"""Tracing and throughput helpers (port of `polar_code_tpu/utils/profiling.py`).

* `trace(logdir)` — context manager around `torch.profiler` writing a
  Chrome / TensorBoard trace (`*.pt.trace.json`) of everything run inside,
  the card's kernels included where there is one.
* `Throughput` — steady-state frames/s meter with a device sync.

CUDA launches return before the card finishes, so `Throughput` syncs by
moving the step's output to the host.  The profiler is known to drop
events in a session that follows an earlier profiler session in the same
process: trace one window a process.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List


@contextlib.contextmanager
def trace(logdir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir))
    try:
        prof.start()
        started = True
    except Exception as exc:  # noqa: BLE001 — profiling unsupported here: run untraced
        print(f"[profiling] trace unavailable: {exc}")
        started = False
    try:
        yield
    finally:
        if started:
            prof.stop()


def _to_host(out):
    """`out` with every tensor in it copied to the host (which waits for it)."""

    import torch

    if isinstance(out, torch.Tensor):
        return out.cpu()
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_to_host(v) for v in out)
    return out


@dataclass
class Throughput:
    """Accumulates (frames, seconds) across timed steps."""

    frames: int = 0
    seconds: float = 0.0
    _laps: List[float] = field(default_factory=list)

    def step(self, fn, *args, frames: int):
        """Run fn(*args), bring its output to the host, and record the
        elapsed wall-clock."""

        t0 = time.perf_counter()
        out = _to_host(fn(*args))
        dt = time.perf_counter() - t0
        self.frames += frames
        self.seconds += dt
        self._laps.append(dt)
        return out

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds > 0 else float("nan")

    def report(self) -> str:
        best = min(self._laps) if self._laps else float("nan")
        return (
            f"{self.frames} frames in {self.seconds:.3f}s — "
            f"{self.fps:.0f} frames/s (best step {best * 1e3:.1f} ms)"
        )


__all__ = ["trace", "Throughput"]
