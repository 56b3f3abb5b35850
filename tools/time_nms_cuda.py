#!/usr/bin/env python3
"""Time the layered NMS LDPC kernel K2 of one checkout, on one CUDA card.

    python tools/time_nms_cuda.py [--repo DIR] [--label NAME]

DIR (default: this checkout) is the root of the checkout whose
`polar_code_tpu_torch` is imported, built into DIR/build and timed; the
shapes, LLRs (numpy draws, seeds 8 and 9) and CUDA-event timing are this
checkout's (`chip_smoke.py::nms_timing_cases`, phase 8).  To compare two
versions of the kernel, run it on one card, in one go, for a parent
checkout and for the change, in the order parent, change, change, parent.

Shapes: QC-IRA 4×8 Z=31 (CRC-24A codewords, E=248) and the demo graph at
Z=32 (E=384), two-min and shared-min, B=4096 at 2.5 dB; QC-IRA 4×8 Z=31
two-min B=65536; QC-IRA 46×68 Z=383, the all-zero codeword, B=64 at two
noise levels a mode of min, and two-min B=1024; QC-IRA 4×8 two-min B=1, a
call's floor.  Each shape gets two times: CUDA events around a run of calls
(what a caller waits, the wrapper's host time included where it is longer
than the kernel's) and the kernel's device time by torch.profiler.  Prints a
line a shape, the card's `nvidia-smi` name and power limit, and a JSON line
of every time last.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def device_time_ms(fn, reps, match):
    """Device time of one call of `fn` in the kernels whose names hold
    `match`, by torch.profiler over `reps` calls after one warm-up; None when
    the profiler records no device time."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and match in e.key:
            us += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
    return us / reps / 1e3 if us > 0 else None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE), help="checkout whose kernel is timed")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import faulthandler
    import importlib.util

    import torch

    # this checkout's chip_smoke.py, whatever DIR holds; it arms a watchdog
    # when imported, which a timing run does not need
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    faulthandler.cancel_dump_traceback_later()
    from polar_code_tpu_torch.nr.ldpc.nms_cuda import decode_ldpc_nms_cuda

    if not torch.cuda.is_available():
        print("time_nms_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    label = args.label or str(repo)
    dev = torch.device("cuda")
    codes = {c[0]: (c, cs.ldpc_code(c[1], c[2])) for c in (cs.IRA, cs.DEMO)}
    big_bg = cs.base_graph(f"ira{cs.BIG[0]}x{cs.BIG[1]}", cs.BIG[2])
    times, device = {}, {}
    for tag, x, bg, Z, se, _, reps in cs.nms_timing_cases(dev, codes, big_bg):
        run = lambda: decode_ldpc_nms_cuda(x, bg, Z, 20, 0.8, self_exclude=se)  # noqa: E731
        times[tag] = cs.cuda_time_ms(run, reps=reps)
        device[tag] = device_time_ms(run, reps, "nms")
        dms = "not measured" if device[tag] is None else f"{device[tag]:.4f} ms"
        print(f"  [{label}] K2 {tag}: {times[tag]:.4f} ms ({reps} launches; device {dms})",
              flush=True)
    print(cs.nvidia_smi_line())
    print(json.dumps({"label": label, "launches": decode_ldpc_nms_cuda.launches, "ms": times,
                      "device_ms": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
