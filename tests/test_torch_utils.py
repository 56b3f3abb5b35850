"""The port's profiling and build-cache utilities on the CPU.

* `trace` writes a Chrome / TensorBoard trace file; `Throughput` counts
  frames and laps and brings the step's output to the host.
* `enable_compilation_cache` returns its build directory, and None under
  ``POLAR_CODE_TPU_NO_CACHE=1`` (a fresh directory of the process's own,
  deleted when the process exits).
* The build lock: two processes that call `_build.build` at once, with a
  stub `nvcc` first on PATH that counts its calls, compile once; the other
  loads the result.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from polar_code_tpu_torch import _build
from polar_code_tpu_torch.utils.cache import enable_compilation_cache
from polar_code_tpu_torch.utils.profiling import Throughput, trace

REPO = Path(__file__).resolve().parent.parent


def test_trace_writes_a_trace_file(tmp_path):
    with trace(str(tmp_path / "tb")):
        torch.ones(64, 64).sum().item()
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)


def test_throughput_counts_frames_and_laps():
    meter = Throughput()
    for _ in range(3):
        out = meter.step(lambda x: {"errors": x.sum(), "bits": [x]}, torch.ones(8), frames=8)
    assert meter.frames == 24 and len(meter._laps) == 3
    assert meter.seconds == sum(meter._laps) and meter.fps > 0
    assert out["errors"].device.type == "cpu" and out["errors"].item() == 8.0
    assert "24 frames in" in meter.report()


def test_enable_compilation_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("POLAR_CODE_TPU_NO_CACHE", raising=False)
    assert enable_compilation_cache(str(tmp_path / "c")) == str(tmp_path / "c")
    assert enable_compilation_cache() == str(tmp_path / "c")  # kept without a path
    assert _build.BUILD_DIR == tmp_path / "c"
    monkeypatch.setenv("POLAR_CODE_TPU_NO_CACHE", "1")
    assert enable_compilation_cache(str(tmp_path / "d")) is None
    fresh = _build.BUILD_DIR
    assert fresh.is_dir() and not any(fresh.iterdir()) and fresh != tmp_path / "d"
    enable_compilation_cache()
    assert _build.BUILD_DIR == fresh  # one directory a process


def test_no_cache_directory_is_removed_at_exit(tmp_path):
    code = ("from polar_code_tpu_torch import _build\n"
            "from polar_code_tpu_torch.utils.cache import enable_compilation_cache\n"
            "assert enable_compilation_cache() is None\n"
            "(_build.BUILD_DIR / 'lib.so').write_text('x')\n"
            "print(_build.BUILD_DIR)\n")
    env = dict(os.environ, POLAR_CODE_TPU_NO_CACHE="1", TMPDIR=str(tmp_path),
               PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    built = Path(p.stdout.strip())
    assert built.parent == tmp_path and not built.exists()


STUB_NVCC = """#!/bin/sh
echo call >> "{calls}"
sleep 1
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo lib > "$1"; fi
  shift
done
"""

BUILD_SCRIPT = """
import sys
from polar_code_tpu_torch import _build
from polar_code_tpu_torch.utils.cache import enable_compilation_cache
enable_compilation_cache(sys.argv[1])
print("cached" if _build.build("scl_decode.cu").cached else "compiled")
"""


def test_concurrent_builds_run_nvcc_once(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "calls"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STUB_NVCC.format(calls=calls))
    nvcc.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=str(REPO))
    env.pop("POLAR_CODE_TPU_NO_CACHE", None)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(tmp_path / "build")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert calls.read_text().count("call") == 1
    assert sorted(outs) == ["cached", "compiled"]
    assert len(list((tmp_path / "build").glob("scl_decode_*.so"))) == 1
