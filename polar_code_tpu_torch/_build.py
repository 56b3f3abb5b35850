"""Build the port's CUDA sources into shared libraries, at first use.

Each `csrc/*.cu` file has a plain `extern "C"` interface and is compiled by
`nvcc` alone (no PyTorch headers, so a build takes seconds) into the
build directory, then loaded with `ctypes`.  The directory is the
git-ignored `build/` at the repository root unless
`utils/cache.py::enable_compilation_cache` points `BUILD_DIR` elsewhere.
The library name carries a hash of the source, the headers it may include
(`csrc/*.cuh`) and the flags, so an edited source or header is rebuilt and
an unchanged one is reused.  A file lock a library
makes processes that start together (the ranks of a multi-process run) run
`nvcc` once: the others wait and load its result.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

# sm_90a keeps Hopper-only instructions available; no fast math and no FMA
# contraction, so the kernels round exactly as the plain PyTorch versions do.
# ptxas assembles a source's kernels in parallel on every core
# (`--split-compile=0`): the same SASS as one thread, in about a third of
# ptxas's time (`PERF.md` §4)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas", "-v", "-Xptxas", "--split-compile=0",
    "-shared", "-Xcompiler", "-fPIC",
)


@dataclass
class BuildResult:
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc/ptxas report (registers, shared memory, spills)
    cached: bool


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def build(source: str, defines: tuple = (), csrc: Path = CSRC) -> BuildResult:
    """Compile `<csrc>/<source>` (`csrc/` by default) into `BUILD_DIR` unless
    an identical build exists there, with `defines` (nvcc `-D` arguments)
    after the flags.  Holds `<lib>.lock` over the check and the compile."""

    csrc = Path(csrc)
    src = csrc / source
    flags = NVCC_FLAGS + tuple(defines)
    headers = b"".join(h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    build_dir = Path(BUILD_DIR)
    lib = build_dir / f"{src.stem}_{key}.so"
    log_path = lib.with_suffix(".log")
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():
            log = log_path.read_text() if log_path.exists() else ""
            return BuildResult(lib, 0.0, log, True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(src)],
            capture_output=True, text=True, timeout=600,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{proc.stderr}")
        log = proc.stdout + proc.stderr
        log_path.write_text(log)
        os.replace(tmp, lib)
    return BuildResult(lib, seconds, log, False)


@functools.lru_cache(maxsize=None)
def load(source: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>`; one handle per process and
    set of defines."""

    return ctypes.CDLL(str(build(source, defines).path))


__all__ = ["BuildResult", "build", "load", "BUILD_DIR", "CSRC", "NVCC_FLAGS"]
