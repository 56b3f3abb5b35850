"""Kernel build cache (port of `polar_code_tpu/utils/cache.py`).

The JAX package keeps a persistent XLA compilation cache; the port's
compiled artifacts are its kernels' shared libraries, which `_build.py`
builds with `nvcc` into a directory keyed by a hash of source and flags.
Every CLI calls `enable_compilation_cache()` first, as the JAX CLIs do.

* default location: the git-ignored `build/` at the repository root;
* `enable_compilation_cache(path)` builds into `path` from then on (a
  later call without a path keeps it);
* opt out with ``POLAR_CODE_TPU_NO_CACHE=1``: each process builds into a
  fresh temporary directory of its own, so every kernel is rebuilt; the
  directory is deleted when the process exits.
"""

from __future__ import annotations

import atexit
import functools
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

from .. import _build


@functools.lru_cache(maxsize=None)
def _process_dir() -> Path:
    path = tempfile.mkdtemp(prefix="polar_code_tpu_build_")
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return Path(path)


def enable_compilation_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernel builds at a cache directory; returns it, or None
    when ``POLAR_CODE_TPU_NO_CACHE`` forces a rebuild."""

    if os.environ.get("POLAR_CODE_TPU_NO_CACHE"):
        _build.BUILD_DIR = _process_dir()
        return None
    if path is not None:
        _build.BUILD_DIR = Path(path)
    return str(_build.BUILD_DIR)


__all__ = ["enable_compilation_cache"]
