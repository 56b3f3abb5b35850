"""Decode routing (port of `polar_code_tpu/ops/backend.py`).

The device decides: a CUDA tensor goes through the SCL kernel
(`ops/scl_cuda.py`), or the call raises for a shape the kernel does not
take; only a CPU tensor goes through the plain decoder (`ops/scl.py`).
A float64 decode on the card goes through the kernel's float64
instantiations (list sizes up to 16384, N up to 8192) or raises.  There is no
fallback from the card to the plain version, and none to float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .scl import decode_scl_batch
from .scl_cuda import check_shape, decode_scl_cuda


def resolve_backend(
    device: torch.device, *, M: int, dtype: torch.dtype, N: int, K: int,
    crc: Optional[str] = None,
) -> str:
    """Return "cuda" (the kernel) or "plain" for a decode on `device`.

    Raises ValueError on a CUDA device for a shape the kernel does not take."""

    device = torch.device(device)
    if device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    check_shape(N, K, M, crc, dtype)
    return "cuda"


def make_scl_decoder(
    info_np, M: int, crc: Optional[str], *, device, dtype: torch.dtype, N: int,
):
    """Return `decode(llr[, forced]) -> (best_path_bits, best_path_info_llrs,
    crc_pass)` for the given code, list size and device."""

    info_np = np.asarray(info_np)
    which = resolve_backend(device, M=M, dtype=dtype, N=N, K=int(info_np.size), crc=crc)

    def decode(llr: torch.Tensor, forced: Optional[torch.Tensor] = None):
        if which == "cuda":
            out = decode_scl_cuda(llr, info_np, M, crc, force_info_bits=forced)
            return out["best_path_bits"], out["best_path_info_llrs"], out["crc_pass"]
        res = decode_scl_batch(llr, info_np, M, crc, force_info_bits=forced, dtype=dtype)
        return res.best_path_bits, res.best_path_info_llrs, res.crc_pass

    return decode


def auto_compact_capacity(compact: int, batch: int, device) -> int:
    """Normalize a retry-compaction request: −1 = auto, 0 = off, >0 = explicit
    capacity (clamped to the batch).

    Auto compacts on a CUDA device when the batch exceeds 128 frames, with
    the whole batch as capacity: the kernel takes ragged batches, so each
    retry step is one launch over every still-failing frame.  On the CPU
    auto is off (masked full-batch retries), as off the TPU in the JAX
    package."""

    if compact == 0:
        return 0
    if compact > 0:
        return min(compact, batch)
    return batch if (torch.device(device).type == "cuda" and batch > 128) else 0


def stable_partition_perm(mask: torch.Tensor) -> torch.Tensor:
    """Permutation putting mask==False elements first, stably — the result of
    a stable argsort of a 1-D bool mask, in O(B) cumsums."""

    m = mask.to(torch.int64)
    n_false = mask.numel() - m.sum()
    pos_true = n_false + torch.cumsum(m, 0) - 1
    pos_false = torch.cumsum(1 - m, 0) - 1
    dest = torch.where(mask, pos_true, pos_false)
    perm = torch.empty_like(dest)
    perm[dest] = torch.arange(mask.numel(), device=mask.device)
    return perm


__all__ = [
    "resolve_backend",
    "make_scl_decoder",
    "auto_compact_capacity",
    "stable_partition_perm",
]
