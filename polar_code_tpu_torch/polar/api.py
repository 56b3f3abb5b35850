"""Scalar reference-compatible API over the batched decoders (port of
`polar_code_tpu/polar/api.py`).

Mirrors the call signatures of the reference modules
(`dl_scl_polar/polar/polar.py`, `scl.py`) so reference-style code can switch
frameworks without edits.  Each call decodes a batch of one; heavy workloads
should use the batched APIs directly.

Each entry point takes `device=None`, the card unless "cpu" is given.  On
the CPU `decode_scl` runs the plain decoder (`ops/scl.py`) in float64, the
JAX package's x64 parity path; on the card it is one launch of the SCL
kernel with its full-list output (`decode_scl_cuda(..., full=True)`) in
float32, the kernel's type.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import config
from ..ops.polar_transform import encode_batch
from ..ops.sc import sc_decode as sc_decode  # re-export
from ..ops.scl_cuda import LIST_FIELDS, decode_scl_cuda
from ..utils.device import resolve_device, scalar_dtype
from .construct import construct_info_set


def encode(msg_bits: np.ndarray, *, device=None) -> np.ndarray:
    """Encode with the default P(N, K) code (reference `polar.encode`)."""

    cfg = config.DEFAULTS
    msg_bits = np.asarray(msg_bits)
    if msg_bits.ndim != 1:
        raise ValueError("msg_bits must be 1D")
    if msg_bits.size != cfg.K:
        raise ValueError(f"msg_bits must have length {cfg.K}")
    info_set = construct_info_set(cfg.N, cfg.K)
    dev = resolve_device(device)
    msg = torch.as_tensor(msg_bits.astype(np.int8) & 1, device=dev)[None]
    return encode_batch(msg, info_set, cfg.N)[0].cpu().numpy().astype(np.int8)


def decode_scl(
    llr: np.ndarray,
    info_set: np.ndarray,
    M: int,
    crc: Optional[str] = None,
    *,
    force_info_bits: Optional[np.ndarray] = None,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> dict:
    """Reference-compatible SCL decode of one frame → dict of numpy arrays.

    Matches `dl_scl_polar/polar/scl.py:108-209`: returns `candidates`,
    `metrics`, `best_path_bits`, `info_llrs`, `best_path_info_llrs`, with the
    candidate list trimmed to the number of reachable paths.  `dtype=None`
    is float64 on the CPU and float32 on the card.
    """

    llr = np.asarray(llr)
    if M <= 0:
        raise ValueError("List size M must be positive")
    info_set = np.asarray(info_set)
    if info_set.ndim != 1:
        raise ValueError("info_set must be a 1D array")
    dev = resolve_device(device)
    forced = None
    if force_info_bits is not None:
        force_info_bits = np.asarray(force_info_bits)
        if force_info_bits.ndim != 1:
            raise ValueError("force_info_bits must be 1D when provided")
        if force_info_bits.size != info_set.size:
            raise ValueError("force_info_bits length must match info_set")
        if not np.all(np.isin(force_info_bits, (-1, 0, 1))):
            raise ValueError("force_info_bits entries must be -1, 0, or 1")
        forced = torch.as_tensor(force_info_bits.astype(np.int8), device=dev)[None]

    x = torch.as_tensor(llr, dtype=scalar_dtype(dev, dtype), device=dev)[None]
    out = decode_scl_cuda(x, info_set, M, crc, force_info_bits=forced, full=True)
    res = {f: out[f][0].cpu().numpy() for f in LIST_FIELDS}

    n_real = int(res["valid"].sum())
    candidates = [np.asarray(res["candidates"][p], dtype=np.int8) for p in range(n_real)]
    metrics = [float(res["metrics"][p]) for p in range(n_real)]
    info_llrs = [np.asarray(res["info_llrs"][p], dtype=float) for p in range(n_real)]
    best_index = int(res["best_index"]) if n_real else None
    return {
        "candidates": candidates,
        "metrics": metrics,
        "best_path_bits": candidates[best_index] if best_index is not None else None,
        "info_llrs": info_llrs,
        "best_path_info_llrs": info_llrs[best_index] if best_index is not None else None,
    }


__all__ = ["encode", "sc_decode", "decode_scl", "construct_info_set"]
