"""Successive-cancellation (SC) decoding (port of `polar_code_tpu/ops/sc.py`).

Reference semantics: `dl_scl_polar/polar/polar.py:122-168` — min-sum f,
exact g, recursive descent of the factor tree, frozen→0, info→(llr<0),
partial-sum combine `left^right ‖ right`.

`f_minsum` and `g_update` are the two node updates every SC/SCL decoder of
the package is built from; the CUDA kernel (`csrc/scl_decode.cu`) evaluates
the same expressions.  `sc_decode_batch` is plain torch on the tensor's
device: the JAX package computes SC in XLA, outside any Pallas kernel, so
there is no kernel to port.  Its recursion is unrolled in Python into a
straight chain of batched f/g/XOR ops over the [segment, B] layout, in the
JAX decoder's order.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..polar.construct import frozen_mask as _frozen_mask
from ..utils.device import resolve_device, scalar_dtype


def f_minsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min-sum check-node update: sign(a)·sign(b)·min(|a|,|b|)."""

    return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())


def g_update(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Variable-node update: b + (1−2c)·a with partial sums c."""

    return b + (1.0 - 2.0 * c.to(a.dtype)) * a


def sc_decode_batch(
    llr: torch.Tensor,
    info_set: np.ndarray,
    *,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Decode a batch of channel LLRs.  llr: [B, N] → info bits [B, K] int8."""

    N = int(llr.shape[1])
    n = int(math.log2(N))
    if 1 << n != N:
        raise ValueError("N must be a power of two")
    frozen = _frozen_mask(N, info_set)

    u_leaves: List[Optional[torch.Tensor]] = [None] * N  # each [1, B] int8

    def decode_segment(seg_llr: torch.Tensor, depth: int, start: int) -> torch.Tensor:
        # seg_llr: [2^depth, B]; returns partial sums x̂ of the segment.
        if depth == 0:
            if frozen[start]:
                bit = torch.zeros_like(seg_llr, dtype=torch.int8)
            else:
                bit = (seg_llr < 0).to(torch.int8)
            u_leaves[start] = bit
            return bit
        half = 1 << (depth - 1)
        a, b = seg_llr[:half], seg_llr[half:]
        left_bits = decode_segment(f_minsum(a, b), depth - 1, start)
        right_bits = decode_segment(g_update(a, b, left_bits), depth - 1, start + half)
        return torch.cat([left_bits ^ right_bits, right_bits], dim=0)

    decode_segment(llr.T.to(dtype), n, 0)
    u_info = torch.cat([u_leaves[int(i)] for i in np.asarray(info_set)], dim=0)
    return u_info.T  # [B, K]


def sc_decode(llr: np.ndarray, info_set: np.ndarray, *, device=None) -> np.ndarray:
    """Scalar reference-compatible API: 1D llr → info bits (int8).

    Decodes on `device` (the card unless given "cpu"), in float64 on the CPU
    and float32 on the card."""

    llr = np.asarray(llr)
    if llr.ndim != 1:
        raise ValueError("llr must be 1D")
    info_set = np.asarray(info_set)
    if info_set.ndim != 1:
        raise ValueError("info_set must be 1D")
    if np.any(info_set < 0) or np.any(info_set >= llr.size):
        raise ValueError("info_set indices out of range")
    dev = resolve_device(device)
    dtype = scalar_dtype(dev)
    x = torch.as_tensor(llr, dtype=dtype, device=dev)[None, :]
    return sc_decode_batch(x, info_set, dtype=dtype)[0].cpu().numpy().astype(np.int8)


__all__ = ["sc_decode_batch", "sc_decode", "f_minsum", "g_update"]
