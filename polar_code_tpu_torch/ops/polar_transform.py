"""Batched Arikan polar transform (port of `polar_code_tpu/ops/polar_transform.py`).

n stages of XOR butterflies in natural order (no bit-reversal),
``x[left] ^= x[right]``; each stage is a reshape to [..., blocks, 2, step]
plus one vectorized XOR over the whole batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def polar_transform(u: torch.Tensor) -> torch.Tensor:
    """Apply the polar transform along the last axis.  u: int [..., N]."""

    N = int(u.shape[-1])
    n = int(math.log2(N))
    if 1 << n != N:
        raise ValueError("N must be a power of two")
    lead = u.shape[:-1]
    x = u
    for stage in range(n):
        step = 1 << stage
        x = x.reshape(*lead, N // (2 * step), 2, step)
        x = torch.stack([x[..., 0, :] ^ x[..., 1, :], x[..., 1, :]], dim=-2)
    return x.reshape(*lead, N)


def encode_batch(msg_bits: torch.Tensor, info_set: np.ndarray, N: int) -> torch.Tensor:
    """Scatter info bits into u (frozen = 0) and polar-transform.

    msg_bits: int [..., K]; info_set: static int vector; returns [..., N].
    """

    info_set = np.asarray(info_set)
    K = int(info_set.size)
    if int(msg_bits.shape[-1]) != K:
        raise ValueError(f"msg_bits must have trailing length {K}")
    u = torch.zeros((*msg_bits.shape[:-1], N), dtype=msg_bits.dtype, device=msg_bits.device)
    u[..., torch.as_tensor(info_set, dtype=torch.long, device=msg_bits.device)] = msg_bits
    return polar_transform(u)


__all__ = ["polar_transform", "encode_batch"]
