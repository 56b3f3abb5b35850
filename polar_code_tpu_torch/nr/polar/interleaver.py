"""5G NR-style sub-block interleaver as a static gather (port of
`polar_code_tpu/nr/polar/interleaver.py`).

Block size 32, pad to a block multiple with −1, permutation
``order[i] = (i % 32)·num_blocks + i // 32`` (a row-column transpose);
deinterleave through the inverse permutation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

INTERLEAVER_BLOCK = 32


@functools.lru_cache(maxsize=None)
def interleave_order(length: int, mode: str = "default") -> np.ndarray:
    """Forward permutation for a padded length (row-column transpose)."""

    block = INTERLEAVER_BLOCK
    num_blocks = (length + block - 1) // block
    total = num_blocks * block
    i = np.arange(total)
    order = ((i % block) * num_blocks + i // block).astype(np.int32)
    order.setflags(write=False)
    return order


def subblock_interleave(bits: torch.Tensor, mode: str = "default") -> torch.Tensor:
    """Interleave along the last axis; pads with −1 to a block multiple."""

    length = int(bits.shape[-1])
    order = interleave_order(length, mode)
    total = order.size
    if total != length:
        pad = torch.full((*bits.shape[:-1], total - length), -1, dtype=bits.dtype, device=bits.device)
        bits = torch.cat([bits, pad], dim=-1)
    return bits[..., torch.as_tensor(order.astype(np.int64), device=bits.device)]


def subblock_deinterleave(bits: torch.Tensor, original_len: int, mode: str = "default") -> torch.Tensor:
    """Invert the interleaver along the last axis (zero-pads short inputs)."""

    order = interleave_order(original_len, mode)
    total = order.size
    cur = int(bits.shape[-1])
    if cur < total:
        pad = torch.zeros((*bits.shape[:-1], total - cur), dtype=bits.dtype, device=bits.device)
        bits = torch.cat([bits, pad], dim=-1)
    inverse = torch.as_tensor(np.argsort(order), dtype=torch.long, device=bits.device)
    return bits[..., inverse][..., :original_len]


__all__ = ["subblock_interleave", "subblock_deinterleave", "INTERLEAVER_BLOCK"]
