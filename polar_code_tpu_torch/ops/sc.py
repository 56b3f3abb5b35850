"""Successive-cancellation primitives (port of `polar_code_tpu/ops/sc.py:29-40`).

The two node updates every SC/SCL decoder of the package is built from; the
CUDA kernel (`csrc/scl_decode.cu`) evaluates the same expressions.
"""

from __future__ import annotations

import torch


def f_minsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min-sum check-node update: sign(a)·sign(b)·min(|a|,|b|)."""

    return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())


def g_update(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Variable-node update: b + (1−2c)·a with partial sums c."""

    return b + (1.0 - 2.0 * c.to(a.dtype)) * a


__all__ = ["f_minsum", "g_update"]
