"""Learnable symmetric β metric for DL-SCL (port of `polar_code_tpu/dlscl/beta.py`).

`SymmetricBeta` is an `nn.Module`, as in the original reference:
β = triu(off_diag, 1) + triu(off_diag, 1)ᵀ + I — symmetric with unit
diagonal — and the forward is Q = |L0| @ β.  Only the strict upper
triangle of `off_diag` affects the forward; the whole matrix (the unused
lower triangle too) carries the L2 penalty in training, and
`clamp_diagonal` zeroes the learnable diagonal (at init and after every
optimizer step).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn


class SymmetricBeta(nn.Module):
    """Symmetric correlation matrix with unit diagonal."""

    def __init__(
        self, dim: int, init_range: float = 0.2, *,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if dim <= 0:
            raise ValueError("dim must be positive")
        self.dim = dim
        off = (torch.rand((dim, dim), generator=generator) * 2.0 - 1.0) * init_range
        self.off_diag = nn.Parameter(off * (1.0 - torch.eye(dim)))

    @torch.no_grad()
    def clamp_diagonal(self) -> "SymmetricBeta":
        """Zero the diagonal of `off_diag` in place; returns the module."""

        self.off_diag.diagonal().zero_()
        return self

    def beta_matrix(self) -> torch.Tensor:
        upper = torch.triu(self.off_diag, diagonal=1)
        eye = torch.eye(self.dim, dtype=upper.dtype, device=upper.device)
        return upper + upper.T + eye

    def forward(self, abs_l0: torch.Tensor) -> torch.Tensor:
        """Q = |L0| @ β for [dim] or [batch, dim] inputs."""

        if abs_l0.dim() not in (1, 2):
            raise ValueError("abs_l0 must be 1D or 2D")
        return abs_l0 @ self.beta_matrix()


def beta_from_checkpoint(path: str) -> np.ndarray:
    """Load a β matrix saved as .npy (the checkpoint format of both packages)."""

    return np.load(path)


__all__ = ["SymmetricBeta", "beta_from_checkpoint"]
