"""Weights carried between the JAX package and the port.

The β checkpoints (`checkpoints/beta_M*.npy`, float32 [64, 64]) hold the full
symmetric matrix with unit diagonal; both packages read and write them with
NumPy.  The static code tables (info set, frozen mask, CRC matrices,
schedule) are rebuilt by the port's own copies of the host-side code and
pinned equal to the JAX package's by the tests.

A trainer's parameters cross whole: `off_diag_from_numpy` takes the JAX
pytree `{"off_diag": [dim, dim]}` (`SymmetricBeta.init`) as it is, lower
triangle and diagonal included — the forward never reads them, but the L2
term of training does — which a β checkpoint cannot carry.
"""

from __future__ import annotations

import numpy as np
import torch

from .dlscl.beta import SymmetricBeta, beta_from_checkpoint


def beta_from_numpy(arr: np.ndarray) -> SymmetricBeta:
    """A `SymmetricBeta` whose β equals `arr` (square, symmetric, unit diagonal)."""

    arr = np.asarray(arr)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError("beta must be a square matrix")
    if not np.array_equal(arr, arr.T) or not np.all(np.diag(arr) == 1):
        raise ValueError("beta must be symmetric with a unit diagonal")
    module = SymmetricBeta(arr.shape[0])
    with torch.no_grad():
        module.off_diag.copy_(torch.from_numpy(np.triu(arr, 1)))
    return module


def beta_to_numpy(module: SymmetricBeta) -> np.ndarray:
    """β as the float32 matrix a checkpoint holds."""

    return module.beta_matrix().detach().cpu().numpy().astype(np.float32)


def off_diag_from_numpy(params: dict) -> SymmetricBeta:
    """A `SymmetricBeta` whose `off_diag` is a copy of `params["off_diag"]`."""

    off = np.asarray(params["off_diag"])
    if off.ndim != 2 or off.shape[0] != off.shape[1]:
        raise ValueError("off_diag must be a square matrix")
    module = SymmetricBeta(off.shape[0])
    with torch.no_grad():
        module.off_diag.copy_(torch.from_numpy(off.astype(np.float32)))
    return module


def off_diag_to_numpy(module: SymmetricBeta) -> dict:
    """The JAX parameter pytree `{"off_diag": float32 [dim, dim]}` of `module`."""

    return {"off_diag": module.off_diag.detach().cpu().numpy().astype(np.float32)}


def load_beta(path: str) -> SymmetricBeta:
    """Read a β checkpoint (.npy) written by either package."""

    return beta_from_numpy(beta_from_checkpoint(path))


__all__ = [
    "beta_from_numpy", "beta_to_numpy", "off_diag_from_numpy", "off_diag_to_numpy",
    "load_beta",
]
