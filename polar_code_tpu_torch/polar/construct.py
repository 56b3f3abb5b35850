"""Polar code construction (port of `polar_code_tpu/polar/construct.py`).

Host-side NumPy, copied so the port does not import the JAX package.  The
methods are the same: ``gaussian`` (density-evolution Gaussian
approximation, DEGA), ``gaussian_bitrev`` (the same recursion read in
bit-reversed index order, the right ordering for the natural-order decoder
at N > 128) and ``polarization`` (β-expansion weights).  Stable argsort,
take the K most reliable, sort ascending — bit-for-bit the JAX tables.
"""

from __future__ import annotations

import functools
import math

import numpy as np


def _check_power_of_two(n: int) -> None:
    if n <= 0 or (n & (n - 1)) != 0:
        raise ValueError("N must be a power of two")


def polarization_weights(N: int) -> np.ndarray:
    """β-expansion weight w(i) = Σ_j b_j(i) · 2^(j/4)."""

    n = int(math.log2(N))
    idx = np.arange(N)[:, None]
    bits = (idx >> np.arange(n)[None, :]) & 1
    return (bits * (2.0 ** (np.arange(n) / 4.0))[None, :]).sum(axis=1)


def bit_reversal_permutation(N: int) -> np.ndarray:
    """perm[i] = the log2(N)-bit reversal of i."""

    n = int(math.log2(N))
    idx = np.arange(N)
    rev = np.zeros(N, dtype=np.int64)
    for b in range(n):
        rev |= ((idx >> b) & 1) << (n - 1 - b)
    return rev


def _phi_inv(x: float) -> float:
    # Piecewise fit used by DEGA mean-LLR recursion (same coefficients as the
    # reference, dl_scl_polar/polar/polar.py:51-58).
    if x > 12.0:
        return 0.9861 * x - 2.3152
    if x > 3.5:
        return x * (0.009005 * x + 0.7694) - 0.9507
    if x > 1.0:
        return x * (0.062883 * x + 0.3678) - 0.1627
    return x * (0.2202 * x + 0.06448)


def gaussian_pe(N: int, K: int, design_snr_db: float) -> np.ndarray:
    """Per-channel error probability from the DEGA mean-LLR recursion."""

    rate = K / N
    snr = 10 ** (design_snr_db / 10.0)
    sigma_sq = 1.0 / (2.0 * rate * snr)

    m = np.zeros(N, dtype=float)
    m[0] = 2.0 / sigma_sq
    stages = int(math.log2(N))
    for level in range(1, stages + 1):
        half = (1 << level) >> 1
        for j in range(half):
            T = m[j]
            m[j] = _phi_inv(T)
            m[half + j] = 2.0 * T

    pe = np.empty(N, dtype=float)
    for i in range(N):
        val = max(m[i], 1e-12)
        pe[i] = 0.5 - 0.5 * math.erf(math.sqrt(val) / 2.0)
    return pe


@functools.lru_cache(maxsize=None)
def construct_info_set(
    N: int, K: int, method: str = "gaussian", design_snr_db: float = 2.5
) -> np.ndarray:
    """Return sorted int32 indices of the (N, K) information set."""

    _check_power_of_two(N)
    if not (0 < K <= N):
        raise ValueError("K must satisfy 0 < K <= N")

    if method == "polarization":
        metric = polarization_weights(N)
        order = np.argsort(metric, kind="stable")
    elif method == "gaussian":
        pe = gaussian_pe(N, K, design_snr_db)
        order = np.argsort(pe, kind="stable")
    elif method == "gaussian_bitrev":
        # corrected index order for the natural-order decoder (see module
        # docstring): channel i's reliability is the recursion's output at
        # the bit-reversed index
        pe = gaussian_pe(N, K, design_snr_db)[bit_reversal_permutation(N)]
        order = np.argsort(pe, kind="stable")
    else:
        raise ValueError(f"Unsupported construction method: {method}")

    info_idx = np.sort(order[:K])
    info_idx.setflags(write=False)
    return info_idx.astype(np.int32)


def frozen_mask(N: int, info_set: np.ndarray) -> np.ndarray:
    """Boolean mask of frozen positions (True = frozen)."""

    mask = np.ones(N, dtype=bool)
    mask[np.asarray(info_set)] = False
    return mask


__all__ = [
    "bit_reversal_permutation",
    "construct_info_set",
    "frozen_mask",
    "gaussian_pe",
    "polarization_weights",
]
