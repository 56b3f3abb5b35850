"""Systematic LDPC encoding with a precomputed GF(2) parity solver (port of
`polar_code_tpu/nr/ldpc/encode.py`).

With H = [H_sys | H_par], the parity satisfies H_par·p = H_sys·d (mod 2), so
p = P·d with P = H_par⁻¹·H_sys, solved once on the host.  Encoding a batch
is one float32 product mod 2 — exact, since the entries are 0/1 and the
sums stay below 2²⁴ (integer products are not available on CUDA).
`encode_ldpc` is the scalar reference-compatible form, host numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _gf2_inverse(A: np.ndarray) -> np.ndarray:
    """Invert a square GF(2) matrix by Gauss-Jordan elimination."""

    A = (A.copy() % 2).astype(np.uint8)
    n = A.shape[0]
    if A.shape[1] != n:
        raise ValueError("matrix must be square")
    aug = np.concatenate([A, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for r in range(col, n):
            if aug[r, col]:
                pivot = r
                break
        if pivot is None:
            raise ValueError("parity submatrix is singular over GF(2)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= aug[col]
    return aug[:, n:]


def parity_solver_matrix(H: np.ndarray, k: int) -> np.ndarray:
    """P [(n−k), k] with parity = P @ payload mod 2."""

    H = np.asarray(H)
    m, n = H.shape
    if n - k != m:
        raise ValueError("expected square parity part: n - k must equal m")
    H_sys = (H[:, :k] % 2).astype(np.uint8)
    H_par = (H[:, k:] % 2).astype(np.uint8)
    P = (_gf2_inverse(H_par) @ H_sys) % 2
    return P.astype(np.int8)


@functools.lru_cache(maxsize=16)
def _solver_t(H_bytes: bytes, m: int, n: int, k: int, device: torch.device) -> torch.Tensor:
    """Pᵀ as float32 [k, n−k] on `device`, solved once per code."""

    H = np.frombuffer(H_bytes, dtype=np.int8).reshape(m, n)
    return torch.as_tensor(parity_solver_matrix(H, k).T.astype(np.float32), device=device)


def encode_ldpc_batch(payload: torch.Tensor, H: np.ndarray) -> torch.Tensor:
    """payload int [..., k] → codeword int8 [..., n]."""

    H = np.ascontiguousarray(np.asarray(H, np.int8))
    m, n = H.shape
    k = int(payload.shape[-1])
    if n <= k:
        raise ValueError("Parity-check matrix too small for payload length")
    Pt = _solver_t(H.tobytes(), m, n, k, payload.device)
    parity = torch.remainder(payload.to(torch.float32) @ Pt, 2.0)
    return torch.cat([payload.to(torch.int8), parity.to(torch.int8)], dim=-1)


def encode_ldpc(payload: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Scalar reference-compatible API (1D payload, host numpy)."""

    payload = np.asarray(payload)
    if payload.ndim != 1:
        raise ValueError("payload must be 1D")
    H = np.asarray(H)
    P = parity_solver_matrix(H, payload.size)
    parity = (P.astype(np.int32) @ payload.astype(np.int32)) % 2
    return np.concatenate([payload.astype(np.int8), parity.astype(np.int8)])


__all__ = ["encode_ldpc", "encode_ldpc_batch", "parity_solver_matrix"]
