"""Lifted parity-check matrices from base graphs, on the host (port of
`polar_code_tpu/nr/ldpc/builder.py`).

Dense H of shape (mZ, nZ) from Z×Z shifted-identity circulants: block
(r, c) with shift s ≥ 0 has ``mat[i, (i + s) % Z] = 1``; −1 is a zero block.

`circulant_structure` is the inverse of `build_h_matrix`: it recovers a base
graph and lifting size from a dense H, so that the scalar decoder
(`decode_nms.decode_ldpc_nms`) can hand an H to the NMS kernel, which works
from shifts.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np

from .basegraphs import BaseGraph


def _circulant(size: int, shift: int) -> np.ndarray:
    mat = np.zeros((size, size), dtype=np.int8)
    if shift < 0:
        return mat
    idx = np.arange(size)
    mat[idx, (idx + shift) % size] = 1
    return mat


def build_h_matrix(base_graph: BaseGraph, Z: int) -> np.ndarray:
    rows = []
    for r in range(base_graph.m):
        row_blocks = [
            _circulant(Z, int(base_graph.shifts[r, c])) for c in range(base_graph.n)
        ]
        rows.append(np.hstack(row_blocks))
    return np.vstack(rows)


def _block_shifts(H: np.ndarray, Z: int) -> Optional[np.ndarray]:
    """Shifts [m/Z, n/Z] (−1 for a zero block) when every Z×Z block of H is
    zero or a shifted identity, else None."""

    m, n = H.shape
    blocks = H.reshape(m // Z, Z, n // Z, Z).transpose(0, 2, 1, 3)
    s = blocks[:, :, 0, :].argmax(axis=-1)  # the shift a block's row 0 shows
    cols = (np.arange(Z)[None, None, :] + s[:, :, None]) % Z
    on_diag = np.take_along_axis(blocks, cols[..., None], axis=3)[..., 0].all(axis=-1)
    ones = blocks.sum(axis=(2, 3), dtype=np.int64)
    if not np.all((ones == 0) | ((ones == Z) & on_diag)):
        return None
    return np.where(ones == 0, -1, s).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _structure(H_bytes: bytes, m: int, n: int) -> Tuple[BaseGraph, int]:
    H = np.frombuffer(H_bytes, dtype=np.int8).reshape(m, n)
    g = math.gcd(m, n)
    for Z in (d for d in range(g, 0, -1) if g % d == 0):
        shifts = _block_shifts(H, Z)
        if shifts is not None:
            return BaseGraph(name=f"circulant Z={Z}", m=m // Z, n=n // Z, shifts=shifts), Z
    raise ValueError("H is not a 0/1 matrix")  # at Z = 1 every 0/1 matrix qualifies


def circulant_structure(H: np.ndarray) -> Tuple[BaseGraph, int]:
    """(base graph, Z) with `build_h_matrix(base graph, Z)` equal to H mod 2,
    at the largest Z dividing both dimensions for which every Z×Z block is
    zero or a shifted identity.  Z = 1 (a base graph of H's own 0/1 entries
    as shifts 0 and −1) always qualifies.  Cached per H."""

    H = np.ascontiguousarray((np.asarray(H) % 2).astype(np.int8))
    return _structure(H.tobytes(), *H.shape)


__all__ = ["build_h_matrix", "circulant_structure"]
