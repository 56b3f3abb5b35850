"""Lifted parity-check matrices from base graphs, on the host (port of
`polar_code_tpu/nr/ldpc/builder.py`).

Dense H of shape (mZ, nZ) from Z×Z shifted-identity circulants: block
(r, c) with shift s ≥ 0 has ``mat[i, (i + s) % Z] = 1``; −1 is a zero block.
"""

from __future__ import annotations

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


__all__ = ["build_h_matrix"]
