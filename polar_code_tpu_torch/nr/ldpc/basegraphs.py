"""Base graphs of the NR-style LDPC comparison codec (port of
`polar_code_tpu/nr/ldpc/basegraphs.py`).

Both bg=1 and bg=2 resolve to the same minimal 3×6 demo base graph (three
payload columns plus an identity parity part), not the full 3GPP BG1/BG2
tables; `load_base_graph(bg)` is kept so real tables can slot in
(`nr_tables.load_base_graph_file`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class BaseGraph:
    name: str
    m: int  # rows in base graph
    n: int  # columns in base graph
    shifts: np.ndarray  # (m, n), −1 meaning zero block


def _create_demo_bg(name: str) -> BaseGraph:
    shifts = np.array(
        [
            [0, 1, 2, 0, -1, -1],
            [1, 0, 3, -1, 0, -1],
            [2, 3, 0, -1, -1, 0],
        ],
        dtype=np.int32,
    )
    return BaseGraph(name=name, m=3, n=6, shifts=shifts)


_BG_CACHE: Dict[int, BaseGraph] = {
    1: _create_demo_bg("BG_demo1"),
    2: _create_demo_bg("BG_demo2"),
}


def load_base_graph(bg: int) -> BaseGraph:
    if bg not in _BG_CACHE:
        raise ValueError(f"Unknown base graph: {bg}")
    return _BG_CACHE[bg]


__all__ = ["BaseGraph", "load_base_graph"]
