"""TS 38.212 §5.3.2 LDPC lifting tables and the `--bg_file` loader (port of
`polar_code_tpu/nr/ldpc/nr_tables.py`).

Host-side table math: the eight lifting sets Z = a·2^j and the set index
(iLS), shift lifting P = V mod Z (−1 stays a zero block), base-graph and
lifting-size selection, and a loader for external shift tables.  No real
38.212 shift table ships with the repository; a loaded one feeds
`build_h_matrix`, the encoder and both NMS decoders (the plain version and
the kernel) unchanged.

`--bg_file` CSV format: header `row,col,V0,V1,...,V7` (one shift column per
iLS set) or `row,col,shift` (pre-reduced); one line per base-graph edge;
-1 (or absence) = zero block.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .basegraphs import BaseGraph

# TS 38.212 Table 5.3.2-1: set index iLS → lifting sizes Z = a·2^j
LIFTING_SETS: Dict[int, Tuple[int, ...]] = {
    0: (2, 4, 8, 16, 32, 64, 128, 256),    # a = 2
    1: (3, 6, 12, 24, 48, 96, 192, 384),   # a = 3
    2: (5, 10, 20, 40, 80, 160, 320),      # a = 5
    3: (7, 14, 28, 56, 112, 224),          # a = 7
    4: (9, 18, 36, 72, 144, 288),          # a = 9
    5: (11, 22, 44, 88, 176, 352),         # a = 11
    6: (13, 26, 52, 104, 208),             # a = 13
    7: (15, 30, 60, 120, 240),             # a = 15
}

# Base-graph dimensions per TS 38.212 Tables 5.3.2-2 / 5.3.2-3
BG_DIMS: Dict[int, Tuple[int, int]] = {1: (46, 68), 2: (42, 52)}
# Systematic columns K_b(max): BG1 fixed 22; BG2 K-dependent (see choose_Kb)
BG_KB_MAX: Dict[int, int] = {1: 22, 2: 10}


def all_lifting_sizes() -> Tuple[int, ...]:
    return tuple(sorted(z for zs in LIFTING_SETS.values() for z in zs))


def ils_index(Z: int) -> int:
    """Set index iLS of lifting size Z (TS 38.212 Table 5.3.2-1)."""

    for ils, zs in LIFTING_SETS.items():
        if Z in zs:
            return ils
    raise ValueError(f"Z={Z} is not a 3GPP lifting size")


def lift_shifts(V: np.ndarray, Z: int) -> np.ndarray:
    """Shift coefficients P = V mod Z (V ≥ 0); −1 (no edge) is preserved."""

    V = np.asarray(V)
    return np.where(V < 0, -1, V % Z).astype(np.int32)


def choose_base_graph(K: int, rate: float) -> int:
    """TS 38.212 §7.2.2: BG2 iff K ≤ 292, or (K ≤ 3824 and R ≤ 0.67),
    or R ≤ 0.25; BG1 otherwise."""

    if K <= 292 or (K <= 3824 and rate <= 0.67) or rate <= 0.25:
        return 2
    return 1


def choose_Kb(bg: int, K: int) -> int:
    """Systematic base-columns K_b (TS 38.212 §5.2.2): BG1 always 22;
    BG2 10/9/8/6 by payload size."""

    if bg == 1:
        return 22
    if K > 640:
        return 10
    if K > 560:
        return 9
    if K > 192:
        return 8
    return 6


def choose_lifting_size(bg: int, K: int) -> Tuple[int, int]:
    """(K_b, Z): smallest Z in Table 5.3.2-1 with K_b·Z ≥ K."""

    Kb = choose_Kb(bg, K)
    for Z in all_lifting_sizes():
        if Kb * Z >= K:
            return Kb, Z
    raise ValueError(f"K={K} exceeds the largest liftable size (Kb={Kb}, Zmax=384)")


def parse_shift_table(text: str) -> np.ndarray:
    """Parse an edge-list shift table.

    Lines (comments ``#``/blank skipped): either
    ``row,col,V0,V1,...,V7`` — one coefficient per iLS set — or
    ``row,col,V`` — a single (pre-reduced or Zmax-form) coefficient,
    broadcast to all 8 sets.  Whitespace-separated fields also accepted.
    A leading non-numeric header line (``row,col,V0,...``) is skipped.
    Returns V as int32 [m, n, 8] with −1 for absent edges; m, n inferred
    from the maximum indices.
    """

    edges = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = [p for p in line.replace(",", " ").split() if p]
        if not edges and parts and not parts[0].lstrip("-").isdigit():
            continue  # CSV header line
        if len(parts) not in (3, 10):
            raise ValueError(
                f"line {lineno}: expected 'row col V' or 'row col V0..V7', "
                f"got {len(parts)} fields"
            )
        vals = [int(p) for p in parts]
        r, c = vals[0], vals[1]
        if r < 0 or c < 0:
            raise ValueError(f"line {lineno}: negative row/col index")
        vs = vals[2:] * (8 if len(vals) == 3 else 1)
        edges.append((r, c, vs))
    if not edges:
        raise ValueError("empty shift table")
    m = max(e[0] for e in edges) + 1
    n = max(e[1] for e in edges) + 1
    V = np.full((m, n, 8), -1, np.int32)
    for r, c, vs in edges:
        if np.any(V[r, c] >= 0):
            raise ValueError(f"duplicate entry for base-graph cell ({r},{c})")
        V[r, c] = vs
    return V


def base_graph_from_table(
    V: np.ndarray, Z: int, *, name: str = "BG_file", bg: Optional[int] = None
) -> BaseGraph:
    """Lift a [m, n, 8] per-iLS coefficient table at lifting size Z."""

    V = np.asarray(V)
    if bg is not None and (V.shape[0], V.shape[1]) != BG_DIMS[bg]:
        raise ValueError(
            f"table is {V.shape[0]}x{V.shape[1]}, but BG{bg} is "
            f"{BG_DIMS[bg][0]}x{BG_DIMS[bg][1]}"
        )
    shifts = lift_shifts(V[:, :, ils_index(Z)], Z)
    return BaseGraph(name=f"{name}_Z{Z}", m=shifts.shape[0], n=shifts.shape[1], shifts=shifts)


def load_base_graph_file(
    path: str | Path, Z: int, *, bg: Optional[int] = None
) -> BaseGraph:
    """Load an external shift table (see `parse_shift_table`) lifted at Z.

    Use with the real TS 38.212 Table 5.3.2-2 (BG1) / 5.3.2-3 (BG2) data:
    ``load_base_graph_file("bg1.csv", Z=384, bg=1)``; pass ``bg`` to enforce
    the spec dimensions.  The result feeds `build_h_matrix` and both NMS
    decoder paths unchanged.
    """

    p = Path(path)
    V = parse_shift_table(p.read_text())
    return base_graph_from_table(V, Z, name=p.stem, bg=bg)


__all__ = [
    "LIFTING_SETS",
    "BG_DIMS",
    "all_lifting_sizes",
    "ils_index",
    "lift_shifts",
    "choose_base_graph",
    "choose_Kb",
    "choose_lifting_size",
    "parse_shift_table",
    "base_graph_from_table",
    "load_base_graph_file",
]
