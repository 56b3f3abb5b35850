"""Generated QC-IRA base graphs (port of `polar_code_tpu/nr/ldpc/qc_ira.py`).

* Payload part: array-code circulants — block (i, j) carries shift
  ``i·(j+1) mod Z``; for prime Z above both block counts the payload
  subgraph has no 4-cycles.
* Parity part: a block-bidiagonal accumulator (identity diagonal plus
  identity subdiagonal), always invertible over GF(2), so
  `encode.parity_solver_matrix` works for every (m, n, Z).
"""

from __future__ import annotations

import numpy as np

from .basegraphs import BaseGraph


def _is_prime(z: int) -> bool:
    if z < 2:
        return False
    for p in range(2, int(z**0.5) + 1):
        if z % p == 0:
            return False
    return True


def make_qc_ira_bg(m: int, n: int, Z: int) -> BaseGraph:
    """Base graph with ``n − m`` array-code payload columns and an m-column
    IRA accumulator; lifted by `build_h_matrix(bg, Z)` to H (mZ, nZ), rate
    (n−m)/n.  Z must be a prime > m and > n − m; m ≥ 2, n > m."""

    if m < 2 or n <= m:
        raise ValueError("need m >= 2 block-rows and n > m block-columns")
    if not _is_prime(Z) or Z <= m or Z <= n - m:
        raise ValueError(
            f"Z={Z} must be a prime > m={m} and > n-m={n - m} "
            "(girth-6 guarantee)"
        )
    shifts = np.full((m, n), -1, dtype=np.int32)
    for i in range(m):
        for j in range(n - m):
            shifts[i, j] = (i * (j + 1)) % Z
    for i in range(m):
        shifts[i, n - m + i] = 0
        if i:
            shifts[i, n - m + i - 1] = 0
    return BaseGraph(name=f"QC-IRA{m}x{n}", m=m, n=n, shifts=shifts)


def parse_ira_spec(spec: str) -> tuple[int, int]:
    """Parse ``"ira<m>x<n>"`` (e.g. ``ira4x8``) → (m, n)."""

    body = spec[3:] if spec.startswith("ira") else spec
    try:
        m_s, n_s = body.lower().split("x")
        return int(m_s), int(n_s)
    except ValueError as e:
        raise ValueError(
            f"bad IRA base-graph spec {spec!r}; expected 'ira<m>x<n>', e.g. 'ira4x8'"
        ) from e


__all__ = ["make_qc_ira_bg", "parse_ira_spec"]
