"""Static per-phase SCL schedule tables (port of `polar_code_tpu/ops/scl_pallas.py:107` `_schedule_tables`).

Host-side NumPy.  For a code (N, info set) the decode schedule is fixed:
which tree levels each phase updates (f or g), where its partial-sum chain
stores, which phases are frozen, and which levels are still live at each
phase's fork.  The CUDA kernel reads these tables instead of recomputing
them per frame; `kernel_tables` packs them for it.

The JAX function also returns the σ fork-interval tables of the TPU kernel's
lazy clone; the CUDA kernel clones survivors by copying live rows, so they
are not ported.
"""

from __future__ import annotations

import math

import numpy as np

from ..polar.construct import frozen_mask as _frozen_mask


def schedule_tables(N: int, info_np: np.ndarray):
    """Return (upd, store, frozen, infoidx, llr_live, bit_live, glevel).

    upd      [N, n+1] int32: 0 none / 1 f / 2 g, per level 1..n
    store    [N, n+1] int32: 1 at the level the partial-sum chain stores to
    frozen   [N] int32
    infoidx  [N] int32: info index of each info phase
    llr_live [N, n+1] int32: LLR level still read after the fork of phase p
    bit_live [N, n+1] int32: partial-sum level still read after that fork
    glevel   [N] int32: the level of phase p's g update (0 at phase 0)
    """

    n = int(math.log2(N))
    upd = np.zeros((N, n + 1), np.int32)
    store = np.zeros((N, n + 1), np.int32)
    for phase in range(N):
        if phase == 0:
            upd[0, 1 : n + 1] = 1
        else:
            k = (phase & -phase).bit_length() - 1
            upd[phase, n - k] = 2
            upd[phase, n - k + 1 : n + 1] = 1
        level, node = n, phase
        while level > 0 and node % 2 == 1:
            node //= 2
            level -= 1
        if level > 0:
            store[phase, level] = 1

    glevel = np.zeros(N, np.int32)
    for phase in range(1, N):
        k = (phase & -phase).bit_length() - 1
        glevel[phase] = n - k

    frozen = _frozen_mask(N, info_np).astype(np.int32)
    infoidx = np.zeros(N, np.int32)
    idx = 0
    for phase in range(N):
        if not frozen[phase]:
            infoidx[phase] = idx
            idx += 1

    # Liveness for clone-by-copy: at the fork of phase p, a level's rows
    # only need copying if some later phase reads them before overwriting.
    # Reverse sweep over the exact schedule:
    # NEED_before(p) = (NEED_after(p) − writes(p)) ∪ reads(p); live(p) =
    # NEED_after(p).  The copy runs after the leaf decision and before the
    # partial-sum chain, so the chain's own left-bit reads count as live.
    llr_live = np.zeros((N, n + 1), np.int32)
    bit_live = np.zeros((N, n + 1), np.int32)
    need_llr: set = set()
    need_bit: set = set()
    for p in range(N - 1, -1, -1):
        lvl, node = n, p
        comb_levels = []
        while lvl > 0 and node % 2 == 1:
            comb_levels.append(lvl)
            node //= 2
            lvl -= 1
        for level in range(1, n + 1):
            llr_live[p, level] = int(level in need_llr)
            bit_live[p, level] = int(level in need_bit or level in comb_levels)
        if lvl > 0:
            need_bit.discard(lvl)  # the chain's store writes this level
        for c in comb_levels:
            need_bit.add(c)  # the chain reads these left rows
        need_llr.add(n)  # the leaf decision
        for level in range(n, 0, -1):  # f/g updates, reversed
            if upd[p, level] == 0:
                continue
            need_llr.discard(level)
            if level > 1:
                need_llr.add(level - 1)
            if upd[p, level] == 2:
                need_bit.add(level)

    return upd, store, frozen, infoidx, llr_live, bit_live, glevel


def kernel_tables(N: int, info_np: np.ndarray) -> np.ndarray:
    """Pack the schedule into the int32 [5, N] table the CUDA kernel reads.

    Rows: g-level, store level (0 = no store), frozen flag, LLR-live level
    bitmask, bit-live level bitmask (bit l set = level l live)."""

    _, store, frozen, _, llr_live, bit_live, glevel = schedule_tables(N, info_np)
    n = int(math.log2(N))
    weights = (1 << np.arange(n + 1)).astype(np.int64)
    return np.stack([
        glevel,
        np.argmax(store, axis=1),  # all-zero row (last phase) gives 0
        frozen,
        (llr_live.astype(np.int64) * weights).sum(axis=1),
        (bit_live.astype(np.int64) * weights).sum(axis=1),
    ]).astype(np.int32)


__all__ = ["schedule_tables", "kernel_tables"]
