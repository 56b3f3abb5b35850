"""Static per-phase SCL schedule tables (port of `polar_code_tpu/ops/scl_pallas.py:107` `_schedule_tables`).

Host-side NumPy.  For a code (N, info set) the decode schedule is fixed:
which tree levels each phase updates (f or g), where its partial-sum chain
stores, which phases are frozen, which levels are still live at each
phase's fork, and which reads can cross a fork.  The CUDA kernels read
these tables instead of recomputing them per frame: `phase_words` packs
them for the lazy clone of the SCL kernel and of the PAC kernel.
"""

from __future__ import annotations

import math

import numpy as np

from ..polar.construct import frozen_mask as _frozen_mask


def schedule_tables(N: int, info_np: np.ndarray):
    """Return (upd, store, frozen, infoidx, llr_live, bit_live, glevel,
    gpar_need, comb_need).

    upd       [N, n+1] int32: 0 none / 1 f / 2 g, per level 1..n
    store     [N, n+1] int32: 1 at the level the partial-sum chain stores to
    frozen    [N] int32
    infoidx   [N] int32: info index of each info phase
    llr_live  [N, n+1] int32: LLR level still read after the fork of phase p
    bit_live  [N, n+1] int32: partial-sum level still read after that fork
    glevel    [N] int32: the level of phase p's g update (0 at phase 0)
    gpar_need [N] int32: phase p's g reads its parent LLR level across a fork
    comb_need [N, n+1] int32: phase p's partial-sum chain reads the left bits
              of that level across a fork
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

    # Fork intervals for the lazy clone: a level's path-origin map σ is
    # reset to identity when every path rewrites the level, and composes
    # with the parents at each fork.  A read needs σ only if a fork (info
    # phase) happened between the level's last write and the read: replay
    # the schedule with a fork counter.  The descent of phase p writes LLR
    # levels gl..n (level n is read only at its own leaf); its g reads level
    # gl−1 before phase p's fork.  The chain runs after the fork, reads the
    # left bits of levels n..s+1 and writes level s.  The g's left-bit read
    # never crosses a fork (the chain of phase p−1 stores the level that
    # the g of phase p reads, with no fork between), so it has no flag.
    gpar_need = np.zeros(N, np.int32)
    comb_need = np.zeros((N, n + 1), np.int32)
    last_l = {lv: 0 for lv in range(1, n)}
    last_b = {lv: 0 for lv in range(1, n + 1)}
    forks = 0
    for p in range(N):
        gl = int(glevel[p])
        if gl > 1:
            gpar_need[p] = int(last_l[gl - 1] < forks)
        for lv in range((gl if gl > 0 else 1), n):
            last_l[lv] = forks
        if not frozen[p]:
            forks += 1
        lvl, node = n, p
        while lvl > 0 and node % 2 == 1:
            comb_need[p, lvl] = int(last_b[lvl] < forks)
            node //= 2
            lvl -= 1
        if lvl > 0:
            last_b[lvl] = forks

    return upd, store, frozen, infoidx, llr_live, bit_live, glevel, gpar_need, comb_need


def phase_words(N: int, info_np: np.ndarray) -> np.ndarray:
    """Pack the schedule into the int32 [N] phase words the SCL and PAC
    kernels read (the PAC kernel's info phases are its mask in bit-reversed
    order).

    Bits 0-4: g-level; 5-9: store level (0 = no store); 10: frozen; 11:
    `gpar_need`; 11 + l for l = 1..n: `comb_need` at level l (the chain
    reads level l's left bits through σ).  One word a phase lets the kernel
    load the next phase's schedule while it decodes this one."""

    _, store, frozen, _, _, _, glevel, gpar_need, comb_need = schedule_tables(N, info_np)
    n = int(math.log2(N))
    if n > 16:
        raise ValueError(f"the phase words take N up to 65536, not {N}")
    weights = (1 << np.arange(n + 1)).astype(np.int64)
    words = (glevel.astype(np.int64)
             | np.argmax(store, axis=1) << 5  # all-zero row (last phase) gives 0
             | frozen.astype(np.int64) << 10
             | gpar_need.astype(np.int64) << 11
             | (comb_need.astype(np.int64) * weights).sum(axis=1) << 11)
    return words.astype(np.int32)


__all__ = ["schedule_tables", "phase_words"]
