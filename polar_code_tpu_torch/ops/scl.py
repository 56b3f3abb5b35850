"""Batched CRC-aided SCL list decoder in plain PyTorch (port of `polar_code_tpu/ops/scl.py`).

This is the plain version of the SCL kernel (`ops/scl_cuda.py`): it decodes
CPU tensors for the sweep and the tests, and it is the oracle every kernel
check compares against on the card.  Semantics are those of the JAX decoder:

* compact per-path state, one active node per tree level (N−1 LLRs and N−1
  partial sums per path), updated on the static O(N log N) schedule;
* exact path metric with the penalty ``max(x,0) + log1p(exp(−|x|))`` — the
  form the kernel evaluates, equal to ``logaddexp(0, x)``;
* fork both bits at free info phases, stable sort on (metric, creation
  index 2p+b), keep the best M; forced plans (−1 free / 0 / 1) mask the
  disallowed branch to +inf; unused list slots carry +inf;
* a final stable re-sort, then CRC selection: the first valid passing
  candidate, else candidate 0.

Layout is batch-last ([M, level rows, B]) as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..polar.construct import frozen_mask as _frozen_mask
from .crc import check_matrix
from .sc import f_minsum, g_update


@dataclass
class SCLResult:
    """Batched SCL decode output (batch-first).

    candidates:  int8 [B, M, K]  — info+CRC bits per surviving path, sorted
                                   by final path metric.
    metrics:     [B, M]          — path metrics (+inf for unused slots).
    valid:       bool [B, M]     — real (reachable) paths.
    info_llrs:   [B, M, K]       — decision LLR per info phase per path.
    best_index:  int32 [B]       — CRC-selected candidate (or 0 fallback).
    best_path_bits:      int8 [B, K]
    best_path_info_llrs: [B, K]
    crc_pass:    bool [B]        — best candidate passes the CRC (False when
                                   no CRC was requested).
    """

    candidates: torch.Tensor
    metrics: torch.Tensor
    valid: torch.Tensor
    info_llrs: torch.Tensor
    best_index: torch.Tensor
    best_path_bits: torch.Tensor
    best_path_info_llrs: torch.Tensor
    crc_pass: torch.Tensor


def level_offsets(N: int) -> dict:
    """Compact per-path storage offsets: level l (1..n) holds N>>l values
    starting at N − (N >> (l−1))."""

    return {level: N - (N >> (level - 1)) for level in range(1, int(math.log2(N)) + 1)}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as max(x, 0) + log1p(exp(−|x|)) — the kernel's form."""

    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def decode_scl_batch(
    llr: torch.Tensor,
    info_set,
    M: int,
    crc: Optional[str] = None,
    *,
    force_info_bits: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> SCLResult:
    """Decode a batch of frames with list size M.

    llr:             [B, N] channel LLRs.
    info_set:        int vector (sorted ascending), K entries.
    crc:             optional hex polynomial for candidate selection.
    force_info_bits: optional int [B, K] with entries −1 (free) / 0 / 1.
    """

    if M <= 0:
        raise ValueError("List size M must be positive")
    if llr.is_cuda:
        decode_scl_batch.cuda_calls += 1
    info_np = np.asarray(info_set, dtype=np.int64)
    B, N = int(llr.shape[0]), int(llr.shape[1])
    n = int(math.log2(N))
    if 1 << n != N:
        raise ValueError("N must be a power of two")
    K = int(info_np.size)
    dev = llr.device
    frozen = _frozen_mask(N, info_np)
    off = level_offsets(N)
    state_len = N - 1

    chan = llr.T.to(dtype)  # [N, B], shared by all paths
    llr_st = torch.zeros((M, state_len, B), dtype=dtype, device=dev)
    bit_st = torch.zeros((M, state_len, B), dtype=torch.int8, device=dev)
    pm = torch.full((M, B), math.inf, dtype=dtype, device=dev)
    pm[0] = 0.0
    u_info = torch.zeros((M, K, B), dtype=torch.int8, device=dev)
    info_llrs = torch.zeros((M, K, B), dtype=dtype, device=dev)

    forced = None
    if force_info_bits is not None:
        forced = force_info_bits.to(device=dev, dtype=torch.int8).T  # [K, B]
        bit_of = (torch.arange(2 * M, device=dev) & 1).to(torch.int8)[:, None]

    def run_updates(phase: int) -> None:
        """Statically-scheduled f/g updates bringing the leaf LLR current."""

        if phase == 0:
            levels = [(l, "f") for l in range(1, n + 1)]
        else:
            k = (phase & -phase).bit_length() - 1  # count trailing zeros
            levels = [(n - k, "g")] + [(l, "f") for l in range(n - k + 1, n + 1)]
        for level, op in levels:
            half = N >> level
            if level == 1:
                a, b = chan[:half], chan[half:]  # broadcast over the list
            else:
                po = off[level - 1]
                a = llr_st[:, po : po + half, :]
                b = llr_st[:, po + half : po + 2 * half, :]
            o = off[level]
            if op == "f":
                child = f_minsum(a, b)
            else:
                child = g_update(a, b, bit_st[:, o : o + half, :])
            llr_st[:, o : o + half, :] = child

    def propagate_bits(phase: int, cur: torch.Tensor) -> None:
        """Partial-sum combine while the node index is odd (static chain)."""

        level, node, size = n, phase, 1
        while level > 0 and node % 2 == 1:
            o = off[level]
            cur = torch.cat([bit_st[:, o : o + size, :] ^ cur, cur], dim=1)
            node //= 2
            level -= 1
            size *= 2
        if level > 0:
            o = off[level]
            bit_st[:, o : o + size, :] = cur

    info_index = 0
    for phase in range(N):
        run_updates(phase)
        leaf = llr_st[:, off[n], :]  # [M, B]

        if frozen[phase]:
            pm = pm + softplus(-leaf)
            propagate_bits(phase, torch.zeros((M, 1, B), dtype=torch.int8, device=dev))
            continue

        i = info_index
        info_index += 1

        # candidate metrics in creation order c = 2p + b
        cand_pm = torch.stack([pm + softplus(-leaf), pm + softplus(leaf)], dim=1)
        cand_pm = cand_pm.reshape(2 * M, B)
        if forced is not None:
            fb = forced[i][None, :]
            cand_pm = torch.where((fb != -1) & (bit_of != fb), math.inf, cand_pm)

        winners = torch.argsort(cand_pm, dim=0, stable=True)[:M]  # [M, B]
        parent = winners >> 1
        bit = (winners & 1).to(torch.int8)

        pidx = parent[:, None, :]
        llr_st = torch.gather(llr_st, 0, pidx.expand(M, state_len, B))
        bit_st = torch.gather(bit_st, 0, pidx.expand(M, state_len, B))
        u_info = torch.gather(u_info, 0, pidx.expand(M, K, B))
        info_llrs = torch.gather(info_llrs, 0, pidx.expand(M, K, B))
        pm = torch.gather(cand_pm, 0, winners)

        u_info[:, i, :] = bit
        info_llrs[:, i, :] = torch.gather(leaf, 0, parent)
        propagate_bits(phase, bit[:, None, :])

    # final stable sort by metric (trailing frozen phases can reorder)
    final_order = torch.argsort(pm, dim=0, stable=True)  # [M, B]
    pm = torch.gather(pm, 0, final_order)
    fidx = final_order[:, None, :]
    u_info = torch.gather(u_info, 0, fidx.expand(M, K, B))
    info_llrs = torch.gather(info_llrs, 0, fidx.expand(M, K, B))
    valid = torch.isfinite(pm)  # [M, B]

    if crc is not None:
        # float32 product of 0/1 values: sums ≤ K are exact
        Hc = torch.as_tensor(np.asarray(check_matrix(crc, K), np.float32), device=dev)
        syn = torch.remainder(torch.einsum("dk,mkb->mdb", Hc, u_info.to(torch.float32)), 2.0)
        crc_ok = torch.all(syn == 0.0, dim=1) & valid  # [M, B]
        crc_pass = torch.any(crc_ok, dim=0)
        first_ok = torch.argmax(crc_ok.to(torch.uint8), dim=0)  # first True
        best_index = torch.where(crc_pass, first_ok, 0).to(torch.int32)
    else:
        best_index = torch.zeros((B,), dtype=torch.int32, device=dev)
        crc_pass = torch.zeros((B,), dtype=torch.bool, device=dev)

    bsel = best_index.long()[None, None, :].expand(1, K, B)
    best_bits = torch.gather(u_info, 0, bsel)[0]  # [K, B]
    best_llrs = torch.gather(info_llrs, 0, bsel)[0]

    return SCLResult(
        candidates=u_info.permute(2, 0, 1),
        metrics=pm.T,
        valid=valid.T,
        info_llrs=info_llrs.permute(2, 0, 1),
        best_index=best_index,
        best_path_bits=best_bits.T,
        best_path_info_llrs=best_llrs.T,
        crc_pass=crc_pass,
    )


# calls made on CUDA tensors: the sweep on the card must leave this at 0
decode_scl_batch.cuda_calls = 0


__all__ = ["decode_scl_batch", "SCLResult", "softplus", "level_offsets"]
