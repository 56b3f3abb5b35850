"""PAC (polarization-adjusted convolutional) codes (port of
`polar_code_tpu/legacy/pac.py`).

Rate-profile masked convolutional precoding in bit-reversed order, the polar
transform, and a list decoder that

* visits leaves in bit-reversed u-order (tree order j, u index bitrev(j)),
  which is the natural halves butterfly on the bit-reversal-permuted LLRs,
* uses the hard-decision path metric ``PM += |LLR|`` when the *convolved*
  edge bit disagrees with the channel hard decision,
* forks at info positions into a [good-branch × L, bad-branch × L]
  candidate layout pruned by a stable sort,
* selects the final path by CRC over the extracted bits, else best metric.

`pac_list_decode_batch` is the plain PyTorch version, a line-for-line port
of the JAX function; it serves CPU tensors and is the oracle of the CUDA
kernel `csrc/pac_decode.cu` (`legacy/pac_cuda.py`).  `pac_decode` routes a
CUDA tensor to the kernel, or raises for a shape the kernel does not take,
and a CPU tensor to the plain version.  Every f, g and metric operation is a
single float32 operation, so both give the JAX decoder's outputs exactly.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..ops.crc import check_matrix
from ..ops.polar_transform import polar_transform
from .rate_profile import bitreversed


@functools.lru_cache(maxsize=None)
def bitrev_perm(N: int) -> np.ndarray:
    n = int(math.log2(N))
    perm = np.array([bitreversed(j, n) for j in range(N)], dtype=np.int64)
    perm.setflags(write=False)
    return perm


@functools.lru_cache(maxsize=None)
def conv_transform_matrix(gen: Tuple[int, ...], N: int) -> np.ndarray:
    """T [N, N] with u = T·v mod 2 — the bit-reversed-order convolution.

    Column k is the convolution of the unit vector e_k: the shift register
    advances along bit-reversed positions; output lands at the same
    positions.
    """

    n = int(math.log2(N))
    order = np.array([bitreversed(j, n) for j in range(N)])  # step q visits u index order[q]
    step = np.empty(N, np.int64)
    step[order] = np.arange(N)
    # the register holds the inputs of the last len(gen) − 1 steps, so e_k,
    # fed at step step[k], reaches the output of step step[k] + t through
    # tap t: one entry a set tap (distinct rows, so no XOR folds two)
    T = np.zeros((N, N), dtype=np.int8)
    cols = np.arange(N)
    for t, g in enumerate(gen):
        if g:
            q = step + t
            ok = q < N
            T[order[q[ok]], cols[ok]] = 1
    T.setflags(write=False)
    return T


def pac_encode_batch(
    info: torch.Tensor, mask: np.ndarray, gen, N: int, systematic: bool = False
) -> torch.Tensor:
    """info [B, Kp] → PAC codeword int8 [B, N] (mask in natural u-index order).

    The precoder is one float32 product of 0/1 values mod 2: every entry is a
    count <= N, exact in float32 (and in TF32, whose accumulation is float32).
    """

    mask = np.asarray(mask)
    positions = torch.as_tensor(np.where(mask == 1)[0], device=info.device)
    B = int(info.shape[0])
    v = torch.zeros((B, N), dtype=torch.int8, device=info.device)
    v[:, positions] = info.to(torch.int8)
    T = torch.tensor(conv_transform_matrix(tuple(int(g) for g in gen), N),
                     dtype=torch.float32, device=info.device)
    u = torch.remainder(v.to(torch.float32) @ T.T, 2.0).to(torch.int8)
    x = polar_transform(u)
    if systematic:
        x = polar_transform(x * torch.as_tensor(mask, dtype=torch.int8, device=info.device))
    return x


def _level_offsets(N: int):
    off = {}
    o = 0
    n = int(math.log2(N))
    for level in range(1, n + 1):
        off[level] = o
        o += N >> level
    return off, o


def pac_list_decode_batch(
    llr: torch.Tensor,
    mask: np.ndarray,
    gen,
    L: int,
    *,
    crc_len: int = 0,
    crc_poly: int = 0,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Batched PAC list decode.  llr: [B, N] channel LLRs.

    Returns {"extracted" int8 [B, Kp] (CRC-selected / best metric),
             "candidates" int8 [B, L, Kp], "metrics" [B, L], "valid" bool
             [B, L], "crc_pass" bool [B], "v_full" int8 [B, L, N],
             "best_index" int64 [B] (the selected rank)}.
    """

    gen = [int(g) for g in gen]
    if gen[0] != 1:
        raise ValueError("convolution generator must start with 1")
    if llr.is_cuda:
        pac_list_decode_batch.cuda_calls += 1
    mem = len(gen) - 1
    mask = np.asarray(mask)
    B, N = int(llr.shape[0]), int(llr.shape[1])
    n = int(math.log2(N))
    dev = llr.device
    perm = bitrev_perm(N)
    # mask in tree-phase order: phase j decides u[bitrev(j)]
    mask_rev = mask[perm]
    Kp = int(mask.sum())
    off, state_len = _level_offsets(N)

    # adjacent-pair butterfly == halves butterfly on bit-rev-permuted LLRs
    chan = llr[:, torch.tensor(perm, device=dev)].T.to(dtype)  # [N, B]

    llr_st = torch.zeros((L, state_len, B), dtype=dtype, device=dev)
    bit_st = torch.zeros((L, state_len, B), dtype=torch.int8, device=dev)
    pm = torch.full((L, B), math.inf, dtype=dtype, device=dev)
    pm[0] = 0.0
    conv_state = torch.zeros((L, max(mem, 1), B), dtype=torch.int8, device=dev)
    v_dec = torch.zeros((L, N, B), dtype=torch.int8, device=dev)  # message bits by u-index
    gen_taps = torch.as_tensor(gen[1:], dtype=torch.int8, device=dev)

    def conv_edge_base(conv_state):
        # parity of (state · gen[1:]) — the edge bit contributed by memory
        if mem == 0:
            return torch.zeros((L, B), dtype=torch.int8, device=dev)
        taps = gen_taps[None, :, None]
        return torch.remainder(torch.sum(conv_state * taps, dim=1), 2).to(torch.int8)

    def shift_state(conv_state, v_bits):
        # state ← [v, state[:-1]]
        if mem == 0:
            return conv_state
        return torch.cat([v_bits[:, None, :], conv_state[:, : mem - 1, :]], dim=1)

    def run_updates(llr_st, bit_st, phase: int):
        if phase == 0:
            levels = [(l, "f") for l in range(1, n + 1)]
        else:
            k = (phase & -phase).bit_length() - 1
            levels = [(n - k, "g")] + [(l, "f") for l in range(n - k + 1, n + 1)]
        for level, op in levels:
            half = N >> level
            if level == 1:
                a, b = chan[:half], chan[half:]
            else:
                po = off[level - 1]
                parent = llr_st[:, po : po + (N >> (level - 1)), :]
                a, b = parent[:, :half, :], parent[:, half:, :]
            o = off[level]
            if op == "f":
                child = torch.sign(a) * torch.sign(b) * torch.minimum(torch.abs(a), torch.abs(b))
            else:
                c = bit_st[:, o : o + half, :]
                child = b + (1.0 - 2.0 * c.to(dtype)) * a
            if child.dim() == 2:
                child = child.expand(L, half, B)
            llr_st[:, o : o + half, :] = child
        return llr_st

    def propagate_bits(bit_st, phase: int, cur: torch.Tensor):
        level, node, size = n, phase, 1
        while level > 0 and node % 2 == 1:
            o = off[level]
            left = bit_st[:, o : o + size, :]
            cur = torch.cat([left ^ cur, cur], dim=1)
            node //= 2
            level -= 1
            size *= 2
        if level > 0:
            o = off[level]
            bit_st[:, o : o + size, :] = cur
        return bit_st

    def take(x, idx):
        # take_along_axis over the path axis: x [L', ...], idx [L, B]
        shape = (idx.shape[0],) + tuple(x.shape[1:])
        return torch.gather(x, 0, idx.view(idx.shape[0], *([1] * (x.dim() - 2)), B).expand(shape))

    for phase in range(N):
        u_index = int(perm[phase])
        llr_st = run_updates(llr_st, bit_st, phase)
        leaf = llr_st[:, off[n], :]  # [L, B]
        hard = (leaf < 0).to(torch.int8)
        base = conv_edge_base(conv_state)  # edge bit for v = 0

        if mask_rev[phase] == 0:
            # frozen: v = 0, edge = base; penalize edge ≠ hard decision
            pm = pm + torch.where(base != hard, torch.abs(leaf), 0.0)
            conv_state = shift_state(conv_state, torch.zeros((L, B), dtype=torch.int8, device=dev))
            bit_st = propagate_bits(bit_st, phase, base[:, None, :])
            continue

        # info: good branch (edge == hard, no penalty) first, bad second
        v_good = base ^ hard  # v with conv edge matching the hard decision
        pm_bad = pm + torch.abs(leaf)
        cand_pm = torch.cat([pm, pm_bad], dim=0)  # [2L, B]

        order = torch.argsort(cand_pm, dim=0, stable=True)  # [2L, B]
        winners = order[:L]
        parent = torch.remainder(winners, L)
        is_bad = (winners >= L).to(torch.int8)

        llr_st = take(llr_st, parent)
        bit_st = take(bit_st, parent)
        conv_state = take(conv_state, parent)
        v_dec = take(v_dec, parent)
        pm = torch.gather(cand_pm, 0, winners)

        v_bit = torch.gather(v_good, 0, parent) ^ is_bad
        edge = torch.gather(base, 0, parent) ^ v_bit  # gen[0] = 1

        v_dec[:, u_index, :] = v_bit
        conv_state = shift_state(conv_state, v_bit)
        bit_st = propagate_bits(bit_st, phase, edge[:, None, :])

    # final stable sort, extraction, CRC selection
    final_order = torch.argsort(pm, dim=0, stable=True)
    pm = torch.gather(pm, 0, final_order)
    v_dec = take(v_dec, final_order)

    positions = torch.as_tensor(np.where(mask == 1)[0], device=dev)
    cand = v_dec[:, positions, :]  # [L, Kp, B]
    valid = torch.isfinite(pm)

    if crc_len > 0:
        full_poly = hex((1 << crc_len) | crc_poly)
        Hc = torch.tensor(check_matrix(full_poly, Kp), dtype=dtype, device=dev)
        syn = torch.remainder(torch.einsum("dk,lkb->ldb", Hc, cand.to(dtype)), 2.0)
        crc_ok = torch.all(syn == 0.0, dim=1) & valid
        any_ok = torch.any(crc_ok, dim=0)
        first_ok = torch.argmax(crc_ok.to(torch.int32), dim=0)
        best_index = torch.where(any_ok, first_ok, 0)
        crc_pass = any_ok
    else:
        best_index = torch.zeros((B,), dtype=torch.int64, device=dev)
        crc_pass = torch.zeros((B,), dtype=torch.bool, device=dev)

    extracted = take(cand, best_index[None, :])[0]  # [Kp, B]

    return {
        "extracted": extracted.T.contiguous(),
        "candidates": cand.permute(2, 0, 1),
        "metrics": pm.T,
        "valid": valid.T,
        "crc_pass": crc_pass,
        "v_full": v_dec.permute(2, 0, 1),  # [B, L, N] message-domain bits
        "best_index": best_index,
    }


pac_list_decode_batch.cuda_calls = 0  # runs of the plain version on CUDA tensors


def pac_decode(
    llr: torch.Tensor,
    mask: np.ndarray,
    gen,
    L: int,
    *,
    crc_len: int = 0,
    crc_poly: int = 0,
    backend: str = "auto",
    full: bool = False,
) -> dict:
    """Decode with the backend the tensor's device calls for.

    A CUDA tensor goes through the kernel (`backend` "auto" or "pallas", the
    JAX names), which raises ValueError for a shape it does not take; there
    is no fallback to the plain version on the card.  A CPU tensor runs the
    plain version, whatever the backend.  Returns at least {"extracted",
    "crc_pass"}; the plain version, and the kernel under `full`,
    additionally return candidates/metrics/valid/v_full/best_index.
    """

    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if not llr.is_cuda:
        return pac_list_decode_batch(llr, mask, gen, L, crc_len=crc_len, crc_poly=crc_poly)
    if backend == "xla":
        raise ValueError("the plain decoder runs on CPU tensors; CUDA tensors decode "
                         "through the PAC kernel (backend 'auto' or 'pallas')")
    from .pac_cuda import pac_list_decode_cuda

    return pac_list_decode_cuda(llr, mask, gen, L, crc_len=crc_len, crc_poly=crc_poly, full=full)


__all__ = [
    "pac_encode_batch",
    "pac_list_decode_batch",
    "pac_decode",
    "conv_transform_matrix",
    "bitrev_perm",
]
