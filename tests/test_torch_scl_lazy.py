"""The SCL kernel's lazy clone, checked on the CPU.

* The fork-interval tables the kernel reads (`gpar_need`, `comb_need`)
  equal the JAX `_schedule_tables` outputs, N from 8 to 2048, for the
  `gaussian` and `gaussian_bitrev` constructions at K = N/2 and for random
  information sets.
* A model of the kernel's bookkeeping — every path writes its own physical
  rows, per-level path-origin maps σ compose at each fork, and only the
  g's parent-LLR read and the partial-sum chain's left-bit reads go through
  σ, where the kernel's table says so — gives the plain decoder's outputs
  frame for frame, at N ∈ {16, 64, 256}, M ∈ {2, 4, 8}, CRC on and off,
  with and without forced plans.  The model keeps the kernel's other
  choices too: unwritten state starts as NaN (LLRs) and 2 (bits), so a read
  before a write would show; dead paths carry 3e38; each path carries its
  CRC syndrome; the selected path is walked back through the trace.  Its
  arithmetic is the plain version's (`ops/sc.py`, `ops/scl.py::softplus`),
  so the outputs must be equal, not close.  Wherever the model reads a
  level's own row, it also asserts that level's σ is the identity.
"""

import math

import numpy as np
import pytest
import torch

from polar_code_tpu.ops.scl_pallas import _schedule_tables as jax_schedule
from polar_code_tpu_torch.ops.crc import attach_crc_batch, crc_degree
from polar_code_tpu_torch.ops.polar_transform import encode_batch
from polar_code_tpu_torch.ops.sc import f_minsum, g_update
from polar_code_tpu_torch.ops.scl import decode_scl_batch, level_offsets, softplus
from polar_code_tpu_torch.ops.scl_cuda import _device_tables
from polar_code_tpu_torch.ops.scl_schedule import schedule_tables
from polar_code_tpu_torch.polar.construct import construct_info_set

BIG = 3.0e38  # the kernel's metric of an unreachable path
# a CRC each code length can carry: degree 4, 8 and 24 (CRC-24A)
CRCS = {16: "0x13", 64: "0x107", 256: "0x1864CFB"}


def _info_sets():
    cases = []
    for N in (8, 16, 32, 64, 128, 256, 512, 1024, 2048):
        for method in ("gaussian", "gaussian_bitrev"):
            cases.append((N, method, construct_info_set(N, N // 2, method=method)))
    rng = np.random.default_rng(7)
    for N, K in ((16, 5), (64, 40), (256, 77), (1024, 300), (2048, 1500)):
        cases.append((N, f"random K={K}", np.sort(rng.choice(N, K, replace=False))))
    return cases


@pytest.mark.parametrize("N,label,info", _info_sets(), ids=lambda v: str(v) if not
                         isinstance(v, np.ndarray) else "")
def test_fork_tables_equal_jax(N, label, info):
    ours = schedule_tables(N, info)
    ref = jax_schedule(N, np.asarray(info, np.int64))
    assert len(ours) == len(ref) == 9
    for name, a, b in zip(("upd", "store", "frozen", "infoidx", "llr_live", "bit_live",
                           "glevel", "gpar_need", "comb_need"), ours, ref):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} N={N} {label}")
    # both kinds of read do cross forks at this size, and not always
    if N >= 64:
        assert 0 < ours[7].sum() < N and 0 < ours[8].sum()


def _sigma_gather(rows, sig):
    """rows [M, W, B] (physical), sig [M, B] → path m's view rows[σ[m]]."""

    return torch.gather(rows, 0, sig[:, None, :].expand(-1, rows.shape[1], -1))


def lazy_model(llr, info, M, crc, plan):
    """The kernel's decode with its lazy clone, batched over frames."""

    B, N = llr.shape
    n = int(math.log2(N))
    K = len(info)
    sched, hcols = _device_tables(tuple(int(i) for i in info), N, crc, torch.device("cpu"))
    words = sched.numpy()  # the kernel's phase words
    glevel, store_level, frozen = words & 31, words >> 5 & 31, words >> 10 & 1
    gpar_need, comb_need = words >> 11 & 1, words >> 11  # bit l of comb_need: level l
    off = level_offsets(N)
    chan = llr.T  # [N, B]
    L = torch.full((M, N - 1, B), math.nan)  # physical rows: path m writes row m
    Bt = torch.full((M, N - 1, B), 2, dtype=torch.int8)
    ident = torch.arange(M)[:, None].expand(M, B)
    sig = ident[None].repeat(2 * n - 1, 1, 1)  # row l−1: LLR level l; n+l−2: bit level l
    pm = torch.full((M, B), BIG)
    pm[0] = 0.0
    syn = torch.zeros((M, B), dtype=torch.int32)
    TI = torch.zeros((K, M, B), dtype=torch.long)
    TL = torch.zeros((K, M, B))
    forced = plan.T if plan is not None else None

    def own_row(r):  # a read of the path's own row: σ must be the identity there
        assert torch.equal(sig[r], ident)

    info_i = 0
    for p in range(N):
        gl = int(glevel[p])
        l0 = 1 if p == 0 else gl
        for lv in range(l0, n + 1):
            half = N >> lv
            is_g = p != 0 and lv == gl
            if lv == 1:
                a, b = chan[:half].expand(M, -1, -1), chan[half:].expand(M, -1, -1)
            else:
                rows = L[:, off[lv - 1] : off[lv - 1] + 2 * half]
                if is_g and gpar_need[p]:
                    rows = _sigma_gather(rows, sig[lv - 2])
                elif is_g:
                    own_row(lv - 2)
                a, b = rows[:, :half], rows[:, half:]
            if is_g:
                own_row(n + lv - 2)
                child = g_update(a, b, Bt[:, off[lv] : off[lv] + half])
            else:
                child = f_minsum(a, b)
            L[:, off[lv] : off[lv] + half] = child
        sig[l0 - 1 : n - 1] = ident
        leaf = L[:, off[n]]  # [M, B]

        bit = torch.zeros((M, B), dtype=torch.long)
        if frozen[p]:
            pm = pm + softplus(-leaf)
        else:
            cand = torch.stack([pm + softplus(-leaf), pm + softplus(leaf)], dim=1).reshape(2 * M, B)
            if forced is not None:
                fb = forced[info_i][None, :]
                cb = (torch.arange(2 * M) & 1)[:, None]
                cand = torch.where((fb != -1) & (cb != fb), torch.tensor(BIG), cand)
            winners = torch.argsort(cand, dim=0, stable=True)[:M]
            parent, bit = winners >> 1, winners & 1
            pm = torch.gather(cand, 0, winners)
            TI[info_i] = winners
            TL[info_i] = torch.gather(leaf, 0, parent)
            syn = torch.gather(syn, 0, parent) ^ (bit.to(torch.int32) * hcols[info_i])
            sig = torch.gather(sig, 1, parent[None].expand(2 * n - 1, M, B))  # σ ← σ[parent]
            info_i += 1

        s = int(store_level[p])
        if s > 0:
            cur = bit[:, None, :].to(torch.int8)
            for lv in range(n, s, -1):
                left = Bt[:, off[lv] : off[lv] + cur.shape[1]]
                if comb_need[p] >> lv & 1:
                    left = _sigma_gather(left, sig[n + lv - 2])
                else:
                    own_row(n + lv - 2)
                cur = torch.cat([left ^ cur, cur], dim=1)
            Bt[:, off[s] : off[s] + cur.shape[1]] = cur
            sig[n + s - 2] = ident

    order = torch.argsort(pm, dim=0, stable=True)  # final stable re-sort
    ok = (syn == 0) & (pm < BIG) if crc is not None else torch.zeros((M, B), dtype=torch.bool)
    ok_sorted = torch.gather(ok, 0, order)
    passed = ok_sorted.any(dim=0)
    sel_rank = torch.where(passed, torch.argmax(ok_sorted.to(torch.uint8), dim=0), 0)
    slot = torch.gather(order, 0, sel_rank[None])[0]
    bits = torch.zeros((K, B), dtype=torch.int8)
    llrs = torch.zeros((K, B))
    cols = torch.arange(B)
    for i in range(K - 1, -1, -1):
        w = TI[i, slot, cols]
        bits[i] = (w & 1).to(torch.int8)
        llrs[i] = TL[i, slot, cols]
        slot = w >> 1
    return {"best_path_bits": bits.T, "best_path_info_llrs": llrs.T, "crc_pass": passed}


def _frames(N, K, crc, B, seed):
    """float32 LLRs of CRC'd codewords at a spread of SNRs, and the sent bits."""

    rng = np.random.default_rng(seed)
    info = construct_info_set(N, K, method="gaussian_bitrev")
    deg = crc_degree(crc)
    payload = torch.from_numpy(rng.integers(0, 2, (B, K - deg)).astype(np.int8))
    msg = attach_crc_batch(payload, crc)
    code = encode_batch(msg, info, N).numpy()
    snr = rng.uniform(-3.0, 3.0, (B, 1))
    nv = 1.0 / (2.0 * (K / N) * 10 ** (snr / 10.0))
    y = 1.0 - 2.0 * code + rng.normal(0.0, 1.0, code.shape) * np.sqrt(nv)
    return torch.from_numpy((2.0 * y / nv).astype(np.float32)), msg.numpy(), info


def _plan(msg, seed):
    """DL-SCL-shaped plans: a prefix of sent bits, one flipped, the rest
    free; every third frame wholly free."""

    rng = np.random.default_rng(seed)
    B, K = msg.shape
    idx = rng.integers(0, K, B)
    pos = np.arange(K)[None, :]
    plan = np.where(pos < idx[:, None], msg, -1)
    plan = np.where(pos == idx[:, None], 1 - msg, plan).astype(np.int8)
    plan[::3] = -1
    return torch.from_numpy(plan)


@pytest.mark.parametrize("use_crc", [True, False])
@pytest.mark.parametrize("M", [2, 4, 8])
@pytest.mark.parametrize("N", [16, 64, 256])
def test_lazy_clone_model_equals_plain_decoder(N, M, use_crc):
    B = 48 if N < 256 else 24
    crc = CRCS[N]
    llr, msg, info = _frames(N, N // 2, crc, B, seed=N * 10 + M)
    for plan in (None, _plan(msg, seed=M)):
        got = lazy_model(llr, info, M, crc if use_crc else None, plan)
        ref = decode_scl_batch(llr, info, M, crc if use_crc else None, force_info_bits=plan,
                               dtype=torch.float32)
        tag = f"N={N} M={M} crc={use_crc} plan={plan is not None}"
        torch.testing.assert_close(got["best_path_bits"], ref.best_path_bits, rtol=0, atol=0,
                                   msg=tag)
        torch.testing.assert_close(got["best_path_info_llrs"], ref.best_path_info_llrs,
                                   rtol=0, atol=0, msg=tag)
        assert torch.equal(got["crc_pass"], ref.crc_pass), tag
        if use_crc:  # the frames exercise both outcomes
            assert 0 < int(ref.crc_pass.sum()) < B, tag
