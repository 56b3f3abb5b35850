"""The PAC kernel's lazy clone, checked on the CPU.

* The fork-interval tables the kernel reads through its phase words
  (`gpar_need`, `comb_need`) equal the JAX `_schedule_tables` outputs at the
  PAC info sets: the `dega` and `pw` rate profiles in bit-reversed order,
  N from 32 to 1024, Kp = K + 16.
* Every shape of the kernel's envelope fits its σ registers.
* A model of the kernel's bookkeeping — every path writes its own physical
  rows, per-level path-origin maps σ compose at each fork and reset at each
  level write, and only the g's parent-LLR read and the partial-sum chain's
  left-bit reads go through σ, where the phase word says so — gives the
  plain decoder's `extracted` and `crc_pass` frame for frame, at N ∈ {32,
  64, 128, 256}, L ∈ {1, 2, 8, 32}, CRC-16 on and off, generators 1011011
  and [1].  The model keeps the kernel's other choices too: unwritten state
  starts as NaN (LLRs) and 2 (bits), and every leaf and left bit read is
  checked to be written; dead paths carry 3e38; each path carries its CRC
  syndrome and its shift register as a bit mask, gathered at forks; the
  selected path is walked back once through the trace.  Its arithmetic is
  the plain version's, so the outputs must be equal, not close.  Wherever
  the model reads a level's own row, it also asserts that level's σ is the
  identity.
* The model against the JAX XLA decoder on the same LLRs: run here at
  PAC(32, 8+16) L=2, and through the JAX outputs of the golden file at
  PAC(128,64)+CRC-16 L=8 and PAC(64,32) L=32.
"""

import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.legacy.pac import pac_list_decode_batch as jax_decode
from polar_code_tpu.ops.scl_pallas import _schedule_tables as jax_schedule
from polar_code_tpu_torch.legacy.crclib import crc as crc_lib
from polar_code_tpu_torch.legacy.pac import bitrev_perm, pac_encode_batch, pac_list_decode_batch
from polar_code_tpu_torch.legacy.pac_cuda import MAX_N, SIGMA_FIELDS, check_shape, frame_bytes, host_tables
from polar_code_tpu_torch.ops.scl_cuda import MAX_BLOCK_SMEM
from polar_code_tpu_torch.legacy.rate_profile import rateprofile
from polar_code_tpu_torch.ops.scl_schedule import schedule_tables

BIG = 3.0e38  # the kernel's metric of a dead path
CRC16 = (16, 0x1021)  # the legacy drivers' CRC
GENS = {"1011011": [1, 0, 1, 1, 0, 1, 1], "1": [1]}
GOLDEN = Path(__file__).resolve().parent / "golden" / "legacy_pac_decode.npz"


def _payload(N):
    return N // 2 if N >= 64 else N // 4


def _mask(N, profile="dega"):
    rp = rateprofile(N, _payload(N) + CRC16[0], 2.0, 0)
    rp.build_mask(profile)
    return np.asarray(rp.modify_profile())


@pytest.mark.parametrize("profile", ["dega", "pw"])
@pytest.mark.parametrize("N", [32, 64, 128, 256, 512, 1024])
def test_fork_tables_equal_jax_at_pac_info_sets(N, profile):
    mask = _mask(N, profile)
    info_phases = np.flatnonzero(mask[bitrev_perm(N)] == 1)
    assert info_phases.size == _payload(N) + CRC16[0]
    ours = schedule_tables(N, info_phases)
    ref = jax_schedule(N, info_phases.astype(np.int64))
    for name, a, b in zip(("upd", "store", "frozen", "infoidx", "llr_live", "bit_live",
                           "glevel", "gpar_need", "comb_need"), ours, ref):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} N={N} {profile}")
    # the kernel's words carry them: bit 11 gpar_need, bit 11 + l comb_need
    words, _, _ = host_tables(mask, *CRC16)
    np.testing.assert_array_equal(words & 31, ours[6])
    np.testing.assert_array_equal(words >> 10 & 1, ours[2])
    np.testing.assert_array_equal(words >> 11 & 1, ours[7])
    for lv in range(1, int(math.log2(N)) + 1):
        np.testing.assert_array_equal(words >> (11 + lv) & 1, ours[8][:, lv])
    # both kinds of read do cross forks at these sizes, and not always
    assert 0 < ours[7].sum() < N and 0 < ours[8].sum()


def test_sigma_registers_hold_the_envelope():
    """Every shape the kernel takes one path a lane has its 2n − 2 σ levels
    in its lanes' registers: N up to `MAX_N` = 8192 (n = 13, 24 fields), at
    every list size 2..32; a frame fits a block there once every level but
    the leaf is in global scratch (the fit rule), and N above 8192 raises."""

    assert MAX_N == 8192
    for L in range(2, 33):
        lm = 1 << (L - 1).bit_length()
        for n in range(1, 14):
            N = 1 << n
            assert 2 * n - 2 <= SIGMA_FIELDS[lm], (L, N)
            # the leaf rows, 5·L bytes rounded to 16, and a ring of 16 trace
            # rows: the trace is in global scratch, so every Kp fits
            ring = 16 * ((L + 15) // 16 * 16)
            assert frame_bytes(N, N // 2, L, n - 1) == (5 * L + 15) // 16 * 16 + ring <= MAX_BLOCK_SMEM
            check_shape(N, N // 2, L, [1], 0, torch.float32)
        check_shape(8192, 2, L, [1], 0, torch.float32)
        with pytest.raises(ValueError, match="8192"):
            check_shape(16384, 2, L, [1], 0, torch.float32)


def _sigma_gather(rows, sig):
    """rows [L, W, B] (physical), sig [L, B] → path m's view rows[σ[m]]."""

    return torch.gather(rows, 0, sig[:, None, :].expand(-1, rows.shape[1], -1))


def lazy_model(llr, mask, gen, L, crc_len, crc_poly):
    """The kernel's decode with its lazy clone, batched over frames."""

    B, N = llr.shape
    n = int(math.log2(N))
    words, out_pos, hcols = host_tables(mask, crc_len, crc_poly)
    glevel, store_level, frozen = words & 31, words >> 5 & 31, words >> 10 & 1
    gpar_need, cmask = words >> 11 & 1, words >> 11  # bit l of cmask: comb_need at level l
    Kp = out_pos.size
    hcols = torch.from_numpy(hcols.astype(np.int64))
    mem_mask = (1 << (len(gen) - 1)) - 1
    tap_mask = sum(1 << t for t, g in enumerate(gen[1:]) if g)
    off = {lv: N - (N >> (lv - 1)) for lv in range(1, n + 1)}  # the kernel's row offsets
    chan = llr[:, torch.from_numpy(bitrev_perm(N).copy())].T  # [N, B]: ch[brev(j)]
    Lr = torch.full((L, N - 1, B), math.nan)  # physical rows: path m writes row m
    Bt = torch.full((L, N - 1, B), 2, dtype=torch.int8)
    ident = torch.arange(L)[:, None].expand(L, B)
    sig = ident[None].repeat(2 * n - 1, 1, 1)  # row l−1: LLR level l; n+l−2: bit level l
    pm = torch.full((L, B), BIG)
    pm[0] = 0.0
    reg = torch.zeros((L, B), dtype=torch.int64)
    syn = torch.zeros((L, B), dtype=torch.int64)
    TI = torch.zeros((Kp, L, B), dtype=torch.int64)

    def own_row(r):  # a read of the path's own row: σ must be the identity there
        assert torch.equal(sig[r], ident)

    def f(a, b):
        return torch.sign(a) * torch.sign(b) * torch.minimum(torch.abs(a), torch.abs(b))

    def g(a, b, c):
        assert bool(((c == 0) | (c == 1)).all()), "a g read an unwritten bit"
        return b + (1.0 - 2.0 * c.to(torch.float32)) * a

    def update(p, lv, is_g):  # level lv's f or g from its parent level, every path
        half = N >> lv
        if lv == 1:
            a, b = chan[:half].expand(L, -1, -1), chan[half:].expand(L, -1, -1)
        else:
            rows = Lr[:, off[lv - 1] : off[lv - 1] + 2 * half]
            if is_g and gpar_need[p]:
                rows = _sigma_gather(rows, sig[lv - 2])
            else:
                own_row(lv - 2)
            a, b = rows[:, :half], rows[:, half:]
        if not is_g:
            return f(a, b)
        own_row(n + lv - 2)
        return g(a, b, Bt[:, off[lv] : off[lv] + half])

    info_i = 0
    for p in range(N):
        gl = int(glevel[p])
        l0 = 1 if p == 0 else gl
        for lv in range(l0, n):  # the descent to level n−1; a write resets σ
            Lr[:, off[lv] : off[lv] + (N >> lv)] = update(p, lv, p != 0 and lv == gl)
            sig[lv - 1] = ident  # (the kernel resets l0..n−1 at the phase's start: no σ read between)
        leaf = update(p, n, gl == n)[:, 0]  # [L, B], kept in a register
        assert not bool(torch.isnan(leaf).any()), f"phase {p} read an unwritten LLR"
        hard = (leaf < 0).to(torch.int64)
        base = torch.zeros_like(reg)
        for t in range(len(gen) - 1):  # parity of reg & tap_mask
            if tap_mask >> t & 1:
                base ^= reg >> t & 1

        if frozen[p]:
            pm = torch.where((pm < BIG) & (base != hard), pm + torch.abs(leaf), pm)
            reg = (reg << 1) & mem_mask
            edge = base
        else:
            cand = torch.cat([pm, torch.where(pm < BIG, pm + torch.abs(leaf), torch.tensor(BIG))])
            winners = torch.argsort(cand, dim=0, stable=True)[:L]
            parent = winners % L
            is_bad = (winners >= L).to(torch.int64)
            hp, bp = torch.gather(hard, 0, parent), torch.gather(base, 0, parent)
            v = bp ^ hp ^ is_bad
            pm = torch.gather(cand, 0, winners)
            edge = hp ^ is_bad
            reg = ((torch.gather(reg, 0, parent) << 1) | v) & mem_mask
            syn = torch.gather(syn, 0, parent) ^ (v * hcols[info_i])
            TI[info_i] = parent * 2 + v
            sig = torch.gather(sig, 1, parent[None].expand(2 * n - 1, L, B))  # σ ← σ[parent]
            info_i += 1

        s = int(store_level[p])
        if s > 0:
            cur = edge[:, None, :].to(torch.int8)
            for lv in range(n, s, -1):
                left = Bt[:, off[lv] : off[lv] + cur.shape[1]]
                if cmask[p] >> lv & 1:
                    left = _sigma_gather(left, sig[n + lv - 2])
                else:
                    own_row(n + lv - 2)
                assert bool(((left == 0) | (left == 1)).all()), f"phase {p} read an unwritten bit"
                cur = torch.cat([left ^ cur, cur], dim=1)
            Bt[:, off[s] : off[s] + cur.shape[1]] = cur
            sig[n + s - 2] = ident

    order = torch.argsort(pm, dim=0, stable=True)  # final stable re-sort
    ok = (syn == 0) & (pm < BIG) if crc_len else torch.zeros((L, B), dtype=torch.bool)
    ok_sorted = torch.gather(ok, 0, order)
    passed = ok_sorted.any(dim=0)
    sel_rank = torch.where(passed, torch.argmax(ok_sorted.to(torch.uint8), dim=0), 0)
    slot = torch.gather(order, 0, sel_rank[None])[0]
    by_phase = torch.zeros((Kp, B), dtype=torch.int8)  # the walk's record
    cols = torch.arange(B)
    for i in range(Kp - 1, -1, -1):
        w = TI[i, slot, cols]
        by_phase[i] = (w & 1).to(torch.int8)
        slot = w >> 1
    extracted = by_phase[torch.from_numpy(np.argsort(out_pos))].T  # lanes write ascending u
    return {"extracted": extracted.contiguous(), "crc_pass": passed}


def _frames(N, mask, gen, B, seed):
    """Float32 LLRs of CRC-16'd PAC codewords at a spread of SNRs (numpy draws)."""

    rng = np.random.default_rng(seed)
    k = _payload(N)
    msgs = rng.integers(0, 2, (B, k)).astype(np.int8)
    msgs = np.concatenate([msgs, crc_lib(*CRC16).crcCalc_batch(msgs)], axis=1)
    x = pac_encode_batch(torch.from_numpy(msgs), mask, gen, N).numpy()
    snr = rng.uniform(-1.0, 4.0, (B, 1))
    nv = 1.0 / (2.0 * (k / N) * 10 ** (snr / 10.0))
    y = 1.0 - 2.0 * x + rng.normal(0.0, 1.0, x.shape) * np.sqrt(nv)
    return torch.from_numpy((2.0 * y / nv).astype(np.float32))


@pytest.mark.parametrize("L", [1, 2, 8, 32])
@pytest.mark.parametrize("N", [32, 64, 128, 256])
def test_lazy_clone_model_equals_plain_decoder(N, L):
    mask = _mask(N)
    B = 24 if N < 256 else 12
    for gname, gen in GENS.items():
        llr = _frames(N, mask, gen, B, seed=N * 100 + L)
        for crc in (CRC16, (0, 0)):
            got = lazy_model(llr, mask, gen, L, *crc)
            ref = pac_list_decode_batch(llr, mask, gen, L, crc_len=crc[0], crc_poly=crc[1])
            tag = f"N={N} L={L} gen {gname} crc={crc[0]}"
            assert torch.equal(got["extracted"], ref["extracted"]), tag
            assert torch.equal(got["crc_pass"], ref["crc_pass"]), tag
            if crc[0]:  # the frames exercise both outcomes
                assert 0 < int(ref["crc_pass"].sum()) < B, tag


def test_lazy_clone_model_equals_jax_decoder():
    """The JAX XLA decoder run here, at PAC(32, 8+16) L=2 with CRC-16."""

    mask, gen = _mask(32), GENS["1011011"]
    llr = _frames(32, mask, gen, 16, seed=7)
    got = lazy_model(llr, mask, gen, 2, *CRC16)
    ref = jax_decode(jnp.asarray(llr.numpy()), mask, gen, 2, crc_len=CRC16[0],
                     crc_poly=CRC16[1], dtype=jnp.float32)
    np.testing.assert_array_equal(got["extracted"].numpy(), np.asarray(ref["extracted"]))
    np.testing.assert_array_equal(got["crc_pass"].numpy(), np.asarray(ref["crc_pass"]))


@pytest.mark.parametrize("name", ["pac128_crc16_L8", "sim64_L32"])
def test_lazy_clone_model_equals_jax_golden(name):
    """The JAX XLA decoder's outputs of `tests/golden/legacy_pac_decode.npz`
    (256 frames each), at PAC(128,64)+CRC-16 L=8 and PAC(64,32) L=32."""

    with np.load(GOLDEN) as g:
        case = next(c for c in json.loads(str(g["cases"])) if c["name"] == name)
        data = {k: g[f"{name}/{k}"] for k in ("llr", "mask", "extracted", "crc_pass")}
    got = lazy_model(torch.from_numpy(data["llr"]), data["mask"], case["gen"], case["L"],
                     case["crc_len"], case["crc_poly"])
    np.testing.assert_array_equal(got["extracted"].numpy(), data["extracted"])
    np.testing.assert_array_equal(got["crc_pass"].numpy(), data["crc_pass"])
