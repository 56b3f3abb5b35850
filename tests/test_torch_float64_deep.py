"""Float64 over warps: K1 and K3 at list sizes 33–1024 and N up to 8192, on the CPU.

The kernels' float64 over-warps instantiations (`scl_deep_kernel<T, LIST,
double>`, `pac_deep_kernel<T, LIST, double>`) run only on the card.  Here,
with no card and no JAX compile:

* the port's plain decoders in float64 against `tests/golden/scl_f64_deep.npz`,
  the JAX package's XLA decoders under x64 on the same float64 LLRs
  (`tests/golden/make_scl_f64_deep.py`): bits, CRC flags, candidates, the
  selected rank and every PAC list field exactly, metrics and info LLRs
  within 1e-12 relative;
* a numpy model of the block-wide sort on the float64 pair key
  (`block_sort_keys<DKey>` in `csrc/list_decode.cuh`), stage by stage
  through its buffer of metrics and indices side by side, against numpy's
  stable argsort, with ±0, exact ties, +inf (a candidate a plan turns off,
  a path never reached) and the (+inf, all ones) pads; the model is
  `tests/test_torch_deep_lists.py::_block_sort` with the pair compare;
* the frame bytes at 8-byte LLRs against a written model of `deep_layout`,
  and the global scratch;
* the float64 over-warps plan on a stand-in occupancy calculator.

The kernel-against-plain cases are marked `gpu` and skip here;
`chip_smoke.py` phase 21 runs them on the card.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from polar_code_tpu_torch.legacy import pac_cuda
from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch
from polar_code_tpu_torch.legacy.pac_cuda import pac_list_decode_cuda
from polar_code_tpu_torch.ops import scl_cuda
from polar_code_tpu_torch.ops.scl import decode_scl_batch

GOLDEN = Path(__file__).resolve().parent / "golden" / "scl_f64_deep.npz"
REL = 1e-12
F64 = torch.float64
PAD_INDEX = 0xFFFFFFFF


def _gold():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


GOLD = _gold()
CASES = {c["name"]: c for c in json.loads(str(GOLD["cases"]))}
SCL_CASES = [n for n, c in CASES.items() if c["code"] != "pac128"]
PAC_CASES = [n for n, c in CASES.items() if c["code"] == "pac128"]


def assert_close(got, want, what):
    """Equal where not finite, within REL relative elsewhere."""

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    np.testing.assert_allclose(got[fin], want[fin], rtol=REL, atol=0.0, err_msg=what)


@pytest.mark.parametrize("name", SCL_CASES)
def test_plain_scl_float64_equals_jax_over_warps(name):
    case = CASES[name]
    code = case["code"]
    llr = torch.from_numpy(GOLD[f"{code}/llr"])
    plan = torch.from_numpy(GOLD[f"{code}/plan"]) if case["plan"] else None
    res = decode_scl_batch(llr, GOLD[f"{code}/info"], case["M"], case["crc"], force_info_bits=plan, dtype=F64)
    np.testing.assert_array_equal(res.best_path_bits.numpy(), GOLD[f"{name}/bits"])
    np.testing.assert_array_equal(res.crc_pass.numpy(), GOLD[f"{name}/crc_pass"])
    assert res.best_path_info_llrs.dtype == res.metrics.dtype == F64
    assert_close(res.best_path_info_llrs, GOLD[f"{name}/llrs"], "best-path info LLRs")
    assert_close(res.metrics, GOLD[f"{name}/metrics"], "metrics")
    if case["full"]:
        np.testing.assert_array_equal(res.candidates.numpy(), GOLD[f"{name}/candidates"])
        np.testing.assert_array_equal(res.best_index.numpy(), GOLD[f"{name}/best_index"])
    if case["info_llrs"]:
        assert_close(res.info_llrs, GOLD[f"{name}/info_llrs"], "list info LLRs")


@pytest.mark.parametrize("name", PAC_CASES)
def test_plain_pac_float64_equals_jax_over_warps(name):
    case = CASES[name]
    llr = torch.from_numpy(GOLD["pac128/llr"])
    out = pac_list_decode_batch(llr, GOLD["pac128/mask"], case["gen"], case["L"], crc_len=case["crc_len"],
                                crc_poly=case["crc_poly"], dtype=F64)
    for f in ("extracted", "crc_pass", "candidates", "v_full", "valid"):
        np.testing.assert_array_equal(out[f].numpy(), GOLD[f"{name}/{f}"], err_msg=f)
    assert out["metrics"].dtype == F64
    assert_close(out["metrics"], GOLD[f"{name}/metrics"], "metrics")


def test_golden_file_covers_the_slice():
    """Float64 LLRs that a float32 cast would move, the list sizes of both
    trace-entry widths (128 and 129), and the file's size."""

    for code in ("p128", "n1024", "pac128"):
        x = GOLD[f"{code}/llr"]
        assert x.dtype == np.float64
        rel = np.abs(x.astype(np.float32).astype(np.float64) - x) / np.abs(x)
        assert np.median(rel) > 1e-9, code
    ms = {c["M"] for c in CASES.values() if c["code"] == "p128"}
    assert {33, 64, 128, 129, 256, 1024} <= ms
    assert {c["L"] for c in CASES.values() if c["code"] == "pac128"} == {33, 64, 256, 1024}
    assert GOLDEN.stat().st_size < 1_500_000


# ---- the block-wide sort on the float64 pair key ----

def _less(am, ai, bm, bi):
    """`DKey`'s operator<: the metric, then the index (±0 compare equal)."""

    return (am < bm) | ((am == bm) & (ai < bi))


def _block_sort_pairs(metric, index, M):
    """`block_sort_keys<DKey>` on a block of P/2 threads, P = `sort_keys(M)`:
    thread t holds keys 2t and 2t + 1 (pads (+inf, 0xFFFFFFFF) from t = M
    on), and the network runs stage by stage: across warps through the
    buffer (the metrics double[P] and beside them the indices uint32[P],
    `store_key_pair`), by shuffles within a warp and in registers; the
    upper half's threads stop after the last merge's first stage.  Returns
    the lower half it stores, as (metrics, indices), and the stages of each
    kind."""

    P = scl_cuda.sort_keys(M)
    T = P // 2
    t = np.arange(T)
    base = 2 * t
    km = np.full(P, np.inf)
    ki = np.full(P, PAD_INDEX, np.int64)
    km[:2 * M], ki[:2 * M] = metric, index
    km, ki = km.reshape(T, 2), ki.reshape(T, 2)
    on = np.ones(T, bool)
    kinds = {"shared": 0, "shuffles": 0, "registers": 0}

    def exchange(om, oi, keep_min, who):
        take = who[:, None] & (_less(om, oi, km, ki) == keep_min)
        return np.where(take, om, km), np.where(take, oi, ki)

    size = 2
    while size <= P:
        up = ((base & size) == 0)[:, None]
        j = size // 2
        while j >= 64:  # the threads that run store their keys; each reads its partner's
            kinds["shared"] += 1
            buf_m = np.full(P, -np.inf)  # what no thread stored reads as a key below every other
            buf_i = np.zeros(P, np.int64)
            buf_m.reshape(T, 2)[on] = km[on]
            buf_i.reshape(T, 2)[on] = ki[on]
            at = (base ^ j)[:, None] + np.arange(2)
            keep_min = ((base & j) == 0)[:, None] == up
            km, ki = exchange(buf_m[at], buf_i[at], keep_min, on)
            if size == P:
                on &= base < P // 2
            j //= 2
        for j in (32, 16, 8, 4, 2):  # lane t ^ j/2, in the same warp: three shuffles a key
            if j < size:
                kinds["shuffles"] += 1
                partner = t ^ (j // 2)
                assert np.array_equal(partner // 32, t // 32) and np.array_equal(on[partner], on)
                keep_min = ((base & j) == 0)[:, None] == up
                km, ki = exchange(km[partner], ki[partner], keep_min, on)
        kinds["registers"] += 1
        swap = on & (_less(km[:, 1], ki[:, 1], km[:, 0], ki[:, 0]) == up[:, 0])  # k0 > k1
        km = np.where(swap[:, None], km[:, ::-1], km)
        ki = np.where(swap[:, None], ki[:, ::-1], ki)
        size *= 2
    return (km.reshape(-1)[:P // 2], ki.reshape(-1)[:P // 2]), kinds


def _fork_f64(rng, M, trial):
    """Good and bad candidate metrics of one fork in float64: distinct
    values a float32 could not tell apart, or heavy ties with ±0.0, +inf (a
    candidate a plan turns off, a path never reached) and 1e300, one side
    of some paths off, and paths off on both sides."""

    if trial == 0:
        good = 1.0 + rng.integers(0, 1 << 20, M) * 1e-12
        return good, good + rng.integers(1, 8, M) * 1e-13
    vals = np.array([0.0, -0.0, 0.5, 0.5 + 2 ** -40, 1.0, 1e300, np.inf])
    good, bad = vals[rng.integers(0, 7, M)], vals[rng.integers(0, 7, M)]
    if trial >= 2:
        off = rng.random(M) < 0.5
        good, bad = np.where(off, np.inf, good), np.where(off, bad, np.inf)
    if trial == 3:
        dead = rng.random(M) < 0.3
        good, bad = np.where(dead, np.inf, good), np.where(dead, np.inf, bad)
    return good, bad


@pytest.mark.parametrize("M", [33, 64, 65, 100, 128, 129, 256, 513, 1024])
def test_pair_key_block_sort_is_the_stable_sort(M):
    rng = np.random.default_rng(6400 + M)
    for trial in range(4):
        good, bad = _fork_f64(rng, M, trial)
        for layout in ("scl", "pac"):
            # thread p's keys at 2p and 2p + 1: SCL candidates 2p + b
            # (index 2p + b), PAC good p and bad p (index p and M + p)
            metric = np.empty(2 * M)
            metric[0::2], metric[1::2] = good, bad
            if layout == "scl":
                index = np.arange(2 * M)
                ordered = metric
            else:
                index = np.empty(2 * M, np.int64)
                index[0::2], index[1::2] = np.arange(M), M + np.arange(M)
                ordered = np.concatenate([good, bad])
            (om, oi), kinds = _block_sort_pairs(metric, index, M)
            want = np.argsort(ordered, kind="stable")  # −0.0 == +0.0: a stable argsort keeps their order
            np.testing.assert_array_equal(oi[:M], want[:M])
            np.testing.assert_array_equal(om[:M] == ordered[want[:M]], True)
            assert not (oi[:M] == PAD_INDEX).any()  # no pad ranks below M
            P = scl_cuda.sort_keys(M)
            # the lower half the threads store: the P/2 smallest keys in
            # order, pads (+inf, all ones) after every candidate, +inf ones too
            np.testing.assert_array_equal(oi[:min(2 * M, P // 2)], want[:P // 2])
            assert (oi[2 * M:] == PAD_INDEX).all() and np.isinf(om[2 * M:]).all()
    P = scl_cuda.sort_keys(M)
    p = P.bit_length() - 1
    assert sum(kinds.values()) == p * (p + 1) // 2
    assert kinds["registers"] == p
    assert kinds["shared"] == {128: 1, 256: 3, 512: 6, 1024: 10, 2048: 15}[P]  # the stages across warps


def test_final_rank_of_float64_metrics():
    """`final_rank<double>`: path m's stable (metric, slot) rank among the M
    metrics, ±0 equal and +inf (paths never reached) last in slot order,
    and the least rank of the paths that pass."""

    rng = np.random.default_rng(64)
    for M in (33, 129, 1024):
        for trial in range(4):
            pm = _fork_f64(rng, M, trial)[0]
            frank = np.array([np.sum((pm < pm[m]) | ((pm == pm[m]) & (np.arange(M) < m))) for m in range(M)])
            order = np.argsort(pm, kind="stable")
            np.testing.assert_array_equal(frank[order], np.arange(M))
            ok = (rng.random(M) < 0.2) & np.isfinite(pm)
            least = frank[ok].min() if ok.any() else M
            first = next((r for r, m in enumerate(order) if ok[m]), None)
            assert (least if least < M else None) == first


# ---- the frame's shared memory and the global scratch ----

def _r16(x):
    return (x + 15) // 16 * 16


def _deep_layout(N, M, G, entry, words, elem):
    """`deep_layout` in `csrc/list_decode.cuh`, region by region: (offsets,
    total).  The float64 keys are a double[P] and a uint32[P]; the leaf is
    `elem` bytes a path, the other published words 4."""

    n = int(math.log2(N))
    ss = (N >> G) - 1
    P = scl_cuda.sort_keys(M)
    sig_row = max(4, ((2 * n - 2) * entry + 3) // 4 * 4)
    off = {"sig": 0, "keys": _r16(M * sig_row)}
    off["key_index"] = off["keys"] + 8 * P if elem == 8 else None
    off["ls"] = off["keys"] + (12 if elem == 8 else 8) * P
    off["words"] = off["ls"] + _r16(elem * M * ss)
    off["syn"] = off["words"] + _r16(elem * M)
    off["bs"] = off["syn"] + (words - 1) * _r16(4 * M)
    off["sel"] = off["bs"] + _r16(M * ss)
    return off, off["sel"] + 16


@pytest.mark.parametrize("M", [33, 128, 129, 1024])
def test_deep_frame_bytes_at_float64(M):
    entry = scl_cuda.trace_entry_bytes(M)
    assert entry == (1 if M <= 128 else 2)
    for N in (16, 64, 128, 1024, 4096, 8192):
        n = int(math.log2(N))
        for G in range(n):
            off, total = _deep_layout(N, M, G, entry, 2, 8)
            # a thread's two metrics are one 16-byte store, its indices one 8-byte store
            assert off["keys"] % 16 == 0 and off["key_index"] % 16 == 0 and off["words"] % 16 == 0
            assert scl_cuda.deep_frame_bytes(N, M, G, 2, 8) == total
            assert scl_cuda.frame_bytes(N, N // 2, M, G, 8) == total
            assert pac_cuda.frame_bytes(N, N // 2, M, G, 8) == _deep_layout(N, M, G, entry, 3, 8)[1]
            # float32 is the layout it was: 8-byte keys, float rows and leaf
            assert scl_cuda.frame_bytes(N, N // 2, M, G) == _deep_layout(N, M, G, entry, 2, 4)[1]
        # the least frame (every level but the leaf in global scratch) fits a block
        assert scl_cuda.frame_bytes(N, N, M, n - 1, 8) <= scl_cuda.MAX_BLOCK_SMEM
        assert pac_cuda.frame_bytes(N, N, M, n - 1, 8) <= scl_cuda.MAX_BLOCK_SMEM
    # P(128,64) M=1024: 199,696 B at G=3, past a block at G=2 (float32 fits at G=2)
    assert scl_cuda.frame_bytes(128, 64, 1024, 3, 8) == 199696
    assert scl_cuda.frame_bytes(128, 64, 1024, 2, 8) > scl_cuda.MAX_BLOCK_SMEM
    assert scl_cuda.frame_bytes(128, 64, 1024, 2) <= scl_cuda.MAX_BLOCK_SMEM
    # global scratch: levels 1..G at 8 + 1 bytes an entry, the trace LLRs at
    # 8 (K1), the trace indices at the entry's bytes
    B, N, K, G = 64, 1024, 512, 5
    assert scl_cuda.scratch_bytes(B, N, K, M, G, 8) == B * M * (N - (N >> G)) * 9 + B * K * M * 8 + B * K * M * entry
    assert pac_cuda.scratch_bytes(B, N, K, M, G, 8) == B * M * (N - (N >> G)) * 9 + B * K * M * entry


def test_float64_takes_every_deep_list_size_up_to_8192():
    for M in range(scl_cuda.PATH_MAX_M + 1, scl_cuda.DEEP_MAX_M + 1):
        for N in (16, 128, 1024, 8192):
            scl_cuda.check_shape(N, N, M, "0x1864CFB", F64)
            pac_cuda.check_shape(N, N // 2, M, [1, 0, 1, 1, 0, 1, 1], 16 if N > 32 else 0, F64)


def test_float64_over_warps_plan_on_a_fake_calculator(monkeypatch):
    """The plans ask the occupancy of the float64 over-warps instantiations
    (`elem` 8) at their frames: one thread a path in blocks of
    `sort_keys(M) / 2` threads at the 64 registers of the 1024-thread launch
    bound, no frame past a block's shared memory.  At P(128,64) M=1024
    float64 takes G=3 where float32 takes 2."""

    seen = []

    def blocks(fbytes, M):
        if fbytes > scl_cuda.MAX_BLOCK_SMEM:
            return 0
        return min(65536 // (64 * (scl_cuda.sort_keys(M) // 2)), 32, (228 * 1024) // (fbytes + 1024))

    def occupancy(N, K, M, G, elem=4):
        seen.append(elem)
        return 1, blocks(scl_cuda.frame_bytes(N, K, M, G, elem), M)

    monkeypatch.setattr(scl_cuda, "_occupancy", occupancy)
    scl_cuda._plan.cache_clear()
    try:
        for N, K, M in ((128, 64, 33), (128, 64, 64), (128, 64, 256), (1024, 512, 64), (8192, 4096, 1024)):
            g32, g64 = scl_cuda.launch_plan(N, K, M, 4096)[0], scl_cuda.launch_plan(N, K, M, 4096, 8)[0]
            assert g64 >= g32, (N, M)
        assert scl_cuda.launch_plan(128, 64, 1024, 4096, 8) == (3, 1, 1)
        assert scl_cuda.launch_plan(128, 64, 1024, 4096) == (2, 1, 1)
        assert set(seen) == {4, 8}
    finally:
        scl_cuda._plan.cache_clear()
    monkeypatch.setattr(pac_cuda, "_occupancy", lambda N, Kp, L, G, elem=4: (
        1, blocks(pac_cuda.frame_bytes(N, Kp, L, G, elem), L)))
    pac_cuda.launch_plan.cache_clear()
    try:
        assert pac_cuda.launch_plan(128, 80, 1024, 8)[0] > pac_cuda.launch_plan(128, 80, 1024)[0]
        assert pac_cuda.launch_plan(128, 80, 256, 8)[0] >= pac_cuda.launch_plan(128, 80, 256)[0]
    finally:
        pac_cuda.launch_plan.cache_clear()


# ---- on the card (marker `gpu`; skipped without a CUDA device) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the float64 over-warps kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M", [33, 64, 129, 1024])
def test_k1_float64_over_warps_matches_plain_on_card(cuda_device, M):
    info = np.asarray(GOLD["p128/info"])
    x = torch.from_numpy(np.tile(GOLD["p128/llr"], (8, 1))).to(cuda_device)
    plan = torch.from_numpy(np.tile(GOLD["p128/plan"], (8, 1))).to(cuda_device)
    for forced in (None, plan):
        out = scl_cuda.decode_scl_cuda(x, info, M, "0x1864CFB", force_info_bits=forced, full=True)
        torch.cuda.synchronize()
        ref = decode_scl_batch(x, info, M, "0x1864CFB", force_info_bits=forced, dtype=F64)
        for f in scl_cuda.BEST_FIELDS + scl_cuda.LIST_FIELDS:
            assert torch.equal(out[f], getattr(ref, f).to(out[f].dtype)), f


@pytest.mark.gpu
@pytest.mark.parametrize("L", [33, 256, 1024])
def test_k3_float64_over_warps_matches_golden_on_card(cuda_device, L):
    case = CASES[f"pac128_L{L}"]
    x = torch.from_numpy(GOLD["pac128/llr"]).to(cuda_device)
    out = pac_list_decode_cuda(x, GOLD["pac128/mask"], case["gen"], L, case["crc_len"], case["crc_poly"], full=True)
    torch.cuda.synchronize()
    for f in ("extracted", "crc_pass", "v_full", "candidates", "valid"):
        np.testing.assert_array_equal(out[f].cpu().numpy(), GOLD[f"pac128_L{L}/{f}"], err_msg=f)
    assert_close(out["metrics"].cpu().numpy(), GOLD[f"pac128_L{L}/metrics"], "metrics")
