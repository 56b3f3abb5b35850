"""Float64 on a cluster: K1 and K3 at list sizes 1025–16384 and N up to 8192, on the CPU.

The kernels' float64 cluster instantiations (`scl_cluster_kernel<LIST,
double>`, `pac_cluster_kernel<LIST, double>`, one path a thread) run only
on the card.  Here:

* the port's plain decoders in float64 against
  `tests/golden/scl_f64_cluster.npz`, the JAX package's XLA decoders under
  x64 on the same float64 LLRs (`tests/golden/make_scl_f64_cluster.py`):
  bits, CRC flags, candidates, the selected rank and every PAC list field
  exactly, metrics and info LLRs within 1e-12 relative, at M 1025 and 2048
  (plans on and off) and L=2048;
* a numpy model of the cluster sort on the float64 pair keys
  (`cluster_sort_keys<DKey>` in `csrc/list_decode.cuh`): the float32
  model, `tests/test_torch_cluster_lists.py::_cluster_sort`, run on keys
  (metric, index) compared as pairs, through buffers that store a key's
  metric and index apart, as the kernel's buffers of the metrics
  double[2048] beside the indices uint32[2048] do, with their races
  tracked; against numpy's stable argsort at P 4096–32768, with ±0,
  exact ties, +inf (a candidate a plan turns off) and the (+inf, all ones)
  pads, and the key of each rank read back as `cluster_key` reads it;
* a block's bytes at 8-byte LLRs against a written model of
  `cluster_layout`, the float64 shape gate and the plan's `elem` on a
  stand-in occupancy calculator.

The kernel-against-plain cases are marked `gpu` and skip here;
`chip_smoke.py` phase 22 runs them on the card.
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
from polar_code_tpu_torch.ops.backend import resolve_backend
from polar_code_tpu_torch.ops.scl import decode_scl_batch

from .test_torch_cluster_lists import _Buffers, _cluster_sort, _path_threads

GOLDEN = Path(__file__).resolve().parent / "golden" / "scl_f64_cluster.npz"
REL = 1e-12
F64 = torch.float64
PAD_INDEX = 0xFFFFFFFF
CRC = "0x1864CFB"
PAC_GEN = [1, 0, 1, 1, 0, 1, 1]


def _gold():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


GOLD = _gold()
CASES = {c["name"]: c for c in json.loads(str(GOLD["cases"]))}
PLAIN_SCL_CASES = [n for n, c in CASES.items() if c["code"] == "p128" and c["M"] <= 2048]
PLAIN_PAC_CASES = [n for n, c in CASES.items() if c["code"] == "pac128" and c["L"] <= 2048]


def assert_close(got, want, what):
    """Equal where not finite, within REL relative elsewhere."""

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    np.testing.assert_allclose(got[fin], want[fin], rtol=REL, atol=0.0, err_msg=what)


@pytest.fixture
def one_thread():
    """The plain decodes on one intra-op thread: beside the other test
    files' workers, torch's default of a thread a core oversubscribes the
    cores (about 20 s a decode at M=2048, against about 1 s)."""

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", PLAIN_SCL_CASES)
def test_plain_scl_float64_equals_jax_on_a_cluster(name, one_thread):
    case = CASES[name]
    llr = torch.from_numpy(GOLD["p128/llr"])
    plan = torch.from_numpy(GOLD["p128/plan"]) if case["plan"] else None
    res = decode_scl_batch(llr, GOLD["p128/info"], case["M"], case["crc"], force_info_bits=plan, dtype=F64)
    np.testing.assert_array_equal(res.best_path_bits.numpy(), GOLD[f"{name}/bits"])
    np.testing.assert_array_equal(res.crc_pass.numpy(), GOLD[f"{name}/crc_pass"])
    np.testing.assert_array_equal(res.candidates.numpy(), GOLD[f"{name}/candidates"])
    np.testing.assert_array_equal(res.best_index.numpy(), GOLD[f"{name}/best_index"])
    assert res.best_path_info_llrs.dtype == res.metrics.dtype == F64
    assert_close(res.best_path_info_llrs, GOLD[f"{name}/llrs"], "best-path info LLRs")
    assert_close(res.metrics, GOLD[f"{name}/metrics"], "metrics")


@pytest.mark.parametrize("name", PLAIN_PAC_CASES)
def test_plain_pac_float64_equals_jax_on_a_cluster(name, one_thread):
    case = CASES[name]
    llr = torch.from_numpy(GOLD["pac128/llr"])
    out = pac_list_decode_batch(llr, GOLD["pac128/mask"], case["gen"], case["L"], crc_len=case["crc_len"],
                                crc_poly=case["crc_poly"], dtype=F64)
    for f in ("extracted", "crc_pass", "candidates", "v_full", "valid"):
        np.testing.assert_array_equal(out[f].numpy(), GOLD[f"{name}/{f}"], err_msg=f)
    assert out["metrics"].dtype == F64
    assert_close(out["metrics"], GOLD[f"{name}/metrics"], "metrics")


def test_golden_file_covers_the_slice():
    """Float64 LLRs that a float32 cast would move, with a spread of
    magnitudes; the list sizes at both ends of the slice, across the
    cluster sizes (2, 4, 8, 16 blocks) and the 16-block edge (8193); plans
    at both plan sizes; and the file's size."""

    for code in ("p128", "pac128"):
        x = GOLD[f"{code}/llr"]
        assert x.dtype == np.float64
        rel = np.abs(x.astype(np.float32).astype(np.float64) - x) / np.abs(x)
        assert np.median(rel) > 1e-9, code
        mags = np.median(np.abs(x), axis=1)
        assert mags.max() / mags.min() > 1e5, code  # the 1e-3 and 1e3 frames
    scl = [c for c in CASES.values() if c["code"] == "p128"]
    assert {c["M"] for c in scl} == {1025, 2048, 4096, 8193, 16384}
    assert {c["M"] for c in scl if c["plan"]} == {1025, 2048}
    assert {scl_cuda.cluster_blocks(c["M"]) for c in scl} == {2, 4, 16}
    assert all(scl_cuda.cluster_ppt(c["M"]) == 1 for c in scl)
    assert {c["L"] for c in CASES.values() if c["code"] == "pac128"} == {2048, 16384}
    for name, c in CASES.items():  # the metrics at every size, the list up to 2048
        assert f"{name}/metrics" in GOLD
        assert (f"{name}/candidates" in GOLD) == (c.get("M", c.get("L")) <= 2048)
    assert GOLDEN.stat().st_size < 2_000_000


# ---- the cluster sort on the float64 pair key ----

class _PairBuffers(_Buffers):
    """The float64 kernel's three key buffers a block, each the metrics
    double[2048] with the indices uint32[2048] beside them
    (`store_key_pair`, `key_buffer_words<DKey>`: 24 KB a buffer): a key
    (a complex metric + index·j, ordered as `DKey`'s pair) is stored as its
    metric and its index apart and read back as a pair; the base tracks
    the races."""

    def __init__(self, C):
        super().__init__(C, 2048)
        self.metric = np.zeros((C, 3, 2048))
        self.index = np.zeros((C, 3, 2048), np.uint32)

    def store(self, blocks, b, at, k):
        super().store(blocks, b, at, np.zeros(k.shape, np.uint64))
        self.metric[blocks[:, None], b, at] = k.real
        self.index[blocks[:, None], b, at] = k.imag

    def read(self, reader, blocks, b, at):
        super().read(reader, blocks, b, at)
        key = np.empty(len(blocks), complex)
        key.real, key.imag = self.metric[blocks, b, at], self.index[blocks, b, at]
        return key


def _pair(metric, index):
    key = np.empty(np.shape(metric), complex)
    key.real, key.imag = metric, index
    return key


def _fork_pairs(M, good, bad, layout):
    """The [T, 2] pair keys of a fork's candidates as the threads hold them
    (`cand_key`): path m's candidates (SCL 2m and 2m + 1, PAC good m and bad
    M + m) on thread m, pads (+inf, 0xFFFFFFFF) past M (`pad_key`)."""

    P = scl_cuda.sort_keys(M)
    keys = np.full((P // 2, 2), _pair(np.inf, PAD_INDEX))
    m = np.arange(M)
    thread, col = _path_threads(M)
    assert np.array_equal(thread, m) and not col.any()  # one path a thread
    keys[m, 0] = _pair(good, 2 * m if layout == "scl" else m)
    keys[m, 1] = _pair(bad, 2 * m + 1 if layout == "scl" else M + m)
    return keys


def _forks_f64(rng, M, trial):
    """Good and bad metrics of one fork in float64: distinct values a
    float32 could not tell apart, or heavy ties with ±0.0, +inf (a candidate
    a plan turns off) and 1e300, with one side of some paths off."""

    if trial == 0:
        good = 1.0 + rng.integers(0, 1 << 20, M) * 1e-12
        return good, good + rng.integers(1, 8, M) * 1e-13
    vals = np.array([0.0, -0.0, 0.5, 0.5 + 2 ** -40, 1.0, 1e300, np.inf])
    good, bad = vals[rng.integers(0, 7, M)], vals[rng.integers(0, 7, M)]
    off = rng.random(M) < 0.3
    return np.where(off, np.inf, good), bad


def _take_pair_ranks(bufs, sorted_b, M):
    """`cluster_key<1, DKey>`: the thread of path m reads the key of rank m,
    block m // 2048's metric and index at entry m % 2048 of the sorted
    buffer, through DSMEM."""

    u = np.arange(M)
    owner, reader = u // 2048, u // 1024
    out = np.empty(M, complex)
    for r in np.unique(reader):
        mine = reader == r
        out[mine] = bufs.read(r, owner[mine], sorted_b, u[mine] % 2048)
    return out


@pytest.mark.parametrize("P", [4096, 8192, 16384, 32768])
def test_pair_key_cluster_sort_is_the_stable_sort(P):
    M_values = {4096: (1025, 2048), 8192: (2049, 4096), 16384: (4097, 8192), 32768: (8193, 16384)}[P]
    rng = np.random.default_rng(P + 64)
    for M in M_values:
        assert scl_cuda.sort_keys(M) == P and scl_cuda.cluster_ppt(M) == 1
        C = scl_cuda.cluster_blocks(M)
        for trial in range(2):
            good, bad = _forks_f64(rng, M, trial)
            for layout in ("scl", "pac"):
                keys = _fork_pairs(M, good, bad, layout)
                bufs = _PairBuffers(C)
                out, kinds, sorted_b, xc = _cluster_sort(keys, bufs)
                c = np.concatenate([good, bad]) if layout == "pac" else np.stack([good, bad], 1).reshape(-1)
                # the lower half the blocks store, P/2 < 2M keys: the stable
                # order (±0 compare equal), +inf candidates in index order and
                # every pad (+inf, all ones) after them
                want = np.argsort(c, kind="stable")[:P // 2]
                np.testing.assert_array_equal(out.imag.astype(np.int64), want)
                np.testing.assert_array_equal(out.real == c[want], True)
                ranks = _take_pair_ranks(bufs, sorted_b, M)
                np.testing.assert_array_equal(ranks, out[:M])
                assert xc == scl_cuda.cluster_exchanges(P)
        p = P.bit_length() - 1
        assert sum(kinds.values()) == p * (p + 1) // 2
        assert kinds["blocks"] == {4096: 1, 8192: 3, 16384: 6, 32768: 10}[P]


def test_pair_key_buffers_across_forks():
    """Three sorts in a row over one block's pair-key buffers, as a decode
    runs them (two forks, each read for the key of its rank, and the final
    rank on (metric, path)): each the stable sort, no store racing a read."""

    M = 3000
    P = scl_cuda.sort_keys(M)
    bufs, xc = _PairBuffers(scl_cuda.cluster_blocks(M)), 0
    rng = np.random.default_rng(3000)
    for fork in range(3):
        if fork < 2:
            good, bad = _forks_f64(rng, M, fork)
            keys = _fork_pairs(M, good, bad, "scl")
            c = np.stack([good, bad], 1).reshape(-1)
        else:  # the final rank: (metric, path), one key a path, a pad beside it
            c = _forks_f64(rng, M, 1)[0]
            keys = np.full((P // 2, 2), _pair(np.inf, PAD_INDEX))
            keys[:M, 0] = _pair(c, np.arange(M))
        out, _, sorted_b, xc = _cluster_sort(keys, bufs, xc)
        want = np.argsort(c, kind="stable")[:M]
        np.testing.assert_array_equal(_take_pair_ranks(bufs, sorted_b, M).imag.astype(np.int64), want)
        assert xc == (fork + 1) * scl_cuda.cluster_exchanges(P)


# ---- a block's bytes, the shape gate and the plan ----

def _r16(x):
    return (x + 15) // 16 * 16


def _cluster_layout(N, G, words, elem):
    """`cluster_layout<1>` in `csrc/list_decode.cuh`, region by region, at
    one path a thread: (offsets, total).  The float64 keys are three buffers
    of the metrics double[2048] and the indices uint32[2048]; a word set is
    the 1024 leaves of `elem` bytes, then the 32-bit words."""

    n = int(math.log2(N))
    ss = (N >> G) - 1
    sig_row = max(4, ((2 * n - 2) * 2 + 3) // 4 * 4)
    off = {"sig": 0, "sig2": _r16(1024 * sig_row)}
    off["keys"] = 2 * off["sig2"]
    key = 12 if elem == 8 else 8
    off["key_index"] = off["keys"] + 8 * 2048 if elem == 8 else None
    off["words"] = off["keys"] + 3 * key * 2048
    word_set = (elem + 4 * (words - 1)) * 1024
    off["syn"] = off["words"] + elem * 1024
    off["ls"] = off["words"] + 2 * word_set
    off["bs"] = off["ls"] + _r16(elem * 1024 * ss)
    off["sel"] = off["bs"] + _r16(1024 * ss)
    return off, off["sel"] + 16


@pytest.mark.parametrize("N", [16, 128, 1024, 8192])
def test_cluster_block_bytes_at_float64(N):
    n = int(math.log2(N))
    for G in range(n):
        for words, frame_bytes in ((2, scl_cuda.frame_bytes), (3, pac_cuda.frame_bytes)):
            off, total = _cluster_layout(N, G, words, 8)
            # a thread's two metrics are one 16-byte store, its indices one
            # 8-byte store; a leaf is an 8-byte load
            assert off["keys"] % 16 == 0 and off["key_index"] % 16 == 0 and off["words"] % 16 == 0
            assert off["syn"] % 16 == 0 and off["ls"] % 16 == 0
            assert scl_cuda.cluster_block_bytes(N, G, words, 1, 8) == total
            assert frame_bytes(N, N // 2, 2048, G, 8) == total
            # float32 is the layout it was: 8-byte keys, 32-bit words, float rows
            assert frame_bytes(N, N // 2, 2048, G) == _cluster_layout(N, G, words, 4)[1]
    # at G = n − 1: N=8192 SCL 205,840 B and PAC
    # 214,032 B, N=128 SCL 156,688 B; the keys 73,728 B (float32 49,152)
    assert scl_cuda.cluster_block_bytes(8192, 12, 2, 1, 8) == 205840
    assert pac_cuda.frame_bytes(8192, 4096, 16384, 12, 8) == 214032
    assert scl_cuda.frame_bytes(128, 64, 1025, 6, 8) == 156688
    assert (scl_cuda.cluster_block_bytes(N, n - 1, 2, 1, 8) - scl_cuda.cluster_block_bytes(N, n - 1, 2, 1)
            == 3 * 4 * 2048 + 2 * 4 * 1024 + 4 * 1024)  # 12-byte keys, 8-byte leaves and a row of doubles
    for words in (2, 3):
        assert scl_cuda.cluster_block_bytes(N, n - 1, words, 1, 8) <= scl_cuda.MAX_BLOCK_SMEM


def test_float64_takes_every_cluster_list_size_up_to_8192():
    for N in (16, 128, 1024, 8192):
        crc_len = 16 if N > 32 else 0
        for M in range(scl_cuda.DEEP_MAX_M + 1, scl_cuda.F64_MAX_M + 1):
            scl_cuda.check_shape(N, N, M, CRC, F64)
            pac_cuda.check_shape(N, N // 2, M, PAC_GEN, crc_len, F64)
        assert resolve_backend("cuda", M=16384, dtype=F64, N=N, K=N // 2, crc=CRC) == "cuda"
    assert scl_cuda.F64_MAX_M == 16384 == scl_cuda.CLUSTER_PAIR_MIN_M - 1


@pytest.mark.parametrize("M,N", [(16385, 128), (32768, 1024), (65536, 8192), (2048, 16384), (16384, 16384),
                                 (1025, 65536)])
def test_float64_past_one_path_a_thread_or_n_8192_raises(M, N):
    scl_cuda.check_shape(N, N // 2, M, CRC, torch.float32)  # float32 takes it
    pac_cuda.check_shape(N, N // 2, M, PAC_GEN, 16, torch.float32)
    for call in (lambda: scl_cuda.check_shape(N, N // 2, M, CRC, F64),
                 lambda: pac_cuda.check_shape(N, N // 2, M, PAC_GEN, 16, F64),
                 lambda: resolve_backend("cuda", M=M, dtype=F64, N=N, K=N // 2, crc=CRC)):
        with pytest.raises(ValueError, match=r"float64 at list sizes 1\.\.16384 and N up to 8192 .*one path a "
                                             r"thread of a cluster"):
            call()


def test_float64_cluster_plan_on_a_fake_calculator(monkeypatch):
    """On a cluster the plans ask the occupancy of the float64
    instantiation (`elem` 8) at its blocks' bytes, and take the smallest G
    at which the card runs as many clusters at once as at G = n − 1: a
    stand-in that places 7 clusters of a shape whose block fits and none
    of one that does not.  P(128,64) M=2048: G=4 in float64 (211,984 B)
    where float32 takes 3; N=8192: K1 G=11 (224,272 B), K3 G=12 (its G=11
    is 16 B past a block)."""

    seen = []

    def at_once(fbytes):
        return 7 if fbytes <= scl_cuda.MAX_BLOCK_SMEM else 0

    def occupancy(N, K, M, G, elem=4):
        seen.append(elem)
        return 1, at_once(scl_cuda.frame_bytes(N, K, M, G, elem))

    monkeypatch.setattr(scl_cuda, "_occupancy", occupancy)
    scl_cuda._plan.cache_clear()
    try:
        assert scl_cuda.launch_plan(128, 64, 2048, 1024, 8) == (4, 1, 7)
        assert scl_cuda.frame_bytes(128, 64, 2048, 4, 8) == 211984
        assert set(seen) == {8}
        assert scl_cuda.launch_plan(128, 64, 2048, 1024) == (3, 1, 7)
        assert scl_cuda.launch_plan(8192, 4096, 16384, 256, 8) == (11, 1, 7)
        assert scl_cuda.frame_bytes(8192, 4096, 16384, 11, 8) == 224272
        assert set(seen) == {4, 8}
    finally:
        scl_cuda._plan.cache_clear()
    seen.clear()

    def pac_occupancy(N, Kp, L, G, elem=4):
        seen.append(elem)
        return 1, at_once(pac_cuda.frame_bytes(N, Kp, L, G, elem))

    monkeypatch.setattr(pac_cuda, "_occupancy", pac_occupancy)
    pac_cuda.launch_plan.cache_clear()
    try:
        assert pac_cuda.launch_plan(128, 80, 2048, 8) == (4, 1, 7)
        assert pac_cuda.launch_plan(8192, 4096, 16384, 8) == (12, 1, 7)
        assert pac_cuda.frame_bytes(8192, 4096, 16384, 11, 8) == scl_cuda.MAX_BLOCK_SMEM + 16
        assert set(seen) == {8}
        assert pac_cuda.launch_plan(128, 80, 2048)[0] == 3
    finally:
        pac_cuda.launch_plan.cache_clear()


# ---- on the card (marker `gpu`; skipped without a CUDA device) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the float64 cluster kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", PLAIN_SCL_CASES)
def test_k1_float64_on_a_cluster_matches_plain_on_card(cuda_device, name):
    case = CASES[name]
    info = np.asarray(GOLD["p128/info"])
    x = torch.from_numpy(GOLD["p128/llr"]).to(cuda_device)
    plan = torch.from_numpy(GOLD["p128/plan"]).to(cuda_device) if case["plan"] else None
    out = scl_cuda.decode_scl_cuda(x, info, case["M"], CRC, force_info_bits=plan, full=True)
    torch.cuda.synchronize()
    ref = decode_scl_batch(x, info, case["M"], CRC, force_info_bits=plan, dtype=F64)
    for f in scl_cuda.BEST_FIELDS + scl_cuda.LIST_FIELDS:
        assert torch.equal(out[f], getattr(ref, f).to(out[f].dtype)), f


@pytest.mark.gpu
@pytest.mark.parametrize("L", [2048, 16384])
def test_k3_float64_on_a_cluster_matches_golden_on_card(cuda_device, L):
    case = CASES[f"pac128_L{L}"]
    x = torch.from_numpy(GOLD["pac128/llr"]).to(cuda_device)
    out = pac_list_decode_cuda(x, GOLD["pac128/mask"], case["gen"], L, case["crc_len"], case["crc_poly"], full=True)
    torch.cuda.synchronize()
    for f in ("extracted", "crc_pass", "v_full", "candidates", "valid"):
        if f in case["fields"]:
            np.testing.assert_array_equal(out[f].cpu().numpy(), GOLD[f"pac128_L{L}/{f}"], err_msg=f)
    assert_close(out["metrics"].cpu().numpy(), GOLD[f"pac128_L{L}/metrics"], "metrics")
