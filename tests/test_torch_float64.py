"""Float64 on the card: K1 (byte words and by path) and K3 (one path a lane)
at list sizes 1–32 and N up to 8192, on the CPU.

The kernels' float64 instantiations (`scl_decode_kernel<M, LIST, double>`,
`scl_path_kernel<LM, LIST, double>`, `pac_decode_kernel<LM, LIST, double>`)
run only on the card.  Here, with no card and no JAX compile:

* the port's plain decoders in float64 against `tests/golden/scl_f64_decode.npz`,
  the JAX package's XLA decoders under x64 on the same float64 LLRs
  (`tests/golden/make_scl_f64.py`; at P(128,64) and PAC(128,64), the
  longer codes on the card): bits, CRC flags, candidates, the
  selected rank and every PAC list field exactly, metrics and info LLRs
  within 1e-12 relative (the LLRs are not float32 numbers: a hidden cast
  would move them by about 1e-8);
* the shape gates: float64 inside the envelope (M and L 1–1024, N up to
  8192, with and without CRC) is taken, outside it a ValueError names the
  envelope, and K2 refuses float64;
* the frame and scratch bytes at 8-byte LLRs against a written model;
* a numpy model of the by-path fork's float64 key, the (metric, index) pair,
  through the in-warp bitonic network stage by stage, against numpy's
  stable argsort, with ±0, exact ties, +inf (a candidate a plan turns off,
  a path never reached) and the (+inf, all ones) pads;
* the scalar entry points' float type.

The kernel-against-plain cases at float64 are marked `gpu` and skip here;
`chip_smoke.py` phase 20 runs them on the card.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from polar_code_tpu_torch.legacy import pac_cuda
from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch
from polar_code_tpu_torch.legacy.pac_cuda import pac_list_decode_cuda
from polar_code_tpu_torch.nr.ldpc import nms_cuda, qc_ira
from polar_code_tpu_torch.ops import scl_cuda
from polar_code_tpu_torch.ops.backend import resolve_backend
from polar_code_tpu_torch.ops.scl import decode_scl_batch
from polar_code_tpu_torch.utils.device import scalar_dtype

GOLDEN = Path(__file__).resolve().parent / "golden" / "scl_f64_decode.npz"
CRC = "0x1864CFB"  # CRC-24A
REL = 1e-12
F64 = torch.float64
LANES = np.arange(32)
PAD_INDEX = np.uint32(0xFFFFFFFF)


def _gold():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


GOLD = _gold()
CASES = {c["name"]: c for c in json.loads(str(GOLD["cases"]))}
# the CPU cases: every P(128,64) one (P(2048,1024) and P(8192,4096), whose
# plain decodes take seconds to minutes of a busy worker, are checked on the
# card, `chip_smoke.py` phase 20)
SCL_CASES = [n for n, c in CASES.items() if c["code"] == "p128"]
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
def test_plain_scl_float64_equals_jax(name):
    case = CASES[name]
    code = case["code"]
    llr = torch.from_numpy(GOLD[f"{code}/llr"])
    assert llr.dtype == F64
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
def test_plain_pac_float64_equals_jax(name):
    case = CASES[name]
    llr = torch.from_numpy(GOLD["pac128/llr"])
    out = pac_list_decode_batch(llr, GOLD["pac128/mask"], case["gen"], case["L"], crc_len=case["crc_len"],
                                crc_poly=case["crc_poly"], dtype=F64)
    for f in ("extracted", "crc_pass", "candidates", "v_full", "valid"):
        np.testing.assert_array_equal(out[f].numpy(), GOLD[f"{name}/{f}"], err_msg=f)
    assert out["metrics"].dtype == F64
    assert_close(out["metrics"], GOLD[f"{name}/metrics"], "metrics")


def test_golden_llrs_are_not_float32_numbers():
    """A decoder that casts the inputs to float32 anywhere changes them by
    far more than the 1e-12 the outputs are held to."""

    for code in ("p128", "n2048", "n8192", "pac128"):
        x = GOLD[f"{code}/llr"]
        assert x.dtype == np.float64
        rel = np.abs(x.astype(np.float32).astype(np.float64) - x) / np.abs(x)
        assert np.median(rel) > 1e-9, code
        mags = np.median(np.abs(x), axis=1)
        assert mags.max() / mags.min() > 1e5, code  # the 1e-3 and 1e3 frames
    assert GOLDEN.stat().st_size < 1_000_000


# M 33, 64 and 1024 refused float64 before the over-warps float64
# instantiations; they are taken now
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33, 64, 1024])
def test_k1_float64_envelope(M):
    for N, K in ((16, 8), (128, 64), (1024, 512), (8192, 4096), (8192, 8192)):
        for crc in (CRC, None):
            scl_cuda.check_shape(N, K, M, crc, F64)
            assert resolve_backend("cuda", M=M, dtype=F64, N=N, K=K, crc=crc) == "cuda"
    with pytest.raises(ValueError, match="float64 at list sizes 1..16384 and N up to 8192"):
        scl_cuda.check_shape(16384, 8192, M, CRC, F64)


# M 1025 and 2048 were refused before the float64 cluster instantiation;
# the envelope's edge is now past one path a thread of a cluster
@pytest.mark.parametrize("M,N", [(16385, 128), (32768, 128), (64, 16384), (65536, 128), (4, 16384), (1, 65536)])
def test_k1_float64_outside_the_envelope_raises(M, N):
    scl_cuda.check_shape(N, N // 2, M, CRC, torch.float32)  # float32 takes it
    for call in (lambda: scl_cuda.check_shape(N, N // 2, M, CRC, F64),
                 lambda: resolve_backend("cuda", M=M, dtype=F64, N=N, K=N // 2, crc=CRC)):
        with pytest.raises(ValueError, match="float64 at list sizes 1..16384 and N up to 8192"):
            call()
    with pytest.raises(ValueError, match="float32 or float64"):
        scl_cuda.check_shape(N, N // 2, M, CRC, torch.float16)


# L 33 and 256 were refused before the over-warps float64 instantiations,
# L 1025 and 2048 before the cluster one
@pytest.mark.parametrize("L,N,ok", [(1, 128, True), (4, 128, True), (8, 1024, True), (32, 8192, True),
                                    (5, 64, True), (33, 128, True), (256, 128, True), (4, 16384, False),
                                    (32, 65536, False), (1025, 128, True), (2048, 128, True),
                                    (16385, 128, False), (64, 16384, False)])
def test_k3_float64_envelope(L, N, ok):
    gen = [1, 0, 1, 1, 0, 1, 1]
    pac_cuda.check_shape(N, N // 2, L, gen, 16, torch.float32)
    if ok:
        pac_cuda.check_shape(N, N // 2, L, gen, 16, F64)
        pac_cuda.check_shape(N, N // 2, L, [1], 0, F64)
    else:
        with pytest.raises(ValueError, match="float64 at list sizes 1..16384 and N up to 8192"):
            pac_cuda.check_shape(N, N // 2, L, gen, 16, F64)


def test_k2_refuses_float64():
    bg = qc_ira.make_qc_ira_bg(4, 8, 31)
    nms_cuda.check_shape(bg, 31, 8 * 31, torch.float32, False)
    with pytest.raises(ValueError, match="float32"):
        nms_cuda.check_shape(bg, 31, 8 * 31, F64, False)


def _r16(x):
    return (x + 15) // 16 * 16


def test_frame_and_scratch_bytes_at_float64():
    # K1 byte words, P(128,64) M=8, levels 1..2 in global scratch: 8-byte
    # LLR rows of (128 >> 2) − 1 = 31 entries, byte partial sums, and the
    # trace indices K·M
    assert scl_cuda.frame_bytes(128, 64, 8, 2, 8) == _r16(8 * 8 * 31 + 8 * 31 + 64 * 8) == 2752
    assert scl_cuda.frame_bytes(128, 64, 8, 2) == _r16(4 * 8 * 31 + 8 * 31 + 64 * 8)
    # by path (no trace in shared memory): M=16 at N=8192 with every level
    # but the leaf in global scratch, and at G = 0
    assert scl_cuda.frame_bytes(8192, 4096, 16, 12, 8) == _r16(16 * 1 * 9)
    assert scl_cuda.frame_bytes(8192, 4096, 3, 0, 8) == _r16(3 * 8191 * 9)
    # scratch: the levels (8 + 1 bytes an entry), the trace LLRs (8 bytes)
    # and by path the trace rows
    assert scl_cuda.scratch_bytes(4096, 128, 64, 8, 2, 8) == 4096 * 8 * 96 * 9 + 4096 * 64 * 8 * 8
    assert scl_cuda.scratch_bytes(1024, 8192, 4096, 32, 12, 8) == (1024 * 32 * 8190 * 9 + 1024 * 4096 * 32 * 8
                                                                  + 1024 * 4096 * 32)
    # K3 one path a lane: 9 bytes an entry, the 16-row trace ring
    assert pac_cuda.frame_bytes(128, 80, 8, 2, 8) == _r16(9 * 8 * 31) + 16 * 16 == 2496
    assert pac_cuda.frame_bytes(128, 80, 1, 0, 8) == _r16(9 * 127)
    assert pac_cuda.scratch_bytes(4096, 128, 80, 8, 2, 8) == 4096 * 8 * 96 * 9 + 4096 * 80 * 16
    # the least frame (every level but the leaf in global scratch) fits a
    # block at every shape of the envelope
    for M in range(1, 33):
        assert scl_cuda.frame_bytes(8192, 8192, M, 12, 8) <= scl_cuda.MAX_BLOCK_SMEM
        assert pac_cuda.frame_bytes(8192, 8192, M, 12, 8) <= scl_cuda.MAX_BLOCK_SMEM


def test_float64_plan_on_a_fake_calculator(monkeypatch):
    """The plans ask the occupancy of the float64 instantiations (`elem`
    8) at their 8-byte frames: a frame twice the LLR bytes needs as many
    global levels or more for the same frames an SM."""

    seen = []

    def occupancy(N, K, M, G, elem=4):
        seen.append(elem)
        return 4, min(32, (228 * 1024) // (scl_cuda.frame_bytes(N, K, M, G, elem) + 256))

    monkeypatch.setattr(scl_cuda, "_occupancy", occupancy)
    monkeypatch.setattr(scl_cuda, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    scl_cuda._plan.cache_clear()
    try:
        for N, K, M in ((128, 64, 8), (128, 64, 32), (2048, 1024, 8), (8192, 4096, 32)):
            g32, g64 = scl_cuda.launch_plan(N, K, M, 4096)[0], scl_cuda.launch_plan(N, K, M, 4096, 8)[0]
            assert g64 >= g32, (N, M)
        assert scl_cuda.launch_plan(2048, 1024, 8, 4096, 8)[0] > scl_cuda.launch_plan(2048, 1024, 8, 4096)[0]
        assert set(seen) == {4, 8}
    finally:
        scl_cuda._plan.cache_clear()
    monkeypatch.setattr(pac_cuda, "_occupancy", lambda N, Kp, L, G, elem=4: (
        4, min(32, (228 * 1024) // (pac_cuda.frame_bytes(N, Kp, L, G, elem) + 256))))
    pac_cuda.launch_plan.cache_clear()
    try:
        assert pac_cuda.launch_plan(1024, 528, 32, 8)[0] > pac_cuda.launch_plan(1024, 528, 32)[0]
    finally:
        pac_cuda.launch_plan.cache_clear()


def _less(am, ai, bm, bi):
    """The float64 key order (`DKey`'s operator<): metric, then index."""

    return (am < bm) | ((am == bm) & (ai < bi))


def _keep(k, o, keep_min):
    """`keep_key` in every lane on (metric, index) pairs."""

    take = _less(o[0], o[1], k[0], k[1]) == keep_min
    return np.where(take, o[0], k[0]), np.where(take, o[1], k[1])


def _shfl(k, j):
    return k[0][LANES ^ j], k[1][LANES ^ j]


def _sort_one_a_lane(k, pmax, P):
    size = 2
    while size <= pmax and size <= P:
        j = size // 2
        while j >= 1:
            k = _keep(k, _shfl(k, j), ((LANES & j) == 0) == ((LANES & size) == 0))
            j //= 2
        size *= 2
    return k


def _sort_two_a_lane(k0, k1):
    size = 2
    while size <= 32:
        j = size // 2
        while j >= 1:
            lower = (LANES & j) == 0
            up = np.full(32, True) if size == 32 else (LANES & size) == 0
            k0, k1 = (_keep(k0, _shfl(k0, j), lower == up),
                      _keep(k1, _shfl(k1, j), lower == (np.zeros(32, bool) if size == 32 else up)))
            j //= 2
        size *= 2
    lo = _less(k1[0], k1[1], k0[0], k0[1])
    k0 = np.where(lo, k1[0], k0[0]), np.where(lo, k1[1], k0[1])
    j = 16
    while j >= 1:
        k0 = _keep(k0, _shfl(k0, j), (LANES & j) == 0)
        j //= 2
    return k0


def _path_select_f64(c0, c1, M):
    """`path_select<LM, double>`: lane p < M holds candidates 2p (c0[p]) and
    2p + 1 (c1[p]); pads (+inf, 0xFFFFFFFF)."""

    LM = scl_cuda.path_width(M)
    a0 = np.full(32, np.inf)
    a1 = np.full(32, np.inf)
    a0[:M], a1[:M] = c0, c1
    pad = np.full(32, PAD_INDEX, np.int64)
    if LM <= 16:
        odd = LANES >= M
        p = np.where(odd, LANES - M, LANES)
        c = np.where(odd, a1[p % 32], a0)
        on = LANES < 2 * M
        k = np.where(on, c, np.inf), np.where(on, 2 * p + odd, pad)
        return _sort_one_a_lane(k, 2 * LM, scl_cuda.sort_keys(M))
    on = LANES < M
    k0 = np.where(on, a0, np.inf), np.where(on, 2 * LANES, pad)
    k1 = np.where(on, a1, np.inf), np.where(on, 2 * LANES + 1, pad)
    return _sort_two_a_lane(k0, k1)


def _fork_metrics(rng, M, trial):
    """Candidate metrics of one fork in float64: distinct values a float32
    could not tell apart, or heavy ties with ±0.0 and +inf (a candidate a
    plan turns off, a path never reached), one side of every path off, and
    paths off on both sides."""

    if trial == 0:
        c0 = 1.0 + rng.integers(0, 4, M) * 1e-12
        return c0, c0 + rng.integers(0, 4, M) * 1e-13
    vals = np.array([0.0, -0.0, 0.5, 0.5 + 2 ** -40, 1.0, 1e300, np.inf])
    c0, c1 = vals[rng.integers(0, 7, M)], vals[rng.integers(0, 7, M)]
    if trial >= 2:
        off = rng.random(M) < 0.5
        c0, c1 = np.where(off, np.inf, c0), np.where(off, c1, np.inf)
    if trial == 3:
        dead = rng.random(M) < 0.3
        c0, c1 = np.where(dead, np.inf, c0), np.where(dead, np.inf, c1)
    return c0, c1


@pytest.mark.parametrize("M", [3, 5, 16, 17, 31, 32])
def test_float64_key_order_is_the_stable_sort(M):
    rng = np.random.default_rng(640 + M)
    for trial in range(4):
        for _ in range(5):
            c0, c1 = _fork_metrics(rng, M, trial)
            metric, index = _path_select_f64(c0, c1, M)
            c = np.empty(2 * M)
            c[0::2], c[1::2] = c0, c1  # candidate 2p + b
            want = np.argsort(c, kind="stable")[:M]
            np.testing.assert_array_equal(index[:M], want)
            np.testing.assert_array_equal(metric[:M] == c[want], True)  # −0.0 == +0.0
            assert not (index[:M] == PAD_INDEX).any()  # no pad ranks below M
    # the final sort of the M metrics, one key a lane over sort_keys(M)/2 lanes
    for trial in range(10):
        pm = np.full(32, np.inf)
        pm[:M] = _fork_metrics(rng, M, trial % 4)[0]
        k = np.where(LANES < M, pm, np.inf), np.where(LANES < M, LANES, np.int64(PAD_INDEX))
        metric, index = _sort_one_a_lane(k, scl_cuda.path_width(M), scl_cuda.sort_keys(M) // 2)
        np.testing.assert_array_equal(index[:M], np.argsort(pm[:M], kind="stable"))


def test_scalar_entry_points_float_type(monkeypatch):
    """`dtype=None`: float64 on the CPU, float32 on the card; an explicit
    float64 is passed on to the card's kernels."""

    assert scalar_dtype(torch.device("cpu")) == F64
    assert scalar_dtype(torch.device("cuda")) == torch.float32
    assert scalar_dtype(torch.device("cuda"), F64) == F64
    from polar_code_tpu_torch.legacy.polar_code import PolarCode
    from polar_code_tpu_torch.legacy.rate_profile import rateprofile

    rp = rateprofile(32, 16, 2.0, 0)
    assert PolarCode(32, 16, "dega", 4, rp, device="cpu").dtype == F64
    assert PolarCode(32, 16, "dega", 4, rp, device="cpu", dtype=torch.float32).dtype == torch.float32


def test_cpu_route_keeps_float64():
    info = np.asarray(GOLD["p128/info"])
    x = torch.from_numpy(GOLD["p128/llr"])
    out = scl_cuda.decode_scl_cuda(x, info, 3, CRC, full=True)
    for f in ("best_path_info_llrs", "info_llrs", "metrics"):
        assert out[f].dtype == F64, f
    name = "p128_M3_crc1_plan0"
    np.testing.assert_array_equal(out["best_path_bits"].numpy(), GOLD[f"{name}/bits"])
    assert_close(out["metrics"], GOLD[f"{name}/metrics"], "metrics")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the float64 kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 2, 3, 4, 8, 16, 32])
def test_k1_float64_matches_plain_on_card(cuda_device, M):
    info = np.asarray(GOLD["p128/info"])
    x = torch.from_numpy(np.tile(GOLD["p128/llr"], (40, 1))).to(cuda_device)
    plan = torch.from_numpy(np.tile(GOLD["p128/plan"], (40, 1))).to(cuda_device)
    for forced in (None, plan):
        out = scl_cuda.decode_scl_cuda(x, info, M, CRC, force_info_bits=forced, full=True)
        torch.cuda.synchronize()
        ref = decode_scl_batch(x, info, M, CRC, force_info_bits=forced, dtype=F64)
        for f in scl_cuda.BEST_FIELDS + scl_cuda.LIST_FIELDS:
            assert torch.equal(out[f], getattr(ref, f).to(out[f].dtype)), f


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 4, 8, 32])
def test_k3_float64_matches_plain_on_card(cuda_device, L):
    case = CASES[f"pac128_L{L}"]
    x = torch.from_numpy(GOLD["pac128/llr"]).to(cuda_device)
    out = pac_list_decode_cuda(x, GOLD["pac128/mask"], case["gen"], L, case["crc_len"], case["crc_poly"], full=True)
    torch.cuda.synchronize()
    for f in ("extracted", "crc_pass", "v_full", "candidates", "metrics", "valid"):
        np.testing.assert_array_equal(out[f].cpu().numpy(), GOLD[f"pac128_L{L}/{f}"], err_msg=f)
