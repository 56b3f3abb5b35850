"""The wide envelope of the port's kernels, held against the JAX package.

The card takes every decode the JAX package runs on its device: SCL list
sizes 1..32 (K1's by-path instantiation beside its byte-word ones at M 1, 2,
4, 8) and N up to 8192, the PAC decoder's full list (K3's list
instantiation, which the systematic `PolarCode` decoder reads) and LDPC
decoding without early stop (K2).  On the CPU:

* the plain `decode_scl_batch` in float64 against JAX's at N=64, M ∈ {3, 16,
  32}, with CRC-24A and forced plans: every field of the list;
* the plain `pac_list_decode_batch` list fields (`v_full`, `valid`,
  `metrics`, `candidates`) against JAX's at L ∈ {4, 32};
* `decode_ldpc_nms_batch(early_stop=False)` against JAX's, shared and
  two-min;
* `PolarCode(device="cpu")`'s systematic decoder against JAX's at L=32;
* K1's planning: `check_shape` over the envelope, `frame_bytes` and the σ
  fields at n = 13, the scratch reckoning, and a pairwise rank count in the
  by-path layout (two candidates a lane) against the stable sort.

On the card (marker `gpu`): K1's by-path instantiation, K3's list output and
K2 without early stop against their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.legacy.crclib import crc as jax_crc
from polar_code_tpu.legacy.pac import pac_list_decode_batch as jax_pac_decode
from polar_code_tpu.legacy.polar_code import PolarCode as JaxPolarCode
from polar_code_tpu.legacy.rate_profile import rateprofile as jax_rateprofile
from polar_code_tpu.nr.ldpc import qc_ira as jax_qc
from polar_code_tpu.nr.ldpc.builder import build_h_matrix as jax_build_h
from polar_code_tpu.nr.ldpc.decode_nms import decode_ldpc_nms_batch as jax_nms
from polar_code_tpu.ops.crc import attach_crc as jax_attach_crc
from polar_code_tpu.ops.polar_transform import encode_batch as jax_encode
from polar_code_tpu.ops.scl import decode_scl_batch as jax_decode
from polar_code_tpu.polar.construct import construct_info_set as jax_info_set
from polar_code_tpu_torch.legacy.crclib import crc
from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch
from polar_code_tpu_torch.legacy.pac_cuda import pac_list_decode_cuda
from polar_code_tpu_torch.legacy.polar_code import PolarCode
from polar_code_tpu_torch.legacy.rate_profile import rateprofile
from polar_code_tpu_torch.nr.ldpc import qc_ira
from polar_code_tpu_torch.nr.ldpc.builder import build_h_matrix
from polar_code_tpu_torch.nr.ldpc.decode_nms import decode_ldpc_nms_batch
from polar_code_tpu_torch.nr.ldpc.nms_cuda import decode_ldpc_nms_cuda
from polar_code_tpu_torch.ops import scl_cuda
from polar_code_tpu_torch.ops.scl import decode_scl_batch
from polar_code_tpu_torch.polar.construct import construct_info_set

CRC = "0x1864CFB"  # CRC-24A
FIELDS_EXACT = ("candidates", "valid", "best_index", "best_path_bits", "crc_pass")
FIELDS_CLOSE = ("metrics", "info_llrs", "best_path_info_llrs")
PAC_N, PAC_KP, PAC_GEN = 64, 40, (1, 0, 1, 1, 0, 1, 1)
PAC_CRC = (16, 0x1021)


def noisy_llrs(N, K, B, snr_db, seed, method="gaussian"):
    """Float64 LLRs of CRC-24A codewords over BPSK/AWGN (numpy draws; the
    JAX package encodes), and the sent bits."""

    rng = np.random.default_rng(seed)
    info = jax_info_set(N, K, method=method)
    msgs = np.stack([jax_attach_crc(p, CRC) for p in rng.integers(0, 2, size=(B, K - 24)).astype(np.int8)])
    codes = np.asarray(jax_encode(jnp.asarray(msgs), info, N))
    nv = 1.0 / (2.0 * (K / N) * 10 ** (snr_db / 10.0))
    return 2.0 * (1.0 - 2.0 * codes + rng.normal(0.0, np.sqrt(nv), size=codes.shape)) / nv, msgs


def forced_plan(msgs, seed):
    """DL-SCL-shaped plans on every other frame: a prefix of sent bits, one
    flipped, the rest free; the other frames all −1."""

    rng = np.random.default_rng(seed)
    B, K = msgs.shape
    idx = rng.integers(0, K, B)
    pos = np.arange(K)[None, :]
    plan = np.where(pos < idx[:, None], msgs, -1)
    plan = np.where(pos == idx[:, None], 1 - msgs, plan).astype(np.int8)
    plan[1::2] = -1
    return plan


# ---- SCL at list sizes outside {1, 2, 4, 8} ----

@pytest.mark.parametrize("M,use_crc,use_plan", [(3, True, True), (16, False, True), (32, True, False)])
def test_plain_scl_equals_jax_float64_at_wide_list_sizes(M, use_crc, use_plan):
    N, K = 64, 32
    llr, msgs = noisy_llrs(N, K, 24, snr_db=1.0, seed=M)
    plan = forced_plan(msgs, seed=M) if use_plan else None
    crc_poly = CRC if use_crc else None
    ref = jax_decode(jnp.asarray(llr), jax_info_set(N, K), M, crc_poly,
                     force_info_bits=None if plan is None else jnp.asarray(plan), dtype=jnp.float64)
    res = decode_scl_batch(torch.from_numpy(llr), construct_info_set(N, K), M, crc_poly,
                           force_info_bits=None if plan is None else torch.from_numpy(plan),
                           dtype=torch.float64)
    for f in FIELDS_EXACT:
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    for f in FIELDS_CLOSE:
        np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-12,
                                   err_msg=f)
    assert res.metrics.shape == (24, M)


# ---- the PAC decoder's full list ----

def _pac_mask():
    rp = jax_rateprofile(PAC_N, PAC_KP, 2.0, 0)
    rp.build_mask("dega")
    return np.asarray(rp.modify_profile())


@pytest.mark.parametrize("L", [4, 32])
def test_plain_pac_list_fields_equal_jax(L):
    mask = _pac_mask()
    rng = np.random.default_rng(L)
    llr = rng.normal(1.0, 2.0, (16, PAC_N)).astype(np.float32)
    ref = jax_pac_decode(jnp.asarray(llr), mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
    res = pac_list_decode_batch(torch.from_numpy(llr), mask, PAC_GEN, L, crc_len=PAC_CRC[0],
                                crc_poly=PAC_CRC[1])
    for f in ("v_full", "valid", "metrics", "candidates", "extracted", "crc_pass"):
        np.testing.assert_array_equal(res[f].numpy(), np.asarray(ref[f]), err_msg=f)
    # the selected rank the list output adds: the extracted bits are its candidate
    pick = np.take_along_axis(res["candidates"].numpy(), res["best_index"].numpy()[:, None, None], 1)
    np.testing.assert_array_equal(pick[:, 0], res["extracted"].numpy())
    # the wrapper's list output on a CPU tensor is the plain version's
    out = pac_list_decode_cuda(torch.from_numpy(llr), mask, PAC_GEN, L, *PAC_CRC, full=True)
    for f in ("v_full", "candidates", "metrics", "valid", "best_index"):
        np.testing.assert_array_equal(out[f].numpy(), res[f].numpy(), err_msg=f)


def test_systematic_polar_code_equals_jax_at_list_size_32():
    L = 32
    ours = PolarCode(PAC_N, PAC_KP, "dega", L, rateprofile(PAC_N, PAC_KP, 2.0, 0), device="cpu")
    theirs = JaxPolarCode(PAC_N, PAC_KP, "dega", L, jax_rateprofile(PAC_N, PAC_KP, 2.0, 0))
    c_ours, c_theirs = crc(*PAC_CRC), jax_crc(*PAC_CRC)
    rng = np.random.default_rng(32)
    nv = 1.0 / (2.0 * (24 / PAC_N) * 10 ** 0.2)
    for _ in range(3):
        msg = rng.integers(0, 2, PAC_KP - PAC_CRC[0])
        msg = np.append(msg, c_ours.crcCalc(msg))
        llr = 2.0 * (1.0 - 2.0 * ours.encode(msg, True) + rng.normal(0.0, np.sqrt(nv), PAC_N)) / nv
        for with_crc in (True, False):
            got = ours.pac_list_crc_decoder(llr, True, with_crc, c_ours, L)
            want = theirs.pac_list_crc_decoder(llr, True, with_crc, c_theirs, L)
            np.testing.assert_array_equal(got, want)


# ---- LDPC without early stop ----

@pytest.mark.parametrize("self_exclude", [False, True])
def test_nms_without_early_stop_equals_jax(self_exclude):
    Z = 13
    H = build_h_matrix(qc_ira.make_qc_ira_bg(4, 8, Z), Z)
    np.testing.assert_array_equal(H, jax_build_h(jax_qc.make_qc_ira_bg(4, 8, Z), Z))
    # the all-zero codeword at a mean LLR from 1 to 12 a frame: some frames pass, some do not
    mean = np.linspace(1.0, 12.0, 32)[:, None]
    llr = (np.random.default_rng(7).normal(0.0, 2.0, (32, H.shape[1])) + mean).astype(np.float32)
    ref = jax_nms(jnp.asarray(llr), H, 8, 0.8, False, self_exclude=self_exclude)
    res = decode_ldpc_nms_batch(torch.from_numpy(llr), H, 8, 0.8, False, self_exclude=self_exclude)
    for f in ("hard", "iters_used", "parity_ok"):
        np.testing.assert_array_equal(res[f].numpy(), np.asarray(ref[f]), err_msg=f)
    assert np.all(res["iters_used"].numpy() == 8)
    assert 0 < int(res["parity_ok"].sum()) < 32  # both outcomes occur
    # the wrapper on a CPU tensor passes the flag to the plain version
    out = decode_ldpc_nms_cuda(torch.from_numpy(llr), qc_ira.make_qc_ira_bg(4, 8, Z), Z, 8, 0.8,
                               early_stop=False, self_exclude=self_exclude, H=H)
    for f in ("hard", "iters_used", "parity_ok"):
        np.testing.assert_array_equal(out[f].numpy(), res[f].numpy(), err_msg=f)


# ---- K1's planning ----

def test_check_shape_takes_the_envelope():
    for M in range(1, 33):
        scl_cuda.check_shape(128, 64, M, CRC, torch.float32)
    for M in range(1, 17):
        scl_cuda.check_shape(4096, 2048, M, CRC, torch.float32)
    for M in range(1, 5):
        scl_cuda.check_shape(8192, 4096, M, CRC, torch.float32)
    with pytest.raises(ValueError, match="1..8192"):
        scl_cuda.check_shape(128, 64, 8193, CRC, torch.float32)
    # past the TPU kernel's N=8192 up to the phase words' 65536
    for N in (16384, 32768, 65536):
        scl_cuda.check_shape(N, N // 2, 4, CRC, torch.float32)
    with pytest.raises(ValueError, match="65536"):
        scl_cuda.check_shape(131072, 65536, 4, CRC, torch.float32)
    # by path the trace indices live in global scratch: every K at N=8192
    scl_cuda.check_shape(8192, 8192, 32, None, torch.float32)


def test_frame_and_scratch_bytes_at_n13():
    n = 13
    # the σ fields of the by-path layout: 2n − 2 = 24 fit LM=32's four words
    # (the instantiations that take n <= 13; longer codes go wide)
    assert 2 * n - 2 == scl_cuda.NARROW_SIGMA_FIELDS[32] == 4 * (32 // 5)
    assert 2 * n - 2 <= scl_cuda.NARROW_SIGMA_FIELDS[16] == 3 * (32 // 4)
    assert [scl_cuda.path_width(M) for M in (3, 5, 8, 9, 16, 17, 32)] == [8, 8, 8, 16, 16, 32, 32]
    # with every level but the leaf in global scratch a frame keeps its leaf
    # rows, and in the byte-word layout its trace indices: 5·M (+ K·M)
    # bytes, rounded to 16
    assert scl_cuda.frame_bytes(8192, 4096, 32, n - 1) == 5 * 32
    assert scl_cuda.frame_bytes(8192, 4096, 4, n - 1) == 16416
    assert scl_cuda.frame_bytes(8192, 4096, 4, 0) == (5 * 4 * 8191 + 4096 * 4 + 15) // 16 * 16
    # Lg, Bg, TL and TI (rows of 32 bytes): about 8 GB at B=4096, N=8192,
    # M=32 with G=12
    assert scl_cuda.scratch_bytes(4096, 8192, 4096, 32, 12) == (4096 * 32 * 8190 * 5
                                                                + 4096 * 4096 * 32 * (4 + 1))


def _bypath_ranks(c0, c1):
    """A pairwise rank count in K1's by-path layout: lane p holds candidates
    2p and 2p + 1 with metrics c0[p], c1[p]; each counts the candidates
    before it in (metric, index) order, the order the kernel's in-warp key
    sort gives (`tests/test_torch_path_lists.py` models that sort)."""

    M = len(c0)
    r0, r1 = np.zeros(M, int), np.zeros(M, int)
    for lane in range(M):
        for j in range(M):
            a, b = c0[j], c1[j]
            r0[lane] += (a < c0[lane]) or (a == c0[lane] and j < lane)
            r0[lane] += (b < c0[lane]) or (b == c0[lane] and j < lane)
            r1[lane] += (a < c1[lane]) or (a == c1[lane] and j <= lane)
            r1[lane] += (b < c1[lane]) or (b == c1[lane] and j < lane)
    return r0, r1


@pytest.mark.parametrize("M", [3, 5, 16, 32])
def test_bypath_rank_is_the_stable_sort(M):
    rng = np.random.default_rng(M)
    for trial in range(20):
        # ties on purpose: few distinct values, and the unreachable 3e38
        vals = np.array([0.5, 1.0, 1.5, 3e38], np.float32)
        c = vals[rng.integers(0, 4, 2 * M)] if trial % 2 else rng.random(2 * M).astype(np.float32)
        r0, r1 = _bypath_ranks(c[0::2], c[1::2])
        ranks = np.empty(2 * M, int)
        ranks[0::2], ranks[1::2] = r0, r1
        order = np.argsort(c, kind="stable")
        np.testing.assert_array_equal(ranks[order], np.arange(2 * M))


# ---- on the card (marker `gpu`; skipped without a CUDA device) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("N,M", [(128, 3), (128, 16), (128, 32), (4096, 16), (8192, 4), (8192, 8),
                                 (8192, 32)])
def test_k1_by_path_and_wide_n_match_plain_on_card(cuda_device, N, M):
    K = N // 2
    info = construct_info_set(N, K, method="gaussian" if N == 128 else "gaussian_bitrev")
    B = 301 if N == 128 else 8
    llr, msgs = noisy_llrs(N, K, B, snr_db=2.0, seed=M, method="gaussian" if N == 128 else "gaussian_bitrev")
    x = torch.from_numpy(llr.astype(np.float32)).to(cuda_device)
    plan = torch.from_numpy(forced_plan(msgs, seed=M)).to(cuda_device)
    out = scl_cuda.decode_scl_cuda(x, info, M, CRC, force_info_bits=plan, full=True)
    torch.cuda.synchronize()
    ref = decode_scl_batch(x, info, M, CRC, force_info_bits=plan)
    for f in ("best_path_bits", "crc_pass", "candidates", "valid", "best_index"):
        assert torch.equal(out[f], getattr(ref, f).to(out[f].dtype)), f


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 5, 32])
def test_k3_list_matches_plain_on_card(cuda_device, L):
    mask = _pac_mask()
    x = torch.from_numpy(np.random.default_rng(L).normal(1.0, 2.0, (301, PAC_N)).astype(np.float32))
    x = x.to(cuda_device)
    out = pac_list_decode_cuda(x, mask, PAC_GEN, L, *PAC_CRC, full=True)
    torch.cuda.synchronize()
    ref = pac_list_decode_batch(x, mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
    for f in ("extracted", "crc_pass", "v_full", "candidates", "metrics", "valid", "best_index"):
        assert torch.equal(out[f], ref[f]), f


@pytest.mark.gpu
@pytest.mark.parametrize("self_exclude", [False, True])
def test_k2_without_early_stop_matches_plain_on_card(cuda_device, self_exclude):
    Z = 31
    bg = qc_ira.make_qc_ira_bg(4, 8, Z)
    H = build_h_matrix(bg, Z)
    x = torch.from_numpy((np.random.default_rng(3).normal(0.0, 1.0, (301, H.shape[1])) * 2.0 + 2.5)
                         .astype(np.float32)).to(cuda_device)
    out = decode_ldpc_nms_cuda(x, bg, Z, 20, 0.8, early_stop=False, self_exclude=self_exclude)
    torch.cuda.synchronize()
    ref = decode_ldpc_nms_batch(x, H, 20, 0.8, False, self_exclude=self_exclude)
    for f in ("hard", "iters_used", "parity_ok"):
        assert torch.equal(out[f], ref[f]), f
