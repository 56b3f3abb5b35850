"""The list decoders past one warp: list sizes 33..1024, held against JAX.

On the card K1 (`csrc/scl_decode.cu`) and K3 (`csrc/pac_decode.cu`) take
list sizes 33..1024 through their over-warps instantiations (a frame spread
over the ceil(M/32) warps of a block, one thread a path), and K3 takes N up
to 8192.  On the CPU:

* the plain `decode_scl_batch` in float64 against JAX's at N=64, M ∈ {64,
  256}, with CRC-24A and forced plans: every field of the list;
* the plain `pac_list_decode_batch` list fields against JAX's at L=64;
* the planning: `check_shape` over the new envelope, `frame_bytes` with
  16-bit trace entries, where the trace indices live, and `scratch_bytes`
  at M 64..1024 and at PAC N=8192;
* a model of the over-warps candidate rank (`rank_pair` in
  `csrc/list_decode.cuh`, with each layout's tie thresholds) and of the
  final rank's min-reduction, against the stable sort.

On the card (marker `gpu`): K1 and K3 at M = L = 64 against their plain
versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.legacy.pac import pac_list_decode_batch as jax_pac_decode
from polar_code_tpu.legacy.rate_profile import rateprofile as jax_rateprofile
from polar_code_tpu.ops.crc import attach_crc as jax_attach_crc
from polar_code_tpu.ops.polar_transform import encode_batch as jax_encode
from polar_code_tpu.ops.scl import decode_scl_batch as jax_decode
from polar_code_tpu.polar.construct import construct_info_set as jax_info_set
from polar_code_tpu_torch.legacy import pac_cuda
from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch
from polar_code_tpu_torch.ops import scl_cuda
from polar_code_tpu_torch.ops.scl import decode_scl_batch
from polar_code_tpu_torch.polar.construct import construct_info_set

CRC = "0x1864CFB"  # CRC-24A
FIELDS_EXACT = ("candidates", "valid", "best_index", "best_path_bits", "crc_pass")
FIELDS_CLOSE = ("metrics", "info_llrs", "best_path_info_llrs")
PAC_N, PAC_KP, PAC_GEN = 64, 40, (1, 0, 1, 1, 0, 1, 1)
PAC_CRC = (16, 0x1021)
GEN = [1, 0, 1, 1, 0, 1, 1]


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


# ---- the plain decoders against JAX at list sizes above 32 ----

@pytest.mark.parametrize("M,use_crc", [(64, True), (256, False)])
def test_plain_scl_equals_jax_float64_at_deep_list_sizes(M, use_crc):
    N, K = 64, 32
    llr, msgs = noisy_llrs(N, K, 16, snr_db=1.0, seed=M)
    plan = forced_plan(msgs, seed=M)
    crc_poly = CRC if use_crc else None
    ref = jax_decode(jnp.asarray(llr), jax_info_set(N, K), M, crc_poly,
                     force_info_bits=jnp.asarray(plan), dtype=jnp.float64)
    res = decode_scl_batch(torch.from_numpy(llr), construct_info_set(N, K), M, crc_poly,
                           force_info_bits=torch.from_numpy(plan), dtype=torch.float64)
    for f in FIELDS_EXACT:
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    for f in FIELDS_CLOSE:
        np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-12,
                                   err_msg=f)
    assert res.metrics.shape == (16, M)


def _pac_mask():
    rp = jax_rateprofile(PAC_N, PAC_KP, 2.0, 0)
    rp.build_mask("dega")
    return np.asarray(rp.modify_profile())


def test_plain_pac_list_fields_equal_jax_at_l64():
    L = 64
    mask = _pac_mask()
    llr = np.random.default_rng(L).normal(1.0, 2.0, (16, PAC_N)).astype(np.float32)
    ref = jax_pac_decode(jnp.asarray(llr), mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
    res = pac_list_decode_batch(torch.from_numpy(llr), mask, PAC_GEN, L, crc_len=PAC_CRC[0],
                                crc_poly=PAC_CRC[1])
    for f in ("extracted", "crc_pass", "v_full", "valid", "metrics", "candidates"):
        np.testing.assert_array_equal(res[f].numpy(), np.asarray(ref[f]), err_msg=f)
    assert res["metrics"].shape == (16, L)


# ---- the planning ----

def test_check_shape_takes_lists_up_to_1024():
    for M in range(33, 1025):
        scl_cuda.check_shape(128, 64, M, CRC, torch.float32)
    for M in (64, 256):
        scl_cuda.check_shape(1024, 512, M, CRC, torch.float32)
    scl_cuda.check_shape(8192, 4096, 1024, None, torch.float32)
    with pytest.raises(ValueError, match="1..1024"):
        scl_cuda.check_shape(128, 64, 1025, CRC, torch.float32)
    for L in range(33, 1025):
        pac_cuda.check_shape(128, 80, L, GEN, 16, torch.float32)
    pac_cuda.check_shape(2048, 1040, 32, GEN, 16, torch.float32)
    pac_cuda.check_shape(8192, 4112, 8, GEN, 16, torch.float32)
    pac_cuda.check_shape(8192, 4112, 1024, GEN, 16, torch.float32)
    with pytest.raises(ValueError, match="1..1024"):
        pac_cuda.check_shape(128, 80, 1025, GEN, 16, torch.float32)
    with pytest.raises(ValueError, match="8192"):
        pac_cuda.check_shape(16384, 8208, 8, GEN, 16, torch.float32)


def test_frame_bytes_over_warps():
    r16 = lambda x: (x + 15) // 16 * 16  # noqa: E731
    assert [scl_cuda.trace_entry_bytes(M) for M in (33, 128, 129, 1024)] == [1, 1, 2, 2]
    # P(128,64) M=1024, levels 1..6 in global scratch: σ rows of 12 16-bit
    # fields (32 B), candidates, leaf rows, leaf and syndrome, bit rows, the
    # 16-bit trace indices (128 KB) and the selected rank
    fb = 1024 * 32 + 8 * 1024 + 4 * 1024 * 1 + 2 * 4 * 1024 + 1024 * 1 + 64 * 1024 * 2 + 16
    assert scl_cuda.trace_in_smem(128, 64, 1024)
    assert scl_cuda.frame_bytes(128, 64, 1024, 6) == fb == 185360
    # byte entries at M=128; the PAC frame publishes its shift register too
    fb = 128 * 16 + 8 * 128 + r16(4 * 128 * 15) + 2 * 512 + r16(128 * 15) + 64 * 128 + 16
    assert scl_cuda.frame_bytes(128, 64, 128, 3) == fb
    assert pac_cuda.frame_bytes(128, 64, 128, 3) == fb + 512
    # P(1024,512) M=256: the 16-bit trace (256 KB) leaves shared memory
    assert not scl_cuda.trace_in_smem(1024, 512, 256) and scl_cuda.trace_in_smem(1024, 512, 128)
    assert scl_cuda.frame_bytes(1024, 512, 256, 9) == 256 * 48 + 2048 + 1024 + 2048 + 256 + 16
    for M in (33, 64, 256, 1024):  # the fit rule: some G fits a block
        n = 10
        assert scl_cuda.frame_bytes(1024, 512, M, n - 1) <= scl_cuda.MAX_BLOCK_SMEM
    # up to M=32 the reckoning is the one-path-a-lane frame's
    assert scl_cuda.frame_bytes(128, 64, 8) == 5600


def test_scratch_bytes_over_warps():
    # levels 1..G and the trace LLRs; the trace indices where they leave shared memory
    for M in (64, 128, 256, 1024):
        G = 4
        want = 4096 * M * (128 - (128 >> G)) * 5 + 4096 * 64 * M * 4
        assert scl_cuda.scratch_bytes(4096, 128, 64, M, G) == want
    # about 3.7 GB at B=4096 P(128,64) M=1024 with G=6
    assert scl_cuda.scratch_bytes(4096, 128, 64, 1024, 6) == 4096 * 1024 * 126 * 5 + 4096 * 64 * 1024 * 4
    ti = 4096 * 512 * 256 * 2
    assert scl_cuda.scratch_bytes(4096, 1024, 512, 256, 9) == (4096 * 256 * 1022 * 5
                                                                + 4096 * 512 * 256 * 4 + ti)
    # PAC(8192,4096)+CRC-16 at L=8: its trace stays in shared memory, 4112·8 bytes
    assert pac_cuda.frame_bytes(8192, 4112, 8, 12) == (5 * 8 + 4112 * 8 + 15) // 16 * 16
    # and over warps at N=8192 it moves to global scratch
    assert not scl_cuda.trace_in_smem(8192, 4112, 64, pac_cuda.DEEP_WORDS)
    assert pac_cuda.frame_bytes(8192, 4112, 64, 12) == 64 * 32 + 512 + 256 + 3 * 256 + 64 + 16


# ---- models of the over-warps rank ----

def _rank_pair(x, y, c, ax, ay):
    """`rank_pair` of `csrc/list_decode.cuh` for one candidate."""

    j = np.arange(len(x))
    return int(np.sum((x < c) | ((x == c) & (j < ax))) + np.sum((y < c) | ((y == c) & (j < ay))))


@pytest.mark.parametrize("M", [33, 64, 100])
def test_over_warps_ranks_are_the_stable_sort(M):
    rng = np.random.default_rng(M)
    vals = np.array([0.5, 1.0, 1.5, 3e38], np.float32)
    for trial in range(6):
        c = vals[rng.integers(0, 4, 2 * M)] if trial % 2 else rng.random(2 * M).astype(np.float32)
        # SCL: thread p holds candidates 2p (x) and 2p + 1 (y)
        x, y = c[0::2], c[1::2]
        ranks = np.empty(2 * M, int)
        ranks[0::2] = [_rank_pair(x, y, x[p], p, p) for p in range(M)]
        ranks[1::2] = [_rank_pair(x, y, y[p], p + 1, p) for p in range(M)]
        np.testing.assert_array_equal(ranks[np.argsort(c, kind="stable")], np.arange(2 * M))
        # PAC: thread p holds good p (x) and bad M + p (y), layout [good×M, bad×M]
        x, y = c[:M], c[M:]
        ranks = np.array([_rank_pair(x, y, x[p], p, 0) for p in range(M)]
                         + [_rank_pair(x, y, y[p], M, p) for p in range(M)])
        np.testing.assert_array_equal(ranks[np.argsort(c, kind="stable")], np.arange(2 * M))
        # the final rank and the selected one (`final_rank`): the least rank
        # of the paths that pass, 0 when none does
        pm = x
        frank = np.array([np.sum((pm < pm[m]) | ((pm == pm[m]) & (np.arange(M) < m))) for m in range(M)])
        order = np.argsort(pm, kind="stable")
        np.testing.assert_array_equal(frank[order], np.arange(M))
        ok = rng.random(M) < 0.2
        least = frank[ok].min() if ok.any() else M
        first = next((r for r, m in enumerate(order) if ok[m]), None)
        assert (least if least < M else None) == first


# ---- on the card (marker `gpu`; skipped without a CUDA device) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_k1_over_warps_matches_plain_on_card(cuda_device):
    N, K, M = 128, 64, 64
    info = construct_info_set(N, K)
    llr, msgs = noisy_llrs(N, K, 37, snr_db=2.0, seed=M)
    x = torch.from_numpy(llr.astype(np.float32)).to(cuda_device)
    plan = torch.from_numpy(forced_plan(msgs, seed=M)).to(cuda_device)
    out = scl_cuda.decode_scl_cuda(x, info, M, CRC, force_info_bits=plan, full=True)
    torch.cuda.synchronize()
    ref = decode_scl_batch(x, info, M, CRC, force_info_bits=plan)
    for f in ("best_path_bits", "crc_pass", "candidates", "valid", "best_index"):
        assert torch.equal(out[f], getattr(ref, f).to(out[f].dtype)), f


@pytest.mark.gpu
def test_k3_over_warps_matches_plain_on_card(cuda_device):
    L = 64
    mask = _pac_mask()
    x = torch.from_numpy(np.random.default_rng(L).normal(1.0, 2.0, (37, PAC_N)).astype(np.float32))
    x = x.to(cuda_device)
    out = pac_cuda.pac_list_decode_cuda(x, mask, PAC_GEN, L, *PAC_CRC, full=True)
    torch.cuda.synchronize()
    ref = pac_list_decode_batch(x, mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
    for f in ("extracted", "crc_pass", "v_full", "candidates", "metrics", "valid", "best_index"):
        assert torch.equal(out[f], ref[f]), f
