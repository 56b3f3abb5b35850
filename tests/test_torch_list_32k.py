"""List sizes past 16384: K1 and K3 at M and L 16385..32768, held against JAX.

On the card K1 (`csrc/scl_decode.cu`) and K3 (`csrc/pac_decode.cu`) take
list sizes 16385..32768 through their pair instantiations: a frame over a
thread-block cluster of 16 blocks of 1024 threads (the largest cluster an
H100 places), two paths a thread and four sort keys (`cluster_sort_keys4`
in `csrc/list_decode.cuh`), σ's two tables in global scratch.  On the CPU:

* the plain `decode_scl_batch` in float64 against JAX's at P(32,28) M=32768,
  where the list fills after 15 info bits, CRC-24A on with a forced plan
  and off without: every field of the list; the plain float32 decoder
  against the JAX float32 golden file `tests/golden/scl_f32_32k.npz`
  (P(128,64) M=32768), which the card holds K1 to;
* the plain `pac_list_decode_batch` list fields against JAX's at
  PAC(32,12)+CRC-16 L=32768;
* `cluster_blocks` (16) and `cluster_ppt` (2) for M 16385..32768,
  `cluster_exchanges(65536)`, a block's bytes (no σ, 4096 keys, 2048
  paths' rows) within 227 KB at the plan's G at every N 16..65536, the
  launch plan on a stand-in occupancy calculator, `scratch_bytes` with σ's
  tables and the batch split at M = 32768, `check_shape` over M and L
  16385..32768 at N 128..65536 and raising at 65537 (past four paths a
  thread), and the routing;
* the within-frame offsets at M = L = 32768, N = K = 65536 against 2^31
  (computed in 64 bits in the pair instantiations) and the 16-bit fields
  against 2^16.

The models of the cluster sort at four keys a thread over 16 blocks
(65536 keys: the stable sort, its buffers across forks, the final rank)
are cases of `tests/test_torch_cluster_lists.py`'s model tests.

On the card (marker `gpu`): K1 and K3 at 32768 against their plain versions.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.legacy.pac import pac_list_decode_batch as jax_pac_decode
from polar_code_tpu.ops.scl import decode_scl_batch as jax_decode
from polar_code_tpu.polar.construct import construct_info_set as jax_info_set
from polar_code_tpu_torch.legacy import pac_cuda
from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch
from polar_code_tpu_torch.ops import scl_cuda
from polar_code_tpu_torch.ops.backend import resolve_backend
from polar_code_tpu_torch.ops.scl import decode_scl_batch
from polar_code_tpu_torch.polar.construct import construct_info_set

from .test_torch_cluster_lists import (CRC, FIELDS_CLOSE, FIELDS_EXACT, GEN, PAC_CRC, PAC_GEN, _pac_mask,
                                       forced_plan, noisy_llrs)
from .test_torch_scl import _near_ties

GOLDEN = Path(__file__).resolve().parent / "golden" / "scl_f32_32k.npz"
P32 = 65536  # the keys of a fork at M 16385..32768
LONG_N = (16384, 32768, 65536)


# ---- the plain decoders against JAX at list size 32768 ----

@pytest.mark.parametrize("use_crc,use_plan", [(True, True), (False, False)])
def test_plain_scl_equals_jax_float64_at_m32768(use_crc, use_plan):
    N, K, M = 32, 28, 32768  # 2^28 paths: the list fills after 15 info bits
    llr, msgs = noisy_llrs(N, K, 2, snr_db=1.0, seed=M + use_crc)
    plan = forced_plan(msgs, seed=M) if use_plan else None
    crc_poly = CRC if use_crc else None
    ref = jax_decode(jnp.asarray(llr), jax_info_set(N, K), M, crc_poly,
                     force_info_bits=jnp.asarray(plan) if use_plan else None, dtype=jnp.float64)
    res = decode_scl_batch(torch.from_numpy(llr), construct_info_set(N, K), M, crc_poly,
                           force_info_bits=torch.from_numpy(plan) if use_plan else None,
                           dtype=torch.float64)
    for f in FIELDS_EXACT:
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    for f in FIELDS_CLOSE:
        np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-12,
                                   err_msg=f)
    assert res.metrics.shape == (2, M)
    assert int(res.valid.numpy()[1].sum()) == M  # frame 1 has no plan: its list fills


def test_plain_pac_list_fields_equal_jax_at_l32768():
    L = 32768
    mask = _pac_mask(32, 12 + PAC_CRC[0])
    llr = np.random.default_rng(L).normal(1.0, 2.0, (2, 32)).astype(np.float32)
    ref = jax_pac_decode(jnp.asarray(llr), mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
    res = pac_list_decode_batch(torch.from_numpy(llr), mask, PAC_GEN, L, crc_len=PAC_CRC[0],
                                crc_poly=PAC_CRC[1])
    for f in ("extracted", "crc_pass", "v_full", "valid", "metrics", "candidates"):
        np.testing.assert_array_equal(res[f].numpy(), np.asarray(ref[f]), err_msg=f)
    assert res["metrics"].shape == (2, L) and bool(res["valid"].all())  # 2^28 paths: the list fills


def test_plain_float32_matches_jax_golden_at_m32768():
    """The golden file the card holds K1 to at M=32768: its first two
    frames through the plain float32 decoder, equal to JAX float32 in bits
    and pass flags, with the best path's info LLRs and every path's metric
    within 1e-6 relative."""

    with np.load(GOLDEN) as g:
        gold = {k: g[k] for k in g.files}
    case, = json.loads(str(gold["cases"]))
    assert (case["N"], case["K"], case["M"], case["crc"]) == (128, 64, 32768, CRC)
    assert GOLDEN.stat().st_size < 1_000_000
    tag, code = case["name"], case["code"]
    llr = torch.from_numpy(gold[f"{code}/llr"][:2])
    res = decode_scl_batch(llr, gold[f"{code}/info"], 32768, CRC, dtype=torch.float32)
    bits, passed = res.best_path_bits.numpy(), res.crc_pass.numpy()
    bad = np.any(bits != gold[f"{tag}/bits"][:2], axis=1) | (passed != gold[f"{tag}/crc_pass"][:2])
    ties = _near_ties(res.metrics.numpy()[:, :64]) | _near_ties(gold[f"{tag}/metrics"][:2, :64])
    assert not (bad & ~ties).any(), np.flatnonzero(bad & ~ties)
    np.testing.assert_allclose(res.best_path_info_llrs.numpy()[~bad], gold[f"{tag}/llrs"][:2][~bad],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(res.metrics.numpy(), gold[f"{tag}/metrics"][:2], rtol=1e-6, atol=0)


# ---- the planning ----

def test_two_paths_a_thread_on_16_blocks():
    for M in (16385, 20000, 24000, 32767, 32768):
        assert scl_cuda.sort_keys(M) == P32 and scl_cuda.cluster_blocks(M) == 16
        assert scl_cuda.cluster_ppt(M) == 2
    assert [scl_cuda.cluster_ppt(M) for M in (1025, 16384, 16385)] == [1, 1, 2]
    # one cross-block stage a merge level j >= 4096 (1 + 2 + 3 + 4) and the sorted keys
    assert scl_cuda.cluster_exchanges(P32) == 11
    # a block of 2048 paths: three buffers of 4096 keys, two word sets, the
    # rows; σ's tables in global scratch.  P(128,64) at G = n − 3 (rows of 7
    # entries): 202,768 B for K1, 219,152 B for K3
    r16 = lambda x: (x + 15) // 16 * 16  # noqa: E731
    for N in (16, 128, 1024, 8192, 65536):
        n = N.bit_length() - 1
        for g in range(n):
            ss = (N >> g) - 1
            for words in (2, 3):
                want = 3 * 8 * 4096 + 2 * words * 4 * 2048 + r16(4 * 2048 * ss) + r16(2048 * ss) + 16
                assert scl_cuda.cluster_block_bytes(N, g, words, 2) == want
            assert scl_cuda.frame_bytes(N, N // 2, 32768, g) == scl_cuda.cluster_block_bytes(N, g, 2, 2)
            assert pac_cuda.frame_bytes(N, N // 2, 24000, g) == scl_cuda.cluster_block_bytes(N, g, 3, 2)
    assert scl_cuda.frame_bytes(128, 64, 32768, 4) == 98304 + 32768 + 71680 + 16 == 202768
    assert pac_cuda.frame_bytes(128, 80, 32768, 4) == 98304 + 49152 + 71680 + 16 == 219152
    # two σ tables of 2048 rows would not fit beside them: 96 KB at n = 7
    assert 2 * 2048 * scl_cuda.sigma_row(128) == 98304
    assert scl_cuda.frame_bytes(128, 64, 32768, 4) + 98304 > scl_cuda.MAX_BLOCK_SMEM


@pytest.mark.parametrize("N", [16, 128, 1024, 8192, 65536])
def test_plan_at_32768_fits_a_block(N, monkeypatch):
    # a stand-in occupancy calculator: 7 clusters of 16 where a block's
    # shared memory fits, none where it does not
    def occupancy(frame_bytes):
        def at(N, K, M, G):
            return 1, (7 if frame_bytes(N, K, M, G) <= scl_cuda.MAX_BLOCK_SMEM else 0)
        return at

    monkeypatch.setattr(scl_cuda, "_occupancy", occupancy(scl_cuda.frame_bytes))
    monkeypatch.setattr(pac_cuda, "_occupancy", occupancy(pac_cuda.frame_bytes))
    scl_cuda._plan.cache_clear()
    pac_cuda.launch_plan.cache_clear()
    try:
        k1 = [scl_cuda.launch_plan(N, N // 2, M, 1024) for M in (16385, 32768)]
        k3 = [pac_cuda.launch_plan(N, N // 2 + 16, L) for L in (16385, 32768)]
        monkeypatch.setattr(scl_cuda, "_occupancy", lambda N, K, M, G: (1, 0))
        monkeypatch.setattr(pac_cuda, "_occupancy", lambda N, K, L, G: (1, 0))
        scl_cuda._plan.cache_clear()
        pac_cuda.launch_plan.cache_clear()
        with pytest.raises(RuntimeError, match="no cluster of 16 blocks"):
            scl_cuda.launch_plan(N, N // 2, 32768, 1024)
        with pytest.raises(RuntimeError, match="no cluster of 16 blocks"):
            pac_cuda.launch_plan(N, N // 2 + 16, 32768)
    finally:
        scl_cuda._plan.cache_clear()
        pac_cuda.launch_plan.cache_clear()
    n = N.bit_length() - 1
    # the smallest G whose block fits 227 KB: n − 3 (rows of 7 entries) for both
    for plans, words in ((k1, 2), (k3, 3)):
        G = plans[0][0]
        assert plans == [(G, 1, 7)] * 2 and G == n - 3
        assert scl_cuda.cluster_block_bytes(N, G, words, 2) <= scl_cuda.MAX_BLOCK_SMEM
        assert scl_cuda.cluster_block_bytes(N, G - 1, words, 2) > scl_cuda.MAX_BLOCK_SMEM


def test_check_shape_takes_lists_up_to_32768():
    for N in (16, 128, 1024, 8192) + LONG_N:
        for M in (16385, 24000, 32768):
            scl_cuda.check_shape(N, N // 2, M, CRC if N > 24 else None, torch.float32)
            scl_cuda.check_shape(N, N // 2, M, None, torch.float32)
            if N >= 128:
                pac_cuda.check_shape(N, N // 2 + 16, M, GEN, 16, torch.float32)
    for M in range(16385, 32769, 511):
        scl_cuda.check_shape(128, 64, M, None, torch.float32)
        pac_cuda.check_shape(128, 80, M, GEN, 16, torch.float32)
    scl_cuda.check_shape(65536, 65536, 32768, CRC, torch.float32)  # K = N: the largest trace
    pac_cuda.check_shape(65536, 65536, 32768, GEN, 16, torch.float32)
    # past 32768 four paths a thread (`tests/test_torch_list_64k.py`): the
    # first size refused is 65537
    for N in (128, 65536):
        with pytest.raises(ValueError, match="1..65536 .*four paths a thread"):
            scl_cuda.check_shape(N, N // 2, 65537, CRC, torch.float32)
        with pytest.raises(ValueError, match="1..65536 .*four paths a thread"):
            pac_cuda.check_shape(N, N // 2 + 16, 65537, GEN, 16, torch.float32)
    # the routing takes 32768 and 32769 on the card
    for M in (32768, 32769):
        assert resolve_backend(torch.device("cuda"), M=M, dtype=torch.float32, N=128, K=64) == "cuda"


def test_scratch_and_split_at_32768():
    # levels 1..G, the trace LLRs and 16-bit trace indices, and σ's two tables
    # of 16-bit rows (24 B at n = 7, 60 B at n = 16)
    assert [scl_cuda.sigma_row(N) for N in (2, 16, 128, 65536)] == [4, 12, 24, 60]
    for N, K, G in ((128, 64, 4), (65536, 32768, 13), (65536, 65536, 13)):
        sig = 2 * 32768 * scl_cuda.sigma_row(N)
        assert scl_cuda.sigma_bytes(1, N, 32768) == sig and scl_cuda.sigma_bytes(1, N, 16384) == 0
        assert scl_cuda.scratch_bytes(1, N, K, 32768, G) == 2 * scl_cuda.scratch_bytes(1, N, K, 16384, G) + sig
        assert pac_cuda.scratch_bytes(1, N, K, 32768, G) == 2 * pac_cuda.scratch_bytes(1, N, K, 16384, G) + sig
    # about 34 MB a frame at P(128,64): 19.7 MB of tree rows, 12.6 MB of trace, 1.6 MB of σ
    one = scl_cuda.scratch_bytes(1, 128, 64, 32768, 4)
    assert one == 32768 * (120 * 5 + 64 * 6 + 2 * 24) == 33_816_576
    # about 17.2 GB a frame at P(65536,32768) G=13; 24 GB at N = K = 65536
    big = scl_cuda.scratch_bytes(1, 65536, 32768, 32768, 13)
    assert big == 32768 * (65528 * 5 + 32768 * 6 + 2 * 60) == 17_182_490_624
    assert scl_cuda.scratch_bytes(1, 65536, 65536, 32768, 13) == 32768 * (65528 * 5 + 65536 * 6 + 120)
    # a card with 80 GB free takes 4 such frames a launch and 2129 of P(128,64); one
    # frame with 18 GB free raises
    assert scl_cuda.split_batch(64, big, 80 * 10 ** 9) == 72 * 10 ** 9 // big == 4
    assert scl_cuda.split_batch(4096, one, 80 * 10 ** 9) == 2129
    with pytest.raises(ValueError, match=f"{big} bytes"):
        scl_cuda.split_batch(1, big, 18 * 10 ** 9)

    def alloc(frames):  # a stand-in allocator with 80 GB free
        if frames * big > 80 * 10 ** 9:
            raise torch.cuda.OutOfMemoryError(f"{frames} frames")
        return frames

    assert scl_cuda.alloc_scratch(64, big, alloc, lambda: 80 * 10 ** 9, "K1") == (4, 4)
    assert scl_cuda.alloc_scratch(2, big, alloc, lambda: 80 * 10 ** 9, "K1") == (2, 2)


def test_offsets_at_32768_need_64_bits():
    """At M = L = 32768 and N = K = 65536 the largest within-frame products
    of the cluster kernels reach 2^31 − 1, where one path a thread stopped
    at 2^30: the pair instantiations compute them in 64 bits
    (`ClusterOff<2>`).  The 16-bit fields (σ, the trace entries 2p + b and
    parent << 1 | v) reach 65535 = 2^16 − 1, unsigned."""

    M, N = 32768, 65536
    K = N
    G = 13  # the plan's G at N=65536
    SG = N - (N >> G)
    largest = {
        "trace entry info_i·M + m": (K - 1) * M + (M - 1),
        "K3 v row m·N + u": (M - 1) * N + (N - 1),
        "global row r·SG + entry": (M - 1) * SG + (SG - 1),
        "a block's v rows base·N + t": (M - 2048) * N + (2048 * N - 1),
        "σ's table (frame's 2nd) row p": (2 * M - 1) * 30 + 29,
    }
    for name, value in largest.items():
        assert value < 2 ** 31, name
    for name in ("trace entry info_i·M + m", "K3 v row m·N + u", "a block's v rows base·N + t"):
        assert largest[name] == 2 ** 31 - 1 and largest[name] >= 2 ** 30, name
    # trace entries and σ fields: 2p + b < 2M = 2^16, the top of an unsigned 16-bit word
    assert 2 * (M - 1) + 1 == 2 ** 16 - 1 and 2 * M - 1 > 2 ** 15 - 1
    # the sort keys' index word holds 2M candidates
    assert 2 * M - 1 < 2 ** 32


# ---- on the card (marker `gpu`; skipped without a CUDA device) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_k1_at_32768_matches_plain_on_card(cuda_device):
    N, K, M = 128, 64, 32768
    info = construct_info_set(N, K)
    llr, msgs = noisy_llrs(N, K, 3, snr_db=2.0, seed=M)
    x = torch.from_numpy(llr.astype(np.float32)).to(cuda_device)
    plan = torch.from_numpy(forced_plan(msgs, seed=M)).to(cuda_device)
    launches = scl_cuda.decode_scl_cuda.pair_launches
    out = scl_cuda.decode_scl_cuda(x, info, M, CRC, force_info_bits=plan, full=True)
    torch.cuda.synchronize()
    assert scl_cuda.decode_scl_cuda.pair_launches == launches + 1
    ref = decode_scl_batch(x, info, M, CRC, force_info_bits=plan)
    for f in ("best_path_bits", "crc_pass", "candidates", "valid", "best_index"):
        assert torch.equal(out[f], getattr(ref, f).to(out[f].dtype)), f


@pytest.mark.gpu
def test_k3_at_32768_matches_plain_on_card(cuda_device):
    L = 32768
    mask = _pac_mask(32, 12 + PAC_CRC[0])
    x = torch.from_numpy(np.random.default_rng(L).normal(1.0, 2.0, (3, 32)).astype(np.float32))
    x = x.to(cuda_device)
    out = pac_cuda.pac_list_decode_cuda(x, mask, PAC_GEN, L, *PAC_CRC, full=True)
    torch.cuda.synchronize()
    ref = pac_list_decode_batch(x, mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
    for f in ("extracted", "crc_pass", "v_full", "candidates", "metrics", "valid", "best_index"):
        assert torch.equal(out[f], ref[f]), f
