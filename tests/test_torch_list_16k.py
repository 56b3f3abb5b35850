"""List sizes past 8192: K1 and K3 at M and L 8193..16384, held against JAX.

On the card K1 (`csrc/scl_decode.cu`) and K3 (`csrc/pac_decode.cu`) take
list sizes 8193..16384 through their cluster instantiations on a
thread-block cluster of 16 blocks of 1024 threads, a non-portable cluster
size that the host allows on the kernel (`allow_cluster` in
`csrc/list_decode.cuh`); each block holds what it holds at M = 8192.  On
the CPU:

* the plain `decode_scl_batch` in float64 against JAX's at P(32,28) M=16384,
  where the list fills, CRC-24A on with a forced plan and off without: every
  field of the list; the plain float32 decoder against the JAX float32
  golden file `tests/golden/scl_f32_16k.npz` (P(128,64) M=16384), which the
  card holds K1 to;
* the plain `pac_list_decode_batch` list fields against JAX's at
  PAC(32,12)+CRC-16 L=16384;
* `cluster_blocks` (16 for M 8193..16384), `cluster_exchanges(32768)`, a
  block's bytes (those of M = 8192), the launch plan on a stand-in
  occupancy calculator (the same G as at 8192; none placed raises),
  `scratch_bytes` and the batch split at M = 16384, `check_shape` over M
  and L 8193..16384 at N 128..65536 (the first size refused is 65537, past
  the four paths a thread of `tests/test_torch_list_64k.py`);
* the largest 32-bit products of the cluster kernels at M = 16384, N =
  65536, against 2^31.

The models of the cluster sort over 16 blocks (32768 keys: its stages,
barriers and buffer races over three sorts in a row, and the final rank)
and of the phase barriers at N = 65536 are cases of
`tests/test_torch_cluster_lists.py`'s model tests.

On the card (marker `gpu`): K1 and K3 at 16384 against their plain versions.
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

GOLDEN = Path(__file__).resolve().parent / "golden" / "scl_f32_16k.npz"
P16 = 32768  # the keys of a fork at M 8193..16384
LONG_N = (16384, 32768, 65536)


# ---- the plain decoders against JAX at list size 16384 ----

@pytest.mark.parametrize("use_crc,use_plan", [(True, True), (False, False)])
def test_plain_scl_equals_jax_float64_at_m16384(use_crc, use_plan):
    N, K, M = 32, 28, 16384  # 2^28 paths: the list fills
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


def test_plain_pac_list_fields_equal_jax_at_l16384():
    L = 16384
    mask = _pac_mask(32, 12 + PAC_CRC[0])
    llr = np.random.default_rng(L).normal(1.0, 2.0, (2, 32)).astype(np.float32)
    ref = jax_pac_decode(jnp.asarray(llr), mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
    res = pac_list_decode_batch(torch.from_numpy(llr), mask, PAC_GEN, L, crc_len=PAC_CRC[0],
                                crc_poly=PAC_CRC[1])
    for f in ("extracted", "crc_pass", "v_full", "valid", "metrics", "candidates"):
        np.testing.assert_array_equal(res[f].numpy(), np.asarray(ref[f]), err_msg=f)
    assert res["metrics"].shape == (2, L) and bool(res["valid"].all())  # 2^28 paths: the list fills


def test_plain_float32_matches_jax_golden_at_m16384():
    """The golden file the card holds K1 to at M=16384: its first two
    frames through the plain float32 decoder, equal to JAX float32 in bits
    and pass flags, with the best path's info LLRs and every path's metric
    within 1e-6 relative."""

    with np.load(GOLDEN) as g:
        gold = {k: g[k] for k in g.files}
    case, = json.loads(str(gold["cases"]))
    assert (case["N"], case["K"], case["M"], case["crc"]) == (128, 64, 16384, CRC)
    assert GOLDEN.stat().st_size < 500_000
    tag, code = case["name"], case["code"]
    llr = torch.from_numpy(gold[f"{code}/llr"][:2])
    res = decode_scl_batch(llr, gold[f"{code}/info"], 16384, CRC, dtype=torch.float32)
    bits, passed = res.best_path_bits.numpy(), res.crc_pass.numpy()
    bad = np.any(bits != gold[f"{tag}/bits"][:2], axis=1) | (passed != gold[f"{tag}/crc_pass"][:2])
    ties = _near_ties(res.metrics.numpy()[:, :64]) | _near_ties(gold[f"{tag}/metrics"][:2, :64])
    assert not (bad & ~ties).any(), np.flatnonzero(bad & ~ties)
    np.testing.assert_allclose(res.best_path_info_llrs.numpy()[~bad], gold[f"{tag}/llrs"][:2][~bad],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(res.metrics.numpy(), gold[f"{tag}/metrics"][:2], rtol=1e-6, atol=0)


# ---- the planning ----

def test_cluster_of_16_blocks():
    # the largest cluster: 16 blocks, at one path a thread up to 16384 (two
    # up to 32768, four above, to MAX_M)
    assert scl_cuda.MAX_M == pac_cuda.MAX_L == 65536 and scl_cuda.CLUSTER_MAX_BLOCKS == 16
    assert scl_cuda.CLUSTER_PAIR_MIN_M == 16385 and scl_cuda.cluster_ppt(16384) == 1
    for M in (8193, 9000, 12000, 12289, 16383, 16384):
        assert scl_cuda.sort_keys(M) == P16 and scl_cuda.cluster_blocks(M) == 16
    assert [scl_cuda.cluster_blocks(M) for M in (8192, 8193)] == [8, 16]
    # one cross-block stage a merge level j >= 2048 (1 + 2 + 3 + 4) and the sorted keys
    assert scl_cuda.cluster_exchanges(P16) == 11
    assert [scl_cuda.cluster_exchanges(P) for P in (4096, 8192, 16384)] == [2, 4, 7]
    # a block holds 1024 paths whatever the cluster: the bytes of M = 8192
    for N in (16, 128, 1024, 8192, 65536):
        n = N.bit_length() - 1
        for g in range(n):
            assert scl_cuda.frame_bytes(N, N // 2, 16384, g) == scl_cuda.frame_bytes(N, N // 2, 8192, g)
            assert (pac_cuda.frame_bytes(N, N // 2, 16384, g) == pac_cuda.frame_bytes(N, N // 2, 8192, g)
                    == scl_cuda.cluster_block_bytes(N, g, 3))


def test_check_shape_takes_lists_up_to_16384():
    for N in (128, 1024, 8192) + LONG_N:
        for M in (8193, 12000, 16384):
            scl_cuda.check_shape(N, N // 2, M, CRC, torch.float32)
            scl_cuda.check_shape(N, N // 2, M, None, torch.float32)
            pac_cuda.check_shape(N, N // 2 + 16, M, GEN, 16, torch.float32)
    for M in range(8193, 16385, 257):
        scl_cuda.check_shape(128, 64, M, None, torch.float32)
        pac_cuda.check_shape(128, 80, M, GEN, 16, torch.float32)
    scl_cuda.check_shape(65536, 65536, 16384, CRC, torch.float32)  # K = N: the largest trace
    for N in (128, 65536):  # past four paths a thread of a cluster of 16 blocks
        with pytest.raises(ValueError, match="1..65536 .*16 blocks"):
            scl_cuda.check_shape(N, N // 2, 65537, CRC, torch.float32)
        with pytest.raises(ValueError, match="1..65536 .*16 blocks"):
            pac_cuda.check_shape(N, N // 2 + 16, 65537, GEN, 16, torch.float32)
    with pytest.raises(ValueError, match="65536"):
        scl_cuda.check_shape(131072, 65536, 16384, CRC, torch.float32)
    with pytest.raises(ValueError, match="65536"):
        pac_cuda.check_shape(131072, 65552, 16384, GEN, 16, torch.float32)
    # the routing takes them on the card, and refuses 65537 there
    assert resolve_backend(torch.device("cuda"), M=16384, dtype=torch.float32, N=128, K=64) == "cuda"
    with pytest.raises(ValueError, match="65536"):
        resolve_backend(torch.device("cuda"), M=65537, dtype=torch.float32, N=128, K=64)


@pytest.mark.parametrize("N", [16, 128, 1024, 8192, 65536])
def test_plan_at_16384_pins_the_g_of_8192(N, monkeypatch):
    # a stand-in occupancy calculator: 7 clusters of 16 (15 of 8) where a
    # block's shared memory fits, none where it does not
    def occupancy(frame_bytes):
        def at(N, K, M, G):
            fits = frame_bytes(N, K, M, G) <= scl_cuda.MAX_BLOCK_SMEM
            return 1, (7 if scl_cuda.cluster_blocks(M) == 16 else 15) if fits else 0
        return at

    monkeypatch.setattr(scl_cuda, "_occupancy", occupancy(scl_cuda.frame_bytes))
    monkeypatch.setattr(pac_cuda, "_occupancy", occupancy(pac_cuda.frame_bytes))
    scl_cuda._plan.cache_clear()
    pac_cuda.launch_plan.cache_clear()
    try:
        k1 = [scl_cuda.launch_plan(N, N // 2, M, 1024) for M in (8192, 8193, 16384)]
        k3 = [pac_cuda.launch_plan(N, N // 2 + 16, L) for L in (8192, 8193, 16384)]
        # a card that places no cluster of 16 raises, naming it
        monkeypatch.setattr(scl_cuda, "_occupancy", lambda N, K, M, G: (1, 0))
        monkeypatch.setattr(pac_cuda, "_occupancy", lambda N, K, L, G: (1, 0))
        scl_cuda._plan.cache_clear()
        pac_cuda.launch_plan.cache_clear()
        with pytest.raises(RuntimeError, match="no cluster of 16 blocks"):
            scl_cuda.launch_plan(N, N // 2, 16384, 1024)
        with pytest.raises(RuntimeError, match="no cluster of 16 blocks"):
            pac_cuda.launch_plan(N, N // 2 + 16, 16384)
    finally:
        scl_cuda._plan.cache_clear()
        pac_cuda.launch_plan.cache_clear()
    for plans in (k1, k3):
        assert [p[0] for p in plans] == [plans[0][0]] * 3 and [p[1:] for p in plans] == [(1, 15), (1, 7), (1, 7)]


def test_scratch_and_split_at_16384():
    # levels 1..G, the trace LLRs and 16-bit trace indices: M times 2 of M = 8192's
    for N, K, G in ((128, 64, 3), (65536, 32768, 13), (65536, 65536, 13)):
        assert scl_cuda.scratch_bytes(1, N, K, 16384, G) == 2 * scl_cuda.scratch_bytes(1, N, K, 8192, G)
        assert pac_cuda.scratch_bytes(1, N, K, 16384, G) == 2 * pac_cuda.scratch_bytes(1, N, K, 8192, G)
    # about 8.6 GB a frame at P(65536,32768) G=13, 16 GB at B=1024 P(128,64)
    one = scl_cuda.scratch_bytes(1, 65536, 32768, 16384, 13)
    assert one == 16384 * (65528 * 5 + 32768 * 6) == 8_589_279_232
    assert scl_cuda.scratch_bytes(1024, 128, 64, 16384, 3) == 1024 * 16384 * (112 * 5 + 64 * 6) == 15_837_691_904
    # a card with 80 GB free takes 8 such frames a launch; one frame with 9 GB free raises
    assert scl_cuda.split_batch(64, one, 80 * 10 ** 9) == 72 * 10 ** 9 // one == 8
    with pytest.raises(ValueError, match=f"{one} bytes"):
        scl_cuda.split_batch(1, one, 9 * 10 ** 9)

    def alloc(frames):  # a stand-in allocator with 80 GB free
        if frames * one > 80 * 10 ** 9:
            raise torch.cuda.OutOfMemoryError(f"{frames} frames")
        return frames

    assert scl_cuda.alloc_scratch(64, one, alloc, lambda: 80 * 10 ** 9, "K1") == (8, 8)
    assert scl_cuda.alloc_scratch(4, one, alloc, lambda: 80 * 10 ** 9, "K1") == (4, 4)


def test_offsets_stay_below_2_31_at_16384():
    """The cluster kernels index within a frame with 32-bit products (the
    frame's base is 64-bit): the largest at M = L = 16384 and N = K = 65536
    reach 2^30 − 1, half of 2^31, and would reach 2^31 at 32768."""

    M, N = 16384, 65536
    K = N
    G = 13  # the plan's G at N=65536 (K1; K3 takes 14, a shorter global row)
    SG = N - (N >> G)
    largest = {
        "trace entry info_i·M + m": (K - 1) * M + (M - 1),
        "K3 v row m·N + u": (M - 1) * N + (N - 1),
        "global row r·SG + entry": (M - 1) * SG + (SG - 1),
        "a block's v rows base·N + t": (M - 1024) * N + (1024 * N - 1),
    }
    for name, value in largest.items():
        assert value < 2 ** 30 <= 2 ** 31 - 1, name
        # a list twice as long takes the trace entry and the v row to 2^31
        if name in ("trace entry info_i·M + m", "K3 v row m·N + u"):
            assert 2 * value + 1 >= 2 ** 31 - 1
    # σ fields and trace entries (2p + b, parent << 1 | v) are 16-bit: below 2M = 32768
    assert 2 * (M - 1) + 1 < 2 ** 16 and 2 * M <= 2 ** 15
    # the sort keys' index word holds 2M candidates
    assert 2 * M - 1 < 2 ** 32


# ---- on the card (marker `gpu`; skipped without a CUDA device) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_k1_at_16384_matches_plain_on_card(cuda_device):
    N, K, M = 128, 64, 16384
    info = construct_info_set(N, K)
    llr, msgs = noisy_llrs(N, K, 3, snr_db=2.0, seed=M)
    x = torch.from_numpy(llr.astype(np.float32)).to(cuda_device)
    plan = torch.from_numpy(forced_plan(msgs, seed=M)).to(cuda_device)
    launches = scl_cuda.decode_scl_cuda.cluster_launches
    out = scl_cuda.decode_scl_cuda(x, info, M, CRC, force_info_bits=plan, full=True)
    torch.cuda.synchronize()
    assert scl_cuda.decode_scl_cuda.cluster_launches == launches + 1
    ref = decode_scl_batch(x, info, M, CRC, force_info_bits=plan)
    for f in ("best_path_bits", "crc_pass", "candidates", "valid", "best_index"):
        assert torch.equal(out[f], getattr(ref, f).to(out[f].dtype)), f


@pytest.mark.gpu
def test_k3_at_16384_matches_plain_on_card(cuda_device):
    L = 16384
    mask = _pac_mask(32, 12 + PAC_CRC[0])
    x = torch.from_numpy(np.random.default_rng(L).normal(1.0, 2.0, (3, 32)).astype(np.float32))
    x = x.to(cuda_device)
    out = pac_cuda.pac_list_decode_cuda(x, mask, PAC_GEN, L, *PAC_CRC, full=True)
    torch.cuda.synchronize()
    ref = pac_list_decode_batch(x, mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
    for f in ("extracted", "crc_pass", "v_full", "candidates", "metrics", "valid", "best_index"):
        assert torch.equal(out[f], ref[f]), f
