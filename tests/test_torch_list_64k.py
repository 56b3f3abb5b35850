"""List sizes past 32768: K1 and K3 at M and L 32769..65536, held against JAX.

On the card K1 (`csrc/scl_decode.cu`) and K3 (`csrc/pac_decode.cu`) take
list sizes 32769..65536 through their quad instantiations: a frame over a
thread-block cluster of 16 blocks of 1024 threads (the largest cluster an
H100 places), four paths a thread and eight sort keys
(`cluster_sort_keysn<8>` in `csrc/list_decode.cuh`), 32-bit trace entries
and σ fields (2p + b reaches 131071), σ's two tables and the published
words in global scratch, and only level n in a block's shared memory.  On
the CPU:

* the plain `decode_scl_batch` in float64 against JAX's at P(32,28) M=65536,
  where the list fills after 16 info bits, CRC-24A on with a forced plan
  and off without: every field of the list; the plain float32 decoder
  against the JAX float32 golden file `tests/golden/scl_f32_64k.npz`
  (P(128,64) M=65536), which the card holds K1 to;
* the plain `pac_list_decode_batch` list fields against JAX's at
  PAC(32,12)+CRC-16 L=65536;
* `cluster_ppt` (4) and `cluster_blocks` (16) over M 32769..65536,
  `cluster_exchanges(131072)`, a block's bytes (three buffers of 8192
  keys, level n's rows of 4096 paths, no σ and no word sets) within 227 KB
  at the plan's G = n − 1 at every N 16..65536 on a stand-in occupancy
  calculator, `scratch_bytes` with σ's 32-bit tables and the word sets, the
  batch split at 65536, `check_shape` over M and L 32769..65536 at N
  128..65536 and raising at 65537, and the routing;
* the trace entries and σ fields of 4 bytes above 32768, and the
  within-frame offsets at M = L = 65536, N = K = 65536 against 2^32.

The models of the cluster sort at eight keys a thread over 16 blocks
(131072 keys: the stable sort, its buffers across forks, the final rank)
are cases of `tests/test_torch_cluster_lists.py`'s model tests.

On the card (marker `gpu`): K1 and K3 at 65536 against their plain versions.
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

GOLDEN = Path(__file__).resolve().parent / "golden" / "scl_f32_64k.npz"
P64 = 131072  # the keys of a fork at M 32769..65536
LONG_N = (16384, 32768, 65536)
NS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192) + LONG_N


# ---- the plain decoders against JAX at list size 65536 ----

@pytest.mark.parametrize("use_crc,use_plan", [(True, True), (False, False)])
def test_plain_scl_equals_jax_float64_at_m65536(use_crc, use_plan):
    N, K, M = 32, 28, 65536  # 2^28 paths: the list fills after 16 info bits
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


def test_plain_pac_list_fields_equal_jax_at_l65536():
    L = 65536
    mask = _pac_mask(32, 12 + PAC_CRC[0])
    llr = np.random.default_rng(L).normal(1.0, 2.0, (2, 32)).astype(np.float32)
    ref = jax_pac_decode(jnp.asarray(llr), mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
    res = pac_list_decode_batch(torch.from_numpy(llr), mask, PAC_GEN, L, crc_len=PAC_CRC[0],
                                crc_poly=PAC_CRC[1])
    for f in ("extracted", "crc_pass", "v_full", "valid", "metrics", "candidates"):
        np.testing.assert_array_equal(res[f].numpy(), np.asarray(ref[f]), err_msg=f)
    assert res["metrics"].shape == (2, L) and bool(res["valid"].all())  # 2^28 paths: the list fills


def test_plain_float32_matches_jax_golden_at_m65536():
    """The golden file the card holds K1 to at M=65536: its first two
    frames through the plain float32 decoder, equal to JAX float32 in bits
    and pass flags, with the best path's info LLRs and every path's metric
    within 1e-6 relative."""

    with np.load(GOLDEN) as g:
        gold = {k: g[k] for k in g.files}
    case, = json.loads(str(gold["cases"]))
    assert (case["N"], case["K"], case["M"], case["crc"]) == (128, 64, 65536, CRC)
    assert GOLDEN.stat().st_size < 1_100_000
    tag, code = case["name"], case["code"]
    llr = torch.from_numpy(gold[f"{code}/llr"][:2])
    res = decode_scl_batch(llr, gold[f"{code}/info"], 65536, CRC, dtype=torch.float32)
    bits, passed = res.best_path_bits.numpy(), res.crc_pass.numpy()
    bad = np.any(bits != gold[f"{tag}/bits"][:2], axis=1) | (passed != gold[f"{tag}/crc_pass"][:2])
    ties = _near_ties(res.metrics.numpy()[:, :64]) | _near_ties(gold[f"{tag}/metrics"][:2, :64])
    assert not (bad & ~ties).any(), np.flatnonzero(bad & ~ties)
    np.testing.assert_allclose(res.best_path_info_llrs.numpy()[~bad], gold[f"{tag}/llrs"][:2][~bad],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(res.metrics.numpy(), gold[f"{tag}/metrics"][:2], rtol=1e-6, atol=0)


# ---- the planning ----

def test_four_paths_a_thread_on_16_blocks():
    for M in (32769, 40000, 50000, 65535, 65536):
        assert scl_cuda.sort_keys(M) == P64 and scl_cuda.cluster_blocks(M) == 16
        assert scl_cuda.cluster_ppt(M) == 4
    assert [scl_cuda.cluster_ppt(M) for M in (16384, 16385, 32768, 32769, 65536)] == [1, 2, 2, 4, 4]
    # one cross-block stage a merge level j >= 8192 (1 + 2 + 3 + 4) and the sorted keys
    assert scl_cuda.cluster_exchanges(P64) == 11
    # a block of 4096 paths: three buffers of 8192 keys (192 KB) and the
    # rows of levels G+1..n; σ's tables and the word sets in global scratch
    r16 = lambda x: (x + 15) // 16 * 16  # noqa: E731
    for N in NS:
        n = N.bit_length() - 1
        for g in range(n):
            ss = (N >> g) - 1
            want = 3 * 8 * 8192 + r16(4 * 4096 * ss) + r16(4096 * ss) + 16
            for words in (2, 3):
                assert scl_cuda.cluster_block_bytes(N, g, words, 4) == want
            assert scl_cuda.frame_bytes(N, N // 2, 65536, g) == want
            assert pac_cuda.frame_bytes(N, N // 2, 40000, g) == want
    # the keys alone are 196,608 B: with level n's rows 217,104 B, and one
    # more level (G = n − 2) is 258,064 B, past a block's 232,448
    assert scl_cuda.frame_bytes(128, 64, 65536, 6) == 196608 + 16384 + 4096 + 16 == 217104
    assert scl_cuda.frame_bytes(128, 64, 65536, 5) == 196608 + 49152 + 12288 + 16 == 258064
    # the word sets would not fit beside the keys in shared memory either
    assert 196608 + 2 * 2 * 4 * 4096 + 20480 > scl_cuda.MAX_BLOCK_SMEM


@pytest.mark.parametrize("N", NS)
def test_plan_at_65536_fits_a_block(N, monkeypatch):
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
        k1 = [scl_cuda.launch_plan(N, N // 2, M, 1024) for M in (32769, 65536)]
        k3 = [pac_cuda.launch_plan(N, N // 2 + 16, L) for L in (32769, 65536)]
        monkeypatch.setattr(scl_cuda, "_occupancy", lambda N, K, M, G: (1, 0))
        monkeypatch.setattr(pac_cuda, "_occupancy", lambda N, K, L, G: (1, 0))
        scl_cuda._plan.cache_clear()
        pac_cuda.launch_plan.cache_clear()
        with pytest.raises(RuntimeError, match="no cluster of 16 blocks"):
            scl_cuda.launch_plan(N, N // 2, 65536, 1024)
        with pytest.raises(RuntimeError, match="no cluster of 16 blocks"):
            pac_cuda.launch_plan(N, N // 2 + 16, 65536)
    finally:
        scl_cuda._plan.cache_clear()
        pac_cuda.launch_plan.cache_clear()
    n = N.bit_length() - 1
    # the only G whose block fits 227 KB: n − 1, level n alone in shared memory
    for plans, words in ((k1, 2), (k3, 3)):
        assert plans == [(n - 1, 1, 7)] * 2
        assert scl_cuda.cluster_block_bytes(N, n - 1, words, 4) == 217104 <= scl_cuda.MAX_BLOCK_SMEM
        if n > 1:
            assert scl_cuda.cluster_block_bytes(N, n - 2, words, 4) > scl_cuda.MAX_BLOCK_SMEM


def test_check_shape_takes_lists_up_to_65536():
    for N in (128, 1024, 8192) + LONG_N:
        for M in (32769, 50000, 65536):
            scl_cuda.check_shape(N, N // 2, M, CRC, torch.float32)
            scl_cuda.check_shape(N, N // 2, M, None, torch.float32)
            pac_cuda.check_shape(N, N // 2 + 16, M, GEN, 16, torch.float32)
    for M in range(32769, 65537, 1023):
        scl_cuda.check_shape(128, 64, M, None, torch.float32)
        pac_cuda.check_shape(128, 80, M, GEN, 16, torch.float32)
    scl_cuda.check_shape(65536, 65536, 65536, CRC, torch.float32)  # K = N: the largest trace
    pac_cuda.check_shape(65536, 65536, 65536, GEN, 16, torch.float32)
    for N in (128, 65536):
        with pytest.raises(ValueError, match="1..65536 .*four paths a thread"):
            scl_cuda.check_shape(N, N // 2, 65537, CRC, torch.float32)
        with pytest.raises(ValueError, match="1..65536 .*four paths a thread"):
            pac_cuda.check_shape(N, N // 2 + 16, 65537, GEN, 16, torch.float32)
    # the routing takes 65536 on the card and refuses 65537 there
    assert resolve_backend(torch.device("cuda"), M=65536, dtype=torch.float32, N=128, K=64) == "cuda"
    with pytest.raises(ValueError, match="65536"):
        resolve_backend(torch.device("cuda"), M=65537, dtype=torch.float32, N=128, K=64)


def test_trace_entries_are_32_bit_above_32768():
    # 2p + b < 2M: a byte up to M = 128, 16 bits up to 32768 (65535), 32 above
    # (131071 at M = 65536); the σ fields on a cluster are as wide
    assert [scl_cuda.trace_entry_bytes(M) for M in (128, 129, 32768, 32769, 65536)] == [1, 2, 2, 4, 4]
    assert 2 * (32768 - 1) + 1 == 2 ** 16 - 1 and 2 * (65536 - 1) + 1 == 131071 > 2 ** 16 - 1
    assert [scl_cuda.sigma_row(N, 65536) for N in (2, 16, 128, 65536)] == [4, 24, 48, 120]
    assert [scl_cuda.sigma_row(N, 32768) for N in (2, 16, 128, 65536)] == [4, 12, 24, 60]
    assert scl_cuda.sigma_row(128) == 24  # 16-bit fields below 32769


def test_scratch_and_split_at_65536():
    # levels 1..G, the trace LLRs and 32-bit trace indices, σ's two tables of
    # 32-bit rows and the two sets of published words (2 K1, 3 K3)
    for N, K, G in ((128, 64, 6), (65536, 256, 15), (65536, 65536, 15)):
        sig = 2 * 65536 * scl_cuda.sigma_row(N, 65536)
        assert scl_cuda.sigma_bytes(1, N, 65536) == sig + 2 * 2 * 4 * 65536
        assert scl_cuda.sigma_bytes(1, N, 65536, 3) == sig + 2 * 3 * 4 * 65536
        lvl = 65536 * (N - (N >> G)) * 5
        assert scl_cuda.scratch_bytes(1, N, K, 65536, G) == lvl + 65536 * K * 8 + sig + 16 * 65536
        assert pac_cuda.scratch_bytes(1, N, K, 65536, G) == lvl + 65536 * K * 4 + sig + 24 * 65536
    # about 82 MB a frame at P(128,64): 41.3 MB of tree rows, 33.6 MB of
    # trace, 6.3 MB of σ, 1 MB of words
    one = scl_cuda.scratch_bytes(1, 128, 64, 65536, 6)
    assert one == 65536 * (126 * 5 + 64 * 8 + 2 * 48 + 16) == 82_182_144
    # about 21.6 GB a frame at P(65536,256) G=15
    big = scl_cuda.scratch_bytes(1, 65536, 256, 65536, 15)
    assert big == 65536 * (65534 * 5 + 256 * 8 + 2 * 120 + 16) == 21_625_176_064
    # a card with 80 GB free takes 3 such frames a launch and 876 of
    # P(128,64), so a B=1024 launch at P(128,64) splits; one frame with 20
    # GB free raises
    assert scl_cuda.split_batch(64, big, 80 * 10 ** 9) == 72 * 10 ** 9 // big == 3
    assert scl_cuda.split_batch(1024, one, 80 * 10 ** 9) == 876
    with pytest.raises(ValueError, match=f"{big} bytes"):
        scl_cuda.split_batch(1, big, 20 * 10 ** 9)

    def alloc(frames):  # a stand-in allocator with 80 GB free
        if frames * one > 80 * 10 ** 9:
            raise torch.cuda.OutOfMemoryError(f"{frames} frames")
        return frames

    assert scl_cuda.alloc_scratch(1024, one, alloc, lambda: 80 * 10 ** 9, "K1") == (876, 876)
    assert scl_cuda.alloc_scratch(256, one, alloc, lambda: 80 * 10 ** 9, "K1") == (256, 256)


def test_offsets_at_65536_need_64_bits():
    """At M = L = 65536 and N = K = 65536 the largest within-frame products
    of the cluster kernels reach 2^32 − 1, past a 32-bit int: the quad
    instantiations compute them in 64 bits (`ClusterOff<4>`), as the pair
    ones do from 2^31 − 1.  The sort keys' index word still holds them."""

    M, N = 65536, 65536
    K = N
    G = 15  # the plan's G at N=65536
    SG = N - (N >> G)
    largest = {
        "trace entry info_i·M + m": (K - 1) * M + (M - 1),
        "K3 v row m·N + u": (M - 1) * N + (N - 1),
        "global row r·SG + entry": (M - 1) * SG + (SG - 1),
        "a block's v rows base·N + t": (M - 4096) * N + (4096 * N - 1),
        "σ's table (frame's 2nd) row p": (2 * M - 1) * 30 + 29,
        "a word set's entry (frame's last)": (2 * 3 - 1) * M + (M - 1),
    }
    for name in ("trace entry info_i·M + m", "K3 v row m·N + u", "a block's v rows base·N + t"):
        assert largest[name] == 2 ** 32 - 1 and largest[name] >= 2 ** 31, name
    assert largest["global row r·SG + entry"] >= 2 ** 31
    assert largest["σ's table (frame's 2nd) row p"] < 2 ** 31
    assert largest["a word set's entry (frame's last)"] < 2 ** 31
    for value in largest.values():
        assert value < 2 ** 63
    # the sort keys' index word holds the 2M candidates, and the cluster
    # sort's key positions (q·g + i < P = 2^17) an int
    assert 2 * M - 1 < 2 ** 32 and P64 < 2 ** 31


# ---- on the card (marker `gpu`; skipped without a CUDA device) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_k1_at_65536_matches_plain_on_card(cuda_device):
    N, K, M = 128, 64, 65536
    info = construct_info_set(N, K)
    llr, msgs = noisy_llrs(N, K, 3, snr_db=2.0, seed=M)
    x = torch.from_numpy(llr.astype(np.float32)).to(cuda_device)
    plan = torch.from_numpy(forced_plan(msgs, seed=M)).to(cuda_device)
    launches = scl_cuda.decode_scl_cuda.quad_launches
    out = scl_cuda.decode_scl_cuda(x, info, M, CRC, force_info_bits=plan, full=True)
    torch.cuda.synchronize()
    assert scl_cuda.decode_scl_cuda.quad_launches == launches + 1
    ref = decode_scl_batch(x, info, M, CRC, force_info_bits=plan)
    for f in ("best_path_bits", "crc_pass", "candidates", "valid", "best_index"):
        assert torch.equal(out[f], getattr(ref, f).to(out[f].dtype)), f


@pytest.mark.gpu
def test_k3_at_65536_matches_plain_on_card(cuda_device):
    L = 65536
    mask = _pac_mask(32, 12 + PAC_CRC[0])
    x = torch.from_numpy(np.random.default_rng(L).normal(1.0, 2.0, (3, 32)).astype(np.float32))
    x = x.to(cuda_device)
    launches = pac_cuda.pac_list_decode_cuda.quad_launches
    out = pac_cuda.pac_list_decode_cuda(x, mask, PAC_GEN, L, *PAC_CRC, full=True)
    torch.cuda.synchronize()
    assert pac_cuda.pac_list_decode_cuda.quad_launches == launches + 1
    ref = pac_list_decode_batch(x, mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
    for f in ("extracted", "crc_pass", "v_full", "candidates", "metrics", "valid", "best_index"):
        assert torch.equal(out[f], ref[f]), f
