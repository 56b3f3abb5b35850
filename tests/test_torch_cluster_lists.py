"""The list decoders past one block: list sizes 1025..8192, held against JAX.

On the card K1 (`csrc/scl_decode.cu`) and K3 (`csrc/pac_decode.cu`) take
list sizes 1025..8192 through their cluster instantiations (a frame spread
over a thread-block cluster of 2, 4 or 8 blocks of 1024 threads, one thread
a path, every tree level in global scratch), and K3's one-path-a-lane
instantiation keeps its trace in global scratch, so it takes PAC(8192, Kp)
at every Kp.  On the CPU:

* the plain `decode_scl_batch` in float64 against JAX's at P(32,28), M 1536
  and 2048, where the list fills, CRC-24A on and off, a forced plan on one
  case: every field of the list;
* the plain `pac_list_decode_batch` list fields against JAX's at
  PAC(32,12)+CRC-16 L=2048;
* the planning: `cluster_blocks`, the bytes a block and a frame of a
  cluster take, `scratch_bytes`, `cluster_batch`, `check_shape` over M and L
  1025..8192 at N 128..8192 and raising at 8193 and at N=16384, and K3's
  one-lane frame without the trace;
* a model of the cluster sort (`cluster_sort_keys` in
  `csrc/list_decode.cuh`: the stages across blocks through DSMEM between
  cluster barriers, then those of `block_sort_keys`) against the stable
  sort at P = 4096, 8192 and 16384 keys, with its count of cross-block
  stages, and of the final rank by the same sort.

On the card (marker `gpu`): K1 and K3 on a cluster against their plain
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
from polar_code_tpu_torch.ops.backend import resolve_backend
from polar_code_tpu_torch.ops.scl import decode_scl_batch
from polar_code_tpu_torch.polar.construct import construct_info_set

CRC = "0x1864CFB"  # CRC-24A
FIELDS_EXACT = ("candidates", "valid", "best_index", "best_path_bits", "crc_pass")
FIELDS_CLOSE = ("metrics", "info_llrs", "best_path_info_llrs")
PAC_GEN = (1, 0, 1, 1, 0, 1, 1)
PAC_CRC = (16, 0x1021)
GEN = list(PAC_GEN)
ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def noisy_llrs(N, K, B, snr_db, seed):
    """Float64 LLRs of CRC-24A codewords over BPSK/AWGN (numpy draws; the
    JAX package encodes), and the sent bits."""

    rng = np.random.default_rng(seed)
    info = jax_info_set(N, K)
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


# ---- the plain decoders against JAX at list sizes above 1024 ----

@pytest.mark.parametrize("M,use_crc,use_plan", [(1536, True, True), (2048, False, False)])
def test_plain_scl_equals_jax_float64_at_cluster_list_sizes(M, use_crc, use_plan):
    N, K = 32, 28  # 2^28 paths: the list fills
    llr, msgs = noisy_llrs(N, K, 4, snr_db=1.0, seed=M)
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
    assert res.metrics.shape == (4, M)
    assert int(res.valid.numpy()[1::2].sum()) == 2 * M  # the unplanned frames' lists fill


def _pac_mask(N, Kp):
    rp = jax_rateprofile(N, Kp, 2.0, 0)
    rp.build_mask("dega")
    return np.asarray(rp.modify_profile())


def test_plain_pac_list_fields_equal_jax_at_l2048():
    L = 2048
    mask = _pac_mask(32, 12 + PAC_CRC[0])
    llr = np.random.default_rng(L).normal(1.0, 2.0, (4, 32)).astype(np.float32)
    ref = jax_pac_decode(jnp.asarray(llr), mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
    res = pac_list_decode_batch(torch.from_numpy(llr), mask, PAC_GEN, L, crc_len=PAC_CRC[0],
                                crc_poly=PAC_CRC[1])
    for f in ("extracted", "crc_pass", "v_full", "valid", "metrics", "candidates"):
        np.testing.assert_array_equal(res[f].numpy(), np.asarray(ref[f]), err_msg=f)
    assert res["metrics"].shape == (4, L) and bool(res["valid"].all())  # 2^28 paths: the list fills


# ---- the planning ----

def test_cluster_blocks_and_bytes():
    assert [scl_cuda.cluster_blocks(M) for M in (1025, 2048, 2049, 3000, 4096, 4097, 8192)] == [
        2, 2, 4, 4, 4, 8, 8]
    r16 = lambda x: (x + 15) // 16 * 16  # noqa: E731
    for n in range(1, 14):
        N = 1 << n
        sig_row = max(4, ((2 * n - 2) * 2 + 3) // 4 * 4)  # 16-bit σ fields, a row to 4 bytes
        # two σ tables of 1024 paths, 2048 sort keys, 2 (PAC 3) words a path, the selected rank
        want = 2 * r16(1024 * sig_row) + 8 * 2048 + 2 * 4 * 1024 + 16
        assert scl_cuda.cluster_block_bytes(N) == want
        assert pac_cuda.frame_bytes(N, N // 2, 2048, n) == want + 4 * 1024
        for M in (1025, 4096, 8192):  # every tree level in global scratch, whatever G
            assert scl_cuda.frame_bytes(N, N // 2, M, 0) == scl_cuda.frame_bytes(N, N // 2, M, n - 1) == want
    # N=8192: 24 fields of 2 bytes, 48 KB a σ table; 122,896 B a block, under a block's 227 KB
    assert scl_cuda.cluster_block_bytes(8192) == 2 * 49152 + 16384 + 8192 + 16 == 122896
    assert pac_cuda.frame_bytes(8192, 4112, 8192, 13) == 122896 + 4096 <= scl_cuda.MAX_BLOCK_SMEM
    # a frame of M=8192 over its cluster of 8 blocks
    assert scl_cuda.cluster_blocks(8192) * scl_cuda.cluster_block_bytes(8192) == 8 * 122896


def test_cluster_scratch_bytes():
    # every level in global scratch (G = n: rows of N − 1 entries), the trace
    # LLRs and 16-bit trace indices
    for M in (1025, 2048, 8192):
        assert scl_cuda.scratch_bytes(4096, 128, 64, M, 7) == 4096 * M * (127 * 5 + 64 * 6)
    # about 34 GB at B=4096 P(128,64) M=8192; 8.5 GB at B=1024
    assert scl_cuda.scratch_bytes(4096, 128, 64, 8192, 7) == 34_191_966_208
    assert scl_cuda.scratch_bytes(1, 8192, 1024, 2048, 13) == 2048 * (8191 * 5 + 1024 * 6)
    assert pac_cuda.scratch_bytes(1, 128, 80, 2048, 7) == 2048 * (127 * 5 + 80 * 2)
    # one path a lane: rows of round16(L) bytes of trace, levels 1..G
    assert pac_cuda.scratch_bytes(8, 8192, 7400, 32, 12) == 8 * (32 * 8190 * 5 + 7400 * 32)
    assert pac_cuda.scratch_bytes(8, 128, 80, 5, 0) == 8 * 80 * 16
    assert pac_cuda.scratch_bytes(8, 128, 80, 1, 0) == 0  # one path: no trace
    # a launch takes all B, or the most frames whose scratch fits 0.9 of the free bytes
    one = scl_cuda.scratch_bytes(1, 8192, 1024, 8192, 13)
    assert scl_cuda.cluster_batch(1000, one, 80 * 10 ** 9) == 72 * 10 ** 9 // one == 186
    assert scl_cuda.cluster_batch(16, one, 80 * 10 ** 9) == 16
    with pytest.raises(ValueError, match=f"{one} bytes"):
        scl_cuda.cluster_batch(4, one, one)


def test_check_shape_takes_lists_up_to_8192():
    for N in (128, 1024, 8192):
        for M in (1025, 1536, 2048, 3000, 4096, 5000, 8192):
            scl_cuda.check_shape(N, N // 2, M, CRC, torch.float32)
            pac_cuda.check_shape(N, N // 2 + 16, M, GEN, 16, torch.float32)
    for M in range(1025, 8193, 127):
        scl_cuda.check_shape(128, 64, M, None, torch.float32)
        pac_cuda.check_shape(128, 80, M, GEN, 16, torch.float32)
    with pytest.raises(ValueError, match="1..8192 .*cluster"):
        scl_cuda.check_shape(128, 64, 8193, CRC, torch.float32)
    with pytest.raises(ValueError, match="1..8192 .*cluster"):
        pac_cuda.check_shape(128, 80, 8193, GEN, 16, torch.float32)
    with pytest.raises(ValueError, match="8192"):
        scl_cuda.check_shape(16384, 8192, 2048, CRC, torch.float32)
    with pytest.raises(ValueError, match="8192"):
        pac_cuda.check_shape(16384, 8208, 2048, GEN, 16, torch.float32)
    # the routing takes them on the card; the shape gate is all it asks there
    assert resolve_backend(torch.device("cuda"), M=8192, dtype=torch.float32, N=1024, K=512) == "cuda"


def test_k3_one_lane_trace_leaves_shared_memory():
    # the frame holds levels G+1..n and (above L=1, whose decisions are its
    # path) a ring of 16 trace rows of round16(L) bytes only: PAC(8192, Kp)
    # at every Kp for L <= 32
    for L in (1, 5, 8, 32):
        ring = pac_cuda.TRACE_RING * ((L + 15) // 16 * 16) if L > 1 else 0
        assert pac_cuda.frame_bytes(8192, 7400, L, 12) == (5 * L + 15) // 16 * 16 + ring
        for kp in (7259, 7260, 7400, 8192):
            pac_cuda.check_shape(8192, kp, L, GEN, 16, torch.float32)
    assert pac_cuda.frame_bytes(128, 80, 32, 0) == 5 * 32 * 127 + 16 * 32


# ---- a model of the cluster sort ----

def _key_word(c):
    """`cand_key`'s high word: a float32's order-preserving 32-bit word,
    −0.0 taken as +0.0."""

    u = np.where(c == 0, np.float32(0), c).astype(np.float32).view(np.uint32)
    return u ^ np.where(u >> np.uint32(31) == 1, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))


def _key_metric(keys):
    w = (keys >> np.uint64(32)).astype(np.uint32)
    return np.where(w >> np.uint32(31) == 1, w ^ np.uint32(0x80000000), ~w).view(np.float32)


def _cluster_sort(k0, k1):
    """`cluster_sort_keys` on a cluster of C = P/2048 blocks of 1024 threads:
    global thread g = 1024·r + t holds keys 2g and 2g + 1 (k0[g], k1[g]).  A
    stage of distance j >= 2048 stores each running thread's keys in its
    block's buffer and reads the partner's from block r ^ j/2048 at the same
    place; below, the block's own buffer, shuffles and registers, as
    `block_sort_keys`.  The upper half stops after the last merge's first
    stage.  Buffers are fresh at each stage, so a read of what no thread
    stored reads a wrong key.  Returns the keys of ranks 0..P/2−1 as the
    blocks store them (rank q in block q >> 11 at q & 2047) and the stages
    of each kind."""

    T = k0.size
    P = 2 * T
    C = T // 1024
    assert C in (2, 4, 8) and P == 2048 * C
    g = np.arange(T)
    base, rank, lbase = 2 * g, g // 1024, 2 * (g % 1024)
    k = np.stack([k0, k1], axis=1)
    on = np.ones(T, bool)
    kinds = {"blocks": 0, "shared": 0, "shuffles": 0, "registers": 0}

    def stage(read, j, up):
        keep_min = ((base & j) == 0)[:, None] == up
        o = read()
        return np.where(on[:, None] & ((o < k) == keep_min), o, k)

    size = 2
    while size <= P:
        up = ((base & size) == 0)[:, None]
        j = size // 2
        while j >= 64:
            buf = np.zeros((C, 2048), np.uint64)
            buf[rank[on], lbase[on]] = k[on, 0]
            buf[rank[on], lbase[on] + 1] = k[on, 1]
            if j >= 2048:  # across blocks: block rank ^ j/2048, through DSMEM
                kinds["blocks"] += 1
                src = rank ^ (j // 2048)
                k = stage(lambda: np.stack([buf[src, lbase], buf[src, lbase + 1]], axis=1), j, up)
            else:
                kinds["shared"] += 1
                src = lbase ^ j
                assert np.all(src // 2048 == 0)
                k = stage(lambda: np.stack([buf[rank, src], buf[rank, src + 1]], axis=1), j, up)
            if size == P:
                on &= base < P // 2
            j //= 2
        for jj in (32, 16, 8, 4, 2):
            if jj < size:
                kinds["shuffles"] += 1
                partner = g ^ (jj // 2)
                assert np.array_equal(partner // 32, g // 32) and np.array_equal(on[partner], on)
                k = stage(lambda: k[partner], jj, up)
        kinds["registers"] += 1
        swap = on & ((k[:, 0] > k[:, 1]) == up[:, 0])
        k = np.where(swap[:, None], k[:, ::-1], k)
        size *= 2
    assert not on[T // 2:].any() and on[:T // 2].all()
    return k[:T // 2].reshape(-1), kinds


@pytest.mark.parametrize("P", [4096, 8192, 16384])
def test_cluster_sort_is_the_stable_sort(P):
    M_values = {4096: (1025, 2048), 8192: (2049, 4096), 16384: (4097, 8192)}[P]
    rng = np.random.default_rng(P)
    ties = np.array([0.0, -0.0, 0.5, 1.0, 1.5, 3e38, np.inf], np.float32)
    T = P // 2
    for M in M_values:
        assert scl_cuda.sort_keys(M) == P
        for trial in range(2):
            if trial == 0:  # distinct metrics
                good = rng.random(M).astype(np.float32)
                bad = good + rng.random(M).astype(np.float32)
            else:  # heavy ties: dead paths at 3e38, +inf, both zeros
                good = ties[rng.integers(0, 7, M)]
                bad = ties[rng.integers(0, 7, M)]
            for layout in ("scl", "pac"):
                # thread m's two candidates: SCL 2m and 2m+1, PAC good m and bad M + m
                idx0 = np.arange(M, dtype=np.uint64) * np.uint64(2 if layout == "scl" else 1)
                idx1 = idx0 + np.uint64(1) if layout == "scl" else np.arange(M, dtype=np.uint64) + np.uint64(M)
                k0, k1 = np.full(T, ONES), np.full(T, ONES)
                k0[:M] = _key_word(good).astype(np.uint64) << np.uint64(32) | idx0
                k1[:M] = _key_word(bad).astype(np.uint64) << np.uint64(32) | idx1
                out, kinds = _cluster_sort(k0, k1)
                c = np.empty(2 * M, np.float32)
                if layout == "scl":
                    c[0::2], c[1::2] = good, bad
                else:
                    c[:M], c[M:] = good, bad
                c = np.where(c == 0, np.float32(0), c)
                want = np.argsort(c, kind="stable")[:M]
                np.testing.assert_array_equal((out[:M] & np.uint64(0xFFFFFFFF)).astype(np.int64), want)
                np.testing.assert_array_equal(_key_metric(out[:M]), c[want])
                np.testing.assert_array_equal(out, np.sort(np.concatenate([k0, k1]))[:T])
    p = P.bit_length() - 1
    assert sum(kinds.values()) == p * (p + 1) // 2
    assert kinds["blocks"] == {4096: 1, 8192: 3, 16384: 6}[P]  # the stages across blocks
    assert kinds["shared"] == 5 * (p - 11) + 15  # the in-block stages, j 1024..64


@pytest.mark.parametrize("M", [1025, 3000, 8192])
def test_cluster_final_rank_is_the_stable_rank(M):
    """The final rank by the cluster sort of (metric, m) keys, thread m's
    second key a pad: thread r takes the path of rank r, and the selected
    rank is the least r whose path passes (an atomicMin), 0 when none
    does."""

    rng = np.random.default_rng(M)
    pm = rng.random(M).astype(np.float32)
    tie = rng.random(M) < 0.5  # half the paths on a few tied metrics, dead ones at 3e38
    pm[tie] = np.array([0.0, 1.5, 2.5, 3e38], np.float32)[rng.integers(0, 4, int(tie.sum()))]
    T = scl_cuda.sort_keys(M) // 2
    k0 = np.full(T, ONES)
    k0[:M] = _key_word(pm).astype(np.uint64) << np.uint64(32) | np.arange(M, dtype=np.uint64)
    out, _ = _cluster_sort(k0, np.full(T, ONES))
    path_r = (out[:M] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    np.testing.assert_array_equal(path_r, np.argsort(pm, kind="stable"))
    for share in (0.0, 0.1):
        ok = rng.random(M) < share
        ranks = np.flatnonzero(ok[path_r])
        least = ranks.min() if ranks.size else M
        first = next((r for r, m in enumerate(np.argsort(pm, kind="stable")) if ok[m]), None)
        assert (least if least < M else None) == first


# ---- on the card (marker `gpu`; skipped without a CUDA device) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_k1_cluster_matches_plain_on_card(cuda_device):
    N, K, M = 128, 64, 2048
    info = construct_info_set(N, K)
    llr, msgs = noisy_llrs(N, K, 5, snr_db=2.0, seed=M)
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
def test_k3_cluster_matches_plain_on_card(cuda_device):
    L = 2048
    mask = _pac_mask(32, 12 + PAC_CRC[0])
    x = torch.from_numpy(np.random.default_rng(L).normal(1.0, 2.0, (5, 32)).astype(np.float32))
    x = x.to(cuda_device)
    out = pac_cuda.pac_list_decode_cuda(x, mask, PAC_GEN, L, *PAC_CRC, full=True)
    torch.cuda.synchronize()
    ref = pac_list_decode_batch(x, mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
    for f in ("extracted", "crc_pass", "v_full", "candidates", "metrics", "valid", "best_index"):
        assert torch.equal(out[f], ref[f]), f
