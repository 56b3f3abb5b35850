"""The list decoders past one block: list sizes 1025..8192, held against JAX.

On the card K1 (`csrc/scl_decode.cu`) and K3 (`csrc/pac_decode.cu`) take
list sizes 1025..8192 through their cluster instantiations (a frame spread
over a thread-block cluster of 2, 4 or 8 blocks of 1024 threads, one thread
a path, levels G+1..n of a block's paths in its shared memory and read
across the cluster through distributed shared memory, levels 1..G in
global scratch), and K3's one-path-a-lane instantiation keeps its trace in
global scratch, so it takes PAC(8192, Kp) at every Kp.  On the CPU:

* the plain `decode_scl_batch` in float64 against JAX's at P(32,28), M 1536
  and 2048, where the list fills, CRC-24A on and off, a forced plan on one
  case: every field of the list;
* the plain `pac_list_decode_batch` list fields against JAX's at
  PAC(32,12)+CRC-16 L=2048;
* the planning: `cluster_blocks`, the bytes a block of a cluster takes at
  every G, the plan's G at N 16..8192 (a stand-in occupancy calculator),
  `scratch_bytes`, `split_batch`, `check_shape` over M and L 1025..8192
  at N 128..65536 and raising at 65537 and at N=131072, and K3's one-lane
  frame without the trace;
* a model of the cluster sort (`cluster_sort_keys` in
  `csrc/list_decode.cuh`: the stages across blocks through two exchange
  buffers in turns, one cluster barrier each, then those within the block
  through a third buffer and the free exchange one, one block barrier
  each) against the stable sort at P = 4096, 8192, 16384 and 32768 keys
  (clusters of 2 to 16 blocks), at 65536 (16 blocks of 4096 keys, four
  a thread) and at 131072 (16 blocks of 8192 keys, eight a thread:
  `cluster_sort_keysn`), with its stage and barrier counts, the
  buffers' races tracked across three sorts in a row, and the final rank
  by the same sort;
* a model of the phase barriers over the schedule words at N 16..65536:
  every row read through σ is written behind a barrier, and no block
  rewrites one before the split barrier of the phase that read it.  The
  replay takes every read through σ as a read of another block's row, so
  it holds at any number of blocks, 16 among them.

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
        for g in range(n):
            ss = (N >> g) - 1  # a path's shared row: levels g+1..n
            # two σ tables of 1024 paths, three buffers of 2048 sort keys, two
            # sets of 2 (PAC 3) words a path, the LLR and bit rows, the selected rank
            want = 2 * r16(1024 * sig_row) + 3 * 8 * 2048 + 2 * 2 * 4 * 1024 + r16(4096 * ss) + r16(1024 * ss) + 16
            assert scl_cuda.cluster_block_bytes(N, g) == want
            assert pac_cuda.frame_bytes(N, N // 2, 2048, g) == want + 2 * 4 * 1024
            for M in (1025, 4096, 8192):
                assert scl_cuda.frame_bytes(N, N // 2, M, g) == want
    # P(128,64) at G = n − 4: 49,152 of σ, 49,152 of keys, 16,384 of words,
    # 76,800 of rows (15 entries of 5 bytes a path); PAC 8,192 more words
    assert scl_cuda.cluster_block_bytes(128, 3) == 49152 + 49152 + 16384 + 76800 + 16 == 191504
    assert pac_cuda.frame_bytes(128, 80, 2048, 3) == 191504 + 8192
    # the least a block takes, every level but the leaf in global scratch:
    # under a block's 227 KB at every N, so check_shape takes N=8192 M=8192
    assert scl_cuda.cluster_block_bytes(8192, 12) == 98304 + 49152 + 16384 + 4096 + 1024 + 16 == 168976
    assert pac_cuda.frame_bytes(8192, 4112, 8192, 12) == 168976 + 8192 <= scl_cuda.MAX_BLOCK_SMEM
    # a frame of M=8192 over its cluster of 8 blocks at P(128,64)
    assert scl_cuda.cluster_blocks(8192) * scl_cuda.cluster_block_bytes(128, 3) == 8 * 191504


# (N, G, a block's bytes) of K1 (SCL, two words a path) and K3 (PAC, three)
# on a cluster: the smallest G whose block fits 232,448 B
CLUSTER_G = {
    "scl": [(16, 0, 166928), (32, 1, 175120), (64, 2, 183312), (128, 3, 191504), (256, 4, 199696),
            (512, 5, 207888), (1024, 6, 216080), (2048, 7, 224272), (4096, 9, 191504), (8192, 10, 199696)],
    "pac": [(16, 0, 175120), (32, 1, 183312), (64, 2, 191504), (128, 3, 199696), (256, 4, 207888),
            (512, 5, 216080), (1024, 6, 224272), (2048, 8, 191504), (4096, 9, 199696), (8192, 10, 207888)],
}


@pytest.mark.parametrize("N", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192])
def test_cluster_plan_pins_g(N, monkeypatch):
    # a stand-in occupancy calculator: the card holds 66 clusters where a
    # block's shared memory fits, none where it does not
    def occupancy(frame_bytes):
        return lambda N, K, M, G: (1, 66 if frame_bytes(N, K, M, G) <= scl_cuda.MAX_BLOCK_SMEM else 0)

    monkeypatch.setattr(scl_cuda, "_occupancy", occupancy(scl_cuda.frame_bytes))
    monkeypatch.setattr(pac_cuda, "_occupancy", occupancy(pac_cuda.frame_bytes))
    scl_cuda._plan.cache_clear()
    pac_cuda.launch_plan.cache_clear()
    try:
        plans = {"scl": [scl_cuda.launch_plan(N, N // 2, M, 1024) for M in (1025, 2048, 8192)],
                 "pac": [pac_cuda.launch_plan(N, N // 2, L) for L in (1025, 2048, 8192)]}
    finally:
        scl_cuda._plan.cache_clear()
        pac_cuda.launch_plan.cache_clear()
    for kind, words in (("scl", 2), ("pac", 3)):
        _, G, want = next(c for c in CLUSTER_G[kind] if c[0] == N)
        assert plans[kind] == [(G, 1, 66)] * 3
        assert scl_cuda.cluster_block_bytes(N, G, words) == want <= scl_cuda.MAX_BLOCK_SMEM == 232448
        assert scl_cuda.cluster_block_bytes(N, G - 1, words) > scl_cuda.MAX_BLOCK_SMEM if G else True
    # levels n−3.. (rows of 7 or more entries) stay in shared memory at every N
    assert N >> G >= 8


def test_cluster_scratch_bytes():
    # levels 1..G in global scratch (rows of N − (N >> G) entries), the trace
    # LLRs and 16-bit trace indices: at P(128,64) G = 3, levels 4..7 (15
    # entries of 5 bytes a path) left global scratch
    for M in (1025, 2048, 8192):
        assert scl_cuda.scratch_bytes(4096, 128, 64, M, 3) == 4096 * M * (112 * 5 + 64 * 6)
        assert (scl_cuda.scratch_bytes(4096, 128, 64, M, 7) - scl_cuda.scratch_bytes(4096, 128, 64, M, 3)
                == 4096 * M * 15 * 5)
    # about 31.7 GB at B=4096 P(128,64) M=8192 (34.2 GB with every level global)
    assert scl_cuda.scratch_bytes(4096, 128, 64, 8192, 3) == 31_675_383_808
    assert scl_cuda.scratch_bytes(1, 8192, 1024, 2048, 10) == 2048 * (8184 * 5 + 1024 * 6)
    assert pac_cuda.scratch_bytes(1, 128, 80, 2048, 3) == 2048 * (112 * 5 + 80 * 2)
    # one path a lane: rows of round16(L) bytes of trace, levels 1..G
    assert pac_cuda.scratch_bytes(8, 8192, 7400, 32, 12) == 8 * (32 * 8190 * 5 + 7400 * 32)
    assert pac_cuda.scratch_bytes(8, 128, 80, 5, 0) == 8 * 80 * 16
    assert pac_cuda.scratch_bytes(8, 128, 80, 1, 0) == 0  # one path: no trace
    # a launch takes all B, or the most frames whose scratch fits 0.9 of the free bytes
    one = scl_cuda.scratch_bytes(1, 8192, 1024, 8192, 10)
    assert scl_cuda.split_batch(1000, one, 80 * 10 ** 9) == 72 * 10 ** 9 // one == 186
    assert scl_cuda.split_batch(16, one, 80 * 10 ** 9) == 16
    with pytest.raises(ValueError, match=f"{one} bytes"):
        scl_cuda.split_batch(4, one, one)
    # the split is exact: launches of `step` frames cover B, the last ragged
    step = scl_cuda.split_batch(1000, one, 80 * 10 ** 9)
    assert [min(step, 1000 - b0) for b0 in range(0, 1000, step)] == [186] * 5 + [70]


def test_check_shape_takes_lists_up_to_8192():
    for N in (128, 1024, 8192):
        for M in (1025, 1536, 2048, 3000, 4096, 5000, 8192):
            scl_cuda.check_shape(N, N // 2, M, CRC, torch.float32)
            pac_cuda.check_shape(N, N // 2 + 16, M, GEN, 16, torch.float32)
    for M in range(1025, 8193, 127):
        scl_cuda.check_shape(128, 64, M, None, torch.float32)
        pac_cuda.check_shape(128, 80, M, GEN, 16, torch.float32)
    # 8193..65536 go to a cluster of 16 blocks (`tests/test_torch_list_16k.py`,
    # `tests/test_torch_list_32k.py`, `tests/test_torch_list_64k.py`); the
    # first size refused is 65537
    with pytest.raises(ValueError, match="1..65536 .*cluster"):
        scl_cuda.check_shape(128, 64, 65537, CRC, torch.float32)
    with pytest.raises(ValueError, match="1..65536 .*cluster"):
        pac_cuda.check_shape(128, 80, 65537, GEN, 16, torch.float32)
    for N in (16384, 32768, 65536):  # past the TPU kernel's N=8192
        scl_cuda.check_shape(N, N // 2, 2048, CRC, torch.float32)
        pac_cuda.check_shape(N, N // 2 + 16, 2048, GEN, 16, torch.float32)
    with pytest.raises(ValueError, match="65536"):
        scl_cuda.check_shape(131072, 65536, 2048, CRC, torch.float32)
    with pytest.raises(ValueError, match="65536"):
        pac_cuda.check_shape(131072, 65552, 2048, GEN, 16, torch.float32)
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


class _Buffers:
    """The three key buffers of each block of a cluster (X0, X1, Y) of
    `entries` keys each (2048 at one path a thread, 4096 at two, 8192 at
    four), kept
    across sorts as the kernel keeps them, with the hazards tracked at a
    buffer's grain: every entry is tagged with the stage that stored it (a
    read of another stage's entry reads a wrong key), and a buffer read by
    its own block is busy until that block's next barrier, one read by
    another block until the next cluster barrier.  Storing to a busy buffer
    is a race."""

    def __init__(self, C, entries=2048):
        self.val = np.zeros((C, 3, entries), np.uint64)
        self.tag = np.full((C, 3, entries), -1)
        self.own = np.zeros((C, 3), bool)
        self.other = np.zeros((C, 3), bool)
        self.stage = 0
        self.barriers = {"cluster": 0, "block": 0}

    def store(self, blocks, b, at, k):
        """Each thread's keys k[:, i] at its entries at[:, i] of buffer b."""

        assert not self.own[blocks, b].any() and not self.other[blocks, b].any(), "a store races a read"
        self.val[blocks[:, None], b, at] = k
        self.tag[blocks[:, None], b, at] = self.stage

    def read(self, reader, blocks, b, at):
        assert np.all(self.tag[blocks, b, at] == self.stage), "a read of a key no thread stored this stage"
        self.other[np.unique(blocks[blocks != reader]), b] = True
        self.own[reader, b] |= bool((blocks == reader).any())
        return self.val[blocks, b, at]

    def barrier(self, cluster):
        self.barriers["cluster" if cluster else "block"] += 1
        self.own[:] = False
        if cluster:
            self.other[:] = False


def _cluster_sort(keys, bufs=None, xc=0):
    """`cluster_sort_keys` (q = 2 keys a thread, one path) and
    `cluster_sort_keysn<q>` (q = 4 and 8, two and four paths) on a cluster
    of C = P/(1024·q) blocks of 1024 threads: global thread g = 1024·r + t
    holds the keys of positions q·g + i in keys[g, i].  A block's buffers
    hold 1024·q keys, thread t's keys 2h, 2h + 1 at entries 2048·h + 2t,
    2048·h + 2t + 1.  A
    stage of distance j >= 1024·q stores each running thread's keys in its
    block's exchange buffer X[xc & 1], one cluster barrier, and reads the
    partner's from block r ^ j/(1024·q) at the same entries; xc then counts
    it.  A stage of distance 32·q..512·q stores to the block's Y and
    X[xc & 1] in turns (Y first after each cross-block stage), one block
    barrier, and reads thread t ^ j/q's entries; below, shuffles with lane
    t ^ j/q and, for the distances within a thread (below q), registers.
    The upper half stops after the last merge's first stage, and the lower
    half stores its keys in rank order to X[xc & 1] (xc
    counted) behind a cluster barrier.  `bufs` (a `_Buffers`, fresh when
    None) persists across calls as in the kernel.  Returns the keys of
    ranks 0..P/2−1 as the blocks store them (rank u in block u // (1024·q)
    at u % (1024·q)), the stages of each kind, the buffer of the sorted keys
    and xc."""

    T, q = keys.shape
    P, bk = q * T, 1024 * q
    C = T // 1024
    assert q in (2, 4, 8) and C in (2, 4, 8, 16) and P == bk * C
    bufs = bufs or _Buffers(C, bk)
    g = np.arange(T)
    base, rank, t = q * g, g // 1024, g % 1024
    entries = np.stack([2048 * (i // 2) + 2 * t + i % 2 for i in range(q)], axis=1)
    k = keys.copy()
    on = np.ones(T, bool)
    kinds = {"blocks": 0, "shared": 0, "shuffles": 0, "registers": 0}

    def stage(o, j, up):
        keep_min = ((base & j) == 0)[:, None] == up
        return np.where(on[:, None] & ((o < k) == keep_min), o, k)

    def read_keys(b, src_rank, src_t):
        o = np.empty_like(k)
        for r in range(C):  # each block reads as a reader of its own
            mine = on & (rank == r)
            if mine.any():
                for i in range(q):
                    o[mine, i] = bufs.read(r, src_rank[mine], b, entries[src_t[mine], i])
        return np.where(on[:, None], o, k)

    def order(a, b, up):  # keys a < b of each thread: the smaller to a when ascending
        lo, hi = np.minimum(k[:, a], k[:, b]), np.maximum(k[:, a], k[:, b])
        k[:, a], k[:, b] = np.where(on, np.where(up, lo, hi), k[:, a]), np.where(on, np.where(up, hi, lo), k[:, b])

    size, ib = 2, 0  # ib: in-block stages since the last cross-block one
    while size <= P:
        up = ((base & size) == 0)[:, None]
        j = size // 2
        while j >= 32 * q:
            bufs.stage += 1
            if j >= bk:  # across blocks: block rank ^ j/bk, through DSMEM
                kinds["blocks"] += 1
                b = xc & 1
                bufs.store(rank[on], b, entries[on], k[on])
                bufs.barrier(cluster=True)
                k = stage(read_keys(b, rank ^ (j // bk), t), j, up)
                xc += 1
                ib = 0
            else:
                kinds["shared"] += 1
                b = (xc & 1) if ib & 1 else 2
                ib += 1
                bufs.store(rank[on], b, entries[on], k[on])
                bufs.barrier(cluster=False)
                assert np.all((t ^ (j // q)) < 1024)
                k = stage(read_keys(b, rank, t ^ (j // q)), j, up)
            if size == P:
                on &= base < P // 2
            j //= 2
        for jj in (16 * q, 8 * q, 4 * q, 2 * q, q):
            if jj < size:
                kinds["shuffles"] += 1
                partner = g ^ (jj // q)
                assert np.array_equal(partner // 32, g // 32) and np.array_equal(on[partner], on)
                k = stage(k[partner], jj, up)
        jj = q // 2
        while jj >= 1:  # within the thread, in registers
            if jj < size:
                kinds["registers"] += 1
                for i in range(q):
                    if not i & jj:  # position q·g + i ascends where its bit of size is clear
                        order(i, i | jj, ((base | i) & size) == 0)
            jj //= 2
        size *= 2
    assert not on[T // 2:].any() and on[:T // 2].all()
    bufs.stage += 1
    sorted_b = xc & 1
    rank_order = (q * t)[:, None] + np.arange(q)[None, :]  # the sorted keys' store: in rank order
    bufs.store(rank[on], sorted_b, rank_order[on], k[on])
    bufs.barrier(cluster=True)
    return k[:T // 2].reshape(-1), kinds, sorted_b, xc + 1


def _take_ranks(bufs, sorted_b, M, q=2):
    """The read by the thread of path m of the key of rank m (`cluster_key`):
    block m // (1024·q)'s entry m % (1024·q) of the sorted buffer, through
    DSMEM; the reader is the block of path m, m // (512·q)."""

    u = np.arange(M)
    owner, reader = u // (1024 * q), u // (512 * q)
    out = np.empty(M, np.uint64)
    for r in np.unique(reader):
        mine = reader == r
        out[mine] = bufs.read(r, owner[mine], sorted_b, u[mine] % (1024 * q))
    return out


def _path_threads(M):
    """(the global thread, the key column) of each path m < M: one path a
    thread, m itself; at ppt = 2 or 4 (M > 16384, 32768) path
    r·1024·ppt + k·1024 + t on thread r·1024 + t, its candidates in
    columns 2k and 2k + 1."""

    m = np.arange(M)
    ppt = scl_cuda.cluster_ppt(M)
    return (m // (1024 * ppt)) * 1024 + m % 1024, 2 * ((m // 1024) % ppt)


def _fork_keys(M, good, bad, layout):
    """The [T, q] keys of a fork's candidates as the threads hold them:
    path m's two candidates (SCL 2m and 2m + 1, PAC good m and bad M + m)
    in its thread's columns (`_path_threads`), pads elsewhere."""

    P = scl_cuda.sort_keys(M)
    q = 2 * scl_cuda.cluster_ppt(M)
    keys = np.full((P // q, q), ONES)
    m = np.arange(M, dtype=np.uint64)
    idx0 = m * np.uint64(2) if layout == "scl" else m
    idx1 = idx0 + np.uint64(1) if layout == "scl" else m + np.uint64(M)
    thread, col = _path_threads(M)
    keys[thread, col] = _key_word(good).astype(np.uint64) << np.uint64(32) | idx0
    keys[thread, col + 1] = _key_word(bad).astype(np.uint64) << np.uint64(32) | idx1
    return keys


# one path a thread up to P = 32768 keys (2048 a block), two at 65536
# (4096), four at 131072 (8192)
@pytest.mark.parametrize("P", [4096, 8192, 16384, 32768, 65536, 131072])
def test_cluster_sort_is_the_stable_sort(P):
    M_values = {4096: (1025, 2048), 8192: (2049, 4096), 16384: (4097, 8192), 32768: (8193, 16384),
                65536: (16385, 32768), 131072: (32769, 65536)}[P]
    rng = np.random.default_rng(P)
    ties = np.array([0.0, -0.0, 0.5, 1.0, 1.5, 3e38, np.inf], np.float32)
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
                keys = _fork_keys(M, good, bad, layout)
                out, kinds, _, _ = _cluster_sort(keys)
                c = np.empty(2 * M, np.float32)
                if layout == "scl":
                    c[0::2], c[1::2] = good, bad
                else:
                    c[:M], c[M:] = good, bad
                c = np.where(c == 0, np.float32(0), c)
                want = np.argsort(c, kind="stable")[:M]
                np.testing.assert_array_equal((out[:M] & np.uint64(0xFFFFFFFF)).astype(np.int64), want)
                np.testing.assert_array_equal(_key_metric(out[:M]), c[want])
                np.testing.assert_array_equal(out, np.sort(keys.reshape(-1))[:P // 2])
    p = P.bit_length() - 1
    block = 11 + {65536: 1, 131072: 2}.get(P, 0)  # log2 of a block's keys
    assert sum(kinds.values()) == p * (p + 1) // 2
    # the stages across blocks
    assert kinds["blocks"] == {4096: 1, 8192: 3, 16384: 6, 32768: 10, 65536: 10, 131072: 10}[P]
    assert scl_cuda.cluster_exchanges(P) == kinds["blocks"] + 1  # and the sorted keys' store
    # the in-block stages, j 1024..64 (2048..128 at two paths a thread, 4096..256 at four)
    assert kinds["shared"] == 5 * (p - block) + 15


@pytest.mark.parametrize("M", [1025, 2048, 3000, 4096, 8192, 8193, 16384, 16385, 32768, 32769, 65536])
def test_cluster_sort_buffers_across_forks(M):
    """Three sorts in a row over one set of key buffers, as a decode runs
    them (two forks, each read by every thread for the key of its rank, and
    the final rank): each is the stable sort, no store races a read of the
    same buffer (its own block's before a barrier, another block's before a
    cluster barrier), and a fork takes one cluster barrier a cross-block
    stage and one for the sorted keys, and one block barrier a stage within
    the block.  Past M = 16384 each thread holds two paths' keys, past
    32768 four."""

    P = scl_cuda.sort_keys(M)
    q = 2 * scl_cuda.cluster_ppt(M)
    C = P // (1024 * q)
    rng = np.random.default_rng(M)
    bufs, xc = _Buffers(C, 1024 * q), 0
    p = P.bit_length() - 1
    thread, col = _path_threads(M)
    for fork in range(3):
        metric = rng.random(2 * M).astype(np.float32)
        metric[rng.random(2 * M) < 0.3] = np.float32(3e38)  # dead candidates tie
        cand = _key_word(metric).astype(np.uint64) << np.uint64(32) | np.arange(2 * M, dtype=np.uint64)
        keys = np.full((P // q, q), ONES)
        if fork < 2:  # path m's candidates 2m and 2m + 1
            keys[thread, col], keys[thread, col + 1] = cand[0::2], cand[1::2]
        else:  # the final rank: one key a path, the other a pad
            keys[thread, col] = cand[:M]
        before = dict(bufs.barriers)
        out, kinds, sorted_b, xc = _cluster_sort(keys, bufs, xc)
        np.testing.assert_array_equal(out, np.sort(keys.reshape(-1))[:P // 2])
        np.testing.assert_array_equal(_take_ranks(bufs, sorted_b, M, q), out[:M])
        cross = {4096: 1, 8192: 3, 16384: 6, 32768: 10, 65536: 10, 131072: 10}[P]
        block = (1024 * q).bit_length() - 1  # log2 of a block's keys
        assert kinds["blocks"] == cross and kinds["shared"] == 5 * (p - block) + 15
        assert bufs.barriers["cluster"] - before["cluster"] == scl_cuda.cluster_exchanges(P) == cross + 1
        assert bufs.barriers["block"] - before["block"] == kinds["shared"]
    assert xc == 3 * scl_cuda.cluster_exchanges(P)


@pytest.mark.parametrize("M", [1025, 3000, 8192, 16384, 16385, 32768, 32769, 65536])
def test_cluster_final_rank_is_the_stable_rank(M):
    """The final rank by the cluster sort of (metric, m) keys, each path's
    second key a pad: the thread of path r takes the path of rank r, and
    the selected rank is the least r whose path passes (an atomicMin), 0
    when none does."""

    rng = np.random.default_rng(M)
    pm = rng.random(M).astype(np.float32)
    tie = rng.random(M) < 0.5  # half the paths on a few tied metrics, dead ones at 3e38
    pm[tie] = np.array([0.0, 1.5, 2.5, 3e38], np.float32)[rng.integers(0, 4, int(tie.sum()))]
    P = scl_cuda.sort_keys(M)
    q = 2 * scl_cuda.cluster_ppt(M)
    keys = np.full((P // q, q), ONES)
    thread, col = _path_threads(M)
    keys[thread, col] = _key_word(pm).astype(np.uint64) << np.uint64(32) | np.arange(M, dtype=np.uint64)
    out, _, _, _ = _cluster_sort(keys)
    path_r = (out[:M] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    np.testing.assert_array_equal(path_r, np.argsort(pm, kind="stable"))
    for share in (0.0, 0.1):
        ok = rng.random(M) < share
        ranks = np.flatnonzero(ok[path_r])
        least = ranks.min() if ranks.size else M
        first = next((r for r, m in enumerate(np.argsort(pm, kind="stable")) if ok[m]), None)
        assert (least if least < M else None) == first


# ---- a model of the phase barriers over the schedule words ----

def _phase_barrier_races(words, n, split=True):
    """Replay the cluster kernels' phases over their schedule words
    (`ops/scl_schedule.py::phase_words`) and list the cross-block races.
    Positions in phase p: 4p the wait for the previous phase's split
    barrier (when its word flagged a read through σ), 4p + 1 the descent
    (the g's read of LLR level gl−1 through σ, the writes of LLR levels
    l0..n−1), 4p + 2 an info phase's sort barriers, 4p + 3 the chain (the
    reads of bit levels above s through σ, the write of level s), and 4p +
    3.5 the split barrier's arrive.  A barrier orders what came before its
    arrive in every block before what comes after its wait: `cover` is the
    arrive of the last barrier waited for.  A write of a level another
    block read through σ races unless that read is before `cover` (no block
    rewrites a row another may still read), and a read through σ races
    unless the level's last write is before `cover` (the row is there).
    With `split=False` the phase-end barriers are left out."""

    cover, races = -1.0, []
    last_read, last_write = {}, {}

    def read(level, at):
        if last_write.get(level, np.inf) >= cover:
            races.append(("read before the write is ordered", level, at))
        last_read[level] = at

    def write(level, at):
        if last_read.get(level, -np.inf) >= cover:
            races.append(("write while a read may run", level, at))
        last_write[level] = at

    flagged = False
    for p, w in enumerate(int(x) for x in words):
        gl, s, frozen, cmask = w & 31, w >> 5 & 31, w >> 10 & 1, w >> 11
        if split and flagged:
            cover = max(cover, 4 * p - 0.5)  # the wait for the arrive at the end of phase p − 1
        if p > 0 and cmask & 1:
            read(("llr", gl - 1), 4 * p + 1)
        for lv in range(1 if p == 0 else gl, n):
            write(("llr", lv), 4 * p + 1)
        if not frozen:
            cover = 4 * p + 2
        if s > 0:
            for lv in range(s + 1, n + 1):
                if cmask >> lv & 1:
                    read(("bit", lv), 4 * p + 3)
            write(("bit", s), 4 * p + 3)
        flagged = cmask != 0
    return races


@pytest.mark.parametrize("N", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 65536])
def test_cluster_phase_barriers_cover_sigma_reads(N):
    """Every row a phase writes that another block may have read through σ
    is written after the wait of the split barrier the reading phase
    arrived at, or behind a sort's barriers, and every row read through σ
    was written before a barrier: K1's info sets (rate 1/2 and 1/4, and a
    random one) and K3's (a rate profile's mask in bit-reversed order).
    Without the phase-end barriers the same replay finds races."""

    from polar_code_tpu_torch.ops.scl_schedule import phase_words

    n = int(np.log2(N))
    rng = np.random.default_rng(N)
    sets = [construct_info_set(N, N // 2), construct_info_set(N, N // 4),
            np.sort(rng.choice(N, N // 3, replace=False))]
    if N <= 1024:
        mask = _pac_mask(N, N // 2)
        perm = np.array([int(format(i, f"0{n}b")[::-1], 2) for i in range(N)])
        sets.append(np.flatnonzero(mask[perm] == 1))
    for info in sets:
        words = phase_words(N, np.asarray(info, np.int64))
        assert _phase_barrier_races(words, n) == []
        assert _phase_barrier_races(words, n, split=False) != []


def test_cluster_barrier_counts():
    """Cluster barriers a phase at P(128,64), K1's info set: an info phase
    takes one a cross-block sort stage, one for the sorted keys and, where
    its word flags a read through σ, the split phase-end one; a frozen
    phase the last alone.  The kernels with every tree level in global
    scratch took two a cross-block stage, one more for the first in-block
    stage of each merge after them, one to close the sort, one to close the
    σ fork and the phase-end one."""

    from polar_code_tpu_torch.ops.scl_schedule import phase_words

    words = phase_words(128, np.asarray(construct_info_set(128, 64), np.int64)).astype(np.int64)
    info, flagged = (words >> 10 & 1) == 0, (words >> 11) != 0
    # P = 65536: M 16385..32768, two paths a thread, 4096 keys a block;
    # P = 131072: M 32769..65536, four paths a thread, 8192 keys a block
    for P, cross in ((4096, 1), (8192, 3), (16384, 6), (32768, 10), (65536, 10), (131072, 10)):
        block = 11 + {65536: 1, 131072: 2}.get(P, 0)  # log2 of a block's keys
        merges = P.bit_length() - 1 - block  # merges with a cross-block stage
        new = np.where(info, scl_cuda.cluster_exchanges(P), 0) + flagged
        old = np.where(info, 2 * cross + merges + 1 + 1, 0) + flagged
        assert set(new[info]) <= {cross + 1, cross + 2} and set(new[~info]) <= {0, 1}
        assert set(old[info]) <= {2 * cross + merges + 2, 2 * cross + merges + 3}
        assert (2 * cross + merges + 3, cross + 2) == {4096: (6, 3), 8192: (11, 5), 16384: (18, 8),
                                                       32768: (27, 12), 65536: (27, 12), 131072: (27, 12)}[P]
        assert new.sum() < old.sum() / 2 + flagged.sum()
    # every info phase reads through σ here (so 3 / 5 / 8 / 12 against 6 / 11 / 18 / 27),
    # and about half the frozen phases
    assert flagged[info].all() and 0 < flagged[~info].sum() < (~info).sum()


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
