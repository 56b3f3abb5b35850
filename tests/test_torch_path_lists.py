"""K1 by path (list sizes 3–32 outside {1, 2, 4, 8}): the fork's in-warp sort,
the trace in global scratch and the launch plan, on the CPU.

On the card the by-path instantiation `scl_path_kernel<LM, LIST>`
(`csrc/scl_decode.cu`) picks a fork's M survivors by sorting the 2M
candidates as unique 64-bit keys (`cand_key`) with a bitonic network inside
one warp (`path_select`, `warp_sort_keys`, `warp_sort_keys64` in
`csrc/list_decode.cuh`), keeps its trace indices in global scratch (rows of
`path_trace_row(M)` bytes) and walks them back a chunk of rows at a time
through the frame's shared memory; its wrapper plans a launch for one wave
(`path_target`).  Here, with numpy and no card:

* a model of the network stage by stage, in the kernel's layout (one key a
  lane up to LM=16, two a lane at LM=32), against numpy's stable sort at
  M ∈ {3, 5, 16, 17, 31, 32}, with ties, −0.0, 3e38 (a forced-off
  candidate), +inf and both candidates of a path forced off; and the final
  sort of the M metrics and the CRC selection;
* a model of the chunked walks back against one walk over the whole trace;
* `frame_bytes`, `scratch_bytes` and `check_shape` by path (N=8192 at K up
  to 8192 and M up to 32);
* the plan rule as a pure function on a fake occupancy calculator, and K1's
  and K3's wrappers on one;
* the plain decoder against JAX's in float64 at a by-path list size where
  every bit is an info bit.  The shapes the old trace rule refused are all
  at N=8192 (K > 7259 at M=32, K=8192 at M=29), where a float64 decode of
  either package on the CPU takes minutes; K=N at N=32 runs the same
  schedule, an info phase at every leaf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.ops.crc import attach_crc as jax_attach_crc
from polar_code_tpu.ops.polar_transform import encode_batch as jax_encode
from polar_code_tpu.ops.scl import decode_scl_batch as jax_decode
from polar_code_tpu_torch.legacy import pac_cuda
from polar_code_tpu_torch.ops import scl_cuda
from polar_code_tpu_torch.ops.scl import decode_scl_batch

CRC = "0x1864CFB"  # CRC-24A
ONES = np.uint64(0xFFFFFFFFFFFFFFFF)
BIG = np.float32(3e38)  # a candidate a forced plan turns off
LANES = np.arange(32)


def _key(c, index):
    """`cand_key`: the metric's order-preserving word above the index."""

    u = np.where(c == 0, np.float32(0), c).astype(np.float32).view(np.uint32)
    w = u ^ np.where(u >> np.uint32(31) == 1, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))
    return w.astype(np.uint64) << np.uint64(32) | np.asarray(index, np.uint64)


def _metric(keys):
    """`key_metric`."""

    w = (keys >> np.uint64(32)).astype(np.uint32)
    return np.where(w >> np.uint32(31) == 1, w ^ np.uint32(0x80000000), ~w).view(np.float32)


def _keep(k, o, keep_min):
    """`keep_key` in every lane."""

    return np.where((o < k) == keep_min, o, k)


def _sort_one_a_lane(k, pmax, P, stages):
    """`warp_sort_keys<pmax>(k, lane, P)`: one key a lane of the warp, a
    shuffle of lane ^ j a stage."""

    size = 2
    while size <= pmax and size <= P:
        j = size // 2
        while j >= 1:
            stages.append("shuffle")
            k = _keep(k, k[LANES ^ j], ((LANES & j) == 0) == ((LANES & size) == 0))
            j //= 2
        size *= 2
    return k


def _sort_two_a_lane(k0, k1, stages):
    """`warp_sort_keys64`: k0 at position lane, k1 at lane + 32."""

    size = 2
    while size <= 32:
        j = size // 2
        while j >= 1:
            stages.append("shuffle")
            lower = (LANES & j) == 0
            up = np.full(32, True) if size == 32 else (LANES & size) == 0
            k0, k1 = (_keep(k0, k0[LANES ^ j], lower == up),
                      _keep(k1, k1[LANES ^ j], lower == (np.zeros(32, bool) if size == 32 else up)))
            j //= 2
        size *= 2
    stages.append("registers")
    k0 = np.minimum(k0, k1)
    j = 16
    while j >= 1:
        stages.append("shuffle")
        k0 = _keep(k0, k0[LANES ^ j], (LANES & j) == 0)
        j //= 2
    return k0


def _path_select(c0, c1, M):
    """`path_select<LM>`: lane p < M holds candidates 2p (metric c0[p]) and
    2p + 1 (c1[p]); returns every lane's key (lane m < M: the key of rank m)
    and the stages run."""

    LM = scl_cuda.path_width(M)
    a0 = np.full(32, BIG, np.float32)
    a1 = np.full(32, BIG, np.float32)
    a0[:M], a1[:M] = c0, c1
    stages = []
    if LM <= 16:
        odd = LANES >= M
        p = np.where(odd, LANES - M, LANES)
        c = np.where(odd, a1[p % 32], a0)  # lane M + p: shuffled from lane p
        k = np.where(LANES < 2 * M, _key(c, 2 * p + odd), ONES)
        return _sort_one_a_lane(k, 2 * LM, scl_cuda.sort_keys(M), stages), stages
    on = LANES < M
    k0 = np.where(on, _key(a0, 2 * LANES), ONES)
    k1 = np.where(on, _key(a1, 2 * LANES + 1), ONES)
    return _sort_two_a_lane(k0, k1, stages), stages


def _fork_metrics(rng, M, trial):
    """Candidate metrics of one fork: distinct, or heavy ties with −0.0,
    forced-off (3e38) and +inf candidates and paths forced off on both
    sides."""

    if trial == 0:
        c0 = rng.random(M).astype(np.float32)
        return c0, c0 + rng.random(M).astype(np.float32)
    vals = np.array([0.0, -0.0, 0.5, 1.0, 1.5, BIG, np.inf], np.float32)
    c0, c1 = vals[rng.integers(0, 7, M)], vals[rng.integers(0, 7, M)]
    if trial >= 2:  # a forced plan: one side of every path at 3e38
        off = rng.random(M) < 0.5
        c0, c1 = np.where(off, BIG, c0), np.where(off, c1, BIG)
    if trial == 3:  # and some paths dead on both sides
        dead = rng.random(M) < 0.3
        c0, c1 = np.where(dead, BIG, c0), np.where(dead, BIG, c1)
    return c0, c1


@pytest.mark.parametrize("M", [3, 5, 16, 17, 31, 32])
def test_in_warp_sort_is_the_stable_sort(M):
    rng = np.random.default_rng(M)
    for trial in range(4):
        for _ in range(5):
            c0, c1 = _fork_metrics(rng, M, trial)
            out, stages = _path_select(c0, c1, M)
            c = np.empty(2 * M, np.float32)
            c[0::2], c[1::2] = c0, c1  # candidate 2p + b
            plain = np.where(c == 0, np.float32(0), c)
            want = np.argsort(plain, kind="stable")[:M]
            # survivor m: trace index 2p + b of the key of rank m, and its
            # metric back from the key
            np.testing.assert_array_equal((out[:M] & np.uint64(0xFFFFFFFF)).astype(np.int64), want)
            np.testing.assert_array_equal(_metric(out[:M]).view(np.uint32), plain[want].view(np.uint32))
    P = scl_cuda.sort_keys(M)
    p = P.bit_length() - 1
    if scl_cuda.path_width(M) <= 16:  # one key a lane: only sort_keys(M)'s stages run
        assert stages == ["shuffle"] * (p * (p + 1) // 2)
    else:  # 15 stages on two keys, one in registers, 5 on one key
        assert stages == ["shuffle"] * 15 + ["registers"] + ["shuffle"] * 5


@pytest.mark.parametrize("M", [3, 5, 16, 17, 31, 32])
def test_final_sort_and_selection(M):
    """The final stable (metric, path) order by `warp_sort_keys` over
    sort_keys(M)/2 lanes, and the CRC selection from its ranks: the least
    rank whose path passes, else rank 0."""

    rng = np.random.default_rng(100 + M)
    vals = np.array([0.0, 0.5, 1.0, BIG, np.inf], np.float32)
    for trial in range(10):
        pm = np.full(32, BIG, np.float32)
        pm[:M] = rng.random(M).astype(np.float32) if trial % 2 else vals[rng.integers(0, 5, M)]
        k = np.where(LANES < M, _key(pm, LANES), ONES)
        out = _sort_one_a_lane(k, scl_cuda.path_width(M), scl_cuda.sort_keys(M) // 2, [])
        path_r = np.where(LANES < M, (out & np.uint64(0xFFFFFFFF)).astype(np.int64), 0)
        order = np.argsort(pm[:M], kind="stable")
        np.testing.assert_array_equal(path_r[:M], order)
        np.testing.assert_array_equal(_metric(out[:M]), pm[order])
        ok = (rng.random(32) < 0.2) & (pm < BIG)
        ok_ranks = (LANES < M) & ok[path_r]
        sel = int(np.argmax(ok_ranks)) if ok_ranks.any() else 0
        passing = [r for r, m in enumerate(order) if ok[m]]
        assert sel == (passing[0] if passing else 0)
        assert path_r[sel] == order[sel]


def _walk_chunked(TI, K, M, R, best, list_slots):
    """The kernel's walks back over chunks of R trace rows (rows hi..lo,
    top down): each path of rank r (LIST) and lane 0's walk of the
    selected path, which rewrites slot 0 of each row in the chunk."""

    list_bits = np.zeros((M, K), np.int8)
    out = np.zeros(K, np.int64)
    slot = list(list_slots)
    hi = K - 1
    while hi >= 0:
        lo = max(hi - R + 1, 0)
        chunk = TI[lo:hi + 1].copy()
        for r in range(M):
            for i in range(hi, lo - 1, -1):
                w = chunk[i - lo, slot[r]]
                list_bits[r, i] = w & 1
                slot[r] = w >> 1
        for i in range(hi, lo - 1, -1):
            w = chunk[i - lo, best]
            chunk[i - lo, 0] = (best << 1) | (w & 1)
            best = w >> 1
        out[lo:hi + 1] = chunk[:, 0]
        hi -= R
    return list_bits, out


@pytest.mark.parametrize("M,K,N,G", [(3, 64, 128, 6), (17, 100, 128, 2), (32, 8192, 8192, 5),
                                     (32, 64, 128, 6)])
def test_chunked_walk_is_the_whole_walk(M, K, N, G):
    rng = np.random.default_rng(M + K)
    TW = scl_cuda.path_trace_row(M)
    R = scl_cuda.frame_bytes(N, K, M, G) // TW  # rows a chunk
    assert R >= 1 and TW % 16 == 0
    TI = np.zeros((K, TW), np.int64)
    TI[:, :M] = rng.integers(0, 2 * M, (K, M))  # creation index 2p + b of slot m
    best = int(rng.integers(0, M))
    list_slots = rng.permutation(M)
    list_bits, out = _walk_chunked(TI, K, M, R, best, list_slots)
    want_list = np.zeros((M, K), np.int8)
    for r in range(M):
        s = list_slots[r]
        for i in range(K - 1, -1, -1):
            want_list[r, i], s = TI[i, s] & 1, TI[i, s] >> 1
    np.testing.assert_array_equal(list_bits, want_list)
    s = best
    for i in range(K - 1, -1, -1):  # (slot << 1 | bit) of the selected path
        assert out[i] == (s << 1) | (TI[i, s] & 1)
        s = TI[i, s] >> 1


def test_frame_and_scratch_bytes_by_path():
    r16 = lambda x: (x + 15) // 16 * 16  # noqa: E731
    assert [scl_cuda.path_layout(M) for M in (1, 2, 3, 4, 8, 9, 32, 33)] == [
        False, False, True, False, False, True, True, False]
    assert [scl_cuda.path_trace_row(M) for M in (3, 5, 16, 17, 32)] == [16, 16, 16, 32, 32]
    # by path a frame holds tree levels only
    assert scl_cuda.frame_bytes(128, 64, 32, 0) == 5 * 32 * 127 == 20320
    assert scl_cuda.frame_bytes(128, 64, 32, 2) == 5 * 32 * 31
    assert scl_cuda.frame_bytes(128, 64, 16, 1) == 5 * 16 * 63
    assert scl_cuda.frame_bytes(128, 64, 3, 0) == r16(5 * 3 * 127)
    assert scl_cuda.frame_bytes(8192, 8192, 32, 12) == 160
    # the byte words keep their trace in shared memory
    assert scl_cuda.frame_bytes(128, 64, 8, 0) == r16(5 * 8 * 127 + 64 * 8)
    # the trace indices beside the trace LLRs: rows of 16 or 32 bytes
    assert scl_cuda.scratch_bytes(4096, 128, 64, 32, 2) == 4096 * 32 * 96 * 5 + 4096 * 64 * (32 * 4 + 32)
    assert scl_cuda.scratch_bytes(400, 128, 64, 3, 0) == 400 * 64 * (3 * 4 + 16)
    assert scl_cuda.scratch_bytes(4096, 128, 64, 8, 2) == 4096 * 8 * 96 * 5 + 4096 * 64 * 8 * 4


def test_check_shape_takes_n8192_at_every_by_path_m():
    for M in range(29, 33):
        for K in (7260, 8000, 8192):
            scl_cuda.check_shape(8192, K, M, CRC, torch.float32)
    for M in (3, 5, 17):
        scl_cuda.check_shape(8192, 8192, M, None, torch.float32)
    for N in (16384, 32768, 65536):  # through the wide twin of LM=32
        scl_cuda.check_shape(N, N // 2, 32, CRC, torch.float32)
    with pytest.raises(ValueError, match="65536"):
        scl_cuda.check_shape(131072, 65536, 32, CRC, torch.float32)


def _fake_occupancy(frames_at):
    """An occupancy calculator: G -> (frames a block, frames an SM)."""

    return lambda g: (4, frames_at[g])


def test_plan_rule():
    # frames an SM at G = 0..6 as shared memory frees up, 32 the registers' cap
    frames = [11, 18, 32, 32, 32, 32, 32]
    occ = _fake_occupancy(frames)
    most = frames[-1]
    # a B=4096 launch on 132 SMs: 32 frames an SM, one wave, at the smallest G that holds them
    assert scl_cuda.path_target(4096, 132, most) == 32
    assert scl_cuda.smallest_global_levels(7, occ, 32) == (2, 4, 32)
    # a retry batch asks for a few frames an SM: the lowest G
    assert scl_cuda.path_target(400, 132, most) == 4
    assert scl_cuda.smallest_global_levels(7, occ, 4) == (0, 4, 11)
    assert scl_cuda.path_target(1, 132, most) == 1
    # more than registers allow: capped, so the smallest G that holds the cap
    assert scl_cuda.path_target(65536, 132, most) == 32
    # registers cap at 24: no G holds 32, the smallest G with the most
    occ24 = _fake_occupancy([11, 18, 24, 24, 24, 24, 24])
    assert scl_cuda.smallest_global_levels(7, occ24, scl_cuda.path_target(4096, 132, 24)) == (2, 4, 24)
    # the default target, the byte-word, over-warps and PAC kernels' rule: 16
    assert scl_cuda.smallest_global_levels(7, occ) == (1, 4, 18)
    assert scl_cuda.smallest_global_levels(7, _fake_occupancy([1, 2, 6, 9, 12, 12, 12])) == (4, 4, 12)


def test_wrappers_plan_on_a_fake_calculator(monkeypatch):
    # frames an SM fall with the frame's shared memory
    def occupancy(N, K, M, G):
        return 4, min(32, (228 * 1024) // (scl_cuda.frame_bytes(N, K, M, G) + 256))

    monkeypatch.setattr(scl_cuda, "_occupancy", occupancy)
    monkeypatch.setattr(scl_cuda, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    scl_cuda._plan.cache_clear()
    try:
        # by path, P(128,64): one wave at B=4096, the lowest G at a retry batch
        assert scl_cuda.launch_plan(128, 64, 32, 4096) == (2, 4, 32)
        assert scl_cuda.launch_plan(128, 64, 16, 4096) == (1, 4, 32)
        assert scl_cuda.launch_plan(128, 64, 32, 400)[0] == 0
        assert scl_cuda.launch_plan(128, 64, 32, 1)[0] == 0
        # P(8192,4096) M=32 B=1024: 8 frames an SM
        G, _, per_sm = scl_cuda.launch_plan(8192, 4096, 32, 1024)
        assert per_sm >= 8 and scl_cuda.launch_plan(8192, 4096, 32, 1024)[0] == G
        # the byte words keep the target of 16, whatever B
        assert scl_cuda.launch_plan(128, 64, 8, 4096) == scl_cuda.launch_plan(128, 64, 8, 1)
        assert scl_cuda.launch_plan(128, 64, 8, 4096)[2] >= 16
    finally:
        scl_cuda._plan.cache_clear()
    # K3's plan is the default rule on its own calculator
    monkeypatch.setattr(pac_cuda, "_occupancy", lambda N, Kp, L, G: (4, [3, 9, 17, 30, 30, 30, 30][G]))
    pac_cuda.launch_plan.cache_clear()
    try:
        assert pac_cuda.launch_plan(128, 80, 32) == (2, 4, 17)
    finally:
        pac_cuda.launch_plan.cache_clear()


@pytest.mark.parametrize("M,use_crc", [(29, True), (5, False)])
def test_plain_scl_equals_jax_float64_every_bit_info(M, use_crc):
    """K = N = 32: every leaf an info phase, each a fork of 2M candidates."""

    N = K = 32
    rng = np.random.default_rng(M)
    info = np.arange(N)
    B = 6
    if use_crc:
        msgs = np.stack([jax_attach_crc(p, CRC) for p in rng.integers(0, 2, size=(B, K - 24)).astype(np.int8)])
    else:
        msgs = rng.integers(0, 2, size=(B, K)).astype(np.int8)
    codes = np.asarray(jax_encode(jnp.asarray(msgs), info, N))
    llr = 2.0 * (1.0 - 2.0 * codes) + rng.normal(0.0, 1.5, size=codes.shape)
    crc = CRC if use_crc else None
    want = jax_decode(jnp.asarray(llr), info, M, crc, dtype=jnp.float64)
    got = decode_scl_batch(torch.from_numpy(llr), info, M, crc, dtype=torch.float64)
    for f in ("candidates", "valid", "best_index", "best_path_bits", "crc_pass"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    for f in ("metrics", "info_llrs", "best_path_info_llrs"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-12,
                                   atol=1e-12, err_msg=f)
