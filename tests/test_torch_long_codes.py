"""Code lengths past 8192: K1 and K3 at N 16384..65536, held against JAX.

On the card K1 (`csrc/scl_decode.cu`) and K3 (`csrc/pac_decode.cu`) take N
up to 65536, where the phase words stop, at every list size 1..8192: the
by-path widths 16 and 32 and the over-warps 16-bit instantiations run wide
twins there whose σ holds 2n − 2 = 30 fields, K1's M 2, 4 and 8 go by path
(the byte words keep their trace in shared memory), and a launch of any
layout goes in several when its global scratch overfills the card.  On the
CPU:

* the shape gate, the bytes a frame and a block take, the scratch, and the
  launch plan's G (a stand-in occupancy calculator) at N 16384, 32768 and
  65536 in every layout, K3 on a cluster at G = n − 2 at N = 65536, and N =
  131072 refused;
* the split of a batch whose scratch allocation failed, in every layout
  (a stand-in allocator);
* a model of the wide σ words (field f in word f / fields-a-word) and of
  the host's reset masks at n 14..16, and of the over-warps fork that
  copies a wide row in two halves;
* the port's schedule tables against the JAX package's `_schedule_tables`
  at n 14..16, and the fields of the phase words the kernels read there;
* (marked `slow`: minutes a case) the port's plain decoders against the JAX
  golden file `tests/golden/scl_f32_long.npz` at P(16384,8192) and
  PAC(16384,8192)+CRC-16.

The card holds the kernels to the plain versions and to the golden file
(`chip_smoke.py`, phase `long_codes`).
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from polar_code_tpu.ops.scl_pallas import _schedule_tables as jax_schedule
from polar_code_tpu_torch.legacy import pac_cuda
from polar_code_tpu_torch.ops import scl_cuda
from polar_code_tpu_torch.ops.scl_schedule import phase_words, schedule_tables
from polar_code_tpu_torch.polar.construct import construct_info_set

CRC = "0x1864CFB"  # CRC-24A
GEN = [1, 0, 1, 1, 0, 1, 1]
LONG_N = (16384, 32768, 65536)
LIST_SIZES = (1, 2, 3, 8, 16, 32, 33, 1024, 1025, 8192)
GOLDEN = Path(__file__).parent / "golden" / "scl_f32_long.npz"


# ---- the shape gate and the bytes ----

@pytest.mark.parametrize("N", LONG_N)
def test_check_shape_takes_long_codes(N):
    for M in LIST_SIZES:
        for K in (N // 2, N):
            scl_cuda.check_shape(N, K, M, CRC, torch.float32)
            pac_cuda.check_shape(N, K, M, GEN, 16, torch.float32)
        scl_cuda.check_shape(N, 1, M, None, torch.float32)
        pac_cuda.check_shape(N, 1, M, GEN, 0, torch.float32)


def test_check_shape_refuses_past_65536():
    assert scl_cuda.MAX_N == pac_cuda.MAX_N == 65536
    for M in (1, 8, 32, 1024, 8192):
        with pytest.raises(ValueError, match="N up to 65536, not 131072"):
            scl_cuda.check_shape(131072, 65536, M, CRC, torch.float32)
        with pytest.raises(ValueError, match="N up to 65536, not 131072"):
            pac_cuda.check_shape(131072, 65552, M, GEN, 16, torch.float32)


def test_byte_words_give_way_past_8192():
    # M=1 keeps the byte words at every N (its trace of K bytes fits a
    # block); M 2, 4 and 8 go by path past N=8192, at LM=8
    for N in (8192,) + LONG_N:
        assert scl_cuda.byte_words(1, N) and not scl_cuda.path_layout(1, N)
        for M in (2, 4, 8):
            assert scl_cuda.byte_words(M, N) == (N <= 8192) != scl_cuda.path_layout(M, N)
            assert scl_cuda.path_width(M) == 8
        for M in (3, 16, 32):
            assert scl_cuda.path_layout(M, N)
    # the trace leaves the frame with the byte words: P(65536,32768) M=8 takes
    # 262,144 B of trace in shared memory, past a block, and by path 48
    assert scl_cuda.frame_bytes(8192, 4096, 8, 12) == (40 + 4096 * 8 + 15) // 16 * 16 == 32816
    assert scl_cuda.frame_bytes(65536, 32768, 8, 15) == 48
    assert scl_cuda.frame_bytes(65536, 65536, 1, 15) == 65552 <= scl_cuda.MAX_BLOCK_SMEM
    # and goes to global scratch, rows of 16 bytes
    assert scl_cuda.scratch_bytes(2, 16384, 8192, 8, 13) == 2 * (8 * 16382 * 5 + 8192 * (8 * 4 + 16))
    assert scl_cuda.scratch_bytes(2, 16384, 8192, 1, 13) == 2 * (16382 * 5 + 8192 * 4)


def test_frame_bytes_at_long_codes():
    r16 = lambda x: (x + 15) // 16 * 16  # noqa: E731
    for N in LONG_N:
        n = N.bit_length() - 1
        # over warps, 16-bit σ rows of 2n − 2 fields rounded to 4 bytes: 52,
        # 56 and 60 B, past the 48 of the n <= 13 instantiation
        row = ((2 * n - 2) * 2 + 3) // 4 * 4
        assert row == {14: 52, 15: 56, 16: 60}[n]
        for G in (n - 4, n - 1):
            ss = (N >> G) - 1
            assert scl_cuda.deep_frame_bytes(N, 1024, G) == (
                r16(1024 * row) + 8 * 2048 + r16(4 * 1024 * ss) + 2 * r16(4096) + r16(1024 * ss) + 16)
            # on a cluster: two σ tables, three key buffers, two word sets
            assert scl_cuda.cluster_block_bytes(N, G) == (
                2 * r16(1024 * row) + 3 * 8 * 2048 + 2 * 2 * 4 * 1024 + r16(4096 * ss) + r16(1024 * ss) + 16)
        # by path (LM 16 and 32 wide): the leaf rows alone at G = n − 1
        for M in (3, 16, 32):
            assert scl_cuda.frame_bytes(N, N, M, n - 1) == r16(5 * M)
        # the scratch of a frame: levels 1..G, trace LLRs and indices
        assert scl_cuda.scratch_bytes(1, N, N // 2, 32, n - 1) == 32 * (N - 2) * 5 + N // 2 * (32 * 4 + 32)
        assert scl_cuda.scratch_bytes(1, N, N // 2, 2048, n - 3) == 2048 * (N - 8) * 5 + N // 2 * 2048 * 6
    # the largest frame the kernels take: 4.3 GB of scratch at P(65536,32768)
    # M=8192, G=13; its trace entries info_i·M + m stay below 2^29
    assert scl_cuda.scratch_bytes(1, 65536, 32768, 8192, 13) == 4_294_639_616
    assert 65535 * 8192 + 8191 < 2 ** 29 and 8191 * 65535 < 2 ** 29


# ---- the launch plan ----

# (N, G) of K1 and K3 on a cluster: the smallest G whose block fits 232,448
# B, with its bytes; K3 at N = 65536 needs n − 2 (n − 3 is 16 B over)
CLUSTER_G = {
    "scl": [(16384, 11, 207888), (32768, 12, 216080), (65536, 13, 224272)],
    "pac": [(16384, 11, 216080), (32768, 12, 224272), (65536, 14, 211984)],
}


@pytest.mark.parametrize("N", LONG_N)
def test_long_cluster_plan_pins_g(N, monkeypatch):
    def occupancy(frame_bytes):  # 66 clusters where a block fits, none elsewhere
        return lambda N, K, M, G: (1, 66 if frame_bytes(N, K, M, G) <= scl_cuda.MAX_BLOCK_SMEM else 0)

    monkeypatch.setattr(scl_cuda, "_occupancy", occupancy(scl_cuda.frame_bytes))
    monkeypatch.setattr(pac_cuda, "_occupancy", occupancy(pac_cuda.frame_bytes))
    scl_cuda._plan.cache_clear()
    pac_cuda.launch_plan.cache_clear()
    try:
        plans = {"scl": [scl_cuda.launch_plan(N, N // 2, M, 64) for M in (1025, 2048, 8192)],
                 "pac": [pac_cuda.launch_plan(N, N // 2 + 16, L) for L in (1025, 2048, 8192)]}
    finally:
        scl_cuda._plan.cache_clear()
        pac_cuda.launch_plan.cache_clear()
    n = N.bit_length() - 1
    for kind, words in (("scl", 2), ("pac", 3)):
        _, G, want = next(c for c in CLUSTER_G[kind] if c[0] == N)
        assert plans[kind] == [(G, 1, 66)] * 3
        assert scl_cuda.cluster_block_bytes(N, G, words) == want <= scl_cuda.MAX_BLOCK_SMEM
        assert scl_cuda.cluster_block_bytes(N, G - 1, words) > scl_cuda.MAX_BLOCK_SMEM
        assert G == (n - 2 if (kind, N) == ("pac", 65536) else n - 3)


@pytest.mark.parametrize("N", LONG_N)
def test_long_plan_in_the_other_layouts(N, monkeypatch):
    # frames an SM fall with the frame's shared memory, 32 at most
    def occupancy(frame_bytes):
        return lambda N, K, M, G: (4, min(32, (228 * 1024) // (frame_bytes(N, K, M, G) + 256)))

    monkeypatch.setattr(scl_cuda, "_occupancy", occupancy(scl_cuda.frame_bytes))
    monkeypatch.setattr(pac_cuda, "_occupancy", occupancy(pac_cuda.frame_bytes))
    monkeypatch.setattr(scl_cuda, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    scl_cuda._plan.cache_clear()
    pac_cuda.launch_plan.cache_clear()
    n = N.bit_length() - 1

    def check_plan(frame_bytes, K, M, G, per_sm, target):
        # G holds the target, or the most any G holds; no smaller G does
        at = [occupancy(frame_bytes)(N, K, M, g)[1] for g in range(n)]
        want = min(target, max(at))
        assert at[G] == per_sm >= want and all(a < want for a in at[:G])
        assert frame_bytes(N, K, M, G) <= scl_cuda.MAX_BLOCK_SMEM

    try:
        for M in (1, 8, 32, 64, 1024):
            G, _, per_sm = scl_cuda.launch_plan(N, N // 2, M, 1024)
            # by path the batch's share, ceil(1024 / 132) = 8 frames an SM;
            # the byte words and over warps the target of 16
            check_plan(scl_cuda.frame_bytes, N // 2, M, G, per_sm, 8 if scl_cuda.path_layout(M, N) else 16)
        for L in (1, 8, 32, 64, 1024):
            G, _, per_sm = pac_cuda.launch_plan(N, N // 2 + 16, L)
            check_plan(pac_cuda.frame_bytes, N // 2 + 16, L, G, per_sm, 16)
    finally:
        scl_cuda._plan.cache_clear()
        pac_cuda.launch_plan.cache_clear()


def test_split_batch_in_every_layout():
    free = 80 * 10 ** 9
    # over warps, P(65536,32768) M=64 at G = n − 1: 31.5 MB a frame, 128.8 GB
    # at B=4096, which goes in two launches; M=32 by path, 64.4 GB, in one
    one = scl_cuda.scratch_bytes(1, 65536, 32768, 64, 15)
    assert one == 64 * 65534 * 5 + 32768 * 64 * 5 and round(4096 * one / 1e9, 1) == 128.8
    step = scl_cuda.split_batch(4096, one, free)
    assert step == 72 * 10 ** 9 // one == 2288
    assert [min(step, 4096 - b0) for b0 in range(0, 4096, step)] == [2288, 1808]
    one = scl_cuda.scratch_bytes(1, 65536, 32768, 32, 15)
    assert round(4096 * one / 1e9, 1) == 64.4 and scl_cuda.split_batch(4096, one, free) == 4096
    assert scl_cuda.split_batch(8192, one, free) == 72 * 10 ** 9 // one < 8192
    # K3 one path a lane, L=32 at PAC(65536,32784): the trace rows and levels
    one = pac_cuda.scratch_bytes(1, 65536, 32784, 32, 15)
    assert one == 32 * 65534 * 5 + 32784 * 32
    assert scl_cuda.split_batch(16384, one, free) == 72 * 10 ** 9 // one
    # a frame that alone overfills nine tenths of the card raises, naming its bytes
    with pytest.raises(ValueError, match=f"{one} bytes"):
        scl_cuda.split_batch(1, one, one)


def test_alloc_scratch_splits_after_a_failed_allocation():
    asked, made = [], []

    def free(n):
        def query():
            asked.append(n)
            return n
        return query

    def card(room):
        """A stand-in allocator: frames' scratch up to `room` bytes, else the
        card's out-of-memory error."""

        def alloc(frames):
            if frames * one > room:
                raise torch.cuda.OutOfMemoryError(f"{frames} frames")
            made.append(frames)
            return f"scratch of {frames}"
        return alloc

    # a by-path launch that fits is allocated whole, the card not asked
    one = scl_cuda.scratch_bytes(1, 16384, 8192, 8, 13)
    assert scl_cuda.alloc_scratch(1024, one, card(10 ** 12), free(0), "x") == (1024, "scratch of 1024")
    assert made == [1024] and not asked
    # one that does not fit, on a card with 2 GB free (well under 4 GiB), is
    # split after the failed allocation, in every layout alike
    for n, k, m, g in ((16384, 8192, 8, 13), (65536, 32768, 64, 15), (128, 64, 2048, 3)):
        one = scl_cuda.scratch_bytes(1, n, k, m, g)
        frames = 3 * 10 ** 9 // one
        step = int(2e9 * 0.9) // one
        assert 0 < step < frames
        assert scl_cuda.alloc_scratch(frames, one, card(2 * 10 ** 9), free(2 * 10 ** 9), "x") == (
            step, f"scratch of {step}")
        assert asked[-1] == 2 * 10 ** 9 and made[-1] == step
    # where the split's allocation fails too (the free memory fragmented), it
    # raises with what and the bytes named
    with pytest.raises(RuntimeError, match=f"the SCL scratch is {step * one} bytes for {step} frames"):
        scl_cuda.alloc_scratch(frames, one, card(one), free(2 * 10 ** 9), "the SCL scratch")
    # a frame that alone overfills nine tenths of the free memory raises, naming its bytes
    with pytest.raises(ValueError, match=f"{one} bytes"):
        scl_cuda.alloc_scratch(4, one, card(0), free(one), "x")
    # a frame with no scratch (K3 at L=1, every level in shared memory) goes whole
    assert pac_cuda.scratch_bytes(1, 128, 80, 1, 0) == 0
    assert scl_cuda.split_batch(4096, 0, 0) == 4096


# ---- the wide σ words, modelled ----

def sigma_layout(LM, wide):
    """(bits a field, fields a word, words) of `PathSigma<LM, WIDE>`."""

    bits = 1 if LM <= 2 else {4: 2, 8: 3, 16: 4, 32: 5}[LM]
    return bits, 32 // bits, (1 if LM <= 2 else 2 if LM == 4 else 3 if LM <= 16 else 4) + wide


def reset_masks(LM, wide, n):
    """`reset_masks<LM, WIDE>(n)`: llr[l] the fields of LLR levels l..n−1,
    bit[l] the field of bit level l, in 4 words (5 wide)."""

    bits, fields, _ = sigma_layout(LM, wide)
    W = 5 if wide else 4
    llr = [[0] * W for _ in range(17)]
    bit = [[0] * W for _ in range(17)]

    def set_(words, f):
        assert f // fields < W  # `words[f / kFields]`: inside the struct's words
        words[f // fields] |= ((1 << bits) - 1) << (bits * (f % fields))

    for lv in range(1, n + 1):
        for x in range(lv, n):
            set_(llr[lv], x - 1)
        if lv >= 2:
            set_(bit[lv], n + lv - 3)
    return llr, bit


def pack(values, LM, wide):
    bits, fields, words = sigma_layout(LM, wide)
    w = [0] * words
    for f, v in enumerate(values):
        w[f // fields] |= v << (bits * (f % fields))
    return w


def get(w, f, LM, wide):
    bits, fields, _ = sigma_layout(LM, wide)
    return (w[f // fields] >> (bits * (f % fields))) & (LM - 1)


def test_sigma_words_hold_every_n():
    for LM in (2, 4, 8, 16, 32):
        bits, fields, words = sigma_layout(LM, False)
        assert scl_cuda.NARROW_SIGMA_FIELDS[LM] == words * fields
        # the narrow words hold n <= 13 everywhere, and n = 16 at LM 2, 4, 8
        assert 2 * 13 - 2 <= words * fields and (2 * 16 - 2 <= words * fields) == (LM <= 8)
        most = sigma_layout(LM, True) if LM >= 16 else (bits, fields, words)
        assert scl_cuda.SIGMA_FIELDS[LM] == most[1] * most[2] >= 2 * 16 - 2
    assert scl_cuda.SIGMA_FIELDS == {2: 32, 4: 32, 8: 30, 16: 32, 32: 30}


@pytest.mark.parametrize("LM", [16, 32])
@pytest.mark.parametrize("n", [14, 15, 16])
def test_wide_sigma_packing_and_resets(LM, n):
    bits, fields, words = sigma_layout(LM, True)
    assert words == sigma_layout(LM, False)[2] + 1 and 2 * n - 2 <= words * fields
    # the narrow words end before field 2n − 3
    assert (2 * n - 3) // sigma_layout(LM, False)[1] >= sigma_layout(LM, False)[2]
    llr, bit = reset_masks(LM, True, n)
    rng = np.random.default_rng(n * LM)
    for m in (0, 5, LM - 1):
        rep = sum(1 << (bits * j) for j in range(fields))
        identity = m * rep & 0xFFFFFFFF  # `PathSigma::identity(m)`
        for _ in range(20):
            values = [int(v) for v in rng.integers(0, LM, 2 * n - 2)]
            w = pack(values, LM, True)
            assert [get(w, f, LM, True) for f in range(2 * n - 2)] == values
            l0, s_prev = int(rng.integers(1, n + 1)), int(rng.integers(0, n + 1))
            mask = [a | b for a, b in zip(llr[l0], bit[s_prev])]
            w = [(x & ~mask[k]) | (identity & mask[k]) for k, x in enumerate(w)]
            reset = set(range(l0 - 1, n - 1)) | ({n + s_prev - 3} if s_prev >= 2 else set())
            assert [get(w, f, LM, True) for f in range(2 * n - 2)] == [
                m if f in reset else v for f, v in enumerate(values)]
    # no mask reaches past the words' fields
    top = (1 << (bits * fields)) - 1
    assert all(x <= top for row in llr + bit for x in row[:words]) and not any(
        row[words:] != [0] * (5 - words) for row in llr + bit)


def test_over_warps_fork_in_halves():
    # σ ← σ[parent] over a table of rows of 15 words (n = 16, 16-bit fields),
    # copied as `DeepSigma::fork` does past 12 words: each thread reads its
    # parent's words 0..7, a barrier, writes its own, a barrier, then 8..15
    rng = np.random.default_rng(16)
    M, words = 1024, 15
    tab = rng.integers(0, 2 ** 32, (M, 16), dtype=np.uint64)
    parent = rng.integers(0, M, M)
    want = tab[parent].copy()
    for h in range(0, 16, 8):
        cols = [k for k in range(h, h + 8) if k < words]
        regs = tab[parent][:, cols]  # every read before the barrier
        tab[:, cols] = regs  # every write after it
    np.testing.assert_array_equal(tab[:, :words], want[:, :words])


# ---- the host tables at n 14..16 ----

@pytest.mark.parametrize("poly", ["0x1864CFB", "0x11021"])
def test_crc_generator_matrix_equals_jax(poly):
    # the LFSR build of the CRC generator matrix: the JAX package's long
    # divisions a column, at the lengths they allow here
    from polar_code_tpu.ops.crc import generator_matrix as jax_generator

    from polar_code_tpu_torch.ops.crc import attach_crc_batch, generator_matrix

    for k in (1, 7, 300, 1500):
        np.testing.assert_array_equal(generator_matrix(poly, k), np.asarray(jax_generator(poly, k)))
    # and at P(65536,32768)'s CRC-24A payload, against a bit-serial CRC
    k = 32744 if poly == "0x1864CFB" else 32768
    msg = np.random.default_rng(k).integers(0, 2, (1, k)).astype(np.int8)
    g = int(poly, 16)
    deg = g.bit_length() - 1
    r = 0
    for b in list(msg[0]) + [0] * deg:  # long division of msg·x^deg
        r = (r << 1) | int(b)
        if r >> deg & 1:
            r ^= g
    want = [(r >> i) & 1 for i in range(deg - 1, -1, -1)]
    np.testing.assert_array_equal(attach_crc_batch(torch.from_numpy(msg), poly)[0, k:].numpy(), want)




@pytest.mark.parametrize("N", LONG_N)
def test_schedule_tables_equal_jax_long(N):
    info = construct_info_set(N, N // 2, method="gaussian_bitrev")
    ours = schedule_tables(N, info)
    theirs = jax_schedule(N, np.asarray(info))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the phase words the kernels read: g-level, store level, frozen,
    # gpar_need and comb_need at levels 1..n, all below bit 31
    _, store, frozen, _, _, _, glevel, gpar_need, comb_need = ours
    n = int(math.log2(N))
    words = phase_words(N, info).astype(np.int64)
    assert words.min() >= 0 and words.max() < 1 << (12 + n)
    np.testing.assert_array_equal(words & 31, glevel)
    np.testing.assert_array_equal(words >> 5 & 31, np.argmax(store, axis=1))
    np.testing.assert_array_equal(words >> 10 & 1, frozen)
    np.testing.assert_array_equal(words >> 11 & 1, gpar_need)
    for lv in range(1, n + 1):
        np.testing.assert_array_equal(words >> (11 + lv) & 1, comb_need[:, lv])
    assert 0 < gpar_need.sum() < N and 0 < comb_need.sum()


# ---- the plain decoders against the JAX golden file (minutes a case) ----

@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def _near_ties(metrics, rel=1e-5):
    m = metrics.astype(np.float64)
    a, b = m[:, :-1], m[:, 1:]
    finite = np.isfinite(a) & np.isfinite(b)
    with np.errstate(invalid="ignore"):
        close = np.abs(b - a) < rel * np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30)
    return np.any(finite & close, axis=1)


@pytest.mark.slow
@pytest.mark.parametrize("M", [1, 8, 32])
def test_plain_scl_equals_jax_at_n16384(golden, M):
    """Bits, CRC pass and info LLRs (within 1e-6 relative) of every frame
    equal to JAX float32's, but in a near-tie frame (two ordered final
    metrics of either decoder within 1e-5 relative, the rule of
    `chip_smoke.py`'s `judge_list`: at M=32 most frames here have one)."""

    from polar_code_tpu_torch.ops.scl import decode_scl_batch

    case = next(c for c in json.loads(str(golden["cases"])) if c["kind"] == "scl" and c["M"] == M)
    tag, code = case["name"], case["code"]
    res = decode_scl_batch(torch.from_numpy(golden[f"{code}/llr"]), golden[f"{code}/info"], M, case["crc"],
                           dtype=torch.float32)
    ties = _near_ties(res.metrics.numpy()) | _near_ties(golden[f"{tag}/metrics"])
    bits = res.best_path_bits.numpy()
    llrs = res.best_path_info_llrs.numpy().astype(np.float64)
    want = golden[f"{tag}/llrs"].astype(np.float64)
    bad = (np.any(bits != golden[f"{tag}/bits"], axis=1) | (res.crc_pass.numpy() != golden[f"{tag}/crc_pass"])
           | np.any(np.abs(llrs - want) > 1e-6 * np.abs(want), axis=1))
    assert not (bad & ~ties).any(), np.flatnonzero(bad & ~ties)


@pytest.mark.slow
def test_plain_pac_equals_jax_at_n16384(golden):
    from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch

    case = next(c for c in json.loads(str(golden["cases"])) if c["kind"] == "pac")
    name = case["name"]
    out = pac_list_decode_batch(torch.from_numpy(golden[f"{name}/llr"]), golden[f"{name}/mask"], case["gen"],
                                case["L"], crc_len=case["crc_len"], crc_poly=case["crc_poly"],
                                dtype=torch.float32)
    for f in ("extracted", "crc_pass", "metrics", "v_full", "candidates"):
        want = golden[f"{name}/{f}"]
        np.testing.assert_array_equal(np.asarray(out[f]).astype(want.dtype), want, err_msg=f)
