"""The list decoders past one warp: list sizes 33..1024, held against JAX.

On the card K1 (`csrc/scl_decode.cu`) and K3 (`csrc/pac_decode.cu`) take
list sizes 33..1024 through their over-warps instantiations (a frame spread
over the warps of a block, one thread a path), and K3 takes N up
to 8192.  On the CPU:

* the plain `decode_scl_batch` in float64 against JAX's at N=64, M ∈ {64,
  256}, with CRC-24A and forced plans: every field of the list;
* the plain `pac_list_decode_batch` list fields against JAX's at L=64;
* the planning: `check_shape` over the new envelope, `frame_bytes` with
  16-bit trace entries and the sort keys, and `scratch_bytes` (the trace
  indices in global scratch over warps) at M 64..1024 and at PAC N=8192;
* a model of the over-warps candidate sort (`cand_key`, `key_metric` and
  `block_sort_keys` in `csrc/list_decode.cuh`: the order-preserving key,
  the bitonic network in registers, shuffles and shared memory, each
  layout's index) and of the final rank's min-reduction, against the
  stable sort.

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
    # above 1024 a frame goes over a cluster of blocks, up to 65536
    scl_cuda.check_shape(128, 64, 1025, CRC, torch.float32)
    with pytest.raises(ValueError, match="1..65536"):
        scl_cuda.check_shape(128, 64, 65537, CRC, torch.float32)
    for L in range(33, 1025):
        pac_cuda.check_shape(128, 80, L, GEN, 16, torch.float32)
    pac_cuda.check_shape(2048, 1040, 32, GEN, 16, torch.float32)
    pac_cuda.check_shape(8192, 4112, 8, GEN, 16, torch.float32)
    pac_cuda.check_shape(8192, 4112, 1024, GEN, 16, torch.float32)
    pac_cuda.check_shape(128, 80, 1025, GEN, 16, torch.float32)
    with pytest.raises(ValueError, match="1..65536"):
        pac_cuda.check_shape(128, 80, 65537, GEN, 16, torch.float32)
    for N in (16384, 32768, 65536):  # past the TPU kernel's N=8192
        pac_cuda.check_shape(N, N // 2 + 16, 8, GEN, 16, torch.float32)
        pac_cuda.check_shape(N, N // 2 + 16, 1024, GEN, 16, torch.float32)
    with pytest.raises(ValueError, match="65536"):
        pac_cuda.check_shape(131072, 65552, 8, GEN, 16, torch.float32)


def test_frame_bytes_over_warps():
    r16 = lambda x: (x + 15) // 16 * 16  # noqa: E731
    assert [scl_cuda.trace_entry_bytes(M) for M in (33, 128, 129, 1024)] == [1, 1, 2, 2]
    # the sort keys: 2M padded to a power of two
    assert [scl_cuda.sort_keys(M) for M in (33, 64, 65, 100, 128, 129, 1024)] == [
        128, 128, 256, 256, 256, 512, 2048]
    # P(128,64) M=1024, levels 1..6 in global scratch: σ rows of 12 16-bit
    # fields (24 B), 2048 sort keys, leaf rows, leaf and syndrome, bit rows
    # and the selected rank; the trace indices are in global scratch
    fb = 1024 * 24 + 8 * 2048 + 4 * 1024 * 1 + 2 * 4 * 1024 + 1024 * 1 + 16
    assert scl_cuda.frame_bytes(128, 64, 1024, 6) == fb == 54288
    # the PAC frame publishes its shift register too, whatever its Kp
    assert pac_cuda.frame_bytes(128, 80, 1024, 6) == fb + 4 * 1024
    # byte entries at M=128: σ rows of 12 bytes
    fb = 128 * 12 + 8 * 256 + r16(4 * 128 * 15) + 2 * 512 + r16(128 * 15) + 16
    assert scl_cuda.frame_bytes(128, 64, 128, 3) == fb
    assert pac_cuda.frame_bytes(128, 64, 128, 3) == fb + 512
    # M=33: 128 keys, and σ rows of 12 bytes, 396 rounded to 400
    assert scl_cuda.frame_bytes(128, 64, 33, 6) == 400 + 8 * 128 + 3 * r16(4 * 33) + r16(33) + 16
    # P(1024,512) M=256: σ rows of 18 16-bit fields (36 B)
    assert scl_cuda.frame_bytes(1024, 512, 256, 9) == 256 * 36 + 8 * 512 + 1024 + 2048 + 256 + 16
    for M in (33, 64, 256, 1024):  # the fit rule: some G fits a block
        n = 10
        assert scl_cuda.frame_bytes(1024, 512, M, n - 1) <= scl_cuda.MAX_BLOCK_SMEM
    # up to M=32 the reckoning is the one-path-a-lane frame's
    assert scl_cuda.frame_bytes(128, 64, 8) == 5600


def test_scratch_bytes_over_warps():
    # levels 1..G and the trace LLRs, and over warps the trace indices
    for M in (64, 128, 256, 1024):
        G = 4
        want = 4096 * M * (128 - (128 >> G)) * 5 + 4096 * 64 * M * (4 + scl_cuda.trace_entry_bytes(M))
        assert scl_cuda.scratch_bytes(4096, 128, 64, M, G) == want
    # about 3.5 GB at B=4096 P(128,64) M=1024 with G=2
    assert scl_cuda.scratch_bytes(4096, 128, 64, 1024, 2) == 4096 * 1024 * (96 * 5 + 64 * 6)
    ti = 4096 * 512 * 256 * 2
    assert scl_cuda.scratch_bytes(4096, 1024, 512, 256, 9) == (4096 * 256 * 1022 * 5
                                                                + 4096 * 512 * 256 * 4 + ti)
    # by path the trace indices are in global scratch too, rows of 32 bytes at M=32
    assert scl_cuda.scratch_bytes(4096, 128, 64, 32, 2) == 4096 * 32 * (96 * 5 + 64 * 4) + 4096 * 64 * 32
    # PAC(8192,4096)+CRC-16 at L=8: its trace is in global scratch too, rows of
    # 16 bytes; the frame keeps its leaf rows and a ring of 16 trace rows
    assert pac_cuda.frame_bytes(8192, 4112, 8, 12) == (5 * 8 + 15) // 16 * 16 + 16 * 16
    # over warps: σ rows of 24 byte fields, 128 sort keys
    assert pac_cuda.frame_bytes(8192, 4112, 64, 12) == 64 * 24 + 8 * 128 + 256 + 3 * 256 + 64 + 16


# ---- models of the over-warps sort ----

ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _key_word(c):
    """`cand_key`'s high word: a float32's order-preserving 32-bit word,
    −0.0 taken as +0.0."""

    u = np.where(c == 0, np.float32(0), c).astype(np.float32).view(np.uint32)
    return u ^ np.where(u >> np.uint32(31) == 1, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))


def _key_metric(keys):
    """`key_metric`: the float32 back from a key's high word."""

    w = (keys >> np.uint64(32)).astype(np.uint32)
    return np.where(w >> np.uint32(31) == 1, w ^ np.uint32(0x80000000), ~w).view(np.float32)


def _block_sort(keys, M):
    """`block_sort_keys` on a block of P/2 threads, P = `sort_keys(M)`:
    thread t holds keys 2t and 2t + 1 (all-ones from t = M on), and the
    network runs stage by stage, through shared memory across warps, by
    shuffles within a warp and in registers; the upper half's threads stop
    after the last merge's first stage.  Returns the lower half it stores
    and the stages of each kind."""

    P = scl_cuda.sort_keys(M)
    T = P // 2
    t = np.arange(T)
    base = 2 * t
    k = np.full(P, ONES)
    k[:2 * M] = keys
    k = k.reshape(T, 2)
    on = np.ones(T, bool)
    kinds = {"shared": 0, "shuffles": 0, "registers": 0}
    size = 2
    while size <= P:
        up = ((base & size) == 0)[:, None]
        j = size // 2
        while j >= 64:  # the threads that run store their keys; each reads its partner's
            kinds["shared"] += 1
            buf = np.zeros(P, np.uint64)  # what no thread stored reads as a wrong key
            buf.reshape(T, 2)[on] = k[on]
            o = buf[(base ^ j)[:, None] + np.arange(2)]
            keep_min = ((base & j) == 0)[:, None] == up
            k = np.where(on[:, None] & ((o < k) == keep_min), o, k)
            if size == P:
                on &= base < P // 2
            j //= 2
        for j in (32, 16, 8, 4, 2):  # lane t ^ j/2, in the same warp
            if j < size:
                kinds["shuffles"] += 1
                partner = t ^ (j // 2)
                assert np.array_equal(partner // 32, t // 32) and np.array_equal(on[partner], on)
                keep_min = ((base & j) == 0)[:, None] == up
                k = np.where(on[:, None] & ((k[partner] < k) == keep_min), k[partner], k)
        kinds["registers"] += 1
        swap = on & ((k[:, 0] > k[:, 1]) == up[:, 0])
        k = np.where(swap[:, None], k[:, ::-1], k)
        size *= 2
    return k.reshape(-1)[:P // 2], kinds


def _fork(good, bad, layout):
    """A fork's candidate metrics in layout order, and the keys as the M
    threads store them: thread p's two at 2p and 2p + 1 (SCL: candidates 2p
    and 2p + 1, index 2p + b; PAC: good p and bad p, index p and M + p)."""

    M = good.size
    c = np.empty(2 * M, np.float32)
    idx = np.empty(2 * M, np.uint64)
    if layout == "scl":
        c[0::2], c[1::2] = good, bad
        idx[:] = np.arange(2 * M)
        ordered = c
    else:
        c[0::2], c[1::2] = good, bad
        idx[0::2], idx[1::2] = np.arange(M), M + np.arange(M)
        ordered = np.concatenate([good, bad])
    return ordered, _key_word(c).astype(np.uint64) << np.uint64(32) | idx


def test_candidate_key_is_order_preserving_and_decodes():
    floats = np.array([-np.inf, -3e38, -2.5, -1e-45, -0.0, 0.0, 1e-45, 0.5, 1.0, 3e38, np.inf],
                      np.float32)
    words = _key_word(floats)
    assert words[4] == words[5] == 0x80000000  # −0.0 and +0.0 are one key
    assert np.all(np.diff(words[5:].astype(np.int64)) > 0) and np.all(np.diff(words[:5].astype(np.int64)) > 0)
    assert words.max() == 0xFF800000  # +inf: below the all-ones pad
    keys = words.astype(np.uint64) << np.uint64(32) | np.uint64(7)
    back = _key_metric(keys)
    np.testing.assert_array_equal(back.view(np.uint32), np.where(floats == 0, np.float32(0), floats).view(np.uint32))
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    order = np.argsort(_key_word(x), kind="stable")
    assert np.all(np.diff(x[order]) >= 0)
    np.testing.assert_array_equal(_key_metric(_key_word(x).astype(np.uint64) << np.uint64(32)), x)


@pytest.mark.parametrize("M", [33, 64, 65, 100, 1024])
def test_over_warps_sort_is_the_stable_sort(M):
    rng = np.random.default_rng(M)
    ties = np.array([0.0, -0.0, 0.5, 1.0, 1.5, 3e38, np.inf], np.float32)
    for trial in range(4):
        if trial == 0:  # distinct metrics
            good = rng.random(M).astype(np.float32)
            bad = good + rng.random(M).astype(np.float32)
        else:  # heavy ties: dead paths at 3e38, +inf, both zeros
            good = ties[rng.integers(0, 7, M)]
            bad = ties[rng.integers(2 if trial == 1 else 0, 7, M)]
        for layout in ("scl", "pac"):
            c, keys = _fork(good, bad, layout)
            out, kinds = _block_sort(keys, M)
            # the trace slot r < M takes the index of the key of rank r, and
            # its metric back from the key
            want = np.argsort(np.where(c == 0, np.float32(0), c), kind="stable")[:M]
            np.testing.assert_array_equal((out[:M] & np.uint64(0xFFFFFFFF)).astype(np.int64), want)
            np.testing.assert_array_equal(_key_metric(out[:M]), np.where(c == 0, np.float32(0), c)[want])
            full = np.sort(np.concatenate([keys, np.full(scl_cuda.sort_keys(M) - 2 * M, ONES)]))
            np.testing.assert_array_equal(out, full[:out.size])
    P = scl_cuda.sort_keys(M)
    p = P.bit_length() - 1
    assert sum(kinds.values()) == p * (p + 1) // 2
    assert kinds["shared"] == {128: 1, 256: 3, 2048: 15}[P]  # the stages across warps
    # the final rank and the selected one (`final_rank`): the least rank
    # of the paths that pass, 0 when none does
    pm = good
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
