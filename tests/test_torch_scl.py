"""The port's SCL decoders against the JAX package's.

* The plain PyTorch decoder (`polar_code_tpu_torch.ops.scl`) in float64 makes
  the same decisions as JAX `decode_scl_batch` on shared LLRs: bits, CRC
  pass, best index exactly; metrics and info LLRs within 1e-12 relative.
* It reproduces the golden reference vectors (float64, the 1e-9 of
  `test_golden.py`), and in float32 the golden bits.
* (`test_torch_scl_wide.py`: the same at N=256, and float32 on 4096 random
  frames.)
* The kernel wrapper runs the plain version for CPU tensors; on the card
  (tests marked `gpu`) the kernel matches the plain version.

JAX's `decode_scl_batch` is pinned bit-identical to the TPU kernel by
`tests/test_pallas_kernel.py`, so it stands in for that kernel here.
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.ops import crc as jax_crc
from polar_code_tpu.ops.polar_transform import encode_batch as jax_encode
from polar_code_tpu.ops.scl import decode_scl_batch as jax_decode
from polar_code_tpu.polar.construct import construct_info_set as jax_info_set
from polar_code_tpu_torch.ops.scl import decode_scl_batch
from polar_code_tpu_torch.ops.scl_cuda import (
    check_shape,
    decode_scl_cuda,
    frame_bytes,
)
from polar_code_tpu_torch.ops.scl_schedule import phase_words, schedule_tables
from polar_code_tpu_torch.polar.construct import construct_info_set

CRC = "0x1864CFB"
GOLDEN = Path(__file__).parent / "golden" / "ref_p128_k64.npz"
FIELDS_EXACT = ("candidates", "valid", "best_index", "best_path_bits", "crc_pass")
FIELDS_CLOSE = ("metrics", "info_llrs", "best_path_info_llrs")


def noisy_llrs(N, K, B, snr_db, seed, method="gaussian"):
    """LLRs of real CRC-24A codewords over BPSK/AWGN (numpy draws, float64)."""

    rng = np.random.default_rng(seed)
    info = jax_info_set(N, K, method=method)
    payloads = rng.integers(0, 2, size=(B, K - 24)).astype(np.int8)
    msgs = np.stack([jax_crc.attach_crc(p, CRC) for p in payloads])
    codes = np.asarray(jax_encode(jnp.asarray(msgs), info, N))
    nv = 1.0 / (2.0 * (K / N) * 10 ** (snr_db / 10.0))
    y = 1.0 - 2.0 * codes + rng.normal(0.0, np.sqrt(nv), size=codes.shape)
    return 2.0 * y / nv, msgs


def forced_plan(msgs, seed):
    """DL-SCL-shaped plans on every other frame: prefix fixed to the sent
    bits, one flipped, the rest free; the other frames are all −1."""

    rng = np.random.default_rng(seed)
    B, K = msgs.shape
    idx = rng.integers(0, K, B)
    pos = np.arange(K)[None, :]
    plan = np.where(pos < idx[:, None], msgs, -1)
    plan = np.where(pos == idx[:, None], 1 - msgs, plan).astype(np.int8)
    plan[1::2] = -1
    return plan


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# the reference's DEGA ordering at N=128, the corrected one above
METHOD = {128: "gaussian", 256: "gaussian_bitrev"}


@functools.lru_cache(maxsize=None)
def _twin_case(N, M):
    """One float64 JAX decode (CRC on, half the frames forced) and its inputs."""

    K = N // 2
    llr, msgs = noisy_llrs(N, K, 40, snr_db=3.0, seed=N + M, method=METHOD[N])
    plan = forced_plan(msgs, seed=M)
    ref = jax_decode(
        jnp.asarray(llr, jnp.float64), jax_info_set(N, K, method=METHOD[N]), M, CRC,
        force_info_bits=jnp.asarray(plan), dtype=jnp.float64,
    )
    return llr, plan, {f: np.asarray(getattr(ref, f)) for f in FIELDS_EXACT + FIELDS_CLOSE}


def check_twin_float64(N, M, use_crc):
    """The plain decoder in float64 against JAX `decode_scl_batch` (shared
    LLRs, half the frames forced); without a CRC against JAX's rank 0."""

    llr, plan, ref = _twin_case(N, M)
    K = N // 2
    res = decode_scl_batch(
        torch.from_numpy(llr), construct_info_set(N, K, method=METHOD[N]), M,
        CRC if use_crc else None,
        force_info_bits=torch.from_numpy(plan), dtype=torch.float64,
    )
    if not use_crc:
        # without a CRC the list is the same and the best path is rank 0
        ref = dict(ref)
        ref["best_index"] = np.zeros_like(ref["best_index"])
        ref["crc_pass"] = np.zeros_like(ref["crc_pass"])
        ref["best_path_bits"] = ref["candidates"][:, 0]
        ref["best_path_info_llrs"] = ref["info_llrs"][:, 0]
    else:
        assert ref["crc_pass"].any() and not ref["crc_pass"].all()
    for f in FIELDS_EXACT:
        np.testing.assert_array_equal(_np(getattr(res, f)), ref[f], err_msg=f)
    for f in FIELDS_CLOSE:
        np.testing.assert_allclose(_np(getattr(res, f)), ref[f], rtol=1e-12, atol=0, err_msg=f)
    assert int((plan[0::2] != -1).sum()) > 0


@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("use_crc", [True, False])
def test_twin_equals_jax_float64(M, use_crc):
    check_twin_float64(128, M, use_crc)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("M", [1, 8])
def test_twin_matches_golden_float64(golden, M):
    res = decode_scl_batch(
        torch.from_numpy(golden["llrs"]), golden["info_set"], M, CRC, dtype=torch.float64
    )
    np.testing.assert_array_equal(res.best_path_bits.numpy(), golden[f"scl_m{M}_best"])
    np.testing.assert_allclose(res.metrics.numpy(), golden[f"scl_m{M}_metrics"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        res.best_path_info_llrs.numpy(), golden[f"scl_m{M}_best_llrs"], rtol=1e-9, atol=1e-9
    )


@pytest.mark.parametrize("M", [1, 8])
def test_twin_golden_bits_float32(golden, M):
    llr = torch.from_numpy(golden["llrs"]).to(torch.float32)
    res = decode_scl_batch(llr, golden["info_set"], M, CRC, dtype=torch.float32)
    np.testing.assert_array_equal(res.best_path_bits.numpy(), golden[f"scl_m{M}_best"])


def _near_ties(metrics, rel=1e-5):
    a, b = metrics[:, :-1].astype(np.float64), metrics[:, 1:].astype(np.float64)
    finite = np.isfinite(a) & np.isfinite(b)
    with np.errstate(invalid="ignore"):
        close = np.abs(b - a) < rel * np.maximum(np.abs(a), np.abs(b))
    return np.any(finite & close, axis=1)


def test_wrapper_runs_plain_version_on_cpu():
    llr, msgs = noisy_llrs(128, 64, 16, snr_db=3.0, seed=5)
    info = construct_info_set(128, 64)
    plan = torch.from_numpy(forced_plan(msgs, seed=3))
    x = torch.from_numpy(llr).to(torch.float32)
    before = decode_scl_cuda.launches
    out = decode_scl_cuda(x, info, 4, CRC, force_info_bits=plan)
    ref = decode_scl_batch(x, info, 4, CRC, force_info_bits=plan)
    assert decode_scl_cuda.launches == before  # no kernel launch on the CPU
    np.testing.assert_array_equal(out["best_path_bits"].numpy(), ref.best_path_bits.numpy())
    np.testing.assert_array_equal(out["crc_pass"].numpy(), ref.crc_pass.numpy())
    np.testing.assert_array_equal(
        out["best_path_info_llrs"].numpy(), ref.best_path_info_llrs.numpy()
    )


@pytest.mark.parametrize(
    "N,K,M,crc,dtype,ok",
    [
        (128, 64, 8, CRC, torch.float32, True),
        (2048, 1024, 4, CRC, torch.float32, True),
        (128, 64, 3, CRC, torch.float32, True),  # M not a power of two: by-path σ
        (128, 64, 16, CRC, torch.float32, True),  # M above 8: by-path σ
        (128, 64, 8, CRC, torch.float64, True),  # float64: M <= 16384 at N <= 8192
        (128, 64, 33, CRC, torch.float64, True),  # float64 over warps: M <= 1024
        (128, 64, 16385, CRC, torch.float64, False),  # float64 past one path a thread of a cluster
        (16384, 8192, 4, CRC, torch.float64, False),  # float64 past N=8192
        (96, 48, 8, CRC, torch.float32, False),  # N not a power of two
        (4096, 2048, 8, CRC, torch.float32, True),  # the TPU kernel's N envelope
        (128, 64, 8, "0x1" + "0" * 9 + "1", torch.float32, False),  # CRC degree 36
        (128, 64, 8193, CRC, torch.float32, True),  # M above 8192: a cluster of 16 blocks
        (128, 64, 16385, CRC, torch.float32, True),  # M above 16384: two paths a thread
        (128, 64, 32769, CRC, torch.float32, True),  # M above 32768: four paths a thread
        (128, 64, 65537, CRC, torch.float32, False),  # M above 65536: four paths a thread of a cluster of 16 blocks
        (16384, 8192, 1, CRC, torch.float32, True),  # N above 8192: past the TPU kernel's envelope
        (131072, 65536, 1, CRC, torch.float32, False),  # N above 65536: past the phase words
        (8192, 8192, 32, None, torch.float32, True),  # by path the trace indices are in global scratch
        (128, 64, 1025, CRC, torch.float64, True),  # float64 on a cluster, one path a thread: M <= 16384
        (8192, 4096, 16384, CRC, torch.float64, True),
    ],
)
def test_kernel_shape_gate(N, K, M, crc, dtype, ok):
    if ok:
        check_shape(N, K, M, crc, dtype)
    else:
        with pytest.raises(ValueError):
            check_shape(N, K, M, crc, dtype)


def test_kernel_tables_pack_the_schedule():
    info = construct_info_set(128, 64)
    _, store, frozen, _, _, _, glevel, gpar_need, comb_need = schedule_tables(128, info)
    # the phase words both kernels read
    words = phase_words(128, info)
    assert words.shape == (128,) and words.dtype == np.int32
    np.testing.assert_array_equal(words & 31, glevel)
    np.testing.assert_array_equal(words >> 10 & 1, frozen)
    np.testing.assert_array_equal(words >> 11 & 1, gpar_need)
    for p in range(128):
        levels = np.flatnonzero(store[p])
        assert words[p] >> 5 & 31 == (levels[0] if levels.size else 0)
    assert not comb_need[:, 0].any()  # level 0 is no level: bit 11 is gpar_need's alone
    for lv in range(1, 8):
        np.testing.assert_array_equal(words >> (11 + lv) & 1, comb_need[:, lv])
    assert (words >> 19 == 0).all()  # nothing above level 7's bit
    assert frame_bytes(128, 64, 8) == 5600  # 4·8·127 + 8·127 + 64·8, to 16 B
    # levels 1..2 in global scratch: 4·8·31 + 8·31 + 64·8
    assert frame_bytes(128, 64, 8, global_levels=2) == 1760
    # N=2048 M=8 with levels 1..4 in global scratch: 5·8·127 + 1024·8, to 16 B
    assert frame_bytes(2048, 1024, 8, 4) == 13280


# ---- on the card (marker `gpu`; skipped without a CUDA device) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SCL kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("use_crc", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, M, use_crc):
    B = 300  # not a multiple of the block's frames
    llr, msgs = noisy_llrs(128, 64, B, snr_db=3.0, seed=M)
    info = construct_info_set(128, 64)
    x = torch.from_numpy(llr).to(torch.float32).to(cuda_device)
    crc = CRC if use_crc else None
    for plan in (None, torch.from_numpy(forced_plan(msgs, seed=M)).to(cuda_device)):
        out = decode_scl_cuda(x, info, M, crc, force_info_bits=plan)
        torch.cuda.synchronize()
        ref = decode_scl_batch(x, info, M, crc, force_info_bits=plan, dtype=torch.float32)
        ties = _near_ties(ref.metrics.cpu().numpy())
        bad = np.any(out["best_path_bits"].cpu().numpy() != ref.best_path_bits.cpu().numpy(), 1)
        bad |= out["crc_pass"].cpu().numpy() != ref.crc_pass.cpu().numpy()
        assert not (bad & ~ties).any()
        keep = ~bad
        np.testing.assert_allclose(
            out["best_path_info_llrs"].cpu().numpy()[keep],
            ref.best_path_info_llrs.cpu().numpy()[keep], rtol=1e-6, atol=0,
        )


@pytest.mark.gpu
def test_kernel_wrapper_rejects_bad_inputs_on_card(cuda_device):
    info = construct_info_set(128, 64)
    x = torch.zeros((8, 128), device=cuda_device)
    with pytest.raises(ValueError):
        decode_scl_cuda(x.double(), info, 8, CRC)
    with pytest.raises(ValueError):
        decode_scl_cuda(x.t().contiguous().t(), info, 8, CRC)  # not contiguous
    with pytest.raises(ValueError):
        decode_scl_cuda(x, info, 8, CRC, force_info_bits=torch.zeros((8, 64), device=cuda_device))
