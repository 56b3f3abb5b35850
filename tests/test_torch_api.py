"""The port's scalar, reference-compatible surface against the JAX package's.

* `ops/sc.py` (`sc_decode_batch`, `sc_decode`), `polar/api.py` (`encode`,
  `decode_scl`), `ops/crc.py` (`attach_crc`, `check_crc`, `check_crc_batch`
  along either axis) and `dlscl/flip.py` (`retry_with_flip`,
  `decode_with_retries`), on the CPU in float64 against the JAX functions on
  the same numpy inputs (x64, `tests/conftest.py`): decisions and trimmed
  lists identical, metrics and info LLRs within 1e-9, the same keys in the
  same order, and the same validation errors.
* The golden reference vectors `tests/golden/ref_p128_k64.npz` through the
  scalar API (SC, SCL M 1 and 8, DL-SCL M=2 with 4 retries).
* `decode_scl_cuda(..., full=True)` on a CPU tensor returns the plain
  decoder's list; the scalar API on `device="cuda"` raises without a card.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.dlscl import flip as jax_flip
from polar_code_tpu.ops import crc as jax_crc
from polar_code_tpu.ops import sc as jax_sc
from polar_code_tpu.polar import api as jax_api
from polar_code_tpu_torch.dlscl import flip
from polar_code_tpu_torch.ops import crc, sc
from polar_code_tpu_torch.ops.scl import decode_scl_batch
from polar_code_tpu_torch.ops.scl_cuda import LIST_FIELDS, decode_scl_cuda
from polar_code_tpu_torch.polar import api
from polar_code_tpu_torch.polar.construct import construct_info_set

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "ref_p128_k64.npz"
CRC24 = "0x1864CFB"
CRC4 = "0x17"
N_SMALL, K_SMALL = 32, 16
TOL = dict(rtol=1e-9, atol=1e-9)


def assert_same(ours, theirs, where="out"):
    """Equal structure: dicts with the same keys in the same order, lists of
    the same length, integer arrays equal, floats within 1e-9."""

    if isinstance(theirs, dict):
        assert list(ours) == list(theirs), where
        for key in theirs:
            assert_same(ours[key], theirs[key], f"{where}[{key!r}]")
    elif isinstance(theirs, (list, tuple)):
        assert isinstance(ours, list) and len(ours) == len(theirs), where
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same(a, b, f"{where}[{i}]")
    elif theirs is None or isinstance(theirs, (str, bool, int, np.bool_)):
        assert ours == theirs and type(ours) is type(theirs), (where, ours, theirs)
    elif isinstance(theirs, float):
        assert isinstance(ours, float), where
        np.testing.assert_allclose(ours, theirs, **TOL, err_msg=where)
    else:
        a, b = np.asarray(ours), np.asarray(theirs)
        assert a.shape == b.shape and a.dtype == b.dtype, (where, a.dtype, b.dtype)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, **TOL, err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)


def same_error(ours, theirs):
    """Both calls raise the same exception type with the same message."""

    with pytest.raises(Exception) as want:
        theirs()
    with pytest.raises(type(want.value)) as got:
        ours()
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def small_frames(B, seed):
    """LLRs of CRC-4 codewords of P(32,16) through BPSK/AWGN near 1.5 dB, and
    the sent info bits."""

    rng = np.random.default_rng(seed)
    info = construct_info_set(N_SMALL, K_SMALL)
    msgs = np.stack([crc.attach_crc(rng.integers(0, 2, K_SMALL - 4), CRC4) for _ in range(B)])
    u = np.zeros((B, N_SMALL), np.int8)
    u[:, info] = msgs
    x = u.copy()
    step = 1
    while step < N_SMALL:  # natural-order polar transform
        for start in range(0, N_SMALL, 2 * step):
            x[:, start:start + step] ^= x[:, start + step:start + 2 * step]
        step *= 2
    nv = 1.0 / (2.0 * 0.5 * 10 ** 0.15)
    y = 1.0 - 2.0 * x + rng.normal(0.0, np.sqrt(nv), x.shape)
    return 2.0 * y / nv, msgs, info


# --------------------------- CRC and SC ---------------------------

def test_crc_scalar_and_axis_match_jax():
    rng = np.random.default_rng(0)
    for poly, k in ((CRC24, 40), (CRC4, 12)):
        for _ in range(3):
            msg = rng.integers(0, 2, k)
            word = crc.attach_crc(msg, poly)
            assert_same(word, jax_crc.attach_crc(msg, poly))
            assert crc.check_crc(word, poly) is True and jax_crc.check_crc(word, poly) is True
            word[1] ^= 1
            assert crc.check_crc(word, poly) == jax_crc.check_crc(word, poly)
    bits = rng.integers(0, 2, (9, 5, 64)).astype(np.int8)
    bits[0, 0] = crc.attach_crc(bits[0, 0, :40], CRC24)
    for axis, arr in ((-1, bits), (0, np.moveaxis(bits, -1, 0)), (1, np.moveaxis(bits, -1, 1))):
        ours = crc.check_crc_batch(torch.from_numpy(arr), CRC24, axis=axis).numpy()
        theirs = np.asarray(jax_crc.check_crc_batch(jnp.asarray(arr), CRC24, axis=axis))
        np.testing.assert_array_equal(ours, theirs)
        assert ours.any() and not ours.all()
    np.testing.assert_array_equal(  # today's callers: the last axis by default
        crc.check_crc_batch(torch.from_numpy(bits), CRC24).numpy(),
        np.asarray(jax_crc.check_crc_batch(jnp.asarray(bits), CRC24)))


def test_sc_decode_batch_matches_jax():
    llr, _, info = small_frames(24, 1)
    ours = sc.sc_decode_batch(torch.from_numpy(llr), info, dtype=torch.float64)
    theirs = jax_sc.sc_decode_batch(jnp.asarray(llr), info, dtype=jnp.float64)
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_sc_decode_and_encode_match_jax(golden):
    info = golden["info_set"]
    for llr in golden["llrs"][:4]:
        assert_same(sc.sc_decode(llr, info, device="cpu"), jax_sc.sc_decode(llr, info))
    rng = np.random.default_rng(2)
    for _ in range(3):
        msg = rng.integers(0, 2, 64)
        assert_same(api.encode(msg, device="cpu"), jax_api.encode(msg))


# --------------------------- decode_scl ---------------------------

@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("use_crc", [True, False])
@pytest.mark.parametrize("M", [1, 2, 4, 8])
def test_decode_scl_matches_jax(M, use_crc, forced):
    llr, msgs, info = small_frames(4, 10 * M + 2 * use_crc + forced)
    poly = CRC4 if use_crc else None
    rng = np.random.default_rng(M)
    for b in range(llr.shape[0]):
        plan = None
        if forced:  # a DL-SCL plan: prefix fixed, one bit flipped, the rest free
            idx = int(rng.integers(1, K_SMALL - 2))
            plan = np.full(K_SMALL, -1, np.int8)
            plan[:idx] = msgs[b, :idx]
            plan[idx] = 1 - msgs[b, idx]
        ours = api.decode_scl(llr[b], info, M, poly, force_info_bits=plan, device="cpu")
        theirs = jax_api.decode_scl(llr[b], info, M, poly, force_info_bits=plan)
        assert_same(ours, theirs, f"frame {b}")
        if forced and M > 1:
            assert len(ours["candidates"]) <= M


def test_decode_scl_validation_errors_match_jax():
    info = construct_info_set(N_SMALL, K_SMALL)
    llr = np.zeros(N_SMALL)
    bad_calls = [
        dict(M=0),
        dict(info_set=info[None]),
        dict(force_info_bits=np.zeros((1, K_SMALL), np.int8)),
        dict(force_info_bits=np.zeros(K_SMALL - 1, np.int8)),
        dict(force_info_bits=np.full(K_SMALL, 2, np.int8)),
    ]
    for bad in bad_calls:
        args = {"info_set": info, "M": 2, **bad}
        same_error(lambda: api.decode_scl(llr, device="cpu", **args),
                   lambda: jax_api.decode_scl(llr, **args))
    same_error(lambda: sc.sc_decode(llr[None], info, device="cpu"), lambda: jax_sc.sc_decode(llr[None], info))
    same_error(lambda: sc.sc_decode(llr, info[None], device="cpu"), lambda: jax_sc.sc_decode(llr, info[None]))
    same_error(lambda: sc.sc_decode(llr, info + 20, device="cpu"), lambda: jax_sc.sc_decode(llr, info + 20))
    same_error(lambda: api.encode(np.zeros((1, 64)), device="cpu"), lambda: jax_api.encode(np.zeros((1, 64))))
    same_error(lambda: api.encode(np.zeros(63), device="cpu"), lambda: jax_api.encode(np.zeros(63)))
    same_error(lambda: crc.attach_crc(np.zeros((2, 8)), CRC4), lambda: jax_crc.attach_crc(np.zeros((2, 8)), CRC4))
    same_error(lambda: crc.check_crc(np.zeros((2, 8)), CRC4), lambda: jax_crc.check_crc(np.zeros((2, 8)), CRC4))
    bits = np.zeros(K_SMALL, np.int8)
    for fb, idx in ((bits[None], 0), (bits, -1), (bits, K_SMALL)):
        same_error(lambda: flip.retry_with_flip(llr, info, 2, fb, idx, device="cpu"),
                   lambda: jax_flip.retry_with_flip(llr, info, 2, fb, idx))


def test_full_list_on_cpu_is_the_plain_list():
    llr, msgs, info = small_frames(16, 3)
    x = torch.from_numpy(llr)
    plan = torch.from_numpy(np.where(np.arange(K_SMALL) < K_SMALL - 1, msgs, -1).astype(np.int8))
    before = decode_scl_cuda.launches
    out = decode_scl_cuda(x, info, 4, CRC4, force_info_bits=plan, full=True)
    ref = decode_scl_batch(x, info, 4, CRC4, force_info_bits=plan, dtype=torch.float64)
    assert decode_scl_cuda.launches == before
    assert list(out) == ["best_path_bits", "best_path_info_llrs", "crc_pass", *LIST_FIELDS]
    for field, value in out.items():
        torch.testing.assert_close(value, getattr(ref, field), rtol=0, atol=0)
    assert not out["valid"].all()  # the plan leaves some slots unreached
    assert list(decode_scl_cuda(x, info, 4, CRC4)) == ["best_path_bits", "best_path_info_llrs",
                                                       "crc_pass"]


def test_scalar_api_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py phase 12 drives the scalar API there")
    info = construct_info_set(N_SMALL, K_SMALL)
    for call in (lambda: api.decode_scl(np.zeros(N_SMALL), info, 2, device="cuda"),
                 lambda: api.decode_scl(np.zeros(N_SMALL), info, 2),
                 lambda: sc.sc_decode(np.zeros(N_SMALL), info),
                 lambda: api.encode(np.zeros(64)),
                 lambda: flip.decode_with_retries(np.zeros(N_SMALL), info, 2, 1, crc=CRC4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --------------------------- DL-SCL retries ---------------------------

@pytest.mark.parametrize("beta_file", [None, "beta_M2.npy"])
def test_decode_with_retries_matches_jax(golden, beta_file):
    beta = np.load(REPO / "checkpoints" / beta_file) if beta_file else None
    info = golden["info_set"]
    kinds = set()
    for llr in golden["llrs"]:
        ours = flip.decode_with_retries(llr, info, 2, 4, crc=CRC24, beta=beta, device="cpu")
        theirs = jax_flip.decode_with_retries(llr, info, 2, 4, crc=CRC24, beta=beta)
        assert_same(ours, theirs)
        kinds.add((len(ours["attempts"]), ours["success"]))
    assert any(n > 1 for n, _ in kinds)  # some frames needed flips


def test_retry_with_flip_matches_jax(golden):
    info = golden["info_set"]
    for b, idx in ((0, 5), (3, 40)):
        base = jax_api.decode_scl(golden["llrs"][b], info, 2, CRC24)["best_path_bits"]
        ours = flip.retry_with_flip(golden["llrs"][b], info, 2, base, idx, CRC24, device="cpu")
        theirs = jax_flip.retry_with_flip(golden["llrs"][b], info, 2, base, idx, CRC24)
        assert_same(ours, theirs)


# --------------------------- golden reference vectors ---------------------------

def test_scalar_api_reproduces_golden(golden):
    info = golden["info_set"]
    for b, llr in enumerate(golden["llrs"]):
        np.testing.assert_array_equal(sc.sc_decode(llr, info, device="cpu"), golden["sc_bits"][b])
        for M in (1, 8):
            out = api.decode_scl(llr, info, M, CRC24, device="cpu")
            np.testing.assert_array_equal(out["best_path_bits"], golden[f"scl_m{M}_best"][b])
            want = golden[f"scl_m{M}_metrics"][b]
            np.testing.assert_allclose(out["metrics"], want[np.isfinite(want)], **TOL)
            np.testing.assert_allclose(out["best_path_info_llrs"], golden[f"scl_m{M}_best_llrs"][b],
                                       **TOL)
        dl = flip.decode_with_retries(llr, info, 2, 4, crc=CRC24, device="cpu")
        np.testing.assert_array_equal(dl["best_path_bits"], golden["dl_m2_best"][b])
        assert dl["success"] == golden["dl_m2_success"][b]
        assert len(dl["attempts"]) - 1 == golden["dl_m2_attempts"][b]
