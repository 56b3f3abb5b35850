"""The port's DL-SCL retries against the JAX package's.

`decode_with_retries_batch` in float64 on shared LLRs, with the committed β
checkpoints, must give JAX's bits, success, attempts, baseline bits and
baseline pass; the compacted path must give exactly what the masked path
gives; the golden `dl_m2_*` vectors must match as `test_golden.py` runs them.
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.dlscl.flip import choose_flip_index as jax_choose
from polar_code_tpu.dlscl.flip import decode_with_retries_batch as jax_retries
from polar_code_tpu.ops import crc as jax_crc
from polar_code_tpu.ops.polar_transform import encode_batch as jax_encode
from polar_code_tpu_torch.dlscl.flip import choose_flip_index, decode_with_retries_batch
from polar_code_tpu_torch.interop import load_beta
from polar_code_tpu_torch.polar.construct import construct_info_set

N, K = 128, 64
CRC = "0x1864CFB"
GOLDEN = Path(__file__).parent / "golden" / "ref_p128_k64.npz"
KEYS = ("best_path_bits", "success", "attempts_used", "baseline_bits", "baseline_pass")


def noisy_llrs(B, snr_db, seed):
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 2, size=(B, K - 24)).astype(np.int8)
    msgs = np.stack([jax_crc.attach_crc(p, CRC) for p in payloads])
    codes = np.asarray(jax_encode(jnp.asarray(msgs), construct_info_set(N, K), N))
    nv = 1.0 / (2.0 * (K / N) * 10 ** (snr_db / 10.0))
    return 2.0 * (1.0 - 2.0 * codes + rng.normal(0.0, np.sqrt(nv), codes.shape)) / nv


@functools.lru_cache(maxsize=None)
def _jax_case(M):
    llr = noisy_llrs(48, snr_db=3.0, seed=M)
    beta = np.load(f"checkpoints/beta_M{M}.npy").astype(np.float64)
    out = jax_retries(
        jnp.asarray(llr, jnp.float64), construct_info_set(N, K), M, 8, crc=CRC,
        beta=jnp.asarray(beta), dtype=jnp.float64, backend="xla",
    )
    return llr, {k: np.asarray(out[k]) for k in KEYS}


@pytest.mark.parametrize("M", [2, 8])
@pytest.mark.parametrize("capacity", [0, 16])
def test_retries_equal_jax_with_beta(M, capacity):
    llr, ref = _jax_case(M)
    beta = load_beta(f"checkpoints/beta_M{M}.npy").beta_matrix().detach().double()
    out = decode_with_retries_batch(
        torch.from_numpy(llr), construct_info_set(N, K), M, 8, crc=CRC, beta=beta,
        compact_capacity=capacity,
    )
    for k in KEYS:
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)
    assert ref["attempts_used"].sum() > 0 and not ref["baseline_pass"].all()


@pytest.mark.parametrize(
    "M,use_beta,snr_db,capacity",
    [
        (1, False, 3.0, 4),  # many failures: several chunks per step
        (2, True, 4.5, 8),  # few failures: some steps run no chunk
        (4, False, 3.5, 16),
        (8, True, 3.0, 64),  # capacity above the batch
    ],
)
def test_compact_equals_masked(M, use_beta, snr_db, capacity):
    llr = torch.from_numpy(noisy_llrs(32, snr_db, seed=M * 100 + capacity)).to(torch.float32)
    beta = load_beta(f"checkpoints/beta_M{M}.npy").beta_matrix().detach() if use_beta else None
    kw = dict(crc=CRC, beta=beta)
    info = construct_info_set(N, K)
    masked = decode_with_retries_batch(llr, info, M, 4, **kw)
    compact = decode_with_retries_batch(llr, info, M, 4, compact_capacity=capacity, **kw)
    assert int(masked["attempts_used"].sum()) > 0
    for k in masked:
        torch.testing.assert_close(compact[k], masked[k], rtol=0, atol=0, msg=k)


def test_retries_match_golden():
    golden = np.load(GOLDEN)
    out = decode_with_retries_batch(
        torch.from_numpy(golden["llrs"]), golden["info_set"], 2, 4, crc=CRC
    )
    np.testing.assert_array_equal(out["best_path_bits"].numpy(), golden["dl_m2_best"])
    np.testing.assert_array_equal(out["success"].numpy(), golden["dl_m2_success"])
    np.testing.assert_array_equal(out["attempts_used"].numpy(), golden["dl_m2_attempts"])


def test_choose_flip_index_equals_jax():
    rng = np.random.default_rng(4)
    beta = np.load("checkpoints/beta_M4.npy")
    for _ in range(20):
        abs_l0 = np.abs(rng.normal(size=64))
        assert choose_flip_index(abs_l0, beta) == jax_choose(abs_l0, beta)
        assert choose_flip_index(abs_l0, None) == jax_choose(abs_l0, None)
    with pytest.raises(ValueError):
        choose_flip_index(np.ones(3), np.eye(4))


def test_retries_require_a_crc_and_fewer_retries_than_k():
    llr = torch.zeros((2, N))
    info = construct_info_set(N, K)
    with pytest.raises(ValueError):
        decode_with_retries_batch(llr, info, 2, 4, crc=None)
    with pytest.raises(ValueError):
        decode_with_retries_batch(llr, info, 2, K, crc=CRC)
