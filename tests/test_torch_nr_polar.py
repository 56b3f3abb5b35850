"""The port's NR polar chain against the JAX package's.

* The sub-block interleaver and its inverse, with and without padding.
* The polar rate match/derate pair on both branches: the derate's −1.0 fill
  (a reference quirk) and repeats with a remainder.
* `encode_rate_matched_batch` equal to JAX's; `decode_rate_matched_scl_batch`
  in float64 makes the same decisions as JAX's on shared LLRs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.nr.polar import interleaver as jax_ilv
from polar_code_tpu.nr.polar import rate_match as jax_rm
from polar_code_tpu.nr.polar import scl_nr as jax_nr
from polar_code_tpu.polar.construct import construct_info_set as jax_info_set
from polar_code_tpu_torch.nr.polar.interleaver import (
    interleave_order,
    subblock_deinterleave,
    subblock_interleave,
)
from polar_code_tpu_torch.nr.polar.rate_match import derate_match_polar, rate_match_polar
from polar_code_tpu_torch.nr.polar.scl_nr import (
    decode_rate_matched_scl_batch,
    encode_rate_matched_batch,
)
from polar_code_tpu_torch.polar.construct import construct_info_set

CRC = "0x17"
N, KP, E, M = 32, 8, 40, 2  # K = 8 payload + 4 CRC bits; E > N with a remainder


@pytest.mark.parametrize("length", [16, 100, 128])
def test_interleaver_equals_jax(length):
    np.testing.assert_array_equal(interleave_order(length), jax_ilv.interleave_order(length))
    bits = np.random.default_rng(length).integers(0, 2, (3, length)).astype(np.int8)
    ilv = subblock_interleave(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(ilv, np.asarray(jax_ilv.subblock_interleave(jnp.asarray(bits))))
    assert ilv.shape[-1] % 32 == 0 and (ilv == -1).sum() == 3 * (ilv.shape[-1] - length)
    back = subblock_deinterleave(torch.from_numpy(ilv), length).numpy()
    np.testing.assert_array_equal(back, bits)
    short = np.random.default_rng(1).normal(0, 1, (3, length - 5))
    np.testing.assert_array_equal(
        subblock_deinterleave(torch.from_numpy(short), length).numpy(),
        np.asarray(jax_ilv.subblock_deinterleave(jnp.asarray(short), length)),
    )


@pytest.mark.parametrize("E_", [20, 32, 72, 101])  # puncture, equal, 2 repeats + 8, 3 repeats + 5
def test_polar_rate_match_equals_jax(E_):
    rng = np.random.default_rng(E_)
    bits = rng.integers(0, 2, (4, N)).astype(np.int8)
    np.testing.assert_array_equal(
        rate_match_polar(torch.from_numpy(bits), E_).numpy(),
        np.asarray(jax_rm.rate_match_polar(jnp.asarray(bits), E_)),
    )
    llr = rng.normal(0, 3, (4, E_))
    ours = derate_match_polar(torch.from_numpy(llr), N).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_rm.derate_match_polar(jnp.asarray(llr), N)))
    if E_ < N:
        assert (ours[:, E_:] == -1.0).all()


def test_rate_matched_encode_and_decode_equal_jax():
    info = construct_info_set(N, KP + 4)
    np.testing.assert_array_equal(info, jax_info_set(N, KP + 4))
    rng = np.random.default_rng(7)
    B = 48
    payload = rng.integers(0, 2, (B, KP)).astype(np.int8)
    tx = encode_rate_matched_batch(torch.from_numpy(payload), CRC, N, E, info).numpy()
    np.testing.assert_array_equal(
        tx, np.asarray(jax_nr.encode_rate_matched_batch(jnp.asarray(payload), CRC, N, E, info))
    )
    # noise from clean to hopeless across the batch
    sigma = np.linspace(0.3, 1.5, B)[:, None]
    y = 1.0 - 2.0 * tx + sigma * rng.normal(0, 1, tx.shape)
    llr = 2.0 * y / sigma**2
    ours = decode_rate_matched_scl_batch(torch.from_numpy(llr), CRC, N, E, info, M,
                                         dtype=torch.float64)
    theirs = jax_nr.decode_rate_matched_scl_batch(jnp.asarray(llr), CRC, N, E, info, M,
                                                  dtype=jnp.float64)
    for key in ("payload", "crc_pass", "best_path_bits"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    passed = ours["crc_pass"].numpy()
    assert 0 < passed.sum() < B, "fixture should mix passing and failing frames"
    assert ours["payload"].shape == (B, KP + 4)  # all info+CRC bits, as the reference
