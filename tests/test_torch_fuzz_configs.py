"""The fuzz configurations of `tests/test_fuzz_configs.py` through the port's
plain decoders, against the JAX package's, on the CPU in float64.

* `CONFIGS` (odd K, CRC-4 `0x17` and CRC-24A, N 16–4096): the port's
  `decode_scl_batch` against JAX `decode_scl_batch` on the same LLRs —
  candidates, validity, best index, bits and CRC pass identical; metrics and
  info LLRs within 1e-9.  N ≥ 2048 is `slow` here (`chip_smoke.py` phase
  12(c) holds the kernel K1 to the plain version there on the card).
* `PAC_CONFIGS`: the port's `pac_list_decode_batch` against JAX's — the
  extracted bits, CRC pass, candidates, validity and paths identical;
  metrics within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.legacy.pac import pac_list_decode_batch as jax_pac_decode
from polar_code_tpu.legacy.rate_profile import rateprofile as jax_rateprofile
from polar_code_tpu.ops.scl import decode_scl_batch as jax_decode
from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch
from polar_code_tpu_torch.legacy.rate_profile import rateprofile
from polar_code_tpu_torch.ops.scl import decode_scl_batch
from polar_code_tpu_torch.polar.construct import construct_info_set

from .test_fuzz_configs import CONFIGS as JAX_CONFIGS
from .test_fuzz_configs import PAC_CONFIGS

TOL = dict(rtol=1e-9, atol=1e-9)
B = 8


def _values(case):
    return tuple(case.values) if hasattr(case, "values") else tuple(case)


CONFIGS = [pytest.param(*_values(c), marks=pytest.mark.slow) if _values(c)[0] >= 2048
           else _values(c) for c in JAX_CONFIGS]


@pytest.mark.parametrize("N,K,M,crc,scale,seed", CONFIGS)
def test_plain_decoder_matches_jax_fuzz(N, K, M, crc, scale, seed):
    info_set = construct_info_set(N, K)
    llr = np.random.default_rng(seed).normal(0, scale, size=(B, N))
    ref = jax_decode(jnp.asarray(llr), info_set, M, crc, dtype=jnp.float64)
    res = decode_scl_batch(torch.from_numpy(llr), info_set, M, crc, dtype=torch.float64)
    for field in ("candidates", "valid", "best_index", "best_path_bits", "crc_pass"):
        np.testing.assert_array_equal(getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
                                      err_msg=field)
    for field in ("metrics", "info_llrs", "best_path_info_llrs"):
        np.testing.assert_allclose(getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
                                   **TOL, err_msg=field)


@pytest.mark.parametrize("N,Kp,L,gen,crc_len,crc_poly,profile,seed", PAC_CONFIGS)
def test_plain_pac_decoder_matches_jax_fuzz(N, Kp, L, gen, crc_len, crc_poly, profile, seed):
    rp, jrp = rateprofile(N, Kp, 2.0, 0), jax_rateprofile(N, Kp, 2.0, 0)
    rp.build_mask(profile)
    jrp.build_mask(profile)
    mask = rp.modify_profile()
    np.testing.assert_array_equal(mask, jrp.modify_profile())
    llr = np.random.default_rng(seed).normal(0, 3, size=(B, N))
    ref = jax_pac_decode(jnp.asarray(llr), mask, gen, L, crc_len=crc_len, crc_poly=crc_poly,
                         dtype=jnp.float64)
    res = pac_list_decode_batch(torch.from_numpy(llr), mask, gen, L, crc_len=crc_len,
                                crc_poly=crc_poly, dtype=torch.float64)
    for field in ("extracted", "crc_pass", "candidates", "valid", "v_full"):
        np.testing.assert_array_equal(res[field].numpy(), np.asarray(ref[field]), err_msg=field)
    np.testing.assert_allclose(res["metrics"].numpy(), np.asarray(ref["metrics"]), **TOL)
