"""The port's plain SCL decoder against JAX at N=256 and on 4096 float32 frames.

The helpers and the N=128 cases are in `test_torch_scl.py`; these cases sit
in a file of their own so that the two JAX-heavy halves run on two workers.

* N=256 (the corrected `gaussian_bitrev` construction), M ∈ {1,2,4,8}, CRC
  on and off, half the frames forced: float64 decisions equal to JAX's.
* In float32 on 4096 random frames the plain decoder disagrees with JAX
  float32 only on near-ties (two ordered final metrics within 1e-5
  relative), at most 1 in 10⁴ frames: the two frameworks' exp/log1p may
  differ in the last ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.ops.scl import decode_scl_batch as jax_decode
from polar_code_tpu_torch.ops.scl import decode_scl_batch
from polar_code_tpu_torch.polar.construct import construct_info_set

from .test_torch_scl import CRC, _near_ties, check_twin_float64, noisy_llrs


@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("use_crc", [True, False])
def test_twin_equals_jax_float64_n256(M, use_crc):
    check_twin_float64(256, M, use_crc)


def test_twin_float32_random_frames_near_ties_only():
    B, M = 4096, 8
    llr, _ = noisy_llrs(128, 64, B, snr_db=2.0, seed=11)
    info = construct_info_set(128, 64)
    ref = jax_decode(jnp.asarray(llr, jnp.float32), info, M, CRC, dtype=jnp.float32)
    res = decode_scl_batch(torch.from_numpy(llr).to(torch.float32), info, M, CRC,
                           dtype=torch.float32)
    bad = np.any(res.best_path_bits.numpy() != np.asarray(ref.best_path_bits), axis=1)
    bad |= res.crc_pass.numpy() != np.asarray(ref.crc_pass)
    ties = _near_ties(res.metrics.numpy()) | _near_ties(np.asarray(ref.metrics))
    assert not (bad & ~ties).any(), np.flatnonzero(bad & ~ties)
    assert int(bad.sum()) <= int(np.ceil(B * 1e-4))
    assert 0 < int(res.crc_pass.sum()) < B  # the frames exercise both outcomes
