"""The port's two-stage adaptive SCL against the JAX package's.

Per frame, the port's `decode_scl_adaptive` must equal JAX's — bits, info
LLRs, CRC pass and the re-decoded flag — with the masked second stage
(capacity 0) and with compaction into chunks (capacity > 0), on LLRs that
mix stage-1 passes and failures.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.ops.adaptive import decode_scl_adaptive as jax_adaptive
from polar_code_tpu_torch.ops.adaptive import decode_scl_adaptive
from polar_code_tpu_torch.polar.construct import construct_info_set

N, K, CRC, M1, M2 = 32, 16, "0x17", 1, 4


@pytest.fixture(scope="module")
def case():
    info = construct_info_set(N, K)
    llr = np.random.default_rng(0).normal(0, 2.0, (24, N)).astype(np.float32)
    return info, llr


@pytest.mark.parametrize("capacity", [0, 5])
def test_adaptive_equals_jax_per_frame(case, capacity):
    info, llr = case
    ours = decode_scl_adaptive(torch.from_numpy(llr), info, M1, M2, CRC, capacity=capacity)
    theirs = jax_adaptive(jnp.asarray(llr), info, M1, M2, CRC, capacity=capacity, backend="xla")
    for key in ("best_path_bits", "best_path_info_llrs", "crc_pass", "second_stage"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    redo = ours["second_stage"].numpy()
    assert 5 < redo.sum() < len(redo), "fixture should re-decode more than one chunk, not all"


def test_adaptive_requires_crc(case):
    info, llr = case
    with pytest.raises(ValueError, match="CRC"):
        decode_scl_adaptive(torch.from_numpy(llr), info, M1, M2, None)
