"""The port's plain float32 SCL decoder against the JAX float32 golden file.

`tests/golden/scl_f32_decode.npz` (written by `tests/golden/make_scl_f32.py`
with the JAX package's XLA decoder in float32) is what `chip_smoke.py` holds
the CUDA kernel K1 to on the card, where there is no JAX.  Here the plain
decoder, K1's oracle, is held to the same file on the CPU: bits and CRC pass
identical except on near-ties (two ordered final metrics within 1e-5
relative in either decoder: the frameworks' exp/log1p may differ in the last
ulp), at most one frame in a hundred; info LLRs of the agreeing frames
within 1e-6 relative.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from polar_code_tpu_torch.ops.scl import decode_scl_batch

from .test_torch_scl import CRC, _near_ties

GOLDEN = Path(__file__).parent / "golden" / "scl_f32_decode.npz"
CASES = [("p128", M, crc, plan) for M in (1, 2, 4, 8) for crc in (True, False)
         for plan in (False, True)] + [("n2048", 8, True, False)]


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_golden_file_lists_the_cases(golden):
    cases = json.loads(str(golden["cases"]))
    assert [(c["code"], c["M"], c["crc"] is not None, c["plan"]) for c in cases] == CASES
    assert all(c["crc"] in (None, CRC) for c in cases)
    assert GOLDEN.stat().st_size < 2_500_000


@pytest.mark.parametrize("code,M,use_crc,use_plan", CASES)
def test_plain_float32_matches_jax_golden(golden, code, M, use_crc, use_plan):
    tag = f"{code}_M{M}_crc{int(use_crc)}_plan{int(use_plan)}"
    llr = torch.from_numpy(golden[f"{code}/llr"])
    plan = torch.from_numpy(golden[f"{code}/plan"]) if use_plan else None
    res = decode_scl_batch(llr, golden[f"{code}/info"], M, CRC if use_crc else None,
                           force_info_bits=plan, dtype=torch.float32)
    bits, passed = res.best_path_bits.numpy(), res.crc_pass.numpy()
    bad = np.any(bits != golden[f"{tag}/bits"], axis=1) | (passed != golden[f"{tag}/crc_pass"])
    ties = _near_ties(res.metrics.numpy()) | _near_ties(golden[f"{tag}/metrics"])
    assert not (bad & ~ties).any(), np.flatnonzero(bad & ~ties)
    assert int(bad.sum()) <= max(1, llr.shape[0] // 100)
    np.testing.assert_allclose(res.best_path_info_llrs.numpy()[~bad],
                               golden[f"{tag}/llrs"][~bad], rtol=1e-6, atol=0)
    if use_crc:  # the frames exercise both outcomes
        assert 0 < int(passed.sum()) < llr.shape[0]
