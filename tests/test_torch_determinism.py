"""Reproducibility and shard invariance of the port's sweep steps.

* Twin of `tests/test_determinism.py`: the same (seed, tags) give the same
  FER and BER chunk counters, another seed gives other counters.
* In-process twin of `tests/test_multidevice.py`: the counters of the W
  frame shards of a chunk (`shard=(r, W)`, as the ranks of a multi-process
  sweep run them) sum to the unsharded chunk's, for W in {2, 4}.
* Each frame decodes as it does in the whole batch, which the byte-identity
  of a split sweep rests on: the SCL decode and the DL-SCL retries (masked
  and compacted) on the ranks' row blocks concatenate to the whole batch's
  result, to JAX `decode_scl_batch` in float64 and to the golden `dl_m2_*`
  vectors.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.ops.scl import decode_scl_batch as jax_decode
from polar_code_tpu_torch.dlscl.flip import decode_with_retries_batch
from polar_code_tpu_torch.interop import load_beta
from polar_code_tpu_torch.nr.ldpc import load_base_graph
from polar_code_tpu_torch.ops.scl_cuda import decode_scl_cuda
from polar_code_tpu_torch.parallel.mesh import shard_frames
from polar_code_tpu_torch.polar.construct import construct_info_set
from polar_code_tpu_torch.sim.pipeline import make_ber_chunk, make_fer_chunk

CRC = "0x17"
GOLDEN = Path(__file__).parent / "golden" / "ref_p128_k64.npz"
CRC24 = "0x1864CFB"


def _host(out):
    return {k: v.item() for k, v in out.items()}


def _fer_chunk(shard=(0, 1), batch=32):
    return make_fer_chunk(
        N=32, K=16, crc_poly=CRC, info_set=construct_info_set(32, 16), M=2, retries=2,
        beta=None, batch=batch, device=torch.device("cpu"), include_uncoded=True, shard=shard,
    )


def _ber_chunk(shard=(0, 1), scheme="polar_scl", batch=16):
    if scheme == "polar_scl":
        code = dict(E=16, N=16, K_payload=4, K_crc=4, info_set=construct_info_set(16, 8),
                    max_iter=0)
    else:  # the demo base graph at Z=4: k = 12 = 8 payload + CRC-4
        code = dict(E=24, N=24, K_payload=8, K_crc=4, info_set=None, max_iter=10,
                    ldpc_bg=load_base_graph(2), ldpc_Z=4)
    return make_ber_chunk(
        scheme=scheme, crc_poly=CRC, M=2, retries=0, beta=None, ilv_mode="default",
        alpha=0.8, batch=batch, device=torch.device("cpu"), shard=shard, **code,
    )


def test_fer_chunk_deterministic():
    a = _host(_fer_chunk()(11, 12, 0, 0.8, 0.8))
    b = _host(_fer_chunk()(11, 12, 0, 0.8, 0.8))
    assert a == b
    assert a != _host(_fer_chunk()(12, 12, 0, 0.8, 0.8))  # another seed, other noise


def test_ber_chunk_deterministic():
    a = _host(_ber_chunk()(3, 0, 0, 0.6))
    assert a == _host(_ber_chunk()(3, 0, 0, 0.6))
    assert a != _host(_ber_chunk()(4, 0, 0, 0.6))


@pytest.mark.parametrize("world", [2, 4])
def test_fer_shards_sum_to_the_chunk(world):
    whole = _host(_fer_chunk(batch=64)(42, 12, 3, 1.2, 1.2))
    parts = [_host(_fer_chunk((r, world), batch=64)(42, 12, 3, 1.2, 1.2)) for r in range(world)]
    assert {k: sum(p[k] for p in parts) for k in whole} == whole
    assert 0 < whole["scl_errors"] <= 64 and whole["retries_used"] > 0
    assert all(p["bits_coded"] == 64 // world * 16 for p in parts)


@pytest.mark.parametrize("world", [2, 4])
def test_ldpc_ber_shards_sum_to_the_chunk(world):
    whole = _host(_ber_chunk(scheme="nr_ldpc", batch=64)(0, 1, 2, 0.5))
    parts = [_host(_ber_chunk((r, world), "nr_ldpc", 64)(0, 1, 2, 0.5)) for r in range(world)]
    assert {k: sum(p[k] for p in parts) for k in whole} == whole
    assert whole["frames"] == 64 and 0 < whole["bit_errors"] <= 64 * 8
    assert 0.0 < whole["work_sum"] <= 64 * 10


def test_shard_needs_a_divisible_batch():
    with pytest.raises(ValueError, match="multiple"):
        _fer_chunk((0, 3), batch=32)(1, 2, 3, 1.0, 1.0)


def _llrs_and_plan(B, N, K, seed):
    rng = np.random.default_rng(seed)
    llr = torch.from_numpy(rng.normal(2.0, 2.5, (B, N)))
    plan = rng.integers(-1, 2, (B, K)).astype(np.int8)
    plan[::2] = -1
    return llr, torch.from_numpy(plan)


def _by_rows(decode, world, llr, plan=None):
    """`decode` on each rank's rows (`shard_frames`), concatenated."""

    parts = [decode(shard_frames(llr, r, world),
                    None if plan is None else shard_frames(plan, r, world)) for r in range(world)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


@pytest.mark.parametrize("world", [2, 4])
def test_row_blocks_decode_as_the_whole_batch(world):
    info = construct_info_set(128, 64)
    llr, plan = _llrs_and_plan(16, 128, 64, seed=7)
    whole = decode_scl_cuda(llr, info, 4, CRC24, force_info_bits=plan)
    split = _by_rows(lambda x, p: decode_scl_cuda(x, info, 4, CRC24, force_info_bits=p),
                     world, llr, plan)
    for k in whole:
        assert torch.equal(split[k], whole[k]), k


def test_row_blocks_equal_jax_float64_on_golden():
    g = np.load(GOLDEN)
    ref = jax_decode(jnp.asarray(g["llrs"], jnp.float64), g["info_set"], 8, CRC24,
                     dtype=jnp.float64)
    out = _by_rows(lambda x, _: decode_scl_cuda(x, g["info_set"], 8, CRC24), 2,
                   torch.from_numpy(g["llrs"]))
    np.testing.assert_array_equal(out["best_path_bits"].numpy(), np.asarray(ref.best_path_bits))
    np.testing.assert_array_equal(out["crc_pass"].numpy(), np.asarray(ref.crc_pass))
    np.testing.assert_allclose(out["best_path_info_llrs"].numpy(),
                               np.asarray(ref.best_path_info_llrs), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(out["best_path_bits"].numpy(), g["scl_m8_best"])


@pytest.mark.parametrize("compact", [0, 8])
def test_retries_on_row_blocks_equal_the_whole_batch(compact):
    info = construct_info_set(128, 64)
    llr, _ = _llrs_and_plan(24, 128, 64, seed=3)
    beta = load_beta("checkpoints/beta_M2.npy").beta_matrix().detach().double()
    whole = decode_with_retries_batch(llr, info, 2, 4, crc=CRC24, beta=beta)
    split = _by_rows(lambda x, _: decode_with_retries_batch(
        x, info, 2, 4, crc=CRC24, beta=beta, compact_capacity=compact), 2, llr)
    for k in whole:
        assert torch.equal(split[k], whole[k]), k
    assert int(whole["attempts_used"].sum()) > 0


def test_retries_on_row_blocks_match_golden():
    g = np.load(GOLDEN)
    out = _by_rows(lambda x, _: decode_with_retries_batch(
        x, g["info_set"], 2, 4, crc=CRC24, compact_capacity=4), 2, torch.from_numpy(g["llrs"]))
    np.testing.assert_array_equal(out["best_path_bits"].numpy(), g["dl_m2_best"])
    np.testing.assert_array_equal(out["success"].numpy(), g["dl_m2_success"])
    np.testing.assert_array_equal(out["attempts_used"].numpy(), g["dl_m2_attempts"])
