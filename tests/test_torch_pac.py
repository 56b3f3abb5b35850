"""The port's PAC list decoder against the JAX package's.

* The plain decoder `pac_list_decode_batch` against JAX's XLA decoder in
  float32, on every output key, at the fixture of `tests/test_pac_kernel.py`
  (PAC(32, 12+8), gen 1011, CRC-8 0xA6) for L ∈ {1, 2, 4}, with and without
  the CRC.
* The plain decoder against every case of the golden file
  `tests/golden/legacy_pac_decode.npz` (JAX outputs written by
  `tests/golden/make_legacy_pac.py`): `extracted`, `crc_pass` and `metrics`
  identical, read with numpy alone.
* The kernel's host tables (phase-order check columns, output positions), its
  shape checks, and `pac_decode`'s routing: a CUDA tensor goes to the kernel
  or raises, a CPU tensor to the plain version.
* On the card (marker `gpu`): the kernel equals the plain version.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.legacy.crclib import crc as jax_crc
from polar_code_tpu.legacy.pac import pac_encode_batch as jax_encode
from polar_code_tpu.legacy.pac import pac_list_decode_batch as jax_decode
from polar_code_tpu.legacy.rate_profile import rateprofile as jax_rateprofile
from polar_code_tpu_torch.legacy import pac as pac_mod
from polar_code_tpu_torch.legacy.pac import pac_decode, pac_list_decode_batch
from polar_code_tpu_torch.legacy.pac_cuda import (
    check_shape,
    frame_bytes,
    host_tables,
    pac_list_decode_cuda,
)
from polar_code_tpu_torch.legacy.rate_profile import rateprofile
from polar_code_tpu_torch.ops.crc import check_matrix

N, K = 32, 12
CRC_LEN, CRC_POLY = 8, 0xA6
KP = K + CRC_LEN
GEN = (1, 0, 1, 1)
B = 8
GOLDEN = Path(__file__).resolve().parent / "golden" / "legacy_pac_decode.npz"
KEYS = ("extracted", "candidates", "metrics", "valid", "crc_pass", "v_full")


@pytest.fixture(scope="module")
def mask():
    rp = jax_rateprofile(N, KP, 2.0, 0)
    rp.build_mask("dega")
    return np.asarray(rp.modify_profile())


def _frames(mask, seed, snr_db=3.0, frames=B):
    """Float32 LLRs of CRC'd PAC codewords through BPSK + AWGN (numpy draws;
    the JAX package encodes, so the port's encoder is not under test here)."""

    rng = np.random.default_rng(seed)
    c = jax_crc(CRC_LEN, CRC_POLY)
    msgs = rng.integers(0, 2, size=(frames, K)).astype(np.int8)
    full = np.concatenate([msgs, np.stack([c.crcCalc(m) for m in msgs]).astype(np.int8)], axis=1)
    x = np.asarray(jax_encode(jnp.asarray(full), mask, GEN, N))
    nv = 1.0 / (2.0 * (K / N) * 10 ** (snr_db / 10.0))
    y = (1.0 - 2.0 * x) + rng.normal(0, np.sqrt(nv), size=x.shape)
    return (4.0 / (2 * nv) * y).astype(np.float32)


@pytest.mark.parametrize("L", [1, 2, 4])
@pytest.mark.parametrize("use_crc", [True, False])
def test_plain_decoder_equals_jax(mask, L, use_crc):
    llr = _frames(mask, seed=L)
    kw = dict(crc_len=CRC_LEN, crc_poly=CRC_POLY) if use_crc else {}
    ref = jax_decode(jnp.asarray(llr), mask, GEN, L, dtype=jnp.float32, **kw)
    out = pac_list_decode_batch(torch.from_numpy(llr), mask, GEN, L, **kw)
    for key in KEYS:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert out["metrics"].dtype == torch.float32


def _golden_cases():
    with np.load(GOLDEN) as g:
        return json.loads(str(g["cases"]))


@pytest.mark.parametrize("case", _golden_cases(), ids=lambda c: c["name"])
def test_plain_decoder_equals_golden(case):
    name = case["name"]
    with np.load(GOLDEN) as g:
        data = {k: g[f"{name}/{k}"] for k in ("llr", "mask", "extracted", "crc_pass", "metrics")}
    rp = rateprofile(case["N"], case["K"] + case["crc_len"], case["design_snr_db"],
                     case["max_row_swaps"])
    rp.build_mask(case["profile"])
    mask = rp.modify_profile()
    np.testing.assert_array_equal(mask, data["mask"])
    out = pac_list_decode_batch(torch.from_numpy(data["llr"]), mask, case["gen"], case["L"],
                                crc_len=case["crc_len"], crc_poly=case["crc_poly"])
    for key in ("extracted", "crc_pass", "metrics"):
        np.testing.assert_array_equal(out[key].numpy(), data[key], err_msg=key)


def test_host_tables_permute_the_check_matrix_to_phase_order(mask):
    sched, out_pos, words = host_tables(mask, CRC_LEN, CRC_POLY)
    perm = pac_mod.bitrev_perm(N)
    info_phases = np.flatnonzero(mask[perm] == 1)
    positions = np.flatnonzero(mask == 1)
    # the bit decided at info phase i lands at its u index's ascending rank
    np.testing.assert_array_equal(positions[out_pos], perm[info_phases])
    Hc = check_matrix(hex((1 << CRC_LEN) | CRC_POLY), KP)
    for i in range(KP):
        col = [(int(words[i]) >> d) & 1 for d in range(CRC_LEN)]
        assert col == list(Hc[:, out_pos[i]])
    assert sched.shape == (N,) and int((sched >> 10 & 1).sum()) == N - KP  # frozen phases
    # 5·32·63 to 16 B, and a ring of 16 trace rows of 32 B: the trace is in global scratch
    assert frame_bytes(64, 32, 32) == 10080 + 16 * 32


def test_wrapper_on_cpu_runs_the_plain_version(mask):
    llr = torch.from_numpy(_frames(mask, seed=7))
    ref = pac_list_decode_batch(llr, mask, GEN, 4, crc_len=CRC_LEN, crc_poly=CRC_POLY)
    out = pac_list_decode_cuda(llr, mask, GEN, 4, CRC_LEN, CRC_POLY)
    assert set(out) == {"extracted", "crc_pass"}
    assert torch.equal(out["extracted"], ref["extracted"])
    assert torch.equal(out["crc_pass"], ref["crc_pass"])
    for backend in ("auto", "xla", "pallas"):  # a CPU tensor runs the plain version
        full = pac_decode(llr, mask, GEN, 4, crc_len=CRC_LEN, crc_poly=CRC_POLY, backend=backend)
        assert set(full) == set(KEYS) | {"best_index"}  # the JAX keys and the selected rank
        for key in KEYS:
            assert torch.equal(full[key], ref[key]), key
    with pytest.raises(ValueError, match="backend"):
        pac_decode(llr, mask, GEN, 4, backend="mosaic")


def test_check_shape_bounds_the_kernel():
    check_shape(64, 32, 32, [1, 0, 1, 1, 0, 1, 1], 0, torch.float32)  # the simulator's stage 2
    check_shape(1024, 512, 32, [1], 16, torch.float32)  # about 160 KB a frame
    check_shape(8192, 8000, 32, [1], 0, torch.float32)  # the trace in global scratch: every Kp
    for N in (16384, 32768, 65536):  # past the TPU kernel's N=8192
        check_shape(N, N // 2, 32, [1], 0, torch.float32)
    for args in ((64, 32, 8193, [1], 0, torch.float32),   # L > 8192
                 (64, 32, 0, [1], 0, torch.float32),
                 (64, 32, 8, [0, 1], 0, torch.float32),  # gen[0] != 1
                 (64, 32, 8, [1] * 33, 0, torch.float32),  # memory 32
                 (64, 32, 8, [1], 33, torch.float32),
                 (64, 32, 8, [1], 0, torch.float64),
                 (131072, 8000, 32, [1], 0, torch.float32)):  # N > 65536
        with pytest.raises(ValueError):
            check_shape(*args)


class _CudaStandIn:
    """What `pac_decode` reads of a CUDA tensor before it touches the card."""

    is_cuda = True
    device = torch.device("cuda")
    dtype = torch.float32
    shape = (4, 64)

    def dim(self):
        return 2

    def is_contiguous(self):
        return True


def test_pac_decode_on_cuda_raises_for_what_the_kernel_does_not_take():
    mask = np.zeros(64, np.int8)
    mask[32:] = 1
    x = _CudaStandIn()
    calls = pac_list_decode_batch.cuda_calls
    with pytest.raises(ValueError, match="list sizes"):
        pac_decode(x, mask, [1, 0, 1, 1, 0, 1, 1], 8193)
    with pytest.raises(ValueError, match="plain decoder runs on CPU"):
        pac_decode(x, mask, [1], 4, backend="xla")
    assert pac_list_decode_batch.cuda_calls == calls  # no fallback to the plain version


# ---- on the card (marker `gpu`; skipped without a CUDA device) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the PAC kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 3, 4, 16, 32])
def test_kernel_matches_plain_on_card(cuda_device, mask, L):
    x = torch.from_numpy(_frames(mask, seed=L, frames=301)).to(cuda_device)  # ragged batch
    out = pac_list_decode_cuda(x, mask, GEN, L, CRC_LEN, CRC_POLY)
    torch.cuda.synchronize()
    ref = pac_list_decode_batch(x, mask, GEN, L, crc_len=CRC_LEN, crc_poly=CRC_POLY)
    assert torch.equal(out["extracted"], ref["extracted"])
    assert torch.equal(out["crc_pass"], ref["crc_pass"])
