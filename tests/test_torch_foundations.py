"""The port's host tables and tensor primitives against the JAX package's.

Info sets, frozen masks, CRC matrices, CRC attach/check, the polar encoder,
BPSK, noise variances, the SCL schedule tables, f/g and the β module must
equal the JAX package's element for element on shared numpy inputs; the
AWGN LLRs are checked by their moments, since torch cannot reproduce
threefry's draws.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polar_code_tpu.channel as jax_channel
import polar_code_tpu.config as jax_config
import polar_code_tpu.ops.crc as jax_crc
import polar_code_tpu.polar.construct as jax_construct
from polar_code_tpu.dlscl.beta import SymmetricBeta as JaxBeta
from polar_code_tpu.ops.backend import stable_partition_perm as jax_partition
from polar_code_tpu.ops.polar_transform import encode_batch as jax_encode
from polar_code_tpu.ops.sc import f_minsum as jax_f, g_update as jax_g
from polar_code_tpu.ops.scl_pallas import _schedule_tables as jax_schedule
from polar_code_tpu_torch import channel, config, interop
from polar_code_tpu_torch.ops import crc
from polar_code_tpu_torch.ops.backend import (
    auto_compact_capacity,
    resolve_backend,
    stable_partition_perm,
)
from polar_code_tpu_torch.ops.polar_transform import encode_batch
from polar_code_tpu_torch.ops.sc import f_minsum, g_update
from polar_code_tpu_torch.ops.scl_schedule import schedule_tables
from polar_code_tpu_torch.polar import construct
from polar_code_tpu_torch.utils.device import resolve_device
from polar_code_tpu_torch.utils.seeding import fold_seed, make_generator

CRC = "0x1864CFB"


@pytest.mark.parametrize("N", [128, 512])
@pytest.mark.parametrize("method", ["gaussian", "gaussian_bitrev", "polarization"])
def test_info_set_and_frozen_mask_equal_jax(N, method):
    ours = construct.construct_info_set(N, N // 2, method=method)
    ref = jax_construct.construct_info_set(N, N // 2, method=method)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(construct.frozen_mask(N, ours), jax_construct.frozen_mask(N, ref))
    np.testing.assert_array_equal(
        construct.bit_reversal_permutation(N), jax_construct.bit_reversal_permutation(N)
    )


def test_config_equals_jax():
    assert config.get_config() == config.PolarConfig(**vars(jax_config.get_config()))
    for N, K in [(128, 24), (100, 64), (64, 64)]:
        with pytest.raises(ValueError):
            config.validate_code_shape(N, K, 24)
        with pytest.raises(ValueError):
            jax_config.validate_code_shape(N, K, 24)
    config.validate_code_shape(128, 64, 24)


@pytest.mark.parametrize("poly,length", [(CRC, 64), (CRC, 128), ("0x17", 12)])
def test_crc_matrices_equal_jax(poly, length):
    np.testing.assert_array_equal(
        crc.generator_matrix(poly, length - crc.crc_degree(poly)),
        jax_crc.generator_matrix(poly, length - jax_crc.crc_degree(poly)),
    )
    np.testing.assert_array_equal(crc.check_matrix(poly, length), jax_crc.check_matrix(poly, length))


def test_crc_attach_and_check_equal_jax():
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 2, (64, 40)).astype(np.int8)
    ours = crc.attach_crc_batch(torch.from_numpy(payload), CRC)
    ref = np.asarray(jax_crc.attach_crc_batch(jnp.asarray(payload), CRC))
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert ours.dtype == torch.int8
    corrupt = ref.copy()
    corrupt[::3, 5] ^= 1
    np.testing.assert_array_equal(
        crc.check_crc_batch(torch.from_numpy(corrupt), CRC).numpy(),
        np.asarray(jax_crc.check_crc_batch(jnp.asarray(corrupt), CRC)),
    )
    assert crc.check_crc_batch(ours, CRC).all()


@pytest.mark.parametrize("N", [128, 512])
def test_encode_equals_jax(N):
    info = construct.construct_info_set(N, N // 2)
    msgs = np.random.default_rng(N).integers(0, 2, (32, N // 2)).astype(np.int8)
    np.testing.assert_array_equal(
        encode_batch(torch.from_numpy(msgs), info, N).numpy(),
        np.asarray(jax_encode(jnp.asarray(msgs), info, N)),
    )


def test_bpsk_and_noise_variances_equal_jax():
    bits = np.random.default_rng(1).integers(0, 2, (8, 16)).astype(np.int8)
    np.testing.assert_array_equal(
        channel.bpsk(torch.from_numpy(bits)).numpy(),
        np.asarray(jax_channel.bpsk(jnp.asarray(bits))).astype(np.float32),
    )
    for snr in (0.0, 2.5, 4.0, 5.0, 6.5):
        assert channel.noise_var_coded(snr, 64, 128) == jax_channel.noise_var_coded(snr, 64, 128)
        assert channel.noise_var_uncoded(snr) == jax_channel.noise_var_uncoded(snr)


def test_awgn_llr_moments():
    nv = channel.noise_var_coded(3.0, 64, 128)
    sym = channel.bpsk(torch.zeros((2048, 128), dtype=torch.int8))
    llr = channel.awgn_llr(make_generator(0, 30, 0, 1), sym, nv)
    assert llr.dtype == torch.float32 and llr.shape == sym.shape
    x = llr.double().numpy().ravel()
    # LLR of +1 over AWGN: mean 2/σ², variance 4/σ²; standard errors ≈ 1e-3 relative
    assert abs(x.mean() / (2.0 / nv) - 1.0) < 0.01
    assert abs(x.var() / (4.0 / nv) - 1.0) < 0.02
    assert abs(float(((x - x.mean()) ** 3).mean()) / x.std() ** 3) < 0.05


def test_generators_depend_only_on_their_tags():
    a = torch.randn(8, generator=make_generator(7, 40, 3, 1))
    b = torch.randn(8, generator=make_generator(7, 40, 3, 1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    seeds = {fold_seed(7, 40, c, s) for c in range(50) for s in range(3)}
    assert len(seeds) == 150 and all(0 <= x < 2**63 for x in seeds)
    assert fold_seed(7, 40, 3) != fold_seed(7, 3, 40)


@pytest.mark.parametrize("N", [128, 512])
def test_schedule_tables_equal_jax(N):
    info = construct.construct_info_set(N, N // 2)
    ours = schedule_tables(N, info)
    ref = jax_schedule(N, info)[:7]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_f_and_g_equal_jax():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(2, 1000))
    a[:10] = 0.0
    c = rng.integers(0, 2, 1000).astype(np.int8)
    np.testing.assert_array_equal(
        f_minsum(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_f(jnp.asarray(a), jnp.asarray(b))),
    )
    np.testing.assert_array_equal(
        g_update(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy(),
        np.asarray(jax_g(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))),
    )


@pytest.mark.parametrize("M", [2, 8])
def test_beta_round_trip_and_forward_equal_jax(M, tmp_path):
    arr = np.load(f"checkpoints/beta_M{M}.npy")
    module = interop.beta_from_numpy(arr)
    np.testing.assert_array_equal(interop.beta_to_numpy(module), arr)
    path = tmp_path / "beta.npy"
    np.save(path, interop.beta_to_numpy(interop.load_beta(f"checkpoints/beta_M{M}.npy")))
    np.testing.assert_array_equal(np.load(path), arr)  # written back byte-compatible
    abs_l0 = np.abs(np.random.default_rng(M).normal(size=(16, 64))).astype(np.float32)
    params = {"off_diag": jnp.asarray(arr * (1 - np.eye(64, dtype=np.float32)))}
    ref = np.asarray(JaxBeta(64).apply(params, jnp.asarray(abs_l0)))
    np.testing.assert_allclose(module(torch.from_numpy(abs_l0)).detach().numpy(), ref,
                               rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError):
        interop.beta_from_numpy(arr + np.triu(np.ones_like(arr), 1))  # not symmetric


def test_stable_partition_perm_equals_jax_and_argsort():
    rng = np.random.default_rng(3)
    for size in (1, 7, 128, 1000):
        mask = rng.random(size) < 0.3
        ours = stable_partition_perm(torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(ours, np.argsort(mask, kind="stable"))
        np.testing.assert_array_equal(ours, np.asarray(jax_partition(jnp.asarray(mask))))


def test_routing_follows_the_device():
    assert resolve_backend(torch.device("cpu"), M=8, dtype=torch.float64, N=128, K=64) == "plain"
    with pytest.raises(ValueError):  # the kernel shape gate applies on the card
        resolve_backend(torch.device("cuda"), M=65537, dtype=torch.float32, N=128, K=64)
    assert auto_compact_capacity(-1, 4096, "cuda") == 4096
    assert auto_compact_capacity(-1, 128, "cuda") == 0
    assert auto_compact_capacity(-1, 4096, "cpu") == 0
    assert auto_compact_capacity(0, 4096, "cuda") == 0
    assert auto_compact_capacity(300, 256, "cpu") == 256


def test_entry_points_raise_without_a_card():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import polar_code_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'polar_code_tpu.'))"
        " or m == 'polar_code_tpu']\n"
        "assert len(names) >= 20, names\n"
        "new = {'polar_code_tpu_torch.train.make_dataset', 'polar_code_tpu_torch.train.train_beta',"
        " 'polar_code_tpu_torch.eval.opcount', 'polar_code_tpu_torch.polar.api',"
        " 'polar_code_tpu_torch.legacy.polar_code', 'polar_code_tpu_torch.legacy.functions',"
        " 'polar_code_tpu_torch.legacy.exceptions'}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_and_chip_smoke_name_no_jax_import():
    import ast
    from pathlib import Path

    files = sorted(Path("polar_code_tpu_torch").rglob("*.py")) + [Path("chip_smoke.py")]
    for name in ("train/make_dataset.py", "train/train_beta.py", "eval/opcount.py"):
        assert Path("polar_code_tpu_torch", name) in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "polar_code_tpu"), f"{path}: {name}"
