"""The port's legacy surface against the JAX package's, on the CPU.

* `rateprofile` masks (bh, dega, pw, rm-polar; row swaps 0 and 3) equal.
* `crc.crcCalc`, per frame and batched, equals the JAX `crclib`.
* `conv_transform_matrix` and `pac_encode_batch` identical.
* The `channel` class: modulation, noise and LLRs (BPSK, QPSK `calc_llr`,
  `calc_llr2`, `calc_llr3`) identical, the port drawing from an explicit
  `RandomState(s)` and JAX's from numpy's global generator after
  `np.random.seed(s)`.
* The OFDM helpers and demo identical.
* The three drivers at the tiny configurations of
  `tests/test_legacy_drivers.py`: the port's results identical to the JAX
  driver's for the same seeds.
* `polar_code_tpu_torch.legacy` imports neither `jax` nor `polar_code_tpu`.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.legacy import channel as jax_channel
from polar_code_tpu.legacy import crc_polar_ofdm_ls as jax_ofdm_ls
from polar_code_tpu.legacy import crc_polar_vs_uncoded as jax_uncoded
from polar_code_tpu.legacy import ofdm_channel_estimation as jax_ofdm
from polar_code_tpu.legacy import simulator as jax_simulator
from polar_code_tpu.legacy.crclib import crc as jax_crc
from polar_code_tpu.legacy.pac import conv_transform_matrix as jax_conv_matrix
from polar_code_tpu.legacy.pac import pac_encode_batch as jax_encode
from polar_code_tpu.legacy.rate_profile import rateprofile as jax_rateprofile
from polar_code_tpu_torch.legacy import channel, crc, rateprofile
from polar_code_tpu_torch.legacy import crc_polar_ofdm_ls, crc_polar_vs_uncoded, simulator
from polar_code_tpu_torch.legacy import ofdm_channel_estimation as ofdm
from polar_code_tpu_torch.legacy.pac import conv_transform_matrix, pac_encode_batch


@pytest.mark.parametrize("profile", ["bh", "dega", "pw", "rm-polar"])
@pytest.mark.parametrize("swaps", [0, 3])
@pytest.mark.parametrize("N,Kp", [(64, 32), (128, 80)])
def test_rate_profile_masks_equal_jax(profile, swaps, N, Kp):
    ours, theirs = rateprofile(N, Kp, 2.0, swaps), jax_rateprofile(N, Kp, 2.0, swaps)
    np.testing.assert_array_equal(ours.build_mask(profile), theirs.build_mask(profile))
    mask = ours.modify_profile()
    np.testing.assert_array_equal(mask, theirs.modify_profile())
    assert int(mask.sum()) == Kp


@pytest.mark.parametrize("crc_len,poly,k", [(8, 0xA6, 12), (16, 0x1021, 64), (12, 0x80F, 33),
                                            (0, 0, 10)])
def test_crc_calc_equals_jax_per_frame_and_batched(crc_len, poly, k):
    msgs = np.random.default_rng(k).integers(0, 2, (20, k)).astype(np.int8)
    ours, theirs = crc(crc_len, poly), jax_crc(crc_len, poly)
    per_frame = [theirs.crcCalc(m) for m in msgs]
    assert [ours.crcCalc(m) for m in msgs] == per_frame
    batched = ours.crcCalc_batch(msgs)
    assert batched.shape == (20, crc_len) and batched.dtype == np.int8
    np.testing.assert_array_equal(batched, np.asarray(per_frame, np.int8).reshape(20, crc_len))


@pytest.mark.parametrize("gen", [(1,), (1, 0, 1, 1), (1, 0, 1, 1, 0, 1, 1)])
@pytest.mark.parametrize("systematic", [False, True])
def test_pac_encoder_equals_jax(gen, systematic):
    N, Kp = 64, 32
    np.testing.assert_array_equal(conv_transform_matrix(gen, N), jax_conv_matrix(gen, N))
    rp = jax_rateprofile(N, Kp, 2.0, 0)
    rp.build_mask("dega")
    mask = rp.modify_profile()
    msgs = np.random.default_rng(len(gen)).integers(0, 2, (16, Kp)).astype(np.int8)
    ours = pac_encode_batch(torch.from_numpy(msgs), mask, gen, N, systematic=systematic)
    theirs = jax_encode(jnp.asarray(msgs), mask, gen, N, systematic=systematic)
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("modu", ["BPSK", "QPSK"])
@pytest.mark.parametrize("snrb_snr", ["SNRb", "SNR"])
def test_channel_equals_jax(modu, snrb_snr):
    bits = np.random.default_rng(3).integers(0, 2, (6, 33)).astype(np.int8)
    ours = channel(modu, 2.5, snrb_snr, 0.5, rng=np.random.RandomState(11))
    theirs = jax_channel(modu, 2.5, snrb_snr, 0.5)
    assert ours.noise_power == theirs.noise_power
    mod = ours.modulate(bits)
    np.testing.assert_array_equal(mod, theirs.modulate(bits))
    np.random.seed(11)
    rx_jax = theirs.add_noise(mod)
    rx = ours.add_noise(mod)
    np.testing.assert_array_equal(rx, rx_jax)
    for fn in ("calc_llr", "calc_llr2", "calc_llr3"):
        np.testing.assert_array_equal(getattr(ours, fn)(rx), getattr(theirs, fn)(rx), err_msg=fn)
    np.testing.assert_array_equal(ours.subconstells, theirs.subconstells)


def test_channels_drawing_in_turn_share_one_generator():
    # the coded and the uncoded arm of crc_polar_vs_uncoded draw in turn
    rng = np.random.RandomState(5)
    a, b = channel("BPSK", 1.0, "SNRb", 0.5, rng=rng), channel("BPSK", 1.0, "SNRb", 1.0, rng=rng)
    x = np.ones((4, 8))
    np.random.seed(5)
    ja, jb = jax_channel("BPSK", 1.0, "SNRb", 0.5), jax_channel("BPSK", 1.0, "SNRb", 1.0)
    expected = [ja.add_noise(x), jb.add_noise(x), ja.add_noise(x)]
    for got, want in zip([a.add_noise(x), b.add_noise(x), a.add_noise(x)], expected):
        np.testing.assert_array_equal(got, want)


def test_ofdm_helpers_and_demo_equal_jax():
    for mod in (ofdm, jax_ofdm):
        assert mod.OFDMSimulationConfig(num_subcarriers=30, pilot_spacing=4).pilot_indices()[-1] == 29
    H = ofdm.rayleigh_frequency_response(32, 4, np.random.default_rng(1), count=5)
    np.testing.assert_array_equal(
        H, jax_ofdm.rayleigh_frequency_response(32, 4, np.random.default_rng(1), count=5))
    tx = np.random.default_rng(2).choice([-1.0, 1.0], (5, 32)).astype(np.complex128)
    pilots = np.array([0, 8, 16, 24, 31])
    np.testing.assert_array_equal(ofdm.ls_channel_estimate(tx, H * tx, pilots),
                                  jax_ofdm.ls_channel_estimate(tx, H * tx, pilots))
    cfg = dict(num_ofdm_symbols=100, seed=0)
    assert ofdm.simulate(ofdm.OFDMSimulationConfig(**cfg)) == \
        jax_ofdm.simulate(jax_ofdm.OFDMSimulationConfig(**cfg))


# ---- the drivers, at the tiny configurations of tests/test_legacy_drivers.py ----

def test_simulator_equals_jax(tmp_path, capsys):
    kw = dict(N=32, R=0.5, crc_len=8, crc_poly=0xA6, list_size=1, list_size_max=2,
              conv_gen=[1, 0, 1, 1], snr_range=[4.0], err_cnt=5, max_frames=64, batch=32, seed=0)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    np.random.seed(0)
    theirs = jax_simulator.run(jax_simulator.LegacySimConfig(**kw), out_dir=str(tmp_path / "jax"))
    jax_out = capsys.readouterr().out
    ours = simulator.run(simulator.LegacySimConfig(**kw), out_dir=str(tmp_path / "port"),
                         device="cpu")
    port_out = capsys.readouterr().out
    assert (ours.snr_range, ours.ber, ours.fer, ours.fname, ours.label) == \
        (theirs.snr_range, theirs.ber, theirs.fer, theirs.fname, theirs.label)
    assert port_out.splitlines()[0] == jax_out.splitlines()[0]  # "@ 4.0 dB FER is … (N frames)"
    csv = f"{ours.fname}.csv"
    assert (tmp_path / "port" / csv).read_text() == (tmp_path / "jax" / csv).read_text()


def test_crc_polar_vs_uncoded_equals_jax():
    kw = dict(n=32, k_info=16, crc_length=8, crc_poly=0xA6, list_size=2, snr_points=(3.0,),
              target_frame_errors=5, max_frames=64, batch=32, seed=0, plot_results=False)
    np.random.seed(0)
    theirs = jax_uncoded.simulate(jax_uncoded.SimulationConfig(**kw))
    ours = crc_polar_vs_uncoded.simulate(crc_polar_vs_uncoded.SimulationConfig(**kw), device="cpu")
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in theirs]
    assert crc_polar_vs_uncoded._format_results(ours) == jax_uncoded._format_results(theirs)


def test_crc_polar_ofdm_ls_equals_jax():
    kw = dict(n=32, k_info=16, crc_length=8, crc_poly=0xA6, list_size=2, snr_points=(12.0,),
              target_frame_errors=5, max_frames=32, num_subcarriers=32, pilot_spacing=4,
              channel_taps=4, batch=16, seed=0, plot_results=False)
    theirs = jax_ofdm_ls.simulate(jax_ofdm_ls.SimulationConfig(**kw))
    ours = crc_polar_ofdm_ls.simulate(crc_polar_ofdm_ls.SimulationConfig(**kw), device="cpu")
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in theirs]
    assert crc_polar_ofdm_ls._format_results(ours) == jax_ofdm_ls._format_results(theirs)


def test_drivers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulator.run(simulator.LegacySimConfig(snr_range=[4.0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        crc_polar_vs_uncoded.simulate(crc_polar_vs_uncoded.SimulationConfig(snr_points=(3.0,)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        crc_polar_ofdm_ls.simulate(crc_polar_ofdm_ls.SimulationConfig(snr_points=(3.0,)))


def test_legacy_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import polar_code_tpu_torch.legacy as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'polar_code_tpu.'))"
        " or m == 'polar_code_tpu']\n"
        "assert len(names) >= 9, names\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
