"""OFDM least-squares channel-estimation demo (port of
`polar_code_tpu/legacy/ofdm_channel_estimation.py`, host-side NumPy, copied).

BPSK symbols on a comb-pilot OFDM grid, a frequency-selective Rayleigh
channel drawn as the FFT of i.i.d. complex-Gaussian taps, LS estimation at
the pilots with linear interpolation across the band, then one-tap
equalization.  Returns ``(channel MSE, BER)``.

Batch-first: linear interpolation is a fixed linear map from pilot
estimates to the full band, so the whole Monte-Carlo is a handful of
[S, N] array ops and one ``[S, P] @ [P, N]`` product.  The batched helpers
(`rayleigh_frequency_response`, `ls_channel_estimate`) also feed the coded
pipeline in `crc_polar_ofdm_ls.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class OFDMSimulationConfig:
    num_subcarriers: int = 64
    pilot_spacing: int = 4
    num_ofdm_symbols: int = 1000
    snr_db: float = 15.0
    channel_taps: int = 8
    seed: int | None = 0

    def pilot_indices(self) -> np.ndarray:
        """Comb pattern: every ``pilot_spacing``-th carrier, and always the
        band edge so interpolation never extrapolates."""
        comb = np.arange(0, self.num_subcarriers, self.pilot_spacing)
        last = self.num_subcarriers - 1
        return comb if comb[-1] == last else np.append(comb, last)


CONFIG = OFDMSimulationConfig()


def generate_bpsk_symbols(size, rng: np.random.Generator) -> np.ndarray:
    return 1 - 2 * rng.integers(0, 2, size=size)


def rayleigh_frequency_response(
    num_subcarriers: int, channel_taps: int, rng: np.random.Generator, count: int = 1
) -> np.ndarray:
    """Draw ``count`` independent frequency responses, [count, N] complex.

    Unit-average-power Rayleigh taps (variance 1/(2·taps) per real
    component per tap), zero-padded to the band and DFT'd.
    """
    scale = np.sqrt(2.0 * channel_taps)
    taps = rng.normal(size=(count, channel_taps)) / scale
    taps = taps + 1j * (rng.normal(size=(count, channel_taps)) / scale)
    return np.fft.fft(taps, n=num_subcarriers, axis=-1)


def add_awgn(signal: np.ndarray, snr_db: float, rng: np.random.Generator) -> np.ndarray:
    """Complex AWGN scaled to the measured per-symbol energy (last axis)."""
    n0 = np.mean(np.abs(signal) ** 2, axis=-1, keepdims=True) * 10.0 ** (-snr_db / 10.0)
    w = rng.normal(size=signal.shape) + 1j * rng.normal(size=signal.shape)
    return signal + w * np.sqrt(n0 / 2.0)


def _interp_matrix(pilot_indices: np.ndarray, num_subcarriers: int) -> np.ndarray:
    """[P, N] linear map: ``H_full = pilot_values @ W``.

    Row weights are the hat functions of piecewise-linear interpolation on
    the pilot grid, so a batch of pilot estimates interpolates across the
    band in one matmul instead of per-symbol `np.interp` calls.
    """
    p = np.asarray(pilot_indices, dtype=np.float64)
    carriers = np.arange(num_subcarriers, dtype=np.float64)
    # segment j covers [p_j, p_{j+1}]; searchsorted gives the right endpoint
    hi = np.clip(np.searchsorted(p, carriers, side="left"), 1, p.size - 1)
    lo = hi - 1
    frac = (carriers - p[lo]) / (p[hi] - p[lo])
    # carriers sitting exactly on a pilot get weight 1 there
    w = np.zeros((p.size, num_subcarriers))
    cols = np.arange(num_subcarriers)
    np.add.at(w, (lo, cols), 1.0 - frac)
    np.add.at(w, (hi, cols), frac)
    return w


def ls_channel_estimate(
    transmitted: np.ndarray, received: np.ndarray, pilot_indices: np.ndarray
) -> np.ndarray:
    """LS pilot division + linear interpolation; accepts [N] or [S, N]."""
    tx_p = transmitted[..., pilot_indices]
    rx_p = received[..., pilot_indices]
    tiny = np.abs(tx_p) < 1e-12
    at_pilots = rx_p / np.where(tiny, 1e-12, tx_p)
    return at_pilots @ _interp_matrix(pilot_indices, transmitted.shape[-1])


def simulate(config: OFDMSimulationConfig) -> tuple:
    """One vectorized Monte-Carlo pass; returns (channel MSE, BER)."""
    if config.num_subcarriers < 2:
        raise ValueError("num_subcarriers must be at least 2")
    if config.pilot_spacing < 1:
        raise ValueError("pilot_spacing must be positive")

    rng = np.random.default_rng(config.seed)
    pilots = config.pilot_indices()
    shape = (config.num_ofdm_symbols, config.num_subcarriers)

    # data everywhere, then overwrite the pilot carriers (both BPSK, drawn
    # in the same order as the reference: data grid first, pilots second)
    tx = generate_bpsk_symbols(shape, rng).astype(np.complex128)
    tx[:, pilots] = generate_bpsk_symbols((shape[0], pilots.size), rng)

    channel = rayleigh_frequency_response(
        config.num_subcarriers, config.channel_taps, rng, count=shape[0]
    )
    rx = add_awgn(channel * tx, config.snr_db, rng)

    estimate = ls_channel_estimate(tx, rx, pilots)
    mse = float(np.mean(np.abs(estimate - channel) ** 2))

    guarded = np.where(np.abs(estimate) < 1e-12, 1e-12, estimate)
    hard = np.sign((rx / guarded).real) < 0
    ber = float(np.mean(hard != (tx.real < 0)))
    return mse, ber


def main(config: OFDMSimulationConfig = CONFIG) -> None:
    channel_mse, ber = simulate(config)
    print("OFDM LS Channel Estimation Results")
    print(f"  Num subcarriers       : {config.num_subcarriers}")
    print(f"  Pilot spacing         : {config.pilot_spacing}")
    print(f"  OFDM symbols simulated: {config.num_ofdm_symbols}")
    print(f"  SNR (dB)              : {config.snr_db}")
    print(f"  Channel taps          : {config.channel_taps}")
    print(f"  Average channel MSE   : {channel_mse:.4e}")
    print(f"  Bit error rate        : {ber:.4e}")


if __name__ == "__main__":
    main()
