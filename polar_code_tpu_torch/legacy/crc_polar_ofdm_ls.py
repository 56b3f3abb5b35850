"""CRC-polar over OFDM with LS estimation vs perfect CSI (port of
`polar_code_tpu/legacy/crc_polar_ofdm_ls.py`).

Maps a CRC-polar codeword onto the data subcarriers of consecutive OFDM
symbols over a Rayleigh frequency-selective channel, decodes with
LS-estimated vs perfect channel equalization, and reports per-SNR
FER/BER/MSE.

Frames run in batches: the OFDM/LS math is vectorized host NumPy over
[frames, symbols, subcarriers] in float64, drawn from one
``default_rng(config.seed)`` as in the JAX driver, and both LLR streams
decode on `device` in float32 through `pac_decode` (on the card, the CUDA
kernel), one call each.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from typing import Iterable, List, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .crclib import crc
from .ofdm_channel_estimation import (
    ls_channel_estimate,
    rayleigh_frequency_response,
)
from .pac import pac_decode, pac_encode_batch
from .rate_profile import rateprofile

DEFAULT_SNR_POINTS = tuple(float(f"{x:.1f}") for x in np.arange(-2.0, 6.5, 0.5))


@dataclass
class SimulationResult:
    snr_db: float
    ls_ber: float
    ls_fer: float
    perfect_ber: float
    perfect_fer: float
    avg_channel_mse: float
    frames_run: int


@dataclass
class SimulationConfig:
    n: int = 128
    k_info: int = 64
    crc_length: int = 16
    crc_poly: int = 0x1021
    list_size: int = 16
    design_snr_db: float = 2.0
    profile_name: str = "dega"
    snr_points: Sequence[float] = field(default_factory=lambda: DEFAULT_SNR_POINTS)
    target_frame_errors: int = 30
    max_frames: int = 5000
    min_frames_per_snr: int = 50
    stop_when_error_free: bool = True
    seed: int | None = None
    num_subcarriers: int = 128
    pilot_spacing: int = 8
    channel_taps: int = 8
    ofdm_symbols_per_frame: int | None = None
    pilot_value: complex = 1 + 0j
    batch: int = 64
    plot_results: bool = True
    plot_file: str | None = None


CONFIG = SimulationConfig()


def _pilot_indices(num_subcarriers: int, spacing: int) -> np.ndarray:
    if num_subcarriers < 2:
        raise ValueError("num_subcarriers must be at least 2")
    if spacing < 1:
        raise ValueError("pilot_spacing must be positive")
    pilots = np.arange(0, num_subcarriers, spacing)
    if pilots[-1] != num_subcarriers - 1:
        pilots = np.append(pilots, num_subcarriers - 1)
    return pilots


def _compute_bpsk_llr(equalized, channel_mag_sq, noise_variance):
    safe_noise = np.maximum(noise_variance, 1e-12)
    safe_mag = np.maximum(channel_mag_sq, 1e-12)
    return 4.0 * equalized.real * (safe_mag / safe_noise)


def simulate(config: SimulationConfig, *, device="cuda") -> List[SimulationResult]:
    dev = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    non_frozen = config.k_info + config.crc_length
    if non_frozen > config.n:
        raise ValueError("k_info + crc_length must not exceed n")
    if config.min_frames_per_snr < 1:
        raise ValueError("min_frames_per_snr must be at least 1")

    rprofile = rateprofile(config.n, non_frozen, config.design_snr_db, 0)
    mask = rprofile.build_mask(config.profile_name)
    mask = rprofile.modify_profile()
    crc_obj = crc(config.crc_length, config.crc_poly) if config.crc_length > 0 else None

    pilots = _pilot_indices(config.num_subcarriers, config.pilot_spacing)
    data_idx = np.setdiff1d(np.arange(config.num_subcarriers), pilots)
    if data_idx.size == 0:
        raise ValueError("No data subcarriers remain after placing pilots")
    min_symbols = int(np.ceil(config.n / data_idx.size))
    num_symbols = config.ofdm_symbols_per_frame or min_symbols
    if num_symbols < min_symbols:
        raise ValueError("ofdm_symbols_per_frame is insufficient for the block length")

    results: List[SimulationResult] = []
    for snr in config.snr_points:
        snr_linear = 10 ** (snr / 10.0)
        ls_bit = ls_frame = perf_bit = perf_frame = 0
        bits_total = frames = 0
        mse_accum = 0.0
        mse_samples = 0

        while frames < config.max_frames and ls_frame < config.target_frame_errors:
            B = min(config.batch, config.max_frames - frames)
            info = rng.integers(0, 2, size=(B, config.k_info)).astype(np.int8)
            if crc_obj is not None:
                messages = np.concatenate([info, crc_obj.crcCalc_batch(info)], axis=1)
            else:
                messages = info
            codewords = pac_encode_batch(
                torch.as_tensor(messages, device=dev), mask, [1], config.n
            ).cpu().numpy()

            # map coded bits onto [B, num_symbols, N_sc] OFDM grids
            tx = np.full(
                (B, num_symbols, config.num_subcarriers),
                config.pilot_value, dtype=np.complex128,
            )
            flat_caps = num_symbols * data_idx.size
            padded = np.ones((B, flat_caps))
            padded[:, : config.n] = 1.0 - 2.0 * codewords
            data_grid = padded.reshape(B, num_symbols, data_idx.size)
            tx[:, :, data_idx] = data_grid

            H = rayleigh_frequency_response(
                config.num_subcarriers, config.channel_taps, rng, count=B * num_symbols
            ).reshape(B, num_symbols, config.num_subcarriers)
            noiseless = H * tx
            sym_energy = np.mean(np.abs(noiseless) ** 2, axis=-1, keepdims=True)
            noise_var = sym_energy / snr_linear
            noise = (
                rng.normal(size=noiseless.shape) + 1j * rng.normal(size=noiseless.shape)
            ) * np.sqrt(noise_var / 2.0)
            rx = noiseless + noise

            safe_h = np.where(np.abs(H) < 1e-12, 1e-12, H)
            perf_eq = rx / safe_h
            perf_mag = np.abs(safe_h) ** 2

            H_est = ls_channel_estimate(
                tx.reshape(-1, config.num_subcarriers),
                rx.reshape(-1, config.num_subcarriers),
                pilots,
            ).reshape(B, num_symbols, config.num_subcarriers)
            mse_accum += float(np.mean(np.abs(H_est - H) ** 2)) * B * num_symbols
            mse_samples += B * num_symbols
            safe_est = np.where(np.abs(H_est) < 1e-12, 1e-12, H_est)
            ls_eq = rx / safe_est
            ls_mag = np.abs(safe_est) ** 2

            perf_llr = _compute_bpsk_llr(
                perf_eq[:, :, data_idx], perf_mag[:, :, data_idx], noise_var
            ).reshape(B, flat_caps)[:, : config.n]
            ls_llr = _compute_bpsk_llr(
                ls_eq[:, :, data_idx], ls_mag[:, :, data_idx], noise_var
            ).reshape(B, flat_caps)[:, : config.n]

            kw = dict(
                crc_len=config.crc_length if crc_obj is not None else 0,
                crc_poly=config.crc_poly,
            )
            def decode(llr):
                x = torch.as_tensor(np.ascontiguousarray(llr, dtype=np.float32), device=dev)
                return pac_decode(x, mask, [1], config.list_size, **kw)["extracted"].cpu().numpy()

            ls_dec = decode(ls_llr)
            perf_dec = decode(perf_llr)

            ls_errs = (ls_dec != messages).sum(axis=1)
            perf_errs = (perf_dec != messages).sum(axis=1)
            ls_bit += int(ls_errs.sum())
            ls_frame += int((ls_errs > 0).sum())
            perf_bit += int(perf_errs.sum())
            perf_frame += int((perf_errs > 0).sum())
            bits_total += messages.size
            frames += B

            if (
                config.stop_when_error_free
                and frames >= config.min_frames_per_snr
                and ls_frame == 0
                and perf_frame == 0
            ):
                break

        results.append(SimulationResult(
            snr_db=float(snr),
            ls_ber=ls_bit / bits_total if bits_total else 0.0,
            ls_fer=ls_frame / frames if frames else 0.0,
            perfect_ber=perf_bit / bits_total if bits_total else 0.0,
            perfect_fer=perf_frame / frames if frames else 0.0,
            avg_channel_mse=mse_accum / mse_samples if mse_samples else 0.0,
            frames_run=frames,
        ))
    return results


def _format_results(results: Iterable[SimulationResult]) -> str:
    header = (
        "SNR (dB) |   LS BER  |   LS FER  | Perfect BER | Perfect FER | Channel MSE | Frames\n"
        "---------+-----------+-----------+-------------+-------------+-------------+-------"
    )
    rows = [
        f"{r.snr_db:8.2f} | {r.ls_ber:9.3e} | {r.ls_fer:9.3e} | "
        f"{r.perfect_ber:11.3e} | {r.perfect_fer:11.3e} | {r.avg_channel_mse:11.3e} | {r.frames_run:6d}"
        for r in results
    ]
    return "\n".join([header, *rows])


def _plot_results(results: Sequence[SimulationResult], save_path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    snr = [r.snr_db for r in results]

    def safe(vals):
        return np.maximum(np.asarray(vals, dtype=float), 1e-12)

    fig, axes = plt.subplots(1, 2, figsize=(12, 5), sharex=True)
    axes[0].semilogy(snr, safe([r.ls_ber for r in results]), marker="o", label="LS BER")
    axes[0].semilogy(snr, safe([r.perfect_ber for r in results]), marker="s", label="Perfect-CSI BER")
    axes[0].set_xlabel("SNR (dB)")
    axes[0].set_ylabel("Bit Error Rate")
    axes[0].grid(True, which="both", linestyle="--", alpha=0.6)
    axes[0].legend()
    axes[1].semilogy(snr, safe([r.ls_fer for r in results]), marker="o", label="LS FER")
    axes[1].semilogy(snr, safe([r.perfect_fer for r in results]), marker="s", label="Perfect-CSI FER")
    axes[1].set_xlabel("SNR (dB)")
    axes[1].set_ylabel("Frame Error Rate")
    axes[1].grid(True, which="both", linestyle="--", alpha=0.6)
    axes[1].legend()
    fig.suptitle("CRC-Polar over OFDM: LS estimation vs perfect CSI")
    fig.tight_layout(rect=(0, 0, 1, 0.95))
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)


def main(config: SimulationConfig = CONFIG, *, device="cuda") -> None:
    results = simulate(config, device=device)
    print(_format_results(results))
    if config.plot_results and config.plot_file:
        if importlib.util.find_spec("matplotlib") is None:
            print("Skipped plot: matplotlib is not installed")
        else:
            _plot_results(results, save_path=config.plot_file)


if __name__ == "__main__":
    main()
