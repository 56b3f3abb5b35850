"""CRC-aided polar vs uncoded BPSK study (port of
`polar_code_tpu/legacy/crc_polar_vs_uncoded.py`).

Config-dataclass-driven (no CLI), same metrics and stopping rules: per-SNR
loop until `target_frame_errors` coded frame errors or `max_frames`,
`min_frames_per_snr`, optional early stop when error-free; prints the same
summary table and, where matplotlib is installed, renders the dual BER/FER
plot.

Frames run in batches through the PAC list decoder with conv_gen=[1]
(plain CRC-aided SCL in the legacy hard-metric formulation): on `device`,
the CUDA kernel.  Messages come from ``default_rng(config.seed)``; the coded
and the uncoded arm draw their noise in turn from one
``RandomState(config.seed)``, which is the JAX driver's global-generator
stream after ``np.random.seed(config.seed)``.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from typing import Iterable, List, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .channel import channel
from .crclib import crc
from .pac import pac_decode, pac_encode_batch
from .rate_profile import rateprofile

DEFAULT_SNR_POINTS = tuple(float(f"{x:.1f}") for x in np.arange(-2.0, 6.5, 0.5))


@dataclass
class SimulationResult:
    snr_db: float
    coded_ber: float
    coded_fer: float
    uncoded_ber: float
    uncoded_fer: float
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
    batch: int = 128
    plot_results: bool = True
    plot_file: str | None = None


CONFIG = SimulationConfig()


def simulate(config: SimulationConfig, *, device="cuda") -> List[SimulationResult]:
    dev = resolve_device(device)
    noise_rng = np.random.RandomState(config.seed)  # both arms draw from it in turn
    rng = np.random.default_rng(config.seed)
    if config.min_frames_per_snr < 1:
        raise ValueError("min_frames_per_snr must be at least 1")

    non_frozen = config.k_info + config.crc_length
    rate = config.k_info / config.n
    rprofile = rateprofile(config.n, non_frozen, config.design_snr_db, 0)
    mask = rprofile.build_mask(config.profile_name)
    mask = rprofile.modify_profile()
    crc_obj = crc(config.crc_length, config.crc_poly) if config.crc_length > 0 else None

    results: List[SimulationResult] = []
    for snr in config.snr_points:
        ch_coded = channel("BPSK", snr, "SNRb", rate if rate > 0 else 1.0, rng=noise_rng)
        ch_uncoded = channel("BPSK", snr, "SNRb", 1.0, rng=noise_rng)

        coded_bit_errors = coded_frame_errors = 0
        uncoded_bit_errors = uncoded_frame_errors = 0
        coded_bits_total = uncoded_bits_total = 0
        frames = 0

        while frames < config.max_frames and coded_frame_errors < config.target_frame_errors:
            B = min(config.batch, config.max_frames - frames)
            info = rng.integers(0, 2, size=(B, config.k_info)).astype(np.int8)
            if crc_obj is not None:
                messages = np.concatenate([info, crc_obj.crcCalc_batch(info)], axis=1)
            else:
                messages = info

            codewords = pac_encode_batch(
                torch.as_tensor(messages, device=dev), mask, [1], config.n
            ).cpu().numpy()
            noisy = ch_coded.add_noise(ch_coded.modulate(codewords))
            llr = ch_coded.calc_llr3(noisy)
            res = pac_decode(
                torch.as_tensor(llr.astype(np.float32), device=dev), mask, [1], config.list_size,
                crc_len=config.crc_length if crc_obj is not None else 0,
                crc_poly=config.crc_poly,
            )
            decoded = res["extracted"].cpu().numpy()
            errs = (decoded != messages).sum(axis=1)
            coded_bit_errors += int(errs.sum())
            coded_frame_errors += int((errs > 0).sum())
            coded_bits_total += messages.size

            unc_noisy = ch_uncoded.add_noise(ch_uncoded.modulate(info))
            hard = (unc_noisy < 0).astype(np.int8)
            uerrs = (hard != info).sum(axis=1)
            uncoded_bit_errors += int(uerrs.sum())
            uncoded_frame_errors += int((uerrs > 0).sum())
            uncoded_bits_total += info.size

            frames += B
            if (
                config.stop_when_error_free
                and frames >= config.min_frames_per_snr
                and coded_frame_errors == 0
                and uncoded_frame_errors == 0
            ):
                break

        results.append(SimulationResult(
            snr_db=float(snr),
            coded_ber=coded_bit_errors / coded_bits_total if coded_bits_total else 0.0,
            coded_fer=coded_frame_errors / frames if frames else 0.0,
            uncoded_ber=uncoded_bit_errors / uncoded_bits_total if uncoded_bits_total else 0.0,
            uncoded_fer=uncoded_frame_errors / frames if frames else 0.0,
            frames_run=frames,
        ))
    return results


def _format_results(results: Iterable[SimulationResult]) -> str:
    header = (
        "SNR (dB) | Coded BER | Coded FER | Uncoded BER | Uncoded FER | Frames\n"
        "---------+-----------+-----------+-------------+-------------+-------"
    )
    rows = [
        f"{res.snr_db:8.2f} | {res.coded_ber:9.3e} | {res.coded_fer:9.3e} | "
        f"{res.uncoded_ber:11.3e} | {res.uncoded_fer:11.3e} | {res.frames_run:6d}"
        for res in results
    ]
    return "\n".join([header, *rows])


def _plot_results(results: Sequence[SimulationResult], save_path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    snr = [res.snr_db for res in results]

    def safe(vals):
        return np.maximum(np.asarray(vals, dtype=float), 1e-12)

    fig, axes = plt.subplots(1, 2, figsize=(12, 5), sharex=True)
    axes[0].semilogy(snr, safe([r.coded_ber for r in results]), marker="o", label="Coded BER")
    axes[0].semilogy(snr, safe([r.uncoded_ber for r in results]), marker="s", label="Uncoded BER")
    axes[0].set_xlabel("SNR (dB)")
    axes[0].set_ylabel("Bit Error Rate")
    axes[0].grid(True, which="both", linestyle="--", alpha=0.6)
    axes[0].legend()
    axes[1].semilogy(snr, safe([r.coded_fer for r in results]), marker="o", label="Coded FER")
    axes[1].semilogy(snr, safe([r.uncoded_fer for r in results]), marker="s", label="Uncoded FER")
    axes[1].set_xlabel("SNR (dB)")
    axes[1].set_ylabel("Frame Error Rate")
    axes[1].grid(True, which="both", linestyle="--", alpha=0.6)
    axes[1].legend()
    fig.suptitle("CRC-Polar vs. Uncoded Performance over AWGN")
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
