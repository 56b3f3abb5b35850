"""Legacy PAC/polar simulator driver (port of `polar_code_tpu/legacy/simulator.py`).

Same experiment: PAC(N, K+CRC) with a convolutional precoder, rate-profile
construction, BPSK/AWGN, adaptive two-stage list decoding (decode with
L=list_size; frames in error are re-decoded with L=list_size_max), per-SNR
stop once more than `err_cnt` frame errors are counted, and the same CSV
text.

Frames are simulated in batches: messages from ``default_rng(cfg.seed)``,
noise from ``RandomState(cfg.seed)``, LLRs made
on the host in float64 and decoded on `device` in float32.  The JAX driver
draws the same messages and, after ``np.random.seed(cfg.seed)``, the same
noise, so both give the same counts frame for frame.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .channel import channel
from .crclib import crc
from .pac import pac_decode, pac_encode_batch
from .rate_profile import rateprofile


@dataclass
class LegacySimConfig:
    N: int = 2**6
    R: float = 0.5
    crc_len: int = 0
    crc_poly: int = 0xA5
    list_size: int = 1
    list_size_max: int = 2**5
    designSNR: float = 2.0
    profile_name: str = "dega"
    conv_gen: Sequence[int] = field(default_factory=lambda: [1, 0, 1, 1, 0, 1, 1])
    snrb_snr: str = "SNRb"
    modu: str = "BPSK"
    snr_range: Sequence[float] = field(default_factory=lambda: np.arange(3, 6, 0.5))
    err_cnt: int = 50
    max_frames: int = 10**6
    batch: int = 256
    max_row_swaps: int = 0
    systematic: bool = False
    seed: int | None = 0


class BERFER:
    """Results container (mirrors the reference struct)."""

    def __init__(self) -> None:
        self.fname = ""
        self.label = ""
        self.snr_range: List[float] = []
        self.ber: List[float] = []
        self.fer: List[float] = []


def run(
    cfg: LegacySimConfig = LegacySimConfig(),
    out_dir: str = ".",
    *,
    device="cuda",
) -> BERFER:
    dev = resolve_device(device)
    noise_rng = np.random.RandomState(cfg.seed)
    K = int(cfg.N * cfg.R)
    nonfrozen = K + cfg.crc_len
    mem = len(cfg.conv_gen) - 1
    rng = np.random.default_rng(cfg.seed)

    rprofile = rateprofile(cfg.N, nonfrozen, cfg.designSNR, cfg.max_row_swaps)
    mask = rprofile.build_mask(cfg.profile_name)
    mask = rprofile.modify_profile()
    crc1 = crc(cfg.crc_len, cfg.crc_poly)
    is_crc = cfg.crc_len > 0

    def decode(llr: np.ndarray, L: int) -> np.ndarray:
        res = pac_decode(
            torch.as_tensor(llr.astype(np.float32), device=dev), mask, cfg.conv_gen, L,
            crc_len=cfg.crc_len if is_crc else 0, crc_poly=cfg.crc_poly,
        )
        return res["extracted"].cpu().numpy()

    result = BERFER()
    start = time.time()

    for snr in cfg.snr_range:
        ch = channel(cfg.modu, float(snr), cfg.snrb_snr, K / cfg.N, rng=noise_rng)
        fer = 0
        ber = 0
        frames = 0
        while frames < cfg.max_frames and fer <= cfg.err_cnt:
            B = min(cfg.batch, cfg.max_frames - frames)
            msgs = rng.integers(0, 2, size=(B, K)).astype(np.int8)
            if is_crc:
                messages = np.concatenate([msgs, crc1.crcCalc_batch(msgs)], axis=1)
            else:
                messages = msgs

            x = pac_encode_batch(
                torch.as_tensor(messages, device=dev), mask, cfg.conv_gen, cfg.N,
                systematic=cfg.systematic,
            ).cpu().numpy()
            mod = ch.modulate(x)
            noisy = ch.add_noise(mod)
            llr = ch.calc_llr3(noisy)

            decoded = decode(llr, cfg.list_size).copy()
            errs = (decoded != messages).sum(axis=1)

            # adaptive second stage: re-decode failed frames with L_max
            failed = np.where(errs > 0)[0]
            if failed.size and cfg.list_size_max > cfg.list_size:
                decoded[failed] = decode(llr[failed], cfg.list_size_max)
                errs[failed] = (decoded[failed] != messages[failed]).sum(axis=1)

            ber += int(errs.sum())
            fer += int((errs > 0).sum())
            frames += B

        result.snr_range.append(float(snr))
        result.ber.append(ber / (frames * nonfrozen))
        result.fer.append(fer / frames)
        print(f"@ {snr} dB FER is {fer / frames:0.2e} ({frames} frames)")

    result.fname = f"PAC({cfg.N},{nonfrozen}),L{cfg.list_size},m{mem}"
    if is_crc:
        result.fname += f",CRC{cfg.crc_len}"
    result.label = (
        f"PAC({cfg.N}, {nonfrozen})\nL={cfg.list_size}\n"
        f"Rate-profile={cfg.profile_name}\ndesign SNR={cfg.designSNR}\n"
        f"Conv Poly={list(cfg.conv_gen)}\nCRC={cfg.crc_len} bits, "
        f"Systematic={cfg.systematic}\n"
    )
    with open(f"{out_dir}/{result.fname}.csv", "w") as f:
        f.write(result.label)
        f.write("\nSNR: " + "".join(f"{s}; " for s in result.snr_range))
        f.write("\nBER: " + "".join(f"{b}; " for b in result.ber))
        f.write("\nFER: " + "".join(f"{e}; " for e in result.fer))

    print(f"time on test = {time.time() - start:.1f} s")
    return result


def main() -> None:
    run()


if __name__ == "__main__":
    main()
