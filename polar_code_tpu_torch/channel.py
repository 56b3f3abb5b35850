"""BPSK modulation, AWGN and LLRs (port of `polar_code_tpu/channel.py`).

Two energy conventions, as in the JAX package:

* FER sweeps: σ² = 1 / (2 · (K/N) · Eb/N0) — the rate counts all K
  info+CRC bits (`noise_var_coded`).
* Uncoded baseline: σ² = 1 / (2 · Eb/N0) (`noise_var_uncoded`).

LLR for BPSK(0→+1, 1→−1) over AWGN: llr = 2y/σ².  Noise comes from an
explicit `torch.Generator` (see `utils/seeding.py`).
"""

from __future__ import annotations

import torch


def bpsk(bits: torch.Tensor) -> torch.Tensor:
    """Map {0,1} → {+1.0, −1.0} (float32)."""

    return 1.0 - 2.0 * bits.to(torch.float32)


def noise_var_coded(ebno_db: float, k_bits: int, n_bits: int) -> float:
    """σ² with rate = k_bits/n_bits (FER-sweep convention)."""

    ebno_lin = 10.0 ** (ebno_db / 10.0)
    rate = k_bits / n_bits
    return 1.0 / (2.0 * rate * ebno_lin)


def noise_var_uncoded(ebno_db: float) -> float:
    ebno_lin = 10.0 ** (ebno_db / 10.0)
    return 1.0 / (2.0 * ebno_lin)


def awgn_llr(
    generator: torch.Generator,
    symbols: torch.Tensor,
    noise_var: float,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Add AWGN at σ²=noise_var and return channel LLRs (2y/σ²).

    The generator must live on the symbols' device."""

    nv = torch.tensor(noise_var, dtype=dtype, device=symbols.device)
    noise = torch.sqrt(nv) * torch.randn(
        symbols.shape, generator=generator, dtype=dtype, device=symbols.device
    )
    return (2.0 / nv) * (symbols.to(dtype) + noise)


__all__ = ["bpsk", "noise_var_coded", "noise_var_uncoded", "awgn_llr"]
