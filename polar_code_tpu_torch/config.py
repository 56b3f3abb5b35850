"""Central configuration defaults (port of `polar_code_tpu/config.py`).

`PolarConfig` holds the P(128,64) + CRC-24A defaults; `get_config()` returns
a fresh copy and `validate_code_shape` checks CLI --N/--K overrides.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List


@dataclass
class PolarConfig:
    N: int = 128
    K: int = 64
    crc_poly: str = "0x1864CFB"  # 5G CRC-24A
    crc_bits: int = 24
    list_sizes: List[int] = field(default_factory=lambda: [1, 2, 4, 8])
    retries: int = 8
    ebno_sweep: List[float] = field(default_factory=lambda: [4.0, 6.5, 0.5])
    seed: int = 0


DEFAULTS = PolarConfig()


def validate_code_shape(N: int, K: int, crc_bits: int) -> None:
    """Validate --N/--K overrides against the configured CRC width.

    K must leave a positive payload after the CRC parity bits, and N must be
    a power of two greater than K."""

    if K <= crc_bits:
        raise ValueError(
            f"K={K} must exceed the CRC width ({crc_bits} parity bits for "
            "the configured polynomial): payload size K - crc_bits must be "
            "positive"
        )
    if N <= K or N & (N - 1):
        raise ValueError(f"N={N} must be a power of two greater than K={K}")


def get_config() -> PolarConfig:
    """Return a copy of the default configuration."""

    return replace(
        DEFAULTS,
        list_sizes=list(DEFAULTS.list_sizes),
        ebno_sweep=list(DEFAULTS.ebno_sweep),
    )
