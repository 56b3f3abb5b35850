"""CRC as GF(2) linear algebra (port of `polar_code_tpu/ops/crc.py`).

Host side (NumPy, copied): a generator matrix ``G [deg, Kp]`` with
``parity = G @ msg (mod 2)`` and a check matrix ``Hc = [G | I_deg]`` with
``syndrome = Hc @ (msg ‖ crc) (mod 2)``.

Device side (torch): one matrix product of 0/1 values followed by ``mod 2``.
The product runs in float32 because CUDA has no integer matmul; every entry
is a count ≤ K < 2^24, so the float32 sums are exact integers.

Polynomials are hex strings (e.g. "0x1864CFB" = CRC-24A); the leading 1 of
the hex value is the x^deg term.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def poly_to_bits(poly: str) -> np.ndarray:
    """Hex polynomial string → int8 coefficient vector (MSB first)."""

    if not poly:
        raise ValueError("CRC polynomial string must be non-empty")
    value = int(poly, 16)
    bit_length = value.bit_length()
    bits = [(value >> i) & 1 for i in reversed(range(bit_length))]
    return np.array(bits, dtype=np.int8)


def crc_degree(poly: str) -> int:
    degree = poly_to_bits(poly).size - 1
    if degree <= 0:
        raise ValueError("Polynomial degree must be positive")
    return degree


def _remainder(buffer: np.ndarray, poly_bits: np.ndarray) -> np.ndarray:
    """GF(2) long-division remainder of `buffer` by `poly_bits` (host)."""

    degree = poly_bits.size - 1
    buf = buffer.copy()
    for i in range(buf.size - degree):
        if buf[i]:
            buf[i : i + degree + 1] ^= poly_bits
    return buf[-degree:]


@functools.lru_cache(maxsize=None)
def generator_matrix(poly: str, msg_len: int) -> np.ndarray:
    """G [deg, msg_len] with parity(msg) = G @ msg mod 2.

    Column i is the remainder of x^(deg + msg_len - 1 - i) mod g(x), i.e. the
    parity of the i-th unit message.
    """

    poly_bits = poly_to_bits(poly)
    degree = poly_bits.size - 1
    G = np.zeros((degree, msg_len), dtype=np.int8)
    for i in range(msg_len):
        buf = np.zeros(msg_len + degree, dtype=np.int8)
        buf[i] = 1
        G[:, i] = _remainder(buf, poly_bits)
    G.setflags(write=False)
    return G


@functools.lru_cache(maxsize=None)
def check_matrix(poly: str, total_len: int) -> np.ndarray:
    """Hc [deg, total_len] with syndrome(msg‖crc) = Hc @ bits mod 2."""

    degree = crc_degree(poly)
    if total_len <= degree:
        raise ValueError("Message too short for the provided CRC polynomial")
    G = generator_matrix(poly, total_len - degree)
    Hc = np.concatenate([G, np.eye(degree, dtype=np.int8)], axis=1)
    Hc.setflags(write=False)
    return Hc


def _mod2_product(mat: np.ndarray, bits: torch.Tensor) -> torch.Tensor:
    """(bits @ matᵀ) mod 2 over the last axis of `bits`, as float32 0/1."""

    m = torch.as_tensor(np.asarray(mat, np.float32), device=bits.device)
    return torch.remainder(bits.to(torch.float32) @ m.T, 2.0)


def attach_crc_batch(msg_bits: torch.Tensor, poly: str) -> torch.Tensor:
    """Append CRC parity bits along the last axis.  msg_bits: int [..., Kp]."""

    parity = _mod2_product(generator_matrix(poly, int(msg_bits.shape[-1])), msg_bits)
    return torch.cat([msg_bits, parity.to(msg_bits.dtype)], dim=-1)


def check_crc_batch(bits: torch.Tensor, poly: str) -> torch.Tensor:
    """CRC pass/fail over the last axis.  Returns a bool tensor [...]."""

    syndrome = _mod2_product(check_matrix(poly, int(bits.shape[-1])), bits)
    return torch.all(syndrome == 0.0, dim=-1)


__all__ = [
    "poly_to_bits",
    "crc_degree",
    "generator_matrix",
    "check_matrix",
    "attach_crc_batch",
    "check_crc_batch",
]
