"""Legacy CRC class (port of `polar_code_tpu/legacy/crclib.py`).

`crc(len, poly).crcCalc(info)` is the long-division remainder of ``info``
by the full polynomial ``x^len + poly``, MSB first, taken from the generator
matrix of `ops/crc.py` as one GF(2) matrix-vector product.  `crcCalc_batch`
gives the parity of a whole [B, K] array as one matrix product: the same
bits as calling `crcCalc` on each row.
"""

from __future__ import annotations

import numpy as np

from ..ops.crc import generator_matrix


class crc:
    def __init__(self, crc_len: int, crc_poly: int) -> None:
        self.len = crc_len
        self.gen = crc_poly
        # full polynomial including the x^len term, as the hex string the
        # GF(2) helpers of ops/crc.py take
        self.full_poly = hex((1 << crc_len) | crc_poly) if crc_len > 0 else None

    def crcCalc(self, info: np.ndarray):
        """Remainder bits (MSB first) of `info` mod the full polynomial."""

        if self.len == 0:
            return []
        info = np.asarray(info).astype(np.int8) & 1
        G = generator_matrix(self.full_poly, info.size)
        parity = (G.astype(np.int32) @ info.astype(np.int32)) % 2
        return [int(b) for b in parity]

    def crcCalc_batch(self, info: np.ndarray) -> np.ndarray:
        """Parity bits int8 [B, len] of the rows of `info` [B, K]."""

        info = np.asarray(info).astype(np.int32) & 1
        if self.len == 0:
            return np.zeros((info.shape[0], 0), np.int8)
        G = generator_matrix(self.full_poly, info.shape[1])
        return ((info @ G.astype(np.int32).T) % 2).astype(np.int8)


__all__ = ["crc"]
