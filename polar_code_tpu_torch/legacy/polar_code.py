"""Legacy `PolarCode` class — reference-compatible API over the batched PAC
core (port of `polar_code_tpu/legacy/polar_code.py`).

Work-alike of `polar_code.py` (reference): construction via a `rateprofile`
(mask build + optional row-swap modification), PAC/polar encoding, and the
CRC-aided PAC list decoder.  Scalar methods wrap batches of one on the
instance's device (the card unless `device="cpu"`); heavy workloads should
call `legacy.pac` batched functions directly.

`pac_list_crc_decoder` decodes on the card through the PAC kernel
(`pac.pac_decode`) in float32, and on the CPU through the plain decoder in
float64.  Its systematic branch re-encodes every path's `v_full`, which only
the plain decoder returns, so on the card it raises: decode systematic codes
with `device="cpu"`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.polar_transform import polar_transform
from ..utils.device import resolve_device
from . import exceptions as pcexc
from .pac import pac_decode, pac_encode_batch, pac_list_decode_batch
from .rate_profile import bitreversed, rateprofile


class PolarCode:
    def __init__(self, N: int, K: int, construct: str, L: int, rprofile: rateprofile,
                 *, device=None):
        if K > N:
            raise pcexc.PCLengthError
        if math.log2(N) != int(math.log2(N)):
            raise pcexc.PCLengthDivTwoError
        self.device = resolve_device(device)
        self.codeword_length = N
        self.log2_N = int(math.log2(N))
        self.nonfrozen_bits = K
        self.n = self.log2_N
        self.bitrev_indices = [bitreversed(j, self.n) for j in range(N)]
        self.rprofile = rprofile
        self.polarcode_mask = self.rprofile.build_mask(construct)
        self.polarcode_mask = self.rprofile.modify_profile()
        self.rate_profile = self.polarcode_mask[self.bitrev_indices]
        self.frozen_bits = (self.polarcode_mask + 1) % 2
        self.list_size = L
        self.list_size_max = L
        self.iterations = 10**6
        self.m = 0
        self.gen = [1]
        self.cur_state: list = []
        self.modu = "BPSK"

    # --------------------------- encoding ---------------------------

    def mul_matrix(self, profiled: np.ndarray) -> np.ndarray:
        """Polar transform (natural order); same butterfly as the core."""

        u = torch.as_tensor(np.asarray(profiled).astype(np.int8), device=self.device)[None]
        return polar_transform(u)[0].cpu().numpy().astype(int)

    def profiling(self, info: np.ndarray) -> np.ndarray:
        profiled = np.zeros(self.codeword_length, dtype=int)
        profiled[self.polarcode_mask == 1] = info
        return profiled

    def encode(self, info: np.ndarray, issystematic: bool) -> np.ndarray:
        polarcoded = self.mul_matrix(self.profiling(info))
        if issystematic:
            polarcoded *= self.polarcode_mask
            polarcoded = self.mul_matrix(polarcoded)
        return polarcoded

    def pac_encode(
        self, info: np.ndarray, conv_gen, mem: int, issystematic: bool = False
    ) -> np.ndarray:
        out = pac_encode_batch(
            torch.as_tensor(np.asarray(info).astype(np.int8), device=self.device)[None],
            self.polarcode_mask,
            conv_gen,
            self.codeword_length,
            systematic=issystematic,
        )
        return out[0].cpu().numpy().astype(int)

    # --------------------------- decoding ---------------------------

    def extract(self, decoded_message: np.ndarray) -> np.ndarray:
        return np.asarray(decoded_message)[self.polarcode_mask == 1].astype(int)

    def pac_list_crc_decoder(
        self,
        soft_mess: np.ndarray,
        issystematic: bool,
        isCRCinc: bool,
        crc1,
        L: int,
    ) -> np.ndarray:
        crc_len = crc1.len if isCRCinc else 0
        crc_poly = crc1.gen if isCRCinc else 0
        if self.device.type == "cuda":
            if issystematic:
                raise ValueError(
                    "the PAC kernel returns the selected path only; the systematic decoder "
                    "needs every path's v_full: decode it on the CPU (device=\"cpu\")")
            x = torch.as_tensor(np.asarray(soft_mess, dtype=np.float32), device=self.device)[None]
            res = pac_decode(x, self.polarcode_mask, self.gen, L, crc_len=crc_len,
                             crc_poly=crc_poly)
            return res["extracted"][0].cpu().numpy().astype(int)
        res = pac_list_decode_batch(
            torch.as_tensor(np.asarray(soft_mess, dtype=np.float64))[None],
            self.polarcode_mask,
            self.gen,
            L,
            crc_len=crc_len,
            crc_poly=crc_poly,
            dtype=torch.float64,
        )
        if issystematic:
            v_full = res["v_full"][0].numpy().astype(np.int8)  # [L, N]
            cands = [
                self.extract(self.mul_matrix(v_full[l])) for l in range(v_full.shape[0])
            ]
            valid = res["valid"][0].numpy()
            if isCRCinc:
                for cand in [c for c, v in zip(cands, valid) if v]:
                    if sum(crc1.crcCalc(np.asarray(cand))) == 0:
                        return np.asarray(cand, dtype=int)
            return np.asarray(cands[0], dtype=int)
        return res["extracted"][0].numpy().astype(int)


__all__ = ["PolarCode"]
