"""Rate-profile constructions for polar/PAC codes (port of
`polar_code_tpu/legacy/rate_profile.py`, host-side NumPy, copied).

Bhattacharyya, DEGA mean-LLR, polarization-weight and RM-polar masks, plus
the minimum-weight row-swap profile modification that reduces the error
coefficient (arXiv:2111.08843).  The masks are this path's parameters: they
enter the decoders as host constants.

Mask conventions: `build_mask` returns the non-frozen indicator in natural
u-index order; `modify_profile` operates in bit-reversed row space and
returns the (possibly modified) natural-order mask.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


def bitreversed(num: int, n: int) -> int:
    return int(bin(num)[2:].zfill(n)[::-1], 2)


class rateprofile:
    def __init__(self, N: int, Kp: int, dSNR: float, b: int) -> None:
        self.N = N
        self.n = int(math.log2(N))
        self.Kp = Kp  # info + CRC bits (non-frozen count)
        self.dsnr_db = dSNR
        self.profile = np.array([], dtype=int)
        self.bitrev_indices = [bitreversed(j, self.n) for j in range(N)]
        self.max_row_swaps = b

    # ------------------------------------------------------------------
    # Reliability metrics
    # ------------------------------------------------------------------

    def bhattacharyya_param(self) -> np.ndarray:
        z = np.zeros(self.N, dtype=float)
        snr = 10.0 ** (self.dsnr_db / 10.0)
        z[0] = np.exp(-snr)
        for level in range(1, self.n + 1):
            half = (1 << level) >> 1
            for j in range(half):
                T = z[j]
                z[j] = 2.0 * T - T * T
                z[half + j] = T * T
        return z

    @staticmethod
    def phi_inv(x: float) -> float:
        if x > 12.0:
            return 0.9861 * x - 2.3152
        if x > 3.5:
            return x * (0.009005 * x + 0.7694) - 0.9507
        if x > 1.0:
            return x * (0.062883 * x + 0.3678) - 0.1627
        return x * (0.2202 * x + 0.06448)

    def mllr_dega(self) -> np.ndarray:
        mllr = np.zeros(self.N, dtype=float)
        sigma_sq = 1.0 / (2.0 * self.Kp / self.N * 10.0 ** (self.dsnr_db / 10.0))
        mllr[0] = 2.0 / sigma_sq
        for level in range(1, self.n + 1):
            half = (1 << level) >> 1
            for j in range(half):
                T = mllr[j]
                mllr[j] = self.phi_inv(T)
                mllr[half + j] = 2.0 * T
        return mllr

    def pe_dega(self) -> np.ndarray:
        mllr = self.mllr_dega()
        return 0.5 - 0.5 * np.array([math.erf(np.sqrt(v) / 2.0) for v in mllr])

    def polarization_weight(self) -> np.ndarray:
        w = np.zeros(self.N, dtype=float)
        for i in range(self.N):
            # NB the reference iterates MSB-first over zfill(n), so bit j of
            # the zero-padded binary string gets weight 2^(j/4).
            binary = bin(i)[2:].zfill(self.n)
            w[i] = sum(int(binary[j]) * 2.0 ** (j * 0.25) for j in range(self.n))
        return w

    # ------------------------------------------------------------------
    # Row-weight helpers
    # ------------------------------------------------------------------

    def row_wt(self) -> np.ndarray:
        return np.array([bin(i).count("1") for i in range(self.N)], dtype=int)

    def min_row_wt(self) -> int:
        w = self.row_wt()
        min_w = self.n
        for i in range(self.N):
            if self.profile[i] == 1 and w[i] < min_w:
                min_w = int(w[i])
        return min_w

    def rows_wt(self, wt: int) -> List[int]:
        w = self.row_wt()
        return [
            bitreversed(i, self.n)
            for i in range(self.N)
            if self.profile[i] == 1 and w[i] == wt
        ]

    def A(self, mask: np.ndarray) -> np.ndarray:
        idx = [bitreversed(i, self.n) for i in range(self.N) if mask[i] == 1]
        return np.sort(np.asarray(idx, dtype=int))

    # ------------------------------------------------------------------
    # Error-coefficient reduction by row swaps (arXiv:2111.08843)
    # ------------------------------------------------------------------

    @staticmethod
    def supp(n: int) -> set:
        return {i for i, b in enumerate(reversed(bin(n)[2:])) if b == "1"}

    @staticmethod
    def supp_bin(bnry) -> set:
        return {i for i, b in enumerate(bnry) if b == 1}

    def dec2bin(self, d: int, n: int) -> List[int]:
        return [int(x) for x in bin(d)[2:].zfill(n)][::-1]

    @staticmethod
    def bin2dec(binary) -> int:
        return sum(b << i for i, b in enumerate(binary))

    def rows_wt_indices(self, wt: int):
        w = self.row_wt()
        B, Bc, W = [], [], []
        profile = self.profile[self.bitrev_indices]
        for i in range(self.N):
            if profile[i] == 1 and w[i] == wt:
                B.append(i)
            elif profile[i] == 0 and w[i] == wt:
                Bc.append(i)
            elif profile[i] == 0 and w[i] > wt:
                W.append(i)
        return B, Bc, W

    def leftSW_add(self, index: int) -> int:
        supp_index = self.supp(index)
        Ki = self.n - len(supp_index)
        zros = self.dec2bin((self.N - 1) ^ index, self.n)
        for x in supp_index:
            Ki += sum(zros[x + 1 : self.n])
        return Ki

    def rightSW(self, index: int) -> int:
        supp_index = self.supp(index)
        zros = self.dec2bin((self.N - 1) ^ index, self.n)
        return sum(sum(zros[0:x]) for x in supp_index)

    def E_set(self, index: int) -> List[int]:
        supp_index = self.supp(index)
        E = [index]
        zros = self.dec2bin((self.N - 1) ^ index, self.n)
        index_bin = self.dec2bin(index, self.n)
        for x in supp_index:
            spaces = sum(zros[0:x])
            fliping = sorted(self.supp_bin(zros[0:x]))
            for y in range(spaces - 1, -1, -1):
                member = list(index_bin)
                member[x] = 0
                member[fliping[y]] = 1
                E.append(self.bin2dec(member))
        return E

    def modify_profile(self) -> np.ndarray:
        profile = self.profile[self.bitrev_indices]
        w_min = self.min_row_wt()
        B, Bc, W = self.rows_wt_indices(w_min)
        cnt_sw = 0
        while True:
            B_rsw_size = [self.rightSW(x) for x in B]
            if not B_rsw_size:
                break
            # last index achieving the max (reference's reversed-argmax)
            cand_to_freeze = B[::-1][B_rsw_size[::-1].index(max(B_rsw_size))]

            E = self.E_set(cand_to_freeze)
            E_cap_B = (set(B) & set(E)) - {cand_to_freeze}
            reduction = 2 ** self.leftSW_add(cand_to_freeze)
            for x in E_cap_B:
                reduction += 2 ** (self.leftSW_add(x) - 1)
            E_cap_Bc = list(set(Bc) & set(E))
            paired = False
            Bc_lsw_size: List[int] = []
            if len(W) > 0:
                cand_to_unfreeze = max(W)
                W.remove(cand_to_unfreeze)
                addition = 0
                paired = True
            elif len(E_cap_Bc) > 0:
                Bc_lsw_size = [self.leftSW_add(x) for x in E_cap_Bc]
                cand_to_unfreeze = E_cap_Bc[::-1][Bc_lsw_size[::-1].index(min(Bc_lsw_size))]
                addition = 2 ** (self.leftSW_add(cand_to_unfreeze) - 1)
                if addition < reduction:
                    Bc.remove(cand_to_unfreeze)
                    paired = True
            elif len(Bc) > 0:
                Bc_lsw_size = [self.leftSW_add(x) for x in Bc]
                cand_to_unfreeze = Bc[::-1][Bc_lsw_size[::-1].index(min(Bc_lsw_size))]
                addition = 2 ** self.leftSW_add(cand_to_unfreeze)
                if addition < reduction:
                    Bc.remove(cand_to_unfreeze)
                    paired = True
            if paired and cnt_sw < self.max_row_swaps:
                cnt_sw += 1
                B.remove(cand_to_freeze)
                profile[cand_to_freeze] = 0
                profile[cand_to_unfreeze] = 1
            else:
                break
        self.profile = profile[self.bitrev_indices]
        return self.profile

    # ------------------------------------------------------------------
    # Mask builders
    # ------------------------------------------------------------------

    def _threshold_mask(self, reliability: np.ndarray, descending: bool) -> np.ndarray:
        # Stable sort (Python `sorted` in the reference): freeze the first
        # N−Kp channels in metric order, ties broken by index.
        order = sorted(range(self.N), key=lambda i: (-reliability[i]) if descending else reliability[i])
        mask = np.ones(self.N, dtype=int)
        for i in order[: self.N - self.Kp]:
            mask[i] = 0
        return mask

    def bh_build_mask(self) -> np.ndarray:
        return self._threshold_mask(self.bhattacharyya_param(), descending=True)

    def dega_build_mask(self) -> np.ndarray:
        return self._threshold_mask(self.mllr_dega(), descending=False)

    def pw_build_mask(self) -> np.ndarray:
        return self._threshold_mask(self.polarization_weight(), descending=False)

    def rmPolar_build_mask(self) -> np.ndarray:
        wt = self.row_wt()
        mllr = self.mllr_dega()
        mask = np.ones(self.N, dtype=int)
        weight_count = np.zeros(self.n + 1, dtype=int)
        for i in range(self.N):
            weight_count[wt[i]] += 1
        bit_cnt = 0
        k = 0
        while bit_cnt + weight_count[k] <= self.N - self.Kp:
            for i in range(self.N):
                if wt[i] == k:
                    mask[i] = 0
                    bit_cnt += 1
            k += 1
        # among weight-k rows, freeze the `remainder` least reliable (DEGA)
        rows_k = [i for i in range(self.N) if wt[i] == k]
        rows_k = sorted(rows_k, key=lambda i: mllr[i])
        remainder = (self.N - self.Kp) - bit_cnt
        for i in rows_k[:remainder]:
            mask[i] = 0
        return mask

    def build_mask(self, profile: str) -> np.ndarray:
        if profile == "bh":
            self.profile = self.bh_build_mask()
        elif profile == "dega":
            self.profile = self.dega_build_mask()
        elif profile == "rm-polar":
            self.profile = self.rmPolar_build_mask()
        elif profile == "pw":
            self.profile = self.pw_build_mask()
        else:
            raise ValueError(f"Unknown profile: {profile}")
        return self.profile


__all__ = ["rateprofile", "bitreversed"]
