"""Legacy channel class (port of `polar_code_tpu/legacy/channel.py`):
BPSK/QPSK + AWGN + LLRs, host-side NumPy.

Batched 2-D inputs are taken everywhere, so the drivers modulate whole frame
batches at once; the LLR formulas are the reference's, kept verbatim,
including the exact log-domain QPSK form (`calc_llr3`).

Noise comes from an explicit `np.random.RandomState` (`rng=`), never from
numpy's global generator.  ``RandomState(s).standard_normal(shape)`` is the
stream of ``np.random.seed(s); np.random.standard_normal(shape)``, which the
JAX package's drivers draw, so a port driver handed ``RandomState(s)`` draws
the same noise in the same order.  Channels that draw in turn share one
generator.  Without `rng=` a channel seeds a generator of its own from the
operating system.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class channel:
    def __init__(
        self, modulation: str, snrdB: float, snrb_snr: str, Rc: float,
        rng: Optional[np.random.RandomState] = None,
    ) -> None:
        self.rng = np.random.RandomState() if rng is None else rng
        self.modulation = modulation
        self.M = 4 if modulation.upper() == "QPSK" else 2
        self.noise_power = self.calc_N0(snrdB, snrb_snr, Rc)
        self.code_word_length = 0
        self.constell = self.construct_mpsk(self.M, rotate=False)
        self.subconstells = self.get_subconstells(self.constell)

    def calc_N0(self, snrdB: float, snrb_snr: str, Rc: float) -> float:
        if snrb_snr.upper() == "SNR":
            return 1.0 / 10 ** (snrdB / 10.0)
        return 1.0 / (np.log2(self.M) * Rc * 10 ** (snrdB / 10.0))

    # ------------------------------------------------------------------

    def modulate(self, m: np.ndarray) -> np.ndarray:
        m = np.asarray(m)
        self.code_word_length = m.shape[-1]
        if self.modulation.upper() == "BPSK":
            return 1.0 - 2.0 * m.astype(float)
        # QPSK: Gray-ish mapping used by the reference:
        # s = (1/√2)·((1+1j) − 2(msb + lsb·1j))
        if m.shape[-1] % 2:
            pad = np.zeros((*m.shape[:-1], 1), dtype=m.dtype)
            m = np.concatenate([pad, m], axis=-1)
        msb = m[..., 0::2].astype(float)
        lsb = m[..., 1::2].astype(float)
        return (1.0 / np.sqrt(2.0)) * ((1.0 + 1.0j) - 2.0 * (msb + lsb * 1.0j))

    def add_noise(self, signal: np.ndarray) -> np.ndarray:
        signal = np.asarray(signal)
        if self.modulation.upper() == "BPSK":
            return signal + np.sqrt(self.noise_power / 2.0) * self.rng.standard_normal(
                signal.shape
            )
        return signal + np.sqrt(self.noise_power / 2.0) * self.rng.randn(
            *signal.shape
        ) * (1.0 + 1.0j)

    # ------------------------------------------------------------------

    def calc_llr(self, c: np.ndarray) -> np.ndarray:
        c = np.asarray(c)
        if self.modulation.upper() == "BPSK":
            return (4.0 / self.noise_power) * c
        real = (4.0 / self.noise_power) * c.real
        imag = (4.0 / self.noise_power) * c.imag
        out = np.empty((*c.shape[:-1], 2 * c.shape[-1]))
        out[..., 0::2] = real
        out[..., 1::2] = imag
        return out

    def calc_llr2(self, c: np.ndarray) -> np.ndarray:
        """Max-log (min-squared-distance) QPSK LLRs (reference
        `channel.py:71-95`).  Unused by every reference driver (they call
        `calc_llr3`); kept for API completeness.  BPSK falls back to the
        exact `4y/N0` form, as in the reference."""

        c = np.asarray(c)
        if self.modulation.upper() == "BPSK":
            return (4.0 / self.noise_power) * c

        a = 0.70710678
        msb_set = np.array([[-a - a * 1j, a - a * 1j], [-a + a * 1j, a + a * 1j]])
        lsb_set = np.array([[-a + a * 1j, -a - a * 1j], [a + a * 1j, a - a * 1j]])

        def mindist(y, points):  # min over the 2 constellation points per bit value
            d = np.abs(y[..., None] - points[None, ...]) ** 2
            return d.min(axis=-1)

        l_msb = (mindist(c, msb_set[0]) - mindist(c, msb_set[1])) / self.noise_power
        l_lsb = (mindist(c, lsb_set[0]) - mindist(c, lsb_set[1])) / self.noise_power
        out = np.empty((*c.shape[:-1], 2 * c.shape[-1]))
        out[..., 0::2] = l_lsb  # reference appends (L_LSB, L_MSB) per symbol
        out[..., 1::2] = l_msb
        return out

    def sum_num_denum(self, rx) -> np.ndarray:
        """Per-bit numerator/denominator likelihood sums over the
        sub-constellations (reference `channel.py:128-140`).  NB: replicates
        the reference's formula verbatim, including its quirk of dividing
        only the imaginary product by N0 — this helper (and `calc_llr2_`)
        exists for API completeness; no driver uses it."""

        rx = np.asarray(rx)
        n_bits = int(np.log2(self.M))
        zer = [
            np.exp(
                np.real(rx) * np.transpose(np.real(self.subconstells[i][0]))
                + np.imag(rx) * np.transpose(np.imag(self.subconstells[i][0]))
                / self.noise_power
            ).sum(axis=0)
            for i in range(n_bits)
        ]
        one = [
            np.exp(
                np.real(rx) * np.transpose(np.real(self.subconstells[i][1]))
                + np.imag(rx) * np.transpose(np.imag(self.subconstells[i][1]))
                / self.noise_power
            ).sum(axis=0)
            for i in range(n_bits)
        ]
        return np.array([zer, one])

    def calc_llr2_(self, c) -> np.ndarray:
        """Sub-constellation log-ratio LLRs (reference `channel.py:143-148`);
        API-completeness twin of `sum_num_denum`."""

        precounted = self.sum_num_denum(c)
        llrs = np.log(precounted[0] / precounted[1])
        return np.reshape(np.transpose(llrs), llrs.size)

    def calc_llr3(self, c: np.ndarray) -> np.ndarray:
        """Exact log-domain QPSK LLRs (max-log-free form of the reference)."""

        c = np.asarray(c)
        if self.modulation.upper() == "BPSK":
            return (4.0 / self.noise_power) * c

        a = 0.70710678
        msb_zero = np.array([-a - a * 1j, a - a * 1j])
        msb_one = np.array([-a + a * 1j, a + a * 1j])
        lsb_zero = np.array([-a + a * 1j, -a - a * 1j])
        lsb_one = np.array([a + a * 1j, a - a * 1j])

        def loglik(y, points):
            d = np.abs(y[..., None] - points[None, ...]) ** 2
            return np.log(np.exp(-d / self.noise_power).sum(axis=-1))

        l_msb = -(loglik(c, msb_zero) - loglik(c, msb_one))
        l_lsb = -(loglik(c, lsb_zero) - loglik(c, lsb_one))
        out = np.empty((*c.shape[:-1], 2 * c.shape[-1]))
        # reference appends (L_LSB, L_MSB) per symbol
        out[..., 0::2] = l_lsb
        out[..., 1::2] = l_msb
        return out

    @staticmethod
    def construct_mpsk(m: int, rotate: bool = True) -> np.ndarray:
        if m == 2:
            return np.array([1, -1])
        angles = np.arange(m) / m * 2 * np.pi + rotate * np.pi / m
        return np.cos(angles) + 1j * np.sin(angles)

    @staticmethod
    def get_subconstells(constell: np.ndarray) -> np.ndarray:
        """Sub-constellations per (bit position, bit value) for LLR detection
        (reference `channel.py:122-126`): entry [i][j] holds the points whose
        position index has bit i equal to j."""

        constell = np.asarray(constell)
        order = int(np.log2(len(constell)))
        positions = np.arange(len(constell))
        return np.array(
            [
                [[constell[(positions >> i) % 2 == j]] for j in range(2)]
                for i in range(order)
            ]
        )


__all__ = ["channel"]
