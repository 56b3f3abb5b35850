"""Legacy helper functions (reference `polar_coding_functions.py` work-alike;
copy of `polar_code_tpu/legacy/functions.py`, host numpy).

Scalar host utilities kept for API compatibility with legacy-style code;
the batched pipelines in `legacy.pac` use the precomputed GF(2) transform
instead of these per-bit loops.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from .rate_profile import bitreversed  # re-export


def fails(list1, list2) -> int:
    """Number of differing bits."""

    return int(np.sum(np.absolute(np.asarray(list1) - np.asarray(list2))))


def lowerconv(upperdecision: int, upperllr: float, lowerllr: float) -> float:
    """g-update in the log domain."""

    return lowerllr + upperllr if upperdecision == 0 else lowerllr - upperllr


def upperconv(llr1: float, llr2: float) -> float:
    """Min-sum f-update."""

    return float(np.sign(llr1) * np.sign(llr2) * min(abs(llr1), abs(llr2)))


def logdomain_sum(x: float, y: float) -> float:
    if x < y:
        return y + float(np.log(1 + np.exp(x - y)))
    return x + float(np.log(1 + np.exp(y - x)))


def logdomain_sum2(x, y) -> np.ndarray:
    """Elementwise stable log(eˣ + eʸ) over arrays (reference
    `polar_coding_functions.py:57-60`); same branch-on-larger form,
    vectorized with `np.where` instead of a per-element list comprehension."""

    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    lo, hi = np.minimum(x, y), np.maximum(x, y)
    return hi + np.log(1 + np.exp(lo - hi))


def upperconv2(llr1, llr2) -> np.ndarray:
    """Exact (non-min-sum) f-update in the log domain, array form:
    log((e^(l1+l2) + 1) / (e^l1 + e^l2)) — reference
    `polar_coding_functions.py:63-66`."""

    llr1 = np.asarray(llr1, dtype=float)
    llr2 = np.asarray(llr2, dtype=float)
    return logdomain_sum2(llr1 + llr2, np.zeros(llr1.shape)) - logdomain_sum2(
        llr1, llr2
    )


def conv_1bit(in_bit: int, cur_state: List[int], gen: List[int]) -> int:
    """One convolution output bit for the current shift-register state."""

    g_bit = in_bit * gen[0]
    for i in range(1, len(gen)):
        if gen[i] == 1:
            g_bit ^= cur_state[i - 1]
    return g_bit


def getNextState(in_bit: int, cur_state: List[int], m: int) -> List[int]:
    return [in_bit] + cur_state[0 : m - 1]


def conv1bit_getNextStates(
    in_bit: int,
    cur_state1: List[int],
    cur_state2: List[int],
    gen1: List[int],
    gen2: List[int],
    bit_flag: int,
):
    """One step of the two-register convolution (reference
    `polar_coding_functions.py:96-132`): XOR `in_bit` with the taps of
    both generators, where the register selected by `bit_flag` skips its
    first feedback tap; register 1 always shifts, register 2 shifts only
    when bit_flag == 1.  Returns (g_bit, next_state1, next_state2)."""

    m1, m2 = len(gen1) - 1, len(gen2) - 1
    skip1, skip2 = (2, 1) if bit_flag == 1 else (1, 2)
    g_bit = in_bit
    for i in range(skip1, m1 + 1):
        if gen1[i] == 1:
            g_bit ^= cur_state1[i - 1]
    for i in range(skip2, m2 + 1):
        if gen2[i] == 1:
            g_bit ^= cur_state2[i - 1]
    next_state1 = [in_bit] + cur_state1[0 : m1 - 1]
    next_state2 = (
        [in_bit] + cur_state2[0 : m2 - 1] if bit_flag == 1 else cur_state2
    )
    return g_bit, next_state1, next_state2


def conv_encode(in_code, gen: List[int], mem: int) -> np.ndarray:
    """Convolutional precoding along the bit-reversed position order."""

    cur_state = [0] * mem
    in_code = np.asarray(in_code)
    out = np.zeros(in_code.size, dtype=int)
    n = int(math.log2(in_code.size))
    for j in range(in_code.size):
        i = bitreversed(j, n)
        out[i] = conv_1bit(int(in_code[i]), cur_state, gen)
        cur_state = getNextState(int(in_code[i]), cur_state, mem)
    return out


def bin2dec(binary) -> int:
    return sum(int(b) << i for i, b in enumerate(binary))


__all__ = [
    "fails",
    "bitreversed",
    "lowerconv",
    "upperconv",
    "upperconv2",
    "logdomain_sum",
    "logdomain_sum2",
    "conv_1bit",
    "getNextState",
    "conv1bit_getNextStates",
    "conv_encode",
    "bin2dec",
]
