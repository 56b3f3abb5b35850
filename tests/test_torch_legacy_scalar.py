"""The port's legacy scalar surface against the JAX package's, on the CPU:
`PolarCode` (its mask, rate profile and attributes, `encode` systematic or
not, `pac_encode`, and `pac_list_crc_decoder` systematic or not at L 1 and 4
with CRC-16 0x1021, in float64), every helper of `functions.py`, and the
three exceptions.
"""

import numpy as np
import pytest

from polar_code_tpu.legacy import exceptions as jax_exc
from polar_code_tpu.legacy import functions as jax_fn
from polar_code_tpu.legacy.crclib import crc as jax_crc
from polar_code_tpu.legacy.polar_code import PolarCode as JaxPolarCode
from polar_code_tpu.legacy.rate_profile import rateprofile as jax_rateprofile
from polar_code_tpu_torch import legacy
from polar_code_tpu_torch.legacy import exceptions, functions
from polar_code_tpu_torch.legacy.crclib import crc
from polar_code_tpu_torch.legacy.polar_code import PolarCode
from polar_code_tpu_torch.legacy.rate_profile import rateprofile

N, K, CRC_LEN, CRC_POLY = 64, 32, 16, 0x1021
KP = K + CRC_LEN
GEN = (1, 0, 1, 1, 0, 1, 1)
ATTRS = ("codeword_length", "log2_N", "nonfrozen_bits", "n", "bitrev_indices", "polarcode_mask",
         "rate_profile", "frozen_bits", "list_size", "list_size_max", "iterations", "m", "gen",
         "cur_state", "modu")


def codes(L, construct="dega"):
    return (PolarCode(N, KP, construct, L, rateprofile(N, KP, 2.0, 0), device="cpu"),
            JaxPolarCode(N, KP, construct, L, jax_rateprofile(N, KP, 2.0, 0)))


@pytest.mark.parametrize("construct", ["dega", "rm-polar"])
def test_polar_code_construction_and_encoders_match_jax(construct):
    ours, theirs = codes(4, construct)
    for name in ATTRS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert type(a) is type(b), name
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    rng = np.random.default_rng(1)
    for _ in range(3):
        info = rng.integers(0, 2, KP)
        for systematic in (False, True):
            a, b = ours.encode(info, systematic), theirs.encode(info, systematic)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for gen in ([1], list(GEN)):
            a = ours.pac_encode(info, gen, len(gen) - 1, False)
            b = theirs.pac_encode(info, gen, len(gen) - 1, False)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours.extract(a), theirs.extract(b))
        np.testing.assert_array_equal(ours.mul_matrix(info[:N // 2].repeat(2)),
                                      theirs.mul_matrix(info[:N // 2].repeat(2)))


@pytest.mark.parametrize("L", [1, 4])
def test_pac_list_crc_decoder_matches_jax(L):
    ours, theirs = codes(L)
    c_ours, c_theirs = crc(CRC_LEN, CRC_POLY), jax_crc(CRC_LEN, CRC_POLY)
    rng = np.random.default_rng(2 + L)
    nv = 1.0 / (2.0 * (K / N) * 10 ** (3.0 / 10.0))
    passed = 0
    for systematic in (False, True):
        for _ in range(3):
            msg = rng.integers(0, 2, K)
            msg = np.append(msg, c_ours.crcCalc(msg))
            x = ours.encode(msg, systematic)
            llr = 2.0 * (1.0 - 2.0 * x + rng.normal(0.0, np.sqrt(nv), N)) / nv
            for with_crc in (True, False):
                got = ours.pac_list_crc_decoder(llr, systematic, with_crc, c_ours, L)
                want = theirs.pac_list_crc_decoder(llr, systematic, with_crc, c_theirs, L)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
                passed += bool(np.array_equal(got, msg))
    assert passed > 0


def test_functions_match_jax():
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, 2, 16), rng.integers(0, 2, 16)
    assert functions.fails(a, b) == jax_fn.fails(a, b)
    for x, y in ((1.5, -0.25), (-3.0, 2.0), (0.0, 1.0)):
        assert functions.lowerconv(0, x, y) == jax_fn.lowerconv(0, x, y)
        assert functions.lowerconv(1, x, y) == jax_fn.lowerconv(1, x, y)
        assert functions.upperconv(x, y) == jax_fn.upperconv(x, y)
        assert functions.logdomain_sum(x, y) == jax_fn.logdomain_sum(x, y)
    u, v = rng.normal(0, 3, 12), rng.normal(0, 3, 12)
    np.testing.assert_array_equal(functions.logdomain_sum2(u, v), jax_fn.logdomain_sum2(u, v))
    np.testing.assert_array_equal(functions.upperconv2(u, v), jax_fn.upperconv2(u, v))
    state, gen = [1, 0, 1, 1, 0, 1], list(GEN)
    for bit in (0, 1):
        assert functions.conv_1bit(bit, state, gen) == jax_fn.conv_1bit(bit, state, gen)
        assert functions.getNextState(bit, state, 6) == jax_fn.getNextState(bit, state, 6)
        for flag in (0, 1):
            args = (bit, state, [0, 1, 1], gen, [1, 1, 0, 1], flag)
            assert functions.conv1bit_getNextStates(*args) == jax_fn.conv1bit_getNextStates(*args)
    code = rng.integers(0, 2, 32)
    np.testing.assert_array_equal(functions.conv_encode(code, gen, 6), jax_fn.conv_encode(code, gen, 6))
    assert functions.bin2dec([1, 0, 1, 1]) == jax_fn.bin2dec([1, 0, 1, 1])
    assert [functions.bitreversed(j, 5) for j in range(32)] == [jax_fn.bitreversed(j, 5) for j in range(32)]
    assert functions.__all__ == jax_fn.__all__


def test_exceptions_match_jax():
    names = ["PCLengthError", "PCLengthDivTwoError", "PCInfoLengthError"]
    assert exceptions.__all__ == jax_exc.__all__ == names
    for name in names:
        cls = getattr(exceptions, name)
        assert issubclass(cls, Exception) and cls.__doc__ == getattr(jax_exc, name).__doc__
        assert getattr(legacy, name) is cls
    with pytest.raises(exceptions.PCLengthError):
        PolarCode(16, 32, "dega", 1, rateprofile(16, 8, 2.0, 0), device="cpu")
    with pytest.raises(exceptions.PCLengthDivTwoError):
        PolarCode(24, 8, "dega", 1, rateprofile(16, 8, 2.0, 0), device="cpu")
