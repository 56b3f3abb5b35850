"""Polar-coding exceptions (reference `polar_coding_exceptions.py`; copy of
`polar_code_tpu/legacy/exceptions.py`)."""


class PCLengthError(Exception):
    """K must not exceed N."""


class PCLengthDivTwoError(Exception):
    """N must be a power of two."""


class PCInfoLengthError(Exception):
    """Information length mismatch."""


__all__ = ["PCLengthError", "PCLengthDivTwoError", "PCInfoLengthError"]
