from .interleaver import subblock_interleave, subblock_deinterleave
from .rate_match import rate_match_polar, derate_match_polar
from .scl_nr import (
    decode_rate_matched_scl,
    decode_rate_matched_scl_batch,
    encode_rate_matched,
    encode_rate_matched_batch,
)

__all__ = [
    "subblock_interleave",
    "subblock_deinterleave",
    "rate_match_polar",
    "derate_match_polar",
    "encode_rate_matched",
    "decode_rate_matched_scl",
    "encode_rate_matched_batch",
    "decode_rate_matched_scl_batch",
]
