"""Rate-matched polar SCL following the simplified 5G NR flow (port of
`polar_code_tpu/nr/polar/scl_nr.py`).

encode = CRC → polar(N) → sub-block interleave → rate match(E);
decode = derate → deinterleave → SCL → {"payload", "crc_pass",
"best_path_bits"}, where "payload" is the first len(info_set) bits of the
best path, i.e. all info+CRC bits (a quirk of the reference, kept).  The
decode goes through `ops/backend.make_scl_decoder`: the SCL kernel on a CUDA
tensor, the plain decoder on a CPU one.  `encode_rate_matched` and
`decode_rate_matched_scl` are the scalar reference-compatible forms, one
frame on `device` (the card unless "cpu"): float64 on the CPU, float32
through the kernel on the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...ops.backend import make_scl_decoder
from ...ops.crc import attach_crc_batch, check_crc_batch
from ...ops.polar_transform import encode_batch
from ...utils.device import resolve_device, scalar_dtype
from .interleaver import subblock_deinterleave, subblock_interleave
from .rate_match import derate_match_polar, rate_match_polar


def encode_rate_matched_batch(
    payload_bits: torch.Tensor,
    crc_poly: str,
    N: int,
    E: int,
    info_set: np.ndarray,
    ilv_mode: str = "default",
) -> torch.Tensor:
    """payload [..., Kp] → transmitted bits [..., E]."""

    msg = attach_crc_batch(payload_bits, crc_poly)
    codeword = encode_batch(msg, info_set, N)
    ilv = subblock_interleave(codeword, mode=ilv_mode)
    return rate_match_polar(ilv, E)


def decode_rate_matched_scl_batch(
    llr_E: torch.Tensor,
    crc_poly: str,
    N: int,
    E: int,
    info_set: np.ndarray,
    M: int,
    ilv_mode: str = "default",
    *,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """llr [B, E] → {"payload" [B, K], "crc_pass" [B], "best_path_bits" [B, K]}."""

    llr_internal = derate_match_polar(llr_E, N)
    llr_internal = subblock_deinterleave(llr_internal, N, mode=ilv_mode).to(dtype).contiguous()
    decode = make_scl_decoder(info_set, M, crc_poly, device=llr_internal.device, dtype=dtype, N=N)
    bits, _, _ = decode(llr_internal)
    return {
        "payload": bits[:, : len(np.asarray(info_set))],
        "crc_pass": check_crc_batch(bits, crc_poly),
        "best_path_bits": bits,
    }


# Scalar reference-compatible wrappers -------------------------------------

def encode_rate_matched(
    payload_bits: np.ndarray,
    crc_poly: str,
    N: int,
    E: int,
    info_set: np.ndarray,
    ilv_mode: str = "default",
    *,
    device=None,
) -> np.ndarray:
    dev = resolve_device(device)
    out = encode_rate_matched_batch(
        torch.as_tensor(np.asarray(payload_bits).astype(np.int8), device=dev)[None],
        crc_poly, N, E, info_set, ilv_mode,
    )
    return out[0].cpu().numpy().astype(np.int8)


def decode_rate_matched_scl(
    llr_E: np.ndarray,
    crc_poly: str,
    N: int,
    E: int,
    info_set: np.ndarray,
    M: int,
    ilv_mode: str = "default",
    *,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, np.ndarray]:
    """`dtype=None` decodes in float64 on the CPU (the JAX function's type)
    and float32 on the card; `dtype=torch.float64` on the card runs the
    kernel's float64 instantiation."""

    dev = resolve_device(device)
    dtype = scalar_dtype(dev, dtype)
    res = decode_rate_matched_scl_batch(
        torch.as_tensor(np.asarray(llr_E, dtype=np.float64), dtype=dtype, device=dev)[None],
        crc_poly, N, E, info_set, M, ilv_mode, dtype=dtype,
    )
    bits = res["best_path_bits"][0].cpu().numpy().astype(np.int8)
    return {
        "payload": res["payload"][0].cpu().numpy().astype(np.int8),
        "crc_pass": bool(res["crc_pass"][0]),
        "best_path_bits": bits,
    }


__all__ = [
    "encode_rate_matched",
    "decode_rate_matched_scl",
    "encode_rate_matched_batch",
    "decode_rate_matched_scl_batch",
]
