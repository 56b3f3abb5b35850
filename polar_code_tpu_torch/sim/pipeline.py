"""Batched Monte-Carlo FER step (port of `polar_code_tpu/sim/pipeline.py:45` `make_fer_chunk`).

    generators → payloads → CRC → encode → BPSK → AWGN → LLR → decode → counters

One call simulates `batch` frames on the device and returns summed counters
as device tensors, so the caller syncs with the host once per chunk.  The
baseline SCL arm and the DL-SCL arm share the baseline decode.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..channel import awgn_llr, bpsk
from ..dlscl.flip import decode_with_retries_batch
from ..ops.crc import attach_crc_batch, crc_degree
from ..ops.polar_transform import encode_batch
from ..utils.seeding import make_generator

# generator streams of one chunk
_PAYLOAD, _NOISE, _UNCODED_NOISE = 0, 1, 2


def make_fer_chunk(
    *,
    N: int,
    K: int,
    crc_poly: str,
    info_set: np.ndarray,
    M: int,
    retries: int,
    beta: Optional[torch.Tensor],
    batch: int,
    device: torch.device,
    include_uncoded: bool = False,
    dtype: torch.dtype = torch.float32,
    compact: int = 0,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the FER-sweep step: (seed, snr_tag, chunk_idx, σ²_coded,
    σ²_uncoded) → dict of summed counters (0-d device tensors)."""

    payload_bits = K - crc_degree(crc_poly)
    info_np = np.asarray(info_set)
    if beta is not None:
        beta = beta.to(device=device, dtype=dtype)

    def chunk(seed: int, snr_tag: int, chunk_idx: int, noise_var_coded: float,
              noise_var_uncoded: float) -> Dict[str, torch.Tensor]:
        def gen(stream: int) -> torch.Generator:
            return make_generator(seed, snr_tag, chunk_idx, stream, device=device)

        payload = torch.randint(
            0, 2, (batch, payload_bits), generator=gen(_PAYLOAD), device=device,
            dtype=torch.int8,
        )
        msg = attach_crc_batch(payload, crc_poly)
        code = encode_batch(msg, info_np, N)
        llr = awgn_llr(gen(_NOISE), bpsk(code), noise_var_coded, dtype=dtype)

        dl = decode_with_retries_batch(
            llr, info_np, M, retries, crc=crc_poly, beta=beta,
            compact_capacity=compact,
        )
        out = {
            "scl_errors": torch.sum(~dl["baseline_pass"]),
            "dl_errors": torch.sum(~dl["success"]),
            "scl_bit_errors": torch.sum(dl["baseline_bits"] != msg),
            "dl_bit_errors": torch.sum(dl["best_path_bits"] != msg),
            "bits_coded": torch.tensor(batch * K, device=device),
            "retries_used": torch.sum(dl["attempts_used"]),
        }
        if include_uncoded:
            unc_llr = awgn_llr(gen(_UNCODED_NOISE), bpsk(payload), noise_var_uncoded, dtype=dtype)
            unc_errs = torch.sum((unc_llr < 0).to(torch.int8) != payload, dim=1)
            out["uncoded_errors"] = torch.sum(unc_errs > 0)
            out["uncoded_bit_errors"] = torch.sum(unc_errs)
            out["bits_uncoded"] = torch.tensor(batch * payload_bits, device=device)
        return out

    return chunk


__all__ = ["make_fer_chunk"]
