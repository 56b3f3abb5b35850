"""Two-stage adaptive SCL decoding (port of `polar_code_tpu/ops/adaptive.py`).

Decode the whole batch at a small list size ``M_first``; re-decode the frames
whose CRC fails at ``M_final``.  Per frame the result is the stage-1 output
if its CRC passed, else the stage-2 output — so a frame whose stage-1 decode
passes the CRC with a wrong codeword keeps it.

On the card the failing frames are gathered in index order
(`backend.stable_partition_perm`) and re-decoded in chunks of `capacity`
frames, one ragged SCL-kernel launch a chunk (auto: the whole batch, so one
launch); that costs one host sync for the failing count.  On the CPU auto
is a masked full-batch second stage: the same results at all-frames cost.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import auto_compact_capacity, make_scl_decoder, stable_partition_perm


def decode_scl_adaptive(
    llr: torch.Tensor,
    info_set,
    M_first: int,
    M_final: int,
    crc: str,
    *,
    dtype: torch.dtype = torch.float32,
    capacity: int = -1,
) -> dict:
    """Adaptive decode of a batch.  llr: [B, N] on the decode device.

    capacity: stage-2 chunk size (−1 auto, 0 masked full batch, >0 explicit,
    on any device).

    Returns {"best_path_bits" [B, K], "best_path_info_llrs" [B, K],
    "crc_pass" [B], "second_stage" [B] (bool: the frame was re-decoded)}."""

    if crc is None:
        raise ValueError("adaptive decoding needs a CRC to detect stage-1 failures")
    info_np = np.asarray(info_set)
    B, N = int(llr.shape[0]), int(llr.shape[1])
    dev = llr.device

    dec1 = make_scl_decoder(info_np, M_first, crc, device=dev, dtype=dtype, N=N)
    dec2 = make_scl_decoder(info_np, M_final, crc, device=dev, dtype=dtype, N=N)
    bits, llrs, ok = dec1(llr)
    llrs = llrs.to(dtype)

    C = auto_compact_capacity(int(capacity), B, dev)
    if C == 0:
        b2, l2, ok2 = dec2(llr)
        sel = ok[:, None]
        return {
            "best_path_bits": torch.where(sel, bits, b2),
            "best_path_info_llrs": torch.where(sel, llrs, l2.to(dtype)),
            "crc_pass": ok | ok2,
            "second_stage": ~ok,
        }

    bits, llrs, okf = bits.clone(), llrs.clone(), ok.clone()
    count = int((~ok).sum())
    failing = stable_partition_perm(ok)[:count]
    for c0 in range(0, count, C):
        sel = failing[c0 : c0 + C]
        r_bits, r_llrs, r_pass = dec2(llr.index_select(0, sel))
        bits[sel] = r_bits
        llrs[sel] = r_llrs.to(dtype)
        okf[sel] = r_pass
    return {
        "best_path_bits": bits,
        "best_path_info_llrs": llrs,
        "crc_pass": okf,
        "second_stage": ~ok,
    }


__all__ = ["decode_scl_adaptive"]
