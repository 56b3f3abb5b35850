"""DL-SCL bit-flip retries (port of `polar_code_tpu/dlscl/flip.py`).

Rank info positions by Q = |L0|·β (or |L0| without β), build a forced-bit
plan that fixes the prefix, flips the chosen bit and frees the rest, retry
SCL, and re-rank from the new best path's LLRs after every failed attempt,
excluding already-tried indices, stopping on CRC pass.  The output is the
last attempt's result whether or not it succeeded.

`retry_with_flip` and `decode_with_retries` are the scalar host loop, with
the reference-compatible signatures and return dict, over
`polar/api.py::decode_scl` (one decode of one frame a call: on the card a
launch of the SCL kernel with its full-list output, on the CPU the plain
decoder in float64); they take `device` and `dtype` and pass them on.

`decode_with_retries_batch` runs the baseline and then up to `retries`
masked steps over the whole batch; with a compaction capacity it decodes,
at each step, only the frames that still fail (gathered in index order,
in chunks of at most `capacity`) and scatters the results back.  Frames are
independent, so both paths return exactly the same tensors.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops.backend import auto_compact_capacity, make_scl_decoder, stable_partition_perm
from ..ops.crc import check_crc
from ..polar import api as polar_api


# ------------------------------------------------------------------
# Scalar host API (reference-compatible)
# ------------------------------------------------------------------


def choose_flip_index(abs_l0: np.ndarray, beta: Optional[np.ndarray]) -> int:
    """Choose the flip index by the β metric (fallback to |L0| ordering)."""

    abs_l0 = np.asarray(abs_l0)
    if abs_l0.ndim != 1:
        raise ValueError("abs_l0 must be a 1D array")
    if abs_l0.size == 0:
        raise ValueError("abs_l0 cannot be empty")
    if beta is not None:
        beta = np.asarray(beta)
        if beta.ndim != 2 or beta.shape[0] != beta.shape[1] or beta.shape[0] != abs_l0.size:
            raise ValueError("beta must be a square matrix matching abs_l0 length")
        return int(np.argmin(abs_l0 @ beta))
    return int(np.argmin(abs_l0))


def _force_vector(best_path_bits: np.ndarray, flip_index: int) -> np.ndarray:
    forced = np.full(best_path_bits.size, -1, dtype=np.int8)
    forced[:flip_index] = best_path_bits[:flip_index]
    forced[flip_index] = 1 - best_path_bits[flip_index]
    return forced


def retry_with_flip(
    llr_root: np.ndarray,
    info_set: np.ndarray,
    M: int,
    best_path_bits: np.ndarray,
    flip_index: int,
    crc: Optional[str] = None,
    *,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> dict:
    """Retry SCL decoding with the specified info bit flipped."""

    best_path_bits = np.asarray(best_path_bits)
    if best_path_bits.ndim != 1:
        raise ValueError("best_path_bits must be 1D")
    if flip_index < 0 or flip_index >= best_path_bits.size:
        raise IndexError("flip_index out of range")
    forced = _force_vector(best_path_bits, flip_index)
    result = polar_api.decode_scl(llr_root, info_set, M, crc=crc, force_info_bits=forced,
                                  dtype=dtype, device=device)
    result["forced_info_bits"] = forced
    result["flip_index"] = flip_index
    return result


def decode_with_retries(
    llr_root: np.ndarray,
    info_set: np.ndarray,
    M: int,
    retries: int,
    *,
    crc: Optional[str] = None,
    beta: Optional[np.ndarray] = None,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> dict:
    """Baseline SCL followed by up to ``retries`` β-ranked flip attempts."""

    attempts: List[dict] = []
    baseline = polar_api.decode_scl(llr_root, info_set, M, crc=crc, dtype=dtype, device=device)
    attempts.append({**baseline, "attempt_type": "baseline"})
    best_output = baseline

    def _passes(output: dict) -> bool:
        bits = output.get("best_path_bits")
        if bits is None:
            return False
        if crc is None:
            return True
        return check_crc(bits, crc)

    if _passes(baseline) or retries <= 0:
        return {**best_output, "attempts": attempts, "tried_indices": [], "success": _passes(best_output)}

    reference_bits = baseline["best_path_bits"]
    reference_llrs = baseline["best_path_info_llrs"]
    if reference_bits is None or reference_llrs is None:
        raise ValueError("Baseline decode did not produce candidate bits/LLRs")
    abs_l0 = np.abs(np.asarray(reference_llrs, dtype=float))

    tried: List[int] = []
    while len(tried) < retries and len(tried) < abs_l0.size:
        q = abs_l0 @ beta if beta is not None else abs_l0
        order = np.argsort(q)
        idx = next((int(i) for i in order if int(i) not in tried), None)
        if idx is None:
            break
        tried.append(idx)
        retry_result = retry_with_flip(llr_root, info_set, M, reference_bits, flip_index=idx,
                                       crc=crc, dtype=dtype, device=device)
        attempts.append({**retry_result, "attempt_type": "flip"})
        best_output = retry_result
        if retry_result.get("best_path_bits") is not None:
            reference_bits = retry_result["best_path_bits"]
        if retry_result.get("best_path_info_llrs") is not None:
            reference_llrs = retry_result["best_path_info_llrs"]
        abs_l0 = np.abs(np.asarray(reference_llrs, dtype=float))
        if _passes(retry_result):
            break

    return {**best_output, "attempts": attempts, "tried_indices": tried, "success": _passes(best_output)}


# ------------------------------------------------------------------
# Batched device implementation
# ------------------------------------------------------------------

def _flip_plan(best_bits, best_llrs, tried, beta):
    """Forced plan for the next attempt of each frame and its flip index."""

    K = best_bits.shape[1]
    pos = torch.arange(K, device=best_bits.device)[None, :]
    q = best_llrs.abs()
    if beta is not None:
        q = q @ beta
    q = torch.where(tried, torch.inf, q)
    idx = torch.argmin(q, dim=1)[:, None]  # first untried index in rank order
    flip = 1 - torch.gather(best_bits, 1, idx)
    forced = torch.where(pos < idx, best_bits, torch.full_like(best_bits, -1))
    forced = torch.where(pos == idx, flip, forced)
    return forced, pos == idx


def decode_with_retries_batch(
    llr: torch.Tensor,
    info_set,
    M: int,
    retries: int,
    *,
    crc: str,
    beta: Optional[torch.Tensor] = None,
    compact_capacity: int = 0,
) -> dict:
    """Batched DL-SCL: baseline SCL plus up to `retries` flip attempts.

    llr: [B, N] on the decode device; its dtype is the decode dtype.
    Returns a dict of tensors:
      best_path_bits       int8 [B, K] — final output bits (last attempt's best)
      best_path_info_llrs  [B, K]
      success              bool [B]    — CRC passed within the retry budget
      attempts_used        int32 [B]   — flip attempts executed
      baseline_pass        bool [B]    — baseline SCL already passed the CRC
      baseline_bits        int8 [B, K] — baseline SCL best path
      tried                bool [B, K] — flip indices tried
    """

    if crc is None:
        raise ValueError("decode_with_retries_batch requires a CRC polynomial")
    info_np = np.asarray(info_set)
    B, N = int(llr.shape[0]), int(llr.shape[1])
    K = int(info_np.size)
    if retries >= K:
        raise ValueError("retries must be < K")
    dev, dtype = llr.device, llr.dtype
    if beta is not None:
        beta = beta.to(device=dev, dtype=dtype)
    decode = make_scl_decoder(info_np, M, crc, device=dev, dtype=dtype, N=N)
    capacity = auto_compact_capacity(int(compact_capacity), B, dev) if compact_capacity else 0

    base_bits, base_llrs, base_pass = decode(llr)
    done = base_pass.clone()
    best_bits = base_bits.clone()
    best_llrs = base_llrs.to(dtype)
    tried = torch.zeros((B, K), dtype=torch.bool, device=dev)
    attempts = torch.zeros((B,), dtype=torch.int32, device=dev)

    for _ in range(retries):
        if not capacity:
            forced, flipped = _flip_plan(best_bits, best_llrs, tried, beta)
            r_bits, r_llrs, r_pass = decode(llr, forced)
            active = ~done
            upd = active[:, None]
            best_bits = torch.where(upd, r_bits, best_bits)
            best_llrs = torch.where(upd, r_llrs.to(dtype), best_llrs)
            tried = tried | (upd & flipped)
            attempts = attempts + active.to(torch.int32)
            done = torch.where(active, r_pass, done)
            continue
        # compaction: still-failing frames first, in index order
        count = int((~done).sum())
        if count == 0:
            break
        failing = stable_partition_perm(done)[:count]
        for c0 in range(0, count, capacity):
            sel = failing[c0 : c0 + capacity]
            bb = best_bits.index_select(0, sel)
            tr = tried.index_select(0, sel)
            forced, flipped = _flip_plan(bb, best_llrs.index_select(0, sel), tr, beta)
            r_bits, r_llrs, r_pass = decode(llr.index_select(0, sel), forced)
            best_bits[sel] = r_bits
            best_llrs[sel] = r_llrs.to(dtype)
            tried[sel] = tr | flipped
            done[sel] = r_pass
            attempts[sel] += 1

    return {
        "best_path_bits": best_bits,
        "best_path_info_llrs": best_llrs,
        "success": done,
        "attempts_used": attempts,
        "baseline_pass": base_pass,
        "baseline_bits": base_bits,
        "tried": tried,
    }


__all__ = [
    "choose_flip_index",
    "retry_with_flip",
    "decode_with_retries",
    "decode_with_retries_batch",
]
