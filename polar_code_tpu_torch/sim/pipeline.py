"""Batched Monte-Carlo steps (port of `polar_code_tpu/sim/pipeline.py`):
the FER step `make_fer_chunk` and the unified BER step `make_ber_chunk`.

    generators → payloads → CRC → encode → BPSK → AWGN → LLR → decode → counters

One call simulates `batch` frames on the device and returns summed counters
as device tensors, so the caller syncs with the host once per chunk.  In the
FER step the baseline SCL arm and the DL-SCL arm share the baseline decode.

`shard=(rank, world)` splits the frames over `world` processes, where the
JAX package takes a mesh: every rank draws and encodes the whole chunk from
the chunk's generators, keeps rows [rank·B/world, (rank+1)·B/world) and
decodes only those, and the counters count those rows.  The sum of the
ranks' counters is then the unsplit chunk's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..channel import awgn_llr, bpsk
from ..dlscl.flip import decode_with_retries_batch
from ..nr.ldpc.basegraphs import BaseGraph
from ..nr.ldpc.builder import build_h_matrix
from ..nr.ldpc.encode import encode_ldpc_batch
from ..nr.ldpc.nms_cuda import decode_ldpc_nms_cuda
from ..nr.ldpc.rate_match import derate_match_ldpc, rate_match_ldpc
from ..nr.polar.scl_nr import decode_rate_matched_scl_batch, encode_rate_matched_batch
from ..ops.adaptive import decode_scl_adaptive
from ..ops.backend import make_scl_decoder
from ..ops.crc import attach_crc_batch, crc_degree
from ..ops.polar_transform import encode_batch
from ..parallel.mesh import shard_frames
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
    shard: Tuple[int, int] = (0, 1),
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the FER-sweep step: (seed, snr_tag, chunk_idx, σ²_coded,
    σ²_uncoded) → dict of summed counters (0-d device tensors) over this
    shard's rows."""

    payload_bits = K - crc_degree(crc_poly)
    rank, world = shard
    rows = batch // world  # shard_frames raises unless world divides batch
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
        llr = shard_frames(awgn_llr(gen(_NOISE), bpsk(code), noise_var_coded, dtype=dtype),
                           rank, world)
        msg = shard_frames(msg, rank, world)

        dl = decode_with_retries_batch(
            llr, info_np, M, retries, crc=crc_poly, beta=beta,
            compact_capacity=compact,
        )
        out = {
            "scl_errors": torch.sum(~dl["baseline_pass"]),
            "dl_errors": torch.sum(~dl["success"]),
            "scl_bit_errors": torch.sum(dl["baseline_bits"] != msg),
            "dl_bit_errors": torch.sum(dl["best_path_bits"] != msg),
            "bits_coded": torch.tensor(rows * K, device=device),
            "retries_used": torch.sum(dl["attempts_used"]),
        }
        if include_uncoded:
            unc_llr = shard_frames(
                awgn_llr(gen(_UNCODED_NOISE), bpsk(payload), noise_var_uncoded, dtype=dtype),
                rank, world)
            sent = shard_frames(payload, rank, world)
            unc_errs = torch.sum((unc_llr < 0).to(torch.int8) != sent, dim=1)
            out["uncoded_errors"] = torch.sum(unc_errs > 0)
            out["uncoded_bit_errors"] = torch.sum(unc_errs)
            out["bits_uncoded"] = torch.tensor(rows * payload_bits, device=device)
        return out

    return chunk


BER_SCHEMES = ("polar_scl", "dl_scl", "nr_polar_scl", "nr_ldpc")


def make_ber_chunk(
    *,
    scheme: str,
    E: int,
    N: int,
    K_payload: int,
    K_crc: int,
    crc_poly: str,
    info_set: Optional[np.ndarray],
    M: int,
    retries: int,
    beta: Optional[torch.Tensor],
    ilv_mode: str,
    max_iter: int,
    alpha: float,
    batch: int,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    ldpc_bg: Optional[BaseGraph] = None,
    ldpc_Z: Optional[int] = None,
    nms_exact: bool = False,
    compact: int = 0,
    adaptive_from: int = 0,
    shard: Tuple[int, int] = (0, 1),
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the unified-BER-sweep step: (seed, point_idx, chunk_idx, σ²) →
    dict of summed counters (0-d device tensors).

    BER counts payload bits only; `work_sum` sums the DL-SCL flip attempts,
    the LDPC iterations, or (adaptive) the re-decoded flags.  adaptive_from >
    0 (polar_scl only) decodes at that list size first and re-decodes CRC
    failures at M.  `nr_ldpc` takes the base graph and its lifting size Z;
    its decode goes through the NMS kernel wrapper.  The counters count
    this shard's rows."""

    if scheme not in BER_SCHEMES:
        raise ValueError(f"Unsupported scheme: {scheme}")
    if adaptive_from and scheme != "polar_scl":
        raise ValueError("--adaptive_from is only supported for polar_scl")
    if adaptive_from and K_crc == 0:
        raise ValueError("adaptive decoding needs a CRC (K_crc > 0)")
    if adaptive_from and adaptive_from >= M:
        raise ValueError(
            f"adaptive_from ({adaptive_from}) must be < M ({M}): the second "
            "stage must use a strictly larger list than the first"
        )
    rank, world = shard
    rows = batch // world  # shard_frames raises unless world divides batch
    H = None
    if scheme == "nr_ldpc":
        if ldpc_bg is None or ldpc_Z is None:
            raise ValueError("nr_ldpc needs the base graph and Z")
        H = build_h_matrix(ldpc_bg, ldpc_Z)
    info_np = np.asarray(info_set) if info_set is not None else None
    if beta is not None:
        beta = beta.to(device=device, dtype=dtype)
    decode = None
    if scheme == "polar_scl" and not adaptive_from:
        # builds the routing once, and raises early for a shape the kernel does not take
        decode = make_scl_decoder(info_np, M, crc_poly, device=device, dtype=dtype, N=N)

    def chunk(seed: int, point_idx: int, chunk_idx: int, noise_var: float) -> Dict[str, torch.Tensor]:
        def gen(stream: int) -> torch.Generator:
            return make_generator(seed, point_idx, chunk_idx, stream, device=device)

        payload = torch.randint(
            0, 2, (batch, K_payload), generator=gen(_PAYLOAD), device=device,
            dtype=torch.int8,
        )
        if scheme == "nr_polar_scl":
            codeword = encode_rate_matched_batch(payload, crc_poly, N, E, info_np, ilv_mode)
        else:
            msg = attach_crc_batch(payload, crc_poly) if K_crc else payload
            if scheme == "nr_ldpc":
                codeword = rate_match_ldpc(encode_ldpc_batch(msg, H), E)
            else:
                codeword = encode_batch(msg, info_np, N)
        llr = shard_frames(awgn_llr(gen(_NOISE), bpsk(codeword), noise_var, dtype=dtype),
                           rank, world)
        payload = shard_frames(payload, rank, world)

        work = None
        if scheme == "polar_scl" and adaptive_from:
            res = decode_scl_adaptive(llr, info_np, adaptive_from, M, crc_poly,
                                      dtype=dtype, capacity=compact)
            bits = res["best_path_bits"]
            work = res["second_stage"]
        elif scheme == "polar_scl":
            bits = decode(llr)[0]
        elif scheme == "dl_scl":
            res = decode_with_retries_batch(
                llr, info_np, M, retries, crc=crc_poly, beta=beta,
                compact_capacity=compact,
            )
            bits = res["best_path_bits"]
            work = res["attempts_used"]
        elif scheme == "nr_polar_scl":
            bits = decode_rate_matched_scl_batch(
                llr, crc_poly, N, E, info_np, M, ilv_mode, dtype=dtype,
            )["best_path_bits"]
        else:  # nr_ldpc
            internal = derate_match_ldpc(llr, int(H.shape[1])).contiguous()
            res = decode_ldpc_nms_cuda(
                internal, ldpc_bg, ldpc_Z, max_iter=max_iter, alpha=alpha,
                self_exclude=nms_exact, H=H,
            )
            bits = res["hard"]
            work = res["iters_used"]

        frame_bit_errs = torch.sum(bits[:, :K_payload] != payload, dim=1)
        return {
            "bit_errors": torch.sum(frame_bit_errs),
            "frame_errors": torch.sum(frame_bit_errs > 0),
            "bits_total": torch.tensor(rows * K_payload, device=device),
            "frames": torch.tensor(rows, device=device),
            "work_sum": (torch.sum(work.to(torch.float32)) if work is not None
                         else torch.zeros((), device=device)),
        }

    return chunk


__all__ = ["make_fer_chunk", "make_ber_chunk", "BER_SCHEMES"]
