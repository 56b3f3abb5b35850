"""PAC list decode on Hopper: wrapper of the CUDA kernel `csrc/pac_decode.cu`.

Replaces the TPU kernel `polar_code_tpu/legacy/pac_pallas.py` `_kernel_body`
(wrapper `pac_list_decode_pallas`).  `pac_list_decode_cuda` has that
wrapper's contract: llr [B, N] float32 → {"extracted" int8 [B, Kp] in
ascending-u order (the first path that passes the CRC, else the best one),
"crc_pass" bool [B]}.

On a CUDA tensor it launches the kernel, or raises for a shape the kernel
does not take; it runs the plain version (`legacy/pac.py`) only for a tensor
on the CPU.  The kernel takes every list size from 1 to 32 (one path a lane
of a warp) and any batch size: the last block is masked, since the adaptive
second stage re-decodes a ragged set of failed frames.
`pac_list_decode_cuda.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import _build
from ..ops.crc import check_matrix
from ..ops.scl_schedule import kernel_tables
from .pac import bitrev_perm, pac_list_decode_batch

SOURCE = "pac_decode.cu"
MAX_L = 32  # one path a lane
MAX_MEM = 31  # the shift register is a 32-bit mask
MAX_BLOCK_SMEM = 227 * 1024  # dynamic shared memory one block may use on an H100
MAX_FRAMES_PER_BLOCK = 4  # warps (frames) per block


def frame_bytes(N: int, Kp: int, L: int) -> int:
    """Shared memory one frame's decode state takes, rounded to 16 bytes:
    LLR rows (float32), edge-bit rows and the trace (bytes)."""

    raw = 4 * L * (N - 1) + L * (N - 1) + Kp * L
    return (raw + 15) // 16 * 16


def frames_per_block(N: int, Kp: int, L: int) -> int:
    return max(1, min(MAX_FRAMES_PER_BLOCK, MAX_BLOCK_SMEM // frame_bytes(N, Kp, L)))


def check_shape(N: int, Kp: int, L: int, gen, crc_len: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless the kernel takes this decode."""

    gen = [int(g) for g in gen]
    if dtype != torch.float32:
        raise ValueError(f"the PAC kernel decodes float32 LLRs, not {dtype}")
    if not 1 <= L <= MAX_L:
        raise ValueError(f"the PAC kernel supports list sizes 1..{MAX_L}, not {L}")
    if N < 2 or N & (N - 1) or not 0 < Kp <= N:
        raise ValueError(f"invalid code shape N={N} Kp={Kp}")
    if not gen or gen[0] != 1:
        raise ValueError("convolution generator must start with 1")
    if len(gen) - 1 > MAX_MEM:
        raise ValueError(f"the PAC kernel supports generators of memory <= {MAX_MEM}")
    if not 0 <= crc_len <= 32 or (crc_len and crc_len >= Kp):
        raise ValueError(f"the PAC kernel supports CRCs of degree <= 32 inside Kp, not {crc_len}")
    if frame_bytes(N, Kp, L) > MAX_BLOCK_SMEM:
        raise ValueError(
            f"PAC decode state for N={N} Kp={Kp} L={L} needs {frame_bytes(N, Kp, L)} bytes "
            f"of shared memory per frame, more than a block has ({MAX_BLOCK_SMEM})"
        )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.pac_decode_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_uint] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    lib.pac_decode_launch.restype = ctypes.c_int
    lib.pac_error_string.argtypes = [ctypes.c_int]
    lib.pac_error_string.restype = ctypes.c_char_p
    return lib


def host_tables(mask, crc_len: int, crc_poly: int):
    """(schedule int32 [5, N], out_pos int32 [Kp], CRC check columns uint32 [Kp]).

    The schedule is `kernel_tables` fed with the info phases (the mask in
    bit-reversed order).  out_pos[i] is the ascending-u position of the i-th
    info phase's bit; the check columns are permuted to phase order, as
    `pac_pallas.py` permutes its check matrix."""

    mask = np.asarray(mask)
    N = int(mask.size)
    perm = bitrev_perm(N)
    info_phases = np.flatnonzero(mask[perm] == 1)
    Kp = int(info_phases.size)
    sched = kernel_tables(N, info_phases)
    out_pos = np.argsort(np.argsort(perm[info_phases])).astype(np.int32)
    words = np.zeros(Kp, np.uint32)
    if crc_len > 0:
        Hc = np.asarray(check_matrix(hex((1 << crc_len) | crc_poly), Kp), np.uint64)
        weights = (np.uint64(1) << np.arange(Hc.shape[0], dtype=np.uint64))[:, None]
        words = (Hc * weights).sum(axis=0).astype(np.uint32)[out_pos]
    return sched, out_pos, words


@functools.lru_cache(maxsize=64)
def _device_tables(mask_key: tuple, crc_len: int, crc_poly: int, device: torch.device):
    sched, out_pos, words = host_tables(np.asarray(mask_key), crc_len, crc_poly)
    return (torch.as_tensor(sched, device=device), torch.as_tensor(out_pos, device=device),
            torch.as_tensor(words.view(np.int32), device=device))


def pac_list_decode_cuda(
    llr: torch.Tensor, mask, gen, L: int, crc_len: int = 0, crc_poly: int = 0,
) -> dict:
    """Fused PAC list decode of a batch: the selected path's bits in
    ascending-u order, and the CRC pass flag."""

    gen = [int(g) for g in gen]
    if llr.device.type == "cpu":
        res = pac_list_decode_batch(llr, mask, gen, L, crc_len=crc_len, crc_poly=crc_poly,
                                    dtype=llr.dtype)
        return {"extracted": res["extracted"], "crc_pass": res["crc_pass"]}
    if llr.device.type != "cuda":
        raise ValueError(f"pac_list_decode_cuda takes CUDA or CPU tensors, not {llr.device}")
    if llr.dim() != 2 or not llr.is_contiguous():
        raise ValueError("llr must be a contiguous [B, N] tensor")
    mask = np.asarray(mask)
    B, N = int(llr.shape[0]), int(llr.shape[1])
    if mask.size != N:
        raise ValueError(f"mask has {mask.size} entries for N={N}")
    Kp = int((mask == 1).sum())
    check_shape(N, Kp, L, gen, crc_len, llr.dtype)

    dev = llr.device
    bits = torch.empty((B, Kp), dtype=torch.int8, device=dev)
    passed = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return {"extracted": bits, "crc_pass": passed}
    sched, out_pos, hcols = _device_tables(tuple(int(x) for x in mask), crc_len, crc_poly, dev)
    mem = len(gen) - 1
    tap_mask = sum(1 << t for t, g in enumerate(gen[1:]) if g)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pac_decode_launch(
            llr.data_ptr(), hcols.data_ptr(), sched.data_ptr(), out_pos.data_ptr(),
            bits.data_ptr(), passed.data_ptr(),
            B, N, int(math.log2(N)), Kp, L, (1 << mem) - 1, tap_mask, int(crc_len > 0),
            frame_bytes(N, Kp, L), frames_per_block(N, Kp, L), stream,
        )
    if rc != 0:
        raise RuntimeError(f"PAC kernel launch failed: {lib.pac_error_string(rc).decode()} ({rc})")
    pac_list_decode_cuda.launches += 1
    return {"extracted": bits, "crc_pass": passed}


pac_list_decode_cuda.launches = 0


__all__ = ["pac_list_decode_cuda", "check_shape", "frame_bytes", "host_tables", "MAX_L"]
