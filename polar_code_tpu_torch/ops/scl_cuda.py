"""SCL list decode on Hopper: wrapper of the CUDA kernel `csrc/scl_decode.cu`.

Replaces the TPU kernel `polar_code_tpu/ops/scl_pallas.py` `_kernel_body`
(wrapper `decode_scl_pallas`).  `decode_scl_cuda` has the JAX wrapper's
contract: llr [B, N] float32 → {"best_path_bits" int8 [B, K],
"best_path_info_llrs" float32 [B, K], "crc_pass" bool [B]}, with an optional
forced plan int8 [B, K] (−1 free / 0 / 1).  With `full=True` it also returns
the whole final list, the fields of the plain `SCLResult` that the scalar API
(`polar/api.py::decode_scl`) reads: "candidates" int8 [B, M, K], "metrics"
float32 [B, M] (+inf for a path never reached), "valid" bool [B, M],
"info_llrs" float32 [B, M, K] and "best_index" int32 [B], in the final
stable (metric, slot) order; the kernel's LIST instantiation writes them.

On a CUDA tensor it launches the kernel, or raises for a shape the kernel
does not take; it runs the plain version (`ops/scl.py`) only for a tensor on
the CPU.  Any batch size is taken: the last block is masked, since the retry
batches after compaction are data-dependent.  `decode_scl_cuda.launches`
counts kernel launches.

Memory.  A frame keeps tree levels G+1..n of its M paths, and its trace
indices, in shared memory; levels 1..G and the trace LLRs go to a global
scratch allocated here for each call.  `launch_plan` asks the CUDA
occupancy calculator for the smallest G at which an SM holds
`FRAMES_PER_SM_TARGET` frames (`smallest_global_levels`, which the PAC
kernel's wrapper shares), and for the frames a block that hold the most.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from .. import _build
from .crc import check_matrix, crc_degree
from .scl import decode_scl_batch
from .scl_schedule import phase_words

SOURCE = "scl_decode.cu"
SUPPORTED_M = (1, 2, 4, 8)
# the north star's envelope, N up to 2048, is what the kernel is held to; in
# it a frame's state fits a block once enough levels go to global scratch
MAX_N = 2048
MAX_BLOCK_SMEM = 227 * 1024  # dynamic shared memory one block may use on an H100
FRAMES_PER_SM_TARGET = 16
# the outputs of every launch, and those `full=True` adds (the plain
# `SCLResult`'s names), in the order of the kernel's arguments; "valid" is
# worked out from the metrics
BEST_FIELDS = ("best_path_bits", "best_path_info_llrs", "crc_pass")
LIST_FIELDS = ("candidates", "info_llrs", "metrics", "best_index", "valid")


def frame_bytes(N: int, K: int, M: int, global_levels: int = 0) -> int:
    """Shared memory one frame's decode state takes, rounded to 16 bytes:
    the LLR rows (float32) and partial-sum rows (bytes) of levels
    global_levels+1..n, and the trace indices (bytes)."""

    row = (N >> global_levels) - 1
    raw = 4 * M * row + M * row + K * M
    return (raw + 15) // 16 * 16


def check_shape(N: int, K: int, M: int, crc: Optional[str], dtype: torch.dtype) -> None:
    """Raise ValueError unless the kernel takes this decode."""

    if dtype != torch.float32:
        raise ValueError(f"the SCL kernel decodes float32 LLRs, not {dtype}")
    if M not in SUPPORTED_M:
        raise ValueError(f"the SCL kernel supports M in {SUPPORTED_M}, not {M}")
    if N < 2 or N & (N - 1) or not 0 < K <= N:
        raise ValueError(f"invalid code shape N={N} K={K}")
    if N > MAX_N:
        raise ValueError(f"the SCL kernel takes N up to {MAX_N}, not {N}")
    if crc is not None and crc_degree(crc) > 32:
        raise ValueError("the SCL kernel supports CRCs of degree <= 32")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.scl_decode_launch.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.scl_decode_launch.restype = ctypes.c_int
    lib.scl_launch_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.scl_launch_plan.restype = ctypes.c_int
    lib.scl_error_string.argtypes = [ctypes.c_int]
    lib.scl_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _occupancy(N: int, K: int, M: int, G: int) -> tuple:
    """(frames a block, frames an SM holds at once) with levels 1..G in
    global scratch, by the CUDA occupancy calculator (shared memory,
    registers, warps): the frames a block that let an SM hold the most."""

    lib = _library()
    fpb, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.scl_launch_plan(M, frame_bytes(N, K, M, G), MAX_BLOCK_SMEM,
                             ctypes.byref(fpb), ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"SCL occupancy query failed: {lib.scl_error_string(rc).decode()} ({rc})")
    return fpb.value, per_sm.value


def smallest_global_levels(n: int, occupancy) -> tuple:
    """(G, frames a block, frames an SM) for a decode kernel whose tree levels
    1..G go to global scratch: the smallest G at which `occupancy(G)` — (frames
    a block, frames an SM) by the CUDA occupancy calculator — puts
    `FRAMES_PER_SM_TARGET` frames on an SM or, where no G does, the smallest G
    that puts the most there.  Level n, the leaf, always stays in shared
    memory.  The SCL and PAC kernels both take their G here."""

    plans = []
    for g in range(n):
        fpb, per_sm = occupancy(g)
        if per_sm >= FRAMES_PER_SM_TARGET:
            return g, fpb, per_sm
        plans.append((g, fpb, per_sm))
    most = max(p[2] for p in plans)
    return next(p for p in plans if p[2] == most)


@functools.lru_cache(maxsize=None)
def launch_plan(N: int, K: int, M: int) -> tuple:
    """(global levels G, frames a block, frames an SM holds at once) on the
    current card, by `smallest_global_levels`."""

    return smallest_global_levels(int(math.log2(N)), lambda g: _occupancy(N, K, M, g))


@functools.lru_cache(maxsize=64)
def _device_tables(info_key: tuple, N: int, crc: Optional[str], device: torch.device):
    """Schedule words int32 [N] and CRC check columns as 32-bit words [K]."""

    info_np = np.asarray(info_key, np.int64)
    sched = torch.as_tensor(phase_words(N, info_np), device=device)
    K = len(info_key)
    words = np.zeros(K, np.uint32)
    if crc is not None:
        Hc = np.asarray(check_matrix(crc, K), np.uint64)
        weights = (np.uint64(1) << np.arange(Hc.shape[0], dtype=np.uint64))[:, None]
        words = (Hc * weights).sum(axis=0).astype(np.uint32)
    hcols = torch.as_tensor(words.view(np.int32), device=device)
    return sched, hcols


def decode_scl_cuda(
    llr: torch.Tensor,
    info_set,
    M: int,
    crc: Optional[str] = None,
    *,
    force_info_bits: Optional[torch.Tensor] = None,
    full: bool = False,
) -> dict:
    """Fused SCL decode of a batch: the CRC-selected path's bits and info
    LLRs, and the CRC pass flag; with `full`, also the whole final list."""

    info_np = np.asarray(info_set, np.int64)
    if llr.device.type == "cpu":
        res = decode_scl_batch(
            llr, info_np, M, crc, force_info_bits=force_info_bits, dtype=llr.dtype
        )
        fields = BEST_FIELDS + (LIST_FIELDS if full else ())
        return {f: getattr(res, f) for f in fields}
    if llr.device.type != "cuda":
        raise ValueError(f"decode_scl_cuda takes CUDA or CPU tensors, not {llr.device}")
    if llr.dim() != 2 or not llr.is_contiguous():
        raise ValueError("llr must be a contiguous [B, N] tensor")
    B, N = int(llr.shape[0]), int(llr.shape[1])
    K = int(info_np.size)
    check_shape(N, K, M, crc, llr.dtype)
    if force_info_bits is not None:
        f = force_info_bits
        if (f.device != llr.device or f.dtype != torch.int8 or tuple(f.shape) != (B, K)
                or not f.is_contiguous()):
            raise ValueError(f"force_info_bits must be a contiguous int8 [{B}, {K}] tensor on {llr.device}")
    G, fpb, _ = launch_plan(N, K, M)
    return _launch(llr, info_np, M, crc, force_info_bits, G, fpb, full)


def _launch(llr, info_np, M, crc, force_info_bits, G, fpb, full=False) -> dict:
    """Launch the kernel on checked inputs, with levels 1..G in global
    scratch and fpb frames a block (`chip_smoke.py` times other G here);
    `full` launches the list instantiation."""

    B, N = int(llr.shape[0]), int(llr.shape[1])
    K = int(info_np.size)
    dev = llr.device
    out = {"best_path_bits": torch.empty((B, K), dtype=torch.int8, device=dev),
           "best_path_info_llrs": torch.empty((B, K), dtype=torch.float32, device=dev),
           "crc_pass": torch.empty((B,), dtype=torch.bool, device=dev)}
    if full:
        out.update(candidates=torch.empty((B, M, K), dtype=torch.int8, device=dev),
                   info_llrs=torch.empty((B, M, K), dtype=torch.float32, device=dev),
                   metrics=torch.empty((B, M), dtype=torch.float32, device=dev),
                   best_index=torch.empty((B,), dtype=torch.int32, device=dev))
    if B > 0:
        sched, hcols = _device_tables(tuple(int(i) for i in info_np), N, crc, dev)
        row = N - (N >> G)  # entries of a path's levels 1..G
        glob_llr = torch.empty((B, M, row), dtype=torch.float32, device=dev) if G else None
        glob_bits = torch.empty((B, M, row), dtype=torch.uint8, device=dev) if G else None
        trace_llr = torch.empty((B, K, M), dtype=torch.float32, device=dev)
        lists = [out[f].data_ptr() if full else None for f in LIST_FIELDS[:4]]
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.scl_decode_launch(
                llr.data_ptr(),
                force_info_bits.data_ptr() if force_info_bits is not None else None,
                hcols.data_ptr(), sched.data_ptr(),
                glob_llr.data_ptr() if G else None, glob_bits.data_ptr() if G else None,
                trace_llr.data_ptr(),
                *(out[f].data_ptr() for f in BEST_FIELDS), *lists,
                B, N, int(math.log2(N)), K, M, G, int(crc is not None),
                frame_bytes(N, K, M, G), fpb, stream,
            )
        if rc != 0:
            raise RuntimeError(f"SCL kernel launch failed: {lib.scl_error_string(rc).decode()} ({rc})")
        decode_scl_cuda.launches += 1
    if full:
        out["valid"] = torch.isfinite(out["metrics"])
    return out


decode_scl_cuda.launches = 0


__all__ = ["decode_scl_cuda", "check_shape", "frame_bytes", "launch_plan", "smallest_global_levels",
           "SUPPORTED_M"]
