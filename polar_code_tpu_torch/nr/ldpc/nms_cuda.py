"""Layered NMS LDPC decode on Hopper: wrapper of the CUDA kernel
`csrc/nms_decode.cu` (kernel K2).

Replaces the TPU kernel `polar_code_tpu/nr/ldpc/nms_pallas.py` `_kernel_body`
(wrapper `decode_ldpc_nms_pallas`).  `decode_ldpc_nms_cuda` takes LLRs
float32 [B, nb·Z] of a code lifted from `base_graph` at `Z` and returns
{"hard" int8 [B, n], "iters_used" int32 [B], "parity_ok" bool [B]}, the
contract of the plain version `decode_nms.decode_ldpc_nms_batch`.

On a CUDA tensor it launches the kernel, or raises for a shape the kernel
does not take; it runs the plain version only for a tensor on the CPU.  Any
batch size is taken.  `decode_ldpc_nms_cuda.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ... import _build
from .basegraphs import BaseGraph
from .builder import build_h_matrix
from .decode_nms import decode_ldpc_nms_batch

SOURCE = "nms_decode.cu"
MAX_Z = 1024  # one thread a check row of a block-row
MAX_BLOCK_SMEM = 227 * 1024  # dynamic shared memory one block may use on an H100


def _shifts_key(base_graph: BaseGraph) -> tuple:
    return tuple(tuple(int(v) for v in row) for row in np.asarray(base_graph.shifts))


def edge_tables(shifts_key: tuple, Z: int):
    """(row_ptr [mb+1], edge_col [E], edge_shift [E]) int32: the nonzero
    blocks of each block-row in column order, shifts reduced mod Z."""

    row_ptr, cols, shifts = [0], [], []
    for row in shifts_key:
        for c, s in enumerate(row):
            if s >= 0:
                cols.append(c)
                shifts.append(s % Z)
        row_ptr.append(len(cols))
    as32 = functools.partial(np.asarray, dtype=np.int32)
    return as32(row_ptr), as32(cols), as32(shifts)


def smem_plan(n: int, mb: int, E: int, Z: int, self_exclude: bool):
    """(shared bytes a block, byte offset of the messages in shared memory,
    or 0 for global scratch).  The kernel's layout: LLRs [n] float32, then
    row_ptr [mb+1], edge_col [E] and edge_shift [E] int32, then, when the
    block has room, the messages at the next 16-byte boundary."""

    tables_end = (4 * n + 4 * (mb + 1) + 8 * E + 15) // 16 * 16
    msg_bytes = 4 * (E if self_exclude else mb) * Z
    if tables_end + msg_bytes <= MAX_BLOCK_SMEM:
        return tables_end + msg_bytes, tables_end
    return tables_end, 0


def check_shape(base_graph: BaseGraph, Z: int, n: int, dtype: torch.dtype,
                self_exclude: bool) -> None:
    """Raise ValueError unless the kernel takes this decode."""

    if dtype != torch.float32:
        raise ValueError(f"the NMS kernel decodes float32 LLRs, not {dtype}")
    if not 1 <= Z <= MAX_Z:
        raise ValueError(f"the NMS kernel takes lifting sizes 1..{MAX_Z}, not Z={Z}")
    mb, nb = np.asarray(base_graph.shifts).shape
    if n != nb * Z:
        raise ValueError(f"llr length {n} is not nb*Z = {nb}*{Z}")
    row_ptr, _, _ = edge_tables(_shifts_key(base_graph), Z)
    if self_exclude and mb and int(np.min(np.diff(row_ptr))) < 2:
        raise ValueError(
            "self_exclude=True needs every check row to have degree >= 2 "
            f"(base graph has a {int(np.min(np.diff(row_ptr)))}-block row)"
        )
    smem, _ = smem_plan(n, mb, int(row_ptr[-1]), Z, self_exclude)
    if smem > MAX_BLOCK_SMEM:
        raise ValueError(
            f"a frame of n={n} LLRs needs {smem} bytes of shared memory, more than a "
            f"block has ({MAX_BLOCK_SMEM})"
        )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.nms_decode_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    lib.nms_decode_launch.restype = ctypes.c_int
    lib.nms_error_string.argtypes = [ctypes.c_int]
    lib.nms_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=16)
def _device_tables(shifts_key: tuple, Z: int, device: torch.device):
    return tuple(torch.as_tensor(t, device=device) for t in edge_tables(shifts_key, Z))


def decode_ldpc_nms_cuda(
    llr: torch.Tensor,
    base_graph: BaseGraph,
    Z: int,
    max_iter: int = 20,
    alpha: float = 0.8,
    *,
    self_exclude: bool = False,
    H: Optional[np.ndarray] = None,
) -> dict:
    """Layered NMS decode of a batch with early stop; shared min, or two-min
    under `self_exclude`.  `H`, the lifted parity-check matrix, is read only
    by the plain version on a CPU tensor (built from the base graph when
    not given); the kernel works from the base graph's shifts."""

    if llr.device.type == "cpu":
        return decode_ldpc_nms_batch(
            llr, H if H is not None else build_h_matrix(base_graph, Z), max_iter=max_iter,
            alpha=alpha, self_exclude=self_exclude, dtype=llr.dtype,
        )
    if llr.device.type != "cuda":
        raise ValueError(f"decode_ldpc_nms_cuda takes CUDA or CPU tensors, not {llr.device}")
    if llr.dim() != 2 or not llr.is_contiguous():
        raise ValueError("llr must be a contiguous [B, n] tensor")
    B, n = int(llr.shape[0]), int(llr.shape[1])
    check_shape(base_graph, Z, n, llr.dtype, self_exclude)

    dev = llr.device
    hard = torch.empty((B, n), dtype=torch.int8, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return {"hard": hard, "iters_used": iters, "parity_ok": ok}
    key = _shifts_key(base_graph)
    row_ptr, edge_col, edge_shift = _device_tables(key, Z, dev)
    mb, E = len(key), int(edge_col.numel())
    smem, msg_offset = smem_plan(n, mb, E, Z, self_exclude)
    scratch = None
    if not msg_offset:
        scratch = torch.empty((B, E if self_exclude else mb, Z), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nms_decode_launch(
            llr.data_ptr(), row_ptr.data_ptr(), edge_col.data_ptr(), edge_shift.data_ptr(),
            hard.data_ptr(), iters.data_ptr(), ok.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, mb, n, Z, E, int(max_iter), float(alpha), int(self_exclude),
            msg_offset, smem, stream,
        )
    if rc != 0:
        raise RuntimeError(f"NMS kernel launch failed: {lib.nms_error_string(rc).decode()} ({rc})")
    decode_ldpc_nms_cuda.launches += 1
    return {"hard": hard, "iters_used": iters, "parity_ok": ok}


decode_ldpc_nms_cuda.launches = 0


__all__ = ["decode_ldpc_nms_cuda", "check_shape", "edge_tables", "smem_plan"]
