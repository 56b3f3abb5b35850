"""Layered NMS LDPC decode on Hopper: wrapper of the CUDA kernel
`csrc/nms_decode.cu` (kernel K2).

Replaces the TPU kernel `polar_code_tpu/nr/ldpc/nms_pallas.py` `_kernel_body`
(wrapper `decode_ldpc_nms_pallas`).  `decode_ldpc_nms_cuda` takes LLRs
float32 [B, nb·Z] of a code lifted from `base_graph` at `Z` and returns
{"hard" int8 [B, n], "iters_used" int32 [B], "parity_ok" bool [B]}, the
contract of the plain version `decode_nms.decode_ldpc_nms_batch`, with early
stop or (`early_stop=False`) without.

On a CUDA tensor it launches the kernel, or raises for a shape the kernel
does not take; it runs the plain version only for a tensor on the CPU.  Any
batch size is taken.  `decode_ldpc_nms_cuda.launches` counts kernel launches,
and `decode_ldpc_nms_cuda.no_stop_launches` those of them without early stop.

The kernel's design is in its source note.  This module lays it out:
`kernel_layout` picks the mode (WARP: a warp a frame and several frames a
block, at Z <= 32 when the tables fit; else BLOCK: a block of ceil(Z/32)
warps a frame), the edges a row keeps in registers (8 or 32, from the
graph's largest row degree), the record words a row and where the records
live; `host_tables` builds the column tables; `launch_plan` asks the CUDA
occupancy calculator for the frames a block and an SM.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
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
WARP, BLOCK, BLOCK_1024 = 0, 1, 2  # kernel modes (`csrc/nms_decode.cu`)
DEGREE_BUCKETS = (8, 32)  # edges a row keeps in registers; longer rows go in 32-edge chunks
MAX_FRAMES_PER_BLOCK = 32  # WARP: a warp a frame, 1024 threads


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


@dataclass(frozen=True)
class Layout:
    """Where the kernel keeps what, for one (graph, Z, mode of min)."""

    mode: int  # WARP or BLOCK (`launch_plan` may make BLOCK BLOCK_1024)
    D: int  # edges a row keeps in registers
    nw: int  # record words a row: 1 (shared min) or 3 + sign words (two-min)
    col_chunks: int  # WARP: 8-edge chunks of the column table (1 KB each)
    tables_bytes: int  # WARP: block-shared tables (column table, row table)
    frame_bytes: int  # WARP: bytes a frame; BLOCK: the block's bytes
    rec_offset: int  # byte offset of the records (a WARP frame's or the BLOCK's); 0: global scratch

    @property
    def records_in_smem(self) -> bool:
        return self.mode == WARP or self.rec_offset > 0

    def block_bytes(self, frames_per_block: int = 1) -> int:
        if self.mode == WARP:
            return self.tables_bytes + frames_per_block * self.frame_bytes
        return self.frame_bytes


def _degrees(shifts: np.ndarray) -> np.ndarray:
    return (np.asarray(shifts) >= 0).sum(axis=1)


def kernel_layout(shifts: np.ndarray, Z: int, self_exclude: bool) -> Layout:
    """The kernel's layout for a base graph's shifts [mb, nb] lifted at Z.

    WARP: a block holds the column table [chunk][half][32 lanes] of four u32
    (1024 bytes an 8-edge chunk of a row) and a row table (8 bytes a row); a frame
    its LLRs [n] float32, then its records [mb][nw][32 lanes] of 4 bytes.
    BLOCK: the edge table (8 bytes an edge), the LLRs, row_ptr [mb+1] int32,
    then, when the block has room, the records [mb][nw][Z] at the next
    16-byte boundary; else in global scratch."""

    mb, nb = np.asarray(shifts).shape
    n = nb * Z
    deg = _degrees(shifts)
    deg_max = int(deg.max()) if mb else 0
    D = next((d for d in DEGREE_BUCKETS if deg_max <= d), DEGREE_BUCKETS[-1])
    nw = 3 + max(1, -(-deg_max // 32)) if self_exclude else 1
    E = int(deg.sum())
    if Z <= 32:
        chunks = int((-(-deg // 8)).sum())
        tables = _align16(1024 * chunks + 8 * mb)
        frame = _align16(4 * n) + 4 * mb * nw * 32
        if tables + frame <= MAX_BLOCK_SMEM:
            return Layout(WARP, D, nw, chunks, tables, frame, _align16(4 * n))
    tables_end = 8 * E + 4 * n + 4 * (mb + 1)
    rec_bytes = 4 * mb * nw * Z
    if _align16(tables_end) + rec_bytes <= MAX_BLOCK_SMEM:
        return Layout(BLOCK, D, nw, 0, 0, _align16(tables_end) + rec_bytes, _align16(tables_end))
    return Layout(BLOCK, D, nw, 0, 0, tables_end, 0)


def host_tables(shifts: np.ndarray, Z: int, layout: Layout):
    """(row table, column table) for the kernel, as numpy arrays.

    Columns are byte offsets into a frame's LLRs.  WARP: rows int32 [mb, 2]
    = (first 8-edge chunk, degree); columns int32 [chunks, 2, 32, 4], entry
    (k, h, z, i) the column of lane z's edge 4h + i of chunk k (0 for a lane
    z >= Z or past the row's end).  BLOCK: row_ptr int32 [mb+1] (edges of
    block-row r: row_ptr[r]..row_ptr[r+1], in column order) and int32
    [E, 2] = (4s, 4c·Z), s the shift mod Z."""

    shifts = np.asarray(shifts)
    mb = shifts.shape[0]
    blocks = [[(c, int(s) % Z) for c, s in enumerate(row) if s >= 0] for row in shifts]
    if layout.mode == WARP:
        rows = np.zeros((mb, 2), np.int32)
        cols = np.zeros((layout.col_chunks, 2, 32, 4), np.int32)
        z = np.arange(Z)
        k = 0
        for r, row in enumerate(blocks):
            rows[r] = (k, len(row))
            for j, (c, s) in enumerate(row):
                cols[k + j // 8, j % 8 // 4, :Z, j % 4] = 4 * (c * Z + (z + s) % Z)
            k += -(-len(row) // 8)
        return rows, cols
    row_ptr = np.cumsum([0] + [len(row) for row in blocks]).astype(np.int32)
    edges = np.array([(4 * s, 4 * c * Z) for row in blocks for c, s in row],
                     np.int32).reshape(-1, 2)
    return row_ptr, edges


def check_shape(base_graph: BaseGraph, Z: int, n: int, dtype: torch.dtype,
                self_exclude: bool) -> None:
    """Raise ValueError unless the kernel takes this decode."""

    shifts = np.asarray(base_graph.shifts)
    _check_call(shifts.shape, Z, n, dtype)
    _check_graph(shifts, Z, self_exclude)


def _check_call(shape: tuple, Z: int, n: int, dtype: torch.dtype) -> None:
    if dtype != torch.float32:
        raise ValueError(f"the NMS kernel decodes float32 LLRs, not {dtype}")
    if not 1 <= Z <= MAX_Z:
        raise ValueError(f"the NMS kernel takes lifting sizes 1..{MAX_Z}, not Z={Z}")
    if n != shape[1] * Z:
        raise ValueError(f"llr length {n} is not nb*Z = {shape[1]}*{Z}")


def _check_graph(shifts: np.ndarray, Z: int, self_exclude: bool) -> None:
    mb, nb = shifts.shape
    n = nb * Z
    deg = _degrees(shifts)
    if self_exclude and mb and int(deg.min()) < 2:
        raise ValueError(
            "self_exclude=True needs every check row to have degree >= 2 "
            f"(base graph has a {int(deg.min())}-block row)"
        )
    layout = kernel_layout(shifts, Z, self_exclude)
    if layout.block_bytes() > MAX_BLOCK_SMEM:
        raise ValueError(
            f"a frame of n={n} LLRs needs {layout.block_bytes()} bytes of shared memory, more "
            f"than a block has ({MAX_BLOCK_SMEM})"
        )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.nms_decode_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    )
    lib.nms_decode_launch.restype = ctypes.c_int
    lib.nms_occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.nms_occupancy.restype = ctypes.c_int
    lib.nms_error_string.argtypes = [ctypes.c_int]
    lib.nms_error_string.restype = ctypes.c_char_p
    return lib


def _occupancy(D: int, se: bool, mode: int, threads: int, smem: int) -> tuple:
    """(blocks an SM holds at once, registers a thread, most threads a block)."""

    lib = _library()
    blocks, regs, max_threads = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.nms_occupancy(D, int(se), mode, threads, smem, ctypes.byref(blocks),
                           ctypes.byref(regs), ctypes.byref(max_threads))
    if rc != 0:
        raise RuntimeError(f"NMS occupancy query failed: {lib.nms_error_string(rc).decode()} ({rc})")
    return blocks.value, regs.value, max_threads.value


@dataclass(frozen=True)
class LaunchPlan:
    layout: Layout
    mode: int  # the kernel launched: WARP, BLOCK or BLOCK_1024
    frames_per_block: int
    frames_per_sm: int
    threads: int
    smem: int
    regs: int


def _plan_for(layout: Layout, Z: int, se: bool) -> LaunchPlan:
    if layout.mode == WARP:
        # the fewest frames a block that reach the most frames an SM: a
        # block holds its SM's room until its slowest warp is done
        best = None
        for fpb in range(1, MAX_FRAMES_PER_BLOCK + 1):
            smem = layout.block_bytes(fpb)
            if smem > MAX_BLOCK_SMEM:
                break
            blocks, regs, _ = _occupancy(layout.D, se, WARP, 32 * fpb, smem)
            if best is None or blocks * fpb > best.frames_per_sm:
                best = LaunchPlan(layout, WARP, fpb, blocks * fpb, 32 * fpb, smem, regs)
        return best
    threads = 32 * -(-Z // 32)
    smem = layout.block_bytes()
    blocks, regs, max_threads = _occupancy(layout.D, se, BLOCK, threads, smem)
    if threads > max_threads:  # too many registers for this block: the 64-register build
        blocks, regs, _ = _occupancy(layout.D, se, BLOCK_1024, threads, smem)
        return LaunchPlan(layout, BLOCK_1024, 1, blocks, threads, smem, regs)
    return LaunchPlan(layout, BLOCK, 1, blocks, threads, smem, regs)


@functools.lru_cache(maxsize=64)
def _plan(shifts_bytes: bytes, shape: tuple, Z: int, se: bool, device: torch.device):
    """Checked layout, launch plan and device tables for one code (cached)."""

    shifts = np.frombuffer(shifts_bytes, dtype=np.int64).reshape(shape)
    _check_graph(shifts, Z, se)
    layout = kernel_layout(shifts, Z, se)
    with torch.cuda.device(device):
        plan = _plan_for(layout, Z, se)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    if plan.frames_per_sm < 1:
        raise ValueError(f"the NMS kernel cannot hold a block of this code on an SM ({plan})")
    rows, cols = host_tables(shifts, Z, layout)
    tabs = tuple(torch.from_numpy(t).to(device) for t in (rows, cols))
    return plan, sms, int((shifts >= 0).sum()), tabs


def launch_plan(base_graph: BaseGraph, Z: int, self_exclude: bool,
                device: Optional[torch.device] = None) -> LaunchPlan:
    """The launch plan on the card (frames a block and an SM, registers)."""

    shifts = np.ascontiguousarray(base_graph.shifts, dtype=np.int64)
    dev = torch.device("cuda") if device is None else device
    return _plan(shifts.tobytes(), shifts.shape, Z, bool(self_exclude), dev)[0]


def decode_ldpc_nms_cuda(
    llr: torch.Tensor,
    base_graph: BaseGraph,
    Z: int,
    max_iter: int = 20,
    alpha: float = 0.8,
    early_stop: bool = True,
    *,
    self_exclude: bool = False,
    H: Optional[np.ndarray] = None,
) -> dict:
    """Layered NMS decode of a batch; shared min, or two-min under
    `self_exclude`; with early stop, or (`early_stop=False`) `max_iter`
    iterations for every frame.  `H`, the lifted parity-check matrix, is
    read only by the plain version on a CPU tensor (built from the base
    graph when not given); the kernel works from the base graph's shifts."""

    if llr.device.type == "cpu":
        return decode_ldpc_nms_batch(
            llr, H if H is not None else build_h_matrix(base_graph, Z), max_iter=max_iter,
            alpha=alpha, early_stop=early_stop, self_exclude=self_exclude, dtype=llr.dtype,
        )
    if llr.device.type != "cuda":
        raise ValueError(f"decode_ldpc_nms_cuda takes CUDA or CPU tensors, not {llr.device}")
    if llr.dim() != 2 or not llr.is_contiguous():
        raise ValueError("llr must be a contiguous [B, n] tensor")
    B, n = int(llr.shape[0]), int(llr.shape[1])
    shifts = np.ascontiguousarray(base_graph.shifts, dtype=np.int64)
    _check_call(shifts.shape, Z, n, llr.dtype)
    # the graph's checks, layout, plan and tables, once a code
    dev = llr.device
    plan, sms, E, (rows, cols) = _plan(shifts.tobytes(), shifts.shape, Z, bool(self_exclude), dev)
    hard = torch.empty((B, n), dtype=torch.int8, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return {"hard": hard, "iters_used": iters, "parity_ok": ok}
    lay = plan.layout
    mb = shifts.shape[0]
    grid = min(-(-B // plan.frames_per_block), plan.frames_per_sm // plan.frames_per_block * sms)
    scratch = None
    if not lay.records_in_smem:
        scratch = torch.empty((grid, mb * lay.nw * Z), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):  # the launch goes to the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nms_decode_launch(
            llr.data_ptr(), rows.data_ptr(), cols.data_ptr(), hard.data_ptr(), iters.data_ptr(),
            ok.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            B, mb, n, Z, E, int(max_iter), float(alpha), int(early_stop), lay.nw, lay.col_chunks,
            lay.tables_bytes, lay.frame_bytes, lay.rec_offset, plan.frames_per_block, lay.D,
            int(self_exclude), plan.mode, grid, plan.threads, plan.smem, stream,
        )
    if rc != 0:
        raise RuntimeError(f"NMS kernel launch failed: {lib.nms_error_string(rc).decode()} ({rc})")
    decode_ldpc_nms_cuda.launches += 1
    if not early_stop:
        decode_ldpc_nms_cuda.no_stop_launches += 1
    return {"hard": hard, "iters_used": iters, "parity_ok": ok}


decode_ldpc_nms_cuda.launches = 0
decode_ldpc_nms_cuda.no_stop_launches = 0  # of them, launches without early stop


__all__ = ["decode_ldpc_nms_cuda", "check_shape", "host_tables", "kernel_layout", "launch_plan",
           "Layout", "LaunchPlan"]
