"""PAC list decode on Hopper: wrapper of the CUDA kernel `csrc/pac_decode.cu`.

Replaces the TPU kernel `polar_code_tpu/legacy/pac_pallas.py` `_kernel_body`
(wrapper `pac_list_decode_pallas`).  `pac_list_decode_cuda` has that
wrapper's contract: llr [B, N] float32 → {"extracted" int8 [B, Kp] in
ascending-u order (the first path that passes the CRC, else the best one),
"crc_pass" bool [B]}.  With `full=True` it also returns the whole final
list, the plain version's fields, in its final stable (metric, slot) order:
"v_full" int8 [B, L, N] (message bits by u index), "candidates" int8
[B, L, Kp], "metrics" float32 [B, L] (+inf for a dead path), "valid" bool
[B, L] and the selected rank "best_index" int64 [B]; the kernel's LIST
instantiation writes them (the systematic scalar decoder,
`legacy/polar_code.py`, reads them).

On a CUDA tensor it launches the kernel, or raises for a shape the kernel
does not take; it runs the plain version (`legacy/pac.py`) only for a tensor
on the CPU.  The kernel takes every list size from 1 to 8192 (the TPU
kernel took power-of-two L <= 8 and N up to 8192, and the JAX package's XLA
decoder takes the rest), N up to 65536 (the phase words' limit), and any
batch size: the last block is masked, since the adaptive second stage
re-decodes a ragged set of failed frames.  Up to L=32 one path is a lane of
a warp (past N=8192 at L 17..32 and 9..16, a wide twin with one more σ
word); from 33 to 1024 a frame is spread over the warps of a block, one
thread a path (the over-warps instantiation, with a wide twin for 16-bit
σ rows past N=8192); from 1025 to 8192 over a thread-block cluster of
`ops/scl_cuda.py::cluster_blocks(L)` blocks of 1024 threads, one thread a
path (the cluster instantiation).  A batch goes, as the SCL kernel's, in
launches whose global scratch fits the card's free memory
(`ops/scl_cuda.py::alloc_scratch`).
`pac_list_decode_cuda.launches` counts kernel launches,
`pac_list_decode_cuda.list_launches` those of them that went to a list
instantiation, `pac_list_decode_cuda.deep_launches` those that went to an
over-warps one and `pac_list_decode_cuda.cluster_launches` those that went
to a cluster one.

The kernel's design (its source note has the whole of it): the TPU
kernel's lazy clone — path m writes row m, per-level path-origin maps σ
compose at forks and reset at level writes, and only the reads the phase
words flag (`ops/scl_schedule.py::phase_words`) go through σ — so no row is
copied at a fork.  σ is a few registers a lane, `SIGMA_FIELDS` levels at
most (over warps, a table in shared memory).  Each path carries its CRC
syndrome and shift register in registers.  What bounds it is a frame's
serial chain of phases, hidden by keeping many frames on an SM: a frame
keeps tree levels G+1..n in shared memory, and levels 1..G go to a global
scratch allocated here for each call, G by the occupancy calculator
(`launch_plan`, the SCL kernel's policy
`ops/scl_cuda.py::smallest_global_levels`).  The trace goes to global
scratch too, as in the SCL kernel: rows of round16(L) bytes one path a lane,
staged 16 rows at a time in shared memory and read by the walks back a
chunk at a time through the frame's freed shared memory (none at L=1,
whose decisions go straight to the outputs), and [Kp, L] entries over
warps; the shared memory goes to tree levels.  On a cluster a block keeps
levels G+1..n of its 1024 paths in shared memory, read by the other blocks
through DSMEM, and levels 1..G go to global scratch.

The envelope: a shape is taken where its frame fits a block at some G, that
is with every level but the leaf in global scratch (`check_shape`); a shape
past it raises with its bytes named.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import _build
from ..ops.crc import check_matrix
from ..ops.scl_cuda import (CLUSTER_MAX_BLOCKS, CLUSTER_THREADS, DEEP_MAX_M, MAX_BLOCK_SMEM, MAX_N,
                             PATH_MAX_M, SIGMA_FIELDS, alloc_scratch, card_free_bytes,
                             cluster_block_bytes, cluster_blocks, deep_frame_bytes, path_trace_row, row_ptr,
                             smallest_global_levels, trace_entry_bytes)
from ..ops.scl_schedule import phase_words
from .pac import bitrev_perm, pac_list_decode_batch

SOURCE = "pac_decode.cu"
MAX_L = 8192  # one thread a path, a cluster of 8 blocks at most
DEEP_WORDS = 3  # published 32-bit values a path over warps: leaf, syndrome, shift register
MAX_MEM = 31  # the shift register is a 32-bit mask
TRACE_RING = 16  # trace rows a one-path-a-lane frame stages in shared memory (`pac_decode.cu`)
# the list outputs of `full=True`, in the order of the kernel's arguments;
# "valid" is worked out from the metrics
LIST_FIELDS = ("v_full", "candidates", "metrics", "best_index", "valid")


def frame_bytes(N: int, Kp: int, L: int, global_levels: int = 0) -> int:
    """Shared memory one frame's decode state takes, rounded to 16 bytes: up
    to L=32 the LLR rows (float32) and edge-bit rows (bytes) of levels
    global_levels+1..n, and above L=1 a ring of `TRACE_RING` trace rows of
    round16(L) bytes (the trace is in global scratch, whatever Kp); over
    warps `ops/scl_cuda.py::deep_frame_bytes`; on a cluster what each of
    its blocks takes, `ops/scl_cuda.py::cluster_block_bytes`."""

    if L > DEEP_MAX_M:
        return cluster_block_bytes(N, global_levels, DEEP_WORDS)
    if L > PATH_MAX_M:
        return deep_frame_bytes(N, L, global_levels, DEEP_WORDS)
    row = (N >> global_levels) - 1
    return (5 * L * row + 15) // 16 * 16 + TRACE_RING * _trace_row(L)


def scratch_bytes(B: int, N: int, Kp: int, L: int, global_levels: int) -> int:
    """Global scratch one launch allocates: the LLR and edge-bit rows of
    levels 1..G of every frame, and its trace: rows of round16(L) bytes one
    path a lane (none at L=1), Kp·L entries of `trace_entry_bytes(L)` over warps and on a
    cluster."""

    return B * L * (N - (N >> global_levels)) * 5 + B * Kp * _trace_row(L)


def _trace_row(L: int) -> int:
    """Bytes of a frame's trace row in global scratch: none at L=1, whose
    decisions are its path."""

    if L == 1:
        return 0
    return path_trace_row(L) if L <= PATH_MAX_M else L * trace_entry_bytes(L)


def check_shape(N: int, Kp: int, L: int, gen, crc_len: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless the kernel takes this decode."""

    gen = [int(g) for g in gen]
    if dtype != torch.float32:
        raise ValueError(f"the PAC kernel decodes float32 LLRs, not {dtype}")
    if not 1 <= L <= MAX_L:
        raise ValueError(f"the PAC kernel supports list sizes 1..{MAX_L} (one frame a cluster of at "
                         f"most {CLUSTER_MAX_BLOCKS} blocks of {CLUSTER_THREADS} threads, one thread a "
                         f"path), not {L}")
    if N < 2 or N & (N - 1) or not 0 < Kp <= N:
        raise ValueError(f"invalid code shape N={N} Kp={Kp}")
    if N > MAX_N:
        raise ValueError(f"the PAC kernel takes N up to {MAX_N}, not {N}")
    if not gen or gen[0] != 1:
        raise ValueError("convolution generator must start with 1")
    if len(gen) - 1 > MAX_MEM:
        raise ValueError(f"the PAC kernel supports generators of memory <= {MAX_MEM}")
    if not 0 <= crc_len <= 32 or (crc_len and crc_len >= Kp):
        raise ValueError(f"the PAC kernel supports CRCs of degree <= 32 inside Kp, not {crc_len}")
    n = int(math.log2(N))
    # σ levels (2n − 2 of them) by the list size rounded up to a power of
    # two (`PathSigma` in `csrc/list_decode.cuh`); L=1 has no σ, and over
    # warps and on a cluster σ is a table whose rows hold every n up to
    # log2(`MAX_N`)
    if 1 < L <= PATH_MAX_M and 2 * n - 2 > SIGMA_FIELDS[1 << (L - 1).bit_length()]:
        raise ValueError(f"the PAC kernel's σ registers do not hold N={N} at L={L}")
    least = frame_bytes(N, Kp, L, n - 1)  # levels 1..n−1 in global scratch: a frame's least
    if least > MAX_BLOCK_SMEM:
        raise ValueError(
            f"PAC decode state for N={N} Kp={Kp} L={L} is {least} bytes of shared memory a frame "
            f"with every level but the leaf in global scratch, more than a block has "
            f"({MAX_BLOCK_SMEM})")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.pac_decode_launch.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_uint] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    lib.pac_decode_launch.restype = ctypes.c_int
    lib.pac_launch_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.pac_launch_plan.restype = ctypes.c_int
    lib.pac_error_string.argtypes = [ctypes.c_int]
    lib.pac_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _occupancy(N: int, Kp: int, L: int, G: int) -> tuple:
    """(frames a block, frames an SM holds at once) with levels 1..G in
    global scratch, by the CUDA occupancy calculator."""

    lib = _library()
    fpb, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.pac_launch_plan(L, int(math.log2(N)), frame_bytes(N, Kp, L, G), MAX_BLOCK_SMEM,
                             ctypes.byref(fpb), ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"PAC occupancy query failed: {lib.pac_error_string(rc).decode()} ({rc})")
    return fpb.value, per_sm.value


@functools.lru_cache(maxsize=None)
def launch_plan(N: int, Kp: int, L: int) -> tuple:
    """(global levels G, frames a block, frames an SM holds at once) on the
    current card; on a cluster (L > 1024) (G, 1, the frames the card runs at
    once), G as `ops/scl_cuda.py::launch_plan` picks it, raising where the
    card places no cluster."""

    n = int(math.log2(N))
    if L > DEEP_MAX_M:
        at_once = _occupancy(N, Kp, L, n - 1)[1]
        if at_once < 1:
            raise RuntimeError(f"the card places no cluster of {cluster_blocks(L)} blocks of "
                               f"{CLUSTER_THREADS} threads and {frame_bytes(N, Kp, L, n - 1)} B of shared "
                               f"memory each (N={N} L={L})")
        return smallest_global_levels(n, lambda g: _occupancy(N, Kp, L, g), at_once)
    return smallest_global_levels(n, lambda g: _occupancy(N, Kp, L, g))


def host_tables(mask, crc_len: int, crc_poly: int):
    """(phase words int32 [N], out_pos int32 [Kp], CRC check columns uint32 [Kp]).

    The phase words are `phase_words` fed with the info phases (the mask in
    bit-reversed order).  out_pos[i] is the ascending-u position of the i-th
    info phase's bit; the check columns are permuted to phase order, as
    `pac_pallas.py` permutes its check matrix."""

    mask = np.asarray(mask)
    N = int(mask.size)
    perm = bitrev_perm(N)
    info_phases = np.flatnonzero(mask[perm] == 1)
    Kp = int(info_phases.size)
    words = phase_words(N, info_phases)
    out_pos = np.argsort(np.argsort(perm[info_phases])).astype(np.int32)
    cols = np.zeros(Kp, np.uint32)
    if crc_len > 0:
        Hc = np.asarray(check_matrix(hex((1 << crc_len) | crc_poly), Kp), np.uint64)
        weights = (np.uint64(1) << np.arange(Hc.shape[0], dtype=np.uint64))[:, None]
        cols = (Hc * weights).sum(axis=0).astype(np.uint32)[out_pos]
    return words, out_pos, cols


@functools.lru_cache(maxsize=64)
def _plan(mask_key: bytes, gen: tuple, L: int, crc_len: int, crc_poly: int, dtype: torch.dtype,
          device: torch.device, global_levels=None) -> tuple:
    """What a launch needs besides its tensors, for one code and list size,
    checked and cached (the legacy drivers launch small batches, where the
    host's share of a call matters): (N, Kp, L, G, frames a block, phase
    words, the info phase of each ascending-u output bit, check columns,
    shift-register and tap masks, CRC flag, shared bytes a frame, for the
    list output the ascending-u output index and the u index of each info
    phase).
    `global_levels` overrides the launch plan's G (`chip_smoke.py` times
    other G)."""

    mask = np.frombuffer(mask_key, np.int8)
    N = int(mask.size)
    Kp = int((mask == 1).sum())
    check_shape(N, Kp, L, gen, crc_len, dtype)
    G, fpb, _ = launch_plan(N, Kp, L)
    if global_levels is not None:
        G, fpb = global_levels, _occupancy(N, Kp, L, global_levels)[0]
    words, out_pos, cols = host_tables(mask, crc_len, crc_poly)
    tables = (torch.as_tensor(words, device=device),
              torch.as_tensor(np.argsort(out_pos).astype(np.int32), device=device),
              torch.as_tensor(cols.view(np.int32), device=device))
    tap_mask = sum(1 << t for t, g in enumerate(gen[1:]) if g)
    positions = np.flatnonzero(mask == 1)
    list_tables = (torch.as_tensor(out_pos, device=device),
                   torch.as_tensor(positions[out_pos].astype(np.int32), device=device))
    return (N, Kp, L, G, fpb, *tables, (1 << (len(gen) - 1)) - 1, tap_mask, int(crc_len > 0),
            frame_bytes(N, Kp, L, G), list_tables)


def pac_list_decode_cuda(
    llr: torch.Tensor, mask, gen, L: int, crc_len: int = 0, crc_poly: int = 0, *,
    full: bool = False,
) -> dict:
    """Fused PAC list decode of a batch: the selected path's bits in
    ascending-u order, and the CRC pass flag; with `full`, also the whole
    final list."""

    if llr.device.type == "cpu":
        res = pac_list_decode_batch(llr, mask, gen, L, crc_len=crc_len, crc_poly=crc_poly,
                                    dtype=llr.dtype)
        fields = ("extracted", "crc_pass") + (LIST_FIELDS if full else ())
        return {f: res[f] for f in fields}
    if llr.device.type != "cuda":
        raise ValueError(f"pac_list_decode_cuda takes CUDA or CPU tensors, not {llr.device}")
    if llr.dim() != 2 or not llr.is_contiguous():
        raise ValueError("llr must be a contiguous [B, N] tensor")
    mask = np.asarray(mask, np.int8)
    if mask.size != int(llr.shape[1]):
        raise ValueError(f"mask has {mask.size} entries for N={int(llr.shape[1])}")
    plan = _plan(mask.tobytes(), tuple(int(g) for g in gen), L, crc_len, crc_poly, llr.dtype,
                 llr.device)
    return _launch(llr, plan, full)


def _launch(llr, plan, full=False) -> dict:
    """Launch the kernel on checked inputs (`_plan`); `full` launches the list
    instantiation."""

    (N, Kp, L, G, fpb, sched, phase_of, hcols, mem_mask, tap_mask, use_crc, fbytes,
     (out_pos, u_pos)) = plan
    B = int(llr.shape[0])
    dev = llr.device
    out = {"extracted": torch.empty((B, Kp), dtype=torch.int8, device=dev),
           "crc_pass": torch.empty((B,), dtype=torch.bool, device=dev)}
    if full:
        out.update(v_full=torch.empty((B, L, N), dtype=torch.int8, device=dev),
                   candidates=torch.empty((B, L, Kp), dtype=torch.int8, device=dev),
                   metrics=torch.empty((B, L), dtype=torch.float32, device=dev),
                   best_index=torch.empty((B,), dtype=torch.int32, device=dev))
    if B > 0:
        # one allocation a launch: the LLR rows (float32) of levels 1..G,
        # their edge bits, and the trace from a 16-byte boundary (none at L=1
        # with G=0)
        def layout(frames):
            lvl = frames * L * (N - (N >> G))
            ti_at = (5 * lvl + 15) // 16 * 16
            return lvl, ti_at, ti_at + frames * Kp * _trace_row(L)

        def scratch(frames):
            total = layout(frames)[2]
            return torch.empty((total,), dtype=torch.uint8, device=dev) if total else None

        step, scratch = alloc_scratch(B, scratch_bytes(1, N, Kp, L, G), scratch, lambda: card_free_bytes(dev),
                                      f"the PAC kernel's global scratch at N={N} Kp={Kp} L={L}")
        lvl, ti_at, _ = layout(step)
        at = scratch.data_ptr() if scratch is not None else 0
        glob_llr, glob_bits = (at, at + 4 * lvl) if G else (None, None)
        batch = [llr, out["extracted"], out["crc_pass"]] + [out[f] for f in LIST_FIELDS[:4] if full]
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for b0 in range(0, B, step):  # one launch unless the batch is split
                rows = [row_ptr(t, b0) for t in batch] if b0 else [t.data_ptr() for t in batch]
                rc = lib.pac_decode_launch(
                    rows[0], hcols.data_ptr(), sched.data_ptr(), phase_of.data_ptr(), glob_llr,
                    glob_bits, at + ti_at, rows[1], rows[2], out_pos.data_ptr(), u_pos.data_ptr(),
                    *(rows[3:] if full else (None,) * 4),
                    min(step, B - b0), N, int(math.log2(N)), Kp, L, G, mem_mask, tap_mask, use_crc,
                    fbytes, fpb, stream,
                )
                if rc != 0:
                    raise RuntimeError(f"PAC kernel launch failed: {lib.pac_error_string(rc).decode()} "
                                       f"({rc})")
                pac_list_decode_cuda.launches += 1
                if full:
                    pac_list_decode_cuda.list_launches += 1
                if L > DEEP_MAX_M:
                    pac_list_decode_cuda.cluster_launches += 1
                elif L > PATH_MAX_M:
                    pac_list_decode_cuda.deep_launches += 1
    if full:
        out["best_index"] = out["best_index"].long()
        out["valid"] = torch.isfinite(out["metrics"])
    return out


pac_list_decode_cuda.launches = 0
pac_list_decode_cuda.list_launches = 0  # of them, launches of a list instantiation
pac_list_decode_cuda.deep_launches = 0  # of them, launches of an over-warps instantiation
pac_list_decode_cuda.cluster_launches = 0  # of them, launches of a cluster instantiation


__all__ = ["pac_list_decode_cuda", "check_shape", "frame_bytes", "scratch_bytes", "host_tables",
           "launch_plan",
           "MAX_L", "MAX_N", "SIGMA_FIELDS", "LIST_FIELDS"]
