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
counts kernel launches, `decode_scl_cuda.path_launches` those of them that
went to the by-path instantiation, `decode_scl_cuda.deep_launches` those
that went to the over-warps one and `decode_scl_cuda.cluster_launches`
those that went to the cluster one.

The kernel takes every list size M from 1 to 8192 (the JAX package's XLA
decoder takes any M; its TPU kernel power-of-two M <= 8) and N up to 65536
(the TPU kernel's N envelope is 8192; the JAX package sends longer codes to
its XLA decoder, and the kernel's phase words stop at 65536).  M ∈ {1, 2,
4, 8} go to the byte-word instantiations, which the sweeps launch (up to
N=8192; above, M=1 alone, `byte_words`); M up to 32 to the by-path
instantiation of M rounded up to a power of two (`path_width`), one path a
lane of a warp; M from 33 to 1024 to the over-warps instantiation, one
frame a block and one thread a path; M from 1025 to 8192 to the cluster
instantiation, one frame a thread-block cluster of `cluster_blocks(M)`
blocks of 1024 threads, one thread a path (the source note has the four
layouts).  Past N=8192 the by-path widths 16 and 32 and the over-warps
16-bit instantiation have wide twins whose σ holds 2n − 2 = 30 fields.  A
shape whose frame fits no block even with every level but the leaf in
global scratch (`check_shape`) raises.  A batch whose global scratch
(`scratch_bytes`: 4.3 GB a frame at P(65536,32768) M=8192, G=13) cannot be
allocated goes, in every layout, in launches that fit nine tenths of the
card's free memory (`alloc_scratch`, `split_batch`), one launch counted
each; a frame that alone overfills it raises with its bytes named.  The
card is asked for its free memory only after an allocation failed, so a
launch that fits pays no query.

Memory.  A frame keeps tree levels G+1..n of its M paths in shared memory;
levels 1..G and the trace LLRs go to a global scratch allocated here for
each call.  The trace indices stay in shared memory in the byte-word
layout (K·M bytes); by path (rows of `path_trace_row(M)` bytes) and over
warps and on a cluster (entries of `trace_entry_bytes(M)`) they go to
global scratch, written once an info phase and read at the end, so that a
frame's shared memory goes to tree levels (and over warps to the σ table
and the sort keys, `deep_frame_bytes`; on a cluster a block's shared
memory holds σ, sort keys, published words and levels G+1..n of its 1024
paths, `cluster_block_bytes`).  `launch_plan` asks the CUDA occupancy
calculator for the smallest G at which an SM holds a number of frames
(`smallest_global_levels`, which the PAC kernel's wrapper shares), and for
the frames a block that hold the most: `FRAMES_PER_SM_TARGET` in the
byte-word and over-warps layouts; by path the batch's share of the card,
ceil(B / SMs) frames an SM, up to the most any G holds (`path_target`), so
that a large batch runs in one wave and a retry batch at the lowest G.
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
MAX_M = 8192  # one thread a path, a cluster of 8 blocks (the portable cluster size) at most
SUPPORTED_M = tuple(range(1, MAX_M + 1))
DEEP_MAX_M = 1024  # the largest list size over the warps of one block; above, a cluster
CLUSTER_THREADS = 1024  # threads a block of a cluster frame (`list_decode.cuh`)
CLUSTER_MAX_BLOCKS = 8
# the largest list size decoded one path a lane of a warp; above it a frame
# is spread over the warps of a block of M rounded up to a power of two
# threads (`DEEP_MIN_M` and `deep_threads` in `csrc/list_decode.cuh`)
PATH_MAX_M = 32
# the list sizes of the byte-word instantiations, which the sweeps launch;
# every other M goes through the by-path instantiation of M rounded up to a
# power of two (`path_width`)
BYTE_WORD_M = (1, 2, 4, 8)
# the phase words' limit (`ops/scl_schedule.py::phase_words`, `MAX_LEVELS`
# in `csrc/list_decode.cuh`); past the TPU kernel's 8192, where JAX runs its
# XLA decoder; at every (N, K, M) up to it whose frame fits a block at some G
# (`check_shape`) a frame's state fits once enough levels go to global scratch
MAX_N = 65536
# the longest code of the byte-word instantiations at M 2, 4 and 8 (n = 13,
# `BYTE_WORD_MAX_LEVELS` in `csrc/scl_decode.cu`); above, those go by path
BYTE_WORD_MAX_N = 8192
MAX_BLOCK_SMEM = 227 * 1024  # dynamic shared memory one block may use on an H100
FRAMES_PER_SM_TARGET = 16
# σ levels (2n − 2 of them) a lane's registers hold in the by-path layout, by
# the list size rounded up to a power of two: 32 / log2(LM) fields a word
# (`PathSigma` in `csrc/list_decode.cuh`, which the SCL and PAC kernels
# share).  The instantiations that run N up to 8192 have 1-4 words
# (`NARROW_SIGMA_FIELDS`); past it LM 16 and 32 run wide twins with one more
# word, and these are the most each width holds
SIGMA_FIELDS = {2: 32, 4: 32, 8: 30, 16: 32, 32: 30}
NARROW_SIGMA_FIELDS = {2: 32, 4: 32, 8: 30, 16: 24, 32: 24}
# the outputs of every launch, and those `full=True` adds (the plain
# `SCLResult`'s names), in the order of the kernel's arguments; "valid" is
# worked out from the metrics
BEST_FIELDS = ("best_path_bits", "best_path_info_llrs", "crc_pass")
LIST_FIELDS = ("candidates", "info_llrs", "metrics", "best_index", "valid")


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def trace_entry_bytes(M: int) -> int:
    """Bytes of a trace entry 2p+b (< 2M), and of a σ field over warps."""

    return 1 if M <= 128 else 2


def sort_keys(M: int) -> int:
    """Keys a fork sorts over warps: the 2M candidates padded to a power of
    two (`sort_keys` in `csrc/list_decode.cuh`)."""

    return 1 << (2 * M - 1).bit_length()


def deep_frame_bytes(N: int, M: int, global_levels: int, words: int = 2) -> int:
    """Shared memory one frame takes over warps (`deep_layout` in
    `csrc/list_decode.cuh`), each region rounded to 16 bytes: the σ table
    (2n−2 fields a path, a row rounded to 4 bytes), the sort keys
    (`sort_keys(M)` of 8 bytes), the LLR rows (float32) of levels
    global_levels+1..n, `words` published 32-bit values a path (SCL 2, PAC
    3), the partial-sum rows (bytes) and the selected rank."""

    n = int(math.log2(N))
    row = (N >> global_levels) - 1
    sig_row = max(4, ((2 * n - 2) * trace_entry_bytes(M) + 3) // 4 * 4)
    return (_round16(M * sig_row) + 8 * sort_keys(M) + _round16(4 * M * row)
            + words * _round16(4 * M) + _round16(M * row) + 16)


def cluster_blocks(M: int) -> int:
    """Blocks of a cluster frame (M 1025..8192): M rounded up to a power of
    two, over 1024 (`cluster_blocks` in `csrc/list_decode.cuh`)."""

    return sort_keys(M) // 2 // CLUSTER_THREADS


def cluster_exchanges(P: int) -> int:
    """Cluster barriers one sort of P keys on a cluster takes
    (`cluster_exchanges` in `csrc/list_decode.cuh`): one a cross-block stage
    (distance 2048 or more in each merge of 4096 keys or more: 1, 3, 6 at
    P = 4096, 8192, 16384) and one for the sorted keys."""

    return 1 + sum(s - 11 for s in range(12, P.bit_length()))


def cluster_block_bytes(N: int, global_levels: int, words: int = 2) -> int:
    """Shared memory each block of a cluster frame takes (`cluster_layout`
    in `csrc/list_decode.cuh`), each region rounded to 16 bytes: two σ
    tables of its 1024 paths (2n−2 16-bit fields a path, a row rounded to
    4 bytes; a fork copies from one into the other), three buffers of 2048
    sort keys of 8 bytes (two a cross-block stage's exchange, in turns, and
    one for the stages within the block), two sets (an info phase's parity)
    of `words` published 32-bit values a path (SCL 2, PAC 3), the LLR rows
    (float32) and partial-sum rows (bytes) of levels global_levels+1..n of
    its 1024 paths, and the selected rank."""

    n = int(math.log2(N))
    sig_row = max(4, ((2 * n - 2) * 2 + 3) // 4 * 4)
    row = (N >> global_levels) - 1
    return (2 * _round16(CLUSTER_THREADS * sig_row) + 3 * 8 * 2 * CLUSTER_THREADS
            + 2 * words * 4 * CLUSTER_THREADS + _round16(4 * CLUSTER_THREADS * row)
            + _round16(CLUSTER_THREADS * row) + 16)


def alloc_scratch(B: int, frame_scratch: int, alloc, free, what: str) -> tuple:
    """(frames a launch takes, `alloc(frames)`): the whole batch where its
    global scratch can be allocated; where that fails for want of memory,
    the card is asked `free()` for its free bytes, and the batch goes in
    launches of `split_batch` frames.  `split_batch` raises ValueError,
    naming the bytes, when one frame does not fit; RuntimeError, naming
    `what` and the bytes, when the split's allocation fails too."""

    try:
        return B, alloc(B)
    except torch.cuda.OutOfMemoryError:
        pass  # out of the handler, so that what alloc(B) did take is freed before the query
    free_bytes = free()
    step = split_batch(B, frame_scratch, free_bytes)
    if step < B:
        try:
            return step, alloc(step)
        except torch.cuda.OutOfMemoryError:
            pass
    raise RuntimeError(f"{what} is {step * frame_scratch} bytes for {step} frames, more than the card can "
                       f"allocate of its {free_bytes} free bytes: decode in smaller batches")


def split_batch(B: int, frame_scratch: int, free: int) -> int:
    """Frames a launch of any layout takes when each needs `frame_scratch`
    bytes of global scratch and `free` bytes are free on the card: all B,
    or the most whose scratch fits nine tenths of `free` (all B when a frame
    takes none: K3 at L=1 with every level in shared memory).  Raises
    ValueError, naming the bytes, when one frame does not fit."""

    if frame_scratch == 0:
        return B
    fits = int(free * 0.9) // frame_scratch
    if fits < 1:
        raise ValueError(f"one frame's global scratch is {frame_scratch} bytes, more than nine tenths "
                         f"of the {free} bytes free on the card")
    return min(B, fits)


def byte_words(M: int, N: int = BYTE_WORD_MAX_N) -> bool:
    """Whether list size M goes to its byte-word instantiation at code
    length N (`byte_words` in `csrc/scl_decode.cu`)."""

    return M in BYTE_WORD_M and (M == 1 or N <= BYTE_WORD_MAX_N)


def path_layout(M: int, N: int = BYTE_WORD_MAX_N) -> bool:
    """Whether list size M goes to the by-path instantiation at code length
    N (the default: any N up to 8192)."""

    return M <= PATH_MAX_M and not byte_words(M, N)


def path_trace_row(M: int) -> int:
    """Bytes of a trace-index row by path in global scratch: M entries
    padded to 16 bytes, so that the walks back copy whole rows as 16-byte
    words into shared memory."""

    return _round16(M)


def frame_bytes(N: int, K: int, M: int, global_levels: int = 0) -> int:
    """Shared memory one frame's decode state takes, rounded to 16 bytes: up
    to M=32 the LLR rows (float32) and partial-sum rows (bytes) of levels
    global_levels+1..n, and in the byte-word layout the trace indices
    (bytes); over warps `deep_frame_bytes`; on a cluster what each of its
    blocks takes, `cluster_block_bytes`."""

    if M > DEEP_MAX_M:
        return cluster_block_bytes(N, global_levels)
    if M > PATH_MAX_M:
        return deep_frame_bytes(N, M, global_levels)
    row = (N >> global_levels) - 1
    raw = 4 * M * row + M * row + (0 if path_layout(M, N) else K * M)
    return _round16(raw)


def path_width(M: int) -> int:
    """LM of the by-path instantiation that decodes list size M: M rounded up
    to a power of two, at least 8 (the source's dispatch note)."""

    return max(8, 1 << (M - 1).bit_length())


def scratch_bytes(B: int, N: int, K: int, M: int, global_levels: int) -> int:
    """Global scratch one launch allocates: the LLR and partial-sum rows of
    levels 1..G and the trace LLRs of every frame, and by path, over warps
    and on a cluster the trace indices."""

    ti = (B * K * M * trace_entry_bytes(M) if M > PATH_MAX_M
          else B * K * path_trace_row(M) if path_layout(M, N) else 0)
    return B * M * (N - (N >> global_levels)) * 5 + B * K * M * 4 + ti


def check_shape(N: int, K: int, M: int, crc: Optional[str], dtype: torch.dtype) -> None:
    """Raise ValueError unless the kernel takes this decode."""

    if dtype != torch.float32:
        raise ValueError(f"the SCL kernel decodes float32 LLRs, not {dtype}")
    if not 1 <= M <= MAX_M:
        raise ValueError(f"the SCL kernel supports list sizes 1..{MAX_M} (one frame a cluster of at "
                         f"most {CLUSTER_MAX_BLOCKS} blocks of {CLUSTER_THREADS} threads, one thread a "
                         f"path), not {M}")
    if N < 2 or N & (N - 1) or not 0 < K <= N:
        raise ValueError(f"invalid code shape N={N} K={K}")
    if N > MAX_N:
        raise ValueError(f"the SCL kernel takes N up to {MAX_N}, not {N}")
    if crc is not None and crc_degree(crc) > 32:
        raise ValueError("the SCL kernel supports CRCs of degree <= 32")
    n = int(math.log2(N))
    if path_layout(M, N) and 2 * n - 2 > SIGMA_FIELDS[path_width(M)]:
        raise ValueError(f"the SCL kernel's σ registers do not hold N={N} at M={M}")
    least = frame_bytes(N, K, M, n - 1)  # levels 1..n−1 in global scratch: a frame's least
    if least > MAX_BLOCK_SMEM:
        raise ValueError(
            f"SCL decode state for N={N} K={K} M={M} is {least} bytes of shared memory a frame "
            f"with every level but the leaf in global scratch, more than a block has "
            f"({MAX_BLOCK_SMEM})")


@functools.lru_cache(maxsize=None)
def _library(defines: tuple = ()) -> ctypes.CDLL:
    """The kernel's library; `defines` only for the layout timings of
    `tools/time_scl_layouts.py` (the source's dispatch note)."""

    lib = _build.load(SOURCE, defines)
    lib.scl_decode_launch.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.scl_decode_launch.restype = ctypes.c_int
    lib.scl_launch_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
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
    rc = lib.scl_launch_plan(M, int(math.log2(N)), frame_bytes(N, K, M, G), MAX_BLOCK_SMEM,
                             ctypes.byref(fpb), ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"SCL occupancy query failed: {lib.scl_error_string(rc).decode()} ({rc})")
    return fpb.value, per_sm.value


def smallest_global_levels(n: int, occupancy, target: int = FRAMES_PER_SM_TARGET) -> tuple:
    """(G, frames a block, frames an SM) for a decode kernel whose tree levels
    1..G go to global scratch: the smallest G at which `occupancy(G)` — (frames
    a block, frames an SM) by the CUDA occupancy calculator — puts `target`
    frames on an SM or, where no G does, the smallest G that puts the most
    there.  Level n, the leaf, always stays in shared memory.  The SCL and
    PAC kernels both take their G here."""

    plans = []
    for g in range(n):
        fpb, per_sm = occupancy(g)
        if per_sm >= target:
            return g, fpb, per_sm
        plans.append((g, fpb, per_sm))
    most = max(p[2] for p in plans)
    return next(p for p in plans if p[2] == most)


def path_target(B: int, sms: int, most: int) -> int:
    """Frames an SM the by-path plan asks for: the batch's share of the
    card's `sms` SMs, ceil(B / sms), so that the batch runs in one wave, up to
    `most`, the frames an SM the registers and warps allow (the occupancy at
    G = n−1)."""

    return max(1, min(-(-B // sms), most))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan(N: int, K: int, M: int, target: int) -> tuple:
    return smallest_global_levels(int(math.log2(N)), lambda g: _occupancy(N, K, M, g), target)


def launch_plan(N: int, K: int, M: int, B: int) -> tuple:
    """(global levels G, frames a block, frames an SM holds at once) for a
    batch of B frames on the current card, by `smallest_global_levels`:
    `FRAMES_PER_SM_TARGET` frames an SM in the byte-word and over-warps
    layouts, `path_target` of the card's SMs by path.  On a cluster (M >
    1024): (G, 1, the frames the card runs at once, by
    `cudaOccupancyMaxActiveClusters`), G the smallest at which the card runs
    as many frames at once as with every level but the leaf in global
    scratch (the most shared memory a block's 1024 paths can take); it
    raises where the card places no cluster.  The occupancy (`_occupancy`)
    is cached by shape alone: the cards of one host are taken to be of one
    kind."""

    n = int(math.log2(N))
    if M > DEEP_MAX_M:
        at_once = _occupancy(N, K, M, n - 1)[1]
        if at_once < 1:
            raise RuntimeError(f"the card places no cluster of {cluster_blocks(M)} blocks of "
                               f"{CLUSTER_THREADS} threads and {frame_bytes(N, K, M, n - 1)} B of shared "
                               f"memory each (N={N} M={M})")
        return _plan(N, K, M, at_once)
    if not path_layout(M, N):
        return _plan(N, K, M, FRAMES_PER_SM_TARGET)
    most = _occupancy(N, K, M, n - 1)[1]
    return _plan(N, K, M, path_target(B, _sm_count(torch.cuda.current_device()), most))


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
    with torch.cuda.device(llr.device):
        G, fpb, _ = launch_plan(N, K, M, B)
    return _launch(llr, info_np, M, crc, force_info_bits, G, fpb, full)


def row_ptr(t: torch.Tensor, b: int) -> int:
    """Address of row b of a contiguous batch-major tensor: where a split
    launch's share of the batch starts, with no tensor made for it."""

    return t.data_ptr() + b * t.stride(0) * t.element_size()


def card_free_bytes(dev) -> int:
    """Bytes a scratch allocation can take on `dev`: free on the card, and
    held by PyTorch's cache unused."""

    free, _ = torch.cuda.mem_get_info(dev)
    return int(free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev))


def _launch(llr, info_np, M, crc, force_info_bits, G, fpb, full=False) -> dict:
    """Launch the kernel on checked inputs, with levels 1..G in global
    scratch and fpb frames a block (`chip_smoke.py` times other G here);
    `full` launches the list instantiation.  The batch goes in launches of
    `alloc_scratch` frames."""

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
        ti_dtype = torch.uint8 if trace_entry_bytes(M) == 1 else torch.int16

        def scratch(frames):
            return ((torch.empty((frames, M, row), dtype=torch.float32, device=dev) if G else None),
                    (torch.empty((frames, M, row), dtype=torch.uint8, device=dev) if G else None),
                    torch.empty((frames, K, M), dtype=torch.float32, device=dev),
                    (torch.empty((frames, K, M), dtype=ti_dtype, device=dev) if M > PATH_MAX_M
                     else torch.empty((frames, K, path_trace_row(M)), dtype=torch.uint8, device=dev)
                     if path_layout(M, N) else None))

        step, (glob_llr, glob_bits, trace_llr, trace_idx) = alloc_scratch(
            B, scratch_bytes(1, N, K, M, G), scratch, lambda: card_free_bytes(dev),
            f"the SCL kernel's global scratch at N={N} K={K} M={M}")
        lib = _library()
        for b0 in range(0, B, step):  # one launch unless the batch is split
            lists = [row_ptr(out[f], b0) if full else None for f in LIST_FIELDS[:4]]
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = lib.scl_decode_launch(
                    row_ptr(llr, b0),
                    row_ptr(force_info_bits, b0) if force_info_bits is not None else None,
                    hcols.data_ptr(), sched.data_ptr(),
                    glob_llr.data_ptr() if G else None, glob_bits.data_ptr() if G else None,
                    trace_llr.data_ptr(), trace_idx.data_ptr() if trace_idx is not None else None,
                    *(row_ptr(out[f], b0) for f in BEST_FIELDS), *lists,
                    min(step, B - b0), N, int(math.log2(N)), K, M, G, int(crc is not None),
                    frame_bytes(N, K, M, G), fpb, stream,
                )
            if rc != 0:
                raise RuntimeError(f"SCL kernel launch failed: {lib.scl_error_string(rc).decode()} ({rc})")
            decode_scl_cuda.launches += 1
            if M > DEEP_MAX_M:
                decode_scl_cuda.cluster_launches += 1
            elif M > PATH_MAX_M:
                decode_scl_cuda.deep_launches += 1
            elif path_layout(M, N):
                decode_scl_cuda.path_launches += 1
    if full:
        out["valid"] = torch.isfinite(out["metrics"])
    return out


decode_scl_cuda.launches = 0
decode_scl_cuda.path_launches = 0  # of them, launches of the by-path instantiation
decode_scl_cuda.deep_launches = 0  # of them, launches of the over-warps instantiation
decode_scl_cuda.cluster_launches = 0  # of them, launches of the cluster instantiation


__all__ = ["decode_scl_cuda", "check_shape", "frame_bytes", "deep_frame_bytes", "sort_keys",
           "cluster_blocks", "cluster_exchanges", "cluster_block_bytes", "split_batch", "alloc_scratch",
           "trace_entry_bytes", "launch_plan", "smallest_global_levels", "path_width",
           "byte_words", "path_layout", "path_trace_row", "path_target", "scratch_bytes",
           "SUPPORTED_M", "BYTE_WORD_M", "BYTE_WORD_MAX_N", "MAX_M", "PATH_MAX_M", "DEEP_MAX_M",
           "MAX_N", "SIGMA_FIELDS", "NARROW_SIGMA_FIELDS"]
