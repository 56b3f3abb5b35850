"""Multi-process scale-out for Monte-Carlo sweeps (port of
`polar_code_tpu/parallel/mesh.py`).

The JAX package puts every device of a process in one `Mesh` and joins
processes with `jax.distributed`.  The port runs one process per card, as
`torchrun --nproc-per-node=<cards>` launches them, joined by a
`torch.distributed` process group:

* the frames of each chunk are split across the ranks (`shard_frames`):
  every rank draws the whole chunk from the chunk's generators and decodes
  its own rows, so the draws do not depend on the number of ranks;
* the only traffic is a few integer counters a chunk and one float64 table
  at the end, which the CLIs bring to the host anyway, so the collectives
  run on gloo over host tensors, not NCCL.  Gloo also takes several ranks
  on one card, which NCCL refuses;
* `--snr_split` gives each rank whole sweep points (`split_points`) and
  merges the rows bit-exactly at the end (`allgather_table_exact`).

A split run therefore writes the byte-identical CSV of a one-process run at
the same `--batch` (a multiple of the number of ranks), provided every
decoder's per-frame result does not depend on the frames it shares a
launch with.  `sweep_split` and `merge_point_rows` are the two ends of
that flow, shared by the FER and BER sweep CLIs.

A process drives one card, so the JAX package's device lists
(`local_mesh_devices`, `frames_mesh`, `local_frames_mesh`) and its
device-sharded SCL decode have no counterpart here.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# a rank waits this long in a collective before the job fails
COLLECTIVE_TIMEOUT_S = 1800.0
# under --snr_split a rank that finished its points waits this long for the
# others at the merge (points with error caps can take hours apart)
MERGE_WAIT_S = 7 * 24 * 3600.0


def _env_int(name: str, default: int = 0) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This rank's index among the ranks of its host (0 in one process):
    torchrun's ``LOCAL_RANK``, else SLURM's or OpenMPI's."""

    if process_count() <= 1:
        return 0
    for name in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if name in os.environ:
            return _env_int(name)
    return 0


def split_points(n_points: int) -> List[int]:
    """Round-robin assignment of sweep-point indices to this process.

    The draws of a point depend only on (seed, point, chunk), so the owner
    does not change its row and the merged table equals an unsplit run's."""

    return list(range(process_index(), n_points, process_count()))


def allgather_table_exact(table) -> np.ndarray:
    """Merge a per-process [rows, fields] float64 table across processes.

    Each row is owned by exactly one process (zeros elsewhere).  The float64
    bit patterns are summed as int64, so every row arrives bit-exact and the
    merged CSV is byte-identical to an unsplit run's.  Waits up to
    `MERGE_WAIT_S` for every rank to arrive.  One process: the table
    unchanged."""

    table = np.ascontiguousarray(table, dtype=np.float64)
    if process_count() <= 1:
        return table
    sync_processes("allgather_table_exact", timeout_s=MERGE_WAIT_S)
    bits = torch.from_numpy(table.view(np.int64).copy())
    dist.all_reduce(bits, op=dist.ReduceOp.SUM)
    return bits.numpy().view(np.float64).reshape(table.shape)


def merge_point_rows(
    rows_by_idx: Dict[int, Dict[str, float]], n_points: int, fields: Sequence[str],
    int_fields: Sequence[str] = (),
) -> List[Dict[str, float]]:
    """The `fields` of every sweep point's row, merged over the processes
    that own them (`--snr_split`), in point order: floats, or ints for
    `int_fields`.  A collective: every rank calls it."""

    table = np.zeros((n_points, len(fields)), np.float64)
    for idx, row in rows_by_idx.items():
        table[idx] = [row[f] for f in fields]
    table = allgather_table_exact(table)
    return [{f: int(v) if f in int_fields else float(v) for f, v in zip(fields, values)}
            for values in table]


def allreduce_counters(counters: Dict[str, float]) -> Dict[str, float]:
    """Sum a chunk's or a point's host counters over processes: Python ints
    exactly as int64, floats as float64 (the pipelines' float counters are
    integer-valued, so their sum is exact too).  One process: unchanged."""

    if process_count() <= 1:
        return dict(counters)
    keys = list(counters)
    is_int = [isinstance(counters[k], int) for k in keys]
    ints = torch.tensor([counters[k] if i else 0 for k, i in zip(keys, is_int)], dtype=torch.int64)
    floats = torch.tensor([0.0 if i else counters[k] for k, i in zip(keys, is_int)],
                          dtype=torch.float64)
    dist.all_reduce(ints, op=dist.ReduceOp.SUM)
    dist.all_reduce(floats, op=dist.ReduceOp.SUM)
    return {k: int(ints[j]) if i else float(floats[j])
            for j, (k, i) in enumerate(zip(keys, is_int))}


def shard_frames(x: torch.Tensor, rank: int, world: int, axis: int = 0) -> torch.Tensor:
    """Rank `rank`'s rows [rank·B/world, (rank+1)·B/world) of `x` along the
    frame axis (a view)."""

    if world <= 1:
        return x
    B = int(x.shape[axis])
    if B % world:
        raise ValueError(f"batch {B} is not a multiple of the {world} ranks")
    local = B // world
    return x.narrow(axis, rank * local, local)


class SweepSplit(NamedTuple):
    """How a sweep CLI divides its work over the processes."""

    snr_split: bool  # whole sweep points a rank, merged at the end
    batch: int  # frames of one chunk over all ranks
    shard: Tuple[int, int]  # (rank, ranks) of each chunk's frames

    @property
    def devices(self) -> int:
        """The cards one chunk runs on."""

        return self.shard[1]

    def points(self, n_points: int):
        """The sweep-point indices this process simulates."""

        return split_points(n_points) if self.snr_split else range(n_points)


def sweep_split(snr_split: bool, batch: int, state_path: Optional[str] = None) -> SweepSplit:
    """The split of a sweep CLI: with `--snr_split` (and more than one
    process) whole points a rank, which resume state does not support;
    otherwise each chunk's frames split over the ranks, `batch` rounded
    down to a multiple of them (at least one frame a rank)."""

    world = process_count()
    if snr_split and world > 1:
        if state_path:
            raise ValueError("--state resume is not supported with --snr_split")
        return SweepSplit(True, max(1, batch), (0, 1))
    return SweepSplit(False, max(world, (batch // world) * world), (process_index(), world))


def _cluster_markers_present() -> bool:
    """True only when the environment shows a MULTI-process launch by a
    cluster manager the port maps onto ranks (SLURM, OpenMPI).

    Markers of one process (a 1-task SLURM allocation, a bare k8s service
    host, a single TPU worker name) do not count, so ordinary single-process
    environments stay silent."""

    if "SLURM_JOB_ID" in os.environ and _env_int("SLURM_NTASKS") > 1:
        return True
    return _env_int("OMPI_COMM_WORLD_SIZE") > 1


def _cluster_rank_world() -> tuple:
    if _env_int("OMPI_COMM_WORLD_SIZE") > 1:
        return _env_int("OMPI_COMM_WORLD_RANK"), _env_int("OMPI_COMM_WORLD_SIZE")
    return _env_int("SLURM_PROCID"), _env_int("SLURM_NTASKS")


def _init(rank: int, world: int) -> None:
    dist.init_process_group(
        "gloo", init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )


def maybe_distributed_init() -> bool:
    """Join the process group when launched as one of several processes.

    No-op in single-process runs.  Two activation paths, checked in order:

    1. torchrun's ``WORLD_SIZE`` > 1 (with ``RANK``, ``MASTER_ADDR``,
       ``MASTER_PORT``) — explicit; a failed rendezvous raises;
    2. a multi-process SLURM or OpenMPI launch — its rank and size are
       mapped onto the group, which meets at ``MASTER_ADDR``/``MASTER_PORT``;
       without them, or if the rendezvous fails, it warns and stays
       single-process.

    Idempotent.  Returns True when multi-process."""

    if dist.is_initialized():
        return process_count() > 1
    if _env_int("WORLD_SIZE", 1) > 1:
        _init(_env_int("RANK"), _env_int("WORLD_SIZE"))
    elif _cluster_markers_present():
        rank, world = _cluster_rank_world()
        try:
            if not (os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")):
                raise RuntimeError("no MASTER_ADDR/MASTER_PORT rendezvous is set")
            _init(rank, world)
        except Exception as exc:  # noqa: BLE001 — any rendezvous failure falls back
            warnings.warn(
                f"cluster markers present but torch.distributed auto-detection "
                f"failed ({exc}); continuing single-process"
            )
    if process_count() > 1:
        # align the ranks, whose start-up (imports, kernel builds) may be
        # skewed, with the monitored barrier's explicit timeout, then run one
        # plain collective so the group's first real one meets formed links
        sync_processes("pre_warmup_align")
        sync_processes("collective_init_warmup", collective=True)
    return process_count() > 1


def is_coordinator() -> bool:
    """True on the process that owns stdout, CSV, plot and state files.

    Every rank runs the same loops on the same all-reduced counters; only
    rank 0 writes."""

    return process_index() == 0


def sync_processes(
    tag: str = "barrier", *, timeout_s: float = 300.0, collective: bool = False
) -> None:
    """Barrier across all processes (no-op single-process).

    Used at sweep exit so the coordinator does not tear down the group while
    other ranks still have chunks in flight.  The default is gloo's
    monitored barrier, which fails with the ranks that did not arrive within
    `timeout_s`; ``collective=True`` is a plain `dist.barrier()` under the
    group's timeout.  Every rank must take the same kind."""

    if process_count() <= 1:
        return
    if collective:
        dist.barrier()
        return
    try:
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as exc:
        raise RuntimeError(f"sync_processes({tag!r}): {exc}") from exc


__all__ = [
    "SweepSplit",
    "allgather_table_exact",
    "allreduce_counters",
    "local_rank",
    "merge_point_rows",
    "split_points",
    "shard_frames",
    "maybe_distributed_init",
    "is_coordinator",
    "process_count",
    "process_index",
    "sweep_split",
    "sync_processes",
]
