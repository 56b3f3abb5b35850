"""Unified BER/FER sweep CLI across coding schemes.

Port of `polar_code_tpu/eval/run_ber_sweep.py`: the same four schemes
(`polar_scl`, `dl_scl`, `nr_polar_scl`, `nr_ldpc`), flags (plus `--device`),
payload-only BER, `avg_work` (DL-SCL flip attempts, LDPC iterations, or the
adaptive re-decoded fraction), CSV schema and `params` strings, and optional
plot.  It runs on the card unless `--device cpu` is given: every SCL decode
on the card goes through the SCL kernel and every `nr_ldpc` decode through
the NMS kernel.

    python -m polar_code_tpu_torch.eval.run_ber_sweep --scheme nr_ldpc \
        --bg ira4x8 --Z 31 --nms_exact --K_payload 100 --K_crc 24 --E 248 \
        --EbN0_lo 1 --EbN0_hi 4 --out results/ber.csv

The stopping rule is the JAX CLI's: simulate a chunk, add its counters, and
go on while `bit_errors < err_cap` and `bits_total < bits_cap` (a cap may be
overshot by at most one chunk).  Chunks are counted in order, one host sync
a chunk.

Launched as several processes (`torchrun --nproc-per-node=<cards> -m
polar_code_tpu_torch.eval.run_ber_sweep ...`), the ranks split each chunk's
frames and sum its counters before the stopping rule reads them, so every
rank stops on the same chunk; with `--snr_split` they own whole points.
Either way the CSV is byte-identical to a one-process run at the same
`--batch` (rounded to a multiple of the ranks).  Only rank 0 writes.
"""

from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from .. import config as global_config
from ..dlscl.beta import beta_from_checkpoint
from ..nr.ldpc import load_base_graph
from ..nr.ldpc.nr_tables import load_base_graph_file
from ..nr.ldpc.qc_ira import make_qc_ira_bg, parse_ira_spec
from ..parallel.mesh import (
    allreduce_counters,
    is_coordinator,
    maybe_distributed_init,
    merge_point_rows,
    sweep_split,
    sync_processes,
)
from ..polar.construct import construct_info_set
from ..sim.pipeline import BER_SCHEMES, make_ber_chunk
from ..utils.cache import enable_compilation_cache
from ..utils.device import resolve_device
from ..utils.resume import SweepState
from ..utils.seeding import seed_all

CSV_HEADER = [
    "scheme", "code", "N_or_E", "K_payload", "K_crc", "rate", "params",
    "EbN0_dB", "bits_total", "bit_errors", "ber", "fer", "avg_work",
]


def _resolve_base_graph(args: argparse.Namespace):
    """A shift table by file (`--bg_file`, lifted at `--Z`), a generated
    QC-IRA graph (`--bg ira<m>x<n>`), or the built-in demo graph by number."""

    if args.bg_file:
        return load_base_graph_file(args.bg_file, args.Z)
    if str(args.bg).startswith("ira"):
        return make_qc_ira_bg(*parse_ira_spec(str(args.bg)), args.Z)
    return load_base_graph(int(args.bg))


def _noise_var(EbN0_dB: float, payload_bits: int, coded_bits: int) -> float:
    # Es/N0 = Eb/N0 · (K_payload/E): CRC bits count as overhead
    ebno_lin = 10 ** (EbN0_dB / 10.0)
    esn0_lin = ebno_lin * (payload_bits / coded_bits)
    return 1.0 / (2.0 * esn0_lin)


def run(args: argparse.Namespace) -> List[Dict[str, float]]:
    seed_all(args.seed)
    enable_compilation_cache()
    maybe_distributed_init()
    coord = is_coordinator()
    device = resolve_device(args.device)

    N = args.N if args.N is not None else args.E
    K_total = args.K_payload + args.K_crc
    info_set = None
    bg = None

    if args.scheme in {"polar_scl", "dl_scl", "nr_polar_scl"}:
        info_set = construct_info_set(N, K_total, method=args.construction)

    if args.scheme == "polar_scl":
        params_label = (
            f"M={args.M},adaptive_from={args.adaptive_from}"
            if args.adaptive_from
            else f"M={args.M}"
        )
    elif args.scheme == "dl_scl":
        params_label = f"M={args.M},retries={args.retries}"
    elif args.scheme == "nr_polar_scl":
        params_label = f"M={args.M},ilv={args.ilv_mode}"
    else:  # nr_ldpc
        bg = _resolve_base_graph(args)
        if (bg.n - bg.m) * args.Z != K_total:
            raise ValueError("LDPC payload+CRC size mismatch with base graph")
        bg_label = args.bg_file or f"bg={args.bg}"
        nms_label = ",exact_nms" if args.nms_exact else ""
        params_label = (
            f"{bg_label},Z={args.Z},iter={args.max_iter},alpha={args.alpha}{nms_label}"
        )

    # the matrix as stored, as the JAX CLI's np.load reads it
    beta = torch.from_numpy(np.asarray(beta_from_checkpoint(args.beta))) if args.beta else None

    # Eb/N0-point split: whole points a rank, rows merged bit-exactly below
    split = sweep_split(args.snr_split, args.batch, args.state)
    batch = split.batch

    chunk_fn = make_ber_chunk(
        scheme=args.scheme, E=args.E, N=N, K_payload=args.K_payload,
        K_crc=args.K_crc, crc_poly=args.crc_poly, info_set=info_set,
        M=args.M, retries=args.retries, beta=beta, ilv_mode=args.ilv_mode,
        max_iter=args.max_iter, alpha=args.alpha, batch=batch,
        device=device, ldpc_bg=bg,
        ldpc_Z=args.Z if args.scheme == "nr_ldpc" else None,
        nms_exact=args.nms_exact, compact=args.compact,
        adaptive_from=args.adaptive_from,
        shard=split.shard,
    )
    state = SweepState(
        args.state,
        {
            "sweep": "ber", "scheme": args.scheme, "K_payload": args.K_payload,
            "K_crc": args.K_crc, "E": args.E, "N": N, "M": args.M,
            "construction": args.construction, "crc_poly": args.crc_poly,
            "adaptive_from": args.adaptive_from, "ilv_mode": args.ilv_mode,
            "retries": args.retries, "seed": args.seed, "batch": batch,
            "err_cap": args.err_cap, "bits_cap": args.bits_cap,
            "beta": args.beta or "", "bg": args.bg,
            "bg_file": args.bg_file or "", "Z": args.Z,
            "max_iter": args.max_iter, "alpha": args.alpha,
            "nms_exact": args.nms_exact,
        },
        writer=coord,
    )

    EbN0_values = np.arange(args.EbN0_lo, args.EbN0_hi + 1e-12, args.EbN0_step)
    # the columns every row of this sweep shares
    meta = {
        "scheme": args.scheme, "code": args.scheme, "N_or_E": args.E,
        "K_payload": args.K_payload, "K_crc": args.K_crc,
        "rate": args.K_payload / args.E, "params": params_label,
    }
    rows: List[Dict[str, float]] = []
    rows_by_idx: Dict[int, Dict[str, float]] = {}
    for point_idx in split.points(len(EbN0_values)):
        EbN0_dB = EbN0_values[point_idx]
        cached = state.get(float(EbN0_dB))
        if cached is not None:
            rows.append(cached)
            continue
        nv = _noise_var(float(EbN0_dB), args.K_payload, args.E)
        acc = {"bit_errors": 0, "frame_errors": 0, "bits_total": 0, "frames": 0, "work_sum": 0.0}
        chunk_idx = 0
        while acc["bit_errors"] < args.err_cap and acc["bits_total"] < args.bits_cap:
            out = chunk_fn(args.seed, point_idx, chunk_idx, nv)
            chunk_idx += 1
            values = torch.stack([v.to(torch.float64) for v in out.values()]).tolist()
            chunk = {k: v if k == "work_sum" else int(v) for k, v in zip(out, values)}
            if not split.snr_split:
                # every rank must read the same totals to stop on the same chunk
                chunk = allreduce_counters(chunk)
            for k, v in chunk.items():
                acc[k] += v

        ber = acc["bit_errors"] / acc["bits_total"] if acc["bits_total"] else float("nan")
        fer = acc["frame_errors"] / acc["frames"] if acc["frames"] else float("nan")
        avg_work = acc["work_sum"] / acc["frames"] if acc["frames"] else 0.0
        row = {
            **meta,
            "EbN0_dB": float(EbN0_dB),
            "bits_total": acc["bits_total"],
            "bit_errors": acc["bit_errors"],
            "ber": ber,
            "fer": fer,
            "avg_work": avg_work,
        }
        state.record(float(EbN0_dB), row)
        rows_by_idx[point_idx] = row
        rows.append(row)

    if split.snr_split:
        # merge the numeric fields across ranks (a collective)
        fields = ["EbN0_dB", "bits_total", "bit_errors", "ber", "fer", "avg_work"]
        merged = merge_point_rows(rows_by_idx, len(EbN0_values), fields,
                                  int_fields=("bits_total", "bit_errors"))
        rows = [{**meta, **values} for values in merged]
    return rows


def write_csv(rows: List[Dict[str, float]], path: Path) -> None:
    if not rows:
        return
    with path.open("w") as f:
        f.write(",".join(CSV_HEADER) + "\n")
        for row in rows:
            f.write(",".join(str(row[col]) for col in CSV_HEADER) + "\n")


def plot_rows(rows: List[Dict[str, float]], path: Path) -> None:
    if not rows:
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows_sorted = sorted(rows, key=lambda r: r["EbN0_dB"])
    snrs = [r["EbN0_dB"] for r in rows_sorted]
    plt.figure(figsize=(6, 4))
    plt.semilogy(snrs, [r["ber"] for r in rows_sorted], "o-", label="BER")
    plt.semilogy(snrs, [r["fer"] for r in rows_sorted], "s-", label="FER")
    plt.xlabel("Eb/N0 (dB)")
    plt.ylabel("Error Rate")
    plt.grid(True, which="both", ls="--", alpha=0.4)
    plt.legend()
    plt.tight_layout()
    path.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(path, dpi=200)
    plt.close()


def parse_args(argv: Optional[Iterable[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="BER/FER sweep across schemes")
    parser.add_argument("--scheme", required=True, choices=list(BER_SCHEMES), help="Coding scheme")
    parser.add_argument("--K_payload", type=int, required=True, help="Payload bits per frame")
    parser.add_argument("--K_crc", type=int, required=True, help="CRC bits per frame")
    parser.add_argument("--E", type=int, required=True, help="Coded bits transmitted")
    parser.add_argument("--N", type=int, help="Polar length before rate match (defaults to E)")
    parser.add_argument(
        "--construction", type=str, default="gaussian",
        choices=["gaussian", "gaussian_bitrev", "polarization"],
        help="Info-set construction (use gaussian_bitrev/polarization for N > 128)",
    )
    parser.add_argument("--crc_poly", type=str, default=global_config.DEFAULTS.crc_poly)
    parser.add_argument("--M", type=int, default=4, help="List size for polar decoders")
    parser.add_argument(
        "--adaptive_from", type=int, default=0,
        help="polar_scl only: two-stage adaptive decode — first pass at this "
        "list size, CRC failures re-decoded at --M. 0 = off. avg_work reports "
        "the re-decoded fraction.",
    )
    parser.add_argument("--retries", type=int, default=8, help="Retries for DL-SCL")
    parser.add_argument("--beta", type=str, help="Path to beta matrix (DL-SCL)")
    parser.add_argument("--ilv_mode", type=str, default="default")
    parser.add_argument(
        "--nms_exact", action="store_true",
        help="textbook two-min layered NMS (self-excluding extrinsics) instead "
        "of the reference's shared-min simplification",
    )
    parser.add_argument(
        "--bg", type=str, default="2",
        help="LDPC base graph: demo graph number (1/2) or 'ira<m>x<n>' for a "
        "generated QC-IRA code (e.g. ira4x8)",
    )
    parser.add_argument(
        "--bg_file", type=str, default=None,
        help="External LDPC shift table (edge-list CSV, per-iLS or single "
             "column; e.g. real TS 38.212 BG1/BG2 tables), lifted at --Z",
    )
    parser.add_argument("--Z", type=int, default=2, help="LDPC lifting size")
    parser.add_argument("--max_iter", type=int, default=20)
    parser.add_argument("--alpha", type=float, default=0.8)
    parser.add_argument("--EbN0_lo", type=float, required=True)
    parser.add_argument("--EbN0_hi", type=float, required=True)
    parser.add_argument("--EbN0_step", type=float, default=0.5)
    parser.add_argument("--bits_cap", type=float, default=1e7)
    parser.add_argument("--err_cap", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, required=True, help="CSV output path")
    parser.add_argument("--plot", type=str, help="Optional plot path")
    parser.add_argument(
        "--batch", type=int, default=2048,
        help="Frames per chunk over all ranks (rounded to a multiple of the ranks)",
    )
    parser.add_argument(
        "--state", type=str, default=None,
        help="Optional JSON state file for checkpoint/resume of sweep points",
    )
    parser.add_argument(
        "--compact", type=int, default=-1,
        help="Compaction capacity for dl_scl retries and the adaptive second "
             "stage (frames a chunk; 0 = masked full batch; -1 = auto: the "
             "whole batch on a CUDA device, off on the CPU). Results are identical",
    )
    parser.add_argument(
        "--snr_split", action="store_true",
        help="Multi-host: assign whole Eb/N0 points to processes round-robin "
             "(each on its local devices, no per-chunk DCN collectives); "
             "rows are merged bit-exactly at the end. No-op single-process.",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Device to run on (default cuda; cpu runs the plain decoders)",
    )
    args = parser.parse_args(list(argv) if argv is not None else None)

    if args.scheme == "dl_scl" and not args.beta:
        raise ValueError("--beta is required for dl_scl scheme")
    return args


def main(argv: Optional[Iterable[str]] = None) -> List[Dict[str, float]]:
    args = parse_args(argv)
    rows = run(args)
    if is_coordinator():
        out_path = Path(args.out)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        write_csv(rows, out_path)
        if args.plot:
            if importlib.util.find_spec("matplotlib") is None:
                print("Skipped BER plot: matplotlib is not installed")
            else:
                plot_rows(rows, Path(args.plot))
    sync_processes("ber_sweep_end")
    return rows


if __name__ == "__main__":
    main()
