"""FER sweep CLI comparing baseline SCL and DL-SCL with β-guided flips.

Port of `polar_code_tpu/eval/run_fer_sweep.py`: the same flags (plus
`--device`), stdout lines, CSV schema (`snr_db[,fer_uncoded,ber_uncoded],
fer_scl,ber_scl,fer_dl,ber_dl`) and semilogy PNG.  It runs on the card
unless `--device cpu` is given; every SCL decode on the card goes through
the CUDA kernel.

    python -m polar_code_tpu_torch.eval.run_fer_sweep --M 8 \
        --beta checkpoints/beta_M8.npy --frames 102400

Launched as several processes (`torchrun --nproc-per-node=<cards> -m
polar_code_tpu_torch.eval.run_fer_sweep ...`, one rank a card), the ranks
split each chunk's frames and sum the counters once a point, or with
`--snr_split` own whole points; either way the CSV is byte-identical to a
one-process run at the same `--batch` (rounded to a multiple of the ranks).
Only rank 0 prints and writes the CSV, plot and state.

Frame counts are rounded up to a whole number of chunks; FER/BER are
normalized by the frames actually simulated.
"""

from __future__ import annotations

import argparse
import importlib.util
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from .. import config
from ..channel import noise_var_coded, noise_var_uncoded
from ..interop import load_beta
from ..polar.construct import construct_info_set
from ..parallel.mesh import (
    allreduce_counters,
    is_coordinator,
    maybe_distributed_init,
    merge_point_rows,
    sweep_split,
    sync_processes,
)
from ..sim.pipeline import make_fer_chunk
from ..utils.cache import enable_compilation_cache
from ..utils.device import resolve_device
from ..utils.resume import SweepState
from ..utils.seeding import seed_all


def run_sweep(args: argparse.Namespace) -> List[Dict[str, float]]:
    cfg = config.get_config()
    seed_all(args.seed)
    enable_compilation_cache()
    maybe_distributed_init()
    coord = is_coordinator()
    say = print if coord else (lambda *a, **k: None)
    device = resolve_device(args.device)

    if args.N:
        cfg.N = args.N
    if args.K:
        cfg.K = args.K
    config.validate_code_shape(cfg.N, cfg.K, cfg.crc_bits)
    info_set = construct_info_set(cfg.N, cfg.K, method=args.construction)

    snr_points = (
        np.arange(args.snr_lo, args.snr_hi + 1e-9, args.snr_step)
        if args.snr_step > 0
        else np.array([args.snr_lo])
    )
    beta = load_beta(args.beta).beta_matrix().detach() if args.beta else None

    # Eb/N0-point split: each rank simulates whole points on its own card and
    # the rows are merged bit-exactly at the end; otherwise each chunk's
    # frames are split over the ranks.  The draws of a chunk depend only on
    # (seed, SNR tag, chunk), so both give the CSV of an unsplit run.
    split = sweep_split(args.snr_split, min(args.batch, max(args.frames, 1)), args.state)
    batch = split.batch

    chunk_fn = make_fer_chunk(
        N=cfg.N, K=cfg.K, crc_poly=cfg.crc_poly, info_set=info_set,
        M=args.M, retries=args.retries, beta=beta, batch=batch, device=device,
        include_uncoded=args.include_uncoded, compact=args.compact,
        shard=split.shard,
    )
    state = SweepState(
        args.state,
        {
            "sweep": "fer", "N": cfg.N, "K": cfg.K, "construction": args.construction,
            "M": args.M, "frames": args.frames,
            "retries": args.retries, "seed": args.seed, "batch": batch,
            "beta": args.beta or "", "include_uncoded": bool(args.include_uncoded),
        },
        writer=coord,
    )

    results: List[Dict[str, float]] = []
    t_start = time.perf_counter()
    frames_done = 0
    rows_by_idx: Dict[int, Dict[str, float]] = {}
    for point_idx in split.points(len(snr_points)):
        snr_db = snr_points[point_idx]
        cached = state.get(float(snr_db))
        if cached is not None:
            say(f"SNR={snr_db:.2f} dB -> resumed from state")
            results.append(cached)
            continue
        nv_c = noise_var_coded(float(snr_db), cfg.K, cfg.N)
        nv_u = noise_var_uncoded(float(snr_db))
        snr_tag = int(round(float(snr_db) * 10))

        acc: Dict[str, int] = {}
        total_frames = 0
        chunk_idx = 0
        while total_frames < args.frames:
            out = chunk_fn(args.seed, snr_tag, chunk_idx, nv_c, nv_u)
            values = torch.stack([v.to(torch.int64) for v in out.values()]).tolist()
            for k, v in zip(out, values):
                acc[k] = acc.get(k, 0) + v
            total_frames += batch
            chunk_idx += 1
        if not split.snr_split:
            acc = allreduce_counters(acc)
        frames_done += total_frames

        row = {
            "snr_db": float(snr_db),
            "fer_scl": acc["scl_errors"] / total_frames,
            "fer_dl": acc["dl_errors"] / total_frames,
            "ber_scl": acc["scl_bit_errors"] / acc["bits_coded"],
            "ber_dl": acc["dl_bit_errors"] / acc["bits_coded"],
        }
        if args.include_uncoded:
            row["fer_uncoded"] = acc["uncoded_errors"] / total_frames
            row["ber_uncoded"] = acc["uncoded_bit_errors"] / acc["bits_uncoded"]
            say(
                f"SNR={snr_db:.2f} dB -> Uncoded FER={row['fer_uncoded']:.3e}, "
                f"BER={row['ber_uncoded']:.3e}; "
                f"SCL FER={row['fer_scl']:.3e}, BER={row['ber_scl']:.3e}; "
                f"DL FER={row['fer_dl']:.3e}, BER={row['ber_dl']:.3e}"
            )
        else:
            say(
                f"SNR={snr_db:.2f} dB -> SCL FER={row['fer_scl']:.3e}, "
                f"BER={row['ber_scl']:.3e}; "
                f"DL FER={row['fer_dl']:.3e}, BER={row['ber_dl']:.3e}"
            )
        state.record(float(snr_db), row)
        rows_by_idx[point_idx] = row
        results.append(row)

    if split.snr_split:
        # merge the rows of every rank (a collective: every rank takes part)
        fields = ["snr_db", "fer_scl", "ber_scl", "fer_dl", "ber_dl"]
        if args.include_uncoded:
            fields += ["fer_uncoded", "ber_uncoded"]
        results = merge_point_rows(rows_by_idx, len(snr_points), fields)

    elapsed = time.perf_counter() - t_start
    if elapsed > 0:
        say(
            f"Simulated {frames_done} frames in {elapsed:.2f}s "
            f"({frames_done / elapsed:.0f} frames/s on {split.devices} device(s))"
        )

    if not coord:
        sync_processes("fer_sweep_end")
        return results

    output_dir = Path(args.out_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    csv_path = output_dir / f"fer_M{args.M}.csv"
    with csv_path.open("w") as f:
        headers = ["snr_db"]
        if args.include_uncoded:
            headers.extend(["fer_uncoded", "ber_uncoded"])
        headers.extend(["fer_scl", "ber_scl", "fer_dl", "ber_dl"])
        f.write(",".join(headers) + "\n")
        for row in results:
            values = [f"{row['snr_db']:.3f}"]
            if args.include_uncoded:
                values.extend([f"{row['fer_uncoded']:.6e}", f"{row['ber_uncoded']:.6e}"])
            values.extend([
                f"{row['fer_scl']:.6e}",
                f"{row['ber_scl']:.6e}",
                f"{row['fer_dl']:.6e}",
                f"{row['ber_dl']:.6e}",
            ])
            f.write(",".join(values) + "\n")
    say(f"Saved FER table to {csv_path}")

    if importlib.util.find_spec("matplotlib") is None:
        say("Skipped FER plot: matplotlib is not installed")
    else:
        plot_dir = Path(args.plot_dir)
        plot_dir.mkdir(parents=True, exist_ok=True)
        plot_path = plot_dir / f"fer_M{args.M}.png"
        _plot(results, plot_path, args.include_uncoded)
        say(f"Saved FER plot to {plot_path}")
    sync_processes("fer_sweep_end")
    return results


def _plot(results: List[Dict[str, float]], plot_path: Path, include_uncoded: bool) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(6, 4))
    snrs = [row["snr_db"] for row in results]
    keys = (("fer_uncoded",) if include_uncoded else ()) + ("fer_scl", "fer_dl")
    # semilogy warns on all-zero data (tiny smoke sweeps): use a linear axis
    draw = plt.plot if all(row[k] == 0.0 for row in results for k in keys) else plt.semilogy
    if include_uncoded:
        draw(snrs, [row["fer_uncoded"] for row in results], "^-", label="Uncoded")
    draw(snrs, [row["fer_scl"] for row in results], "o-", label="SCL")
    draw(snrs, [row["fer_dl"] for row in results], "s-", label="DL-SCL")
    plt.xlabel("Eb/N0 (dB)")
    plt.ylabel("Frame Error Rate")
    plt.grid(True, which="both", ls="--", alpha=0.4)
    plt.legend()
    plt.tight_layout()
    plt.savefig(plot_path, dpi=200)
    plt.close()


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Run FER sweep for DL-SCL")
    parser.add_argument("--M", type=int, required=True, help="List size")
    parser.add_argument("--N", type=int, help="Code length (default: config, 128)")
    parser.add_argument("--K", type=int, help="Info+CRC bits (default: config, 64)")
    parser.add_argument(
        "--construction", type=str, default="gaussian",
        choices=["gaussian", "gaussian_bitrev", "polarization"],
        help="Info-set construction (use gaussian_bitrev/polarization for N>128)",
    )
    parser.add_argument("--frames", type=int, default=10000, help="Frames per SNR point")
    parser.add_argument("--snr_lo", type=float, default=4.0)
    parser.add_argument("--snr_hi", type=float, default=6.5)
    parser.add_argument("--snr_step", type=float, default=0.5)
    parser.add_argument("--retries", type=int, default=8)
    parser.add_argument("--beta", type=str, help="Path to trained β matrix (.npy)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out_dir", type=str, default="results")
    parser.add_argument("--plot_dir", type=str, default="plots")
    parser.add_argument(
        "--include_uncoded", action="store_true",
        help="Also simulate an uncoded BPSK baseline",
    )
    parser.add_argument(
        "--batch", type=int, default=4096,
        help="Frames per step over all ranks (rounded to a multiple of the ranks)",
    )
    parser.add_argument(
        "--state", type=str, default=None,
        help="Optional JSON state file: completed Eb/N0 points are recorded "
             "and skipped on re-run (checkpoint/resume for long sweeps)",
    )
    parser.add_argument(
        "--compact", type=int, default=-1,
        help="Retry compaction capacity (frames per retry chunk; 0 = masked "
             "full-batch retries; -1 = auto: the whole batch on a CUDA device, "
             "off on the CPU). Results are identical",
    )
    parser.add_argument(
        "--snr_split", action="store_true",
        help="Multi-host: assign whole Eb/N0 points to processes round-robin "
             "(each on its local devices, no per-chunk DCN collectives) "
             "instead of sharding frames globally; rows are merged "
             "bit-exactly at the end. No-op single-process.",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Device to run on (default cuda; cpu runs the plain decoder)",
    )
    return parser


def main(argv: List[str] | None = None) -> List[Dict[str, float]]:
    args = build_argparser().parse_args(argv)
    return run_sweep(args)


if __name__ == "__main__":
    main()
