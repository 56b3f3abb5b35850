"""Dataset generation for β flip-metric training (port of
`polar_code_tpu/train/make_dataset.py`).

Transmit the all-zero payload codeword at the given Eb/N0, keep frames where
baseline SCL fails the CRC, and label each with the first flip index (in
ascending-|L0| order, ≤ 8 attempts) whose forced retry recovers the true
info word.  The same `.npz` shard schema (`abs_l0` f32[S,K], `flip_idx`
i32[S], `meta` json) and the same CLI flags, plus `--device`.

Frames are simulated in device chunks.  On the card every SCL decode is one
launch of the SCL kernel: the baseline over the chunk, then one launch an
attempt over the frames still searched — with compaction (the default
there) only the baseline failures, gathered in index order; without it the
whole chunk, masked, as on the CPU.  The labelled rows are compacted on the
device before they cross to the host.

    python -m polar_code_tpu_torch.train.make_dataset --M 8 --snr_db 5 \
        --frames 300000 --out data/train_M8_snr5_seed0
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from .. import config
from ..channel import awgn_llr, bpsk, noise_var_coded
from ..ops.backend import auto_compact_capacity, make_scl_decoder, stable_partition_perm
from ..ops.crc import attach_crc_batch
from ..ops.polar_transform import encode_batch
from ..polar.construct import construct_info_set
from ..utils.cache import enable_compilation_cache
from ..utils.device import resolve_device
from ..utils.seeding import make_generator, seed_all


def make_oracle_chunk(
    cfg, info_set, M: int, batch: int, max_attempts: int, compact: int = 0,
    out_cap: int = 0, device=None,
):
    """Return `chunk(generator, noise_var) -> dict` for one chunk of `batch`
    frames: `fail` bool [B], `n_labeled` (0-d), `lab_idx` [out_cap] (labelled
    frames first, each group in frame order), `label` int32 [out_cap] and
    `abs_l0` f32 [out_cap, K] — device tensors.

    compact > 0 searches only the baseline failures, in slabs of at most
    `compact` frames; 0 searches the whole chunk, masked.  The labels of the
    failed frames are the same either way."""

    device = resolve_device(device)
    info_np = np.asarray(info_set)
    K = int(info_np.size)
    B = batch
    C = min(int(compact), B) if compact else 0
    # B/4 covers the highest-yield regime (M=1 at 5 dB labels ~19% of
    # frames); the generator detects an overflow per chunk and raises
    out_cap = min(B, int(out_cap) if out_cap else max(256, B // 4))

    decode = make_scl_decoder(
        info_np, M, cfg.crc_poly, device=device, dtype=torch.float32, N=cfg.N
    )
    payload = torch.zeros((1, cfg.K - cfg.crc_bits), dtype=torch.int8, device=device)
    info_vec = attach_crc_batch(payload, cfg.crc_poly)  # [1, K]
    symbols = bpsk(encode_batch(info_vec, info_np, cfg.N))  # [1, N]
    pos = torch.arange(K, device=device)[None, :]

    def search(llr_n, best_bits_n, order_n):
        """≤ max_attempts forced retries on an [n]-frame slab: the first
        attempt whose decode passes the CRC with the true info word."""

        n = llr_n.shape[0]
        found = torch.zeros((n,), dtype=torch.bool, device=device)
        label = torch.zeros((n,), dtype=torch.int32, device=device)
        for j in range(max_attempts):
            idx = order_n[:, j : j + 1]
            flip_bit = 1 - torch.gather(best_bits_n, 1, idx)
            forced = torch.where(pos < idx, best_bits_n, torch.full_like(best_bits_n, -1))
            forced = torch.where(pos == idx, flip_bit, forced)
            r_bits, _, r_pass = decode(llr_n, forced)
            ok = r_pass & torch.all(r_bits == info_vec, dim=1)
            label = torch.where(~found & ok, idx[:, 0].to(torch.int32), label)
            found = found | ok
        return found, label

    def chunk(generator: torch.Generator, noise_var: float) -> dict:
        llr = awgn_llr(generator, symbols.expand(B, cfg.N), noise_var)
        best_bits, best_llrs, crc_pass = decode(llr)
        fail = ~crc_pass
        abs_l0 = best_llrs.abs()  # [B, K]
        # ascending |L0|, the lowest index first on ties (as JAX's top_k of
        # −|L0|); torch.topk does not promise that order, a stable sort does
        order = torch.argsort(abs_l0, dim=1, stable=True)[:, :max_attempts]

        if not C:
            found, label = search(llr, best_bits, order)
        else:
            count = int(fail.sum())  # one host sync a chunk
            failing = stable_partition_perm(~fail)[:count]
            found = torch.zeros((B,), dtype=torch.bool, device=device)
            label = torch.zeros((B,), dtype=torch.int32, device=device)
            for c0 in range(0, count, C):
                sel = failing[c0 : c0 + C]
                found[sel], label[sel] = search(
                    llr.index_select(0, sel), best_bits.index_select(0, sel),
                    order.index_select(0, sel),
                )
        labeled = fail & found
        sel = stable_partition_perm(~labeled)[:out_cap]  # labelled frames first
        return {
            "fail": fail,
            "n_labeled": labeled.sum(),
            "lab_idx": sel,
            "label": label[sel],
            "abs_l0": abs_l0[sel],
        }

    return chunk


def generate_samples(args: argparse.Namespace) -> None:
    enable_compilation_cache()
    device = resolve_device(args.device)
    cfg = config.get_config()
    if getattr(args, "N", None):
        cfg.N = args.N
    if getattr(args, "K", None):
        cfg.K = args.K
    config.validate_code_shape(cfg.N, cfg.K, cfg.crc_bits)
    construction = getattr(args, "construction", "gaussian")

    seed_all(args.seed)
    info_set = construct_info_set(cfg.N, cfg.K, method=construction)
    noise_var = noise_var_coded(args.snr_db, cfg.K, cfg.N)

    batch = min(args.batch, max(args.frames, 1))
    max_attempts = min(8, cfg.K)
    chunk_fn = make_oracle_chunk(
        cfg, info_set, args.M, batch, max_attempts,
        compact=auto_compact_capacity(args.compact, batch, device),
        out_cap=getattr(args, "out_cap", 0), device=device,
    )

    abs_l0_samples: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    failures = 0

    def drain(out, take):
        nonlocal failures
        cap = int(out["lab_idx"].shape[0])
        n_lab = int(out["n_labeled"])
        lab_idx = out["lab_idx"].cpu().numpy()
        if n_lab > cap:
            # The compaction is a stable partition, so real frames
            # (index < take) sort ahead of the padded tail of a partial
            # final chunk.  Overflow can drop real rows only when the
            # kept capacity is filled entirely by real frames; labelled
            # padded-tail frames spilling past cap are harmless.
            if int(np.sum(lab_idx[:cap] < take)) == cap:
                raise RuntimeError(
                    f"labeled-row capacity overflow ({n_lab} > {cap}); "
                    f"raise --out_cap or lower --batch"
                )
            n_lab = cap
        keep = lab_idx[:n_lab] < take  # honor a partial tail chunk
        failures += int(out["fail"][:take].sum()) - int(np.sum(keep))
        # only the labelled rows cross to the host
        abs_l0_samples.append(out["abs_l0"][:n_lab].cpu().numpy()[keep])
        labels.append(out["label"][:n_lab].cpu().numpy()[keep])

    t_start = time.perf_counter()
    frames_done = 0
    chunk_idx = 0

    def progress():
        dt = time.perf_counter() - t_start
        print(
            f"  {frames_done}/{args.frames} frames, "
            f"{sum(a.size for a in labels)} labels, {failures} unrepaired, "
            f"{frames_done / dt:,.0f} frames/s",
            flush=True,
        )

    while frames_done < args.frames:
        take = min(batch, args.frames - frames_done)
        gen = make_generator(args.seed, chunk_idx, device=device)
        drain(chunk_fn(gen, noise_var), take)
        frames_done += take
        chunk_idx += 1
        if chunk_idx % 32 == 0:
            progress()
    progress()

    label_array = np.concatenate(labels).astype(np.int32)
    if not label_array.size:
        raise RuntimeError("No samples collected; consider increasing frames or SNR")
    abs_array = np.concatenate(abs_l0_samples).astype(np.float32)
    meta = {
        "M": args.M,
        "EbN0_dB": args.snr_db,
        "seed": args.seed,
        "frames": args.frames,
        "N": cfg.N,
        "K": cfg.K,
        "construction": construction,
        "crc_poly": cfg.crc_poly,
        "crc_bits": cfg.crc_bits,
        "samples": int(label_array.size),
        "failures": int(failures),
    }

    out_path = Path(args.out)
    out_dir = out_path.parent if out_path.parent != Path("") else Path(".")
    out_dir.mkdir(parents=True, exist_ok=True)
    shard = out_dir / f"{out_path.name}_part0.npz"
    np.savez_compressed(shard, abs_l0=abs_array, flip_idx=label_array, meta=json.dumps(meta))
    print(f"Saved {label_array.size} samples to {shard}")


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Generate DL-SCL flip dataset")
    parser.add_argument("--M", type=int, required=True, help="SCL list size")
    parser.add_argument("--N", type=int, help="Code length (default: config, 128)")
    parser.add_argument("--K", type=int, help="Info+CRC bits (default: config, 64)")
    parser.add_argument(
        "--construction", type=str, default="gaussian",
        choices=["gaussian", "gaussian_bitrev", "polarization"],
        help="Info-set construction (use gaussian_bitrev/polarization for N>128)",
    )
    parser.add_argument("--snr_db", type=float, default=5.0, help="AWGN Eb/N0 in dB")
    parser.add_argument("--frames", type=int, default=100000, help="Number of frames to simulate")
    parser.add_argument("--seed", type=int, default=0, help="RNG seed")
    parser.add_argument("--out", type=str, required=True, help="Output prefix for dataset shards")
    parser.add_argument("--batch", type=int, default=4096, help="Frames per device chunk")
    parser.add_argument(
        "--compact", type=int, default=-1,
        help="Oracle-search compaction capacity (−1 auto: the whole chunk on a "
             "CUDA device, off on the CPU; 0 off): only baseline-failing "
             "frames go through the ≤8-attempt search",
    )
    parser.add_argument(
        "--out_cap", type=int, default=0,
        help="Labeled-row output capacity per chunk (0 auto = batch/4). "
             "At most this many [K]-wide |L0| rows cross device→host per "
             "chunk. Overflow raises with guidance.",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Device to run on (default cuda; cpu runs the plain decoder)",
    )
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_argparser().parse_args(argv)
    generate_samples(args)


if __name__ == "__main__":
    main()
