#!/usr/bin/env python3
"""Hold the list decoders of one checkout to another's, bit for bit: K1 by path, over warps and on a cluster, K3.

    python tools/compare_deep_lists.py --repo DIR --save FILE.npz
    python tools/compare_deep_lists.py [--repo DIR] --compare FILE.npz

DIR (default: this checkout) is the root of the checkout whose
`polar_code_tpu_torch` is imported and built into DIR/build.  Each run
decodes the same inputs (numpy draws, seed 123, through this checkout's
`chip_smoke.py` helpers) with the SCL kernel K1 over warps at P(128,64)
CRC-24A M 33, 64, 65, 100, 129, 256 and 1024, P(1024,512) M=256 and
P(32,28) M=64, with and without a forced plan; K1 by path at P(128,64) M 3,
5, 16, 17, 31 and 32, P(32,28) M=16 and P(8192,4096) M=32 (B=8), with and
without CRC-24A and a forced plan, and with CRC-24A at the launch plans of
the timed batches (`chip_smoke.py`'s PATH_TIMES): P(128,64) M 3, 16 and 32
at B=4096, P(1024,512) M=16 at B=1024, and 8 frames of P(8192,4096) M=32 at
the plan of B=1024; K1 on a cluster at P(128,64) M 1025, 2048 and 3000
(B=12), 4096 and 8192 (B=6), with and without CRC-24A and a forced plan,
and P(1024,512) (B=4) and P(8192,2048) (B=2) M=2048 with CRC-24A; and the
PAC kernel K3 one path a lane at PAC(128,64)+CRC-16 L 1, 2, 4, 5, 8, 16,
24 and 32, PAC(2048,1024) L=32 and PAC(8192,4096) L=8 (B=6), over warps at
PAC(128,64)+CRC-16 L 33, 64, 65, 100, 129, 256 and 1024 and PAC(32,12)
L=64, and on a cluster at PAC(128,64)+CRC-16 L 2048 (B=12) and 4096
(B=6); B=37 frames unless named, every output of the list launch and of
the best-only one.  `--save` writes
them to FILE; `--compare` holds them to FILE's, byte for byte, and each
case to the plain PyTorch version (`chip_smoke.py`'s judges: K1 outside
near-ties, K3 every field).  To compare a change with its parent, run both
on one card in one go; FILE holds every output (a few hundred MiB: keep it
in the git-ignored `smoke_checkout/`, not under `chiprun_out/`).  Prints
the card's `nvidia-smi` line and exits non-zero on any difference.
"""

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE), help="checkout whose kernels run")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", help="write the outputs to this .npz")
    mode.add_argument("--compare", help="hold the outputs to this .npz and to the plain versions")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import faulthandler
    import importlib.util
    import inspect

    import numpy as np
    import torch

    # this checkout's chip_smoke.py, whatever DIR holds; it arms a watchdog
    # when imported, which this run does not need
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    faulthandler.cancel_dump_traceback_later()
    from polar_code_tpu_torch.legacy import pac_cuda
    from polar_code_tpu_torch.ops import scl_cuda
    from polar_code_tpu_torch.polar.construct import construct_info_set

    if not torch.cuda.is_available():
        print("compare_deep_lists: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    outs = {}
    rng = np.random.default_rng(123)

    def keep(tag, full, best):
        torch.cuda.synchronize()
        for f, v in list(full.items()) + [(f"best/{f}", v) for f, v in best.items()]:
            outs[f"{tag}|{f}"] = v.cpu().numpy()

    # a checkout whose by-path plan takes the batch size, or one whose plan does not
    takes_b = "B" in inspect.signature(scl_cuda.launch_plan).parameters

    def k1(x, info, M, crc, p, launch_b, full=False):
        if launch_b is None:
            return scl_cuda.decode_scl_cuda(x, info, M, crc, force_info_bits=p, full=full)
        G, fpb, _ = scl_cuda.launch_plan(x.shape[1], len(info), M, *([launch_b] if takes_b else []))
        return scl_cuda._launch(x, np.asarray(info, np.int64), M, crc, p, G, fpb, full)

    # (N, K, M, frames, CRCs, the batch whose launch plan runs): over warps
    # with CRC-24A, by path with and without, and at the timed batches' plans
    k1_cases = ([(128, 64, M, 37, (cs.CRC,), None) for M in (33, 64, 65, 100, 129, 256, 1024)]
                + [(1024, 512, 256, 37, (cs.CRC,), None), (32, 28, 64, 37, (cs.CRC,), None)]
                + [(128, 64, M, 37, (cs.CRC, None), None) for M in (3, 5, 16, 17, 31, 32)]
                + [(32, 28, 16, 37, (cs.CRC, None), None), (8192, 4096, 32, 8, (cs.CRC, None), None)]
                + [(128, 64, M, 4096, (cs.CRC,), None) for M in (3, 16, 32)]
                + [(1024, 512, 16, 1024, (cs.CRC,), None), (8192, 4096, 32, 8, (cs.CRC,), 1024)]
                + [(128, 64, M, 12 if M <= 3000 else 6, (cs.CRC, None), None)
                   for M in (1025, 2048, 3000, 4096, 8192)]
                + [(1024, 512, 2048, 4, (cs.CRC,), None), (8192, 2048, 2048, 2, (cs.CRC,), None)])
    for n, k, M, B, crcs, launch_b in k1_cases:
        info = construct_info_set(n, k, method="gaussian" if n == 128 else "gaussian_bitrev")
        llr, msg = cs.make_llrs(rng, B, 2.5 if n < 8192 else 1.5, info, n=n)
        x = torch.from_numpy(llr).to(dev)
        plan = torch.from_numpy(cs.random_plan(rng, msg)).to(dev)
        for crc in crcs:
            for p in (None, plan):
                tag = (f"K1 P({n},{k}) M={M}{'' if crc else ' crc=off'} "
                       f"plan={'on' if p is not None else 'off'}"
                       + (f" B={B}" if B != 37 else "") + (f" at the B={launch_b} plan" if launch_b else ""))
                keep(tag, k1(x, info, M, crc, p, launch_b, full=True), k1(x, info, M, crc, p, launch_b))
                if args.compare:
                    cs.k1_vs_plain(x, info, M, crc, p, tag, launch_b=launch_b)
    k3_cases = ([(128, 64, L, 37) for L in (33, 64, 65, 100, 129, 256, 1024)] + [(32, 12, 64, 37)]
                + [(128, 64, L, 37) for L in (1, 2, 4, 5, 8, 16, 24, 32)] + [(2048, 1024, 32, 6), (8192, 4096, 8, 6)]
                + [(128, 64, 2048, 12), (128, 64, 4096, 6)])
    for n, k, L, B in k3_cases:
        mask = cs.pac_mask(n, k + cs.PAC_CRC[0])
        x = cs.pac_llrs(rng, B, 2.0 if n <= 128 else 1.5, (n, k, cs.PAC_CRC), cs.PAC_GEN, mask, dev)
        tag = f"K3 PAC({n},{k}) L={L}" + (f" B={B}" if B != 37 else "")
        full = pac_cuda.pac_list_decode_cuda(x, mask, cs.PAC_GEN, L, *cs.PAC_CRC, full=True)
        keep(tag, full, pac_cuda.pac_list_decode_cuda(x, mask, cs.PAC_GEN, L, *cs.PAC_CRC))
        if args.compare:
            cs.k3_list_vs_plain(x, mask, cs.PAC_GEN, L, *cs.PAC_CRC, tag, out=full)
    print(cs.nvidia_smi_line())
    if args.save:
        np.savez(args.save, **outs)
        n_k1 = sum(2 * len(case[4]) for case in k1_cases)
        print(f"saved {len(outs)} arrays of {n_k1} K1 and {len(k3_cases)} K3 cases to {args.save}")
        return 0
    with np.load(args.compare) as ref:
        differ = [t for t, v in outs.items()
                  if t not in ref or ref[t].shape != v.shape
                  or not np.array_equal(ref[t].view(np.uint8), v.view(np.uint8))]
    for t in differ:
        print(f"  differs from {args.compare}: {t}")
    print(f"{len(outs)} arrays, {len(differ)} differ byte for byte; every case equal to the plain "
          f"version (K1 outside near-ties)")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
