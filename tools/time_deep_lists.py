#!/usr/bin/env python3
"""Time the over-warps and cluster list decoders of one checkout, on one CUDA card.

    python tools/time_deep_lists.py [--repo DIR] [--label NAME]

DIR (default: this checkout) is the root of the checkout whose
`polar_code_tpu_torch` is imported, built into DIR/build and timed; the
shapes, LLRs (numpy draws) and CUDA-event timing are this checkout's
(`chip_smoke.py` phase 14 (g)).  To compare two versions of the kernels,
run it on one card, in one go, for a parent checkout and for the change, in
the order parent, change, change, parent.

Shapes: the SCL kernel K1 over warps at P(128,64) CRC-24A, 5.0 dB, M 64,
256 and 1024, B=4096, beside its byte-word M=8 (`chip_smoke.py` phase 5's
kernel); the PAC kernel K3 over warps at PAC(128,64)+CRC-16,
gen 1011011, `dega`, 2.5 dB, L 64, 256 and 1024, B=4096; K1 at P(1024,512)
`gaussian_bitrev` M=64, 1.75 dB, B=1024; and one frame (B=1) of K1 at M=256
and K3 at L=256, a launch's latency; and on a cluster, B=1024, K1 at
P(128,64) CRC-24A 5.0 dB M 2048, 4096 and 8192 and K3 at PAC(128,64)+CRC-16
2.5 dB L 2048 and 4096 (`chip_smoke.py` phase 15 (f)).  `--only A|B` times
the shapes whose names hold A or B.  Prints a line a shape (its time, its
bound from `chip_smoke.py`'s work counts and the frames an SM, or on a
cluster the frames at once, the wrapper's launch plan holds), the card's
`nvidia-smi` name and power limit, and a JSON line of every time last;
a shape's line gives the kernel launches a call (more than one where a
batch was split).
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE), help="checkout whose kernels are timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", default=None, help="time only the shapes whose names hold one of A|B|..")
    args = ap.parse_args()
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import faulthandler
    import importlib.util

    import numpy as np
    import torch

    # this checkout's chip_smoke.py, whatever DIR holds; it arms a watchdog
    # when imported, which a timing run does not need
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    faulthandler.cancel_dump_traceback_later()
    from polar_code_tpu_torch.legacy import pac_cuda
    from polar_code_tpu_torch.ops import scl_cuda
    from polar_code_tpu_torch.polar.construct import construct_info_set

    if not torch.cuda.is_available():
        print("time_deep_lists: no CUDA device is available", file=sys.stderr)
        return 1
    label = args.label or str(repo)
    dev = torch.device("cuda")
    times, per_sm = {}, {}
    wrappers = (scl_cuda.decode_scl_cuda, pac_cuda.pac_list_decode_cuda)

    def run(tag, fn, reps, work, plan):
        if args.only and not any(part in tag for part in args.only.split("|")):
            return
        fn()  # builds the kernel at its first call
        before = sum(f.launches for f in wrappers)
        ms = cs.cuda_time_ms(fn, reps=reps, warmup=1)
        launches = (sum(f.launches for f in wrappers) - before) / (reps + 1)
        b_ms, b_by = cs.bound(*work)
        times[tag], per_sm[tag] = ms, plan[2]
        where = "at once" if "cluster" in tag else "an SM"
        print(f"  [{label}] {tag}: {ms:.4f} ms ({reps} calls, {launches:g} kernel launches a call); bound "
              f"{b_ms:.6f} ms ({b_by}), {ms / b_ms:.0f}x; {plan[2]} frames {where}", flush=True)

    B = 4096
    info = construct_info_set(cs.N, cs.K)
    llr = torch.from_numpy(cs.make_llrs(np.random.default_rng(5), B, 5.0, info)[0]).to(dev)
    for M in (8, 64, 256, 1024):  # M=8: the byte-word instantiation the sweeps launch
        run(f"K1 P(128,64) M={M} B={B}", lambda M=M: scl_cuda.decode_scl_cuda(llr, info, M, cs.CRC),
            2 if M == 1024 else 10, cs.scl_work(info, M, B), scl_cuda.launch_plan(cs.N, cs.K, M, B))
    run("K1 P(128,64) M=256 B=1", lambda: scl_cuda.decode_scl_cuda(llr[:1], info, 256, cs.CRC), 20,
        cs.scl_work(info, 256, 1), scl_cuda.launch_plan(cs.N, cs.K, 256, 1))
    info_c = construct_info_set(1024, 512, method="gaussian_bitrev")
    x = torch.from_numpy(cs.make_llrs(np.random.default_rng(6), 1024, 1.75, info_c, n=1024)[0]).to(dev)
    run("K1 P(1024,512) M=64 B=1024", lambda: scl_cuda.decode_scl_cuda(x, info_c, 64, cs.CRC), 3,
        cs.scl_work(info_c, 64, 1024, n=1024, k=512), scl_cuda.launch_plan(1024, 512, 64, 1024))
    n_p, k_p, crc_p = cs.PAC_CODES[128]
    mask = cs.pac_mask(n_p, k_p + crc_p[0])
    x = cs.pac_llrs(np.random.default_rng(7), B, 2.5, cs.PAC_CODES[128], cs.PAC_GEN, mask, dev)
    for L in (64, 256, 1024):
        run(f"K3 PAC(128,64) L={L} B={B}",
            lambda L=L: pac_cuda.pac_list_decode_cuda(x, mask, cs.PAC_GEN, L, *crc_p),
            2 if L == 1024 else 10, cs.pac_work(mask, L, B), pac_cuda.launch_plan(n_p, k_p + crc_p[0], L))
    run("K3 PAC(128,64) L=256 B=1", lambda: pac_cuda.pac_list_decode_cuda(x[:1], mask, cs.PAC_GEN, 256, *crc_p),
        20, cs.pac_work(mask, 256, 1), pac_cuda.launch_plan(n_p, k_p + crc_p[0], 256))
    B = 1024  # on a cluster
    llr = llr[:B].contiguous()
    for M in (2048, 4096, 8192):
        run(f"K1 cluster P(128,64) M={M} B={B}", lambda M=M: scl_cuda.decode_scl_cuda(llr, info, M, cs.CRC),
            3 if M == 2048 else 2, cs.scl_work(info, M, B), scl_cuda.launch_plan(cs.N, cs.K, M, B))
    x = x[:B].contiguous()
    for L in (2048, 4096):
        run(f"K3 cluster PAC(128,64) L={L} B={B}",
            lambda L=L: pac_cuda.pac_list_decode_cuda(x, mask, cs.PAC_GEN, L, *crc_p),
            3 if L == 2048 else 2, cs.pac_work(mask, L, B), pac_cuda.launch_plan(n_p, k_p + crc_p[0], L))
    print(cs.nvidia_smi_line())
    print(json.dumps({"label": label, "ms": times, "frames_per_sm": per_sm}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
