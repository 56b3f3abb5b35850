#!/usr/bin/env python3
"""Time the PAC list-decode kernel K3 of one checkout, on one CUDA card.

    python tools/time_pac_cuda.py [--repo DIR] [--label NAME]

DIR (default: this checkout) is the root of the checkout whose
`polar_code_tpu_torch` is imported, built into DIR/build and timed; the
shapes, LLRs (numpy draws, seed 11) and CUDA-event timing are this
checkout's (`chip_smoke.py` phase 11).  To compare two versions of the
kernel, run it on one card, in one go, for a parent checkout and for the
change, in the order parent, change, change, parent.

Shapes: PAC(64,32), PAC(128,64) and PAC(256,128) with CRC-16 0x1021, gen
1011011, `dega`, 2.5 dB, at L ∈ {1, 2, 4, 8, 32} and B=65536; PAC(128,64) L 8
and 32 and PAC(1024,512) L=32 at B=4096; PAC(8192,4096) L=8 at B=1024 and
1.5 dB (its trace walked back in chunks); the legacy drivers' shapes (PAC(64,32) L=1
B=256 and L=32 B=16, P(128,64+16) L=16 B=128), and PAC(64,32) L=1 B=1, a
launch's floor (the wrapper's host time, or one frame's latency, whichever
is longer).  Each shape has three times a launch: the CUDA-event time of
back-to-back calls of the wrapper (`ms`), the device time of the kernel
alone, from `torch.profiler` (`kernel_ms`), and the host time of the
wrapper, calls queued without a sync (`host_ms`).  `--only A|B` times the
shapes whose name holds A or B.  Prints a line a shape, the card's
`nvidia-smi` name and power limit, and a JSON line of every time last.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE), help="checkout whose kernel is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", default="", help="time only the shapes whose name holds one of these ('|' between them)")
    args = ap.parse_args()
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import faulthandler
    import importlib.util
    import time

    import numpy as np
    import torch

    # this checkout's chip_smoke.py, whatever DIR holds; it arms a watchdog
    # when imported, which a timing run does not need
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    faulthandler.cancel_dump_traceback_later()
    from polar_code_tpu_torch.legacy.pac_cuda import pac_list_decode_cuda

    if not torch.cuda.is_available():
        print("time_pac_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    label = args.label or str(repo)
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    times, kernel_times, host_times = {}, {}, {}

    def kernel_ms(fn, reps):
        # device time of the PAC kernels alone, a call
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.key_averages() if "pac_" in e.key and "_kernel" in e.key]
        return sum(e.device_time_total for e in ks) / 1e3 / max(1, sum(e.count for e in ks))

    def host_ms(fn, reps):
        # the wrapper's host time, a call: calls queued, no sync between them
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / reps

    def run(tag, x, mask, gen, L, crc, reps):
        if not any(o in tag for o in args.only.split("|")):
            return
        fn = lambda: pac_list_decode_cuda(x, mask, gen, L, *crc)  # noqa: E731
        times[tag] = ms = cs.cuda_time_ms(fn, reps=reps)
        kernel_times[tag] = km = kernel_ms(fn, reps)
        host_times[tag] = hm = host_ms(fn, reps)
        print(f"  [{label}] {tag}: {ms:.4f} ms, kernel {km:.4f} ms, host {hm:.4f} ms ({reps} launches)",
              flush=True)

    for n_p, code in cs.PAC_CODES.items():
        mask = cs.pac_mask(n_p, code[1] + cs.PAC_CRC[0])
        x = cs.pac_llrs(rng, cs.PAC_BATCH, 2.5, code, cs.PAC_GEN, mask, dev)
        for L in (1, 2, 4, 8, 32):
            run(f"PAC({n_p},{code[1]}) L={L} B={cs.PAC_BATCH}", x, mask, cs.PAC_GEN, L, cs.PAC_CRC,
                reps=10 if L < 32 else 3)
        if n_p == 128:
            for L in (8, 32):
                run(f"PAC(128,64) L={L} B=4096", x[:4096].contiguous(), mask, cs.PAC_GEN, L, cs.PAC_CRC,
                    reps=20)
    mask = cs.pac_mask(1024, 528)
    x = cs.pac_llrs(rng, 4096, 2.5, (1024, 512, cs.PAC_CRC), cs.PAC_GEN, mask, dev)
    run("PAC(1024,512) L=32 B=4096", x, mask, cs.PAC_GEN, 32, cs.PAC_CRC, reps=3)
    mask = cs.pac_mask(8192, 4112)
    x = cs.pac_llrs(rng, 1024, 1.5, (8192, 4096, cs.PAC_CRC), cs.PAC_GEN, mask, dev)
    run("PAC(8192,4096) L=8 B=1024", x, mask, cs.PAC_GEN, 8, cs.PAC_CRC, reps=2)
    sim_mask = cs.pac_mask(64, 32)
    for L, B in ((1, 256), (32, 16), (1, 1)):  # B=1: a launch's floor, host and card
        x = cs.pac_llrs(rng, B, 3.0, (64, 32, None), cs.PAC_GEN, sim_mask, dev)
        run(f"simulator PAC(64,32) L={L} B={B}", x, sim_mask, cs.PAC_GEN, L, (0, 0), reps=50)
    unc_mask = cs.pac_mask(128, 80)
    x = cs.pac_llrs(rng, 128, 2.0, (128, 64, cs.PAC_CRC), [1], unc_mask, dev)
    run("crc_polar_vs_uncoded P(128,64+16) L=16 B=128", x, unc_mask, [1], 16, cs.PAC_CRC, reps=50)
    print(cs.nvidia_smi_line())
    print(json.dumps({"label": label, "launches": pac_list_decode_cuda.launches, "ms": times,
                      "kernel_ms": kernel_times, "host_ms": host_times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
