#!/usr/bin/env python3
"""Time the by-path SCL list decoder (list sizes 3–32) of one checkout, on one CUDA card.

    python tools/time_path_lists.py [--repo DIR] [--label NAME] [--sweep]

DIR (default: this checkout) is the root of the checkout whose
`polar_code_tpu_torch` is imported, built into DIR/build and timed; the
shapes, LLRs (numpy draws) and CUDA-event timing are this checkout's
(`chip_smoke.py` phase 13 (f): `PATH_TIMES`, `time_by_path`).  To compare
two versions of the kernel, run it on one card, in one go, for a parent
checkout and for the change, in the order parent, change, change, parent.

Shapes: the SCL kernel K1 through its by-path instantiation at P(128,64)
CRC-24A, 5.0 dB, M 3, 16 and 32, at B=4096 (a FER step's baseline launch),
B=400 (a retry launch) and B=1 (a scalar call's latency); P(1024,512)
`gaussian_bitrev` M=16, 1.75 dB, B=1024; and P(8192,4096) `gaussian_bitrev`
M=32, 1.5 dB, B=1024.  Prints the `-Xptxas -v` registers and spills of
every K1 entry of DIR's build, a line a shape (its time, its bound from
`chip_smoke.py`'s work counts, and the wrapper's launch plan: tree levels in
global scratch G, frames a block and frames an SM), with `--sweep` the same
shapes at every G within two of the plan's, the card's `nvidia-smi` name and
power limit, and a JSON line of every time last.
"""

import argparse
import inspect
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE), help="checkout whose kernel is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--sweep", action="store_true",
                    help="also time each shape of B > 1 at every G within two of the plan's")
    args = ap.parse_args()
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import faulthandler
    import importlib.util

    import torch

    # this checkout's chip_smoke.py, whatever DIR holds; it arms a watchdog
    # when imported, which a timing run does not need
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    faulthandler.cancel_dump_traceback_later()
    from polar_code_tpu_torch import _build
    from polar_code_tpu_torch.ops import scl_cuda

    if not torch.cuda.is_available():
        print("time_path_lists: no CUDA device is available", file=sys.stderr)
        return 1
    label = args.label or str(repo)
    dev = torch.device("cuda")
    built = _build.build(scl_cuda.SOURCE)
    for row in cs.ptxas_report(built.log):
        if row["entry"].startswith("scl_"):
            print(f"  [{label}] ptxas {row['entry']}: {row['regs']} registers, spills "
                  f"{row['spill_stores']} B stores / {row['spill_loads']} B loads", flush=True)
    # a checkout whose plan for this layout takes the batch size, or one whose plan does not
    takes_b = "B" in inspect.signature(scl_cuda.launch_plan).parameters

    def plan_of(n, k, M, B):
        return scl_cuda.launch_plan(n, k, M, B) if takes_b else scl_cuda.launch_plan(n, k, M)

    res = cs.time_by_path(dev, plan_of, f"[{label}] ", args.sweep)
    times = {t: v[0] if isinstance(v, tuple) else v for t, v in res.items()}
    plans = {t: list(v[3]) for t, v in res.items() if isinstance(v, tuple)}
    print(cs.nvidia_smi_line())
    print(json.dumps({"label": label, "ms": times, "plan": plans}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
