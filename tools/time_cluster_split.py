#!/usr/bin/env python3
"""Split the time of K1's and K3's cluster instantiations by timing-only variants, on one CUDA card.

    python tools/time_cluster_split.py [--repo DIR] [--label NAME] [--variants 2,4]
        [--ms 2048,8192] [--ls 2048] [--batch 1024] [--leaf-g]

DIR (default: this checkout) is the root of the checkout whose
`polar_code_tpu_torch` is imported and whose `csrc/scl_decode.cu` and
`csrc/pac_decode.cu` are built (into DIR/build), each once a variant, all
the `nvcc` runs started together.  Variant 0 is the sources as they are.
Every other variant is a patch (`PATCHES`) applied to a copy of DIR's
`csrc/` under DIR/build/cluster_split/: 2 drops the phase-end cluster
barrier (every `cluster_arrive()` / `cluster_wait()` of the two kernel
files), 4 the σ fork's copy of the parent's row (`cluster_sigma_fork`,
one path a thread), 8 runs each sort of a launch twice (a fork's and the
final rank's: the second sorts the keys the first left in the threads'
registers, the same multiset, so the outputs stay right, and the time
variant 8 adds is the sorts').  Variants 2 and 4 give wrong outputs: no
wrapper routes to any variant, and this tool only times them.  A patch
that no longer matches the sources stops the tool.

Shapes (`chip_smoke.py` phase 15 (f)'s inputs): K1 at P(128,64) CRC-24A
5.0 dB, M in `--ms` (2048 and 8192), K3 at PAC(128,64)+CRC-16 2.5 dB, L in
`--ls` (2048), B = `--batch` (1024).  Each shape is timed with CUDA events
in the order 0, 2, 4, 4, 2, 0 (the variants asked for), a few launches
each; `--leaf-g` also times variant 0 with every tree level but the leaf
in global scratch (G = n − 1, the only G a block's shared memory holds at
four paths a thread) beside the plan's G.  Prints each build's `-Xptxas
-v` lines for the cluster kernels, a line a shape and variant, the card's
`nvidia-smi` name and power limit, and a JSON line of every time last.
"""

import argparse
import ctypes
import json
import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
NAMES = {"0": "as built", "2": "no phase-end barrier", "4": "no σ fork copy", "8": "each sort twice"}
# a sort call of the two kernel bodies, with its exchange count argument
SORT = r"cluster_sort<PPT>\(keys, kk, P, rank, tid, info_i \* cluster_exchanges<PPT>\(P\)\)"
# variant: [(file in csrc/, pattern, replacement)]; each pattern must match
PATCHES = {
    "2": [(f, r"\bcluster_(arrive|wait)\(\);", ";") for f in ("scl_decode.cu", "pac_decode.cu")],
    "4": [("list_decode.cuh", r"#pragma unroll 4\n\s*for \(int k = 0; k < sig\.words; \+\+k\) dst\[k\] = src\[k\];",
           "")],
    # sort i of a launch at exchanges 2i·E and (2i + 1)·E, E = cluster_exchanges<PPT>(P): the buffers' turns
    # of a launch whose sorts are twice as many
    "8": [(f, SORT, "(cluster_sort<PPT>(keys, kk, P, rank, tid, 2 * info_i * cluster_exchanges<PPT>(P)), "
                    "cluster_sort<PPT>(keys, kk, P, rank, tid, (2 * info_i + 1) * cluster_exchanges<PPT>(P)))")
          for f in ("scl_decode.cu", "pac_decode.cu")],
}


def patched_csrc(csrc: Path, variant: str, into: Path) -> Path:
    """A copy of `csrc` with `PATCHES[variant]` applied, at `into`/<variant>."""

    out = into / variant
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for name, pattern, repl in PATCHES[variant]:
        path = out / name
        text, count = re.subn(pattern, repl, path.read_text())
        if count == 0:
            raise RuntimeError(f"variant {variant}: {pattern!r} matches nothing in {name}")
        path.write_text(text)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE), help="checkout whose kernels are built and timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--variants", default="2,4", help="the patched variants beside 0")
    ap.add_argument("--ms", default="2048,8192", help="K1's list sizes")
    ap.add_argument("--ls", default="2048", help="K3's list sizes")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--leaf-g", action="store_true", help="also time variant 0 at G = n - 1")
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
    from polar_code_tpu_torch import _build
    from polar_code_tpu_torch.legacy import pac_cuda
    from polar_code_tpu_torch.ops import scl_cuda
    from polar_code_tpu_torch.polar.construct import construct_info_set

    if not torch.cuda.is_available():
        print("time_cluster_split: no CUDA device is available", file=sys.stderr)
        return 1
    label = args.label or str(repo)
    variants = ["0"] + [v for v in args.variants.split(",") if v]
    csrc = {"0": _build.CSRC}
    csrc.update({v: patched_csrc(_build.CSRC, v, repo / "build" / "cluster_split") for v in variants[1:]})
    modules = {"scl": (scl_cuda, "scl"), "pac": (pac_cuda, "pac")}
    jobs = [(k, v) for k in modules for v in variants]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: _build.build(modules[kv[0]][0].SOURCE, csrc=csrc[kv[1]]),
                                        jobs)))
    libs = {}
    for (k, v), b in built.items():
        mod, pre = modules[k]
        base = mod._library()
        lib = ctypes.CDLL(str(b.path))
        for fn in (f"{pre}_decode_launch", f"{pre}_launch_plan", f"{pre}_error_string"):
            getattr(lib, fn).argtypes = getattr(base, fn).argtypes
            getattr(lib, fn).restype = getattr(base, fn).restype
        libs[k, v] = lib
        for row in cs.ptxas_report(b.log):
            if "_cluster" in row["entry"]:
                print(f"  [{label}] {v} ({NAMES[v]}) ptxas {row['entry']}: {row['regs']} registers, spills "
                      f"{row['spill_stores']} B")
    defaults = {k: mod._library for k, (mod, _) in modules.items()}

    def use(k, v):  # route the wrapper's launches to one build
        modules[k][0]._library = lambda *a: libs[k, v]

    dev = torch.device("cuda")
    B = args.batch
    info = construct_info_set(cs.N, cs.K)
    llr = torch.from_numpy(cs.make_llrs(np.random.default_rng(5), B, 5.0, info)[0]).to(dev)
    n_p, k_p, crc_p = cs.PAC_CODES[128]
    mask = cs.pac_mask(n_p, k_p + crc_p[0])
    xp = cs.pac_llrs(np.random.default_rng(6), B, 2.5, cs.PAC_CODES[128], cs.PAC_GEN, mask, dev)
    k1_ms = [int(M) for M in args.ms.split(",") if M]
    k3_ls = [int(L) for L in args.ls.split(",") if L]
    shapes = [("scl", f"K1 P(128,64) M={M} B={B}", lambda M=M: scl_cuda.decode_scl_cuda(llr, info, M, cs.CRC),
               3 if M == 2048 else 2) for M in k1_ms]
    shapes += [("pac", f"K3 PAC(128,64) L={L} B={B}",
                lambda L=L: pac_cuda.pac_list_decode_cuda(xp, mask, cs.PAC_GEN, L, *crc_p), 3 if L == 2048 else 2)
               for L in k3_ls]
    n = cs.N.bit_length() - 1
    leaf = {}  # variant 0 at G = n − 1 (levels 1..n−1 in global scratch), and the plan's G
    if args.leaf_g:
        info_np = np.asarray(info, np.int64)
        for M in k1_ms:
            leaf[f"K1 P(128,64) M={M} B={B}"] = (
                lambda M=M: scl_cuda._launch(llr, info_np, M, cs.CRC, None, n - 1, 1),
                scl_cuda.launch_plan(cs.N, cs.K, M, B)[0])
        for L in k3_ls:
            plan = pac_cuda._plan(np.asarray(mask, np.int8).tobytes(), tuple(cs.PAC_GEN), L, crc_p[0], crc_p[1],
                                  torch.float32, dev, n - 1)
            leaf[f"K3 PAC(128,64) L={L} B={B}"] = (lambda plan=plan: pac_cuda._launch(xp, plan),
                                                   pac_cuda.launch_plan(n_p, k_p + crc_p[0], L)[0])
    times = {}
    order = variants + variants[::-1]
    try:
        for k, tag, fn, reps in shapes:
            for v in order:
                use(k, v)
                ms = cs.cuda_time_ms(fn, reps=reps, warmup=1)
                times.setdefault(tag, {}).setdefault(v, []).append(ms)
                print(f"  [{label}] {tag} {v} ({NAMES[v]}): {ms:.4f} ms ({reps} launches)", flush=True)
            if tag in leaf:
                use(k, "0")
                ms = cs.cuda_time_ms(leaf[tag][0], reps=reps, warmup=1)
                times[tag]["G=n-1"] = [ms]
                print(f"  [{label}] {tag} 0 at G = n - 1 = {n - 1} (the plan's G: {leaf[tag][1]}): {ms:.4f} ms "
                      f"({reps} launches)", flush=True)
    finally:
        for k, (mod, _) in modules.items():
            mod._library = defaults[k]
    for tag, row in times.items():
        base = sum(row["0"]) / len(row["0"])
        row = {v: t for v, t in row.items() if v in NAMES}
        cells = "; ".join(f"{v} {sum(t) / len(t):.4f} ms ({100 * (1 - sum(t) / len(t) / base):+.1f}%)"
                          for v, t in row.items() if v != "0")
        print(f"  [{label}] {tag}: as built {base:.4f} ms; {cells} (mean of the two turns; % of the time "
              f"the variant saves)")
    print(cs.nvidia_smi_line())
    print(json.dumps({"label": label, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
