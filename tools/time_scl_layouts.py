"""Time the SCL kernel's two σ layouts, and its by-path widths, against each
other on one NVIDIA card.

    python tools/time_scl_layouts.py [--rounds 5] [--ptxas FILE.cu ...]

Builds `polar_code_tpu_torch/csrc/scl_decode.cu` three ways, one `nvcc`
each, all started together (the source's dispatch note):

* default: byte words at M ∈ {1, 2, 4, 8}, by path elsewhere, least width 8;
* by_path: every M by path (-DSCL_BY_PATH_ONLY=1), least width 8;
* by_path_w4: every M by path at a least width of 4
  (-DSCL_BY_PATH_ONLY=1 -DSCL_LEAST_PATH_WIDTH=4).

Then, in interleaved rounds with CUDA events (the minimum over rounds is
reported), times each build's best-only launch at P(128,64) CRC-24A B=4096
5.0 dB for M ∈ {1, 2, 3, 4, 8}, and at P(2048,1024) (`gaussian_bitrev`)
CRC-24A B=4096 1.5 dB for M ∈ {4, 8}, and fails unless every build decodes
the same bits and CRC flags as the default one.  Prints the card's name
and power limit and each build's `-Xptxas -v` lines.  With `--ptxas`, also
compiles the given sources with the port's flags and prints their lines (a
parent checkout's `csrc/*.cu`, say, to compare registers and spills).
"""

import argparse
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (its helpers; importing arms its hang watchdog)
import numpy as np  # noqa: E402

chip_smoke.faulthandler.cancel_dump_traceback_later()

VARIANTS = {
    "default": (),
    "by_path": ("-DSCL_BY_PATH_ONLY=1",),
    "by_path_w4": ("-DSCL_BY_PATH_ONLY=1", "-DSCL_LEAST_PATH_WIDTH=4"),
}
SHAPES = [((128, 64, "gaussian", 5.0), M) for M in (1, 2, 3, 4, 8)] + [
    ((2048, 1024, "gaussian_bitrev", 1.5), M) for M in (4, 8)]
B = 4096


def ptxas_lines(log):
    return [f"  ptxas {r['entry']}: {r['regs']} registers, spills {r['spill_stores']} B stores / "
            f"{r['spill_loads']} B loads" for r in chip_smoke.ptxas_report(log)]


def compile_log(src):
    """nvcc's -Xptxas -v report for one source, built with the port's flags."""

    from polar_code_tpu_torch import _build

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", f"{tmp}/lib.so", str(src)],
                              capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return proc.stdout + proc.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--ptxas", nargs="*", default=[], help="further .cu files to report")
    args = ap.parse_args()

    import torch

    from polar_code_tpu_torch import _build
    from polar_code_tpu_torch.ops import scl_cuda
    from polar_code_tpu_torch.polar.construct import construct_info_set

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi_line())
    with ThreadPoolExecutor(max_workers=len(VARIANTS) + len(args.ptxas)) as pool:
        builds = dict(zip(VARIANTS, pool.map(lambda d: _build.build(scl_cuda.SOURCE, d), VARIANTS.values())))
        extra = list(pool.map(compile_log, args.ptxas))
    for name, built in builds.items():
        print(f"build {name} ({' '.join(VARIANTS[name]) or 'no defines'}): {built.seconds:.2f} s")
        print("\n".join(ptxas_lines(built.log)))
    for src, log in zip(args.ptxas, extra):
        print(f"ptxas of {src}:")
        print("\n".join(ptxas_lines(log)))

    dev = torch.device("cuda")
    default_library = scl_cuda._library

    default_byte_words = scl_cuda.BYTE_WORD_M

    def use(name):  # route the wrapper's launches, and its reckoning, to one build's layouts
        lib = default_library(VARIANTS[name])
        scl_cuda._library = lambda: lib
        scl_cuda.BYTE_WORD_M = default_byte_words if name == "default" else ()
        scl_cuda._occupancy.cache_clear()
        scl_cuda._plan.cache_clear()

    rng = np.random.default_rng(13)
    inputs = {}
    for (n, k, method, snr), _ in SHAPES:
        if (n, k) not in inputs:
            info = construct_info_set(n, k, method=method)
            inputs[n, k] = (info, torch.from_numpy(chip_smoke.make_llrs(rng, B, snr, info, n=n)[0]).to(dev))
    times, decoded = {}, {}
    for rnd in range(args.rounds):
        for name in VARIANTS:
            use(name)
            for (n, k, _, _), M in SHAPES:
                info, x = inputs[n, k]
                if rnd == 0:
                    got = scl_cuda.decode_scl_cuda(x, info, M, chip_smoke.CRC)
                    decoded.setdefault((n, M), {})[name] = got
                reps = 20 if n == 128 else 5
                ms = chip_smoke.cuda_time_ms(lambda: scl_cuda.decode_scl_cuda(x, info, M, chip_smoke.CRC),
                                             reps=reps)
                key = (n, k, M)
                times.setdefault(key, {}).setdefault(name, []).append(ms)
    scl_cuda._library = default_library
    scl_cuda.BYTE_WORD_M = default_byte_words
    ok = True
    for (n, k, _, snr), M in SHAPES:
        outs = decoded[n, M]
        for name, got in outs.items():
            same = all(torch.equal(got[f], outs["default"][f]) for f in ("best_path_bits", "crc_pass"))
            ok &= same
            if not same:
                print(f"P({n},{k}) M={M}: build {name} decodes other bits than the default build")
        row = times[n, k, M]
        cells = ", ".join(f"{name} {min(v):.4f} ms (LM={_width(name, M)})" for name, v in row.items())
        print(f"P({n},{k}) CRC-24A B={B} {snr} dB M={M}: {cells}; min of {args.rounds} rounds")
    return 0 if ok else 1


def _width(name, M):
    if name == "default" and M in (1, 2, 4, 8):
        return "byte words"
    least = 4 if name == "by_path_w4" else 8
    return max(least, 1 << (M - 1).bit_length())


if __name__ == "__main__":
    sys.exit(main())
