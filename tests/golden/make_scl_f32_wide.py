"""Write the JAX package's SCL outputs at the port's wide envelope as golden files.

    python tests/golden/make_scl_f32_wide.py [decode] [fer] [fer16] [fer32]

Runs on the CPU with the JAX package.  With no argument it does both parts;
`fer16` and `fer32` run one list size of `fer`.

`decode` writes `scl_f32_wide.npz` beside this script: the outputs of the
XLA decoder `polar_code_tpu.ops.scl.decode_scl_batch` in float32
(`best_path_bits`, `best_path_info_llrs`, `crc_pass`, and the final metrics
of all M paths) on float32 LLRs of real CRC-24A codewords through BPSK +
AWGN, made as `make_scl_f32.py` makes them (`code_inputs`):

* P(128,64), `gaussian`, 256 frames, half at 1.5 dB and half at 3.0 dB, at
  M ∈ {3, 16, 32} (list sizes outside the byte-word instantiations of the
  CUDA kernel), CRC on and off, with and without a forced plan;
* P(4096,2048), `gaussian_bitrev`, 32 frames at 1.5 dB, M=8, CRC on.

`fer` writes `fer_wide/fer_M16.csv` and `fer_wide/fer_M32.csv`: the JAX FER
sweep CLI on the CPU at P(128,64) with DL-SCL retries, 40960 frames a point,
at two points where the SCL FER is between about 1e-1 and 1e-2: 4.0 and 4.5
dB at M=16, 3.5 and 4.0 dB at M=32.  The commands, run from the repository
root (11 and 33 minutes on 8 CPU cores):

    JAX_PLATFORMS=cpu POLAR_CODE_TPU_NO_CACHE=1 \
        python -m polar_code_tpu.eval.run_fer_sweep --M 16 \
        --frames 40960 --batch 4096 --snr_lo 4.0 --snr_hi 4.5 --snr_step 0.5 \
        --retries 8 --beta checkpoints/beta_M8.npy --seed 0 \
        --out_dir tests/golden/fer_wide --plot_dir <a scratch directory>
    (the same with --M 32 --snr_lo 3.5 --snr_hi 4.0)

`chip_smoke.py`'s `wide_envelope` phase holds the CUDA kernel to the npz up
to near-ties, and the port's FER CLI on the card to the CSVs at |z| < 3.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(HERE))

OUT = HERE / "scl_f32_wide.npz"
FER_DIR = HERE / "fer_wide"
FER_POINTS = {16: (4.0, 4.5), 32: (3.5, 4.0)}  # list size: Eb/N0 points, dB
FER_ARGS = ["--frames", "40960", "--batch", "4096", "--snr_step", "0.5", "--retries", "8",
            "--beta", "checkpoints/beta_M8.npy", "--seed", "0"]
# code name: N, K, construction, frames, Eb/N0 points (equal shares), seed
CODES = {
    "p128": (128, 64, "gaussian", 256, (1.5, 3.0), 1280),
    "n4096": (4096, 2048, "gaussian_bitrev", 32, (1.5,), 4096),
}
CASES = [("p128", M, crc, plan) for M in (3, 16, 32) for crc in (True, False)
         for plan in (False, True)] + [("n4096", 8, True, False)]


def make_decodes():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from make_scl_f32 import CRC, code_inputs

    from polar_code_tpu.ops.scl import decode_scl_batch

    arrays, cases, inputs = {}, [], {}
    for name, (N, K, method, frames, snrs, seed) in CODES.items():
        info, llr, _, plan = code_inputs(N, K, method, frames, snrs, seed)
        inputs[name] = (info, llr, plan)
        arrays[f"{name}/info"] = np.asarray(info, np.int32)
        arrays[f"{name}/llr"] = llr
        arrays[f"{name}/plan"] = plan
    for code, M, use_crc, use_plan in CASES:
        info, llr, plan = inputs[code]
        tag = f"{code}_M{M}_crc{int(use_crc)}_plan{int(use_plan)}"
        t = time.perf_counter()
        res = decode_scl_batch(
            jnp.asarray(llr), info, M, CRC if use_crc else None,
            force_info_bits=jnp.asarray(plan) if use_plan else None, dtype=jnp.float32,
        )
        arrays[f"{tag}/bits"] = np.asarray(res.best_path_bits, np.int8)
        arrays[f"{tag}/llrs"] = np.asarray(res.best_path_info_llrs, np.float32)
        arrays[f"{tag}/crc_pass"] = np.asarray(res.crc_pass, bool)
        arrays[f"{tag}/metrics"] = np.asarray(res.metrics, np.float32)
        cases.append({"name": tag, "code": code, "N": CODES[code][0], "K": CODES[code][1],
                      "M": M, "crc": CRC if use_crc else None, "plan": use_plan})
        print(f"{tag}: {time.perf_counter() - t:.1f} s, crc pass {int(np.sum(res.crc_pass))}/"
              f"{llr.shape[0]}", flush=True)
    arrays["cases"] = np.asarray(json.dumps(cases))
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


def make_fer(ms=tuple(FER_POINTS)):
    FER_DIR.mkdir(exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), POLAR_CODE_TPU_NO_CACHE="1")
    with tempfile.TemporaryDirectory() as plots:
        for M in ms:
            lo, hi = FER_POINTS[M]
            t = time.perf_counter()
            subprocess.run([sys.executable, "-m", "polar_code_tpu.eval.run_fer_sweep", "--M", str(M),
                            "--snr_lo", str(lo), "--snr_hi", str(hi), *FER_ARGS,
                            "--out_dir", str(FER_DIR), "--plot_dir", plots],
                           cwd=REPO, env=env, check=True)
            print(f"M={M}: {time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    parts = sys.argv[1:] or ["decode", "fer"]
    if "fer" in parts:
        make_fer()
    for M in FER_POINTS:
        if f"fer{M}" in parts:
            make_fer((M,))
    if "decode" in parts:
        make_decodes()
