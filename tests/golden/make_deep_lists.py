"""Write the JAX package's list decodes at list sizes above 32 as golden files.

    python tests/golden/make_deep_lists.py [decode | scl | pac] [fer] [legacy]

Runs on the CPU with the JAX package; with no argument it does all three
parts (`decode` is `scl` and `pac`).  `chip_smoke.py`'s `deep_lists` phase holds the port on the card to
them.

`decode` writes, beside this script:

* `scl_f32_deep.npz`: the outputs of the XLA decoder
  `polar_code_tpu.ops.scl.decode_scl_batch` in float32 (`best_path_bits`,
  `best_path_info_llrs`, `crc_pass`, and the final metrics of all M paths)
  on float32 LLRs of real CRC-24A codewords through BPSK + AWGN, made as
  `make_scl_f32.py` makes them (`code_inputs`): P(128,64) `gaussian`, 48
  frames, half at 1.5 dB and half at 3.0 dB, at M=64 (CRC on and off, plan
  on and off), M=256 and M=1024 (CRC on); P(1024,512) `gaussian_bitrev`, 16
  frames at 1.5 dB, M=64 CRC on;
* `pac_deep.npz`: the outputs of the XLA decoder
  `polar_code_tpu.legacy.pac.pac_list_decode_batch` (`extracted`,
  `crc_pass`, `metrics`, `v_full`, `candidates`) on LLRs made as
  `make_legacy_pac.py` makes them (`case_llrs`), gen 1011011, `dega`:
  PAC(128,64)+CRC-16 at L 64, 256 and 1024 (48 frames at 1.5 and 2.5 dB);
  PAC(2048,1024)+CRC-16 at L=32 and PAC(8192,4096)+CRC-16 at L=8 (8 frames
  at 1.5 dB).

`fer` writes `fer_deep/fer_M64.csv`: the JAX FER sweep CLI on the CPU at
P(128,64) M=64 with DL-SCL retries, 40960 frames a point, at 3.0 and 3.5
dB, where the SCL FER is between about 1e-1 and 1e-2.  The command, run from
the repository root (78 minutes on 8 CPU cores):

    JAX_PLATFORMS=cpu POLAR_CODE_TPU_NO_CACHE=1 \\
        python -m polar_code_tpu.eval.run_fer_sweep --M 64 \\
        --frames 40960 --batch 4096 --snr_lo 3.0 --snr_hi 3.5 --snr_step 0.5 \\
        --retries 8 --beta checkpoints/beta_M8.npy --seed 0 \\
        --out_dir tests/golden/fer_deep --plot_dir <a scratch directory>

`legacy` writes `legacy_pac_deep.json`: the JAX legacy simulator
(`polar_code_tpu.legacy.simulator.run`) at `LegacySimConfig(list_size_max=
256, snr_range=[3.0, 3.5], seed=0)` (the SNR points of
`legacy_pac_drivers.json`), after `np.random.seed(0)`, with its BER, FER,
progress lines and CSV.  It draws with numpy and the PAC metric has no
transcendentals, so the port's counts must equal these exactly.
"""

import contextlib
import io
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

SCL_OUT = HERE / "scl_f32_deep.npz"
PAC_OUT = HERE / "pac_deep.npz"
LEGACY_OUT = HERE / "legacy_pac_deep.json"
FER_DIR = HERE / "fer_deep"
FER_M = 64
FER_POINTS = (3.0, 3.5)  # Eb/N0, dB
FER_ARGS = ["--frames", "40960", "--batch", "4096", "--snr_step", "0.5", "--retries", "8",
            "--beta", "checkpoints/beta_M8.npy", "--seed", "0"]
# code name: N, K, construction, frames, Eb/N0 points (equal shares), seed
SCL_CODES = {
    "p128": (128, 64, "gaussian", 48, (1.5, 3.0), 1414),
    "n1024": (1024, 512, "gaussian_bitrev", 16, (1.5,), 1415),
}
SCL_CASES = ([("p128", 64, crc, plan) for crc in (True, False) for plan in (False, True)]
             + [("p128", 256, True, False), ("p128", 1024, True, False), ("n1024", 64, True, False)])
PAC_GEN = [1, 0, 1, 1, 0, 1, 1]
# name, N, K (payload), L, frames, (Eb/N0 points), seed; CRC-16 0x1021, `dega`
PAC_CASES = [
    ("pac128_L64", 128, 64, 64, 48, (1.5, 2.5), 2064),
    ("pac128_L256", 128, 64, 256, 48, (1.5, 2.5), 2256),
    ("pac128_L1024", 128, 64, 1024, 48, (1.5, 2.5), 2024),
    ("pac2048_L32", 2048, 1024, 32, 8, (1.5,), 2032),
    ("pac8192_L8", 8192, 4096, 8, 8, (1.5,), 2008),
]
PAC_CRC = (16, 0x1021)
SIM_SNR = [3.0, 3.5]
SIM_LIST_MAX = 256


def make_scl():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from make_scl_f32 import CRC, code_inputs

    from polar_code_tpu.ops.scl import decode_scl_batch

    arrays, cases, inputs = {}, [], {}
    for name, (N, K, method, frames, snrs, seed) in SCL_CODES.items():
        info, llr, _, plan = code_inputs(N, K, method, frames, snrs, seed)
        inputs[name] = (info, llr, plan)
        arrays[f"{name}/info"] = np.asarray(info, np.int32)
        arrays[f"{name}/llr"] = llr
        arrays[f"{name}/plan"] = plan
    for code, M, use_crc, use_plan in SCL_CASES:
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
        cases.append({"name": tag, "code": code, "N": SCL_CODES[code][0], "K": SCL_CODES[code][1],
                      "M": M, "crc": CRC if use_crc else None, "plan": use_plan})
        print(f"{tag}: {time.perf_counter() - t:.1f} s, crc pass {int(np.sum(res.crc_pass))}/"
              f"{llr.shape[0]}", flush=True)
    arrays["cases"] = np.asarray(json.dumps(cases))
    np.savez_compressed(SCL_OUT, **arrays)
    print(f"wrote {SCL_OUT} ({SCL_OUT.stat().st_size} bytes)")


def make_pac():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import make_legacy_pac

    from polar_code_tpu.legacy.pac import pac_list_decode_batch
    from polar_code_tpu.legacy.rate_profile import rateprofile

    arrays, meta = {}, []
    crc_len, crc_poly = PAC_CRC
    for name, N, K, L, frames, snrs, seed in PAC_CASES:
        rp = rateprofile(N, K + crc_len, 2.0, 0)
        rp.build_mask("dega")
        mask = np.asarray(rp.modify_profile(), np.int8)
        make_legacy_pac.FRAMES = frames  # case_llrs draws FRAMES frames, half at each SNR
        llr = make_legacy_pac.case_llrs(N, K, crc_len, crc_poly, PAC_GEN, mask,
                                        snrs if len(snrs) == 2 else snrs * 2, seed)
        t = time.perf_counter()
        out = pac_list_decode_batch(jnp.asarray(llr), mask, PAC_GEN, L, crc_len=crc_len,
                                    crc_poly=crc_poly, dtype=jnp.float32)
        arrays[f"{name}/llr"] = llr
        arrays[f"{name}/mask"] = mask
        for f, dt in (("extracted", np.int8), ("crc_pass", bool), ("metrics", np.float32),
                      ("v_full", np.int8), ("candidates", np.int8)):
            arrays[f"{name}/{f}"] = np.asarray(out[f], dt)
        meta.append({"name": name, "N": N, "K": K, "crc_len": crc_len, "crc_poly": crc_poly,
                     "gen": PAC_GEN, "L": L, "profile": "dega", "snr_db": list(snrs)})
        print(f"{name}: {time.perf_counter() - t:.1f} s, crc pass "
              f"{int(arrays[f'{name}/crc_pass'].sum())}/{frames}", flush=True)
    arrays["cases"] = np.asarray(json.dumps(meta))
    np.savez_compressed(PAC_OUT, **arrays)
    print(f"wrote {PAC_OUT} ({PAC_OUT.stat().st_size} bytes)")


def make_fer():
    FER_DIR.mkdir(exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), POLAR_CODE_TPU_NO_CACHE="1")
    with tempfile.TemporaryDirectory() as plots:
        t = time.perf_counter()
        subprocess.run([sys.executable, "-m", "polar_code_tpu.eval.run_fer_sweep", "--M", str(FER_M),
                        "--snr_lo", str(FER_POINTS[0]), "--snr_hi", str(FER_POINTS[1]), *FER_ARGS,
                        "--out_dir", str(FER_DIR), "--plot_dir", plots],
                       cwd=REPO, env=env, check=True)
        print(f"M={FER_M}: {time.perf_counter() - t:.1f} s", flush=True)


def make_legacy():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from polar_code_tpu.legacy import simulator

    t = time.perf_counter()
    np.random.seed(0)
    cfg = simulator.LegacySimConfig(snr_range=SIM_SNR, seed=0, list_size_max=SIM_LIST_MAX)
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
        res = simulator.run(cfg, out_dir=tmp)
        csv_text = next(Path(tmp).glob("*.csv")).read_text()
    run = {
        "config": {"snr_range": SIM_SNR, "seed": 0, "list_size_max": SIM_LIST_MAX},
        "snr_range": res.snr_range, "ber": res.ber, "fer": res.fer,
        "fname": res.fname, "csv": csv_text,
        "lines": [ln for ln in buf.getvalue().splitlines() if ln.startswith("@")],
        "seconds": time.perf_counter() - t,
    }
    LEGACY_OUT.write_text(json.dumps({"simulator": run}, indent=1) + "\n")
    print(f"simulator at list_size_max={SIM_LIST_MAX}: {run['seconds']:.1f} s; wrote {LEGACY_OUT}",
          flush=True)


if __name__ == "__main__":
    parts = sys.argv[1:] or ["decode", "fer", "legacy"]
    if "fer" in parts:
        make_fer()
    if "legacy" in parts:
        make_legacy()
    if "decode" in parts or "scl" in parts:
        make_scl()
    if "decode" in parts or "pac" in parts:
        make_pac()
