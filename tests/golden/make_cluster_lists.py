"""Write the JAX package's list decodes at list sizes above 1024 as golden files.

    python tests/golden/make_cluster_lists.py [decode | scl | pac] [legacy]

Runs on the CPU with the JAX package; with no argument it does both parts
(`decode` is `scl` and `pac`).  `chip_smoke.py`'s `cluster_lists` phase
holds the port's cluster instantiations on the card to them.

`decode` writes, beside this script:

* `scl_f32_cluster.npz`: the outputs of the XLA decoder
  `polar_code_tpu.ops.scl.decode_scl_batch` in float32 (`best_path_bits`,
  `best_path_info_llrs`, `crc_pass`, and the final metrics of all M paths)
  on float32 LLRs of real CRC-24A codewords through BPSK + AWGN, made as
  `make_scl_f32.py` makes them (`code_inputs`): P(128,64) `gaussian`, 16
  frames, half at 1.5 dB and half at 3.0 dB, at M=2048 (CRC on, plan off
  and on), M=4096 and M=8192 (CRC on);
* `pac_cluster.npz`: the outputs of the XLA decoder
  `polar_code_tpu.legacy.pac.pac_list_decode_batch` (`extracted`,
  `crc_pass`, `metrics`, `v_full`, `candidates`) on LLRs made as
  `make_legacy_pac.py` makes them (`case_llrs`), gen 1011011, `dega`:
  PAC(128,64)+CRC-16 at L=2048, 16 frames at 1.5 and 2.5 dB.

N=8192 at M=2048 is too slow for the XLA decoder on a CPU; the card holds
that shape to the plain PyTorch version instead (`chip_smoke.py` phase 15
(a): P(8192,2048) M=2048, 2 frames at each of two draws).

`legacy` writes `legacy_pac_cluster.json`: the JAX legacy simulator
(`polar_code_tpu.legacy.simulator.run`) at `LegacySimConfig(list_size_max=
2048, snr_range=[3.0, 3.5], seed=0)`, after `np.random.seed(0)`, with its
BER, FER, progress lines and CSV, as `make_deep_lists.py legacy` writes
them at list_size_max=256.

CPU times of the committed files (one run of `legacy scl pac`, 8 cores, 5
min 18 s in all): `legacy` 207 s; `scl` 88 s (M=2048 15 s and, with the
plan, 6 s; M=4096 29 s; M=8192 38 s); `pac` 6 s.
"""

import contextlib
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(HERE))

SCL_OUT = HERE / "scl_f32_cluster.npz"
PAC_OUT = HERE / "pac_cluster.npz"
LEGACY_OUT = HERE / "legacy_pac_cluster.json"
# code name: N, K, construction, frames, Eb/N0 points (equal shares), seed
SCL_CODES = {"p128": (128, 64, "gaussian", 16, (1.5, 3.0), 1417)}
SCL_CASES = [("p128", 2048, False), ("p128", 2048, True), ("p128", 4096, False), ("p128", 8192, False)]
PAC_GEN = [1, 0, 1, 1, 0, 1, 1]
# name, N, K (payload), L, frames, (Eb/N0 points), seed; CRC-16 0x1021, `dega`
PAC_CASES = [("pac128_L2048", 128, 64, 2048, 16, (1.5, 2.5), 2048)]
PAC_CRC = (16, 0x1021)
SIM_SNR = [3.0, 3.5]
SIM_LIST_MAX = 2048


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
    for code, M, use_plan in SCL_CASES:
        info, llr, plan = inputs[code]
        tag = f"{code}_M{M}_crc1_plan{int(use_plan)}"
        t = time.perf_counter()
        res = decode_scl_batch(jnp.asarray(llr), info, M, CRC,
                               force_info_bits=jnp.asarray(plan) if use_plan else None,
                               dtype=jnp.float32)
        arrays[f"{tag}/bits"] = np.asarray(res.best_path_bits, np.int8)
        arrays[f"{tag}/llrs"] = np.asarray(res.best_path_info_llrs, np.float32)
        arrays[f"{tag}/crc_pass"] = np.asarray(res.crc_pass, bool)
        arrays[f"{tag}/metrics"] = np.asarray(res.metrics, np.float32)
        cases.append({"name": tag, "code": code, "N": SCL_CODES[code][0], "K": SCL_CODES[code][1],
                      "M": M, "crc": CRC, "plan": use_plan})
        print(f"{tag}: {time.perf_counter() - t:.1f} s, crc pass {int(np.sum(res.crc_pass))}/"
              f"{llr.shape[0]}", flush=True)
    arrays["cases"] = np.asarray(json.dumps(cases))
    np.savez_compressed(SCL_OUT, **arrays)
    print(f"wrote {SCL_OUT} ({SCL_OUT.stat().st_size} bytes)")


def make_pac():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import make_legacy_pac
    import numpy as np

    from polar_code_tpu.legacy.pac import pac_list_decode_batch
    from polar_code_tpu.legacy.rate_profile import rateprofile

    arrays, meta = {}, []
    crc_len, crc_poly = PAC_CRC
    for name, N, K, L, frames, snrs, seed in PAC_CASES:
        rp = rateprofile(N, K + crc_len, 2.0, 0)
        rp.build_mask("dega")
        mask = np.asarray(rp.modify_profile(), np.int8)
        make_legacy_pac.FRAMES = frames  # case_llrs draws FRAMES frames, half at each SNR
        llr = make_legacy_pac.case_llrs(N, K, crc_len, crc_poly, PAC_GEN, mask, snrs, seed)
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
    parts = sys.argv[1:] or ["decode", "legacy"]
    if "legacy" in parts:
        make_legacy()
    if "decode" in parts or "scl" in parts:
        make_scl()
    if "decode" in parts or "pac" in parts:
        make_pac()
