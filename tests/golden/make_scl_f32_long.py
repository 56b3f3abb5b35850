"""Write the JAX package's list decodes at code lengths past 8192 as golden files.

    python tests/golden/make_scl_f32_long.py [scl] [pac]

Runs on the CPU with the JAX package; with no argument it does both parts.
Writes `scl_f32_long.npz` beside this script:

* `scl` cases: the outputs of the XLA decoder
  `polar_code_tpu.ops.scl.decode_scl_batch` in float32 (`best_path_bits`,
  `best_path_info_llrs`, `crc_pass`, and the final metrics of all M paths)
  on float32 LLRs of real CRC-24A codewords through BPSK + AWGN, made as
  `make_scl_f32.py` makes them (`code_inputs`): P(16384,8192)
  `gaussian_bitrev`, 8 frames at 1.25 dB, at M ∈ {1, 8, 32}, CRC on;
* `pac` cases: the outputs of the XLA decoder
  `polar_code_tpu.legacy.pac.pac_list_decode_batch` (`extracted`,
  `crc_pass`, `metrics`, `v_full`, `candidates`) on LLRs made as
  `make_legacy_pac.py` makes them (`case_llrs`), gen 1011011, `dega`:
  PAC(16384,8192)+CRC-16 at L=8, 8 frames, half at 1.25 and half at 1.5 dB.

`cases` holds each case's parameters as JSON.  The file keeps the LLRs, so
the card needs no JAX to use it: `chip_smoke.py`'s `long_codes` phase holds
the CUDA kernels and the plain versions there to it, K1 up to near-ties.
`tests/test_torch_long_codes.py` holds the port's plain decoders to it on
the CPU (marked `slow`: minutes a case).

CPU time of the committed file: 26 min on 8 cores, sharing them with
other work (`scl` M=1 129 s, M=8 248 s, M=32 322 s; `pac` 143 s; the rest
the inputs and the rate profile).  1,992,312 bytes.  N=65536 is left out:
its phase loop is four times N=16384's, so one shape would take past the
15 minutes this file allows.
"""

import json
import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(HERE))

OUT = HERE / "scl_f32_long.npz"
# code name: N, K, construction, frames, Eb/N0 points (equal shares), seed
SCL_CODES = {"n16384": (16384, 8192, "gaussian_bitrev", 8, (1.25,), 16384)}
SCL_CASES = [("n16384", M) for M in (1, 8, 32)]
PAC_GEN = [1, 0, 1, 1, 0, 1, 1]
PAC_CRC = (16, 0x1021)
# name, N, K (payload), L, frames, (Eb/N0 points), seed; CRC-16 0x1021, `dega`
PAC_CASES = [("pac16384_L8", 16384, 8192, 8, 8, (1.25, 1.5), 16385)]


def make_scl(arrays, cases):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from make_scl_f32 import CRC, code_inputs

    from polar_code_tpu.ops.scl import decode_scl_batch

    inputs = {}
    for name, (N, K, method, frames, snrs, seed) in SCL_CODES.items():
        info, llr, _, _ = code_inputs(N, K, method, frames, snrs, seed)
        inputs[name] = (info, llr)
        arrays[f"{name}/info"] = np.asarray(info, np.int32)
        arrays[f"{name}/llr"] = llr
    for code, M in SCL_CASES:
        info, llr = inputs[code]
        tag = f"{code}_M{M}"
        t = time.perf_counter()
        res = decode_scl_batch(jnp.asarray(llr), info, M, CRC, dtype=jnp.float32)
        arrays[f"{tag}/bits"] = np.asarray(res.best_path_bits, np.int8)
        arrays[f"{tag}/llrs"] = np.asarray(res.best_path_info_llrs, np.float32)
        arrays[f"{tag}/crc_pass"] = np.asarray(res.crc_pass, bool)
        arrays[f"{tag}/metrics"] = np.asarray(res.metrics, np.float32)
        cases.append({"kind": "scl", "name": tag, "code": code, "N": SCL_CODES[code][0],
                      "K": SCL_CODES[code][1], "M": M, "crc": CRC})
        print(f"{tag}: {time.perf_counter() - t:.1f} s, crc pass {int(np.sum(res.crc_pass))}/"
              f"{llr.shape[0]}", flush=True)


def make_pac(arrays, cases):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import make_legacy_pac
    import numpy as np

    from polar_code_tpu.legacy.pac import pac_list_decode_batch
    from polar_code_tpu.legacy.rate_profile import rateprofile

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
        cases.append({"kind": "pac", "name": name, "N": N, "K": K, "crc_len": crc_len,
                      "crc_poly": crc_poly, "gen": PAC_GEN, "L": L, "profile": "dega",
                      "snr_db": list(snrs)})
        print(f"{name}: {time.perf_counter() - t:.1f} s, crc pass "
              f"{int(arrays[f'{name}/crc_pass'].sum())}/{frames}", flush=True)


if __name__ == "__main__":
    import numpy as np

    parts = sys.argv[1:] or ["scl", "pac"]
    arrays, cases = {}, []
    if OUT.exists():  # keep the other part's cases
        with np.load(OUT) as old:
            kept = [c for c in json.loads(str(old["cases"])) if c["kind"] not in parts]
            keys = {c.get("code", c["name"]) for c in kept} | {c["name"] for c in kept}
            arrays = {k: old[k] for k in old.files if k != "cases" and k.split("/")[0] in keys}
            cases = kept
    if "scl" in parts:
        make_scl(arrays, cases)
    if "pac" in parts:
        make_pac(arrays, cases)
    arrays["cases"] = np.asarray(json.dumps(cases))
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")
