"""Write the JAX package's float64 SCL and PAC decodes at deep list sizes as a golden file for the port.

    python tests/golden/make_scl_f64_deep.py

Runs on the CPU with the JAX package under x64 and writes
`scl_f64_deep.npz` beside this script: float64 LLRs of real codewords
through BPSK + AWGN, drawn with numpy, and the outputs of the XLA decoders
in float64 on them, at the list sizes the port decodes over the warps of a
block (33..1024):

* `polar_code_tpu.ops.scl.decode_scl_batch` at P(128,64) (`gaussian`, 4
  frames, half at 1.5 dB and half at 3.0 dB), CRC-24A, M ∈ {33, 64, 128,
  129, 256, 1024} (128 and 129: the last byte trace entry and the first
  16-bit one), with and without a forced plan (DL-SCL-shaped, as
  `make_scl_f64.py` draws it): the best path's bits, info LLRs and CRC flag
  and the final list's metrics at every M; the list's candidates and
  selected rank up to M=256, and its info LLRs without a plan up to M=64
  (the file stays under 1.5 MB);
* CRC off at M=64 (every list field);
* P(1024,512) M=64 (`gaussian_bitrev`, CRC-24A, 2 frames at 1.5 dB): the
  best-path fields and the metrics;
* `polar_code_tpu.legacy.pac.pac_list_decode_batch` at PAC(128,64)+CRC-16
  (the legacy simulator's generator, `dega` profile, 4 frames, half at 1.5
  dB and half at 2.5 dB), L ∈ {33, 64, 256, 1024}: every list field.

The LLRs are float64 from the start, and two frames of each code are scaled
by 1e-3 and 1e3: a decoder that casts them to float32 anywhere moves an
info LLR by about 1e-8 relative, far past the 1e-12 the port is held to.
`cases` holds each case's parameters as JSON.
`tests/test_torch_float64_deep.py` holds the port's plain decoders to this
file on the CPU, and `chip_smoke.py` phase 21 the CUDA kernels on the card.
The run takes about two minutes on the CPU (115 s on 8 cores), most of it
XLA compiling one decoder a list size; the file is 550,943 bytes.
"""

import json
import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))
sys.path.insert(0, str(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from make_scl_f64 import CRC, PAC_FIELDS, code_inputs, pac_inputs  # noqa: E402
from polar_code_tpu.legacy.pac import pac_list_decode_batch  # noqa: E402
from polar_code_tpu.ops.scl import decode_scl_batch  # noqa: E402

OUT = HERE / "scl_f64_deep.npz"
# code name: N, K, construction, frames, Eb/N0 points (equal shares), seed
CODES = {
    "p128": (128, 64, "gaussian", 4, (1.5, 3.0), 6411),
    "n1024": (1024, 512, "gaussian_bitrev", 2, (1.5,), 6412),
}
SCL_MS = (33, 64, 128, 129, 256, 1024)
FULL_MAX_M = 256  # the list's candidates and selected rank are kept up to this M
LIST_LLRS_MAX_M = 64  # the list's info LLRs are kept without a plan up to this M
CASES = ([("p128", M, True, plan) for M in SCL_MS for plan in (False, True)]
         + [("p128", 64, False, False), ("n1024", 64, True, False)])
# PAC(128,64)+CRC-16: N, payload K, CRC (len, poly), generator, profile, frames, Eb/N0, seed
PAC = (128, 64, (16, 0x1021), [1, 0, 1, 1, 0, 1, 1], "dega", 4, (1.5, 2.5), 6414)
PAC_LS = (33, 64, 256, 1024)


def main():
    t0 = time.perf_counter()
    arrays, cases = {}, []
    inputs = {}
    for name, (N, K, method, frames, snrs, seed) in CODES.items():
        info, llr, plan = code_inputs(N, K, method, frames, snrs, seed)
        inputs[name] = (info, llr, plan)
        arrays[f"{name}/info"] = np.asarray(info, np.int32)
        arrays[f"{name}/llr"] = llr
        if name == "p128":
            arrays[f"{name}/plan"] = plan
    for code, M, use_crc, use_plan in CASES:
        info, llr, plan = inputs[code]
        tag = f"{code}_M{M}_crc{int(use_crc)}_plan{int(use_plan)}"
        t = time.perf_counter()
        res = decode_scl_batch(
            jnp.asarray(llr), info, M, CRC if use_crc else None,
            force_info_bits=jnp.asarray(plan) if use_plan else None, dtype=jnp.float64,
        )
        arrays[f"{tag}/bits"] = np.asarray(res.best_path_bits, np.int8)
        arrays[f"{tag}/llrs"] = np.asarray(res.best_path_info_llrs, np.float64)
        arrays[f"{tag}/crc_pass"] = np.asarray(res.crc_pass, bool)
        arrays[f"{tag}/metrics"] = np.asarray(res.metrics, np.float64)
        full = code == "p128" and M <= FULL_MAX_M
        if full:
            arrays[f"{tag}/candidates"] = np.asarray(res.candidates, np.int8)
            arrays[f"{tag}/best_index"] = np.asarray(res.best_index, np.int32)
        list_llrs = full and not use_plan and M <= LIST_LLRS_MAX_M
        if list_llrs:
            arrays[f"{tag}/info_llrs"] = np.asarray(res.info_llrs, np.float64)
        seconds = time.perf_counter() - t
        cases.append({"name": tag, "code": code, "N": CODES[code][0], "K": CODES[code][1], "M": M,
                      "crc": CRC if use_crc else None, "plan": use_plan, "full": full,
                      "info_llrs": list_llrs})
        print(f"{tag}: {seconds:.1f} s, crc pass {int(np.sum(res.crc_pass))}/{llr.shape[0]}", flush=True)
    N, K, (crc_len, crc_poly), gen, profile, frames, snrs, seed = PAC
    mask, llr = pac_inputs(PAC)
    arrays["pac128/llr"] = llr
    arrays["pac128/mask"] = mask
    for L in PAC_LS:
        tag = f"pac128_L{L}"
        t = time.perf_counter()
        out = pac_list_decode_batch(jnp.asarray(llr), mask, gen, L, crc_len=crc_len, crc_poly=crc_poly,
                                    dtype=jnp.float64)
        for f in PAC_FIELDS:
            arrays[f"{tag}/{f}"] = np.asarray(out[f])
        cases.append({"name": tag, "code": "pac128", "N": N, "K": K, "crc_len": crc_len,
                      "crc_poly": crc_poly, "gen": gen, "L": L, "profile": profile})
        print(f"{tag}: {time.perf_counter() - t:.1f} s, crc pass {int(np.sum(out['crc_pass']))}/{frames}",
              flush=True)
    arrays["cases"] = np.asarray(json.dumps(cases))
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes) in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
