"""Write the JAX package's float64 SCL and PAC decodes at cluster list sizes as a golden file for the port.

    python tests/golden/make_scl_f64_cluster.py

Runs on the CPU with the JAX package under x64 and writes
`scl_f64_cluster.npz` beside this script: float64 LLRs of real codewords
through BPSK + AWGN, drawn with numpy, and the outputs of the XLA decoders
in float64 on them, at the list sizes the port decodes one path a thread
of a thread-block cluster (1025..16384):

* `polar_code_tpu.ops.scl.decode_scl_batch` at P(128,64) (`gaussian`, 4
  frames, half at 1.5 dB and half at 3.0 dB), CRC-24A: M 1025 and 2048
  with and without a forced plan (DL-SCL-shaped, as `make_scl_f64.py`
  draws it), and M 4096, 8193 and 16384 without: the best path's bits,
  info LLRs and CRC flag and the final list's metrics at every M, and the
  list's candidates and selected rank up to M=2048;
* `polar_code_tpu.legacy.pac.pac_list_decode_batch` at PAC(128,64)+CRC-16
  (the legacy simulator's generator, `dega` profile, 4 frames, half at 1.5
  dB and half at 2.5 dB): every list field at L=2048, and the extracted
  bits, CRC flags and metrics at L=16384.

The LLRs are float64 from the start, and two frames of each code are scaled
by 1e3 and 1e-3: a decoder that casts them to float32 anywhere moves an
info LLR by about 1e-8 relative, far past the 1e-12 the port is held to.
`cases` holds each case's parameters as JSON.
`tests/test_torch_float64_cluster.py` holds the port's plain decoders to
this file on the CPU, and `chip_smoke.py` phase 22 the CUDA kernels on the
card.  The run takes about 95 s on the CPU (93.5 s on 8 cores), most of it
XLA compiling and running one decoder a list size (21.5 s at M=16384); the
file is 1,726,694 bytes.
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

OUT = HERE / "scl_f64_cluster.npz"
# P(128,64): N, K, construction, frames, Eb/N0 points (equal shares), seed
CODE = (128, 64, "gaussian", 4, (1.5, 3.0), 6421)
FULL_MAX_M = 2048  # the list's candidates and selected rank are kept up to this M
CASES = [(M, plan) for M in (1025, 2048) for plan in (False, True)] + [(M, False) for M in (4096, 8193, 16384)]
# PAC(128,64)+CRC-16: N, payload K, CRC (len, poly), generator, profile, frames, Eb/N0, seed
PAC = (128, 64, (16, 0x1021), [1, 0, 1, 1, 0, 1, 1], "dega", 4, (1.5, 2.5), 6424)
PAC_LS = (2048, 16384)
PAC_BEST_FIELDS = ("extracted", "crc_pass", "metrics")  # past L=2048


def main():
    t0 = time.perf_counter()
    arrays, cases = {}, []
    N, K, method, frames, snrs, seed = CODE
    info, llr, plan = code_inputs(N, K, method, frames, snrs, seed)
    arrays["p128/info"] = np.asarray(info, np.int32)
    arrays["p128/llr"] = llr
    arrays["p128/plan"] = plan
    for M, use_plan in CASES:
        tag = f"p128_M{M}_plan{int(use_plan)}"
        t = time.perf_counter()
        res = decode_scl_batch(jnp.asarray(llr), info, M, CRC,
                               force_info_bits=jnp.asarray(plan) if use_plan else None, dtype=jnp.float64)
        arrays[f"{tag}/bits"] = np.asarray(res.best_path_bits, np.int8)
        arrays[f"{tag}/llrs"] = np.asarray(res.best_path_info_llrs, np.float64)
        arrays[f"{tag}/crc_pass"] = np.asarray(res.crc_pass, bool)
        arrays[f"{tag}/metrics"] = np.asarray(res.metrics, np.float64)
        full = M <= FULL_MAX_M
        if full:
            arrays[f"{tag}/candidates"] = np.asarray(res.candidates, np.int8)
            arrays[f"{tag}/best_index"] = np.asarray(res.best_index, np.int32)
        cases.append({"name": tag, "code": "p128", "N": N, "K": K, "M": M, "crc": CRC, "plan": use_plan,
                      "full": full})
        print(f"{tag}: {time.perf_counter() - t:.1f} s, crc pass {int(np.sum(res.crc_pass))}/{frames}", flush=True)
    N, K, (crc_len, crc_poly), gen, profile, frames, snrs, seed = PAC
    mask, llr = pac_inputs(PAC)
    arrays["pac128/llr"] = llr
    arrays["pac128/mask"] = mask
    for L in PAC_LS:
        tag = f"pac128_L{L}"
        t = time.perf_counter()
        out = pac_list_decode_batch(jnp.asarray(llr), mask, gen, L, crc_len=crc_len, crc_poly=crc_poly,
                                    dtype=jnp.float64)
        fields = PAC_FIELDS if L <= FULL_MAX_M else PAC_BEST_FIELDS
        for f in fields:
            arrays[f"{tag}/{f}"] = np.asarray(out[f])
        cases.append({"name": tag, "code": "pac128", "N": N, "K": K, "crc_len": crc_len, "crc_poly": crc_poly,
                      "gen": gen, "L": L, "profile": profile, "fields": list(fields)})
        print(f"{tag}: {time.perf_counter() - t:.1f} s, crc pass {int(np.sum(out['crc_pass']))}/{frames}",
              flush=True)
    arrays["cases"] = np.asarray(json.dumps(cases))
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes) in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
