"""Write the JAX package's list decode at list size 65536 as a golden file.

    python tests/golden/make_scl_f32_64k.py

Runs on the CPU with the JAX package and writes `scl_f32_64k.npz` beside
this script: the outputs of the XLA decoder
`polar_code_tpu.ops.scl.decode_scl_batch` in float32 (`best_path_bits`,
`best_path_info_llrs`, `crc_pass`, and the final metrics of all M paths) on
float32 LLRs of real CRC-24A codewords through BPSK + AWGN, made as
`make_scl_f32.py` makes them (`code_inputs`): P(128,64) `gaussian`, 8
frames, half at 1.5 dB and half at 3.0 dB, at M=65536, CRC on, no plan.

`cases` holds the case's parameters as JSON.  The file keeps the LLRs, so
the card needs no JAX to use it: `chip_smoke.py`'s `list_sizes_64k` phase
holds K1's quad instantiation at M=65536 (four paths a thread on a cluster
of 16 blocks) to it, up to near-ties.

CPU time of the committed file: 53 s, 46.5 s of it the decode.  592,344
bytes.
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

OUT = HERE / "scl_f32_64k.npz"
# code name: N, K, construction, frames, Eb/N0 points (equal shares), seed
SCL_CODES = {"p128": (128, 64, "gaussian", 8, (1.5, 3.0), 65536)}
SCL_CASES = [("p128", 65536)]


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from make_scl_f32 import CRC, code_inputs

    from polar_code_tpu.ops.scl import decode_scl_batch

    arrays, cases, inputs = {}, [], {}
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
        cases.append({"name": tag, "code": code, "N": SCL_CODES[code][0], "K": SCL_CODES[code][1],
                      "M": M, "crc": CRC})
        print(f"{tag}: {time.perf_counter() - t:.1f} s, crc pass {int(np.sum(res.crc_pass))}/"
              f"{llr.shape[0]}", flush=True)
    arrays["cases"] = np.asarray(json.dumps(cases))
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
