"""Write the JAX package's float32 SCL decodes as a golden file for the port.

    python tests/golden/make_scl_f32.py

Runs on the CPU with the JAX package and writes `scl_f32_decode.npz` beside
this script: float32 LLRs of real CRC-24A codewords through BPSK + AWGN, and
the outputs of the XLA decoder `polar_code_tpu.ops.scl.decode_scl_batch` in
float32 on them (`best_path_bits`, `best_path_info_llrs`, `crc_pass`, and
the final metrics, which the near-tie rule reads):

* P(128,64), the `gaussian` construction, 256 frames, half at 1.5 dB and
  half at 3.0 dB, at M ∈ {1, 2, 4, 8}, CRC on and off, with and without a
  forced plan (DL-SCL-shaped: a prefix of sent bits, then one flipped bit on
  even frames and one more sent bit on odd frames, the rest free);
* P(2048,1024), `gaussian_bitrev`, 64 frames at 1.5 dB, M=8, CRC on.

Eb/N0 is over the rate K/N.  `cases` holds each case's parameters as JSON.
`tests/test_torch_scl_f32.py` holds the port's plain float32 decoder to it
on the CPU and `chip_smoke.py` holds the CUDA kernel to it on the card, both
up to near-ties: the two frameworks' exp and log1p may differ in the last
ulp, which can reorder two paths whose metrics nearly tie.
"""

import json
import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from polar_code_tpu.ops.crc import attach_crc  # noqa: E402
from polar_code_tpu.ops.polar_transform import encode_batch  # noqa: E402
from polar_code_tpu.ops.scl import decode_scl_batch  # noqa: E402
from polar_code_tpu.polar.construct import construct_info_set  # noqa: E402

CRC = "0x1864CFB"  # CRC-24A
OUT = HERE / "scl_f32_decode.npz"
# code name: N, K, construction, frames, Eb/N0 points (equal shares), seed
CODES = {
    "p128": (128, 64, "gaussian", 256, (1.5, 3.0), 128),
    "n2048": (2048, 1024, "gaussian_bitrev", 64, (1.5,), 2048),
}
CASES = [("p128", M, crc, plan) for M in (1, 2, 4, 8) for crc in (True, False)
         for plan in (False, True)] + [("n2048", 8, True, False)]


def code_inputs(N, K, method, frames, snrs, seed):
    """(info set, float32 LLRs [frames, N], sent bits [frames, K], plan)."""

    rng = np.random.default_rng(seed)
    info = construct_info_set(N, K, method=method)
    payload = rng.integers(0, 2, size=(frames, K - 24)).astype(np.int8)
    msgs = np.stack([np.asarray(attach_crc(p, CRC)) for p in payload]).astype(np.int8)
    x = np.asarray(encode_batch(jnp.asarray(msgs), info, N)).astype(np.float64)
    snr = np.repeat(np.asarray(snrs, np.float64), frames // len(snrs))[:, None]
    nv = 1.0 / (2.0 * (K / N) * 10 ** (snr / 10.0))
    y = (1.0 - 2.0 * x) + rng.normal(0.0, 1.0, size=x.shape) * np.sqrt(nv)
    llr = (2.0 * y / nv).astype(np.float32)
    idx = rng.integers(0, K, frames)
    pos = np.arange(K)[None, :]
    plan = np.where(pos < idx[:, None], msgs, -1)
    last = np.where(np.arange(frames)[:, None] % 2 == 0, 1 - msgs, msgs)
    plan = np.where(pos == idx[:, None], last, plan).astype(np.int8)
    return info, llr, msgs, plan


def main():
    arrays, cases = {}, []
    inputs = {}
    for name, (N, K, method, frames, snrs, seed) in CODES.items():
        info, llr, msgs, plan = code_inputs(N, K, method, frames, snrs, seed)
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
        seconds = time.perf_counter() - t
        cases.append({"name": tag, "code": code, "N": CODES[code][0], "K": CODES[code][1],
                      "M": M, "crc": CRC if use_crc else None, "plan": use_plan})
        print(f"{tag}: {seconds:.1f} s, crc pass {int(np.sum(res.crc_pass))}/{llr.shape[0]}",
              flush=True)
    arrays["cases"] = np.asarray(json.dumps(cases))
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
