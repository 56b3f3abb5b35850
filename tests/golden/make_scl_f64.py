"""Write the JAX package's float64 SCL and PAC decodes as a golden file for the port.

    python tests/golden/make_scl_f64.py

Runs on the CPU with the JAX package under x64 and writes
`scl_f64_decode.npz` beside this script: float64 LLRs of real codewords
through BPSK + AWGN, drawn with numpy, and the outputs of the XLA decoders
in float64 on them:

* `polar_code_tpu.ops.scl.decode_scl_batch` at P(128,64) (`gaussian`, 8
  frames, half at 1.5 dB and half at 3.0 dB), CRC-24A and no CRC, M ∈ {1,
  2, 3, 4, 8, 16, 32}, with and without a forced plan (DL-SCL-shaped, as
  `make_scl_f32.py` draws it): the best path's bits, info LLRs and CRC flag,
  and the final list's candidates, metrics and selected rank; the list's
  info LLRs too in the cases without a plan at M <= 8 (the file stays under
  1 MB);
* the same best-path fields and metrics at P(2048,1024) M=8 (4 frames) and
  P(8192,4096) M=4 (2 frames), `gaussian_bitrev`, CRC-24A, 1.5 dB;
* `polar_code_tpu.legacy.pac.pac_list_decode_batch` at PAC(128,64)+CRC-16
  (the legacy simulator's generator, `dega` profile, 16 frames, half at 1.5
  dB and half at 2.5 dB), L ∈ {1, 4, 8, 32}: every list field.

The LLRs are float64 from the start, and two frames of each code are scaled
by 1e-3 and 1e3: a decoder that casts them to float32 anywhere moves an
info LLR by about 1e-8 relative, far past the 1e-12 the port is held to.
`cases` holds each case's parameters as JSON.  `tests/test_torch_float64.py`
holds the port's plain decoders to this file on the CPU, and `chip_smoke.py`
phase 20 the CUDA kernels on the card.  The P(8192,4096) decode, one XLA
compile of an 8192-phase graph, is most of the run.
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
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from polar_code_tpu.legacy.crclib import crc  # noqa: E402
from polar_code_tpu.legacy.pac import pac_encode_batch, pac_list_decode_batch  # noqa: E402
from polar_code_tpu.legacy.rate_profile import rateprofile  # noqa: E402
from polar_code_tpu.ops.crc import attach_crc  # noqa: E402
from polar_code_tpu.ops.polar_transform import encode_batch  # noqa: E402
from polar_code_tpu.ops.scl import decode_scl_batch  # noqa: E402
from polar_code_tpu.polar.construct import construct_info_set  # noqa: E402

CRC = "0x1864CFB"  # CRC-24A
OUT = HERE / "scl_f64_decode.npz"
SCALES = (1e3, 1e-3)  # frames 0 and 1 of every code: a spread of magnitudes
# code name: N, K, construction, frames, Eb/N0 points (equal shares), seed
CODES = {
    "p128": (128, 64, "gaussian", 8, (1.5, 3.0), 6401),
    "n2048": (2048, 1024, "gaussian_bitrev", 4, (1.5,), 6402),
    "n8192": (8192, 4096, "gaussian_bitrev", 2, (1.5,), 6403),
}
SCL_MS = (1, 2, 3, 4, 8, 16, 32)
FULL_LLRS_MAX_M = 8  # the list's info LLRs are kept without a plan up to this M
CASES = ([("p128", M, use_crc, plan) for M in SCL_MS for use_crc in (True, False) for plan in (False, True)]
         + [("n2048", 8, True, False), ("n8192", 4, True, False)])
# PAC(128,64)+CRC-16: N, payload K, CRC (len, poly), generator, profile, frames, Eb/N0, seed
PAC = (128, 64, (16, 0x1021), [1, 0, 1, 1, 0, 1, 1], "dega", 16, (1.5, 2.5), 6404)
PAC_LS = (1, 4, 8, 32)
PAC_FIELDS = ("extracted", "crc_pass", "metrics", "valid", "candidates", "v_full")


def spread(llr):
    """Frames 0 and 1 scaled by `SCALES`."""

    llr[0] *= SCALES[0]
    llr[1] *= SCALES[1]
    return llr


def code_inputs(N, K, method, frames, snrs, seed):
    """(info set, float64 LLRs [frames, N], plan int8 [frames, K])."""

    rng = np.random.default_rng(seed)
    info = construct_info_set(N, K, method=method)
    payload = rng.integers(0, 2, size=(frames, K - 24)).astype(np.int8)
    msgs = np.stack([np.asarray(attach_crc(p, CRC)) for p in payload]).astype(np.int8)
    x = np.asarray(encode_batch(jnp.asarray(msgs), info, N)).astype(np.float64)
    snr = np.repeat(np.asarray(snrs, np.float64), frames // len(snrs))[:, None]
    nv = 1.0 / (2.0 * (K / N) * 10 ** (snr / 10.0))
    y = (1.0 - 2.0 * x) + rng.normal(0.0, 1.0, size=x.shape) * np.sqrt(nv)
    llr = spread(2.0 * y / nv)
    idx = rng.integers(0, K, frames)
    pos = np.arange(K)[None, :]
    plan = np.where(pos < idx[:, None], msgs, -1)
    last = np.where(np.arange(frames)[:, None] % 2 == 0, 1 - msgs, msgs)
    plan = np.where(pos == idx[:, None], last, plan).astype(np.int8)
    return info, llr, plan


def pac_inputs(pac=PAC):
    """(mask, float64 LLRs [frames, N]) of CRC'd PAC codewords of `pac`
    (`PAC`'s fields)."""

    N, K, (crc_len, crc_poly), gen, profile, frames, snrs, seed = pac
    rp = rateprofile(N, K + crc_len, 2.0, 0)
    rp.build_mask(profile)
    mask = np.asarray(rp.modify_profile(), np.int8)
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, size=(frames, K)).astype(np.int8)
    c = crc(crc_len, crc_poly)
    msgs = np.concatenate([msgs, np.stack([c.crcCalc(m) for m in msgs]).astype(np.int8)], axis=1)
    x = np.asarray(pac_encode_batch(jnp.asarray(msgs), mask, gen, N)).astype(np.float64)
    snr = np.repeat(np.asarray(snrs, np.float64), frames // len(snrs))[:, None]
    nv = 1.0 / (2.0 * (K / N) * 10 ** (snr / 10.0))
    y = (1.0 - 2.0 * x) + rng.normal(0.0, 1.0, size=x.shape) * np.sqrt(nv)
    return mask, spread(2.0 * y / nv)


def main():
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
        full = code == "p128"
        if full:
            arrays[f"{tag}/candidates"] = np.asarray(res.candidates, np.int8)
            arrays[f"{tag}/best_index"] = np.asarray(res.best_index, np.int32)
        list_llrs = full and not use_plan and M <= FULL_LLRS_MAX_M
        if list_llrs:
            arrays[f"{tag}/info_llrs"] = np.asarray(res.info_llrs, np.float64)
        seconds = time.perf_counter() - t
        cases.append({"name": tag, "code": code, "N": CODES[code][0], "K": CODES[code][1], "M": M,
                      "crc": CRC if use_crc else None, "plan": use_plan, "full": full,
                      "info_llrs": list_llrs})
        print(f"{tag}: {seconds:.1f} s, crc pass {int(np.sum(res.crc_pass))}/{llr.shape[0]}", flush=True)
    N, K, (crc_len, crc_poly), gen, profile, frames, snrs, _ = PAC
    mask, llr = pac_inputs()
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
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
