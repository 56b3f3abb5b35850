"""Write the JAX package's legacy PAC outputs as golden files for the port.

    python tests/golden/make_legacy_pac.py

Runs on the CPU with the JAX package and writes, beside this script:

* `legacy_pac_decode.npz`: for each decode case, float32 LLRs of real PAC
  codewords through BPSK + AWGN (half the frames at each of two SNRs) and
  the outputs of the XLA decoder `polar_code_tpu.legacy.pac.
  pac_list_decode_batch` on them (`extracted`, `crc_pass`, `metrics`), with
  the code's rate-profile mask; `cases` holds each case's parameters as JSON;
* `legacy_pac_drivers.json`: the result lists of the three legacy drivers
  (`simulator.run`, `crc_polar_vs_uncoded.simulate`, `crc_polar_ofdm_ls.
  simulate`) at their default configurations, seed 0, at a few SNR points,
  with the seconds each run took.  The drivers that draw noise from numpy's
  global generator get `np.random.seed(0)` first.

The PAC metric has no transcendentals, so the port reproduces these outputs
exactly; `tests/test_torch_pac.py` holds its plain decoder to them on the CPU
and `chip_smoke.py` holds the CUDA kernel and the drivers to them on the card.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from polar_code_tpu.legacy import crc_polar_ofdm_ls, crc_polar_vs_uncoded, simulator  # noqa: E402
from polar_code_tpu.legacy.crclib import crc  # noqa: E402
from polar_code_tpu.legacy.pac import pac_encode_batch, pac_list_decode_batch  # noqa: E402
from polar_code_tpu.legacy.rate_profile import rateprofile  # noqa: E402

FRAMES = 256
GEN_SIM = [1, 0, 1, 1, 0, 1, 1]
# name, N, K (payload), crc_len, crc_poly, gen, L, profile, (snr_lo, snr_hi) in dB
DECODE_CASES = [
    ("fixture_L1", 32, 12, 8, 0xA6, [1, 0, 1, 1], 1, "dega", (2.0, 4.0)),
    ("fixture_L4", 32, 12, 8, 0xA6, [1, 0, 1, 1], 4, "dega", (2.0, 4.0)),
    ("fixture_polar_L2", 32, 12, 0, 0, [1], 2, "dega", (2.0, 4.0)),
    ("pac128_crc16_L8", 128, 64, 16, 0x1021, GEN_SIM, 8, "dega", (1.5, 2.5)),
    ("pac256_crc16_pw_L4", 256, 128, 16, 0x1021, GEN_SIM, 4, "pw", (1.5, 2.5)),
    ("sim64_L1", 64, 32, 0, 0, GEN_SIM, 1, "dega", (2.5, 3.5)),
    ("sim64_L32", 64, 32, 0, 0, GEN_SIM, 32, "dega", (2.5, 3.5)),
    ("polar128_crc16_L16", 128, 64, 16, 0x1021, [1], 16, "dega", (1.0, 2.0)),
]
SIM_SNR = [3.0, 3.5]
UNCODED_SNR = (1.0, 2.0)
OFDM_SNR = (4.0,)


def case_llrs(N, K, crc_len, crc_poly, gen, mask, snrs, seed):
    """Float32 LLRs of CRC'd PAC codewords through BPSK + AWGN, half the
    frames at each SNR (Eb/N0 over the payload rate K/N)."""

    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, size=(FRAMES, K)).astype(np.int8)
    if crc_len:
        c = crc(crc_len, crc_poly)
        msgs = np.concatenate([msgs, np.stack([c.crcCalc(m) for m in msgs]).astype(np.int8)], axis=1)
    x = np.asarray(pac_encode_batch(jnp.asarray(msgs), mask, gen, N)).astype(np.float64)
    snr = np.repeat(np.asarray(snrs, np.float64), FRAMES // 2)[:, None]
    nv = 1.0 / (2.0 * (K / N) * 10 ** (snr / 10.0))
    y = (1.0 - 2.0 * x) + rng.normal(0.0, 1.0, size=x.shape) * np.sqrt(nv)
    return (2.0 * y / nv).astype(np.float32)


def decode_golden():
    arrays, meta = {}, []
    for i, (name, N, K, crc_len, crc_poly, gen, L, profile, snrs) in enumerate(DECODE_CASES):
        rp = rateprofile(N, K + crc_len, 2.0, 0)
        rp.build_mask(profile)
        mask = np.asarray(rp.modify_profile(), np.int8)
        llr = case_llrs(N, K, crc_len, crc_poly, gen, mask, snrs, seed=1000 + i)
        t = time.perf_counter()
        out = pac_list_decode_batch(jnp.asarray(llr), mask, gen, L, crc_len=crc_len,
                                    crc_poly=crc_poly, dtype=jnp.float32)
        arrays[f"{name}/llr"] = llr
        arrays[f"{name}/mask"] = mask
        arrays[f"{name}/extracted"] = np.asarray(out["extracted"], np.int8)
        arrays[f"{name}/crc_pass"] = np.asarray(out["crc_pass"], bool)
        arrays[f"{name}/metrics"] = np.asarray(out["metrics"], np.float32)
        meta.append({"name": name, "N": N, "K": K, "crc_len": crc_len, "crc_poly": crc_poly,
                     "gen": gen, "L": L, "profile": profile, "design_snr_db": 2.0,
                     "max_row_swaps": 0, "snr_db": list(snrs)})
        print(f"{name}: {time.perf_counter() - t:.1f} s, crc pass "
              f"{int(arrays[f'{name}/crc_pass'].sum())}/{FRAMES}", flush=True)
    arrays["cases"] = np.asarray(json.dumps(meta))
    np.savez_compressed(HERE / "legacy_pac_decode.npz", **arrays)


def driver_golden():
    runs = {}

    t = time.perf_counter()
    np.random.seed(0)
    cfg = simulator.LegacySimConfig(snr_range=SIM_SNR, seed=0)
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
        res = simulator.run(cfg, out_dir=tmp)
        csv_text = next(Path(tmp).glob("*.csv")).read_text()
    runs["simulator"] = {
        "config": {"snr_range": SIM_SNR, "seed": 0},
        "snr_range": res.snr_range, "ber": res.ber, "fer": res.fer,
        "fname": res.fname, "csv": csv_text,
        "lines": [ln for ln in buf.getvalue().splitlines() if ln.startswith("@")],
        "seconds": time.perf_counter() - t,
    }
    print(f"simulator: {runs['simulator']['seconds']:.1f} s", flush=True)

    t = time.perf_counter()
    np.random.seed(0)
    res = crc_polar_vs_uncoded.simulate(crc_polar_vs_uncoded.SimulationConfig(
        snr_points=UNCODED_SNR, seed=0, plot_results=False))
    runs["crc_polar_vs_uncoded"] = {
        "config": {"snr_points": list(UNCODED_SNR), "seed": 0},
        "results": [dataclasses.asdict(r) for r in res],
        "table": crc_polar_vs_uncoded._format_results(res),
        "seconds": time.perf_counter() - t,
    }
    print(f"crc_polar_vs_uncoded: {runs['crc_polar_vs_uncoded']['seconds']:.1f} s", flush=True)

    t = time.perf_counter()
    res = crc_polar_ofdm_ls.simulate(crc_polar_ofdm_ls.SimulationConfig(
        snr_points=OFDM_SNR, seed=0, plot_results=False))
    runs["crc_polar_ofdm_ls"] = {
        "config": {"snr_points": list(OFDM_SNR), "seed": 0},
        "results": [dataclasses.asdict(r) for r in res],
        "seconds": time.perf_counter() - t,
    }
    print(f"crc_polar_ofdm_ls: {runs['crc_polar_ofdm_ls']['seconds']:.1f} s", flush=True)

    runs["versions"] = {"jax": jax.__version__, "numpy": np.__version__}
    (HERE / "legacy_pac_drivers.json").write_text(json.dumps(runs, indent=1) + "\n")


if __name__ == "__main__":
    which = sys.argv[1:] or ["decode", "drivers"]
    if "decode" in which:
        decode_golden()
    if "drivers" in which:
        driver_golden()
