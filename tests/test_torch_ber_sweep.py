"""The port's unified BER sweep on the CPU: CLI schema, caps, resume, device
rules, and the `nr_ldpc` step held stage by stage against the JAX package.

* For each committed `results/ber_*.csv` (written by the JAX CLI), the port's
  CLI run with the same configuration at a toy size writes the same header
  and the same leading columns (scheme … params) — `params` strings included.
* The caps stop the sweep as the JAX controller does; `--state` resumes;
  without `--device cpu` and with no card the CLI raises.
* The `nr_ldpc` step's stages on shared payloads and noise: codewords, the
  derated LLRs and the decoder's decisions equal the JAX stages'.  (The JAX
  CLI is not run here; sweep rates are compared on the card by
  `chip_smoke.py`.)
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.eval import run_ber_sweep as jax_cli
from polar_code_tpu.nr.ldpc import decode_nms as jax_nms
from polar_code_tpu.nr.ldpc import encode as jax_encode
from polar_code_tpu.nr.ldpc import rate_match as jax_rm
from polar_code_tpu.ops import crc as jax_crc
from polar_code_tpu_torch.eval import run_ber_sweep
from polar_code_tpu_torch.nr.ldpc import build_h_matrix, derate_match_ldpc, encode_ldpc_batch
from polar_code_tpu_torch.nr.ldpc import rate_match_ldpc
from polar_code_tpu_torch.nr.ldpc.nms_cuda import decode_ldpc_nms_cuda
from polar_code_tpu_torch.ops.crc import attach_crc_batch

# the committed JAX sweeps and the flags that wrote them (README)
COMMITTED = {
    "ber_nr_ldpc_ira4x8.csv": ["--scheme", "nr_ldpc", "--bg", "ira4x8", "--Z", "31", "--nms_exact",
                               "--K_payload", "100", "--K_crc", "24", "--E", "248"],
    "ber_nr_ldpc_Z32_E384.csv": ["--scheme", "nr_ldpc", "--K_payload", "72", "--K_crc", "24",
                                 "--E", "384", "--Z", "32"],
    "ber_nr_polar_K88_E256_M4.csv": ["--scheme", "nr_polar_scl", "--K_payload", "64",
                                     "--K_crc", "24", "--E", "256", "--N", "128", "--M", "4"],
    "ber_polar_scl_M8.csv": ["--scheme", "polar_scl", "--K_payload", "40", "--K_crc", "24",
                             "--E", "128", "--N", "128", "--M", "8"],
}
TOY = ["--K_payload", "4", "--K_crc", "4", "--E", "16", "--N", "16", "--crc_poly", "0x17",
       "--M", "2", "--EbN0_lo", "2.0", "--EbN0_hi", "3.0", "--EbN0_step", "1.0", "--batch", "16"]


def _main(tmp_path, argv, device="cpu"):
    out = tmp_path / "ber.csv"
    rows = run_ber_sweep.main(argv + ["--device", device, "--out", str(out)])
    return rows, out.read_text().splitlines()


@pytest.mark.parametrize("csv_name", sorted(COMMITTED))
def test_header_and_params_equal_committed_csv(tmp_path, csv_name):
    committed = open(f"results/{csv_name}").read().splitlines()
    ebno = committed[1].split(",")[-6]
    rows, lines = _main(tmp_path, COMMITTED[csv_name] + [
        "--EbN0_lo", ebno, "--EbN0_hi", ebno, "--bits_cap", "1", "--batch", "8"])
    assert lines[0] == committed[0] == ",".join(run_ber_sweep.CSV_HEADER)
    # everything before EbN0_dB: scheme, code, N_or_E, K_payload, K_crc, rate, params
    assert lines[1].split(",")[:-6] == committed[1].split(",")[:-6]
    assert len(rows) == 1 and rows[0]["EbN0_dB"] == float(ebno)
    assert rows[0]["bits_total"] == 8 * rows[0]["K_payload"]  # one chunk reaches a 1-bit cap


def test_dl_scl_and_adaptive_params(tmp_path):
    beta = tmp_path / "beta.npy"
    np.save(beta, np.eye(8, dtype=np.float32))
    rows, _ = _main(tmp_path, ["--scheme", "dl_scl", "--retries", "3", "--beta", str(beta),
                               "--bits_cap", "256", *TOY])
    assert [r["params"] for r in rows] == ["M=2,retries=3"] * 2
    assert all(0.0 <= r["avg_work"] <= 3.0 for r in rows)
    rows, _ = _main(tmp_path, ["--scheme", "polar_scl", "--adaptive_from", "1",
                               "--bits_cap", "256", *TOY])
    assert [r["params"] for r in rows] == ["M=2,adaptive_from=1"] * 2
    assert 0.0 < rows[0]["avg_work"] < 1.0  # the re-decoded fraction at 2 dB


def test_caps_stop_the_sweep(tmp_path):
    # bits_cap decides: 640 bits at 64 a chunk is 10 chunks exactly
    rows, lines = _main(tmp_path, ["--scheme", "polar_scl", "--bits_cap", "640",
                                   "--err_cap", "100000", *TOY])
    assert len(lines) == 3
    assert [r["bits_total"] for r in rows] == [640, 640]
    # err_cap decides: at 2 dB the first chunk has errors, so one chunk a point
    rows, _ = _main(tmp_path, ["--scheme", "polar_scl", "--bits_cap", "640", "--err_cap", "1",
                               *TOY])
    assert rows[0]["bits_total"] == 64 and rows[0]["bit_errors"] >= 1
    for r in rows:
        assert r["bits_total"] % 64 == 0 and 0.0 <= r["fer"] <= 1.0
        assert r["ber"] == r["bit_errors"] / r["bits_total"]


def test_state_resume(tmp_path):
    state = tmp_path / "state.json"
    argv = ["--scheme", "nr_ldpc", "--K_payload", "8", "--K_crc", "4", "--E", "24",
            "--crc_poly", "0x17", "--bg", "2", "--Z", "4", "--max_iter", "10",
            "--EbN0_lo", "2.0", "--EbN0_hi", "3.0", "--EbN0_step", "1.0",
            "--bits_cap", "640", "--batch", "16", "--state", str(state)]
    first, _ = _main(tmp_path, argv)
    saved = json.loads(state.read_text())
    assert set(saved["rows"]) == {"2.0000", "3.0000"}
    assert saved["config"]["scheme"] == "nr_ldpc" and saved["config"]["Z"] == 4
    assert all(0.0 <= r["avg_work"] <= 10.0 for r in first)
    # a resumed point comes from the state file, not from a new simulation
    saved["rows"]["3.0000"]["bit_errors"] = -1
    state.write_text(json.dumps(saved))
    second, _ = _main(tmp_path, argv)
    assert second[0] == first[0] and second[1]["bit_errors"] == -1
    # a different sweep starts over
    third, _ = _main(tmp_path, argv[:-2] + ["--seed", "1", "--state", str(state)])
    assert json.loads(state.read_text())["config"]["seed"] == 1 and len(third) == 2


@pytest.mark.parametrize("change", [("--construction", "polarization"), ("--crc_poly", "0x13"),
                                    ("--adaptive_from", "1"), ("--ilv_mode", "nr")])
def test_state_of_another_code_starts_over(tmp_path, change):
    # each of these fields changes what a point measures, so a state file
    # written without it must not feed its rows into this sweep
    state = tmp_path / "state.json"
    argv = ["--scheme", "polar_scl", *TOY[:12], "--EbN0_lo", "2.0", "--EbN0_hi", "2.0",
            "--batch", "16", "--bits_cap", "64", "--state", str(state)]
    _main(tmp_path, argv)
    saved = json.loads(state.read_text())
    saved["rows"]["2.0000"]["bit_errors"] = -1
    state.write_text(json.dumps(saved))
    assert _main(tmp_path, argv)[0][0]["bit_errors"] == -1  # the same sweep resumes
    rows, _ = _main(tmp_path, argv + list(change))
    assert rows[0]["bit_errors"] >= 0
    assert str(json.loads(state.read_text())["config"][change[0][2:]]) == change[1]


def test_bad_arguments_raise(tmp_path):
    with pytest.raises(ValueError, match="mismatch"):
        _main(tmp_path, ["--scheme", "nr_ldpc", "--K_payload", "9", "--K_crc", "4", "--E", "24",
                         "--Z", "4", "--EbN0_lo", "2.0", "--EbN0_hi", "2.0"])
    with pytest.raises(ValueError, match="beta"):
        run_ber_sweep.parse_args(["--scheme", "dl_scl", "--K_payload", "4", "--K_crc", "4",
                                  "--E", "16", "--EbN0_lo", "2.0", "--EbN0_hi", "2.0",
                                  "--out", "x.csv"])
    with pytest.raises(ValueError, match="adaptive_from"):
        _main(tmp_path, ["--scheme", "polar_scl", "--adaptive_from", "2", *TOY])


def test_sweep_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ber_sweep.main(["--scheme", "polar_scl", *TOY, "--out", str(tmp_path / "x.csv")])


def test_noise_and_base_graph_match_jax_cli(tmp_path):
    for ebno, kp, e in [(2.5, 100, 248), (4.0, 64, 256), (1.0, 72, 384)]:
        assert run_ber_sweep._noise_var(ebno, kp, e) == jax_cli._noise_var(ebno, kp, e)
    table = tmp_path / "bg.csv"
    table.write_text("row,col,shift\n0,0,3\n0,1,5\n1,1,2\n1,2,0\n")
    for argv in (["--bg", "ira4x8", "--Z", "31"], ["--bg", "1", "--Z", "8"],
                 ["--bg_file", str(table), "--Z", "7"]):
        full = ["--scheme", "nr_ldpc", "--K_payload", "1", "--K_crc", "0", "--E", "8",
                "--EbN0_lo", "1", "--EbN0_hi", "1", "--out", "x.csv", *argv]
        ours = run_ber_sweep._resolve_base_graph(run_ber_sweep.parse_args(full))
        theirs = jax_cli._resolve_base_graph(jax_cli.parse_args(full))
        assert (ours.name, ours.m, ours.n) == (theirs.name, theirs.m, theirs.n)
        np.testing.assert_array_equal(ours.shifts, theirs.shifts)


def test_nr_ldpc_step_stages_equal_jax():
    """ira4x8 Z=31, two-min, 2.5 dB: payload → CRC → encode → rate match,
    then derate → decode → payload bit errors, on shared numpy draws."""

    args = run_ber_sweep.parse_args(COMMITTED["ber_nr_ldpc_ira4x8.csv"] + [
        "--EbN0_lo", "2.5", "--EbN0_hi", "2.5", "--out", "x.csv"])
    bg = run_ber_sweep._resolve_base_graph(args)
    H = build_h_matrix(bg, args.Z)
    rng = np.random.default_rng(25)
    B, crc = 64, args.crc_poly
    payload = rng.integers(0, 2, (B, args.K_payload)).astype(np.int8)
    cw = rate_match_ldpc(encode_ldpc_batch(attach_crc_batch(torch.from_numpy(payload), crc), H),
                         args.E).numpy()
    jax_cw = jax_rm.rate_match_ldpc(
        jax_encode.encode_ldpc_batch(jax_crc.attach_crc_batch(jnp.asarray(payload), crc), H), args.E)
    np.testing.assert_array_equal(cw, np.asarray(jax_cw))

    nv = run_ber_sweep._noise_var(2.5, args.K_payload, args.E)
    y = (1.0 - 2.0 * cw + np.sqrt(nv) * rng.normal(0, 1, cw.shape)).astype(np.float32)
    llr = (2.0 / np.float32(nv)) * y
    internal = derate_match_ldpc(torch.from_numpy(llr), H.shape[1]).contiguous()
    ours = decode_ldpc_nms_cuda(internal, bg, args.Z, args.max_iter, args.alpha, self_exclude=True)
    theirs = jax_nms.decode_ldpc_nms_batch(
        jax_rm.derate_match_ldpc(jnp.asarray(llr), H.shape[1]), H, max_iter=args.max_iter,
        alpha=args.alpha, self_exclude=True, dtype=jnp.float32)
    for key in ("hard", "iters_used", "parity_ok"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    errs = (ours["hard"][:, : args.K_payload].numpy() != payload).sum(axis=1)
    assert 0 < (errs > 0).sum() < B, "2.5 dB should mix decoded and failed frames"
