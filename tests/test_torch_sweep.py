"""The port's FER sweep CLI on the CPU: CSV schema, resume, device rules.

The CSV header must equal the one the JAX CLI writes (the committed
`results/fer_M*.csv` were written by it, with --include_uncoded); `--state`
must skip a finished point; without `--device cpu` and with no card the CLI
must raise rather than carry on on the CPU.  Sweep FER is compared with the
JAX sweep statistically by `chip_smoke.py` on the card.
"""

import json

import pytest
import torch

from polar_code_tpu_torch.eval import run_fer_sweep

ARGS = ["--M", "2", "--frames", "256", "--batch", "128", "--snr_lo", "4.0",
        "--snr_hi", "5.0", "--snr_step", "1.0", "--beta", "checkpoints/beta_M2.npy"]


def _run(tmp_path, *extra):
    return run_fer_sweep.main(ARGS + ["--device", "cpu", "--out_dir", str(tmp_path / "out"),
                                      "--plot_dir", str(tmp_path / "plots"), *extra])


@pytest.mark.parametrize("uncoded", [True, False])
def test_csv_header_equals_jax_cli(tmp_path, uncoded):
    rows = _run(tmp_path, *(["--include_uncoded"] if uncoded else []))
    header = (tmp_path / "out" / "fer_M2.csv").read_text().splitlines()[0]
    jax_header = open("results/fer_M2.csv").read().splitlines()[0]
    if not uncoded:
        jax_header = jax_header.replace(",fer_uncoded,ber_uncoded", "")
    assert header == jax_header
    assert [r["snr_db"] for r in rows] == [4.0, 5.0]
    lines = (tmp_path / "out" / "fer_M2.csv").read_text().splitlines()
    assert len(lines) == 3 and lines[1].startswith("4.000,")
    for r in rows:
        assert 0.0 <= r["fer_dl"] <= r["fer_scl"] <= 1.0  # DL-SCL keeps SCL's passes


def test_state_resume_skips_finished_points(tmp_path, capsys):
    state = tmp_path / "state.json"
    first = _run(tmp_path, "--state", str(state))
    saved = json.loads(state.read_text())
    assert set(saved["rows"]) == {"4.0000", "5.0000"}
    assert saved["config"]["M"] == 2 and saved["config"]["batch"] == 128
    capsys.readouterr()
    second = _run(tmp_path, "--state", str(state))
    out = capsys.readouterr().out
    assert out.count("resumed from state") == 2
    assert second == first
    # a different sweep starts over
    _run(tmp_path, "--state", str(state), "--seed", "1")
    assert "resumed" not in capsys.readouterr().out


@pytest.mark.parametrize("change", [("--N", "256"), ("--K", "72"),
                                    ("--construction", "polarization")])
def test_state_of_another_code_starts_over(tmp_path, capsys, change):
    # N, K and the construction change the code, so a state file written for
    # another code must not feed its rows into this sweep
    argv = ["--M", "2", "--frames", "128", "--batch", "128", "--snr_lo", "4.0",
            "--snr_hi", "4.0", "--device", "cpu", "--out_dir", str(tmp_path / "out"),
            "--plot_dir", str(tmp_path / "plots"), "--state", str(tmp_path / "state.json")]
    run_fer_sweep.main(argv)
    saved = json.loads((tmp_path / "state.json").read_text())
    saved["rows"]["4.0000"]["fer_scl"] = -1.0
    (tmp_path / "state.json").write_text(json.dumps(saved))
    capsys.readouterr()
    rows = run_fer_sweep.main(argv + list(change))
    assert "resumed" not in capsys.readouterr().out
    assert rows[0]["fer_scl"] >= 0.0
    config = json.loads((tmp_path / "state.json").read_text())["config"]
    assert str(config[change[0][2:]]) == change[1]


def test_sweep_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fer_sweep.main(ARGS + ["--out_dir", str(tmp_path), "--plot_dir", str(tmp_path)])
