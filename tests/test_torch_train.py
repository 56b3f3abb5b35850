"""The port's DL-SCL training workloads against the JAX package's.

* `make_oracle_chunk` against JAX `_make_oracle_chunk` on shared float32
  LLRs (both packages' `awgn_llr` replaced in this process): `fail`,
  `n_labeled`, `lab_idx` and `label` identical and `abs_l0` within 1e-6
  relative, except on frames where a decode of the oracle (the baseline or
  one of its attempts) has two ordered final metrics within 1e-5 relative
  (a near-tie, as `test_torch_scl_f32.py` defines it); the compacted search
  equal to the masked one; the `--out_cap` overflow check.
* Shards: the schema, `meta` key order and stdout lines of a JAX-written
  shard; a port shard trains in the JAX trainer and a JAX shard in the
  port's.
* `rmsprop_step` against `optax.rmsprop(lr, decay=0.99, eps=1e-8)` (which
  `torch.optim.RMSprop` does not compute); `train_beta` from a carried-across
  init against the JAX trainer live and against its golden file
  (`tests/golden/train_beta_jax.npz`): β within 1e-6 absolute, the CSV rows
  within 1e-6 relative; `clamp_diagonal` and the `off_diag` interchange.
* `opcount` byte-identical to the JAX tool and the committed CSVs.
* The dataset → β → FER sweep pipeline of `test_cli_end2end.py` on the CPU.
* The golden files pinned to the committed shards.
"""

import contextlib
import io
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import polar_code_tpu.train.make_dataset as jax_md
from polar_code_tpu import config as jax_config
from polar_code_tpu.dlscl.beta import SymmetricBeta as JaxBeta
from polar_code_tpu.eval import opcount as jax_opcount
from polar_code_tpu.train import train_beta as jax_tb
from polar_code_tpu_torch import config
from polar_code_tpu_torch.channel import noise_var_coded
from polar_code_tpu_torch.dlscl.beta import SymmetricBeta
from polar_code_tpu_torch.eval import opcount, run_fer_sweep
from polar_code_tpu_torch.interop import off_diag_from_numpy, off_diag_to_numpy
from polar_code_tpu_torch.ops.scl import decode_scl_batch
from polar_code_tpu_torch.polar.construct import construct_info_set
from polar_code_tpu_torch.train import make_dataset, train_beta

from .test_torch_scl import CRC, _near_ties

GOLDEN = Path(__file__).parent / "golden"
DATA = Path("data")


@pytest.fixture(autouse=True)
def _no_jax_cache(monkeypatch):
    monkeypatch.setenv("POLAR_CODE_TPU_NO_CACHE", "1")  # the JAX CLIs' compile cache


def _code(N, K, method):
    cfg, jcfg = config.get_config(), jax_config.get_config()
    cfg.N, cfg.K, jcfg.N, jcfg.K = N, K, N, K
    return cfg, jcfg, construct_info_set(N, K, method=method)


def _zero_codeword_llrs(B, N, K, snr_db, seed):
    nv = noise_var_coded(snr_db, K, N)
    rng = np.random.default_rng(seed)
    return ((2.0 / nv) * (1.0 + np.sqrt(nv) * rng.standard_normal((B, N)))).astype(np.float32), nv


def _per_frame(out, B):
    """(fail, labelled, label, |L0|) a frame from a chunk whose out_cap is B."""

    out = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
    idx = out["lab_idx"].astype(np.int64)
    assert sorted(idx) == list(range(B))
    labelled = np.zeros(B, bool)
    labelled[idx[: int(out["n_labeled"])]] = True
    label, abs_l0 = np.empty(B, np.int64), np.empty((B, out["abs_l0"].shape[1]), np.float32)
    label[idx], abs_l0[idx] = out["label"], out["abs_l0"]
    return out, out["fail"], labelled, label, abs_l0


def _oracle_ties(llr, info, M):
    """Frames where the baseline or one of the 8 oracle attempts decodes with
    a near-tie (the port's plain float32 decoder, with its metrics)."""

    x = torch.from_numpy(llr)
    base = decode_scl_batch(x, info, M, CRC, dtype=torch.float32)
    ties = _near_ties(base.metrics.numpy())
    bits = base.best_path_bits
    order = torch.argsort(base.best_path_info_llrs.abs(), dim=1, stable=True)[:, :8]
    pos = torch.arange(bits.shape[1])[None, :]
    for j in range(8):
        idx = order[:, j : j + 1]
        plan = torch.where(pos < idx, bits, torch.full_like(bits, -1))
        plan = torch.where(pos == idx, 1 - torch.gather(bits, 1, idx), plan)
        res = decode_scl_batch(x, info, M, CRC, force_info_bits=plan, dtype=torch.float32)
        ties |= _near_ties(res.metrics.numpy())
    return ties


# (N, K, construction, M, Eb/N0): B=256 frames, so out_cap = B covers every frame
ORACLE_CASES = [(128, 64, "gaussian", 1, 3.0), (128, 64, "gaussian", 2, 3.0),
                (128, 64, "gaussian", 8, 3.0), (64, 32, "gaussian_bitrev", 2, 1.0)]


@pytest.mark.parametrize("N,K,method,M,snr", ORACLE_CASES)
def test_oracle_chunk_equals_jax(monkeypatch, N, K, method, M, snr):
    B = 256
    cfg, jcfg, info = _code(N, K, method)
    llr, nv = _zero_codeword_llrs(B, N, K, snr, seed=N + M)
    # nv / nv keeps the LLRs a traced value (1.0 exactly), not a folded constant
    monkeypatch.setattr(jax_md, "awgn_llr", lambda key, sym, n: jnp.asarray(llr) * (n / n))
    monkeypatch.setattr(make_dataset, "awgn_llr", lambda gen, sym, n: torch.from_numpy(llr))
    ref = jax.device_get(jax_md._make_oracle_chunk(jcfg, info, M, B, 8)(jax.random.key(0), nv))
    out = make_dataset.make_oracle_chunk(cfg, info, M, B, 8, device="cpu")(None, nv)

    ref, *r = _per_frame(ref, B)
    out, *p = _per_frame(out, B)
    bad = (r[0] != p[0]) | (r[1] != p[1]) | (r[2] != p[2])
    bad |= ~np.all(np.abs(r[3] - p[3]) <= 1e-6 * np.abs(r[3]), axis=1)
    if bad.any():
        ties = np.zeros(B, bool)
        ties[bad] = _oracle_ties(llr[bad], info, M)
        assert not (bad & ~ties).any(), np.flatnonzero(bad & ~ties)
    else:  # the chunk's outputs themselves, in their order
        assert int(out["n_labeled"]) == int(ref["n_labeled"])
        for k in ("fail", "lab_idx", "label"):
            np.testing.assert_array_equal(out[k], ref[k])
        np.testing.assert_allclose(out["abs_l0"], ref["abs_l0"], rtol=1e-6, atol=0)
    assert 0 < int(r[1].sum()) < int(r[0].sum())  # labels, and failures it cannot repair


@pytest.mark.parametrize("capacity", [16, 256])
def test_oracle_compact_equals_masked(capacity):
    """Everything the shard writer reads is the same with the search
    compacted to the failures (in slabs smaller than their count, or one)."""

    B = 128
    cfg, _, info = _code(128, 64, "gaussian")
    nv = noise_var_coded(3.0, 64, 128)
    masked = make_dataset.make_oracle_chunk(cfg, info, 2, B, 8, device="cpu")(
        torch.Generator().manual_seed(3), nv)
    compact = make_dataset.make_oracle_chunk(cfg, info, 2, B, 8, compact=capacity, device="cpu")(
        torch.Generator().manual_seed(3), nv)
    n = int(masked["n_labeled"])
    assert capacity < int(masked["fail"].sum()) or capacity == 256
    assert 0 < n and int(compact["n_labeled"]) == n
    torch.testing.assert_close(compact["fail"], masked["fail"], rtol=0, atol=0)
    for k in ("lab_idx", "label", "abs_l0"):  # labelled frames first, in frame order
        torch.testing.assert_close(compact[k][:n], masked[k][:n], rtol=0, atol=0)


def test_out_cap_overflow_raises(tmp_path):
    with pytest.raises(RuntimeError, match="capacity overflow"):
        make_dataset.main([
            "--M", "1", "--snr_db", "1.0", "--frames", "64", "--batch", "64",
            "--out_cap", "1", "--out", str(tmp_path / "d"), "--device", "cpu",
        ])


# ---- shards: schema, meta and interchange ----

SHARD_FLAGS = ["--M", "2", "--N", "64", "--K", "32", "--construction", "gaussian_bitrev",
               "--snr_db", "1.0", "--frames", "192", "--seed", "0", "--batch", "64"]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The same flags through both packages' `make_dataset.main`: the shard
    paths and the stdout of each."""

    tmp = tmp_path_factory.mktemp("shards")
    paths, logs = {}, {}
    for name, main, extra in (("jax", jax_md.main, []), ("port", make_dataset.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
            mp.setenv("POLAR_CODE_TPU_NO_CACHE", "1")
            main(SHARD_FLAGS + ["--out", str(tmp / name / "d")] + extra)
        paths[name], logs[name] = tmp / name / "d_part0.npz", buf.getvalue()
    return paths, logs


def test_shard_schema_and_meta_equal_jax(shards):
    paths, logs = shards
    with np.load(paths["jax"]) as j, np.load(paths["port"]) as p:
        assert j.files == p.files == ["abs_l0", "flip_idx", "meta"]
        for k in ("abs_l0", "flip_idx"):
            assert p[k].dtype == j[k].dtype and p[k].ndim == j[k].ndim
        assert p["abs_l0"].shape == (p["flip_idx"].size, 32) and p["flip_idx"].size > 0
        assert p["meta"].dtype == j["meta"].dtype
        mj, mp = json.loads(str(j["meta"])), json.loads(str(p["meta"]))
    assert list(mp) == list(mj)  # the same keys in the same order
    assert {k: mp[k] for k in mp if k not in ("samples", "failures")} == \
        {k: mj[k] for k in mj if k not in ("samples", "failures")}
    assert mp["samples"] == int(np.load(paths["port"])["flip_idx"].size)
    for name, path in paths.items():  # the same stdout lines
        lines = logs[name].rstrip().splitlines()
        assert re.fullmatch(r"  192/192 frames, \d+ labels, \d+ unrepaired, [\d,]+ frames/s", lines[-2])
        assert lines[-1] == f"Saved {json.loads(str(np.load(path)['meta']))['samples']} samples to {path}"


@pytest.mark.parametrize("writer,trainer", [("port", "jax"), ("jax", "port")])
def test_shard_trains_in_the_other_package(shards, tmp_path, writer, trainer):
    paths, _ = shards
    argv = ["--M", "2", "--data", str(paths[writer]), "--epochs", "1",
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "logs")]
    (jax_tb.main if trainer == "jax" else train_beta.main)(argv + (["--cpu"] if trainer == "port" else []))
    beta = np.load(tmp_path / "ckpt" / "beta_M2.npy")
    assert beta.shape == (32, 32)  # float64 from the JAX trainer here: this process enables x64
    np.testing.assert_array_equal(beta, beta.T)
    np.testing.assert_array_equal(np.diag(beta), np.ones(32))
    lines = (tmp_path / "logs" / "train_M2.csv").read_text().splitlines()
    assert lines[0] == "epoch,train_loss,train_acc,val_loss,val_acc" and len(lines) == 2


# ---- β training ----

def _grads(step):
    mag = np.logspace(-6, 0, 61)
    sign = np.where(np.arange(61) % 3 == step % 3, -1.0, 1.0)
    return (sign * mag * (1.0 + 0.1 * step)).astype(np.float32)


def _optax_updates(lr, steps):
    tx = optax.rmsprop(lr, decay=0.99, eps=1e-8)
    p = jnp.zeros(61, jnp.float32)
    state, updates = tx.init(p), []
    for s in range(steps):
        upd, state = tx.update(jnp.asarray(_grads(s)), state, p)
        updates.append(np.asarray(upd))
    return updates


def test_rmsprop_step_equals_optax():
    """Each step's update, from gradients of 1e-6 to 1 in both signs; the
    parameter restarts at 0 so that it holds the update itself."""

    lr, ref = 1e-3, _optax_updates(1e-3, 4)
    p = torch.zeros(61, requires_grad=True)
    nu = torch.zeros(61)
    for s in range(4):
        with torch.no_grad():
            p.zero_()
        p.grad = torch.from_numpy(_grads(s))
        train_beta.rmsprop_step(p, nu, lr)
        np.testing.assert_allclose(p.detach().numpy(), ref[s], rtol=1e-6, atol=0)


def test_torch_rmsprop_is_not_the_optax_rule():
    """`torch.optim.RMSprop` (ε outside the root) misses optax's updates by
    orders of magnitude on small gradients, which is why the port writes
    the rule out."""

    ref = _optax_updates(1e-3, 1)[0]
    p = torch.zeros(61, requires_grad=True)
    opt = torch.optim.RMSprop([p], lr=1e-3, alpha=0.99, eps=1e-8)
    p.grad = torch.from_numpy(_grads(0))
    opt.step()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-6, atol=0)
    assert abs(p[0].item() / ref[0]) > 50  # g = 1e-6: 9.1e-3 against 1.0e-5


def _csv_rows(text):
    lines = text.strip().splitlines()
    assert lines[0] == "epoch,train_loss,train_acc,val_loss,val_acc"
    return np.array([[float(v) for v in line.split(",")] for line in lines[1:]])


@pytest.fixture(scope="module")
def golden_beta():
    with np.load(GOLDEN / "train_beta_jax.npz") as f:
        return {k: f[k] for k in f.files}


def test_golden_train_beta_file_holds_the_committed_run(golden_beta):
    with np.load(DATA / "train_M8_snr5_seed0_part0.npz") as f:
        np.testing.assert_array_equal(golden_beta["x"], f["abs_l0"])
        np.testing.assert_array_equal(golden_beta["y"], f["flip_idx"])
        assert str(golden_beta["shard_meta"]) == str(f["meta"])
    with jax.enable_x64(False):  # the trainer's own float32 draw
        init = JaxBeta.clamp_diagonal(JaxBeta(64).init(jax.random.key(0)))["off_diag"]
    np.testing.assert_array_equal(golden_beta["init_off_diag"], np.asarray(init))
    np.testing.assert_array_equal(_csv_rows(str(golden_beta["csv"])), golden_beta["rows"])
    assert json.loads(str(golden_beta["args"]))["epochs"] == len(golden_beta["rows"]) == 2


@pytest.mark.parametrize("reference", ["jax_trainer", "golden_file"])
def test_train_beta_equals_jax(tmp_path, golden_beta, reference):
    """From the JAX trainer's own initial parameters, carried across whole:
    the JAX trainer run here on the committed shard (float64, as this test
    process enables x64) or its float32 run in the golden file."""

    a = json.loads(str(golden_beta["args"]))
    flags = ["--M", "8", "--epochs", str(a["epochs"]), "--lr", str(a["lr"]),
             "--batch", str(a["batch"]), "--lambda_l2", str(a["lambda_l2"]),
             "--seed", str(a["seed"]), "--val_frac", str(a["val_frac"])]
    if reference == "jax_trainer":
        shard = DATA / "train_M8_snr5_seed0_part0.npz"
        init = JaxBeta.clamp_diagonal(JaxBeta(64).init(jax.random.key(a["seed"])))
        jax_tb.main(flags + ["--data", str(shard), "--checkpoint_dir", str(tmp_path / "jc"),
                             "--log_dir", str(tmp_path / "jl")])
        ref_rows = _csv_rows((tmp_path / "jl" / "train_M8.csv").read_text())
        ref_beta = np.load(tmp_path / "jc" / "beta_M8.npy")
    else:
        shard = tmp_path / "golden_part0.npz"
        np.savez(shard, abs_l0=golden_beta["x"], flip_idx=golden_beta["y"],
                 meta=str(golden_beta["shard_meta"]))
        init = {"off_diag": golden_beta["init_off_diag"]}
        ref_rows, ref_beta = golden_beta["rows"], golden_beta["beta"]
    args = train_beta.build_argparser().parse_args(
        flags + ["--data", str(shard), "--cpu", "--checkpoint_dir",
                 str(tmp_path / "c"), "--log_dir", str(tmp_path / "l")])
    rows = train_beta.train_beta(args, init=off_diag_from_numpy(init))

    got = _csv_rows((tmp_path / "l" / "train_M8.csv").read_text())
    np.testing.assert_allclose(got, ref_rows, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[:, [0, 2, 4]], ref_rows[:, [0, 2, 4]])  # accuracies
    assert [r["epoch"] for r in rows] == [1, 2]
    beta = np.load(tmp_path / "c" / "beta_M8.npy")
    assert beta.dtype == np.float32
    np.testing.assert_allclose(beta, ref_beta, rtol=0, atol=1e-6)


def test_train_beta_cli_init_is_seeded_and_clamped(tmp_path, golden_beta):
    """Without `init`, β starts from `make_generator(seed)`, diagonal clamped:
    the same run twice gives the same β."""

    shard = tmp_path / "s_part0.npz"
    np.savez(shard, abs_l0=golden_beta["x"][:300], flip_idx=golden_beta["y"][:300], meta="{}")
    betas = []
    for i in range(2):
        train_beta.main(["--M", "8", "--data", str(shard), "--epochs", "1", "--cpu",
                         "--checkpoint_dir", str(tmp_path / f"c{i}"), "--log_dir", str(tmp_path / f"l{i}")])
        betas.append(np.load(tmp_path / f"c{i}" / "beta_M8.npy"))
    np.testing.assert_array_equal(betas[0], betas[1])
    np.testing.assert_array_equal(np.diag(betas[0]), np.ones(64))


def test_clamp_diagonal_and_off_diag_interchange():
    rng = np.random.default_rng(0)
    off = rng.uniform(-1, 1, (16, 16)).astype(np.float32)
    module = off_diag_from_numpy({"off_diag": off})
    np.testing.assert_array_equal(off_diag_to_numpy(module)["off_diag"], off)  # lower triangle too
    assert module.clamp_diagonal() is module and module.off_diag.requires_grad
    got = off_diag_to_numpy(module)["off_diag"]
    ref = np.asarray(JaxBeta.clamp_diagonal({"off_diag": jnp.asarray(off)})["off_diag"])
    np.testing.assert_array_equal(got, ref)
    assert not np.any(np.diag(got))
    np.testing.assert_array_equal(got[~np.eye(16, dtype=bool)], off[~np.eye(16, dtype=bool)])
    np.testing.assert_array_equal(module.beta_matrix().detach().numpy(),
                                  np.asarray(JaxBeta.beta_matrix({"off_diag": jnp.asarray(got)})))
    seeded = SymmetricBeta(16, generator=torch.Generator().manual_seed(1))
    assert np.all(np.diag(seeded.off_diag.detach().numpy()) == 0)  # drawn with a zero diagonal


# ---- opcount ----

OPCOUNT = [("checkpoints/beta_M4.npy", "results/opcount_M4.csv")] + [
    (f"checkpoints/n{n}/beta_M8.npy", f"results/n{n}/opcount_M8.csv") for n in (256, 512, 1024, 2048)]


@pytest.mark.parametrize("beta,csv", OPCOUNT)
def test_opcount_equals_jax_and_committed(tmp_path, capsys, beta, csv):
    for name, tool in (("port", opcount), ("jax", jax_opcount)):
        tool.main(["--beta", beta, "--report", str(tmp_path / f"{name}.csv"),
                   "--save_pruned", str(tmp_path / f"{name}.npy")])
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == [f"Saved opcount report to {tmp_path / 'port.csv'}",
                       f"Saved pruned β to {tmp_path / 'port.npy'}"]
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes() == Path(csv).read_bytes()
    assert (tmp_path / "port.npy").read_bytes() == (tmp_path / "jax.npy").read_bytes()
    b = np.load(beta)
    assert opcount.count_ops(b) == jax_opcount.count_ops(b)
    np.testing.assert_array_equal(opcount.prune_beta(b, 0.01), jax_opcount.prune_beta(b, 0.01))


# ---- the pipeline, on the CPU ----

def test_port_pipeline_end2end(tmp_path):
    data_prefix = tmp_path / "data" / "train_M2_snr0_seed0"
    make_dataset.main([
        "--M", "2", "--snr_db", "1.0", "--frames", "192", "--seed", "0",
        "--out", str(data_prefix), "--batch", "64", "--device", "cpu",
    ])
    shard = data_prefix.parent / f"{data_prefix.name}_part0.npz"
    data = np.load(shard)
    assert data["abs_l0"].ndim == 2 and data["abs_l0"].shape[1] == 64
    assert data["abs_l0"].shape[0] == data["flip_idx"].size > 0
    assert data["abs_l0"].dtype == np.float32 and data["flip_idx"].dtype == np.int32
    meta = json.loads(str(data["meta"]))
    assert meta["M"] == 2 and meta["frames"] == 192 and meta["samples"] == data["flip_idx"].size

    train_beta.main([
        "--M", "2", "--data", str(shard), "--epochs", "1", "--cpu",
        "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "logs"),
    ])
    ckpt = tmp_path / "ckpt" / "beta_M2.npy"
    beta = np.load(ckpt)
    assert beta.shape == (64, 64)
    np.testing.assert_allclose(beta, beta.T)
    np.testing.assert_allclose(np.diag(beta), np.ones(64))
    lines = (tmp_path / "logs" / "train_M2.csv").read_text().strip().splitlines()
    assert lines[0] == "epoch,train_loss,train_acc,val_loss,val_acc" and len(lines) == 2

    run_fer_sweep.main([
        "--M", "2", "--frames", "128", "--snr_lo", "5.0", "--snr_hi", "5.0",
        "--snr_step", "0.5", "--retries", "2", "--beta", str(ckpt),
        "--out_dir", str(tmp_path / "results"), "--plot_dir", str(tmp_path / "plots"),
        "--batch", "64", "--include_uncoded", "--device", "cpu",
    ])
    lines = (tmp_path / "results" / "fer_M2.csv").read_text().strip().splitlines()
    assert lines[0] == "snr_db,fer_uncoded,ber_uncoded,fer_scl,ber_scl,fer_dl,ber_dl"
    vals = lines[1].split(",")
    assert float(vals[0]) == 5.0 and 0.0 <= float(vals[5]) <= float(vals[3]) <= 1.0


def test_port_pipeline_end2end_custom_code(tmp_path):
    data_prefix = tmp_path / "data" / "train_M2_n64"
    make_dataset.main([
        "--M", "2", "--N", "64", "--K", "32", "--construction", "gaussian_bitrev",
        "--snr_db", "1.0", "--frames", "192", "--seed", "0", "--out", str(data_prefix),
        "--batch", "64", "--device", "cpu",
    ])
    data = np.load(data_prefix.parent / f"{data_prefix.name}_part0.npz")
    assert data["abs_l0"].shape[1] == 32
    meta = json.loads(str(data["meta"]))
    assert meta["N"] == 64 and meta["K"] == 32 and meta["construction"] == "gaussian_bitrev"

    train_beta.main([
        "--M", "2", "--data", str(data_prefix.parent / f"{data_prefix.name}_part0.npz"),
        "--epochs", "1", "--cpu", "--checkpoint_dir", str(tmp_path / "ckpt"),
        "--log_dir", str(tmp_path / "logs"),
    ])
    assert np.load(tmp_path / "ckpt" / "beta_M2.npy").shape == (32, 32)

    run_fer_sweep.main([
        "--M", "2", "--N", "64", "--K", "32", "--construction", "gaussian_bitrev",
        "--frames", "128", "--snr_lo", "4.0", "--snr_hi", "4.0", "--retries", "2",
        "--beta", str(tmp_path / "ckpt" / "beta_M2.npy"), "--out_dir", str(tmp_path / "results"),
        "--plot_dir", str(tmp_path / "plots"), "--batch", "64", "--device", "cpu",
    ])
    lines = (tmp_path / "results" / "fer_M2.csv").read_text().strip().splitlines()
    assert lines[0] == "snr_db,fer_scl,ber_scl,fer_dl,ber_dl"
    vals = lines[1].split(",")
    assert 0.0 <= float(vals[3]) <= float(vals[1]) <= 1.0


def test_training_clis_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_dataset.main(["--M", "2", "--frames", "64", "--out", str(tmp_path / "d")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_beta.main(["--M", "2", "--data", str(DATA / "train_M8_snr5_seed0_part0.npz")])


def test_golden_dataset_meta_pins_the_committed_shards():
    metas = json.loads((GOLDEN / "dataset_meta.json").read_text())
    shards = sorted(DATA.glob("*.npz"))
    assert sorted(metas) == [p.name for p in shards]
    for path in shards:
        with np.load(path) as f:
            meta = json.loads(str(f["meta"]))
            assert metas[path.name] == meta and list(metas[path.name]) == list(meta)
            assert meta["samples"] == f["flip_idx"].size
    # the rates chip_smoke.py holds its shards to
    assert (metas["train_M8_snr5_seed0_part0.npz"]["samples"],
            metas["train_M8_snr5_seed0_part0.npz"]["failures"]) == (2893, 567)
    assert (metas["train_M1_snr5_seed0_part0.npz"]["samples"],
            metas["train_M1_snr5_seed0_part0.npz"]["failures"]) == (55116, 19954)
    n1024 = metas["train_M8_n1024_snr1.75_seed0_part0.npz"]
    assert (n1024["samples"], n1024["failures"], n1024["frames"]) == (39823, 58197, 20000000)


# ---- on the card (marker `gpu`; skipped without a CUDA device) ----

@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8])
def test_oracle_chunk_on_card_equals_cpu(M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the oracle's decodes run K1 only on the card")
    B = 256
    cfg, _, info = _code(128, 64, "gaussian")
    llr, nv = _zero_codeword_llrs(B, 128, 64, 3.0, seed=M)
    outs = {}
    for dev in ("cpu", "cuda"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(make_dataset, "awgn_llr", lambda gen, sym, n, dev=dev: torch.from_numpy(llr).to(dev))
            outs[dev] = _per_frame(make_dataset.make_oracle_chunk(
                cfg, info, M, B, 8, compact=B if dev == "cuda" else 0, device=dev)(None, nv), B)[1:]
    bad = np.zeros(B, bool)
    for c, g in zip(outs["cpu"][:3], outs["cuda"][:3]):
        bad |= c != g
    bad |= ~np.all(np.abs(outs["cpu"][3] - outs["cuda"][3]) <= 1e-6 * np.abs(outs["cpu"][3]), axis=1)
    bad &= outs["cpu"][0]  # labels of baseline-passing frames are not searched when compacted
    bad |= outs["cpu"][0] != outs["cuda"][0]
    if bad.any():
        assert _oracle_ties(llr[bad], info, M).all()
