"""The port's multi-process sweeps (`polar_code_tpu_torch/parallel/`) on the CPU.

Twin of `tests/test_multihost.py`: two ranks joined by a gloo process group
(torchrun's environment variables on a free localhost port) run the FER and
BER sweep CLIs at `--device cpu`, with the frames of each chunk split over
the ranks and with `--snr_split`.  Every CSV must be byte-identical to the
one-process run at the same `--batch`, and only rank 0 prints and writes.
The one process pair runs all four sweeps (this file is also its worker
program); the cluster-marker tests are the JAX file's twins.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from polar_code_tpu_torch.eval import run_ber_sweep, run_fer_sweep
from polar_code_tpu_torch.parallel import mesh

REPO = Path(__file__).resolve().parent.parent

# P(64,32) M=2 with 2 retries: two chunks of 256 frames at each of 2 points
FER_ARGS = ["--N", "64", "--K", "32", "--M", "2", "--retries", "2", "--frames", "512",
            "--batch", "256", "--snr_lo", "1.0", "--snr_hi", "2.0", "--snr_step", "1.0"]
# the toy polar_scl code of tests/test_ber_eval.py: err_cap decides the first
# point after one chunk, bits_cap the other two after two
BER_ARGS = ["--scheme", "polar_scl", "--K_payload", "4", "--K_crc", "4", "--E", "16",
            "--crc_poly", "0x17", "--M", "2", "--EbN0_lo", "1.0", "--EbN0_hi", "3.0",
            "--EbN0_step", "1.0", "--bits_cap", "512", "--err_cap", "60", "--batch", "64"]
MODES = {"frames": [], "split": ["--snr_split"]}


def _run_all(out: Path, modes) -> None:
    """The FER and BER sweeps in each mode, written under `out`."""

    for mode in modes:
        run_fer_sweep.main(FER_ARGS + MODES[mode] + [
            "--device", "cpu", "--out_dir", str(out / f"fer_{mode}"),
            "--plot_dir", str(out / f"plot_{mode}")])
        run_ber_sweep.main(BER_ARGS + MODES[mode] + [
            "--device", "cpu", "--out", str(out / f"ber_{mode}.csv")])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# what a rank prints when its rendezvous port was taken meanwhile
PORT_LOST = ("Address already in use", "EADDRINUSE", "failed to listen")


def _launch(rank: int, port: int, out: Path, log: Path) -> subprocess.Popen:
    env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    with log.open("w") as f:
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--out", str(out / f"rank{rank}")],
            env=env, cwd=str(REPO), stdout=f, stderr=subprocess.STDOUT,
        )


def _wait(procs, timeout_s: float) -> None:
    """Wait for every rank; once one fails or time runs out, end the rest
    (a rank left alone would wait for its peer until the group's timeout)."""

    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(one-process outputs, rank outputs dir, [rank 0 stdout, rank 1 stdout])."""

    tmp = tmp_path_factory.mktemp("parallel")
    single = tmp / "single"
    # the port bound and closed may be taken before rank 0 binds it: only
    # then launch the pair again, on a fresh port
    for attempt in range(3):
        logs = [tmp / f"rank{rank}_{attempt}.log" for rank in (0, 1)]
        port = _free_port()
        procs = [_launch(rank, port, tmp, log) for rank, log in zip((0, 1), logs)]
        try:
            # the one-process sweeps run here meanwhile
            if not single.exists():
                _run_all(single, ["frames"])
        finally:
            _wait(procs, timeout_s=240)
        outs = [log.read_text() for log in logs]
        if not any(m in out for out in outs for m in PORT_LOST):
            break
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return single, tmp, outs


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("csv", ["fer_{mode}/fer_M2.csv", "ber_{mode}.csv"])
def test_two_ranks_write_the_one_process_csv(two_ranks, mode, csv):
    single, tmp, _ = two_ranks
    expected = (single / csv.format(mode="frames")).read_bytes()
    assert (tmp / "rank0" / csv.format(mode=mode)).read_bytes() == expected
    assert not (tmp / "rank1" / csv.format(mode=mode)).exists()  # only rank 0 writes


def test_only_rank_zero_prints(two_ranks):
    _, _, (out0, out1) = two_ranks
    assert out0.count("Saved FER table") == 2 and "on 2 device(s)" in out0
    assert "SNR=" not in out1 and "Saved" not in out1 and "Simulated" not in out1


def test_ber_points_stop_on_both_caps():
    rows = run_ber_sweep.main(BER_ARGS + ["--device", "cpu", "--out", os.devnull])
    assert rows[0]["bit_errors"] >= 60 and rows[0]["bits_total"] < 512  # err_cap
    assert all(r["bits_total"] == 512 for r in rows[1:])  # bits_cap


@pytest.mark.parametrize("cli", ["fer", "ber"])
def test_state_with_snr_split_raises(tmp_path, monkeypatch, cli):
    # a second rank in name only: the split is decided before any collective
    monkeypatch.setattr(run_fer_sweep, "maybe_distributed_init", lambda: True)
    monkeypatch.setattr(run_ber_sweep, "maybe_distributed_init", lambda: True)
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="--state resume is not supported with --snr_split"):
        if cli == "fer":
            run_fer_sweep.main(FER_ARGS + ["--snr_split", "--state", str(tmp_path / "s.json"),
                                           "--device", "cpu", "--out_dir", str(tmp_path)])
        else:
            run_ber_sweep.main(BER_ARGS + ["--snr_split", "--state", str(tmp_path / "s.json"),
                                           "--device", "cpu", "--out", str(tmp_path / "b.csv")])


def _marker_run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)


def test_cluster_marker_fallback_is_graceful():
    """Multi-process markers without a rendezvous warn and stay single-process."""

    p = _marker_run(
        "import os, warnings\n"
        "os.environ['SLURM_JOB_ID'] = '1234'\n"
        "os.environ['SLURM_NTASKS'] = '2'\n"
        "from polar_code_tpu_torch.parallel.mesh import maybe_distributed_init, process_count\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    multi = maybe_distributed_init()\n"
        "assert multi is False, multi\n"
        "assert process_count() == 1\n"
        "assert any('auto-detection failed' in str(x.message) for x in w), "
        "[str(x.message) for x in w]\n"
        "print('fallback ok')\n"
    )
    assert p.returncode == 0, p.stdout + p.stderr
    assert "fallback ok" in p.stdout


def test_single_process_markers_stay_silent():
    """Markers that ordinary single-process environments carry do not warn."""

    p = _marker_run(
        "import os, warnings\n"
        "os.environ['KUBERNETES_SERVICE_HOST'] = '10.0.0.1'\n"
        "os.environ['SLURM_JOB_ID'] = '1234'\n"
        "os.environ['SLURM_NTASKS'] = '1'\n"
        "os.environ['TPU_WORKER_HOSTNAMES'] = 'host0'\n"
        "from polar_code_tpu_torch.parallel.mesh import maybe_distributed_init\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    multi = maybe_distributed_init()\n"
        "assert multi is False, multi\n"
        "ours = [x for x in w if 'auto-detection' in str(x.message)]\n"
        "assert not ours, [str(x.message) for x in ours]\n"
        "print('silent ok')\n"
    )
    assert p.returncode == 0, p.stdout + p.stderr
    assert "silent ok" in p.stdout


def test_one_process_helpers():
    assert not mesh.maybe_distributed_init()
    assert mesh.is_coordinator() and mesh.process_count() == 1
    assert mesh.split_points(5) == [0, 1, 2, 3, 4]
    table = np.array([[1.5, -0.0], [np.pi, 1e-300]])
    out = mesh.allgather_table_exact(table)
    assert out.dtype == np.float64 and out.tobytes() == table.tobytes()
    assert mesh.allreduce_counters({"a": 3, "w": 2.0}) == {"a": 3, "w": 2.0}
    mesh.sync_processes("noop")
    rows = {0: {"x": 1.5, "n": 7}, 1: {"x": -2.0, "n": 3}}
    assert mesh.merge_point_rows(rows, 2, ["x", "n"], int_fields=("n",)) == [
        {"x": 1.5, "n": 7}, {"x": -2.0, "n": 3}]


@pytest.mark.parametrize("world,rank,snr_split,batch,expected", [
    (1, 0, True, 100, (False, 100, (0, 1))),  # one process: nothing to split
    (2, 1, False, 101, (False, 100, (1, 2))),  # frames: a multiple of the ranks
    (4, 3, False, 2, (False, 4, (3, 4))),  # at least one frame a rank
    (2, 1, True, 101, (True, 101, (0, 1))),  # points: the whole chunk a rank
])
def test_sweep_split(monkeypatch, world, rank, snr_split, batch, expected):
    monkeypatch.setattr(mesh, "process_count", lambda: world)
    monkeypatch.setattr(mesh, "process_index", lambda: rank)
    split = mesh.sweep_split(snr_split, batch)
    assert tuple(split) == expected and split.devices == expected[2][1]
    owned = []
    for r in range(world):
        monkeypatch.setattr(mesh, "process_index", lambda r=r: r)
        owned += list(split.points(5))
    # each point is simulated by one rank (--snr_split) or by all of them
    assert sorted(owned) == sorted(list(range(5)) * (1 if split.snr_split else world))


def test_shard_frames_splits_rows():
    import torch

    x = torch.arange(24).reshape(6, 4)
    parts = [mesh.shard_frames(x, r, 3) for r in range(3)]
    assert torch.equal(torch.cat(parts), x) and parts[1].tolist() == x[2:4].tolist()
    assert mesh.shard_frames(x, 0, 1) is x
    assert torch.equal(mesh.shard_frames(x, 1, 2, axis=1), x[:, 2:])
    with pytest.raises(ValueError, match="multiple"):
        mesh.shard_frames(x, 0, 4)


if __name__ == "__main__":
    # one rank of the process pair: the four sweeps, the outputs under --out
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True)
    _run_all(Path(parser.parse_args().out), list(MODES))
