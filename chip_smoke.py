#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each ends with one flushed line carrying the elapsed seconds):

1. device: name, count, torch/CUDA versions, `nvidia-smi` name and power limit;
2. build: the SCL kernel (`polar_code_tpu_torch/csrc/scl_decode.cu`) by nvcc,
   with the build seconds and the `-Xptxas -v` registers, shared memory and
   spills;
3. the kernel against its plain PyTorch version at P(128,64): M ∈ {1,2,4,8},
   CRC-24A on and off, with and without a random forced plan, B=4096 LLRs at
   3, 5 and 7 dB, plus ragged B=1000 and B=1001 batches.  Bits and CRC pass must be
   identical and info LLRs equal within 1e-6 relative; a frame whose two
   ordered final path metrics lie within 1e-5 relative (a near-tie) is
   counted and printed instead of failing;
4. the main path: the FER sweep CLI (`run_fer_sweep.main`) at M=8, 8 retries,
   β from `checkpoints/beta_M8.npy`, 102400 frames at 4.0 and 5.0 dB on the
   card.  Every SCL decode must go through the kernel (its launch counter
   grows, the plain decoder runs 0 times on CUDA), and FER of both arms must
   agree with the JAX package's `results/fer_M8.csv` at |z| < 3;
5. times with CUDA events after a warm-up: the kernel and the plain version
   per B=4096 M=8 CRC decode, and FER-step frames/s at 5 dB;
6. a `kernels` JSON line, the `nvidia-smi` line, and the device JSON line last.

It exits non-zero, and prints no result line, when there is no CUDA device,
when a phase fails, or when run without the rest of the repository.  It
writes the sweep's outputs to a temporary directory; the kernel build lands
in the git-ignored `build/`.
"""

import faulthandler
import sys

HANG_BUDGET_S = 900  # a hung kernel ends the run with a traceback, not silence
faulthandler.dump_traceback_later(HANG_BUDGET_S, exit=True)

import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parent
T0 = time.perf_counter()

N, K, CRC = 128, 64, "0x1864CFB"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
JAX_CSV = REPO / "results" / "fer_M8.csv"
# every rate in that CSV times 204800 is a whole count: 204800 frames a point
JAX_FRAMES_PER_POINT = 204800
SWEEP_FRAMES = 102400


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_done(name):
    print(f"[{time.perf_counter() - T0:7.1f} s] phase {name} done", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log):
    """[(template M, registers, spill stores, spill loads, static smem)] per entry."""

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            tm = re.search(r"scl_decode_kernelILi(\d+)E", m.group(1))
            cur = {"M": int(tm.group(1)) if tm else None, "regs": None,
                   "spill_stores": None, "spill_loads": None, "smem": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return rows


def make_llrs(rng, B, snr_db, info_set):
    """Real codewords through BPSK + AWGN, drawn with numpy (float32 LLRs)."""

    import torch
    from polar_code_tpu_torch.ops.crc import attach_crc_batch, crc_degree
    from polar_code_tpu_torch.ops.polar_transform import encode_batch

    payload = torch.from_numpy(rng.integers(0, 2, (B, K - crc_degree(CRC))).astype(np.int8))
    msg = attach_crc_batch(payload, CRC)
    code = encode_batch(msg, info_set, N).numpy()
    nv = 1.0 / (2.0 * (K / N) * 10 ** (snr_db / 10.0))
    y = 1.0 - 2.0 * code + rng.normal(0.0, math.sqrt(nv), code.shape)
    return (2.0 * y / nv).astype(np.float32), msg.numpy()


def random_plan(rng, msg):
    """DL-SCL-shaped plans: a prefix fixed to the sent bits, then on even
    frames one flipped bit (the CRC cannot pass) and on odd frames one more
    sent bit (it can); the rest free."""

    B = msg.shape[0]
    idx = rng.integers(0, K, B)
    pos = np.arange(K)[None, :]
    plan = np.where(pos < idx[:, None], msg, -1)
    last = np.where(np.arange(B)[:, None] % 2 == 0, 1 - msg, msg)
    plan = np.where(pos == idx[:, None], last, plan)
    return plan.astype(np.int8)


def near_tie_frames(metrics, rel=1e-5):
    """Frames whose adjacent ordered final metrics differ by < rel relative."""

    m = metrics.astype(np.float64)
    a, b = m[:, :-1], m[:, 1:]
    finite = np.isfinite(a) & np.isfinite(b)
    with np.errstate(invalid="ignore"):
        close = np.abs(b - a) < rel * np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30)
    return np.any(finite & close, axis=1)


def cuda_time_ms(fn, reps, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_fer_steps(chunk, nv_c, nv_u, steps=5):
    """Device time by kernel over a few FER steps (torch.profiler), and the
    share of the steps' wall time the device was busy (kernel time summed;
    kernels of one stream do not overlap)."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(steps):
            torch.stack(list(chunk(2, 50, i, nv_c, nv_u).values())).tolist()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = []  # device-side events only: a host op's row repeats its kernels' time
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        print("  profiler: no device time recorded (not measured)")
        return
    print(f"  profiler over {steps} FER steps: device busy {busy / wall_us:.3f} of "
          f"{wall_us / steps / 1e3:.3f} ms a step (host clock, profiler on)")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"    {dev_us / steps / 1e3:9.4f} ms a step  {count / steps:7.1f} calls  {key[:70]}")


def scl_work(info_set, M, B):
    """(bytes, operations) one SCL decode of B frames needs at least.

    Bytes: LLRs in, bits + info LLRs + pass out, each once.  Operations
    (float32): f = 4 (two |·|, min, sign product) and g = 2 (multiply, add)
    per updated entry per path, the penalty and metric add (5) per path per
    phase plus the second candidate's (5) at info phases, and (2M)² ranking
    comparisons per info phase; transcendentals count as one operation."""

    from polar_code_tpu_torch.ops.scl_schedule import schedule_tables

    upd, _, frozen, *_ = schedule_tables(N, np.asarray(info_set))
    widths = np.array([0] + [N >> l for l in range(1, upd.shape[1])])
    fg = int(((upd == 1) * widths).sum()) * 4 + int(((upd == 2) * widths).sum()) * 2
    n_info = int((frozen == 0).sum())
    per_frame = M * fg + M * N * 5 + M * n_info * 5 + n_info * (2 * M) ** 2
    nbytes = B * (N * 4 + K + K * 4 + 1)
    return nbytes, per_frame * B


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from polar_code_tpu_torch import _build
    from polar_code_tpu_torch.eval import run_fer_sweep
    from polar_code_tpu_torch.ops import scl_cuda
    from polar_code_tpu_torch.ops.scl import decode_scl_batch
    from polar_code_tpu_torch.polar.construct import construct_info_set
    from polar_code_tpu_torch.sim.pipeline import make_fer_chunk
    from polar_code_tpu_torch.channel import noise_var_coded, noise_var_uncoded
    from polar_code_tpu_torch.interop import load_beta

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    info_set = construct_info_set(N, K)

    # ---- 1. device ----
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"device: {name} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    phase_done("1 device")

    # ---- 2. build ----
    built = _build.build(scl_cuda.SOURCE)
    print(f"build: {built.path.name} in {built.seconds:.2f} s"
          + (" (reused an identical earlier build)" if built.cached else ""))
    for row in ptxas_report(built.log):
        print(f"  ptxas M={row['M']}: {row['regs']} registers, {row['smem']} B static smem, "
              f"spills {row['spill_stores']} B stores / {row['spill_loads']} B loads")
    for M in scl_cuda.SUPPORTED_M:
        fb, fpb = scl_cuda.frame_bytes(N, K, M), scl_cuda.frames_per_block(N, K, M)
        print(f"  dynamic smem M={M}: {fb} B per frame x {fpb} frames = {fb * fpb} B per block")
    scl_cuda._library()
    phase_done("2 build")

    # ---- 3. kernel against its plain version ----
    rng = np.random.default_rng(20261017)
    cases = [(M, crc, plan, snr, 4096)
             for M in scl_cuda.SUPPORTED_M for crc in (CRC, None)
             for plan in (False, True) for snr in (3.0, 5.0, 7.0)]
    # ragged batches: not a multiple of 128 frames, and (1001) of the block
    cases += [(8, CRC, True, 5.0, 1000), (4, CRC, False, 5.0, 1001)]
    max_abs_err = 0.0
    near_ties = []
    for M, crc, use_plan, snr, B in cases:
        llr_np, msg = make_llrs(rng, B, snr, info_set)
        llr = torch.from_numpy(llr_np).to(dev)
        plan = torch.from_numpy(random_plan(rng, msg)).to(dev) if use_plan else None
        out = scl_cuda.decode_scl_cuda(llr, info_set, M, crc, force_info_bits=plan)
        torch.cuda.synchronize()
        ref = decode_scl_batch(llr, info_set, M, crc, force_info_bits=plan, dtype=torch.float32)
        torch.cuda.synchronize()
        kb, rb = out["best_path_bits"].cpu().numpy(), ref.best_path_bits.cpu().numpy()
        kp, rp = out["crc_pass"].cpu().numpy(), ref.crc_pass.cpu().numpy()
        kl, rl = out["best_path_info_llrs"].cpu().numpy(), ref.best_path_info_llrs.cpu().numpy()
        llr_ok = np.abs(kl - rl) <= 1e-6 * np.maximum(np.abs(rl), 1e-30)
        bad = np.any(kb != rb, axis=1) | (kp != rp) | ~np.all(llr_ok, axis=1)
        ties = near_tie_frames(ref.metrics.cpu().numpy())
        unexplained = bad & ~ties
        tag = f"M={M} crc={'on' if crc else 'off'} plan={'on' if use_plan else 'off'} {snr} dB B={B}"
        if bad.any():
            for f in np.flatnonzero(bad):
                near_ties.append(f"{tag} frame {f} (seed 20261017)")
            print(f"  {tag}: {int(bad.sum())} mismatched frames, {int((bad & ties).sum())} near-ties")
        check(not unexplained.any(),
              f"kernel disagrees with the plain version ({tag}): frames "
              f"{np.flatnonzero(unexplained)[:10].tolist()}")
        max_abs_err = max(max_abs_err, float(np.max(np.abs(kl - rl))) if kl.size else 0.0)
        if snr == 5.0 and B == 4096:
            print(f"  {tag}: {int(bad.sum())} frames differ; crc pass {int(kp.sum())}/{B}, "
                  f"bit errors vs sent {int((kb != msg).sum())}", flush=True)
    print(f"kernel vs plain: {len(cases)} cases, near-tie mismatches {len(near_ties)}, "
          f"max |info LLR diff| {max_abs_err:.3e}")
    for line in near_ties:
        print(f"  near-tie: {line}")
    phase_done("3 kernel vs plain")

    # ---- 4. the main path: the FER sweep CLI on the card ----
    scl_cuda.decode_scl_cuda.launches = 0
    decode_scl_batch.cuda_calls = 0
    with tempfile.TemporaryDirectory() as tmp:
        rows = run_fer_sweep.main([
            "--M", "8", "--retries", "8", "--beta", str(REPO / "checkpoints" / "beta_M8.npy"),
            "--batch", "4096", "--frames", str(SWEEP_FRAMES),
            "--snr_lo", "4.0", "--snr_hi", "5.0", "--snr_step", "1.0",
            "--out_dir", f"{tmp}/results", "--plot_dir", f"{tmp}/plots",
        ])
        torch.cuda.synchronize()
        csv_text = Path(f"{tmp}/results/fer_M8.csv").read_text()
    main_launches = scl_cuda.decode_scl_cuda.launches
    plain_cuda = decode_scl_batch.cuda_calls
    steps = 2 * SWEEP_FRAMES // 4096
    print(f"main path: {main_launches} kernel launches over {steps} FER steps "
          f"({main_launches / steps:.2f} a step), plain decoder on CUDA {plain_cuda} times")
    check(main_launches >= steps, "the FER sweep did not go through the SCL kernel")
    check(plain_cuda == 0, "the plain decoder ran on CUDA in the FER sweep")
    check(csv_text.splitlines()[0] == "snr_db,fer_scl,ber_scl,fer_dl,ber_dl", "CSV header")
    jax_rows = {}
    for line in JAX_CSV.read_text().splitlines()[1:]:
        vals = line.split(",")
        jax_rows[float(vals[0])] = {"fer_scl": float(vals[3]), "fer_dl": float(vals[5])}
    for row in rows:
        for key in ("fer_scl", "fer_dl"):
            p1, p2 = row[key], jax_rows[row["snr_db"]][key]
            check(math.isfinite(p1) and 0.0 < p1 < 1.0, f"{key} at {row['snr_db']} dB is {p1}")
            se = math.sqrt(p1 * (1 - p1) / SWEEP_FRAMES + p2 * (1 - p2) / JAX_FRAMES_PER_POINT)
            z = (p1 - p2) / se
            print(f"  {row['snr_db']:.1f} dB {key}: port {p1:.6e} ({SWEEP_FRAMES} frames) vs "
                  f"JAX {p2:.6e} ({JAX_FRAMES_PER_POINT} frames): z = {z:+.3f}")
            check(abs(z) < 3.0, f"{key} at {row['snr_db']} dB is off the JAX sweep (z={z:.2f})")
    phase_done("4 main path")

    # ---- 5. times ----
    llr_np, _ = make_llrs(np.random.default_rng(5), 4096, 5.0, info_set)
    llr = torch.from_numpy(llr_np).to(dev)
    kernel_ms = cuda_time_ms(lambda: scl_cuda.decode_scl_cuda(llr, info_set, 8, CRC), reps=50)
    plain_ms = cuda_time_ms(
        lambda: decode_scl_batch(llr, info_set, 8, CRC, dtype=torch.float32), reps=20, warmup=2)
    nbytes, nops = scl_work(info_set, 8, 4096)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= nops / FP32_OPS_PER_S else "operations"

    beta = load_beta(str(REPO / "checkpoints" / "beta_M8.npy")).beta_matrix().detach()
    chunk = make_fer_chunk(N=N, K=K, crc_poly=CRC, info_set=info_set, M=8, retries=8,
                           beta=beta, batch=4096, device=dev, compact=-1)
    nv_c, nv_u = noise_var_coded(5.0, K, N), noise_var_uncoded(5.0)
    for i in range(2):
        torch.stack(list(chunk(1, 50, i, nv_c, nv_u).values())).tolist()
    before = scl_cuda.decode_scl_cuda.launches
    reps = 20
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(reps):
        torch.stack(list(chunk(1, 50, 1000 + i, nv_c, nv_u).values())).tolist()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / reps
    step_launches = (scl_cuda.decode_scl_cuda.launches - before) / reps
    print(f"times on {smi}:")
    print(f"  SCL kernel, B=4096 M=8 CRC: {kernel_ms:.4f} ms a decode (50 launches)")
    print(f"  plain version, same decode: {plain_ms:.4f} ms (20 calls)")
    print(f"  bound: {bound_ms:.6f} ms ({bound_by}; {nbytes} B, {nops} float32 operations)")
    print(f"  FER step at 5 dB (M=8, 8 retries, B=4096): {step_s * 1e3:.3f} ms, "
          f"{4096 / step_s:.0f} frames/s, {step_launches:.2f} kernel launches a step")
    for M in (1, 2, 4):
        ms = cuda_time_ms(lambda M=M: scl_cuda.decode_scl_cuda(llr, info_set, M, CRC), reps=50)
        print(f"  SCL kernel, B=4096 M={M} CRC: {ms:.4f} ms a decode (50 launches)")
    small = llr[:64].contiguous()  # about one retry step's failing frames at 5 dB
    ms = cuda_time_ms(lambda: scl_cuda.decode_scl_cuda(small, info_set, 8, CRC), reps=50)
    print(f"  SCL kernel, B=64 M=8 CRC: {ms:.4f} ms a decode (50 launches)")
    profile_fer_steps(chunk, nv_c, nv_u)
    phase_done("5 times")

    # ---- 6. result lines ----
    print(json.dumps({"kernels": [{
        "name": "scl_decode",
        "route": "cuda",
        "source": "polar_code_tpu_torch/csrc/scl_decode.cu",
        "replaces": "polar_code_tpu/ops/scl_pallas.py:293",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    code = main()
    faulthandler.cancel_dump_traceback_later()
    sys.exit(code)
