#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases (each ends with one flushed line carrying the elapsed seconds):

1. device: name, count, torch/CUDA versions, `nvidia-smi` name and power limit;
2. build: the three kernels, one `nvcc` each, started together — the SCL
   kernel K1 (`polar_code_tpu_torch/csrc/scl_decode.cu`), the NMS LDPC kernel
   K2 (`csrc/nms_decode.cu`) and the PAC list-decode kernel K3
   (`csrc/pac_decode.cu`) — with the build seconds and the `-Xptxas -v`
   registers, shared memory and spills (K1 in its best-only and its
   full-list instantiation); K2's launch plan (mode, edges in
   registers, record words and where they live, bytes a frame, frames a
   block and an SM, registers) for every K2 shape phases 6 and 8 run; K1's
   shared memory a frame, levels in global scratch and resident frames an
   SM for each shape it runs (more than one at N=2048 M=8, or the phase
   fails); and K3's for the shapes of phases 9 and 11 (at least 4 frames an
   SM at N=1024 L=32, or the phase fails);
3. K1 against its plain PyTorch version at P(128,64): M ∈ {1,2,4,8}, CRC-24A
   on and off, with and without a random forced plan, B=4096 LLRs at 3, 5
   and 7 dB, plus ragged B=1000 and B=1001 batches.  Bits and CRC pass must
   be identical and info LLRs equal within 1e-6 relative; a frame whose two
   ordered final path metrics lie within 1e-5 relative (a near-tie) is
   counted and printed instead of failing.  Then K1 against the JAX
   package's float32 XLA decoder, under the same rule: every case of
   `tests/golden/scl_f32_decode.npz` (written on the CPU by
   `tests/golden/make_scl_f32.py`: P(128,64) at M ∈ {1,2,4,8}, CRC on and
   off, plan on and off, 256 frames; P(2048,1024) M=8 CRC, 64 frames);
   3b. the same at the one shape of the BER path that phase 3 does not
   cover, run (c)'s NR polar code: N=128, K=88 (64 + CRC-24A), M=4, B=4096
   LLRs of the NR polar chain (E=256, derated and deinterleaved to N) at
   3.5 and 4.0 dB (runs (d)-(f) give K1 phase 3's P(128,64) at M 2 and 8,
   with and without plans);
   3c. the same at (N, K) ∈ {(256,128), (512,256), (1024,512), (2048,1024)},
   M ∈ {2, 8}, CRC-24A, B=256, LLRs N(0, 2²) (the shapes of
   `tests/test_fuzz_configs.py`), and K1's B=4096 M=8 time per N; then the
   rest of the envelope on codeword LLRs at 1–4 dB a frame, B=256: N=64 at
   M ∈ {1,2,4,8}, CRC on and off, plan on and off; N 256–2048
   (`gaussian_bitrev`) with CRC off, with a plan, and at M 1 and 4; a ragged
   B=1001 at N=2048;
   3d. where K1's time goes, with CUDA events: at N 1024 and 2048 (B=4096,
   M=8) each number of tree levels in global scratch, 0 to 5; at N=2048
   M ∈ {1, 2, 4}; B ∈ {64, 1024, 4096, 16384} at N=128 and N=2048;
4. the FER path: the FER sweep CLI (`run_fer_sweep.main`) at M=8, 8 retries,
   β from `checkpoints/beta_M8.npy`, 102400 frames at 4.0 and 5.0 dB; and at
   P(2048,1024) (`gaussian_bitrev`, β `checkpoints/n2048/beta_M8.npy`),
   40960 frames at 1.5 dB.  Every SCL decode must go through K1 (its launch
   counter grows, the plain decoder runs 0 times on CUDA), and FER of both
   arms must agree with the JAX package's `results/fer_M8.csv` and
   `results/n2048/fer_M8.csv` (frames per point from its
   `sweep_state.json`) at |z| < 3; then the rest of the envelope, each run
   held to its JAX CSV the same way: P(128,64) at M ∈ {1, 2, 4} (β
   `checkpoints/beta_M{M}.npy`, 102400 frames at 4.0 and 5.0 dB, against
   `results/fer_M{M}.csv`) and P(N, N/2) M=8 `gaussian_bitrev` for N ∈
   {256, 512, 1024} (β `checkpoints/n<N>/beta_M8.npy`, 40960 frames at the
   lowest point of `results/n<N>/fer_M8.csv`);
   4b. the training path: the dataset CLI (`train/make_dataset.main`, B=4096)
   at P(128,64) M=8 and M=1, 5.0 dB, 300000 frames, and P(1024,512)
   `gaussian_bitrev` M=8, 1.75 dB, 409600 frames — frames/s, K1's launches
   (at least one a chunk; the plain decoders 0 times on CUDA) and the
   labelled and baseline-failure rates within |z| < 3 of the committed
   shards' `meta` (`tests/golden/dataset_meta.json`), then a profiler split
   of the oracle chunk; β training (`train/train_beta.train_beta`, 2 epochs
   from the JAX trainer's initial parameters) against the JAX run in
   `tests/golden/train_beta_jax.npz` (losses within `TRAIN_LOSS_RTOL`, β
   within `TRAIN_BETA_ATOL`, accuracies identical up to argmax near-ties),
   seconds an epoch; and `eval/opcount.main` on `checkpoints/beta_M4.npy` and
   `checkpoints/n*/beta_M8.npy`, byte for byte the committed CSVs;
5. FER times with CUDA events after a warm-up: K1 and the plain version per
   B=4096 M=8 CRC decode, FER-step frames/s at 5 dB, a profiler split;
6. K2 against its plain PyTorch version: hard bits, iterations used and
   parity flags identical in every frame — QC-IRA 4×8 Z=31 (E=248) and the
   demo graph at Z=32 (E=384, derated), shared-min and two-min, B=4096 at
   1.0, 2.5 and 4.0 dB; ragged B=1000 and B=1001; and QC-IRA 46×68 Z=383
   (n=26044) at B=64, the all-zero codeword through AWGN, at a noise level
   where most frames run all 20 iterations and one where most stop early;
   then K2d, the rest of the envelope (all-zero codewords at 0–12 dB a
   frame unless named): the demo graph at Z=2 and Z=33, QC-IRA 4×8 at
   Z=37, QC-IRA 3×6 at Z=1021, QC-IRA 2×42 Z=41 (rows of degree 41–42)
   and a dense 2×40 graph at Z=8 (degree 40 a warp a frame), each in both
   modes; integer LLRs in −3..3 (exact zeros and ties of |ext|) at QC-IRA
   4×8 Z=31; `max_iter` 0 and 1; a ragged B=333;
7. the BER path: the BER sweep CLI (`run_ber_sweep.main`), B=4096, seed 0,
   the bits cap deciding, for (a) `nr_ldpc` QC-IRA 4×8 two-min at 2.0/2.5/
   3.0 dB, (b) `nr_ldpc` demo Z=32 at 2.0 dB, (c) `nr_polar_scl` at 3.5/4.0
   dB, (d) `polar_scl` M=8 at 5.0/5.5 dB, (e) adaptive M 2→8 at 5.0 dB and
   (f) `dl_scl` M=8 at 5.0 dB, each held to the JAX package's committed
   `results/ber_*.csv` or to its own bound; the kernels' counters grow and
   the plain decoders run 0 times on CUDA;
   7b. the multi-process path: 2 ranks (`chip_smoke.py --rank-worker`,
   torchrun's variables, gloo on localhost, both on cuda:0) build K1 and
   K2 into a fresh directory (one `nvcc` a source across the ranks, the build lock)
   and run the FER CLI at P(128,64) M=8, 8 retries, β `beta_M8.npy`, B=4096,
   40960 frames at 4.0 and 5.0 dB with the frames split and with
   `--snr_split`, and BER run (a) at 2.5 dB; every CSV byte-identical to
   the one-process run's, only rank 0 writes, each rank's JSON line shows
   K1 and K2 launched and the plain decoders 0 times; FER-step frames/s at
   5.0 dB with 1, 2 and 4 ranks on the card (informative);
8. BER times: K2 and its plain version at the shapes of phase 6, their
   bounds, and K2 alone at QC-IRA 4×8 Z=31 two-min B=65536 and B=1 (a
   call's floor) and QC-IRA 46×68 Z=383 two-min B=1024
   (`nms_timing_cases`, which `tools/time_nms_cuda.py` shares); BER-step
   frames/s for (a) at 2.5 dB and a profiler split;
9. K3 against the JAX package and its plain version: every case of
   `tests/golden/legacy_pac_decode.npz` (the JAX decoder's outputs, written
   by `tests/golden/make_legacy_pac.py`) with 0 frames differing in
   `extracted` and `crc_pass`; then against the plain version on the card,
   B=4096 at 2.5 dB, for PAC(128,64)+CRC-16 L=8 and the simulator's
   PAC(64,32) m=6 at L 1 and 32, and ragged B=1001 and B=1000 batches (L=16
   and L=5); then K3d, the rest of the first envelope, up to N=1024 L=32
   (phase 14 has L above 32 and N above 1024):
   PAC(256,128) and PAC(512,256) with CRC-16 at L=32 and 8, PAC(512,256)
   with the CRC off, PAC(1024,512)+CRC-16 at L=32 and a ragged B=333 at
   L=24.  No near-tie exemption: the PAC metric has no transcendentals;
10. the legacy path: the port's `simulator.run`, `crc_polar_vs_uncoded.
   simulate` and `crc_polar_ofdm_ls.simulate` at the golden file
   `tests/golden/legacy_pac_drivers.json`'s configurations and seeds, their
   results identical to the JAX drivers' recorded there (the OFDM channel MSE,
   host float64, within 1e-12 relative); K3's counter grows and the plain
   decoder runs 0 times on CUDA;
11. K3 times with CUDA events: PAC(64,32), PAC(128,64) and PAC(256,128) with
   CRC-16, gen 1011011, `dega`, 2.5 dB LLRs, L ∈ {1, 4, 8, 32}, B=65536; the
   plain version at B=4096; the bounds; PAC(1024,512) L=32 B=4096 at each
   number of tree levels in global scratch, 0 to 9; the same time with one
   payload bit (17 info phases) at N=128 and 1024, L=32; and the drivers'
   shapes;
12. the scalar, reference-compatible surface on the card: (a) K1's full-list
   output (`decode_scl_cuda(..., full=True)`) against the plain version —
   candidates, validity and selected rank identical, metrics and info LLRs
   within 1e-6 relative, outside near-ties — at P(128,64) M ∈ {1,2,4,8}, CRC
   on and off, plan on and off, 5.0 dB, B=4096, a ragged B=1001,
   P(1024,512) `gaussian_bitrev` M=8 at 1.75 dB B=1024 and P(2048,1024) M=8
   B=256; (b) its metrics of all M paths against the JAX float32 decoder's
   (every case of `tests/golden/scl_f32_decode.npz`); (c) the shapes of
   `tests/test_fuzz_configs.py` at B=4096 — N 16–4096 through K1 (list and
   best-only; B=256 at N=4096) against the plain version, and its PAC
   shapes through K3, every frame identical; (d) the
   scalar entry points with their default device — `sc_decode`,
   `decode_scl` (M 1 and 8) and `decode_with_retries` (M=2, 4 retries) on
   the 12 frames of `tests/golden/ref_p128_k64.npz` against the reference's
   outputs, `retry_with_flip`, `decode_ldpc_nms` (QC-IRA 4×8 Z=31, shared
   and two-min), `decode_rate_matched_scl` (BER run (c)'s code) and
   `PolarCode(64, 48, "dega", L).pac_list_crc_decoder` (CRC-16, L 1 and 4)
   on 64 frames each, equal to the batch kernels on the same frames; K1, K2
   and K3 launched once a decode and the plain decoders never on CUDA; the
   systematic PolarCode decoder and `decode_ldpc_nms(early_stop=False)` on
   one frame each equal to the plain version, and float64 raising on the
   card; (e) `decode_scl`'s time a call and K1's full-list launch beside
   its best-only launch;
13. the wide envelope (`wide_envelope`): the `-Xptxas -v` registers and
   spills of the six by-path instantiations (one that spills fails the
   phase), K1's launch plan at every new shape (at B=4096); (a) K1's
   by-path instantiation against the plain version, list and best-only,
   at P(128,64) CRC-24A M ∈ {3, 16, 32}, B=1001, CRC on and off, plan on
   and off, and at P(1024,512) M=16 B=256; (b) K1 at N=4096 (M 1, 4, 8,
   16) and N=8192 (M 1, 4, 8, 16, 32), 32 frames each, and by path at
   N=8192 K=8000 M=32 and K=8192 M=29 (K·M trace bytes past a block,
   which the trace indices in global scratch take), 4 frames each, against
   the plain version; (c) K1 against the JAX float32 decoder, every case of
   `tests/golden/scl_f32_wide.npz` (written on the CPU by
   `tests/golden/make_scl_f32_wide.py`: P(128,64) at M 3, 16, 32 and
   P(4096,2048) M=8) — bits, info LLRs and the metrics of all M paths;
   (a)–(c) under K1's near-tie rule; (d) the FER sweep CLI at P(128,64) M
   16 and 32, 8 retries, β `beta_M8.npy`, 40960 frames at two points
   (4.0 and 4.5 dB at M=16, 3.5 and 4.0 dB at M=32),
   through K1's by-path instantiation alone, held to the JAX CLI's CSVs in
   `tests/golden/fer_wide/` at |z| < 3; (e) the scalar calls that reach
   the new instantiations — `decode_scl` at M=16 on the 12 golden frames,
   the systematic `PolarCode(64, 48, "dega", L)` decoder at L 1, 4 and 32
   with CRC-16 on and off, and `decode_ldpc_nms(early_stop=False)` on
   QC-IRA 4×8 Z=31 shared and two-min, 64 frames each — each one launch of
   its new instantiation and equal to the plain version on the card; and
   K3's list launch (`pac_list_decode_cuda(..., full=True)`) on the
   systematic decoder's frames, every list field (`extracted`, `crc_pass`,
   `v_full`, `candidates`, `metrics`, `valid`, `best_index`) equal to the
   plain version's; (f) times with CUDA events: K1 by path at `PATH_TIMES`
   (P(128,64) M 3, 16 and 32 at B 4096, 400 and 1; P(1024,512) M=16 and
   P(8192,4096) M=32 at B=1024), each with its launch plan (G, frames a
   block and an SM) and bound, and on the same inputs at each shape's
   launch plan, list and best-only, against the plain version (P(8192,4096)
   on 8 frames at the B=1024 plan; the plan depends on B, so these are the
   plans of the FER CLI's B=4096 launches and of the timed batches, which
   (a)–(c) at smaller batches do not run), beside byte-word M=8 at
   B=4096; K1 at P(4096,2048) and P(8192,4096) M=4 B=1024, K3's list
   launch beside its best-only one at PAC(128,64)+CRC-16 L=8 B=4096
   (and every list field there equal to the plain version's), and K2
   without early stop beside early stop at QC-IRA 4×8 Z=31 two-min B=4096
   (and its bits, iterations and parity there equal to the plain
   version's);
14. the deep lists (`deep_lists`): the `-Xptxas -v` registers and spills
   of the eight over-warps instantiations (a best-only one that spills
   fails the phase), and K1's and K3's launch plans at the new shapes
   (frames an SM, threads a block); (a) K1's
   over-warps
   instantiation (list sizes 33..1024, a frame over the warps of a block)
   against the plain version, list and best-only, at P(128,64) CRC-24A M ∈
   {33, 64, 100, 256, 1024}, B=37, CRC and plan on and off, and at P(1024,512)
   M 64 and 256 and P(32,28)
   M=64, B=13, under K1's near-tie rule; (b) K3 against the plain version,
   every list field and best-only, max |diff| 0: PAC(128,64)+CRC-16 at L
   64, 256 and 1024 and PAC(32,12)+CRC-16 at L=64 (B=37), PAC(2048,1024)
   L=32 and PAC(8192,4096) L=8 (B=6); (c) K1 and K3
   against the JAX golden files `tests/golden/scl_f32_deep.npz` and
   `pac_deep.npz` (written by `tests/golden/make_deep_lists.py`); (d) the
   FER sweep CLI at P(128,64) M=64, 8 retries, β `beta_M8.npy`, 40960
   frames at 3.0 and 3.5 dB, through K1's over-warps instantiation alone,
   against the JAX CLI's `tests/golden/fer_deep/fer_M64.csv` at |z| < 3;
   (e) the legacy simulator at `list_size_max=256` (stage 2 over warps),
   identical to the JAX driver (`tests/golden/legacy_pac_deep.json`); (f)
   `decode_scl` at M=64 on the 12 golden frames and `PolarCode(64, 48,
   "dega", 256).pac_list_crc_decoder`, systematic and not, 32 frames each,
   one launch a call, equal to the plain version; (g) times with CUDA
   events beside their bounds: K1 at P(128,64) B=4096 M 64, 256 and 1024
   beside by-path M=32, and at P(1024,512) M=64 B=1024; K3 at
   PAC(128,64)+CRC-16 B=4096 L 64, 256 and 1024 beside L=32, and
   PAC(2048,1024) L=32 and PAC(8192,4096) L=8 at B=1024;
15. the cluster lists (`cluster_lists`): the `-Xptxas -v` registers and
   spills of the four cluster instantiations and of K3's one-path-a-lane
   ones (a best-only one that spills fails the phase; K3 at L=1 may spill
   up to the parent's 32 B), and K1's and K3's
   launch plans at the new shapes (scratch bytes a frame, shared bytes a
   block, frames the card runs at once); each vs-plain case at two draws
   (seeds 20261118 and 20261119: a missing cluster barrier would show as a
   rare wrong decision): (a) K1's cluster instantiation (list sizes
   1025..8192, a frame over a thread-block cluster of 2, 4 or 8 blocks of
   1024 threads) against the plain version, list and best-only, at
   P(128,64) CRC-24A M ∈ {1025, 2048, 3000, 4096, 8192} (B=32; CRC and plan
   on and off at 2048), P(1024,512) M=2048 (B=16) and P(8192,2048) M=2048
   (B=2), under K1's near-tie rule, and K1 and K3 at M = L = 2048 with the
   card's room pinned to 10 frames' scratch (a larger allocation raises
   the out-of-memory error), a batch of 32 in 4 launches, every output
   equal to one launch's; (b) K1 and K3 against the JAX golden
   files `tests/golden/scl_f32_cluster.npz` (P(128,64) M 2048, 4096 and
   8192) and `pac_cluster.npz` (PAC(128,64)+CRC-16 L=2048), written by
   `tests/golden/make_cluster_lists.py`; (c) K3's cluster instantiation
   against the plain version, every list field and best-only, max |diff|
   0: PAC(128,64)+CRC-16 and PAC(32,12)+CRC-16 at L 2048 and 4096; (d) K3
   one path a lane at PAC(8192,7368)+CRC-16 L=32 (B=2), Kp past what its
   trace in shared memory took, the same way;
   (e) the legacy simulator at `list_size_max=2048` (stage 2 on a cluster),
   identical to the JAX driver (`tests/golden/legacy_pac_cluster.json`),
   and `decode_scl` at M=2048 on the 12 golden frames and `PolarCode(64,
   48, "dega", 2048).pac_list_crc_decoder`, systematic and not, 8 frames
   each, one cluster launch a call, equal to the plain version; the plain
   decoders 0 times on CUDA; (f) times with CUDA events beside their
   bounds: K1 at P(128,64) CRC-24A B=1024 M 2048, 4096 and 8192 beside over
   warps at M=1024, K3 at PAC(128,64)+CRC-16 B=1024 L 2048 and 4096 beside
   L=1024, the plain versions at M = L = 2048, and K3 one path a lane at
   PAC(128,64)+CRC-16 L=32 B=4096 and PAC(8192,7368) L=32 B=64;
16. the long codes (`long_codes`): the `-Xptxas -v` registers and spills
   of the wide instantiations (σ of 30 fields: K1 and K3 one path a lane
   at LM 16 and 32, over warps with 16-bit entries; a best-only one that
   spills fails the phase), and each shape's plan (G, scratch bytes a
   frame, shared bytes, frames an SM or at once); (a) K1 and K3 against
   the plain version, list and best-only, one draw each, no frame allowed
   to differ (the plain version takes 9–75 s a call, so its calls run six
   at once in worker processes, `plain_reference`): K1 at P(16384,8192) M
   1, 8, 32 (the golden file's 8 frames), M=16 with forced plans, M 64,
   1024 and 2048, at P(65536,65536) M 1, 8 and 32, P(65536,32768) M 8 and
   32 and P(65536,256) M=2048; K3 at PAC(16384,8192)+CRC-16 L 8 (golden),
   16, 32, 64, 256, 2048 and PAC(65536,240) L 8 and 2048, every list field
   exactly; (b)
   K1, K3 and both plain versions against the JAX file
   `tests/golden/scl_f32_long.npz` (written by
   `tests/golden/make_scl_f32_long.py`), K1 under its near-tie rule; (c)
   the FER sweep CLI at P(16384,8192) `gaussian_bitrev` CRC-24A M=8, 8
   retries, no β, 4096 frames at B=1024 and 1.25 dB, through K1 (the plain
   decoders 0 times on CUDA), and `decode_scl` at M=8, the legacy
   `pac_decode` at L=8 and the systematic `PolarCode(16384, 8208)` at L=8
   on one frame each, one launch a call, equal to the batch launches; a
   batch the card cannot allocate (K1 P(128,64) M=64 B=65536, a blocker
   tensor holding all but half its scratch) split after the failed
   allocation, every output equal to one launch's; (d) CUDA-event times
   at B=1024 (B=64 at M and L >= 1024) beside their bounds, and the plain
   versions' at P(16384,8192) M = L = 8; (e) with a parent's
   `polar_code_tpu_torch/` and `tools/` in `smoke_checkout/parent/`,
   `tools/compare_sass.py` against it;
17. a `kernels` JSON line (one entry a kernel, and one for each new
   instantiation with its launches on phases 13's to 16's paths;
   each `max_abs_err` the largest difference from the plain version that
   the run measured), the `nvidia-smi` line, and the device JSON line last.

It exits non-zero, and prints no result line, when there is no CUDA device,
when a phase fails, or when run without the rest of the repository.  It
writes the sweeps' outputs to a temporary directory; the kernel builds land
in the git-ignored `build/`.
"""

import faulthandler
import sys

HANG_BUDGET_S = 1100  # a hung kernel ends the run with a traceback, not silence
faulthandler.dump_traceback_later(HANG_BUDGET_S, exit=True)

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import multiprocessing  # noqa: E402
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor  # noqa: E402
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
# the FER path at P(2048,1024): results/n2048, about 500 errors at 1.5 dB
N2048_FRAMES, N2048_SNR = 40960, 1.5
# the rest of the FER envelope: P(128,64) at M 1, 2, 4 (results/fer_M{M}.csv,
# 204800 frames a point), and P(N, N/2) M=8 at the lowest point of
# results/n<N>/fer_M8.csv, with the JAX frames a point: n1024 from its
# sweep_state.json; n512's rates are whole counts over 2,097,152; n256 has no
# state file, and 2,015,232 (--frames 2000000 at --batch 16384) is the
# smallest count over which each of its rates is a whole count
ENVELOPE_MS = (1, 2, 4)
ENVELOPE_N = {256: (2.0, 2015232), 512: (1.75, 2097152), 1024: (1.5, None)}
ENVELOPE_N_FRAMES = 40960
# the training path: dataset shards generated on the card, held to the
# committed shards' meta (tests/golden/dataset_meta.json):
# (name, M, N, K, construction, Eb/N0, frames, committed shard)
DATASETS = [
    ("P(128,64) M=8 5.0 dB", 8, 128, 64, "gaussian", 5.0, 300000, "train_M8_snr5_seed0_part0.npz"),
    ("P(128,64) M=1 5.0 dB", 1, 128, 64, "gaussian", 5.0, 300000, "train_M1_snr5_seed0_part0.npz"),
    ("P(1024,512) M=8 1.75 dB", 8, 1024, 512, "gaussian_bitrev", 1.75, 409600,
     "train_M8_n1024_snr1.75_seed0_part0.npz"),
]
# β training on the card against the JAX trainer's float32 run
# (tests/golden/train_beta_jax.npz): relative on the losses, absolute on β.
# The card gave 9.6e-8 and 4.5e-8 (cuBLAS sums in another order than XLA's
# CPU dot), so the bounds are the CPU tests' 1e-6
TRAIN_LOSS_RTOL, TRAIN_BETA_ATOL = 1e-6, 1e-6
OPCOUNT = [("beta_M4.npy", "opcount_M4.csv")] + [
    (f"n{n}/beta_M8.npy", f"n{n}/opcount_M8.csv") for n in (256, 512, 1024, 2048)]
NR_POLAR = (128, 88, 64, 256, 4)  # BER run (c): N, K (64 + CRC-24A), K_payload, E, M
K1C_SHAPES = [(256, 128), (512, 256), (1024, 512), (2048, 1024)]
# LDPC codes of the BER path: (name, base graph spec, Z, K_payload, E)
IRA, DEMO = ("ira4x8", "ira4x8", 31, 100, 248), ("demo Z=32", "2", 32, 72, 384)
BER_FRAMES = 40960  # a point of the BER runs: ten B=4096 chunks
# two-min NMS on QC-IRA 46x68 has its threshold near 6.5 dB; shared-min only
# stops when the channel's hard decisions already are the codeword
BIG = (46, 68, 383)  # QC-IRA with BG1's block shape, lifted at the largest prime Z <= 384
BIG_EBN0 = {True: (5.0, 7.0), False: (5.0, 15.0)}
# K2d, the rest of K2's envelope: (base graph spec, Z, modes of min, B, max_iter)
K2D = [("2", 2, (False, True), 1024, 20), ("2", 33, (False, True), 1024, 20),
       ("ira4x8", 37, (False, True), 1024, 20), ("ira3x6", 1021, (False, True), 256, 20),
       ("ira2x42", 41, (False, True), 1024, 20), ("ira4x8", 31, (False, True), 1024, 0),
       ("ira4x8", 31, (False, True), 1024, 1), ("2", 33, (True,), 333, 20),
       ("dense2x40", 8, (False, True), 1024, 20)]
# float32 operations an iteration, (per edge, per check row).  Two-min: sub,
# abs, sign, two min/compare, the sign-product multiply, two update
# multiplies and the add, all per edge.  Shared min: sub, abs, sign, one min,
# the sign-product multiply and the add per edge, and the one update
# multiply per row.  The rate is the guide's float32 peak, 67e12, which
# counts an FMA as two: none of these is an FMA, so the issue rate of them
# is half that, and the bound is the lower, more lenient of the two.
NMS_OPS = {False: (6, 1), True: (9, 0)}
GOLDEN = REPO / "tests" / "golden"
PAC_GEN = [1, 0, 1, 1, 0, 1, 1]  # the legacy simulator's conv generator (m=6)
PAC_CRC = (16, 0x1021)  # CRC-16 of the legacy drivers
# PAC codes of phases 9 and 11: (N, payload K, CRC (len, poly) or None)
PAC_CODES = {64: (64, 32, PAC_CRC), 128: (128, 64, PAC_CRC), 256: (256, 128, PAC_CRC)}
PAC_BATCH = 65536  # frames a timed K3 call


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
    """[(entry, registers, spill stores, spill loads, static smem)] per entry."""

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            tm = re.search(r"scl_decode_kernelILi(\d+)ELb([01])E", m.group(1))
            tw = re.search(r"scl_path(_wide)?_kernelILi(\d+)ELb([01])E", m.group(1))
            tp = re.search(r"pac_decode(_wide)?_kernelILi(\d+)E(?:Lb([01])E)?", m.group(1))
            tn = re.search(r"nms_kernel_(warp|block|1024)ILi(\d+)ELb([01])E", m.group(1))
            td = re.search(r"(scl|pac)_deep_kernelI([ht])Lb([01])E", m.group(1))
            tdw = re.search(r"(scl|pac)_deep_wide_kernelILb([01])E", m.group(1))
            tc = re.search(r"(scl|pac)_cluster_kernelILb([01])E", m.group(1))
            entry = (f"scl_decode_kernel<M={tm.group(1)}{', list' if tm.group(2) == '1' else ''}>" if tm
                     else f"scl_path{tw.group(1) or ''}_kernel<LM={tw.group(2)}"
                          f"{', list' if tw.group(3) == '1' else ''}>" if tw
                     else f"pac_decode{tp.group(1) or ''}_kernel<LM={tp.group(2)}"
                          f"{', list' if tp.group(3) == '1' else ''}>" if tp
                     else f"{tdw.group(1)}_deep_wide_kernel<u16 trace{', list' if tdw.group(2) == '1' else ''}>"
                     if tdw
                     else f"nms_kernel<D={tn.group(2)}, {'two-min' if tn.group(3) == '1' else 'shared'}, "
                          f"{tn.group(1)}>" if tn
                     else f"{td.group(1)}_deep_kernel<{'u8' if td.group(2) == 'h' else 'u16'} trace"
                          f"{', list' if td.group(3) == '1' else ''}>" if td
                     else f"{tc.group(1)}_cluster_kernel<{'list' if tc.group(2) == '1' else 'best-only'}>"
                     if tc else m.group(1))
            cur = {"entry": entry, "regs": None, "spill_stores": None, "spill_loads": None,
                   "smem": 0}
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


def make_llrs(rng, B, snr_db, info_set, n=N):
    """Real CRC-24A codewords of the (n, len(info_set)) code through BPSK +
    AWGN, drawn with numpy (float32 LLRs); `snr_db` a number or a [B, 1]
    array of per-frame Eb/N0."""

    import torch
    from polar_code_tpu_torch.ops.crc import attach_crc_batch, crc_degree
    from polar_code_tpu_torch.ops.polar_transform import encode_batch

    k = len(info_set)
    payload = torch.from_numpy(rng.integers(0, 2, (B, k - crc_degree(CRC))).astype(np.int8))
    msg = attach_crc_batch(payload, CRC)
    code = encode_batch(msg, info_set, n).numpy()
    nv = 1.0 / (2.0 * (k / n) * 10 ** (np.asarray(snr_db) / 10.0))
    y = 1.0 - 2.0 * code + rng.normal(0.0, 1.0, code.shape) * np.sqrt(nv)
    return (2.0 * y / nv).astype(np.float32), msg.numpy()


def nr_polar_llrs(rng, B, snr_db, info_set):
    """LLRs of BER run (c)'s NR polar chain, CRC-24A codewords interleaved
    and rate-matched to E through BPSK + AWGN at the BER sweep's Es/N0, then
    derated and deinterleaved back to N, as the decoder gets them (numpy
    draws); and the sent info+CRC bits."""

    import torch
    from polar_code_tpu_torch.eval.run_ber_sweep import _noise_var
    from polar_code_tpu_torch.nr.polar.interleaver import subblock_deinterleave
    from polar_code_tpu_torch.nr.polar.rate_match import derate_match_polar
    from polar_code_tpu_torch.nr.polar.scl_nr import encode_rate_matched_batch
    from polar_code_tpu_torch.ops.crc import attach_crc_batch

    n, _, kp, E, _ = NR_POLAR
    payload = torch.from_numpy(rng.integers(0, 2, (B, kp)).astype(np.int8))
    tx = encode_rate_matched_batch(payload, CRC, n, E, info_set).numpy()
    nv = _noise_var(snr_db, kp, E)
    llr = ((1.0 - 2.0 * tx + rng.normal(0.0, math.sqrt(nv), tx.shape)) * (2.0 / nv)).astype(np.float32)
    internal = subblock_deinterleave(derate_match_polar(torch.from_numpy(llr), n), n)
    return internal.contiguous(), attach_crc_batch(payload, CRC).numpy()


def random_plan(rng, msg):
    """DL-SCL-shaped plans: a prefix fixed to the sent bits, then on even
    frames one flipped bit (the CRC cannot pass) and on odd frames one more
    sent bit (it can); the rest free."""

    B, k = msg.shape
    idx = rng.integers(0, k, B)
    pos = np.arange(k)[None, :]
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


def profile_steps(step, label, steps=5):
    """Device time by kernel over a few steps (torch.profiler), and the share
    of the steps' wall time the device was busy (kernel time summed; kernels
    of one stream do not overlap).  `step(i)` runs step i to its host sync."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(steps):
            step(i)
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
        print(f"  profiler ({label}): no device time recorded (not measured)")
        return
    print(f"  profiler over {steps} {label}: device busy {busy / wall_us:.3f} of "
          f"{wall_us / steps / 1e3:.3f} ms a step (host clock, profiler on)")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"    {dev_us / steps / 1e3:9.4f} ms a step  {count / steps:7.1f} calls  {key[:70]}")


def select_ops(L):
    """Comparisons needed to pick the best L of 2L candidates in order: the
    decision-tree bound ceil(log2((2L)! / L!)), 29 at L=8 (a rank count by
    all pairs does (2L)² = 256)."""

    return (math.factorial(2 * L) // math.factorial(L) - 1).bit_length()


def scl_work(info_set, M, B, n=N, k=K):
    """(bytes, operations) one SCL decode of B frames needs at least.

    Bytes: LLRs in, bits + info LLRs + pass out, each once.  Operations
    (float32): f = 4 (two |·|, min, sign product) and g = 2 (multiply, add)
    per updated entry per path, the penalty and metric add (5) per path per
    phase plus the second candidate's (5) at info phases, and `select_ops(M)`
    comparisons per info phase; transcendentals count as one operation."""

    from polar_code_tpu_torch.ops.scl_schedule import schedule_tables

    upd, _, frozen, *_ = schedule_tables(n, np.asarray(info_set))
    widths = np.array([0] + [n >> l for l in range(1, upd.shape[1])])
    fg = int(((upd == 1) * widths).sum()) * 4 + int(((upd == 2) * widths).sum()) * 2
    n_info = int((frozen == 0).sum())
    per_frame = M * fg + M * n * 5 + M * n_info * 5 + n_info * select_ops(M)
    nbytes = B * (n * 4 + k + k * 4 + 1)
    return nbytes, per_frame * B


def nms_work(iters_used, n, edges, rows, self_exclude):
    """(bytes, operations) one NMS decode needs at least: LLRs in, hard bits,
    iteration count and pass flag out, each once; NMS_OPS operations an edge
    and a check row for every iteration each frame actually ran."""

    B = int(iters_used.numel())
    nbytes = B * (4 * n + n + 4 + 1)
    per_edge, per_row = NMS_OPS[self_exclude]
    nops = int(iters_used.sum()) * (edges * per_edge + rows * per_row)
    return nbytes, nops


def pac_mask(N, kp, profile="dega"):
    from polar_code_tpu_torch.legacy.rate_profile import rateprofile

    rp = rateprofile(N, kp, 2.0, 0)
    rp.build_mask(profile)
    return np.asarray(rp.modify_profile())


def pac_llrs(rng, B, snr_db, code, gen, mask, dev):
    """Float32 LLRs of PAC codewords (CRC'd payloads, the port's encoder on the
    card) through BPSK + AWGN at Eb/N0 over the payload rate (numpy draws)."""

    import torch
    from polar_code_tpu_torch.legacy.crclib import crc
    from polar_code_tpu_torch.legacy.pac import pac_encode_batch

    n, k, crc_cfg = code
    msgs = rng.integers(0, 2, (B, k)).astype(np.int8)
    if crc_cfg:
        msgs = np.concatenate([msgs, crc(*crc_cfg).crcCalc_batch(msgs)], axis=1)
    x = pac_encode_batch(torch.from_numpy(msgs).to(dev), mask, gen, n).cpu().numpy()
    nv = 1.0 / (2.0 * (k / n) * 10 ** (snr_db / 10.0))
    y = 1.0 - 2.0 * x + rng.normal(0.0, math.sqrt(nv), x.shape)
    return torch.from_numpy((2.0 * y / nv).astype(np.float32)).to(dev)


def pac_work(mask, L, B):
    """(bytes, operations) one PAC list decode of B frames needs at least.

    Bytes: LLRs in, bits + pass flag out, each once.  Operations, per path:
    f = 4 (two |·|, min, sign product) and g = 2 (multiply, add) per updated
    entry, and per phase the metric's penalty add and the shift register's
    parity; per info phase `select_ops(L)` comparisons of the candidates."""

    from polar_code_tpu_torch.legacy.pac import bitrev_perm
    from polar_code_tpu_torch.ops.scl_schedule import schedule_tables

    n = int(mask.size)
    upd, _, frozen, *_ = schedule_tables(n, np.flatnonzero(mask[bitrev_perm(n)] == 1))
    widths = np.array([0] + [n >> l for l in range(1, upd.shape[1])])
    fg = int(((upd == 1) * widths).sum()) * 4 + int(((upd == 2) * widths).sum()) * 2
    n_info = int((frozen == 0).sum())
    per_frame = L * fg + L * n * 2 + n_info * select_ops(L)
    return B * (n * 4 + n_info + 1), per_frame * B


def bound(nbytes, nops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def base_graph(spec, Z):
    """"ira<m>x<n>" (QC-IRA), "dense<m>x<n>" (every block nonzero, shifts
    i·(j+1) mod Z; rows of degree n) or a demo graph's number."""

    from polar_code_tpu_torch.nr.ldpc import BaseGraph, load_base_graph
    from polar_code_tpu_torch.nr.ldpc.qc_ira import make_qc_ira_bg, parse_ira_spec

    if spec.startswith("dense"):
        m, n = parse_ira_spec(spec[5:])
        return BaseGraph(spec, m, n, (np.arange(m)[:, None] * np.arange(1, n + 1)[None]) % Z)
    return make_qc_ira_bg(*parse_ira_spec(spec), Z) if spec.startswith("ira") else load_base_graph(int(spec))


def ldpc_code(spec, Z):
    from polar_code_tpu_torch.nr.ldpc import build_h_matrix

    bg = base_graph(spec, Z)
    return bg, build_h_matrix(bg, Z)


def ldpc_llrs(rng, code, B, ebno, dev):
    """LLRs of CRC-24A LDPC codewords, rate-matched to E, through BPSK + AWGN
    at the BER sweep's Es/N0, derated back to n (numpy draws)."""

    import torch
    from polar_code_tpu_torch.eval.run_ber_sweep import _noise_var
    from polar_code_tpu_torch.nr.ldpc import derate_match_ldpc, encode_ldpc_batch, rate_match_ldpc
    from polar_code_tpu_torch.ops.crc import attach_crc_batch

    (_, _, _, kp, E), (bg, H) = code
    payload = torch.from_numpy(rng.integers(0, 2, (B, kp)).astype(np.int8))
    tx = rate_match_ldpc(encode_ldpc_batch(attach_crc_batch(payload, CRC), H), E).numpy()
    nv = _noise_var(ebno, kp, E)
    llr = ((1.0 - 2.0 * tx + rng.normal(0.0, math.sqrt(nv), tx.shape)) * (2.0 / nv)).astype(np.float32)
    return derate_match_ldpc(torch.from_numpy(llr), H.shape[1]).to(dev).contiguous()


def zero_codeword_llrs(rng, B, n, k, ebno, dev):
    import torch

    nv = 1.0 / (2.0 * (k / n) * 10 ** (ebno / 10.0))
    llr = ((1.0 + rng.normal(0.0, math.sqrt(nv), (B, n))) * (2.0 / nv)).astype(np.float32)
    return torch.from_numpy(llr).to(dev)


def spread_llrs(rng, B, n, k, dev):
    """All-zero codeword LLRs through AWGN at an Eb/N0 drawn a frame from
    0–12 dB (numpy draws), so frames stop at many iterations and some never
    (shared min stops only where the channel's hard decisions are right)."""

    import torch

    ebno = rng.uniform(0.0, 12.0, (B, 1))
    nv = 1.0 / (2.0 * (k / n) * 10 ** (ebno / 10.0))
    llr = ((1.0 + rng.normal(0.0, 1.0, (B, n)) * np.sqrt(nv)) * (2.0 / nv)).astype(np.float32)
    return torch.from_numpy(llr).to(dev)


def nms_timing_cases(dev, codes, big_bg, big_H=None):
    """K2's timed shapes with their LLRs (numpy draws, seeds 8 and 9), as
    [(tag, llr, base graph, Z, self_exclude, H or None, reps)]: H is given
    where the plain version is timed beside the kernel.  `codes` maps the
    names of IRA and DEMO to (their tuple, (base graph, H))."""

    cases = []
    for cname, (c, (bg, H)) in codes.items():
        x = ldpc_llrs(np.random.default_rng(8), (c, (bg, H)), 4096, 2.5, dev)
        for se in (True, False):
            cases.append((f"{cname} {'two-min' if se else 'shared'} 2.5 dB B=4096", x, bg, c[2], se,
                          H, 50))
    c, (bg, H) = codes[IRA[0]]
    x = ldpc_llrs(np.random.default_rng(8), (c, (bg, H)), 65536, 2.5, dev)
    cases.append((f"{IRA[0]} two-min 2.5 dB B=65536", x, bg, c[2], True, None, 10))
    # one frame: a call's floor (the wrapper's host time, or a frame's latency)
    cases.append((f"{IRA[0]} two-min 2.5 dB B=1", x[:1].contiguous(), bg, c[2], True, None, 50))
    rng = np.random.default_rng(9)
    big_n, big_k = BIG[1] * BIG[2], (BIG[1] - BIG[0]) * BIG[2]
    tag = f"ira{BIG[0]}x{BIG[1]} Z={BIG[2]}"
    for se in (True, False):
        for ebno in BIG_EBN0[se]:
            x = zero_codeword_llrs(rng, 64, big_n, big_k, ebno, dev)
            cases.append((f"{tag} {'two-min' if se else 'shared'} {ebno} dB B=64", x, big_bg, BIG[2],
                          se, big_H, 20))
    x = zero_codeword_llrs(rng, 1024, big_n, big_k, BIG_EBN0[True][0], dev)
    cases.append((f"{tag} two-min {BIG_EBN0[True][0]} dB B=1024", x, big_bg, BIG[2], True, None, 5))
    return cases


def csv_rows(path):
    """Rows of a BER CSV as dicts (`params` holds commas)."""

    lines = Path(path).read_text().splitlines()
    header = lines[0].split(",")
    rows = []
    for line in lines[1:]:
        f = line.split(",")
        vals = f[:6] + [",".join(f[6:-6])] + f[-6:]
        rows.append(dict(zip(header, vals)))
    return rows


def jax_fer_rows(path, frames):
    """{Eb/N0: {"fer_scl", "fer_dl"}} of a JAX FER CSV, checked to be whole
    counts over `frames`."""

    lines = Path(path).read_text().splitlines()
    header = lines[0].split(",")
    rows = {}
    for line in lines[1:]:
        row = dict(zip(header, map(float, line.split(","))))
        for key in ("fer_scl", "fer_dl"):  # 7 significant digits
            c = row[key] * frames
            check(abs(c - round(c)) <= 5e-7 * c + 1e-9, f"{path} {key} is not a count over {frames}")
        rows[row["snr_db"]] = {"fer_scl": row["fer_scl"], "fer_dl": row["fer_dl"]}
    return rows


def fer_z(p1, n1, p2, n2):
    se = math.sqrt(p1 * (1 - p1) / n1 + p2 * (1 - p2) / n2)
    return (p1 - p2) / se if se > 0 else (0.0 if p1 == p2 else math.inf)


def fer_envelope(reset_counts, counts):
    """The FER sweep CLI over the rest of its envelope, each run held to its
    JAX CSV at |z| < 3 and through K1; returns K1's launches."""

    import torch

    from polar_code_tpu_torch.eval import run_fer_sweep

    state = json.loads((REPO / "results" / "n1024" / "sweep_state.json").read_text())
    n1024_frames = math.ceil(state["config"]["frames"] / state["config"]["batch"]) * state["config"]["batch"]
    envelope = [(f"P(128,64) M={M}", ["--M", str(M), "--snr_lo", "4.0", "--snr_hi", "5.0"],
                 f"beta_M{M}.npy", f"fer_M{M}.csv", SWEEP_FRAMES, JAX_FRAMES_PER_POINT)
                for M in ENVELOPE_MS]
    envelope += [(f"P({n},{n // 2}) M=8", ["--M", "8", "--N", str(n), "--K", str(n // 2),
                                          "--construction", "gaussian_bitrev",
                                          "--snr_lo", str(snr), "--snr_hi", str(snr)],
                  f"n{n}/beta_M8.npy", f"n{n}/fer_M8.csv", ENVELOPE_N_FRAMES, jax_frames or n1024_frames)
                 for n, (snr, jax_frames) in ENVELOPE_N.items()]
    env_launches = 0
    for label, flags, beta_rel, csv_rel, frames, jax_frames in envelope:
        ref = jax_fer_rows(REPO / "results" / csv_rel, jax_frames)
        reset_counts()
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
            rows = run_fer_sweep.main(flags + [
                "--retries", "8", "--beta", str(REPO / "checkpoints" / beta_rel), "--batch", "4096",
                "--frames", str(frames), "--snr_step", "1.0",
                "--out_dir", f"{tmp}/results", "--plot_dir", f"{tmp}/plots"])
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches, _, plain_cuda = counts()
        env_launches += launches
        steps = len(rows) * math.ceil(frames / 4096)
        print(f"FER path {label}: {launches} K1 launches over {steps} FER steps, plain decoders on "
              f"CUDA {plain_cuda} times, {len(rows) * frames / secs:.0f} frames/s")
        check(launches >= steps, f"the {label} FER sweep did not go through K1")
        check(plain_cuda == 0, f"a plain decoder ran on CUDA in the {label} FER sweep")
        for row in rows:
            for key in ("fer_scl", "fer_dl"):
                p1, p2 = row[key], ref[row["snr_db"]][key]
                check(math.isfinite(p1) and 0.0 < p1 < 1.0, f"{label} {key} at {row['snr_db']} dB is {p1}")
                z = fer_z(p1, frames, p2, jax_frames)
                print(f"  {label} {row['snr_db']} dB {key}: port {p1:.6e} ({frames} frames) vs "
                      f"JAX {p2:.6e} ({jax_frames} frames): z = {z:+.3f}")
                check(abs(z) < 3.0, f"{label} {key} at {row['snr_db']} dB is off the JAX sweep (z={z:.2f})")
    return env_launches


def training_path(reset_counts, counts):
    """Phase 4b: dataset shards on the card held to the committed shards'
    rates, β training held to the JAX trainer's golden run, and opcount held
    to the committed CSVs; returns K1's launches."""

    import torch

    from polar_code_tpu_torch import config
    from polar_code_tpu_torch.channel import noise_var_coded
    from polar_code_tpu_torch.eval import opcount
    from polar_code_tpu_torch.interop import off_diag_from_numpy
    from polar_code_tpu_torch.polar.construct import construct_info_set
    from polar_code_tpu_torch.train import make_dataset, train_beta
    from polar_code_tpu_torch.utils.seeding import make_generator

    metas = json.loads((GOLDEN / "dataset_meta.json").read_text())
    train_launches = 0
    for label, M, n, k, construction, snr, frames, shard_name in DATASETS:
        ref = metas[shard_name]
        reset_counts()
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                make_dataset.main([
                    "--M", str(M), "--N", str(n), "--K", str(k), "--construction", construction,
                    "--snr_db", str(snr), "--frames", str(frames), "--seed", "0", "--batch", "4096",
                    "--out", f"{tmp}/d"])
                torch.cuda.synchronize()
            secs = time.perf_counter() - t
            print(out.getvalue(), end="")
            # the generation loop's own rate: the CLI's last progress line
            loop_rate = int(re.findall(r"([\d,]+) frames/s", out.getvalue())[-1].replace(",", ""))
            with np.load(f"{tmp}/d_part0.npz") as f:
                meta, x, y = json.loads(str(f["meta"])), f["abs_l0"], f["flip_idx"]
        launches, _, plain_cuda = counts()
        train_launches += launches
        frames, k_bits = meta["frames"], meta["K"]
        chunks = math.ceil(frames / 4096)
        print(f"dataset {label}: {frames} frames in {secs:.3f} s, {frames / secs:.0f} frames/s with the "
              f"shard's save, {loop_rate} frames/s without; {launches} K1 launches over {chunks} chunks, "
              f"plain decoders on CUDA {plain_cuda} times")
        check(launches >= chunks, f"dataset {label} did not go through K1")
        check(plain_cuda == 0, f"a plain decoder ran on CUDA in dataset {label}")
        check(meta["samples"] == y.size and x.shape == (y.size, k_bits) and x.dtype == np.float32
              and y.dtype == np.int32, f"dataset {label}: shard schema")
        check(bool(np.all(np.isfinite(x)) and np.all((y >= 0) & (y < k_bits))), f"dataset {label}: values")
        for what, ours, theirs in (
                ("labelled", meta["samples"], ref["samples"]),
                ("baseline failures", meta["samples"] + meta["failures"], ref["samples"] + ref["failures"])):
            p1, p2 = ours / frames, theirs / ref["frames"]
            z = fer_z(p1, frames, p2, ref["frames"])
            print(f"  {what}: port {ours}/{frames} = {p1:.6e} vs committed {theirs}/{ref['frames']} "
                  f"= {p2:.6e}: z = {z:+.3f}")
            check(abs(z) < 3.0, f"dataset {label}: {what} rate off the committed shard (z={z:.2f})")
        # where a chunk's time goes: the oracle chunk the CLI runs, alone
        cfg = config.get_config()
        cfg.N, cfg.K = n, k
        chunk = make_dataset.make_oracle_chunk(
            cfg, construct_info_set(n, k, method=construction), M, 4096, 8, compact=4096,
            device=torch.device("cuda"))
        nv = noise_var_coded(snr, k, n)
        profile_steps(lambda i: chunk(make_generator(7, i, device="cuda"), nv)["n_labeled"].item(),
                      f"dataset chunks of {label}")

    golden = np.load(GOLDEN / "train_beta_jax.npz")
    a = json.loads(str(golden["args"]))
    with tempfile.TemporaryDirectory() as tmp:
        shard = f"{tmp}/golden_part0.npz"
        np.savez(shard, abs_l0=golden["x"], flip_idx=golden["y"], meta=str(golden["shard_meta"]))
        args = train_beta.build_argparser().parse_args([
            "--M", str(a["M"]), "--data", shard, "--epochs", str(a["epochs"]), "--lr", str(a["lr"]),
            "--batch", str(a["batch"]), "--lambda_l2", str(a["lambda_l2"]), "--seed", str(a["seed"]),
            "--val_frac", str(a["val_frac"]), "--checkpoint_dir", f"{tmp}/ckpt", "--log_dir", f"{tmp}/logs"])
        hist = train_beta.train_beta(args, init=off_diag_from_numpy({"off_diag": golden["init_off_diag"]}))
        got_csv = Path(f"{tmp}/logs/train_M{a['M']}.csv").read_text()
        beta = np.load(f"{tmp}/ckpt/beta_M{a['M']}.npy")
    got = np.array([[float(v) for v in line.split(",")] for line in got_csv.splitlines()[1:]])
    ref_rows = golden["rows"]
    check(got.shape == ref_rows.shape and got_csv.splitlines()[0] == str(golden["csv"]).splitlines()[0],
          "β training: CSV shape")
    loss_err = float(np.max(np.abs(got[:, [1, 3]] - ref_rows[:, [1, 3]]) / np.abs(ref_rows[:, [1, 3]])))
    beta_err = float(np.max(np.abs(beta - golden["beta"])))
    n_val = golden["y"].size - int(golden["y"].size * (1.0 - a["val_frac"]))
    n_train = golden["y"].size - n_val
    print(f"β training on the card ({golden['y'].size} samples, {a['epochs']} epochs, from the JAX init): "
          f"losses within {loss_err:.3e} relative, β within {beta_err:.3e} absolute of the JAX run "
          f"(bounds {TRAIN_LOSS_RTOL:g}, {TRAIN_BETA_ATOL:g})")
    for row, ref_row, h in zip(got, ref_rows, hist):
        print(f"  epoch {int(row[0])}: {h['seconds']:.4f} s; train_acc {row[2]:.6f} (JAX {ref_row[2]:.6f}), "
              f"val_acc {row[4]:.6f} (JAX {ref_row[4]:.6f}); argmax near-ties {h['train_ties']} train, "
              f"{h['val_ties']} val")
        for col, total, ties in ((2, n_train, h["train_ties"]), (4, n_val, h["val_ties"])):
            diff = abs(round(row[col] * total) - round(ref_row[col] * total))
            check(diff <= ties, f"β training epoch {int(row[0])}: {diff} frames scored differently, "
                                f"{ties} near-ties")
    check(loss_err < TRAIN_LOSS_RTOL, f"β training losses off the JAX run ({loss_err:.3e})")
    check(beta_err < TRAIN_BETA_ATOL, f"β off the JAX run ({beta_err:.3e})")

    for beta_rel, csv_rel in OPCOUNT:
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
            opcount.main(["--beta", str(REPO / "checkpoints" / beta_rel), "--report", f"{tmp}/op.csv"])
            same = Path(f"{tmp}/op.csv").read_bytes() == (REPO / "results" / csv_rel).read_bytes()
        print(f"opcount {beta_rel}: {'identical to' if same else 'DIFFERS from'} results/{csv_rel}")
        check(same, f"opcount of {beta_rel} differs from results/{csv_rel}")
    return train_launches


# phase 7b, the multi-process path: ranks joined by gloo on localhost, all
# on the one card; FER at P(128,64) M=8 (40960 frames at 4.0 and 5.0 dB),
# BER run (a) at 2.5 dB, and the FER step timed at 5 dB over 409600 frames
MP_SOURCES = ("scl_decode.cu", "nms_decode.cu")
MP_TIMED_FRAMES = 409600
RANK_TAG = "RANK_RESULT "


def mp_fer_argv(out, frames, snr_lo, snr_hi):
    return ["--M", "8", "--retries", "8", "--beta", str(REPO / "checkpoints" / "beta_M8.npy"),
            "--batch", "4096", "--frames", str(frames), "--snr_lo", str(snr_lo),
            "--snr_hi", str(snr_hi), "--snr_step", "1.0", "--out_dir", f"{out}/fer",
            "--plot_dir", f"{out}/plots"]


def mp_ber_argv(out):
    return ["--scheme", "nr_ldpc", "--bg", "ira4x8", "--Z", "31", "--nms_exact", "--K_payload",
            "100", "--K_crc", "24", "--E", "248", "--EbN0_lo", "2.5", "--EbN0_hi", "2.5",
            "--batch", "4096", "--seed", "0", "--err_cap", "1000000000",
            "--bits_cap", str(BER_FRAMES * 100), "--out", f"{out}/ber.csv"]


def fer_rate(text):
    """Frames/s of the FER CLI's throughput line (its sweep loop alone)."""

    m = re.search(r"\((\d+) frames/s on (\d+) device\(s\)\)", text)
    check(m is not None, "the FER sweep printed no throughput line")
    return int(m.group(1)), int(m.group(2))


def rank_worker(spec_path):
    """One rank of phase 7b (`chip_smoke.py --rank-worker <spec.json>`, with
    torchrun's variables set): build the path's kernels, all sources at once
    (into the spec's build directory when it names one), run the spec's CLI
    calls ("{rank}" in an argument becomes the rank) and the timed FER call,
    and print one JSON line of this rank's launch counts, builds and rate."""

    import torch

    sys.path.insert(0, str(REPO))
    from polar_code_tpu_torch import _build
    from polar_code_tpu_torch.eval import run_ber_sweep, run_fer_sweep
    from polar_code_tpu_torch.nr.ldpc.decode_nms import decode_ldpc_nms_batch
    from polar_code_tpu_torch.nr.ldpc.nms_cuda import decode_ldpc_nms_cuda
    from polar_code_tpu_torch.ops.scl import decode_scl_batch
    from polar_code_tpu_torch.ops.scl_cuda import decode_scl_cuda
    from polar_code_tpu_torch.parallel.mesh import maybe_distributed_init, process_index, sync_processes
    from polar_code_tpu_torch.utils.cache import enable_compilation_cache
    from polar_code_tpu_torch.utils.device import resolve_device

    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    if spec["build_dir"]:
        enable_compilation_cache(spec["build_dir"])
    maybe_distributed_init()
    rank = process_index()
    device = resolve_device(spec["device"])
    builds = {}
    if device.type == "cuda":
        with ThreadPoolExecutor(max_workers=len(MP_SOURCES)) as pool:
            for src, res in zip(MP_SOURCES, pool.map(_build.build, MP_SOURCES)):
                builds[src] = {"nvcc": not res.cached, "seconds": round(res.seconds, 2)}
    clis = {"fer": run_fer_sweep.main, "ber": run_ber_sweep.main}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def run(cli, argv):
        decode_scl_cuda.launches = decode_ldpc_nms_cuda.launches = 0
        decode_scl_batch.cuda_calls = decode_ldpc_nms_batch.cuda_calls = 0
        with contextlib.redirect_stdout(io.StringIO()) as out:
            clis[cli]([a.replace("{rank}", str(rank)) for a in argv] + ["--device", spec["device"]])
            sync()
        counts = [decode_scl_cuda.launches, decode_ldpc_nms_cuda.launches,
                  decode_scl_batch.cuda_calls + decode_ldpc_nms_batch.cuda_calls]
        return counts, out.getvalue()

    runs = {name: run(cli, argv)[0] for name, cli, argv in spec["runs"]}
    sync_processes("timed", collective=True)
    _, text = run("fer", spec["timed"])
    fps, n_dev = fer_rate(text) if rank == 0 else (None, None)
    print(RANK_TAG + json.dumps({
        "rank": rank, "device": str(device), "builds": builds, "runs": runs,
        "k1": sum(r[0] for r in runs.values()), "k2": sum(r[1] for r in runs.values()),
        "plain": sum(r[2] for r in runs.values()), "fps": fps, "devices": n_dev,
    }), flush=True)
    return 0


def launch_ranks(world, spec, tmp, timeout_s=300):
    """Run `world` rank workers of `spec` (env init on a free localhost port);
    returns their JSON lines in rank order.  Every worker is ended before
    this returns."""

    import socket

    spec_path = Path(tmp) / f"spec_{world}.json"
    spec_path.write_text(json.dumps(spec))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--rank-worker", str(spec_path)],
                env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        deadline = time.perf_counter() + timeout_s
        outs = [p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith(RANK_TAG)]
        check(p.returncode == 0 and len(lines) == 1,
              f"rank {rank} of {world} failed (exit {p.returncode}):\n{out[-4000:]}")
        results.append(json.loads(lines[0][len(RANK_TAG):]))
    return results


def multi_process_path(reset_counts, counts, device="cuda"):
    """Phase 7b: the sweep CLIs as 2 ranks on the one card, their CSVs
    byte-identical to the one-process runs, every rank through K1 and K2,
    one nvcc a source across the ranks; FER-step frames/s at 1, 2 and 4 ranks.  Returns (K1, K2) launches of the
    main-path runs (one-process and ranks)."""

    import torch

    from polar_code_tpu_torch.channel import awgn_llr, bpsk, noise_var_coded
    from polar_code_tpu_torch.eval import run_ber_sweep, run_fer_sweep
    from polar_code_tpu_torch.ops.crc import attach_crc_batch, crc_degree
    from polar_code_tpu_torch.ops.polar_transform import encode_batch
    from polar_code_tpu_torch.ops.scl_cuda import decode_scl_cuda
    from polar_code_tpu_torch.polar.construct import construct_info_set
    from polar_code_tpu_torch.utils.device import resolve_device
    from polar_code_tpu_torch.utils.seeding import make_generator

    dev = resolve_device(device)

    # what every rank repeats: the whole chunk's draws, CRC and encode, at
    # N=2048 B=4096, beside K1 on a rank's half of it (2 ranks)
    info_big = construct_info_set(2048, 1024, method="gaussian_bitrev")
    nv = noise_var_coded(1.5, 1024, 2048)
    tag = iter(range(10**6))

    def draw():
        i = next(tag)
        payload = torch.randint(0, 2, (4096, 1024 - crc_degree(CRC)), device=dev, dtype=torch.int8,
                                generator=make_generator(0, 15, i, 0, device=dev))
        code = encode_batch(attach_crc_batch(payload, CRC), info_big, 2048)
        return awgn_llr(make_generator(0, 15, i, 1, device=dev), bpsk(code), nv)

    draw_ms = cuda_time_ms(draw, reps=20)
    half = draw()[:2048].contiguous()
    half_ms = cuda_time_ms(lambda: decode_scl_cuda(half, info_big, 8, CRC), reps=10)
    print(f"a rank's repeated chunk generation at P(2048,1024) B=4096 (draws, CRC, encode, "
          f"AWGN): {draw_ms:.4f} ms; K1 on its half (B=2048, M=8): {half_ms:.4f} ms")

    fer_frames = mp_fer_argv("{out}", BER_FRAMES, 4.0, 5.0)
    timed = mp_fer_argv("{out}", MP_TIMED_FRAMES, 5.0, 5.0)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        one = f"{tmp}/one"
        with contextlib.redirect_stdout(io.StringIO()):
            run_fer_sweep.main([a.replace("{out}", one) for a in fer_frames] + ["--device", device])
            run_ber_sweep.main(mp_ber_argv(one) + ["--device", device])
        k1, k2, plain = counts()
        print(f"one process: K1 launches {k1}, K2 launches {k2}, plain decoders on CUDA {plain}")
        check(k1 > 0 and k2 > 0 and plain == 0, "the one-process runs missed a kernel")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            run_fer_sweep.main([a.replace("{out}", f"{tmp}/one_timed") for a in timed]
                               + ["--device", device])
        rates = {1: fer_rate(out.getvalue())[0]}

        ranks = f"{tmp}/rank{{rank}}"
        res = launch_ranks(2, {
            "build_dir": f"{tmp}/build", "device": device,
            "runs": [["fer_frames", "fer", [a.replace("{out}", f"{ranks}/frames") for a in fer_frames]],
                     ["fer_split", "fer", [a.replace("{out}", f"{ranks}/split") for a in fer_frames]
                      + ["--snr_split"]],
                     ["ber_frames", "ber", mp_ber_argv(f"{ranks}/frames")]],
            "timed": [a.replace("{out}", f"{ranks}/timed") for a in timed],
        }, tmp)
        for r in res:
            print(RANK_TAG + json.dumps(r))
            check(r["k1"] > 0 and r["k2"] > 0, f"rank {r['rank']} did not launch K1 and K2")
            if dev.type == "cuda":
                check(r["plain"] == 0, f"a plain decoder ran on CUDA in rank {r['rank']}")
        for src in MP_SOURCES if dev.type == "cuda" else ():
            who = [r["rank"] for r in res if r["builds"][src]["nvcc"]]
            print(f"build log: {src}: nvcc ran on rank(s) {who}; the other rank loaded its build")
            check(len(who) == 1, f"{src} was compiled {len(who)} times by 2 ranks")
        for name, rel, ref in (("FER frames", "frames/fer/fer_M8.csv", "fer/fer_M8.csv"),
                               ("FER --snr_split", "split/fer/fer_M8.csv", "fer/fer_M8.csv"),
                               ("BER (a) frames", "frames/ber.csv", "ber.csv")):
            got = Path(f"{tmp}/rank0/{rel}").read_bytes()
            same = got == Path(f"{one}/{ref}").read_bytes()
            print(f"2 ranks, {name}: CSV {'byte-identical to' if same else 'DIFFERS from'} "
                  f"the one-process run")
            check(same, f"the 2-rank {name} CSV differs from the one-process CSV")
            check(not Path(f"{tmp}/rank1/{rel}").exists(), f"rank 1 wrote {rel}")
        rates[2] = res[0]["fps"]
        check(res[0]["devices"] == 2, "the 2-rank FER sweep did not run on 2 devices")
        k1 += sum(r["k1"] for r in res)
        k2 += sum(r["k2"] for r in res)

        res = launch_ranks(4, {
            "build_dir": None, "device": device,
            "runs": [["warm", "fer", [a.replace("{out}", f"{tmp}/w4_{{rank}}")
                                      for a in mp_fer_argv("{out}", 16384, 5.0, 5.0)]]],
            "timed": [a.replace("{out}", f"{tmp}/w4_{{rank}}") for a in timed],
        }, tmp)
        rates[4] = res[0]["fps"]
    smi = nvidia_smi_line() if dev.type == "cuda" else "no card"
    print(f"FER step (P(128,64) M=8, 8 retries, B=4096 over all ranks, 5.0 dB, "
          f"{MP_TIMED_FRAMES} frames) on {smi}, ranks on one card: "
          + ", ".join(f"{w} rank(s) {fps} frames/s" for w, fps in rates.items()))
    return k1, k2


# phase 12, the scalar surface: tests/test_fuzz_configs.py's shapes, (N, K,
# M, CRC, LLR scale, seed) and PAC (N, Kp, L, gen, CRC length, CRC poly,
# profile, seed), copied (this script imports nothing of the JAX package)
FUZZ_CONFIGS = [
    (16, 8, 2, "0x17", 2.0, 0), (16, 12, 4, "0x17", 4.0, 1), (32, 10, 1, None, 3.0, 2),
    (32, 24, 8, "0x17", 1.5, 3), (64, 40, 4, "0x1864CFB", 2.5, 4), (64, 13, 2, "0x17", 6.0, 5),
    (256, 140, 2, "0x17", 2.0, 6), (512, 280, 1, "0x1864CFB", 2.0, 7),
    (2048, 1024, 2, "0x1864CFB", 2.0, 8), (2048, 1024, 4, "0x1864CFB", 2.0, 9),
    (2048, 1024, 8, "0x1864CFB", 2.0, 10), (4096, 2048, 4, "0x1864CFB", 2.0, 11),
    (4096, 2048, 8, "0x1864CFB", 2.0, 12),
]
FUZZ_PAC_CONFIGS = [
    (16, 8, 2, (1, 1), 0, 0, "dega", 0), (32, 20, 4, (1, 0, 1, 1), 8, 0xA6, "pw", 1),
    (32, 12, 1, (1, 1, 0, 1), 0, 0, "bh", 2), (64, 40, 8, (1, 0, 1, 1, 0, 1, 1), 12, 0xC06, "rm-polar", 3),
]
SCALAR_FRAMES = 64  # frames of the scalar NMS, NR polar and PolarCode calls
SCALAR_BATCH = 4096  # frames of phase 12's P(128,64) list cases and fuzz shapes
FUZZ_WIDE_BATCH = 256  # of them, frames of the N=4096 fuzz shapes: the plain version's cost


def judge_list(out, ref, tag, tie_metrics=None):
    """Frames where K1's outputs differ from a reference's: under the plain
    `SCLResult` names, the bits, pass flags, candidates, validity and
    selected rank exactly, metrics and info LLRs within 1e-6 relative (+inf
    where the reference has it); only the fields `ref` holds.  Fails on a
    frame outside near-ties (`near_tie_frames` of the reference's metrics,
    or of `tie_metrics`) and on a list whose selected candidate is not the
    best path.  Returns (frames differing, of them near-ties, max |info LLR
    diff|)."""

    got = {f: v.cpu().numpy() for f, v in out.items()}
    B = got["best_path_bits"].shape[0]
    bad = np.zeros(B, bool)
    err = 0.0
    for f, want in ref.items():
        have = got[f].reshape(B, -1)
        want = np.asarray(want).reshape(B, -1)
        if f in ("metrics", "info_llrs", "best_path_info_llrs"):
            with np.errstate(invalid="ignore"):
                diff = np.abs(have.astype(np.float64) - want)
                ok = (have == want) | (diff <= 1e-6 * np.maximum(np.abs(want), 1e-30))
            if f != "metrics":
                err = max(err, float(diff.max()) if diff.size else 0.0)
        else:
            ok = have == want
        bad |= ~np.all(ok, axis=1)
    if "candidates" in got:
        pick = np.take_along_axis(got["candidates"], got["best_index"].astype(np.int64)[:, None, None],
                                  axis=1)[:, 0]
        check(np.array_equal(pick, got["best_path_bits"]), f"{tag}: K1's list does not hold its best path")
    ties = near_tie_frames(np.asarray(ref["metrics"] if tie_metrics is None else tie_metrics))
    unexplained = bad & ~ties
    if bad.any():
        print(f"  {tag}: {int(bad.sum())} frames differ, {int((bad & ties).sum())} of them near-ties")
    check(not unexplained.any(), f"K1's list differs ({tag}): frames {np.flatnonzero(unexplained)[:10].tolist()}")
    return int(bad.sum()), int((bad & ties).sum()), err


def plain_fields(res):
    return {f: getattr(res, f).cpu().numpy() for f in
            ("best_path_bits", "best_path_info_llrs", "crc_pass", "candidates", "metrics", "valid",
             "info_llrs", "best_index")}


def systematic_reference(pc, llr_rows, crc_on, crc1, L, dev):
    """What `PolarCode.pac_list_crc_decoder(issystematic=True)` returns for
    each row, from the plain PAC decoder in float32 on the card: every
    path's `v_full` re-encoded, the first valid path whose extracted bits
    pass the CRC, else the first path."""

    import torch

    from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch
    from polar_code_tpu_torch.ops.polar_transform import polar_transform

    res = pac_list_decode_batch(torch.from_numpy(np.asarray(llr_rows, np.float32)).to(dev),
                                pc.polarcode_mask, pc.gen, L, crc_len=crc1.len if crc_on else 0,
                                crc_poly=crc1.gen if crc_on else 0)
    coded = polar_transform(res["v_full"]).cpu().numpy()[:, :, np.asarray(pc.polarcode_mask) == 1]
    valid = res["valid"].cpu().numpy()
    out = []
    for cands, ok in zip(coded.astype(int), valid):
        pick = cands[0]
        if crc_on:
            pick = next((c for c, v in zip(cands, ok) if v and sum(crc1.crcCalc(c)) == 0), cands[0])
        out.append(pick)
    return np.stack(out)


PAC_LIST_FIELDS = ("extracted", "crc_pass", "v_full", "candidates", "metrics", "valid", "best_index")


def k3_list_vs_plain(x, mask, gen, L, crc_len, crc_poly, tag, out=None, ref=None):
    """K3's list launch (`pac_list_decode_cuda(..., full=True)`) against the
    plain version on the same card tensor, every field of the list held
    exactly (a dead path's +inf metric equal to +inf); either side may be
    given.  Returns max |diff| over the fields."""

    import torch

    from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch
    from polar_code_tpu_torch.legacy.pac_cuda import pac_list_decode_cuda

    if out is None:
        out = pac_list_decode_cuda(x, mask, gen, L, crc_len, crc_poly, full=True)
    if ref is None:
        ref = pac_list_decode_batch(x, mask, gen, L, crc_len=crc_len, crc_poly=crc_poly)
    torch.cuda.synchronize()
    err = 0.0
    for f in PAC_LIST_FIELDS:
        have, want = out[f].double().cpu().numpy(), ref[f].double().cpu().numpy()
        check(have.shape == want.shape, f"{tag}: K3's {f} is {have.shape}, the plain version's {want.shape}")
        with np.errstate(invalid="ignore"):
            diff = np.where(have == want, 0.0, np.abs(have - want))
        err = max(err, float(diff.max()) if diff.size else 0.0)
        check(np.array_equal(have, want), f"{tag}: K3's list {f} differs from the plain version in frames "
              f"{np.flatnonzero(np.any((have != want).reshape(len(have), -1), axis=1))[:10].tolist()}")
    return err


def k1_vs_plain(llr, info, M, crc, plan, tag, launch_b=None, keep=None, ref=None):
    """K1's list and best-only launches against the plain version on the
    same card tensors (`judge_list`): ((frames differing, near-ties, max
    |info LLR diff|) of the list, the same of best-only).  With `launch_b`,
    K1 runs the launch plan of a batch of launch_b frames on the frames
    given: a few frames of a large batch's launch.  A `keep` dict takes the
    plain version's fields and K1's list.  A `ref` (`plain_fields` of the
    plain version's call on these inputs) stands in for that call."""

    import torch

    from polar_code_tpu_torch.ops import scl_cuda
    from polar_code_tpu_torch.ops.scl import decode_scl_batch

    if launch_b is None:
        out = scl_cuda.decode_scl_cuda(llr, info, M, crc, force_info_bits=plan, full=True)
        best = scl_cuda.decode_scl_cuda(llr, info, M, crc, force_info_bits=plan)
    else:
        G, fpb, _ = scl_cuda.launch_plan(llr.shape[1], len(info), M, launch_b)
        info_np = np.asarray(info, np.int64)
        out = scl_cuda._launch(llr, info_np, M, crc, plan, G, fpb, full=True)
        best = scl_cuda._launch(llr, info_np, M, crc, plan, G, fpb)
    torch.cuda.synchronize()
    if ref is None:
        ref = plain_fields(decode_scl_batch(llr, info, M, crc, force_info_bits=plan, dtype=torch.float32))
    if keep is not None:
        keep.update(plain=ref, k1=out)
    res = judge_list(out, ref, tag)
    best_ref = {f: ref[f] for f in ("best_path_bits", "best_path_info_llrs", "crc_pass")}
    return res, judge_list(best, best_ref, tag + " best-only", ref["metrics"])


def scalar_surface(dev, smi):
    """Phase 12: K1's full-list output against the plain version and the JAX
    float32 metrics; the fuzz shapes through K1 and K3; the scalar entry
    points on the card against the golden reference vectors and the batch
    kernels, with the kernels' launch counts; their times.  Returns the
    kernels' launches of the scalar entry points' run (K1, K2, K3)."""

    import torch

    from polar_code_tpu_torch.dlscl.flip import decode_with_retries, retry_with_flip
    from polar_code_tpu_torch.eval.run_ber_sweep import _noise_var
    from polar_code_tpu_torch.legacy.crclib import crc as legacy_crc
    from polar_code_tpu_torch.legacy.pac import pac_decode, pac_list_decode_batch
    from polar_code_tpu_torch.legacy.pac_cuda import pac_list_decode_cuda
    from polar_code_tpu_torch.legacy.polar_code import PolarCode
    from polar_code_tpu_torch.legacy.rate_profile import rateprofile
    from polar_code_tpu_torch.nr.ldpc import decode_ldpc_nms, decode_ldpc_nms_batch
    from polar_code_tpu_torch.nr.ldpc.nms_cuda import decode_ldpc_nms_cuda
    from polar_code_tpu_torch.nr.polar.scl_nr import (decode_rate_matched_scl,
                                                      decode_rate_matched_scl_batch,
                                                      encode_rate_matched_batch)
    from polar_code_tpu_torch.ops.crc import check_crc
    from polar_code_tpu_torch.ops.sc import sc_decode
    from polar_code_tpu_torch.ops.scl import decode_scl_batch
    from polar_code_tpu_torch.ops.scl_cuda import decode_scl_cuda
    from polar_code_tpu_torch.polar.api import decode_scl
    from polar_code_tpu_torch.polar.construct import construct_info_set

    # ---- (a) K1's list output against the plain version ----
    rng = np.random.default_rng(20261021)
    info = construct_info_set(N, K)
    cases = [(N, K, M, crc, plan, SCALAR_BATCH, 5.0, "gaussian") for M in (1, 2, 4, 8)
             for crc in (CRC, None) for plan in (False, True)]
    cases += [(N, K, 8, CRC, True, 1001, 5.0, "gaussian"),
              (1024, 512, 8, CRC, False, 1024, 1.75, "gaussian_bitrev"),
              (2048, 1024, 8, CRC, True, 256, 1.5, "gaussian_bitrev")]
    ties = differ = 0
    max_err = 0.0
    for n_c, k_c, M, crc, use_plan, B, snr, method in cases:
        info_c = construct_info_set(n_c, k_c, method=method)
        llr_np, msg = make_llrs(rng, B, snr, info_c, n=n_c)
        plan = torch.from_numpy(random_plan(rng, msg)).to(dev) if use_plan else None
        tag = (f"list P({n_c},{k_c}) M={M} crc={'on' if crc else 'off'} plan={'on' if use_plan else 'off'} "
               f"{snr} dB B={B}")
        (d, t, e), _ = k1_vs_plain(torch.from_numpy(llr_np).to(dev), info_c, M, crc, plan, tag)
        differ, ties, max_err = differ + d, ties + t, max(max_err, e)
    print(f"K1 list vs plain: {len(cases)} cases, {differ} frames differ, all {ties} near-ties; "
          f"max |info LLR diff| {max_err:.3e}")

    # ---- (b) K1's list metrics against the JAX float32 decoder's ----
    differ = ties = 0
    with np.load(GOLDEN / "scl_f32_decode.npz") as gold:
        f32_cases = json.loads(str(gold["cases"]))
        for case in f32_cases:
            tag, code = case["name"], case["code"]
            x = torch.from_numpy(gold[f"{code}/llr"]).to(dev)
            plan = torch.from_numpy(gold[f"{code}/plan"]).to(dev) if case["plan"] else None
            out = decode_scl_cuda(x, gold[f"{code}/info"], case["M"], case["crc"], force_info_bits=plan,
                                  full=True)
            ref = {"best_path_bits": gold[f"{tag}/bits"], "best_path_info_llrs": gold[f"{tag}/llrs"],
                   "crc_pass": gold[f"{tag}/crc_pass"], "metrics": gold[f"{tag}/metrics"]}
            check(ref["metrics"].shape == tuple(out["metrics"].shape), f"{tag}: golden metrics shape")
            d, t, _ = judge_list(out, ref, f"list vs JAX f32 {tag}")
            differ, ties = differ + d, ties + t
    print(f"K1 list vs JAX float32: {len(f32_cases)} cases (metrics of all M paths), {differ} frames "
          f"differ, all {ties} near-ties")

    # ---- (c) the fuzz shapes through K1 and K3, B=4096 ----
    differ = ties = 0
    for n_c, k_c, M, crc, scale, seed in FUZZ_CONFIGS:
        info_c = construct_info_set(n_c, k_c)
        B = FUZZ_WIDE_BATCH if n_c > 2048 else SCALAR_BATCH  # the plain version's cost
        llr = torch.from_numpy(np.random.default_rng(seed).normal(0, scale, (SCALAR_BATCH, n_c))
                               .astype(np.float32)[:B]).to(dev)
        tag = f"fuzz N={n_c} K={k_c} M={M} crc={crc} B={B}"
        (d, t, _), (db, tb, _) = k1_vs_plain(llr, info_c, M, crc, None, tag)
        differ, ties = differ + d + db, ties + t + tb
        print(f"  {tag}: list and best-only equal to the plain version outside "
              f"{t + tb} near-tie frames", flush=True)
    for n_p, kp, L, gen, crc_len, crc_poly, profile, seed in FUZZ_PAC_CONFIGS:
        rp = rateprofile(n_p, kp, 2.0, 0)
        rp.build_mask(profile)
        mask = rp.modify_profile()
        x = torch.from_numpy(np.random.default_rng(seed).normal(0, 3, (SCALAR_BATCH, n_p))
                             .astype(np.float32)).to(dev)
        out = pac_list_decode_cuda(x, mask, gen, L, crc_len, crc_poly)
        ref = pac_list_decode_batch(x, mask, gen, L, crc_len=crc_len, crc_poly=crc_poly)
        torch.cuda.synchronize()
        bad = (torch.any(out["extracted"] != ref["extracted"], dim=1)
               | (out["crc_pass"] != ref["crc_pass"])).cpu().numpy()
        print(f"  fuzz PAC N={n_p} Kp={kp} L={L} {profile} B={SCALAR_BATCH}: {int(bad.sum())} frames differ")
        check(not bad.any(), f"K3 differs from the plain version at fuzz PAC N={n_p} Kp={kp} L={L}")
    print(f"fuzz shapes: {len(FUZZ_CONFIGS)} SCL shapes ({differ} frames differ, all {ties} near-ties) "
          f"and {len(FUZZ_PAC_CONFIGS)} PAC shapes, every frame identical")

    # ---- (d) the scalar entry points on the card ----
    golden = np.load(GOLDEN / "ref_p128_k64.npz")
    g_info = golden["info_set"]
    ira, (ira_bg, ira_H) = IRA, ldpc_code(IRA[1], IRA[2])
    nms_llr = ldpc_llrs(rng, (ira, (ira_bg, ira_H)), SCALAR_FRAMES, 2.5, dev)
    n_r, k_r, kp_r, e_r, m_r = NR_POLAR
    info_r = construct_info_set(n_r, k_r)
    payload = torch.from_numpy(rng.integers(0, 2, (SCALAR_FRAMES, kp_r)).astype(np.int8))
    tx = encode_rate_matched_batch(payload, CRC, n_r, e_r, info_r).numpy()
    nv = _noise_var(3.5, kp_r, e_r)
    nr_llr = ((1.0 - 2.0 * tx + rng.normal(0.0, math.sqrt(nv), tx.shape)) * (2.0 / nv)).astype(np.float32)
    crc16 = legacy_crc(*PAC_CRC)
    pc = {L: PolarCode(64, 48, "dega", L, rateprofile(64, 48, 2.0, 0)) for L in (1, 4)}
    msgs = rng.integers(0, 2, (SCALAR_FRAMES, 32)).astype(np.int8)
    msgs = np.concatenate([msgs, crc16.crcCalc_batch(msgs)], axis=1)
    codewords = np.stack([pc[1].encode(m, False) for m in msgs])
    nv = 1.0 / (2.0 * 0.5 * 10 ** 0.3)
    pc_llr = (2.0 * (1.0 - 2.0 * codewords + rng.normal(0.0, math.sqrt(nv), codewords.shape)) / nv
              ).astype(np.float32)

    # the systematic decoder and decode without early stop, on one frame each,
    # against the plain version on the card; float64 on the card raises
    got = pc[4].pac_list_crc_decoder(pc_llr[0], True, True, crc16, 4)
    want = systematic_reference(pc[4], pc_llr[:1], True, crc16, 4, dev)[0]
    check(np.array_equal(got, want), "PolarCode systematic decoder differs from the plain version")
    got = decode_ldpc_nms(nms_llr[0].cpu().numpy(), ira_H, early_stop=False)
    want = decode_ldpc_nms_batch(nms_llr[:1], ira_H, early_stop=False)
    check(np.array_equal(got["hard"], want["hard"][0].cpu().numpy())
          and got["iters_used"] == 20 == int(want["iters_used"][0])
          and got["parity_ok"] == bool(want["parity_ok"][0]),
          "decode_ldpc_nms(early_stop=False) differs from the plain version")
    print("  PolarCode(64, 48, dega, L=4) systematic CRC-16 and decode_ldpc_nms(early_stop=False) on "
          "the card: one frame each, equal to the plain version")
    try:
        decode_scl(golden["llrs"][0], g_info, 8, CRC, dtype=torch.float64)
    except ValueError as exc:
        print(f"  decode_scl(dtype=float64) on the card raises: {exc}")
    else:
        check(False, "decode_scl(dtype=float64) on the card did not raise")

    k1_before, k2_before = decode_scl_cuda.launches, decode_ldpc_nms_cuda.launches
    k3_before = pac_list_decode_cuda.launches
    decode_scl_batch.cuda_calls = decode_ldpc_nms_batch.cuda_calls = pac_list_decode_batch.cuda_calls = 0
    t = time.perf_counter()
    sc_bits = np.stack([sc_decode(llr, g_info) for llr in golden["llrs"]])
    scl = {M: [decode_scl(llr, g_info, M, CRC) for llr in golden["llrs"]] for M in (1, 8)}
    dl = [decode_with_retries(llr, g_info, 2, 4, crc=CRC) for llr in golden["llrs"]]
    flip_base = scl[8][0]["best_path_bits"]
    flip = retry_with_flip(golden["llrs"][0], g_info, 8, flip_base, 10, CRC)
    nms = {se: [decode_ldpc_nms(row, ira_H, self_exclude=se) for row in nms_llr.cpu().numpy()]
           for se in (False, True)}
    nr = [decode_rate_matched_scl(row, CRC, n_r, e_r, info_r, m_r) for row in nr_llr]
    pac = {L: [pc[L].pac_list_crc_decoder(row, False, True, crc16, L) for row in pc_llr] for L in (1, 4)}
    torch.cuda.synchronize()
    scalar_s = time.perf_counter() - t
    launches = (decode_scl_cuda.launches - k1_before, decode_ldpc_nms_cuda.launches - k2_before,
                pac_list_decode_cuda.launches - k3_before)
    plain = (decode_scl_batch.cuda_calls, decode_ldpc_nms_batch.cuda_calls,
             pac_list_decode_batch.cuda_calls)
    calls = (2 * len(golden["llrs"]) + sum(len(r["attempts"]) for r in dl) + 1 + SCALAR_FRAMES,
             2 * SCALAR_FRAMES, 2 * SCALAR_FRAMES)
    print(f"scalar entry points on the card: {scalar_s:.3f} s (host clock); K1/K2/K3 launches "
          f"{launches} for {calls} decodes; plain decoders on CUDA {plain}")
    check(launches == calls, f"the scalar entry points launched {launches}, not one a decode {calls}")
    check(plain == (0, 0, 0), f"a plain decoder ran on CUDA under the scalar entry points: {plain}")

    # the golden reference vectors
    check(np.array_equal(sc_bits, golden["sc_bits"]), "sc_decode on the card differs from the golden SC bits")
    for M in (1, 8):
        bits = np.stack([r["best_path_bits"] for r in scl[M]])
        check(np.array_equal(bits, golden[f"scl_m{M}_best"]), f"decode_scl M={M} differs from the golden bits")
        for b, r in enumerate(scl[M]):
            want = golden[f"scl_m{M}_metrics"][b]
            want = want[np.isfinite(want)]
            got = np.asarray(r["metrics"])
            check(got.shape == want.shape and np.all(np.abs(got - want) <= 1e-5 * np.abs(want)),
                  f"decode_scl M={M} frame {b} metrics {got} vs golden {want}")
    dl_bad = []
    for b, r in enumerate(dl):
        same = (np.array_equal(r["best_path_bits"], golden["dl_m2_best"][b])
                and r["success"] == bool(golden["dl_m2_success"][b])
                and len(r["attempts"]) - 1 == int(golden["dl_m2_attempts"][b]))
        if not same:
            metrics = [a["metrics"] for a in r["attempts"]]
            tie = any(near_tie_frames(np.asarray([m], np.float64))[0] for m in metrics if len(m) > 1)
            print(f"  DL-SCL frame {b} differs from the golden run; near-tie {tie}; its attempts' metrics "
                  f"{metrics}")
            check(tie, f"DL-SCL frame {b} differs from the golden run outside a near-tie")
            dl_bad.append(b)
    print(f"  golden P(128,64): sc_decode 12/12 frames, decode_scl M=1 and M=8 bits and metrics "
          f"(1e-5), decode_with_retries M=2 4 retries {12 - len(dl_bad)}/12 frames "
          f"(attempts {[len(r['attempts']) - 1 for r in dl]}, success {sum(r['success'] for r in dl)})")
    check(list(flip) == ["candidates", "metrics", "best_path_bits", "info_llrs", "best_path_info_llrs",
                         "forced_info_bits", "flip_index"], f"retry_with_flip keys {list(flip)}")
    for cand in flip["candidates"]:
        check(np.array_equal(cand[:10], flip_base[:10]) and cand[10] == 1 - flip_base[10],
              "retry_with_flip: a candidate does not honour the forced plan")
    print(f"  retry_with_flip M=8 at index 10: {len(flip['candidates'])} candidates honour the plan, "
          f"crc {'passes' if check_crc(flip['best_path_bits'], CRC) else 'fails'}")

    # the scalar entry points against the batch kernels on the same frames
    for se in (False, True):
        ref = decode_ldpc_nms_cuda(nms_llr, ira_bg, IRA[2], self_exclude=se)
        for f in ("hard", "iters_used", "parity_ok"):
            got = np.asarray([r[f] for r in nms[se]])
            check(np.array_equal(got, ref[f].cpu().numpy()), f"decode_ldpc_nms {f} differs from K2's batch "
                  f"({'two-min' if se else 'shared'})")
        print(f"  decode_ldpc_nms QC-IRA 4x8 Z=31 {'two-min' if se else 'shared'} 2.5 dB: {SCALAR_FRAMES} "
              f"frames equal to K2's batch; parity {sum(r['parity_ok'] for r in nms[se])}, "
              f"iterations {sum(r['iters_used'] for r in nms[se])}")
    ref = decode_rate_matched_scl_batch(torch.from_numpy(nr_llr).to(dev), CRC, n_r, e_r, info_r, m_r)
    for f in ("payload", "best_path_bits", "crc_pass"):
        got = np.asarray([r[f] for r in nr])
        check(np.array_equal(got, ref[f].cpu().numpy()), f"decode_rate_matched_scl {f} differs from the batch")
    print(f"  decode_rate_matched_scl N={n_r} K={k_r} E={e_r} M={m_r} 3.5 dB: {SCALAR_FRAMES} frames equal "
          f"to the batch; crc pass {sum(r['crc_pass'] for r in nr)}")
    for L in (1, 4):
        ref = pac_decode(torch.from_numpy(pc_llr).to(dev), pc[L].polarcode_mask, [1], L,
                         crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])["extracted"].cpu().numpy()
        got = np.stack(pac[L])
        check(np.array_equal(got, ref), f"PolarCode L={L} differs from pac_decode on the batch")
        print(f"  PolarCode(64, 48, dega, L={L}) CRC-16 3.0 dB: {SCALAR_FRAMES} frames equal to pac_decode "
              f"on the batch; {int(np.all(got == msgs, axis=1).sum())} decoded the sent message")

    # ---- (e) times ----
    llr0 = golden["llrs"][0]
    decode_scl(llr0, g_info, 8, CRC)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        decode_scl(llr0, g_info, 8, CRC)
    per_call_ms = (time.perf_counter() - t) / 200 * 1e3
    llr_np, _ = make_llrs(np.random.default_rng(5), 4096, 5.0, info)
    llr = torch.from_numpy(llr_np).to(dev)
    best_ms = cuda_time_ms(lambda: decode_scl_cuda(llr, info, 8, CRC), reps=50)
    list_ms = cuda_time_ms(lambda: decode_scl_cuda(llr, info, 8, CRC, full=True), reps=50)
    best2_ms = cuda_time_ms(lambda: decode_scl_cuda(llr, info, 8, CRC), reps=50)
    print(f"scalar times on {smi}:")
    print(f"  decode_scl P(128,64) M=8 CRC, one frame: {per_call_ms:.4f} ms a call (200 calls, host clock)")
    print(f"  K1 B=4096 M=8 CRC: best-only {best_ms:.4f} / {best2_ms:.4f} ms, full list {list_ms:.4f} ms "
          f"(50 launches each, CUDA events)")
    return launches


# phase 13, the wide envelope: K1's by-path instantiation (the list sizes up
# to 32 outside {1, 2, 4, 8}; phase 14 has 33..1024) and N up to 8192, K3's
# list output and K2 without early stop
WIDE_MS = (3, 16, 32)  # (a): P(128,64) list sizes, B=1001 (ragged)
WIDE_B = 1001
WIDE_N = [(4096, 2048, M) for M in (1, 4, 8, 16)] + [(8192, 4096, M) for M in (1, 4, 8, 16, 32)]  # (b)
WIDE_N_FRAMES = 32  # (b): the plain version takes seconds a batch at N=8192
# (b): by path at N=8192 with K·M trace bytes past a block (the trace indices
# in global scratch take them), a few frames each
WIDE_N_TRACE = ((8192, 8000, 32), (8192, 8192, 29))
WIDE_N_TRACE_FRAMES = 4
# (d): list size: its two Eb/N0 points (dB), where the SCL FER is about 1e-1
# to 1e-2; tests/golden/fer_wide/fer_M{M}.csv, 40960 frames a point
WIDE_FER = {16: (4.0, 4.5), 32: (3.5, 4.0)}
WIDE_FER_FRAMES = 40960
SYSTEMATIC_LS = (1, 4, 32)  # (e): PolarCode(64, 48, "dega", L), systematic
WIDE_TIME_B = (4096, 1024)  # (f): frames of the P(128,64), PAC and LDPC times; of N 4096 and 8192
# (f): K1 by path, (N, K, construction, Eb/N0 dB, M, B, timed launches): a
# FER step's baseline (B=4096), a retry batch (B=400) and a scalar call
# (B=1) at P(128,64), and P(1024,512) and P(8192,4096) at B=1024;
# `tools/time_path_lists.py` times the same shapes
PATH_TIMES = ([(N, K, "gaussian", 5.0, M, B, reps) for B, reps in ((4096, 10), (400, 20), (1, 20))
               for M in WIDE_MS]
              + [(1024, 512, "gaussian_bitrev", 1.75, 16, 1024, 3),
                 (8192, 4096, "gaussian_bitrev", 1.5, 32, 1024, 2)])
PATH_CHECK_FRAMES = 8  # (f): frames of P(8192,4096) held to the plain version at the B=1024 plan


def path_inputs(dev):
    """PATH_TIMES' inputs, from numpy (seed 5): {(N, K): (info set, LLRs of
    the most frames a shape of that code takes, on `dev`)}."""

    import torch

    from polar_code_tpu_torch.polar.construct import construct_info_set

    rng = np.random.default_rng(5)
    inputs = {}
    for n, k, method, snr, _, _, _ in PATH_TIMES:
        if (n, k) not in inputs:
            info = construct_info_set(n, k, method=method)
            b_max = max(t[5] for t in PATH_TIMES if t[:2] == (n, k))
            inputs[n, k] = info, torch.from_numpy(make_llrs(rng, b_max, snr, info, n=n)[0]).to(dev)
    return inputs


def time_by_path(dev, plan_of, label="", sweep=False):
    """K1 by path at PATH_TIMES with CUDA events (`path_inputs`):
    prints a line a shape — its time, its bound, the launch plan `plan_of(N,
    K, M, B)` gives (tree levels in global scratch G, frames a block, frames
    an SM) — and with `sweep` the shapes of B > 1 at every other G within two
    of the plan's (`scl_cuda._launch`).  Returns {tag: (ms, bound ms, bound
    by, plan)}, and the tag of each G sweep point with its ms."""

    from polar_code_tpu_torch.ops import scl_cuda

    inputs, out = path_inputs(dev), {}
    for n, k, method, snr, M, B, reps in PATH_TIMES:
        info, llr = inputs[n, k]
        x = llr[:B]
        tag = f"K1 P({n},{k}) M={M} B={B}"
        plan = plan_of(n, k, M, B)
        fn = lambda: scl_cuda.decode_scl_cuda(x, info, M, CRC)  # noqa: E731
        fn()  # builds the kernel at its first call
        ms = cuda_time_ms(fn, reps=reps, warmup=1)
        b_ms, b_by = bound(*scl_work(info, M, B, n=n, k=k))
        out[tag] = (ms, b_ms, b_by, plan)
        print(f"  {label}{tag} CRC {snr} dB (by path, LM={scl_cuda.path_width(M)}): {ms:.4f} ms "
              f"({reps} launches); bound {b_ms:.6f} ms ({b_by}), {ms / b_ms:.0f}x; G={plan[0]}, "
              f"{plan[1]} frames a block, {plan[2]} frames an SM", flush=True)
        if sweep and B > 1:
            info_np = np.asarray(info, np.int64)
            for g in range(max(0, plan[0] - 2), min(int(math.log2(n)) - 1, plan[0] + 2) + 1):
                g_fpb, g_per_sm = scl_cuda._occupancy(n, k, M, g)
                if g == plan[0] or g_per_sm == 0:
                    continue
                fn = lambda g=g, f=g_fpb: scl_cuda._launch(x, info_np, M, CRC, None, g, f)  # noqa: E731
                g_ms = cuda_time_ms(fn, reps=reps, warmup=1)
                out[f"{tag} G={g}"] = g_ms
                print(f"  {label}  {tag} at G={g}: {g_ms:.4f} ms; {g_fpb} frames a block, {g_per_sm} "
                      f"frames an SM", flush=True)
    return out


def wide_envelope(dev, smi):
    """Phase 13: K1's by-path instantiation and N up to 8192 against the
    plain version and the JAX float32 golden file, the FER CLI at M 16 and
    32 against the JAX CSVs, the scalar calls that reach the new
    instantiations, and their times.  Returns the `kernels` entries of the
    three new instantiations."""

    import torch

    from polar_code_tpu_torch import _build
    from polar_code_tpu_torch.eval import run_fer_sweep
    from polar_code_tpu_torch.legacy.crclib import crc as legacy_crc
    from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch
    from polar_code_tpu_torch.legacy.pac_cuda import pac_list_decode_cuda
    from polar_code_tpu_torch.legacy.polar_code import PolarCode
    from polar_code_tpu_torch.legacy.rate_profile import rateprofile
    from polar_code_tpu_torch.nr.ldpc import decode_ldpc_nms, decode_ldpc_nms_batch
    from polar_code_tpu_torch.nr.ldpc.nms_cuda import decode_ldpc_nms_cuda
    from polar_code_tpu_torch.ops import scl_cuda
    from polar_code_tpu_torch.ops.scl import decode_scl_batch
    from polar_code_tpu_torch.polar.api import decode_scl
    from polar_code_tpu_torch.polar.construct import construct_info_set

    decode_scl_cuda = scl_cuda.decode_scl_cuda
    wrappers = (decode_scl_cuda, decode_ldpc_nms_cuda, pac_list_decode_cuda)
    plains = (decode_scl_batch, decode_ldpc_nms_batch, pac_list_decode_batch)

    def reset_counts():
        for f in wrappers:
            f.launches = 0
        decode_scl_cuda.path_launches = pac_list_decode_cuda.list_launches = 0
        decode_ldpc_nms_cuda.no_stop_launches = 0
        for f in plains:
            f.cuda_calls = 0

    def new_counts():  # launches of the by-path K1, list K3 and no-stop K2
        return (decode_scl_cuda.path_launches, decode_ldpc_nms_cuda.no_stop_launches,
                pac_list_decode_cuda.list_launches)

    for row in ptxas_report(_build.build(scl_cuda.SOURCE).log):  # built in phase 2: the kept log
        if "scl_path_kernel" in row["entry"]:
            print(f"  ptxas {row['entry']}: {row['regs']} registers, spills {row['spill_stores']} B "
                  f"stores / {row['spill_loads']} B loads")
            check(not row["spill_stores"], f"{row['entry']} spills {row['spill_stores']} B")
    for n_s, k_s, M in [(N, K, M) for M in WIDE_MS] + [(1024, 512, 16)] + WIDE_N + list(WIDE_N_TRACE):
        g, fpb, per_sm = scl_cuda.launch_plan(n_s, k_s, M, 4096)
        fb = scl_cuda.frame_bytes(n_s, k_s, M, g)
        kind = "by path, LM=" + str(scl_cuda.path_width(M)) if scl_cuda.path_layout(M) else "byte words"
        print(f"  K1 N={n_s} K={k_s} M={M} ({kind}) at B=4096: levels 1..{g} in global scratch; {fb} B "
              f"shared a frame x {fpb} frames a block; {per_sm} resident frames an SM (occupancy "
              f"calculator)")
        check(per_sm >= 1, f"K1 cannot place a frame of N={n_s} M={M}")

    # ---- (a) the by-path instantiation against the plain version ----
    rng = np.random.default_rng(20261105)
    info = construct_info_set(N, K)
    cases = [(N, K, M, crc, plan, WIDE_B, 2.5, "gaussian") for M in WIDE_MS for crc in (CRC, None)
             for plan in (False, True)]
    cases.append((1024, 512, 16, CRC, False, 256, 1.75, "gaussian_bitrev"))
    differ = ties = 0
    max_err = 0.0

    def against_plain(case_list, label):
        nonlocal differ, ties, max_err
        for n_c, k_c, M, crc, use_plan, B, snr, method in case_list:
            info_c = construct_info_set(n_c, k_c, method=method)
            llr_np, msg = make_llrs(rng, B, snr, info_c, n=n_c)
            plan = torch.from_numpy(random_plan(rng, msg)).to(dev) if use_plan else None
            tag = (f"{label} P({n_c},{k_c}) M={M} crc={'on' if crc else 'off'} "
                   f"plan={'on' if use_plan else 'off'} {snr} dB B={B}")
            (d, t, e), (db, tb, eb) = k1_vs_plain(torch.from_numpy(llr_np).to(dev), info_c, M, crc, plan,
                                                   tag)
            differ, ties, max_err = differ + d + db, ties + t + tb, max(max_err, e, eb)
            print(f"  {tag}: list and best-only equal to the plain version outside {t + tb} "
                  f"near-tie frames", flush=True)

    against_plain(cases, "(a)")
    print(f"(a) K1 by path vs plain: {len(cases)} cases, list and best-only, {differ} frames differ, all "
          f"{ties} near-ties; max |info LLR diff| {max_err:.3e}")

    # ---- (b) N 4096 and 8192 against the plain version ----
    differ = ties = 0
    against_plain([(n_c, k_c, M, CRC, False, WIDE_N_FRAMES, 1.5, "gaussian_bitrev")
                   for n_c, k_c, M in WIDE_N]
                  + [(n_c, k_c, M, CRC, False, WIDE_N_TRACE_FRAMES, 1.5, "gaussian_bitrev")
                     for n_c, k_c, M in WIDE_N_TRACE], "(b)")
    print(f"(b) K1 at N 4096 and 8192 vs plain: {len(WIDE_N) + len(WIDE_N_TRACE)} shapes, {differ} "
          f"frames differ, all {ties} near-ties")

    # ---- (c) against the JAX float32 XLA decoder ----
    differ = ties = 0
    with np.load(GOLDEN / "scl_f32_wide.npz") as gold:
        wide_cases = json.loads(str(gold["cases"]))
        for case in wide_cases:
            tag, code = case["name"], case["code"]
            x = torch.from_numpy(gold[f"{code}/llr"]).to(dev)
            plan = torch.from_numpy(gold[f"{code}/plan"]).to(dev) if case["plan"] else None
            out = decode_scl_cuda(x, gold[f"{code}/info"], case["M"], case["crc"], force_info_bits=plan,
                                  full=True)
            ref = {"best_path_bits": gold[f"{tag}/bits"], "best_path_info_llrs": gold[f"{tag}/llrs"],
                   "crc_pass": gold[f"{tag}/crc_pass"], "metrics": gold[f"{tag}/metrics"]}
            check(ref["metrics"].shape == tuple(out["metrics"].shape), f"{tag}: golden metrics shape")
            d, t, _ = judge_list(out, ref, f"(c) vs JAX f32 {tag}")
            differ, ties = differ + d, ties + t
            print(f"  (c) {tag} B={x.shape[0]}: {d} frames differ from JAX float32 ({t} near-ties); "
                  f"crc pass {int(ref['crc_pass'].sum())}", flush=True)
    print(f"(c) K1 vs JAX float32: {len(wide_cases)} cases (bits, info LLRs, metrics of all M paths), "
          f"{differ} frames differ, all {ties} near-ties")

    # ---- (d) the FER CLI at M 16 and 32 against the JAX CSVs ----
    path_launches = 0
    for M, (snr_lo, snr_hi) in WIDE_FER.items():
        ref = jax_fer_rows(GOLDEN / "fer_wide" / f"fer_M{M}.csv", WIDE_FER_FRAMES)
        reset_counts()
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
            rows = run_fer_sweep.main([
                "--M", str(M), "--snr_lo", str(snr_lo), "--snr_hi", str(snr_hi), "--snr_step", "0.5",
                "--retries", "8", "--beta", str(REPO / "checkpoints" / "beta_M8.npy"),
                "--batch", "4096", "--frames", str(WIDE_FER_FRAMES), "--seed", "0",
                "--out_dir", f"{tmp}/results", "--plot_dir", f"{tmp}/plots"])
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches, plain = decode_scl_cuda.launches, sum(f.cuda_calls for f in plains)
        path_launches += decode_scl_cuda.path_launches
        steps = len(rows) * math.ceil(WIDE_FER_FRAMES / 4096)
        print(f"(d) FER CLI P(128,64) M={M}: {launches} K1 launches ({decode_scl_cuda.path_launches} by "
              f"path) over {steps} FER steps, plain decoders on CUDA {plain} times, "
              f"{len(rows) * WIDE_FER_FRAMES / secs:.0f} frames/s")
        check(launches >= steps and decode_scl_cuda.path_launches == launches,
              f"the M={M} FER sweep did not go through K1's by-path instantiation")
        check(plain == 0, f"a plain decoder ran on CUDA in the M={M} FER sweep")
        check(len(rows) == len(ref), f"the M={M} FER sweep gave {len(rows)} points")
        for row in rows:
            for key in ("fer_scl", "fer_dl"):
                p1, p2 = row[key], ref[row["snr_db"]][key]
                check(math.isfinite(p1) and 0.0 < p1 < 1.0, f"M={M} {key} at {row['snr_db']} dB is {p1}")
                z = fer_z(p1, WIDE_FER_FRAMES, p2, WIDE_FER_FRAMES)
                print(f"  M={M} {row['snr_db']} dB {key}: port {p1:.6e} vs JAX {p2:.6e} "
                      f"({WIDE_FER_FRAMES} frames each): z = {z:+.3f}")
                check(abs(z) < 3.0, f"M={M} {key} at {row['snr_db']} dB is off the JAX sweep (z={z:.2f})")

    # ---- (e) the scalar calls that reach the new instantiations ----
    pac_err, nms_err = 0.0, 0  # max |diff| of K3's list and K2 without early stop against the plain version
    golden = np.load(GOLDEN / "ref_p128_k64.npz")
    g_info = golden["info_set"]
    crc16 = legacy_crc(*PAC_CRC)
    systematic = {}
    for L in SYSTEMATIC_LS:
        pc = PolarCode(64, 48, "dega", L, rateprofile(64, 48, 2.0, 0))
        for crc_on in (True, False):
            msgs = rng.integers(0, 2, (SCALAR_FRAMES, 32 if crc_on else 48)).astype(np.int8)
            if crc_on:
                msgs = np.concatenate([msgs, crc16.crcCalc_batch(msgs)], axis=1)
            codewords = np.stack([pc.encode(m, True) for m in msgs])
            nv = 1.0 / (2.0 * 0.5 * 10 ** 0.3)
            llr = (2.0 * (1.0 - 2.0 * codewords + rng.normal(0.0, math.sqrt(nv), codewords.shape)) / nv
                   ).astype(np.float32)
            systematic[L, crc_on] = (pc, msgs, llr)
    ira_bg, ira_H = ldpc_code(IRA[1], IRA[2])
    nms_llr = ldpc_llrs(rng, (IRA, (ira_bg, ira_H)), SCALAR_FRAMES, 2.5, dev)
    reset_counts()
    scl16 = [decode_scl(llr, g_info, 16, CRC) for llr in golden["llrs"]]
    sys_out = {key: np.stack([pc.pac_list_crc_decoder(row, True, key[1], crc16, key[0]) for row in llr])
               for key, (pc, _, llr) in systematic.items()}
    nms_out = {se: [decode_ldpc_nms(row, ira_H, early_stop=False, self_exclude=se)
                    for row in nms_llr.cpu().numpy()] for se in (False, True)}
    torch.cuda.synchronize()
    scalar_launches = tuple(f.launches for f in wrappers)
    scalar_new = new_counts()
    plain = tuple(f.cuda_calls for f in plains)
    calls = (len(scl16), 2 * SCALAR_FRAMES, len(systematic) * SCALAR_FRAMES)
    print(f"(e) scalar calls: K1/K2/K3 launches {scalar_launches} (by path / no early stop / list "
          f"{scalar_new}) for {calls} decodes; plain decoders on CUDA {plain}")
    check(scalar_launches == calls == scalar_new,
          f"the scalar calls launched {scalar_launches} ({scalar_new} new), not one a decode {calls}")
    check(plain == (0, 0, 0), f"a plain decoder ran on CUDA under the scalar calls: {plain}")
    ref = decode_scl_batch(torch.from_numpy(golden["llrs"].astype(np.float32)).to(dev), g_info, 16, CRC,
                           dtype=torch.float32)
    want = plain_fields(ref)
    got = {"best_path_bits": torch.from_numpy(np.stack([r["best_path_bits"] for r in scl16]))}
    d, t, _ = judge_list(got, {"best_path_bits": want["best_path_bits"]}, "(e) decode_scl M=16",
                         want["metrics"])
    near = near_tie_frames(want["metrics"])
    for b, r in enumerate(scl16):  # the valid paths' metrics, in the final order, outside near-ties
        have, ok = np.asarray(r["metrics"]), want["valid"][b]
        check(near[b] or have.shape == (int(ok.sum()),)
              and np.all(np.abs(have - want["metrics"][b][ok]) <= 1e-6 * np.abs(have)),
              f"decode_scl M=16 frame {b} metrics differ from the plain version")
    print(f"  decode_scl P(128,64) M=16 CRC on the 12 golden frames: {d} frames differ from the plain "
          f"version ({t} near-ties)")
    for (L, crc_on), (pc, msgs, llr) in systematic.items():
        want = systematic_reference(pc, llr, crc_on, crc16, L, dev)
        got = sys_out[L, crc_on]
        check(np.array_equal(got, want), f"systematic PolarCode L={L} crc={crc_on} differs from the plain "
              f"version")
        print(f"  PolarCode(64, 48, dega, L={L}) systematic, CRC-16 {'on' if crc_on else 'off'}, 3.0 dB: "
              f"{SCALAR_FRAMES} frames equal to the plain version; {int(np.all(got == msgs, axis=1).sum())} "
              f"decoded the sent message")
        # the list the systematic decoder reads, every field, on the same frames
        crc_args = (crc16.len, crc16.gen) if crc_on else (0, 0)
        e = k3_list_vs_plain(torch.from_numpy(llr).to(dev), pc.polarcode_mask, pc.gen, L, *crc_args,
                             f"(e) K3 list L={L} crc={crc_on}")
        pac_err = max(pac_err, e)
        print(f"  K3 list at PolarCode(64, 48, dega, L={L}), CRC-16 {'on' if crc_on else 'off'}: "
              f"{', '.join(PAC_LIST_FIELDS)} of {SCALAR_FRAMES} frames equal to the plain version "
              f"(max |diff| {e})")
    for se in (False, True):
        ref = decode_ldpc_nms_batch(nms_llr, ira_H, early_stop=False, self_exclude=se)
        for f in ("hard", "iters_used", "parity_ok"):
            got = np.asarray([r[f] for r in nms_out[se]]).astype(np.int64)
            want = ref[f].cpu().numpy().astype(np.int64)
            nms_err = max(nms_err, int(np.abs(got - want).max()))
            check(np.array_equal(got, want), f"decode_ldpc_nms(early_stop=False) {f} "
                  f"differs from the plain version ({'two-min' if se else 'shared'})")
        print(f"  decode_ldpc_nms(early_stop=False) QC-IRA 4x8 Z=31 {'two-min' if se else 'shared'} 2.5 dB: "
              f"{SCALAR_FRAMES} frames equal to the plain version, 20 iterations each; parity "
              f"{sum(r['parity_ok'] for r in nms_out[se])}")

    # ---- (f) times with CUDA events ----
    print(f"wide-envelope times on {smi}:")
    B, B_wide = WIDE_TIME_B
    llr_np, _ = make_llrs(np.random.default_rng(5), B, 5.0, info)
    llr = torch.from_numpy(llr_np).to(dev)
    entries = {}
    ms = cuda_time_ms(lambda: decode_scl_cuda(llr, info, 8, CRC), reps=20)  # the byte words beside
    print(f"  K1 P(128,64) M=8 CRC B={B} 5.0 dB (byte words): {ms:.4f} ms; bound "
          f"{bound(*scl_work(info, 8, B))[0]:.6f} ms")
    path_times = time_by_path(dev, scl_cuda.launch_plan)
    # the same inputs at the plans those batches run (the FER CLI's B=4096
    # launches among them) against the plain version; P(8192,4096) on a few
    # frames at the B=1024 plan
    differ = ties = 0
    for (n_c, k_c), (info_c, x) in path_inputs(dev).items():
        for M, B_t in sorted({t[4:6] for t in PATH_TIMES if t[:2] == (n_c, k_c)}):
            frames = min(B_t, PATH_CHECK_FRAMES) if n_c == 8192 else B_t
            tag = f"(f) K1 P({n_c},{k_c}) M={M} at the B={B_t} plan {scl_cuda.launch_plan(n_c, k_c, M, B_t)}"
            (d, t, e), (db, tb, eb) = k1_vs_plain(x[:frames], info_c, M, CRC, None, tag, launch_b=B_t)
            differ, ties, max_err = differ + d + db, ties + t + tb, max(max_err, e, eb)
            print(f"  {tag}, {frames} frames: list and best-only equal to the plain version outside "
                  f"{t + tb} near-tie frames", flush=True)
    print(f"(f) K1 by path at the timed plans vs plain: {differ} frames differ, all {ties} near-ties")
    ms, b_ms, b_by, _ = path_times[f"K1 P(128,64) M=32 B={B}"]
    plain_ms = cuda_time_ms(lambda: decode_scl_batch(llr, info, 32, CRC, dtype=torch.float32), reps=3,
                            warmup=1)
    entries["scl_path"] = (ms, plain_ms, b_ms, b_by)
    print(f"  K1 P(128,64) M=32 CRC B={B} 5.0 dB: plain {plain_ms:.4f} ms")
    for n_c, k_c in ((4096, 2048), (8192, 4096)):
        info_c = construct_info_set(n_c, k_c, method="gaussian_bitrev")
        x = torch.from_numpy(make_llrs(rng, B_wide, 1.5, info_c, n=n_c)[0]).to(dev)
        ms = cuda_time_ms(lambda: decode_scl_cuda(x, info_c, 4, CRC), reps=5, warmup=1)
        plain_ms = cuda_time_ms(lambda: decode_scl_batch(x, info_c, 4, CRC, dtype=torch.float32),
                                reps=1, warmup=0)
        b_ms, b_by = bound(*scl_work(info_c, 4, B_wide, n=n_c, k=k_c))
        print(f"  K1 P({n_c},{k_c}) M=4 CRC B={B_wide} 1.5 dB: {ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
              f"{b_ms:.6f} ms ({b_by})")
    n_p, k_p, crc_p = PAC_CODES[128]
    p_mask = pac_mask(n_p, k_p + crc_p[0])
    x = pac_llrs(rng, B, 2.5, PAC_CODES[128], PAC_GEN, p_mask, dev)
    best_ms = cuda_time_ms(lambda: pac_list_decode_cuda(x, p_mask, PAC_GEN, 8, *crc_p), reps=20)
    list_ms = cuda_time_ms(lambda: pac_list_decode_cuda(x, p_mask, PAC_GEN, 8, *crc_p, full=True), reps=20)
    best2_ms = cuda_time_ms(lambda: pac_list_decode_cuda(x, p_mask, PAC_GEN, 8, *crc_p), reps=20)
    plain_ms = cuda_time_ms(lambda: pac_list_decode_batch(x, p_mask, PAC_GEN, 8, crc_len=crc_p[0],
                                                          crc_poly=crc_p[1]), reps=3, warmup=1)
    e = k3_list_vs_plain(x, p_mask, PAC_GEN, 8, *crc_p, f"(f) K3 list PAC(128,64) L=8 B={B}")
    pac_err = max(pac_err, e)
    print(f"  K3 list PAC(128,64)+CRC-16 L=8 B={B} 2.5 dB: {', '.join(PAC_LIST_FIELDS)} equal to the plain "
          f"version (max |diff| {e})")
    nbytes, nops = pac_work(p_mask, 8, B)
    kp = int(p_mask.sum())
    b_ms, b_by = bound(nbytes + B * 8 * (n_p + kp + 4) + B * 4, nops)  # the list outputs too
    entries["pac_list"] = (list_ms, plain_ms, b_ms, b_by)
    print(f"  K3 PAC(128,64)+CRC-16 L=8 B={B} 2.5 dB: full list {list_ms:.4f} ms beside best-only "
          f"{best_ms:.4f} / {best2_ms:.4f} ms ({list_ms / min(best_ms, best2_ms):.3f}x); plain {plain_ms:.4f} "
          f"ms; bound {b_ms:.6f} ms ({b_by})")
    x = ldpc_llrs(rng, (IRA, (ira_bg, ira_H)), B, 2.5, dev)
    stop_ms = cuda_time_ms(lambda: decode_ldpc_nms_cuda(x, ira_bg, IRA[2], self_exclude=True), reps=20)
    full_ms = cuda_time_ms(lambda: decode_ldpc_nms_cuda(x, ira_bg, IRA[2], early_stop=False,
                                                        self_exclude=True), reps=20)
    stop2_ms = cuda_time_ms(lambda: decode_ldpc_nms_cuda(x, ira_bg, IRA[2], self_exclude=True), reps=20)
    plain_ms = cuda_time_ms(lambda: decode_ldpc_nms_batch(x, ira_H, early_stop=False, self_exclude=True),
                            reps=3, warmup=1)
    got = decode_ldpc_nms_cuda(x, ira_bg, IRA[2], early_stop=False, self_exclude=True)
    ref = decode_ldpc_nms_batch(x, ira_H, early_stop=False, self_exclude=True)
    for f in ("hard", "iters_used", "parity_ok"):
        d = int((got[f].long() - ref[f].long()).abs().max())
        nms_err = max(nms_err, d)
        check(d == 0, f"K2 without early stop at B={B}: {f} differs from the plain version")
    print(f"  K2 QC-IRA 4x8 Z=31 two-min B={B} 2.5 dB without early stop: hard bits, iterations and parity "
          f"equal to the plain version (max |diff| {nms_err})")
    iters = torch.full((B,), 20, dtype=torch.int32)
    b_ms, b_by = bound(*nms_work(iters, ira_H.shape[1], int((ira_bg.shifts >= 0).sum()) * IRA[2],
                                 ira_H.shape[0], True))
    entries["nms_no_stop"] = (full_ms, plain_ms, b_ms, b_by)
    print(f"  K2 QC-IRA 4x8 Z=31 two-min B={B} 2.5 dB: 20 iterations without early stop {full_ms:.4f} ms "
          f"beside early stop {stop_ms:.4f} / {stop2_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
          f"{b_ms:.6f} ms ({b_by})")

    launches = {"scl_path": path_launches + scalar_new[0], "nms_no_stop": scalar_new[1],
                "pac_list": scalar_new[2]}
    errors = {"scl_path": max_err, "nms_no_stop": float(nms_err), "pac_list": pac_err}
    names = {"scl_path": ("scl_decode (by path: M 1-32 outside 1/2/4/8)",
                          "polar_code_tpu_torch/csrc/scl_decode.cu", "polar_code_tpu/ops/scl_pallas.py:293"),
             "nms_no_stop": ("nms_decode (without early stop)", "polar_code_tpu_torch/csrc/nms_decode.cu",
                             "polar_code_tpu/nr/ldpc/nms_pallas.py:31"),
             "pac_list": ("pac_decode (full list)", "polar_code_tpu_torch/csrc/pac_decode.cu",
                          "polar_code_tpu/legacy/pac_pallas.py:59")}
    return [{"name": names[k][0], "route": "cuda", "source": names[k][1], "replaces": names[k][2],
             "launches": launches[k], "max_abs_err": errors[k], "ms": entries[k][0], "plain_ms": entries[k][1],
             "bound_ms": entries[k][2], "bound_by": entries[k][3], "library_ms": None}
            for k in ("scl_path", "pac_list", "nms_no_stop")]


# phase 14, the deep lists: K1 and K3 at list sizes 33..1024 (their
# over-warps instantiations, a frame spread over the warps of a block) and
# K3 at N up to 8192
DEEP_MS = (33, 64, 100, 256, 1024)  # (a): P(128,64) list sizes; 33 and 100 sort pads
DEEP_B = 37  # frames of a vs-plain case: ragged, and the plain version costs seconds at M=1024
# (a): P(32,28), four payload bits beside CRC-24A, and P(1024,512), with
# 16-bit trace entries at M=256
DEEP_N = ((32, 28, 64), (1024, 512, 64), (1024, 512, 256))
DEEP_N_B = 13
DEEP_LS = (64, 256, 1024)  # (b): PAC(128,64)+CRC-16 list sizes; and PAC(32,12)+CRC-16 at L=64
DEEP_PAC_SMALL = (32, 12, 64)
DEEP_PAC_N = ((2048, 1024, 32), (8192, 4096, 8))  # (b): K3 at N above 1024, one path a lane
DEEP_PAC_N_B = 6  # the plain version takes seconds a batch at N=8192
# (d): list size and its two Eb/N0 points (dB), where the SCL FER is about
# 1e-1 to 1e-2; tests/golden/fer_deep/fer_M64.csv, 40960 frames a point
DEEP_FER = (64, (3.0, 3.5))
DEEP_FER_FRAMES = 40960
DEEP_SIM_LIST_MAX = 256  # (e): the legacy simulator's stage-2 list size
DEEP_SCALAR = (64, 256, 32)  # (f): decode_scl's M, PolarCode's L, frames a PolarCode decoder
DEEP_TIME_B = (4096, 1024)  # (g): frames of the P(128,64) times; of N 1024 and above


def deep_lists(dev, smi):
    """Phase 14: K1 and K3 over warps (list sizes 33..1024) and K3 at N up to
    8192 against the plain versions and the JAX golden files, the FER CLI
    at M=64 against the JAX CSV, the legacy simulator at
    list_size_max=256 against the JAX driver, the scalar calls that reach the
    new instantiations, and their times.  Returns the `kernels` entries of
    the two over-warps instantiations."""

    import torch

    from polar_code_tpu_torch import _build
    from polar_code_tpu_torch.eval import run_fer_sweep
    from polar_code_tpu_torch.legacy import simulator
    from polar_code_tpu_torch.legacy.crclib import crc as legacy_crc
    from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch
    from polar_code_tpu_torch.legacy.pac_cuda import launch_plan as pac_plan
    from polar_code_tpu_torch.legacy.pac_cuda import SOURCE as pac_source
    from polar_code_tpu_torch.legacy.pac_cuda import frame_bytes as pac_frame_bytes
    from polar_code_tpu_torch.legacy.pac_cuda import pac_list_decode_cuda
    from polar_code_tpu_torch.legacy.polar_code import PolarCode
    from polar_code_tpu_torch.legacy.rate_profile import rateprofile
    from polar_code_tpu_torch.ops import scl_cuda
    from polar_code_tpu_torch.ops.scl import decode_scl_batch
    from polar_code_tpu_torch.polar.api import decode_scl
    from polar_code_tpu_torch.polar.construct import construct_info_set

    decode_scl_cuda = scl_cuda.decode_scl_cuda
    wrappers = (decode_scl_cuda, pac_list_decode_cuda)
    plains = (decode_scl_batch, pac_list_decode_batch)

    def reset_counts():
        for f in wrappers:
            f.launches = f.deep_launches = 0
        for f in plains:
            f.cuda_calls = 0

    for source in (scl_cuda.SOURCE, pac_source):  # built in phase 2: this reads the kept log
        for row in ptxas_report(_build.build(source).log):
            if "_deep_kernel" in row["entry"]:
                print(f"  ptxas {row['entry']}: {row['regs']} registers, spills {row['spill_stores']} B "
                      f"stores / {row['spill_loads']} B loads")
                check("list" in row["entry"] or not row["spill_stores"],
                      f"the best-only {row['entry']} spills {row['spill_stores']} B")
    for n_s, k_s, M in [(N, K, M) for M in DEEP_MS] + list(DEEP_N):
        g, fpb, per_sm = scl_cuda.launch_plan(n_s, k_s, M, 4096)
        print(f"  K1 N={n_s} K={k_s} M={M} (over warps, {scl_cuda.trace_entry_bytes(M)}-byte trace "
              f"entries): levels 1..{g} and the trace indices in global scratch; "
              f"{scl_cuda.frame_bytes(n_s, k_s, M, g)} B shared a frame, one frame a block of "
              f"{scl_cuda.sort_keys(M) // 2} threads; {per_sm} frames an SM (occupancy calculator)")
        check(per_sm >= 1, f"K1 cannot place a frame of N={n_s} M={M}")
    for n_p, k_p, L in [(N, K, L) for L in (32,) + DEEP_LS] + list(DEEP_PAC_N):
        kp = k_p + PAC_CRC[0]
        g, fpb, per_sm = pac_plan(n_p, kp, L)
        threads = scl_cuda.sort_keys(L) // 2 if L > scl_cuda.PATH_MAX_M else 32 * fpb
        print(f"  K3 N={n_p} Kp={kp} L={L}: levels 1..{g} in global scratch; "
              f"{pac_frame_bytes(n_p, kp, L, g)} B shared a frame x {fpb} frames a block of {threads} "
              f"threads; {per_sm} frames an SM (occupancy calculator)")
        check(per_sm >= 1, f"K3 cannot place a frame of N={n_p} L={L}")

    # ---- (a) K1 over warps against the plain version ----
    rng = np.random.default_rng(20261114)
    cases = [(N, K, M, crc, plan, DEEP_B, 2.5, "gaussian") for M in DEEP_MS for crc in (CRC, None)
             for plan in (False, True)]
    cases += [(n_c, k_c, M, CRC, False, DEEP_N_B, 1.5, "gaussian_bitrev") for n_c, k_c, M in DEEP_N]
    differ = ties = 0
    k1_err = 0.0
    for n_c, k_c, M, crc, use_plan, B, snr, method in cases:
        info_c = construct_info_set(n_c, k_c, method=method)
        llr_np, msg = make_llrs(rng, B, snr, info_c, n=n_c)
        plan = torch.from_numpy(random_plan(rng, msg)).to(dev) if use_plan else None
        tag = (f"(a) P({n_c},{k_c}) M={M} crc={'on' if crc else 'off'} plan={'on' if use_plan else 'off'} "
               f"{snr} dB B={B}")
        (d, t, e), (db, tb, eb) = k1_vs_plain(torch.from_numpy(llr_np).to(dev), info_c, M, crc, plan, tag)
        differ, ties, k1_err = differ + d + db, ties + t + tb, max(k1_err, e, eb)
        print(f"  {tag}: list and best-only equal to the plain version outside {t + tb} near-tie frames",
              flush=True)
    print(f"(a) K1 over warps vs plain: {len(cases)} cases, list and best-only, {differ} frames differ, all "
          f"{ties} near-ties; max |info LLR diff| {k1_err:.3e}")

    # ---- (b) K3 over warps, and at N 2048 and 8192, against the plain version ----
    k3_err = 0.0
    for n_p, k_p, L in [(N, K, L) for L in DEEP_LS] + [DEEP_PAC_SMALL] + list(DEEP_PAC_N):
        B = DEEP_B if n_p <= N else DEEP_PAC_N_B
        mask = pac_mask(n_p, k_p + PAC_CRC[0])
        x = pac_llrs(rng, B, 2.0 if n_p <= N else 1.5, (n_p, k_p, PAC_CRC), PAC_GEN, mask, dev)
        ref = pac_list_decode_batch(x, mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
        tag = f"(b) PAC({n_p},{k_p})+CRC-16 L={L} B={B}"
        e = k3_list_vs_plain(x, mask, PAC_GEN, L, *PAC_CRC, tag, ref=ref)
        best = pac_list_decode_cuda(x, mask, PAC_GEN, L, *PAC_CRC)
        for f in ("extracted", "crc_pass"):
            check(torch.equal(best[f], ref[f]), f"{tag} best-only: K3's {f} differs from the plain version")
        k3_err = max(k3_err, e)
        print(f"  {tag}: list ({', '.join(PAC_LIST_FIELDS)}) and best-only equal to the plain version "
              f"(max |diff| {e}); crc pass {int(ref['crc_pass'].sum())}", flush=True)

    # ---- (c) against the JAX float32 golden files ----
    differ = ties = 0
    with np.load(GOLDEN / "scl_f32_deep.npz") as gold:
        deep_cases = json.loads(str(gold["cases"]))
        for case in deep_cases:
            tag, code = case["name"], case["code"]
            x = torch.from_numpy(gold[f"{code}/llr"]).to(dev)
            plan = torch.from_numpy(gold[f"{code}/plan"]).to(dev) if case["plan"] else None
            out = decode_scl_cuda(x, gold[f"{code}/info"], case["M"], case["crc"], force_info_bits=plan,
                                  full=True)
            ref = {"best_path_bits": gold[f"{tag}/bits"], "best_path_info_llrs": gold[f"{tag}/llrs"],
                   "crc_pass": gold[f"{tag}/crc_pass"], "metrics": gold[f"{tag}/metrics"]}
            check(ref["metrics"].shape == tuple(out["metrics"].shape), f"{tag}: golden metrics shape")
            d, t, _ = judge_list(out, ref, f"(c) vs JAX f32 {tag}")
            differ, ties = differ + d, ties + t
            print(f"  (c) K1 {tag} B={x.shape[0]}: {d} frames differ from JAX float32 ({t} near-ties); "
                  f"crc pass {int(ref['crc_pass'].sum())}", flush=True)
    with np.load(GOLDEN / "pac_deep.npz") as gold:
        pac_cases = json.loads(str(gold["cases"]))
        for case in pac_cases:
            name = case["name"]
            x = torch.from_numpy(gold[f"{name}/llr"]).to(dev)
            out = pac_list_decode_cuda(x, gold[f"{name}/mask"], case["gen"], case["L"], case["crc_len"],
                                       case["crc_poly"], full=True)
            for f in ("extracted", "crc_pass", "metrics", "v_full", "candidates"):
                have, want = out[f].cpu().numpy(), gold[f"{name}/{f}"]
                check(have.shape == want.shape and np.array_equal(have.astype(want.dtype), want),
                      f"(c) K3 {name}: {f} differs from the JAX decoder's")
            print(f"  (c) K3 {name} B={x.shape[0]}: extracted, crc_pass, metrics, v_full and candidates equal "
                  f"to the JAX decoder's; crc pass {int(gold[f'{name}/crc_pass'].sum())}", flush=True)
    print(f"(c) vs JAX: K1 {len(deep_cases)} cases (bits, info LLRs, metrics of all M paths), {differ} frames "
          f"differ, all {ties} near-ties; K3 {len(pac_cases)} cases, every field equal")

    # ---- (d) the FER CLI at M=64 against the JAX CSV ----
    M, (snr_lo, snr_hi) = DEEP_FER
    ref = jax_fer_rows(GOLDEN / "fer_deep" / f"fer_M{M}.csv", DEEP_FER_FRAMES)
    reset_counts()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        rows = run_fer_sweep.main([
            "--M", str(M), "--snr_lo", str(snr_lo), "--snr_hi", str(snr_hi), "--snr_step", "0.5",
            "--retries", "8", "--beta", str(REPO / "checkpoints" / "beta_M8.npy"),
            "--batch", "4096", "--frames", str(DEEP_FER_FRAMES), "--seed", "0",
            "--out_dir", f"{tmp}/results", "--plot_dir", f"{tmp}/plots"])
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches, fer_deep = decode_scl_cuda.launches, decode_scl_cuda.deep_launches
    plain = sum(f.cuda_calls for f in plains)
    steps = len(rows) * math.ceil(DEEP_FER_FRAMES / 4096)
    print(f"(d) FER CLI P(128,64) M={M}: {launches} K1 launches ({fer_deep} over warps) over {steps} FER "
          f"steps, plain decoders on CUDA {plain} times, {len(rows) * DEEP_FER_FRAMES / secs:.0f} frames/s")
    check(launches >= steps and fer_deep == launches,
          f"the M={M} FER sweep did not go through K1's over-warps instantiation")
    check(plain == 0, f"a plain decoder ran on CUDA in the M={M} FER sweep")
    check(len(rows) == len(ref), f"the M={M} FER sweep gave {len(rows)} points")
    for row in rows:
        for key in ("fer_scl", "fer_dl"):
            p1, p2 = row[key], ref[row["snr_db"]][key]
            check(math.isfinite(p1) and 0.0 < p1 < 1.0, f"M={M} {key} at {row['snr_db']} dB is {p1}")
            z = fer_z(p1, DEEP_FER_FRAMES, p2, DEEP_FER_FRAMES)
            print(f"  M={M} {row['snr_db']} dB {key}: port {p1:.6e} vs JAX {p2:.6e} "
                  f"({DEEP_FER_FRAMES} frames each): z = {z:+.3f}")
            check(abs(z) < 3.0, f"M={M} {key} at {row['snr_db']} dB is off the JAX sweep (z={z:.2f})")

    # ---- (e) the legacy simulator at list_size_max=256 against the JAX driver ----
    sim_ref = json.loads((GOLDEN / "legacy_pac_deep.json").read_text())["simulator"]
    cfg = sim_ref["config"]
    reset_counts()
    buf = io.StringIO()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
        res = simulator.run(simulator.LegacySimConfig(snr_range=cfg["snr_range"], seed=cfg["seed"],
                                                      list_size_max=cfg["list_size_max"]), tmp)
        sim_csv = next(Path(tmp).glob("*.csv")).read_text()
    sim_s = time.perf_counter() - t
    sim_launches, sim_deep = pac_list_decode_cuda.launches, pac_list_decode_cuda.deep_launches
    plain = sum(f.cuda_calls for f in plains)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("@")]
    for ln in lines:
        print(f"  simulator L 1 -> {cfg['list_size_max']}: {ln}")
    print(f"(e) simulator at list_size_max={cfg['list_size_max']}: {sim_s:.3f} s (host clock; the JAX driver "
          f"on the CPU took {sim_ref['seconds']:.1f} s); K3 {sim_launches} launches, {sim_deep} of them over "
          f"warps (stage 2); plain decoders on CUDA {plain} times")
    check(lines == sim_ref["lines"] and res.ber == sim_ref["ber"] and res.fer == sim_ref["fer"]
          and sim_csv == sim_ref["csv"], f"simulator results at list_size_max={cfg['list_size_max']} differ "
          f"from the JAX driver's: {lines} {res.ber} vs {sim_ref['lines']} {sim_ref['ber']}")
    check(sim_deep > 0, "the simulator's stage 2 did not go through K3's over-warps instantiation")
    check(plain == 0, "a plain decoder ran on CUDA in the simulator")

    # ---- (f) the scalar calls ----
    scl_m, pac_l, frames = DEEP_SCALAR
    golden = np.load(GOLDEN / "ref_p128_k64.npz")
    g_info = golden["info_set"]
    crc16 = legacy_crc(*PAC_CRC)
    pc = PolarCode(64, 48, "dega", pac_l, rateprofile(64, 48, 2.0, 0))
    msgs = rng.integers(0, 2, (frames, 32)).astype(np.int8)
    msgs = np.concatenate([msgs, crc16.crcCalc_batch(msgs)], axis=1)
    pac_in = {}
    for systematic in (True, False):
        codewords = np.stack([pc.encode(m, systematic) for m in msgs])
        nv = 1.0 / (2.0 * 0.5 * 10 ** 0.2)
        pac_in[systematic] = (2.0 * (1.0 - 2.0 * codewords + rng.normal(0.0, math.sqrt(nv), codewords.shape))
                              / nv).astype(np.float32)
    reset_counts()
    scl_out = [decode_scl(llr, g_info, scl_m, CRC) for llr in golden["llrs"]]
    pac_out = {sy: np.stack([pc.pac_list_crc_decoder(row, sy, True, crc16, pac_l) for row in llr])
               for sy, llr in pac_in.items()}
    torch.cuda.synchronize()
    scalar = tuple(f.launches for f in wrappers)
    scalar_deep = tuple(f.deep_launches for f in wrappers)
    plain = tuple(f.cuda_calls for f in plains)
    calls = (len(scl_out), 2 * frames)
    print(f"(f) scalar calls: K1/K3 launches {scalar} ({scalar_deep} over warps) for {calls} decodes; plain "
          f"decoders on CUDA {plain}")
    check(scalar == calls == scalar_deep,
          f"the scalar calls launched {scalar} ({scalar_deep} over warps), not one a decode {calls}")
    check(plain == (0, 0), f"a plain decoder ran on CUDA under the scalar calls: {plain}")
    ref = plain_fields(decode_scl_batch(torch.from_numpy(golden["llrs"].astype(np.float32)).to(dev), g_info,
                                        scl_m, CRC, dtype=torch.float32))
    got = {"best_path_bits": torch.from_numpy(np.stack([r["best_path_bits"] for r in scl_out]))}
    d, t, _ = judge_list(got, {"best_path_bits": ref["best_path_bits"]}, f"(f) decode_scl M={scl_m}",
                         ref["metrics"])
    near = near_tie_frames(ref["metrics"])
    for b, r in enumerate(scl_out):  # the valid paths' metrics, in the final order, outside near-ties
        have, ok = np.asarray(r["metrics"]), ref["valid"][b]
        check(near[b] or have.shape == (int(ok.sum()),)
              and np.all(np.abs(have - ref["metrics"][b][ok]) <= 1e-6 * np.abs(have)),
              f"decode_scl M={scl_m} frame {b} metrics differ from the plain version")
    print(f"  decode_scl P(128,64) M={scl_m} CRC on the 12 golden frames: {d} frames differ from the plain "
          f"version ({t} near-ties)")
    for systematic, llr in pac_in.items():
        if systematic:
            want = systematic_reference(pc, llr, True, crc16, pac_l, dev)
        else:
            want = pac_list_decode_batch(torch.from_numpy(llr).to(dev), pc.polarcode_mask, pc.gen, pac_l,
                                         crc_len=crc16.len, crc_poly=crc16.gen)["extracted"].cpu().numpy()
        check(np.array_equal(pac_out[systematic], want), f"PolarCode L={pac_l} systematic={systematic} "
              f"differs from the plain version")
        print(f"  PolarCode(64, 48, dega, L={pac_l}) {'systematic' if systematic else 'non-systematic'}, "
              f"CRC-16, 2.0 dB: {frames} frames equal to the plain version; "
              f"{int(np.all(pac_out[systematic] == msgs, axis=1).sum())} decoded the sent message")

    # ---- (g) times with CUDA events ----
    print(f"deep-list times on {smi}:")
    B, B_wide = DEEP_TIME_B
    info = construct_info_set(N, K)
    llr = torch.from_numpy(make_llrs(np.random.default_rng(5), B, 5.0, info)[0]).to(dev)
    entries = {}
    for M in (32, 64, 256, 1024):  # the by-path instantiation beside the over-warps one
        ms = cuda_time_ms(lambda M=M: decode_scl_cuda(llr, info, M, CRC), reps=2 if M == 1024 else 10,
                          warmup=1)
        b_ms, b_by = bound(*scl_work(info, M, B))
        line = f"  K1 P(128,64) M={M} CRC B={B} 5.0 dB: {ms:.4f} ms"
        if M == 64:
            plain_ms = cuda_time_ms(
                lambda: decode_scl_batch(llr, info, M, CRC, dtype=torch.float32), reps=2, warmup=1)
            entries["scl_deep"] = (ms, plain_ms, b_ms, b_by)
            line += f"; plain {plain_ms:.4f} ms"
        print(f"{line}; bound {b_ms:.6f} ms ({b_by}); "
              f"{scl_cuda.launch_plan(N, K, M, B)[2]} frames an SM")
    info_c = construct_info_set(1024, 512, method="gaussian_bitrev")
    x = torch.from_numpy(make_llrs(rng, B_wide, 1.75, info_c, n=1024)[0]).to(dev)
    ms = cuda_time_ms(lambda: decode_scl_cuda(x, info_c, 64, CRC), reps=3, warmup=1)
    plain_ms = cuda_time_ms(lambda: decode_scl_batch(x, info_c, 64, CRC, dtype=torch.float32), reps=1,
                            warmup=0)
    b_ms, b_by = bound(*scl_work(info_c, 64, B_wide, n=1024, k=512))
    print(f"  K1 P(1024,512) M=64 CRC B={B_wide} 1.75 dB: {ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
          f"{b_ms:.6f} ms ({b_by}); {scl_cuda.launch_plan(1024, 512, 64, B_wide)[2]} frames an SM")
    n_p, k_p, crc_p = PAC_CODES[128]
    p_mask = pac_mask(n_p, k_p + crc_p[0])
    x = pac_llrs(rng, B, 2.5, PAC_CODES[128], PAC_GEN, p_mask, dev)
    for L in (32,) + DEEP_LS:  # one path a lane beside over warps
        ms = cuda_time_ms(lambda L=L: pac_list_decode_cuda(x, p_mask, PAC_GEN, L, *crc_p),
                          reps=2 if L == 1024 else 10, warmup=1)
        b_ms, b_by = bound(*pac_work(p_mask, L, B))
        line = f"  K3 PAC(128,64)+CRC-16 L={L} B={B} 2.5 dB: {ms:.4f} ms"
        if L == 64:
            plain_ms = cuda_time_ms(lambda: pac_list_decode_batch(x, p_mask, PAC_GEN, L, crc_len=crc_p[0],
                                                                  crc_poly=crc_p[1]), reps=2, warmup=1)
            entries["pac_deep"] = (ms, plain_ms, b_ms, b_by)
            line += f"; plain {plain_ms:.4f} ms"
        print(f"{line}; bound {b_ms:.6f} ms ({b_by}); {pac_plan(n_p, k_p + crc_p[0], L)[2]} frames an SM")
    for n_p, k_p, L in DEEP_PAC_N:
        mask = pac_mask(n_p, k_p + PAC_CRC[0])
        x = pac_llrs(rng, B_wide, 1.5, (n_p, k_p, PAC_CRC), PAC_GEN, mask, dev)
        ms = cuda_time_ms(lambda: pac_list_decode_cuda(x, mask, PAC_GEN, L, *PAC_CRC), reps=3, warmup=1)
        plain_ms = cuda_time_ms(lambda: pac_list_decode_batch(x, mask, PAC_GEN, L, crc_len=PAC_CRC[0],
                                                              crc_poly=PAC_CRC[1]), reps=1, warmup=0)
        b_ms, b_by = bound(*pac_work(mask, L, B_wide))
        print(f"  K3 PAC({n_p},{k_p})+CRC-16 L={L} B={B_wide} 1.5 dB: {ms:.4f} ms; plain {plain_ms:.4f} ms; "
              f"bound {b_ms:.6f} ms ({b_by}); {pac_plan(n_p, k_p + PAC_CRC[0], L)[2]} frames an SM")

    launches = {"scl_deep": fer_deep + scalar_deep[0], "pac_deep": sim_deep + scalar_deep[1]}
    errors = {"scl_deep": k1_err, "pac_deep": k3_err}
    names = {"scl_deep": ("scl_decode (over warps: M 33-1024)", "polar_code_tpu_torch/csrc/scl_decode.cu",
                          "polar_code_tpu/ops/scl_pallas.py:293"),
             "pac_deep": ("pac_decode (over warps: L 33-1024)", "polar_code_tpu_torch/csrc/pac_decode.cu",
                          "polar_code_tpu/legacy/pac_pallas.py:59")}
    return [{"name": names[k][0], "route": "cuda", "source": names[k][1], "replaces": names[k][2],
             "launches": launches[k], "max_abs_err": errors[k], "ms": entries[k][0], "plain_ms": entries[k][1],
             "bound_ms": entries[k][2], "bound_by": entries[k][3], "library_ms": None}
            for k in ("scl_deep", "pac_deep")]


# phase 15, the cluster lists: K1 and K3 at list sizes 1025..8192 (their
# cluster instantiations, a frame spread over a thread-block cluster of 2,
# 4 or 8 blocks of 1024 threads) and K3 one path a lane with its trace in
# global scratch
CLUSTER_SEEDS = (20261118, 20261119)  # every vs-plain case at two draws: a missing barrier is rare
CLUSTER_B = 32  # frames of a P(128,64) vs-plain case
# (a): P(128,64) list sizes (1025 and 3000 sort pads; 3000 leaves a block idle),
# CRC and plan on and off at 2048
CLUSTER_MS = (1025, 2048, 3000, 4096, 8192)
# (a): (N, K, M, frames); the plain version took 3.2 s at P(8192,256) M=2048 B=2
CLUSTER_N = ((1024, 512, 2048, 16), (8192, 2048, 2048, 2))
CLUSTER_LS = (2048, 4096)  # (c): K3 list sizes at PAC(128,64)+CRC-16 and PAC(32,12)+CRC-16
# (d): K3 one path a lane at N=8192 with Kp past what its trace in shared
# memory took (7259 at L=32)
ONE_LANE_N = ((8192, 7384, 32),)
ONE_LANE_B = 2  # the plain version takes about 12 s a call at N=8192
CLUSTER_SIM_LIST_MAX = 2048  # (e): the legacy simulator's stage-2 list size
CLUSTER_SCALAR = (2048, 2048, 8)  # (e): decode_scl's M, PolarCode's L, frames a PolarCode decoder
CLUSTER_TIME_B = 1024  # (f): frames of the timed launches


def pac_cuda_info_phases(mask):
    """K3's info phases: the mask's ones in bit-reversed order."""

    from polar_code_tpu_torch.legacy.pac import bitrev_perm

    return np.flatnonzero(np.asarray(mask)[bitrev_perm(int(np.asarray(mask).size))] == 1)


def cluster_barriers(n_code, info_phases, M):
    """(an info phase's, a frozen phase's) cluster barriers on a cluster, from
    the schedule words: an info phase one a cross-block sort stage and one
    for the sorted keys (`scl_cuda.cluster_exchanges`), and
    each phase whose word flags a read through σ the split phase-end one;
    as "a" or "a–b" where phases differ."""

    from polar_code_tpu_torch.ops.scl_cuda import cluster_exchanges, sort_keys
    from polar_code_tpu_torch.ops.scl_schedule import phase_words

    exchanges = cluster_exchanges(sort_keys(M))
    words = phase_words(n_code, np.asarray(info_phases, np.int64)).astype(np.int64)
    info, flagged = (words >> 10 & 1) == 0, (words >> 11) != 0
    per = np.where(info, exchanges, 0) + flagged
    span = lambda v: f"{v.min()}" if v.min() == v.max() else f"{v.min()}–{v.max()}"  # noqa: E731
    return span(per[info]), span(per[~info]) if (~info).any() else "-"


def cluster_lists(dev, smi):
    """Phase 15: K1 and K3 on a cluster (list sizes 1025..8192) against the
    plain versions and the JAX golden files, K3 one path a lane at N=8192
    with the trace in global scratch, the legacy simulator at
    list_size_max=2048 against the JAX driver, the scalar calls that reach
    the new instantiations, and their times.  Returns the `kernels` entries
    of the two cluster instantiations."""

    import torch

    from polar_code_tpu_torch import _build
    from polar_code_tpu_torch.legacy import pac_cuda, simulator
    from polar_code_tpu_torch.legacy.crclib import crc as legacy_crc
    from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch
    from polar_code_tpu_torch.legacy.pac_cuda import launch_plan as pac_plan
    from polar_code_tpu_torch.legacy.pac_cuda import SOURCE as pac_source
    from polar_code_tpu_torch.legacy.pac_cuda import frame_bytes as pac_frame_bytes
    from polar_code_tpu_torch.legacy.pac_cuda import pac_list_decode_cuda
    from polar_code_tpu_torch.legacy.polar_code import PolarCode
    from polar_code_tpu_torch.legacy.rate_profile import rateprofile
    from polar_code_tpu_torch.ops import scl_cuda
    from polar_code_tpu_torch.ops.scl import decode_scl_batch
    from polar_code_tpu_torch.polar.api import decode_scl
    from polar_code_tpu_torch.polar.construct import construct_info_set

    decode_scl_cuda = scl_cuda.decode_scl_cuda
    wrappers = (decode_scl_cuda, pac_list_decode_cuda)
    plains = (decode_scl_batch, pac_list_decode_batch)

    def reset_counts():
        for f in wrappers:
            f.launches = f.cluster_launches = 0
        for f in plains:
            f.cuda_calls = 0

    for source in (scl_cuda.SOURCE, pac_source):  # built in phase 2: this reads the kept log
        for row in ptxas_report(_build.build(source).log):
            if "_cluster_kernel" in row["entry"] or "pac_decode_kernel" in row["entry"]:
                print(f"  ptxas {row['entry']}: {row['regs']} registers, spills {row['spill_stores']} B "
                      f"stores / {row['spill_loads']} B loads")
                # every cluster instantiation, best-only and list, spill-free;
                # K3 one path a lane's best-only ones too, but at L=1, which
                # may keep the parent's few spilled bytes: the spill-free
                # builds of it (launch bounds of 5–7 blocks an SM) ran 19%
                # slower at B=65536 (PERF.md, §6)
                limit = 32 if row["entry"] == "pac_decode_kernel<LM=1>" else 0
                check(("list" in row["entry"] and "_cluster_kernel" not in row["entry"])
                      or row["spill_stores"] <= limit,
                      f"{row['entry']} spills {row['spill_stores']} B (at most {limit})")
    cluster_shapes = ([("K1", n_s, k_s, M, 2) for n_s, k_s, M in [(N, K, M) for M in CLUSTER_MS]
                       + [c[:3] for c in CLUSTER_N]]
                      + [("K3", N, K + PAC_CRC[0], L, 3) for L in CLUSTER_LS])
    for kernel, n_s, k_s, M, words in cluster_shapes:
        if kernel == "K1":
            g, _, at_once = scl_cuda.launch_plan(n_s, k_s, M, CLUSTER_TIME_B)
            scratch = scl_cuda.scratch_bytes(1, n_s, k_s, M, g)
            info_phases = construct_info_set(n_s, k_s, method="gaussian" if n_s == N else "gaussian_bitrev")
        else:
            g, _, at_once = pac_plan(n_s, k_s, M)
            scratch = pac_cuda.scratch_bytes(1, n_s, k_s, M, g)
            info_phases = pac_cuda_info_phases(pac_mask(n_s, k_s))
        info_b, frozen_b = cluster_barriers(n_s, info_phases, M)
        print(f"  {kernel} N={n_s} K={k_s} M={M} (a cluster of {scl_cuda.cluster_blocks(M)} blocks of 1024 "
              f"threads): levels {g + 1}..{int(math.log2(n_s))} in shared memory, 1..{g} and the trace in "
              f"global scratch ({scratch} B a frame); {scl_cuda.cluster_block_bytes(n_s, g, words)} B shared a "
              f"block; {at_once} frames at once on the card (occupancy calculator); cluster barriers "
              f"{info_b} an info phase, {frozen_b} a frozen phase")
    for n_p, kp, L in list(ONE_LANE_N) + [(N, 80, 32)]:
        g, fpb, at = pac_plan(n_p, kp, L)
        print(f"  K3 N={n_p} Kp={kp} L={L}: levels 1..{g} and the trace in global scratch; "
              f"{pac_frame_bytes(n_p, kp, L, g)} B shared a frame; {fpb} frames a block; {at} frames an SM "
              f"(occupancy calculator)")

    # ---- (a) K1 on a cluster against the plain version, at two draws ----
    cases = [(N, K, M, CRC, False, CLUSTER_B) for M in CLUSTER_MS]
    cases += [(N, K, 2048, crc, plan, CLUSTER_B) for crc, plan in ((CRC, True), (None, False), (None, True))]
    cases += [(n_c, k_c, M, CRC, False, B) for n_c, k_c, M, B in CLUSTER_N]
    differ = ties = 0
    k1_err = 0.0
    t_plain_n8192 = None
    for seed in CLUSTER_SEEDS:
        rng = np.random.default_rng(seed)
        for n_c, k_c, M, crc, use_plan, B in cases:
            info_c = construct_info_set(n_c, k_c, method="gaussian" if n_c == N else "gaussian_bitrev")
            llr_np, msg = make_llrs(rng, B, 2.0 if n_c == N else 1.5, info_c, n=n_c)
            plan = torch.from_numpy(random_plan(rng, msg)).to(dev) if use_plan else None
            tag = (f"(a) P({n_c},{k_c}) M={M} crc={'on' if crc else 'off'} "
                   f"plan={'on' if use_plan else 'off'} B={B} seed {seed}")
            t = time.perf_counter()
            (d, t_, e), (db, tb, eb) = k1_vs_plain(torch.from_numpy(llr_np).to(dev), info_c, M, crc, plan, tag)
            if n_c == 8192:
                t_plain_n8192 = time.perf_counter() - t
            differ, ties, k1_err = differ + d + db, ties + t_ + tb, max(k1_err, e, eb)
            print(f"  {tag}: list and best-only equal to the plain version outside {t_ + tb} near-tie frames "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)
    print(f"(a) K1 on a cluster vs plain: {len(cases)} cases at {len(CLUSTER_SEEDS)} draws, list and "
          f"best-only, {differ} frames differ, all {ties} near-ties; max |info LLR diff| {k1_err:.3e}")
    # a batch whose scratch cannot be allocated goes in launches of
    # `alloc_scratch` frames: here the card's room is pinned to 10 frames'
    # scratch (an allocation of more raises the card's out-of-memory error)
    rng = np.random.default_rng(CLUSTER_SEEDS[0])
    llr_np, msg = make_llrs(rng, CLUSTER_B, 2.0, construct_info_set(N, K))
    x = torch.from_numpy(llr_np).to(dev)
    plan = torch.from_numpy(random_plan(rng, msg)).to(dev)
    mask = pac_mask(N, K + PAC_CRC[0])
    xp = pac_llrs(rng, CLUSTER_B, 2.0, (N, K, PAC_CRC), PAC_GEN, mask, dev)
    whole = (decode_scl_cuda(x, construct_info_set(N, K), 2048, CRC, force_info_bits=plan, full=True),
             pac_list_decode_cuda(xp, mask, PAC_GEN, 2048, *PAC_CRC, full=True))
    alloc_scratch = scl_cuda.alloc_scratch

    def ten_frames(B, one, alloc, free, what):
        def pinned(frames):
            if frames > 10:
                raise torch.cuda.OutOfMemoryError(f"{frames} frames, past the 10 pinned")
            return alloc(frames)
        return alloc_scratch(B, one, pinned, lambda: one * 100 // 9 + 100, what)

    reset_counts()
    try:
        scl_cuda.alloc_scratch = pac_cuda.alloc_scratch = ten_frames
        split = (decode_scl_cuda(x, construct_info_set(N, K), 2048, CRC, force_info_bits=plan, full=True),
                 pac_list_decode_cuda(xp, mask, PAC_GEN, 2048, *PAC_CRC, full=True))
    finally:
        scl_cuda.alloc_scratch = pac_cuda.alloc_scratch = alloc_scratch
    torch.cuda.synchronize()
    want = -(-CLUSTER_B // 10)
    check((decode_scl_cuda.cluster_launches, pac_list_decode_cuda.cluster_launches) == (want, want),
          f"a split batch of {CLUSTER_B} frames took {decode_scl_cuda.cluster_launches} / "
          f"{pac_list_decode_cuda.cluster_launches} launches, not {want}")
    for a, b in zip(whole, split):
        for f in a:
            check(torch.equal(a[f], b[f]), f"(a) a split cluster batch's {f} differs from one launch's")
    print(f"  (a) K1 and K3 at M = L = 2048, B={CLUSTER_B} with the card's room pinned to 10 frames' "
          f"scratch: {want} launches each, every output equal to one launch's", flush=True)

    # ---- (b) against the JAX golden files ----
    differ = ties = 0
    with np.load(GOLDEN / "scl_f32_cluster.npz") as gold:
        gold_cases = json.loads(str(gold["cases"]))
        for case in gold_cases:
            tag, code = case["name"], case["code"]
            x = torch.from_numpy(gold[f"{code}/llr"]).to(dev)
            plan = torch.from_numpy(gold[f"{code}/plan"]).to(dev) if case["plan"] else None
            out = decode_scl_cuda(x, gold[f"{code}/info"], case["M"], case["crc"], force_info_bits=plan,
                                  full=True)
            ref = {"best_path_bits": gold[f"{tag}/bits"], "best_path_info_llrs": gold[f"{tag}/llrs"],
                   "crc_pass": gold[f"{tag}/crc_pass"], "metrics": gold[f"{tag}/metrics"]}
            check(ref["metrics"].shape == tuple(out["metrics"].shape), f"{tag}: golden metrics shape")
            d, t, _ = judge_list(out, ref, f"(b) vs JAX f32 {tag}")
            differ, ties = differ + d, ties + t
            print(f"  (b) K1 {tag} B={x.shape[0]}: {d} frames differ from JAX float32 ({t} near-ties); "
                  f"crc pass {int(ref['crc_pass'].sum())}", flush=True)
    with np.load(GOLDEN / "pac_cluster.npz") as gold:
        pac_cases = json.loads(str(gold["cases"]))
        for case in pac_cases:
            name = case["name"]
            x = torch.from_numpy(gold[f"{name}/llr"]).to(dev)
            out = pac_list_decode_cuda(x, gold[f"{name}/mask"], case["gen"], case["L"], case["crc_len"],
                                       case["crc_poly"], full=True)
            best = pac_list_decode_cuda(x, gold[f"{name}/mask"], case["gen"], case["L"], case["crc_len"],
                                        case["crc_poly"])
            for f in ("extracted", "crc_pass", "metrics", "v_full", "candidates"):
                have, want = out[f].cpu().numpy(), gold[f"{name}/{f}"]
                check(have.shape == want.shape and np.array_equal(have.astype(want.dtype), want),
                      f"(b) K3 {name}: {f} differs from the JAX decoder's")
            for f in ("extracted", "crc_pass"):
                check(np.array_equal(best[f].cpu().numpy().astype(gold[f"{name}/{f}"].dtype),
                                     gold[f"{name}/{f}"]), f"(b) K3 {name} best-only: {f} differs")
            print(f"  (b) K3 {name} B={x.shape[0]}: list (extracted, crc_pass, metrics, v_full, candidates) "
                  f"and best-only equal to the JAX decoder's; crc pass {int(gold[f'{name}/crc_pass'].sum())}",
                  flush=True)
    print(f"(b) vs JAX: K1 {len(gold_cases)} cases (bits, info LLRs, metrics of all M paths), {differ} frames "
          f"differ, all {ties} near-ties; K3 {len(pac_cases)} case, every field equal")

    # ---- (c) K3 on a cluster, (d) one path a lane at N=8192, against the plain version ----
    k3_err = 0.0
    pac_shapes = ([(N, K, L, CLUSTER_B) for L in CLUSTER_LS] + [(32, 12, L, CLUSTER_B) for L in CLUSTER_LS]
                  + [(n_p, kp - PAC_CRC[0], L, ONE_LANE_B) for n_p, kp, L in ONE_LANE_N])
    for seed in CLUSTER_SEEDS:
        rng = np.random.default_rng(seed)
        for n_p, k_p, L, B in pac_shapes:
            mask = pac_mask(n_p, k_p + PAC_CRC[0])
            x = pac_llrs(rng, B, 2.0 if n_p <= N else 1.5, (n_p, k_p, PAC_CRC), PAC_GEN, mask, dev)
            ref = pac_list_decode_batch(x, mask, PAC_GEN, L, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
            tag = f"({'c' if L > 32 else 'd'}) PAC({n_p},{k_p})+CRC-16 L={L} B={B} seed {seed}"
            e = k3_list_vs_plain(x, mask, PAC_GEN, L, *PAC_CRC, tag, ref=ref)
            best = pac_list_decode_cuda(x, mask, PAC_GEN, L, *PAC_CRC)
            for f in ("extracted", "crc_pass"):
                check(torch.equal(best[f], ref[f]), f"{tag} best-only: K3's {f} differs from the plain version")
            k3_err = max(k3_err, e)
            print(f"  {tag}: list ({', '.join(PAC_LIST_FIELDS)}) and best-only equal to the plain version "
                  f"(max |diff| {e}); crc pass {int(ref['crc_pass'].sum())}", flush=True)

    # ---- (e) the simulator and the scalar calls ----
    sim_ref = json.loads((GOLDEN / "legacy_pac_cluster.json").read_text())["simulator"]
    cfg = sim_ref["config"]
    reset_counts()
    buf = io.StringIO()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
        res = simulator.run(simulator.LegacySimConfig(snr_range=cfg["snr_range"], seed=cfg["seed"],
                                                      list_size_max=cfg["list_size_max"]), tmp)
        sim_csv = next(Path(tmp).glob("*.csv")).read_text()
    sim_s = time.perf_counter() - t
    sim_launches, sim_cluster = pac_list_decode_cuda.launches, pac_list_decode_cuda.cluster_launches
    plain = sum(f.cuda_calls for f in plains)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("@")]
    for ln in lines:
        print(f"  simulator L 1 -> {cfg['list_size_max']}: {ln}")
    print(f"(e) simulator at list_size_max={cfg['list_size_max']}: {sim_s:.3f} s (host clock; the JAX driver "
          f"on the CPU took {sim_ref['seconds']:.1f} s); K3 {sim_launches} launches, {sim_cluster} of them on "
          f"a cluster (stage 2); plain decoders on CUDA {plain} times")
    check(lines == sim_ref["lines"] and res.ber == sim_ref["ber"] and res.fer == sim_ref["fer"]
          and sim_csv == sim_ref["csv"], f"simulator results at list_size_max={cfg['list_size_max']} differ "
          f"from the JAX driver's: {lines} {res.ber} vs {sim_ref['lines']} {sim_ref['ber']}")
    check(sim_cluster > 0, "the simulator's stage 2 did not go through K3's cluster instantiation")
    check(plain == 0, "a plain decoder ran on CUDA in the simulator")

    scl_m, pac_l, frames = CLUSTER_SCALAR
    golden = np.load(GOLDEN / "ref_p128_k64.npz")
    g_info = golden["info_set"]
    crc16 = legacy_crc(*PAC_CRC)
    pc = PolarCode(64, 48, "dega", pac_l, rateprofile(64, 48, 2.0, 0))
    rng = np.random.default_rng(CLUSTER_SEEDS[0])
    msgs = rng.integers(0, 2, (frames, 32)).astype(np.int8)
    msgs = np.concatenate([msgs, crc16.crcCalc_batch(msgs)], axis=1)
    pac_in = {}
    for systematic in (True, False):
        codewords = np.stack([pc.encode(m, systematic) for m in msgs])
        nv = 1.0 / (2.0 * 0.5 * 10 ** 0.2)
        pac_in[systematic] = (2.0 * (1.0 - 2.0 * codewords + rng.normal(0.0, math.sqrt(nv), codewords.shape))
                              / nv).astype(np.float32)
    reset_counts()
    scl_out = [decode_scl(llr, g_info, scl_m, CRC) for llr in golden["llrs"]]
    pac_out = {sy: np.stack([pc.pac_list_crc_decoder(row, sy, True, crc16, pac_l) for row in llr])
               for sy, llr in pac_in.items()}
    torch.cuda.synchronize()
    scalar = tuple(f.launches for f in wrappers)
    scalar_cluster = tuple(f.cluster_launches for f in wrappers)
    plain = tuple(f.cuda_calls for f in plains)
    calls = (len(scl_out), 2 * frames)
    print(f"(e) scalar calls: K1/K3 launches {scalar} ({scalar_cluster} on a cluster) for {calls} decodes; "
          f"plain decoders on CUDA {plain}")
    check(scalar == calls == scalar_cluster,
          f"the scalar calls launched {scalar} ({scalar_cluster} on a cluster), not one a decode {calls}")
    check(plain == (0, 0), f"a plain decoder ran on CUDA under the scalar calls: {plain}")
    ref = plain_fields(decode_scl_batch(torch.from_numpy(golden["llrs"].astype(np.float32)).to(dev), g_info,
                                        scl_m, CRC, dtype=torch.float32))
    got = {"best_path_bits": torch.from_numpy(np.stack([r["best_path_bits"] for r in scl_out]))}
    d, t, _ = judge_list(got, {"best_path_bits": ref["best_path_bits"]}, f"(e) decode_scl M={scl_m}",
                         ref["metrics"])
    near = near_tie_frames(ref["metrics"])
    for b, r in enumerate(scl_out):  # the valid paths' metrics, in the final order, outside near-ties
        have, ok = np.asarray(r["metrics"]), ref["valid"][b]
        check(near[b] or have.shape == (int(ok.sum()),)
              and np.all(np.abs(have - ref["metrics"][b][ok]) <= 1e-6 * np.abs(have)),
              f"decode_scl M={scl_m} frame {b} metrics differ from the plain version")
    print(f"  decode_scl P(128,64) M={scl_m} CRC on the 12 golden frames: {d} frames differ from the plain "
          f"version ({t} near-ties)")
    for systematic, llr in pac_in.items():
        if systematic:
            want = systematic_reference(pc, llr, True, crc16, pac_l, dev)
        else:
            want = pac_list_decode_batch(torch.from_numpy(llr).to(dev), pc.polarcode_mask, pc.gen, pac_l,
                                         crc_len=crc16.len, crc_poly=crc16.gen)["extracted"].cpu().numpy()
        check(np.array_equal(pac_out[systematic], want), f"PolarCode L={pac_l} systematic={systematic} "
              f"differs from the plain version")
        print(f"  PolarCode(64, 48, dega, L={pac_l}) {'systematic' if systematic else 'non-systematic'}, "
              f"CRC-16, 2.0 dB: {frames} frames equal to the plain version; "
              f"{int(np.all(pac_out[systematic] == msgs, axis=1).sum())} decoded the sent message")

    # ---- (f) times with CUDA events ----
    print(f"cluster-list times on {smi}:")
    B = CLUSTER_TIME_B
    info = construct_info_set(N, K)
    llr = torch.from_numpy(make_llrs(np.random.default_rng(5), B, 5.0, info)[0]).to(dev)
    entries = {}
    for M in (1024, 2048, 4096, 8192):  # over warps beside the cluster
        before = decode_scl_cuda.launches
        ms = cuda_time_ms(lambda M=M: decode_scl_cuda(llr, info, M, CRC), reps=2, warmup=1)
        b_ms, b_by = bound(*scl_work(info, M, B))
        line = (f"  K1 P(128,64) M={M} CRC B={B} 5.0 dB: {ms:.4f} ms ({(decode_scl_cuda.launches - before) / 3:g} "
                f"launches a call)")
        if M == 2048:
            plain_ms = cuda_time_ms(lambda: decode_scl_batch(llr, info, M, CRC, dtype=torch.float32), reps=1,
                                    warmup=0)
            entries["scl_cluster"] = (ms, plain_ms, b_ms, b_by)
            line += f"; plain {plain_ms:.4f} ms"
        print(f"{line}; bound {b_ms:.6f} ms ({b_by}); {scl_cuda.launch_plan(N, K, M, B)[2]} frames "
              f"{'at once' if M > scl_cuda.DEEP_MAX_M else 'an SM'}", flush=True)
    if t_plain_n8192 is not None:
        print(f"  (a)'s P(8192,2048) M=2048 case, K1 list and best-only and the plain version: "
              f"{t_plain_n8192:.1f} s (host clock)")
    n_p, k_p, crc_p = PAC_CODES[128]
    p_mask = pac_mask(n_p, k_p + crc_p[0])
    x = pac_llrs(np.random.default_rng(6), B, 2.5, PAC_CODES[128], PAC_GEN, p_mask, dev)
    for L in (1024, 2048, 4096):
        ms = cuda_time_ms(lambda L=L: pac_list_decode_cuda(x, p_mask, PAC_GEN, L, *crc_p), reps=2, warmup=1)
        b_ms, b_by = bound(*pac_work(p_mask, L, B))
        line = f"  K3 PAC(128,64)+CRC-16 L={L} B={B} 2.5 dB: {ms:.4f} ms"
        if L == 2048:
            plain_ms = cuda_time_ms(lambda: pac_list_decode_batch(x, p_mask, PAC_GEN, L, crc_len=crc_p[0],
                                                                  crc_poly=crc_p[1]), reps=1, warmup=0)
            entries["pac_cluster"] = (ms, plain_ms, b_ms, b_by)
            line += f"; plain {plain_ms:.4f} ms"
        print(f"{line}; bound {b_ms:.6f} ms ({b_by}); {pac_plan(n_p, k_p + crc_p[0], L)[2]} frames "
              f"{'at once' if L > scl_cuda.DEEP_MAX_M else 'an SM'}", flush=True)
    # K3 one path a lane, the trace now in global scratch (parent beside it:
    # `tools/time_pac_cuda.py` in one call)
    x = pac_llrs(np.random.default_rng(7), 4096, 2.5, PAC_CODES[128], PAC_GEN, p_mask, dev)
    ms = cuda_time_ms(lambda: pac_list_decode_cuda(x, p_mask, PAC_GEN, 32, *crc_p), reps=5)
    b_ms, b_by = bound(*pac_work(p_mask, 32, 4096))
    g, fpb, per_sm = pac_plan(n_p, k_p + crc_p[0], 32)
    print(f"  K3 one path a lane PAC(128,64)+CRC-16 L=32 B=4096 2.5 dB: {ms:.4f} ms (5 launches); bound "
          f"{b_ms:.6f} ms ({b_by}); levels 1..{g} in global scratch, {fpb} frames a block, {per_sm} an SM")
    n_w, kp_w, L_w = ONE_LANE_N[0]
    w_mask = pac_mask(n_w, kp_w)
    x = pac_llrs(np.random.default_rng(8), 64, 1.5, (n_w, kp_w - PAC_CRC[0], PAC_CRC), PAC_GEN, w_mask, dev)
    ms = cuda_time_ms(lambda: pac_list_decode_cuda(x, w_mask, PAC_GEN, L_w, *PAC_CRC), reps=2, warmup=1)
    print(f"  K3 one path a lane PAC({n_w},{kp_w - PAC_CRC[0]})+CRC-16 L={L_w} B=64 1.5 dB: {ms:.4f} ms "
          f"(a shape the trace in shared memory refused); {pac_plan(n_w, kp_w, L_w)}")

    launches = {"scl_cluster": scalar_cluster[0], "pac_cluster": sim_cluster + scalar_cluster[1]}
    errors = {"scl_cluster": k1_err, "pac_cluster": k3_err}
    names = {"scl_cluster": ("scl_decode (cluster: M 1025-8192)", "polar_code_tpu_torch/csrc/scl_decode.cu",
                             "polar_code_tpu/ops/scl_pallas.py:293"),
             "pac_cluster": ("pac_decode (cluster: L 1025-8192)", "polar_code_tpu_torch/csrc/pac_decode.cu",
                             "polar_code_tpu/legacy/pac_pallas.py:59")}
    return [{"name": names[k][0], "route": "cuda", "source": names[k][1], "replaces": names[k][2],
             "launches": launches[k], "max_abs_err": errors[k], "ms": entries[k][0], "plain_ms": entries[k][1],
             "bound_ms": entries[k][2], "bound_by": entries[k][3], "library_ms": None}
            for k in ("scl_cluster", "pac_cluster")]


LONG_SEED = 20261201
# (a): the plain version's call costs 9–17 s at N=16384 and 40–75 s at
# N=65536 on an H100's host whatever the batch (it steps through N phases;
# the host's speed moved it by half between two runs), so a case is one
# draw of a few frames, and the phase runs the plain calls `LONG_WORKERS`
# at once in worker processes (`plain_reference`), the longest first: those
# at N=65536, then those at M or L >= 1024 (about 36 s at N=16384 beside
# 12-16 s at the other list sizes when six run at once).
# K1 against the plain version, list and best-only: (N, K, M, frames,
# forced plans); beside the golden file's M 1 (byte words), 8 (by path at
# LM=8, where the byte words give way) and 32 (the wide LM=32) at N=16384:
LONG_K1 = ((16384, 8192, 16, 8, True),  # the wide LM=16, with plans
           (16384, 8192, 64, 4, False),  # over warps, 8-bit σ fields and trace entries
           (16384, 8192, 1024, 4, False),  # the wide over-warps twin (16-bit)
           (16384, 8192, 2048, 2, False),  # a cluster, σ rows of 52 B, G = n − 3
           (65536, 65536, 1, 1, False),  # byte words, a trace of K = 65536 bytes in shared memory
           (65536, 32768, 8, 1, False),  # by path at LM=8, its 30 σ fields full
           (65536, 65536, 8, 1, False),  # the same with a trace of N rows
           (65536, 32768, 32, 1, False),  # the wide LM=32's 30 fields full
           (65536, 65536, 32, 1, False),  # the same with a trace of N rows
           (65536, 256, 2048, 1, False))  # a cluster at n = 16
# (a): K3 against the plain version, every list field and best-only: (N,
# payload, L, frames); beside the golden file's L=8 at N=16384:
LONG_K3 = ((16384, 8192, 16, 2),  # the wide one-lane LM=16
           (16384, 8192, 32, 4),  # the wide one-lane LM=32
           (16384, 8192, 64, 2),  # over warps, 8-bit
           (16384, 8192, 256, 2),  # the wide over-warps twin (16-bit)
           (16384, 8192, 2048, 1),  # a cluster, G = n − 3
           (65536, 240, 8, 1),  # one path a lane at n = 16, the trace's Kp rows in global scratch
           (65536, 240, 2048, 1))  # a cluster at G = n − 2
LONG_WORKERS = 6  # plain calls at once: each holds a host core, of the 8 beside an H100 here
LONG_SNR = 1.25  # dB: P(16384,8192) at M=8 decodes most frames, M=1 about half (the golden file)
# (c): the FER CLI at P(16384,8192) `gaussian_bitrev` CRC-24A M=8, 8 DL-SCL
# retries, no β: N, K, frames, batch, Eb/N0; the scalar and legacy calls at
# the same (N, K)
LONG_FER = (16384, 8192, 4096, 1024, 1.25)
LONG_TIME_B = (1024, 64)  # (d): frames of the timed launches; at M and L >= 1024
# (c): a batch whose scratch the card cannot allocate, split after the
# failed allocation: K1 over warps at P(128,64) M=64, 65536 frames (3.4 GB
# of scratch), with the card's free memory held to about half of it
LONG_SPLIT = (64, 65536)


def plain_reference(kind, args, device="cuda"):
    """One plain decode on `device`, in a worker process of phase 16:
    `plain_fields` of the SCL decoder (kind "scl": LLRs, info set, M, CRC,
    plan) or the PAC decoder's list fields (kind "pac": LLRs, mask, gen, L,
    CRC length and polynomial), as numpy arrays, and the call's seconds on
    the host clock."""

    import torch

    sys.path.insert(0, str(REPO))
    dev = torch.device(device)
    t = time.perf_counter()
    if kind == "scl":
        from polar_code_tpu_torch.ops.scl import decode_scl_batch

        llr, info, M, crc, plan = args
        res = plain_fields(decode_scl_batch(
            torch.from_numpy(llr).to(dev), info, M, crc, dtype=torch.float32,
            force_info_bits=None if plan is None else torch.from_numpy(plan).to(dev)))
    else:
        from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch

        llr, mask, gen, L, crc_len, crc_poly = args
        out = pac_list_decode_batch(torch.from_numpy(llr).to(dev), mask, gen, L, crc_len=crc_len,
                                    crc_poly=crc_poly)
        res = {f: out[f].cpu().numpy() for f in PAC_LIST_FIELDS}
    return res, time.perf_counter() - t


def long_codes(dev, smi):
    """Phase 16: K1 and K3 at code lengths 16384..65536 against the plain
    versions and the JAX golden file, the FER CLI at P(16384,8192) M=8 and
    the scalar and legacy calls at N=16384, and their times.  Returns the
    `kernels` entries of K1 and K3 at these lengths."""

    import torch

    from polar_code_tpu_torch import _build
    from polar_code_tpu_torch.eval import run_fer_sweep
    from polar_code_tpu_torch.legacy import pac_cuda
    from polar_code_tpu_torch.legacy.crclib import crc as legacy_crc
    from polar_code_tpu_torch.legacy.pac import pac_decode, pac_list_decode_batch
    from polar_code_tpu_torch.legacy.pac_cuda import pac_list_decode_cuda
    from polar_code_tpu_torch.legacy.polar_code import PolarCode
    from polar_code_tpu_torch.legacy.rate_profile import rateprofile
    from polar_code_tpu_torch.ops import scl_cuda
    from polar_code_tpu_torch.ops.polar_transform import polar_transform
    from polar_code_tpu_torch.ops.scl import decode_scl_batch
    from polar_code_tpu_torch.polar.api import decode_scl
    from polar_code_tpu_torch.polar.construct import construct_info_set

    decode_scl_cuda = scl_cuda.decode_scl_cuda
    wrappers = (decode_scl_cuda, pac_list_decode_cuda)
    plains = (decode_scl_batch, pac_list_decode_batch)
    t_phase = time.perf_counter()

    def reset_counts():
        for f in wrappers:
            f.launches = 0
        for f in plains:
            f.cuda_calls = 0

    # ---- (d), first part: registers and spills of the new instantiations, and the plans ----
    for source in (scl_cuda.SOURCE, pac_cuda.SOURCE):  # built in phase 2: this reads the kept log
        for row in ptxas_report(_build.build(source).log):
            if "_wide_kernel" in row["entry"]:
                print(f"  ptxas {row['entry']}: {row['regs']} registers, spills {row['spill_stores']} B "
                      f"stores / {row['spill_loads']} B loads")
                check("list" in row["entry"] or not row["spill_stores"],
                      f"the best-only {row['entry']} spills {row['spill_stores']} B")
    info_of = {}

    def code_info(n_c, k_c):
        if (n_c, k_c) not in info_of:
            info_of[n_c, k_c] = (np.arange(n_c) if k_c == n_c
                                 else construct_info_set(n_c, k_c, method="gaussian_bitrev"))
        return info_of[n_c, k_c]

    def k1_layout(n_c, M):
        if M > scl_cuda.DEEP_MAX_M:
            return f"a cluster of {scl_cuda.cluster_blocks(M)} blocks"
        if M > scl_cuda.PATH_MAX_M:
            wide = M > 128 and n_c > 8192
            return f"over warps, {scl_cuda.trace_entry_bytes(M) * 8}-bit entries{', wide' if wide else ''}"
        if scl_cuda.byte_words(M, n_c):
            return "byte words"
        LM = scl_cuda.path_width(M)
        wide = 2 * int(math.log2(n_c)) - 2 > scl_cuda.NARROW_SIGMA_FIELDS[LM]
        return f"by path, LM={LM}{', wide' if wide else ''}"

    def k3_layout(n_p, L):
        if L > scl_cuda.DEEP_MAX_M:
            return f"a cluster of {scl_cuda.cluster_blocks(L)} blocks"
        if L > scl_cuda.PATH_MAX_M:
            wide = L > 128 and n_p > 8192
            return f"over warps, {scl_cuda.trace_entry_bytes(L) * 8}-bit entries{', wide' if wide else ''}"
        LM = 1 << (L - 1).bit_length()
        wide = 2 * int(math.log2(n_p)) - 2 > scl_cuda.NARROW_SIGMA_FIELDS.get(LM, 32)
        return f"one path a lane, LM={LM}{', wide' if wide else ''}"

    def long_split():
        """(c): a batch whose scratch the card cannot allocate goes in
        several launches (`scl_cuda.alloc_scratch`): K1 over warps at
        P(128,64), `LONG_SPLIT`, once with the card's memory free and once
        with all but about half the batch's scratch held by a blocker
        tensor; every output equal."""

        M, B = LONG_SPLIT
        info = construct_info_set(N, K)
        x = torch.from_numpy(make_llrs(np.random.default_rng(LONG_SEED + 2), B, 3.0, info)[0]).to(dev)
        whole = decode_scl_cuda(x, info, M, CRC)
        torch.cuda.synchronize()
        one = scl_cuda.scratch_bytes(1, N, K, M, scl_cuda.launch_plan(N, K, M, B)[0])
        torch.cuda.empty_cache()
        blocker = torch.empty((scl_cuda.card_free_bytes(dev) - one * B // 2,), dtype=torch.uint8, device=dev)
        try:
            free = scl_cuda.card_free_bytes(dev)
            reset_counts()
            split = decode_scl_cuda(x, info, M, CRC)
            torch.cuda.synchronize()
            launches = decode_scl_cuda.launches
        finally:
            del blocker
            torch.cuda.empty_cache()
        print(f"(c) a batch the card cannot allocate: K1 P({N},{K}) M={M} ({k1_layout(N, M)}) B={B}, "
              f"{B * one} bytes of scratch, with {free} bytes free (a blocker tensor holds the rest): "
              f"{launches} launches", flush=True)
        check(launches >= 2, f"a batch of {B * one} bytes of scratch with {free} bytes free went in {launches} "
              f"launch(es)")
        for f in whole:
            check(torch.equal(whole[f], split[f]), f"(c) the split batch's {f} differs from one launch's")

    gold = np.load(GOLDEN / "scl_f32_long.npz")
    gold_cases = json.loads(str(gold["cases"]))
    # every K1 and K3 shape of the phase: the golden file's, then (a)'s
    k1_shapes = ([(c["N"], c["K"], c["M"]) for c in gold_cases if c["kind"] == "scl"]
                 + [c[:3] for c in LONG_K1])
    k3_shapes = ([(c["N"], c["K"], c["L"]) for c in gold_cases if c["kind"] == "pac"]
                 + [c[:3] for c in LONG_K3])
    for n_c, k_c, M in k1_shapes:
        B = LONG_TIME_B[1] if M >= 1024 else LONG_TIME_B[0]
        g, fpb, per_sm = scl_cuda.launch_plan(n_c, k_c, M, B)
        print(f"  K1 N={n_c} K={k_c} M={M} ({k1_layout(n_c, M)}) at B={B}: levels 1..{g} in global "
              f"scratch ({scl_cuda.scratch_bytes(1, n_c, k_c, M, g)} B a frame); "
              f"{scl_cuda.frame_bytes(n_c, k_c, M, g)} B shared a {'block' if M > 1024 else 'frame'}; "
              f"{fpb} frames a block; {per_sm} frames {'at once' if M > 1024 else 'an SM'}")
    for n_p, k_p, L in k3_shapes:
        g, fpb, per_sm = pac_cuda.launch_plan(n_p, k_p + PAC_CRC[0], L)
        print(f"  K3 N={n_p} Kp={k_p + PAC_CRC[0]} L={L}: levels 1..{g} in global scratch "
              f"({pac_cuda.scratch_bytes(1, n_p, k_p + PAC_CRC[0], L, g)} B a frame); "
              f"{pac_cuda.frame_bytes(n_p, k_p + PAC_CRC[0], L, g)} B shared a {'block' if L > 1024 else 'frame'}"
              f"; {fpb} frames a block; {per_sm} frames {'at once' if L > 1024 else 'an SM'}", flush=True)

    def long_path():
        """(c): the FER CLI at P(16384,8192) M=8 through K1, and the scalar
        and legacy calls at N=16384.  Returns (K1 launches of the sweep, the
        scalar calls' K1 and K3 launches)."""

        n_f, k_f, frames, batch, snr = LONG_FER
        reset_counts()
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
            rows = run_fer_sweep.main([
                "--M", "8", "--N", str(n_f), "--K", str(k_f), "--construction", "gaussian_bitrev",
                "--snr_lo", str(snr), "--snr_hi", str(snr), "--snr_step", "0.5", "--retries", "8",
                "--batch", str(batch), "--frames", str(frames), "--seed", "0",
                "--out_dir", f"{tmp}/results", "--plot_dir", f"{tmp}/plots"])
            torch.cuda.synchronize()
        fer_s = time.perf_counter() - t
        fer_launches, plain = decode_scl_cuda.launches, sum(f.cuda_calls for f in plains)
        steps = frames // batch
        row = rows[0]
        print(f"(c) FER CLI P({n_f},{k_f}) gaussian_bitrev CRC-24A M=8, 8 retries, no β, {snr} dB: {frames} frames "
              f"at B={batch}: FER SCL {row['fer_scl']:.6e}, DL-SCL {row['fer_dl']:.6e}; {fer_launches} K1 launches "
              f"over {steps} steps; plain decoders on CUDA {plain} times; {frames / fer_s:.0f} frames/s "
              f"({fer_s:.1f} s, host clock, beside (a)'s plain calls in their workers)")
        check(len(rows) == 1 and all(math.isfinite(row[k]) and 0.0 <= row[k] < 1.0 for k in ("fer_scl", "fer_dl")),
              f"the FER sweep at N={n_f} gave {rows}")
        check(fer_launches >= steps + (8 if row["fer_scl"] > 0 else 0),
              f"the FER sweep at N={n_f} launched K1 {fer_launches} times over {steps} steps")
        check(plain == 0, f"a plain decoder ran on CUDA in the FER sweep at N={n_f}")

        info_f = code_info(n_f, k_f)
        llr_np, _ = make_llrs(np.random.default_rng(LONG_SEED), 1, 2.0, info_f, n=n_f)
        crc16 = legacy_crc(*PAC_CRC)
        pac_mask_f = pac_mask(n_f, k_f + PAC_CRC[0])
        pc = PolarCode(n_f, k_f + PAC_CRC[0], "dega", 8, rateprofile(n_f, k_f + PAC_CRC[0], 2.0, 0))
        rng = np.random.default_rng(LONG_SEED + 1)
        msg = rng.integers(0, 2, (1, k_f)).astype(np.int8)
        msg = np.concatenate([msg, crc16.crcCalc_batch(msg)], axis=1)
        nv = 1.0 / (2.0 * (k_f / n_f) * 10 ** (2.0 / 10.0))
        sys_cw = pc.encode(msg[0], True)
        sys_llr = (2.0 * (1.0 - 2.0 * sys_cw + rng.normal(0.0, math.sqrt(nv), sys_cw.shape)) / nv).astype(np.float32)
        pac_x = pac_llrs(rng, 1, 2.0, (n_f, k_f, PAC_CRC), PAC_GEN, pac_mask_f, dev)
        reset_counts()
        scl_out = decode_scl(llr_np[0], info_f, 8, CRC)
        legacy_out = pac_decode(pac_x, pac_mask_f, PAC_GEN, 8, crc_len=PAC_CRC[0], crc_poly=PAC_CRC[1])
        sys_out = pc.pac_list_crc_decoder(sys_llr, True, True, crc16, 8)
        torch.cuda.synchronize()
        scalar = tuple(f.launches for f in wrappers)
        plain = tuple(f.cuda_calls for f in plains)
        print(f"(c) decode_scl P({n_f},{k_f}) M=8, pac_decode PAC({n_f},{k_f})+CRC-16 L=8 and the systematic "
              f"PolarCode({n_f}, {k_f + PAC_CRC[0]}) L=8 decoder, one frame each at 2.0 dB: K1/K3 launches {scalar}; "
              f"plain decoders on CUDA {plain}")
        check(scalar == (1, 2) and plain == (0, 0), f"the scalar calls launched {scalar}, plain {plain}")
        batch_out = decode_scl_cuda(torch.from_numpy(llr_np).to(dev), info_f, 8, CRC, full=True)
        check(np.array_equal(scl_out["best_path_bits"], batch_out["best_path_bits"][0].cpu().numpy()),
              "decode_scl at N=16384 differs from K1's batch launch")
        want = pac_list_decode_cuda(pac_x, pac_mask_f, PAC_GEN, 8, *PAC_CRC)["extracted"]
        check(torch.equal(legacy_out["extracted"], want), "pac_decode at N=16384 differs from K3's batch launch")
        lst = pac_list_decode_cuda(torch.from_numpy(sys_llr)[None].to(dev), pc.polarcode_mask, pc.gen, 8, *PAC_CRC,
                                   full=True)
        coded = polar_transform(lst["v_full"][0].to(torch.int8)).cpu().numpy()[:, np.asarray(pc.polarcode_mask) == 1]
        valid = lst["valid"][0].cpu().numpy()
        pick = next((c for c, v in zip(coded.astype(int), valid) if v and sum(crc16.crcCalc(c)) == 0),
                    coded[0].astype(int))
        check(np.array_equal(sys_out, pick), "the systematic PolarCode at N=16384 differs from K3's list launch")
        print(f"  each equal to its batch kernel's launch on the same frame; K1's batch crc pass "
              f"{bool(batch_out['crc_pass'][0])}, pac_decode crc pass {bool(legacy_out['crc_pass'][0])}, PolarCode "
              f"decoded the sent message: {bool(np.array_equal(sys_out, msg[0]))}", flush=True)

        return fer_launches, scalar

    # ---- (a) and (b): the kernels against the plain versions, and both against JAX ----
    # every plain call of (a) and (b) goes to the workers at once, the
    # longest first (N=65536, then M or L >= 1024); (c) runs while they work
    jobs, inputs = {}, {}
    for case in (c for c in gold_cases if c["kind"] == "scl"):
        llr_np = gold[f"{case['code']}/llr"]
        jobs[case["name"]] = ("scl", (llr_np, gold[f"{case['code']}/info"], case["M"], case["crc"], None))
    for n_c, k_c, M, B, use_plan in LONG_K1:
        rng = np.random.default_rng(LONG_SEED + n_c + M)
        info_c = code_info(n_c, k_c)
        llr_np, msg = make_llrs(rng, B, LONG_SNR, info_c, n=n_c)
        plan_np = random_plan(rng, msg) if use_plan else None
        inputs["K1", n_c, k_c, M] = (llr_np, plan_np)
        jobs["K1", n_c, k_c, M] = ("scl", (llr_np, info_c, M, CRC, plan_np))
    for case in (c for c in gold_cases if c["kind"] == "pac"):
        name = case["name"]
        jobs[name] = ("pac", (gold[f"{name}/llr"], gold[f"{name}/mask"], case["gen"], case["L"], case["crc_len"],
                              case["crc_poly"]))
    for n_p, k_p, L, B in LONG_K3:
        mask = pac_mask(n_p, k_p + PAC_CRC[0])
        x = pac_llrs(np.random.default_rng(LONG_SEED + n_p + L), B, LONG_SNR, (n_p, k_p, PAC_CRC), PAC_GEN, mask,
                     dev)
        inputs["K3", n_p, k_p, L] = (x, mask)
        jobs["K3", n_p, k_p, L] = ("pac", (x.cpu().numpy(), mask, PAC_GEN, L, *PAC_CRC))
    def cost(key):  # the code length, then list sizes of 1024 and more
        kind, args = jobs[key]
        return args[0].shape[1], args[2 if kind == "scl" else 3] >= 1024

    order = sorted(jobs, key=cost, reverse=True)
    pool = ProcessPoolExecutor(LONG_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = {key: pool.submit(plain_reference, *jobs[key], str(dev)) for key in order}
        t_pool = time.perf_counter()
        print(f"  {len(jobs)} plain calls submitted to {LONG_WORKERS} worker processes", flush=True)
        fer_launches, scalar = long_path()

        def plain_of(key):
            res, secs = futures[key].result()
            plain_s[key] = secs
            return res

        differ = ties = 0
        k1_err = 0.0
        plain_s = {}
        for case in (c for c in gold_cases if c["kind"] == "scl"):
            tag, code, M = case["name"], case["code"], case["M"]
            x = torch.from_numpy(gold[f"{code}/llr"]).to(dev)
            kept = {}
            (d, t_, e), (db, tb, eb) = k1_vs_plain(x, gold[f"{code}/info"], M, case["crc"], None,
                                                    f"(a) P({case['N']},{case['K']}) M={M} golden LLRs",
                                                    keep=kept, ref=plain_of(tag))
            check(d + db == 0, f"(a) {tag}: K1 differs from the plain version in {d + db} frames, {t_ + tb} "
                  f"of them near-ties: the kernel runs the plain version's float operations")
            differ, ties, k1_err = differ + d + db, ties + t_ + tb, max(k1_err, e, eb)
            # (b): K1's list and the plain version against the JAX float32 decoder's outputs
            ref = {"best_path_bits": gold[f"{tag}/bits"], "best_path_info_llrs": gold[f"{tag}/llrs"],
                   "crc_pass": gold[f"{tag}/crc_pass"], "metrics": gold[f"{tag}/metrics"]}
            check(ref["metrics"].shape == tuple(kept["k1"]["metrics"].shape), f"{tag}: golden metrics shape")
            dj, tj, _ = judge_list(kept["k1"], ref, f"(b) vs JAX f32 {tag}")
            dp, tp, _ = judge_list({f: torch.from_numpy(v) for f, v in kept["plain"].items()}, ref,
                                   f"(b) plain vs JAX f32 {tag}", kept["plain"]["metrics"])
            print(f"  (a), (b) P({case['N']},{case['K']}) M={M} ({k1_layout(case['N'], M)}) on the golden "
                  f"file's {x.shape[0]} frames: K1 list and best-only equal to the plain version; K1 {dj} and "
                  f"the plain version {dp} frames from JAX float32 ({tj}, {tp} near-ties); crc pass "
                  f"{int(ref['crc_pass'].sum())}", flush=True)
        for n_c, k_c, M, B, use_plan in LONG_K1:
            llr_np, plan_np = inputs["K1", n_c, k_c, M]
            plan = torch.from_numpy(plan_np).to(dev) if use_plan else None
            tag = f"(a) P({n_c},{k_c}) M={M} ({k1_layout(n_c, M)}) plan={'on' if use_plan else 'off'} B={B}"
            (d, t_, e), (db, tb, eb) = k1_vs_plain(torch.from_numpy(llr_np).to(dev), code_info(n_c, k_c), M,
                                                    CRC, plan, tag, ref=plain_of(("K1", n_c, k_c, M)))
            check(d + db == 0, f"{tag}: K1 differs from the plain version in {d + db} frames, {t_ + tb} of "
                  f"them near-ties: the kernel runs the plain version's float operations")
            differ, ties, k1_err = differ + d + db, ties + t_ + tb, max(k1_err, e, eb)
            print(f"  {tag}: list and best-only equal to the plain version", flush=True)
        print(f"(a) K1 at N 16384-65536 vs plain: {len(k1_shapes)} cases, list and best-only, {differ} frames "
              f"differ (none allowed); max |info LLR diff| {k1_err:.3e}")

        k3_err = 0.0
        for case in (c for c in gold_cases if c["kind"] == "pac"):
            name = case["name"]
            x = torch.from_numpy(gold[f"{name}/llr"]).to(dev)
            ref = {f: torch.from_numpy(v) for f, v in plain_of(name).items()}
            out = pac_list_decode_cuda(x, gold[f"{name}/mask"], case["gen"], case["L"], case["crc_len"],
                                       case["crc_poly"], full=True)
            k3_err = max(k3_err, k3_list_vs_plain(x, gold[f"{name}/mask"], case["gen"], case["L"],
                                                  case["crc_len"], case["crc_poly"], f"(a) {name}", out=out,
                                                  ref=ref))
            best = pac_list_decode_cuda(x, gold[f"{name}/mask"], case["gen"], case["L"], case["crc_len"],
                                        case["crc_poly"])
            for f in ("extracted", "crc_pass"):
                check(torch.equal(best[f].cpu(), ref[f]), f"(a) {name} best-only: K3's {f} differs")
            for f in ("extracted", "crc_pass", "metrics", "v_full", "candidates"):
                want = gold[f"{name}/{f}"]
                for who, have in (("K3", out[f]), ("the plain version", ref[f])):
                    have = have.cpu().numpy()
                    check(have.shape == want.shape and np.array_equal(have.astype(want.dtype), want),
                          f"(b) {who} {name}: {f} differs from the JAX decoder's")
            print(f"  (a), (b) {name} on the golden file's {x.shape[0]} frames: K3 list and best-only equal to "
                  f"the plain version, and K3 and the plain version equal to the JAX decoder in every field; crc "
                  f"pass {int(gold[f'{name}/crc_pass'].sum())}", flush=True)
        for n_p, k_p, L, B in LONG_K3:
            x, mask = inputs["K3", n_p, k_p, L]
            tag = f"(a) PAC({n_p},{k_p})+CRC-16 L={L} ({k3_layout(n_p, L)}) B={B}"
            ref = {f: torch.from_numpy(v) for f, v in plain_of(("K3", n_p, k_p, L)).items()}
            k3_err = max(k3_err, k3_list_vs_plain(x, mask, PAC_GEN, L, *PAC_CRC, tag, ref=ref))
            best = pac_list_decode_cuda(x, mask, PAC_GEN, L, *PAC_CRC)
            for f in ("extracted", "crc_pass"):
                check(torch.equal(best[f].cpu(), ref[f]), f"{tag} best-only: K3's {f} differs from the plain "
                      f"version")
            print(f"  {tag}: list ({', '.join(PAC_LIST_FIELDS)}) and best-only equal to the plain version; crc "
                  f"pass {int(ref['crc_pass'].sum())}", flush=True)
        print(f"(a) K3 at N 16384-65536 vs plain: {len(k3_shapes)} cases, every list field and best-only equal "
              f"(max |diff| {k3_err}); (b) K1 and K3 and their plain versions against the JAX golden file: "
              f"{len(gold_cases)} cases")
        print(f"  the plain calls in {LONG_WORKERS} workers: {time.perf_counter() - t_pool:.1f} s from submission "
              f"to the last comparison (host clock); each call's own seconds:")
        for key in order:
            print(f"    {key}: {plain_s[key]:.1f} s")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    long_split()

    # ---- (d) times with CUDA events ----
    print(f"long-code times on {smi}:")
    entries = {}
    for n_c, k_c, M in k1_shapes:
        B = LONG_TIME_B[1] if M >= 1024 else LONG_TIME_B[0]
        info_c = code_info(n_c, k_c)
        x = torch.from_numpy(make_llrs(np.random.default_rng(9), B, LONG_SNR, info_c, n=n_c)[0]).to(dev)
        ms = cuda_time_ms(lambda: decode_scl_cuda(x, info_c, M, CRC), reps=1, warmup=1)
        b_ms, b_by = bound(*scl_work(info_c, M, B, n=n_c, k=k_c))
        g, fpb, per_sm = scl_cuda.launch_plan(n_c, k_c, M, B)
        line = (f"  K1 P({n_c},{k_c}) M={M} ({k1_layout(n_c, M)}) CRC B={B} {LONG_SNR} dB: {ms:.4f} ms; bound "
                f"{b_ms:.6f} ms ({b_by}); G={g}, {fpb} frames a block, {per_sm} frames "
                f"{'at once' if M > 1024 else 'an SM'}")
        if (n_c, M) == (LONG_FER[0], 8):  # the path's code: the `kernels` line
            plain_ms = cuda_time_ms(lambda: decode_scl_batch(x, info_c, M, CRC, dtype=torch.float32), reps=1,
                                    warmup=0)
            entries["scl"] = (ms, plain_ms, b_ms, b_by)
            line += f"; plain {plain_ms:.4f} ms"
        print(line, flush=True)
    for n_p, k_p, L in k3_shapes:
        B = LONG_TIME_B[1] if L >= 1024 else LONG_TIME_B[0]
        mask = pac_mask(n_p, k_p + PAC_CRC[0])
        x = pac_llrs(np.random.default_rng(10), B, LONG_SNR, (n_p, k_p, PAC_CRC), PAC_GEN, mask, dev)
        ms = cuda_time_ms(lambda: pac_list_decode_cuda(x, mask, PAC_GEN, L, *PAC_CRC), reps=1, warmup=1)
        b_ms, b_by = bound(*pac_work(mask, L, B))
        g, fpb, per_sm = pac_cuda.launch_plan(n_p, k_p + PAC_CRC[0], L)
        line = (f"  K3 PAC({n_p},{k_p})+CRC-16 L={L} B={B} {LONG_SNR} dB: {ms:.4f} ms; bound {b_ms:.6f} ms "
                f"({b_by}); G={g}, {fpb} frames a block, {per_sm} frames {'at once' if L > 1024 else 'an SM'}")
        if (n_p, L) == (LONG_FER[0], 8):
            plain_ms = cuda_time_ms(lambda: pac_list_decode_batch(x, mask, PAC_GEN, L, crc_len=PAC_CRC[0],
                                                                  crc_poly=PAC_CRC[1]), reps=1, warmup=0)
            entries["pac"] = (ms, plain_ms, b_ms, b_by)
            line += f"; plain {plain_ms:.4f} ms"
        print(line, flush=True)

    print(f"phase long_codes (a)-(d): {time.perf_counter() - t_phase:.1f} s")

    # ---- (e) the SASS of the N <= 8192 instantiations against the parent's ----
    parent = REPO / "smoke_checkout" / "parent"
    if (parent / "polar_code_tpu_torch" / "csrc").is_dir():
        out = subprocess.run([sys.executable, str(REPO / "tools" / "compare_sass.py"), "--repo", str(parent)],
                             capture_output=True, text=True, timeout=600)
        print(out.stdout.rstrip())
        summary = [ln for ln in out.stdout.splitlines() if "kernels with the same SASS" in ln]
        print(f"(e) SASS against {parent}: {'; '.join(summary) or out.stderr[-500:]}")
    else:
        print("(e) SASS: no parent checkout in smoke_checkout/parent here; `tools/compare_sass.py --repo "
              "<parent>` compares the N <= 8192 instantiations in a call of their own (PERF.md, §6)")

    launches = {"scl": fer_launches + scalar[0], "pac": scalar[1]}
    errors = {"scl": k1_err, "pac": k3_err}
    names = {"scl": ("scl_decode (N 16384-65536)", "polar_code_tpu_torch/csrc/scl_decode.cu",
                     "polar_code_tpu/ops/scl_pallas.py:293"),
             "pac": ("pac_decode (N 16384-65536)", "polar_code_tpu_torch/csrc/pac_decode.cu",
                     "polar_code_tpu/legacy/pac_pallas.py:59")}
    return [{"name": names[k][0], "route": "cuda", "source": names[k][1], "replaces": names[k][2],
             "launches": launches[k], "max_abs_err": errors[k], "ms": entries[k][0], "plain_ms": entries[k][1],
             "bound_ms": entries[k][2], "bound_by": entries[k][3], "library_ms": None}
            for k in ("scl", "pac")]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from polar_code_tpu_torch import _build
    from polar_code_tpu_torch.channel import noise_var_coded, noise_var_uncoded
    from polar_code_tpu_torch.eval import run_ber_sweep, run_fer_sweep
    from polar_code_tpu_torch.interop import load_beta
    from polar_code_tpu_torch.legacy import crc_polar_ofdm_ls, crc_polar_vs_uncoded, pac_cuda, simulator
    from polar_code_tpu_torch.legacy.pac import pac_list_decode_batch
    from polar_code_tpu_torch.legacy.pac_cuda import pac_list_decode_cuda
    from polar_code_tpu_torch.nr.ldpc import nms_cuda
    from polar_code_tpu_torch.nr.ldpc.decode_nms import decode_ldpc_nms_batch
    from polar_code_tpu_torch.nr.ldpc.nms_cuda import decode_ldpc_nms_cuda
    from polar_code_tpu_torch.ops import scl_cuda
    from polar_code_tpu_torch.ops.scl import decode_scl_batch
    from polar_code_tpu_torch.polar.construct import construct_info_set
    from polar_code_tpu_torch.sim.pipeline import make_ber_chunk, make_fer_chunk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    info_set = construct_info_set(N, K)

    def reset_counts():
        scl_cuda.decode_scl_cuda.launches = 0
        decode_ldpc_nms_cuda.launches = 0
        decode_scl_batch.cuda_calls = 0
        decode_ldpc_nms_batch.cuda_calls = 0

    def counts():
        return (scl_cuda.decode_scl_cuda.launches, decode_ldpc_nms_cuda.launches,
                decode_scl_batch.cuda_calls + decode_ldpc_nms_batch.cuda_calls)

    # ---- 1. device ----
    device_kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"device: {device_kind} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    phase_done("1 device")

    # ---- 2. build: one nvcc a source, all started together ----
    sources = {"scl": scl_cuda.SOURCE, "nms": nms_cuda.SOURCE, "pac": pac_cuda.SOURCE}
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        builds = dict(zip(sources, pool.map(_build.build, sources.values())))
    for built in builds.values():
        print(f"build: {built.path.name} in {built.seconds:.2f} s"
              + (" (reused an identical earlier build)" if built.cached else ""))
        for row in ptxas_report(built.log):
            print(f"  ptxas {row['entry']}: {row['regs']} registers, {row['smem']} B static smem, "
                  f"spills {row['spill_stores']} B stores / {row['spill_loads']} B loads")
    scl_cuda._library()
    k1_resident = {}
    for n_s, k_s, M in ([(N, K, M) for M in scl_cuda.BYTE_WORD_M]
                        + [(n_c, k_c, M) for n_c, k_c in K1C_SHAPES for M in (1, 8)]):
        g, fpb, k1_resident[n_s, M] = scl_cuda.launch_plan(n_s, k_s, M, 4096)
        fb = scl_cuda.frame_bytes(n_s, k_s, M, g)
        print(f"  K1 N={n_s} K={k_s} M={M}: levels 1..{g} in global scratch; dynamic smem "
              f"{fb} B per frame x {fpb} frames = {fb * fpb} B per block; "
              f"{k1_resident[n_s, M]} resident frames an SM (occupancy calculator)")
    check(k1_resident[2048, 8] > 1, "K1 holds one frame an SM at N=2048 M=8")
    k3_resident = {}
    for n_p, kp, L in ([(n_p, k_p + crc_p[0], L) for n_p, (_, k_p, crc_p) in PAC_CODES.items()
                        for L in (1, 8, 16, 32)] + [(512, 272, 8), (512, 272, 32), (1024, 528, 32)]):
        g, fpb, k3_resident[n_p, L] = pac_cuda.launch_plan(n_p, kp, L)
        fb = pac_cuda.frame_bytes(n_p, kp, L, g)
        print(f"  K3 N={n_p} Kp={kp} L={L}: levels 1..{g} in global scratch; dynamic smem "
              f"{fb} B per frame x {fpb} frames = {fb * fpb} B per block; "
              f"{k3_resident[n_p, L]} resident frames an SM (occupancy calculator)")
    check(k3_resident[1024, 32] >= 4, "K3 holds fewer than 4 frames an SM at N=1024 L=32")
    nms_cuda._library()
    where = {True: "shared memory", False: "global scratch"}
    k2_shapes = [(IRA[1], IRA[2]), (DEMO[1], DEMO[2]), (f"ira{BIG[0]}x{BIG[1]}", BIG[2])]
    for spec, Z in dict.fromkeys(k2_shapes + [(k[0], k[1]) for k in K2D]):
        bg = base_graph(spec, Z)
        for se in (True, False):
            plan = nms_cuda.launch_plan(bg, Z, se, dev)
            lay = plan.layout
            mode = {nms_cuda.WARP: "a warp a frame", nms_cuda.BLOCK: "a block a frame",
                    nms_cuda.BLOCK_1024: "a block a frame (64-register build)"}[plan.mode]
            per_frame = lay.frame_bytes if plan.mode == nms_cuda.WARP else plan.smem
            print(f"  K2 {spec} Z={Z} {'two-min' if se else 'shared'}: {mode}, {lay.D} edges in "
                  f"registers, records of {lay.nw} words a row in {where[lay.records_in_smem]}; "
                  f"{per_frame} B shared a frame, {plan.smem} B a block of {plan.frames_per_block} "
                  f"frames ({plan.threads} threads, {plan.regs} registers); {plan.frames_per_sm} "
                  f"frames an SM (occupancy calculator)")
            check(plan.frames_per_sm >= 1, f"K2 cannot place a frame of {spec} Z={Z}")
    pac_cuda._library()
    phase_done("2 build")

    # ---- 3. K1 against its plain version ----
    rng = np.random.default_rng(20261017)
    cases = [(M, crc, plan, snr, 4096)
             for M in scl_cuda.BYTE_WORD_M for crc in (CRC, None)
             for plan in (False, True) for snr in (3.0, 5.0, 7.0)]
    # ragged batches: not a multiple of 128 frames, and (1001) of the block
    cases += [(8, CRC, True, 5.0, 1000), (4, CRC, False, 5.0, 1001)]
    max_abs_err = 0.0
    near_ties = []

    def judge(out, rb, rp, rl, metrics, tag, against="the plain version"):
        """Mismatched frames of K1's outputs against a reference's bits, pass
        flags, info LLRs and final metrics; fails on one outside near-ties.
        `max_abs_err` tracks the comparisons with the plain version."""

        nonlocal max_abs_err
        kb, kp, kl = (out[k].cpu().numpy() for k in ("best_path_bits", "crc_pass",
                                                      "best_path_info_llrs"))
        llr_ok = np.abs(kl - rl) <= 1e-6 * np.maximum(np.abs(rl), 1e-30)
        bad = np.any(kb != rb, axis=1) | (kp != rp) | ~np.all(llr_ok, axis=1)
        ties = near_tie_frames(metrics)
        unexplained = bad & ~ties
        if bad.any():
            for f in np.flatnonzero(bad):
                near_ties.append(f"{tag} frame {f}")
            print(f"  {tag}: {int(bad.sum())} mismatched frames, {int((bad & ties).sum())} near-ties")
        check(not unexplained.any(),
              f"kernel disagrees with {against} ({tag}): frames "
              f"{np.flatnonzero(unexplained)[:10].tolist()}")
        if against == "the plain version" and kl.size:
            max_abs_err = max(max_abs_err, float(np.max(np.abs(kl - rl))))
        return kb, kp, bad

    def compare_scl(llr, info, M, crc, plan, tag, msg=None, show=False):
        out = scl_cuda.decode_scl_cuda(llr, info, M, crc, force_info_bits=plan)
        torch.cuda.synchronize()
        ref = decode_scl_batch(llr, info, M, crc, force_info_bits=plan, dtype=torch.float32)
        torch.cuda.synchronize()
        kb, kp, bad = judge(out, ref.best_path_bits.cpu().numpy(), ref.crc_pass.cpu().numpy(),
                            ref.best_path_info_llrs.cpu().numpy(), ref.metrics.cpu().numpy(), tag)
        if show:
            sent = f", bit errors vs sent {int((kb != msg).sum())}" if msg is not None else ""
            print(f"  {tag}: {int(bad.sum())} frames differ; crc pass {int(kp.sum())}/{len(kp)}"
                  f"{sent}", flush=True)

    for M, crc, use_plan, snr, B in cases:
        llr_np, msg = make_llrs(rng, B, snr, info_set)
        llr = torch.from_numpy(llr_np).to(dev)
        plan = torch.from_numpy(random_plan(rng, msg)).to(dev) if use_plan else None
        tag = f"M={M} crc={'on' if crc else 'off'} plan={'on' if use_plan else 'off'} {snr} dB B={B}"
        compare_scl(llr, info_set, M, crc, plan, tag, msg, show=(snr == 5.0 and B == 4096))
    print(f"K1 vs plain: {len(cases)} cases, near-tie mismatches {len(near_ties)}, "
          f"max |info LLR diff| {max_abs_err:.3e}")
    for line in near_ties:
        print(f"  near-tie: {line} (seed 20261017)")
    # K1 against the JAX package's float32 XLA decoder, through the golden
    # file that tests/golden/make_scl_f32.py wrote on the CPU
    ties_before = len(near_ties)
    with np.load(GOLDEN / "scl_f32_decode.npz") as gold:
        f32_cases = json.loads(str(gold["cases"]))
        for case in f32_cases:
            tag, code = case["name"], case["code"]
            x = torch.from_numpy(gold[f"{code}/llr"]).to(dev)
            plan = torch.from_numpy(gold[f"{code}/plan"]).to(dev) if case["plan"] else None
            out = scl_cuda.decode_scl_cuda(x, gold[f"{code}/info"], case["M"], case["crc"],
                                           force_info_bits=plan)
            torch.cuda.synchronize()
            _, kp, bad = judge(out, gold[f"{tag}/bits"], gold[f"{tag}/crc_pass"],
                               gold[f"{tag}/llrs"], gold[f"{tag}/metrics"], f"JAX f32 {tag}",
                               against="the JAX float32 decoder")
            print(f"  K1 vs JAX float32 {tag} (B={x.shape[0]}): {int(bad.sum())} frames differ; "
                  f"crc pass {int(kp.sum())}", flush=True)
    print(f"K1 vs JAX float32: {len(f32_cases)} cases, near-tie mismatches "
          f"{len(near_ties) - ties_before}")
    phase_done("3 K1 vs plain and JAX float32")

    # ---- 3b. K1 at BER run (c)'s shape ----
    n_r, k_r, _, _, m_r = NR_POLAR
    info_r = construct_info_set(n_r, k_r)
    ties_before = len(near_ties)
    for snr in (3.5, 4.0):
        llr_r, msg_r = nr_polar_llrs(rng, 4096, snr, info_r)
        compare_scl(llr_r.to(dev), info_r, m_r, CRC, None,
                    f"NR polar N={n_r} K={k_r} M={m_r} {snr} dB B=4096", msg_r, show=True)
    print(f"K1 at NR polar: 2 cases, near-tie mismatches {len(near_ties) - ties_before}")
    phase_done("3b K1 at NR polar")

    # ---- 3c. K1 at N from 256 to 2048 ----
    k1c_ms = {}
    ties_before = len(near_ties)
    for n_c, k_c in K1C_SHAPES:
        info_c = construct_info_set(n_c, k_c)
        for M in (2, 8):
            llr = torch.from_numpy(
                np.random.default_rng(n_c + M).normal(0.0, 2.0, (256, n_c)).astype(np.float32)).to(dev)
            compare_scl(llr, info_c, M, CRC, None, f"N={n_c} K={k_c} M={M} B=256", show=True)
        big = torch.from_numpy(np.random.default_rng(n_c).normal(0.0, 2.0, (4096, n_c))
                               .astype(np.float32)).to(dev)
        k1c_ms[n_c] = cuda_time_ms(lambda: scl_cuda.decode_scl_cuda(big, info_c, 8, CRC), reps=10)
        g, fpb, per_sm = scl_cuda.launch_plan(n_c, k_c, 8, 4096)
        print(f"  K1 N={n_c} K={k_c} B=4096 M=8 CRC: {k1c_ms[n_c]:.4f} ms a decode (10 launches); "
              f"{scl_cuda.frame_bytes(n_c, k_c, 8, g)} B smem a frame, {fpb} frames a block, "
              f"{per_sm} an SM", flush=True)
    print(f"K1c: {2 * len(K1C_SHAPES)} cases, near-tie mismatches {len(near_ties) - ties_before}")

    # K1d: the rest of the envelope, B=256 codeword LLRs at 1-4 dB a frame
    rng = np.random.default_rng(20261020)
    d_cases = [(64, 32, M, crc, plan, 256) for M in scl_cuda.BYTE_WORD_M
               for crc in (CRC, None) for plan in (False, True)]
    for n_c, k_c in K1C_SHAPES:
        d_cases += [(n_c, k_c, 8, None, False, 256), (n_c, k_c, 8, CRC, True, 256),
                    (n_c, k_c, 1, CRC, False, 256), (n_c, k_c, 4, CRC, False, 256)]
    d_cases.append((2048, 1024, 8, CRC, True, 1001))  # ragged
    ties_before = len(near_ties)
    for n_c, k_c, M, crc, use_plan, B in d_cases:
        # the construction the repository's N > 128 sweeps use
        info_c = construct_info_set(n_c, k_c, method="gaussian_bitrev" if n_c > N else "gaussian")
        llr_np, msg = make_llrs(rng, B, rng.uniform(1.0, 4.0, (B, 1)), info_c, n=n_c)
        plan = torch.from_numpy(random_plan(rng, msg)).to(dev) if use_plan else None
        compare_scl(torch.from_numpy(llr_np).to(dev), info_c, M, crc, plan,
                    f"N={n_c} K={k_c} M={M} crc={'on' if crc else 'off'} "
                    f"plan={'on' if use_plan else 'off'} B={B}", msg, show=True)
    print(f"K1d: {len(d_cases)} cases, near-tie mismatches {len(near_ties) - ties_before}")
    phase_done("3c K1 at N 64..2048")

    # ---- 3d. where K1's time goes: levers of the kernel, CUDA events ----
    print(f"K1 times on {smi} (M=8 CRC-24A unless stated):")
    for n_c, k_c in ((1024, 512), (2048, 1024)):
        info_c = np.asarray(construct_info_set(n_c, k_c), np.int64)
        big = torch.from_numpy(np.random.default_rng(n_c).normal(0.0, 2.0, (4096, n_c))
                               .astype(np.float32)).to(dev)
        for g in range(6):  # tree levels in global scratch; `launch_plan` picks one
            fpb, per_sm = scl_cuda._occupancy(n_c, k_c, 8, g)
            ms = cuda_time_ms(lambda: scl_cuda._launch(big, info_c, 8, CRC, None, g, fpb),
                              reps=5, warmup=1)
            print(f"  N={n_c} B=4096 levels 1..{g} in global scratch: {ms:.4f} ms "
                  f"({scl_cuda.frame_bytes(n_c, k_c, 8, g)} B smem a frame, "
                  f"{per_sm} resident frames an SM)", flush=True)
    for n_c, k_c in ((N, K), (2048, 1024)):
        info_c = construct_info_set(n_c, k_c)
        x = torch.from_numpy(np.random.default_rng(n_c + 1).normal(0.0, 2.0, (16384, n_c))
                             .astype(np.float32)).to(dev)
        for M in ((1, 2, 4) if n_c == 2048 else ()):  # phase 5 times them at N=128
            xs = x[:4096].contiguous()
            ms = cuda_time_ms(lambda: scl_cuda.decode_scl_cuda(xs, info_c, M, CRC), reps=5, warmup=1)
            print(f"  N={n_c} B=4096 M={M}: {ms:.4f} ms", flush=True)
        for B in (64, 1024, 4096, 16384):
            xs = x[:B].contiguous()
            ms = cuda_time_ms(lambda: scl_cuda.decode_scl_cuda(xs, info_c, 8, CRC), reps=5, warmup=1)
            print(f"  N={n_c} B={B} M=8: {ms:.4f} ms ({B / ms * 1e3:.0f} frames/s)", flush=True)
    phase_done("3d K1 levers")

    # ---- 4. the FER path: the FER sweep CLI on the card ----
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        rows = run_fer_sweep.main([
            "--M", "8", "--retries", "8", "--beta", str(REPO / "checkpoints" / "beta_M8.npy"),
            "--batch", "4096", "--frames", str(SWEEP_FRAMES),
            "--snr_lo", "4.0", "--snr_hi", "5.0", "--snr_step", "1.0",
            "--out_dir", f"{tmp}/results", "--plot_dir", f"{tmp}/plots",
        ])
        torch.cuda.synchronize()
        csv_text = Path(f"{tmp}/results/fer_M8.csv").read_text()
    fer_launches, _, plain_cuda = counts()
    steps = 2 * SWEEP_FRAMES // 4096
    print(f"FER path: {fer_launches} K1 launches over {steps} FER steps "
          f"({fer_launches / steps:.2f} a step), plain decoders on CUDA {plain_cuda} times")
    check(fer_launches >= steps, "the FER sweep did not go through the SCL kernel")
    check(plain_cuda == 0, "a plain decoder ran on CUDA in the FER sweep")
    check(csv_text.splitlines()[0] == "snr_db,fer_scl,ber_scl,fer_dl,ber_dl", "CSV header")
    jax_rows = {}
    for line in JAX_CSV.read_text().splitlines()[1:]:
        vals = line.split(",")
        jax_rows[float(vals[0])] = {"fer_scl": float(vals[3]), "fer_dl": float(vals[5])}
    for row in rows:
        for key in ("fer_scl", "fer_dl"):
            p1, p2 = row[key], jax_rows[row["snr_db"]][key]
            check(math.isfinite(p1) and 0.0 < p1 < 1.0, f"{key} at {row['snr_db']} dB is {p1}")
            z = fer_z(p1, SWEEP_FRAMES, p2, JAX_FRAMES_PER_POINT)
            print(f"  {row['snr_db']:.1f} dB {key}: port {p1:.6e} ({SWEEP_FRAMES} frames) vs "
                  f"JAX {p2:.6e} ({JAX_FRAMES_PER_POINT} frames): z = {z:+.3f}")
            check(abs(z) < 3.0, f"{key} at {row['snr_db']} dB is off the JAX sweep (z={z:.2f})")

    # the FER path at N=2048: the only path that gives K1 forced plans at large N
    state = json.loads((REPO / "results" / "n2048" / "sweep_state.json").read_text())
    jax_frames = math.ceil(state["config"]["frames"] / state["config"]["batch"]) * state["config"]["batch"]
    jax_row = state["rows"][f"{N2048_SNR:.4f}"]
    for key in ("fer_scl", "fer_dl"):  # the recorded rates are counts over jax_frames
        check(abs(jax_row[key] * jax_frames - round(jax_row[key] * jax_frames)) < 1e-6,
              f"results/n2048 {key} is not a count over {jax_frames} frames")
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        rows = run_fer_sweep.main([
            "--N", "2048", "--K", "1024", "--construction", "gaussian_bitrev",
            "--M", "8", "--retries", "8",
            "--beta", str(REPO / "checkpoints" / "n2048" / "beta_M8.npy"),
            "--batch", "4096", "--frames", str(N2048_FRAMES),
            "--snr_lo", str(N2048_SNR), "--snr_hi", str(N2048_SNR), "--snr_step", "1.0",
            "--out_dir", f"{tmp}/results", "--plot_dir", f"{tmp}/plots",
        ])
        torch.cuda.synchronize()
    fer2048_launches, _, plain_cuda = counts()
    print(f"FER path N=2048: {fer2048_launches} K1 launches over {N2048_FRAMES // 4096} FER steps, "
          f"plain decoders on CUDA {plain_cuda} times")
    check(fer2048_launches >= N2048_FRAMES // 4096, "the N=2048 FER sweep did not go through K1")
    check(plain_cuda == 0, "a plain decoder ran on CUDA in the N=2048 FER sweep")
    check(len(rows) == 1, f"the N=2048 FER sweep gave {len(rows)} points")
    for key in ("fer_scl", "fer_dl"):
        p1, p2 = rows[0][key], jax_row[key]
        check(math.isfinite(p1) and 0.0 < p1 < 1.0, f"N=2048 {key} is {p1}")
        z = fer_z(p1, N2048_FRAMES, p2, jax_frames)
        print(f"  N=2048 {N2048_SNR} dB {key}: port {p1:.6e} ({N2048_FRAMES} frames) vs "
              f"JAX {p2:.6e} ({jax_frames} frames): z = {z:+.3f}")
        check(abs(z) < 3.0, f"N=2048 {key} is off the JAX sweep (z={z:.2f})")

    # the rest of the FER envelope: P(128,64) at M 1, 2, 4, and P(N, N/2) M=8
    # at N 256-1024, each held to its JAX CSV
    env_launches = fer_envelope(reset_counts, counts)
    phase_done("4 FER path")

    # ---- 4b. the training path: datasets, β training and opcount on the card ----
    train_launches = training_path(reset_counts, counts)
    phase_done("4b training path")

    # ---- 5. FER times ----
    llr_np, _ = make_llrs(np.random.default_rng(5), 4096, 5.0, info_set)
    llr = torch.from_numpy(llr_np).to(dev)
    kernel_ms = cuda_time_ms(lambda: scl_cuda.decode_scl_cuda(llr, info_set, 8, CRC), reps=50)
    plain_ms = cuda_time_ms(
        lambda: decode_scl_batch(llr, info_set, 8, CRC, dtype=torch.float32), reps=20, warmup=2)
    bound_ms, bound_by = bound(*scl_work(info_set, 8, 4096))

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
    print(f"FER times on {smi}:")
    print(f"  K1, B=4096 M=8 CRC: {kernel_ms:.4f} ms a decode (50 launches)")
    print(f"  plain version, same decode: {plain_ms:.4f} ms (20 calls)")
    print(f"  bound: {bound_ms:.6f} ms ({bound_by})")
    print(f"  FER step at 5 dB (M=8, 8 retries, B=4096): {step_s * 1e3:.3f} ms, "
          f"{4096 / step_s:.0f} frames/s, {step_launches:.2f} K1 launches a step")
    for M in (1, 2, 4):
        ms = cuda_time_ms(lambda M=M: scl_cuda.decode_scl_cuda(llr, info_set, M, CRC), reps=50)
        print(f"  K1, B=4096 M={M} CRC: {ms:.4f} ms a decode (50 launches)")
    small = llr[:64].contiguous()  # about one retry step's failing frames at 5 dB
    ms = cuda_time_ms(lambda: scl_cuda.decode_scl_cuda(small, info_set, 8, CRC), reps=50)
    print(f"  K1, B=64 M=8 CRC: {ms:.4f} ms a decode (50 launches)")
    profile_steps(lambda i: torch.stack(list(chunk(2, 50, i, nv_c, nv_u).values())).tolist(),
                  "FER steps")
    phase_done("5 FER times")

    # ---- 6. K2 against its plain version ----
    codes = {c[0]: (c, ldpc_code(c[1], c[2])) for c in (IRA, DEMO)}
    rng = np.random.default_rng(20261018)
    nms_cases = []
    nms_max_err = 0

    def compare_nms(x, bg, Z, H, se, tag, max_iter=20):
        nonlocal nms_max_err
        out = decode_ldpc_nms_cuda(x, bg, Z, max_iter, 0.8, self_exclude=se)
        torch.cuda.synchronize()
        ref = decode_ldpc_nms_batch(x, H, max_iter, 0.8, self_exclude=se)
        torch.cuda.synchronize()
        bad = ((out["hard"] != ref["hard"]).any(dim=1) | (out["iters_used"] != ref["iters_used"])
               | (out["parity_ok"] != ref["parity_ok"])).cpu().numpy()
        diffs = [(out[k].to(torch.int32) - ref[k].to(torch.int32)).abs().max() for k in ref]
        nms_max_err = max([nms_max_err] + [int(d) for d in diffs])
        it = ref["iters_used"].cpu().numpy()
        print(f"  {tag}: {int(bad.sum())} frames differ; mean iterations {it.mean():.3f}, "
              f"{int((it < max_iter).sum())}/{len(it)} stopped early, "
              f"parity ok {int(ref['parity_ok'].sum())}", flush=True)
        check(not bad.any(), f"K2 disagrees with the plain version ({tag}): frames "
              f"{np.flatnonzero(bad)[:10].tolist()}")
        nms_cases.append(tag)

    for cname, (c, (bg, H)) in codes.items():
        for se in (False, True):
            for ebno in (1.0, 2.5, 4.0):
                x = ldpc_llrs(rng, (c, (bg, H)), 4096, ebno, dev)
                compare_nms(x, bg, c[2], H, se, f"{cname} {'two-min' if se else 'shared'} "
                            f"{ebno} dB B=4096")
    for B, (cname, se) in ((1000, (IRA[0], True)), (1001, (DEMO[0], False))):
        c, (bg, H) = codes[cname]
        x = ldpc_llrs(rng, (c, (bg, H)), B, 2.5, dev)
        compare_nms(x, bg, c[2], H, se, f"{cname} {'two-min' if se else 'shared'} 2.5 dB B={B}")
    big_bg, big_H = ldpc_code(f"ira{BIG[0]}x{BIG[1]}", BIG[2])
    big_n, big_k = BIG[1] * BIG[2], (BIG[1] - BIG[0]) * BIG[2]
    big_tag = f"ira{BIG[0]}x{BIG[1]} Z={BIG[2]}"
    for se in (True, False):
        for ebno in BIG_EBN0[se]:
            x = zero_codeword_llrs(rng, 64, big_n, big_k, ebno, dev)
            compare_nms(x, big_bg, BIG[2], big_H, se,
                        f"{big_tag} {'two-min' if se else 'shared'} {ebno} dB B=64")
    n_main = len(nms_cases)
    for spec, Z, modes, B, max_iter in K2D:
        bg, H = ldpc_code(spec, Z)
        x = spread_llrs(rng, B, H.shape[1], H.shape[1] - H.shape[0], dev)
        for se in modes:
            compare_nms(x, bg, Z, H, se, f"K2d {spec} Z={Z} {'two-min' if se else 'shared'} "
                        f"B={B} max_iter={max_iter}", max_iter)
    bg, H = codes[IRA[0]][1]
    x = torch.from_numpy(rng.integers(-3, 4, (1024, H.shape[1])).astype(np.float32)).to(dev)
    for se in (False, True):
        compare_nms(x, bg, IRA[2], H, se, f"K2d {IRA[0]} {'two-min' if se else 'shared'} "
                    "integer LLRs B=1024")
    print(f"K2 vs plain: {n_main} cases and {len(nms_cases) - n_main} K2d cases, every frame "
          f"identical (max |diff| {nms_max_err})")
    phase_done("6 K2 vs plain")

    # ---- 7. the BER path: the BER sweep CLI on the card ----
    reset_counts()
    ber_runs = [
        ("a", ["--scheme", "nr_ldpc", "--bg", "ira4x8", "--Z", "31", "--nms_exact",
               "--K_payload", "100", "--K_crc", "24", "--E", "248", "--EbN0_lo", "2.0",
               "--EbN0_hi", "3.0"], "ber_nr_ldpc_ira4x8.csv", 100),
        ("b", ["--scheme", "nr_ldpc", "--bg", "2", "--Z", "32", "--K_payload", "72",
               "--K_crc", "24", "--E", "384", "--EbN0_lo", "2.0", "--EbN0_hi", "2.0"],
         "ber_nr_ldpc_Z32_E384.csv", 72),
        ("c", ["--scheme", "nr_polar_scl", "--K_payload", "64", "--K_crc", "24", "--E", "256",
               "--N", "128", "--M", "4", "--EbN0_lo", "3.5", "--EbN0_hi", "4.0"],
         "ber_nr_polar_K88_E256_M4.csv", 64),
        ("d", ["--scheme", "polar_scl", "--K_payload", "40", "--K_crc", "24", "--E", "128",
               "--N", "128", "--M", "8", "--EbN0_lo", "5.0", "--EbN0_hi", "5.5"],
         "ber_polar_scl_M8.csv", 40),
        ("e", ["--scheme", "polar_scl", "--K_payload", "40", "--K_crc", "24", "--E", "128",
               "--N", "128", "--M", "8", "--adaptive_from", "2", "--EbN0_lo", "5.0",
               "--EbN0_hi", "5.0"], "ber_polar_scl_M8.csv", 40),
        ("f", ["--scheme", "dl_scl", "--K_payload", "40", "--K_crc", "24", "--E", "128",
               "--N", "128", "--M", "8", "--beta", str(REPO / "checkpoints" / "beta_M8.npy"),
               "--EbN0_lo", "5.0", "--EbN0_hi", "5.0"], None, 40),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        for run_id, argv, ref_csv, kp in ber_runs:
            before = counts()
            rows = run_ber_sweep.main(argv + [
                "--batch", "4096", "--seed", "0", "--err_cap", "1000000000",
                "--bits_cap", str(BER_FRAMES * kp), "--out", f"{tmp}/ber_{run_id}.csv"])
            torch.cuda.synchronize()
            d_scl, d_nms, d_plain = (a - b for a, b in zip(counts(), before))
            ldpc = argv[1] == "nr_ldpc"
            print(f"BER run ({run_id}) {' '.join(argv[:2])}: K1 launches {d_scl}, "
                  f"K2 launches {d_nms}, plain decoders on CUDA {d_plain}")
            check((d_nms if ldpc else d_scl) > 0, f"BER run ({run_id}) did not launch its kernel")
            check(d_plain == 0, f"a plain decoder ran on CUDA in BER run ({run_id})")
            ref = {float(r["EbN0_dB"]): r for r in csv_rows(REPO / "results" / ref_csv)} if ref_csv else {}
            for row in rows:
                frames = row["bits_total"] // kp
                check(frames == BER_FRAMES, f"BER run ({run_id}): {frames} frames, not {BER_FRAMES}")
                fer, work, ber = row["fer"], row["avg_work"], row["ber"]
                line = f"  ({run_id}) {row['EbN0_dB']:.1f} dB: FER {fer:.6e} BER {ber:.6e} avg_work {work:.6f}"
                r = ref.get(row["EbN0_dB"])
                if run_id == "e":
                    r = ref[5.0]
                if r is not None:
                    n2 = int(r["bits_total"]) // kp
                    z = fer_z(fer, frames, float(r["fer"]), n2)
                    line += (f"; JAX FER {float(r['fer']):.6e} ({n2} frames) z = {z:+.3f}, "
                             f"avg_work {float(r['avg_work']):.6f}")
                print(line, flush=True)
                check(math.isfinite(ber) and 0.0 <= ber <= 1.0, f"BER run ({run_id}): BER {ber}")
                if run_id == "b":
                    check(work == 20.0, f"(b) avg_work {work} is not 20.0")
                    check(fer >= 0.99, f"(b) FER {fer} < 0.99")
                    check(abs(ber / 0.13835 - 1.0) < 0.10, f"(b) BER {ber} is off 0.13835 by > 10%")
                elif run_id == "f":
                    check(0.0 <= work <= 8.0, f"(f) avg_work {work} outside [0, 8]")
                else:
                    check(abs(z) < 3.0, f"BER run ({run_id}) FER at {row['EbN0_dB']} dB is off "
                          f"the JAX sweep (z={z:.2f})")
                    if run_id == "a":
                        rel = abs(work / float(r["avg_work"]) - 1.0)
                        check(rel < 0.05, f"(a) avg_work {work} is {rel:.3f} off the JAX sweep's")
                    if run_id == "e":
                        check(0.0 < work < 1.0, f"(e) avg_work {work} outside (0, 1)")
    ber_scl_launches, ber_nms_launches, ber_plain = counts()
    print(f"BER path: K1 launches {ber_scl_launches}, K2 launches {ber_nms_launches}, "
          f"plain decoders on CUDA {ber_plain}")
    phase_done("7 BER path")

    # ---- 7b. the multi-process path: the sweep CLIs as ranks on the card ----
    mp_scl_launches, mp_nms_launches = multi_process_path(reset_counts, counts)
    phase_done("7b multi-process path")

    # ---- 8. BER times ----
    print(f"BER times on {smi}:")
    nms_times = {}
    for tag, x, bg, Z, se, H, reps in nms_timing_cases(dev, codes, big_bg, big_H):
        run = lambda: decode_ldpc_nms_cuda(x, bg, Z, 20, 0.8, self_exclude=se)  # noqa: E731
        ms = cuda_time_ms(run, reps=reps)
        iters = run()["iters_used"]
        edges = int((bg.shifts >= 0).sum()) * Z
        b_ms, b_by = bound(*nms_work(iters, bg.n * Z, edges, bg.m * Z, se))
        line = f"  K2 {tag}: {ms:.4f} ms ({reps} launches)"
        pms = None
        if H is not None:
            big = H.shape[1] > 10000
            pms = cuda_time_ms(lambda: decode_ldpc_nms_batch(x, H, 20, 0.8, self_exclude=se),
                               reps=2 if big else 5, warmup=1)
            line += f"; plain {pms:.4f} ms ({2 if big else 5} calls)"
        print(f"{line}; bound {b_ms:.6f} ms ({b_by}; mean iterations "
              f"{iters.float().mean().item():.3f})", flush=True)
        nms_times[tag] = (ms, pms, b_ms, b_by)

    bg = codes[IRA[0]][1][0]
    step = make_ber_chunk(
        scheme="nr_ldpc", E=IRA[4], N=IRA[4], K_payload=IRA[3], K_crc=24, crc_poly=CRC,
        info_set=None, M=4, retries=8, beta=None, ilv_mode="default", max_iter=20,
        alpha=0.8, batch=4096, device=dev, ldpc_bg=bg, ldpc_Z=IRA[2], nms_exact=True)
    nv = run_ber_sweep._noise_var(2.5, IRA[3], IRA[4])
    for i in range(3):
        torch.stack([v.to(torch.float64) for v in step(3, 1, i, nv).values()]).tolist()
    reps = 20
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(reps):
        torch.stack([v.to(torch.float64) for v in step(3, 1, 100 + i, nv).values()]).tolist()
    torch.cuda.synchronize()
    ber_step_s = (time.perf_counter() - t) / reps
    print(f"  BER step (a) at 2.5 dB (nr_ldpc ira4x8 Z=31 two-min, B=4096): "
          f"{ber_step_s * 1e3:.3f} ms, {4096 / ber_step_s:.0f} frames/s ({reps} steps)")
    profile_steps(lambda i: torch.stack([v.to(torch.float64) for v in step(4, 1, i, nv).values()])
                  .tolist(), "BER steps (a) 2.5 dB")
    phase_done("8 BER times")

    # ---- 9. K3 against the JAX package's outputs and its plain version ----
    pac_cases = 0
    with np.load(GOLDEN / "legacy_pac_decode.npz") as golden:
        for case in json.loads(str(golden["cases"])):
            tag = case["name"]
            mask = pac_mask(case["N"], case["K"] + case["crc_len"], case["profile"])
            check(np.array_equal(mask, golden[f"{tag}/mask"]), f"{tag}: rate profile differs")
            x = torch.from_numpy(golden[f"{tag}/llr"]).to(dev)
            out = pac_list_decode_cuda(x, mask, case["gen"], case["L"], case["crc_len"],
                                       case["crc_poly"])
            torch.cuda.synchronize()
            bad = (np.any(out["extracted"].cpu().numpy() != golden[f"{tag}/extracted"], axis=1)
                   | (out["crc_pass"].cpu().numpy() != golden[f"{tag}/crc_pass"]))
            print(f"  K3 vs JAX {tag} (N={case['N']} L={case['L']} B={x.shape[0]}): "
                  f"{int(bad.sum())} frames differ", flush=True)
            check(not bad.any(), f"K3 differs from the JAX decoder ({tag}): frames "
                  f"{np.flatnonzero(bad)[:10].tolist()}")
            pac_cases += 1
    rng = np.random.default_rng(20261019)
    pac_max_err = 0
    sim_code = (64, 32, None)
    plain_cases = [(PAC_CODES[128], 8, 4096), (sim_code, 1, 4096), (sim_code, 32, 4096),
                   ((128, 64, PAC_CRC), 16, 1001), (sim_code, 5, 1000)]

    def compare_pac(code, L, B, gen, tag):
        nonlocal pac_max_err
        n_p, k_p, crc_p = code
        crc_len, crc_poly = crc_p or (0, 0)
        mask = pac_mask(n_p, k_p + crc_len)
        x = pac_llrs(rng, B, 2.5, code, gen, mask, dev)
        out = pac_list_decode_cuda(x, mask, gen, L, crc_len, crc_poly)
        torch.cuda.synchronize()
        ref = pac_list_decode_batch(x, mask, gen, L, crc_len=crc_len, crc_poly=crc_poly)
        torch.cuda.synchronize()
        diff = (out["extracted"].to(torch.int32) - ref["extracted"].to(torch.int32)).abs()
        bad = (diff.amax(dim=1) > 0) | (out["crc_pass"] != ref["crc_pass"])
        pac_max_err = max(pac_max_err, int(diff.max()))
        print(f"  {tag} vs plain PAC({n_p},{k_p}) gen {''.join(map(str, gen))} L={L} CRC "
              f"{'on' if crc_p else 'off'} 2.5 dB B={B}: {int(bad.sum())} frames differ; "
              f"crc pass {int(ref['crc_pass'].sum())}", flush=True)
        check(not bool(bad.any()), f"{tag} differs from the plain version (PAC({n_p},{k_p}) L={L} B={B})")

    for code, L, B in plain_cases:
        # L=16 ragged: crc_polar_vs_uncoded's polar code
        compare_pac(code, L, B, PAC_GEN if L != 16 else [1], "K3")
    # K3d: the rest of the first envelope, levels in global scratch, up to
    # N=1024 L=32; small batches keep the plain version quick
    k3d_cases = [((256, 128, PAC_CRC), 32, 512, PAC_GEN), ((512, 256, PAC_CRC), 8, 512, PAC_GEN),
                 ((512, 256, PAC_CRC), 32, 256, PAC_GEN), ((512, 256, None), 8, 512, PAC_GEN),
                 ((1024, 512, PAC_CRC), 32, 128, PAC_GEN), ((1024, 512, PAC_CRC), 24, 333, [1])]
    for code, L, B, gen in k3d_cases:
        compare_pac(code, L, B, gen, "K3d")
    print(f"K3: {pac_cases} JAX cases, {len(plain_cases)} plain-version cases and "
          f"{len(k3d_cases)} K3d cases, every frame identical")
    phase_done("9 K3 vs JAX and plain")

    # ---- 10. the legacy path: the three legacy drivers on the card ----
    drivers = json.loads((GOLDEN / "legacy_pac_drivers.json").read_text())
    pac_list_decode_cuda.launches = 0
    pac_list_decode_batch.cuda_calls = 0
    sim_ref = drivers["simulator"]
    buf = io.StringIO()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
        res = simulator.run(simulator.LegacySimConfig(snr_range=sim_ref["config"]["snr_range"],
                                                      seed=sim_ref["config"]["seed"]), tmp)
        sim_csv = next(Path(tmp).glob("*.csv")).read_text()
    sim_s = time.perf_counter() - t
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("@")]
    sim_frames = sum(int(re.search(r"\((\d+) frames\)", ln).group(1)) for ln in lines)
    for ln in lines:
        print(f"  simulator: {ln}")
    print(f"  simulator: {sim_s:.3f} s for {sim_frames} frames ({sim_frames / sim_s:.0f} frames/s, "
          f"host clock; the JAX driver on the CPU took {sim_ref['seconds']:.1f} s)")
    check(lines == sim_ref["lines"] and res.ber == sim_ref["ber"] and res.fer == sim_ref["fer"]
          and sim_csv == sim_ref["csv"], f"simulator results differ from the JAX driver's: "
          f"{lines} {res.ber} vs {sim_ref['lines']} {sim_ref['ber']}")
    unc_ref = drivers["crc_polar_vs_uncoded"]
    t = time.perf_counter()
    unc = crc_polar_vs_uncoded.simulate(crc_polar_vs_uncoded.SimulationConfig(
        snr_points=tuple(unc_ref["config"]["snr_points"]), seed=unc_ref["config"]["seed"],
        plot_results=False))
    print(f"  crc_polar_vs_uncoded: {time.perf_counter() - t:.3f} s, host clock")
    print("  crc_polar_vs_uncoded:\n    " + crc_polar_vs_uncoded._format_results(unc)
          .replace("\n", "\n    "))
    check([dataclasses.asdict(r) for r in unc] == unc_ref["results"],
          "crc_polar_vs_uncoded results differ from the JAX driver's")
    ofdm_ref = drivers["crc_polar_ofdm_ls"]
    t = time.perf_counter()
    ofdm = crc_polar_ofdm_ls.simulate(crc_polar_ofdm_ls.SimulationConfig(
        snr_points=tuple(ofdm_ref["config"]["snr_points"]), seed=ofdm_ref["config"]["seed"],
        plot_results=False))
    print(f"  crc_polar_ofdm_ls: {time.perf_counter() - t:.3f} s, host clock")
    print("  crc_polar_ofdm_ls:\n    " + crc_polar_ofdm_ls._format_results(ofdm)
          .replace("\n", "\n    "))
    check(len(ofdm) == len(ofdm_ref["results"]), "crc_polar_ofdm_ls: number of points")
    for got, want in zip((dataclasses.asdict(r) for r in ofdm), ofdm_ref["results"]):
        mse, want_mse = got.pop("avg_channel_mse"), want["avg_channel_mse"]
        check(got == {k: v for k, v in want.items() if k != "avg_channel_mse"},
              f"crc_polar_ofdm_ls results differ from the JAX driver's: {got} vs {want}")
        check(abs(mse - want_mse) <= 1e-12 * abs(want_mse), f"OFDM channel MSE {mse} vs {want_mse}")
    legacy_launches, legacy_plain = pac_list_decode_cuda.launches, pac_list_decode_batch.cuda_calls
    print(f"legacy path: pac_list_decode_cuda.launches {legacy_launches}, "
          f"pac_list_decode_batch.cuda_calls {legacy_plain}; the three drivers equal the JAX drivers")
    check(legacy_launches > 0, "the legacy drivers did not go through the PAC kernel")
    check(legacy_plain == 0, "the plain PAC decoder ran on CUDA in the legacy drivers")

    def sim_batch(i):  # one simulator batch: 256 frames at 3.0 dB, stage 1 and stage 2
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
            simulator.run(simulator.LegacySimConfig(snr_range=[3.0], max_frames=256, seed=i), tmp)

    profile_steps(sim_batch, "simulator batches (256 frames, 3.0 dB)")
    phase_done("10 legacy path")

    # ---- 11. K3 times ----
    print(f"K3 times on {smi} (CRC-16 0x1021, gen 1011011, dega, 2.5 dB):")
    rng = np.random.default_rng(11)
    for n_p, code in PAC_CODES.items():
        kp = code[1] + PAC_CRC[0]
        mask = pac_mask(n_p, kp)
        x = pac_llrs(rng, PAC_BATCH, 2.5, code, PAC_GEN, mask, dev)
        for L in (1, 4, 8, 32):
            ms = cuda_time_ms(lambda: pac_list_decode_cuda(x, mask, PAC_GEN, L, *PAC_CRC), reps=10)
            b_ms, b_by = bound(*pac_work(mask, L, PAC_BATCH))
            print(f"  K3 PAC({n_p},{code[1]}) L={L} B={PAC_BATCH}: {ms:.4f} ms "
                  f"({PAC_BATCH / ms * 1e3:.0f} decodes/s, 10 launches); bound {b_ms:.6f} ms "
                  f"({b_by})", flush=True)
        small = x[:4096].contiguous()
        for L in (1, 8):
            ms = cuda_time_ms(lambda: pac_list_decode_cuda(small, mask, PAC_GEN, L, *PAC_CRC), reps=20)
            pms = cuda_time_ms(lambda: pac_list_decode_batch(small, mask, PAC_GEN, L, crc_len=PAC_CRC[0],
                                                             crc_poly=PAC_CRC[1]), reps=2, warmup=1)
            b_ms, b_by = bound(*pac_work(mask, L, 4096))
            print(f"  PAC({n_p},{code[1]}) L={L} B=4096: K3 {ms:.4f} ms (20 launches); plain "
                  f"{pms:.4f} ms (2 calls); bound {b_ms:.6f} ms ({b_by})", flush=True)
            if n_p == 128 and L == 8:
                pac_ms, pac_plain_ms, pac_bound_ms, pac_bound_by = ms, pms, b_ms, b_by
    # N=1024 L=32, and what its time depends on: the levels
    # in global scratch, G (`pac_cuda._launch`), and the info phases (the
    # same code with one payload bit: the f/g passes and the chain are the
    # same, the forks — the rank, σ, trace and syndrome — fall from 528 to 17)
    corner = (1024, 512, PAC_CRC)
    mask = pac_mask(1024, 528)
    x = pac_llrs(rng, 4096, 2.5, corner, PAC_GEN, mask, dev)
    g_plan = pac_cuda.launch_plan(1024, 528, 32)[0]
    for g in range(10):
        per_sm = pac_cuda._occupancy(1024, 528, 32, g)[1]
        plan = pac_cuda._plan(mask.astype(np.int8).tobytes(), tuple(PAC_GEN), 32, *PAC_CRC,
                              torch.float32, dev, global_levels=g)
        ms = cuda_time_ms(lambda: pac_cuda._launch(x, plan), reps=3, warmup=1)
        print(f"  K3 PAC(1024,512) L=32 B=4096, levels 1..{g} in global scratch: {ms:.4f} ms "
              f"({per_sm} frames an SM){' (the launch plan)' if g == g_plan else ''}", flush=True)
    ms = cuda_time_ms(lambda: pac_list_decode_cuda(x, mask, PAC_GEN, 32, *PAC_CRC), reps=5)
    b_ms, b_by = bound(*pac_work(mask, 32, 4096))
    print(f"  K3 PAC(1024,512) L=32 B=4096: {ms:.4f} ms (5 launches); bound {b_ms:.6f} ms ({b_by})")
    for n_p, B in ((128, 4096), (1024, 4096)):
        for kp in (n_p // 2 + 16, 17):
            mask = pac_mask(n_p, kp)
            x = pac_llrs(rng, B, 2.5, (n_p, kp - 16, PAC_CRC), PAC_GEN, mask, dev)
            ms = cuda_time_ms(lambda: pac_list_decode_cuda(x, mask, PAC_GEN, 32, *PAC_CRC), reps=5)
            print(f"  K3 N={n_p} Kp={kp} (info phases) L=32 B={B}: {ms:.4f} ms (5 launches)")
    # the drivers' own shapes: simulator stage 1 and 2, crc_polar_vs_uncoded
    sim_mask = pac_mask(64, 32)
    for L, B in ((1, 256), (32, 16)):
        x = pac_llrs(rng, B, 3.0, sim_code, PAC_GEN, sim_mask, dev)
        ms = cuda_time_ms(lambda: pac_list_decode_cuda(x, sim_mask, PAC_GEN, L), reps=50)
        print(f"  simulator stage shape PAC(64,32) L={L} B={B}: {ms:.4f} ms (50 launches)")
    unc_mask = pac_mask(128, 80)
    x = pac_llrs(rng, 128, 2.0, (128, 64, PAC_CRC), [1], unc_mask, dev)
    ms = cuda_time_ms(lambda: pac_list_decode_cuda(x, unc_mask, [1], 16, *PAC_CRC), reps=50)
    print(f"  crc_polar_vs_uncoded shape P(128,64+16) L=16 B=128: {ms:.4f} ms (50 launches)")
    phase_done("11 K3 times")

    # ---- 12. the scalar surface on the card ----
    scalar_k1, scalar_k2, scalar_k3 = scalar_surface(dev, smi)
    phase_done("12 scalar surface")

    # ---- 13. the wide envelope ----
    wide_entries = wide_envelope(dev, smi)
    phase_done("13 wide_envelope")

    # ---- 14. the deep lists ----
    deep_entries = deep_lists(dev, smi)
    phase_done("14 deep_lists")

    # ---- 15. the cluster lists ----
    cluster_entries = cluster_lists(dev, smi)
    phase_done("15 cluster_lists")

    # ---- 16. code lengths past 8192 ----
    long_entries = long_codes(dev, smi)
    phase_done("16 long_codes")

    # ---- 17. result lines ----
    nms_ms, nms_plain_ms, nms_bound_ms, nms_bound_by = nms_times[f"{IRA[0]} two-min 2.5 dB B=4096"]
    print(json.dumps({"kernels": [{
        "name": "scl_decode",
        "route": "cuda",
        "source": "polar_code_tpu_torch/csrc/scl_decode.cu",
        "replaces": "polar_code_tpu/ops/scl_pallas.py:293",
        "launches": (fer_launches + fer2048_launches + env_launches + train_launches
                     + ber_scl_launches + mp_scl_launches + scalar_k1),
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "nms_decode",
        "route": "cuda",
        "source": "polar_code_tpu_torch/csrc/nms_decode.cu",
        "replaces": "polar_code_tpu/nr/ldpc/nms_pallas.py:31",
        "launches": ber_nms_launches + mp_nms_launches + scalar_k2,
        "max_abs_err": float(nms_max_err),
        "ms": nms_ms,
        "plain_ms": nms_plain_ms,
        "bound_ms": nms_bound_ms,
        "bound_by": nms_bound_by,
        "library_ms": None,
    }, {
        "name": "pac_decode",
        "route": "cuda",
        "source": "polar_code_tpu_torch/csrc/pac_decode.cu",
        "replaces": "polar_code_tpu/legacy/pac_pallas.py:59",
        "launches": legacy_launches + scalar_k3,
        "max_abs_err": float(pac_max_err),
        "ms": pac_ms,
        "plain_ms": pac_plain_ms,
        "bound_ms": pac_bound_ms,
        "bound_by": pac_bound_by,
        "library_ms": None,
    }] + wide_entries + deep_entries + cluster_entries + long_entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    code = rank_worker(sys.argv[2]) if sys.argv[1:2] == ["--rank-worker"] else main()
    faulthandler.cancel_dump_traceback_later()
    sys.exit(code)
