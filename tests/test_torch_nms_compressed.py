"""The NMS kernel's bookkeeping, checked on the CPU.

* A model of the kernel's per-row loop (`csrc/nms_decode.cu`): columns
  read once from the host tables the kernel gets (`nms_cuda.host_tables`,
  both layouts), ext = L − msg kept between the pass that finds the minima
  and the pass that writes, the sign product carried as the parity of the
  ext sign bits, two-min messages stored as the kernel's compressed record
  (A1 = α·min1, A2 = α·min2 or 0 where min1 == 0, the first edge at min1
  in the kernel's order — 32-edge chunks in turn, each from its last edge
  down — and sign words of the message signs, edge j of a chunk at bit j)
  and rebuilt from it, frames frozen from
  the iteration their syndrome passes.  Its arithmetic is the kernel's, so
  `hard`, `iters_used` and `parity_ok` must equal the plain decoder's
  exactly: QC-IRA 4×8 Z=31 and the demo graph at Z=2 and Z=32, shared-min
  and two-min; integer LLRs in −3..3, which give exact zeros and exact ties
  of |ext|; QC-IRA 2×42 Z=41, rows of degree 41–42 (two sign words), and
  a dense 2×40 graph at Z=8 (degree 40 in the warp-a-frame layout);
  `max_iter` 0 and 1.
* The wrapper's layout (`kernel_layout`): mode, edges in registers, record
  words, where the records live and the bytes a frame; the launch policy
  (`_plan_for`) against a stand-in occupancy calculator (the real numbers
  come from the card, `chip_smoke.py` phase 2).
"""

import dataclasses

import numpy as np
import pytest
import torch

from polar_code_tpu_torch.nr.ldpc import basegraphs, build_h_matrix, nms_cuda, qc_ira
from polar_code_tpu_torch.nr.ldpc.decode_nms import decode_ldpc_nms_batch
from polar_code_tpu_torch.nr.ldpc.encode import encode_ldpc_batch
from polar_code_tpu_torch.nr.ldpc.nms_cuda import (
    BLOCK,
    BLOCK_1024,
    WARP,
    host_tables,
    kernel_layout,
)


def _graph(name):
    if name == "ira4x8":
        return qc_ira.make_qc_ira_bg(4, 8, 31), 31
    if name == "ira2x42":
        return qc_ira.make_qc_ira_bg(2, 42, 41), 41
    if name == "dense2x40":  # rows of degree 40 at Z=8: a warp a frame, 32-edge chunks
        return basegraphs.BaseGraph(name, 2, 40, (np.arange(2)[:, None] * np.arange(1, 41)) % 8), 8
    return basegraphs.load_base_graph(2), int(name[4:])  # "demo<Z>"


def row_columns(shifts, Z, layout):
    """Per block-row, a [deg, Z] array of each lane's column of each edge, as
    the kernel reads them from `host_tables` as byte offsets (WARP: the u32
    chunks; BLOCK: u = 4z + 4s, then min(u, u − 4Z) over unsigned, plus
    4c·Z)."""

    rows, cols = host_tables(shifts, Z, layout)
    z = np.arange(Z)
    out = []
    if layout.mode == WARP:
        for first, deg in rows:
            j = np.arange(deg)
            out.append(cols[first + j // 8, j % 8 // 4, :Z, j % 4].astype(np.int64) // 4)
        return out
    for r in range(len(rows) - 1):
        e = cols[rows[r]:rows[r + 1]].astype(np.int64)
        u = (4 * z[None] + e[:, :1]).astype(np.uint32)
        out.append((np.minimum(u, u - np.uint32(4 * Z)).astype(np.int64) + e[:, 1:]) // 4)
    return out


def model_decode(llr, shifts, Z, max_iter=20, alpha=0.8, self_exclude=False, layout=None):
    """The kernel's decode of float32 LLRs [B, n], in torch on the CPU; and
    counts of the row updates where the record's special cases decide: min1
    == 0 < min2 (A2 zeroed) and exact ties min1 == min2 > 0."""

    shifts = np.asarray(shifts)
    layout = layout or kernel_layout(shifts, Z, self_exclude)
    cols = [torch.from_numpy(c) for c in row_columns(shifts, Z, layout)]
    B, n = llr.shape
    mb = len(cols)
    a = torch.tensor(alpha, dtype=torch.float32)
    inf = torch.tensor(float("inf"))
    zero = torch.zeros((), dtype=torch.float32)
    L = llr.clone()
    # records, lane-major as in the kernel: [B, mb, Z] a word
    A1 = torch.zeros((B, mb, Z))
    A2 = torch.zeros((B, mb, Z))
    idx = torch.zeros((B, mb, Z), dtype=torch.int64)
    words = torch.zeros((B, mb, layout.nw - 3 if self_exclude else 0, Z), dtype=torch.int64)
    stats = {"zero_min1": 0, "ties": 0}

    def message(r, j):  # edge j of a 32-edge chunk has bit j of its word
        bit = (words[:, r, j // 32] >> (j % 32)) & 1
        v = torch.where(idx[:, r] == j, A2[:, r], A1[:, r])
        return torch.where(bit == 1, -v, v)

    def syndrome_fails(x):
        bad = torch.zeros(B, dtype=torch.bool)
        for c in cols:
            par = torch.zeros((B, Z), dtype=torch.bool)
            for j in range(c.shape[0]):
                par ^= x[:, c[j]] < 0
            bad |= par.any(dim=1)
        return bad

    live = torch.ones(B, dtype=torch.bool)
    iters = torch.full((B,), max_iter, dtype=torch.int32)
    for it in range(max_iter):
        for r, c in enumerate(cols):
            deg = c.shape[0]
            ext = [L[:, c[j]] - (message(r, j) if self_exclude else A1[:, r]) for j in range(deg)]
            par = torch.zeros((B, Z), dtype=torch.bool)
            m1, m2 = inf.expand(B, Z), inf.expand(B, Z)
            amin = torch.zeros((B, Z), dtype=torch.int64)
            for j in [b + i for b in range(0, deg, 32) for i in reversed(range(min(32, deg - b)))]:
                x = ext[j]
                par ^= torch.signbit(x)
                mag = x.abs()
                m2 = torch.fmin(m2, torch.fmax(m1, mag))
                amin = torch.where(mag < m1, j, amin)
                m1 = torch.fmin(m1, mag)
            keep = live[:, None]
            if self_exclude:
                stats["zero_min1"] += int(((m1 == 0) & (m2 > 0) & keep).sum())
                stats["ties"] += int(((m1 == m2) & (m1 > 0) & keep).sum())
                n1 = a * m1
                n2 = torch.where(m1 == 0, zero, a * m2)
                A1[:, r] = torch.where(keep, n1, A1[:, r])
                A2[:, r] = torch.where(keep, n2, A2[:, r])
                idx[:, r] = torch.where(keep, amin, idx[:, r])
                for w in range(words.shape[2]):
                    word = torch.zeros((B, Z), dtype=torch.int64)
                    for j in range(32 * w, min(32 * w + 32, deg)):
                        word |= (torch.signbit(ext[j]) ^ par).to(torch.int64) << (j % 32)
                    words[:, r, w] = torch.where(keep, word, words[:, r, w])
                for j, x in enumerate(ext):
                    L[:, c[j]] = torch.where(keep, x + message(r, j), L[:, c[j]])
            else:
                u = torch.where(par, -(a * m1), a * m1)
                A1[:, r] = torch.where(keep, u, A1[:, r])
                for j, x in enumerate(ext):
                    L[:, c[j]] = torch.where(keep, x + u, L[:, c[j]])
        newly = live & ~syndrome_fails(L)
        iters = torch.where(newly, it + 1, iters)
        live &= ~newly
        if not live.any():
            break
    ok = ~live if max_iter else ~syndrome_fails(L)
    return {"hard": (L < 0).to(torch.int8), "iters_used": iters, "parity_ok": ok}, stats


def _llrs(name, B, kind, seed):
    bg, Z = _graph(name)
    H = build_h_matrix(bg, Z)
    rng = np.random.default_rng(seed)
    if kind == "int":  # exact zeros and exact ties of |ext|
        return bg, Z, H, rng.integers(-3, 4, (B, H.shape[1])).astype(np.float32)
    if kind == "zero":  # the all-zero codeword, a codeword of every graph
        sig = np.linspace(0.3, 1.6, B)[:, None]
        return bg, Z, H, (2.0 + sig * rng.normal(0, 1, (B, H.shape[1]))).astype(np.float32)
    k = H.shape[1] - H.shape[0]
    cw = encode_ldpc_batch(torch.from_numpy(rng.integers(0, 2, (B, k)).astype(np.int8)), H).numpy()
    sig = np.linspace(0.3, 1.6, B)[:, None]
    return bg, Z, H, ((1.0 - 2.0 * cw) * 2.0 + sig * rng.normal(0, 1, cw.shape)).astype(np.float32)


CASES = [  # (graph, LLRs, frames, max_iter)
    ("ira4x8", "awgn", 48, 20),
    ("ira4x8", "int", 48, 20),
    ("demo2", "awgn", 32, 20),
    ("demo2", "int", 32, 20),
    ("demo32", "awgn", 32, 20),
    ("demo32", "int", 32, 20),
    ("ira2x42", "awgn", 24, 20),
    ("ira2x42", "int", 24, 20),
    ("dense2x40", "zero", 24, 20),
    ("dense2x40", "int", 24, 20),
    ("ira4x8", "awgn", 32, 0),
    ("ira4x8", "awgn", 32, 1),
]


@pytest.mark.parametrize("self_exclude", [False, True])
@pytest.mark.parametrize("name,kind,B,max_iter", CASES)
def test_model_equals_plain_decoder(name, kind, B, max_iter, self_exclude):
    bg, Z, H, llr = _llrs(name, B, kind, seed=B + max_iter)
    x = torch.from_numpy(llr)
    ours, stats = model_decode(x, bg.shifts, Z, max_iter, 0.8, self_exclude)
    ref = decode_ldpc_nms_batch(x, H, max_iter=max_iter, alpha=0.8, self_exclude=self_exclude)
    for key in ("hard", "iters_used", "parity_ok"):
        np.testing.assert_array_equal(ours[key].numpy(), ref[key].numpy(), err_msg=key)
    if kind == "awgn" and max_iter == 20:  # frames stop early, at different iterations
        assert len(np.unique(ref["iters_used"].numpy())) > 1
    if self_exclude and kind == "int" and name not in ("ira2x42", "dense2x40"):
        # the zero rule and the tie rule both decide somewhere in these cases
        assert stats["zero_min1"] > 0 and stats["ties"] > 0, stats


@pytest.mark.parametrize("self_exclude", [False, True])
def test_model_block_layout_equals_plain_decoder(self_exclude):
    """The BLOCK layout's tables (the edge table Z > 32 uses) at a WARP shape."""

    bg, Z, H, llr = _llrs("ira4x8", 32, "int", seed=5)
    layout = dataclasses.replace(kernel_layout(bg.shifts, Z, self_exclude), mode=BLOCK)
    x = torch.from_numpy(llr)
    ours, _ = model_decode(x, bg.shifts, Z, 20, 0.8, self_exclude, layout=layout)
    ref = decode_ldpc_nms_batch(x, H, max_iter=20, alpha=0.8, self_exclude=self_exclude)
    for key in ("hard", "iters_used", "parity_ok"):
        np.testing.assert_array_equal(ours[key].numpy(), ref[key].numpy(), err_msg=key)


@pytest.mark.parametrize("name", ["ira4x8", "demo2", "demo32", "ira2x42"])
def test_tables_give_the_lifted_columns(name):
    bg, Z = _graph(name)
    shifts = np.asarray(bg.shifts)
    layout = kernel_layout(shifts, Z, True)
    z = np.arange(Z)
    want = [np.array([c * Z + (z + s) % Z for c, s in enumerate(row) if s >= 0]) for row in shifts]
    for mode in (WARP, BLOCK):
        if mode == WARP and layout.mode != WARP:
            continue
        got = row_columns(shifts, Z, dataclasses.replace(layout, mode=mode))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_layout():
    # QC-IRA 4x8 Z=31: a warp a frame; rows of degree 5-6 keep 8 edges in
    # registers; a record of 4 words (A1, A2, argmin, signs) a lane a row
    ira = qc_ira.make_qc_ira_bg(4, 8, 31).shifts
    lay = kernel_layout(ira, 31, True)
    assert (lay.mode, lay.D, lay.nw, lay.col_chunks) == (WARP, 8, 4, 4)
    assert lay.tables_bytes == 1024 * 4 + 8 * 4  # four chunks, four 8-byte rows
    assert lay.frame_bytes == 992 + 4 * 4 * 4 * 32 and lay.rec_offset == 992
    assert lay.records_in_smem and lay.block_bytes(3) == lay.tables_bytes + 3 * lay.frame_bytes
    shared = kernel_layout(ira, 31, False)
    assert (shared.mode, shared.nw, shared.frame_bytes) == (WARP, 1, 992 + 4 * 4 * 32)
    # the demo graph at Z=32 is still a warp a frame; at Z=33 a block a frame
    demo = basegraphs.load_base_graph(2).shifts
    assert kernel_layout(demo, 32, True).mode == WARP
    assert kernel_layout(demo, 33, True).mode == BLOCK
    # QC-IRA 46x68 Z=383: rows of degree 23-24 keep 32 edges in registers;
    # two-min records (46 rows x 4 words x 383 lanes x 4 B = 281,888 B a
    # frame, against 1.69 MB of one float an edge) go to global scratch,
    # shared-min's one word a row fits past the LLRs
    big = qc_ira.make_qc_ira_bg(46, 68, 383).shifts
    E = int((big >= 0).sum())
    tables_end = 8 * E + 4 * 68 * 383 + 4 * 47
    lay = kernel_layout(big, 383, True)
    assert (lay.mode, lay.D, lay.nw, lay.rec_offset) == (BLOCK, 32, 4, 0)
    assert lay.frame_bytes == tables_end and not lay.records_in_smem
    assert 4 * 46 * lay.nw * 383 == 281_888
    lay = kernel_layout(big, 383, False)
    assert lay.rec_offset == (tables_end + 15) // 16 * 16 and lay.records_in_smem
    assert lay.frame_bytes == lay.rec_offset + 4 * 46 * 383
    # degree 41-42: 32 edges in registers, the rest in chunks; two sign words
    lay = kernel_layout(qc_ira.make_qc_ira_bg(2, 42, 41).shifts, 41, True)
    assert (lay.mode, lay.D, lay.nw) == (BLOCK, 32, 5)
    # degree 9 and above takes the 32-edge build
    assert kernel_layout(np.zeros((2, 9), np.int32), 5, False).D == 32


def test_launch_policy(monkeypatch):
    """WARP: the fewest frames a block that reach the most frames an SM; a
    BLOCK whose build has too many registers for its threads takes the
    64-register build."""

    calls = []

    def fake(D, se, mode, threads, smem):
        calls.append((mode, threads))
        warps = threads // 32
        if mode == WARP:  # 48 warps an SM, at most 32 blocks
            return min(32, 48 // warps), 40, 1024
        return (1, 64, 1024) if mode == BLOCK_1024 else (1, 96, 640)

    monkeypatch.setattr(nms_cuda, "_occupancy", fake)
    lay = kernel_layout(qc_ira.make_qc_ira_bg(4, 8, 31).shifts, 31, True)
    plan = nms_cuda._plan_for(lay, 31, True)
    assert (plan.mode, plan.frames_per_block, plan.frames_per_sm) == (WARP, 2, 48)
    assert plan.threads == 64 and plan.smem == lay.block_bytes(2)
    big = kernel_layout(qc_ira.make_qc_ira_bg(3, 6, 1021).shifts, 1021, True)
    plan = nms_cuda._plan_for(big, 1021, True)
    assert (plan.mode, plan.threads, plan.frames_per_block) == (BLOCK_1024, 1024, 1)
    small = kernel_layout(qc_ira.make_qc_ira_bg(3, 6, 37).shifts, 37, True)
    assert nms_cuda._plan_for(small, 37, True).mode == BLOCK
