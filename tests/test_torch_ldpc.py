"""The port's NR LDPC stack against the JAX package's.

* Host tables: base graphs, `build_h_matrix`, `make_qc_ira_bg`, the
  `nr_tables` lifting machinery and `parity_solver_matrix` — arrays equal.
* `encode_ldpc_batch` and the rate match/derate pair — outputs equal, both
  branches of the derate (fill, and repeats with a remainder).
* The plain decoder `decode_ldpc_nms_batch` against JAX's in float32: hard
  bits, `iters_used` and `parity_ok` identical, shared-min and two-min, on
  the demo graph (Z=8, 32), QC-IRA 3×6 Z=13 and a random lifted graph; and
  once against the Pallas kernel in interpret mode.
* The kernel wrapper runs the plain version for CPU tensors and raises for
  shapes the kernel does not take; on the card (marker `gpu`) the kernel
  equals the plain version.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_code_tpu.nr.ldpc import basegraphs as jax_bg
from polar_code_tpu.nr.ldpc import encode as jax_encode
from polar_code_tpu.nr.ldpc import nr_tables as jax_tables
from polar_code_tpu.nr.ldpc import qc_ira as jax_qc
from polar_code_tpu.nr.ldpc import rate_match as jax_rm
from polar_code_tpu.nr.ldpc.builder import build_h_matrix as jax_build_h
from polar_code_tpu.nr.ldpc.decode_nms import decode_ldpc_nms_batch as jax_decode
from polar_code_tpu.nr.ldpc.nms_pallas import decode_ldpc_nms_pallas
from polar_code_tpu_torch.nr.ldpc import basegraphs, nr_tables, qc_ira
from polar_code_tpu_torch.nr.ldpc.builder import build_h_matrix
from polar_code_tpu_torch.nr.ldpc.decode_nms import decode_ldpc_nms_batch
from polar_code_tpu_torch.nr.ldpc.encode import encode_ldpc_batch, parity_solver_matrix
from polar_code_tpu_torch.nr.ldpc.nms_cuda import (
    BLOCK,
    MAX_BLOCK_SMEM,
    WARP,
    check_shape,
    decode_ldpc_nms_cuda,
    host_tables,
    kernel_layout,
)
from polar_code_tpu_torch.nr.ldpc.rate_match import derate_match_ldpc, rate_match_ldpc


def _random_shifts(mb, nb, Z, rng):
    """Random payload blocks + lower-triangular parity part, as in
    `tests/test_ldpc_random_graphs.py`."""

    shifts = np.full((mb, nb), -1, dtype=np.int32)
    kb = nb - mb
    for r in range(mb):
        for c in rng.choice(kb, size=rng.integers(2, min(4, kb + 1)), replace=False):
            shifts[r, c] = int(rng.integers(0, Z))
        shifts[r, kb + r] = 0
        if r > 0:
            shifts[r, kb + r - 1] = int(rng.integers(0, Z))
    return shifts


def _graphs(name):
    """(port BaseGraph, JAX BaseGraph, Z) for a named test graph."""

    if name.startswith("demo"):
        Z = int(name[4:])
        return basegraphs.load_base_graph(2), jax_bg.load_base_graph(2), Z
    if name == "ira3x6":
        return qc_ira.make_qc_ira_bg(3, 6, 13), jax_qc.make_qc_ira_bg(3, 6, 13), 13
    shifts = _random_shifts(4, 9, 16, np.random.default_rng(1))
    return (basegraphs.BaseGraph("random", 4, 9, shifts),
            jax_bg.BaseGraph("random", 4, 9, shifts), 16)


GRAPHS = ["demo8", "demo32", "ira3x6", "random"]


@pytest.mark.parametrize("name", GRAPHS)
def test_h_matrix_and_solver_equal(name):
    bg, jbg, Z = _graphs(name)
    np.testing.assert_array_equal(bg.shifts, jbg.shifts)
    assert (bg.m, bg.n) == (jbg.m, jbg.n)
    H = build_h_matrix(bg, Z)
    np.testing.assert_array_equal(H, jax_build_h(jbg, Z))
    k = H.shape[1] - H.shape[0]
    np.testing.assert_array_equal(parity_solver_matrix(H, k), jax_encode.parity_solver_matrix(H, k))


def test_demo_graphs_and_ira_spec():
    for bg in (1, 2):
        np.testing.assert_array_equal(basegraphs.load_base_graph(bg).shifts,
                                      jax_bg.load_base_graph(bg).shifts)
    with pytest.raises(ValueError):
        basegraphs.load_base_graph(3)
    assert qc_ira.parse_ira_spec("ira4x8") == jax_qc.parse_ira_spec("ira4x8") == (4, 8)
    np.testing.assert_array_equal(qc_ira.make_qc_ira_bg(46, 68, 383).shifts,
                                  jax_qc.make_qc_ira_bg(46, 68, 383).shifts)
    for bad in [(4, 8, 30), (4, 8, 3), (1, 8, 31)]:  # composite Z, Z too small, m < 2
        with pytest.raises(ValueError):
            qc_ira.make_qc_ira_bg(*bad)
    with pytest.raises(ValueError):
        qc_ira.parse_ira_spec("ira4by8")


def test_nr_tables_equal(tmp_path):
    assert nr_tables.all_lifting_sizes() == jax_tables.all_lifting_sizes()
    assert nr_tables.LIFTING_SETS == jax_tables.LIFTING_SETS
    for Z in jax_tables.all_lifting_sizes():
        assert nr_tables.ils_index(Z) == jax_tables.ils_index(Z)
    for K, rate in [(100, 0.3), (300, 0.5), (3000, 0.8), (3000, 0.2), (8000, 0.9)]:
        bg = nr_tables.choose_base_graph(K, rate)
        assert bg == jax_tables.choose_base_graph(K, rate)
        assert nr_tables.choose_lifting_size(bg, K) == jax_tables.choose_lifting_size(bg, K)
    with pytest.raises(ValueError, match="liftable"):
        nr_tables.choose_lifting_size(2, 5000)
    V = np.array([[-1, 0, 7, 400], [383, -1, 12, 5]])
    np.testing.assert_array_equal(nr_tables.lift_shifts(V, 13), jax_tables.lift_shifts(V, 13))
    per_ils = "row,col,V0,V1,V2,V3,V4,V5,V6,V7\n0,0,1,2,3,4,5,6,7,8\n1,2,9,10,11,12,13,14,15,16\n"
    single = "row col shift  # pre-reduced\n0 1 5\n2 0 3\n"
    for i, text in enumerate([per_ils, single]):
        np.testing.assert_array_equal(nr_tables.parse_shift_table(text),
                                      jax_tables.parse_shift_table(text))
        path = tmp_path / f"bg{i}.csv"
        path.write_text(text)
        a = nr_tables.load_base_graph_file(path, 12)
        b = jax_tables.load_base_graph_file(path, 12)
        assert (a.name, a.m, a.n) == (b.name, b.m, b.n)
        np.testing.assert_array_equal(a.shifts, b.shifts)
    with pytest.raises(ValueError):
        nr_tables.parse_shift_table("0,0,1\n0,0,2\n")  # duplicate cell


@pytest.mark.parametrize("name", GRAPHS)
def test_encode_equal(name):
    bg, _, Z = _graphs(name)
    H = build_h_matrix(bg, Z)
    k = H.shape[1] - H.shape[0]
    payload = np.random.default_rng(Z).integers(0, 2, (16, k)).astype(np.int8)
    ours = encode_ldpc_batch(torch.from_numpy(payload), H).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_encode.encode_ldpc_batch(jnp.asarray(payload), H)))
    assert not ((ours.astype(np.int64) @ H.T) % 2).any()


@pytest.mark.parametrize("E", [13, 24, 40, 59])  # puncture, equal, 2 repeats + 8, 3 repeats + 11
def test_rate_match_equal(E):
    rng = np.random.default_rng(E)
    n = 16 if E != 24 else 24
    cw = rng.integers(0, 2, (5, n)).astype(np.int8)
    tx = rate_match_ldpc(torch.from_numpy(cw), E).numpy()
    np.testing.assert_array_equal(tx, np.asarray(jax_rm.rate_match_ldpc(jnp.asarray(cw), E)))
    llr = rng.normal(0, 3, (5, E)).astype(np.float32)
    ours = derate_match_ldpc(torch.from_numpy(llr), n).numpy()
    theirs = np.asarray(jax_rm.derate_match_ldpc(jnp.asarray(llr), n))
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    if E < n:
        assert (ours[:, E:] == 0.0).all()


def _decode_case(name, B=32, sigma=None, seed=0):
    """Codeword LLRs at noise levels from near-clean to hopeless across the
    batch (σ from 0.1 to 2.0 unless one σ is given), so frames stop at many
    iterations and some never do."""

    bg, _, Z = _graphs(name)
    H = build_h_matrix(bg, Z)
    k = H.shape[1] - H.shape[0]
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (B, k)).astype(np.int8)
    cw = encode_ldpc_batch(torch.from_numpy(payload), H).numpy()
    sig = np.linspace(0.1, 2.0, B)[:, None] if sigma is None else sigma
    llr = ((1.0 - 2.0 * cw) * 2.0 + sig * rng.normal(0, 1, cw.shape)).astype(np.float32)
    return bg, Z, H, llr


def _assert_same(ours, theirs):
    for key in ("hard", "iters_used", "parity_ok"):
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(theirs[key]), err_msg=key)


@pytest.mark.parametrize("self_exclude", [False, True])
@pytest.mark.parametrize("name", GRAPHS)
def test_plain_decoder_equals_jax(name, self_exclude):
    bg, Z, H, llr = _decode_case(name)
    ours = decode_ldpc_nms_batch(torch.from_numpy(llr), H, max_iter=20, alpha=0.8,
                                 self_exclude=self_exclude)
    theirs = jax_decode(jnp.asarray(llr), H, max_iter=20, alpha=0.8,
                        self_exclude=self_exclude, dtype=jnp.float32)
    _assert_same(ours, theirs)
    assert ours["hard"].dtype == torch.int8 and ours["iters_used"].dtype == torch.int32
    # the wrapper runs the plain version on CPU tensors
    _assert_same(decode_ldpc_nms_cuda(torch.from_numpy(llr), bg, Z, 20, 0.8,
                                      self_exclude=self_exclude), theirs)


def test_plain_decoder_equals_pallas_interpret():
    bg, Z, H, llr = _decode_case("demo8", B=8, sigma=1.0, seed=8)
    ours = decode_ldpc_nms_batch(torch.from_numpy(llr), H, max_iter=20, alpha=0.8)
    jbg = jax_bg.load_base_graph(2)
    theirs = decode_ldpc_nms_pallas(jnp.asarray(llr), jbg, Z, max_iter=20, alpha=0.8,
                                    block_batch=8, interpret=True)
    _assert_same(ours, theirs)


def test_plain_decoder_stops_and_freezes():
    bg, Z, H, llr = _decode_case("ira3x6", B=16, sigma=0.01)
    out = decode_ldpc_nms_batch(torch.from_numpy(20 * llr), H, self_exclude=True)
    assert out["parity_ok"].all() and (out["iters_used"] == 1).all()
    # a frame that never passes reports max_iter; max_iter 0 checks the input
    noise = torch.from_numpy(np.random.default_rng(3).normal(0, 0.2, llr.shape).astype(np.float32))
    res = decode_ldpc_nms_batch(noise, H, max_iter=3)
    assert ((res["iters_used"] == 3) | res["parity_ok"]).all()
    zero = decode_ldpc_nms_batch(torch.from_numpy(llr), H, max_iter=0)
    assert (zero["iters_used"] == 0).all() and zero["parity_ok"].all()


def test_kernel_tables_and_shape_gate():
    bg = qc_ira.make_qc_ira_bg(4, 8, 31)
    lay = kernel_layout(bg.shifts, 31, True)
    rows, cols = host_tables(bg.shifts, 31, lay)
    # a warp a frame: (first chunk, degree) a block-row, one 8-edge chunk each
    assert lay.mode == WARP and rows.tolist() == [[0, 5], [1, 6], [2, 6], [3, 6]]
    assert cols.shape == (4, 2, 32, 4) and int(cols.max()) < 4 * 248  # byte offsets
    # the edge table of a block a frame: row_ptr, (4s, 4c*Z) an edge
    row_ptr, edges = host_tables(bg.shifts, 31, dataclasses.replace(lay, mode=BLOCK))
    assert row_ptr.tolist() == [0, 5, 11, 17, 23] and edges.shape == (23, 2)
    assert (edges[:, 0] >= 0).all() and (edges[:, 0] < 4 * 31).all()
    assert (edges[:, 1] % (4 * 31) == 0).all()
    # the demo graph's shifts reach 3, so at Z=2 they are reduced mod Z
    demo = basegraphs.load_base_graph(2)
    _, e2 = host_tables(demo.shifts, 2, dataclasses.replace(kernel_layout(demo.shifts, 2, True),
                                                            mode=BLOCK))
    assert (e2[:, 0] >= 0).all() and (e2[:, 0] < 4 * 2).all()
    # ira4x8 Z=31 keeps its records in shared memory, past each frame's
    # LLRs; ira46x68 Z=383 two-min cannot (offset 0: global scratch)
    assert lay.records_in_smem and lay.rec_offset == 4 * 248
    big = qc_ira.make_qc_ira_bg(46, 68, 383)
    assert kernel_layout(big.shifts, 383, True).rec_offset == 0
    check_shape(big, 383, 68 * 383, torch.float32, True)
    with pytest.raises(ValueError, match="float32"):
        check_shape(bg, 31, 248, torch.float64, False)
    with pytest.raises(ValueError, match="nb\\*Z"):
        check_shape(bg, 31, 247, torch.float32, False)
    with pytest.raises(ValueError, match="lifting sizes"):
        check_shape(basegraphs.load_base_graph(2), 1031, 6 * 1031, torch.float32, False)
    deg1 = basegraphs.BaseGraph("deg1", 2, 3, np.array([[0, -1, -1], [1, 0, 0]], np.int32))
    check_shape(deg1, 4, 12, torch.float32, False)
    with pytest.raises(ValueError, match="degree >= 2"):
        check_shape(deg1, 4, 12, torch.float32, True)
    with pytest.raises(ValueError, match="shared memory"):
        check_shape(basegraphs.BaseGraph("wide", 1, 80, np.zeros((1, 80), np.int32)), 1000,
                    80_000, torch.float32, False)
    # what the first design took, it still takes: Z 1..1024, a two-min row of
    # degree above 32, and a frame whose LLRs and edge tables fill the block
    # to the byte (8E + 4n + 4(mb+1) = MAX_BLOCK_SMEM), in both modes of min
    for g, Z in [(demo, 1), (demo, 1024), (qc_ira.make_qc_ira_bg(2, 42, 41), 41),
                 (qc_ira.make_qc_ira_bg(3, 6, 1021), 1021)]:
        for se in (False, True):
            check_shape(g, Z, g.n * Z, torch.float32, se)
    full = basegraphs.BaseGraph("full", 1, 149, np.zeros((1, 149), np.int32))
    assert 8 * 149 + 4 * 149 * 388 + 4 * 2 == MAX_BLOCK_SMEM
    for se in (False, True):
        check_shape(full, 388, 149 * 388, torch.float32, se)
        with pytest.raises(ValueError, match="shared memory"):
            check_shape(basegraphs.BaseGraph("over", 1, 150, np.zeros((1, 150), np.int32)), 388,
                        150 * 388, torch.float32, se)


# ---- on the card (marker `gpu`; skipped without a CUDA device) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("self_exclude", [False, True])
@pytest.mark.parametrize("name", GRAPHS)
def test_kernel_equals_plain_on_card(cuda_device, name, self_exclude):
    bg, Z, H, llr = _decode_case(name, B=1001)
    x = torch.from_numpy(llr).to(cuda_device)
    ours = decode_ldpc_nms_cuda(x, bg, Z, 20, 0.8, self_exclude=self_exclude)
    ref = decode_ldpc_nms_batch(x, H, 20, 0.8, self_exclude=self_exclude)
    for key in ("hard", "iters_used", "parity_ok"):
        assert torch.equal(ours[key].cpu(), ref[key].cpu()), key
