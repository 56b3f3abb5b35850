"""The port's scalar NR entry points against the JAX package's, on the CPU in
float64: `encode_ldpc`, `decode_ldpc_nms` (demo graph at Z 4 and 32, QC-IRA
4×8 at Z=31; shared and two-min; with and without early stop),
`encode_rate_matched` and `decode_rate_matched_scl` at BER run (c)'s shape
(N=128, K=64+24, E=256, M=4) — every output identical.  And
`circulant_structure`, the inverse of `build_h_matrix` that hands a dense H
to the NMS kernel on the card: it recovers every graph of the repository
from its lifted H, and a random H at Z = 1.
"""

import numpy as np
import pytest

from polar_code_tpu.nr.ldpc import decode_ldpc_nms as jax_decode_nms
from polar_code_tpu.nr.ldpc import encode_ldpc as jax_encode_ldpc
from polar_code_tpu.nr.polar import scl_nr as jax_scl_nr
from polar_code_tpu_torch.nr.ldpc import (
    build_h_matrix,
    circulant_structure,
    decode_ldpc_nms,
    encode_ldpc,
    load_base_graph,
)
from polar_code_tpu_torch.nr.ldpc.qc_ira import make_qc_ira_bg
from polar_code_tpu_torch.nr.polar import scl_nr
from polar_code_tpu_torch.ops.crc import attach_crc
from polar_code_tpu_torch.polar.construct import construct_info_set

CRC24 = "0x1864CFB"
GRAPHS = {"demo Z=4": (load_base_graph(1), 4), "demo Z=32": (load_base_graph(2), 32),
          "ira4x8 Z=31": (make_qc_ira_bg(4, 8, 31), 31)}


def codeword_llrs(H, B, ebno_db, seed):
    """LLRs of B random codewords of H through BPSK/AWGN, and the codewords."""

    rng = np.random.default_rng(seed)
    m, n = H.shape
    cws = np.stack([encode_ldpc(rng.integers(0, 2, n - m), H) for _ in range(B)])
    nv = 1.0 / (2.0 * ((n - m) / n) * 10 ** (ebno_db / 10.0))
    y = 1.0 - 2.0 * cws + rng.normal(0.0, np.sqrt(nv), cws.shape)
    return 2.0 * y / nv, cws


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_encode_ldpc_matches_jax(graph):
    H = build_h_matrix(*GRAPHS[graph])
    m, n = H.shape
    rng = np.random.default_rng(1)
    for _ in range(4):
        payload = rng.integers(0, 2, n - m)
        ours, theirs = encode_ldpc(payload, H), jax_encode_ldpc(payload, H)
        assert ours.dtype == theirs.dtype == np.int8
        np.testing.assert_array_equal(ours, theirs)
        assert not ((H.astype(np.int64) @ ours) % 2).any()
    with pytest.raises(ValueError, match="payload must be 1D"):
        encode_ldpc(np.zeros((1, n - m)), H)


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("self_exclude", [False, True])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_decode_ldpc_nms_matches_jax(graph, self_exclude, early_stop):
    H = build_h_matrix(*GRAPHS[graph])
    llr, _ = codeword_llrs(H, 3, 3.0 if "ira" in graph else 8.0, seed=len(graph) + self_exclude)
    stopped = 0
    for row in llr:
        ours = decode_ldpc_nms(row, H, max_iter=10, early_stop=early_stop,
                               self_exclude=self_exclude, device="cpu")
        theirs = jax_decode_nms(row, H, max_iter=10, early_stop=early_stop,
                                self_exclude=self_exclude)
        assert list(ours) == list(theirs) == ["hard", "iters_used", "parity_ok"]
        assert ours["hard"].dtype == theirs["hard"].dtype == np.int8
        np.testing.assert_array_equal(ours["hard"], theirs["hard"])
        assert type(ours["iters_used"]) is int and ours["iters_used"] == theirs["iters_used"]
        assert type(ours["parity_ok"]) is bool and ours["parity_ok"] == theirs["parity_ok"]
        stopped += ours["iters_used"] < 10
    assert stopped == 0 or early_stop
    with pytest.raises(ValueError, match="llr must be 1D"):
        decode_ldpc_nms(llr, H, device="cpu")


def test_circulant_structure_recovers_the_repository_graphs():
    graphs = dict(GRAPHS)
    for (m, n), Z in (((3, 6), 5), ((46, 68), 47), ((2, 42), 41)):
        graphs[f"ira{m}x{n} Z={Z}"] = (make_qc_ira_bg(m, n, Z), Z)
    for name, (bg, Z) in graphs.items():
        H = build_h_matrix(bg, Z)
        got, z = circulant_structure(H)
        assert z == Z, name
        assert (got.m, got.n) == (bg.m, bg.n)
        np.testing.assert_array_equal(got.shifts, bg.shifts, err_msg=name)
        np.testing.assert_array_equal(build_h_matrix(got, z), H)
    rng = np.random.default_rng(3)
    H = (rng.random((6, 10)) < 0.4).astype(np.int8)
    got, z = circulant_structure(H)
    assert z == 1 and got.shifts.shape == H.shape
    np.testing.assert_array_equal(build_h_matrix(got, 1), H)
    # a block that is not a whole circulant forces a smaller Z
    H = build_h_matrix(load_base_graph(1), 4)
    H[0, :] ^= 1
    assert circulant_structure(H)[1] == 1


def test_rate_matched_scalar_matches_jax():
    N, K, kp, E, M = 128, 88, 64, 256, 4
    info = construct_info_set(N, K)
    rng = np.random.default_rng(4)
    nv = 1.0 / (2.0 * (kp / E) * 10 ** (3.0 / 10.0))
    for _ in range(3):
        payload = rng.integers(0, 2, kp)
        tx = scl_nr.encode_rate_matched(payload, CRC24, N, E, info, device="cpu")
        np.testing.assert_array_equal(tx, jax_scl_nr.encode_rate_matched(payload, CRC24, N, E, info))
        assert tx.dtype == np.int8 and tx.shape == (E,)
        llr = 2.0 * (1.0 - 2.0 * tx + rng.normal(0.0, np.sqrt(nv), E)) / nv
        ours = scl_nr.decode_rate_matched_scl(llr, CRC24, N, E, info, M, device="cpu")
        theirs = jax_scl_nr.decode_rate_matched_scl(llr, CRC24, N, E, info, M)
        assert list(ours) == list(theirs)
        for key in ("payload", "best_path_bits"):
            assert ours[key].dtype == theirs[key].dtype == np.int8
            np.testing.assert_array_equal(ours[key], theirs[key])
        assert type(ours["crc_pass"]) is bool and ours["crc_pass"] == theirs["crc_pass"]
        if ours["crc_pass"]:
            np.testing.assert_array_equal(ours["best_path_bits"], attach_crc(payload, CRC24))
