from .basegraphs import BaseGraph, load_base_graph
from .builder import build_h_matrix
from .encode import encode_ldpc_batch, parity_solver_matrix
from .rate_match import rate_match_ldpc, derate_match_ldpc
from .decode_nms import decode_ldpc_nms_batch
from .nms_cuda import decode_ldpc_nms_cuda
from .nr_tables import (
    all_lifting_sizes,
    choose_base_graph,
    choose_lifting_size,
    load_base_graph_file,
)

__all__ = [
    "BaseGraph",
    "load_base_graph",
    "all_lifting_sizes",
    "choose_base_graph",
    "choose_lifting_size",
    "load_base_graph_file",
    "build_h_matrix",
    "encode_ldpc_batch",
    "parity_solver_matrix",
    "rate_match_ldpc",
    "derate_match_ldpc",
    "decode_ldpc_nms_batch",
    "decode_ldpc_nms_cuda",
]
