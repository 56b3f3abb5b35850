"""Layered normalized min-sum LDPC decoding in plain PyTorch (port of
`polar_code_tpu/nr/ldpc/decode_nms.py`).

This is the plain version of kernel K2 (`nms_cuda.py`, `csrc/nms_decode.cu`):
it decodes CPU tensors for the sweep and the tests, and it is the oracle the
kernel is held against on the card.  Semantics, op for op as in the JAX
decoder:

* rows are grouped on the host into layers of column-disjoint rows by a
  greedy in-order pass, so updating a layer's rows together equals the
  sequential row order;
* per row, ext = llr − msg; the update is α·∏sign·min|ext|, one shared
  value for every edge of the row (the default), or under `self_exclude`
  the textbook two-min α·(∏sign·sign(ext))·min over the other edges;
  llr = ext + update, written in place;
* after each iteration the syndrome of the hard decisions is checked; a
  frame that passes stops, and its LLRs and messages stay exactly as they
  are; `iters_used` is the stopping iteration, else `max_iter`.

The syndrome is a sum over each row's edges mod 2 rather than the JAX
decoder's dense product with H: both count the same 0/1 terms exactly, and
the edge form stays small at lifting sizes where the dense H has 10⁸
entries.

`decode_ldpc_nms` is the scalar reference-compatible API (one frame, a
dense H).  On the CPU it runs this plain version in float64; on the card it
goes through the kernel in float32, with the base graph and lifting size
recovered from H (`builder.circulant_structure`): a Z×Z circulant block-row
is a group of column-disjoint rows, so the kernel's block-row order gives
the sequential row order's result, as the greedy layers here do.  The
kernel always stops early, so `early_stop=False` raises on the card.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ...utils.device import resolve_device
from .builder import circulant_structure


def _layers_from_h(H: np.ndarray) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    m, n = H.shape
    rr, cc = np.nonzero(H == 1)
    row_cols = np.split(cc, np.searchsorted(rr, np.arange(1, m)))
    deg_max = max((c.size for c in row_cols), default=0)

    # greedy in-order grouping into column-disjoint layers
    layers: List[List[int]] = []
    layer_cols: List[set] = []
    for r in range(m):
        cols = set(row_cols[r].tolist())
        if layers and not (cols & layer_cols[-1]):
            layers[-1].append(r)
            layer_cols[-1] |= cols
        else:
            layers.append([r])
            layer_cols.append(set(cols))

    # padded edge tables: sentinel column index n marks padding
    idx = np.full((m, deg_max), n, dtype=np.int64)
    for r in range(m):
        idx[r, : row_cols[r].size] = row_cols[r]
    pad = idx == n
    return idx, pad, [np.asarray(l, dtype=np.int64) for l in layers]


@functools.lru_cache(maxsize=8)
def _prep(H_bytes: bytes, m: int, n: int):
    return _layers_from_h(np.frombuffer(H_bytes, dtype=np.int8).reshape(m, n))


def decode_ldpc_nms_batch(
    llr: torch.Tensor,
    H: np.ndarray,
    max_iter: int = 20,
    alpha: float = 0.8,
    early_stop: bool = True,
    *,
    self_exclude: bool = False,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """llr [B, n] → {"hard" int8 [B, n], "iters_used" int32 [B],
    "parity_ok" bool [B]}.

    `self_exclude=False` keeps the reference's shared min (every edge of a
    row gets the same message, its own contribution included);
    `self_exclude=True` is textbook two-min layered NMS, which raises on a
    row of degree < 2."""

    H = np.ascontiguousarray((np.asarray(H) % 2).astype(np.int8))
    m, n = H.shape
    if int(llr.shape[-1]) != n:
        raise ValueError("llr length mismatch")
    if llr.device.type == "cuda":
        decode_ldpc_nms_batch.cuda_calls += 1
    B = int(llr.shape[0])
    dev = llr.device
    idx_np, pad_np, layers = _prep(H.tobytes(), m, n)
    deg_max = idx_np.shape[1]
    if self_exclude and m:
        min_deg = int(np.min((~pad_np).sum(axis=1)))
        if min_deg < 2:
            raise ValueError(
                "self_exclude=True needs every check row to have degree >= 2 "
                f"(leave-one-out min is undefined on degree-{min_deg} rows)"
            )
    a = torch.tensor(alpha, dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    arange_deg = torch.arange(deg_max, device=dev)
    layer_tabs = [
        (torch.as_tensor(rows, device=dev), torch.as_tensor(idx_np[rows], device=dev),
         torch.as_tensor(pad_np[rows], device=dev)[None])
        for rows in layers
    ]
    all_idx = torch.as_tensor(idx_np, device=dev)
    all_real = ~torch.as_tensor(pad_np, device=dev)

    def one_iteration(llr_x, msg):
        # llr_x: [B, n+1] (sentinel column n); msg: [B, m, deg] under
        # self_exclude, else one shared value a row, [B, m]
        msg = msg.clone()
        llr_x = llr_x.clone()
        for rows, cols, pad in layer_tabs:
            prev = msg[:, rows] if self_exclude else msg[:, rows, None]
            ext = llr_x[:, cols] - prev  # [B, L, deg]
            sgn = torch.where(pad, one, torch.sign(ext))
            mag = torch.where(pad, inf, ext.abs())
            sprod = torch.prod(sgn, dim=-1, keepdim=True)  # [B, L, 1]
            if self_exclude:
                amin = torch.argmin(mag, dim=-1, keepdim=True)
                is_min = arange_deg[None, None] == amin
                min1 = torch.amin(mag, dim=-1, keepdim=True)
                min2 = torch.amin(torch.where(is_min, inf, mag), dim=-1, keepdim=True)
                update = a * (sprod * sgn) * torch.where(is_min, min2, min1)
                msg[:, rows] = torch.where(pad, zero, update)
            else:
                row_upd = a * sprod * torch.amin(mag, dim=-1, keepdim=True)
                update = row_upd * torch.ones_like(ext)
                msg[:, rows] = row_upd[..., 0]
            llr_x[:, cols] = ext + update
        return llr_x, msg

    def syndrome_ok(llr_x):
        hard = llr_x[:, :n] < 0
        ones = (hard[:, all_idx.clamp(max=n - 1)] & all_real).sum(dim=-1)
        return torch.all(ones % 2 == 0, dim=-1)

    llr_x = torch.cat([llr.to(dtype), torch.zeros((B, 1), dtype=dtype, device=dev)], dim=-1)
    msg = torch.zeros((B, m, deg_max) if self_exclude else (B, m), dtype=dtype, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters_used = torch.full((B,), max_iter, dtype=torch.int32, device=dev)
    for it in range(max_iter):
        new_llr, new_msg = one_iteration(llr_x, msg)
        llr_x = torch.where(done[:, None], llr_x, new_llr)
        mask = done[:, None, None] if self_exclude else done[:, None]
        msg = torch.where(mask, msg, new_msg)
        if not early_stop:
            continue
        newly = ~done & syndrome_ok(llr_x)
        iters_used = torch.where(newly, it + 1, iters_used)
        done = done | newly
        if bool(done.all()):  # every frame frozen: the rest would change nothing
            break

    hard = (llr_x[:, :n] < 0).to(torch.int8)
    return {"hard": hard, "iters_used": iters_used, "parity_ok": syndrome_ok(llr_x)}


decode_ldpc_nms_batch.cuda_calls = 0  # runs of the plain version on CUDA tensors


def decode_ldpc_nms(
    llr: np.ndarray,
    H: np.ndarray,
    max_iter: int = 20,
    alpha: float = 0.8,
    early_stop: bool = True,
    self_exclude: bool = False,
    *,
    device=None,
) -> dict:
    """Scalar reference-compatible API (1D llr)."""

    llr = np.asarray(llr, dtype=np.float64)
    if llr.ndim != 1:
        raise ValueError("llr must be 1D")
    dev = resolve_device(device)
    if dev.type == "cpu":
        res = decode_ldpc_nms_batch(
            torch.as_tensor(llr)[None], H, max_iter=max_iter, alpha=alpha,
            early_stop=early_stop, self_exclude=self_exclude, dtype=torch.float64,
        )
    else:
        if not early_stop:
            raise ValueError("the NMS kernel always stops early; decode with early_stop=False "
                             "on the CPU (device=\"cpu\")")
        from .nms_cuda import decode_ldpc_nms_cuda

        base_graph, Z = circulant_structure(H)
        x = torch.as_tensor(llr, dtype=torch.float32, device=dev)[None]
        res = decode_ldpc_nms_cuda(x, base_graph, Z, max_iter=max_iter, alpha=alpha,
                                   self_exclude=self_exclude)
    return {
        "hard": res["hard"][0].cpu().numpy().astype(np.int8),
        "iters_used": int(res["iters_used"][0]),
        "parity_ok": bool(res["parity_ok"][0]),
    }


__all__ = ["decode_ldpc_nms", "decode_ldpc_nms_batch"]
