"""NR-style LDPC rate matching, truncate or repeat (port of
`polar_code_tpu/nr/ldpc/rate_match.py`).

The derate fills punctured positions with 0.0 (unlike the polar derate's
−1.0) and averages repeats.
"""

from __future__ import annotations

import numpy as np
import torch


def rate_match_ldpc(codeword: torch.Tensor, E: int) -> torch.Tensor:
    N = int(codeword.shape[-1])
    if E <= N:
        return codeword[..., :E]
    idx = torch.as_tensor(np.arange(E) % N, device=codeword.device)
    return codeword[..., idx]


def derate_match_ldpc(llr: torch.Tensor, N: int) -> torch.Tensor:
    E = int(llr.shape[-1])
    lead = llr.shape[:-1]
    if E <= N:
        fill = torch.zeros((*lead, N - E), dtype=llr.dtype, device=llr.device)
        return torch.cat([llr, fill], dim=-1)
    reps = E // N
    remainder = E % N
    accum = llr[..., : reps * N].reshape(*lead, reps, N).sum(dim=-2)
    counts = np.full(N, reps, dtype=np.float64)
    if remainder:
        tail = torch.zeros((*lead, N), dtype=llr.dtype, device=llr.device)
        tail[..., :remainder] = llr[..., reps * N :]
        accum = accum + tail
        counts[:remainder] += 1
    counts[counts == 0] = 1
    return accum / torch.as_tensor(counts, dtype=llr.dtype, device=llr.device)


__all__ = ["rate_match_ldpc", "derate_match_ldpc"]
