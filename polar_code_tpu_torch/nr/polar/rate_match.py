"""NR polar rate matching, puncture or repeat (port of
`polar_code_tpu/nr/polar/rate_match.py`).

``E ≤ N`` truncates, ``E > N`` tile-repeats.  The derate fills a missing tail
with −1.0 (a quirk of the reference, kept; the LDPC derate fills 0.0) and
averages repeated LLRs (full repeats plus the remainder prefix).
"""

from __future__ import annotations

import numpy as np
import torch


def rate_match_polar(bits: torch.Tensor, E: int, mode: str = "puncture") -> torch.Tensor:
    """Select E transmitted bits along the last axis."""

    N = int(bits.shape[-1])
    if E <= N:
        return bits[..., :E]
    idx = torch.as_tensor(np.arange(E) % N, device=bits.device)
    return bits[..., idx]


def derate_match_polar(llr_E: torch.Tensor, N: int, mode: str = "puncture") -> torch.Tensor:
    """Map E received LLRs back to N decoder inputs along the last axis."""

    E = int(llr_E.shape[-1])
    lead = llr_E.shape[:-1]
    if E <= N:
        fill = torch.full((*lead, N - E), -1.0, dtype=llr_E.dtype, device=llr_E.device)
        return torch.cat([llr_E, fill], dim=-1)
    reps = E // N
    remainder = E % N
    accum = llr_E[..., : reps * N].reshape(*lead, reps, N).sum(dim=-2)
    counts = np.full(N, reps, dtype=np.float64)
    if remainder:
        tail = torch.zeros((*lead, N), dtype=llr_E.dtype, device=llr_E.device)
        tail[..., :remainder] = llr_E[..., reps * N :]
        accum = accum + tail
        counts[:remainder] += 1
    counts[counts == 0] = 1
    return accum / torch.as_tensor(counts, dtype=llr_E.dtype, device=llr_E.device)


__all__ = ["rate_match_polar", "derate_match_polar"]
