"""Arithmetic cost of the DL-SCL flip metric ``Q = |L0| @ beta`` (port of
``polar_code_tpu/eval/opcount.py``).

For a trained beta matrix it reports, before and after magnitude pruning,
how many multiplies and adds one metric evaluation costs: Q_j = sum_i
|L0|_i * beta_ij, so a column with c nonzeros costs c multiplies and c−1
adds (0 adds when the column is empty).  Output schema:
``stage,nonzero,multiplies,adds`` with one ``full`` and one ``pruned`` row,
the same bytes as the JAX tool's on the same beta.

Host-side NumPy only; nothing here touches a device.

    python -m polar_code_tpu_torch.eval.opcount --beta checkpoints/beta_M4.npy \
        --report results/opcount_M4.csv
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class BetaOpCount:
    """Multiply/add cost of one ``|L0| @ beta`` evaluation."""

    nonzero: int
    multiplies: int
    adds: int

    @classmethod
    def of(cls, beta: np.ndarray) -> "BetaOpCount":
        if beta.ndim != 2 or beta.shape[0] != beta.shape[1]:
            raise ValueError(
                f"beta must be square, got shape {beta.shape!r}"
            )
        per_col = np.count_nonzero(beta, axis=0)
        nnz = int(per_col.sum())
        # one add fewer than multiplies per non-empty output column
        adds = int(per_col.sum() - np.count_nonzero(per_col))
        return cls(nonzero=nnz, multiplies=nnz, adds=adds)

    def csv_row(self, stage: str) -> list:
        return [stage, self.nonzero, self.multiplies, self.adds]


def prune_beta(beta: np.ndarray, threshold: float) -> np.ndarray:
    """Zero every entry with ``|beta| <= threshold`` (reference semantics:
    the comparison is inclusive)."""
    return np.where(np.abs(beta) > threshold, beta, 0.0)


def count_ops(beta: np.ndarray) -> tuple:
    c = BetaOpCount.of(beta)
    return c.nonzero, c.multiplies, c.adds


def run(args: argparse.Namespace) -> None:
    beta = np.load(args.beta)
    stages = {
        "full": BetaOpCount.of(beta),
        "pruned": BetaOpCount.of(prune_beta(beta, args.prune)),
    }

    out = Path(args.report)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["stage", "nonzero", "multiplies", "adds"])
        for stage, counts in stages.items():
            w.writerow(counts.csv_row(stage))
    print(f"Saved opcount report to {out}")

    if args.save_pruned:
        dest = Path(args.save_pruned)
        dest.parent.mkdir(parents=True, exist_ok=True)
        np.save(dest, prune_beta(beta, args.prune))
        print(f"Saved pruned β to {dest}")


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Count operations for β metric")
    parser.add_argument("--beta", required=True, help="Path to β matrix (.npy)")
    parser.add_argument("--prune", type=float, default=1e-4, help="Threshold for pruning")
    parser.add_argument("--report", required=True, help="CSV output path")
    parser.add_argument("--save_pruned", help="Optional path to save pruned matrix")
    return parser


def main(argv: list | None = None) -> None:
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
