"""Train symmetric β matrices for DL-SCL flip ranking (port of
`polar_code_tpu/train/train_beta.py`).

Loads `.npz` shards by glob, splits train/val with NumPy `default_rng(seed)`
and shuffles the training batches with `default_rng(seed + 1)` — the same
batches as the JAX trainer.  Logits are −Q = −(|L0| @ β) (the smallest Q is
the most likely flip); the loss is the mean cross-entropy to the oracle flip
index plus λ·Σ off²/dim² over the whole `off_diag` (its unused lower
triangle too); the diagonal is clamped after every step.  The CSV log
(`epoch,train_loss,train_acc,val_loss,val_acc`, Python floats) and the
best-validation β checkpoint (`.npy`) are the JAX trainer's.

The optimizer is RMSprop as `optax.rmsprop(lr, decay=0.99, eps=1e-8)`
computes it, written out in `rmsprop_step`: ν ← 0.99·ν + 0.01·g² from ν = 0,
then p ← p − lr·g·rsqrt(ν + 1e-8), ε inside the square root.
`torch.optim.RMSprop` divides by √ν + ε instead, which differs by orders of
magnitude while ν is small, so it is not used.

Float32 products run in full float32 on the card: training sets the float32
matmul precision to "highest" (so `torch.backends.cuda.matmul.allow_tf32`
is False, no TF32) and restores the caller's setting afterwards.

    python -m polar_code_tpu_torch.train.train_beta --M 8 \
        --data data/train_M8_snr5_seed0_part0.npz --epochs 8
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import time
from glob import glob
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..dlscl.beta import SymmetricBeta
from ..utils.cache import enable_compilation_cache
from ..utils.device import resolve_device
from ..utils.seeding import make_generator, seed_all

RMS_DECAY, RMS_EPS = 0.99, 1e-8


def _load_dataset(paths: Iterable[str]) -> Tuple[np.ndarray, np.ndarray]:
    abs_l0_list: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    for pattern in paths:
        matches = sorted(glob(pattern))
        if not matches and Path(pattern).exists():
            matches = [pattern]
        for file_str in matches:
            data = np.load(file_str)
            abs_l0_list.append(data["abs_l0"])
            labels.append(data["flip_idx"])
    if not abs_l0_list:
        raise FileNotFoundError("No dataset shards found for the provided --data patterns")
    return (
        np.concatenate(abs_l0_list, axis=0).astype(np.float32),
        np.concatenate(labels, axis=0).astype(np.int64),
    )


def _split_train_val(
    abs_l0: np.ndarray, labels: np.ndarray, val_frac: float, seed: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    indices = np.arange(abs_l0.shape[0])
    rng.shuffle(indices)
    split = int(indices.size * (1.0 - val_frac))
    tr, va = indices[:split], indices[split:]
    return abs_l0[tr], labels[tr], abs_l0[va], labels[va]


@torch.no_grad()
def rmsprop_step(param: torch.Tensor, nu: torch.Tensor, lr: float) -> None:
    """One optax-style RMSprop update of `param` from `param.grad`, in place:
    ν ← (1 − 0.99)·g² + 0.99·ν; p ← p + (−lr)·(rsqrt(ν + 1e-8)·g)."""

    g = param.grad
    nu.copy_((1 - RMS_DECAY) * (g * g) + RMS_DECAY * nu)
    param.add_(-lr * (torch.rsqrt(nu + RMS_EPS) * g))


@contextlib.contextmanager
def _full_float32_matmul():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 is still allowed for float32 matmuls")
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def train_beta(args: argparse.Namespace, init: Optional[SymmetricBeta] = None) -> List[dict]:
    """Train β as the CLI does; `init` replaces the seeded initial β (a copy is
    trained).  Returns the CSV rows as dicts, each with `train_ties` and
    `val_ties`, the samples whose two largest logits lie within 1e-5
    relative (argmax near-ties) at the step that scored them, and `seconds`,
    the epoch's host-clock time up to its last host sync."""

    enable_compilation_cache()
    device = resolve_device("cpu" if args.cpu else None)
    seed_all(args.seed)
    abs_l0, labels = _load_dataset(args.data)
    dim = abs_l0.shape[1]

    x_tr, y_tr, x_va, y_va = _split_train_val(abs_l0, labels, args.val_frac, args.seed)

    if init is None:
        model = SymmetricBeta(dim, generator=make_generator(args.seed)).clamp_diagonal()
    else:
        if init.dim != dim:
            raise ValueError(f"init β is {init.dim}-wide, the data {dim}")
        model = SymmetricBeta(dim)
        with torch.no_grad():
            model.off_diag.copy_(init.off_diag)
    model = model.to(device)
    param = model.off_diag
    nu = torch.zeros_like(param)

    def loss_fn(x, y):
        logits = -model(x)
        ce = F.cross_entropy(logits, y)
        l2 = torch.sum(param * param) / (dim * dim)
        loss = ce + args.lambda_l2 * l2 if args.lambda_l2 > 0 else ce
        top2 = torch.topk(logits, 2, dim=1).values
        ties = torch.sum(top2[:, 0] - top2[:, 1] <= 1e-5 * top2.abs().amax(dim=1))
        return loss, torch.sum(torch.argmax(logits, dim=1) == y), ties

    log_dir = Path(args.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    log_path = log_dir / f"train_M{args.M}.csv"
    checkpoint_dir = Path(args.checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    ckpt_path = checkpoint_dir / f"beta_M{args.M}.npy"

    best_val = float("inf")
    best_beta = None
    shuffle_rng = np.random.default_rng(args.seed + 1)
    x_tr_d, y_tr_d = torch.from_numpy(x_tr).to(device), torch.from_numpy(y_tr).to(device)
    x_va_d, y_va_d = torch.from_numpy(x_va).to(device), torch.from_numpy(y_va).to(device)

    def batches(x, y, shuffle):
        order = np.arange(x.shape[0])
        if shuffle:
            shuffle_rng.shuffle(order)
        for start in range(0, order.size, args.batch):
            sel = torch.from_numpy(order[start : start + args.batch]).to(device)
            yield x.index_select(0, sel), y.index_select(0, sel)

    def epoch_sums(parts, total):
        """Batch-size-weighted mean loss, accuracy and ties; one host sync.
        The loss sum runs over float32 values, as np.sum of the JAX trainer's."""

        if not parts:
            return float("nan"), float("nan"), 0
        losses, accs, ties = (torch.stack(p).cpu().numpy() for p in zip(*parts))
        return float(np.sum(losses)) / total, int(np.sum(accs)) / total, int(np.sum(ties))

    rows: List[dict] = []
    with _full_float32_matmul(), log_path.open("w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["epoch", "train_loss", "train_acc", "val_loss", "val_acc"])
        for epoch in range(1, args.epochs + 1):
            t_epoch = time.perf_counter()
            parts, total = [], 0
            for xb, yb in batches(x_tr_d, y_tr_d, shuffle=True):
                param.grad = None
                loss, acc_count, ties = loss_fn(xb, yb)
                loss.backward()
                rmsprop_step(param, nu, args.lr)
                model.clamp_diagonal()
                bs = int(xb.shape[0])
                parts.append((loss.detach() * bs, acc_count, ties))
                total += bs
            train_loss, train_acc, train_ties = epoch_sums(parts, max(total, 1))

            parts, val_total = [], 0
            with torch.no_grad():
                for xb, yb in batches(x_va_d, y_va_d, shuffle=False):
                    loss, acc_count, ties = loss_fn(xb, yb)
                    bs = int(xb.shape[0])
                    parts.append((loss * bs, acc_count, ties))
                    val_total += bs
            val_loss, val_acc, val_ties = epoch_sums(parts, val_total)
            seconds = time.perf_counter() - t_epoch

            writer.writerow([epoch, train_loss, train_acc, val_loss, val_acc])
            f.flush()
            rows.append({
                "epoch": epoch, "train_loss": train_loss, "train_acc": train_acc,
                "val_loss": val_loss, "val_acc": val_acc,
                "train_ties": train_ties, "val_ties": val_ties, "seconds": seconds,
            })

            if val_total > 0 and val_loss < best_val:
                best_val = val_loss
                best_beta = model.beta_matrix().detach().cpu().numpy()
        if best_beta is None:
            best_beta = model.beta_matrix().detach().cpu().numpy()

    np.save(ckpt_path, best_beta)
    print(f"Saved β checkpoint to {ckpt_path}")
    return rows


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train symmetric β for DL-SCL")
    parser.add_argument("--M", type=int, required=True, help="SCL list size")
    parser.add_argument("--data", nargs="+", required=True, help="Glob(s) to dataset shards")
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--lambda_l2", type=float, default=0.25)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--val_frac", type=float, default=0.1)
    parser.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    parser.add_argument("--log_dir", type=str, default="logs")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU (default: the card)")
    return parser


def main(argv: List[str] | None = None) -> List[dict]:
    args = build_argparser().parse_args(argv)
    return train_beta(args)


if __name__ == "__main__":
    main()
