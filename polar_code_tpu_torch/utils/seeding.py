"""Deterministic seeding (port of `polar_code_tpu/utils/seeding.py`).

The JAX package folds integer tags (Eb/N0 point, chunk index, ...) into a
root `jax.random` key.  The port folds the same tags into a 63-bit seed with
the SplitMix64 finaliser and seeds an explicit `torch.Generator` on the
device from it, so every chunk's draws depend only on (seed, tags) — not on
the order in which chunks run or on the batch they share a step with.

Torch cannot reproduce threefry's bits, so sweeps of the two packages agree
statistically, not draw for draw.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_seed(seed: int, *tags: int) -> int:
    """Derive a 63-bit seed from a root seed and a sequence of integer tags."""

    x = _splitmix64(int(seed) & _MASK64)
    for tag in tags:
        x = _splitmix64(x ^ (int(tag) & _MASK64))
    return x >> 1


def make_generator(seed: int, *tags: int, device="cpu") -> torch.Generator:
    """A `torch.Generator` on `device` seeded from (seed, *tags)."""

    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(seed, *tags))
    return gen


def seed_all(seed: int) -> None:
    """Seed the host-side RNGs (Python, NumPy).  Device draws use generators."""

    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)


__all__ = ["fold_seed", "make_generator", "seed_all"]
