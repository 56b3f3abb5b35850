"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; a missing
card is an error, never a silent move to the CPU.  The scalar,
reference-compatible entry points take their float type from the device
(`scalar_dtype`).  With one process per
card (`parallel/mesh.py`), "cuda" means this rank's own card,
`cuda:{local rank % cards}`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..parallel.mesh import local_rank


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means "cuda".  A CUDA device comes back indexed ("cuda" is this
    rank's card) and is made the current device, before any tensor or
    generator of the run is created on it.  Raises if CUDA is asked for and
    the card is missing."""

    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) to "
            "run on the CPU"
        )
    count = torch.cuda.device_count()
    index = local_rank() % count if dev.index is None else dev.index
    if index >= count:
        raise RuntimeError(f"{dev} asked for, but there are {count} CUDA devices")
    dev = torch.device("cuda", index)
    torch.cuda.set_device(dev)
    return dev


def scalar_dtype(device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The float type of a scalar entry point's decode: `dtype` when given;
    else float64 on the CPU (the JAX package's x64 parity path) and float32
    on the card (the kernels' type).  An explicit float64 on the card is
    passed on, and the kernel's shape check raises for it."""

    if dtype is not None:
        return dtype
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


__all__ = ["resolve_device", "scalar_dtype"]
