"""PyTorch + CUDA port of `polar_code_tpu` for NVIDIA Hopper (H100).

The package mirrors the JAX package's module names so each function's
counterpart is easy to find.  It imports `torch` and `numpy` only — never
`jax` and nothing from `polar_code_tpu`.  Entry points run on `cuda` unless
the caller asks for `device="cpu"`.  On a CUDA tensor every SCL decode goes
through the hand-written kernel in `csrc/scl_decode.cu`, every layered NMS
LDPC decode through `csrc/nms_decode.cu` and every PAC list decode through
`csrc/pac_decode.cu`; the plain PyTorch decoders (`ops/scl.py`,
`nr/ldpc/decode_nms.py`, `legacy/pac.py`) serve CPU tensors and are the
kernels' oracles.
"""

from . import config
from .polar.construct import construct_info_set

__version__ = "0.1.0"

# the JAX package's lazy re-exports, under the port's names (its
# `decode_scl_pallas` is `decode_scl_cuda` here); importing the package
# builds and loads no kernel library
_LAZY = {
    "decode_scl_batch": ("polar_code_tpu_torch.ops.scl", "decode_scl_batch"),
    "decode_scl_cuda": ("polar_code_tpu_torch.ops.scl_cuda", "decode_scl_cuda"),
    "sc_decode_batch": ("polar_code_tpu_torch.ops.sc", "sc_decode_batch"),
    "decode_scl_adaptive": ("polar_code_tpu_torch.ops.adaptive", "decode_scl_adaptive"),
    "decode_with_retries_batch": ("polar_code_tpu_torch.dlscl.flip", "decode_with_retries_batch"),
    "SymmetricBeta": ("polar_code_tpu_torch.dlscl.beta", "SymmetricBeta"),
    "encode_batch": ("polar_code_tpu_torch.ops.polar_transform", "encode_batch"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'polar_code_tpu_torch' has no attribute {name!r}")


__all__ = [
    "config",
    "construct_info_set",
    "decode_scl_adaptive",
    "decode_scl_batch",
    "decode_scl_cuda",
    "sc_decode_batch",
    "decode_with_retries_batch",
    "SymmetricBeta",
    "encode_batch",
    "__version__",
]
