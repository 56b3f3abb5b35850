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
