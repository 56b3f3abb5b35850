"""PyTorch + CUDA port of `polar_code_tpu` for NVIDIA Hopper (H100).

The package mirrors the JAX package's module names so each function's
counterpart is easy to find.  It imports `torch` and `numpy` only — never
`jax` and nothing from `polar_code_tpu`.  Entry points run on `cuda` unless
the caller asks for `device="cpu"`; every SCL decode on a CUDA tensor goes
through the hand-written kernel in `csrc/scl_decode.cu`, and the plain
PyTorch decoder (`ops/scl.py`) serves CPU tensors and is the kernel's oracle.
"""
