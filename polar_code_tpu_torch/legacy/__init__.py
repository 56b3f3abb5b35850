"""Legacy capability surface: PAC codes, rate profiles, channels, OFDM
(port of `polar_code_tpu/legacy/`).

Construction, channels and OFDM math stay host-side NumPy; PAC encoding is
PyTorch and PAC list decoding runs on the card through the CUDA kernel
`csrc/pac_decode.cu` (`pac_cuda.py`), or through its plain PyTorch version
(`pac.py`) for CPU tensors.  The drivers `simulator`, `crc_polar_vs_uncoded`
and `crc_polar_ofdm_ls` run on the card unless given ``device="cpu"``.
"""

from .rate_profile import rateprofile
from .crclib import crc
from .channel import channel

__all__ = ["rateprofile", "crc", "channel"]
