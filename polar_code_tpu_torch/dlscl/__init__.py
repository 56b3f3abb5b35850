from .beta import SymmetricBeta
from .flip import choose_flip_index, decode_with_retries, retry_with_flip

__all__ = [
    "SymmetricBeta",
    "choose_flip_index",
    "decode_with_retries",
    "retry_with_flip",
]
