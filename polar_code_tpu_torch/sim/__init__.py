from .pipeline import make_fer_chunk, make_ber_chunk

__all__ = ["make_fer_chunk", "make_ber_chunk"]
