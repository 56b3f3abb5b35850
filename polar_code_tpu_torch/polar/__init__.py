from .construct import construct_info_set

__all__ = ["construct_info_set"]
