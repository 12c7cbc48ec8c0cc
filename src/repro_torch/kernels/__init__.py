"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and their plain versions."""

from . import ops, ref
from .ops import decode_attention, gemv, gemv_tiles, rmsnorm

__all__ = ["ops", "ref", "decode_attention", "gemv", "gemv_tiles", "rmsnorm"]
