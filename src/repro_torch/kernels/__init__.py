"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and their plain versions."""

from . import ops, ref
from .ops import decode_attention, rmsnorm

__all__ = ["ops", "ref", "decode_attention", "rmsnorm"]
