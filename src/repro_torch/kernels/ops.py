"""Public kernel entry points: dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
version.  There is no fallback: a CUDA call that the kernel refuses raises.
"""

from __future__ import annotations

import torch

from .decode_attention import decode_attention_cuda, decode_attention_ref
from .gemv import gemv_cuda, gemv_ref
from .gemv_tiles import gemv_tiles_cuda, gemv_tiles_ref
from .rmsnorm import rmsnorm_cuda, rmsnorm_ref

__all__ = ["decode_attention", "gemv", "gemv_tiles", "rmsnorm"]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int):
    """Flash-decoding: one token per sequence against the cache prefix ``length``."""
    if q.is_cuda:
        return decode_attention_cuda(q, k, v, length)
    return decode_attention_ref(q, k, v, length)


def gemv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` for a narrow x (N <= 8 on the card), float32 accumulation."""
    if a.is_cuda:
        return gemv_cuda(a, x)
    return gemv_ref(a, x)


def gemv_tiles(a: torch.Tensor, x: torch.Tensor, *, n_dev: int, my_dev: int, bm: int = 64):
    """``(y, owner_served)``: ``gemv`` with its row tiles issued remote-first."""
    if a.is_cuda:
        return gemv_tiles_cuda(a, x, n_dev=n_dev, my_dev=my_dev, bm=bm)
    return gemv_tiles_ref(a, x, n_dev, my_dev, bm)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """Fused RMSNorm with the ``(1 + gamma)`` scale."""
    if x.is_cuda:
        return rmsnorm_cuda(x, gamma, eps)
    return rmsnorm_ref(x, gamma, eps)
