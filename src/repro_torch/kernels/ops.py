"""Public kernel entry points: dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
version.  There is no fallback: a CUDA call that the kernel refuses raises.
"""

from __future__ import annotations

import torch

from .decode_attention import decode_attention_cuda, decode_attention_ref
from .rmsnorm import rmsnorm_cuda, rmsnorm_ref

__all__ = ["decode_attention", "rmsnorm"]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int):
    """Flash-decoding: one token per sequence against the cache prefix ``length``."""
    if q.is_cuda:
        return decode_attention_cuda(q, k, v, length)
    return decode_attention_ref(q, k, v, length)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """Fused RMSNorm with the ``(1 + gamma)`` scale."""
    if x.is_cuda:
        return rmsnorm_cuda(x, gamma, eps)
    return rmsnorm_ref(x, gamma, eps)
