"""Public kernel entry points: dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
version.  There is no fallback: a CUDA call that the kernel refuses raises.
``rmsnorm`` is differentiable on both: on the card through
:class:`~.rmsnorm.RMSNormFunction` (the forward and backward kernels) where
autograd records, on the CPU through the plain version's own autograd.

A ``meta`` tensor (the dry run's: shapes, no data) takes an explicit branch
of its own to the kernels' shape functions, the operators
``repro_torch::rmsnorm`` / ``rmsnorm_bwd`` (:func:`~.rmsnorm.rmsnorm_op`),
through the same :class:`~.rmsnorm.RMSNormFunction` where autograd records,
``repro_torch::decode_attention`` / ``decode_attention_partial``
(:func:`~.decode_attention.decode_attention_op`) and
``repro_torch::mamba_decode`` (:func:`~.mamba_decode.mamba_decode_op`); they
allocate the outputs' shapes, launch nothing, and the dry run's dispatch
modes count each as one kernel call.  A CUDA tensor never takes it: the
operators' dispatch cost some 20 µs of host time a call and 4 ms a gemma3-1b
decode step more than the wrappers, measured on an NVIDIA H100 80GB HBM3 at
700 W (``tools/rmsnorm_dispatch_cost.py``; PERF.md), so they are shape
functions only and raise on any other tensor.
"""

from __future__ import annotations

import torch

from .decode_attention import (decode_attention_cuda, decode_attention_op,
                               decode_attention_partial_cuda, decode_attention_partial_op,
                               decode_attention_partial_ref, decode_attention_ref)
from .gemv import gemv_cuda, gemv_ref
from .gemv_tiles import gemv_tiles_cuda, gemv_tiles_ref
from .mamba_decode import mamba_decode_cuda, mamba_decode_op, mamba_decode_ref
from .rmsnorm import (RMSNormFunction, rmsnorm_bwd_cuda, rmsnorm_bwd_op, rmsnorm_cuda, rmsnorm_op,
                      rmsnorm_ref)

__all__ = ["decode_attention", "decode_attention_partial", "gemv", "gemv_tiles", "mamba_decode",
           "rmsnorm"]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int):
    """Flash-decoding: one token per sequence against the cache prefix ``length``."""
    if q.is_cuda:
        return decode_attention_cuda(q, k, v, length)
    if q.is_meta:
        return decode_attention_op(q, k, v, int(length))
    return decode_attention_ref(q, k, v, length)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int):
    """``(o float32, lse)`` of one slice of S against its valid prefix
    ``length`` (0 allowed), for ``decode_attention.combine_partials``."""
    if q.is_cuda:
        return decode_attention_partial_cuda(q, k, v, length)
    if q.is_meta:
        return decode_attention_partial_op(q, k, v, int(length))
    return decode_attention_partial_ref(q, k, v, length)


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


def mamba_decode(proj: torch.Tensor, conv: torch.Tensor, h: torch.Tensor, conv_w: torch.Tensor,
                 dt_bias: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                 norm_z: torch.Tensor):
    """One Mamba2 decode step between the projections: ``(y, conv)``, h
    updated in place (:func:`~.mamba_decode.mamba_decode_cuda`)."""
    if proj.is_cuda:
        return mamba_decode_cuda(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z)
    if proj.is_meta:
        return mamba_decode_op(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z)
    return mamba_decode_ref(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """Fused RMSNorm with the ``(1 + gamma)`` scale.

    On the card one forward launch a call; where autograd records (grad mode
    on and x or gamma requiring grad) the backward kernel gives the gradients.
    """
    if x.is_cuda:  # the kernels
        fns = (rmsnorm_cuda, rmsnorm_bwd_cuda)
    elif x.is_meta:  # the dry run's shapes: the kernels' shape functions
        fns = (rmsnorm_op, rmsnorm_bwd_op)
    else:
        return rmsnorm_ref(x, gamma, eps)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad):
        return RMSNormFunction.apply(x, gamma, eps, fns)
    return fns[0](x, gamma, eps)
