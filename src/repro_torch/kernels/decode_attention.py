"""Flash-decoding attention: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/decode_attention.py``.  One query token per sequence,
``q[B, H, D]``, against ``k, v[B, S, KV, D]`` with GQA ``rep = H / KV``; only
the cache prefix ``[0, length)`` takes part.  The kernel
(``csrc/decode_attention.cu``) runs one CTA per ``(kv head, batch row)``;
:func:`decode_attention_ref` is the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["decode_attention_cuda", "decode_attention_ref"]

_NEG_INF = -2.0e38
_MAX_REP = 16  # kMaxRep in the kernel
_MAX_VECS = 128  # 16-byte vectors in a row of D: one per thread of the CTA


def decode_attention_ref(
    q: torch.Tensor,  # [B, H, D]
    k: torch.Tensor,  # [B, S, KV, D]
    v: torch.Tensor,  # [B, S, KV, D]
    length: int,      # valid prefix of the cache
) -> torch.Tensor:
    """Softmax attention in float32 over the first ``length`` slots, in q's dtype."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qh = q.reshape(B, KV, rep, D).float() * (D ** -0.5)
    s = torch.einsum("bgrd,bsgd->bgrs", qh, k.float())
    mask = torch.arange(S, device=q.device) < length
    s = torch.where(mask, s, torch.tensor(_NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", w, v.float())
    return o.reshape(B, H, D).to(q.dtype)


@functools.cache
def _launch_fn():
    fn = build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int
) -> torch.Tensor:
    """Launch the kernel (CUDA tensors) and return ``o[B, H, D]`` in q's dtype.

    Takes float32 or bfloat16 q, k, v of one dtype, contiguous, with
    ``H % KV == 0``, ``H / KV <= 16``, D a multiple of 16 bytes and at most
    128 such vectors (512 float32, 1024 bf16), and ``length >= 1`` (a length above S means all of S).  Raises on anything
    else, and on a launch the runtime refuses.  Each launch adds one to
    ``decode_attention_cuda.launches``.
    """
    if not (q.device.type == "cuda" and k.device == q.device and v.device == q.device):
        raise ValueError(f"decode_attention_cuda needs CUDA tensors on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in build.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention_cuda takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention_cuda needs q [B,H,D] and k, v [B,S,KV,D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    vec = 16 // q.element_size()
    if (k.shape[0] != B or k.shape[3] != D or H % KV != 0 or H // KV > _MAX_REP
            or D % vec != 0 or D // vec > _MAX_VECS or B > 65535 or S == 0):
        raise ValueError(f"decode_attention_cuda does not take q {tuple(q.shape)} "
                         f"with k {tuple(k.shape)} (needs H % KV == 0, H/KV <= "
                         f"{_MAX_REP}, D % {vec} == 0, D <= {_MAX_VECS * vec})")
    length = int(length)
    if length < 1:
        raise ValueError(f"decode_attention_cuda needs length >= 1, got {length}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention_cuda needs contiguous q, k, v")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention_cuda needs 16-byte aligned q, k, v")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _launch_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                          B, H, KV, S, D, min(length, S), float(D ** -0.5),
                          build.DTYPE_CODE[q.dtype], stream)
    if status != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with CUDA error "
                           f"{status}")
    decode_attention_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0
