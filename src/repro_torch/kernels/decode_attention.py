"""Flash-decoding attention: the CUDA kernel's wrapper and its plain versions.

Port of ``repro/kernels/decode_attention.py``.  One query token per sequence,
``q[B, H, D]``, against ``k, v[B, S, KV, D]`` with GQA ``rep = H / KV``; only
the cache prefix ``[0, length)`` takes part.  The kernel
(``csrc/decode_attention.cu``) cuts that prefix into chunks chosen by
:func:`decode_attention_plan`, runs one CTA per (chunk, kv head, batch row)
and combines the chunks' float32 (max, sum, accumulator) in chunk order in the
same launch.  :func:`decode_attention_ref` is the same function in plain
PyTorch; :func:`decode_attention_split_ref` is the kernel's split algebra in
plain PyTorch, for the tests.

A slice of S (a rank's part of a cache cut over S: the sequence-parallel
decode) takes the partial entry, :func:`decode_attention_partial_cuda`: the
same kernel writing a float32 output and each row's log-sum-exp, for
:func:`combine_partials` to join the slices' partials in rank order.  It takes
a slice with no valid slot (``length`` 0): one launch that writes ``o = 0``
and a log-sum-exp of about ``-2e38``, so that every rank launches the same
kernels a step.  :func:`decode_attention_partial_ref` is its plain version.

The operators ``repro_torch::decode_attention`` and
``repro_torch::decode_attention_partial`` are the kernel's shape functions
for the dry run's ``meta`` tensors (``kernels/ops.py``); they launch nothing
and raise on any other tensor.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import build
from .gemv import sm_count

__all__ = ["decode_attention_cuda", "decode_attention_partial_cuda", "decode_attention_ref",
           "decode_attention_partial_ref", "decode_attention_split_ref", "combine_partials",
           "decode_attention_plan", "DecodeAttentionPlan", "blocks_per_sm",
           "decode_attention_op", "decode_attention_partial_op"]

_NEG_INF = -2.0e38
_MAX_REP = 16  # kMaxRep in the kernel
_MAX_VECS = 128  # 16-byte vectors in a row of D: one column vector a thread
MIN_CHUNK = 16  # slots: a chunk is a positive multiple of this
PLAN_CHUNK = 32  # slots: the least chunk a default plan takes (16 measured slower: PERF.md)
MAX_BLOCK = 128  # kMaxBlock: slots a CTA stages in shared memory at once
BLOCK_BYTES = 64 * 1024  # K and V of one staged block, at most
MAX_SPLITS = 256  # chunks of one (b, kv head): bounds the combine's shared memory
CTAS_PER_SM = 2  # CTAs a plan aims at for each SM (measured: PERF.md)


@dataclass(frozen=True)
class DecodeAttentionPlan:
    """How a launch cuts the valid prefix ``[0, length)`` of the cache.

    ``splits`` chunks of ``chunk`` slots (a multiple of 16; the last may be
    shorter, none is empty; one chunk, empty, for ``length`` 0), one CTA each
    per (kv head, batch row); a CTA stages its chunk in shared memory
    ``block`` slots at a time.
    """

    chunk: int
    splits: int
    block: int

    def ctas(self, B: int, KV: int) -> int:
        return B * KV * self.splits

    def workspace_bytes(self, B: int, KV: int, rep: int, D: int) -> int:
        """float32 partials ``acc [B KV splits rep D]``, ``(m, l)`` and one
        int32 counter a (b, kv head); none with one split."""
        if self.splits == 1:
            return 0
        items = B * KV * self.splits * rep
        return 4 * items * (D + 2) + 4 * B * KV

    def check(self, length: int) -> None:
        """Raise unless the chunks cover ``[0, length)`` once, none empty (one
        chunk where ``length`` is 0)."""
        if not (self.chunk >= 1 and self.splits >= 1 and 1 <= self.block <= MAX_BLOCK
                and length >= 0
                and (self.splits - 1) * self.chunk < max(length, 1) <= self.splits * self.chunk):
            raise ValueError(f"plan {self} does not cover length {length} with non-empty "
                             f"chunks and blocks of at most {MAX_BLOCK} slots")


@functools.lru_cache(maxsize=4096)
def decode_attention_plan(B: int, KV: int, rep: int, D: int, itemsize: int, length: int,
                          sms: int, *, chunk: int | None = None) -> DecodeAttentionPlan:
    """Choose the chunks of a launch; pure, so it runs (and is tested) on the CPU.

    ``length`` is the valid prefix, ``min(length, S)``, 0 for a slice of S
    with no valid slot (one split).  Without ``chunk``,
    the smallest multiple of 16 slots, at least ``PLAN_CHUNK``, that keeps
    ``B * KV * splits`` within ``CTAS_PER_SM * sms`` CTAs (within one wave of
    resident CTAs); one split when ``B * KV`` alone fills that, or ``length``
    fits one chunk.  A block is the chunk, or as many slots (a multiple of 16)
    as ``BLOCK_BYTES`` holds of K and V, at most ``MAX_BLOCK``.
    """
    if not (B >= 1 and KV >= 1 and 1 <= rep <= _MAX_REP and D >= 1 and itemsize in (2, 4)
            and length >= 0 and sms >= 1):
        raise ValueError(f"decode_attention_plan takes positive sizes, rep <= {_MAX_REP} "
                         f"and itemsize 2 or 4; got B={B}, KV={KV}, rep={rep}, D={D}, "
                         f"itemsize={itemsize}, length={length}, sms={sms}")
    if chunk is None:
        per_row = max(1, CTAS_PER_SM * sms // (B * KV))
        chunk = max(-(-length // per_row), -(-length // MAX_SPLITS), PLAN_CHUNK)
        chunk = -(-chunk // MIN_CHUNK) * MIN_CHUNK
    elif chunk < MIN_CHUNK or chunk % MIN_CHUNK:
        raise ValueError(f"a chunk is a positive multiple of {MIN_CHUNK} slots, got {chunk}")
    fits = max(MIN_CHUNK, BLOCK_BYTES // (2 * D * itemsize) // MIN_CHUNK * MIN_CHUNK)
    return DecodeAttentionPlan(chunk=chunk, splits=max(1, -(-length // chunk)),
                               block=min(chunk, MAX_BLOCK, fits))


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


def decode_attention_partial_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, H, D] float32, lse [B, H] float32)`` over the first ``length``
    slots: the softmax output and ``M + log(max(l, 1e-20))`` of each row's
    scores (M their max, l the sum of ``e^(s - M)``); ``o = 0`` and
    ``lse = -2e38`` where ``length`` is 0."""
    B, H, D = q.shape
    KV = k.shape[2]
    rep = H // KV
    length = min(int(length), k.shape[1])
    if length == 0:
        return (torch.zeros(B, H, D, dtype=torch.float32, device=q.device),
                torch.full((B, H), _NEG_INF, dtype=torch.float32, device=q.device))
    qh = q.reshape(B, KV, rep, D).float() * (D ** -0.5)
    s = torch.einsum("bgrd,bsgd->bgrs", qh, k[:, :length].float())
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", p, v[:, :length].float()) / l[..., None]
    return o.reshape(B, H, D), (m + torch.log(torch.clamp(l, min=1e-20))).reshape(B, H)


def combine_partials(os: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Join the partials of R slices of S: ``os [R, B, H, D]`` and ``lses
    [R, B, H]`` float32 give ``o = sum_r e^(lse_r - M) o_r / sum_r e^(lse_r -
    M)`` (M the largest finite lse of the row, 0 where there is none), the
    sums taken in rank order, so every run gives the same bits.  A slice with
    no valid slot (lse ``-inf`` or ``-2e38``) adds nothing."""
    M = lses.amax(dim=0)
    M = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    num = torch.zeros_like(os[0])
    den = torch.zeros_like(M)
    for o_r, lse_r in zip(os, lses):
        w = torch.exp(lse_r - M)
        num = num + w[..., None] * o_r
        den = den + w
    return num / torch.clamp(den, min=1e-20)[..., None]


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int,
                               plan: DecodeAttentionPlan) -> torch.Tensor:
    """The kernel's algebra in plain PyTorch, float32: each chunk's max ``m``,
    sum ``l`` and unnormalised ``acc``, then ``o = sum_i e^(m_i - M) acc_i /
    max(sum_i e^(m_i - M) l_i, 1e-20)`` with ``M = max_i m_i``, in chunk order."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    length = min(int(length), S)
    plan.check(length)
    qh = q.reshape(B, KV, rep, D).float() * (D ** -0.5)
    parts = []
    for i in range(plan.splits):
        lo, hi = i * plan.chunk, min((i + 1) * plan.chunk, length)
        s = torch.einsum("bgrd,bsgd->bgrs", qh, k[:, lo:hi].float())
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(dim=-1), torch.einsum("bgrs,bsgd->bgrd", p, v[:, lo:hi].float())))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_sum = torch.zeros_like(M)
    acc = torch.zeros(B, KV, rep, D, dtype=torch.float32, device=q.device)
    for m, l, a in parts:
        w = torch.exp(m - M)
        l_sum = l_sum + w * l
        acc = acc + w[..., None] * a
    o = acc / torch.clamp(l_sum, min=1e-20)[..., None]
    return o.reshape(B, H, D).to(q.dtype)


@functools.cache
def _lib():
    lib = build.load("decode_attention")
    lib.decode_attention_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_blocks_per_sm.argtypes = [ctypes.c_int] * 7
    lib.decode_attention_blocks_per_sm.restype = ctypes.c_int
    return lib


def blocks_per_sm(plan: DecodeAttentionPlan, H: int, KV: int, D: int, dtype: torch.dtype) -> int:
    """CTAs of ``decode_attention_cuda``'s kernel that one SM holds under ``plan``."""
    n = _lib().decode_attention_blocks_per_sm(H, KV, D, build.DTYPE_CODE[dtype], plan.chunk,
                                              plan.splits, plan.block)
    if n <= 0:
        raise RuntimeError(f"decode_attention occupancy query failed with CUDA error {-n}")
    return n


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int,
            plan: DecodeAttentionPlan | None, partial: bool, least: int):
    """Check the operands, launch the kernel once and return ``(o, lse)``
    (lse None unless ``partial``); see :func:`decode_attention_cuda`."""
    name = "decode_attention_partial_cuda" if partial else "decode_attention_cuda"
    if not (q.device.type == "cuda" and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} needs CUDA tensors on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in build.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name} needs q [B,H,D] and k, v [B,S,KV,D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    vec = 16 // q.element_size()
    if (k.shape[0] != B or k.shape[3] != D or H % KV != 0 or H // KV > _MAX_REP
            or D % vec != 0 or D // vec > _MAX_VECS or B > 65535 or S == 0):
        raise ValueError(f"{name} does not take q {tuple(q.shape)} "
                         f"with k {tuple(k.shape)} (needs H % KV == 0, H/KV <= "
                         f"{_MAX_REP}, D % {vec} == 0, D <= {_MAX_VECS * vec})")
    length = int(length)
    if length < least:
        raise ValueError(f"{name} needs length >= {least}, got {length}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} needs contiguous q, k, v")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned q, k, v")
    length = min(length, S)
    if plan is None:
        plan = decode_attention_plan(B, KV, H // KV, D, q.element_size(), length,
                                     sm_count(q.device))
    else:
        plan.check(length)
    o = torch.empty_like(q, dtype=torch.float32 if partial else q.dtype)
    lse = torch.empty(B, H, dtype=torch.float32, device=q.device) if partial else None
    ws = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_bytes(B, KV, H // KV, D), dtype=torch.uint8,
                         device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), None if ws is None else ws.data_ptr(),
        B, H, KV, S, D, length, plan.chunk, plan.splits, plan.block, float(D ** -0.5),
        build.DTYPE_CODE[q.dtype], stream)
    if status != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with CUDA error "
                           f"{status}")
    decode_attention_cuda.launches += 1
    return o, lse


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int, *,
                          plan: DecodeAttentionPlan | None = None) -> torch.Tensor:
    """Launch the kernel (CUDA tensors) and return ``o[B, H, D]`` in q's dtype.

    Takes float32 or bfloat16 q, k, v of one dtype, contiguous, with
    ``H % KV == 0``, ``H / KV <= 16``, D a multiple of 16 bytes and at most
    128 such vectors (512 float32, 1024 bf16), and ``length >= 1`` (a length
    above S means all of S).  ``plan`` defaults to :func:`decode_attention_plan`
    on this card; with more than one split the partials and counters live in
    one workspace allocated per call.  Raises on anything else, and on a
    launch the runtime refuses.  Each launch of the kernel, from this entry
    or the partial one, adds one to ``decode_attention_cuda.launches``.
    """
    return _launch(q, k, v, length, plan, partial=False, least=1)[0]


decode_attention_cuda.launches = 0


def decode_attention_partial_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  length: int, *, plan: DecodeAttentionPlan | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's partial output over a slice of S: ``(o [B, H, D] float32,
    lse [B, H] float32)``, as :func:`decode_attention_partial_ref` gives
    them, in one launch.  Takes what :func:`decode_attention_cuda` takes, and
    ``length`` 0.  Each call adds one to ``decode_attention_partial_cuda.launches``
    (and, as every launch of the kernel, to ``decode_attention_cuda.launches``).
    """
    out = _launch(q, k, v, length, plan, partial=True, least=0)
    decode_attention_partial_cuda.launches += 1
    return out


decode_attention_partial_cuda.launches = 0


def _shapes_only(name: str, x: torch.Tensor):
    raise RuntimeError(f"repro_torch::{name} is the dry run's shape function; a {x.device} "
                       "tensor takes the kernel's wrapper (kernels.ops)")


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        length: int) -> torch.Tensor:
    """:func:`decode_attention_cuda`'s shape, on ``meta`` tensors only."""
    _shapes_only("decode_attention", q)


@decode_attention_op.register_fake
def _decode_attention_shape(q, k, v, length):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::decode_attention_partial", mutates_args=())
def decode_attention_partial_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                length: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_attention_partial_cuda`'s shapes, on ``meta`` tensors only."""
    _shapes_only("decode_attention_partial", q)


@decode_attention_partial_op.register_fake
def _decode_attention_partial_shape(q, k, v, length):
    return (torch.empty_like(q, dtype=torch.float32),
            q.new_empty(q.shape[:2], dtype=torch.float32))
