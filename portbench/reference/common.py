"""Plain float32 pieces the reference models share.

Written from the published descriptions, in plain ``torch`` operations,
with no kernel, cache or batching trick, and nothing imported from the
program under test.  Every product is float32 with TF32 off (the caller,
:func:`float32_matmuls`), so the reference is the precise side of each
comparison.

``Precision`` names where the reference rounds: ``"f32"`` is the reference
itself; ``"fp8"`` rounds both operands of every product the configuration
states in bfloat16 (weights by output column, activations by row, keys and
values by head vector) to float8 e4m3 with a scale, and multiplies the
rounded values in float32: the control one precision below the
configuration's bfloat16.  ``"bf16_state"`` keeps every product in float32
and rounds a recurrent state that the configuration states in float32 (its
``state_dtype``) to bfloat16 after every step: the control one precision
below that float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator

import torch

F8_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def float32_matmuls() -> Iterator[None]:
    """Full float32 products on the card (TF32 off) while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / F8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


PRECISIONS = ("f32", "fp8", "bf16_state")


class Precision:
    """Where the reference rounds: nowhere (``"f32"``), the products' operands
    to float8 (``"fp8"``), or the recurrent state to bfloat16 (``"bf16_state"``)."""

    def __init__(self, name: str = "f32"):
        if name not in PRECISIONS:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for activations ``x [..., k]`` and a weight ``w [k, n]``."""
        if self.name == "fp8":
            x, w = fp8_round(x, -1), fp8_round(w, 0)
        return x @ w

    def table(self, w: torch.Tensor) -> torch.Tensor:
        """An embedding table (rows are looked up)."""
        return fp8_round(w, -1) if self.name == "fp8" else w

    def kv(self, t: torch.Tensor) -> torch.Tensor:
        """Keys or values ``[R, T, heads, hd]`` as a cache would hold them."""
        return fp8_round(t, -1) if self.name == "fp8" else t

    def state(self, t: torch.Tensor) -> torch.Tensor:
        """A recurrent state as a step leaves it."""
        return t.bfloat16().float() if self.name == "bf16_state" else t


def f32(weights: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The float32 copies of the weights under ``prefix`` (one layer at a
    time, so that the float32 model never sits in memory whole)."""
    n = len(prefix)
    return {k[n:]: v.float() for k, v in weights.items() if k.startswith(prefix)}


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """``x / sqrt(mean(x^2) + eps) * (1 + gain)``."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + gain)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x [R, T, heads, hd]`` at positions 0..T-1, the
    two halves of each head rotated as pairs (i, i + hd/2), frequencies
    ``theta ** (-i / (hd/2))``."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = (theta ** (-torch.arange(half, dtype=torch.float64) / half)).float().to(x.device)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs
    c, s = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention of every position over itself and all before it.

    q [R, T, H, hd], k / v [R, T, KV, hd] (H a multiple of KV; query head h
    reads key head h // (H / KV)) -> [R, T, H * hd]."""
    R, T, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("rthd,rshd->rhts", q, k) / math.sqrt(hd)
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("rhts,rshd->rthd", p, v).reshape(R, T, H * hd)


def attention(prec: Precision, w: Dict[str, torch.Tensor], h: torch.Tensor, n_heads: int,
              n_kv: int, hd: int, theta: float) -> torch.Tensor:
    """Multi-head causal self-attention with RoPE; weights ``w_q [d, H hd]``,
    ``w_k`` / ``w_v [d, KV hd]``, ``w_o [H hd, d]``."""
    R, T, _ = h.shape
    q = prec.linear(h, w["w_q"]).reshape(R, T, n_heads, hd)
    k = prec.linear(h, w["w_k"]).reshape(R, T, n_kv, hd)
    v = prec.linear(h, w["w_v"]).reshape(R, T, n_kv, hd)
    q, k = rope(q, theta), rope(k, theta)
    o = causal_attention(q, prec.kv(k), prec.kv(v))
    return prec.linear(o, w["w_o"])


def gated_mlp(prec: Precision, h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor) -> torch.Tensor:
    """``(silu(h W_gate) * h W_up) W_down``."""
    g = torch.nn.functional.silu(prec.linear(h, w_gate))
    return prec.linear(g * prec.linear(h, w_up), w_down)
