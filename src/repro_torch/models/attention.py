"""Attention variants: GQA (full / sliding-window), MLA, RoPE / M-RoPE
(port of ``repro.models.attention``).

The forward (``attention_apply``, used by ``Model.forward`` and ``prefill``)
is the reference's chunked causal attention, a plain loop over KV chunks with
the same rounding: scores in float32, the softmax weights cast to v's dtype
before the PV product, a float32 accumulator.  It is no Pallas kernel in the
reference, so it stays plain torch here.

Decode of GQA layers goes through ``kernels.ops.decode_attention``: the CUDA
kernel on the card, its plain version on the CPU.  Both keep the softmax
weights in float32 for the PV product, as the Pallas kernel does; the
reference's ``attention_decode`` instead casts them to v's dtype first.  So
port and reference agree to float32 precision in float32 and only to bf16
tolerance in bf16.  Decode of MLA layers (naive expansion, or absorbed with
``mla_absorbed_decode``) is the reference's einsums in plain torch, rounding
and all: its K and V widths differ and the absorbed form has up to 64 query
heads on one latent head, which the kernel does not take.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from .common import ModelConfig, ParamSpec, rms_norm

__all__ = [
    "attention_specs",
    "attention_apply",
    "attention_decode",
    "init_kv_cache",
    "rope_cos_sin",
    "apply_rope",
]

_NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE and Qwen2-VL style M-RoPE)
# ---------------------------------------------------------------------------


@functools.cache
def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """``theta ** (-i / half)`` in float32, made once a device.

    theta is raised to the float32 exponent in float64 on the CPU and rounded
    once: the correctly rounded float32 values, which XLA gives.  torch's
    float32 ``pow`` is one ulp off at a few indices (D 256, theta 1e4: 11, 33,
    84, 102, 124), and positions multiply that error.
    """
    exponent = -torch.arange(0, half, dtype=torch.float32) / half
    return (theta ** exponent.double()).float().to(device)


def rope_cos_sin(
    positions: torch.Tensor,  # int[B, S], or int[3, B, S] for M-RoPE
    head_dim: int,
    theta: float,
    mrope_sections: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    freqs = _rope_freqs(half, float(theta), positions.device)
    if positions.dim() == 2:
        ang = positions[..., None].to(torch.float32) * freqs  # [B, S, half]
    else:
        # M-RoPE: the rotary dims are split into (temporal, h, w) sections,
        # each rotating with its own position stream; identical streams (text
        # tokens) give standard RoPE
        if mrope_sections is None or sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE needs sections summing to {half}, got {mrope_sections}")
        parts, off = [], 0
        for sec, pos in zip(mrope_sections, positions):
            parts.append(pos[..., None].to(torch.float32) * freqs[off:off + sec])
            off += sec
        ang = torch.cat(parts, dim=-1)  # [B, S, half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [B, S, D/2] (broadcast over heads).

    cos and sin are cast to x's dtype before the products, as the reference
    does, so bf16 rounds at the same places.
    """
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def attention_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.hd
    pd = cfg.param_dtype
    if cfg.attn_kind == "mla":
        r, rd = cfg.mla_kv_rank, cfg.mla_rope_dim
        specs: Dict[str, ParamSpec] = {
            "w_dkv": ParamSpec((d, r + rd), ("embed", "rank"), pd),
            "w_uk": ParamSpec((r, cfg.n_heads * hd), ("rank", "heads"), pd),
            "w_uv": ParamSpec((r, cfg.n_heads * hd), ("rank", "heads"), pd),
            "w_o": ParamSpec((cfg.n_heads * hd, d), ("heads", "embed"), pd),
            "norm_kv": ParamSpec((r,), ("rank",), pd, init="zeros"),
        }
        if cfg.mla_q_rank:
            specs["w_dq"] = ParamSpec((d, cfg.mla_q_rank), ("embed", "rank"), pd)
            specs["w_uq"] = ParamSpec(
                (cfg.mla_q_rank, cfg.n_heads * (hd + rd)), ("rank", "heads"), pd
            )
            specs["norm_q"] = ParamSpec((cfg.mla_q_rank,), ("rank",), pd, init="zeros")
        else:
            specs["w_q"] = ParamSpec((d, cfg.n_heads * (hd + rd)), ("embed", "heads"), pd)
        return specs
    return {
        "w_q": ParamSpec((d, cfg.n_heads * hd), ("embed", "heads"), pd),
        "w_k": ParamSpec((d, cfg.n_kv_heads * hd), ("embed", "kv"), pd),
        "w_v": ParamSpec((d, cfg.n_kv_heads * hd), ("embed", "kv"), pd),
        "w_o": ParamSpec((cfg.n_heads * hd, d), ("heads", "embed"), pd),
    }


# ---------------------------------------------------------------------------
# chunked (flash-style) causal attention
# ---------------------------------------------------------------------------


def _chunked_attention(
    q: torch.Tensor,  # [B, S, H, Dk]
    k: torch.Tensor,  # [B, S, KV, Dk]
    v: torch.Tensor,  # [B, S, KV, Dv]
    *,
    window: int = 0,  # 0 => full causal; > 0 => sliding window
    chunk: int = 1024,
) -> torch.Tensor:
    """Causal attention over KV chunks with a running log-sum-exp.

    The reference pads the last chunk with masked zero slots; this loop takes
    the ragged chunk as it is, which adds only exact zeros there.
    """
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    rep = H // KV
    chunk = min(chunk, S)
    q_pos = torch.arange(S, device=q.device)
    qh = (q * (1.0 / math.sqrt(Dk))).reshape(B, S, KV, rep, Dk).float()
    m = torch.full((B, S, KV, rep), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(B, S, KV, rep, Dv, dtype=torch.float32, device=q.device)
    for lo in range(0, S, chunk):
        kci, vci = k[:, lo:lo + chunk], v[:, lo:lo + chunk]
        k_pos = torch.arange(lo, lo + kci.shape[1], device=q.device)
        s = torch.einsum("bsgrd,bcgd->bsgrc", qh, kci.float())  # [B, S, KV, rep, c]
        mask = k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(mask[None, :, None, None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bsgrc,bcgd->bsgrd", p.to(vci.dtype).float(), vci.float())
        m = m_new
    out = o / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(B, S, H, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    """``(q, k, v, cache entry)``: ``(k, v)`` for GQA, ``(c_kv, k_pe)`` for MLA."""
    B, S, _ = x.shape
    hd = cfg.hd
    if cfg.attn_kind == "mla":
        r, rd = cfg.mla_kv_rank, cfg.mla_rope_dim
        ckv_pe = x @ p["w_dkv"]
        c_kv = rms_norm(ckv_pe[..., :r].contiguous(), p["norm_kv"], cfg.norm_eps)
        k_pe = ckv_pe[..., r:]
        if cfg.mla_q_rank:
            cq = rms_norm(x @ p["w_dq"], p["norm_q"], cfg.norm_eps)
            q_full = (cq @ p["w_uq"]).reshape(B, S, cfg.n_heads, hd + rd)
        else:
            q_full = (x @ p["w_q"]).reshape(B, S, cfg.n_heads, hd + rd)
        q_nope, q_pe = q_full[..., :hd], q_full[..., hd:]
        cos, sin = rope_cos_sin(positions, rd, cfg.rope_theta)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)
        # the latent expanded to per-head K and V (naive MLA)
        k_nope = (c_kv @ p["w_uk"]).reshape(B, S, cfg.n_heads, hd)
        v = (c_kv @ p["w_uv"]).reshape(B, S, cfg.n_heads, hd)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, S, cfg.n_heads, rd)], dim=-1)
        return q, k, v, (c_kv, k_pe[:, :, 0, :])
    q = (x @ p["w_q"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["w_k"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["w_v"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.rope_kind == "mrope":
        # text tokens: one position stream broadcast to the three
        pos3 = positions[None].expand(3, *positions.shape)
        cos, sin = rope_cos_sin(pos3, hd, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.rope_kind == "rope":
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    else:
        cos = sin = None
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v, (k, v)


def attention_apply(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,          # [B, S, d_model]
    positions: torch.Tensor,  # int[B, S]
    *,
    is_global: bool = True,
    chunk: int = 1024,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``(attention output [B, S, d], cache entry (k, v) or (c_kv, k_pe))``.

    ``is_global`` is a Python bool: the port walks layers in a loop, so the
    reference's traced select between windowed and full attention is static.
    """
    q, k, v, cache = _project_qkv(cfg, p, x, positions)
    window = cfg.sliding_window if cfg.attn_kind == "sliding" and not is_global else 0
    out = _chunked_attention(q, k, v, window=window, chunk=chunk)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p["w_o"], cache


# ---------------------------------------------------------------------------
# decode (single new token against a cache)
# ---------------------------------------------------------------------------


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, layer_idx: int, device: torch.device,
) -> Dict[str, torch.Tensor]:
    """Zeroed cache of one layer in the param dtype.

    GQA: ``k``/``v`` of ``[B, L, KV, hd]``, L a local layer's window.  MLA:
    the latent ``c_kv [B, L, kv_rank]`` and the rotary key ``k_pe [B, L, rope_dim]``.
    """
    dt = cfg.param_dtype
    if cfg.attn_kind == "mla":
        return {
            "c_kv": torch.zeros(batch, max_len, cfg.mla_kv_rank, dtype=dt, device=device),
            "k_pe": torch.zeros(batch, max_len, cfg.mla_rope_dim, dtype=dt, device=device),
        }
    if cfg.attn_kind == "sliding" and not cfg.is_global_attn(layer_idx):
        max_len = min(max_len, cfg.sliding_window)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def _cache_write(cache_arr: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """Write one token at (ring-buffered) slot ``pos % L``.

    In place: the reference's JAX version returns a new array instead.
    """
    cache_arr[:, pos % cache_arr.shape[1]] = new.to(cache_arr.dtype)


def _mla_decode(cfg: ModelConfig, p, q: torch.Tensor, cache, pos: int) -> torch.Tensor:
    """MLA attention of one query token over the latent cache: ``o [B, 1, H, hd]``."""
    B = q.shape[0]
    hd, H = cfg.hd, cfg.n_heads
    r, rd = cfg.mla_kv_rank, cfg.mla_rope_dim
    c_kv, k_pe = cache["c_kv"], cache["k_pe"]
    S = c_kv.shape[1]
    valid = torch.arange(S, device=q.device) <= pos
    if cfg.mla_absorbed_decode:
        # score and attend in latent space: w_uk folds into the query, w_uv
        # into the output, so the per-token K/V expansion never materialises
        q_nope, q_pe = q[..., :hd], q[..., hd:]
        w_uk = p["w_uk"].reshape(r, H, hd)
        w_uv = p["w_uv"].reshape(r, H, hd)
        q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
        s = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), c_kv.float())
             + torch.einsum("bqhp,bsp->bhqs", q_pe.float(), k_pe.float())
             ) * (1.0 / math.sqrt(hd + rd))
        s = torch.where(valid, s, _NEG_INF)
        w = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhqs,bsr->bqhr", w.to(c_kv.dtype).float(), c_kv.float())
        return torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv.float()).to(q.dtype)
    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, H, hd)
    v = (c_kv @ p["w_uv"]).reshape(B, S, H, hd)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, rd)], dim=-1)
    qh = q * (1.0 / math.sqrt(q.shape[-1]))
    s = torch.einsum("bqhd,bshd->bhqs", qh.float(), k.float())
    s = torch.where(valid, s, _NEG_INF)
    w = torch.softmax(s, dim=-1)
    # float32 accumulation, then the activation dtype before w_o
    return torch.einsum("bhqs,bshd->bqhd", w.to(v.dtype).float(), v.float()).to(q.dtype)


def attention_decode(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                 # [B, 1, d_model]
    cache: Dict[str, torch.Tensor],  # updated in place
    pos: int,                        # tokens already in the cache
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One new token per sequence: ``(attention output [B, 1, d_model], cache)``."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new, extras = _project_qkv(cfg, p, x, positions)
    if cfg.attn_kind == "mla":
        c_kv_new, k_pe_new = extras
        _cache_write(cache["c_kv"], c_kv_new[:, 0], pos)
        _cache_write(cache["k_pe"], k_pe_new[:, 0], pos)
        o = _mla_decode(cfg, p, q, cache, pos)
        return o.reshape(B, 1, -1) @ p["w_o"], cache
    _cache_write(cache["k"], k_new[:, 0], pos)
    _cache_write(cache["v"], v_new[:, 0], pos)
    # The valid slots are always a prefix: on a global layer slots 0..pos; on a
    # local layer's ring buffer slots 0..pos until it fills, then all of them.
    # Softmax does not depend on slot order, so the ring needs no unrolling.
    length = min(pos + 1, cache["k"].shape[1])
    o = ops.decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"], length)
    return o.reshape(B, 1, -1) @ p["w_o"], cache
