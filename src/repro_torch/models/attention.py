"""GQA attention for decode, full and sliding-window (port of ``repro.models.attention``).

The port covers what the dense decode path runs: RoPE, the parameter specs,
the KV cache and ``attention_decode``.  MLA, M-RoPE and the chunked forward
of the reference wait for a later slice and are refused here.

The score/softmax/PV part goes through ``kernels.ops.decode_attention``: the
CUDA kernel on the card, its plain version on the CPU.  Both keep the softmax
weights in float32 for the PV product, as the Pallas kernel does; the
reference's ``attention_decode`` instead casts them to v's dtype first.  So
port and reference agree to float32 precision in float32 and only to bf16
tolerance in bf16.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels import ops
from .common import ModelConfig, ParamSpec

__all__ = [
    "attention_specs",
    "attention_decode",
    "init_kv_cache",
    "rope_cos_sin",
    "apply_rope",
]


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attn_kind not in ("full", "sliding") or cfg.rope_kind not in ("rope", "none"):
        raise NotImplementedError(
            f"attn_kind={cfg.attn_kind!r}, rope_kind={cfg.rope_kind!r} is not "
            "ported yet (full and sliding GQA with RoPE only)"
        )


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_cos_sin(
    positions: torch.Tensor,  # int[B, S]
    head_dim: int,
    theta: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    )
    ang = positions[..., None].to(torch.float32) * freqs  # [B, S, half]
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
    _check_supported(cfg)
    d, hd = cfg.d_model, cfg.hd
    pd = cfg.param_dtype
    return {
        "w_q": ParamSpec((d, cfg.n_heads * hd), ("embed", "heads"), pd),
        "w_k": ParamSpec((d, cfg.n_kv_heads * hd), ("embed", "kv"), pd),
        "w_v": ParamSpec((d, cfg.n_kv_heads * hd), ("embed", "kv"), pd),
        "w_o": ParamSpec((cfg.n_heads * hd, d), ("heads", "embed"), pd),
    }


# ---------------------------------------------------------------------------
# decode (single new token against a cache)
# ---------------------------------------------------------------------------


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, layer_idx: int, device: torch.device,
) -> Dict[str, torch.Tensor]:
    """Zeroed ``k``/``v`` of ``[B, L, KV, hd]`` in the param dtype.

    A local layer's L is its window.
    """
    _check_supported(cfg)
    if cfg.attn_kind == "sliding" and not cfg.is_global_attn(layer_idx):
        max_len = min(max_len, cfg.sliding_window)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.param_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.param_dtype, device=device),
    }


def _cache_write(cache_arr: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """Write one token at (ring-buffered) slot ``pos % L``.

    In place: the reference's JAX version returns a new array instead.
    """
    cache_arr[:, pos % cache_arr.shape[1]] = new.to(cache_arr.dtype)


def attention_decode(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                 # [B, 1, d_model]
    cache: Dict[str, torch.Tensor],  # updated in place
    pos: int,                        # tokens already in the cache
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One new token per sequence: ``(attention output [B, 1, d_model], cache)``."""
    B = x.shape[0]
    hd = cfg.hd
    q = (x @ p["w_q"]).reshape(B, 1, cfg.n_heads, hd)
    k_new = (x @ p["w_k"]).reshape(B, 1, cfg.n_kv_heads, hd)
    v_new = (x @ p["w_v"]).reshape(B, 1, cfg.n_kv_heads, hd)
    if cfg.rope_kind == "rope":
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    _cache_write(cache["k"], k_new[:, 0], pos)
    _cache_write(cache["v"], v_new[:, 0], pos)
    # The valid slots are always a prefix: on a global layer slots 0..pos; on a
    # local layer's ring buffer slots 0..pos until it fills, then all of them.
    # Softmax does not depend on slot order, so the ring needs no unrolling.
    length = min(pos + 1, cache["k"].shape[1])
    o = ops.decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"], length)
    return o.reshape(B, 1, -1) @ p["w_o"], cache
