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

Under a bound mesh (training on a sharded model, ``distributed/sharding.py``)
:func:`attention_apply` computes the rank's query heads, with ``w_q``
column-parallel and ``w_o`` row-parallel, where the ``heads`` rule cuts them
over ``model`` and the heads divide: the input's gradient is summed over
``model`` on entry and the output summed on exit.  K and V are the rank's
own heads where the KV heads divide too; else every rank gathers the whole
K/V projections (their gradient summed over ``model``, as each rank uses
them for its heads only) and takes the KV heads its query heads read, as
for gemma3-1b's single KV head (:func:`kv_columns`; a decode takes them
once a batch, with its caches, not at every step).  MLA is head-parallel
the same way: ``w_uq`` (or ``w_q``), ``w_uk`` and ``w_uv`` column-parallel
over the heads (their columns are contiguous a head), ``w_o`` row-parallel;
its down-projections ``w_dkv`` / ``w_dq`` and their norms are replicated,
so every rank computes the latent ``c_kv`` / ``k_pe`` (and the compressed
query) whole, a named duplicate, with those weights' gradient summed over
``model``.  Heads that ``model`` does not divide run whole on every rank
from gathered weights.

:func:`attention_decode` under a bound mesh takes the same heads, and the
cache as the rank's shard (``cache_spec``, from ``Model.cache_specs``):
its rows, its KV heads, and, where the spec cuts the slots (dim 1) over an
axis, the rank's consecutive slice of them.  A cut cache is attended
sequence-parallel: slot ``pos % L`` lives on one rank, which alone writes it;
each rank attends its slice's valid prefix, ``clamp(min(pos + 1, L) - i *
L / n, 0, L / n)`` slots (0 for a slice past it, a local layer's ring
included), through ``ops.decode_attention_partial`` for GQA or the same
partial softmax in plain torch for MLA (naive or absorbed); then one
all-gather of every rank's ``(o, lse)`` over the axis and
``combine_partials`` in rank order.  Head-parallel MLA over latents whose
slots are cut over ``model`` gathers every head's query over ``model`` (the
absorbed form's latent query), attends the rank's slots with every head,
joins, and keeps the rank's heads for its ``w_uv`` / ``w_o`` rows; the
naive form expands the rank's slots with the whole ``w_uk`` / ``w_uv``,
taken once a batch (:func:`kv_columns`).  Every rank takes part in every
exchange whatever ``pos`` is, so the ranks' schedules never depend on it.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ..distributed.collectives import copy_in, raw_all_gather, reduce_out
from ..distributed.sharding import use_full, use_params
from ..kernels import ops
from ..kernels.decode_attention import combine_partials
from .common import ModelConfig, ParamSpec, rms_norm

__all__ = [
    "attention_specs",
    "attention_apply",
    "attention_decode",
    "init_kv_cache",
    "rope_cos_sin",
    "apply_rope",
    "head_parallel",
    "kv_heads_read",
    "kv_columns",
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
    mesh=None,
    specs: Optional[Dict[str, tuple]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``(attention output [B, S, d], cache entry (k, v) or (c_kv, k_pe))``.

    ``is_global`` is a Python bool: the port walks layers in a loop, so the
    reference's traced select between windowed and full attention is static.
    With a bound ``mesh``, ``p`` holds this rank's shards, cut as ``specs``
    says (see the module's doc; the cache entry is then the rank's heads).
    """
    if mesh is not None:
        return _attention_sharded(cfg, p, x, positions, is_global, chunk, mesh, specs or {})
    q, k, v, cache = _project_qkv(cfg, p, x, positions)
    window = cfg.sliding_window if cfg.attn_kind == "sliding" and not is_global else 0
    out = _chunked_attention(q, k, v, window=window, chunk=chunk)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p["w_o"], cache


_MLA_HEADS = ("w_q", "w_uq", "w_uk", "w_uv", "w_o")  # MLA's weights cut by the heads


def head_parallel(cfg: ModelConfig, specs: Dict[str, tuple], mesh) -> bool:
    """Whether the rank computes its own query heads (see the module's doc)."""
    m = mesh.axis_size("model")
    if m == 1 or cfg.n_heads % m:
        return False
    cols = ("w_q",)
    if cfg.attn_kind == "mla":
        cols = ("w_uq" if cfg.mla_q_rank else "w_q", "w_uk", "w_uv")
    return all(specs.get(w) == (None, "model") for w in cols) and specs.get("w_o") == ("model",)


def kv_heads_read(cfg: ModelConfig, mesh) -> torch.Tensor:
    """The KV heads the rank's query heads read under head-parallel attention
    where ``model`` does not divide the KV heads: one copy of each where the
    local heads share them in order, else one a query head."""
    m, r = mesh.axis_size("model"), mesh.index("model")
    Hl, rep = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
    kv_of = (r * Hl + torch.arange(Hl)) // rep
    if Hl % rep == 0 or rep % Hl == 0:
        kv_of = torch.unique_consecutive(kv_of)
    return kv_of


def kv_columns(cfg: ModelConfig, p, specs: Dict[str, tuple], mesh,
               cache_spec: Optional[Dict[str, tuple]] = None
               ) -> Optional[Dict[str, torch.Tensor]]:
    """``{"w_k", "w_v"}``: the columns of the KV heads the rank's query heads
    read, gathered over ``model``, under head-parallel attention whose KV
    heads the rank's own shards do not hold (``model`` does not divide them,
    or w_k / w_v are not cut over it); for MLA, ``{"w_uk", "w_uv"}`` whole
    under a head-parallel naive decode of latents whose slots
    (``cache_spec``) are cut over ``model``; None elsewhere.  A decode takes
    them once a batch, with its caches (``Model.init_caches``, ``prefill``)."""
    m, hd = mesh.axis_size("model"), cfg.hd
    if cfg.attn_kind == "mla":
        spec = (cache_spec or {}).get("c_kv", ())
        if (not head_parallel(cfg, specs, mesh) or cfg.mla_absorbed_decode
                or len(spec) < 2 or spec[1] != "model"):
            return None
        return {w: use_full(p[w], specs.get(w, ()), mesh, "model") for w in ("w_uk", "w_uv")}
    if not head_parallel(cfg, specs, mesh) or (
            cfg.n_kv_heads % m == 0 and all(specs.get(w) == (None, "model")
                                            for w in ("w_k", "w_v"))):
        return None
    kv_of = kv_heads_read(cfg, mesh)
    cols = (kv_of[:, None] * hd + torch.arange(hd)).reshape(-1).to(p["w_k"].device)
    return {w: use_full(p[w], specs.get(w, ()), mesh, "model").index_select(1, cols)
            for w in ("w_k", "w_v")}


def _local_heads(cfg: ModelConfig, p, specs, mesh, kv=None):
    """``(config, parameters)`` of the rank's query heads and the KV heads
    they read, under head-parallel attention; ``kv``: :func:`kv_columns`
    taken before (else taken here where they are needed).  MLA: the rank's
    heads' cut weights as they lie, the rest whole, their gradient summed
    over ``model``."""
    if cfg.attn_kind == "mla":
        H = cfg.n_heads // mesh.axis_size("model")
        local = {k: v if k in _MLA_HEADS else use_full(v, specs.get(k, ()), mesh, "model")
                 for k, v in p.items()}
        return cfg.with_(n_heads=H, n_kv_heads=H, head_dim=cfg.hd), local
    kv = kv or kv_columns(cfg, p, specs, mesh) or {w: p[w] for w in ("w_k", "w_v")}
    local = {"w_q": p["w_q"], **kv, "w_o": p["w_o"]}
    return cfg.with_(n_heads=cfg.n_heads // mesh.axis_size("model"),
                     n_kv_heads=kv["w_k"].shape[1] // cfg.hd, head_dim=cfg.hd), local


def _attention_sharded(cfg: ModelConfig, p, x, positions, is_global, chunk, mesh, specs):
    if not head_parallel(cfg, specs, mesh):
        return attention_apply(cfg, use_params(p, specs, mesh), x, positions,
                               is_global=is_global, chunk=chunk)
    local_cfg, local = _local_heads(cfg, p, specs, mesh)
    out, kv = attention_apply(local_cfg, local, copy_in(x, mesh, "model"), positions,
                              is_global=is_global, chunk=chunk)
    return reduce_out(out, mesh, "model"), kv


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


def _slot_and_length(cache_arr: torch.Tensor, pos: int, mesh=None, axis=None):
    """``(local slot, valid length)`` of this rank's slice of a cache whose
    ``L`` slots (dim 1) are cut over ``axis`` (whole without one): where the
    token of ``pos`` goes, ``pos % L``, as an index into the slice (None where
    another rank holds that slot), and how many of the slice's slots are in
    the valid prefix ``[0, min(pos + 1, L))``."""
    n = 1 if axis is None else mesh.axis_size(axis)
    i = 0 if axis is None else mesh.index(axis)
    L_loc = cache_arr.shape[1]
    slot = pos % (L_loc * n) - i * L_loc
    length = min(max(min(pos + 1, L_loc * n) - i * L_loc, 0), L_loc)
    return (slot if 0 <= slot < L_loc else None), length


def _cache_write(cache_arr: torch.Tensor, new: torch.Tensor, slot) -> None:
    """Write one token at this rank's slot (nothing where it is another's).

    In place: the reference's JAX version returns a new array instead.
    """
    if slot is not None:
        cache_arr[:, slot] = new.to(cache_arr.dtype)


def _join(o: torch.Tensor, lse: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Every rank's partial ``(o [B, H, D] float32, lse [B, H])`` along
    ``axis``, in one all-gather, combined in rank order."""
    parts = raw_all_gather(torch.cat([o, lse[..., None]], dim=-1)[None], mesh, axis, dim=0)
    return combine_partials(parts[..., :-1], parts[..., -1])


def _softmax(s: torch.Tensor, valid: torch.Tensor, axis):
    """``(weights, lse)`` of scores ``s [..., S]`` over the ``valid`` slots.
    Whole (no ``axis``): the softmax, and no lse.  Over a slice of the slots:
    ``e^(s - m) / l`` there (0 elsewhere, and everywhere for no valid slot)
    and ``lse = m + log(max(l, 1e-20))``, ``l`` the sum of ``e^(s - m)``."""
    s = torch.where(valid, s, _NEG_INF)
    if axis is None:
        return torch.softmax(s, dim=-1), None
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    return p / l, (m + torch.log(l))[..., 0]


def _mla_decode(cfg: ModelConfig, p, q: torch.Tensor, cache, length: int, mesh=None,
                axis=None, every: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """MLA attention of one query token over the latent cache's first
    ``length`` slots: ``o [B, 1, H, hd]`` of q's heads.  With ``axis``, the
    cache is this rank's slice of the slots, and the ranks' partial
    softmaxes are joined.  ``every`` (head-parallel, the slots cut over
    ``model``; the naive form's whole ``w_uk`` / ``w_uv``, empty for the
    absorbed one): q and ``p`` are the rank's heads', every head's query is
    gathered over ``model`` to attend the rank's slots, and the rank's heads
    are kept after the join."""
    hd, r, rd = cfg.hd, cfg.mla_kv_rank, cfg.mla_rope_dim
    c_kv, k_pe = cache["c_kv"], cache["k_pe"]
    B, S = c_kv.shape[:2]
    valid = torch.arange(S, device=q.device) < length
    heads = q.shape[2]

    def gathered(t):  # every head's, on dim 2
        return t if every is None else raw_all_gather(t, mesh, "model", dim=2)

    def own(t):  # the rank's heads of every head's
        return t if every is None else t.narrow(2, mesh.index("model") * heads, heads)

    if cfg.mla_absorbed_decode:
        # score and attend in latent space: w_uk folds into the query, w_uv
        # into the output, so the per-token K/V expansion never materialises
        q_nope, q_pe = q[..., :hd], gathered(q[..., hd:])
        w_uk = p["w_uk"].reshape(r, heads, hd)
        w_uv = p["w_uv"].reshape(r, heads, hd)
        q_abs = gathered(torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk))
        s = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), c_kv.float())
             + torch.einsum("bqhp,bsp->bhqs", q_pe.float(), k_pe.float())
             ) * (1.0 / math.sqrt(hd + rd))
        w, lse = _softmax(s, valid, axis)
        o_lat = torch.einsum("bhqs,bsr->bqhr", w.to(c_kv.dtype).float(), c_kv.float())
        if axis is not None:
            o_lat = _join(o_lat[:, 0], lse[:, :, 0], mesh, axis)[:, None]
        return torch.einsum("bqhr,rhd->bqhd", own(o_lat), w_uv.float()).to(q.dtype)
    q = gathered(q)
    H = q.shape[2]
    up = p if every is None else every
    k_nope = (c_kv @ up["w_uk"]).reshape(B, S, H, hd)
    v = (c_kv @ up["w_uv"]).reshape(B, S, H, hd)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, rd)], dim=-1)
    qh = q * (1.0 / math.sqrt(q.shape[-1]))
    s = torch.einsum("bqhd,bshd->bhqs", qh.float(), k.float())
    w, lse = _softmax(s, valid, axis)
    # float32 accumulation, then the activation dtype before w_o
    o = torch.einsum("bhqs,bshd->bqhd", w.to(v.dtype).float(), v.float())
    if axis is not None:
        o = _join(o[:, 0], lse[:, :, 0], mesh, axis)[:, None]
    return own(o).to(q.dtype)


def attention_decode(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                 # [B, 1, d_model]
    cache: Dict[str, torch.Tensor],  # updated in place
    pos: int,                        # tokens already in the cache
    *,
    mesh=None,
    specs: Optional[Dict[str, tuple]] = None,
    cache_spec: Optional[Dict[str, tuple]] = None,
    kv: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One new token per sequence: ``(attention output [B, 1, d_model], cache)``.

    With a bound ``mesh``, ``p`` holds this rank's shards as ``specs`` says
    and ``cache`` this rank's shard as ``cache_spec`` says (see the module's
    doc); ``kv`` the rank's :func:`kv_columns`, as ``Model.decode_step``
    takes them from its caches (without them, gathered here).
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    mla = cfg.attn_kind == "mla"
    axis, parallel, every = None, False, None
    if mesh is not None:
        specs = specs or {}
        spec = (cache_spec or {}).get("c_kv" if mla else "k", ())
        axis = spec[1] if len(spec) > 1 else None
        parallel = head_parallel(cfg, specs, mesh)
        if parallel and mla and axis == "model":  # every head attends the rank's slots
            every = kv or kv_columns(cfg, p, specs, mesh, cache_spec) or {}
        if parallel:
            cfg, p = _local_heads(cfg, p, specs, mesh, kv)
            x = copy_in(x, mesh, "model")
        else:
            p = use_params(p, specs, mesh)
    q, k_new, v_new, extras = _project_qkv(cfg, p, x, positions)
    if mla:
        c_kv_new, k_pe_new = extras
        slot, length = _slot_and_length(cache["c_kv"], pos, mesh, axis)
        _cache_write(cache["c_kv"], c_kv_new[:, 0], slot)
        _cache_write(cache["k_pe"], k_pe_new[:, 0], slot)
        o = _mla_decode(cfg, p, q, cache, length, mesh, axis, every)
        out = o.reshape(B, 1, -1) @ p["w_o"]
        return (reduce_out(out, mesh, "model") if parallel else out), cache
    slot, length = _slot_and_length(cache["k"], pos, mesh, axis)
    _cache_write(cache["k"], k_new[:, 0], slot)
    _cache_write(cache["v"], v_new[:, 0], slot)
    # The valid slots are always a prefix: on a global layer slots 0..pos; on a
    # local layer's ring buffer slots 0..pos until it fills, then all of them.
    # Softmax does not depend on slot order, so the ring needs no unrolling.
    q0 = q[:, 0].contiguous()
    if axis is None:
        o = ops.decode_attention(q0, cache["k"], cache["v"], length)
    else:
        o = _join(*ops.decode_attention_partial(q0, cache["k"], cache["v"], length),
                  mesh, axis).to(q.dtype)
    out = o.reshape(B, 1, -1) @ p["w_o"]
    return (reduce_out(out, mesh, "model") if parallel else out), cache
