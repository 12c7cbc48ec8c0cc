"""Mixture-of-Experts layer, top-k routing (port of ``repro.models.moe``).

The reference routes by sort + grouped GEMM (``jax.lax.ragged_dot``), a
library product and no Pallas kernel.  The port keeps that shape: the
router's top-k, a stable sort of the (token, expert) assignments by expert,
one grouped gated MLP over the sorted rows, and a weighted combine back to
the tokens.  On the card the grouped products are ``torch._grouped_mm``,
which reads the group offsets from the device, so a decode step waits on the
host for nothing; on the CPU they are :func:`grouped_ffn_ref`, a loop over
the experts' groups.

Router aux losses (load-balance and z-loss) are returned as the reference
returns them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .common import ModelConfig, ParamSpec
from .mlp import activation

__all__ = ["moe_specs", "moe_apply", "route", "grouped_ffn", "grouped_ffn_ref"]


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    pd = cfg.param_dtype
    specs = {
        # the router stays float32 whatever the param dtype
        "router": ParamSpec((d, E), ("embed", "experts_logits"), torch.float32),
        "w_gate": ParamSpec((E, d, ff), ("experts", "embed", "expert_mlp"), pd),
        "w_up": ParamSpec((E, d, ff), ("experts", "embed", "expert_mlp"), pd),
        "w_down": ParamSpec((E, ff, d), ("experts", "expert_mlp", "embed"), pd),
    }
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        specs.update({
            "sh_gate": ParamSpec((d, sff), ("embed", "mlp"), pd),
            "sh_up": ParamSpec((d, sff), ("embed", "mlp"), pd),
            "sh_down": ParamSpec((sff, d), ("mlp", "embed"), pd),
        })
    return specs


def route(cfg: ModelConfig, p, x2d: torch.Tensor, aux: bool = True, reduce=None):
    """Top-k routing: ``(indices [T, k], weights [T, k] float32, aux losses)``.

    With ``aux=False`` the losses are not computed (an empty dict): the
    decode step drops them, as the reference's jitted step does.  The losses
    come from sums over the tokens (expert counts, router probabilities,
    squared log-sum-exps, the token count); ``reduce``, where given, sums
    those over the ranks that hold the other tokens, so a sharded batch gives
    the losses of the whole batch.

    ``jax.lax.top_k`` puts the lower index first among equal values, and
    ``torch.topk`` on the card promises no order among them; a stable
    descending sort of each row gives the reference's order on both devices.
    """
    logits = x2d.float() @ p["router"]  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :k], idx[:, :k]
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-9)
    if not aux:
        return idx, weights, {}
    E = cfg.n_experts
    ones = torch.ones(idx.numel(), dtype=torch.float32, device=x2d.device)
    counts = torch.zeros(E, dtype=torch.float32, device=x2d.device).index_add_(
        0, idx.reshape(-1), ones)
    lse_sq = torch.logsumexp(logits, dim=-1) ** 2
    stats = torch.cat([counts, probs.sum(dim=0), lse_sq.sum()[None],
                       torch.full((1,), x2d.shape[0], dtype=torch.float32, device=x2d.device)])
    if reduce is not None:
        stats = reduce(stats)
    counts, n = stats[:E], stats[-1]
    # load-balance loss (Switch-style): E * sum(f_e * p_e)
    density = counts / torch.clamp(counts.sum(), min=1.0)
    lb_loss = E * torch.sum(density * (stats[E:2 * E] / n))
    z_loss = stats[2 * E] / n
    return idx, weights, {"moe_load_balance": lb_loss, "moe_z": z_loss}


def grouped_ffn_ref(cfg: ModelConfig, p, xs: torch.Tensor, offsets: torch.Tensor):
    """The gated MLP of each expert on its rows of ``xs``, a loop over the groups.

    ``xs [N, d]`` is sorted by expert; expert e owns rows ``[offsets[e-1],
    offsets[e])``.  Products in the param dtype, as ``ragged_dot`` gives them.
    """
    act = activation(cfg)
    out = torch.zeros(xs.shape[0], cfg.d_model, dtype=xs.dtype, device=xs.device)
    lo = 0
    for e, hi in enumerate(offsets.tolist()):
        if hi > lo:
            rows = xs[lo:hi]
            h = (act(rows @ p["w_gate"][e]) * (rows @ p["w_up"][e])).to(xs.dtype)
            out[lo:hi] = h @ p["w_down"][e]
        lo = hi
    return out


def grouped_ffn(cfg: ModelConfig, p, xs: torch.Tensor, offsets: torch.Tensor):
    """``grouped_ffn_ref``'s function: ``torch._grouped_mm`` on the card (and
    on the dry run's ``meta`` tensors, whose shapes it gives), the loop on the
    CPU.  ``offsets`` is int32 on xs's device.  On the card, rows past the
    last offset are left unwritten, in the output and in the input's
    gradient."""
    if xs.device.type == "cpu":
        return grouped_ffn_ref(cfg, p, xs, offsets)
    if xs.is_meta and xs.dtype != torch.bfloat16:
        # the meta function of _grouped_mm takes bf16 only (the card's kernel
        # takes float32 too): a float32 trace gets its shapes and products from
        # bf16 stand-ins, and its bytes count the casts (the dry run marks such
        # a record's bytes approximate: launch.dryrun.MOE_STANDIN_BYTES)
        w = {k: p[k].to(torch.bfloat16) for k in ("w_gate", "w_up", "w_down")}
        return grouped_ffn(cfg, w, xs.to(torch.bfloat16), offsets).to(xs.dtype)
    act = activation(cfg)
    g = torch._grouped_mm(xs, p["w_gate"], offs=offsets)
    u = torch._grouped_mm(xs, p["w_up"], offs=offsets)
    return torch._grouped_mm((act(g) * u).to(xs.dtype), p["w_down"], offs=offsets)


def moe_apply(
    cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor, *, aux: bool = True,
    reduce=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """x: [B, S, d] -> ``(y, aux losses, routing indices [B*S, k])``;
    ``reduce`` as :func:`route` takes it."""
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    k = cfg.experts_per_token
    idx, weights, losses = route(cfg, p, x2d, aux, reduce)

    # sort the token-expert assignments by expert id (stable, as jnp.argsort)
    flat_expert = idx.reshape(-1)                                   # [T*k]
    order = torch.argsort(flat_expert, stable=True)
    xs = x2d[order // k]                                            # [T*k, d] by expert
    experts = torch.arange(1, cfg.n_experts + 1, device=x.device)
    offsets = torch.searchsorted(flat_expert[order], experts, out_int32=True)
    ys = grouped_ffn(cfg, p, xs, offsets)                           # [T*k, d]

    # combine: each token's k weighted rows, summed in float32 in the order
    # of its experts (the order the reference's scatter-add meets them);
    # a fixed order, so the card's result does not vary from run to run
    contrib = ys * weights.reshape(-1)[order].to(ys.dtype)[:, None]
    slot = torch.empty_like(order)
    slot[order] = torch.arange(order.numel(), device=x.device)
    slot = slot.reshape(-1, k).sort(dim=-1).values
    y2d = contrib[slot].float().sum(dim=1).to(ys.dtype)

    if cfg.n_shared_experts:
        act = activation(cfg)
        y2d = y2d + (act(x2d @ p["sh_gate"]) * (x2d @ p["sh_up"])) @ p["sh_down"]
    return y2d.reshape(B, S, d).to(x.dtype), losses, idx
