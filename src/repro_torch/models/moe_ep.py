"""Expert-parallel MoE with explicit all-to-alls (port of ``repro/models/moe_ep.py``).

The paper's MoE workload ("GEMM + All-to-All"): each rank of the ``model``
axis owns ``E / msz`` experts and the tokens travel to their experts.

scatter path (training, ``T_loc % msz == 0`` and at least 8 tokens a rank):
  1. each model rank takes its 1/msz slice of its data shard's tokens,
  2. routes its top-k pairs into one capacity buffer a destination rank
     (pairs past the capacity drop, and are counted),
  3. ``all_to_all`` over ``model`` delivers the pairs to their experts' owner,
  4. the rank's grouped FFN over its experts (a dummy group, E_loc, holds the
     empty slots and gives zeros),
  5. ``all_to_all`` back, the weighted combine, and an all-gather of the
     token slices.

gather path (decode, few tokens): every rank computes the pairs of its own
experts on all of its data shard's tokens, and a sum over ``model`` joins.

The expert FFN width may be sharded over ``data`` (the ``expert_mlp`` rule):
the scatter path gathers the weights before use (FSDP-style), the gather
path gathers the tokens instead and sums partial outputs.

Each rank calls :func:`moe_apply_ep` with its own rows ``x [B_loc, S, d]``
(batch sharded over the mesh's batch axes, the same on every model rank)
and its own parameter shards in :func:`ep_specs`' layout.  Autograd runs
through the exchanges (``distributed/collectives.py``): where a rank uses a
replicated tensor for its part only (the scatter path's router, shared
experts and token slice; the gather path's tokens and routing weights), the
gradient is summed over the ranks that share it.  Gradients of tensors
replicated over the batch axes are left for the caller to sum over them, as
the train step does; the sharded FFN weights' are summed here.

The reference averages each rank's load-balance and z losses; their product
of means then depends on the mesh.  Here the routing statistics are summed
over every rank that routes other tokens before the losses are formed, so
they equal ``moe_apply``'s on the whole batch.  ``moe_dropped`` is the
reference's: the mean of the ranks' dropped-pair counts.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..distributed.collectives import (all_to_all, copy_in, gather, raw_all_reduce,
                                       reduce_out, split)
from .common import ModelConfig
from .mlp import activation
from .moe import grouped_ffn, route

__all__ = ["moe_apply_ep", "ep_applicable", "ep_specs"]

SHARED_KEYS = ("sh_gate", "sh_up", "sh_down")


def ep_applicable(cfg: ModelConfig, mesh) -> bool:
    if mesh is None or "model" not in mesh.shape:
        return False
    msz = mesh.shape["model"]
    return msz > 1 and cfg.n_experts % msz == 0


def _ff_axis(cfg: ModelConfig, mesh):
    dsz = mesh.shape.get("data", 1)
    return "data" if dsz > 1 and cfg.d_ff % dsz == 0 else None


def ep_specs(cfg: ModelConfig, mesh) -> Dict[str, tuple]:
    """The layout :func:`moe_apply_ep` takes its parameters in (the reference's
    ``param_specs``): experts over ``model``, the FFN width over ``data``
    where it divides, the router and shared experts whole."""
    ff = _ff_axis(cfg, mesh)
    specs = {"router": (), "w_gate": ("model", None, ff), "w_up": ("model", None, ff),
             "w_down": ("model", ff)}
    if cfg.n_shared_experts:
        specs.update({k: () for k in SHARED_KEYS})
    for k, v in specs.items():
        while v and v[-1] is None:
            v = v[:-1]
        specs[k] = v
    return specs


def _shared_ffn(cfg: ModelConfig, p, x2: torch.Tensor) -> torch.Tensor:
    if not cfg.n_shared_experts:
        return torch.zeros_like(x2)
    act = activation(cfg)
    return ((act(x2 @ p["sh_gate"]) * (x2 @ p["sh_up"])) @ p["sh_down"]).to(x2.dtype)


def _local_ffn(cfg: ModelConfig, p, xs: torch.Tensor, local_e: torch.Tensor, E_loc: int):
    """The rank's experts on the rows of ``xs`` sorted by ``local_e`` (E_loc,
    the dummy group, last and given zeros, its rows' gradient zeros too)."""
    experts = torch.arange(1, E_loc + 1, device=xs.device)
    offsets = torch.searchsorted(local_e, experts, out_int32=True)
    valid = (local_e < E_loc)[:, None]
    ys = grouped_ffn(cfg, p, torch.where(valid, xs, 0), offsets)
    return torch.where(valid, ys, 0)


def _inverse(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return inv


def _combine(y: torch.Tensor, w: torch.Tensor, T: int, k: int) -> torch.Tensor:
    """Each token's k rows of ``y [T * k, d]`` weighted by ``w [T * k]`` and
    summed in float32 in top-k order: a fixed order, no atomics."""
    return (y.float() * w[:, None]).reshape(T, k, -1).sum(dim=1)


def _scatter(cfg: ModelConfig, p, x: torch.Tensor, mesh, batch_axes, ff_axis, aux):
    B_loc, S, d = x.shape
    if ff_axis:  # FSDP-style gather of the ff-sharded expert weights
        p = dict(p)
        for key, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
            p[key] = copy_in(gather(p[key], mesh, ff_axis, dim), mesh, ff_axis)
    # the router and shared experts see this rank's token slice only
    p.update({k: copy_in(p[k], mesh, "model") for k in ("router", *SHARED_KEYS) if k in p})
    msz = mesh.shape["model"]
    E_loc = cfg.n_experts // msz
    k = cfg.experts_per_token
    T = B_loc * S
    Tm = T // msz
    xm = split(x.reshape(T, d), mesh, "model", 0)

    idx, weights, losses = route(cfg, p, xm, aux, reduce=lambda t: reduce_out(
        t, mesh, ("model", *batch_axes)))
    flat_e = idx.reshape(-1)                    # [Tm*k] global expert ids
    pair_tok = torch.arange(Tm * k, device=x.device) // k
    dest = flat_e // E_loc                      # owning model rank
    C = int(math.ceil(Tm * k / msz * cfg.capacity_factor))

    # position of each pair within its destination buffer (sorted by dest)
    order = torch.argsort(dest, stable=True)
    sdest = dest[order]
    run_start = torch.searchsorted(sdest, torch.arange(msz, device=x.device))
    pos = torch.arange(Tm * k, device=x.device) - run_start[sdest]
    keep = pos < C
    dropped = (~keep).sum().float().reshape(1)

    # a dropped pair is written to a spare destination row msz, cut off
    # before the exchange: the buffers stay contiguous and no shape depends
    # on the routing, so the dry run traces it
    at = (torch.where(keep, sdest, msz), torch.where(keep, pos, 0))
    send_x = xm.new_zeros(msz + 1, C, d).index_put(at, xm[pair_tok[order]])[:msz]
    send_le = torch.full((msz + 1, C), E_loc, dtype=torch.long, device=x.device).index_put(
        at, flat_e[order] % E_loc)[:msz]

    recv_x = all_to_all(send_x, mesh, "model").reshape(msz * C, d)
    recv_le = all_to_all(send_le, mesh, "model").reshape(msz * C)
    order2 = torch.argsort(recv_le, stable=True)
    ys = _local_ffn(cfg, p, recv_x[order2], recv_le[order2], E_loc)
    ret = all_to_all(ys[_inverse(order2)].reshape(msz, C, d), mesh, "model")

    # each pair's result out of the buffers; dropped pairs get weight 0
    inv = _inverse(order)
    pair_y = ret[sdest, torch.where(keep, pos, 0)][inv]
    pair_w = torch.where(keep[inv], weights.reshape(-1), 0.0)
    y_m = _combine(pair_y, pair_w, Tm, k).to(x.dtype) + _shared_ffn(cfg, p, xm)
    y_full = gather(y_m, mesh, "model", 0)     # [T, d]
    return y_full.reshape(B_loc, S, d), losses, dropped


def _gather(cfg: ModelConfig, p, x: torch.Tensor, mesh, batch_axes, ff_axis, aux):
    B_loc, S, d = x.shape
    msz, midx = mesh.shape["model"], mesh.index("model")
    E_loc = cfg.n_experts // msz
    k = cfg.experts_per_token
    T_loc = B_loc * S
    x_loc = x.reshape(T_loc, d)
    # routing is per token: route this rank's own tokens (the same on every
    # model rank), then gather the decisions with the tokens
    idx, weights, losses = route(cfg, p, x_loc, aux, reduce=lambda t: reduce_out(
        t, mesh, batch_axes))
    x2 = x_loc
    if ff_axis:  # few tokens at decode: gather them across the ff-sharding axis
        x2 = gather(x_loc, mesh, ff_axis, 0)
        weights = gather(weights, mesh, ff_axis, 0)
        idx = gather(idx, mesh, ff_axis, 0)
    # this rank computes the pairs of its experts (on its ff slice): partial
    partial = ("model", ff_axis) if ff_axis else ("model",)
    x2 = copy_in(x2, mesh, partial)
    weights = copy_in(weights, mesh, partial)
    T = x2.shape[0]
    flat_e = idx.reshape(-1)
    pair_tok = torch.arange(T * k, device=x.device) // k
    mine = (flat_e // E_loc) == midx
    le = torch.where(mine, flat_e % E_loc, E_loc)     # dummy group for others
    order = torch.argsort(le, stable=True)
    ys = _local_ffn(cfg, p, x2[pair_tok[order]], le[order], E_loc)[_inverse(order)]
    w = torch.where(mine, weights.reshape(-1), 0.0)
    y2 = reduce_out(_combine(ys, w, T, k), mesh, "model")
    if ff_axis:  # sum the ff-slice partials, keep this rank's tokens
        y2 = split(reduce_out(y2, mesh, ff_axis), mesh, ff_axis, 0)
    y2 = y2.to(x.dtype) + _shared_ffn(cfg, p, x_loc)
    return y2.reshape(B_loc, S, d), losses, torch.zeros(1, device=x.device)


def moe_apply_ep(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor, mesh, *,
                 aux: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert-parallel MoE layer on this rank's rows ``x [B_loc, S, d]``:
    ``(y [B_loc, S, d], {"moe_load_balance", "moe_z", "moe_dropped"})``; with
    ``aux=False`` (the decode step, which drops them) no losses, no drop
    count and none of their exchanges: ``(y, {})``."""
    msz = mesh.shape["model"]
    B_loc, S, _ = x.shape
    batch_axes = mesh.batch_axes
    T_loc = B_loc * S
    use_scatter = T_loc % msz == 0 and (T_loc // msz) >= 8
    body = _scatter if use_scatter else _gather
    p_used = {key: p[key] for key in ep_specs(cfg, mesh)}
    y, losses, dropped = body(cfg, p_used, x, mesh, batch_axes, _ff_axis(cfg, mesh), aux)
    if not aux:
        return y, {}
    axes = ("model", *batch_axes)
    dropped = raw_all_reduce(dropped, mesh, axes)[0] / mesh.axis_size(axes)
    return y, {**losses, "moe_dropped": dropped}
