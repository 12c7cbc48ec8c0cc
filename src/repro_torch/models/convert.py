"""Carry the reference's parameters into the port.

The reference keeps a scan stage's parameters stacked on a leading ``layers``
dim (``{"embed", "final_norm", "stages": [{"ln1": [L, d], "attn": {...},
...}, ...]}``, one stage per entry of ``build_plan``: kimi-k2's dense first
layer, then its MoE layers with expert tensors ``[L, E, d, ff]`` and a
float32 router).  A ``single`` stage (xLSTM's layers) holds one layer's
unstacked dict; a ``shared`` stage (zamba2) holds ``{}``, and the shared
block's parameters sit once under ``params["shared"]``.  The port keeps one
block per layer, ``blocks.<i>``, and the shared block once, ``shared``.  :func:`params_from_jax`
takes that tree with numpy leaves (bf16 leaves as ``ml_dtypes.bfloat16``
arrays, as ``np.asarray`` gives them) and returns a ``state_dict`` for
``Model(cfg)``; given a bound mesh, the state_dict of this rank's shards,
cut as ``distributed.sharding.shard_params`` cuts them.
:func:`opt_state_from_jax` carries the reference's AdamW
state across by the same walk, its moments and master kept in float32.  No
JAX is imported: the caller converts to numpy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..distributed.sharding import DEFAULT_RULES, ShardingRules, param_shardings, shard_tensor
from .common import ModelConfig
from .model import build_plan, param_specs

__all__ = ["params_from_jax", "opt_state_from_jax"]


def _to_torch(a: Any) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(np_tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The leaves of a tree shaped like the reference's parameters, as
    tensors of their own dtype under the port's ``state_dict`` names."""
    specs = param_specs(cfg)
    plan = build_plan(cfg)
    if len(np_tree["stages"]) != len(plan):
        raise ValueError(f"expected {len(plan)} stages, got {len(np_tree['stages'])}")
    flat: Dict[str, Any] = {"embed": np_tree["embed"], "final_norm": np_tree["final_norm"]}

    def put(prefix: str, tree: Dict[str, Any], pick) -> None:
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                flat.update({f"{prefix}.{name}.{k}": pick(v) for k, v in leaf.items()})
            else:
                flat[f"{prefix}.{name}"] = pick(leaf)

    li = 0  # blocks with parameters of their own, in order
    for st, stage in zip(plan, np_tree["stages"]):
        if st.kind == "shared":
            if stage:
                raise ValueError(f"a shared stage holds no parameters, got {sorted(stage)}")
            continue
        for i in range(st.n):
            put(f"blocks.{li}", stage, (lambda a, i=i: a[i]) if st.kind == "scan" else
                (lambda a: a))
            li += 1
    if "shared" in np_tree:
        put("shared", np_tree["shared"], lambda a: a)
    if "lm_head" in np_tree:
        flat["lm_head"] = np_tree["lm_head"]

    if set(flat) != set(specs):
        raise ValueError(f"parameter names differ: missing {sorted(set(specs) - set(flat))}, "
                         f"unexpected {sorted(set(flat) - set(specs))}")
    out = {}
    for name, spec in specs.items():
        t = _to_torch(flat[name])
        if tuple(t.shape) != spec.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {spec.shape}")
        out[name] = t
    return out


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig, mesh=None,
                    rules: ShardingRules = DEFAULT_RULES) -> Dict[str, torch.Tensor]:
    """``state_dict`` of ``Model(cfg)`` from the reference's numpy parameter
    tree; with a bound ``mesh``, this rank's shards under ``rules``."""
    specs = param_specs(cfg)
    out = {name: t.to(specs[name].dtype) for name, t in _flatten(np_tree, cfg).items()}
    if mesh is None:
        return out
    cuts, _ = param_shardings(specs, mesh, rules)
    return {name: shard_tensor(t, cuts[name], mesh).clone() for name, t in out.items()}


def opt_state_from_jax(np_state: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's AdamW state (``repro_torch.optim``) from the reference's
    ``adamw_init`` / ``adamw_step`` state with numpy leaves: ``step`` as an
    int32 scalar, ``mu`` / ``nu`` / ``master`` keyed like ``state_dict`` and
    kept in float32 (a cast to the parameters' dtype would round the master)."""
    out: Dict[str, Any] = {"step": torch.tensor(int(np.asarray(np_state["step"])),
                                                dtype=torch.int32)}
    for key in ("mu", "nu", "master"):
        if key in np_state:
            out[key] = {name: t.to(torch.float32)
                        for name, t in _flatten(np_state[key], cfg).items()}
    return out
