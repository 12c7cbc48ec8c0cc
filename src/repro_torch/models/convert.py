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
``Model(cfg)``.  No JAX is imported: the caller converts to numpy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .common import ModelConfig
from .model import build_plan, param_specs

__all__ = ["params_from_jax"]


def _to_torch(a: Any) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """``state_dict`` of ``Model(cfg)`` from the reference's numpy parameter tree."""
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
        out[name] = t.to(spec.dtype)
    return out
