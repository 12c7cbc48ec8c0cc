"""AdamW with float32 master weights, global-norm clipping, warmup + cosine LR.

Port of ``repro/optim/adamw.py``, op for op in float32.  A parameter tree is
a ``{name: tensor}`` dict keyed like the model's ``state_dict``.  The state is
``{"step": int32 scalar, "mu", "nu", "master": {name: float32 tensor}}``.
Unlike the reference, which returns new trees, :func:`adamw_step` updates the
state's tensors and the parameters in place, so a step holds no second copy
of the 16 bytes a parameter of optimizer state.

Not ``torch.optim.AdamW``: its bias correction divides sqrt(v) by
sqrt(1 - beta2^t) before adding eps, and it rounds in another order.  Weight
decay applies to every tensor, norms and embeddings too, as in the reference.
The reference computes this in XLA with no Pallas kernel, so the port runs
plain torch ops.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_step", "cosine_lr", "global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    master_fp32: bool = True


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to ``min_lr_ratio`` of
    it at ``total_steps``; float32, on step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


def adamw_init(params: Dict[str, torch.Tensor], cfg: AdamWConfig) -> Dict[str, object]:
    """Zero moments (and the float32 master copy) for ``{name: parameter}``."""
    first = next(iter(params.values()))
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "mu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
    }
    if cfg.master_fp32:
        state["master"] = {k: p.detach().float().clone() for k, p in params.items()}
    return state


@torch.no_grad()
def adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: Dict[str, object], cfg: AdamWConfig, *,
               grad_norm: Optional[torch.Tensor] = None,
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, object], Dict[str, torch.Tensor]]:
    """One step: ``(params, state, {"lr", "grad_norm"})``, params and state
    updated in place (the same objects are returned).

    Gradients are scaled by ``min(1, clip_norm / global_norm)``; the update is
    ``w - lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * w)`` on the
    float32 master, and each parameter becomes the master cast to its dtype.
    A caller that holds only part of the gradients (a ZeRO-1 shard) passes
    the whole model's ``grad_norm``.
    """
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads[k] for k in params) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    masters = state.get("master")
    for name, p in params.items():
        g32 = grads[name].float() * scale
        m, v = state["mu"][name], state["nu"][name]
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * torch.square(g32))
        mh = m / c1
        vh = v / c2
        w32 = masters[name] if masters is not None else p.float()
        w32.copy_(w32 - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * w32))
        p.copy_(w32)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
