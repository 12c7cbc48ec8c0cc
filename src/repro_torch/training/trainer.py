"""Train step and fault-tolerant run loop (port of ``repro/training/trainer.py``).

``build_train_step`` gives the reference's step on one device: the loss in
float32, gradients by autograd (through the rmsnorm backward kernel on the
card), microbatched accumulation into float32 buffers, remat by name, and
AdamW on float32 master weights.  The model's parameters are updated in
place.  The reference's sharding, ZeRO-1 and buffer donation belong to the
sharded substrate (slice 4b) and are left out, with the mesh.

``Trainer`` adds checkpoint/restart on (simulated) failures, as the
reference's does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from ..checkpoint import CheckpointManager
from ..ft import SimulatedFailure, StragglerMonitor
from ..models import Model
from ..optim import AdamWConfig, adamw_init, adamw_step

__all__ = ["TrainConfig", "Trainer", "build_train_step"]


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat_policy: str = "none"       # none | full (dots, dots_no_batch: slice 4b)
    moe_loss_weight: float = 0.01
    z_loss_weight: float = 1e-4
    optim: AdamWConfig = field(default_factory=AdamWConfig)


def build_train_step(model: Model, tcfg: TrainConfig):
    """``train_step(opt_state, tokens, labels) -> (opt_state, metrics)``.

    tokens / labels: int ``[B, S]`` (tensors or arrays).  With
    ``microbatches`` mb > 1 the batch is cut into mb consecutive slices of
    B / mb rows (the reference's reshape); each slice's bf16 gradients are
    added into float32 buffers, which are then divided by mb, and the loss is
    the mean of the slices'.  Metrics: ``loss``, ``lr``, ``grad_norm``, and
    with one microbatch the loss's own (``ce`` and the aux losses), as 0-dim
    tensors on the model's device.  Sets every parameter to require grad.
    """
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    remat = tcfg.remat_policy != "none"
    policy = tcfg.remat_policy if remat else "full"

    def grad(p: torch.Tensor) -> torch.Tensor:
        """A parameter's gradient; zeros for one the loss did not reach."""
        return torch.zeros_like(p) if p.grad is None else p.grad

    def grads_of(tokens, labels):
        """``(loss, metrics)`` of one batch, its gradients left in ``.grad``."""
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss_fn(tokens, labels, remat=remat, remat_policy=policy,
                                      moe_loss_weight=tcfg.moe_loss_weight,
                                      z_loss_weight=tcfg.z_loss_weight)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(opt_state, tokens, labels):
        tokens = torch.as_tensor(tokens, device=model.device)
        labels = torch.as_tensor(labels, device=model.device)
        mb = tcfg.microbatches
        if mb > 1:
            B = tokens.shape[0]
            if B % mb:
                raise ValueError(f"batch {B} must divide into {mb} microbatches")
            tks = tokens.reshape(mb, B // mb, *tokens.shape[1:])
            lbs = labels.reshape(mb, B // mb, *labels.shape[1:])
            g = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(mb):
                l_i, _ = grads_of(tks[i], lbs[i])
                for k, p in params.items():
                    g[k].add_(grad(p))
                loss = loss + l_i
            for acc in g.values():
                acc.div_(mb)
            loss = loss / mb
            metrics_aux: Dict[str, torch.Tensor] = {}
        else:
            loss, metrics_aux = grads_of(tokens, labels)
            g = {k: grad(p) for k, p in params.items()}
        _, opt_state, opt_metrics = adamw_step(params, g, opt_state, tcfg.optim)
        for p in params.values():
            p.grad = None
        metrics = {"loss": loss, **opt_metrics}
        metrics.update(metrics_aux)
        return opt_state, metrics

    return train_step


class Trainer:
    """Fault-tolerant training runner (checkpoint/restart + stragglers)."""

    def __init__(self, model: Model, tcfg: TrainConfig, *, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50,
                 failure_injector: Optional[Callable[[int], None]] = None):
        self.model = model
        self.tcfg = tcfg
        self.step_fn = build_train_step(model, tcfg)
        self.ckpt = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.stragglers = StragglerMonitor()
        self.failure_injector = failure_injector
        self.opt_state = None
        self.step = 0

    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def init_state(self, generator: torch.Generator) -> None:
        """Draw the parameters from ``generator`` and zero the optimizer."""
        self.model.init(generator)
        self.opt_state = adamw_init(self._params(), self.tcfg.optim)
        self.step = 0

    def maybe_restore(self) -> bool:
        """Load the newest committed checkpoint into the model and the
        optimizer state; False if there is none."""
        if self.ckpt is None:
            return False
        params = self._params()
        shapes = {k: torch.empty_like(p, device="meta") for k, p in params.items()}
        template = {"params": shapes, "state": adamw_init(shapes, self.tcfg.optim)}
        step, tree = self.ckpt.restore_latest(template, self.model.device)
        if step is None:
            return False
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(tree["params"][name])
        self.opt_state = tree["state"]
        self.step = step
        return True

    def run(self, batches, n_steps: int, *, log_every: int = 10):
        """Run to ``n_steps`` with automatic restart on SimulatedFailure;
        the history has one entry a step taken (a restart repeats steps)."""
        history = []
        while self.step < n_steps:
            try:
                for _ in range(self.step, n_steps):
                    batch = next(batches)
                    if self.failure_injector is not None:
                        self.failure_injector(self.step)
                    t0 = time.perf_counter()
                    self.opt_state, metrics = self.step_fn(
                        self.opt_state, batch["tokens"], batch["labels"])
                    loss = float(metrics["loss"])
                    dt = time.perf_counter() - t0
                    self.step += 1
                    history.append({"step": self.step, "loss": loss, "dt": dt})
                    if self.ckpt and self.step % self.ckpt_every == 0:
                        self.ckpt.save(self.step, {"params": self._params(),
                                                   "state": self.opt_state})
                    if log_every and self.step % log_every == 0:
                        print(f"step {self.step:5d} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            except SimulatedFailure as e:
                print(f"[ft] failure at step {self.step}: {e}; restarting")
                if not self.maybe_restore():
                    raise RuntimeError("failure before first checkpoint; cannot recover") from e
        if self.ckpt:
            self.ckpt.wait()
        return history
