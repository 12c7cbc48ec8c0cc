"""Train step and fault-tolerant run loop (port of ``repro/training/trainer.py``).

``build_train_step`` gives the reference's step: the loss in float32,
gradients by autograd (through the rmsnorm backward kernel on the card),
microbatched accumulation into float32 buffers, remat by name, and AdamW on
float32 master weights.  The model's parameters are updated in place, and so
is the optimizer state: what the reference's buffer donation
(``donate_state``) buys, the port always does, so it has no such option and
a caller who needs the old state copies it first.

With a mesh (``launch/mesh.py``, bound in a running world) the step is the
reference's sharded one, each rank computing its part:
  - parameters sharded by the logical-axis rules (``shard_params``), the
    model's compute tensor-parallel where the specs allow;
  - batch rows sharded over ("pod", "data"): microbatch i of the global
    batch is cut into one slice a data rank, so every microbatch holds the
    rows it holds on one device;
  - the loss of the whole batch on every rank; each rank's gradients, its
    rows' part, summed over the batch axes for a parameter the batch axes do
    not shard (a sharded one's sum happens in its gather's backward);
  - ZeRO-1: each rank keeps and updates its piece of the optimizer state,
    laid out as its parameter shard cut again over ``zero1_axes``
    (``zero1_from_params``, the reference's default), the clipping norm is
    the whole model's, and each new parameter shard is gathered from the
    pieces.

``Trainer`` adds checkpoint/restart on (simulated) failures, as the
reference's does.  Under a mesh its checkpoints hold whole tensors, gathered
from every rank and written by the mesh's first rank, so the store's format
is the one-device format.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..distributed.collectives import raw_all_reduce
from ..distributed.sharding import (DEFAULT_RULES, ShardingRules, gather_tensor,
                                    param_shardings, shard_params, shard_tensor, spec_axes)
from ..distributed.zero import zero1_from_params, zero1_join, zero1_piece
from ..ft import SimulatedFailure, StragglerMonitor
from ..models import Model
from ..optim import AdamWConfig, adamw_init, adamw_step

__all__ = ["TrainConfig", "Trainer", "build_train_step"]


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat_policy: str = "none"       # none | full | dots | dots_no_batch
    moe_loss_weight: float = 0.01
    z_loss_weight: float = 1e-4
    optim: AdamWConfig = field(default_factory=AdamWConfig)
    zero1_axes: Tuple[str, ...] = ("data",)


def build_train_step(model: Model, tcfg: TrainConfig, mesh=None,
                     rules: ShardingRules = DEFAULT_RULES):
    """``train_step(opt_state, tokens, labels) -> (opt_state, metrics)``.

    tokens / labels: int ``[B, S]`` (tensors or arrays), the global batch on
    every rank.  With ``microbatches`` mb > 1 the batch is cut into mb
    consecutive slices of B / mb rows (the reference's reshape); each slice's
    gradients are added into float32 buffers, which are then divided by mb,
    and the loss is the mean of the slices'.  Metrics: ``loss``, ``lr``,
    ``grad_norm``, and with one microbatch the loss's own (``ce`` and the aux
    losses), as 0-dim tensors on the model's device.  Sets every parameter to
    require grad.

    With a bound ``mesh`` the model is sharded on it first (if it is not
    yet), and the step is the sharded one (see the module's doc).  The
    returned function carries ``init_state()`` (the optimizer state of the
    model's current parameters; under a mesh this rank's ZeRO-1 pieces),
    ``shardings`` (``{"params", "state"}``: ``{name: spec}`` each, None
    without a mesh), ``fallbacks`` (the rules' fallback log) and
    ``unpartitioned`` (``Model.unpartitioned``).
    """
    fallbacks = []
    if mesh is not None:
        if model.mesh is None:
            fallbacks = shard_params(model, mesh, rules)
        else:
            _, fallbacks = param_shardings(model.param_specs(), mesh, rules)
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

    def accumulate(tks, lbs):
        """``(loss, gradients, metrics)`` over the microbatches ``tks[i]``."""
        mb = tks.shape[0]
        if mb == 1:
            loss, metrics_aux = grads_of(tks[0], lbs[0])
            return loss, {k: grad(p) for k, p in params.items()}, metrics_aux
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
        return loss / mb, g, {}

    def microbatches(tokens, labels):
        """``[mb, rows, S]`` of this rank's rows of each microbatch."""
        tokens = torch.as_tensor(tokens, device=model.device)
        labels = torch.as_tensor(labels, device=model.device)
        mb, B = tcfg.microbatches, tokens.shape[0]
        nb = 1 if mesh is None else mesh.axis_size(mesh.batch_axes)
        bi = 0 if mesh is None else mesh.index(mesh.batch_axes)
        if B % (mb * nb):
            raise ValueError(f"batch {B} must divide into {mb} microbatches of {nb} "
                             f"data-parallel slices")
        return tuple(t.reshape(mb, nb, B // (mb * nb), *t.shape[1:])[:, bi]
                     for t in (tokens, labels))

    if mesh is None:
        def train_step(opt_state, tokens, labels):
            loss, g, metrics_aux = accumulate(*microbatches(tokens, labels))
            _, opt_state, opt_metrics = adamw_step(params, g, opt_state, tcfg.optim)
            for p in params.values():
                p.grad = None
            return opt_state, {"loss": loss, **opt_metrics, **metrics_aux}

        train_step.init_state = lambda: adamw_init(params, tcfg.optim)
        train_step.shardings = None
    else:
        pspecs = model.shardings
        shapes = {k: s.shape for k, s in model.param_specs().items()}
        zaxes = tuple(a for a in (*tcfg.zero1_axes, "pod") if a in mesh.shape)
        zspecs = zero1_from_params(pspecs, shapes, mesh, zaxes)
        batch = mesh.batch_axes
        # gradients the batch axes do not shard: each rank holds its rows' part
        dp_sum = [k for k in params if not set(spec_axes(pspecs[k])) & set(batch)]
        # a piece counts once in the norm: on the ranks at coordinate 0 of
        # every axis along which it is repeated
        counted = [k for k in params
                   if all(mesh.coord[a] == 0 for a in mesh.shape
                          if a not in spec_axes(zspecs[k]))]

        def pieces(tensors):
            return {k: zero1_piece(t, pspecs[k], zspecs[k], mesh) for k, t in tensors.items()}

        def train_step(opt_state, tokens, labels):
            loss, g, metrics_aux = accumulate(*microbatches(tokens, labels))
            g = {k: raw_all_reduce(v.float(), mesh, batch) if k in dp_sum else v.float()
                 for k, v in g.items()}
            for p in params.values():
                p.grad = None
            g_pieces = pieces(g)
            sq = sum(torch.sum(torch.square(g_pieces[k])) for k in counted)
            sq = torch.as_tensor(sq, dtype=torch.float32, device=model.device).reshape(1)
            gnorm = torch.sqrt(raw_all_reduce(sq, mesh, mesh.axis_names))[0]
            with torch.no_grad():
                p_pieces = pieces({k: p.data for k, p in params.items()})
                _, opt_state, opt_metrics = adamw_step(p_pieces, g_pieces, opt_state,
                                                       tcfg.optim, grad_norm=gnorm)
                for k, p in params.items():
                    p.data.copy_(zero1_join(p_pieces[k], pspecs[k], zspecs[k], mesh))
            return opt_state, {"loss": loss, **opt_metrics, **metrics_aux}

        train_step.init_state = lambda: adamw_init(
            pieces({k: p.detach() for k, p in params.items()}), tcfg.optim)
        train_step.shardings = {"params": pspecs, "state": zspecs}
    train_step.fallbacks = fallbacks
    train_step.unpartitioned = model.unpartitioned()
    return train_step


class Trainer:
    """Fault-tolerant training runner (checkpoint/restart + stragglers)."""

    def __init__(self, model: Model, tcfg: TrainConfig, *, mesh=None,
                 rules: ShardingRules = DEFAULT_RULES, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50,
                 failure_injector: Optional[Callable[[int], None]] = None):
        self.model = model
        self.tcfg = tcfg
        self.mesh = mesh
        self.step_fn = build_train_step(model, tcfg, mesh, rules)
        self.shardings = self.step_fn.shardings
        self.fallbacks = self.step_fn.fallbacks
        self.ckpt = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.stragglers = StragglerMonitor()
        self.failure_injector = failure_injector
        self.opt_state = None
        self.step = 0

    @property
    def is_main(self) -> bool:
        """The rank that writes checkpoints and logs: the only one without a mesh."""
        return self.mesh is None or self.mesh.rank == self.mesh.devices.reshape(-1)[0]

    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def init_state(self, generator: torch.Generator) -> None:
        """Draw the parameters from ``generator`` and zero the optimizer."""
        self.model.init(generator)
        self.opt_state = self.step_fn.init_state()
        self.step = 0

    def _whole(self) -> Dict[str, object]:
        """``{"params", "state"}`` as whole tensors (gathered under a mesh)."""
        params = self._params()
        if self.mesh is None:
            return {"params": params, "state": self.opt_state}
        p_specs, z_specs = self.shardings["params"], self.shardings["state"]
        state = {k: v if k == "step" else {n: gather_tensor(t, z_specs[n], self.mesh)
                                           for n, t in v.items()}
                 for k, v in self.opt_state.items()}
        return {"params": {n: gather_tensor(p.detach(), p_specs[n], self.mesh)
                           for n, p in params.items()}, "state": state}

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.group(self.mesh.axis_names) is not None:
            dist.barrier(group=self.mesh.group(self.mesh.axis_names))

    def maybe_restore(self) -> bool:
        """Load the newest committed checkpoint into the model and the
        optimizer state; False if there is none."""
        if self.ckpt is None:
            return False
        if self.is_main:
            self.ckpt.wait()
        self._barrier()  # the main rank's last checkpoint is on disk
        shapes = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
                  for k, s in self.model.param_specs().items()}
        template = {"params": shapes, "state": adamw_init(shapes, self.tcfg.optim)}
        step, tree = self.ckpt.restore_latest(template, self.model.device)
        if step is None:
            return False
        state = tree["state"]
        if self.mesh is not None:
            z_specs = self.shardings["state"]
            state = {k: v if k == "step" else {n: shard_tensor(t, z_specs[n], self.mesh).clone()
                                               for n, t in v.items()}
                     for k, v in state.items()}
        with torch.no_grad():
            for name, p in self._params().items():
                full = tree["params"][name]
                p.copy_(full if self.mesh is None else
                        shard_tensor(full, self.shardings["params"][name], self.mesh))
        self.opt_state = state
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
                    history.append({"step": self.step, "loss": loss, "dt": dt,
                                    "grad_norm": float(metrics["grad_norm"])})
                    if self.ckpt and self.step % self.ckpt_every == 0:
                        whole = self._whole()
                        if self.is_main:
                            self.ckpt.save(self.step, whole)
                    if log_every and self.step % log_every == 0 and self.is_main:
                        print(f"step {self.step:5d} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            except SimulatedFailure as e:
                if self.is_main:
                    print(f"[ft] failure at step {self.step}: {e}; restarting")
                if not self.maybe_restore():
                    raise RuntimeError("failure before first checkpoint; cannot recover") from e
        if self.ckpt and self.is_main:
            self.ckpt.wait()
        return history
