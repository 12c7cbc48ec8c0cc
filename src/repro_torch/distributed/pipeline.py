"""Pipeline parallelism, GPipe-style (port of ``repro/distributed/pipeline.py``).

Layers are split into ``n_stages`` equal groups placed along a ``pipe``
mesh axis, one group a rank; microbatches stream through the GPipe
schedule: ``n_micro + n_stages - 1`` ticks, each running one stage-step on
every rank and shifting activations to the next stage around the ring (the
paper's one-sided neighbour pushes at pipeline granularity).  Stage 0
injects microbatch t at tick t, the last stage emits microbatch
``t - n_stages + 1``, and a final all-reduce over ``pipe`` gives every stage
the result.  The forward equals the unpipelined stack.

Each rank runs its own program, so the reference's one SPMD program becomes
one schedule a rank: a tick where a stage holds no microbatch (the bubble)
computes nothing and sends zeros, where the reference computes on zeros and
masks them out.  The backward is the mirrored pipeline, written out: the
ticks in reverse, each stage's gradient shifted back to the previous stage
(the ring shift's transpose).  It is one autograd function, because a rank's
autograd sees only its own graph: a stage's output leaves it through a send,
so no gradient would reach that stage's layers through a differentiable
shift.  Each active tick's graph is kept from the forward (GPipe keeps every
microbatch's activations); the gradient of the input is summed over ``pipe``
(stage 0's, the only stage that reads it).

Bubble fraction = (n_stages - 1) / (n_micro + n_stages - 1).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from .collectives import _all_reduce, _ring_shift

__all__ = ["pipeline_apply", "bubble_fraction", "stack_stage_params"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe schedule."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def stack_stage_params(layer_params, n_stages: int):
    """[L, ...] stacked layer params -> [n_stages, L/n_stages, ...]."""

    def re(x):
        L = x.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])

    return pytree.tree_map(re, layer_params)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layer_fn, treedef, n_micro, mesh, axis, x, *leaves):
        n_stages, stage, group = mesh.axis_size(axis), mesh.index(axis), mesh.group(axis)
        micros = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
        n_ticks = n_micro + n_stages - 1
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        n_layers = params[0].shape[1]

        def run_stage(x_mb):
            for i in range(n_layers):
                x_mb = layer_fn(pytree.tree_unflatten([p[0, i] for p in params], treedef), x_mb)
            return x_mb

        graphs = {}  # tick -> (input, output) of this stage's step, with its graph
        buf = torch.zeros_like(micros[0])
        outs = torch.zeros_like(micros)
        with torch.enable_grad():
            for t in range(n_ticks):
                m = t - stage  # the microbatch at this stage on tick t
                y = torch.zeros_like(buf)
                if 0 <= m < n_micro:
                    x_in = (micros[m] if stage == 0 else buf).detach().requires_grad_()
                    y = run_stage(x_in)
                    graphs[t] = (x_in, y)
                    if stage == n_stages - 1:
                        outs[m] = y.detach()
                if t < n_ticks - 1 and group is not None:  # the last shift is never read
                    buf = _ring_shift(y.detach(), group)
        ctx.graphs, ctx.params = graphs, params
        ctx.layout = (n_micro, n_stages, stage, group, n_ticks, micros.shape)
        ctx.x_grad = x.requires_grad
        outs = outs if group is None else _all_reduce(outs, group)
        return outs.reshape(x.shape)

    @staticmethod
    def backward(ctx, g_out):
        n_micro, n_stages, stage, group, n_ticks, shape = ctx.layout
        g_outs = g_out.reshape(shape)
        g_params = [torch.zeros_like(p) for p in ctx.params]
        g_x = torch.zeros(shape, dtype=g_out.dtype, device=g_out.device)
        g_in = torch.zeros(shape[1:], dtype=g_out.dtype, device=g_out.device)
        wanted = [p for p in ctx.params if p.requires_grad]
        for t in reversed(range(n_ticks)):
            # the gradient of what this stage sent on tick t, from the next
            # stage, for the gradient of what it received after tick t
            g_y = (torch.zeros_like(g_in) if t == n_ticks - 1 or group is None
                   else _ring_shift(g_in, group, offset=-1))
            g_in = torch.zeros_like(g_in)
            if t not in ctx.graphs:
                continue
            m = t - stage
            if stage == n_stages - 1:
                g_y = g_y + g_outs[m]
            x_in, y = ctx.graphs.pop(t)
            grads = torch.autograd.grad(y, [x_in, *wanted], g_y, allow_unused=True)
            it = iter(grads[1:])
            for i, p in enumerate(ctx.params):
                if p.requires_grad:
                    g = next(it)
                    if g is not None:
                        g_params[i] += g
            if stage == 0:
                g_x[m] = grads[0]
            else:
                g_in = grads[0]
        if ctx.x_grad and group is not None:
            g_x = _all_reduce(g_x, group)
        return (None, None, None, None, None, g_x.reshape(g_out.shape) if ctx.x_grad else None,
                *g_params)


def pipeline_apply(mesh, layer_fn: Callable[[Any, torch.Tensor], torch.Tensor], *,
                   n_micro: int, axis: str = "pipe"):
    """Builds a pipelined stack applier on a bound ``mesh``.

    ``layer_fn(layer_params, x) -> x`` applies ONE layer.  Returns
    ``apply(stage_params, x)``: ``stage_params`` is this rank's shard of
    :func:`stack_stage_params`' output along dim 0 (leaves ``[1, L/S, ...]``)
    and ``x [n_micro * mb, ...]`` is the same on every rank.  Every rank gets
    the output of all layers run in sequence.
    """

    def apply(stage_params, x: torch.Tensor) -> torch.Tensor:
        leaves, treedef = pytree.tree_flatten(stage_params)
        return _Pipeline.apply(layer_fn, treedef, n_micro, mesh, axis, x, *leaves)

    return apply
