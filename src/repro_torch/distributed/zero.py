"""ZeRO-1 optimizer-state sharding (port of ``repro/distributed/zero.py``).

Optimizer moments (and the float32 master copy) are sharded across the
data(-parallel) axes: each leaf is cut along a dim that the data-parallel
world divides, falling back to replication for small tensors.  Specs are the
tuples of ``distributed/sharding.py``.

The reference stacks a scan stage's layers on a leading ``layers`` dim, and
its first divisible dim is often that one; the port keeps a tensor a layer
and takes the layer tensor's own first free divisible dim.  Each rank then
holds the same bytes of state as a device of the reference, but for a layer
tensor whose own dims leave none free (zamba2's per-head vectors, whose one
dim ``model`` takes), which the reference cuts by layer and the port keeps
whole over ``data``.

:func:`zero1_piece` and :func:`zero1_join` take a tensor of a parameter's
local layout to a rank's piece of state and back, for the layout
:func:`zero1_from_params` gives, the one the trainer keeps.
:func:`zero1_spec` and :func:`zero1_shardings` are the reference's layout
without regard to the parameter's, kept for its specs and byte counts.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from .collectives import raw_all_gather
from .sharding import Spec, spec_axes

__all__ = ["zero1_spec", "zero1_shardings", "zero1_from_params", "zero1_piece", "zero1_join"]


def zero1_spec(shape: Tuple[int, ...], mesh, axes=("data",), *, model_dim: bool = False) -> Spec:
    """Shard the first divisible dim across the (combined) DP axes.

    ``model_dim=True`` additionally shards a second dim over 'model' (the
    reference's option for 100B-parameter configs; off by default).
    """
    use = tuple(a for a in axes if a in mesh.shape)
    parts: List[Any] = [None] * len(shape)
    if use:
        world = math.prod(mesh.shape[a] for a in use)
        for d, n in enumerate(shape):
            if n > 0 and n % world == 0:
                parts[d] = use if len(use) > 1 else use[0]
                break
    if model_dim and "model" in mesh.shape:
        msz = mesh.shape["model"]
        for d, n in enumerate(shape):
            if parts[d] is None and n > 0 and n % msz == 0 and msz > 1:
                parts[d] = "model"
                break
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def zero1_shardings(shapes: Dict[str, Tuple[int, ...]], mesh, axes=("data",), *,
                    model_dim: bool = False) -> Dict[str, Spec]:
    """``{name: spec}`` of the optimizer state from the parameters' shapes."""
    return {k: zero1_spec(tuple(s), mesh, axes, model_dim=model_dim) for k, s in shapes.items()}


def zero1_from_params(param_specs: Dict[str, Spec], shapes: Dict[str, Tuple[int, ...]], mesh,
                      axes=("data",)) -> Dict[str, Spec]:
    """Param-layout-aligned ZeRO: each parameter's spec, extended with the DP
    axes on its first still-free dim that their combined size divides (none
    where the spec already uses one of them)."""
    use = tuple(a for a in axes if a in mesh.shape)
    world = math.prod(mesh.shape[a] for a in use)

    def extend(pspec, shape):
        spec = list(pspec) + [None] * (len(shape) - len(pspec))
        if use and not set(use) & set(spec_axes(pspec)):
            for d, n in enumerate(shape):
                if spec[d] is None and n > 0 and n % world == 0:
                    spec[d] = use if len(use) > 1 else use[0]
                    break
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    return {k: extend(param_specs[k], tuple(shapes[k])) for k in param_specs}


def _extra(zspec: Spec, pspec: Spec):
    """``[(dim, axes)]`` that the state cuts beyond the parameter's own cut.
    Raises where the state's layout does not refine the parameter's, as only
    :func:`zero1_from_params`'s does."""
    out = []
    for d in range(max(len(zspec), len(pspec))):
        z = zspec[d] if d < len(zspec) else None
        p = pspec[d] if d < len(pspec) else None
        if z == p:
            continue
        if p is not None:
            raise ValueError(f"state spec {zspec} does not refine the parameter's {pspec}")
        out.append((d, z))
    return out


def zero1_piece(local: torch.Tensor, pspec: Spec, zspec: Spec, mesh) -> torch.Tensor:
    """This rank's piece of state from ``local``, a tensor in the parameter's
    layout: a view of it."""
    out = local
    for d, axes in _extra(zspec, pspec):
        n, i = mesh.axis_size(axes), mesh.index(axes)
        step = out.shape[d] // n
        out = out.narrow(d, i * step, step)
    return out


def zero1_join(piece: torch.Tensor, pspec: Spec, zspec: Spec, mesh) -> torch.Tensor:
    """The tensor in the parameter's layout from every rank's piece."""
    out = piece
    for d, axes in _extra(zspec, pspec):
        out = raw_all_gather(out, mesh, axes, d)
    return out
