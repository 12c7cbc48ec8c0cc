"""Logical-axis sharding rules with automatic divisibility fallback (port of
``repro/distributed/sharding.py``), and the placement of a model's shards.

Parameters declare *logical* axes (``embed``, ``heads``, ``mlp``, ``vocab``,
``experts``, ...); a :class:`ShardingRules` table maps each to a mesh axis
(or None, replicated).  :func:`resolve_spec` checks divisibility: a dim that
its mesh axis does not divide falls back to replication, and the event is
logged in the reference's words.  A spec is the reference's
``PartitionSpec`` as a tuple: one entry a dim, a mesh axis name, a tuple of
them, or None, trailing Nones trimmed.

The port keeps one block a layer (``blocks.<i>.*``) where the reference
stacks a leading ``layers`` dim, which its rules never shard; the port's
spec for a layer tensor is the reference's with that dim dropped.

:func:`shard_params` keeps each rank's slice of every parameter (its chunk
of each sharded dim, by :meth:`BoundMesh.index`) and tells the model's
blocks their specs; :func:`gather_params` is the inverse.  :func:`use_full`
gives a block the whole tensor it computes with where its compute is not
partitioned like its storage: an all-gather of each sharded dim, whose
backward keeps this rank's slice, and an all-reduce of the gradient over
the axes where the use is partial (the batch axes the shard spans, where
every rank saw other rows, and ``sum_over``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .collectives import copy_in, gather, raw_all_gather

__all__ = [
    "ShardingRules",
    "DEFAULT_RULES",
    "resolve_spec",
    "param_shardings",
    "constrain",
    "batch_spec",
    "spec_axes",
    "shard_tensor",
    "gather_tensor",
    "shard_params",
    "gather_params",
    "use_full",
    "use_params",
]

Spec = Tuple  # one entry a dim: None, an axis name or a tuple of them


@dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (None = replicate)."""

    rules: Tuple[Tuple[str, Optional[str]], ...] = ()
    strict: bool = False

    def to_dict(self) -> Dict[str, Optional[str]]:
        return dict(self.rules)

    def with_rule(self, logical: str, mesh_axis: Optional[str]) -> "ShardingRules":
        d = self.to_dict()
        d[logical] = mesh_axis
        return ShardingRules(rules=tuple(d.items()), strict=self.strict)


# The production table: model-parallel over heads/mlp/vocab/experts, data-
# parallel over batch, pods pure-DP.  ``experts_logits`` (router) and MLA
# ``rank`` stay replicated; layers stay unsharded.
DEFAULT_RULES = ShardingRules(
    rules=(
        ("batch", "data"),
        ("seq", None),
        ("kv_seq", "data"),       # sequence-parallel KV for long_500k
        ("embed", None),
        ("embed2", None),
        ("heads", "model"),
        ("kv", "model"),
        ("mlp", "model"),
        # expert FFN width shards across data: with experts on the model
        # axis this spreads a 1T-param MoE over the full mesh (FSDP-style
        # per-layer weight gathers happen inside the EP layer)
        ("expert_mlp", "data"),
        ("vocab", "model"),
        ("experts", "model"),     # expert parallelism on the model axis
        ("experts_logits", None),
        ("rank", None),
        ("layers", None),
        ("conv", None),
        ("state", None),
    )
)


def resolve_spec(shape: Sequence[int], axes: Sequence[Optional[str]], rules: ShardingRules,
                 mesh, *, path: str = "", fallbacks: Optional[List[str]] = None) -> Spec:
    """The spec of one tensor, with divisibility fallback."""
    table = rules.to_dict()
    used: set = set()
    parts: List[Optional[str]] = []
    for dim, ax in zip(shape, axes):
        mesh_ax = table.get(ax) if ax is not None else None
        if mesh_ax is None or mesh_ax not in mesh.shape:
            parts.append(None)
            continue
        size = mesh.shape[mesh_ax]
        if dim % size != 0 or mesh_ax in used:
            if rules.strict:
                raise ValueError(f"{path}: dim {dim} (logical {ax!r}) not divisible by "
                                 f"mesh axis {mesh_ax!r} of size {size}")
            if fallbacks is not None:
                reason = "reused" if mesh_ax in used else f"{dim} % {size} != 0"
                fallbacks.append(f"{path}[{ax}->{mesh_ax}]: replicated ({reason})")
            parts.append(None)
            continue
        used.add(mesh_ax)
        parts.append(mesh_ax)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def param_shardings(specs, mesh, rules: ShardingRules = DEFAULT_RULES
                    ) -> Tuple[Dict[str, Spec], List[str]]:
    """``({name: spec}, fallback log)`` for ``{name: ParamSpec}``; a log
    entry's path is the parameter's name."""
    fallbacks: List[str] = []
    out = {name: resolve_spec(s.shape, s.axes, rules, mesh, path=name, fallbacks=fallbacks)
           for name, s in specs.items()}
    return out, fallbacks


def batch_spec(mesh, *, pods: bool = False) -> Spec:
    """Data-parallel batch spec: batch over ('pod', 'data') when multi-pod."""
    if pods and "pod" in mesh.shape:
        return (("pod", "data"),)
    return ("data",)


def constrain(x: torch.Tensor, mesh, *parts) -> torch.Tensor:
    """The reference's activation sharding hint, which no model of the
    reference calls.  Here a rank holds its shards explicitly, so a hint has
    nothing to act on: ``x`` is returned as it is."""
    return x


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over."""
    out: List[str] = []
    for part in spec:
        out.extend((part,) if isinstance(part, str) else part or ())
    return tuple(out)


def _cuts(spec: Spec, mesh, coord) -> List[Tuple[int, int, int]]:
    """``(dim, chunks, this rank's chunk)`` of each sharded dim."""
    out = []
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = mesh.axes_in_order(part)
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + coord[a]
        out.append((d, mesh.axis_size(axes), i))
    return out


def shard_tensor(full: torch.Tensor, spec: Spec, mesh, coord: Optional[Dict[str, int]] = None
                 ) -> torch.Tensor:
    """The chunk of ``full`` that the rank at ``coord`` (the bound mesh's own
    by default) holds: a view."""
    out = full
    for d, n, i in _cuts(spec, mesh, mesh.coord if coord is None else coord):
        step = full.shape[d] // n
        out = out.narrow(d, i * step, step)
    return out


def gather_tensor(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's chunk (no autograd); ``local``
    itself where the spec cuts nothing."""
    out = local
    for d, part in enumerate(spec):
        if part is not None:
            out = raw_all_gather(out, mesh, part, d)
    return out


def shard_params(model, mesh, rules: ShardingRules = DEFAULT_RULES) -> List[str]:
    """Keep this rank's slice of every parameter of ``model`` (from the full
    values it holds), and bind the model to ``mesh``; returns the fallback
    log.  Every rank must hold the same full values: draw them from the same
    seeded generator (``Model.init`` does so again after binding)."""
    specs, fallbacks = param_shardings(model.param_specs(), mesh, rules)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = shard_tensor(p.data, specs[name], mesh).clone()
    model.bind_mesh(mesh, specs)
    return fallbacks


def gather_params(model) -> Dict[str, torch.Tensor]:
    """``{name: whole tensor}`` of a sharded model, on every rank."""
    return {name: gather_tensor(p.detach(), model.shardings[name], model.mesh)
            for name, p in model.named_parameters()}


def use_full(t: torch.Tensor, spec: Spec, mesh, sum_over=()) -> torch.Tensor:
    """The whole tensor for a compute that needs it (see the module's doc):
    gathered over each sharded dim, the gradient summed over the batch axes
    in ``spec`` and over ``sum_over``."""
    for d, part in enumerate(spec):
        if part is not None:
            t = gather(t, mesh, part, d)
    partial = [a for a in spec_axes(spec) if a in mesh.batch_axes]
    return copy_in(t, mesh, mesh.axes_in_order(partial + list(mesh.axes_in_order(sum_over))))


def use_params(p, specs: Dict[str, Spec], mesh, sum_over=()) -> Dict[str, torch.Tensor]:
    """:func:`use_full` of every tensor of a block's parameter dict."""
    return {k: use_full(v, specs.get(k, ()), mesh, sum_over) for k, v in p.items()}
