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
every rank saw other rows, and ``sum_over``); a dim gathered over axes of
``sum_over`` takes both as one reduce-scatter.

A served batch's rows and caches are placed by :func:`rows_spec` and
:func:`cache_leaf_spec`, the rules of the reference's ``_cache_leaf_spec``
(``repro/launch/specs.py``) with four deviations that follow from what the
port computes, each named where it applies (:data:`CACHE_DEVIATIONS`).
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
    "rows_spec",
    "cache_leaf_spec",
    "CACHE_DEVIATIONS",
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
    in ``spec`` and over ``sum_over``; a dim gathered over axes of
    ``sum_over`` alone takes that sum as one reduce-scatter."""
    sum_over = mesh.axes_in_order(sum_over)
    for d, part in enumerate(spec):
        if part is not None:
            partial = set(mesh.axes_in_order(part)) <= set(sum_over)
            t = gather(t, mesh, part, d, partial=partial)
            if partial:
                sum_over = tuple(a for a in sum_over if a not in mesh.axes_in_order(part))
    partial = [a for a in spec_axes(spec) if a in mesh.batch_axes]
    return copy_in(t, mesh, mesh.axes_in_order(partial + list(sum_over)))


def use_params(p, specs: Dict[str, Spec], mesh, sum_over=()) -> Dict[str, torch.Tensor]:
    """:func:`use_full` of every tensor of a block's parameter dict."""
    return {k: use_full(v, specs.get(k, ()), mesh, sum_over) for k, v in p.items()}


# ---------------------------------------------------------------------------
# the placement of a served batch and its caches
# ---------------------------------------------------------------------------

CACHE_DEVIATIONS = {  # name: where the port's cache placement leaves the reference's
    "state_heads": "(a) a Mamba or mLSTM state is cut over model on its heads dim (1) where its "
                   "block is head-parallel, else by its rows alone: the reference cuts dim 2 of "
                   "a 4-D state (d_head, or C's value dim), dim 1 of a 3-D one and dim 1 over "
                   "data where the rows are not cut, cuts no head-parallel recurrence reads in "
                   "place",
    "kv_heads_read": "(b) head-parallel attention whose KV heads model does not divide: "
                     "the rank holds the KV heads its query heads read, as prefill "
                     "returns them; without head-parallel attention, every KV head",
    "pod_rows": "(c) the cache rows follow the token rows over the batch axes "
                "(pod, data), as batch_spec places them, and are not cut where those "
                "axes do not divide the batch",
    "conv_channels_read": "(d) a head-parallel Mamba block's conv window holds the x channels "
                          "of the rank's heads and all of B and C, as its prefill returns "
                          "them; the spec leaves the channels uncut",
}


def rows_spec(mesh, batch: int):
    """The spec entry of a served batch's rows: the mesh's batch axes of more
    than one rank where they divide ``batch``, else None (every rank holds
    every row: the sequence-parallel case)."""
    axes = tuple(a for a in mesh.batch_axes if mesh.shape[a] > 1)
    n = mesh.axis_size(axes)
    if n == 1 or batch % n:
        return None
    return axes[0] if len(axes) == 1 else axes


def _trim(parts) -> Spec:
    parts = list(parts)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def cache_leaf_spec(shape: Sequence[int], mesh, batch: int, role: str = "kv", *,
                    head_parallel: bool = True) -> Tuple[Spec, Tuple[str, ...]]:
    """``(spec, deviations)`` of one cache tensor of the global ``shape``.

    ``role``: "kv" (a GQA ``k`` / ``v`` ``[B, L, KV, hd]``), "latent" (MLA's
    ``c_kv`` / ``k_pe`` ``[B, L, r]``), "state" (a recurrent state whose dim
    1, if it has one past the rows, is its heads: a Mamba ``h``, an mLSTM
    ``C`` / ``n`` / ``m``, an sLSTM state ``[B, d]``) or "conv" (a Mamba
    block's conv window ``[B, K - 1, channels]``).  ``head_parallel`` says
    whether the block computes the rank's own heads (its attention's query
    heads, its Mamba or mLSTM heads).  The reference's rules: the rows over
    the batch axes where they divide them (:func:`rows_spec`); a 4-D cache's
    dim 2 over ``model`` where it divides; a 3-D one's dim 1 over ``model``
    where it divides; where the rows are not cut, dim 1 over ``data`` where
    it divides (``data`` wins over ``model``).  ``deviations`` names each
    :data:`CACHE_DEVIATIONS` entry where the port leaves those rules: (c)
    the rows placed over (pod, data); (a) a state cut past its rows only on
    its heads over ``model``; (b) a KV cache's heads left uncut where its
    attention is head-parallel and ``model`` does not divide them (the leaf
    holds the heads its rank reads on dim 2) or where it is not
    head-parallel and ``model`` would divide them; (d) a head-parallel conv
    window's channels (the leaf holds those its rank reads on dim 2).
    """
    dsz, msz = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
    parts: List = [None] * len(shape)
    devs = []
    if shape[0] == batch:
        parts[0] = rows_spec(mesh, batch)
        if mesh.shape.get("pod", 1) > 1 and (parts[0] is not None
                                             or (dsz > 1 and batch % dsz == 0)):
            devs.append("pod_rows")  # the reference cuts them over data alone
    if len(shape) >= 4 and msz > 1 and shape[2] % msz == 0:
        parts[2] = "model"
    elif len(shape) == 3 and msz > 1 and shape[1] % msz == 0:
        parts[1] = "model"
    if parts[0] is None and len(shape) >= 3 and dsz > 1 and shape[1] % dsz == 0:
        parts[1] = "data"
    if role in ("state", "conv"):
        past = [None] * (len(shape) - 1)
        if role == "state" and head_parallel and msz > 1 and len(shape) > 1:
            past[0] = "model"
        if parts[1:] != past:
            devs.append("state_heads")
        parts[1:] = past
        if role == "conv" and head_parallel and msz > 1:
            devs.append("conv_channels_read")
    elif role == "kv" and msz > 1 and (not head_parallel or shape[2] % msz):
        if head_parallel or parts[2] == "model":
            devs.append("kv_heads_read")
        parts[2] = None
    return _trim(parts), tuple(devs)
