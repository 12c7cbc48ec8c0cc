"""Collective capture: the bridge from the torch program to Eidola (port of
``repro/core/hlo_capture.py``).

The reference reads a step's collectives out of XLA's compiled HLO text.  The
port has no HLO: its exchanges are calls into ``distributed/collectives.py``,
made by the same Python code whether a rank runs in a world or is traced
alone.  :func:`capture_collectives` is its front end: within it, every
exchange this rank hands a buffer to is recorded, in order, as a
:class:`CollectiveOp` (``all_reduce`` -> all-reduce, ``all_gather`` ->
all-gather, ``all_to_all`` -> all-to-all, ``ring_shift`` ->
collective-permute), with the sizes the reference's parser gives an HLO op:
``result_bytes`` per device, ``operand_bytes`` from it as
``_operand_bytes`` has it, the group's size, the dtype in HLO's names, and
one field the reference drops, ``axes``: the mesh axes of the group.

A :class:`CaptureGroup` stands for a process group where there is no world:
``Mesh.bind_abstract`` hands them out, and the exchanges record what they
are given and return a result of the right shape and dtype without
exchanging anything (a copy; an all-gather ``[n, *shape]``).

``collective_bytes``, ``by_kind``, ``summarize`` and ``schedule_to_trace``
are the reference's, but that an op with ``axes`` is priced on them
(``Topology.collective_on``); one without keeps the reference's rule, the
first axis whose size equals the group's.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from .events import TraceBundle
from .memory import AddressMap
from .topology import Topology

__all__ = [
    "CollectiveOp",
    "CaptureGroup",
    "capture_collectives",
    "record",
    "collective_bytes",
    "by_kind",
    "summarize",
    "schedule_to_trace",
    "KINDS",
]

KINDS = {  # the port's exchange -> the HLO collective it is
    "all_reduce": "all-reduce",
    "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "all_to_all": "all-to-all",
    "ring_shift": "collective-permute",
}

_HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.int32: "s32", torch.float32: "f32",
    torch.int64: "s64", torch.float64: "f64",
}


@dataclass(frozen=True)
class CollectiveOp:
    kind: str                 # all-reduce | all-gather | reduce-scatter | all-to-all | ...
    result_bytes: int         # per-device result size
    operand_bytes: int        # per-device operand size (roofline numerator)
    group_size: int           # participants per replica group (1 if unknown)
    dtype: str = ""
    line: str = ""
    axes: Tuple[str, ...] = ()  # the mesh axes of the group; () where unknown


def _operand_bytes(kind: str, result_bytes: int, group_size: int) -> int:
    """Per-device operand size implied by the result size."""
    g = max(1, group_size)
    if kind == "all-gather":
        return result_bytes // g
    if kind == "reduce-scatter":
        return result_bytes * g
    return result_bytes


@dataclass(frozen=True)
class CaptureGroup:
    """A process group with no world behind it: the mesh ``axes`` it spans,
    its ``size`` and this rank's index ``rank`` in it."""

    axes: Tuple[str, ...]
    size: int
    rank: int


_SINKS: List[List[CollectiveOp]] = []


@contextlib.contextmanager
def capture_collectives() -> Iterator[List[CollectiveOp]]:
    """Within it, the list it yields receives a :class:`CollectiveOp` for each
    exchange this rank hands a buffer to, in order (nested captures each
    receive every op)."""
    ops: List[CollectiveOp] = []
    _SINKS.append(ops)
    try:
        yield ops
    finally:
        _SINKS.remove(ops)


def record(name: str, sent: torch.Tensor, group_size: int, axes: Tuple[str, ...]) -> None:
    """Record that this rank hands ``sent`` to exchange ``name`` (a key of
    :data:`KINDS`) over a group of ``group_size`` ranks spanning ``axes``."""
    if not _SINKS:
        return
    kind = KINDS[name]
    nbytes = sent.numel() * sent.element_size()
    result = {"all-gather": nbytes * group_size,
              "reduce-scatter": nbytes // max(1, group_size)}.get(kind, nbytes)
    dtype = _HLO_DTYPE.get(sent.dtype, str(sent.dtype))
    op = CollectiveOp(kind=kind, result_bytes=result,
                      operand_bytes=_operand_bytes(kind, result, group_size),
                      group_size=group_size, dtype=dtype,
                      line=f"{name} {dtype}{list(sent.shape)} over {','.join(axes) or '?'}",
                      axes=tuple(axes))
    for sink in _SINKS:
        sink.append(op)


def collective_bytes(ops: Sequence[CollectiveOp]) -> int:
    """Roofline numerator: sum of per-device operand sizes of cross-device
    collectives (group_size 1 ops move no bytes)."""
    return sum(o.operand_bytes for o in ops if o.group_size != 1)


def by_kind(ops: Sequence[CollectiveOp]) -> Dict[str, Tuple[int, int]]:
    out: Dict[str, Tuple[int, int]] = {}
    for o in ops:
        c, b = out.get(o.kind, (0, 0))
        out[o.kind] = (c + 1, b + o.operand_bytes)
    return out


def summarize(ops: Sequence[CollectiveOp]) -> str:
    rows = [f"{k}: n={c} bytes={b:,}" for k, (c, b) in sorted(by_kind(ops).items())]
    rows.append(f"TOTAL collective bytes (operand sum): {collective_bytes(ops):,}")
    return "\n".join(rows)


def op_cost(op: CollectiveOp, topo: Topology,
            axis_for_group: Optional[Dict[int, str]] = None):
    """The cost of one op on ``topo``: on its ``axes`` where it names axes the
    topology has, else on the reference's axis (``axis_for_group``'s, or the
    last, replaced by the first axis whose size equals the group's)."""
    if op.axes and all(a in topo.axis_names for a in op.axes):
        return topo.collective_on(op.kind, op.operand_bytes, op.axes)
    axis = (axis_for_group or {}).get(op.group_size, topo.axis_names[-1])
    for name, size in zip(topo.axis_names, topo.axis_sizes):
        if size == op.group_size:
            axis = name
            break
    return topo.collective(op.kind, op.operand_bytes, axis)


def schedule_to_trace(
    ops: Sequence[CollectiveOp],
    topo: Topology,
    *,
    axis_for_group: Optional[Dict[int, str]] = None,
    compute_gap_ns: float = 0.0,
    n_egpu_peers: int = 3,
) -> TraceBundle:
    """Lower a collective schedule into eidolon semaphore-write traces.

    Each collective contributes its ring-step completion times; step ``i``'s
    completion is one 8-byte flag write from peer ``1 + i % n_egpu_peers``,
    then the collective's own flag; ``compute_gap_ns`` is the compute time
    put before each collective.  A closing barrier has every peer signal its
    flag.  The reference's ``schedule_to_trace``, the ops priced by
    :func:`op_cost`.
    """
    amap = AddressMap(n_devices=n_egpu_peers + 1)
    bundle = TraceBundle(
        meta={
            "pattern": "hlo_capture",
            "n_collectives": len(ops),
            "topology": topo.describe(),
        }
    )
    t_ns = 0.0
    for i, op in enumerate(ops):
        if op.group_size == 1:
            continue
        cost = op_cost(op, topo, axis_for_group)
        t_ns += compute_gap_ns
        for j, arr_s in enumerate(cost.arrival_times_s(t_ns * 1e-9)):
            src = 1 + (j % n_egpu_peers)
            bundle.add(
                wakeup_ns=arr_s * 1e9,
                addr=amap.partial_base + 64 * ((i * 64 + j) % 65536),
                data=j,
                size=8,
                src=src,
            )
        t_ns = cost.arrival_times_s(t_ns * 1e-9)[-1] * 1e9
        # final completion: the collective's semaphore flag
        bundle.add(
            wakeup_ns=t_ns,
            addr=amap.flag_addr(1 + (i % n_egpu_peers)),
            data=1,
            size=8,
            src=1 + (i % n_egpu_peers),
        )
    # end-of-step barrier: every peer signals its flag
    for g in range(1, n_egpu_peers + 1):
        bundle.add(wakeup_ns=t_ns, addr=amap.flag_addr(g), data=1, size=8, src=g)
    return bundle
