"""Interconnect topology and the collective-cost algebra (port of
``CollectiveCost`` and ``Topology`` in ``repro/core/topology.py``).

A copy of the reference's: each mesh axis rides one fabric, the intra-node
tier (ICI on a TPU pod, NVLink on ``H100_SXM``) or, for the axes in
``dci_axes``, the inter-node one (DCI; InfiniBand); a collective along an
axis is priced with bidirectional-ring algebra, and its ring steps' completion
times are the arrival schedule that ``core/capture.py`` lowers to flag
writes.  ``FabricModel`` (the closed-loop per-message router) is not copied:
the capture bridge does not use it.

The port adds :meth:`Topology.collective_on`, which prices a collective over
the mesh axes a captured op names: one axis as :meth:`Topology.collective`
does, several as one ring over the product of their sizes on the slowest of
their fabrics.  ``describe`` names the tiers as the hardware spec does
("(DCI)" for ``V5E``, as the reference prints it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .interconnect import V5E, HardwareSpec

__all__ = ["HardwareSpec", "Topology", "CollectiveCost", "V5E"]


@dataclass(frozen=True)
class CollectiveCost:
    kind: str
    bytes_in: int          # per-device operand bytes
    axis_size: int
    link_bytes: int        # bytes crossing the busiest link
    time_s: float
    steps: int             # ring steps (used for arrival schedules)

    def arrival_times_s(self, start_s: float = 0.0) -> List[float]:
        """Completion time of each ring step (semaphore-write schedule)."""
        if self.steps <= 0:
            return [start_s]
        dt = self.time_s / self.steps
        return [start_s + dt * (i + 1) for i in range(self.steps)]


def _ring_cost(kind: str, bytes_in: int, k: int, bw: float, lat: float) -> CollectiveCost:
    """The reference's bidirectional-ring algebra for a ring of ``k`` chips."""
    if k <= 1:
        return CollectiveCost(kind, bytes_in, k, 0, 0.0, 0)
    if kind == "all-reduce":
        # reduce-scatter + all-gather, 2(k-1) steps of bytes/k
        link = 2 * bytes_in * (k - 1) // k
        steps = 2 * (k - 1)
    elif kind == "all-gather":
        link = bytes_in * (k - 1)
        steps = k - 1
    elif kind == "reduce-scatter":
        link = bytes_in * (k - 1) // k
        steps = k - 1
    elif kind == "all-to-all":
        link = bytes_in * (k - 1) // k
        steps = k - 1
    elif kind == "collective-permute":
        link = bytes_in
        steps = 1
    else:
        raise ValueError(f"unknown collective kind {kind!r}")
    time = link / bw + steps * lat
    return CollectiveCost(kind, bytes_in, k, link, time, steps)


@dataclass(frozen=True)
class Topology:
    """A mesh of chips with per-axis fabric characteristics."""

    axis_sizes: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")
    hw: HardwareSpec = V5E
    # axes routed over the inter-node fabric rather than the intra-node tier
    dci_axes: Tuple[str, ...] = ("pod",)

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError("axis_sizes and axis_names length mismatch")

    @property
    def n_chips(self) -> int:
        return math.prod(self.axis_sizes)

    def axis_size(self, name: str) -> int:
        return self.axis_sizes[self.axis_names.index(name)]

    def _fabric(self, axis: str) -> Tuple[float, float]:
        if axis in self.dci_axes:
            return self.hw.dci_link_bw, self.hw.dci_hop_latency_s
        return (
            self.hw.ici_link_bw * self.hw.ici_links_per_axis,
            self.hw.ici_hop_latency_s,
        )

    def collective(self, kind: str, bytes_in: int, axis: str) -> CollectiveCost:
        """Cost of one collective of per-device operand size ``bytes_in``.

        bytes_in semantics per kind (per device):
          all-reduce      : the full reduced tensor's shard held per device
          all-gather      : the local shard that gets gathered
          reduce-scatter  : the full input that gets reduce-scattered
          all-to-all      : the full local buffer exchanged
          collective-permute : the buffer shifted to the neighbour
        """
        bw, lat = self._fabric(axis)
        return _ring_cost(kind, bytes_in, self.axis_size(axis), bw, lat)

    def collective_on(self, kind: str, bytes_in: int, axes: Sequence[str]) -> CollectiveCost:
        """:meth:`collective` over a group spanning ``axes``: one axis as
        there, several as one ring over their chips at the slowest of their
        fabrics (the lowest bandwidth, the longest hop)."""
        axes = tuple(axes)
        if len(axes) == 1:
            return self.collective(kind, bytes_in, axes[0])
        fabrics = [self._fabric(a) for a in axes]
        k = math.prod(self.axis_size(a) for a in axes)
        return _ring_cost(kind, bytes_in, k, min(bw for bw, _ in fabrics),
                          max(lat for _, lat in fabrics))

    def flat_collective_seconds(self, total_bytes: int, axis: Optional[str] = None) -> float:
        """The assignment's flat roofline collective term:
        collective_bytes / link_bw (per chip)."""
        bw, _ = self._fabric(axis or self.axis_names[-1])
        return total_bytes / bw

    def describe(self) -> str:
        axes = ", ".join(
            f"{n}={s}{f' ({self.hw.dci_name})' if n in self.dci_axes else ''}"
            for n, s in zip(self.axis_names, self.axis_sizes)
        )
        return f"<Topology {self.n_chips} chips: {axes}; {self.hw.name}>"
