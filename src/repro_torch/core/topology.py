"""Interconnect topology, the collective-cost algebra and the closed loop's
fabric model (port of ``repro/core/topology.py``).

A copy of the reference's: each mesh axis rides one fabric, the intra-node
tier (ICI on a TPU pod, NVLink on ``H100_SXM``) or, for the axes in
``dci_axes``, the inter-node one (DCI; InfiniBand); a collective along an
axis is priced with bidirectional-ring algebra, and its ring steps' completion
times are the arrival schedule that ``core/capture.py`` lowers to flag
writes.

:class:`FabricModel` is the closed-loop counterpart, a copy of the
reference's: per-message routing over a fabric described by an
:class:`repro_torch.core.interconnect.InterconnectSpec`, with typed link
classes, egress ports that keep their own serialization and contention state,
and a routing policy whose per-pair legs are memoized into a route table.
``Topology.flat_ring`` / ``two_tier`` / ``for_devices`` make tier
participation explicit, and ``FabricModel.from_topology`` derives the
closed-loop shape from them (the ``ring`` / ``two_tier`` presets).  The model
is host state on numpy, as the reference's is; its ``transfer_batch`` adds
each port's chain with ``np.cumsum``, in the reference's order.

The port adds :meth:`Topology.collective_on`, which prices a collective over
the mesh axes a captured op names: one axis as :meth:`Topology.collective`
does, several as one ring over the product of their sizes on the slowest of
their fabrics.  ``describe`` names the tiers as the hardware spec does
("(DCI)" for ``V5E``, as the reference prints it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .interconnect import (
    V5E,
    FabricLike,
    HardwareSpec,
    InterconnectSpec,
    Leg,
    _ring_route,
    build_fabric,
    resolve_fabric,
)

__all__ = ["HardwareSpec", "Topology", "CollectiveCost", "FabricModel", "V5E"]


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

    @property
    def devices_per_node(self) -> int:
        """Chips reachable over the intra-node (ICI) tier: the product of
        every axis NOT routed over the DCI fabric."""
        out = 1
        for n, s in zip(self.axis_names, self.axis_sizes):
            if n not in self.dci_axes:
                out *= s
        return out

    @property
    def n_nodes(self) -> int:
        """Number of nodes (DCI endpoints): the product of the DCI axes."""
        out = 1
        for n, s in zip(self.axis_names, self.axis_sizes):
            if n in self.dci_axes:
                out *= s
        return out

    def axis_size(self, name: str) -> int:
        return self.axis_sizes[self.axis_names.index(name)]

    # ------------------------------------------------------------------
    # tier-explicit constructors (scenarios use these instead of spelling
    # out dci_axes, so tier participation is always intentional)
    # ------------------------------------------------------------------

    @classmethod
    def flat_ring(cls, n: int, axis: str = "ring", hw: HardwareSpec = V5E) -> "Topology":
        """A single-tier ring of ``n`` chips: every hop is intra-node ICI."""
        if n < 1:
            raise ValueError("flat_ring needs at least 1 chip")
        return cls(axis_sizes=(n,), axis_names=(axis,), hw=hw, dci_axes=())

    @classmethod
    def two_tier(
        cls,
        n_nodes: int,
        devices_per_node: int,
        hw: HardwareSpec = V5E,
        *,
        intra_axis: str = "ici",
        inter_axis: str = "dcn",
    ) -> "Topology":
        """``n_nodes`` nodes of ``devices_per_node`` chips each: the intra
        axis rides ICI, the inter axis rides the DCI fabric."""
        if n_nodes < 1 or devices_per_node < 1:
            raise ValueError("n_nodes and devices_per_node must be >= 1")
        return cls(
            axis_sizes=(n_nodes, devices_per_node),
            axis_names=(inter_axis, intra_axis),
            hw=hw,
            dci_axes=(inter_axis,),
        )

    @classmethod
    def for_devices(
        cls,
        n_devices: int,
        devices_per_node: Optional[int] = None,
        hw: HardwareSpec = V5E,
        *,
        intra_axis: str = "ici",
        inter_axis: str = "dcn",
    ) -> "Topology":
        """The closed-loop shape knob: ``devices_per_node=None`` (or >= the
        device count) is the flat single-tier ring; anything smaller groups
        the devices into nodes with a DCI tier between them."""
        if devices_per_node is None or devices_per_node >= n_devices:
            return cls.flat_ring(n_devices, axis=intra_axis, hw=hw)
        if devices_per_node < 1 or n_devices % devices_per_node:
            raise ValueError(
                f"devices_per_node={devices_per_node} must divide "
                f"n_devices={n_devices}"
            )
        return cls.two_tier(
            n_devices // devices_per_node,
            devices_per_node,
            hw,
            intra_axis=intra_axis,
            inter_axis=inter_axis,
        )

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


class FabricModel:
    """Per-message routing over a pluggable fabric, with per-port contention.

    This is the closed-loop counterpart of :meth:`Topology.collective`: instead
    of pricing a whole collective in closed form, it prices *one xGMI write
    burst* from ``src`` to ``dst`` at a concrete issue time, so the
    :class:`repro_torch.core.cluster.Cluster` can register the write into the
    destination device's WTT at a physically-derived arrival time.

    The fabric's *shape* is an :class:`repro_torch.core.interconnect.InterconnectSpec`:
    typed link classes, declared egress ports, and a routing policy whose
    per-pair legs are memoized into a route table (computed once per pair,
    never per message).  Pricing one message walks its legs — per leg:

    * store-and-forward serialization of the burst on the leg's egress port
      (``bytes / class_bw``), FIFO behind the port's previous burst
      (contention: back-to-back emissions queue up per port);
    * shortest-path hop count x the link class's hop latency.

    ``stats`` counts messages/bytes/queueing in total and per link class
    (``ici_*`` / ``dci_*`` / ``spine_*`` / ``rail_*`` / ...), and
    ``port_stats`` holds the same triple per egress port (the per-port sums
    equal the per-class sums — a tested invariant).

    The legacy constructor knobs build the ``ring`` / ``two_tier`` presets,
    bit-identical to the original hard-coded router: with one node
    (``devices_per_node >= n_devices``, the default when built from a device
    count) every message takes a single same-ring leg and the model is
    bit-for-bit the old flat ring.

    All state updates are deterministic in emission order, which both engines
    reproduce identically (writes before transitions, devices in id order), so
    cycle/event runs stay bit-identical.
    """

    def __init__(
        self,
        n_devices: Optional[int] = None,
        hw: HardwareSpec = V5E,
        *,
        devices_per_node: Optional[int] = None,
        hop_latency_ns: Optional[float] = None,
        link_bw_bytes_per_ns: Optional[float] = None,
        dci_hop_latency_ns: Optional[float] = None,
        dci_link_bw_bytes_per_ns: Optional[float] = None,
        spec: Optional[InterconnectSpec] = None,
    ):
        if isinstance(n_devices, InterconnectSpec):
            if spec is not None:
                raise ValueError("pass the spec once, not twice")
            spec, n_devices = n_devices, None
        if spec is None:
            if n_devices is None:
                raise ValueError("FabricModel needs n_devices or a spec")
            if n_devices < 2:
                raise ValueError("a fabric needs at least 2 devices")
            n_devices = int(n_devices)
            if devices_per_node is None or devices_per_node >= n_devices:
                devices_per_node = n_devices
            if devices_per_node < 1 or n_devices % devices_per_node:
                raise ValueError(
                    f"devices_per_node={devices_per_node} must divide "
                    f"n_devices={n_devices}"
                )
            link_bw: Dict[str, float] = {}
            link_lat: Dict[str, float] = {}
            if link_bw_bytes_per_ns is not None:
                link_bw["ici"] = float(link_bw_bytes_per_ns)
            if hop_latency_ns is not None:
                link_lat["ici"] = float(hop_latency_ns)
            if dci_link_bw_bytes_per_ns is not None:
                link_bw["dci"] = float(dci_link_bw_bytes_per_ns)
            if dci_hop_latency_ns is not None:
                link_lat["dci"] = float(dci_hop_latency_ns)
            spec = build_fabric(
                "two_tier" if devices_per_node < n_devices else "ring",
                n_devices,
                hw,
                devices_per_node=devices_per_node,
                link_bw=link_bw,
                link_latency_ns=link_lat,
            )
        elif n_devices is not None and int(n_devices) != spec.n_devices:
            raise ValueError(
                f"n_devices={n_devices} contradicts spec.n_devices="
                f"{spec.n_devices}"
            )
        self.spec = spec
        self.hw = hw
        self.n_devices = spec.n_devices
        self.devices_per_node = spec.devices_per_node
        self.n_nodes = spec.n_nodes
        # (bw_bytes_per_ns, hop_latency_ns) per link class, resolved once
        self._cls: Dict[str, Tuple[float, float]] = {
            name: (lc.bw_bytes_per_ns, lc.hop_latency_ns)
            for name, lc in spec.link_classes.items()
        }
        # memoized per-pair leg table (the RoutingPolicy runs once per pair)
        self._leg_table: Dict[Tuple[int, int], Tuple[Leg, ...]] = {}
        # egress port -> ns at which the port frees up
        self._busy_until_ns: Dict[Tuple, float] = {}
        self.stats = self._fresh_stats()
        # egress port -> [messages, bytes, queued_ns]
        self.port_stats: Dict[Tuple, List[float]] = self._fresh_port_stats()

    @classmethod
    def from_spec(cls, spec: InterconnectSpec) -> "FabricModel":
        """The fabric an :class:`InterconnectSpec` describes, verbatim."""
        return cls(spec=spec)

    @classmethod
    def from_topology(
        cls,
        topo: Topology,
        *,
        fabric: FabricLike = None,
        link_bw: Optional[Dict[str, float]] = None,
        link_latency_ns: Optional[Dict[str, float]] = None,
        **overrides,
    ) -> "FabricModel":
        """The closed-loop fabric a :class:`Topology` describes: its non-DCI
        axes collapse into the intra-node tier, its DCI axes into the
        inter-node tier (the ``ring``/``two_tier`` presets), with
        bandwidths/latencies from ``topo.hw``.

        ``fabric`` selects a different registered preset (or passes a
        ready-built spec); ``link_bw``/``link_latency_ns`` override per link
        *class* (bytes/ns == GB/s, and ns) — unknown class names raise an
        error listing the fabric's valid classes.  The legacy scalar keywords
        (``hop_latency_ns`` etc.) keep working as ici/dci aliases; anything
        else is rejected rather than silently ignored."""
        link_bw = dict(link_bw or {})
        link_latency_ns = dict(link_latency_ns or {})
        legacy = {
            "link_bw_bytes_per_ns": (link_bw, "ici"),
            "dci_link_bw_bytes_per_ns": (link_bw, "dci"),
            "hop_latency_ns": (link_latency_ns, "ici"),
            "dci_hop_latency_ns": (link_latency_ns, "dci"),
        }
        for key, val in overrides.items():
            if key not in legacy:
                raise ValueError(
                    f"unknown FabricModel override {key!r}; pass per-class "
                    "overrides via link_bw=/link_latency_ns= (valid keys: "
                    f"{sorted(legacy)})"
                )
            if val is not None:
                target, cls_name = legacy[key]
                target.setdefault(cls_name, float(val))
        spec = resolve_fabric(
            fabric,
            topo.n_chips,
            topo.hw,
            devices_per_node=topo.devices_per_node,
            link_bw=link_bw,
            link_latency_ns=link_latency_ns,
        )
        if spec is not None:
            return cls(spec=spec)
        return cls(
            topo.n_chips, topo.hw, devices_per_node=topo.devices_per_node
        )

    def _fresh_stats(self) -> Dict[str, float]:
        st: Dict[str, float] = {"messages": 0, "bytes": 0, "queued_ns": 0.0}
        # per-class leg counters (a multi-leg message counts one leg per
        # class it traverses; totals above count each message once), in
        # sorted class order so stats dicts diff stably across runs
        for name in sorted(self.spec.link_classes):
            st[name + "_messages"] = 0
            st[name + "_bytes"] = 0
            st[name + "_queued_ns"] = 0.0
        return st

    def _fresh_port_stats(self) -> Dict[Tuple, List[float]]:
        # every declared egress port pre-seeded at zero, in deterministic
        # order (port keys mix ints and strs, so sort by repr); ports a
        # routing policy synthesizes outside the declaration still appear on
        # first touch, after the declared block
        return {p: [0, 0, 0.0] for p in sorted(self.spec.ports, key=repr)}

    def reset(self) -> None:
        self._busy_until_ns.clear()
        self.stats = self._fresh_stats()
        self.port_stats = self._fresh_port_stats()

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def _check(self, src: int, dst: int) -> None:
        n = self.n_devices
        if src == dst or not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"bad route {src} -> {dst} on {n}-device fabric")

    def node_of(self, device: int) -> int:
        return device // self.devices_per_node

    def legs(self, src: int, dst: int) -> Tuple[Leg, ...]:
        """The routed path of one device pair, from the memoized per-pair
        table (the :class:`RoutingPolicy` runs once per pair)."""
        self._check(src, dst)
        key = (src, dst)
        legs = self._leg_table.get(key)
        if legs is None:
            legs = tuple(self.spec.routing.legs(self.spec, src, dst))
            self._leg_table[key] = legs
        return legs

    def route_table(self) -> Dict[Tuple[int, int], Tuple[Leg, ...]]:
        """Materialize (and return) the full per-pair leg table."""
        n = self.n_devices
        for src in range(n):
            for dst in range(n):
                if src != dst:
                    self.legs(src, dst)
        return dict(self._leg_table)

    def route(self, src: int, dst: int) -> Tuple[int, int]:
        """(hops, direction) of the shortest same-ring path; +1 = ascending.

        Valid for same-node pairs (the intra ring; with one node that is every
        pair, matching the old flat model).  Cross-node pairs take a composed
        multi-leg path — see :meth:`route_legs`.
        """
        self._check(src, dst)
        dpn = self.devices_per_node
        sn, sl = divmod(src, dpn)
        dn, dl = divmod(dst, dpn)
        if sn != dn:
            raise ValueError(
                f"route {src} -> {dst} crosses nodes {sn} -> {dn}; composed "
                "paths are described by route_legs()"
            )
        return _ring_route(sl, dl, dpn)

    def route_legs(self, src: int, dst: int) -> List[Tuple[str, Tuple, int]]:
        """The composed path as ``(link_class, egress_port, hops)`` legs.

        The legacy view of :meth:`legs` — e.g. on the ``two_tier`` preset a
        same-node pair is one ``("ici", (src, dir), hops)`` leg and a
        cross-node pair composes an optional intra leg to the source gateway,
        a ``("dci", ("dci", node, dir), hops)`` uplink leg between gateways,
        and an optional intra leg from the destination gateway (zero-hop legs
        are omitted).
        """
        return [(leg.cls, leg.port, leg.hops) for leg in self.legs(src, dst)]

    # ------------------------------------------------------------------
    # transfers
    # ------------------------------------------------------------------

    def _leg(
        self,
        tier: str,
        port: Tuple,
        nbytes: int,
        ready_ns: float,
        hops: int,
        bw: float,
        lat: float,
    ) -> float:
        """Serialize one burst on ``port`` (FIFO behind its previous burst)
        and propagate it ``hops`` hops; returns the leg's arrival time."""
        start = max(ready_ns, self._busy_until_ns.get(port, 0.0))
        ser_ns = nbytes / bw
        self._busy_until_ns[port] = start + ser_ns
        queued = start - ready_ns
        self.stats["queued_ns"] += queued
        self.stats[tier + "_messages"] += 1
        self.stats[tier + "_bytes"] += nbytes
        self.stats[tier + "_queued_ns"] += queued
        ps = self.port_stats.get(port)
        if ps is None:
            ps = self.port_stats[port] = [0, 0, 0.0]
        ps[0] += 1
        ps[1] += nbytes
        ps[2] += queued
        return start + ser_ns + hops * lat

    def transfer(self, src: int, dst: int, nbytes: int, issue_ns: float) -> float:
        """Arrival time (ns) of an ``nbytes`` burst issued at ``issue_ns``.

        Mutates the traversed egress ports' busy state (contention) and
        returns when the burst becomes *deliverable* at the destination
        directory.
        """
        nb = max(0, nbytes)
        legs = self.legs(src, dst)
        self.stats["messages"] += 1
        self.stats["bytes"] += nb
        t = issue_ns
        cls = self._cls
        for leg in legs:
            bw, lat = cls[leg.cls]
            t = self._leg(leg.cls, leg.port, nb, t, leg.hops, bw, lat)
        return t

    def transfer_batch(
        self,
        src: int,
        dsts: Sequence[int],
        nbytes: Sequence[int],
        issue_ns: float,
    ) -> List[float]:
        """Arrival times of ``len(dsts)`` bursts all issued by ``src`` at
        ``issue_ns`` — bit-identical to calling :meth:`transfer` once per
        destination in order, but priced per egress port in one vectorized
        pass.

        This is the ``all_to_all`` incast shape: a completing dispatch phase
        emits one burst to every peer at the same cycle, O(devices) messages
        per call and O(devices^2) per simulation, which per-message python
        routing made the closed-loop bottleneck.  Same-issue bursts on one
        egress port serialize back-to-back, so each port's queue is a prefix
        sum over its bursts' serialization times — computed here with one
        cumulative sum per port instead of a python transition per message.
        Batches with any multi-leg route fall back to the per-message path
        (their legs couple ports in issue order).
        """
        if len(dsts) != len(nbytes):
            raise ValueError("dsts and nbytes length mismatch")
        single = len(dsts) >= 16  # below that, numpy setup costs more
        if single:
            for d in dsts:
                if len(self.legs(src, d)) != 1:
                    single = False
                    break
        if not single:
            return [
                self.transfer(src, d, nb, issue_ns)
                for d, nb in zip(dsts, nbytes)
            ]
        import numpy as np

        arrivals = [0.0] * len(dsts)
        queued = [0.0] * len(dsts)
        # group by egress port, preserving per-port emission order
        by_port: Dict[Tuple, Tuple[str, List[int], List[int], List[int]]] = {}
        for i, (dst, nb) in enumerate(zip(dsts, nbytes)):
            (leg,) = self.legs(src, dst)
            entry = by_port.get(leg.port)
            if entry is None:
                entry = by_port[leg.port] = (leg.cls, [], [], [])
            _, idxs, hlist, blist = entry
            idxs.append(i)
            hlist.append(leg.hops)
            blist.append(max(0, nb))
        leg_cls = [None] * len(dsts)
        for port, (cname, idxs, hlist, blist) in by_port.items():
            bw, lat = self._cls[cname]
            b0 = self._busy_until_ns.get(port, 0.0)
            start0 = max(issue_ns, b0)
            # busy_k after burst k: start0 + ser_1 + ... + ser_k, accumulated
            # sequentially (np.cumsum) so each float add matches the loop
            chain = np.empty(len(idxs) + 1, dtype=np.float64)
            chain[0] = start0
            np.divide(blist, bw, out=chain[1:])
            busy = np.cumsum(chain)
            self._busy_until_ns[port] = float(busy[-1])
            ps = self.port_stats.get(port)
            if ps is None:
                ps = self.port_stats[port] = [0, 0, 0.0]
            # start of burst k is busy_{k-1}; arrival adds the hop latency
            for j, i in enumerate(idxs):
                arrivals[i] = float(busy[j + 1]) + hlist[j] * lat
                q = float(busy[j]) - issue_ns
                queued[i] = q
                leg_cls[i] = cname
                ps[0] += 1
                ps[1] += max(0, nbytes[i])
                ps[2] += q
        # totals accumulate in emission order, matching the sequential path's
        # float-add sequence exactly
        st = self.stats
        for i, nb in enumerate(nbytes):
            nb = max(0, nb)
            cname = leg_cls[i]
            st["messages"] += 1
            st["bytes"] += nb
            st["queued_ns"] += queued[i]
            st[cname + "_messages"] += 1
            st[cname + "_bytes"] += nb
            st[cname + "_queued_ns"] += queued[i]
        return arrivals
