"""Hardware presets and the graph-based interconnect API: fabric topologies
as data (port of ``repro/core/interconnect.py``).

:class:`HardwareSpec` and :data:`V5E` are copies of the reference's (the TPU
v5e constants its roofline is written for).  :data:`H100_SXM` is the port's
own preset, one NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU
data sheet (SXM5 column):

- ``peak_flops_bf16`` 989 TFLOP/s: BF16 Tensor Core, dense (the sheet's
  1,979 is with sparsity);
- ``hbm_bw`` 3.35 TB/s and ``hbm_bytes`` 80 GB (HBM3; taken as GiB, as
  ``V5E``'s 16 is);
- the intra-node tier (the ``ici_*`` fields) is NVLink 4: 900 GB/s a GPU,
  18 links of 25 GB/s in each direction, all of which a ring through the
  NVSwitches can use (``ici_links_per_axis`` 18), in an 8-GPU HGX/DGX node;
- the inter-node tier (the ``dci_*`` fields) is NDR InfiniBand, 400 Gb/s:
  one ConnectX-7 a GPU in a DGX H100, 50 GB/s in each direction.

The sheet gives no hop latency: ``ici_hop_latency_s`` (1 µs) and
``dci_hop_latency_s`` (5 µs) are assumptions, not measurements.  ``vmem_bytes``
(the TPU's VMEM) has no H100 counterpart; the port puts the 228 KB of shared
memory an SM has there, and nothing in the port reads the field.
``dci_name`` (the port's addition) names the inter-node tier in
``Topology.describe``.

The closed loop's fabric gallery is a copy of the reference's:

* :class:`LinkClass` — a typed link: name, bandwidth (bytes/ns) and per-hop
  latency (ns); :class:`repro_torch.core.topology.FabricModel` counts
  messages, bytes and queueing per class.
* **Ports** — egress-serialization points: each burst crossing a port
  serializes at its class's bandwidth, FIFO behind the port's previous burst
  (contention and oversubscription live here).
* :class:`Leg` — one store-and-forward step of a routed path: its egress
  port, hop count and graph endpoints.
* :class:`RoutingPolicy` — ``legs(spec, src, dst)`` gives the composed path;
  the fabric model memoizes it per pair.
* :class:`InterconnectSpec` — the whole fabric as one value: device/node
  shape, link classes, declared ports and routing policy.
* the preset registry (:func:`register_fabric` / :func:`get_fabric` /
  :func:`list_fabrics` / :func:`build_fabric` / :func:`resolve_fabric`) with
  ``ring``, ``two_tier``, ``fat_tree`` (configurable oversubscription),
  ``rail_optimized`` (k NICs a node, rail-aligned cross-node paths) and
  ``torus2d``.

The closed-loop scenarios build their fabrics from ``V5E`` by default, as the
reference's do, so that their counters are the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

__all__ = [
    "HardwareSpec",
    "V5E",
    "H100_SXM",
    "HARDWARE",
    "NVLINK_NODE_GPUS",
    "LinkClass",
    "Leg",
    "RoutingPolicy",
    "InterconnectSpec",
    "register_fabric",
    "get_fabric",
    "list_fabrics",
    "build_fabric",
    "resolve_fabric",
    "FabricLike",
]


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12     # per chip
    hbm_bw: float = 819e9               # bytes/s per chip
    ici_link_bw: float = 50e9           # bytes/s per link per direction
    ici_links_per_axis: int = 1         # links a ring along one axis can use
    ici_hop_latency_s: float = 1e-6
    dci_link_bw: float = 12.5e9         # inter-pod (pod axis) bandwidth
    dci_hop_latency_s: float = 10e-6
    vmem_bytes: int = 128 * 1024 * 1024
    hbm_bytes: int = 16 * 1024**3
    dci_name: str = "DCI"


V5E = HardwareSpec()

H100_SXM = HardwareSpec(
    name="h100-sxm5",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_link_bw=25e9,
    ici_links_per_axis=18,
    ici_hop_latency_s=1e-6,      # assumption: the data sheet gives none
    dci_link_bw=50e9,
    dci_hop_latency_s=5e-6,      # assumption: the data sheet gives none
    vmem_bytes=228 * 1024,       # shared memory an SM; read by nothing
    hbm_bytes=80 * 1024**3,
    dci_name="IB",
)

NVLINK_NODE_GPUS = 8  # GPUs an HGX / DGX H100 node joins over NVLink

HARDWARE = {"h100": H100_SXM, "v5e": V5E}


# ---------------------------------------------------------------------------
# typed links, ports, legs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkClass:
    """One class of link: every port of this class serializes at
    ``bw_bytes_per_ns`` and propagates at ``hop_latency_ns`` per hop."""

    name: str
    bw_bytes_per_ns: float
    hop_latency_ns: float

    def __post_init__(self) -> None:
        if self.bw_bytes_per_ns <= 0:
            raise ValueError(
                f"link class {self.name!r} bandwidth must be > 0"
            )
        if self.hop_latency_ns < 0:
            raise ValueError(
                f"link class {self.name!r} hop latency must be >= 0"
            )


# Graph endpoints are labelled tuples: ("dev", i) for a device, ("leaf", l)
# for a fat-tree leaf switch, ... — only routing-invariant tests interpret
# them; the pricing engine ignores them entirely.
Endpoint = Tuple

PortKey = Tuple


@dataclass(frozen=True)
class Leg:
    """One store-and-forward step of a routed path.

    cls   link class the leg rides (keys ``InterconnectSpec.link_classes``).
    port  egress port the burst serializes on (FIFO behind prior bursts).
    hops  number of hops the burst propagates after serializing (>= 1).
    src   graph endpoint the leg leaves from (e.g. ``("dev", 3)``).
    dst   graph endpoint the leg arrives at.
    """

    cls: str
    port: PortKey
    hops: int
    src: Endpoint
    dst: Endpoint


class RoutingPolicy:
    """Protocol: compute the composed path of one (src, dst) device pair.

    Implementations must be *pure* (same legs for the same pair every call):
    the fabric model memoizes results into a per-pair leg table, so routing
    runs once per pair, never per message."""

    def legs(
        self, spec: "InterconnectSpec", src: int, dst: int
    ) -> Tuple[Leg, ...]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------


@dataclass
class InterconnectSpec:
    """A complete fabric: shape, typed links, declared ports, and routing.

    ``devices_per_node`` groups consecutive device ids into nodes (the unit
    that owns NICs); ``nics_per_node`` is how many independent egress NICs
    each node drives (>= 1; ``rail_optimized`` uses k).  ``link_classes``
    maps class name -> :class:`LinkClass`; ``ports`` maps every declared
    egress-port key -> its class name.  ``routing`` computes per-pair legs.

    Treat instances as immutable: derive variants with
    :meth:`with_link_overrides`.
    """

    name: str
    n_devices: int
    devices_per_node: int
    routing: RoutingPolicy
    link_classes: Dict[str, LinkClass]
    ports: Dict[PortKey, str]
    nics_per_node: int = 1
    params: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.n_devices < 2:
            raise ValueError("a fabric needs at least 2 devices")
        if self.devices_per_node < 1 or self.n_devices % self.devices_per_node:
            raise ValueError(
                f"devices_per_node={self.devices_per_node} must divide "
                f"n_devices={self.n_devices}"
            )
        if self.nics_per_node < 1:
            raise ValueError("every node needs at least 1 NIC")
        for port, cls in self.ports.items():
            if cls not in self.link_classes:
                raise ValueError(
                    f"port {port!r} declares unknown link class {cls!r}"
                )

    @property
    def n_nodes(self) -> int:
        return self.n_devices // self.devices_per_node

    def check_link_classes(self, names, *, what: str = "link override") -> None:
        """Raise an actionable error for any name not declared by this
        fabric (the ``--ici-bw``/``--dci-bw``/``--link`` validation path)."""
        for name in names:
            if name not in self.link_classes:
                raise ValueError(
                    f"unknown link class {name!r} in {what} for fabric "
                    f"{self.name!r}; valid classes: "
                    f"{sorted(self.link_classes)}"
                )

    def with_link_overrides(
        self,
        link_bw: Optional[Dict[str, float]] = None,
        link_latency_ns: Optional[Dict[str, float]] = None,
    ) -> "InterconnectSpec":
        """A copy with per-class bandwidth (bytes/ns == GB/s) and/or hop
        latency (ns) overridden.  Unknown class names raise, listing the
        fabric's valid classes."""
        link_bw = dict(link_bw or {})
        link_latency_ns = dict(link_latency_ns or {})
        if not link_bw and not link_latency_ns:
            return self
        self.check_link_classes(link_bw, what="link_bw override")
        self.check_link_classes(
            link_latency_ns, what="link_latency_ns override"
        )
        classes = {
            name: LinkClass(
                name,
                float(link_bw.get(name, lc.bw_bytes_per_ns)),
                float(link_latency_ns.get(name, lc.hop_latency_ns)),
            )
            for name, lc in self.link_classes.items()
        }
        return InterconnectSpec(
            name=self.name,
            n_devices=self.n_devices,
            devices_per_node=self.devices_per_node,
            routing=self.routing,
            link_classes=classes,
            ports=self.ports,
            nics_per_node=self.nics_per_node,
            params=dict(self.params),
        )

    def describe(self) -> str:
        cls = ", ".join(
            f"{c.name}={c.bw_bytes_per_ns:g}B/ns"
            for c in self.link_classes.values()
        )
        return (
            f"<InterconnectSpec {self.name}: {self.n_devices} devices, "
            f"{self.n_nodes} nodes x {self.devices_per_node}, "
            f"{self.nics_per_node} NIC/node; {cls}>"
        )


# ---------------------------------------------------------------------------
# shared routing helpers
# ---------------------------------------------------------------------------


def _ring_route(src: int, dst: int, n: int) -> Tuple[int, int]:
    """(hops, direction) of the shortest path on an ``n``-ring."""
    fwd = (dst - src) % n
    bwd = (src - dst) % n
    return (fwd, +1) if fwd <= bwd else (bwd, -1)


def _dev(i: int) -> Endpoint:
    return ("dev", i)


def _ici_leg(src_dev: int, dst_dev: int, local_src: int, local_dst: int,
             ring: int, port_dev: int) -> Leg:
    hops, d = _ring_route(local_src, local_dst, ring)
    return Leg("ici", (port_dev, d), hops, _dev(src_dev), _dev(dst_dev))


def _ici_ports(n_devices: int) -> Dict[PortKey, str]:
    ports: Dict[PortKey, str] = {}
    for dev in range(n_devices):
        ports[(dev, +1)] = "ici"
        ports[(dev, -1)] = "ici"
    return ports


# ---------------------------------------------------------------------------
# preset registry
# ---------------------------------------------------------------------------

FabricBuilder = Callable[..., InterconnectSpec]
_FABRICS: Dict[str, FabricBuilder] = {}


def register_fabric(name: str) -> Callable[[FabricBuilder], FabricBuilder]:
    """Decorator: register a fabric-spec builder under ``name``.

    Builders take ``(n_devices, hw=V5E, *, devices_per_node=None,
    **params)`` and return an :class:`InterconnectSpec`."""

    def deco(fn: FabricBuilder) -> FabricBuilder:
        existing = _FABRICS.get(name)
        if existing is not None and existing is not fn:
            raise ValueError(f"fabric preset {name!r} already registered")
        _FABRICS[name] = fn
        return fn

    return deco


def get_fabric(name: str) -> FabricBuilder:
    try:
        return _FABRICS[name]
    except KeyError:
        raise KeyError(
            f"unknown fabric preset {name!r}; available: {sorted(_FABRICS)}"
        ) from None


def list_fabrics() -> List[str]:
    return sorted(_FABRICS)


def build_fabric(
    name: str,
    n_devices: int,
    hw: HardwareSpec = V5E,
    *,
    devices_per_node: Optional[int] = None,
    link_bw: Optional[Dict[str, float]] = None,
    link_latency_ns: Optional[Dict[str, float]] = None,
    **params,
) -> InterconnectSpec:
    """Build a registered preset and apply per-class link overrides.

    ``link_bw`` values are bytes/ns, which is numerically GB/s — the CLI's
    ``--link dci=6.25`` maps straight through."""
    spec = get_fabric(name)(
        n_devices, hw, devices_per_node=devices_per_node, **params
    )
    return spec.with_link_overrides(link_bw, link_latency_ns)


FabricLike = Union[None, str, InterconnectSpec]


def resolve_fabric(
    fabric: FabricLike,
    n_devices: int,
    hw: HardwareSpec = V5E,
    *,
    devices_per_node: Optional[int] = None,
    link_bw: Optional[Dict[str, float]] = None,
    link_latency_ns: Optional[Dict[str, float]] = None,
    **params,
) -> Optional[InterconnectSpec]:
    """Resolve a scenario's ``fabric=`` argument to a spec (or ``None``).

    ``None`` with no link overrides returns ``None`` — the legacy path where
    the :class:`repro_torch.core.cluster.Cluster` derives a ``ring``/``two_tier``
    fabric from the scenario's :class:`repro_torch.core.topology.Topology`.  A
    string names a registered preset; a ready-built spec passes through
    (validated against the device count, with overrides applied)."""
    if isinstance(fabric, InterconnectSpec):
        if fabric.n_devices != n_devices:
            raise ValueError(
                f"fabric spec {fabric.name!r} models {fabric.n_devices} "
                f"devices but the scenario simulates {n_devices}"
            )
        return fabric.with_link_overrides(link_bw, link_latency_ns)
    if fabric is None:
        if not link_bw and not link_latency_ns:
            return None
        # overrides without a named preset apply to the default shape the
        # topology would have produced — through the validated path
        fabric = (
            "two_tier"
            if devices_per_node is not None and devices_per_node < n_devices
            else "ring"
        )
    return build_fabric(
        fabric,
        n_devices,
        hw,
        devices_per_node=devices_per_node,
        link_bw=link_bw,
        link_latency_ns=link_latency_ns,
        **params,
    )


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------


def _std_classes(hw: HardwareSpec) -> Dict[str, LinkClass]:
    """The legacy ici/dci class pair, numerically identical to the original
    hard-coded fabric constants."""
    return {
        "ici": LinkClass(
            "ici",
            hw.ici_link_bw * hw.ici_links_per_axis / 1e9,
            hw.ici_hop_latency_s * 1e9,
        ),
        "dci": LinkClass("dci", hw.dci_link_bw / 1e9, hw.dci_hop_latency_s * 1e9),
    }


class _RingRouting(RoutingPolicy):
    """Single bidirectional ring over all devices: one ICI leg per pair."""

    def legs(self, spec, src, dst):
        n = spec.n_devices
        hops, d = _ring_route(src, dst, n)
        return (Leg("ici", (src, d), hops, _dev(src), _dev(dst)),)


@register_fabric("ring")
def ring_spec(
    n_devices: int,
    hw: HardwareSpec = V5E,
    *,
    devices_per_node: Optional[int] = None,
) -> InterconnectSpec:
    """flat bidirectional ring; every hop is intra-node ICI (the classic
    single-tier fabric)"""
    # the ring has no node-boundary routing, but a requested node split is
    # honored as grouping metadata (node_of / report shape) rather than
    # silently flattened
    return InterconnectSpec(
        name="ring",
        n_devices=n_devices,
        devices_per_node=devices_per_node or n_devices,
        routing=_RingRouting(),
        link_classes=_std_classes(hw),
        ports=_ici_ports(n_devices),
    )


class _TwoTierRouting(RoutingPolicy):
    """The legacy tiered router: intra-node bidirectional ICI rings stitched
    by a bidirectional DCI ring over per-node gateway devices (local rank 0).
    Leg composition and port keys are bit-identical to the original
    hard-coded ``route_legs``."""

    def legs(self, spec, src, dst):
        dpn = spec.devices_per_node
        sn, sl = divmod(src, dpn)
        dn, dl = divmod(dst, dpn)
        if sn == dn:
            return (_ici_leg(src, dst, sl, dl, dpn, src),)
        legs: List[Leg] = []
        if sl != 0:
            legs.append(_ici_leg(src, sn * dpn, sl, 0, dpn, src))
        nhops, nd = _ring_route(sn, dn, spec.n_nodes)
        legs.append(
            Leg(
                "dci",
                ("dci", sn, nd),
                nhops,
                _dev(sn * dpn),
                _dev(dn * dpn),
            )
        )
        if dl != 0:
            legs.append(_ici_leg(dn * dpn, dst, 0, dl, dpn, dn * dpn))
        return tuple(legs)


@register_fabric("two_tier")
def two_tier_spec(
    n_devices: int,
    hw: HardwareSpec = V5E,
    *,
    devices_per_node: Optional[int] = None,
) -> InterconnectSpec:
    """intra-node ICI rings + a DCI ring of per-node gateway uplinks (the
    legacy hierarchical fabric, bit-identical)"""
    dpn = devices_per_node
    if dpn is None or dpn >= n_devices:
        # one node: degenerates to the flat ring (matching the legacy model)
        return ring_spec(n_devices, hw)
    ports = _ici_ports(n_devices)
    for node in range(n_devices // dpn):
        ports[("dci", node, +1)] = "dci"
        ports[("dci", node, -1)] = "dci"
    return InterconnectSpec(
        name="two_tier",
        n_devices=n_devices,
        devices_per_node=dpn,
        routing=_TwoTierRouting(),
        link_classes=_std_classes(hw),
        ports=ports,
    )


class _FatTreeRouting(RoutingPolicy):
    """Node gateways hang off leaf switches; leaves meet at a spine.  The
    leaf's spine uplink carries ``oversubscription``x less bandwidth than the
    sum of its node downlinks — the classic DCN bottleneck."""

    def legs(self, spec, src, dst):
        dpn = spec.devices_per_node
        npl = spec.params["nodes_per_leaf"]
        sn, sl = divmod(src, dpn)
        dn, dl = divmod(dst, dpn)
        if sn == dn:
            return (_ici_leg(src, dst, sl, dl, dpn, src),)
        s_leaf, d_leaf = sn // npl, dn // npl
        sgw, dgw = sn * dpn, dn * dpn
        legs: List[Leg] = []
        if sl != 0:
            legs.append(_ici_leg(src, sgw, sl, 0, dpn, src))
        # gateway -> leaf switch over the node's uplink NIC
        legs.append(
            Leg("dci", ("up", sn), 1, _dev(sgw), ("leaf", s_leaf))
        )
        if s_leaf != d_leaf:
            # leaf -> spine -> leaf: serialized on the (oversubscribed)
            # spine uplink of the source leaf
            legs.append(
                Leg(
                    "spine",
                    ("spine", s_leaf),
                    2,
                    ("leaf", s_leaf),
                    ("leaf", d_leaf),
                )
            )
        # leaf -> destination gateway over the leaf's node downlink
        legs.append(
            Leg("dci", ("down", dn), 1, ("leaf", d_leaf), _dev(dgw))
        )
        if dl != 0:
            legs.append(_ici_leg(dgw, dst, 0, dl, dpn, dgw))
        return tuple(legs)


@register_fabric("fat_tree")
def fat_tree_spec(
    n_devices: int,
    hw: HardwareSpec = V5E,
    *,
    devices_per_node: Optional[int] = None,
    oversubscription: float = 2.0,
    nodes_per_leaf: int = 2,
) -> InterconnectSpec:
    """leaf/spine fat tree over the nodes; the leaf->spine uplink is
    oversubscribed by the given factor (bandwidth / oversubscription)"""
    dpn = 1 if devices_per_node is None else int(devices_per_node)
    if dpn < 1 or n_devices % dpn:
        raise ValueError(
            f"devices_per_node={dpn} must divide n_devices={n_devices}"
        )
    if oversubscription < 1:
        raise ValueError("oversubscription must be >= 1")
    if nodes_per_leaf < 1:
        raise ValueError("nodes_per_leaf must be >= 1")
    n_nodes = n_devices // dpn
    n_leaves = math.ceil(n_nodes / nodes_per_leaf)
    classes = _std_classes(hw)
    classes["spine"] = LinkClass(
        "spine",
        classes["dci"].bw_bytes_per_ns / float(oversubscription),
        classes["dci"].hop_latency_ns,
    )
    ports = _ici_ports(n_devices)
    for node in range(n_nodes):
        ports[("up", node)] = "dci"
        ports[("down", node)] = "dci"
    for leaf in range(n_leaves):
        ports[("spine", leaf)] = "spine"
    return InterconnectSpec(
        name="fat_tree",
        n_devices=n_devices,
        devices_per_node=dpn,
        routing=_FatTreeRouting(),
        link_classes=classes,
        ports=ports,
        params={
            "oversubscription": float(oversubscription),
            "nodes_per_leaf": int(nodes_per_leaf),
            "n_leaves": n_leaves,
        },
    )


class _RailRouting(RoutingPolicy):
    """Rail-optimized: NIC ``r`` of every node attaches to the device with
    local rank ``r`` and to rail switch ``r``.  A cross-node message rides
    the *destination's* rail (``dl % rails``): hop intra-node to the rail's
    NIC owner if needed, cross on the rail, and land — rail-aligned pairs
    (same local rank) cross with zero intra-node hops, the PXN idiom."""

    def legs(self, spec, src, dst):
        dpn = spec.devices_per_node
        rails = spec.nics_per_node
        sn, sl = divmod(src, dpn)
        dn, dl = divmod(dst, dpn)
        if sn == dn:
            return (_ici_leg(src, dst, sl, dl, dpn, src),)
        r = dl % rails
        legs: List[Leg] = []
        if sl != r:
            legs.append(_ici_leg(src, sn * dpn + r, sl, r, dpn, src))
        legs.append(
            Leg(
                "rail",
                ("rail", sn, r),
                1,
                _dev(sn * dpn + r),
                _dev(dn * dpn + r),
            )
        )
        if dl != r:
            legs.append(
                _ici_leg(dn * dpn + r, dst, r, dl, dpn, dn * dpn + r)
            )
        return tuple(legs)


@register_fabric("rail_optimized")
def rail_optimized_spec(
    n_devices: int,
    hw: HardwareSpec = V5E,
    *,
    devices_per_node: Optional[int] = None,
    rails: Optional[int] = None,
) -> InterconnectSpec:
    """k NICs per node, one per rail switch; cross-node traffic rides the
    destination's rail with zero intra hops when local ranks align"""
    dpn = 1 if devices_per_node is None else int(devices_per_node)
    if dpn < 1 or n_devices % dpn:
        raise ValueError(
            f"devices_per_node={dpn} must divide n_devices={n_devices}"
        )
    rails = dpn if rails is None else int(rails)
    if not (1 <= rails <= dpn):
        raise ValueError(
            f"rails={rails} must be in [1, devices_per_node={dpn}]"
        )
    classes = {
        "ici": _std_classes(hw)["ici"],
        "rail": LinkClass(
            "rail", hw.dci_link_bw / 1e9, hw.dci_hop_latency_s * 1e9
        ),
    }
    ports = _ici_ports(n_devices)
    for node in range(n_devices // dpn):
        for r in range(rails):
            ports[("rail", node, r)] = "rail"
    return InterconnectSpec(
        name="rail_optimized",
        n_devices=n_devices,
        devices_per_node=dpn,
        routing=_RailRouting(),
        link_classes=classes,
        ports=ports,
        nics_per_node=rails,
        params={"rails": rails},
    )


class _Torus2DRouting(RoutingPolicy):
    """Dimension-ordered (X then Y) routing on a rows x cols torus; each
    device owns one egress port per axis per direction."""

    def legs(self, spec, src, dst):
        cols = spec.params["cols"]
        r1, c1 = divmod(src, cols)
        r2, c2 = divmod(dst, cols)
        legs: List[Leg] = []
        turn = src
        if c1 != c2:
            hops, d = _ring_route(c1, c2, cols)
            turn = r1 * cols + c2
            legs.append(Leg("x", ("x", src, d), hops, _dev(src), _dev(turn)))
        if r1 != r2:
            hops, d = _ring_route(r1, r2, spec.params["rows"])
            legs.append(Leg("y", ("y", turn, d), hops, _dev(turn), _dev(dst)))
        return tuple(legs)


@register_fabric("torus2d")
def torus2d_spec(
    n_devices: int,
    hw: HardwareSpec = V5E,
    *,
    devices_per_node: Optional[int] = None,
    rows: Optional[int] = None,
    cols: Optional[int] = None,
) -> InterconnectSpec:
    """rows x cols 2D torus of ICI links with dimension-ordered (X then Y)
    routing; per-axis link classes ``x``/``y``"""
    if rows is None and cols is None:
        rows = 1
        for r in range(int(math.isqrt(n_devices)), 0, -1):
            if n_devices % r == 0:
                rows = r
                break
        cols = n_devices // rows
    elif rows is None:
        if n_devices % cols:
            raise ValueError(f"cols={cols} must divide n_devices={n_devices}")
        rows = n_devices // cols
    elif cols is None:
        if n_devices % rows:
            raise ValueError(f"rows={rows} must divide n_devices={n_devices}")
        cols = n_devices // rows
    if rows * cols != n_devices:
        raise ValueError(
            f"rows x cols = {rows}x{cols} != n_devices = {n_devices}"
        )
    ici = _std_classes(hw)["ici"]
    classes = {
        "x": LinkClass("x", ici.bw_bytes_per_ns, ici.hop_latency_ns),
        "y": LinkClass("y", ici.bw_bytes_per_ns, ici.hop_latency_ns),
    }
    ports: Dict[PortKey, str] = {}
    for dev in range(n_devices):
        for d in (+1, -1):
            ports[("x", dev, d)] = "x"
            ports[("y", dev, d)] = "y"
    # torus routing is node-agnostic, but a requested node split is honored
    # as grouping metadata (node_of / report shape), not silently flattened
    return InterconnectSpec(
        name="torus2d",
        n_devices=n_devices,
        devices_per_node=devices_per_node or n_devices,
        routing=_Torus2DRouting(),
        link_classes=classes,
        ports=ports,
        params={"rows": int(rows), "cols": int(cols)},
    )
