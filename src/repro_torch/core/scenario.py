"""Scenario API: pluggable per-GPU traffic patterns as data (port of
``repro/core/scenario.py``).

* :class:`PhaseSpec` / :class:`WGProgram` — per-workgroup *phase programs as
  data*: an ordered list of compute/write/wait steps with durations and
  closed-form traffic attribution.  :class:`repro_torch.core.target.TargetDevice`
  interprets these programs, so the spin/SyncMon wait semantics, the WTT, and
  all three engines are shared by every scenario.  The symbolic programs
  (:class:`SymbolicProgram` and its loop IR) are copied whole.
* :class:`Scenario` — owns (a) program generation for the detailed device and
  (b) eidolon :class:`TraceBundle` generation (the registered peer writes).
* the port's own registry (:func:`register_scenario` / :func:`get_scenario` /
  :func:`list_scenarios`), and
* :func:`simulate` — the unified entry point: name + config + params in,
  :class:`repro_torch.core.simulator.Report` out — plus :class:`SweepRunner`,
  which fans one scenario across a parameter grid and engine set.

A scenario runs open loop (one detailed device replays its peers' writes
from the WTT) or, where it supports it, closed loop (every device detailed in
a :class:`repro_torch.core.cluster.Cluster`, flags emitted over a fabric
model).  ``simulate`` and ``SweepRunner`` take the torch ``device`` a run
uses; the static analyzer (:mod:`repro_torch.analysis`: the sanitizer, the
verifier and the layout prover) checks the programs.  Built-in scenarios
live in :mod:`repro_torch.core.scenarios`; importing that package (or calling
any registry function) registers them.
"""

from __future__ import annotations

import abc
import itertools
from bisect import bisect_right
from dataclasses import dataclass, fields
from typing import (
    Callable,
    ClassVar,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    Type,
    Union,
)

from ..device import resolve_device
from .config import EngineKind, SimConfig
from .events import TraceBundle
from .interconnect import V5E, FabricLike, HardwareSpec, resolve_fabric
from .memory import AddressMap

__all__ = [
    "TrafficOp",
    "EmitOp",
    "PhaseSpec",
    "WGProgram",
    "Affine",
    "AffineRun",
    "EmitRun",
    "LoopEmit",
    "LoopPhase",
    "LoopSpec",
    "SymbolicProgram",
    "affine_of",
    "Scenario",
    "register_scenario",
    "get_scenario",
    "list_scenarios",
    "simulate",
    "SweepPoint",
    "SweepRunner",
    "SIM_CONFIG_FIELDS",
    "LAYOUT_PROOF_OBLIGATIONS",
]


# ---------------------------------------------------------------------------
# phase programs as data
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrafficOp:
    """Closed-form traffic accounted when the owning phase completes.

    kind        "reads" (non-flag device reads), "local_writes", or
                "xgmi_out" (writes pushed to peers over the fabric).
    n           number of homogeneous requests.
    bytes_each  payload bytes per request.
    """

    kind: str
    n: int
    bytes_each: int

    _KINDS = ("reads", "local_writes", "xgmi_out")

    def __post_init__(self) -> None:
        if self.kind not in self._KINDS:
            raise ValueError(f"traffic kind must be one of {self._KINDS}")
        if self.n < 0 or self.bytes_each < 0:
            raise ValueError("traffic counts must be non-negative")

    def apply(self, memory, times: int = 1) -> None:
        """Account this op ``times`` times (cohort batching: the counters are
        linear in ``n``, so ``times`` workgroups completing the same phase
        account exactly ``n * times`` requests)."""
        if self.kind == "reads":
            memory.bulk_reads(self.n * times, bytes_each=self.bytes_each)
        elif self.kind == "local_writes":
            memory.bulk_local_writes(self.n * times, bytes_each=self.bytes_each)
        else:
            memory.issue_xgmi_out(self.n * times, bytes_each=self.bytes_each)


def reads(n: int, bytes_each: int) -> TrafficOp:
    return TrafficOp("reads", n, bytes_each)


def local_writes(n: int, bytes_each: int) -> TrafficOp:
    return TrafficOp("local_writes", n, bytes_each)


def xgmi_out(n: int, bytes_each: int) -> TrafficOp:
    return TrafficOp("xgmi_out", n, bytes_each)


@dataclass(frozen=True)
class EmitOp:
    """An xGMI write *emitted into a peer device's WTT* when the owning phase
    completes — the closed-loop counterpart of a pre-scheduled trace write.

    In a :class:`repro_torch.core.cluster.Cluster` simulation, a completing phase's
    ``emits`` are routed over the fabric model (per-hop latency + egress-link
    serialization/contention) and registered into device ``dst``'s Write
    Tracking Table at the physically-derived arrival time.  Outside a cluster
    (open-loop single-device runs) emits are inert.

    dst            destination device id.
    slot           flag slot: the write lands at ``amap.flag_addr(src, slot)``
                   in the destination's symmetric heap, where ``src`` is the
                   emitting device (flags are indexed by writer).
    data/size      written value and width (1..8 bytes, like RegisteredWrite).
    payload_bytes  data payload serialized on the link *ahead of* the flag; it
                   delays the flag's arrival but is NOT accounted as traffic
                   here (put the payload's ``xgmi_out`` in the phase's
                   TrafficOps) — only the flag write itself is accounted.
    data_writes    marker data writes registered into the destination WTT just
                   before the flag (mirrors the open-loop trace bundles'
                   ``include_data_writes`` decoration).
    coalesce       "last": emit once per device, when the final workgroup
                   completes this phase (requires all WGs of the device to
                   share program structure, i.e. the same phase index);
                   "each": emit once per workgroup.
    addr           explicit destination address, overriding the flag-slot
                   convention (e.g. raw data writes).
    """

    dst: int
    slot: int = 0
    data: int = 1
    size: int = 8
    payload_bytes: int = 0
    data_writes: int = 0
    coalesce: str = "last"
    addr: Optional[int] = None

    def __post_init__(self) -> None:
        if self.dst < 0:
            raise ValueError("EmitOp.dst must be a device id >= 0")
        if not (1 <= self.size <= 8):
            raise ValueError("EmitOp.size must be in [1, 8] bytes")
        if self.slot < 0 or self.payload_bytes < 0 or self.data_writes < 0:
            raise ValueError("EmitOp fields must be non-negative")
        if self.coalesce not in ("last", "each"):
            raise ValueError("EmitOp.coalesce must be 'last' or 'each'")


@dataclass(frozen=True)
class PhaseSpec:
    """One step of a workgroup's phase program.

    Two flavours:

    * timed phase — ``wait_addrs is None``: runs for ``duration_cycles``
      (perturbable via ``Perturb.scale_phase(wg, name, base)``), then accounts
      ``traffic`` in closed form.
    * wait phase — ``wait_addrs`` is an ordered tuple of flag *addresses* the
      workgroup observes sequentially under the configured sync policy
      (spin-poll or SyncMon monitor/mwait).  Flag-read traffic is accounted by
      the interpreter, not by ``traffic``; ``duration_cycles`` is ignored.

    ``emits`` fire at phase completion in closed-loop (cluster) simulations:
    each :class:`EmitOp` becomes a registered write in a *peer* device's WTT,
    which is how one device's perturbation ripples to the others.

    ``name`` doubles as the timeline segment label and the perturbation key;
    it must be registered via :func:`repro_torch.core.events.register_phase`.
    """

    name: str
    duration_cycles: int = 0
    traffic: Tuple[TrafficOp, ...] = ()
    wait_addrs: Optional[Tuple[int, ...]] = None
    emits: Tuple[EmitOp, ...] = ()

    @property
    def is_wait(self) -> bool:
        return self.wait_addrs is not None


@dataclass(frozen=True)
class WGProgram:
    """The full phase program of one workgroup on the detailed device."""

    wg: int
    cu: int
    dispatch_cycle: int
    phases: Tuple[PhaseSpec, ...]

    def wait_addresses(self) -> List[int]:
        out: List[int] = []
        for ph in self.phases:
            if ph.wait_addrs:
                out.extend(ph.wait_addrs)
        return out


# ---------------------------------------------------------------------------
# symbolic program IR: compressed loop phases
# ---------------------------------------------------------------------------
#
# Flat closed-loop collectives build O(devices) phases for O(devices) ranks —
# quadratic PhaseSpec construction that dominated 1024-device wall time.  The
# IR below represents a *run* of ring/incast steps as one object with affine
# step-indexed fields.  ``SymbolicProgram`` is a drop-in replacement for a
# ``Tuple[PhaseSpec, ...]``: it supports ``len``/indexing/iteration/equality,
# materializes individual steps lazily (memoized, so step identity is stable
# for id-keyed engine caches), and ``expand()`` reproduces the pre-refactor
# flat tuple bit-identically.  Engines and the verifier read ``.segments``
# directly to advance or check whole loops without unrolling.


@dataclass(frozen=True)
class Affine:
    """An integer affine function ``base + step * k`` of the loop index."""

    base: int
    step: int = 0

    def at(self, k: int) -> int:
        return self.base + self.step * k


def affine_of(fn: Callable[[int], int], k0: int, count: int) -> Affine:
    """Derive the :class:`Affine` matching ``fn`` on ``[k0, k0+count)``.

    Sampled at the first two points and verified at the last, so non-affine
    layouts (e.g. a custom AddressMap) fail loudly instead of silently
    mis-compressing.
    """
    v0 = fn(k0)
    if count <= 1:
        return Affine(v0, 0)
    step = fn(k0 + 1) - v0
    last = k0 + count - 1
    if fn(last) != v0 + step * (count - 1):
        raise ValueError("function is not affine over the loop range")
    return Affine(v0 - step * k0, step)


@dataclass(frozen=True)
class AffineRun:
    """A compressed *within-phase* arithmetic run of ``count`` addresses
    ``start, start+stride, ...`` (e.g. the all-to-all wait list over peers)."""

    start: int
    stride: int
    count: int

    def __post_init__(self) -> None:
        if self.count < 0:
            raise ValueError("AffineRun.count must be >= 0")

    def expand(self) -> Tuple[int, ...]:
        return tuple(self.start + self.stride * j for j in range(self.count))


@dataclass(frozen=True)
class EmitRun:
    """``count`` :class:`EmitOp`\\ s whose dst/slot advance affinely with the
    member index ``j`` (shared payload/marker/coalesce fields) — the per-peer
    fan-out of an incast phase as one descriptor."""

    count: int
    dst0: int
    dst_stride: int = 1
    slot0: int = 0
    slot_stride: int = 0
    data: int = 1
    size: int = 8
    payload_bytes: int = 0
    data_writes: int = 0
    coalesce: str = "last"

    def __post_init__(self) -> None:
        if self.count < 0:
            raise ValueError("EmitRun.count must be >= 0")

    def expand(self) -> Tuple[EmitOp, ...]:
        return tuple(
            EmitOp(
                self.dst0 + j * self.dst_stride,
                slot=self.slot0 + j * self.slot_stride,
                data=self.data,
                size=self.size,
                payload_bytes=self.payload_bytes,
                data_writes=self.data_writes,
                coalesce=self.coalesce,
            )
            for j in range(self.count)
        )


@dataclass(frozen=True)
class LoopEmit:
    """An :class:`EmitOp` template whose dst/slot are :class:`Affine` in the
    loop index ``k`` (the ring step's downstream emit)."""

    dst: Affine
    slot: Affine = Affine(0)
    data: int = 1
    size: int = 8
    payload_bytes: int = 0
    data_writes: int = 0
    coalesce: str = "last"

    def at(self, k: int) -> EmitOp:
        return EmitOp(
            self.dst.at(k),
            slot=self.slot.at(k),
            data=self.data,
            size=self.size,
            payload_bytes=self.payload_bytes,
            data_writes=self.data_writes,
            coalesce=self.coalesce,
        )


#: wait entries a LoopPhase accepts: a literal address, an address affine in
#: the loop index, or a within-phase run of addresses (constant in k).
WaitEntry = Union[int, Affine, AffineRun]
#: emit entries a LoopPhase accepts.
EmitEntry = Union[EmitOp, LoopEmit, EmitRun]


@dataclass(frozen=True)
class LoopPhase:
    """A :class:`PhaseSpec` *template* evaluated at a loop index ``k``.

    ``traffic`` is loop-invariant (the built-in collectives move the same
    bytes every step); step-dependent addressing lives in ``wait_addrs`` /
    ``emits`` entries, which may be symbolic (:class:`Affine`,
    :class:`AffineRun`, :class:`LoopEmit`, :class:`EmitRun`).
    """

    name: str
    duration_cycles: int = 0
    traffic: Tuple[TrafficOp, ...] = ()
    wait_addrs: Optional[Tuple[WaitEntry, ...]] = None
    emits: Tuple[EmitEntry, ...] = ()

    @property
    def is_wait(self) -> bool:
        return self.wait_addrs is not None

    def at(self, k: int) -> PhaseSpec:
        waits: Optional[Tuple[int, ...]] = None
        if self.wait_addrs is not None:
            acc: List[int] = []
            for w in self.wait_addrs:
                if isinstance(w, AffineRun):
                    acc.extend(w.expand())
                elif isinstance(w, Affine):
                    acc.append(w.at(k))
                else:
                    acc.append(w)
            waits = tuple(acc)
        ems: List[EmitOp] = []
        for e in self.emits:
            if isinstance(e, EmitRun):
                ems.extend(e.expand())
            elif isinstance(e, LoopEmit):
                ems.append(e.at(k))
            else:
                ems.append(e)
        return PhaseSpec(self.name, self.duration_cycles, self.traffic, waits, tuple(ems))


@dataclass(frozen=True)
class LoopSpec:
    """``count`` iterations of ``body`` with the loop index running
    ``k = k0, k0+1, ..., k0+count-1`` — one object standing for
    ``count * len(body)`` phases."""

    count: int
    body: Tuple[LoopPhase, ...]
    k0: int = 0

    def __post_init__(self) -> None:
        if self.count < 0:
            raise ValueError("LoopSpec.count must be >= 0")
        if not self.body:
            raise ValueError("LoopSpec.body must be non-empty")
        for ph in self.body:
            if not isinstance(ph, LoopPhase):
                raise TypeError("LoopSpec.body entries must be LoopPhase")

    @property
    def n_phases(self) -> int:
        return self.count * len(self.body)


#: a SymbolicProgram segment: a literal phase, a single compressed phase
#: (evaluated at k = 0), or a counted loop of compressed phases.
Segment = Union[PhaseSpec, LoopPhase, LoopSpec]


class SymbolicProgram:
    """A compressed per-rank phase program.

    Drop-in replacement for a flat ``Tuple[PhaseSpec, ...]`` in
    :class:`WGProgram.phases`: sequence protocol (``len``/index/iterate),
    value equality against other programs *and* flat tuples, and a
    bit-identical :meth:`expand`.  Individual phases materialize lazily and
    are memoized, so ``program[i] is program[i]`` — engine caches keyed by
    phase identity keep working.  Bulk engines skip materialization entirely
    and read :attr:`segments`.

    Note: equality with flat tuples is supported but hashes differ — don't
    mix symbolic and materialized programs as keys of one dict.
    """

    __slots__ = ("segments", "group", "_starts", "_len", "_memo", "_hash")

    def __init__(self, segments: Iterable[Segment], group: Optional[str] = None):
        segs: List[Segment] = []
        starts: List[int] = []
        n = 0
        for s in segments:
            if isinstance(s, LoopSpec):
                cnt = s.n_phases
                if cnt == 0:
                    continue  # empty loops contribute no phases
            elif isinstance(s, (PhaseSpec, LoopPhase)):
                cnt = 1
            else:
                raise TypeError(
                    "SymbolicProgram segments must be PhaseSpec, LoopPhase, or LoopSpec"
                )
            segs.append(s)
            starts.append(n)
            n += cnt
        self.segments: Tuple[Segment, ...] = tuple(segs)
        #: Optional group-uniformity label stamped by the scenario: ranks
        #: sharing a label are claimed to run programs that are uniform under
        #: an affine rank remapping.  Advisory metadata for the lockstep
        #: group classifier — excluded from equality and hashing.
        self.group: Optional[str] = group
        self._starts: Tuple[int, ...] = tuple(starts)
        self._len = n
        self._memo: Dict[int, PhaseSpec] = {}
        self._hash: Optional[int] = None

    # -- sequence protocol --------------------------------------------------

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i):
        if isinstance(i, slice):
            return tuple(self[j] for j in range(*i.indices(self._len)))
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError("phase index out of range")
        got = self._memo.get(i)
        if got is None:
            si = bisect_right(self._starts, i) - 1
            seg = self.segments[si]
            if isinstance(seg, PhaseSpec):
                got = seg
            elif isinstance(seg, LoopPhase):
                got = seg.at(0)
            else:
                k, b = divmod(i - self._starts[si], len(seg.body))
                got = seg.body[b].at(seg.k0 + k)
            self._memo[i] = got
        return got

    def __iter__(self) -> Iterator[PhaseSpec]:
        for i in range(self._len):
            yield self[i]

    def __eq__(self, other):
        if self is other:
            return True
        if isinstance(other, SymbolicProgram):
            if self.segments == other.segments:
                return True
            if self._len != other._len:
                return False
            return all(a == b for a, b in zip(self, other))
        if isinstance(other, tuple):
            if len(other) != self._len:
                return False
            return all(a == b for a, b in zip(self, other))
        return NotImplemented

    def __hash__(self) -> int:
        if self._hash is None:
            self._hash = hash(self.segments)
        return self._hash

    def __repr__(self) -> str:
        tag = f", group={self.group!r}" if self.group is not None else ""
        return f"SymbolicProgram({self._len} phases, {len(self.segments)} segments{tag})"

    # -- materialization and summaries --------------------------------------

    def expand(self) -> Tuple[PhaseSpec, ...]:
        """Materialize the flat phase tuple — bit-identical to the
        pre-refactor construction."""
        return tuple(self[i] for i in range(self._len))

    def wait_runs(self) -> Tuple[List[int], List[Tuple[int, int, int]]]:
        """Every wait address as a literal or a ``(start, stride, count)``
        arithmetic run, in O(#segments) — never O(steps).  Membership
        summary for engine watch sets."""
        literals: List[int] = []
        runs: List[Tuple[int, int, int]] = []
        for seg in self.segments:
            if isinstance(seg, PhaseSpec):
                if seg.wait_addrs:
                    literals.extend(seg.wait_addrs)
                continue
            if isinstance(seg, LoopPhase):
                body: Tuple[LoopPhase, ...] = (seg,)
                count, k0 = 1, 0
            else:
                body, count, k0 = seg.body, seg.count, seg.k0
            for ph in body:
                if not ph.wait_addrs:
                    continue
                for w in ph.wait_addrs:
                    if isinstance(w, AffineRun):
                        # constant in k: the same run re-awaited each
                        # iteration — one membership run suffices.
                        if w.count:
                            runs.append((w.start, w.stride, w.count))
                    elif isinstance(w, Affine):
                        if w.step == 0 or count == 1:
                            literals.append(w.at(k0))
                        else:
                            runs.append((w.at(k0), w.step, count))
                    else:
                        literals.append(w)
        return literals, runs


def as_symbolic(phases) -> Optional[SymbolicProgram]:
    """Return ``phases`` as a :class:`SymbolicProgram` if it is one."""
    return phases if isinstance(phases, SymbolicProgram) else None


# ---------------------------------------------------------------------------
# the Scenario base class
# ---------------------------------------------------------------------------


class Scenario(abc.ABC):
    """A communication scenario: phase programs + eidolon write traces.

    Subclasses set ``name`` (the registry key), accept their swept parameters
    as keyword arguments, and implement :meth:`programs` and :meth:`traces`.
    ``params`` holds whatever keyword arguments the constructor accepted, for
    reporting.

    A scenario runs in one of two modes:

    * **open loop** (default, ``closed_loop = False``): exactly one detailed
      device (device 0); peers are eidolons whose writes are synthesized up
      front by :meth:`traces` and replayed from the WTT.
    * **closed loop** (``closed_loop = True``, set by scenarios that support
      it): every device runs its own phase-program interpreter inside a
      :class:`repro_torch.core.cluster.Cluster`; flags are *emitted* by completing
      phases (:class:`EmitOp`) instead of pre-scheduled, so perturbations on
      one device propagate to the others.  Closed-loop scenarios override
      :meth:`programs_for`.
    """

    name: str = ""
    closed_loop: bool = False  # instances flip this when built closed-loop
    #: Class-level capability flag: True on scenarios that accept
    #: ``closed_loop=True`` and run per-rank phase programs in a Cluster.
    #: Registering such a class records a layout-proof obligation (see
    #: ``LAYOUT_PROOF_OBLIGATIONS``) discharged by the parametric prover in
    #: :mod:`repro_torch.analysis.layout`.
    closed_loop_capable: ClassVar[bool] = False
    #: Device-count ceiling the layout prover certifies this scenario's
    #: address layout up to (flag/partial/marker disjointness, unique
    #: writers, wait coverage, for every constructible n <= max_devices).
    max_devices: ClassVar[int] = 4096

    def __init__(self, cfg: SimConfig, amap: Optional[AddressMap] = None):
        self.cfg = cfg
        self.amap = amap or self.default_amap(cfg)
        self.params: Dict[str, object] = {}
        # Closed-loop fabric shape: scenarios that take a ``devices_per_node``
        # knob set this to a tier-explicit Topology (see
        # ``Topology.for_devices``); the Cluster derives its FabricModel from
        # it.  ``None`` means the flat single-tier ring over cfg.n_devices.
        self.topology = None  # type: ignore[assignment]
        # Pluggable fabric: scenarios built with ``fabric=``/link overrides
        # resolve an InterconnectSpec here (see :meth:`_setup_fabric`), which
        # the Cluster prefers over ``topology``.  ``None`` keeps the legacy
        # topology-derived ring/two_tier shape.
        self.interconnect = None  # type: ignore[assignment]
        self.fabric_name: Optional[str] = None

    @classmethod
    def default_amap(cls, cfg: SimConfig) -> AddressMap:
        # clearance is a no-op for the single-slot default map; it makes
        # "partial region starts above the flag pool" a base-class invariant
        # for any subclass that forgets to re-base a wider pool
        return AddressMap(n_devices=cfg.n_devices).with_partial_clearance()

    def _setup_fabric(
        self,
        *,
        devices_per_node: Optional[int] = None,
        hw: HardwareSpec = V5E,
        fabric: FabricLike = None,
        link_bw: Optional[Dict[str, float]] = None,
        link_latency_ns: Optional[Dict[str, float]] = None,
        **fabric_params,
    ) -> None:
        """Resolve the closed-loop fabric: sets ``self.topology`` (the legacy
        tier-explicit shape) and — when ``fabric`` names a registered preset
        (e.g. ``"fat_tree"``), is a ready
        :class:`repro_torch.core.interconnect.InterconnectSpec`, or any per-class
        link override is given — ``self.interconnect``, which the
        :class:`repro_torch.core.cluster.Cluster` prefers.  ``link_bw`` maps link
        class -> bytes/ns (== GB/s); unknown classes raise, listing the
        fabric's valid ones."""
        from .topology import Topology  # late import (topology is heavier)

        n = self.cfg.n_devices
        self.topology = Topology.for_devices(n, devices_per_node, hw=hw)
        self.interconnect = resolve_fabric(
            fabric,
            n,
            hw,
            devices_per_node=devices_per_node,
            link_bw=link_bw,
            link_latency_ns=link_latency_ns,
            **fabric_params,
        )
        self.fabric_name = (
            self.interconnect.name if self.interconnect is not None else None
        )

    @abc.abstractmethod
    def programs(self) -> List[WGProgram]:
        """Per-workgroup phase programs for the detailed device (device 0)."""

    @abc.abstractmethod
    def traces(self) -> TraceBundle:
        """Registered peer writes the eidolons replay (including every flag
        write some program waits on — otherwise the run deadlocks)."""

    # -- multi-device hooks (closed-loop scenarios override) -----------------

    def programs_for(self, device: int) -> List[WGProgram]:
        """Phase programs for one device of a multi-device simulation.

        Open-loop scenarios model only device 0, for which this defers to
        :meth:`programs`; closed-loop scenarios override this with genuinely
        per-rank programs (whose phases carry :class:`EmitOp`\\ s).
        """
        if self.closed_loop:
            raise NotImplementedError(
                f"scenario {self.name!r} sets closed_loop but does not "
                "implement programs_for()"
            )
        if device == 0:
            return self.programs()
        raise ValueError(
            f"open-loop scenario {self.name!r} models only device 0 in "
            f"detail (got device {device}); build it with closed_loop=True "
            "if supported"
        )

    def traces_for(self, device: int) -> TraceBundle:
        """Seed writes pre-registered into ``device``'s WTT before the run.

        Open loop: device 0 gets the full eidolon bundle (:meth:`traces`),
        peers get nothing — the degenerate case where an eidolon is just a
        device whose program replays a bundle.  Closed loop: empty by default,
        because flags are emitted by completing phases at run time.
        """
        if self.closed_loop:
            return TraceBundle(meta={"scenario": self.name, "closed_loop": True})
        return self.traces() if device == 0 else TraceBundle()

    # -- optional hooks ------------------------------------------------------

    def run_vectorized(self, sim) -> Optional["object"]:
        """Return a Report from a scenario-specific closed-form engine, or
        ``None`` if the scenario only supports the cycle/event engines."""
        return None

    def describe(self) -> str:
        ps = ", ".join(f"{k}={v!r}" for k, v in self.params.items())
        return f"<{type(self).__name__} {self.name}({ps})>"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[Scenario]] = {}

#: Registration-time layout-proof obligations.  Every closed-loop-capable
#: scenario registered below must have its address layout *proven* — flag
#: pool / partial region / marker windows pairwise disjoint, one writer per
#: flag value epoch, every wait family fed by an earlier emission family —
#: for all device counts up to its ``max_devices`` bound.  The obligation is
#: discharged by :func:`repro_torch.analysis.layout.prove_registry`, wired
#: into ``python -m repro_torch.analysis``.
LAYOUT_PROOF_OBLIGATIONS: List[str] = []


def register_scenario(cls: Type[Scenario]) -> Type[Scenario]:
    """Class decorator: register a Scenario subclass under ``cls.name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    existing = _REGISTRY.get(cls.name)
    if existing is not None and existing is not cls:
        raise ValueError(f"scenario {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls
    if cls.closed_loop_capable and cls.name not in LAYOUT_PROOF_OBLIGATIONS:
        LAYOUT_PROOF_OBLIGATIONS.append(cls.name)
    return cls


def _load_builtins() -> None:
    # importing the package registers the built-in scenarios
    from . import scenarios  # noqa: F401


def get_scenario(name: str) -> Type[Scenario]:
    _load_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def list_scenarios() -> List[str]:
    _load_builtins()
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# unified entry point
# ---------------------------------------------------------------------------

ScenarioLike = Union[str, Scenario, Type[Scenario]]


def _resolve(scenario: ScenarioLike, cfg: SimConfig, params: Dict) -> Scenario:
    if isinstance(scenario, Scenario):
        if params:
            raise ValueError(
                "pass scenario params to the constructor when providing an "
                "instance, not to simulate()"
            )
        return scenario
    cls = get_scenario(scenario) if isinstance(scenario, str) else scenario
    return cls(cfg, **params)


def _resolve_shape(
    devices: Optional[int],
    nodes: Optional[int],
    devices_per_node: Optional[int],
) -> Tuple[Optional[int], Optional[int]]:
    """Resolve the (devices, devices_per_node) pair from any two of the
    ``devices`` / ``nodes`` / ``devices_per_node`` knobs."""
    if nodes is not None and nodes < 1:
        raise ValueError("nodes must be >= 1")
    if devices_per_node is not None and devices_per_node < 1:
        raise ValueError("devices_per_node must be >= 1")
    if nodes is None:
        return devices, devices_per_node
    if devices_per_node is not None:
        total = nodes * devices_per_node
        if devices is not None and devices != total:
            raise ValueError(
                f"devices={devices} contradicts nodes={nodes} x "
                f"devices_per_node={devices_per_node}"
            )
        return total, devices_per_node
    if devices is None:
        raise ValueError(
            "nodes= needs devices= or devices_per_node= to fix the shape"
        )
    if devices % nodes:
        raise ValueError(f"devices={devices} not divisible by nodes={nodes}")
    return devices, devices // nodes


def simulate(
    scenario: ScenarioLike,
    cfg: Optional[SimConfig] = None,
    *,
    perturb=None,
    collect_segments: bool = True,
    devices: Optional[int] = None,
    nodes: Optional[int] = None,
    devices_per_node: Optional[int] = None,
    sanitize: bool = False,
    timeline: Optional[bool] = None,
    lockstep: Optional[bool] = None,
    _plan_cache=None,
    _plan_key=None,
    device=None,
    **params,
):
    """Simulate one kernel launch of ``scenario`` under ``cfg``.

    ``scenario`` may be a registered name (see :func:`list_scenarios`), a
    Scenario subclass, or a ready-built instance (whose own cfg is then used;
    passing a *different* cfg alongside an instance is an error).  Extra
    keyword arguments are forwarded to the scenario constructor (e.g.
    ``flag_delays_ns=...`` for ``gemv_allreduce``, or ``closed_loop=True``
    for the scenarios that support running every device in detail).

    ``devices`` overrides the total device count (``cfg.n_egpus`` becomes
    ``devices - 1``), e.g. ``simulate("ring_allreduce", cfg, devices=8,
    closed_loop=True)``.

    ``nodes`` / ``devices_per_node`` fix the tiered fabric shape: any two of
    (``devices``, ``nodes``, ``devices_per_node``) determine the third, and
    the resolved ``devices_per_node`` is forwarded to the scenario (which
    builds its :class:`repro_torch.core.topology.Topology` from it), e.g.
    ``simulate("hierarchical_allreduce", nodes=4, devices_per_node=4)``.

    ``fabric=`` (a registered interconnect preset name such as
    ``"fat_tree"`` or ``"rail_optimized"``, or a ready
    :class:`repro_torch.core.interconnect.InterconnectSpec`) and ``link_bw=``
    (per-link-class bandwidth overrides, validated) are ordinary scenario
    parameters on every closed-loop scenario — the same workload runs over
    any fabric, e.g. ``simulate("all_to_all", devices=16, nodes=4,
    closed_loop=True, fabric="rail_optimized")``.

    Scenarios built with ``closed_loop=True`` run in a
    :class:`repro_torch.core.cluster.Cluster` (every device program-driven, flags
    routed over the fabric); otherwise the single-detailed-device
    :class:`repro_torch.core.simulator.Eidola` replay path is used.  Both return a
    :class:`repro_torch.core.simulator.Report`.

    ``sanitize=True`` (closed loop only) runs the
    :class:`repro_torch.analysis.sanitize.TrafficSanitizer` alongside the
    engines: byte conservation, calendar monotonicity, and exactly-once flag
    delivery are asserted at the end of the run (raising ``SanitizerError``
    on violation) without perturbing any simulated state.

    ``timeline`` (closed loop only) selects the pod-scale timeline engine
    (:mod:`repro_torch.core.cohort_timeline`): ``None`` (default) auto-enables it
    whenever the lockstep-lane invariant holds, ``True`` requires it (error
    when ineligible), ``False`` always uses the per-phase interpreter.

    ``lockstep`` (closed loop only) is the same tri-state for the bulk
    lockstep solvers, which substitute for the timeline engine — whole
    loops advance as closed forms instead of per-phase interpretation.
    The flat solver (:mod:`repro_torch.core.lockstep`) covers globally
    rank-uniform programs on the single-tier ring; the tiered solver
    (:mod:`repro_torch.core.lockstep_tiered`) covers group-uniform programs
    (leaders vs. workers, the uniform collectives) over the ``two_tier``,
    ``fat_tree``, and ``rail_optimized`` presets, pricing real multi-leg
    routes.  ``Report.meta["lockstep_reason"]`` records either ``"engaged"``
    or the exact reason the solvers declined.

    ``device`` is the torch device the vector engine's and the lockstep
    solvers' tensors live on: ``None`` is the CUDA device (an error without a
    card), ``"cpu"`` the host; it is resolved before anything is built.
    """
    from .simulator import Eidola  # late import: simulator imports target

    device = resolve_device(device)
    devices, dpn = _resolve_shape(devices, nodes, devices_per_node)
    if dpn is not None:
        params.setdefault("devices_per_node", dpn)
    if devices is not None:
        cfg = (cfg or SimConfig()).with_devices(devices)
    if isinstance(scenario, Scenario):
        # the instance's programs/traces were built from its cfg; running the
        # engines under another cfg would silently mix two configurations
        if cfg is not None and cfg != scenario.cfg:
            raise ValueError(
                "scenario instance was built with a different SimConfig than "
                "the one passed to simulate(); rebuild the scenario or drop "
                "the cfg/devices arguments"
            )
        cfg = scenario.cfg
    cfg = (cfg or SimConfig()).validate()
    sc = _resolve(scenario, cfg, params)
    if sc.closed_loop:
        from .cluster import Cluster  # late import: cluster imports target

        return Cluster(
            cfg,
            sc,
            perturb=perturb,
            collect_segments=collect_segments,
            sanitize=sanitize,
            timeline=timeline,
            lockstep=lockstep,
            plan_cache=_plan_cache,
            plan_key=_plan_key,
            device=device,
        ).run()
    if sanitize:
        raise ValueError(
            "sanitize=True requires a closed-loop scenario (the sanitizer "
            "shadows the cluster's fabric and directory accounting)"
        )
    if timeline is True:
        raise ValueError(
            "timeline=True requires a closed-loop scenario (the timeline "
            "engine drives a Cluster of lockstep lanes)"
        )
    if lockstep is True:
        raise ValueError(
            "lockstep=True requires a closed-loop scenario (the bulk solver "
            "advances a Cluster of rank-uniform symbolic programs)"
        )
    return Eidola(
        cfg,
        sc.traces(),
        scenario=sc,
        amap=sc.amap,
        perturb=perturb,
        collect_segments=collect_segments,
        device=device,
    ).run()


# ---------------------------------------------------------------------------
# parameter sweeps
# ---------------------------------------------------------------------------

# SimConfig field names: any sweep/CLI key in this set is a config override,
# everything else is a scenario constructor parameter (the CLI reuses this)
SIM_CONFIG_FIELDS = frozenset(f.name for f in fields(SimConfig))


@dataclass
class SweepPoint:
    """One (scenario params x config overrides x engine) simulation."""

    scenario: str
    engine: str
    overrides: Dict[str, object]
    params: Dict[str, object]
    report: object  # Report (typed loosely to avoid the circular import)

    def row(self) -> Dict[str, object]:
        r = self.report
        return {
            "scenario": self.scenario,
            "engine": self.engine,
            **self.overrides,
            **self.params,
            "flag_reads": r.flag_reads,
            "nonflag_reads": r.nonflag_reads,
            "kernel_span_ns": r.kernel_span_ns,
            "wall_time_s": r.wall_time_s,
        }


class SweepRunner:
    """Fan one scenario across a parameter grid and a set of engines.

    Grid keys naming :class:`SimConfig` fields become config overrides; all
    other keys are forwarded to the scenario constructor (``devices`` and
    ``nodes`` are sugar for the fabric shape, as in :func:`simulate`).  The
    cross product of the grid runs once per engine, on ``device`` (resolved
    here, as :func:`simulate` does).
    """

    def __init__(
        self,
        scenario: Union[str, Type[Scenario]],
        base_cfg: Optional[SimConfig] = None,
        *,
        engines: Sequence[EngineKind] = (EngineKind.EVENT,),
        perturb=None,
        collect_segments: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.scenario_cls = (
            get_scenario(scenario) if isinstance(scenario, str) else scenario
        )
        self.base_cfg = base_cfg or SimConfig()
        self.engines = tuple(engines)
        self.perturb = perturb
        self.collect_segments = collect_segments
        # compiled lockstep plans keyed by the point's full (scenario,
        # engine, config, params) identity; plans are read-only at run
        # time, so revisiting a shape (e.g. sweeping a non-structural
        # parameter per repeat) skips recompilation.  Perturbed sweeps
        # bypass the cache: a perturbation may reroute the run entirely.
        self._plan_cache: Dict[tuple, object] = {}

    def run(self, grid: Optional[Dict[str, Iterable]] = None, **grid_kw) -> List[SweepPoint]:
        grid = dict(grid or {})
        grid.update(grid_kw)
        keys = sorted(grid)
        combos = list(itertools.product(*(list(grid[k]) for k in keys))) or [()]
        points: List[SweepPoint] = []
        for combo in combos:
            assignment = dict(zip(keys, combo))
            # "devices"/"nodes" are sugar for the fabric shape (as in
            # simulate()); the resolved devices_per_node stays a scenario
            # parameter so it reaches the constructor and the sweep row
            devices, dpn = _resolve_shape(
                assignment.pop("devices", None),
                assignment.pop("nodes", None),
                assignment.get("devices_per_node"),
            )
            if dpn is not None:
                assignment["devices_per_node"] = dpn
            overrides = {k: v for k, v in assignment.items() if k in SIM_CONFIG_FIELDS}
            if devices is not None:
                overrides["n_egpus"] = SimConfig().with_devices(devices).n_egpus
            params = {k: v for k, v in assignment.items() if k not in SIM_CONFIG_FIELDS}
            for eng in self.engines:
                cfg = self.base_cfg.with_(engine=eng, **overrides)
                plan_key = (
                    (
                        self.scenario_cls.name,
                        repr(cfg),
                        tuple(
                            sorted((k, repr(v)) for k, v in params.items())
                        ),
                    )
                    if self.perturb is None
                    else None
                )
                report = simulate(
                    self.scenario_cls,
                    cfg,
                    perturb=self.perturb,
                    collect_segments=self.collect_segments,
                    _plan_cache=(
                        self._plan_cache if plan_key is not None else None
                    ),
                    _plan_key=plan_key,
                    device=self.device,
                    **params,
                )
                points.append(
                    SweepPoint(
                        scenario=self.scenario_cls.name,
                        engine=EngineKind(eng).value,
                        overrides=overrides,
                        params=params,
                        report=report,
                    )
                )
        return points

    @staticmethod
    def to_csv(points: Sequence[SweepPoint]) -> str:
        if not points:
            return ""

        def cell(v) -> str:
            s = str(v)
            if any(ch in s for ch in ",\"\n"):
                s = '"' + s.replace('"', '""') + '"'
            return s

        cols: List[str] = []
        for p in points:
            for k in p.row():
                if k not in cols:
                    cols.append(k)
        lines = [",".join(cell(c) for c in cols)]
        for p in points:
            row = p.row()
            lines.append(",".join(cell(row.get(c, "")) for c in cols))
        return "\n".join(lines)
