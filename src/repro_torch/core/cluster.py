"""Closed-loop multi-device simulation: N program-driven devices, one fabric
(port of ``repro/core/cluster.py``).

The paper's headline claim is modeling "synchronization behavior across large
multi-GPU configurations", but open-loop replay can never show one device's
perturbation rippling to another: eidolon flag-write times are synthesized up
front.  A :class:`Cluster` closes the loop — every device runs its own
phase-program interpreter (:class:`repro_torch.core.target.TargetDevice` with its
own :class:`DirectoryMemory`, :class:`MonitorLog`, and
:class:`WriteTrackingTable`), and a completing phase *emits* xGMI writes
(:class:`repro_torch.core.scenario.EmitOp`) that are routed over the fabric model
(:class:`repro_torch.core.topology.FabricModel`: per-hop latency + per-egress-link
serialization/contention) and registered into the destination device's WTT.
Step-k flags are therefore written only when the emitting device actually
finishes step k, so a slow reduce on one rank measurably delays every
downstream rank.

Open-loop replay remains the degenerate case: a cluster of one detailed
device whose WTT was pre-loaded with a trace bundle is exactly the classic
:class:`repro_torch.core.simulator.Eidola` run (same engines, same node type).

Determinism: emissions happen at phase completions, whose global order is
identical under both engines (writes before transitions, devices in id
order), and the fabric's contention state is updated in that order — so
cycle/event runs stay bit-identical, which the tests assert per scenario.

The port's cluster runs on a torch device, resolved when it is built: the
CUDA device unless the caller passes ``device="cpu"``, and an error, not a
fallback, when there is no card.  The cycle, event and timeline engines are
host interpreters and ignore it; the flat lockstep solver
and the tiered one (:mod:`repro_torch.core.lockstep_tiered`) keep their
cursor matrices, counters and fabric state there.  ``sanitize=True`` shadows
the run with :class:`repro_torch.analysis.sanitize.TrafficSanitizer`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Union

from ..device import resolve_device
from .config import EngineKind, SimConfig, SyncPolicy
from .engine import CyclePollEngine, EventQueueEngine
from .events import RegisteredWrite, Segment
from .interconnect import InterconnectSpec, build_fabric
from .memory import DirectoryMemory
from .monitor import MonitorLog
from .scenario import EmitOp, PhaseSpec, Scenario, SymbolicProgram
from .target import TargetDevice
from .topology import V5E, FabricModel, Topology
from .wtt import LazyWriteRun, RegistrationLike, WriteTrackingTable

__all__ = ["Cluster", "ClusterNode", "resolve_cluster_fabric"]

# perturb may be one object applied to every device, or a per-device mapping
PerturbLike = Union[None, object, Dict[int, object]]


def resolve_cluster_fabric(
    cfg: SimConfig,
    scenario: Scenario,
    fabric: Union[None, str, InterconnectSpec, FabricModel] = None,
    topology: Optional[Topology] = None,
) -> FabricModel:
    """The fabric a cluster run of ``scenario`` would route over.

    Priority order (shared by :class:`Cluster` and the static verifier's
    reachability check, so both always see the same fabric): an explicit
    ``fabric`` argument (ready :class:`FabricModel`, an
    :class:`InterconnectSpec`, or a registered preset name), then the
    scenario's ``interconnect`` spec, then its :class:`Topology`, then the
    flat single-tier ring over ``cfg.n_devices``.
    """
    topo = topology or getattr(scenario, "topology", None)
    if fabric is None:
        spec = getattr(scenario, "interconnect", None)
        if spec is not None:
            fabric = FabricModel.from_spec(spec)
        elif topo is not None:
            if topo.n_chips != cfg.n_devices:
                raise ValueError(
                    f"topology spans {topo.n_chips} chips but the cluster "
                    f"simulates {cfg.n_devices} devices"
                )
            fabric = FabricModel.from_topology(topo)
        else:
            fabric = FabricModel(
                cfg.n_devices, hw=getattr(scenario, "hw", V5E)
            )
    elif isinstance(fabric, str):
        # forward the scenario's node split only when it has one; a flat
        # topology (n_nodes == 1) leaves the preset's own default (e.g.
        # one-device nodes for fat_tree/rail_optimized) so a named
        # fabric never silently degenerates to a single node
        dpn = (
            topo.devices_per_node
            if topo is not None and topo.n_nodes > 1
            else None
        )
        fabric = FabricModel.from_spec(
            build_fabric(
                fabric,
                cfg.n_devices,
                getattr(scenario, "hw", V5E),
                devices_per_node=dpn,
            )
        )
    elif isinstance(fabric, InterconnectSpec):
        fabric = FabricModel.from_spec(fabric)
    if fabric.n_devices != cfg.n_devices:
        raise ValueError(
            f"fabric models {fabric.n_devices} devices but the cluster "
            f"simulates {cfg.n_devices}"
        )
    return fabric


@dataclass
class ClusterNode:
    """One simulated device: interpreter + private memory/monitor/WTT."""

    device_id: int
    memory: DirectoryMemory
    monitor: Optional[MonitorLog]
    target: TargetDevice
    wtt: WriteTrackingTable


class Cluster:
    """N detailed devices in one closed simulation loop.

    ``scenario`` must have been built with ``closed_loop=True`` (its
    ``programs_for(d)`` yields per-rank programs whose phases carry
    :class:`EmitOp`\\ s); ``scenario.traces_for(d)`` seeds each device's WTT
    (normally empty in closed loop — flags are emitted at run time).

    ``perturb`` may be a single perturbation object (applied to every device;
    note phase jitter is then *correlated* across devices because it is keyed
    by (wg, phase) only) or a mapping ``{device_id: perturb}`` to disturb
    specific ranks — the knob the propagation experiments turn.

    The fabric resolves in priority order: an explicit ``fabric=`` argument
    (a ready :class:`FabricModel`, an
    :class:`repro_torch.core.interconnect.InterconnectSpec`, or a registered preset
    *name* such as ``"fat_tree"``), then the scenario's ``interconnect`` spec
    (set when it was built with ``fabric=``/link overrides), then the
    scenario's :class:`Topology` (its ``topology`` attribute, or an explicit
    ``topology=`` argument: non-DCI axes form the intra-node tier, DCI axes
    the inter-node tier — the ``ring``/``two_tier`` presets).  Without any of
    those the fabric degenerates to the flat single-tier ring over
    ``cfg.n_devices`` (the pre-tiered behaviour).

    ``device`` is where the lockstep solvers' tensors live: ``None`` is the
    CUDA device (an error without a card), ``"cpu"`` the host.  It is
    resolved first, before anything is built.
    """

    def __init__(
        self,
        cfg: SimConfig,
        scenario: Scenario,
        *,
        perturb: PerturbLike = None,
        collect_segments: bool = True,
        fabric: Union[None, str, InterconnectSpec, FabricModel] = None,
        topology: Optional[Topology] = None,
        cohorts: bool = True,
        sanitize: bool = False,
        timeline: Optional[bool] = None,
        lockstep: Optional[bool] = None,
        plan_cache=None,
        plan_key=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg.validate()
        self.scenario = scenario
        self.amap = scenario.amap
        self.perturb = perturb
        self.collect_segments = collect_segments
        # optional cross-run lockstep plan cache (sweeps revisiting the
        # same shape skip recompilation; plans are read-only at run time)
        self._plan_cache = plan_cache
        self._plan_key = plan_key
        # None = auto (use the timeline engine when eligible), True = require
        # it (error when ineligible), False = never
        self._timeline = timeline
        # same tri-state for the bulk lockstep solver, which substitutes for
        # the timeline engine on rank-uniform symbolic programs
        self._lockstep = lockstep
        self._cohorts_flag = cohorts
        self.fabric = resolve_cluster_fabric(
            self.cfg, scenario, fabric=fabric, topology=topology
        )
        self._seq = 0  # cluster-wide emission seq counter (plain int: hot path)
        # (src_device, phase_idx, emit_idx) -> completions seen (coalescing)
        self._emit_counts: Dict[tuple, int] = {}
        # dst device -> marker data writes placed so far (address spacing)
        self._data_marks: Dict[int, int] = {}
        if sanitize:
            # late import: repro_torch.analysis imports this module
            from ..analysis.sanitize import TrafficSanitizer

            self._san = TrafficSanitizer(
                self.amap, self.fabric, cfg.n_devices
            )
        else:
            self._san = None

        t0 = time.perf_counter()
        self.nodes: List[ClusterNode] = []
        for d in range(cfg.n_devices):
            memory = DirectoryMemory(self.amap)
            monitor = (
                MonitorLog(
                    memory,
                    semantics=cfg.monitor_semantics,  # type: ignore[arg-type]
                    wake_latency_cycles=cfg.wake_latency_cycles,
                )
                if cfg.sync == SyncPolicy.SYNCMON
                else None
            )
            target = TargetDevice(
                cfg,
                scenario,
                memory,
                monitor,
                perturb=self._perturb_for(d),
                device_id=d,
                emit_sink=self._on_emit,
                cohorts=cohorts,
            )
            wtt = WriteTrackingTable(clock_ghz=cfg.clock_ghz)
            if self._san is not None:
                memory.add_write_observer(self._san.observer_for(d))
            self.nodes.append(ClusterNode(d, memory, monitor, target, wtt))

        # seed traces (the open-loop degenerate case / warm-start writes) get
        # the same xGMI visibility treatment as the Eidola facade
        for node in self.nodes:
            for w in scenario.traces_for(node.device_id):
                eff = replace(
                    w, wakeup_ns=w.wakeup_ns + cfg.xgmi_enact_latency_ns
                )
                p = self._perturb_for(node.device_id)
                if p is not None:
                    eff = p.jitter_write(eff)
                if self._san is not None:
                    self._san.note_seed_write(node.device_id, eff.addr)
                node.wtt.register(eff)
        # program-construction wall (nodes + seed traces), surfaced in
        # Report.meta["program_stats"] — symbolic programs keep this O(1)
        # per rank in step count where flat construction was O(steps)
        self._construct_wall_s = time.perf_counter() - t0

    # ------------------------------------------------------------------
    # emission: phase completion -> fabric -> destination WTT
    # ------------------------------------------------------------------

    def _perturb_for(self, device: int):
        if isinstance(self.perturb, dict):
            return self.perturb.get(device)
        return self.perturb

    def _on_emit(
        self,
        src: int,
        wg_id: int,
        phase_idx: int,
        spec: PhaseSpec,
        cycle: int,
        count: int = 1,
    ) -> None:
        """TargetDevice sink: fire ``spec.emits`` for a completed phase.

        ``count`` is the number of workgroups the completing cohort stands
        for: "last" coalescing advances its completion counter by that many,
        and "each" emission routes one message per represented workgroup (in
        the same order the per-workgroup interpreter would have).
        """
        n_wgs = self.nodes[src].target.n_wgs
        fire: List[EmitOp] = []
        for i, op in enumerate(spec.emits):
            if op.coalesce == "last":
                key = (src, phase_idx, i)
                seen = self._emit_counts.get(key, 0) + count
                self._emit_counts[key] = seen
                if seen < n_wgs:
                    continue
                fire.append(op)
            else:  # "each": one message per represented workgroup
                fire.extend([op] * count)
        if len(fire) > 1:
            self._route_batch(src, fire, cycle)
        elif fire:
            self._route(src, fire[0], cycle)

    def _route(self, src: int, op: EmitOp, cycle: int) -> None:
        cfg = self.cfg
        if op.dst >= cfg.n_devices:
            raise ValueError(
                f"EmitOp.dst {op.dst} out of range for {cfg.n_devices} devices"
            )
        # the flag write itself is fabric traffic out of the emitting device;
        # payload bytes are accounted by the phase's own TrafficOps
        self.nodes[src].memory.issue_xgmi_out(1, bytes_each=op.size)
        issue_ns = cfg.cycles_to_ns(cycle)
        arrival_ns = self.fabric.transfer(
            src, op.dst, op.payload_bytes + op.size, issue_ns
        )
        if self._san is not None:
            self._san.note_emission(
                src,
                op.dst,
                op.addr if op.addr is not None
                else self.amap.flag_addr(src, op.slot),
                op.payload_bytes + op.size,
                issue_ns,
                arrival_ns,
            )
        self.nodes[op.dst].wtt.register_many(
            self._emit_writes(src, op, arrival_ns, cycle)
        )

    def _route_batch(self, src: int, ops: List[EmitOp], cycle: int) -> None:
        """Route all of one completion's emissions in a single fabric pass.

        The ``all_to_all`` incast fires O(devices) same-cycle bursts per
        completing dispatch phase (O(devices^2) per run); pricing them with
        :meth:`FabricModel.transfer_batch` replaces that many python routing
        calls with one cumulative sum per egress port, and the resulting
        marker+flag writes land per destination through
        :meth:`WriteTrackingTable.register_many` — one heap restructure and
        one calendar hook per (source, destination) pair instead of ~9 of
        each.  Bit-identical to the sequential path: registration order,
        seqs, per-table reg_nos, and port FIFO order are all preserved.
        """
        cfg = self.cfg
        for op in ops:
            if op.dst >= cfg.n_devices:
                raise ValueError(
                    f"EmitOp.dst {op.dst} out of range for "
                    f"{cfg.n_devices} devices"
                )
        mem = self.nodes[src].memory
        for op in ops:
            mem.issue_xgmi_out(1, bytes_each=op.size)
        issue_ns = cfg.cycles_to_ns(cycle)
        arrivals = self.fabric.transfer_batch(
            src,
            [op.dst for op in ops],
            [op.payload_bytes + op.size for op in ops],
            issue_ns,
        )
        if self._san is not None:
            for op, arrival_ns in zip(ops, arrivals):
                self._san.note_emission(
                    src,
                    op.dst,
                    op.addr if op.addr is not None
                    else self.amap.flag_addr(src, op.slot),
                    op.payload_bytes + op.size,
                    issue_ns,
                    arrival_ns,
                )
        # writes are built in emission order (Cluster seqs identical to the
        # per-op path) and grouped per destination WTT; within one table the
        # batch preserves that order, so reg_nos — the pop tie-break — are
        # assigned exactly as sequential registration would have
        per_dst: Dict[int, List[RegistrationLike]] = {}
        for op, arrival_ns in zip(ops, arrivals):
            ws = self._emit_writes(src, op, arrival_ns, cycle)
            bucket = per_dst.get(op.dst)
            if bucket is None:
                per_dst[op.dst] = ws
            else:
                bucket.extend(ws)
        for dst, ws in per_dst.items():
            self.nodes[dst].wtt.register_many(ws)

    def _emit_writes(
        self, src: int, op: EmitOp, arrival_ns: float, cycle: int
    ) -> List[RegistrationLike]:
        """The registered writes (markers + flag) of one routed emission,
        enforcing causality: a write emitted at ``cycle`` can never become
        visible in the same cycle (jitter perturbations could otherwise pull
        it into the past, which the two engines would order differently).

        Without a perturbation on the destination, the marker burst is
        returned as one :class:`LazyWriteRun` descriptor instead of
        ``data_writes`` materialized dataclasses — the WTT synthesizes the
        members at enactment with the identical wakeup expression and a
        contiguous seq/reg_no block, so pop order and counters are
        bit-identical (the incast registration cost drops from O(devices^2)
        dataclasses per run to O(devices) descriptors).
        """
        cfg = self.cfg
        arrival_ns += cfg.xgmi_enact_latency_ns
        addr = op.addr if op.addr is not None else self.amap.flag_addr(src, op.slot)
        # per-destination constants hoisted out of the marker loop (the
        # all_to_all incast builds O(devices^2) marker writes per run)
        p = self._perturb_for(op.dst)
        min_ns = cfg.cycles_to_ns(cycle + 1)
        seq = self._seq
        out: List[RegistrationLike] = []
        if cfg.include_data_writes and op.data_writes > 0:
            lead = min(cfg.data_write_lead_ns, arrival_ns)
            t0 = arrival_ns - lead
            base = self._data_marks.get(op.dst, 0)
            self._data_marks[op.dst] = base + op.data_writes
            mark_data = 0xC0 + (src % 16)
            mark_base = self.amap.partial_base + base * 64
            if p is None:
                out.append(
                    LazyWriteRun(
                        count=op.data_writes,
                        base_ns=t0,
                        span_ns=lead,
                        addr_base=mark_base,
                        addr_stride=64,
                        data=mark_data,
                        size=8,
                        src=src,
                        seq0=seq,
                        min_ns=min_ns,
                    )
                )
                seq += op.data_writes
            else:
                for k in range(op.data_writes):
                    w = RegisteredWrite(
                        wakeup_ns=t0 + lead * (k + 1) / (op.data_writes + 1),
                        addr=mark_base + k * 64,
                        data=mark_data,
                        size=8,
                        src=src,
                        seq=seq,
                    )
                    seq += 1
                    w = p.jitter_write(w)
                    if w.wakeup_ns < min_ns:
                        w = replace(w, wakeup_ns=min_ns)
                    out.append(w)
        w = RegisteredWrite(
            wakeup_ns=arrival_ns,
            addr=addr,
            data=op.data,
            size=op.size,
            src=src,
            seq=seq,
        )
        seq += 1
        if p is not None:
            w = p.jitter_write(w)
        if w.wakeup_ns < min_ns:
            w = replace(w, wakeup_ns=min_ns)
        out.append(w)
        self._seq = seq
        return out

    # ------------------------------------------------------------------
    # running
    # ------------------------------------------------------------------

    def run(self):
        """Drive all devices to completion; return an aggregate Report."""
        from .simulator import Report  # late import (simulator imports target)

        cfg = self.cfg
        if cfg.engine == EngineKind.VECTOR:
            raise NotImplementedError(
                "closed-loop cluster simulation requires EngineKind.CYCLE or "
                "EngineKind.EVENT (the vectorized engine is replay-only)"
            )
        # The timeline engine is a faster implementation of the event
        # engine's semantics (bit-identical counters/segments), so it
        # substitutes for EngineKind.EVENT when the lockstep-lane invariant
        # holds; timeline=True makes ineligibility an error instead of a
        # silent fallback.
        use_timeline = False
        lockstep_used = False
        tl_reason: Optional[str] = None
        if cfg.engine == EngineKind.EVENT and self._timeline is not False:
            if not self._cohorts_flag:
                tl_reason = "cohorts=False forces the per-workgroup interpreter"
            else:
                from .cohort_timeline import timeline_support

                tl_reason = timeline_support(self)
            use_timeline = tl_reason is None
        elif self._timeline is True:
            tl_reason = "timeline engine requires EngineKind.EVENT"
        if self._timeline is True and not use_timeline:
            raise ValueError(
                f"timeline engine requested but unavailable: {tl_reason}"
            )
        if self._lockstep is True and not use_timeline:
            raise ValueError(
                "lockstep solver requested but unavailable: it substitutes "
                "for the timeline engine, which is not in use here "
                f"({tl_reason or 'engine is not EngineKind.EVENT'})"
            )
        lockstep_reason: Optional[str] = None
        if use_timeline:
            # the bulk lockstep solver substitutes for the timeline engine
            # when every rank (or every rank of each program group, on the
            # multi-tier presets) runs a group-uniform symbolic program;
            # anything else falls back to the generic timeline
            ls_reason: Optional[str] = None
            ls_engine = None
            if self._lockstep is not False:
                from .lockstep import LockstepEngine, lockstep_support

                ls_reason = lockstep_support(self)
                if ls_reason is None:
                    ls_engine = LockstepEngine(self)
                    cache = self._plan_cache
                    key = self._plan_key
                    cached = (
                        cache.get(key)
                        if cache is not None and key is not None
                        else None
                    )
                    ls_reason = ls_engine.compile(reuse=cached)
                    if (
                        ls_reason is None
                        and cached is None
                        and cache is not None
                        and key is not None
                    ):
                        cache[key] = ls_engine.plan_handle()
            else:
                ls_reason = "lockstep=False disables the bulk solver"
            if self._lockstep is True and ls_reason is not None:
                raise ValueError(
                    f"lockstep solver requested but unavailable: {ls_reason}"
                )
            res = None
            if ls_reason is None:
                from .lockstep import UnsupportedProgram

                try:
                    res = ls_engine.run()
                    lockstep_used = True
                except UnsupportedProgram as exc:
                    # the solver mutates cluster state only in its final
                    # write-back, so a mid-solve refusal (e.g. a run-time
                    # route spot-check) falls back to the timeline cleanly
                    ls_reason = f"lockstep solve failed: {exc}"
                    if self._lockstep is True:
                        raise ValueError(
                            "lockstep solver requested but unavailable: "
                            f"{ls_reason}"
                        ) from exc
            if res is None:
                from .cohort_timeline import TimelineEngine

                res = TimelineEngine(self).run()
            lockstep_reason = "engaged" if lockstep_used else ls_reason
            engine_name = "event"  # same semantics & counters as the event
            # engine; meta["engine_impl"] records the implementation
        else:
            engine = (
                CyclePollEngine()
                if cfg.engine == EngineKind.CYCLE
                else EventQueueEngine()
            )
            res = engine.run_nodes([(n.target, n.wtt) for n in self.nodes])
            engine_name = engine.name
            why = tl_reason or "engine is not EngineKind.EVENT"
            lockstep_reason = (
                "lockstep solver substitutes for the timeline engine, "
                f"which is not in use here ({why})"
            )
        if self._san is not None:
            self._san.check()

        traffic: Dict[str, int] = {}
        per_device: Dict[int, Dict[str, int]] = {}
        monitor_stats: Dict[str, int] = {}
        segments: List[Segment] = []
        spans: Dict[int, float] = {}
        for node in self.nodes:
            td = node.memory.traffic.as_dict()
            per_device[node.device_id] = td
            for k, v in td.items():
                traffic[k] = traffic.get(k, 0) + v
            if node.monitor is not None:
                for k, v in node.monitor.stats.items():
                    monitor_stats[k] = monitor_stats.get(k, 0) + v
            spans[node.device_id] = cfg.cycles_to_ns(
                node.target.kernel_end_cycle
            )
            if self.collect_segments:
                segments.extend(node.target.collect_segments())
        # symbolic-vs-materialized program accounting (after the run, so the
        # materialized count reflects what the engines actually expanded)
        progs: Dict[int, object] = {}
        for node in self.nodes:
            for c in node.target.cohorts:
                progs.setdefault(id(c.phases), c.phases)
        sym = [p for p in progs.values() if isinstance(p, SymbolicProgram)]
        program_stats = {
            "symbolic_programs": len(sym),
            "flat_programs": len(progs) - len(sym),
            "segments": sum(len(p.segments) for p in sym),
            "program_phases": sum(len(p) for p in progs.values()),
            "materialized_phases": sum(len(p._memo) for p in sym)
            + sum(
                len(p)
                for p in progs.values()
                if not isinstance(p, SymbolicProgram)
            ),
            "construct_wall_s": self._construct_wall_s,
            "lockstep": lockstep_used,
        }
        return Report(
            engine=engine_name,
            sync=cfg.sync.value,
            traffic=traffic,
            flag_reads=traffic.get("flag_reads", 0),
            nonflag_reads=traffic.get("nonflag_reads", 0),
            kernel_span_ns=max(spans.values()) if spans else 0.0,
            sim_cycles=res.sim_cycles,
            wall_time_s=res.wall_time_s,
            wtt_registered=sum(n.wtt.stats.registered for n in self.nodes),
            wtt_enacted=sum(n.wtt.stats.enacted for n in self.nodes),
            wtt_head_polls=res.head_polls,
            scenario=self.scenario.name,
            monitor_stats=monitor_stats,
            segments=segments,
            meta={
                "closed_loop": True,
                "sanitized": self._san is not None,
                "engine_impl": "timeline" if use_timeline else engine_name,
                "lockstep_reason": lockstep_reason,
                "program_stats": program_stats,
                **(
                    {"wall_breakdown": res.breakdown}
                    if res.breakdown is not None
                    else {}
                ),
                "device_spans_ns": spans,
                "fabric": dict(self.fabric.stats),
                "fabric_name": self.fabric.spec.name,
                "n_nodes": self.fabric.n_nodes,
                "devices_per_node": self.fabric.devices_per_node,
                **{f"param_{k}": v for k, v in self.scenario.params.items()},
            },
            n_devices=cfg.n_devices,
            per_device=per_device,
            closed_loop=True,
        )
