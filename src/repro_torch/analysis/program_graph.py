"""Lowering phase programs into an inter-rank wait/emit dependency graph
(port of ``repro/analysis/program_graph.py``).

A scenario's synchronization structure is fully determined before any cycle is
simulated: every :class:`repro_torch.core.scenario.PhaseSpec` either *waits* on flag
addresses (decodable through the scenario's :class:`AddressMap` back to a
``(src_device, slot)`` pair) or *emits* flags into peer memories
(:class:`repro_torch.core.scenario.EmitOp`, landing at ``flag_addr(src, slot)`` in
the destination's symmetric heap).  This module lowers the per-rank programs
into that graph — lanes, wait sites, emit sites, and externally-scheduled
trace writes — which :mod:`repro_torch.analysis.verify` then checks for deadlock
cycles, unmatched synchronization, write races, and fabric reachability
without running an engine.

Terminology:

* **lane** — all workgroups of one device that share a phase tuple (the same
  grouping the cohort interpreter uses).  Every built-in scenario stamps one
  shared tuple per rank, so a lane is normally "the rank's program"; devices
  with heterogeneous programs get one lane per distinct tuple.
* **flag key** — ``(owner_device, address)``: a flag variable in one device's
  memory.  Wait sites reference keys in their own device's memory; emit sites
  reference keys in the destination's.
* **external flag** — a flag written by a pre-scheduled trace
  (``scenario.traces_for``), i.e. satisfied unconditionally at some time.
  Open-loop scenarios synchronize exclusively through these.

This lowering is *materialized*: iterating ``lane.phases`` expands any
:class:`repro_torch.core.scenario.SymbolicProgram` step by step, so site counts
grow with the step count (O(devices^2) for flat collectives).  At pod scale
use :func:`repro_torch.analysis.verify.verify_symbolic` instead, which checks
rank-uniform symbolic programs in *loop space* — one node per (lane, affine
pattern) via :func:`repro_torch.core.lockstep.plan_stages` — and is cross-checked
against this exact graph at small scale by ``python -m repro_torch.analysis``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.scenario import EmitOp, PhaseSpec, Scenario

__all__ = ["EmitSite", "WaitSite", "Lane", "ProgramGraph"]

FlagKey = Tuple[int, int]  # (owner device, address in its memory)


@dataclass(frozen=True)
class WaitSite:
    """One wait phase observing one flag address."""

    device: int
    lane: int        # index into ProgramGraph.lanes
    phase_idx: int
    phase_name: str
    addr: int        # address in ``device``'s own memory
    src: Optional[int] = None   # decoded writer device, if a flag address
    slot: Optional[int] = None  # decoded flag slot, if a flag address

    def describe(self) -> str:
        what = f"flag 0x{self.addr:x}"
        if self.src is not None:
            what = f"flag(src={self.src}, slot={self.slot})"
        return (
            f"rank {self.device} phase {self.phase_idx} "
            f"{self.phase_name!r} waits on {what}"
        )


@dataclass(frozen=True)
class EmitSite:
    """One :class:`EmitOp` in one phase of one lane."""

    device: int
    lane: int
    phase_idx: int
    phase_name: str
    emit_idx: int    # position within the phase's ``emits`` tuple
    dst: int
    addr: int        # effective address in ``dst``'s memory
    coalesce: str
    slot: Optional[int] = None  # decoded flag slot, if a flag address

    def describe(self) -> str:
        return (
            f"rank {self.device} phase {self.phase_idx} {self.phase_name!r} "
            f"emits to rank {self.dst}"
            + (f" slot {self.slot}" if self.slot is not None else
               f" addr 0x{self.addr:x}")
        )


@dataclass
class Lane:
    """All workgroups of one device sharing a phase tuple."""

    device: int
    index: int                       # global lane id (ProgramGraph.lanes)
    wg_count: int
    phases: Tuple[PhaseSpec, ...]


@dataclass
class ProgramGraph:
    """The lowered wait/emit structure of one scenario instance."""

    scenario_name: str
    n_devices: int
    closed_loop: bool
    lanes: List[Lane] = field(default_factory=list)
    lanes_of: Dict[int, List[int]] = field(default_factory=dict)
    device_wgs: Dict[int, int] = field(default_factory=dict)
    waiters: Dict[FlagKey, List[WaitSite]] = field(default_factory=dict)
    emitters: Dict[FlagKey, List[EmitSite]] = field(default_factory=dict)
    # (device, addr) -> count of pre-scheduled trace writes landing there
    external_flags: Dict[FlagKey, int] = field(default_factory=dict)
    # emit ops whose flag address could not be formed (bad slot/device)
    invalid_emits: List[str] = field(default_factory=list)

    @classmethod
    def from_scenario(cls, scenario: Scenario) -> "ProgramGraph":
        """Lower ``scenario`` (closed loop: every rank's ``programs_for``;
        open loop: device 0's program plus the eidolon trace bundle)."""
        cfg = scenario.cfg
        amap = scenario.amap
        n = cfg.n_devices
        g = cls(
            scenario_name=scenario.name or type(scenario).__name__,
            n_devices=n,
            closed_loop=bool(scenario.closed_loop),
        )
        modeled = range(n) if scenario.closed_loop else range(1)
        for d in modeled:
            programs = scenario.programs_for(d)
            g.device_wgs[d] = len(programs)
            g.lanes_of[d] = []
            seen: Dict[int, Lane] = {}  # id(phases) -> lane
            for p in programs:
                lane = seen.get(id(p.phases))
                if lane is None:
                    lane = Lane(
                        device=d,
                        index=len(g.lanes),
                        wg_count=0,
                        phases=p.phases,
                    )
                    seen[id(p.phases)] = lane
                    g.lanes.append(lane)
                    g.lanes_of[d].append(lane.index)
                lane.wg_count += 1
        for d in modeled:
            for w in scenario.traces_for(d):
                if amap.is_flag(w.addr):
                    key = (d, w.addr)
                    g.external_flags[key] = g.external_flags.get(key, 0) + 1

        for lane in g.lanes:
            for i, ph in enumerate(lane.phases):
                if ph.wait_addrs:
                    for a in ph.wait_addrs:
                        decoded = amap.decode_flag(a)
                        site = WaitSite(
                            device=lane.device,
                            lane=lane.index,
                            phase_idx=i,
                            phase_name=ph.name,
                            addr=a,
                            src=decoded[0] if decoded else None,
                            slot=decoded[1] if decoded else None,
                        )
                        g.waiters.setdefault((lane.device, a), []).append(site)
                for j, op in enumerate(ph.emits):
                    addr = g._effective_addr(amap, lane.device, op)
                    if addr is None:
                        g.invalid_emits.append(
                            f"rank {lane.device} phase {i} {ph.name!r}: "
                            f"EmitOp slot {op.slot} has no address in the "
                            f"scenario's flag layout (flag_slots="
                            f"{amap.flag_slots})"
                        )
                        continue
                    decoded = amap.decode_flag(addr)
                    site = EmitSite(
                        device=lane.device,
                        lane=lane.index,
                        phase_idx=i,
                        phase_name=ph.name,
                        emit_idx=j,
                        dst=op.dst,
                        addr=addr,
                        coalesce=op.coalesce,
                        slot=decoded[1] if decoded else None,
                    )
                    g.emitters.setdefault((op.dst, addr), []).append(site)
        return g

    @staticmethod
    def _effective_addr(amap, src: int, op: EmitOp) -> Optional[int]:
        """The address an emission lands at in ``op.dst``'s memory, or None
        when the flag-slot convention cannot form one (bad slot/device)."""
        if op.addr is not None:
            return op.addr
        try:
            return amap.flag_addr(src, op.slot)
        except ValueError:
            return None

    # ------------------------------------------------------------------
    # derived views used by the checks
    # ------------------------------------------------------------------

    def emit_pairs(self) -> List[Tuple[int, int]]:
        """Sorted distinct ``(src, dst)`` device pairs of all emissions."""
        return sorted({
            (s.device, s.dst) for sites in self.emitters.values()
            for s in sites
        })

    def describe_key(self, key: FlagKey) -> str:
        """Human-readable name of a flag key, decoding the slot convention."""
        device, addr = key
        # decode against any lane's amap-compatible layout: keys were built
        # from one AddressMap, so re-derive (src, slot) from the waiters or
        # emitters that reference the key
        for site in self.waiters.get(key, []):
            if site.src is not None:
                return (
                    f"flag(src={site.src}, slot={site.slot}) "
                    f"in rank {device}'s memory"
                )
        for site in self.emitters.get(key, []):
            if site.slot is not None:
                return (
                    f"flag(src={site.device}, slot={site.slot}) "
                    f"in rank {device}'s memory"
                )
        return f"address 0x{addr:x} in rank {device}'s memory"
