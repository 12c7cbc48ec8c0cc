"""All-to-all (MoE-dispatch-shaped) incast as an Eidola scenario.

Expert-parallel MoE dispatch is the canonical irregular pattern the paper
motivates: every device simultaneously pushes a token shard to every other
device, then barriers before the expert computation.  From the detailed
device's perspective this is an *incast*: n-1 peers each land a burst of data
writes followed by a completion flag, and every workgroup waits on all n-1
flags (exactly the fused kernel's wait structure, but with the compute phases
on the other side of the barrier).

Peer arrival times are the all-to-all cost from :mod:`repro_torch.core.topology`
plus a configurable per-peer skew — sweeping ``skew_ns`` reproduces the
incast-straggler effect (flag traffic grows linearly in the last arrival under
SPIN, stays flat under SyncMon).
"""

from __future__ import annotations

import math
from typing import List, Optional

from ..config import SimConfig
from ..events import TraceBundle, register_phase
from ..memory import AddressMap
from ..scenario import (
    AffineRun,
    EmitOp,
    EmitRun,
    LoopPhase,
    PhaseSpec,
    Scenario,
    SymbolicProgram,
    WGProgram,
    affine_of,
    local_writes,
    reads,
    register_scenario,
    xgmi_out,
)
from ..topology import HardwareSpec, Topology, V5E

__all__ = ["AllToAllScenario"]

register_phase("a2a_dispatch", color="green", glyph="d")
register_phase("a2a_combine", color="brown", glyph="c")


@register_scenario
class AllToAllScenario(Scenario):
    """MoE-dispatch-shaped all-to-all incast with per-peer arrival skew."""

    name = "all_to_all"
    closed_loop_capable = True

    def __init__(
        self,
        cfg: SimConfig,
        amap: Optional[AddressMap] = None,
        *,
        tokens_per_device: int = 4096,
        token_bytes: int = 512,
        skew_ns: float = 2_000.0,
        writes_per_peer: int = 8,
        closed_loop: bool = False,
        devices_per_node: Optional[int] = None,
        fabric=None,
        link_bw=None,
        hw: HardwareSpec = V5E,
    ):
        super().__init__(cfg, amap)
        if tokens_per_device <= 0 or token_bytes <= 0:
            raise ValueError("tokens_per_device and token_bytes must be positive")
        self.tokens_per_device = int(tokens_per_device)
        self.token_bytes = int(token_bytes)
        self.skew_ns = float(skew_ns)
        self.writes_per_peer = int(writes_per_peer)
        self.closed_loop = bool(closed_loop)
        self.devices_per_node = devices_per_node
        self.hw = hw
        k = cfg.n_devices
        self.payload_bytes = self.tokens_per_device * self.token_bytes
        # Closed-loop fabric shape (flat when devices_per_node is unset,
        # fabric= selects any registered preset); the open-loop arrival
        # schedule keeps the flat single-tier algebra.
        self._setup_fabric(
            devices_per_node=devices_per_node, hw=hw, fabric=fabric,
            link_bw=link_bw,
        )
        # every rank announces dispatch completion in its slot-0 column
        self.amap.claim_flag_block("a2a_dispatch_barrier", 0, 1)
        self.cost = Topology.flat_ring(k, axis="ep", hw=hw).collective(
            "all-to-all", self.payload_bytes, "ep"
        )
        self.base_arrival_ns = self.cost.time_s * 1e9
        self.params = {
            "tokens_per_device": self.tokens_per_device,
            "token_bytes": self.token_bytes,
            "skew_ns": self.skew_ns,
            "closed_loop": self.closed_loop,
            "devices_per_node": self.devices_per_node,
            "fabric": self.fabric_name,
        }

    # ------------------------------------------------------------------

    def _shares(self) -> tuple:
        """Per-WG (bytes, sectors, cycles) of the local token shard."""
        cfg = self.cfg
        share = max(1, self.payload_bytes // cfg.workgroups)
        sectors = math.ceil(share / cfg.sector_bytes)
        cycles = max(1, math.ceil(sectors / cfg.wg_sector_throughput))
        return share, sectors, cycles

    def _flat_phases(self, rank: int, *, emit: bool):
        """Pre-refactor flat phase construction — O(devices) wait addresses
        and EmitOps per rank.  Kept as the reference oracle for
        ``SymbolicProgram.expand()`` equivalence (property-tested); runtime
        paths use :meth:`_symbolic_phases`."""
        cfg = self.cfg
        n_peers = cfg.n_egpus
        share, sectors, cycles = self._shares()
        peer_share = max(1, share // cfg.n_devices)
        peer_chunk = max(1, self.payload_bytes // cfg.n_devices)
        wait_addrs = tuple(
            self.amap.flag_addr(g) for g in range(cfg.n_devices) if g != rank
        )
        emits = (
            tuple(
                EmitOp(
                    g,
                    slot=0,
                    payload_bytes=peer_chunk,
                    data_writes=self.writes_per_peer,
                )
                for g in range(cfg.n_devices)
                if g != rank
            )
            if emit
            else ()
        )
        # open loop: each WG's flag pushes are closed-form traffic; closed
        # loop: the coalesced EmitOps account the (one-per-peer) flag writes
        dispatch_traffic = [
            reads(sectors, cfg.sector_bytes),
            xgmi_out(n_peers, peer_share),
        ]
        if not emit:
            dispatch_traffic.append(xgmi_out(n_peers, 8))
        return (
            # route + push our token shard to every peer, then the
            # completion flag write to each of them
            PhaseSpec(
                "a2a_dispatch",
                cycles,
                traffic=tuple(dispatch_traffic),
                emits=emits,
            ),
            # incast barrier on every peer's completion flag
            PhaseSpec("wait_flags", wait_addrs=wait_addrs),
            # combine: read the n-1 received shards + our own
            PhaseSpec(
                "a2a_combine",
                cycles * cfg.n_devices,
                traffic=(
                    reads(sectors * cfg.n_devices, cfg.sector_bytes),
                    local_writes(1, share),
                ),
            ),
        )

    def _symbolic_phases(self, rank: int, *, emit: bool) -> SymbolicProgram:
        """The same program as :meth:`_flat_phases`, compressed: the per-peer
        fan-out and the incast barrier's wait list become *within-phase* runs
        (:class:`EmitRun` / :class:`AffineRun`), split around our own rank —
        O(1) objects per rank in device count."""
        cfg = self.cfg
        n = cfg.n_devices
        n_peers = cfg.n_egpus
        share, sectors, cycles = self._shares()
        peer_share = max(1, share // n)
        peer_chunk = max(1, self.payload_bytes // n)
        # barrier flag addresses are affine in the writer id (verified over
        # the full device range, not assumed from the AddressMap layout)
        flag_aff = affine_of(lambda g: self.amap.flag_addr(g), 0, n)
        below, above = rank, n - 1 - rank
        wait_entries = tuple(
            AffineRun(flag_aff.at(g0), flag_aff.step, cnt)
            for g0, cnt in ((0, below), (rank + 1, above))
            if cnt
        )
        emit_entries = (
            tuple(
                EmitRun(
                    cnt,
                    dst0=g0,
                    payload_bytes=peer_chunk,
                    data_writes=self.writes_per_peer,
                )
                for g0, cnt in ((0, below), (rank + 1, above))
                if cnt
            )
            if emit
            else ()
        )
        dispatch_traffic = [
            reads(sectors, cfg.sector_bytes),
            xgmi_out(n_peers, peer_share),
        ]
        if not emit:
            dispatch_traffic.append(xgmi_out(n_peers, 8))
        return SymbolicProgram(
            (
                LoopPhase(
                    "a2a_dispatch",
                    cycles,
                    traffic=tuple(dispatch_traffic),
                    emits=emit_entries,
                ),
                LoopPhase("wait_flags", wait_addrs=wait_entries),
                PhaseSpec(
                    "a2a_combine",
                    cycles * n,
                    traffic=(
                        reads(sectors * n, cfg.sector_bytes),
                        local_writes(1, share),
                    ),
                ),
            ),
            group="all",
        )

    def _rank_programs(self, rank: int, *, emit: bool) -> List[WGProgram]:
        """Dispatch -> incast barrier -> combine, for one rank.

        ``rank`` waits on every peer's completion flag; with ``emit`` its own
        dispatch phase pushes a completion flag to each peer over the fabric
        (per-rank dispatch skew then *emerges* from dispatch compute + link
        serialization instead of the open-loop ``skew_ns`` constant).

        Phases are workgroup-invariant, so per-WG records are stamped against
        one shared :class:`SymbolicProgram` — O(1) construction per rank in
        device count, and the shared identity feeds the cohort interpreter's
        grouping.
        """
        cfg = self.cfg
        shared = self._symbolic_phases(rank, emit=emit)
        return [
            WGProgram(
                wg=wg,
                cu=wg % cfg.n_cus,
                dispatch_cycle=(wg // cfg.n_cus) * cfg.dispatch_stagger_cycles,
                phases=shared,
            )
            for wg in range(cfg.workgroups)
        ]

    def programs(self) -> List[WGProgram]:
        return self._rank_programs(0, emit=False)

    def programs_for(self, device: int) -> List[WGProgram]:
        if not self.closed_loop:
            return super().programs_for(device)
        return self._rank_programs(device, emit=True)

    def traces(self) -> TraceBundle:
        cfg = self.cfg
        bundle = TraceBundle(
            meta={
                "scenario": self.name,
                "n_devices": cfg.n_devices,
                "payload_bytes": self.payload_bytes,
                "base_arrival_ns": self.base_arrival_ns,
                "skew_ns": self.skew_ns,
            }
        )
        lead = cfg.data_write_lead_ns
        for g in range(1, cfg.n_devices):
            flag_t = self.base_arrival_ns + (g - 1) * self.skew_ns
            if cfg.include_data_writes and self.writes_per_peer > 0:
                t0 = max(0.0, flag_t - lead)
                for i in range(self.writes_per_peer):
                    t = t0 + (flag_t - t0) * (i + 1) / (self.writes_per_peer + 1)
                    bundle.add(
                        wakeup_ns=t,
                        addr=self.amap.partial_base
                        + (g * self.writes_per_peer + i) * 64,
                        data=0xE0 + g,
                        size=8,
                        src=g,
                    )
            bundle.add(
                wakeup_ns=flag_t,
                addr=self.amap.flag_addr(g),
                data=1,
                size=8,
                src=g,
            )
        return bundle
