"""Pipeline-parallel p2p send/recv as an Eidola scenario.

The detailed device is one interior stage of a pipeline: for every microbatch
it (1) waits for the previous stage's activation hand-off — the upstream
eidolon pushes the activation tensor as data writes, then a per-microbatch
arrival flag, the TPU analogue being a DMA-completion semaphore — (2) runs the
stage's forward compute, and (3) pushes its own activations to the next stage
over the fabric.

One flag slot per microbatch keeps successive hand-offs independent (a flag is
write-once, so reusing one address would make every wait after the first free).
The upstream cadence is derived from the collective-permute cost of the
activation tensor in :mod:`repro_torch.core.topology`, stretched by
``bubble_factor`` to model the upstream stage's own compute time.
"""

from __future__ import annotations

import math
from typing import List, Optional

from ..config import SimConfig
from ..events import TraceBundle, register_phase
from ..memory import AddressMap
from ..scenario import (
    Affine,
    EmitOp,
    LoopEmit,
    LoopPhase,
    LoopSpec,
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

__all__ = ["PipelineP2PScenario"]

register_phase("fwd_compute", color="green", glyph="f")
register_phase("p2p_send", color="blue", glyph=">")


@register_scenario
class PipelineP2PScenario(Scenario):
    """Pipeline stage: per-microbatch activation wait -> compute -> p2p send."""

    name = "pipeline_p2p"
    closed_loop_capable = True

    def __init__(
        self,
        cfg: SimConfig,
        amap: Optional[AddressMap] = None,
        *,
        n_microbatches: int = 8,
        activation_bytes: int = 1 << 19,
        compute_scale: float = 4.0,
        bubble_factor: float = 1.25,
        writes_per_microbatch: int = 4,
        interval_ns: Optional[float] = None,
        closed_loop: bool = False,
        devices_per_node: Optional[int] = None,
        fabric=None,
        link_bw=None,
        hw: HardwareSpec = V5E,
    ):
        super().__init__(cfg, amap)
        if n_microbatches <= 0 or activation_bytes <= 0:
            raise ValueError("n_microbatches and activation_bytes must be positive")
        self.n_microbatches = int(n_microbatches)
        self.activation_bytes = int(activation_bytes)
        self.compute_scale = float(compute_scale)
        self.writes_per_microbatch = int(writes_per_microbatch)
        self.closed_loop = bool(closed_loop)
        self.devices_per_node = devices_per_node
        self.hw = hw
        self.upstream = 1  # previous stage
        # next stage: where the p2p_send traffic is headed (trace metadata;
        # outgoing writes are aggregate counters, not per-address)
        self.downstream = 2 if cfg.n_devices > 2 else 1
        # Closed-loop fabric shape: consecutive pipeline stages share a node
        # until a stage boundary crosses a node boundary, where the hand-off
        # rides the DCI uplink (flat when devices_per_node is unset, fabric=
        # selects any registered preset).  The open-loop cadence keeps the
        # flat single-tier algebra.
        self._setup_fabric(
            devices_per_node=devices_per_node, hw=hw, fabric=fabric,
            link_bw=link_bw,
        )
        # one flag slot per microbatch, each stage writing its own column
        self.amap.claim_flag_block("pipe_microbatch", 0, self.n_microbatches)
        self.cost = Topology.flat_ring(
            cfg.n_devices, axis="pp", hw=hw
        ).collective("collective-permute", self.activation_bytes, "pp")
        if interval_ns is not None:
            self.interval_ns = float(interval_ns)
        else:
            self.interval_ns = self.cost.time_s * 1e9 * float(bubble_factor)
        self.params = {
            "n_microbatches": self.n_microbatches,
            "activation_bytes": self.activation_bytes,
            "interval_ns": self.interval_ns,
            "closed_loop": self.closed_loop,
            "devices_per_node": self.devices_per_node,
            "fabric": self.fabric_name,
        }

    @classmethod
    def default_amap(cls, cfg: SimConfig) -> AddressMap:
        # worst case a caller re-instantiates with more microbatches on the
        # same map; 64 slots cover the defaults with headroom.  At 4092+
        # devices 64 slots overrun the default flag/partial gap (layout
        # prover finding), so clear the partial region past the pool.
        return AddressMap(
            n_devices=cfg.n_devices, flag_slots=64
        ).with_partial_clearance()

    # ------------------------------------------------------------------

    def _shares(self) -> tuple:
        cfg = self.cfg
        share = max(1, self.activation_bytes // cfg.workgroups)
        sectors = math.ceil(share / cfg.sector_bytes)
        io_cycles = max(1, math.ceil(sectors / cfg.wg_sector_throughput))
        fwd_cycles = max(1, math.ceil(io_cycles * self.compute_scale))
        return share, sectors, io_cycles, fwd_cycles

    def _check_slots(self) -> None:
        if self.n_microbatches > self.amap.flag_slots:
            raise ValueError(
                f"{self.n_microbatches} microbatches need flag_slots >= "
                f"{self.n_microbatches} (amap has {self.amap.flag_slots})"
            )

    def _stamp(self, phases) -> List[WGProgram]:
        """Stamp per-WG program records against one shared phase program.

        Phases are workgroup-invariant — only (wg, cu, dispatch_cycle) vary —
        so sharing the program removes the O(workgroups) construction factor
        and feeds the cohort interpreter's identity-based grouping."""
        cfg = self.cfg
        shared = phases if isinstance(phases, SymbolicProgram) else tuple(phases)
        return [
            WGProgram(
                wg=wg,
                cu=wg % cfg.n_cus,
                dispatch_cycle=(wg // cfg.n_cus) * cfg.dispatch_stagger_cycles,
                phases=shared,
            )
            for wg in range(cfg.workgroups)
        ]

    def _microbatch_flag(self) -> Affine:
        """Per-microbatch wait address, affine in the microbatch index."""
        return affine_of(
            lambda m: self.amap.flag_addr(self.upstream, slot=m),
            0,
            self.n_microbatches,
        )

    def _flat_open_phases(self):
        """Pre-refactor flat open-loop construction — the reference oracle
        for :meth:`_symbolic_open_phases` (property-tested)."""
        cfg = self.cfg
        share, sectors, io_cycles, fwd_cycles = self._shares()
        phases: List[PhaseSpec] = []
        for m in range(self.n_microbatches):
            phases.append(
                PhaseSpec(
                    "wait_flags",
                    wait_addrs=(self.amap.flag_addr(self.upstream, slot=m),),
                )
            )
            phases.append(
                PhaseSpec(
                    "fwd_compute",
                    fwd_cycles,
                    traffic=(
                        reads(sectors, cfg.sector_bytes),
                        local_writes(1, share),
                    ),
                )
            )
            phases.append(
                PhaseSpec(
                    "p2p_send",
                    io_cycles,
                    traffic=(xgmi_out(1, share), xgmi_out(1, 8)),
                )
            )
        return tuple(phases)

    def _symbolic_open_phases(self) -> SymbolicProgram:
        """One :class:`LoopSpec` over microbatches — O(1) objects in
        ``n_microbatches``."""
        cfg = self.cfg
        share, sectors, io_cycles, fwd_cycles = self._shares()
        return SymbolicProgram(
            (
                LoopSpec(
                    self.n_microbatches,
                    (
                        LoopPhase(
                            "wait_flags", wait_addrs=(self._microbatch_flag(),)
                        ),
                        LoopPhase(
                            "fwd_compute",
                            fwd_cycles,
                            traffic=(
                                reads(sectors, cfg.sector_bytes),
                                local_writes(1, share),
                            ),
                        ),
                        LoopPhase(
                            "p2p_send",
                            io_cycles,
                            traffic=(xgmi_out(1, share), xgmi_out(1, 8)),
                        ),
                    ),
                ),
            )
        )

    def programs(self) -> List[WGProgram]:
        self._check_slots()
        return self._stamp(self._symbolic_open_phases())

    def programs_for(self, device: int) -> List[WGProgram]:
        """Closed loop: device ``r`` is pipeline stage ``r`` (0 = source).

        The source stage free-runs its microbatches; every other stage waits
        for the upstream stage's per-microbatch arrival flag, runs forward
        compute, and — except for the final stage — pushes activations plus
        the hand-off flag downstream.  The microbatch cadence of interior
        stages then *emerges* from stage-0 compute + link serialization
        instead of the open-loop ``interval_ns`` constant.
        """
        if not self.closed_loop:
            return super().programs_for(device)
        self._check_slots()
        return self._stamp(self._symbolic_closed_phases(device))

    def _flat_closed_phases(self, device: int):
        """Pre-refactor flat closed-loop construction — the reference oracle
        for :meth:`_symbolic_closed_phases` (property-tested)."""
        cfg = self.cfg
        share, sectors, io_cycles, fwd_cycles = self._shares()
        n = cfg.n_devices
        first = device == 0
        last = device == n - 1
        phases: List[PhaseSpec] = []
        for m in range(self.n_microbatches):
            if not first:
                phases.append(
                    PhaseSpec(
                        "wait_flags",
                        wait_addrs=(
                            self.amap.flag_addr(device - 1, slot=m),
                        ),
                    )
                )
            phases.append(
                PhaseSpec(
                    "fwd_compute",
                    fwd_cycles,
                    traffic=(
                        reads(sectors, cfg.sector_bytes),
                        local_writes(1, share),
                    ),
                )
            )
            if last:
                # final stage: write the microbatch result locally
                phases.append(
                    PhaseSpec(
                        "p2p_send",
                        io_cycles,
                        traffic=(local_writes(1, share),),
                    )
                )
            else:
                phases.append(
                    PhaseSpec(
                        "p2p_send",
                        io_cycles,
                        traffic=(xgmi_out(1, share),),
                        emits=(
                            EmitOp(
                                device + 1,
                                slot=m,
                                payload_bytes=self.activation_bytes,
                                data_writes=self.writes_per_microbatch,
                            ),
                        ),
                    )
                )
        return tuple(phases)

    def _symbolic_closed_phases(self, device: int) -> SymbolicProgram:
        """One :class:`LoopSpec` over microbatches, body shaped by the
        stage's position (source stages free-run, the final stage keeps its
        results local) — O(1) objects in ``n_microbatches``."""
        cfg = self.cfg
        share, sectors, io_cycles, fwd_cycles = self._shares()
        n = cfg.n_devices
        first = device == 0
        last = device == n - 1
        body: List[LoopPhase] = []
        if not first:
            wait_aff = affine_of(
                lambda m: self.amap.flag_addr(device - 1, slot=m),
                0,
                self.n_microbatches,
            )
            body.append(LoopPhase("wait_flags", wait_addrs=(wait_aff,)))
        body.append(
            LoopPhase(
                "fwd_compute",
                fwd_cycles,
                traffic=(
                    reads(sectors, cfg.sector_bytes),
                    local_writes(1, share),
                ),
            )
        )
        if last:
            body.append(
                LoopPhase("p2p_send", io_cycles, traffic=(local_writes(1, share),))
            )
        else:
            body.append(
                LoopPhase(
                    "p2p_send",
                    io_cycles,
                    traffic=(xgmi_out(1, share),),
                    emits=(
                        LoopEmit(
                            Affine(device + 1),
                            slot=Affine(0, 1),
                            payload_bytes=self.activation_bytes,
                            data_writes=self.writes_per_microbatch,
                        ),
                    ),
                )
            )
        return SymbolicProgram(
            (LoopSpec(self.n_microbatches, tuple(body)),),
            group="head" if first else ("tail" if last else "interior"),
        )

    def traces(self) -> TraceBundle:
        cfg = self.cfg
        bundle = TraceBundle(
            meta={
                "scenario": self.name,
                "n_devices": cfg.n_devices,
                "n_microbatches": self.n_microbatches,
                "activation_bytes": self.activation_bytes,
                "interval_ns": self.interval_ns,
                "upstream": self.upstream,
                "downstream": self.downstream,
            }
        )
        lead = cfg.data_write_lead_ns
        for m in range(self.n_microbatches):
            flag_t = self.interval_ns * (m + 1)
            if cfg.include_data_writes and self.writes_per_microbatch > 0:
                t0 = max(0.0, flag_t - lead)
                for i in range(self.writes_per_microbatch):
                    t = t0 + (flag_t - t0) * (i + 1) / (self.writes_per_microbatch + 1)
                    bundle.add(
                        wakeup_ns=t,
                        addr=self.amap.partial_base
                        + (m * self.writes_per_microbatch + i) * 64,
                        data=0xD0 + m % 16,
                        size=8,
                        src=self.upstream,
                    )
            bundle.add(
                wakeup_ns=flag_t,
                addr=self.amap.flag_addr(self.upstream, slot=m),
                data=1,
                size=8,
                src=self.upstream,
            )
        return bundle
