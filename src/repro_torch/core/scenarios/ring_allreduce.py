"""Chunked ring all-reduce as an Eidola scenario.

Devices 0..n-1 form a unidirectional ring (0 -> 1 -> ... -> n-1 -> 0).  A
payload of ``payload_bytes`` is split into n chunks and reduce-scattered then
all-gathered in the textbook 2(n-1) ring steps.  Each step is a
*synchronization event*: the upstream neighbour pushes its chunk (data writes
into the partial region) followed by a per-step flag — one flag slot per ring
step — and every workgroup waits on that flag before reducing/forwarding its
share of the chunk.

Two modes:

* **open loop** (default): only device 0 is detailed; the upstream eidolon's
  arrival schedule is synthesized from the collective cost model in
  :mod:`repro_torch.core.topology` (ring algebra over the configured fabric), so the
  step cadence reflects link bandwidth and hop latency rather than an
  arbitrary constant; ``step_time_ns`` overrides it for controlled sweeps.
* **closed loop** (``closed_loop=True``): every rank runs the same per-step
  program in a :class:`repro_torch.core.cluster.Cluster`; finishing step k *emits*
  the step-k flag to the downstream rank (:class:`repro_torch.core.scenario.EmitOp`
  routed over the fabric model), so nothing is pre-scheduled and a
  perturbation on one rank propagates around the ring.
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

__all__ = ["RingAllReduceScenario"]

register_phase("ring_send", color="green", glyph="s")
register_phase("ring_reduce", color="brown", glyph="+")
register_phase("ring_gather", color="blue", glyph="a")


@register_scenario
class RingAllReduceScenario(Scenario):
    """Chunked ring all-reduce; one wait/flag per ring step."""

    name = "ring_allreduce"
    closed_loop_capable = True

    def __init__(
        self,
        cfg: SimConfig,
        amap: Optional[AddressMap] = None,
        *,
        payload_bytes: int = 1 << 20,
        step_time_ns: Optional[float] = None,
        writes_per_step: int = 4,
        closed_loop: bool = False,
        devices_per_node: Optional[int] = None,
        fabric=None,
        link_bw=None,
        hw: HardwareSpec = V5E,
    ):
        super().__init__(cfg, amap)
        if payload_bytes <= 0:
            raise ValueError("payload_bytes must be positive")
        self.payload_bytes = int(payload_bytes)
        self.writes_per_step = int(writes_per_step)
        self.closed_loop = bool(closed_loop)
        self.devices_per_node = devices_per_node
        self.hw = hw
        k = cfg.n_devices
        self.steps = 2 * (k - 1)
        self.upstream = k - 1
        # Closed-loop fabric shape: the global ring maps onto intra-node ICI
        # rings stitched by DCI uplinks (flat when devices_per_node is unset);
        # fabric= selects any registered interconnect preset instead.
        self._setup_fabric(
            devices_per_node=devices_per_node, hw=hw, fabric=fabric,
            link_bw=link_bw,
        )
        # one flag slot per ring step, every rank writing its own column
        self.amap.claim_flag_block("ring_step", 0, self.steps)
        # Open-loop cadence keeps the flat single-ring collective algebra the
        # trace schedule was always derived from.
        self.cost = Topology.flat_ring(k, axis="ring", hw=hw).collective(
            "all-reduce", self.payload_bytes, "ring"
        )
        if step_time_ns is not None:
            self.step_time_ns = float(step_time_ns)
        else:
            self.step_time_ns = self.cost.time_s * 1e9 / max(1, self.steps)
        self.params = {
            "payload_bytes": self.payload_bytes,
            "step_time_ns": self.step_time_ns,
            "writes_per_step": self.writes_per_step,
            "closed_loop": self.closed_loop,
            "devices_per_node": self.devices_per_node,
            "fabric": self.fabric_name,
        }

    @classmethod
    def default_amap(cls, cfg: SimConfig) -> AddressMap:
        # per-step flag slots overrun the default flag/partial gap beyond
        # ~256 devices; clear the partial region so ring-step waits can
        # never be satisfied by stale data-marker writes
        return AddressMap(
            n_devices=cfg.n_devices, flag_slots=max(1, 2 * (cfg.n_devices - 1))
        ).with_partial_clearance()

    # ------------------------------------------------------------------

    def _wg_share(self) -> tuple:
        """(bytes, sectors, cycles) of one WG's slice of one chunk."""
        cfg = self.cfg
        chunk = max(1, self.payload_bytes // cfg.n_devices)
        share = max(1, chunk // cfg.workgroups)
        sectors = math.ceil(share / cfg.sector_bytes)
        cycles = max(1, math.ceil(sectors / cfg.wg_sector_throughput))
        return share, sectors, cycles

    def _flat_phases(self, rank: int, *, emit: bool):
        """Pre-refactor flat phase construction — O(steps) PhaseSpecs.  Kept
        as the reference oracle for ``SymbolicProgram.expand()`` equivalence
        (property-tested); runtime paths use :meth:`_symbolic_phases`."""
        cfg = self.cfg
        n = cfg.n_devices
        share, sectors, cycles = self._wg_share()
        chunk = max(1, self.payload_bytes // n)
        rs_steps = n - 1
        upstream = (rank - 1) % n
        downstream = (rank + 1) % n

        def flag_out(slot: int):
            if not emit:
                return ()
            return (
                EmitOp(
                    downstream,
                    slot=slot,
                    payload_bytes=chunk,
                    data_writes=self.writes_per_step,
                ),
            )

        phases: List[PhaseSpec] = [
            # step 0: push our own chunk downstream before waiting
            PhaseSpec(
                "ring_send",
                cycles,
                traffic=(reads(sectors, cfg.sector_bytes), xgmi_out(1, share)),
                emits=flag_out(0),
            )
        ]
        for s in range(self.steps):
            phases.append(
                PhaseSpec(
                    "wait_flags",
                    wait_addrs=(self.amap.flag_addr(upstream, slot=s),),
                )
            )
            reducing = s < rs_steps
            last = s == self.steps - 1
            traffic = [
                # incoming chunk + (while reducing) the local accumulator
                reads(sectors * (2 if reducing else 1), cfg.sector_bytes),
                local_writes(1, share),
            ]
            if not last:
                traffic.append(xgmi_out(1, share))
            phases.append(
                PhaseSpec(
                    "ring_reduce" if reducing else "ring_gather",
                    cycles,
                    traffic=tuple(traffic),
                    emits=() if last else flag_out(s + 1),
                )
            )
        return tuple(phases)

    def _symbolic_phases(self, rank: int, *, emit: bool) -> SymbolicProgram:
        """The same program as :meth:`_flat_phases`, compressed: a literal
        send, one :class:`LoopSpec` per ring stage (reduce-scatter /
        all-gather) whose wait address and emit slot are affine in the step
        index k, and a literal tail — O(1) objects per rank in step count."""
        cfg = self.cfg
        n = cfg.n_devices
        share, sectors, cycles = self._wg_share()
        chunk = max(1, self.payload_bytes // n)
        rs_steps = n - 1
        upstream = (rank - 1) % n
        downstream = (rank + 1) % n

        def loop_out(slot: Affine):
            if not emit:
                return ()
            return (
                LoopEmit(
                    Affine(downstream),
                    slot=slot,
                    payload_bytes=chunk,
                    data_writes=self.writes_per_step,
                ),
            )

        # step-k wait address: one flag slot per ring step, the upstream
        # writer's column — derived from the AddressMap rather than assuming
        # its layout (affine_of verifies affinity over the full step range).
        wait_aff = affine_of(
            lambda k: self.amap.flag_addr(upstream, slot=k), 0, self.steps
        )
        wait_body = LoopPhase("wait_flags", wait_addrs=(wait_aff,))
        step_out = loop_out(Affine(1, 1))  # finishing step k emits flag k+1
        segments = [
            PhaseSpec(
                "ring_send",
                cycles,
                traffic=(reads(sectors, cfg.sector_bytes), xgmi_out(1, share)),
                emits=tuple(e.at(0) for e in loop_out(Affine(0))),
            ),
            LoopSpec(
                rs_steps,
                (
                    wait_body,
                    LoopPhase(
                        "ring_reduce",
                        cycles,
                        traffic=(
                            reads(sectors * 2, cfg.sector_bytes),
                            local_writes(1, share),
                            xgmi_out(1, share),
                        ),
                        emits=step_out,
                    ),
                ),
            ),
            LoopSpec(
                self.steps - 1 - rs_steps,
                (
                    wait_body,
                    LoopPhase(
                        "ring_gather",
                        cycles,
                        traffic=(
                            reads(sectors, cfg.sector_bytes),
                            local_writes(1, share),
                            xgmi_out(1, share),
                        ),
                        emits=step_out,
                    ),
                ),
                k0=rs_steps,
            ),
            PhaseSpec(
                "wait_flags", wait_addrs=(wait_aff.at(self.steps - 1),)
            ),
            PhaseSpec(
                "ring_gather",
                cycles,
                traffic=(reads(sectors, cfg.sector_bytes), local_writes(1, share)),
            ),
        ]
        return SymbolicProgram(segments, group="ring")

    def _rank_programs(self, rank: int, *, emit: bool) -> List[WGProgram]:
        """Per-step ring program of one rank; with ``emit`` the step-k flag is
        pushed downstream when (the last WG of) step k completes.

        The phase list is identical for every workgroup of the rank — only
        (wg, cu, dispatch_cycle) vary — so build ONE shared
        :class:`SymbolicProgram` and stamp per-WG program records against it.
        Construction is O(1) in step count; the shared identity lets the
        cohort interpreter group workgroups without comparing phase lists.
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
                "steps": self.steps,
                "step_time_ns": self.step_time_ns,
            }
        )
        chunk = max(1, self.payload_bytes // cfg.n_devices)
        lead = cfg.data_write_lead_ns
        for s in range(self.steps):
            flag_t = self.step_time_ns * (s + 1)
            if cfg.include_data_writes and self.writes_per_step > 0:
                t0 = max(0.0, flag_t - lead)
                for i in range(self.writes_per_step):
                    t = t0 + (flag_t - t0) * (i + 1) / (self.writes_per_step + 1)
                    bundle.add(
                        wakeup_ns=t,
                        addr=self.amap.partial_base
                        + (s * self.writes_per_step + i) * 64,
                        data=0xC0 + s,
                        size=min(8, max(1, chunk % 8 or 8)),
                        src=self.upstream,
                    )
            bundle.add(
                wakeup_ns=flag_t,
                addr=self.amap.flag_addr(self.upstream, slot=s),
                data=1,
                size=8,
                src=self.upstream,
            )
        return bundle
