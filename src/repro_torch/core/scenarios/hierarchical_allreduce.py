"""Hierarchical (intra-node / inter-node) all-reduce as a closed-loop scenario.

The canonical cross-tier collective on a pod of nodes: every rank first
participates in an **intra-node ring reduce-scatter** over the ICI tier, the
non-leader ranks hand their reduced shards to the node leader, the **node
leaders ring-all-reduce over the DCI tier** while everyone else sits in the
broadcast wait, and finally each leader **broadcasts** the result back to its
node.  Every stage hand-off is flag-synchronized through
:class:`repro_torch.core.scenario.EmitOp` slots, so nothing is pre-scheduled — the
stage cadence emerges from compute + tiered fabric routing, and slowing the
DCI tier lengthens exactly the leader-stage waits (``hir_wait`` on leaders,
``hbc_wait`` on everyone else) while the intra-node reduce-scatter stage is
untouched (asserted in ``tests/test_hierarchy.py``).

Wait phases carry stage-specific names (``hrs_wait`` / ``hir_wait`` /
``hbc_wait``) precisely so per-stage timelines can be told apart; the
interpreter treats any registered name with ``wait_addrs`` as a wait phase.

Closed-loop only: with one detailed device there is no tier to cross.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

from ..config import SimConfig
from ..events import TraceBundle, register_phase
from ..memory import AddressMap
from ..scenario import (
    Affine,
    AffineRun,
    EmitOp,
    EmitRun,
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
from ..topology import HardwareSpec, V5E

__all__ = ["HierarchicalAllReduceScenario"]

register_phase("hrs_send", color="green", glyph="s")
register_phase("hrs_reduce", color="brown", glyph="+")
register_phase("hrs_handoff", color="blue", glyph="^")
register_phase("hrs_wait", color="red", glyph="r")
register_phase("hir_send", color="green", glyph="S")
register_phase("hir_reduce", color="brown", glyph="*")
register_phase("hir_gather", color="blue", glyph="a")
register_phase("hir_wait", color="red", glyph="R")
register_phase("hbc_push", color="blue", glyph="v")
register_phase("hbc_read", color="green", glyph="b")
register_phase("hbc_wait", color="red", glyph="w")


@register_scenario
class HierarchicalAllReduceScenario(Scenario):
    """Intra-node reduce-scatter -> leader ring all-reduce -> broadcast."""

    name = "hierarchical_allreduce"
    closed_loop_capable = True

    def __init__(
        self,
        cfg: SimConfig,
        amap: Optional[AddressMap] = None,
        *,
        payload_bytes: int = 1 << 20,
        devices_per_node: Optional[int] = None,
        writes_per_step: int = 4,
        closed_loop: bool = True,
        fabric=None,
        link_bw=None,
        hw: HardwareSpec = V5E,
    ):
        if not closed_loop:
            raise ValueError(
                "hierarchical_allreduce is closed-loop only (the stages are "
                "emitted, never pre-scheduled)"
            )
        if payload_bytes <= 0:
            raise ValueError("payload_bytes must be positive")
        n = cfg.n_devices
        dpn = n if devices_per_node is None else int(devices_per_node)
        if dpn < 1 or n % dpn:
            raise ValueError(
                f"devices_per_node={dpn} must divide n_devices={n}"
            )
        self.dpn = dpn
        self.n_nodes = n // dpn
        # slots: [0, dpn-2] intra ring steps, dpn-1 shard handoff to the
        # leader, [dpn, dpn + 2(nodes-1)) leader ring steps, last = broadcast
        self.leader_slot_base = dpn
        self.bcast_slot = dpn + 2 * (self.n_nodes - 1)
        if amap is None:
            # bcast_slot grows with the node count; past ~720 devices the
            # pool would cross the default partial_base and data markers
            # would alias high flag slots (layout prover finding) — re-base
            # the partial region above the pool
            amap = AddressMap(
                n_devices=n, flag_slots=self.bcast_slot + 1
            ).with_partial_clearance()
        super().__init__(cfg, amap)
        self.payload_bytes = int(payload_bytes)
        self.devices_per_node = devices_per_node
        self.writes_per_step = int(writes_per_step)
        self.closed_loop = True
        self.hw = hw
        # The *program structure* (leaders, handoffs, stages) follows
        # devices_per_node; the *fabric* carrying it is independently
        # pluggable — the same hierarchical collective can run over two_tier
        # uplinks, a fat tree, or rails.
        self._setup_fabric(
            devices_per_node=devices_per_node, hw=hw, fabric=fabric,
            link_bw=link_bw,
        )
        # the four stages get disjoint slot ranges; a collision here means
        # the layout arithmetic above regressed
        if dpn > 1:
            self.amap.claim_flag_block("hier_intra_ring", 0, dpn - 1)
            self.amap.claim_flag_block("hier_shard_handoff", dpn - 1, dpn)
        if self.n_nodes > 1:
            self.amap.claim_flag_block(
                "hier_leader_ring", self.leader_slot_base, self.bcast_slot
            )
        self.amap.claim_flag_block(
            "hier_broadcast", self.bcast_slot, self.bcast_slot + 1
        )
        self.params = {
            "payload_bytes": self.payload_bytes,
            "devices_per_node": self.devices_per_node,
            "writes_per_step": self.writes_per_step,
            "closed_loop": True,
            "fabric": self.fabric_name,
        }

    # ------------------------------------------------------------------

    def _share(self, nbytes: int) -> Tuple[int, int, int]:
        """(bytes, sectors, cycles) of one WG's slice of an ``nbytes`` block."""
        cfg = self.cfg
        share = max(1, nbytes // cfg.workgroups)
        sectors = math.ceil(share / cfg.sector_bytes)
        cycles = max(1, math.ceil(sectors / cfg.wg_sector_throughput))
        return share, sectors, cycles

    def _emit(self, dst: int, slot: int, payload: int) -> Tuple[EmitOp, ...]:
        return (
            EmitOp(
                dst,
                slot=slot,
                payload_bytes=payload,
                data_writes=self.writes_per_step,
            ),
        )

    def programs_for(self, device: int) -> List[WGProgram]:
        cfg = self.cfg
        shared = self._symbolic_phases(device)
        return [
            WGProgram(
                wg=wg,
                cu=wg % cfg.n_cus,
                dispatch_cycle=(wg // cfg.n_cus) * cfg.dispatch_stagger_cycles,
                phases=shared,
            )
            for wg in range(cfg.workgroups)
        ]

    def _symbolic_phases(self, device: int) -> SymbolicProgram:
        """The per-rank stage program, compressed: both ring stages become
        :class:`LoopSpec`\\ s whose wait address / emit slot are affine in the
        step index, the leader's handoff barrier and broadcast fan-out become
        within-phase runs — O(1) objects per rank in devices and nodes.
        Bit-identity with the flat construction (:meth:`_flat_phases`) is
        property-tested."""
        cfg = self.cfg
        dpn, nodes = self.dpn, self.n_nodes
        node, local = divmod(device, dpn)
        leader = node * dpn
        is_leader = local == 0
        chunk1 = max(1, self.payload_bytes // dpn)
        share1, sectors1, cycles1 = self._share(chunk1)
        segs: List[object] = []

        def _loop_emit(dst: int, slot: Affine, payload: int):
            return (
                LoopEmit(
                    Affine(dst),
                    slot=slot,
                    payload_bytes=payload,
                    data_writes=self.writes_per_step,
                ),
            )

        # ---- stage 1: intra-node ring reduce-scatter (ICI tier) ----------
        if dpn > 1:
            local_up = node * dpn + (local - 1) % dpn
            local_down = node * dpn + (local + 1) % dpn
            segs.append(
                PhaseSpec(
                    "hrs_send",
                    cycles1,
                    traffic=(
                        reads(sectors1, cfg.sector_bytes),
                        xgmi_out(1, share1),
                    ),
                    emits=self._emit(local_down, 0, chunk1),
                )
            )
            t_reduce = (
                reads(2 * sectors1, cfg.sector_bytes),
                local_writes(1, share1),
                xgmi_out(1, share1),
            )
            t_reduce_last = t_reduce[:2]
            wait1 = affine_of(
                lambda k: self.amap.flag_addr(local_up, slot=k), 0, dpn - 1
            )
            # steps 0..dpn-3 are a loop (emit flag k+1 downstream); the last
            # reduce step dpn-2 keeps its shard and emits nothing
            segs.append(
                LoopSpec(
                    dpn - 2,
                    (
                        LoopPhase("hrs_wait", wait_addrs=(wait1,)),
                        LoopPhase(
                            "hrs_reduce",
                            cycles1,
                            traffic=t_reduce,
                            emits=_loop_emit(local_down, Affine(1, 1), chunk1),
                        ),
                    ),
                )
            )
            segs.append(
                PhaseSpec("hrs_wait", wait_addrs=(wait1.at(dpn - 2),))
            )
            segs.append(
                PhaseSpec("hrs_reduce", cycles1, traffic=t_reduce_last)
            )
            # shard handoff: non-leaders push their reduced shard to the
            # leader; the leader barriers on all dpn-1 handoff flags
            if is_leader:
                handoff = affine_of(
                    lambda l2: self.amap.flag_addr(node * dpn + l2, slot=dpn - 1),
                    1,
                    dpn - 1,
                )
                segs.append(
                    LoopPhase(
                        "hrs_wait",
                        wait_addrs=(
                            AffineRun(handoff.at(1), handoff.step, dpn - 1),
                        ),
                    )
                )
            else:
                segs.append(
                    PhaseSpec(
                        "hrs_handoff",
                        cycles1,
                        traffic=(xgmi_out(1, share1),),
                        emits=self._emit(leader, dpn - 1, chunk1),
                    )
                )

        # ---- stage 2: leader ring all-reduce (DCI tier) ------------------
        if nodes > 1 and is_leader:
            chunk2 = max(1, self.payload_bytes // nodes)
            share2, sectors2, cycles2 = self._share(chunk2)
            up_leader = ((node - 1) % nodes) * dpn
            down_leader = ((node + 1) % nodes) * dpn
            base = self.leader_slot_base
            steps2 = 2 * (nodes - 1)
            rs2 = nodes - 1
            segs.append(
                PhaseSpec(
                    "hir_send",
                    cycles2,
                    traffic=(
                        reads(sectors2, cfg.sector_bytes),
                        xgmi_out(1, share2),
                    ),
                    emits=self._emit(down_leader, base, chunk2),
                )
            )
            t_red = (
                reads(2 * sectors2, cfg.sector_bytes),
                local_writes(1, share2),
                xgmi_out(1, share2),
            )
            t_gat = (
                reads(sectors2, cfg.sector_bytes),
                local_writes(1, share2),
                xgmi_out(1, share2),
            )
            t_gat_last = t_gat[:2]
            wait2 = affine_of(
                lambda k: self.amap.flag_addr(up_leader, slot=base + k),
                0,
                steps2,
            )
            wait2_body = LoopPhase("hir_wait", wait_addrs=(wait2,))
            # emit slot is base + k + 1 for finishing step k
            slot_out = Affine(base + 1, 1)
            segs.append(
                LoopSpec(
                    rs2,
                    (
                        wait2_body,
                        LoopPhase(
                            "hir_reduce",
                            cycles2,
                            traffic=t_red,
                            emits=_loop_emit(down_leader, slot_out, chunk2),
                        ),
                    ),
                )
            )
            segs.append(
                LoopSpec(
                    steps2 - 1 - rs2,
                    (
                        wait2_body,
                        LoopPhase(
                            "hir_gather",
                            cycles2,
                            traffic=t_gat,
                            emits=_loop_emit(down_leader, slot_out, chunk2),
                        ),
                    ),
                    k0=rs2,
                )
            )
            segs.append(
                PhaseSpec("hir_wait", wait_addrs=(wait2.at(steps2 - 1),))
            )
            segs.append(PhaseSpec("hir_gather", cycles2, traffic=t_gat_last))

        # ---- stage 3: intra-node broadcast (ICI tier) --------------------
        shareF, sectorsF, cyclesF = self._share(self.payload_bytes)
        if dpn > 1:
            if is_leader:
                segs.append(
                    LoopPhase(
                        "hbc_push",
                        cyclesF,
                        traffic=(xgmi_out(dpn - 1, shareF),),
                        emits=(
                            EmitRun(
                                dpn - 1,
                                dst0=node * dpn + 1,
                                slot0=self.bcast_slot,
                                payload_bytes=self.payload_bytes,
                                data_writes=self.writes_per_step,
                            ),
                        ),
                    )
                )
            else:
                segs.append(
                    PhaseSpec(
                        "hbc_wait",
                        wait_addrs=(
                            self.amap.flag_addr(leader, slot=self.bcast_slot),
                        ),
                    )
                )
        segs.append(
            PhaseSpec(
                "hbc_read",
                cyclesF,
                traffic=(
                    reads(sectorsF, cfg.sector_bytes),
                    local_writes(1, shareF),
                ),
            )
        )
        return SymbolicProgram(segs, group="leader" if is_leader else "worker")

    def _flat_phases(self, device: int):
        """Pre-refactor flat phase construction — the reference oracle for
        :meth:`_symbolic_phases` (property-tested, never on runtime paths)."""
        cfg = self.cfg
        dpn, nodes = self.dpn, self.n_nodes
        node, local = divmod(device, dpn)
        leader = node * dpn
        is_leader = local == 0
        chunk1 = max(1, self.payload_bytes // dpn)
        share1, sectors1, cycles1 = self._share(chunk1)
        phases: List[PhaseSpec] = []

        # ---- stage 1: intra-node ring reduce-scatter (ICI tier) ----------
        if dpn > 1:
            local_up = node * dpn + (local - 1) % dpn
            local_down = node * dpn + (local + 1) % dpn
            phases.append(
                PhaseSpec(
                    "hrs_send",
                    cycles1,
                    traffic=(
                        reads(sectors1, cfg.sector_bytes),
                        xgmi_out(1, share1),
                    ),
                    emits=self._emit(local_down, 0, chunk1),
                )
            )
            # loop-invariant traffic tuples hoisted (built once per device,
            # not per ring step — pod-scale construction walks O(devices)
            # steps per leader)
            t_reduce = (
                reads(2 * sectors1, cfg.sector_bytes),
                local_writes(1, share1),
                xgmi_out(1, share1),
            )
            t_reduce_last = t_reduce[:2]
            for s in range(dpn - 1):
                phases.append(
                    PhaseSpec(
                        "hrs_wait",
                        wait_addrs=(self.amap.flag_addr(local_up, slot=s),),
                    )
                )
                last_rs = s == dpn - 2
                phases.append(
                    PhaseSpec(
                        "hrs_reduce",
                        cycles1,
                        traffic=t_reduce_last if last_rs else t_reduce,
                        emits=()
                        if last_rs
                        else self._emit(local_down, s + 1, chunk1),
                    )
                )
            # shard handoff: non-leaders push their reduced shard to the
            # leader; the leader barriers on all dpn-1 handoff flags
            if is_leader:
                phases.append(
                    PhaseSpec(
                        "hrs_wait",
                        wait_addrs=tuple(
                            self.amap.flag_addr(node * dpn + l2, slot=dpn - 1)
                            for l2 in range(1, dpn)
                        ),
                    )
                )
            else:
                phases.append(
                    PhaseSpec(
                        "hrs_handoff",
                        cycles1,
                        traffic=(xgmi_out(1, share1),),
                        emits=self._emit(leader, dpn - 1, chunk1),
                    )
                )

        # ---- stage 2: leader ring all-reduce (DCI tier) ------------------
        if nodes > 1 and is_leader:
            chunk2 = max(1, self.payload_bytes // nodes)
            share2, sectors2, cycles2 = self._share(chunk2)
            up_leader = ((node - 1) % nodes) * dpn
            down_leader = ((node + 1) % nodes) * dpn
            base = self.leader_slot_base
            steps2 = 2 * (nodes - 1)
            rs2 = nodes - 1
            phases.append(
                PhaseSpec(
                    "hir_send",
                    cycles2,
                    traffic=(
                        reads(sectors2, cfg.sector_bytes),
                        xgmi_out(1, share2),
                    ),
                    emits=self._emit(down_leader, base, chunk2),
                )
            )
            # per-step traffic is one of three loop-invariant tuples
            t_red = (
                reads(2 * sectors2, cfg.sector_bytes),
                local_writes(1, share2),
                xgmi_out(1, share2),
            )
            t_gat = (
                reads(sectors2, cfg.sector_bytes),
                local_writes(1, share2),
                xgmi_out(1, share2),
            )
            t_gat_last = t_gat[:2]
            for s in range(steps2):
                phases.append(
                    PhaseSpec(
                        "hir_wait",
                        wait_addrs=(
                            self.amap.flag_addr(up_leader, slot=base + s),
                        ),
                    )
                )
                reducing = s < rs2
                last = s == steps2 - 1
                phases.append(
                    PhaseSpec(
                        "hir_reduce" if reducing else "hir_gather",
                        cycles2,
                        traffic=t_red
                        if reducing
                        else (t_gat_last if last else t_gat),
                        emits=()
                        if last
                        else self._emit(down_leader, base + s + 1, chunk2),
                    )
                )

        # ---- stage 3: intra-node broadcast (ICI tier) --------------------
        shareF, sectorsF, cyclesF = self._share(self.payload_bytes)
        if dpn > 1:
            if is_leader:
                phases.append(
                    PhaseSpec(
                        "hbc_push",
                        cyclesF,
                        traffic=(xgmi_out(dpn - 1, shareF),),
                        emits=tuple(
                            EmitOp(
                                node * dpn + l2,
                                slot=self.bcast_slot,
                                payload_bytes=self.payload_bytes,
                                data_writes=self.writes_per_step,
                            )
                            for l2 in range(1, dpn)
                        ),
                    )
                )
            else:
                phases.append(
                    PhaseSpec(
                        "hbc_wait",
                        wait_addrs=(
                            self.amap.flag_addr(leader, slot=self.bcast_slot),
                        ),
                    )
                )
        phases.append(
            PhaseSpec(
                "hbc_read",
                cyclesF,
                traffic=(
                    reads(sectorsF, cfg.sector_bytes),
                    local_writes(1, shareF),
                ),
            )
        )
        return tuple(phases)

    # closed-loop only fallbacks -------------------------------------------

    def programs(self) -> List[WGProgram]:
        raise NotImplementedError("hierarchical_allreduce is closed-loop only")

    def traces(self) -> TraceBundle:
        return TraceBundle(meta={"scenario": self.name, "closed_loop": True})
