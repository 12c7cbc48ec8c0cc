"""Simulation engines (port of ``repro/core/engine.py``).

Three interchangeable engines drive the same :class:`TargetDevice` model and
must produce bit-identical traffic counts and timelines (tested):

* :class:`CyclePollEngine` — the paper's §3.1 design: advance one cycle at a
  time and poll the WTT head every cycle (an O(1) comparison in the common
  case).  Faithful, transparent, and the paper's measured configuration.
* :class:`EventQueueEngine` — the paper's §3.2.2 *proposed* design (future
  work there; built here): WTT enactments and device transitions are events;
  simulation jumps between event times, eliminating idle per-cycle polling.
* ``run_vectorized`` in ``vector_engine.py`` — a closed-form, vectorized
  batch replay on torch tensors on the run's device, exploiting the fact that
  eidolons are replay-only (their traffic is independent of target state).

Both cycle and event engines drive *N* devices on one unified loop: a node is
a ``(TargetDevice, WriteTrackingTable)`` pair, and the classic single-device
open-loop run is just the one-node case.  Intra-cycle ordering is fixed —
writes enact before device transitions, devices in id order — which is what
keeps the two engines bit-identical even when devices emit writes into each
other's WTTs mid-run (closed-loop clusters).
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .target import EidolaDeadlock, TargetDevice
from .wtt import WriteTrackingTable

__all__ = ["CyclePollEngine", "EventQueueEngine", "EngineResult"]

_MAX_CYCLES = 2_000_000_000  # runaway guard

Node = Tuple[TargetDevice, WriteTrackingTable]


@dataclass
class EngineResult:
    sim_cycles: int
    wall_time_s: float
    head_polls: int
    # perf_counter section split (interpreter/fabric/WTT seconds); only the
    # timeline engine fills this in — bench rows surface it as wall_breakdown
    breakdown: Optional[Dict[str, float]] = None


def _fmt_ids(ids: Sequence[int]) -> str:
    """Compress sorted ids into range notation: [0,1,2,5] -> '0-2,5'."""
    if not ids:
        return ""
    parts: List[str] = []
    start = prev = ids[0]
    for i in list(ids[1:]) + [None]:  # type: ignore[list-item]
        if i is not None and i == prev + 1:
            prev = i
            continue
        parts.append(str(start) if start == prev else f"{start}-{prev}")
        if i is not None:
            start = prev = i
    return ",".join(parts)


def _deadlock_message(nodes: Sequence[Node], cycle: int) -> str:
    """Actionable deadlock report: scenario, blocked WGs, unsatisfied flags."""
    scenario = nodes[0][0].scenario.name or "<unnamed>"
    total = sum(dev.blocked_count() for dev, _ in nodes)
    details: List[str] = []
    for dev, _ in nodes:
        for addr, wgs in sorted(dev.blocked_waits().items()):
            decoded = dev.amap.decode_flag(addr)
            where = f"flag 0x{addr:x}"
            if decoded is not None:
                where += f" (src_device={decoded[0]}, slot={decoded[1]})"
            details.append(
                f"device {dev.device_id}: wg {_fmt_ids(wgs)} waiting on {where}"
            )
    msg = (
        f"deadlock in scenario {scenario!r}: all queues empty at cycle "
        f"{cycle} with {total} workgroups blocked"
    )
    if details:
        msg += " [" + "; ".join(details) + "]"
    return msg + " (missing peer flag writes in the trace, or an EmitOp never fired?)"


def _deadlock_error(nodes: Sequence[Node], cycle: int) -> EidolaDeadlock:
    """Build the empty-queue deadlock error, with the static analyzer's
    blame-chain diagnosis embedded when one can be computed."""
    msg = _deadlock_message(nodes, cycle)
    diagnosis = None
    try:
        # late import: repro_torch.analysis imports core modules
        from ..analysis import diagnose_deadlock

        diagnosis = diagnose_deadlock(nodes[0][0].scenario)
    except Exception:  # diagnosis is best-effort; never mask the deadlock
        diagnosis = None
    return EidolaDeadlock(msg, diagnosis=diagnosis)


def _all_idle(nodes: Sequence[Node]) -> bool:
    return all(dev.all_done and wtt.empty for dev, wtt in nodes)


class CyclePollEngine:
    """Per-cycle WTT head polling, exactly as the paper describes."""

    name = "cycle"

    def run(self, device: TargetDevice, wtt: WriteTrackingTable) -> EngineResult:
        return self.run_nodes([(device, wtt)])

    def run_nodes(self, nodes: Sequence[Node]) -> EngineResult:
        t0 = time.perf_counter()
        cycle = -1
        while not _all_idle(nodes):
            cycle += 1
            if cycle > _MAX_CYCLES:
                # not the empty-queue deadlock: queues still hold work, the
                # simulation just ran away — report what is pending instead
                scenario = nodes[0][0].scenario.name or "<unnamed>"
                pending = sum(len(wtt) for _, wtt in nodes)
                blocked = sum(dev.blocked_count() for dev, _ in nodes)
                raise EidolaDeadlock(
                    f"scenario {scenario!r} exceeded {_MAX_CYCLES} cycles with "
                    f"{pending} WTT writes pending and {blocked} workgroups "
                    "blocked (runaway span or livelock, not an empty-queue "
                    "deadlock)"
                )
            # (1) the per-cycle O(1) head check on every device; enact due
            # writes everywhere before any device transition fires
            for dev, wtt in nodes:
                due = wtt.poll(cycle)
                if due:
                    for w in due:
                        dev.memory.enact_xgmi_write(w, cycle)
                    dev.on_writes_enacted(due, cycle)
            # (2) fire device transitions scheduled at this cycle
            any_pending = False
            for dev, wtt in nodes:
                nxt = dev.next_transition_cycle()
                if nxt is not None:
                    any_pending = True
                    if nxt <= cycle:
                        dev.process_until(cycle)
            if (
                not any_pending
                and all(wtt.empty for _, wtt in nodes)
                and not all(dev.all_done for dev, _ in nodes)
            ):
                raise _deadlock_error(nodes, cycle)
        return EngineResult(
            sim_cycles=max(cycle, 0),
            wall_time_s=time.perf_counter() - t0,
            head_polls=sum(wtt.stats.head_polls for _, wtt in nodes),
        )


class EventQueueEngine:
    """Event-driven engine using the WTTs as native event queues.

    The next event time is tracked in one **global calendar**: a heap over
    ``(cycle, kind, node)`` entries (kind 0 = WTT head, 1 = device transition)
    with *lazy invalidation* — entries are validated against the node's actual
    next event on pop, and corrected entries are re-pushed.  Cross-device
    registrations (closed-loop emissions landing in a peer's WTT mid-run) are
    captured by the WTT's ``on_register`` hook, so advancing an N-device
    cluster costs O(log N) per event instead of the former O(N) scan of every
    WTT head and device queue.  Intra-cycle ordering is unchanged: writes
    enact before device transitions at equal cycles, devices in id order.
    """

    name = "event"

    _KIND_WTT, _KIND_DEV = 0, 1

    def run(self, device: TargetDevice, wtt: WriteTrackingTable) -> EngineResult:
        return self.run_nodes([(device, wtt)])

    def run_nodes(self, nodes: Sequence[Node]) -> EngineResult:
        t0 = time.perf_counter()
        last_cycle = 0
        K_WTT, K_DEV = self._KIND_WTT, self._KIND_DEV
        cal: List[Tuple[int, int, int]] = []
        push = heapq.heappush
        pop = heapq.heappop

        def push_dev(i: int, dev: TargetDevice) -> None:
            c = dev.next_transition_cycle()
            if c is not None:
                push(cal, (c, K_DEV, i))

        saved_hooks = [wtt.on_register for _, wtt in nodes]
        try:
            for i, (dev, wtt) in enumerate(nodes):
                # every registration (seed traces were registered before the
                # run; these are mid-run cross-device emissions) lands in the
                # calendar the moment it happens
                wtt.on_register = (
                    lambda cyc, i=i: push(cal, (cyc, K_WTT, i))
                )
                c = wtt.peek_wakeup_cycle()
                if c is not None:
                    push(cal, (c, K_WTT, i))
                push_dev(i, dev)

            while True:
                # earliest still-valid calendar entry (lazy invalidation:
                # drained/deferred entries are dropped or re-timed on pop)
                nxt = None
                while cal:
                    c, kind, i = cal[0]
                    dev, wtt = nodes[i]
                    cur = (
                        wtt.peek_wakeup_cycle()
                        if kind == K_WTT
                        else dev.next_transition_cycle()
                    )
                    if cur != c:
                        pop(cal)
                        if cur is not None:
                            push(cal, (cur, kind, i))
                        continue
                    nxt = c
                    break
                if nxt is None:
                    if all(dev.all_done for dev, _ in nodes):
                        break
                    raise _deadlock_error(nodes, last_cycle)

                # gather every node with an event at nxt (dedupe duplicates)
                due_wtt: set = set()
                due_dev: set = set()
                while cal and cal[0][0] == nxt:
                    _, kind, i = pop(cal)
                    (due_wtt if kind == K_WTT else due_dev).add(i)
                # writes enact before device transitions at equal cycles,
                # devices in id order — matching the cycle engine's
                # intra-cycle ordering
                for i in sorted(due_wtt):
                    dev, wtt = nodes[i]
                    if wtt.peek_wakeup_cycle() != nxt:
                        continue  # stale duplicate
                    cycle, group = wtt.pop_next_group()
                    for w in group:
                        dev.memory.enact_xgmi_write(w, cycle)
                    dev.on_writes_enacted(group, cycle)
                    c = wtt.peek_wakeup_cycle()
                    if c is not None:
                        push(cal, (c, K_WTT, i))
                    due_dev.add(i)  # wakes may schedule transitions <= nxt
                for i in sorted(due_dev):
                    dev, _ = nodes[i]
                    c = dev.next_transition_cycle()
                    if c is not None and c <= nxt:
                        dev.process_until(nxt)
                    push_dev(i, dev)
                last_cycle = max(last_cycle, nxt)
        finally:
            for (_, wtt), hook in zip(nodes, saved_hooks):
                wtt.on_register = hook
        return EngineResult(
            sim_cycles=last_cycle,
            wall_time_s=time.perf_counter() - t0,
            head_polls=sum(wtt.stats.head_polls for _, wtt in nodes),
        )
