"""Pod-scale closed-loop engine: vectorized cohort timelines (port of
``repro/core/cohort_timeline.py``).

The cohort interpreter (``target.py``) already advances counted cohorts, but
the event engine still walks every phase of every cohort through a Python
heap.  The timeline engine applies the vector engine's spin-read closed form
to the N-device closed loop.  (Not to be confused with
:mod:`repro_torch.core.trace_render`, which only draws and exports finished
segment lists.)

The key invariant — **lockstep lanes** — makes it possible.  Under SPIN with
no perturbation, whether a wait blocks is decided by whether the flag's set
cycle is *known at processing time*, which is uniform across all cohorts of a
device that share one phase program (their programs only differ in dispatch
cycle).  So those cohorts stay at the same ``phase_idx`` forever; the only
per-cohort divergent state is the poll-cursor vector.  A device whose
workgroups all share one phases tuple (every built-in closed-loop scenario)
is then a single **lane**: one ``(phase_idx, flag_idx)`` scalar plus a dense
``int64`` cursor vector, advanced closed-form between synchronization events:

* a timed phase is one vector add (+ six integer traffic adds x total
  members, the same arithmetic as ``_complete_phase``);
* a wait address with known visibility cycle ``V`` is the unified spin
  closed form ``nticks = max(ceil((V - t) / poll), 0)`` per cohort —
  identical to both interpreter paths (observed-at-entry and
  blocked-then-resumed), so counters stay bit-exact;
* an unknown flag blocks the whole lane until the write enacts.

Lanes run *ahead* of global time safely: resume cursors after an enactment at
cycle ``T`` are strictly greater than ``T`` (``flag_check_cycles`` > 0) and
routed arrivals are clamped to cycle ``T + 1`` (``Cluster._emit_writes``), so
emissions computed during a run-ahead are simply collected into a heap keyed
``(cycle, device, first_member, phase_idx)`` and routed when global time
reaches them — reproducing the event engine's exact completion order, which
is what keeps the stateful fabric's port-FIFO arithmetic (and therefore every
counter) bit-identical.

The engine reports as ``engine="event"`` (same semantics, same counters) and
marks ``meta["engine_impl"] = "timeline"``.  Ineligible configurations
(SyncMon, perturbations, multi-lane devices, ``cohorts=False``, or a
scenario's declared ``timeline_opt_out``) fall back to the ordinary engines;
``Cluster(timeline=True)`` turns the fallback into a hard error.  The engine
is a host interpreter on numpy, as the reference's is: it ignores the
cluster's torch device.

``lane_step_arrays`` and ``replay_lane_numpy`` expose the same closed form as
a standalone whole-lane replay over dense step arrays; :func:`replay_lane`
(the port of ``replay_lane_jax``) runs it on a torch device, one step at a
time vectorised over cohorts, and :func:`spin_wait` is its one wait.  A lane
is a program of steps, each either timed (advance the cursor by a duration)
or a spin wait on one flag that becomes visible at cycle V: a cohort whose
cursor is t polls every ``poll`` cycles, so it reads the flag ``nticks + 1``
times with ``nticks = max(ceil((V - t) / poll), 0)`` and leaves the wait at
``t + nticks * poll + check``.
"""

from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .config import SyncPolicy
from .engine import EngineResult, _deadlock_error
from .scenario import EmitOp, PhaseSpec

__all__ = [
    "TimelineEngine",
    "timeline_support",
    "lane_step_arrays",
    "replay_lane_numpy",
    "replay_lane",
    "spin_wait",
]


def timeline_support(cluster) -> Optional[str]:
    """Why this cluster cannot use the timeline engine, or None if it can.

    The engine's eligibility is exactly the lockstep-lane invariant: SPIN
    sync, no perturbation on any device, cohort batching enabled, and every
    device's cohorts sharing one phase program.  A scenario may also opt out
    explicitly by declaring a ``timeline_opt_out`` reason string —
    the reference's ``python -m repro.analysis`` fails loudly on undeclared
    opt-outs.
    """
    opt_out = getattr(cluster.scenario, "timeline_opt_out", None)
    if opt_out:
        return f"scenario {cluster.scenario.name!r} opts out: {opt_out}"
    cfg = cluster.cfg
    if cfg.sync != SyncPolicy.SPIN:
        return (
            "SyncMon wake coalescing is member-granular; lanes require SPIN"
        )
    for d in range(cfg.n_devices):
        if cluster._perturb_for(d) is not None:
            return "perturbations force per-workgroup interpretation"
    for node in cluster.nodes:
        cohorts = node.target.cohorts
        if not cohorts:
            continue
        ph0 = cohorts[0].phases
        for c in cohorts[1:]:
            if c.phases is not ph0 and c.phases != ph0:
                return (
                    f"device {node.device_id} workgroups run distinct phase "
                    "programs (multi-lane devices not supported)"
                )
    return None


class _ProgramTable:
    """Dense-array form of one shared phase program.

    One table per distinct phases tuple, shared by every lane running it:
    phase kinds, timed durations, wait flag keys, per-phase traffic deltas
    (reusing the cohort interpreter's precomputed unit deltas), and emit
    schedules.
    """

    __slots__ = ("specs", "n", "is_wait", "dur", "wait_addrs", "tdelta",
                 "names", "emits", "all_last")

    def __init__(self, phases, tdelta_for=None):
        # ``phases`` may be a flat tuple or a SymbolicProgram — iterating the
        # latter materializes (memoized) PhaseSpecs, which is fine here: the
        # generic lane path is per-step anyway, and the bulk lockstep
        # solvers (``core.lockstep`` flat, ``core.lockstep_tiered``
        # group-uniform over multi-tier presets) take over before this
        # table is ever built for the pod-scale collectives; only shapes
        # they decline — cross-group pipelined chains, recorded in
        # ``meta["lockstep_reason"]`` — reach this walk at pod scale.
        specs = tuple(phases)
        self.specs = specs
        self.n = len(specs)
        self.is_wait = [sp.wait_addrs is not None for sp in specs]
        self.dur = [
            0 if sp.wait_addrs is not None else sp.duration_cycles
            for sp in specs
        ]
        self.wait_addrs = [sp.wait_addrs for sp in specs]
        self.tdelta = [
            tdelta_for(sp) if tdelta_for is not None else None for sp in specs
        ]
        self.names = [sp.name for sp in specs]
        self.emits = [sp.emits for sp in specs]
        self.all_last = [
            bool(sp.emits) and all(op.coalesce == "last" for op in sp.emits)
            for sp in specs
        ]


class _Lane:
    """All cohorts of one device, advancing in lockstep.

    Wraps the device's :class:`~repro_torch.core.target.TargetDevice` for traffic
    counters, flag bookkeeping, and result/diagnostic write-back (cohort
    segments, ``kernel_end_cycle``, blocked-wait state) — so collection and
    deadlock reporting reuse the interpreter's own machinery unchanged.
    """

    __slots__ = ("dev_id", "target", "table", "nc", "counts", "counts_list",
                 "total", "fm", "t", "phase_idx", "flag_idx", "in_wait",
                 "wait_start", "blocked", "done", "seg_mode")

    def __init__(self, dev_id: int, target, table: _ProgramTable,
                 seg_mode: bool):
        cohorts = target.cohorts
        self.dev_id = dev_id
        self.target = target
        self.table = table
        self.nc = len(cohorts)
        self.counts = np.array([c.count for c in cohorts], np.int64)
        self.counts_list = [c.count for c in cohorts]
        self.total = int(self.counts.sum()) if cohorts else 0
        self.fm = [c.members[0] for c in cohorts]
        self.t = np.array(
            [c.program.dispatch_cycle for c in cohorts], np.int64
        )
        self.phase_idx = 0
        self.flag_idx = 0
        self.in_wait = False
        self.wait_start: Optional[np.ndarray] = None
        self.blocked: Optional[int] = None
        self.done = False
        self.seg_mode = seg_mode

    def advance(self, eng: "TimelineEngine") -> None:
        """Run the lane closed-form until it blocks or finishes."""
        if self.done:
            return
        tab = self.table
        tgt = self.target
        P = tab.n
        is_wait = tab.is_wait
        durs = tab.dur
        traffic = tgt.memory.traffic
        flag_set = tgt.flag_set_cycle
        poll = eng.poll
        check = eng.check
        counts = self.counts
        total = self.total
        t = self.t
        p = self.phase_idx
        while p < P:
            if is_wait[p]:
                if not self.in_wait:
                    self.in_wait = True
                    self.flag_idx = 0
                    if self.seg_mode:
                        self.wait_start = t.copy()
                addrs = tab.wait_addrs[p]
                fi = self.flag_idx
                na = len(addrs)
                while fi < na:
                    V = flag_set.get(addrs[fi])
                    if V is None:
                        # unknown visibility: the whole lane blocks (the
                        # interpreter would block every cohort here too —
                        # blocking is processing-time-uniform across the lane)
                        self.flag_idx = fi
                        self.blocked = addrs[fi]
                        self.t = t
                        self.phase_idx = p
                        return
                    # unified spin closed form, vectorized over cohorts:
                    # identical to both interpreter paths (_run_wait's
                    # set_c<=cursor / set_c>cursor and on_writes_enacted's
                    # blocked-resume arithmetic); in-place ops — t is never
                    # aliased here (wait_start is a copy, prior phases'
                    # start/end arrays are fully consumed by _complete)
                    nticks = V - t
                    nticks += poll - 1
                    nticks //= poll
                    np.maximum(nticks, 0, out=nticks)
                    m = int(counts @ nticks) + total
                    traffic.flag_reads += m
                    traffic.read_bytes += 8 * m
                    nticks *= poll
                    nticks += check
                    t += nticks
                    fi += 1
                self.blocked = None
                self.in_wait = False
                self._complete(p, self.wait_start, t, eng, traffic)
                p += 1
            else:
                dur = durs[p]
                start = t
                if dur:
                    t = t + dur
                self._complete(p, start, t, eng, traffic)
                p += 1
        self.t = t
        self.phase_idx = p
        self._finish()

    def _complete(
        self,
        p: int,
        start: Optional[np.ndarray],
        end: np.ndarray,
        eng: "TimelineEngine",
        traffic,
    ) -> None:
        tab = self.table
        d = tab.tdelta[p]
        if d is not None:
            n = self.total
            traffic.nonflag_reads += d[0] * n
            traffic.read_bytes += d[1] * n
            traffic.local_writes += d[2] * n
            traffic.write_bytes += d[3] * n
            traffic.xgmi_writes_out += d[4] * n
            traffic.xgmi_bytes_out += d[5] * n
        if self.seg_mode:
            # write into the cohorts' own segment lists so
            # TargetDevice.collect_segments serves the timeline run unchanged
            name = tab.names[p]
            wait = tab.is_wait[p]
            cohorts = self.target.cohorts
            for i in range(self.nc):
                st = int(start[i])
                en = int(end[i])
                if en > st or not wait:
                    cohorts[i].segments.append((name, st, en))
        emits = tab.emits[p]
        if emits:
            self._fire(p, emits, end, eng)

    def _fire(
        self,
        p: int,
        emits: Tuple[EmitOp, ...],
        end: np.ndarray,
        eng: "TimelineEngine",
    ) -> None:
        # The trigger completion — where the interpreter's "last" counter
        # crosses n_wgs — is the lexicographic max of (cycle, first_member)
        # over cohorts; first_members ascend with cohort index, so it is the
        # highest index among the max-cycle cohorts.
        nc = self.nc
        if nc == 1:
            trig = 0
            cyc = int(end[0])
        else:
            cm = end.max()
            trig = int(np.flatnonzero(end == cm)[-1])
            cyc = int(cm)
        if self.table.all_last[p]:
            # a single firing carrying all ops (the interpreter's _on_emit
            # fires them together at the trigger, batched when > 1)
            eng.push_emission(cyc, self.dev_id, self.fm[trig], p, list(emits))
            return
        # mixed / "each" coalescing: one firing per cohort, ops in emit
        # order, "each" ops repeated per represented member — exactly the
        # per-completion fire list _on_emit builds
        for i in range(nc):
            fire: List[EmitOp] = []
            ci = self.counts_list[i]
            for op in emits:
                if op.coalesce == "last":
                    if i == trig:
                        fire.append(op)
                else:
                    fire.extend([op] * ci)
            if fire:
                eng.push_emission(int(end[i]), self.dev_id, self.fm[i], p, fire)

    def _finish(self) -> None:
        self.done = True
        tgt = self.target
        tgt.done_count = tgt.n_wgs
        if self.nc:
            tgt.kernel_end_cycle = int(self.t.max())

    def sync_diagnostics(self) -> None:
        """Write blocked-wait state back onto the cohorts so the standard
        deadlock reporting (blocked_count/blocked_waits) works unchanged."""
        if self.done or self.blocked is None:
            return
        for c in self.target.cohorts:
            c.in_wait = True
            c.blocked_on = self.blocked
            c.phase_idx = self.phase_idx
            c.flag_idx = self.flag_idx


class TimelineEngine:
    """Drives a :class:`~repro_torch.core.cluster.Cluster` of lockstep lanes.

    Global loop over two heaps: a WTT calendar (``on_register`` hooks, as in
    the event engine) and the emission heap filled by run-ahead lanes.  At
    each event cycle ``T``: deliveries first (devices in id order — enact,
    flag bookkeeping, resume blocked lanes), then emissions at ``T`` routed
    in ``(cycle, device, first_member, phase_idx)`` order through the
    cluster's ordinary ``_route``/``_route_batch`` — the event engine's exact
    intra-cycle order, hence bit-identical fabric and counter arithmetic.
    """

    def __init__(self, cluster):
        self.cluster = cluster
        cfg = cluster.cfg
        self.poll = cfg.poll_interval_cycles
        self.check = cfg.flag_check_cycles
        tables: Dict[int, _ProgramTable] = {}
        self.lanes: List[_Lane] = []
        seg_mode = cluster.collect_segments
        for node in cluster.nodes:
            tgt = node.target
            if tgt.cohorts:
                phases = tgt.cohorts[0].phases
                tab = tables.get(id(phases))
                if tab is None:
                    tab = _ProgramTable(phases, tgt._tdelta_for)
                    tables[id(phases)] = tab
            else:
                tab = _ProgramTable(())
            self.lanes.append(_Lane(node.device_id, tgt, tab, seg_mode))
        # (cycle, device, first_member, phase_idx, tie, ops)
        self._emissions: List[tuple] = []
        self._ectr = 0
        self.breakdown: Dict[str, float] = {}

    def push_emission(
        self, cycle: int, dev: int, fm: int, phase_idx: int, ops: List[EmitOp]
    ) -> None:
        self._ectr += 1
        heapq.heappush(
            self._emissions, (cycle, dev, fm, phase_idx, self._ectr, ops)
        )

    def run(self) -> EngineResult:
        t0 = time.perf_counter()
        pc = time.perf_counter
        cluster = self.cluster
        nodes = cluster.nodes
        lanes = self.lanes
        emis = self._emissions
        route = cluster._route
        route_batch = cluster._route_batch
        cal: List[Tuple[int, int]] = []
        push = heapq.heappush
        pop = heapq.heappop
        t_interp = t_fabric = t_wtt = 0.0
        last_cycle = 0
        saved_hooks = [n.wtt.on_register for n in nodes]
        try:
            for i, n in enumerate(nodes):
                n.wtt.on_register = lambda cyc, i=i: push(cal, (cyc, i))
                c = n.wtt.peek_wakeup_cycle()
                if c is not None:
                    push(cal, (c, i))
            ts = pc()
            for lane in lanes:
                lane.advance(self)
            t_interp += pc() - ts
            while True:
                # earliest still-valid WTT head (lazy invalidation)
                wtt_next = None
                while cal:
                    c, i = cal[0]
                    cur = nodes[i].wtt.peek_wakeup_cycle()
                    if cur != c:
                        pop(cal)
                        if cur is not None:
                            push(cal, (cur, i))
                        continue
                    wtt_next = c
                    break
                em_next = emis[0][0] if emis else None
                if wtt_next is None and em_next is None:
                    if all(lane.done for lane in lanes):
                        break
                    for lane in lanes:
                        lane.sync_diagnostics()
                    raise _deadlock_error(
                        [(n.target, n.wtt) for n in nodes], last_cycle
                    )
                if em_next is None or (
                    wtt_next is not None and wtt_next <= em_next
                ):
                    T = wtt_next
                else:
                    T = em_next

                # (1) deliveries at T, devices in id order (writes enact
                # before anything else at equal cycles)
                if wtt_next == T:
                    ts = pc()
                    ia0 = t_interp
                    due = {pop(cal)[1]}
                    while cal and cal[0][0] == T:
                        due.add(pop(cal)[1])
                    order = sorted(due) if len(due) > 1 else tuple(due)
                    # pass A: enact the cycle-T group of every due device
                    # (id order, resumes included) — the event engine's
                    # intra-cycle order exactly
                    hit: List[int] = []
                    for i in order:
                        node = nodes[i]
                        wtt = node.wtt
                        if wtt.peek_wakeup_cycle() != T:
                            continue  # stale duplicate
                        cycle, group = wtt.pop_next_group()
                        node.memory.enact_xgmi_group(group, cycle)
                        tgt = node.target
                        fs = tgt.flag_set_cycle
                        watched = tgt._watched
                        lane = lanes[i]
                        blocked = lane.blocked
                        resume = False
                        for w in group:
                            a = w.addr
                            if a in watched and a not in fs:
                                fs[a] = cycle
                                if a == blocked:
                                    resume = True
                        if resume:
                            ti = pc()
                            lane.advance(self)
                            t_interp += pc() - ti
                        hit.append(i)
                    # pass B: drain each due device's subsequent groups
                    # while no other event can precede them.  All cycle-T
                    # work (including resumes) is done, cal entries are
                    # strictly > T and static during deliveries (resumes
                    # never register writes — only emission *routing* does),
                    # and the emission heap is re-read live each step, so a
                    # group at cycle c <= min(emission head, cal head) can
                    # be enacted now: any future registration arrives
                    # strictly after the emission that causes it.  Equal-
                    # cycle ties are safe — deliveries precede emissions at
                    # one cycle, and same-cycle deliveries on different
                    # devices touch disjoint state (the emission heap key
                    # orders cross-device firings by (cycle, device), never
                    # by push order).
                    for i in hit:
                        node = nodes[i]
                        wtt = node.wtt
                        c = wtt.peek_wakeup_cycle()
                        if c is None:
                            continue
                        mem = node.memory
                        tgt = node.target
                        fs = tgt.flag_set_cycle
                        watched = tgt._watched
                        lane = lanes[i]
                        while True:
                            stop = emis[0][0] if emis else None
                            if cal:
                                c0 = cal[0][0]
                                if stop is None or c0 < stop:
                                    stop = c0
                            if stop is not None and c > stop:
                                break
                            # bulk-pop a head marker run in one call (no
                            # per-member heap round trip), bounded by the
                            # same horizon
                            run = wtt.pop_due_run(stop)
                            if run is not None:
                                cycles2, addrs, rdata, rsize = run
                                mem.enact_xgmi_run(
                                    addrs, cycles2, rdata, rsize
                                )
                                cycle = cycles2[-1]
                                blocked = lane.blocked
                                resume = False
                                for a, cy in zip(addrs, cycles2):
                                    if a in watched and a not in fs:
                                        fs[a] = cy
                                        if a == blocked:
                                            resume = True
                            else:
                                cycle, group = wtt.pop_next_group()
                                mem.enact_xgmi_group(group, cycle)
                                blocked = lane.blocked
                                resume = False
                                for w in group:
                                    a = w.addr
                                    if a in watched and a not in fs:
                                        fs[a] = cycle
                                        if a == blocked:
                                            resume = True
                            if resume:
                                ti = pc()
                                lane.advance(self)
                                t_interp += pc() - ti
                            if cycle > last_cycle:
                                last_cycle = cycle
                            c = wtt.peek_wakeup_cycle()
                            if c is None:
                                break
                        if c is not None:
                            push(cal, (c, i))
                    t_wtt += (pc() - ts) - (t_interp - ia0)

                # (2) route emissions at T, in completion order
                if emis and emis[0][0] == T:
                    ts = pc()
                    while emis and emis[0][0] == T:
                        cyc, dev, _fm, _p, _k, ops = pop(emis)
                        if len(ops) > 1:
                            route_batch(dev, ops, cyc)
                        else:
                            route(dev, ops[0], cyc)
                    t_fabric += pc() - ts
                if T > last_cycle:
                    last_cycle = T
        finally:
            for n, hook in zip(nodes, saved_hooks):
                n.wtt.on_register = hook
        # device transitions are events too: the last one is each lane's
        # kernel end (the event engine counts it via its calendar)
        for lane in lanes:
            if lane.target.kernel_end_cycle > last_cycle:
                last_cycle = lane.target.kernel_end_cycle
        wall = time.perf_counter() - t0
        self.breakdown = {
            "interpreter_s": t_interp,
            "fabric_s": t_fabric,
            "wtt_s": t_wtt,
            "other_s": max(0.0, wall - t_interp - t_fabric - t_wtt),
        }
        return EngineResult(
            sim_cycles=last_cycle,
            wall_time_s=wall,
            head_polls=sum(n.wtt.stats.head_polls for n in nodes),
            breakdown=self.breakdown,
        )


# ---------------------------------------------------------------------------
# Standalone whole-lane closed form (numpy reference + torch variant)
# ---------------------------------------------------------------------------


def lane_step_arrays(
    phases: Tuple[PhaseSpec, ...], flag_set_cycle: Dict[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten a phase program into dense per-step arrays.

    Each timed phase becomes one step ``(is_wait=False, value=duration)``;
    each wait *address* becomes one step ``(is_wait=True, value=visibility
    cycle)`` looked up in ``flag_set_cycle`` (e.g. a completed run's
    ``TargetDevice.flag_set_cycle``).  Feeding the result to
    :func:`replay_lane_numpy` / :func:`replay_lane` replays the whole
    lane closed-form.
    """
    is_wait: List[bool] = []
    val: List[int] = []
    for sp in phases:
        if sp.wait_addrs is not None:
            for a in sp.wait_addrs:
                is_wait.append(True)
                val.append(int(flag_set_cycle[a]))
        else:
            is_wait.append(False)
            val.append(int(sp.duration_cycles))
    return np.asarray(is_wait, bool), np.asarray(val, np.int64)


def replay_lane_numpy(
    dispatch, is_wait, val, *, poll: int, check: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form lane replay (numpy reference).

    ``dispatch`` is the per-cohort dispatch-cycle vector; returns
    ``(flag_reads_per_cohort_member, end_cycle_per_cohort)`` after running
    every step of the program — the exact per-member arithmetic of
    ``TargetDevice._run_wait`` with no interpreter in the loop.
    """
    t = np.array(dispatch, np.int64, copy=True)
    reads = np.zeros_like(t)
    for w, v in zip(is_wait, val):
        if w:
            nticks = np.maximum((v - t + poll - 1) // poll, 0)
            reads += nticks + 1
            t += nticks * poll + check
        else:
            t += v
    return reads, t



def spin_wait(t: torch.Tensor, visible: int, poll: int, check: int):
    """One spin wait from cursors ``t`` on a flag visible at ``visible``:
    returns ``(flag reads per cohort member, cursors after the wait)``."""
    nticks = torch.clamp((visible - t + poll - 1) // poll, min=0)
    return nticks + 1, t + nticks * poll + check


def replay_lane(dispatch, is_wait, val, *, poll: int, check: int, device=None):
    """Replay a whole lane closed-form for every cohort at once.

    ``dispatch``: per-cohort dispatch cycles; ``is_wait``, ``val``: the
    per-step arrays of ``lane_step_arrays`` (a wait step's value is the flag's
    visibility cycle, a timed step's its duration).  Returns
    ``(flag_reads_per_cohort_member, end_cycle_per_cohort)`` as int64 tensors
    on ``device`` (the CUDA device unless the caller passes ``"cpu"``).

    The loop runs over steps on the host and each step is vectorised over
    cohorts.  The arithmetic is int64 throughout, like the reference's
    ground truth ``replay_lane_numpy``; the JAX version works in int32
    (jax's default), which this port does not copy.
    """
    dev = resolve_device(device)
    t = torch.as_tensor(np.asarray(dispatch, np.int64), device=dev)
    reads = torch.zeros_like(t)
    for w, v in zip(np.asarray(is_wait, bool).tolist(), np.asarray(val, np.int64).tolist(),
                    strict=True):
        if w:
            step_reads, t = spin_wait(t, v, poll, check)
            reads += step_reads
        else:
            t = t + v
    return reads, t
