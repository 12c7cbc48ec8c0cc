"""Detailed target-device model: a cohort-batched phase-program interpreter
(port of ``repro/core/target.py``).

The paper simulates exactly one device in detailed timing mode; its figures
measure (a) per-workgroup phase timelines (Figs. 1/2) and (b) memory-read
traffic split into flag vs. non-flag categories (Figs. 6/9).  This module
models the target at that granularity, but — unlike a hardcoded
remote -> flag -> local -> wait -> reduce -> broadcast machine — it interprets
*phase programs as data* (:class:`repro_torch.core.scenario.WGProgram`): each
workgroup advances through an ordered list of timed phases (closed-form
traffic accounted at completion) and wait phases.  A wait phase observes a
sequence of flag addresses under one of two synchronization policies:

* ``SPIN``    — sequential per-address polling loop; one flag read per poll
                tick while the current flag is unset, one observe read once
                set.
* ``SYNCMON`` — check once; if unset, arm a Monitor Log entry and mwait
                (descheduled, zero reads while waiting); on wake, a validation
                read that may coalesce with other wavefronts woken in the same
                cycle on the same CU (the fill triggered by the waking write
                serves adjacent waiters).

Cohorts
-------
Under SPIN with no perturbation, every workgroup of one dispatch wave runs the
same program from the same start cycle and observes the same flag-visibility
times, so their interpreter states are *identical forever* — the per-workgroup
transition loop redundantly recomputes the same advance ``n_cus`` times per
wave.  The interpreter therefore advances **counted cohorts**: maximal runs of
consecutive workgroups sharing (dispatch cycle, phase program).  One transition
advances the whole cohort; traffic is accounted in closed form (each bulk
counter multiplied by the member count — exactly how ``vector_engine.py``
already scores spin waits across all workgroups at once), and timeline segments
are stored once per cohort and stamped per member only at collection time.
Under SyncMon the only member-keyed *state* is the deterministic requeue
jitter (``wg % requeue_jitter_mod``), so cohorts split by jitter class —
workgroups sharing (dispatch cycle, phase program, jitter class) advance as
one counted unit even when their ids interleave.  The CU (``wg % n_cus`` in
every built-in scenario) never diverges member state; it only shapes the
coalesced validation-read *accounting* on wake, which is scored from the
cohort's per-member CU list, grouped across cohorts exactly as the
per-workgroup interpreter groups individual workgroups.  A perturbation
(keyed by wg id) still forces singleton cohorts, which is bit-for-bit the old
per-workgroup interpreter.

The model is engine-agnostic: cycle-poll and event-queue engines drive the
same transitions and therefore produce bit-identical traffic and timelines.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from .config import SimConfig, SyncPolicy
from .events import RegisteredWrite, Segment
from .memory import DirectoryMemory
from .monitor import MonitorLog
from .scenario import PhaseSpec, Scenario, WGProgram, as_symbolic

__all__ = ["TargetDevice", "EidolaDeadlock"]


class _WatchSet:
    """Flag addresses some program may wait on, as literals + arithmetic runs.

    Symbolic programs summarize their wait addresses as ``(start, stride,
    count)`` runs in O(#segments) (:meth:`SymbolicProgram.wait_runs`), so the
    watch set never materializes O(steps) addresses; membership stays O(1) in
    the literal set plus O(#runs) run checks (a handful per program shape).
    """

    __slots__ = ("literal", "runs")

    def __init__(self) -> None:
        self.literal: Set[int] = set()
        self.runs: Set[Tuple[int, int, int]] = set()

    def add_program(self, phases) -> None:
        sp = as_symbolic(phases)
        if sp is not None:
            lits, runs = sp.wait_runs()
            self.literal.update(lits)
            self.runs.update(runs)
            return
        for ph in phases:
            if ph.wait_addrs:
                self.literal.update(ph.wait_addrs)

    def __contains__(self, addr: int) -> bool:
        if addr in self.literal:
            return True
        for start, stride, count in self.runs:
            off = addr - start
            if stride:
                if off >= 0 and off % stride == 0 and off // stride < count:
                    return True
            elif off == 0:
                return True
        return False


class EidolaDeadlock(RuntimeError):
    """Raised when all workgroups are blocked and no pending writes remain.

    ``diagnosis`` carries the static analyzer's explanation of the wait-for
    cycle (blame chains from :func:`repro_torch.analysis.diagnose_deadlock`)
    when one could be computed; it is appended to the message.
    """

    def __init__(self, message: str, *, diagnosis: "str | None" = None):
        self.diagnosis = diagnosis
        if diagnosis:
            message = f"{message}\n{diagnosis}"
        super().__init__(message)


@dataclass
class _Cohort:
    """A maximal run of consecutive workgroups in identical interpreter state.

    ``program`` is the first member's :class:`WGProgram`; all members share its
    ``phases`` and ``dispatch_cycle`` (singleton cohorts additionally make
    ``program.wg``/``program.cu`` exact).  Segments are stored as
    ``(phase, start_cycle, end_cycle)`` tuples shared by every member and
    expanded per workgroup only in :meth:`TargetDevice.collect_segments`.
    """

    program: WGProgram
    members: Tuple[int, ...]      # wg ids sharing this state (consecutive
                                  # under SPIN; same jitter class under
                                  # SyncMon, where they may interleave)
    idx: int = 0                  # position in TargetDevice.cohorts
    count: int = 1                # len(members), denormalized for the hot path
    member_cus: Tuple[int, ...] = ()    # per-member CU (SyncMon wake
                                        # coalescing accounts reads per CU)
    phases: Tuple[PhaseSpec, ...] = ()  # program.phases, denormalized
    phase_idx: int = -1           # -1 = not yet dispatched
    phase_start: int = 0          # cycle the current phase began
    done: bool = False
    # wait-phase bookkeeping
    in_wait: bool = False
    flag_idx: int = 0
    t_cursor: int = 0             # next poll/check tick (cycles)
    blocked_on: Optional[int] = None   # flag address we spin/mwait on
    in_mwait: bool = False
    t_arm: int = 0                # cycle the current monitor was armed
    wait_start: int = 0
    segments: List[Tuple[str, int, int]] = field(default_factory=list)
    desched_segments: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def current(self) -> Optional[PhaseSpec]:
        if 0 <= self.phase_idx < len(self.phases):
            return self.phases[self.phase_idx]
        return None


class TargetDevice:
    """One detailed device of an Eidola simulation.

    In the classic open-loop configuration this is the single device 0; in a
    closed-loop :class:`repro_torch.core.cluster.Cluster` every device is one
    of these, each with its own ``device_id``, :class:`DirectoryMemory`,
    :class:`MonitorLog`, and Write Tracking Table.  ``emit_sink`` (set by the
    cluster) receives phase-completion
    :class:`repro_torch.core.scenario.EmitOp` notifications — called once per
    cohort with the member ``count`` so the sink can replay per-workgroup
    semantics in closed form; without a sink, emits are inert (open-loop
    degenerate case).

    ``scenario`` provides the phase programs via ``programs_for(device_id)``.

    ``cohorts=False`` forces singleton cohorts (the pre-batching per-workgroup
    interpreter); the equivalence tests drive both modes against each other.
    """

    def __init__(
        self,
        cfg: SimConfig,
        scenario: Scenario,
        memory: DirectoryMemory,
        monitor_log: Optional[MonitorLog] = None,
        perturb=None,
        *,
        device_id: int = 0,
        emit_sink: Optional[
            Callable[[int, int, int, "PhaseSpec", int, int], None]
        ] = None,
        cohorts: bool = True,
    ):
        self.cfg = cfg
        self.scenario = scenario
        self.amap = scenario.amap
        self.memory = memory
        self.monitor_log = monitor_log
        if cfg.sync == SyncPolicy.SYNCMON and monitor_log is None:
            raise ValueError("SYNCMON policy requires a MonitorLog")
        self.perturb = perturb
        self.device_id = int(device_id)
        self.emit_sink = emit_sink

        programs = sorted(scenario.programs_for(self.device_id), key=lambda p: p.wg)
        if [p.wg for p in programs] != list(range(len(programs))):
            raise ValueError("WGProgram ids must be contiguous from 0")
        self.n_wgs = len(programs)
        # Cohort batching is valid only when no per-member state can diverge.
        # A perturbation scales phases by wg id — singletons.  Under SPIN,
        # nothing is member-keyed: maximal runs of consecutive workgroups
        # sharing (dispatch cycle, phases) batch.  Under SyncMon, the only
        # state divergence is the deterministic requeue jitter (wg %
        # requeue_jitter_mod), so workgroups of the same *jitter class* (and
        # dispatch cycle and phases) batch even when interleaved; the CU only
        # affects the coalesced-validation-read accounting, which is scored
        # from the per-member CU list at wake time.
        batch = cohorts and perturb is None
        # (first_program, member_wgs, member_cus) triples, frozen below
        groups: List[Tuple[WGProgram, List[int], List[int]]] = []
        if batch and cfg.sync == SyncPolicy.SPIN:
            for p in programs:
                g = groups[-1] if groups else None
                if (
                    g is not None
                    and g[0].dispatch_cycle == p.dispatch_cycle
                    and (g[0].phases is p.phases or g[0].phases == p.phases)
                ):
                    g[1].append(p.wg)
                    g[2].append(p.cu)
                else:
                    groups.append((p, [p.wg], [p.cu]))
        elif batch and cfg.sync == SyncPolicy.SYNCMON:
            mod = max(1, cfg.requeue_jitter_mod)
            token: Dict[int, int] = {}  # id(phases) -> small int
            index: Dict[Tuple[int, int, int], int] = {}
            for p in programs:
                t = token.setdefault(id(p.phases), len(token))
                key = (p.dispatch_cycle, t, p.wg % mod)
                gi = index.get(key)
                if gi is None:
                    index[key] = len(groups)
                    groups.append((p, [p.wg], [p.cu]))
                else:
                    g = groups[gi]
                    g[1].append(p.wg)
                    g[2].append(p.cu)
        else:
            groups = [(p, [p.wg], [p.cu]) for p in programs]
        self.cohorts: List[_Cohort] = [
            _Cohort(
                program=p,
                members=tuple(wgs),
                member_cus=tuple(cus),
                idx=i,
                count=len(wgs),
                phases=p.phases,
            )
            for i, (p, wgs, cus) in enumerate(groups)
        ]
        # wg id -> cohort index (monitor wakes are keyed by wg id)
        self._by_wg: Dict[int, int] = {
            wg: c.idx for c in self.cohorts for wg in c.members
        }
        # Per-spec unit traffic deltas, keyed by spec identity and filled
        # *lazily* by _tdelta_for (symbolic programs materialize phases on
        # demand; an up-front walk would re-expand O(steps) specs).  A phase
        # completion then costs six integer adds instead of re-walking the
        # TrafficOp list; the arithmetic is identical to op.apply() per member.
        # SymbolicProgram memoizes materialization, so spec ids are stable and
        # stay alive as long as the program does.
        self._tdelta: Dict[int, Optional[Tuple[int, int, int, int, int, int]]] = {}

        # every flag address some program may wait on, as literals plus
        # (start, stride, count) runs (one walk per distinct phases object)
        self._watched = _WatchSet()
        seen_phase_tuples: Set[int] = set()
        for c in self.cohorts:
            pid = id(c.phases)
            if pid in seen_phase_tuples:
                continue
            seen_phase_tuples.add(pid)
            self._watched.add_program(c.phases)
        self.flag_set_cycle: Dict[int, int] = {}
        # spin mode: flag addr -> set of blocked cohort indexes
        self._spin_waiters: Dict[int, Set[int]] = {}
        # syncmon: wg -> monitor entry currently armed
        self._armed: Dict[int, object] = {}

        # transition queue managed via (cycle, first_member, cohort_idx);
        # first_member is the tie-break that reproduces per-workgroup pop
        # order (cohorts are consecutive id runs, so ordering by the first
        # member orders every member)
        self._ready: List[Tuple[int, int, int]] = []
        for ci, c in enumerate(self.cohorts):
            self._push(c.program.dispatch_cycle, ci)
        self.done_count = 0
        self.kernel_end_cycle = 0

    # ------------------------------------------------------------------
    # transition queue (a tiny heap the engines drain)
    # ------------------------------------------------------------------

    def _push(self, cycle: int, ci: int) -> None:
        heapq.heappush(self._ready, (int(cycle), self.cohorts[ci].members[0], ci))

    def next_transition_cycle(self) -> Optional[int]:
        return self._ready[0][0] if self._ready else None

    def process_until(self, cycle: int) -> None:
        """Fire all transitions scheduled at or before ``cycle``."""
        while self._ready and self._ready[0][0] <= cycle:
            t, _, ci = heapq.heappop(self._ready)
            self._advance(self.cohorts[ci], t)

    @property
    def all_done(self) -> bool:
        return self.done_count == self.n_wgs

    def blocked_count(self) -> int:
        return sum(
            c.count for c in self.cohorts if c.in_wait and c.blocked_on is not None
        )

    def blocked_waits(self) -> Dict[int, List[int]]:
        """Unsatisfied flag address -> sorted blocked workgroup ids.

        Deadlock diagnostics: these are the flags no pending write will ever
        set (decode them with ``self.amap.decode_flag``).
        """
        out: Dict[int, List[int]] = {}
        for c in self.cohorts:
            if c.in_wait and c.blocked_on is not None:
                out.setdefault(c.blocked_on, []).extend(c.members)
        return {addr: sorted(wgs) for addr, wgs in out.items()}

    # ------------------------------------------------------------------
    # phase completion accounting
    # ------------------------------------------------------------------

    def _tdelta_for(
        self, spec: PhaseSpec
    ) -> Optional[Tuple[int, int, int, int, int, int]]:
        """Unit traffic delta of ``spec``, memoized by spec identity."""
        key = id(spec)
        try:
            return self._tdelta[key]
        except KeyError:
            pass
        if not spec.traffic:
            self._tdelta[key] = None
            return None
        nonflag = rbytes = local = wbytes = xout = xbytes = 0
        for op in spec.traffic:
            if op.kind == "reads":
                nonflag += op.n
                rbytes += op.n * op.bytes_each
            elif op.kind == "local_writes":
                local += op.n
                wbytes += op.n * op.bytes_each
            else:  # xgmi_out
                xout += op.n
                xbytes += op.n * op.bytes_each
        d = (nonflag, rbytes, local, wbytes, xout, xbytes)
        self._tdelta[key] = d
        return d

    def _complete_phase(self, c: _Cohort, spec: PhaseSpec, start: int, end: int) -> None:
        # timed phases always get a timeline segment (even zero-length, as the
        # reference's first state machine did); wait phases only when time
        # actually passed
        if end > start or spec.wait_addrs is None:
            c.segments.append((spec.name, start, end))
        d = self._tdelta_for(spec)
        if d is not None:
            # closed-form cohort accounting: identical arithmetic to
            # TrafficOp.apply(memory, times=count), precomputed per spec
            t = self.memory.traffic
            n = c.count
            t.nonflag_reads += d[0] * n
            t.read_bytes += d[1] * n
            t.local_writes += d[2] * n
            t.write_bytes += d[3] * n
            t.xgmi_writes_out += d[4] * n
            t.xgmi_bytes_out += d[5] * n
        if spec.emits and self.emit_sink is not None:
            self.emit_sink(
                self.device_id, c.program.wg, c.phase_idx, spec, end, c.count
            )

    # ------------------------------------------------------------------
    # the program interpreter
    # ------------------------------------------------------------------

    def _advance(self, c: _Cohort, now: int) -> None:
        if c.done:
            return
        if c.in_wait:
            self._run_wait(c, now)
            return
        # completing the current timed phase (if dispatched)
        if c.phase_idx >= 0:
            self._complete_phase(c, c.phases[c.phase_idx], c.phase_start, now)
        self._enter_next_phase(c, now)

    def _enter_next_phase(self, c: _Cohort, now: int) -> None:
        c.phase_idx += 1
        c.phase_start = now
        if c.phase_idx >= len(c.phases):
            self._finish(c, now)
            return
        spec = c.phases[c.phase_idx]
        if spec.wait_addrs is not None:
            c.in_wait = True
            c.flag_idx = 0
            c.t_cursor = now
            c.wait_start = now
            self._run_wait(c, now)
        else:
            dur = spec.duration_cycles
            if self.perturb is not None and dur > 0:
                dur = self.perturb.scale_phase(c.program.wg, spec.name, dur)
            self._push(now + dur, c.idx)

    def _finish(self, c: _Cohort, now: int) -> None:
        c.done = True
        self.done_count += c.count
        self.kernel_end_cycle = max(self.kernel_end_cycle, now)

    # ------------------------------------------------------------------
    # WAIT phase: spin / syncmon
    # ------------------------------------------------------------------

    def _run_wait(self, c: _Cohort, now: int) -> None:
        cfg = self.cfg
        spec = c.phases[c.phase_idx]
        assert spec.wait_addrs is not None
        addrs = spec.wait_addrs
        n_addrs = len(addrs)
        n = c.count
        traffic = self.memory.traffic
        flag_set = self.flag_set_cycle
        check = cfg.flag_check_cycles
        poll = cfg.poll_interval_cycles
        spin = cfg.sync == SyncPolicy.SPIN
        c.blocked_on = None
        while c.flag_idx < n_addrs:
            addr = addrs[c.flag_idx]
            set_c = flag_set.get(addr)
            if set_c is not None and set_c <= c.t_cursor:
                # observe-and-advance: a single read (per member) sees the
                # flag set (inline of memory.bulk_reads(n, 8, flag=True))
                traffic.flag_reads += n
                traffic.read_bytes += 8 * n
                c.t_cursor += check
                c.flag_idx += 1
                continue
            if spin:
                if set_c is not None:
                    # flag will be visible at set_c > t_cursor: poll until
                    # then — every member polls the same ticks, so the cohort
                    # accounts nticks+1 reads per member in closed form
                    nticks = -((set_c - c.t_cursor) // -poll)
                    traffic.flag_reads += n * (nticks + 1)
                    traffic.read_bytes += 8 * n * (nticks + 1)
                    c.t_cursor += nticks * poll + check
                    c.flag_idx += 1
                    continue
                # unset with unknown set time: block until notify
                c.blocked_on = addr
                self._spin_waiters.setdefault(addr, set()).add(c.idx)
                return
            # SYNCMON (members share jitter class -> identical state):
            # one check read per member (sees unset or not-yet-visible)
            self.memory.bulk_reads(n, bytes_each=8, flag=True)
            t_arm = c.t_cursor + cfg.monitor_arm_cycles
            if set_c is not None and set_c <= t_arm:
                # race window: write landed between check and mwait; the
                # mwait returns immediately after its own validation read
                self.memory.bulk_reads(n, bytes_each=8, flag=True)
                if self.monitor_log is not None:
                    self.monitor_log.stats["immediate_mwait_returns"] += n
                c.t_cursor = t_arm + cfg.flag_check_cycles
                c.flag_idx += 1
                continue
            # arm + deschedule: every member arms its own monitor (one
            # Monitor Log row each in the per-workgroup interpreter; a
            # multi-member cohort shares one row but accounts the same
            # number of armings, and all members wake together)
            entry = self.monitor_log.monitor(addr, 8, 1)
            for wg in c.members:
                entry.waiting_wfs.add(wg)
                self._armed[wg] = entry
            if n > 1:
                self.monitor_log.stats["monitors_armed"] += n - 1
            c.blocked_on = addr
            c.in_mwait = True
            c.t_arm = t_arm
            c.desched_segments.append((t_arm, -1))  # end filled on wake
            return
        # all flags observed — wait phase completes at the poll cursor
        end = c.t_cursor
        self._complete_phase(c, spec, c.wait_start, end)
        c.in_wait = False
        self._enter_next_phase(c, end)

    # ------------------------------------------------------------------
    # peer-write enactment hooks (called by the engines)
    # ------------------------------------------------------------------

    def on_writes_enacted(self, writes: List[RegisteredWrite], cycle: int) -> None:
        """Process a batch of WTT writes that were enacted at ``cycle``.

        The DirectoryMemory has already applied them (and fired Monitor Log
        observers).  Here we resolve flag visibility for blocked workgroups.
        """
        cfg = self.cfg
        poll = cfg.poll_interval_cycles
        check = cfg.flag_check_cycles
        traffic = self.memory.traffic
        for w in writes:
            if w.addr not in self._watched:
                continue
            if w.addr not in self.flag_set_cycle:
                self.flag_set_cycle[w.addr] = cycle
            if cfg.sync == SyncPolicy.SPIN:
                waiters = self._spin_waiters.pop(w.addr, set())
                for ci in sorted(waiters):
                    c = self.cohorts[ci]
                    # account the polls from t_cursor up to the observation
                    # tick, closed-form across the cohort's members
                    gap = cycle - c.t_cursor
                    nticks = -(gap // -poll) if gap > 0 else 0
                    m = c.count * (nticks + 1)
                    traffic.flag_reads += m
                    traffic.read_bytes += 8 * m
                    c.t_cursor += nticks * poll + check
                    c.flag_idx += 1
                    c.blocked_on = None
                    self._push(c.t_cursor, ci)
        if cfg.sync == SyncPolicy.SYNCMON and self.monitor_log is not None:
            pending = self.monitor_log.pop_wakes_until(
                cycle + cfg.wake_latency_cycles
            )
            # A cohort's members armed one entry together and wake together,
            # so scan the pending wakes once per cohort.  The coalesced
            # validation read accounting stays *member*-granular: simultaneous
            # wakes group by (wake_cycle, cu) ACROSS cohorts, exactly as the
            # per-workgroup interpreter groups individual workgroups.
            race: List[_Cohort] = []
            woken: List[Tuple[int, _Cohort]] = []
            groups: Dict[Tuple[int, int], int] = {}
            seen: Set[int] = set()
            for wg_id, wake_c in pending:
                ci = self._by_wg[wg_id]
                if ci in seen:
                    continue
                c = self.cohorts[ci]
                if not c.in_mwait:
                    continue
                seen.add(ci)
                if cycle <= c.t_arm:
                    race.append(c)
                    continue
                for cu in (c.member_cus or (c.program.cu,) * c.count):
                    key = (wake_c, cu)
                    groups[key] = groups.get(key, 0) + 1
                woken.append((wake_c, c))
            for c in race:
                # race window: the write landed between the check read and
                # the monitor arming; the mwait returns immediately after
                # its own (uncoalesced) validation read at arm time
                self.memory.bulk_reads(c.count, bytes_each=8, flag=True)
                c.in_mwait = False
                for wg in c.members:
                    self._armed.pop(wg, None)
                if c.desched_segments and c.desched_segments[-1][1] == -1:
                    c.desched_segments.pop()  # never actually descheduled
                self.monitor_log.stats["immediate_mwait_returns"] += c.count
                c.blocked_on = None
                c.flag_idx += 1
                c.t_cursor = c.t_arm + cfg.flag_check_cycles
                self._push(c.t_cursor, c.idx)
            width = max(1, cfg.wake_coalesce_width)
            for (wake_c, _cu), n_members in sorted(groups.items()):
                self.memory.bulk_reads(
                    math.ceil(n_members / width), bytes_each=8, flag=True
                )
            for wake_c, c in woken:
                c.in_mwait = False
                for wg in c.members:
                    self._armed.pop(wg, None)
                # close the descheduled segment
                if c.desched_segments and c.desched_segments[-1][1] == -1:
                    st = c.desched_segments[-1][0]
                    c.desched_segments[-1] = (st, wake_c)
                jitter = c.program.wg % max(1, cfg.requeue_jitter_mod)
                resume = wake_c + jitter
                # the coalesced validation read observed the blocking flag;
                # if it is (now) set, advance past it without another read
                addr = c.blocked_on
                set_c = self.flag_set_cycle.get(addr)
                if set_c is not None and set_c <= resume:
                    c.flag_idx += 1
                c.blocked_on = None
                c.t_cursor = resume + cfg.flag_check_cycles
                self._push(c.t_cursor, c.idx)

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------

    def collect_segments(self) -> List[Segment]:
        segs: List[Segment] = []
        ns = self.cfg.cycles_to_ns
        for c in self.cohorts:
            for wg in c.members:
                for phase, st, en in c.segments:
                    segs.append(
                        Segment(
                            wg=wg,
                            phase=phase,
                            start_ns=ns(st),
                            end_ns=ns(en),
                            device=self.device_id,
                        )
                    )
                for st, en in c.desched_segments:
                    if en >= st >= 0:
                        segs.append(
                            Segment(
                                wg=wg,
                                phase="descheduled",
                                start_ns=ns(st),
                                end_ns=ns(en),
                                device=self.device_id,
                            )
                        )
        return sorted(segs, key=lambda s: (s.wg, s.start_ns))
