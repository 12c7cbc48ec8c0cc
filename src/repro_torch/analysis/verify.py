"""Static checks over the lowered wait/emit graph (port of
``repro/analysis/verify.py``).

Four check families, all running in milliseconds and without an engine:

* **deadlock** — a monotone fixpoint over the lanes (flags are sticky, so
  satisfiability is timing-independent): advance every lane while its next
  phase's flags are available, firing emissions as phases complete with the
  cluster's exact coalescing semantics ("each" per lane completion, "last"
  when the whole device's workgroup count passes the phase).  Lanes still
  stuck at the fixpoint are deadlocked; Tarjan's SCC over their wait-for
  graph yields the blame cycles, reported as rank/phase/flag chains.
* **unmatched synchronization** — waits on flags no rank (or trace) ever
  writes; emits into the flag region no rank ever awaits; duplicate emits to
  a flag with a single consuming wait (count mismatch).
* **flag-slot write races** — two emit sites targeting the same flag key with
  no happens-before path between them (program order within a lane, plus
  single-emitter wait edges across lanes).
* **fabric reachability** — every emission's ``(src, dst)`` pair must be
  routable on the resolved :class:`repro_torch.core.interconnect.InterconnectSpec`
  (catches presets whose routing policy cannot serve a scenario's traffic).

:func:`verify_scenario` is the public entry point; it mirrors
:func:`repro_torch.core.scenario.simulate`'s resolution (name/class/instance plus
``devices``/``nodes``/``devices_per_node`` shape sugar) and returns a
:class:`Verdict`.  :func:`diagnose_deadlock` is the runtime hook: the engines
embed its blame-chain rendering into :class:`EidolaDeadlock` messages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.config import SimConfig
from repro_torch.core.scenario import (
    Scenario,
    ScenarioLike,
    _resolve,
    _resolve_shape,
)

from .program_graph import EmitSite, FlagKey, ProgramGraph, WaitSite

__all__ = [
    "Finding",
    "Verdict",
    "verify_graph",
    "verify_scenario",
    "verify_symbolic",
    "diagnose_deadlock",
]

# finding kinds that predict an EidolaDeadlock at runtime
_DEADLOCK_KINDS = frozenset(
    {"deadlock-cycle", "unmatched-wait", "unsatisfiable-wait"}
)


@dataclass(frozen=True)
class Finding:
    """One verifier diagnosis: a kind tag, a severity, and the blame text."""

    kind: str
    severity: str  # "error" | "warning"
    message: str

    def render(self) -> str:
        return f"[{self.severity}] {self.kind}: {self.message}"


@dataclass
class Verdict:
    """The verifier's result for one scenario instance on one fabric."""

    scenario: str
    n_devices: int
    fabric: Optional[str] = None
    findings: List[Finding] = field(default_factory=list)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    @property
    def deadlock(self) -> bool:
        """True when the program cannot terminate (the runtime engines would
        raise :class:`repro_torch.core.target.EidolaDeadlock`)."""
        return any(f.kind in _DEADLOCK_KINDS for f in self.findings)

    def render(self) -> str:
        head = (
            f"verify {self.scenario!r} ({self.n_devices} devices"
            + (f", fabric {self.fabric!r}" if self.fabric else "")
            + "): "
        )
        if not self.findings:
            return head + "ok"
        lines = [head + f"{len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s)"]
        lines.extend("  " + f.render() for f in self.findings)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the deadlock fixpoint
# ---------------------------------------------------------------------------


@dataclass
class _Saturation:
    """State after running every lane as far as flag availability allows."""

    cursors: List[int]                       # per-lane next phase index
    flags: Set[FlagKey]                      # flag keys known set
    completions: Dict[Tuple[int, int], int]  # (device, phase_idx) -> wgs done
    stuck: List[int]                         # lane indices not run to the end


def _saturate(g: ProgramGraph) -> _Saturation:
    """Run the timing-free abstraction of the closed loop to its fixpoint.

    Flags are write-once-sticky and waits only observe set-ness, so whether
    every lane terminates is independent of the engines' timing — a monotone
    worklist suffices and is exact for the cluster's semantics.
    """
    flags: Set[FlagKey] = set(g.external_flags)
    cursors = [0] * len(g.lanes)
    completions: Dict[Tuple[int, int], int] = {}

    # emit sites indexed by (lane, phase_idx) so firing a phase is O(sites)
    sites_at: Dict[Tuple[int, int], List[Tuple[FlagKey, EmitSite]]] = {}
    for key, sites in g.emitters.items():
        for s in sites:
            sites_at.setdefault((s.lane, s.phase_idx), []).append((key, s))

    def fire(lane_idx: int, phase_idx: int, last_only: bool) -> None:
        for key, s in sites_at.get((lane_idx, phase_idx), ()):
            if (s.coalesce == "last") == last_only:
                flags.add(key)

    progress = True
    while progress:
        progress = False
        for li, lane in enumerate(g.lanes):
            while cursors[li] < len(lane.phases):
                ph = lane.phases[cursors[li]]
                if ph.wait_addrs and any(
                    (lane.device, a) not in flags for a in ph.wait_addrs
                ):
                    break
                idx = cursors[li]
                cursors[li] += 1
                progress = True
                key = (lane.device, idx)
                completions[key] = completions.get(key, 0) + lane.wg_count
                fire(li, idx, last_only=False)  # "each" emits: on completion
                if completions[key] >= g.device_wgs[lane.device]:
                    # "last" emits fire when the whole device passes the
                    # phase — from every lane of the device long enough to
                    # hold that phase index (matching Cluster._on_emit's
                    # workgroup-count threshold)
                    for lj in g.lanes_of[lane.device]:
                        if len(g.lanes[lj].phases) > idx:
                            fire(lj, idx, last_only=True)
    stuck = [
        li for li, lane in enumerate(g.lanes)
        if cursors[li] < len(lane.phases)
    ]
    return _Saturation(cursors, flags, completions, stuck)


def _site_fired(g: ProgramGraph, sat: _Saturation, s: EmitSite) -> bool:
    if s.coalesce == "each":
        return sat.cursors[s.lane] > s.phase_idx
    done = sat.completions.get((s.device, s.phase_idx), 0)
    return done >= g.device_wgs[s.device]


def _site_dead(g: ProgramGraph, s: EmitSite) -> bool:
    """True when a "last" emit can structurally never fire: some lane of the
    emitting device is too short to ever complete the phase, so the device's
    workgroup completion count cannot reach the threshold."""
    if s.coalesce != "last":
        return False
    reachable = sum(
        g.lanes[lj].wg_count
        for lj in g.lanes_of[s.device]
        if len(g.lanes[lj].phases) > s.phase_idx
    )
    return reachable < g.device_wgs[s.device]


def _tarjan(nodes: Sequence[int], edges: Dict[int, List[int]]) -> List[List[int]]:
    """Tarjan's strongly-connected components, iterative (deep cycles at
    fleet scale must not hit the recursion limit)."""
    index: Dict[int, int] = {}
    low: Dict[int, int] = {}
    on_stack: Set[int] = set()
    stack: List[int] = []
    sccs: List[List[int]] = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work: List[Tuple[int, int]] = [(root, 0)]
        while work:
            v, ei = work[-1]
            if ei == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack.add(v)
            advanced = False
            succs = edges.get(v, [])
            while ei < len(succs):
                w = succs[ei]
                ei += 1
                if w not in index:
                    work[-1] = (v, ei)
                    work.append((w, 0))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                scc: List[int] = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(scc)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
    return sccs


# ---------------------------------------------------------------------------
# the individual checks
# ---------------------------------------------------------------------------


def _check_invalid_emits(g: ProgramGraph, out: List[Finding]) -> None:
    for msg in g.invalid_emits:
        out.append(Finding("invalid-emit", "error", msg))


def _check_unmatched(g: ProgramGraph, out: List[Finding]) -> None:
    for key in sorted(g.waiters):
        if key not in g.emitters and key not in g.external_flags:
            sites = g.waiters[key]
            out.append(Finding(
                "unmatched-wait",
                "error",
                f"{g.describe_key(key)} is never written by any rank or "
                f"trace; blocked: " + "; ".join(
                    s.describe() for s in sites[:4]
                ) + ("" if len(sites) <= 4 else f" (+{len(sites) - 4} more)"),
            ))
    for key in sorted(g.emitters):
        device, addr = key
        sites = g.emitters[key]
        # raw-address emits outside the flag region are data pushes, not
        # synchronization — only unawaited *flags* indicate a program bug
        if sites[0].slot is None:
            continue
        if key not in g.waiters:
            out.append(Finding(
                "unawaited-emit",
                "warning",
                f"{g.describe_key(key)} is emitted but no rank ever waits "
                "on it: " + "; ".join(s.describe() for s in sites[:4]),
            ))
        elif len(sites) > len(g.waiters[key]):
            out.append(Finding(
                "count-mismatch",
                "warning",
                f"{g.describe_key(key)} has {len(sites)} emit sites but "
                f"only {len(g.waiters[key])} wait site(s) — the flag is "
                "sticky, so later emissions are unobservable: "
                + "; ".join(s.describe() for s in sites),
            ))
    # vacuous re-waits: one lane waiting the same sticky flag twice
    for key in sorted(g.waiters):
        by_lane: Dict[int, List[WaitSite]] = {}
        for s in g.waiters[key]:
            by_lane.setdefault(s.lane, []).append(s)
        for sites in by_lane.values():
            idxs = sorted({s.phase_idx for s in sites})
            if len(idxs) > 1:
                out.append(Finding(
                    "count-mismatch",
                    "warning",
                    f"{g.describe_key(key)} is awaited at phases {idxs} of "
                    f"the same rank-{sites[0].device} program; the flag "
                    "stays set after the first wait, so the later waits "
                    "never synchronize",
                ))


def _hb_reachable(
    g: ProgramGraph,
    frm: Tuple[int, int],
    to: Tuple[int, int],
    succ: Dict[Tuple[int, int], List[Tuple[int, int]]],
) -> bool:
    """DFS over the happens-before DAG of (lane, phase_idx) nodes."""
    seen: Set[Tuple[int, int]] = set()
    stack = [frm]
    while stack:
        node = stack.pop()
        if node == to:
            return True
        if node in seen:
            continue
        seen.add(node)
        lane, idx = node
        if idx + 1 < len(g.lanes[lane].phases):
            stack.append((lane, idx + 1))
        stack.extend(succ.get(node, ()))
    return False


def _check_races(g: ProgramGraph, out: List[Finding]) -> None:
    # cross-lane happens-before edges: a wait phase observing a flag with
    # exactly one emit site orders that site before the wait; with several
    # sites any one write satisfies the wait, so no order is guaranteed
    succ: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for key, waits in g.waiters.items():
        sites = g.emitters.get(key, [])
        if len(sites) != 1:
            continue
        e = sites[0]
        for w in waits:
            succ.setdefault((e.lane, e.phase_idx), []).append(
                (w.lane, w.phase_idx)
            )
    for key in sorted(g.emitters):
        sites = g.emitters[key]
        if len(sites) < 2:
            continue
        for i in range(len(sites)):
            for j in range(i + 1, len(sites)):
                a, b = sites[i], sites[j]
                if a.lane == b.lane:
                    continue  # program order within the lane
                na, nb = (a.lane, a.phase_idx), (b.lane, b.phase_idx)
                if _hb_reachable(g, na, nb, succ) or _hb_reachable(
                    g, nb, na, succ
                ):
                    continue
                out.append(Finding(
                    "slot-race",
                    "error",
                    f"unordered writers to {g.describe_key(key)}: "
                    f"{a.describe()} vs {b.describe()} — no happens-before "
                    "path orders them, so the waiting rank may observe "
                    "either write first",
                ))


def _check_reachability(
    g: ProgramGraph, fabric, out: List[Finding]
) -> None:
    if fabric is None:
        return
    for src, dst in g.emit_pairs():
        if src == dst:
            out.append(Finding(
                "unreachable-pair",
                "error",
                f"rank {src} emits to itself; the fabric routes no "
                "self-loops (use a local write, not an EmitOp)",
            ))
            continue
        if not (0 <= dst < g.n_devices):
            out.append(Finding(
                "unreachable-pair",
                "error",
                f"emit destination {dst} is outside the {g.n_devices}-device "
                "fabric",
            ))
            continue
        try:
            legs = fabric.legs(src, dst)
        except Exception as e:  # routing policies raise their own types
            out.append(Finding(
                "unreachable-pair",
                "error",
                f"no route for emission {src} -> {dst} on fabric "
                f"{fabric.spec.name!r}: {e}",
            ))
            continue
        if not legs:
            out.append(Finding(
                "unreachable-pair",
                "error",
                f"fabric {fabric.spec.name!r} routes {src} -> {dst} over "
                "zero legs",
            ))


def _check_deadlock(g: ProgramGraph, out: List[Finding]) -> None:
    sat = _saturate(g)
    if not sat.stuck:
        return
    stuck_set = set(sat.stuck)
    # wait-for graph over stuck lanes: an edge L -> M means L's unsatisfied
    # flag has a pending emit site whose firing is held up by lane M
    edges: Dict[int, List[int]] = {}
    labels: Dict[Tuple[int, int], Tuple[WaitSite, EmitSite]] = {}
    blocked_sites: Dict[int, List[WaitSite]] = {}
    for li in sat.stuck:
        lane = g.lanes[li]
        ph = lane.phases[sat.cursors[li]]
        if not ph.wait_addrs:
            continue  # cannot happen: only waits block
        for a in ph.wait_addrs:
            key = (lane.device, a)
            if key in sat.flags:
                continue
            wsite = next(
                (
                    w for w in g.waiters.get(key, [])
                    if w.lane == li and w.phase_idx == sat.cursors[li]
                ),
                None,
            )
            if wsite is None:
                decoded_sites = g.waiters.get(key, [])
                wsite = decoded_sites[0] if decoded_sites else WaitSite(
                    lane.device, li, sat.cursors[li], ph.name, a
                )
            blocked_sites.setdefault(li, []).append(wsite)
            pending = [
                s for s in g.emitters.get(key, [])
                if not _site_fired(g, sat, s)
            ]
            live = [s for s in pending if not _site_dead(g, s)]
            if not pending and key not in g.emitters:
                continue  # reported by the unmatched-wait check
            if pending and not live:
                out.append(Finding(
                    "unsatisfiable-wait",
                    "error",
                    f"{wsite.describe()}, but every emitter of "
                    f"{g.describe_key(key)} is 'last'-coalesced on a device "
                    "whose workgroups can never all reach the emitting "
                    "phase",
                ))
                continue
            for s in live:
                holders = {s.lane}
                if s.coalesce == "last":
                    # any lane of the emitting device that has not passed
                    # the phase holds up the device-wide completion count
                    holders.update(
                        lj for lj in g.lanes_of[s.device]
                        if len(g.lanes[lj].phases) > s.phase_idx
                        and sat.cursors[lj] <= s.phase_idx
                    )
                for h in holders & stuck_set:
                    edges.setdefault(li, []).append(h)
                    labels.setdefault((li, h), (wsite, s))
    for targets in edges.values():
        targets.sort()
    sccs = _tarjan(sorted(stuck_set), edges)
    reported: Set[int] = set()
    for scc in sccs:
        if len(scc) == 1 and scc[0] not in edges.get(scc[0], []):
            continue
        member = set(scc)
        # walk one concrete cycle through the SCC for the blame chain
        start = min(scc)
        chain: List[Tuple[WaitSite, EmitSite]] = []
        seen_nodes: List[int] = []
        node = start
        while node not in seen_nodes:
            seen_nodes.append(node)
            nxt = next(
                (t for t in edges.get(node, []) if t in member), None
            )
            if nxt is None:
                break
            chain.append(labels[(node, nxt)])
            node = nxt
        if node in seen_nodes:
            # trim to the actual cycle portion
            k = seen_nodes.index(node)
            chain = chain[k:]
        parts = [
            f"{w.describe()} <- emitted by rank {e.device} "
            f"phase {e.phase_idx} {e.phase_name!r}"
            for w, e in chain
        ]
        out.append(Finding(
            "deadlock-cycle",
            "error",
            "wait-for cycle spanning ranks "
            + ",".join(str(g.lanes[li].device) for li in seen_nodes)
            + ": " + "; ".join(parts),
        ))
        reported.update(seen_nodes)
    # stuck lanes outside any cycle: blocked behind the cycle or behind an
    # unmatched flag (the latter already has its own finding)
    collateral = [
        li for li in sat.stuck
        if li not in reported and li in blocked_sites
        and any(
            (g.lanes[li].device, w.addr) in g.emitters
            for w in blocked_sites[li]
        )
        and edges.get(li)
    ]
    if reported and collateral:
        out.append(Finding(
            "deadlock-cycle",
            "warning",
            "additionally blocked behind the cycle: " + "; ".join(
                blocked_sites[li][0].describe() for li in collateral[:6]
            ),
        ))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def verify_graph(
    g: ProgramGraph, *, fabric=None, scenario_name: Optional[str] = None
) -> Verdict:
    """Run every check over an already-lowered :class:`ProgramGraph`."""
    findings: List[Finding] = []
    _check_invalid_emits(g, findings)
    _check_unmatched(g, findings)
    _check_races(g, findings)
    _check_reachability(g, fabric, findings)
    _check_deadlock(g, findings)
    findings.sort(key=lambda f: (f.severity != "error", f.kind))
    return Verdict(
        scenario=scenario_name or g.scenario_name,
        n_devices=g.n_devices,
        fabric=fabric.spec.name if fabric is not None else None,
        findings=findings,
    )


def verify_scenario(
    scenario: ScenarioLike,
    cfg: Optional[SimConfig] = None,
    *,
    devices: Optional[int] = None,
    nodes: Optional[int] = None,
    devices_per_node: Optional[int] = None,
    **params,
) -> Verdict:
    """Statically verify one scenario instance; no simulation runs.

    Mirrors :func:`repro_torch.core.scenario.simulate`'s resolution: ``scenario``
    may be a registered name, a Scenario subclass, or a ready instance, and
    any two of ``devices``/``nodes``/``devices_per_node`` fix the fabric
    shape.  Closed-loop scenarios additionally get the fabric-reachability
    check against the same resolved fabric the Cluster would route over
    (``fabric=``/``link_bw=`` scenario params included).
    """
    devices, dpn = _resolve_shape(devices, nodes, devices_per_node)
    if dpn is not None:
        params.setdefault("devices_per_node", dpn)
    if devices is not None:
        cfg = (cfg or SimConfig()).with_devices(devices)
    if isinstance(scenario, Scenario):
        if cfg is not None and cfg != scenario.cfg:
            raise ValueError(
                "scenario instance was built with a different SimConfig "
                "than the one passed to verify_scenario(); rebuild the "
                "scenario or drop the cfg/devices arguments"
            )
        cfg = scenario.cfg
    cfg = (cfg or SimConfig()).validate()
    sc = _resolve(scenario, cfg, params)
    g = ProgramGraph.from_scenario(sc)
    fabric = None
    if sc.closed_loop:
        from repro_torch.core.cluster import resolve_cluster_fabric

        try:
            fabric = resolve_cluster_fabric(cfg, sc)
        except ValueError as e:
            v = Verdict(scenario=g.scenario_name, n_devices=g.n_devices)
            v.findings.append(Finding(
                "unreachable-pair",
                "error",
                f"fabric resolution failed: {e}",
            ))
            return v
    verdict = verify_graph(g, fabric=fabric)
    if sc.closed_loop:
        # concrete layout obligations at this instance's exact shape (the
        # all-n parametric form lives in prove_layout); findings merge into
        # the same verdict so the CLI --verify path reports both
        from .layout import check_layout

        for f in check_layout(sc):
            verdict.findings.append(Finding(f.kind, f.severity, f.message))
        verdict.findings.sort(
            key=lambda f: (f.severity != "error", f.kind)
        )
    return verdict


def _try_tiered_plan(cfg, sc) -> Optional[str]:
    """Compile the scenario through the tiered group-uniform lockstep
    planner; None on success (the plan's total instruction order proves
    deadlock freedom), else the compiler's refusal reason."""
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.lockstep import LockstepEngine, lockstep_support

    try:
        # compilation touches no tensor: the host is enough
        cluster = Cluster(cfg, sc, collect_segments=False, device="cpu")
    except (ValueError, NotImplementedError) as e:
        return f"cluster construction failed: {e}"
    reason = lockstep_support(cluster)
    if reason is not None:
        return reason
    return LockstepEngine(cluster).compile()


def verify_symbolic(
    scenario: ScenarioLike,
    cfg: Optional[SimConfig] = None,
    *,
    devices: Optional[int] = None,
    nodes: Optional[int] = None,
    devices_per_node: Optional[int] = None,
    **params,
) -> Verdict:
    """Loop-space verification of rank-uniform symbolic programs.

    Instead of materializing every phase of every rank (O(devices x steps)
    wait/emit sites — 33M at 4096 devices for a flat ring), this lowers each
    rank's :class:`repro_torch.core.scenario.SymbolicProgram` into one node per
    (lane, affine pattern) via :func:`repro_torch.core.lockstep.plan_stages` and
    proves every wait family is consumed by a strictly *earlier* emission
    family (lexicographic order over (segment, iteration, body position)).
    For lockstep programs that is exactly the deadlock-freedom argument: a
    matched plan cannot cycle, because the wait-for relation is embedded in
    a total order.  Work and memory are O(segments x devices).

    Returns a clean :class:`Verdict` on success.  Programs outside the
    globally rank-uniform families get a second chance at *group* level:
    the tiered lockstep compiler (:mod:`repro_torch.core.lockstep_tiered`)
    schedules group-uniform programs (leader/worker splits, per-stage
    groups) into one total instruction order, and a successful compile is
    the same deadlock-freedom argument — every wait column is consumed by
    a strictly earlier emission instance.  A program outside both lowering
    families yields a single ``symbolic-shape`` warning (severity
    "warning": such programs are covered by the materialized
    :func:`verify_scenario` instead); a rank-uniform program whose wait
    has no earlier matching emission is an error (the engines would
    deadlock).
    """
    from repro_torch.core.lockstep import UnsupportedProgram, plan_stages
    from repro_torch.core.scenario import as_symbolic

    devices, dpn = _resolve_shape(devices, nodes, devices_per_node)
    if dpn is not None:
        params.setdefault("devices_per_node", dpn)
    if devices is not None:
        cfg = (cfg or SimConfig()).with_devices(devices)
    if isinstance(scenario, Scenario):
        if cfg is not None and cfg != scenario.cfg:
            raise ValueError(
                "scenario instance was built with a different SimConfig "
                "than the one passed to verify_symbolic(); rebuild the "
                "scenario or drop the cfg/devices arguments"
            )
        cfg = scenario.cfg
    cfg = (cfg or SimConfig()).validate()
    sc = _resolve(scenario, cfg, params)
    name = sc.name or type(sc).__name__
    v = Verdict(scenario=name, n_devices=cfg.n_devices)

    def skip(msg: str) -> Verdict:
        v.findings.append(Finding("symbolic-shape", "warning", msg))
        return v

    if not sc.closed_loop:
        return skip("open-loop scenario: no per-rank programs to align")
    progs = []
    for d in range(cfg.n_devices):
        programs = sc.programs_for(d)
        if not programs:
            return skip(f"rank {d} has no workgroup programs")
        ph = programs[0].phases
        if any(p.phases is not ph for p in programs[1:]):
            return skip(
                f"rank {d} runs multiple lanes; loop-space lowering needs "
                "one shared program per rank"
            )
        sp = as_symbolic(ph)
        if sp is None:
            return skip(
                f"rank {d} runs a flat (non-symbolic) program; covered by "
                "the materialized verifier"
            )
        progs.append(sp)
    try:
        plan_stages(sc.amap, cfg.n_devices, progs)
    except UnsupportedProgram as e:
        msg = str(e)
        # an unmatched wait in a rank-uniform program means no earlier
        # stage ever writes the awaited flags — the engines would deadlock;
        # every other UnsupportedProgram is a shape outside the affine
        # families, which the materialized verifier covers instead
        if "no matching earlier emission" in msg:
            v.findings.append(Finding(
                "unmatched-wait",
                "error",
                f"loop-space matching failed: {msg} — no earlier emission "
                "family writes the awaited flag family, so every engine "
                "would deadlock at this wait",
            ))
            return v
        # outside the flat rank-uniform families: retry at group level
        # through the tiered compiler.  A group-level schedule failure is
        # NOT a deadlock verdict — cross-group pipelined chains are valid
        # programs the timeline engine runs fine — so it stays a warning
        # carrying the compiler's blame (group, rank, phase, flag).
        tiered_msg = _try_tiered_plan(cfg, sc)
        if tiered_msg is None:
            return v
        return skip(
            f"{msg}; group-level lowering also declined: {tiered_msg}"
        )
    except ValueError as e:  # address-map probing (bad slot/device)
        v.findings.append(Finding(
            "invalid-emit",
            "error",
            f"symbolic program probing failed: {e}",
        ))
    return v


def diagnose_deadlock(scenario: Scenario) -> Optional[str]:
    """Blame-chain rendering of the scenario's deadlock findings, or None.

    Called by the engines when they hit an empty-queue deadlock: the static
    analyzer explains *why* the wait-for graph cycled (or which flags are
    unmatched), which the runtime state alone cannot.
    """
    g = ProgramGraph.from_scenario(scenario)
    findings: List[Finding] = []
    _check_unmatched(g, findings)
    _check_deadlock(g, findings)
    blame = [f for f in findings if f.kind in _DEADLOCK_KINDS]
    if not blame:
        return None
    return "static analysis:\n" + "\n".join(
        "  " + f.render() for f in blame
    )
