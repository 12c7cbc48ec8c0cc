"""Parametric layout & happens-before prover (port of
``repro/analysis/layout.py``).

Every closed-loop scenario synchronizes through three address regions of one
:class:`repro_torch.core.memory.AddressMap`: the *flag pool* (``flag_addr(src,
slot)``), the *partial-tile region* where data-marker writes accumulate
upward from ``partial_base``, and the raw data region.  The engines resolve
waits **by value**, so any aliasing between those regions lets a stale
marker satisfy a flag wait long before the real emission arrives — the bug
class ``ring_allreduce`` once had beyond 256 devices.

This module proves the layout safe for *all* device counts, not just the n a
test happened to run.  It lowers each scenario's
:class:`repro_torch.core.scenario.SymbolicProgram` + AddressMap into affine
address families — flag-slot progressions over loop iterations (``k``) and
run members (``j``), data-marker windows ``[partial_base, partial_base +
64*marks[d])``, and region extents as functions of ``n`` — then discharges,
via gcd/lag residues and interval arithmetic over that affine IR and
*without expanding a single program or simulating*:

(a) flag pool, partial region, and marker windows are pairwise disjoint;
(b) every flag address has a unique writer per value epoch (no two emission
    instances rewrite the same ``(writer, slot)`` — cross-writer collisions
    are impossible because ``flag_addr`` is injective over ``slot*n + src``,
    so the check is per-writer local);
(c) every wait family is fed by an emission family (existence statically;
    strict happens-before order via the loop-space planner,
    :func:`repro_torch.analysis.verify.verify_symbolic`, at probe counts).

for every constructible device count up to the scenario's
``max_devices`` bound.  Small counts are checked exhaustively rank-by-rank;
large counts through representative rank classes whose family descriptors
are fitted as exact integer polynomials in n at a handful of probe counts
(verified on held-out probes) and then evaluated over the whole candidate
range with vectorized interval/gcd arithmetic.  Any parametric hit is
re-confirmed concretely at the smallest suspect count so findings name the
exact slot, the writer pair, and the first aliasing n.

The tiered lockstep compiler (:mod:`repro_torch.core.lockstep_tiered`) consumes
the same concrete checker (:func:`check_programs`) instead of re-deriving
its private ``_check_flag_reuse`` — one implementation, two call sites.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.config import SimConfig
from repro_torch.core.memory import AddressMap
from repro_torch.core.scenario import (
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
    as_symbolic,
    get_scenario,
    list_scenarios,
)

__all__ = [
    "LayoutFinding",
    "LayoutProof",
    "check_layout",
    "check_programs",
    "prove_layout",
    "prove_registry",
]

ScenarioRef = Union[str, type]


def _flag_name(writer: int, slot: int) -> str:
    return f"flag (writer {writer}, slot {slot})"


# ---------------------------------------------------------------------------
# findings / proofs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayoutFinding:
    """One provable layout defect (or modelling limit) with exact blame."""

    kind: str
    severity: str  # "error" | "warning"
    message: str
    n_devices: Optional[int] = None  # smallest device count exhibiting it
    slot: Optional[int] = None
    writers: Tuple[int, ...] = ()
    dst: Optional[int] = None

    def render(self) -> str:
        where = f" [n={self.n_devices}]" if self.n_devices is not None else ""
        return f"[{self.severity}] {self.kind}{where}: {self.message}"


@dataclass
class LayoutProof:
    """Result of a parametric sweep over one scenario's device counts."""

    scenario: str
    devices_per_node: Optional[int]
    fabric: Optional[str]
    max_devices: int
    findings: List[LayoutFinding] = field(default_factory=list)
    checked_counts: Tuple[int, ...] = ()  # exhaustively checked (small n)
    probe_counts: Tuple[int, ...] = ()  # full-rank probes (large n)
    ordering_counts: Tuple[int, ...] = ()  # happens-before probe counts
    parametric: bool = False  # large regime covered by verified models
    notes: Tuple[str, ...] = ()

    @property
    def errors(self) -> List[LayoutFinding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def render(self) -> str:
        dpn = self.devices_per_node
        shape = f" dpn={dpn}" if dpn else ""
        fab = f" fabric={self.fabric}" if self.fabric else ""
        head = (
            f"layout proof: {self.scenario}{shape}{fab} "
            f"n<={self.max_devices}: "
            + ("PROVEN" if self.ok else f"{len(self.errors)} finding(s)")
        )
        lines = [head]
        lines.extend("  " + f.render() for f in self.findings)
        lines.extend("  note: " + n for n in self.notes)
        return "\n".join(lines)


class _Unmodeled(Exception):
    """Program shape outside the affine families the prover lowers."""


# ---------------------------------------------------------------------------
# affine family extraction (no expansion: one record per emission/wait site)
# ---------------------------------------------------------------------------


@dataclass
class _EFam:
    """One emission site: ``m`` members (j) re-emitted over ``epochs`` (k).

    dst(j) = dst0 + j*dstep; slot(j, k) = slot0 + j*sstep_j + k*sstep_k.
    ``raw`` marks an address-override emission (no flag-slot convention);
    its literal target is ``addr0``.
    """

    writer: int
    name: str
    pos: int  # phase ordinal within the rank's program
    m: int
    dst0: int
    dstep: int
    slot0: int
    sstep_j: int
    sstep_k: int
    epochs: int
    dw: int
    raw: bool = False
    addr0: int = 0

    @property
    def site(self) -> str:
        return f"{self.name}#{self.pos}"


@dataclass
class _WFam:
    """One wait site: ``m`` member addresses (j) awaited over ``epochs``."""

    rank: int
    name: str
    pos: int
    m: int
    addr0: int
    astep_j: int
    astep_k: int
    epochs: int

    @property
    def site(self) -> str:
        return f"{self.name}#{self.pos}"


def _extract_program(
    program, rank: int
) -> Tuple[List[_EFam], List[_WFam]]:
    """Lower one rank's program into affine families — O(sites), not
    O(phases): loops contribute one record per body site."""
    efams: List[_EFam] = []
    wfams: List[_WFam] = []
    if isinstance(program, SymbolicProgram):
        segments = program.segments
    else:
        segments = tuple(program)
    pos = 0
    for seg in segments:
        if isinstance(seg, LoopSpec):
            body, count, k0 = seg.body, seg.count, seg.k0
        elif isinstance(seg, (PhaseSpec, LoopPhase)):
            body, count, k0 = (seg,), 1, 0
        else:
            raise _Unmodeled(
                f"rank {rank}: unknown segment type {type(seg).__name__}"
            )
        if count <= 0:
            continue
        for ph in body:
            for w in ph.wait_addrs or ():
                if isinstance(w, AffineRun):
                    wfams.append(_WFam(
                        rank, ph.name, pos, w.count, w.start, w.stride,
                        0, count,
                    ))
                elif isinstance(w, Affine):
                    wfams.append(_WFam(
                        rank, ph.name, pos, 1, w.at(k0),
                        0, w.step if count > 1 else 0, count,
                    ))
                else:
                    wfams.append(_WFam(
                        rank, ph.name, pos, 1, int(w), 0, 0, count,
                    ))
            for e in ph.emits or ():
                if isinstance(e, EmitRun):
                    if e.count <= 0:
                        continue
                    efams.append(_EFam(
                        rank, ph.name, pos, e.count, e.dst0,
                        e.dst_stride if e.count > 1 else 0, e.slot0,
                        e.slot_stride if e.count > 1 else 0, 0, count,
                        e.data_writes,
                    ))
                elif isinstance(e, LoopEmit):
                    if e.dst.step != 0 and count > 1:
                        raise _Unmodeled(
                            f"rank {rank}: emission destination varies "
                            f"across loop iterations in phase {ph.name!r}"
                        )
                    efams.append(_EFam(
                        rank, ph.name, pos, 1, e.dst.at(k0), 0,
                        e.slot.at(k0), 0,
                        e.slot.step if count > 1 else 0, count,
                        e.data_writes,
                    ))
                elif isinstance(e, EmitOp):
                    if e.addr is not None:
                        efams.append(_EFam(
                            rank, ph.name, pos, 1, e.dst, 0, 0, 0, 0,
                            count, e.data_writes, raw=True, addr0=e.addr,
                        ))
                    else:
                        efams.append(_EFam(
                            rank, ph.name, pos, 1, e.dst, 0, e.slot, 0, 0,
                            count, e.data_writes,
                        ))
                else:
                    raise _Unmodeled(
                        f"rank {rank}: unknown emit entry "
                        f"{type(e).__name__} in phase {ph.name!r}"
                    )
            pos += 1
    return efams, wfams


def _flag_linear(amap: AddressMap, n: int) -> Tuple[int, int]:
    """Validated linear form of the flag pool: ``addr = base + unit*(slot*n
    + src)``.  Raises :class:`_Unmodeled` for maps that break the form."""
    base, unit = amap.flag_linear()
    checks = [(0, 0, base)]
    if n > 1:
        checks.append((1, 0, base + unit))
    if amap.flag_slots > 1:
        checks.append((0, 1, base + unit * n))
    for src, slot, want in checks:
        if amap.flag_addr(src, slot) != want:
            raise _Unmodeled(
                "AddressMap flag addressing is not the linear "
                "base + unit*(slot*n + src) family"
            )
    return base, unit


# ---------------------------------------------------------------------------
# concrete checker (shared core: prover + tiered lockstep compiler)
# ---------------------------------------------------------------------------


def _fam_slot_range(f: _EFam) -> Tuple[int, int]:
    dj = (f.m - 1) * f.sstep_j
    dk = (f.epochs - 1) * f.sstep_k
    lo = f.slot0 + min(0, dj) + min(0, dk)
    hi = f.slot0 + max(0, dj) + max(0, dk)
    return lo, hi


def _fam_dst_range(f: _EFam) -> Tuple[int, int, int]:
    """(lo, hi, step) of the destination progression."""
    if f.m == 1 or f.dstep == 0:
        return f.dst0, f.dst0, 0
    last = f.dst0 + (f.m - 1) * f.dstep
    return min(f.dst0, last), max(f.dst0, last), abs(f.dstep)


def _progression_meet(
    lo_a: int, hi_a: int, st_a: int, lo_b: int, hi_b: int, st_b: int
) -> Optional[int]:
    """Smallest common member of two arithmetic progressions, or ``None``.

    Conservative: a gcd-residue test decides intersection; the witness is
    then located by walking the sparser progression (bounded by its count).
    """
    if hi_a < lo_b or hi_b < lo_a:
        return None
    if st_a == 0 and st_b == 0:
        return lo_a if lo_a == lo_b else None
    if st_a == 0:
        hit = lo_b <= lo_a <= hi_b and (lo_a - lo_b) % st_b == 0
        return lo_a if hit else None
    if st_b == 0:
        hit = lo_a <= lo_b <= hi_a and (lo_b - lo_a) % st_a == 0
        return lo_b if hit else None
    if (lo_b - lo_a) % int(np.gcd(st_a, st_b)):
        return None
    # a shared value exists on the infinite lattices; walk A's progression
    # (bounded by st_b steps via CRT) for the first one inside both ranges
    start = max(lo_a, lo_b)
    v = lo_a + -(-(start - lo_a) // st_a) * st_a  # ceil into A's lattice
    while v <= min(hi_a, hi_b):
        if (v - lo_b) % st_b == 0:
            return v
        v += st_a
    return None


def _check_families(
    n: int,
    amap: AddressMap,
    efams: Sequence[_EFam],
    wfams: Sequence[_WFam],
    *,
    include_marks: bool = True,
    region: bool = True,
    capacity: bool = True,
    coverage: bool = True,
    coverage_dsts: Optional[Sequence[int]] = None,
    stop_after: int = 8,
) -> List[LayoutFinding]:
    """Run every layout check over concrete-n affine families.

    Cost is O(sites + members-of-runs) — loop epochs are never expanded.
    This is the single implementation behind both the parametric prover and
    the tiered lockstep compiler's pre-solve gate.
    """
    findings: List[LayoutFinding] = []
    base, unit = _flag_linear(amap, n)
    pbase = amap.partial_base
    fend = amap.flag_region()[1]

    def decode(addr: int) -> Tuple[int, int]:
        idx = (addr - base) // unit
        return int(idx % n), int(idx // n)

    def done() -> bool:
        return len(findings) >= stop_after

    # -- region-level disjointness: flag pool vs partial-tile region
    if region and fend > pbase:
        w, s = decode(pbase + (-(pbase - base) % unit) % unit)
        findings.append(LayoutFinding(
            "layout-overlap", "error",
            f"flag pool overruns the partial-tile region: flag region "
            f"[0x{base:x}, 0x{fend:x}) crosses partial_base 0x{pbase:x} "
            f"by {fend - pbase} bytes; first aliased {_flag_name(w, s)} — "
            f"re-base the map with AddressMap.with_partial_clearance()",
            n_devices=n, slot=s, writers=(w,),
        ))

    # -- slot capacity and destination sanity
    for f in efams:
        if f.raw:
            if base <= f.addr0 < fend:
                w, s = decode(f.addr0)
                findings.append(LayoutFinding(
                    "layout-raw-write", "error",
                    f"raw address emission at {f.site} on rank {f.writer} "
                    f"targets 0x{f.addr0:x} inside the flag pool "
                    f"({_flag_name(w, s)})",
                    n_devices=n, slot=s, writers=(f.writer,), dst=f.dst0,
                ))
            continue
        dlo, dhi, _ = _fam_dst_range(f)
        if dlo < 0 or dhi >= n:
            findings.append(LayoutFinding(
                "layout-bad-dst", "error",
                f"emission {f.site} on rank {f.writer} targets device "
                f"{dlo if dlo < 0 else dhi} outside [0, {n})",
                n_devices=n, writers=(f.writer,),
            ))
            continue
        if not capacity:
            continue
        slo, shi = _fam_slot_range(f)
        if slo < 0 or shi >= amap.flag_slots:
            findings.append(LayoutFinding(
                "layout-capacity", "error",
                f"emission {f.site} on rank {f.writer} uses flag slot "
                f"{slo if slo < 0 else shi} outside the map's capacity "
                f"(flag_slots={amap.flag_slots}); writes would land past "
                f"the reserved flag region",
                n_devices=n, slot=(slo if slo < 0 else shi),
                writers=(f.writer,),
            ))
    if done():
        return findings

    # -- data-marker windows: wend[d] = pbase + 64 * total marker writes
    marks = np.zeros(n, np.int64)
    flag_fams = [f for f in efams if not f.raw]
    for f in efams:
        dlo, dhi, _ = _fam_dst_range(f)
        if f.dw == 0 or dlo < 0 or dhi >= n:
            continue
        if f.dstep == 0:
            marks[f.dst0] += f.m * f.epochs * f.dw
        else:
            marks[f.dst0 + f.dstep * np.arange(f.m)] += f.epochs * f.dw
    wend = pbase + 64 * marks

    if include_marks and marks.any():
        for f in flag_fams:
            dlo, dhi, _ = _fam_dst_range(f)
            if dlo < 0 or dhi >= n:
                continue
            j = np.arange(f.m)
            dvec = f.dst0 + f.dstep * j
            slot_j = f.slot0 + f.sstep_j * j
            dk = (f.epochs - 1) * f.sstep_k
            lo = base + unit * ((slot_j + min(0, dk)) * n + f.writer)
            hi = base + unit * ((slot_j + max(0, dk)) * n + f.writer)
            st = unit * n * abs(f.sstep_k) if f.epochs > 1 else 0
            s = max(st, 1)
            first = lo + ((pbase - lo + s - 1) // s) * s
            first = np.maximum(first, lo)
            bad = (first <= hi) & (first < wend[dvec])
            if bad.any():
                jb = int(np.argmax(bad))
                d = int(dvec[jb])
                w, sl = decode(int(first[jb]))
                findings.append(LayoutFinding(
                    "marker-alias", "error",
                    f"data-marker writes on rank {d} reach "
                    f"{_flag_name(w, sl)}: the flag pool overruns the "
                    f"partial-tile region at this shape",
                    n_devices=n, slot=sl, writers=(w,), dst=d,
                ))
                if done():
                    return findings

    # -- unique writer per flag value epoch (per-writer local: flag_addr is
    #    injective over slot*n + src, so cross-writer collisions can't exist)
    by_writer: Dict[int, List[_EFam]] = {}
    for f in flag_fams:
        dlo, dhi, _ = _fam_dst_range(f)
        if dlo < 0 or dhi >= n:
            continue
        by_writer.setdefault(f.writer, []).append(f)
        # within one site: loop epochs rewriting the same slot, or
        # duplicated members
        rewrite = f.epochs > 1 and f.sstep_k == 0
        dup = f.m > 1 and f.dstep == 0 and f.sstep_j == 0
        if rewrite or dup:
            findings.append(LayoutFinding(
                "flag-reuse", "error",
                f"flag slot reuse: rank {f.dst0} receives "
                f"{_flag_name(f.writer, f.slot0)} from more than one "
                f"emission instance ({f.site} re-emits it "
                + (f"across {f.epochs} loop iterations"
                   if rewrite else f"for {f.m} run members") + ")",
                n_devices=n, slot=f.slot0, writers=(f.writer, f.writer),
                dst=f.dst0,
            ))
            if done():
                return findings
    for w, fams in by_writer.items():
        for i in range(len(fams)):
            for jx in range(i + 1, len(fams)):
                a, b = fams[i], fams[jx]
                da = _fam_dst_range(a)
                db = _fam_dst_range(b)
                d_hit = _progression_meet(*da, *db)
                if d_hit is None:
                    continue
                sa_lo, sa_hi = _fam_slot_range(a)
                sb_lo, sb_hi = _fam_slot_range(b)
                ga = int(np.gcd(
                    abs(a.sstep_j) if a.m > 1 else 0,
                    abs(a.sstep_k) if a.epochs > 1 else 0,
                ))
                gb = int(np.gcd(
                    abs(b.sstep_j) if b.m > 1 else 0,
                    abs(b.sstep_k) if b.epochs > 1 else 0,
                ))
                s_hit = _progression_meet(
                    sa_lo, sa_hi, ga, sb_lo, sb_hi, gb
                )
                if s_hit is None:
                    continue
                findings.append(LayoutFinding(
                    "flag-reuse", "error",
                    f"flag slot reuse: rank {d_hit} receives "
                    f"{_flag_name(w, s_hit)} from more than one emission "
                    f"instance ({a.site} and {b.site})",
                    n_devices=n, slot=s_hit, writers=(w, w), dst=d_hit,
                ))
                if done():
                    return findings

    # -- wait coverage: every awaited flag has an emitting instance
    if coverage and wfams:
        dscope = (
            sorted(set(coverage_dsts))
            if coverage_dsts is not None else range(n)
        )
        want = {int(d) for d in dscope}
        by_dst: Dict[int, List[Tuple[int, int, int]]] = {d: [] for d in want}
        for f in flag_fams:
            dlo, dhi, _ = _fam_dst_range(f)
            if dlo < 0 or dhi >= n:
                continue
            dk = (f.epochs - 1) * f.sstep_k
            st = unit * n * abs(f.sstep_k) if f.epochs > 1 else 0
            for d in want:
                t = d - f.dst0
                if f.dstep == 0:
                    js = range(f.m) if t == 0 else ()
                elif t % f.dstep == 0 and 0 <= t // f.dstep < f.m:
                    js = (t // f.dstep,)
                else:
                    js = ()
                for jm in js:
                    sl = f.slot0 + jm * f.sstep_j
                    lo = base + unit * ((sl + min(0, dk)) * n + f.writer)
                    hi = base + unit * ((sl + max(0, dk)) * n + f.writer)
                    by_dst[d].append((lo, hi, st))
        for wf in wfams:
            if wf.rank not in want:
                continue
            mem = (
                wf.addr0
                + wf.astep_j * np.arange(wf.m)[:, None]
                + wf.astep_k * np.arange(wf.epochs)[None, :]
            ).ravel()
            covered = np.zeros(mem.shape, bool)
            for lo, hi, st in by_dst[wf.rank]:
                if st == 0:
                    covered |= mem == lo
                else:
                    covered |= (
                        (mem >= lo) & (mem <= hi) & ((mem - lo) % st == 0)
                    )
            if not covered.all():
                a = int(mem[int(np.argmin(covered))])
                wtag = (
                    f"{_flag_name(*decode(a))}"
                    if base <= a < max(fend, a + 1) and (a - base) % unit == 0
                    and (a - base) // unit < n * max(amap.flag_slots, 1)
                    else f"address 0x{a:x}"
                )
                findings.append(LayoutFinding(
                    "unmatched-wait-family", "error",
                    f"wait at {wf.site} on rank {wf.rank} polls {wtag} "
                    f"that no emission instance ever writes",
                    n_devices=n, dst=wf.rank,
                ))
                if done():
                    return findings
    return findings


def _extract_all(
    progs: Sequence, n: int
) -> Tuple[List[_EFam], List[_WFam]]:
    efams: List[_EFam] = []
    wfams: List[_WFam] = []
    for rank in range(n):
        e, w = _extract_program(progs[rank], rank)
        efams.extend(e)
        wfams.extend(w)
    return efams, wfams


def check_programs(
    progs: Sequence,
    amap: AddressMap,
    cfg: SimConfig,
    *,
    coverage: bool = False,
    coverage_dsts: Optional[Sequence[int]] = None,
) -> List[LayoutFinding]:
    """Concrete layout check over per-rank programs (symbolic or flat).

    The tiered lockstep compiler's entry point: it passes the same
    ``SymbolicProgram`` list it schedules, and declines the shape when any
    error finding comes back (citing the finding verbatim).  Marker checks
    follow ``cfg.include_data_writes`` — with markers disabled no data write
    ever lands in the partial region, so no alias is reachable.
    """
    n = cfg.n_devices
    try:
        efams, wfams = _extract_all(progs, n)
    except _Unmodeled as e:
        return [LayoutFinding("layout-unmodeled", "error", str(e),
                              n_devices=n)]
    try:
        return _check_families(
            n, amap, efams, wfams,
            include_marks=cfg.include_data_writes,
            region=False,
            coverage=coverage, coverage_dsts=coverage_dsts,
        )
    except _Unmodeled as e:
        return [LayoutFinding("layout-unmodeled", "error", str(e),
                              n_devices=n)]


def check_layout(sc: Scenario) -> List[LayoutFinding]:
    """Full concrete layout check of one scenario instance (all ranks, all
    checks).  Open-loop scenarios have no per-rank programs and return
    no findings."""
    if not sc.closed_loop:
        return []
    n = sc.cfg.n_devices
    progs = []
    for d in range(n):
        programs = sc.programs_for(d)
        if not programs:
            return [LayoutFinding(
                "layout-unmodeled", "warning",
                f"rank {d} has no workgroup programs", n_devices=n,
            )]
        sp = as_symbolic(programs[0].phases)
        progs.append(sp if sp is not None else programs[0].phases)
    try:
        efams, wfams = _extract_all(progs, n)
        return _check_families(
            n, sc.amap, efams, wfams,
            include_marks=sc.cfg.include_data_writes,
        )
    except _Unmodeled as e:
        return [LayoutFinding("layout-unmodeled", "warning", str(e),
                              n_devices=n)]


# ---------------------------------------------------------------------------
# exact polynomial models over n (probe-fitted, holdout-verified)
# ---------------------------------------------------------------------------


def _fit_poly(
    xs: Sequence[int], ys: Sequence[int], max_deg: int = 3
) -> Optional[Tuple[Fraction, ...]]:
    """Exact rational polynomial through the probe points, or ``None``.

    Fits degree d on the first d+1 points and verifies on *all* remaining
    probes — at least two held-out points at the highest degree — so an
    accepted model interpolates every probe exactly."""
    deg_cap = min(max_deg, len(xs) - 2)
    for deg in range(deg_cap + 1):
        pts = deg + 1
        mat = [
            [Fraction(x) ** p for p in range(pts)] + [Fraction(y)]
            for x, y in zip(xs[:pts], ys[:pts])
        ]
        ok = True
        for col in range(pts):
            piv = next(
                (r for r in range(col, pts) if mat[r][col] != 0), None
            )
            if piv is None:
                ok = False
                break
            mat[col], mat[piv] = mat[piv], mat[col]
            inv = 1 / mat[col][col]
            mat[col] = [v * inv for v in mat[col]]
            for r in range(pts):
                if r != col and mat[r][col] != 0:
                    fac = mat[r][col]
                    mat[r] = [
                        v - fac * u for v, u in zip(mat[r], mat[col])
                    ]
        if not ok:
            continue
        coeffs = tuple(mat[r][pts] for r in range(pts))
        if all(
            sum(c * x ** p for p, c in enumerate(coeffs)) == y
            for x, y in zip(xs, ys)
        ):
            return coeffs
    return None


def _eval_poly_vec(
    coeffs: Tuple[Fraction, ...], nvec: np.ndarray
) -> Optional[np.ndarray]:
    """Exact int64 evaluation of a rational polynomial over a vector of
    device counts; ``None`` if any value is non-integral."""
    den = 1
    for c in coeffs:
        den = den * c.denominator // int(np.gcd(den, c.denominator))
    acc = np.zeros(nvec.shape, np.int64)
    for c in reversed(coeffs):
        acc = acc * nvec + int(c * den)
    if den != 1 and (acc % den).any():
        return None
    return acc // den if den != 1 else acc


# ---------------------------------------------------------------------------
# representative rank classes (affine in n; fixed offsets from 0 and n)
# ---------------------------------------------------------------------------


def _rep_rules(step: int) -> List[Tuple[int, int]]:
    """Rank rules ``r = a + b*n`` covering group-class boundaries: the low
    ranks, node boundaries (one and two nodes in), and their mirrors at the
    top.  Distinct and in-range whenever n exceeds the small-regime
    cutoff."""
    s = max(step, 1)
    rules = [
        (0, 0), (1, 0), (2, 0), (3, 0),
        (s - 1, 0), (s, 0), (s + 1, 0),
        (2 * s - 1, 0), (2 * s, 0), (2 * s + 1, 0),
        (-2 * s, 1), (-s - 1, 1), (-s, 1), (-s + 1, 1),
        (-2, 1), (-1, 1),
    ]
    seen = set()
    out = []
    for r in rules:
        # a + 1*n >= n for a >= 0: never a valid rank (hit when step == 1
        # collapses the mirror rules onto the top boundary)
        if r[1] == 1 and r[0] >= 0:
            continue
        if r not in seen:
            seen.add(r)
            out.append(r)
    return out


_EFIELDS = ("m", "dst0", "dstep", "slot0", "sstep_j", "sstep_k", "epochs",
            "dw", "addr0")
_WFIELDS = ("m", "addr0", "astep_j", "astep_k", "epochs")


def _snapshot(
    sc: Scenario, rules: Sequence[Tuple[int, int]]
) -> Tuple[Dict[tuple, int], str, List[_EFam], List[_WFam]]:
    """Full-rank extraction + model snapshot at one concrete device count.

    Returns (field values keyed by (rule, kind, site-index, field), a
    structural signature that must match across probes, and the full-rank
    family lists for the concrete probe check)."""
    n = sc.cfg.n_devices
    progs = []
    for d in range(n):
        programs = sc.programs_for(d)
        sp = as_symbolic(programs[0].phases) if programs else None
        progs.append(
            sp if sp is not None else (programs[0].phases if programs else ())
        )
    efams, wfams = _extract_all(progs, n)
    marks = np.zeros(n, np.int64)
    for f in efams:
        dlo, dhi, _ = _fam_dst_range(f)
        if f.dw == 0 or f.raw or dlo < 0 or dhi >= n:
            continue
        if f.dstep == 0:
            marks[f.dst0] += f.m * f.epochs * f.dw
        else:
            marks[f.dst0 + f.dstep * np.arange(f.m)] += f.epochs * f.dw
    vals: Dict[tuple, int] = {}
    amap = sc.amap
    base, unit = _flag_linear(amap, n)
    vals[("amap", "base")] = base
    vals[("amap", "unit")] = unit
    vals[("amap", "flag_slots")] = amap.flag_slots
    vals[("amap", "partial_base")] = amap.partial_base
    vals[("amap", "flag_end")] = amap.flag_region()[1]
    sig_parts = [f"u{unit}"]
    by_rank_e: Dict[int, List[_EFam]] = {}
    by_rank_w: Dict[int, List[_WFam]] = {}
    for f in efams:
        by_rank_e.setdefault(f.writer, []).append(f)
    for f in wfams:
        by_rank_w.setdefault(f.rank, []).append(f)
    for rule in rules:
        r = rule[0] + rule[1] * n
        if not 0 <= r < n:
            raise _Unmodeled(f"rep rank rule {rule} out of range at n={n}")
        re_ = by_rank_e.get(r, [])
        rw = by_rank_w.get(r, [])
        sig_parts.append(
            f"{rule}:"
            + ",".join(f"{f.site}{'R' if f.raw else ''}" for f in re_)
            + "|" + ",".join(f.site for f in rw)
        )
        vals[(rule, "marks")] = int(marks[r])
        for i, f in enumerate(re_):
            for fld in _EFIELDS:
                vals[(rule, "e", i, fld)] = int(getattr(f, fld))
        for i, f in enumerate(rw):
            for fld in _WFIELDS:
                vals[(rule, "w", i, fld)] = int(getattr(f, fld))
    return vals, ";".join(sig_parts), efams, wfams


# ---------------------------------------------------------------------------
# vectorized parametric scan over all candidate device counts
# ---------------------------------------------------------------------------


def _parametric_scan(
    models: Dict[tuple, np.ndarray],
    shapes: Dict[tuple, dict],
    rules: Sequence[Tuple[int, int]],
    nvec: np.ndarray,
    include_marks: bool,
) -> Optional[Tuple[int, str]]:
    """Evaluate every layout check over the whole candidate range at once.

    ``models`` maps snapshot keys to int64 vectors (one entry per candidate
    n); ``shapes[(rule, kind)]`` records how many sites each rep rank
    carries.  Returns ``(smallest suspect n, hint)`` or ``None`` when every
    check holds everywhere."""
    base = models[("amap", "base")]
    unit = models[("amap", "unit")]
    slots_cap = models[("amap", "flag_slots")]
    pbase = models[("amap", "partial_base")]
    fend = models[("amap", "flag_end")]
    suspect = np.zeros(nvec.shape, bool)
    hints: List[Tuple[int, str]] = []

    def flag(mask: np.ndarray, hint: str) -> None:
        if mask.any():
            hints.append((int(nvec[int(np.argmax(mask))]), hint))
            np.logical_or(suspect, mask, out=suspect)

    flag(fend > pbase, "flag region crosses partial_base")

    def efam_vecs(rule, i):
        return {
            fld: models[(rule, "e", i, fld)] for fld in _EFIELDS
        }

    for rule in rules:
        rank = rule[0] + rule[1] * nvec
        n_e = shapes[(rule, "e")]
        fams = [efam_vecs(rule, i) for i in range(n_e)]
        raws = shapes[(rule, "eraw")]
        for i, f in enumerate(fams):
            if raws[i]:
                flag(
                    (f["addr0"] >= base) & (f["addr0"] < fend),
                    "raw emission inside flag pool",
                )
                continue
            dj = (f["m"] - 1) * f["sstep_j"]
            dk = (f["epochs"] - 1) * f["sstep_k"]
            slo = f["slot0"] + np.minimum(0, dj) + np.minimum(0, dk)
            shi = f["slot0"] + np.maximum(0, dj) + np.maximum(0, dk)
            dlast = f["dst0"] + (f["m"] - 1) * f["dstep"]
            dlo = np.minimum(f["dst0"], dlast)
            dhi = np.maximum(f["dst0"], dlast)
            flag((dlo < 0) | (dhi >= nvec), "emission dst out of range")
            flag((slo < 0) | (shi >= slots_cap), "flag slot capacity")
            flag(
                (f["epochs"] > 1) & (f["sstep_k"] == 0),
                "same flag rewritten across loop epochs",
            )
            flag(
                (f["m"] > 1) & (f["dstep"] == 0) & (f["sstep_j"] == 0),
                "duplicated emission members",
            )
            # marker alias against every representative destination class
            if include_marks:
                for drule in rules:
                    d = drule[0] + drule[1] * nvec
                    t = d - f["dst0"]
                    dstep = f["dstep"]
                    jm = np.where(
                        dstep != 0, t // np.where(dstep == 0, 1, dstep), 0
                    )
                    member = np.where(
                        dstep == 0,
                        t == 0,
                        (t % np.where(dstep == 0, 1, dstep) == 0)
                        & (jm >= 0) & (jm < f["m"]),
                    )
                    if not member.any():
                        continue
                    sl = f["slot0"] + jm * f["sstep_j"]
                    lo = base + unit * ((sl + np.minimum(0, dk)) * nvec
                                        + rank)
                    hi = base + unit * ((sl + np.maximum(0, dk)) * nvec
                                        + rank)
                    st = np.where(
                        f["epochs"] > 1,
                        unit * nvec * np.abs(f["sstep_k"]), 0,
                    )
                    s = np.maximum(st, 1)
                    first = lo + ((pbase - lo + s - 1) // s) * s
                    first = np.maximum(first, lo)
                    wend_d = pbase + 64 * models[(drule, "marks")]
                    flag(
                        member & (first <= hi) & (first < wend_d),
                        "data-marker writes reach the flag pool",
                    )
        # same-writer pairwise slot reuse (representative writer classes)
        for i in range(n_e):
            if raws[i]:
                continue
            for jx in range(i + 1, n_e):
                if raws[jx]:
                    continue
                a, b = fams[i], fams[jx]

                def rng(f):
                    dj = (f["m"] - 1) * f["sstep_j"]
                    dk = (f["epochs"] - 1) * f["sstep_k"]
                    slo = f["slot0"] + np.minimum(0, dj) + np.minimum(0, dk)
                    shi = f["slot0"] + np.maximum(0, dj) + np.maximum(0, dk)
                    g = np.gcd(
                        np.where(f["m"] > 1, np.abs(f["sstep_j"]), 0),
                        np.where(f["epochs"] > 1, np.abs(f["sstep_k"]), 0),
                    )
                    dlast = f["dst0"] + (f["m"] - 1) * f["dstep"]
                    return (
                        slo, shi, g,
                        np.minimum(f["dst0"], dlast),
                        np.maximum(f["dst0"], dlast),
                        np.where(f["m"] > 1, np.abs(f["dstep"]), 0),
                    )

                sa_lo, sa_hi, ga, da_lo, da_hi, gda = rng(a)
                sb_lo, sb_hi, gb, db_lo, db_hi, gdb = rng(b)
                d_int = (da_hi >= db_lo) & (db_hi >= da_lo)
                gd = np.gcd(gda, gdb)
                d_hit = d_int & np.where(
                    gd == 0, da_lo == db_lo,
                    (db_lo - da_lo) % np.maximum(gd, 1) == 0,
                )
                s_int = (sa_hi >= sb_lo) & (sb_hi >= sa_lo)
                gs = np.gcd(ga, gb)
                s_hit = s_int & np.where(
                    gs == 0, sa_lo == sb_lo,
                    (sb_lo - sa_lo) % np.maximum(gs, 1) == 0,
                )
                flag(d_hit & s_hit, "two emission instances share a slot")
    if not suspect.any():
        return None
    n_hat = int(nvec[int(np.argmax(suspect))])
    hint = min(hints, key=lambda h: h[0])[1]
    return n_hat, hint


# ---------------------------------------------------------------------------
# the prover
# ---------------------------------------------------------------------------


def _resolve_class(scenario: ScenarioRef) -> type:
    if isinstance(scenario, str):
        return get_scenario(scenario)
    if isinstance(scenario, type) and issubclass(scenario, Scenario):
        return scenario
    raise TypeError(
        "prove_layout needs a registered scenario name or Scenario subclass"
    )


def _construct(cls: type, n: int, params: dict) -> Scenario:
    cfg = SimConfig().with_devices(n)
    return cls(cfg, **params)


def _probe_counts(cands: List[int], cutoff: int) -> List[int]:
    """Geometric ladder of probe counts through the large regime, densified
    to at least six points so cubic models keep two held-out probes."""
    large = [c for c in cands if c > cutoff]
    if not large:
        return []
    probes = []
    target = large[0]
    while target <= large[-1]:
        idx = min(
            range(len(large)), key=lambda i: abs(large[i] - target)
        )
        probes.append(large[idx])
        target *= 2
    probes.append(large[-1])
    probes = sorted(set(probes))
    while len(probes) < min(6, len(large)):
        gaps = [
            (large.index(b) - large.index(a), a, b)
            for a, b in zip(probes, probes[1:])
        ]
        width, a, b = max(gaps)
        if width < 2:
            extra = [c for c in large if c not in probes]
            if not extra:
                break
            probes.append(extra[0])
        else:
            probes.append(large[(large.index(a) + large.index(b)) // 2])
        probes = sorted(set(probes))
    return probes


def prove_layout(
    scenario: ScenarioRef,
    *,
    devices_per_node: Optional[int] = None,
    fabric: Optional[str] = None,
    max_devices: Optional[int] = None,
    ordering: bool = True,
    **params,
) -> LayoutProof:
    """Prove one scenario's layout for every constructible device count.

    Sweeps n over multiples of ``devices_per_node`` (all counts when no node
    shape is given) up to ``max_devices`` (default: the scenario class's
    declared bound).  Small counts are checked exhaustively; the large
    regime goes through representative-rank polynomial models evaluated
    vectorized over every candidate, with full-rank concrete checks at the
    probe counts the models are fitted from.  Any parametric suspicion is
    re-confirmed concretely so findings carry exact blame and the smallest
    failing n.  Ordering (obligation (c)) is discharged statically for
    existence and via the loop-space planner at probe counts.
    """
    cls = _resolve_class(scenario)
    name = getattr(cls, "name", "") or cls.__name__
    bound = int(max_devices or getattr(cls, "max_devices", 4096))
    step = int(devices_per_node) if devices_per_node else 1
    kw = dict(params)
    kw.setdefault("closed_loop", True)
    if devices_per_node is not None:
        kw.setdefault("devices_per_node", devices_per_node)
    if fabric is not None:
        kw.setdefault("fabric", fabric)
    proof = LayoutProof(
        scenario=name, devices_per_node=devices_per_node, fabric=fabric,
        max_devices=bound,
    )
    notes: List[str] = []

    def build(n: int) -> Optional[Scenario]:
        try:
            return _construct(cls, n, kw)
        except TypeError as e:
            raise ValueError(
                f"{name} does not accept the closed-loop parameters the "
                f"layout prover sweeps ({e})"
            ) from e
        except (ValueError, NotImplementedError):
            return None

    cands = [n for n in range(max(step, 2), bound + 1, step)]
    if step == 1 and cands and cands[0] < 2:
        cands = [n for n in cands if n >= 2]
    built = []
    for n in cands[:64]:
        sc = build(n)
        if sc is not None:
            built.append((n, sc))
            break
    if not built:
        proof.findings.append(LayoutFinding(
            "layout-shape", "warning",
            f"no constructible device count in the first 64 candidates "
            f"(step {step}); nothing to prove",
        ))
        proof.notes = tuple(notes)
        return proof

    cutoff = min(bound, max(48, 6 * step))
    checked: List[int] = []
    ordered: List[int] = []
    seen_warn: set = set()

    def fold(fs: List[LayoutFinding]) -> bool:
        """Collect findings (warnings deduped across counts); True on
        error."""
        err = False
        for f in fs:
            if f.severity == "error":
                proof.findings.append(f)
                err = True
            elif (f.kind, f.message) not in seen_warn:
                seen_warn.add((f.kind, f.message))
                proof.findings.append(f)
        return err

    def concrete(n: int, sc: Optional[Scenario] = None) -> bool:
        """Full exhaustive check at one count; True when errors found."""
        sc = sc or build(n)
        if sc is None:
            return False
        checked.append(n)
        return fold(check_layout(sc))

    first_n, first_sc = built[0]
    for n in cands:
        if n > cutoff:
            break
        sc = first_sc if n == first_n else None
        if concrete(n, sc):
            proof.checked_counts = tuple(checked)
            proof.notes = tuple(notes)
            return proof

    large = [c for c in cands if c > cutoff]
    if large:
        rules = _rep_rules(step)
        probes = _probe_counts(cands, cutoff)
        snaps: List[Tuple[int, Dict[tuple, int]]] = []
        sig0: Optional[str] = None
        modeled = True
        last_clean = max((c for c in cands if c <= cutoff), default=None)

        def first_failure(lo_n: Optional[int], hi_n: int) -> None:
            """Bisect (lo_n, hi_n] for the smallest failing count (layout
            violations grow monotonically with the flag pool) and fold its
            findings, so blame always carries the first aliasing n."""
            span = [
                c for c in cands
                if (lo_n is None or c > lo_n) and c <= hi_n
            ]
            lo, hi = 0, len(span) - 1  # span[hi] is known-failing
            while lo < hi:
                mid = (lo + hi) // 2
                sc_m = build(span[mid])
                fs_m = check_layout(sc_m) if sc_m is not None else []
                checked.append(span[mid])
                if any(f.severity == "error" for f in fs_m):
                    hi = mid
                else:
                    lo = mid + 1
            sc_b = build(span[hi])
            fold(check_layout(sc_b) if sc_b is not None else [])

        for pn in probes:
            sc = build(pn)
            if sc is None:
                notes.append(f"probe n={pn}: shape not constructible")
                continue
            try:
                vals, sig, efams, wfams = _snapshot(sc, rules)
            except _Unmodeled as e:
                proof.findings.append(LayoutFinding(
                    "layout-unmodeled", "warning", str(e), n_devices=pn,
                ))
                modeled = False
                break
            reps = sorted({
                r[0] + r[1] * pn for r in rules if 0 <= r[0] + r[1] * pn < pn
            })
            fs = _check_families(
                pn, sc.amap, efams, wfams,
                include_marks=sc.cfg.include_data_writes,
                coverage_dsts=reps,
            )
            checked.append(pn)
            if any(f.severity == "error" for f in fs):
                first_failure(last_clean, pn)
                proof.checked_counts = tuple(sorted(set(checked)))
                proof.probe_counts = tuple(p for p, _ in snaps)
                proof.notes = tuple(notes)
                return proof
            fold(fs)
            last_clean = pn
            if sig0 is None:
                sig0 = sig
            elif sig != sig0:
                notes.append(
                    f"program structure changes shape at n={pn}; "
                    "falling back to dense concrete checks"
                )
                modeled = False
                break
            snaps.append((pn, vals))
        include_marks = first_sc.cfg.include_data_writes
        if modeled and len(snaps) >= 4:
            xs = [p for p, _ in snaps]
            keys = set(snaps[0][1])
            if any(set(v) != keys for _, v in snaps):
                modeled = False
            if modeled:
                nvec = np.array(large, np.int64)
                models: Dict[tuple, np.ndarray] = {}
                pb_key = ("amap", "partial_base")
                for key in keys:
                    if key == pb_key:
                        continue
                    ys = [v[key] for _, v in snaps]
                    coeffs = _fit_poly(xs, ys)
                    vec = (
                        _eval_poly_vec(coeffs, nvec)
                        if coeffs is not None else None
                    )
                    if vec is None:
                        notes.append(
                            f"descriptor {key} does not interpolate as a "
                            "polynomial in n; falling back to dense checks"
                        )
                        modeled = False
                        break
                    models[key] = vec
            if modeled:
                # partial_base is piecewise, not polynomial, on cleared
                # maps: max(default base, flag region end rounded up to a
                # page) — verify that clearance form at every probe, and
                # fall back to a plain polynomial (legacy constant maps)
                pb_ys = [v[pb_key] for _, v in snaps]
                fend_ys = [v[("amap", "flag_end")] for _, v in snaps]
                page = 0x1000
                floor_pb = min(pb_ys)

                def pageup(x):
                    return (x + page - 1) // page * page

                if all(
                    pb == max(floor_pb, pageup(fe))
                    for pb, fe in zip(pb_ys, fend_ys)
                ):
                    models[pb_key] = np.maximum(
                        floor_pb,
                        (models[("amap", "flag_end")] + page - 1)
                        // page * page,
                    )
                else:
                    coeffs = _fit_poly(xs, pb_ys)
                    vec = (
                        _eval_poly_vec(coeffs, nvec)
                        if coeffs is not None else None
                    )
                    if vec is None:
                        notes.append(
                            "partial_base follows neither the clearance "
                            "form nor a polynomial; falling back to dense "
                            "checks"
                        )
                        modeled = False
                    else:
                        models[pb_key] = vec
            if modeled:
                # clearance-form sanity: a with_partial_clearance() map must
                # keep partial_base at/above the flag region end everywhere
                shapes: Dict[tuple, object] = {}
                for rule in rules:
                    sites = [
                        k for k in keys
                        if k[0] == rule and len(k) == 4 and k[1] == "e"
                        and k[3] == "m"
                    ]
                    n_e = len(sites)
                    shapes[(rule, "e")] = n_e
                    shapes[(rule, "eraw")] = [
                        bool(models[(rule, "e", i, "addr0")].any())
                        for i in range(n_e)
                    ]
                hit = _parametric_scan(
                    models, shapes, rules, nvec, include_marks
                )
                proof.parametric = True
                proof.probe_counts = tuple(xs)
                if hit is not None:
                    n_hat, hint = hit
                    confirm = [c for c in large if c >= n_hat][:16]
                    for cn in confirm:
                        sc = build(cn)
                        if sc is not None and concrete(cn, sc):
                            break
                    else:
                        proof.findings.append(LayoutFinding(
                            "layout-overlap", "error",
                            f"parametric models flag a layout violation "
                            f"({hint}) starting at n={n_hat}, but the "
                            f"concrete checker could not localize it — "
                            f"treat the layout as unproven at pod scale",
                            n_devices=n_hat,
                        ))
        if not modeled:
            proof.parametric = False
            dense = [
                large[min(len(large) - 1, round(i * (len(large) - 1) / 11))]
                for i in range(12)
            ]
            prev = last_clean
            for dn in sorted(set(dense)):
                sc = build(dn)
                if sc is None:
                    continue
                fs = check_layout(sc)
                checked.append(dn)
                if any(f.severity == "error" for f in fs):
                    first_failure(prev, dn)
                    break
                fold(fs)
                prev = dn
            notes.append(
                "large regime covered by dense concrete checks only "
                f"(at {sorted(set(dense))}); no parametric certificate"
            )

    # happens-before: the loop-space planner proves every wait family is
    # consumed by a strictly-earlier emission family (total order)
    if ordering and not any(f.severity == "error" for f in proof.findings):
        from .verify import verify_symbolic

        order_ns = [first_n]
        mid = [c for c in cands if c >= min(cutoff, bound)]
        if mid and mid[0] != first_n:
            order_ns.append(mid[0])
        for on in order_ns:
            sc = build(on)
            if sc is None:
                continue
            v = verify_symbolic(sc)
            ordered.append(on)
            for f in v.findings:
                if f.severity == "error":
                    proof.findings.append(LayoutFinding(
                        "unmatched-wait-family", "error", f.message,
                        n_devices=on,
                    ))

    proof.checked_counts = tuple(sorted(set(checked)))
    proof.ordering_counts = tuple(ordered)
    proof.notes = tuple(notes)
    return proof


# ---------------------------------------------------------------------------
# the registry's proofs (the registration-time obligation's discharge point)
# ---------------------------------------------------------------------------


def prove_registry(
    *,
    max_devices: int = 4096,
    devices_per_node: int = 4,
    fabrics: Optional[Sequence[Optional[str]]] = None,
    quiet: bool = True,
) -> List[LayoutProof]:
    """Discharge every registered closed-loop scenario's layout obligation.

    Runs the full parametric proof once per scenario (layout depends on the
    address map and programs, not the fabric), then re-attests each fabric
    preset cheaply: the family snapshot at one probe count must be identical
    to the fabric-less one, which it records as a note.  A preset that
    cannot construct the probe shape is noted and skipped.
    """
    from repro_torch.core.interconnect import list_fabrics
    from repro_torch.core.scenario import LAYOUT_PROOF_OBLIGATIONS

    list_scenarios()  # load builtins so obligations are recorded
    if fabrics is None:
        fabrics = [None, *list_fabrics()]
    proofs: List[LayoutProof] = []
    step = max(devices_per_node, 1)
    fp_n = min(max_devices, max(64, 8 * step))
    fp_n -= fp_n % step
    rules = _rep_rules(step)
    for name in list(LAYOUT_PROOF_OBLIGATIONS):
        cls = get_scenario(name)
        base_proof = prove_layout(
            name, devices_per_node=devices_per_node,
            max_devices=max_devices,
        )
        proofs.append(base_proof)
        if not quiet:
            print(base_proof.render())
        fp0 = None
        try:
            sc = _construct(cls, fp_n, {
                "closed_loop": True, "devices_per_node": devices_per_node,
            })
            fp0 = _snapshot(sc, rules)[:2]  # numeric fields + structure
        except (ValueError, NotImplementedError, _Unmodeled):
            fp0 = None
        for fab in fabrics:
            if fab is None:
                continue
            try:
                sc = _construct(cls, fp_n, {
                    "closed_loop": True,
                    "devices_per_node": devices_per_node,
                    "fabric": fab,
                })
                fp = _snapshot(sc, rules)[:2]
            except (ValueError, NotImplementedError, _Unmodeled) as e:
                proofs.append(LayoutProof(
                    scenario=name, devices_per_node=devices_per_node,
                    fabric=fab, max_devices=max_devices,
                    notes=(
                        f"fabric {fab}: probe shape n={fp_n} not "
                        f"constructible ({e}); layout is fabric-independent",
                    ),
                ))
                continue
            if fp0 is not None and fp == fp0:
                att = replace_proof_fabric(base_proof, fab, fp_n)
            else:
                att = prove_layout(
                    name, devices_per_node=devices_per_node, fabric=fab,
                    max_devices=max_devices,
                )
            proofs.append(att)
            if not quiet and not att.ok:
                print(att.render())
    return proofs


def replace_proof_fabric(
    base: LayoutProof, fabric: str, probe_n: int
) -> LayoutProof:
    """Re-attest a fabric preset against the fabric-less proof: identical
    family snapshot at the probe count means identical layout everywhere."""
    att = LayoutProof(
        scenario=base.scenario, devices_per_node=base.devices_per_node,
        fabric=fabric, max_devices=base.max_devices,
        findings=list(base.findings),
        checked_counts=base.checked_counts,
        probe_counts=base.probe_counts,
        ordering_counts=base.ordering_counts,
        parametric=base.parametric,
    )
    att.notes = (*base.notes, (
        f"fabric {fabric}: family snapshot at n={probe_n} is identical to "
        "the fabric-less layout; proof re-attested without a second sweep"
    ))
    return att
