"""Bulk lockstep solver: whole-program closed forms over symbolic programs
(port of ``repro/core/lockstep.py``).

The timeline engine (:mod:`repro_torch.core.cohort_timeline`) already collapses each
device's cohorts into one lane, but it still walks *every phase of every lane*
through Python — at 1024 devices a flat ``ring_allreduce`` is ~8M lane-phase
advances plus ~2M heap-ordered emissions, and 4096 devices is 16x that.  This
module removes the last per-step Python loop for the **rank-uniform lockstep**
case: when every rank runs the *same* :class:`~repro_torch.core.scenario.LoopSpec`
structure (only the affine bases — peer ids, flag addresses — differ per
rank), the whole pod advances stage by stage with one numpy expression per
phase over a ``[n_ranks, n_cohorts]`` cursor matrix:

* a timed phase is one matrix add (traffic deltas are rank-uniform scalars);
* an emission stage prices every rank's message in one vectorized pass that
  replicates :class:`~repro_torch.core.topology.FabricModel`'s float arithmetic
  exactly (same IEEE-754 op order per egress port, including
  ``transfer_batch``'s per-port ``cumsum`` chains), then converts
  arrival + enactment latency to flag-set cycles with the WTT's own rounding;
* a wait phase applies the interpreter's unified spin closed form
  (``nticks = max(ceil((V - t)/poll), 0)``) against set cycles gathered from
  the matching earlier emission stage.

Stage-ordered processing is dependency-correct by construction: compilation
symbolically matches every wait to the emission that writes it (affine flag
addresses, permutation or all-peers fan-in), and rejects programs where a wait
precedes its writer.  Per-port FIFO order equals per-rank program order on the
flat ring (ports are ``(src, dir)``-owned), and issue cycles are monotone per
rank, so the sequential per-port pricing the event engine performs in global
heap order factors exactly into independent per-rank chains.

The solver substitutes for the timeline engine *inside* the same
``EngineKind.EVENT`` path (``meta["engine_impl"]`` stays ``"timeline"``;
``meta["program_stats"]["lockstep"]`` records that the bulk solver ran) and is
bit-identical to it — and therefore to the event and cycle engines — on every
counter the repo checks: per-device traffic, ``sim_cycles``,
``kernel_end_cycle``, WTT registered/enacted, fabric message/byte counters,
per-port busy chains and integer port stats.  Documented divergences (the
reference's own), all invisible to the counters a run reports:

* ``DirectoryMemory._mem`` contents and ``TargetDevice.flag_set_cycle`` are
  not populated (O(devices^2) state that no counter reads);
* the float ``queued_ns`` *aggregates* are summed per stage rather than in
  global heap order, so they can differ from the event engine's accumulation
  in the last ulps (per-port queued stats use the same add order as the
  engine and stay bit-exact);
* ``wtt_head_polls`` is 0 (the solver never polls a table head).

Eligibility (:func:`lockstep_support` + a successful compile) requires the
timeline invariant plus: flat single-tier ring fabric, no segment collection,
no sanitizer, no seed writes, and rank-uniform symbolic programs whose waits/emits fit the
affine single-peer or all-peers patterns.  Anything else falls back to the
generic timeline engine; ``Cluster(lockstep=True)`` turns the fallback into a
hard error naming the reason.  The other presets (``two_tier``,
``fat_tree``, ``rail_optimized``) compile through the tiered group-uniform
solver (:mod:`repro_torch.core.lockstep_tiered`).

Compilation stays on the host.  :meth:`LockstepEngine.run` works on torch
tensors on the cluster's device (``Cluster.device``): the cursor matrix, the
flag-read and byte counters, the per-port busy chains and stats and the
set-cycle maps.  It reads the fabric's busy state in once and writes the
fabric's state and stats back once at the end.  The solver is bit-identical
to the reference's because it keeps numpy's floating-point operations in
their order: each operation is its own tensor op (no fused multiply-add, no
reassociation); a division by the clock divides by a float64 tensor on the
device (PyTorch multiplies by the reciprocal when the divisor is a host
scalar on the card); ``torch.round`` is ``np.rint`` (half to even); and every
sum numpy adds left to right (a port's busy chain, a stage's queued time)
goes through :func:`repro_torch.kernels.ordered_scan.ordered_scan` (or
``ordered_total`` where only the sum is kept), whose kernel adds each column
in order on the card.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..kernels.ordered_scan import ordered_scan, ordered_total
from .engine import EngineResult
from .scenario import (
    Affine,
    AffineRun,
    EmitOp,
    EmitRun,
    LoopEmit,
    LoopSpec,
    as_symbolic,
)

__all__ = [
    "LockstepEngine",
    "UnsupportedProgram",
    "lockstep_support",
    "plan_stages",
]

class UnsupportedProgram(Exception):
    """Raised during compilation when the program shape doesn't fit."""


def lockstep_support(cluster) -> Optional[str]:
    """Why this cluster cannot use the bulk lockstep solver, or None.

    Callers check :func:`~repro_torch.core.cohort_timeline.timeline_support` first
    (SPIN, no perturbation, one shared program per device); this adds the
    solver's own structural requirements.  A ``None`` here still requires a
    successful :meth:`LockstepEngine.compile` — the compile step verifies the
    affine wait/emit patterns rank by rank and returns its own reason when
    they don't fit.
    """
    cfg = cluster.cfg
    n = cfg.n_devices
    if n < 2:
        return "bulk solver needs at least 2 devices"
    if cluster.collect_segments:
        return (
            "segment collection needs per-phase spans "
            "(handled by the generic timeline engine)"
        )
    if cluster._san is not None:
        return "traffic sanitization observes individual write enactments"
    fab = cluster.fabric
    rcls = type(fab.spec.routing).__name__
    supported = {
        "ring": "_RingRouting",
        "two_tier": "_TwoTierRouting",
        "fat_tree": "_FatTreeRouting",
        "rail_optimized": "_RailRouting",
    }
    if supported.get(fab.spec.name) != rcls:
        return (
            f"fabric {fab.spec.name!r} (routing {rcls}) is outside the "
            "lockstep presets (ring, two_tier, fat_tree, rail_optimized)"
        )
    if "ici" not in fab._cls:
        return f"fabric {fab.spec.name!r} lacks an 'ici' link class"
    for node in cluster.nodes:
        if node.monitor is not None:
            return "monitor-based sync is per-write; lockstep needs SPIN"
        if len(node.wtt):
            return (
                "seed writes pre-registered in a WTT (warm start) need the "
                "event calendar"
            )
        cohorts = node.target.cohorts
        if not cohorts:
            return f"device {node.device_id} has no workgroup cohorts"
        if as_symbolic(cohorts[0].phases) is None:
            return (
                f"device {node.device_id} runs a flat (non-symbolic) phase "
                "program; only SymbolicPrograms compile to loop stages"
            )
    return None


# ---------------------------------------------------------------------------
# compiled plan
# ---------------------------------------------------------------------------


class _SingleEmit:
    """One message per rank per iteration: rank r -> dst(r, k), flag address
    addr(r, k), both affine in the loop index ``k``."""

    __slots__ = (
        "dst_base", "dst_step", "addr_base", "addr_step",
        "payload", "size", "dw",
    )

    def __init__(self, dst_base, dst_step, addr_base, addr_step,
                 payload, size, dw):
        self.dst_base = dst_base      # int64[n]
        self.dst_step = dst_step      # int
        self.addr_base = addr_base    # int64[n]
        self.addr_step = addr_step    # int
        self.payload = payload
        self.size = size
        self.dw = dw


class _FanoutEmit:
    """All-peers fan-out: rank r sends one message to every other rank in
    ascending order, all carrying rank r's flag address ``addr_vec[r]``."""

    __slots__ = ("addr_vec", "payload", "size", "dw")

    def __init__(self, addr_vec, payload, size, dw):
        self.addr_vec = addr_vec      # int64[n]
        self.payload = payload
        self.size = size
        self.dw = dw


class _PhasePlan:
    __slots__ = ("name", "is_wait", "dur", "tdelta", "wait", "emit")

    def __init__(self, name, is_wait, dur, tdelta, wait, emit):
        self.name = name
        self.is_wait = is_wait
        self.dur = dur
        self.tdelta = tdelta
        # wait: None | ("single", base_vec, step) | ("allpeers", alpha, beta)
        self.wait = wait
        self.emit = emit


class _Seg:
    __slots__ = ("count", "k0", "body")

    def __init__(self, count, k0, body):
        self.count = count
        self.k0 = k0
        self.body = body


class _Plan:
    __slots__ = ("segs", "wait_src", "counts", "dispatch", "total", "n_stages")

    def __init__(self, segs, wait_src, counts, dispatch, total, n_stages):
        self.segs = segs
        self.wait_src = wait_src  # stage_id -> ("single", src, perm)|("allpeers", src)
        self.counts = counts      # int64[nc], rank-uniform cohort sizes
        self.dispatch = dispatch  # int64[nc], rank-uniform dispatch cycles
        self.total = total        # workgroups per rank
        self.n_stages = n_stages


def _uniform(values, what):
    it = iter(values)
    first = next(it)
    for v in it:
        if v != first:
            raise UnsupportedProgram(f"{what} varies across ranks")
    return first


def _wait_runs_of(entries, k0, count, n):
    """Normalize one rank's wait entries to ``(start, stride, count)`` runs.

    Entries must be k-invariant (ints or :class:`AffineRun`); an ``Affine``
    with step 0 degenerates to an int.  Used only for the all-peers pattern —
    the single-address pattern handles k-varying ``Affine`` entries directly.
    """
    runs = []
    for e in entries:
        if isinstance(e, AffineRun):
            runs.append((e.start, e.stride, e.count))
        elif isinstance(e, Affine):
            if e.step != 0 and count > 1:
                raise UnsupportedProgram(
                    "k-varying wait address inside an all-peers barrier"
                )
            runs.append((e.at(k0), 0, 1))
        elif isinstance(e, int):
            runs.append((e, 0, 1))
        else:
            raise UnsupportedProgram(f"unsupported wait entry {type(e).__name__}")
    return runs


def _classify_wait(specs, k0, count, n):
    """("single", base_vec, step) or ("allpeers", alpha, beta)."""
    # -- one address per rank per iteration ------------------------------
    single = True
    for sp in specs:
        entries = sp.wait_addrs
        if len(entries) != 1 or isinstance(entries[0], AffineRun) and \
                entries[0].count != 1:
            single = False
            break
    if single:
        base = np.empty(len(specs), np.int64)
        steps = set()
        for r, sp in enumerate(specs):
            e = sp.wait_addrs[0]
            if isinstance(e, Affine):
                base[r] = e.base
                steps.add(e.step if count > 1 else 0)
                if count <= 1:
                    base[r] = e.at(k0)
            elif isinstance(e, AffineRun):
                base[r] = e.start
                steps.add(0)
            else:
                base[r] = int(e)
                steps.add(0)
        if len(steps) != 1:
            raise UnsupportedProgram("wait address step varies across ranks")
        return ("single", base, steps.pop())
    # -- all-peers barrier: writers 0..n-1 minus self, ascending ---------
    # derive the writer-affine (alpha, beta) from rank n-1, whose single
    # run covers writers 0..n-2
    last = specs[n - 1].wait_addrs
    runs_last = _wait_runs_of(last, k0, count, n)
    if len(runs_last) != 1 or runs_last[0][2] != n - 1:
        raise UnsupportedProgram("wait entries do not form an all-peers barrier")
    alpha = runs_last[0][0]
    beta = runs_last[0][1] if n - 1 >= 2 else 0
    for r, sp in enumerate(specs):
        runs = _wait_runs_of(sp.wait_addrs, k0, count, n)
        below = (alpha, beta, r)
        above = (alpha + beta * (r + 1), beta, n - 1 - r)
        want = [x for x in (below, above) if x[2] > 0]
        if len(runs) != len(want):
            raise UnsupportedProgram("wait entries do not form an all-peers barrier")
        for got, exp in zip(runs, want):
            ok = got[0] == exp[0] and got[2] == exp[2] and (
                got[2] == 1 or got[1] == exp[1]
            )
            if not ok:
                raise UnsupportedProgram(
                    "wait entries do not form an all-peers barrier"
                )
    return ("allpeers", alpha, beta)


def _classify_emit(amap, specs, k0, count, n):
    """None, :class:`_SingleEmit`, or :class:`_FanoutEmit`."""
    if not specs[0].emits:
        for sp in specs:
            if sp.emits:
                raise UnsupportedProgram("emit presence varies across ranks")
        return None
    nranks = len(specs)
    first = specs[0].emits
    if len(first) == 1 and isinstance(first[0], (LoopEmit, EmitOp)):
        dst_base = np.empty(nranks, np.int64)
        dst_steps, payloads, sizes, dws = set(), set(), set(), set()
        slots = []  # per-rank (slot_base, slot_step)
        for r, sp in enumerate(specs):
            if len(sp.emits) != 1:
                raise UnsupportedProgram("emit count varies across ranks")
            e = sp.emits[0]
            if isinstance(e, LoopEmit):
                if e.coalesce != "last":
                    raise UnsupportedProgram("per-workgroup ('each') emission")
                dst_base[r] = e.dst.base
                dst_steps.add(e.dst.step if count > 1 else 0)
                if count <= 1:
                    dst_base[r] = e.dst.at(k0)
                slots.append((e.slot.base, e.slot.step if count > 1 else 0)
                             if count > 1 else (e.slot.at(k0), 0))
            elif isinstance(e, EmitOp):
                if e.coalesce != "last":
                    raise UnsupportedProgram("per-workgroup ('each') emission")
                if e.addr is not None:
                    raise UnsupportedProgram("explicit EmitOp.addr override")
                dst_base[r] = e.dst
                dst_steps.add(0)
                slots.append((e.slot, 0))
            else:
                raise UnsupportedProgram(
                    f"unsupported emit entry {type(e).__name__}"
                )
            payloads.add(e.payload_bytes)
            sizes.add(e.size)
            dws.add(e.data_writes)
        if len(dst_steps) != 1 or len(payloads) != 1 or len(sizes) != 1 \
                or len(dws) != 1:
            raise UnsupportedProgram("emit parameters vary across ranks")
        dst_step = dst_steps.pop()
        # flag addresses: addr(r, k) = flag_addr(r, slot_r(k)), verified
        # affine in k over the full loop range (never assumed from layout)
        addr_base = np.empty(nranks, np.int64)
        addr_steps = set()
        for r, (sb, ss) in enumerate(slots):
            a0 = amap.flag_addr(r, sb + ss * k0)
            if count > 1:
                a1 = amap.flag_addr(r, sb + ss * (k0 + 1))
                step = a1 - a0
                klast = k0 + count - 1
                if amap.flag_addr(r, sb + ss * klast) != a0 + step * (
                    count - 1
                ):
                    raise UnsupportedProgram(
                        "flag address is not affine over the loop range"
                    )
            else:
                step = 0
            addr_steps.add(step)
            addr_base[r] = a0 - step * k0
        if len(addr_steps) != 1:
            raise UnsupportedProgram("flag address step varies across ranks")
        # destination sanity over the whole k range (affine in k, so the
        # endpoints bound the range; self-sends can only occur at one k)
        ranks = np.arange(nranks, dtype=np.int64)
        for kk in (k0, k0 + max(count - 1, 0)):
            d = dst_base + dst_step * kk
            if d.min() < 0 or d.max() >= n:
                raise UnsupportedProgram("emit destination out of range")
        if dst_step == 0:
            if np.any(dst_base == ranks):
                raise UnsupportedProgram("self-directed emission")
        else:
            for r in range(nranks):
                num = r - int(dst_base[r])
                if num % dst_step == 0 and \
                        k0 <= num // dst_step < k0 + count:
                    raise UnsupportedProgram("self-directed emission")
        return _SingleEmit(
            dst_base, dst_step, addr_base, addr_steps.pop(),
            payloads.pop(), sizes.pop(), dws.pop(),
        )
    # -- all-peers fan-out: EmitRuns below/above self, ascending ----------
    payloads, sizes, dws, slot0s = set(), set(), set(), set()
    for r, sp in enumerate(specs):
        want = [(0, r), (r + 1, n - 1 - r)]
        want = [w for w in want if w[1] > 0]
        if len(sp.emits) != len(want):
            raise UnsupportedProgram("emits do not form an all-peers fan-out")
        for e, (d0, cnt) in zip(sp.emits, want):
            if not isinstance(e, EmitRun):
                raise UnsupportedProgram("emits do not form an all-peers fan-out")
            if e.coalesce != "last":
                raise UnsupportedProgram("per-workgroup ('each') emission")
            ok = e.dst0 == d0 and e.count == cnt and e.slot_stride == 0 and (
                e.count == 1 or e.dst_stride == 1
            )
            if not ok:
                raise UnsupportedProgram("emits do not form an all-peers fan-out")
            payloads.add(e.payload_bytes)
            sizes.add(e.size)
            dws.add(e.data_writes)
            slot0s.add(e.slot0)
    if len(payloads) != 1 or len(sizes) != 1 or len(dws) != 1 \
            or len(slot0s) != 1:
        raise UnsupportedProgram("fan-out parameters vary across ranks")
    slot0 = slot0s.pop()
    addr_vec = np.array(
        [amap.flag_addr(r, slot0) for r in range(len(specs))], np.int64
    )
    return _FanoutEmit(addr_vec, payloads.pop(), sizes.pop(), dws.pop())


def _phase_plan(amap, n, tdelta_for, specs, k0, count):
    """Compile one aligned body-phase position across all ranks."""
    s0 = specs[0]
    name = s0.name
    is_wait = s0.wait_addrs is not None
    for sp in specs:
        if sp.name != name or (sp.wait_addrs is not None) != is_wait:
            raise UnsupportedProgram("phase structure varies across ranks")
    dur = 0 if is_wait else _uniform(
        (sp.duration_cycles for sp in specs), "phase duration"
    )
    _uniform((sp.traffic for sp in specs), "phase traffic")
    tdelta = tdelta_for(s0) if tdelta_for is not None else None
    wait = emit = None
    if is_wait:
        wait = _classify_wait(specs, k0, count, n)
        for sp in specs:
            if sp.emits:
                raise UnsupportedProgram("wait phase with emissions")
    else:
        emit = _classify_emit(amap, specs, k0, count, n)
    return _PhasePlan(name, is_wait, dur, tdelta, wait, emit)


def _verify_ring_routes(fab, n) -> None:
    """Spot-check the fabric against the solver's replicated ring router."""
    srcs = sorted({0, 1, n // 2, n - 1})
    for src in srcs:
        for dst in sorted({(src + 1) % n, (src - 1) % n, (src + n // 2) % n}):
            if dst == src:
                continue
            fwd = (dst - src) % n
            bwd = (src - dst) % n
            hops, d = (fwd, 1) if fwd <= bwd else (bwd, -1)
            legs = fab.legs(src, dst)
            if len(legs) != 1:
                raise UnsupportedProgram("multi-leg route on the flat ring")
            leg = legs[0]
            if leg.cls != "ici" or leg.port != (src, d) or leg.hops != hops:
                raise UnsupportedProgram(
                    "fabric routes diverge from the flat ring router"
                )


def plan_stages(amap, n, progs, tdelta_for=None) -> _Plan:
    """Compile rank-aligned symbolic programs into the stage plan.

    This is the engine-independent half of lockstep compilation: segment
    alignment, affine wait/emit classification, and the symbolic wait<->
    emission matching that proves every wait is satisfied by a strictly
    earlier emission (lex order over (segment, k, body position)) — one
    node per (lane, affine pattern), never one per step.  The static
    verifier (:mod:`repro_torch.analysis.verify`) reuses it with
    ``tdelta_for=None`` to check loop-space dependency graphs at pod scale
    without materializing O(devices x steps) sites.

    Raises :class:`UnsupportedProgram` when the programs are not rank-uniform or
    a pattern falls outside the affine single-peer / all-peers families.
    The returned plan's cohort fields (``counts``/``dispatch``/``total``)
    are unset; :func:`_compile` fills them for the runtime solver.
    """
    nsegs = _uniform((len(p.segments) for p in progs), "segment count")
    segs: List[_Seg] = []
    for j in range(nsegs):
        col = [p.segments[j] for p in progs]
        s0 = col[0]
        if isinstance(s0, LoopSpec):
            for s in col:
                if not isinstance(s, LoopSpec) or s.count != s0.count \
                        or s.k0 != s0.k0 or len(s.body) != len(s0.body):
                    raise UnsupportedProgram("loop structure varies across ranks")
            body = [
                _phase_plan(
                    amap, n, tdelta_for, [s.body[b] for s in col],
                    s0.k0, s0.count,
                )
                for b in range(len(s0.body))
            ]
            segs.append(_Seg(s0.count, s0.k0, body))
        else:
            # literal segments (PhaseSpec or LoopPhase at k=0) are compiled
            # symbolically — materializing LoopPhase.at(0) would expand
            # EmitRuns into O(n) EmitOps per rank, O(n^2) for the pod
            for s in col:
                if isinstance(s, LoopSpec):
                    raise UnsupportedProgram("segment kinds vary across ranks")
            segs.append(
                _Seg(1, 0, [_phase_plan(amap, n, tdelta_for, col, 0, 1)])
            )

    # ---- symbolic wait<->emission matching over the full stage sequence
    wait_src: Dict[int, tuple] = {}
    open_recs: List[list] = []  # [stage_id, kind, dst_vec, addr_vec]
    perm_cache: Dict[bytes, np.ndarray] = {}
    ar = np.arange(n, dtype=np.int64)
    stage_id = 0
    for seg in segs:
        for k in range(seg.k0, seg.k0 + seg.count):
            for pp in seg.body:
                if pp.is_wait:
                    kind = pp.wait[0]
                    hit = None
                    if kind == "single":
                        want = pp.wait[1] + pp.wait[2] * k
                        for idx in range(len(open_recs) - 1, -1, -1):
                            sid, rkind, dstv, addrv = open_recs[idx]
                            if rkind != "single":
                                # at n == 2 the all-peers fan-out is a
                                # single exchange; a one-address wait can
                                # consume it as an all-peers barrier
                                if n == 2 and np.array_equal(
                                    addrv[::-1], want
                                ):
                                    del open_recs[idx]
                                    hit = ("allpeers", sid)
                                    break
                                continue
                            inv = np.empty(n, np.int64)
                            inv[dstv] = ar
                            if np.array_equal(addrv[inv], want):
                                del open_recs[idx]
                                key = inv.tobytes()
                                perm = perm_cache.get(key)
                                if perm is None:
                                    perm = perm_cache[key] = inv
                                hit = ("single", sid, perm)
                                break
                    else:
                        want = pp.wait[1] + pp.wait[2] * ar
                        for idx in range(len(open_recs) - 1, -1, -1):
                            sid, rkind, _dstv, addrv = open_recs[idx]
                            if rkind != "fanout":
                                continue
                            if np.array_equal(addrv, want):
                                del open_recs[idx]
                                hit = ("allpeers", sid)
                                break
                    if hit is None:
                        raise UnsupportedProgram(
                            f"wait phase {pp.name!r} (k={k}) has no matching "
                            "earlier emission"
                        )
                    wait_src[stage_id] = hit
                elif isinstance(pp.emit, _SingleEmit):
                    e = pp.emit
                    dstv = e.dst_base + e.dst_step * k
                    if not np.array_equal(np.bincount(dstv, minlength=n),
                                          np.ones(n, dtype=np.int64)):
                        raise UnsupportedProgram(
                            "emission destinations are not a permutation"
                        )
                    addrv = e.addr_base + e.addr_step * k
                    open_recs.append([stage_id, "single", dstv, addrv])
                elif isinstance(pp.emit, _FanoutEmit):
                    open_recs.append(
                        [stage_id, "fanout", None, pp.emit.addr_vec]
                    )
                stage_id += 1
    return _Plan(segs, wait_src, None, None, 0, stage_id)


def _compile(cluster) -> _Plan:
    """Full runtime compile: fabric spot-check, cohort uniformity, and the
    engine-independent stage plan (:func:`plan_stages`)."""
    cfg = cluster.cfg
    n = cfg.n_devices
    _verify_ring_routes(cluster.fabric, n)
    progs = [
        as_symbolic(node.target.cohorts[0].phases) for node in cluster.nodes
    ]
    # rank-uniform cohort shape: same sizes and dispatch cycles everywhere
    c0 = cluster.nodes[0].target.cohorts
    counts = np.array([c.count for c in c0], np.int64)
    dispatch = np.array([c.program.dispatch_cycle for c in c0], np.int64)
    for node in cluster.nodes[1:]:
        cs = node.target.cohorts
        if len(cs) != len(c0) or any(
            a.count != b.count
            or a.program.dispatch_cycle != b.program.dispatch_cycle
            for a, b in zip(cs, c0)
        ):
            raise UnsupportedProgram("cohort shapes vary across ranks")
    plan = plan_stages(
        cluster.amap, n, progs,
        tdelta_for=cluster.nodes[0].target._tdelta_for,
    )
    plan.counts = counts
    plan.dispatch = dispatch
    plan.total = int(counts.sum())
    return plan


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


class _OrderedTotal:
    """A float64 total on the device that takes its terms in order, as the
    reference's ``g_q += float(np.cumsum(q)[-1])`` does.

    A term is either the ordered sum of a vector (:meth:`add_sum_of`) or each
    entry of a vector in turn (:meth:`add_each`).  Vectors to sum wait as the
    columns of one matrix, scanned :data:`BLOCK` at a time, so the card runs
    one ordered scan a block instead of one a stage.
    """

    BLOCK = 256

    def __init__(self, dev):
        self.total = torch.zeros(1, dtype=torch.float64, device=dev)
        self._cols: List[torch.Tensor] = []
        # the terms in order: an int indexes _cols, a tensor adds each entry
        self._terms: List[object] = []

    def add_sum_of(self, v: torch.Tensor) -> None:
        self._terms.append(len(self._cols))
        self._cols.append(v)
        if len(self._cols) == self.BLOCK:
            self.flush()

    def add_each(self, v: torch.Tensor) -> None:
        self._terms.append(v)

    def flush(self) -> torch.Tensor:
        if not self._terms:
            return self.total
        sums = ordered_total(torch.stack(self._cols, dim=1)) if self._cols else None
        seq = [self.total] + [sums[t:t + 1] if isinstance(t, int) else t
                              for t in self._terms]
        self.total = ordered_total(torch.cat(seq)[:, None])
        self._cols, self._terms = [], []
        return self.total


class LockstepEngine:
    """Vectorized pod-scale solve of a compiled rank-uniform program."""

    def __init__(self, cluster):
        self.cluster = cluster
        self._plan: Optional[_Plan] = None
        self._tiered = None
        self.breakdown: Dict[str, float] = {}

    def compile(self, reuse=None) -> Optional[str]:
        """Build the stage plan; returns a fallback reason or None.

        The flat single-tier ring keeps the original rank-uniform stage
        plan; every other supported preset compiles through the tiered
        group-uniform solver (:mod:`repro_torch.core.lockstep_tiered`).
        Compilation mutates nothing, so a failure here falls back to the
        generic timeline engine cleanly.

        ``reuse`` accepts a :meth:`plan_handle` compiled for an identical
        (scenario, config, fabric) point — plans are read-only at run time,
        so a sweep revisiting the same shape skips recompilation.
        """
        t0 = time.perf_counter()
        if reuse is not None:
            kind, plan = reuse
            if kind == "tiered":
                self._tiered = plan
            else:
                self._plan = plan
            self.breakdown["compile_s"] = time.perf_counter() - t0
            self.breakdown["compile_cached"] = 1.0
            return None
        fab = self.cluster.fabric
        try:
            if fab.spec.name == "ring" and fab.n_nodes == 1:
                self._plan = _compile(self.cluster)
            else:
                from .lockstep_tiered import compile_tiered

                self._tiered = compile_tiered(self.cluster)
        except UnsupportedProgram as e:
            return str(e)
        except ValueError as e:  # e.g. address-map probing out of range
            return f"symbolic program probing failed: {e}"
        self.breakdown["compile_s"] = time.perf_counter() - t0
        return None

    def plan_handle(self):
        """The compiled plan as an opaque (kind, plan) pair for reuse via
        ``compile(reuse=...)``; None before a successful compile."""
        if self._tiered is not None:
            return ("tiered", self._tiered)
        if self._plan is not None:
            return ("flat", self._plan)
        return None

    def run(self) -> EngineResult:
        if self._tiered is not None:
            from .lockstep_tiered import run_tiered

            return run_tiered(self.cluster, self._tiered, self.breakdown)
        t0 = time.perf_counter()
        plan = self._plan
        assert plan is not None, "compile() must succeed before run()"
        cluster = self.cluster
        dev = cluster.device
        cfg = cluster.cfg
        n = cfg.n_devices
        clock = cfg.clock_ghz
        poll = cfg.poll_interval_cycles
        check = cfg.flag_check_cycles
        xgmi_lat = cfg.xgmi_enact_latency_ns
        include_dw = cfg.include_data_writes
        fab = cluster.fabric
        bw, lat = fab._cls["ici"]
        i64, f64 = torch.int64, torch.float64
        counts = torch.as_tensor(plan.counts, device=dev)
        total = plan.total
        ar = torch.arange(n, dtype=i64, device=dev)
        # the divisor of every ns conversion: a device tensor, so the card
        # divides (a host scalar would be turned into a reciprocal multiply)
        clock_t = torch.tensor(clock, dtype=f64, device=dev)
        on_dev: Dict[int, torch.Tensor] = {}  # plan arrays, copied once

        def dev_array(a: np.ndarray) -> torch.Tensor:
            t = on_dev.get(id(a))
            if t is None:
                t = on_dev[id(a)] = torch.as_tensor(a, device=dev)
            return t

        # cursor matrix: every rank starts its cohorts at the dispatch cycles
        T = torch.as_tensor(plan.dispatch, device=dev).repeat(n, 1)
        # spin reads: the ticks of every wait summed per (rank, cohort); the
        # reads are (ticks + waits) x cohort sizes, summed at the end (integer
        # sums, so the order does not matter); rank-uniform categories
        # accumulate as plain ints
        NT = torch.zeros_like(T)
        n_spins = 0
        u_nfr = u_rb = u_lw = u_wb = u_xo = u_xob = 0
        u_xi = u_xib = u_reg = u_marks = 0
        # fabric state: the flat ring's ports are (rank, +-1), row 0 of each
        # [2, n] tensor the +1 ports, row 1 the -1 ports; busy chains, port
        # stats, and the used-port masks (only touched ports get busy
        # entries written back, matching the engine's lazy dict)
        DIRS = (1, -1)
        busy = torch.tensor(
            [[fab._busy_until_ns.get((r, d), 0.0) for r in range(n)] for d in DIRS],
            dtype=f64, device=dev,
        )
        used = torch.zeros((2, n), dtype=torch.bool, device=dev)
        pcnt = torch.zeros((2, n), dtype=i64, device=dev)
        pbyt = torch.zeros((2, n), dtype=i64, device=dev)
        pqd = torch.zeros((2, n), dtype=f64, device=dev)
        g_msgs = 0
        g_bytes = 0
        g_q = _OrderedTotal(dev)
        setcycs: Dict[int, torch.Tensor] = {}
        # each rank's latest flag-set cycle so far (the reference's max_set
        # over ranks, taken once at the end)
        max_set = torch.zeros(n, dtype=i64, device=dev)
        seq_add = 0
        single_geo: Dict[tuple, tuple] = {}
        fan_geo: Dict[int, tuple] = {}

        def spin(V):
            """One wait address against the cursor matrix: the interpreter's
            unified closed form, vectorized over ranks x cohorts."""
            nonlocal n_spins
            nt = V[:, None] - T
            nt += poll - 1
            nt = torch.div(nt, poll, rounding_mode="floor")
            nt.clamp_(min=0)
            NT.add_(nt)
            nt *= poll
            nt += check
            T.add_(nt)
            n_spins += 1

        def single_geometry(e, k):
            """Hops (float64) and the one-hot direction of each rank's
            message, ``[2, n]`` (row 0: +1); fixed across k when the
            destination is."""
            key = (id(e), k if e.dst_step else None)
            geo = single_geo.get(key)
            if geo is None:
                dstv = dev_array(e.dst_base) + e.dst_step * k
                off = torch.remainder(dstv - ar, n)
                pos = 2 * off <= n
                geo = single_geo[key] = (
                    torch.minimum(off, n - off).to(f64),
                    torch.stack((pos, ~pos)),
                )
            return geo

        def fanout_geometry():
            """Per direction, rank r's destinations in ascending id (the
            reference's ``ds[msk]``) and their hop counts, as ``[cnt, n]``
            matrices (column r for rank r)."""
            if not fan_geo:
                d = ar.view(1, n).expand(n, n)
                off = torch.remainder(d - ar[:, None], n)
                hops = torch.minimum(off, n - off)
                pos = 2 * off <= n
                for row, msk in enumerate((pos & (off != 0), ~pos)):
                    cnt = n // 2 if row == 0 else n - 1 - n // 2
                    if cnt:
                        fan_geo[row] = (
                            d[msk].view(n, cnt).t().contiguous(),
                            hops[msk].view(n, cnt).t().to(f64).contiguous(),
                        )
            return fan_geo

        stage_id = 0
        for seg in plan.segs:
            for k in range(seg.k0, seg.k0 + seg.count):
                for pp in seg.body:
                    if pp.is_wait:
                        src = plan.wait_src[stage_id]
                        if src[0] == "single":
                            sc = setcycs.pop(src[1])
                            spin(sc[dev_array(src[2])])
                        else:
                            M = setcycs.pop(src[1])
                            # writer j for the ranks above it, j + 1 for
                            # the rest: the reference's M[where(ar > j, j,
                            # j + 1), ar], row by row
                            for j in range(n - 1):
                                spin(torch.cat((M[j + 1, :j + 1], M[j, j + 1:])))
                    else:
                        if pp.dur:
                            T += pp.dur
                        e = pp.emit
                        if e is not None:
                            Ef = T.max(dim=1).values.to(f64)
                            nb = e.payload + e.size
                            dw = e.dw if include_dw and e.dw > 0 else 0
                            regs = 1 + dw
                            if isinstance(e, _SingleEmit):
                                issue = Ef / clock_t
                                ser = nb / bw
                                hops, D = single_geometry(e, k)
                                # every rank's one message on its own port:
                                # the reference's two masked passes at once
                                st = torch.maximum(issue, torch.where(D[0], busy[0], busy[1]))
                                nbsy = st + ser
                                busy = torch.where(D, nbsy, busy)
                                used |= D
                                q = torch.where(D, st - issue, 0.0)
                                pcnt += D
                                pbyt.add_(D, alpha=nb)
                                # q >= 0: the other direction's zeros leave
                                # each pass's pqd and ordered sum as they were
                                pqd += q
                                g_q.add_sum_of(q[0])
                                g_q.add_sum_of(q[1])
                                g_msgs += n
                                g_bytes += n * nb
                                wake = nbsy + hops * lat
                                wake += xgmi_lat
                                minns = (Ef + 1) / clock_t
                                wake = torch.maximum(wake, minns)
                                sc = torch.round(wake * clock).to(i64)
                                setcycs[stage_id] = sc
                                torch.maximum(max_set, sc, out=max_set)
                                u_xo += 1
                                u_xob += e.size
                                u_xi += regs
                                u_xib += e.size + 8 * dw
                                u_reg += regs
                                u_marks += dw
                                seq_add += n * regs
                            else:  # _FanoutEmit, every rank at once
                                M = torch.zeros((n, n), dtype=i64, device=dev)
                                iss = Ef / clock_t
                                minns = (Ef + 1.0) / clock_t
                                ser = nb / bw
                                qsums = []
                                for row, (dst, hop) in fanout_geometry().items():
                                    cnt = dst.shape[0]
                                    start0 = torch.maximum(iss, busy[row])
                                    # the exact per-port cumsum chain of
                                    # FabricModel.transfer_batch, per rank
                                    chain = torch.empty(
                                        (cnt + 1, n), dtype=f64, device=dev
                                    )
                                    chain[0] = start0
                                    chain[1:] = ser
                                    bs = ordered_scan(chain)
                                    busy[row] = bs[-1]
                                    used[row] = True
                                    arrm = bs[1:] + hop * lat
                                    q = bs[:-1] - iss
                                    pcnt[row] += cnt
                                    pbyt[row] += cnt * nb
                                    qs = ordered_total(q)
                                    pqd[row] += qs
                                    qsums.append(qs)
                                    wake = arrm + xgmi_lat
                                    wake = torch.maximum(wake, minns)
                                    M.scatter_(
                                        1, dst.t(),
                                        torch.round(wake * clock).to(i64).t(),
                                    )
                                # rank by rank, direction +1 before -1
                                g_q.add_each(torch.stack(qsums, dim=1).reshape(-1))
                                setcycs[stage_id] = M
                                torch.maximum(max_set, M.max(dim=1).values, out=max_set)
                                g_msgs += n * (n - 1)
                                g_bytes += n * (n - 1) * nb
                                u_xo += n - 1
                                u_xob += (n - 1) * e.size
                                u_xi += (n - 1) * regs
                                u_xib += (n - 1) * (e.size + 8 * dw)
                                u_reg += (n - 1) * regs
                                u_marks += (n - 1) * dw
                                seq_add += n * (n - 1) * regs
                    d = pp.tdelta
                    if d is not None:
                        u_nfr += d[0] * total
                        u_rb += d[1] * total
                        u_lw += d[2] * total
                        u_wb += d[3] * total
                        u_xo += d[4] * total
                        u_xob += d[5] * total
                    stage_id += 1
        fr = (NT * counts).sum(dim=1) + n_spins * total
        g_q_t = g_q.flush()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        solve_done = time.perf_counter()

        # ---- write-back: the device's state read once ---------------------
        kend = T.max(dim=1).values.tolist()
        sim_cycles = max(max(kend), int(max_set.max()))
        fr_h = fr.tolist()
        g_q_h = float(g_q_t)
        for r, node in enumerate(self.cluster.nodes):
            t = node.memory.traffic
            t.flag_reads += fr_h[r]
            t.nonflag_reads += u_nfr
            t.read_bytes += 8 * fr_h[r] + u_rb
            t.local_writes += u_lw
            t.write_bytes += u_wb
            t.xgmi_writes_out += u_xo
            t.xgmi_bytes_out += u_xob
            t.xgmi_writes_in += u_xi
            t.xgmi_bytes_in += u_xib
            tgt = node.target
            tgt.done_count = tgt.n_wgs
            tgt.kernel_end_cycle = kend[r]
            ws = node.wtt.stats
            ws.registered += u_reg
            ws.enacted += u_reg
            if u_marks:
                cluster._data_marks[r] = (
                    cluster._data_marks.get(r, 0) + u_marks
                )
        cluster._seq += seq_add
        st = fab.stats
        st["messages"] += g_msgs
        st["bytes"] += g_bytes
        st["queued_ns"] += g_q_h
        st["ici_messages"] += g_msgs
        st["ici_bytes"] += g_bytes
        st["ici_queued_ns"] += g_q_h
        um, busy_h = used.tolist(), busy.tolist()
        pcnt_h, pbyt_h, pqd_h = pcnt.tolist(), pbyt.tolist(), pqd.tolist()
        for row, dval in enumerate(DIRS):
            for r in range(n):
                if not um[row][r]:
                    continue
                port = (r, dval)
                fab._busy_until_ns[port] = busy_h[row][r]
                ps = fab.port_stats.get(port)
                if ps is None:
                    ps = fab.port_stats[port] = [0, 0, 0.0]
                ps[0] += pcnt_h[row][r]
                ps[1] += pbyt_h[row][r]
                ps[2] += pqd_h[row][r]
        run_wall = time.perf_counter() - t0
        self.breakdown.update(
            solve_s=solve_done - t0,
            writeback_s=run_wall - (solve_done - t0),
        )
        return EngineResult(
            sim_cycles=sim_cycles,
            # the compile pass is part of this engine's cost; include it so
            # wall_time_s >= sum(breakdown.values())
            wall_time_s=run_wall + self.breakdown.get("compile_s", 0.0),
            head_polls=0,
            breakdown=self.breakdown,
        )
