"""Tiered lockstep: group-uniform bulk solving over multi-tier fabrics
(port of ``repro/core/lockstep_tiered.py``).

The flat solver (:mod:`repro_torch.core.lockstep`) requires one globally
rank-uniform program on the single-tier ring.  This module generalizes both
axes at once:

* **groups** — ranks partition by ``SymbolicProgram.group`` (leaders vs.
  workers in ``hierarchical_allreduce``, the single ``ring``/``all`` group of
  the uniform collectives).  Structural uniformity — segment kinds, loop
  bounds, phase names/durations/traffic, emit parameters — is required only
  *within* a group; rank-varying peers and flag addresses stay per-group
  vectors.  Cross-group dependencies (worker handoff -> leader barrier,
  leader broadcast -> worker wait) are stitched by a compile-time worklist
  that orders every group's stage instances so each wait follows the
  emission(s) that write its flags, and fails loudly (naming the blocked
  group, rank, phase, and flag) when no such order exists — which is exactly
  the pipelined cross-rank chain the timeline engine keeps handling.

* **multi-leg route families** — emissions are priced over the fabric's real
  leg sequences (intra-node ICI, DCI uplinks, fat-tree spine, rails) by a
  vectorized replica of the routing policy, spot-checked against
  ``fab.legs`` at compile time.  Two pricers cover every supported family:

  - *elementwise*: when no two messages of a stage share an egress port
    (ring steps, hierarchical stages on all presets), each leg is one
    ``max``/``add`` pass over per-port busy vectors — identical IEEE-754 ops
    to the event engine's sequential ``_leg`` calls, which factor into
    independent per-port chains because every port has a single producer
    rank whose issue cycles are monotone in program order.

  - *ordered*: when messages share ports (the all-to-all incast's single
    dispatch stage, the broadcast fan-out), messages are priced in the event
    engine's global order — ``(cycle, device, dst-run position)`` — by the
    reference's port-wavefront: each sweep extends every port's priced prefix
    with the touches whose upstream legs resolved.

Divergences from the event engine match the flat solver's documented set
(no ``_mem``/``flag_set_cycle`` mirrors, aggregate float ``queued_ns`` in
stage order, ``wtt_head_polls`` 0); per-port busy chains, set cycles, and
every integer counter stay bit-identical.

Compilation stays on the host, in numpy, as the reference's does.
:func:`run_tiered` works on torch tensors on the cluster's device: the
plan's arrays go there once, the fabric's busy state is read in once and the
fabric's state, stats and counters are written back once.  Its float64 is
numpy's, operation for operation:

* the wavefront's sweeps depend only on which legs are priced, never on the
  values, so :func:`_chunk_schedule` derives every (sweep, port) chunk with
  integer work, and each dependency level's chunks are priced in one launch
  of :func:`repro_torch.kernels.port_chain.port_chain` (the scalar busy
  recurrence and the port's queued sum, in order, one thread a port);
* every ``float(q.sum())`` is numpy's pairwise sum,
  :func:`repro_torch.kernels.numpy_sum.numpy_sum`;
* the queued totals take their terms in order through
  :func:`repro_torch.kernels.ordered_scan.ordered_total`;
* a division divides by a float64 tensor (the clock) or is numpy's own
  (``nb / bw`` per port, once per message size), ``torch.round`` is
  ``np.rint``, and sorts are stable.
"""


from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.numpy_sum import numpy_sum
from ..kernels.ordered_scan import ordered_total
from ..kernels.port_chain import port_chain
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

__all__ = ["compile_tiered", "run_tiered"]

_SUPPORTED = {
    "ring": "_RingRouting",
    "two_tier": "_TwoTierRouting",
    "fat_tree": "_FatTreeRouting",
    "rail_optimized": "_RailRouting",
}


def _unsupported(msg):
    from .lockstep import UnsupportedProgram

    return UnsupportedProgram(msg)


def _uniform(values, what, ids=None):
    """First value, or raise naming the first divergent rank."""
    vals = list(values)
    first = vals[0]
    for i, v in enumerate(vals[1:], 1):
        if v != first:
            who = ids[i] if ids is not None else i
            who0 = ids[0] if ids is not None else 0
            raise _unsupported(
                f"{what} varies across ranks (rank {who} differs from "
                f"rank {who0})"
            )
    return first


# ---------------------------------------------------------------------------
# port space + vectorized routing replicas
# ---------------------------------------------------------------------------


class _Ports:
    """Dense integer port ids + per-port link-class tables for one fabric.

    Encodings (id -> tuple is materialized in ``tuples`` for write-back):

    * ici ``(dev, +-1)``   -> ``dev*2 + (0 if +1 else 1)``
    * two_tier ``("dci", node, +-1)`` -> ``2n + node*2 + (0 if +1 else 1)``
    * fat_tree ``("up", node)`` / ``("down", node)`` / ``("spine", leaf)``
    * rail ``("rail", node, r)``
    """

    def __init__(self, fab):
        spec = fab.spec
        self.kind = spec.name
        n = self.n = spec.n_devices
        self.dpn = spec.devices_per_node
        self.n_nodes = n // self.dpn
        self.params = dict(getattr(spec, "params", {}) or {})
        tuples: List[tuple] = []
        cls: List[str] = []
        for dev in range(n):
            tuples.append((dev, 1))
            tuples.append((dev, -1))
            cls.extend(("ici", "ici"))
        nn = self.n_nodes
        if self.kind == "two_tier":
            for node in range(nn):
                tuples.append(("dci", node, 1))
                tuples.append(("dci", node, -1))
                cls.extend(("dci", "dci"))
        elif self.kind == "fat_tree":
            self.npl = int(self.params["nodes_per_leaf"])
            self.n_leaves = int(self.params["n_leaves"])
            for node in range(nn):
                tuples.append(("up", node))
                cls.append("dci")
            for node in range(nn):
                tuples.append(("down", node))
                cls.append("dci")
            for leaf in range(self.n_leaves):
                tuples.append(("spine", leaf))
                cls.append("spine")
        elif self.kind == "rail_optimized":
            self.rails = int(spec.nics_per_node)
            for node in range(nn):
                for r in range(self.rails):
                    tuples.append(("rail", node, r))
                    cls.append("rail")
        self.tuples = tuples
        self.P = len(tuples)
        names = sorted(set(cls))
        self.cls_names = names
        cid = {c: i for i, c in enumerate(names)}
        self.port_cls = np.array([cid[c] for c in cls], np.int64)
        missing = [c for c in names if c not in fab._cls]
        if missing:
            raise _unsupported(
                f"fabric lacks link class(es) {missing} the solver prices"
            )
        self.cls_bw = np.array([fab._cls[c][0] for c in names])
        self.cls_lat = np.array([fab._cls[c][1] for c in names])

    # -- vectorized port encoders ---------------------------------------
    def ici(self, dev, d):
        return dev * 2 + (d != 1)

    def dci(self, node, nd):
        return 2 * self.n + node * 2 + (nd != 1)

    def up(self, node):
        return 2 * self.n + node

    def down(self, node):
        return 2 * self.n + self.n_nodes + node

    def spine(self, leaf):
        return 2 * self.n + 2 * self.n_nodes + leaf

    def rail(self, node, r):
        return 2 * self.n + node * self.rails + r


def _ring_vec(src, dst, n):
    """(hops, dir) tensors of the shortest ring path — ``_ring_route``."""
    fwd = torch.remainder(dst - src, n)
    bwd = torch.remainder(src - dst, n)
    take_fwd = fwd <= bwd
    return torch.where(take_fwd, fwd, bwd), torch.where(take_fwd, 1, -1)


def _legs_csr(ports: _Ports, src, dst):
    """Vectorized leg expansion: CSR of (port, hops, cls) per message, legs
    in traversal order, as int64 ``src``/``dst`` tensors on any device give
    it.  Replicates the routing policies of the supported presets;
    ``_spot_check`` verifies samples against the real ``fab.legs``.
    """
    n = ports.n
    dpn = ports.dpn
    m = len(src)
    dev = src.device
    # candidate leg sets in traversal order (append order IS the per-message
    # leg order: a message matches either the same-node set or the cross-node
    # sets, and the cross sets are appended rank-ascending)
    cand: List[tuple] = []  # (mask, port_all, hops_all, cls_id)
    cid = {c: i for i, c in enumerate(ports.cls_names)}
    ici_c = cid["ici"]
    zeros = torch.zeros(m, dtype=torch.int64, device=dev)
    ones = torch.ones(m, dtype=torch.int64, device=dev)

    if ports.kind == "ring":
        hops, d = _ring_vec(src, dst, n)
        cand.append((torch.ones(m, dtype=torch.bool, device=dev),
                     ports.ici(src, d), hops, ici_c))
    else:
        sn, sl = torch.div(src, dpn, rounding_mode="floor"), torch.remainder(src, dpn)
        dn, dl = torch.div(dst, dpn, rounding_mode="floor"), torch.remainder(dst, dpn)
        same = sn == dn
        lhops, ld = _ring_vec(sl, dl, dpn)
        cand.append((same, ports.ici(src, ld), lhops, ici_c))
        cross = ~same
        if ports.kind == "two_tier":
            dci_c = cid["dci"]
            h1, d1 = _ring_vec(sl, zeros, dpn)
            cand.append((cross & (sl != 0), ports.ici(src, d1), h1, ici_c))
            nhops, nd = _ring_vec(sn, dn, ports.n_nodes)
            cand.append((cross, ports.dci(sn, nd), nhops, dci_c))
            h3, d3 = _ring_vec(zeros, dl, dpn)
            cand.append((cross & (dl != 0), ports.ici(dn * dpn, d3), h3, ici_c))
        elif ports.kind == "fat_tree":
            dci_c = cid["dci"]
            spine_c = cid["spine"]
            npl = ports.npl
            s_leaf = torch.div(sn, npl, rounding_mode="floor")
            d_leaf = torch.div(dn, npl, rounding_mode="floor")
            h1, d1 = _ring_vec(sl, zeros, dpn)
            cand.append((cross & (sl != 0), ports.ici(src, d1), h1, ici_c))
            cand.append((cross, ports.up(sn), ones, dci_c))
            cand.append((cross & (s_leaf != d_leaf), ports.spine(s_leaf), 2 * ones, spine_c))
            cand.append((cross, ports.down(dn), ones, dci_c))
            h5, d5 = _ring_vec(zeros, dl, dpn)
            cand.append((cross & (dl != 0), ports.ici(dn * dpn, d5), h5, ici_c))
        elif ports.kind == "rail_optimized":
            rail_c = cid["rail"]
            r = torch.remainder(dl, ports.rails)
            h1, d1 = _ring_vec(sl, r, dpn)
            cand.append((cross & (sl != r), ports.ici(src, d1), h1, ici_c))
            cand.append((cross, ports.rail(sn, r), ones, rail_c))
            h3, d3 = _ring_vec(r, dl, dpn)
            cand.append((cross & (dl != r), ports.ici(dn * dpn + r, d3), h3, ici_c))
        else:  # pragma: no cover - gated by _SUPPORTED
            raise _unsupported(f"unsupported fabric kind {ports.kind!r}")

    # direct CSR construction: leg (msg i, set r) lands at
    # offs[i] + (earlier sets present for i) — no sort over the leg table.
    # int32 leg columns: the leg table reaches ~66M rows at 4096 devices on
    # fat_tree, and every value fits comfortably in 31 bits
    counts = torch.zeros(m, dtype=torch.int64, device=dev)
    for mask, _p, _h, _c in cand:
        counts += mask
    offs = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=offs[1:])  # integer sums: exact in any order
    L = int(offs[m])
    msg = torch.repeat_interleave(torch.arange(m, dtype=torch.int32, device=dev), counts)
    port = torch.empty(L, dtype=torch.int32, device=dev)
    hops = torch.empty(L, dtype=torch.int32, device=dev)
    cls = torch.empty(L, dtype=torch.int32, device=dev)
    prior = torch.zeros(m, dtype=torch.int64, device=dev)
    for mask, port_all, hops_all, cls_id in cand:
        idx = torch.nonzero(mask).flatten()
        if idx.numel():
            pos = offs[idx] + prior[idx]
            port[pos] = port_all[idx].to(torch.int32)
            hops[pos] = hops_all[idx].to(torch.int32)
            cls[pos] = cls_id
        prior += mask
    return {
        "msg": msg, "port": port, "hops": hops, "cls": cls, "offs": offs,
    }


def _legs_np(ports: _Ports, src: np.ndarray, dst: np.ndarray):
    """:func:`_legs_csr` of host arrays, as numpy arrays (the compiler's)."""
    legs = _legs_csr(ports, torch.as_tensor(src, dtype=torch.int64),
                     torch.as_tensor(dst, dtype=torch.int64))
    return {k: v.numpy() for k, v in legs.items()}


def _spot_check(ports: _Ports, fab, src, dst, legs) -> None:
    """Verify sampled messages' replicated legs against ``fab.legs``."""
    m = len(src)
    if m == 0:
        return
    samples = sorted({0, m // 3, m // 2, (2 * m) // 3, m - 1})
    offs = legs["offs"]
    for i in samples:
        got = fab.legs(int(src[i]), int(dst[i]))
        lo, hi = int(offs[i]), int(offs[i + 1])
        if len(got) != hi - lo:
            raise _unsupported(
                "fabric routes diverge from the solver's replicated router"
            )
        for j, leg in enumerate(got):
            t = lo + j
            ok = (
                leg.cls == ports.cls_names[int(legs["cls"][t])]
                and leg.port == ports.tuples[int(legs["port"][t])]
                and leg.hops == int(legs["hops"][t])
            )
            if not ok:
                raise _unsupported(
                    "fabric routes diverge from the solver's replicated "
                    "router"
                )


# ---------------------------------------------------------------------------
# group-aligned program
# ---------------------------------------------------------------------------


class _GEmit:
    """One group's emission family at one aligned phase position.

    kind: "single" (one message per rank, k-invariant dst), "run" (a
    contiguous per-rank dst run sharing one flag address), or "fanout_all"
    (the all-peers incast, group == all ranks).
    """

    __slots__ = (
        "kind", "payload", "size", "dw", "dst", "addr_base", "addr_step",
        "cnt",
    )

    def __init__(self, kind, payload, size, dw, dst, addr_base, addr_step,
                 cnt=1):
        self.kind = kind
        self.payload = payload
        self.size = size
        self.dw = dw
        self.dst = dst              # int64[g] dst device (base for "run")
        self.addr_base = addr_base  # int64[g] flag addr at k=0
        self.addr_step = addr_step  # int, addr advance per k
        self.cnt = cnt              # messages per rank ("run")


class _GPhase:
    __slots__ = ("name", "is_wait", "dur", "tdelta", "wait", "emit")

    def __init__(self, name, is_wait, dur, tdelta, wait, emit):
        self.name = name
        self.is_wait = is_wait
        self.dur = dur
        self.tdelta = tdelta
        # wait: None | ("cols", [(base_vec, kstep), ...])
        #            | ("allpeers", alpha, beta)
        self.wait = wait
        self.emit = emit


class _GSeg:
    __slots__ = ("count", "k0", "body")

    def __init__(self, count, k0, body):
        self.count = count
        self.k0 = k0
        self.body = body


class _Group:
    __slots__ = ("name", "devs", "segs", "counts", "dispatch", "total",
                 "tdf")

    def __init__(self, name, devs):
        self.name = name
        self.devs = devs  # int64[g], ascending device ids
        self.segs: List[_GSeg] = []
        self.counts = None
        self.dispatch = None
        self.total = 0
        self.tdf = None


def _wait_cols(specs, devs, k0, count, gname, phname):
    """Classify one aligned wait position into ordered address columns.

    Each rank's ``wait_addrs`` entries normalize to (base, kstep) columns:
    ints and ``AffineRun`` members are k-invariant, an ``Affine`` advances
    by its step per loop iteration.  Column structure must match across the
    group; bases become per-rank vectors.
    """
    g = len(specs)
    per_rank: List[List[Tuple[int, int]]] = []
    for i, sp in enumerate(specs):
        cols: List[Tuple[int, int]] = []
        for e in sp.wait_addrs:
            if isinstance(e, AffineRun):
                for p in range(e.count):
                    cols.append((e.start + e.stride * p, 0))
            elif isinstance(e, Affine):
                if count > 1:
                    cols.append((e.base, e.step))
                else:
                    cols.append((e.at(k0), 0))
            elif isinstance(e, (int, np.integer)):
                cols.append((int(e), 0))
            else:
                raise _unsupported(
                    f"unsupported wait entry {type(e).__name__} in phase "
                    f"{phname!r} of group {gname!r}"
                )
        per_rank.append(cols)
    ncols = _uniform(
        (len(c) for c in per_rank), f"wait width of phase {phname!r}",
        ids=devs,
    )
    out = []
    for c in range(ncols):
        kstep = _uniform(
            (per_rank[i][c][1] for i in range(g)),
            f"wait address step of phase {phname!r}", ids=devs,
        )
        base = np.array([per_rank[i][c][0] for i in range(g)], np.int64)
        out.append((base, kstep))
    return ("cols", out)


def _try_allpeers_wait(specs, devs, k0, count, n):
    """("allpeers", alpha, beta) when the group is all ranks and the wait is
    the all-peers barrier; None otherwise."""
    if len(devs) != n or devs[0] != 0 or devs[-1] != n - 1:
        return None
    total = 0
    for e in specs[0].wait_addrs:
        total += e.count if isinstance(e, AffineRun) else 1
    if total != n - 1 or n - 1 <= 1:
        return None
    from .lockstep import UnsupportedProgram, _classify_wait

    try:
        w = _classify_wait(specs, k0, count, n)
    except UnsupportedProgram:
        return None
    return w if w[0] == "allpeers" else None


def _classify_emit_group(amap, specs, devs, k0, count, n, gname, phname):
    """None, or a :class:`_GEmit` for the aligned emission position."""
    if not specs[0].emits:
        for i, sp in enumerate(specs):
            if sp.emits:
                raise _unsupported(
                    f"emit presence of phase {phname!r} varies across ranks "
                    f"(rank {devs[i]} differs from rank {devs[0]})"
                )
        return None
    g = len(specs)
    blame = f"phase {phname!r} of group {gname!r}"
    all_single = all(
        len(sp.emits) == 1 and isinstance(sp.emits[0], (LoopEmit, EmitOp))
        for sp in specs
    )
    all_run = all(
        len(sp.emits) == 1 and isinstance(sp.emits[0], EmitRun)
        for sp in specs
    )
    if all_single:
        dst = np.empty(g, np.int64)
        slots: List[Tuple[int, int]] = []
        payloads, sizes, dws = set(), set(), set()
        for i, sp in enumerate(specs):
            e = sp.emits[0]
            if isinstance(e, LoopEmit):
                if e.coalesce != "last":
                    raise _unsupported(
                        f"per-workgroup ('each') emission in {blame}"
                    )
                if e.dst.step != 0 and count > 1:
                    raise _unsupported(
                        f"k-varying emission destination in {blame} on a "
                        "multi-tier fabric"
                    )
                dst[i] = e.dst.at(k0)
                slots.append(
                    (e.slot.base, e.slot.step) if count > 1
                    else (e.slot.at(k0), 0)
                )
            elif isinstance(e, EmitOp):
                if e.coalesce != "last":
                    raise _unsupported(
                        f"per-workgroup ('each') emission in {blame}"
                    )
                if e.addr is not None:
                    raise _unsupported(
                        f"explicit EmitOp.addr override in {blame}"
                    )
                dst[i] = e.dst
                slots.append((e.slot, 0))
            else:
                raise _unsupported(
                    f"unsupported emit entry {type(e).__name__} in {blame}"
                )
            payloads.add(e.payload_bytes)
            sizes.add(e.size)
            dws.add(e.data_writes)
        if len(payloads) != 1 or len(sizes) != 1 or len(dws) != 1:
            raise _unsupported(f"emit parameters of {blame} vary across ranks")
        addr_base = np.empty(g, np.int64)
        addr_steps = set()
        for i, (sb, ss) in enumerate(slots):
            src_dev = int(devs[i])
            a0 = amap.flag_addr(src_dev, sb + ss * k0)
            if count > 1:
                a1 = amap.flag_addr(src_dev, sb + ss * (k0 + 1))
                step = a1 - a0
                klast = k0 + count - 1
                if amap.flag_addr(src_dev, sb + ss * klast) != a0 + step * (
                    count - 1
                ):
                    raise _unsupported(
                        f"flag address of {blame} is not affine over the "
                        "loop range"
                    )
            else:
                step = 0
            addr_steps.add(step)
            addr_base[i] = a0 - step * k0
        if len(addr_steps) != 1:
            raise _unsupported(
                f"flag address step of {blame} varies across ranks"
            )
        if dst.min() < 0 or dst.max() >= n:
            raise _unsupported(f"emit destination out of range in {blame}")
        if np.any(dst == devs):
            bad = int(devs[np.flatnonzero(dst == devs)[0]])
            raise _unsupported(
                f"self-directed emission in {blame} (rank {bad})"
            )
        return _GEmit(
            "single", payloads.pop(), sizes.pop(), dws.pop(), dst,
            addr_base, addr_steps.pop(),
        )
    # ---- contiguous per-rank dst run sharing one flag address ----------
    if all_run:
        if count > 1:
            raise _unsupported(
                f"EmitRun fan-out inside a k-loop in {blame} rewrites the "
                "same flags every iteration"
            )
        dst0 = np.empty(g, np.int64)
        cnts, slot0s, payloads, sizes, dws = set(), set(), set(), set(), set()
        for i, sp in enumerate(specs):
            e = sp.emits[0]
            if e.coalesce != "last":
                raise _unsupported(
                    f"per-workgroup ('each') emission in {blame}"
                )
            if e.count > 1 and e.dst_stride != 1 or e.slot_stride != 0:
                raise _unsupported(
                    f"non-contiguous EmitRun fan-out in {blame}"
                )
            dst0[i] = e.dst0
            cnts.add(e.count)
            slot0s.add(e.slot0)
            payloads.add(e.payload_bytes)
            sizes.add(e.size)
            dws.add(e.data_writes)
        if len(cnts) != 1 or len(slot0s) != 1 or len(payloads) != 1 \
                or len(sizes) != 1 or len(dws) != 1:
            raise _unsupported(f"fan-out parameters of {blame} vary across ranks")
        cnt = cnts.pop()
        if cnt < 1:
            return None
        slot0 = slot0s.pop()
        if dst0.min() < 0 or int(dst0.max()) + cnt - 1 >= n:
            raise _unsupported(f"emit destination out of range in {blame}")
        for i in range(g):
            if dst0[i] <= devs[i] < dst0[i] + cnt:
                raise _unsupported(
                    f"self-directed emission in {blame} (rank {int(devs[i])})"
                )
        addr_base = np.array(
            [amap.flag_addr(int(d), slot0) for d in devs], np.int64
        )
        return _GEmit(
            "run", payloads.pop(), sizes.pop(), dws.pop(), dst0,
            addr_base, 0, cnt=cnt,
        )
    # ---- all-peers fan-out (group must cover every rank) ---------------
    if len(devs) == n and devs[0] == 0:
        from .lockstep import UnsupportedProgram, _classify_emit

        try:
            e = _classify_emit(amap, specs, k0, count, n)
        except UnsupportedProgram as exc:
            raise _unsupported(f"{exc} ({blame})")
        if type(e).__name__ == "_FanoutEmit":
            if count > 1:
                raise _unsupported(
                    f"all-peers fan-out inside a k-loop in {blame}"
                )
            return _GEmit(
                "fanout_all", e.payload, e.size, e.dw, None, e.addr_vec, 0,
            )
    raise _unsupported(f"unsupported emission pattern in {blame}")


def _align_group(amap, n, group: _Group, progs) -> None:
    """Fill ``group.segs`` with the aligned per-phase classification."""
    devs = group.devs
    gname = group.name
    nsegs = _uniform(
        (len(p.segments) for p in progs),
        f"segment count of group {gname!r}", ids=devs,
    )
    tdf = group.tdf
    for j in range(nsegs):
        col = [p.segments[j] for p in progs]
        s0 = col[0]
        if isinstance(s0, LoopSpec):
            for i, s in enumerate(col):
                if not isinstance(s, LoopSpec) or s.count != s0.count \
                        or s.k0 != s0.k0 or len(s.body) != len(s0.body):
                    raise _unsupported(
                        f"loop structure of group {gname!r} varies across "
                        f"ranks (rank {devs[i]} differs from rank {devs[0]})"
                    )
            body = [
                _gphase(
                    amap, n, tdf, [s.body[b] for s in col], devs, gname,
                    s0.k0, s0.count,
                )
                for b in range(len(s0.body))
            ]
            group.segs.append(_GSeg(s0.count, s0.k0, body))
        else:
            for i, s in enumerate(col):
                if isinstance(s, LoopSpec):
                    raise _unsupported(
                        f"segment kinds of group {gname!r} vary across "
                        f"ranks (rank {devs[i]} differs from rank {devs[0]})"
                    )
            group.segs.append(
                _GSeg(1, 0, [_gphase(amap, n, tdf, col, devs, gname, 0, 1)])
            )


def _gphase(amap, n, tdf, specs, devs, gname, k0, count) -> _GPhase:
    s0 = specs[0]
    name = s0.name
    is_wait = s0.wait_addrs is not None
    for i, sp in enumerate(specs):
        if sp.name != name or (sp.wait_addrs is not None) != is_wait:
            raise _unsupported(
                f"phase structure of group {gname!r} varies across ranks "
                f"(rank {devs[i]} differs from rank {devs[0]})"
            )
    dur = 0 if is_wait else _uniform(
        (sp.duration_cycles for sp in specs),
        f"duration of phase {name!r} in group {gname!r}", ids=devs,
    )
    _uniform(
        (sp.traffic for sp in specs),
        f"traffic of phase {name!r} in group {gname!r}", ids=devs,
    )
    tdelta = tdf(s0) if tdf is not None else None
    wait = emit = None
    if is_wait:
        for i, sp in enumerate(specs):
            if sp.emits:
                raise _unsupported(
                    f"wait phase {name!r} of group {gname!r} has emissions "
                    f"(rank {devs[i]})"
                )
        wait = _try_allpeers_wait(specs, devs, k0, count, n)
        if wait is None:
            wait = _wait_cols(specs, devs, k0, count, gname, name)
    else:
        emit = _classify_emit_group(
            amap, specs, devs, k0, count, n, gname, name
        )
    return _GPhase(name, is_wait, dur, tdelta, wait, emit)


# ---------------------------------------------------------------------------
# emission families + compiled plan
# ---------------------------------------------------------------------------


class _Fam:
    """One aligned emission position's route family, shared by its k
    instances.  Messages are enumerated source-major (group row order, dst
    ascending within a rank's run) — the event engine's per-firing op order.
    """

    __slots__ = (
        "gi", "fid", "kind", "pricing", "payload", "size", "dw", "nb",
        "m", "cnt", "src_row", "src_dev", "dst", "addr_rel", "addr_step",
        "legs", "leg_slots", "keys_sorted", "keys_order", "dst_unique",
        "addr_vec", "cls_legs",
    )


class _Rec:
    """One emission instance awaiting its consumer wait(s)."""

    __slots__ = ("uid", "fam", "k", "consumed", "live")

    def __init__(self, uid, fam, k):
        self.uid = uid
        self.fam = fam
        self.k = k
        self.consumed = np.zeros(fam.m, bool)
        self.live = fam.m


class _TieredPlan:
    __slots__ = ("ports", "groups", "instrs", "refs")

    def __init__(self, ports, groups, instrs, refs):
        self.ports = ports
        self.groups = groups
        # ("p", gi, dur, tdelta, fam|None, uid, k)  non-wait phase
        # ("w", gi, cols, tdelta)  cols: [[(uid, idx, rows), ...], ...]
        # ("aw", gi, uid, tdelta)  all-peers barrier on a fanout record
        self.instrs = instrs
        self.refs = refs  # int64[n_uids]: runtime gathers per record


def _build_fam(ports, fab, grp, gi, fid, e: _GEmit, n) -> _Fam:
    fam = _Fam()
    fam.gi = gi
    fam.fid = fid
    fam.kind = e.kind
    fam.payload = e.payload
    fam.size = e.size
    fam.dw = e.dw
    fam.nb = e.payload + e.size
    fam.addr_step = e.addr_step
    fam.leg_slots = None
    fam.keys_sorted = None
    fam.addr_vec = None
    g = len(grp.devs)
    if e.kind == "fanout_all":
        fam.pricing = "ordered"
        fam.m = n * (n - 1)
        fam.cnt = n - 1
        fam.addr_vec = e.addr_base
        fam.legs = None  # built lazily at the (single) run instance
        fam.src_row = fam.src_dev = fam.dst = fam.addr_rel = None
        fam.dst_unique = False
        fam.cls_legs = None
        return fam
    if e.kind == "single":
        fam.cnt = 1
        fam.src_row = np.arange(g, dtype=np.int64)
        fam.src_dev = grp.devs
        fam.dst = e.dst
        fam.addr_rel = e.addr_base
    else:  # run
        fam.cnt = e.cnt
        fam.src_row = np.repeat(np.arange(g, dtype=np.int64), e.cnt)
        fam.src_dev = grp.devs[fam.src_row]
        fam.dst = (
            e.dst[:, None] + np.arange(e.cnt, dtype=np.int64)
        ).ravel()
        fam.addr_rel = np.repeat(e.addr_base, e.cnt)
    fam.m = len(fam.dst)
    fam.legs = _legs_np(ports, fam.src_dev, fam.dst)
    _spot_check(ports, fab, fam.src_dev, fam.dst, fam.legs)
    # matching keys: (flag addr at k=0, dst) must identify each message
    keys = fam.addr_rel * np.int64(n) + fam.dst
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    if fam.m > 1 and np.any(skeys[1:] == skeys[:-1]):
        raise _unsupported(
            f"duplicate (flag, destination) pair in an emission of group "
            f"{grp.name!r}"
        )
    fam.keys_sorted = skeys
    fam.keys_order = order
    fam.dst_unique = np.unique(fam.dst).size == fam.m
    # pricing: elementwise when no two messages of the instance share a
    # port; ordered per-port chains otherwise
    prt = fam.legs["port"]
    if np.unique(prt).size == prt.size:
        fam.pricing = "elem"
        offs = fam.legs["offs"]
        local = np.arange(len(prt), dtype=np.int64) - offs[fam.legs["msg"]]
        slots = []
        for s in range(int(local.max()) + 1 if len(prt) else 0):
            sel = np.flatnonzero(local == s)
            slots.append((
                fam.legs["msg"][sel], prt[sel],
                fam.legs["hops"][sel], fam.legs["cls"][sel],
            ))
        fam.leg_slots = slots
    else:
        fam.pricing = "ordered"
    fam.cls_legs = np.bincount(
        fam.legs["cls"], minlength=len(ports.cls_names)
    )
    return fam


def _register_ports(own, fam, gname):
    """Record port ownership; every port must have a single producer rank
    unless all its touches are priced in-order within one instance."""
    if fam.legs is None:
        return
    prt = fam.legs["port"]
    src = fam.src_dev[fam.legs["msg"]]
    pairs = np.unique(np.stack((prt, src)), axis=1)
    seen_ports, first = np.unique(pairs[0], return_index=True)
    if fam.pricing == "elem" and seen_ports.size != pairs.shape[1]:
        raise _unsupported(
            f"link port shared across source ranks in an emission of "
            f"group {gname!r}"
        )
    for p, s in zip(pairs[0], pairs[1]):
        p = int(p)
        s = int(s)
        prev = own.get(p)
        if prev is not None and prev != s:
            raise _unsupported(
                f"link port shared across source ranks {prev} and {s} "
                f"(group {gname!r}); cross-rank port interleaving stays on "
                "the timeline engine"
            )
        own[p] = s


class _Cursor:
    """Unrolled (segment, iteration, body position) walker for one group."""

    __slots__ = ("grp", "si", "kk", "bi", "done")

    def __init__(self, grp):
        self.grp = grp
        self.si = 0
        self.kk = 0
        self.bi = 0
        self.done = not grp.segs
        self._skip_empty()

    def _skip_empty(self):
        while not self.done and self.grp.segs[self.si].count <= 0:
            self.si += 1
            if self.si >= len(self.grp.segs):
                self.done = True

    def phase(self):
        seg = self.grp.segs[self.si]
        return seg.body[self.bi], seg.k0 + self.kk

    def advance(self):
        seg = self.grp.segs[self.si]
        self.bi += 1
        if self.bi >= len(seg.body):
            self.bi = 0
            self.kk += 1
            if self.kk >= seg.count:
                self.kk = 0
                self.si += 1
                if self.si >= len(self.grp.segs):
                    self.done = True
                    return
                self._skip_empty()


def _decode_flag(amap, n, addr):
    """Best-effort (writer, slot) of a flag address, for blame text."""
    try:
        base = amap.flag_addr(0, 0)
        dstride = amap.flag_addr(1, 0) - base
        idx, rem = divmod(int(addr) - base, dstride)
        if rem == 0 and idx >= 0:
            return idx % n, idx // n
    except Exception:
        pass
    return None, None


def _check_flag_reuse(progs, amap, cfg):
    """Decline programs where a flag address the solver stitches to an
    emission can also be set by an *earlier, unrelated* write.

    The event and timeline engines resolve waits by *value*: once a flag
    address holds data, every later wait on it completes at the next poll.
    The solver instead stitches each wait to its affine-matched emission, so
    any second writer of a stitched address makes the two disagree — either
    a *flag rewrite* (two emission instances targeting one (rank, flag)) or
    *marker aliasing* (``EmitOp.data_writes`` markers growing up from
    ``partial_base`` into a flag pool that overran the gap).

    The actual analysis lives in the parametric layout prover
    (:func:`repro_torch.analysis.layout.check_programs`) — one implementation,
    shared with ``verify_scenario``/``prove_layout`` — and this gate cites
    the prover's finding verbatim.  Declined shapes stay on the timeline
    engine, which reproduces the engines' stale-flag timing exactly.
    """
    # analysis builds on core; import lazily to keep core import-light and
    # cycle-free
    from ..analysis.layout import check_programs

    findings = check_programs(progs, amap, cfg)
    for f in findings:
        if f.severity != "error":
            continue
        tail = (
            "; stale-flag waits stay on the timeline engine"
            if f.kind == "flag-reuse"
            else "; stale-flag visibility stays on the timeline engine"
        )
        raise _unsupported(f.message + tail)


def _match_col(open_recs, want_addr, want_dst, n, cache):
    """Resolve one wait column against open emission records, latest first.

    Returns (segments, pend) — segments are (uid, idx, rows) gathers, pend
    the deferred consumption marks — or (None, blocked_row) when some rank's
    flag has no unconsumed earlier emission.
    """
    g = len(want_addr)
    remaining = np.ones(g, bool)
    segments = []
    pend = []
    for rec in reversed(open_recs):
        fam = rec.fam
        if fam.keys_sorted is None:
            continue
        rel = want_addr - fam.addr_step * rec.k
        ck = (fam.fid, rel.tobytes(), want_dst.tobytes())
        rows = cache.get(ck)
        if rows is None:
            keys = rel * np.int64(n) + want_dst
            pos = np.searchsorted(fam.keys_sorted, keys)
            pos_c = np.minimum(pos, fam.m - 1)
            hit = fam.keys_sorted[pos_c] == keys
            rows = np.where(hit, fam.keys_order[pos_c], -1)
            cache[ck] = rows
        valid = remaining & (rows >= 0)
        vi = np.flatnonzero(valid)
        if not vi.size:
            continue
        rr = rows[vi]
        free = ~rec.consumed[rr]
        vi = vi[free]
        if not vi.size:
            continue
        segments.append((rec.uid, vi, rows[vi]))
        pend.append((rec, rows[vi]))
        remaining[vi] = False
        if not remaining.any():
            return segments, pend
    return None, int(np.flatnonzero(remaining)[0])


def compile_tiered(cluster) -> _TieredPlan:
    """Group-align, classify, and schedule the pod's symbolic programs over
    a multi-tier fabric.  Raises :class:`UnsupportedProgram` with the
    offending group/rank/phase when the shape doesn't fit."""
    cfg = cluster.cfg
    n = cfg.n_devices
    amap = cluster.amap
    fab = cluster.fabric
    rcls = type(fab.spec.routing).__name__
    if _SUPPORTED.get(fab.spec.name) != rcls:
        raise _unsupported(
            f"fabric {fab.spec.name!r} (routing {rcls}) is outside the "
            "tiered solver's presets"
        )
    if amap.flag_addr(0, 0) >= (1 << 62) // max(2, n):
        raise _unsupported("flag address space too large for match keys")
    ports = _Ports(fab)
    progs = [
        as_symbolic(node.target.cohorts[0].phases) for node in cluster.nodes
    ]
    gorder: List[str] = []
    gmap: Dict[str, List[int]] = {}
    for dev, p in enumerate(progs):
        gname = p.group if p.group is not None else "ranks"
        if gname not in gmap:
            gmap[gname] = []
            gorder.append(gname)
        gmap[gname].append(dev)
    groups: List[_Group] = []
    for gname in gorder:
        devs = np.array(gmap[gname], np.int64)
        grp = _Group(gname, devs)
        tgt0 = cluster.nodes[int(devs[0])].target
        c0 = tgt0.cohorts
        grp.counts = np.array([c.count for c in c0], np.int64)
        grp.dispatch = np.array(
            [c.program.dispatch_cycle for c in c0], np.int64
        )
        grp.total = int(grp.counts.sum())
        grp.tdf = tgt0._tdelta_for
        for d in devs[1:]:
            cs = cluster.nodes[int(d)].target.cohorts
            if len(cs) != len(c0) or any(
                a.count != b.count
                or a.program.dispatch_cycle != b.program.dispatch_cycle
                for a, b in zip(cs, c0)
            ):
                raise _unsupported(
                    f"cohort shapes vary across ranks of group {gname!r} "
                    f"(rank {int(d)})"
                )
        _align_group(amap, n, grp, [progs[int(d)] for d in devs])
        groups.append(grp)

    # ---- worklist: order every group's phase instances -----------------
    fams: Dict[tuple, _Fam] = {}
    own: Dict[int, int] = {}
    recs: List[_Rec] = []
    open_recs: List[_Rec] = []
    instrs: List[tuple] = []
    refs: List[int] = []
    cursors = [_Cursor(grp) for grp in groups]
    cache: Dict[tuple, np.ndarray] = {}
    arrc: Dict[bytes, np.ndarray] = {}
    blocked: List[Optional[tuple]] = [None] * len(groups)

    def share(a):
        b = arrc.get(a.tobytes())
        if b is None:
            arrc[a.tobytes()] = a
            return a
        return b

    ar = np.arange(n, dtype=np.int64)
    while True:
        progress = False
        alldone = True
        for gi, (grp, cur) in enumerate(zip(groups, cursors)):
            while not cur.done:
                ph, k = cur.phase()
                if not ph.is_wait:
                    fam = uid = None
                    if ph.emit is not None:
                        fkey = (gi, cur.si, cur.bi)
                        fam = fams.get(fkey)
                        if fam is None:
                            fam = _build_fam(
                                ports, fab, grp, gi, len(fams), ph.emit, n
                            )
                            _register_ports(own, fam, grp.name)
                            fams[fkey] = fam
                        uid = len(recs)
                        rec = _Rec(uid, fam, k)
                        recs.append(rec)
                        open_recs.append(rec)
                        refs.append(0)
                    instrs.append(("p", gi, ph.dur, ph.tdelta, fam, uid, k))
                    cur.advance()
                    progress = True
                    continue
                if ph.wait[0] == "allpeers":
                    alpha, beta = ph.wait[1], ph.wait[2]
                    want = alpha + beta * ar
                    hit = None
                    for rec in reversed(open_recs):
                        if rec.fam.addr_vec is not None and rec.live and \
                                np.array_equal(rec.fam.addr_vec, want):
                            hit = rec
                            break
                    if hit is None:
                        blocked[gi] = (ph.name, k, int(grp.devs[0]), None)
                        break
                    hit.live = 0
                    refs[hit.uid] += 1
                    instrs.append(("aw", gi, hit.uid, ph.tdelta))
                else:
                    cols = []
                    fail = None
                    done_pend = []
                    for base, kstep in ph.wait[1]:
                        want_addr = base + kstep * k
                        segs, pend = _match_col(
                            open_recs, want_addr, grp.devs, n, cache
                        )
                        if segs is None:
                            fail = (want_addr, pend)
                            break
                        cols.append([
                            (u, share(i), share(r)) for u, i, r in segs
                        ])
                        done_pend.extend(pend)
                    if fail is not None:
                        addr = int(fail[0][fail[1]])
                        blocked[gi] = (
                            ph.name, k, int(grp.devs[fail[1]]), addr
                        )
                        break
                    for rec, rr in done_pend:
                        rec.consumed[rr] = True
                        rec.live -= len(rr)
                    for col in cols:
                        for u, _i, _r in col:
                            refs[u] += 1
                    instrs.append(("w", gi, cols, ph.tdelta))
                open_recs = [r for r in open_recs if r.live]
                cur.advance()
                progress = True
            if not cur.done:
                alldone = False
        if alldone:
            break
        if not progress:
            for gi, b in enumerate(blocked):
                if b is not None and not cursors[gi].done:
                    name, k, dev, addr = b
                    if addr is None:
                        raise _unsupported(
                            f"all-peers wait phase {name!r} (k={k}) of "
                            f"group {groups[gi].name!r} has no matching "
                            "earlier fan-out emission"
                        )
                    w, s = _decode_flag(amap, n, addr)
                    flag = (
                        f"flag (writer {w}, slot {s})" if w is not None
                        else f"flag 0x{addr:x}"
                    )
                    raise _unsupported(
                        f"wait phase {name!r} (k={k}) of group "
                        f"{groups[gi].name!r}: rank {dev} observes {flag} "
                        "with no earlier emission; cross-rank pipelined "
                        "chains stay on the timeline engine"
                    )
            raise _unsupported(
                "no group can advance (cyclic cross-group dependency)"
            )  # pragma: no cover

    if any(f.kind == "fanout_all" for f in fams.values()) and len(fams) > 1:
        raise _unsupported(
            "all-peers fan-out cannot share link ports with other "
            "emission stages"
        )
    _check_flag_reuse(progs, amap, cfg)
    return _TieredPlan(
        ports, groups, instrs, np.array(refs, np.int64)
    )


# ---------------------------------------------------------------------------
# the solver runtime (torch tensors on the cluster's device)
# ---------------------------------------------------------------------------


class _QueuedTotals:
    """The fabric's float64 queued totals, taking their terms in the
    reference's order: ``g_q`` (every stage's and chunk's numpy sum, in turn)
    and ``cls_q`` (per link class: each elementwise-priced touch's queued
    time, and each chunk's numpy sum, in turn).

    Terms wait on the device and are added at :meth:`flush` (when
    :data:`PENDING` touches wait, and at the end): the pending vectors'
    numpy sums in one :func:`numpy_sum` launch, then ``g_q`` and ``cls_q``
    in one ordered scan each.  A term of exactly zero is dropped first:
    every queued time is ``>= 0``, so the totals start and stay ``>= +0.0``,
    and adding zero leaves them unchanged.
    """

    PENDING = 1 << 22

    def __init__(self, dev, n_cls: int):
        self.g = torch.zeros(1, dtype=torch.float64, device=dev)
        self.cls = torch.zeros(n_cls, dtype=torch.float64, device=dev)
        self._cls_ids = torch.arange(n_cls, device=dev)
        self._vecs: List[torch.Tensor] = []   # vectors whose numpy sums are g terms
        self._g: List[object] = []            # int: index into _vecs; tensor: terms
        self._cv: List[torch.Tensor] = []     # cls terms and their classes, in order
        self._ck: List[torch.Tensor] = []
        self._pending = 0

    def add_sum_of(self, q: torch.Tensor, cls: torch.Tensor) -> None:
        """An elementwise pass: ``g_q += q.sum()``, ``np.add.at(cls_q, cls, q)``."""
        self._g.append(len(self._vecs))
        self._vecs.append(q)
        self._cv.append(q)
        self._ck.append(cls)
        self._pending += q.numel()
        if self._pending >= self.PENDING:
            self.flush()

    def add_each(self, qs: torch.Tensor, cls: torch.Tensor) -> None:
        """Chunks already summed: ``g_q += qs[i]``, ``cls_q[cls[i]] += qs[i]``."""
        self._g.append(qs)
        self._cv.append(qs)
        self._ck.append(cls)

    def flush(self) -> None:
        if not self._g:
            return
        if self._vecs:
            offs = np.zeros(len(self._vecs) + 1, np.int64)
            np.cumsum([v.numel() for v in self._vecs], out=offs[1:])
            sums = numpy_sum(torch.cat(self._vecs), torch.as_tensor(offs, device=self.g.device))
        terms = torch.cat([sums[t:t + 1] if isinstance(t, int) else t for t in self._g])
        terms = terms[terms != 0]
        self.g = ordered_total(torch.cat((self.g, terms))[:, None])
        v, k = torch.cat(self._cv), torch.cat([c.long() for c in self._ck])
        keep = v != 0
        v, k = v[keep], k[keep]
        onehot = torch.where(k[:, None] == self._cls_ids, v[:, None], 0.0)
        self.cls = ordered_total(torch.cat((self.cls[None], onehot)))
        self._vecs, self._g, self._cv, self._ck = [], [], [], []
        self._pending = 0


def _chunk_schedule(tprt: torch.Tensor, first: torch.Tensor, P: int):
    """The reference's port wavefront as integer work.

    The wavefront sweeps the ports in ascending id; at each it prices the
    prefix of the port's remaining touches (queue order: ``tprt`` stably
    sorted) whose upstream leg is priced.  A touch is therefore priced in
    sweep ``max(need, sweep of the touch before it in the port's queue)``,
    where ``need`` is its upstream leg's sweep, plus one unless that leg's
    port comes earlier in the sweep.  Iterated from zero, the recurrence
    reaches its least fixpoint, the reference's sweeps.

    Returns ``corder`` (the touches by chunk: sweep-major, port ascending,
    queue order within), the chunks' offsets into it, ports and levels (a
    chunk's level exceeds those of the chunks its ready times and its port's
    busy time come from, so one launch prices a level).
    """
    dev = tprt.device
    L = tprt.numel()
    i64 = torch.int64
    prt = tprt.to(i64)
    tsort = torch.sort(prt, stable=True).indices
    qprt = prt[tsort]
    has_pred = ~first
    pred = torch.where(has_pred, torch.arange(L, device=dev) - 1, 0)
    later = (prt[pred] >= prt).to(i64)
    # the running max within each port's queue: ports ascend in queue order
    # and sweeps stay below L + 2, so port * (L + 2) + sweep never carries a
    # max from one port into the next
    base = qprt * (L + 2)
    sweep = torch.zeros(L, dtype=i64, device=dev)
    for _ in range(L + 1):
        need = torch.where(has_pred, sweep[pred] + later, 0)
        new = torch.empty_like(sweep)
        new[tsort] = torch.cummax(base + need[tsort], 0).values - base
        if torch.equal(new, sweep):
            break
        sweep = new
    else:  # pragma: no cover - leg classes form a DAG
        raise _unsupported("link-port pricing stalled (non-DAG port order)")
    key = sweep * P + prt
    corder = tsort[torch.sort(key[tsort], stable=True).indices]
    ck = key[corder]
    brk = torch.ones(L, dtype=torch.bool, device=dev)
    brk[1:] = ck[1:] != ck[:-1]
    cstart = torch.nonzero(brk).flatten()
    nch = cstart.numel()
    coffs = torch.cat((cstart, torch.tensor([L], device=dev)))
    cport = prt[corder[cstart]]
    cid = torch.empty(L, dtype=i64, device=dev)
    cid[corder] = torch.cumsum(brk.to(i64), 0) - 1
    # the chunk before each on its port (chunks are sweep-major, so a stable
    # sort by port lists each port's chunks in sweep order)
    byport = torch.sort(cport, stable=True).indices
    prevc = torch.full((nch,), -1, dtype=i64, device=dev)
    same = cport[byport[1:]] == cport[byport[:-1]]
    prevc[byport[1:][same]] = byport[:-1][same]
    src_c, dst_c = cid[pred][has_pred], cid[has_pred]
    has_prev = prevc >= 0
    lev = torch.zeros(nch, dtype=i64, device=dev)
    for _ in range(nch + 1):
        new = torch.zeros_like(lev)
        new.scatter_reduce_(0, dst_c, lev[src_c] + 1, "amax")
        new[has_prev] = torch.maximum(new[has_prev], lev[prevc[has_prev]] + 1)
        if torch.equal(new, lev):
            break
        lev = new
    return corder, coffs, cport, lev


def run_tiered(cluster, plan: _TieredPlan, breakdown: Dict[str, float]):
    """Solve the compiled tiered plan on the cluster's device; mutates cluster
    state only in the final write-back (a mid-solve failure falls back to the
    timeline engine cleanly)."""
    t0 = time.perf_counter()
    cfg = cluster.cfg
    dev = cluster.device
    i64, f64 = torch.int64, torch.float64
    n = cfg.n_devices
    clock = cfg.clock_ghz
    poll = cfg.poll_interval_cycles
    check = cfg.flag_check_cycles
    xgmi_lat = cfg.xgmi_enact_latency_ns
    include_dw = cfg.include_data_writes
    fab = cluster.fabric
    ports = plan.ports
    groups = plan.groups
    ar_n = torch.arange(n, device=dev)
    # the divisor of every ns conversion: a device tensor, so the card
    # divides (a host scalar would be turned into a reciprocal multiply)
    clock_t = torch.tensor(clock, dtype=f64, device=dev)
    on_dev: Dict[tuple, torch.Tensor] = {}  # plan arrays, copied once

    def dev_array(a: np.ndarray, dtype=None) -> torch.Tensor:
        t = on_dev.get((id(a), dtype))
        if t is None:
            t = on_dev[(id(a), dtype)] = torch.as_tensor(a, dtype=dtype, device=dev)
        return t

    # fabric state, read in once
    P = ports.P
    port_busy = torch.tensor(
        [fab._busy_until_ns.get(t, 0.0) for t in ports.tuples], dtype=f64, device=dev
    )
    port_used = torch.zeros(P, dtype=torch.bool, device=dev)
    port_cnt = torch.zeros(P, dtype=i64, device=dev)
    port_byt = torch.zeros(P, dtype=i64, device=dev)
    port_qd = torch.zeros(P, dtype=f64, device=dev)
    port_bw = ports.cls_bw[ports.port_cls]
    port_lat = torch.as_tensor(ports.cls_lat[ports.port_cls], device=dev)
    port_cls = torch.as_tensor(ports.port_cls, device=dev)
    ser_of: Dict[int, torch.Tensor] = {}

    def port_ser(nb: int) -> torch.Tensor:
        """Every port's serialization time of ``nb`` bytes, ``nb / bw`` as
        numpy divides it."""
        t = ser_of.get(nb)
        if t is None:
            t = ser_of[nb] = torch.as_tensor(nb / port_bw, device=dev)
        return t

    C = len(ports.cls_names)
    cls_msgs = torch.zeros(C, dtype=i64, device=dev)
    cls_bytes = torch.zeros(C, dtype=i64, device=dev)
    queued = _QueuedTotals(dev, C)
    g_msgs = 0
    g_bytes = 0
    seq_add = 0
    max_set = torch.zeros((), dtype=i64, device=dev)

    # per-rank counters that vary by destination; the group-uniform ones
    # (tdapply's and the source side of account) accumulate as plain ints
    a_xi = torch.zeros(n, dtype=i64, device=dev)
    a_xib = torch.zeros(n, dtype=i64, device=dev)
    a_reg = torch.zeros(n, dtype=i64, device=dev)
    a_marks = torch.zeros(n, dtype=i64, device=dev)
    # per group: nonflag_reads, read_bytes, local_writes, write_bytes,
    # xgmi_writes_out, xgmi_bytes_out
    g_uni = [[0] * 6 for _ in groups]
    devs_t = [dev_array(g.devs) for g in groups]
    counts_t = [dev_array(g.counts) for g in groups]

    T = [torch.as_tensor(g.dispatch, device=dev).repeat(len(g.devs), 1) for g in groups]
    # spin reads: every wait's ticks summed per (rank, cohort); the reads are
    # (ticks + waits) x cohort sizes, summed at the end (integer sums)
    NT = [torch.zeros_like(t) for t in T]
    n_spins = [0] * len(groups)
    sc_store: Dict[int, torch.Tensor] = {}
    refs = plan.refs.copy()

    def spin(gi, V):
        """The interpreter's unified spin closed form over one group's
        cursor matrix (one wait address per rank)."""
        nt = V[:, None] - T[gi]
        nt += poll - 1
        nt = torch.div(nt, poll, rounding_mode="floor")
        nt.clamp_(min=0)
        NT[gi].add_(nt)
        n_spins[gi] += 1
        nt *= poll
        nt += check
        T[gi].add_(nt)

    def tdapply(gi, d):
        if d is None:
            return
        tot = groups[gi].total
        acc = g_uni[gi]
        for i in range(6):
            acc[i] += d[i] * tot

    def price_elem(fam, issue):
        """Leg-by-leg elementwise pricing; valid because no two messages of
        the instance share a port (checked at compile)."""
        nb = fam.nb
        ser_p = port_ser(nb)
        arr = issue.clone()
        for mi, prt, hops, cls in fam.leg_slots:
            mi, prt, cls = (dev_array(a, i64) for a in (mi, prt, cls))
            hops = dev_array(hops, f64)
            rdy = arr[mi]
            st = torch.maximum(rdy, port_busy[prt])
            fin = st + ser_p[prt]
            port_busy[prt] = fin
            port_used[prt] = True
            q = st - rdy
            port_cnt[prt] += 1
            port_byt[prt] += nb
            port_qd[prt] += q
            queued.add_sum_of(q, cls)
            arr[mi] = fin + hops * port_lat[prt]
        return arr

    def price_ordered(fam, issue, E_msg, legs):
        """Port-wavefront pricing in the event engine's global message
        order: the reference's sweeps as integer work
        (:func:`_chunk_schedule`), then each dependency level's chunks in
        one :func:`port_chain` launch and one :func:`numpy_sum` launch."""
        nb = fam.nb
        m = issue.numel()
        msg = legs["msg"].to(i64)
        L = msg.numel()
        tprt, thops = legs["port"].to(i64), legs["hops"]
        if not bool((E_msg == E_msg[0]).all()):
            morder = torch.sort(E_msg, stable=True).indices
            inv = torch.empty(m, dtype=i64, device=dev)
            inv[morder] = torch.arange(m, device=dev)
            tord = torch.sort(inv[msg], stable=True).indices
            msg, tprt, thops = msg[tord], tprt[tord], thops[tord]
        first = torch.ones(L, dtype=torch.bool, device=dev)
        first[1:] = msg[1:] != msg[:-1]
        last = torch.ones(L, dtype=torch.bool, device=dev)
        last[:-1] = first[1:]
        ready = torch.full((L,), float("nan"), dtype=f64, device=dev)
        ready[first] = issue[msg[first]]
        corder, coffs, cport, lev = _chunk_schedule(tprt, first, P)
        ser_p = port_ser(nb)
        clen = coffs[1:] - coffs[:-1]
        qsum = torch.empty(cport.numel(), dtype=f64, device=dev)
        arr_out = torch.empty(m, dtype=f64, device=dev)
        lev_order = torch.sort(lev, stable=True)
        lev_counts = torch.bincount(lev).tolist()
        at = 0
        for cnt in lev_counts:
            cs = lev_order.indices[at:at + cnt]  # the level's chunks, ascending
            at += cnt
            lens = clen[cs]
            offs = torch.zeros(cnt + 1, dtype=i64, device=dev)
            torch.cumsum(lens, 0, out=offs[1:])
            within = torch.arange(int(offs[-1]), device=dev) - torch.repeat_interleave(
                offs[:-1], lens)
            tl = corder[torch.repeat_interleave(coffs[:-1][cs], lens) + within]
            rdy = ready[tl]
            prt = cport[cs]
            starts = port_chain(rdy, offs, prt, ser_p[prt], port_busy, port_qd)
            fin = starts + ser_p[tprt[tl]]
            qsum[cs] = numpy_sum(starts - rdy, offs)
            a = fin + thops[tl].to(f64) * port_lat[tprt[tl]]
            lm = last[tl]
            ready[tl[~lm] + 1] = a[~lm]
            arr_out[msg[tl[lm]]] = a[lm]
        pc = torch.bincount(tprt, minlength=P)
        port_cnt.add_(pc)
        port_byt.add_(pc * nb)
        port_used.logical_or_(pc > 0)
        queued.add_each(qsum, port_cls[cport])
        return arr_out

    def account(fam, nmsg_per_rank, gi):
        nonlocal seq_add, g_msgs, g_bytes
        dw = fam.dw if include_dw and fam.dw > 0 else 0
        regs = 1 + dw
        g_uni[gi][4] += nmsg_per_rank
        g_uni[gi][5] += nmsg_per_rank * fam.size
        if fam.kind == "fanout_all":
            a_xi.add_(nmsg_per_rank * regs)
            a_xib.add_(nmsg_per_rank * (fam.size + 8 * dw))
            a_reg.add_(nmsg_per_rank * regs)
            if dw:
                a_marks.add_(nmsg_per_rank * dw)
        else:
            dst = dev_array(fam.dst, i64)
            one = torch.ones(dst.numel(), dtype=i64, device=dev)
            a_xi.index_add_(0, dst, one, alpha=regs)
            a_xib.index_add_(0, dst, one, alpha=fam.size + 8 * dw)
            a_reg.index_add_(0, dst, one, alpha=regs)
            if dw:
                a_marks.index_add_(0, dst, one, alpha=dw)
        seq_add += fam.m * regs
        g_msgs += fam.m
        g_bytes += fam.m * fam.nb

    def set_cycles(arr, Ef, src):
        nonlocal max_set
        minns = ((Ef + 1.0) / clock_t)[src]
        wake = arr + xgmi_lat
        wake = torch.maximum(wake, minns)
        sc = torch.round(wake * clock).to(i64)
        max_set = torch.maximum(max_set, sc.max())
        return sc

    def emit_family(fam, uid):
        gi = fam.gi
        Ef = T[gi].max(dim=1).values.to(f64)
        src = dev_array(fam.src_row, i64)
        issue = (Ef / clock_t)[src]
        if fam.pricing == "elem":
            arr = price_elem(fam, issue)
        else:
            legs = {k: dev_array(v) for k, v in fam.legs.items()}
            arr = price_ordered(fam, issue, T[gi].max(dim=1).values[src], legs)
        sc = set_cycles(arr, Ef, src)
        if refs[uid] > 0:
            sc_store[uid] = sc
        account(fam, fam.cnt, gi)
        cl = dev_array(fam.cls_legs)
        cls_msgs.add_(cl)
        cls_bytes.add_(cl * fam.nb)

    def emit_fanout(fam, uid):
        gi = fam.gi
        E = T[gi].max(dim=1).values
        Ef = E.to(f64)
        src = torch.repeat_interleave(ar_n, n - 1)
        dstm = torch.arange(n - 1, device=dev).repeat(n, 1)
        dstm += dstm >= ar_n[:, None]
        dst = dstm.flatten()
        legs = _legs_csr(ports, src, dst)
        _spot_check(ports, fab, src, dst, legs)
        arr = price_ordered(fam, (Ef / clock_t)[src], E[src], legs)
        sc = set_cycles(arr, Ef, src)
        if refs[uid] > 0:
            M = torch.zeros((n, n), dtype=i64, device=dev)
            M[src, dst] = sc
            sc_store[uid] = M
        account(fam, n - 1, gi)  # the fan-out's group is every rank
        cl = torch.bincount(legs["cls"], minlength=C)
        cls_msgs.add_(cl)
        cls_bytes.add_(cl * fam.nb)

    for ins in plan.instrs:
        tag = ins[0]
        if tag == "p":
            _, gi, dur, td, fam, uid, _k = ins
            if dur:
                T[gi] += dur
            if fam is not None:
                if fam.kind == "fanout_all":
                    emit_fanout(fam, uid)
                else:
                    emit_family(fam, uid)
            tdapply(gi, td)
        elif tag == "w":
            _, gi, cols, td = ins
            g = len(groups[gi].devs)
            for col in cols:
                V = torch.empty(g, dtype=i64, device=dev)
                for uid, idx, rows in col:
                    V[dev_array(idx, i64)] = sc_store[uid][dev_array(rows, i64)]
                    refs[uid] -= 1
                    if refs[uid] == 0:
                        del sc_store[uid]
                spin(gi, V)
            tdapply(gi, td)
        else:  # "aw"
            _, gi, uid, td = ins
            M = sc_store[uid]
            # writer j for the ranks above it, j + 1 for the rest: the
            # reference's M[where(ar > j, j, j + 1), ar], row by row
            for j in range(n - 1):
                spin(gi, torch.cat((M[j + 1, :j + 1], M[j, j + 1:])))
            refs[uid] -= 1
            if refs[uid] == 0:
                del sc_store[uid]
            tdapply(gi, td)

    queued.flush()
    kend = torch.zeros(n, dtype=i64, device=dev)
    a_fr = torch.zeros(n, dtype=i64, device=dev)
    for gi, grp in enumerate(groups):
        kend[devs_t[gi]] = T[gi].max(dim=1).values
        a_fr[devs_t[gi]] = (NT[gi] * counts_t[gi]).sum(dim=1) + n_spins[gi] * grp.total
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    solve_done = time.perf_counter()

    # ---- write-back: the device's state read once -----------------------
    kend_h, fr_h = kend.tolist(), a_fr.tolist()
    xi_h, xib_h, reg_h, marks_h = (t.tolist() for t in (a_xi, a_xib, a_reg, a_marks))
    uni = [[0] * 6 for _ in range(n)]
    for gi, grp in enumerate(groups):
        for r in grp.devs.tolist():
            uni[r] = g_uni[gi]
    sim_cycles = max(max(kend_h), int(max_set))
    for r, node in enumerate(cluster.nodes):
        u = uni[r]
        t = node.memory.traffic
        t.flag_reads += fr_h[r]
        t.nonflag_reads += u[0]
        t.read_bytes += 8 * fr_h[r] + u[1]
        t.local_writes += u[2]
        t.write_bytes += u[3]
        t.xgmi_writes_out += u[4]
        t.xgmi_bytes_out += u[5]
        t.xgmi_writes_in += xi_h[r]
        t.xgmi_bytes_in += xib_h[r]
        tgt = node.target
        tgt.done_count = tgt.n_wgs
        tgt.kernel_end_cycle = kend_h[r]
        ws = node.wtt.stats
        ws.registered += reg_h[r]
        ws.enacted += reg_h[r]
        if marks_h[r]:
            cluster._data_marks[r] = cluster._data_marks.get(r, 0) + marks_h[r]
    cluster._seq += seq_add
    st = fab.stats
    st["messages"] += g_msgs
    st["bytes"] += g_bytes
    st["queued_ns"] += float(queued.g)
    cls_msgs_h, cls_bytes_h = cls_msgs.tolist(), cls_bytes.tolist()
    cls_q_h = queued.cls.tolist()
    for ci, cname in enumerate(ports.cls_names):
        if cls_msgs_h[ci]:
            st[f"{cname}_messages"] = st.get(f"{cname}_messages", 0) + cls_msgs_h[ci]
            st[f"{cname}_bytes"] = st.get(f"{cname}_bytes", 0) + cls_bytes_h[ci]
            st[f"{cname}_queued_ns"] = st.get(f"{cname}_queued_ns", 0.0) + cls_q_h[ci]
    used_h = port_used.tolist()
    busy_h, cnt_h, byt_h, qd_h = (t.tolist() for t in (port_busy, port_cnt, port_byt, port_qd))
    for p in range(P):
        if not used_h[p]:
            continue
        port = ports.tuples[p]
        fab._busy_until_ns[port] = busy_h[p]
        ps = fab.port_stats.get(port)
        if ps is None:
            ps = fab.port_stats[port] = [0, 0, 0.0]
        ps[0] += cnt_h[p]
        ps[1] += byt_h[p]
        ps[2] += qd_h[p]
    run_wall = time.perf_counter() - t0
    breakdown.update(
        solve_s=solve_done - t0,
        writeback_s=run_wall - (solve_done - t0),
    )
    return EngineResult(
        sim_cycles=sim_cycles,
        wall_time_s=run_wall + breakdown.get("compile_s", 0.0),
        head_polls=0,
        breakdown=breakdown,
    )
