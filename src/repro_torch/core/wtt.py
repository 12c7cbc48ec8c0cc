"""Write Tracking Table (WTT) (port of ``repro/core/wtt.py``).

The WTT is the paper's core simulator-side data structure (§3.1): a priority
queue of registered writes sorted by ``wakeupTime``.  The detailed engine polls
the head every simulated cycle; when current time reaches the head's wakeup
time, *all* entries sharing that timestamp are popped and enacted as xGMI
writes.  Registration order is arbitrary; pops are strictly chronological with
this table's own registration counter as a deterministic tie-break (write
``seq`` numbers are producer-local and may collide across producers).

Timestamps are registered in nanoseconds (as in the pseudo-op) and converted to
cycles with the device clock, exactly as the paper describes ("these timestamps
are converted into cycles based on the device clock frequency defined in the
gem5 configuration").
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

from .events import RegisteredWrite, TraceBundle

__all__ = ["WriteTrackingTable", "WTTStats", "LazyWriteRun"]


@dataclass
class WTTStats:
    registered: int = 0
    enacted: int = 0
    max_pending: int = 0
    head_polls: int = 0  # number of O(1) head comparisons performed


@dataclass(frozen=True)
class LazyWriteRun:
    """A compact descriptor for an arithmetic run of registered writes.

    The closed-loop incast registers O(devices^2) *marker* writes per run —
    every one of them on the same arithmetic grid: member ``k`` wakes at
    ``base_ns + span_ns * (k + 1) / (count + 1)`` (clamped to ``min_ns``,
    the emission-causality floor) and lands at ``addr_base + k *
    addr_stride`` with identical data/size/src and consecutive ``seq``
    numbers.  Registering one descriptor instead of ``count`` dataclasses
    keeps registration O(1) in the run length; the table synthesizes each
    :class:`RegisteredWrite` only when simulated time actually reaches it.

    Synthesis is bit-identical to materialized registration: the wakeup
    expression is evaluated with exactly the float arithmetic the eager
    builder used (same rounding into cycles), member cycles are
    non-decreasing in ``k`` (the clamp preserves monotonicity), and the
    run's members occupy a *contiguous* block of the owning table's
    registration counter — so ``(cycle, reg_no)`` pop order, the heap
    tie-break, and mid-run interleaving with ordinary writes are all exactly
    what ``count`` sequential registrations would have produced (property-
    tested in the reference's ``tests/test_timeline.py``).
    """

    count: int
    base_ns: float
    span_ns: float
    addr_base: int
    addr_stride: int
    data: int
    size: int = 8
    src: int = -1
    seq0: int = 0
    min_ns: float = 0.0

    def __post_init__(self) -> None:
        if self.count < 1:
            raise ValueError("LazyWriteRun.count must be >= 1")
        if self.span_ns < 0:
            raise ValueError("LazyWriteRun.span_ns must be >= 0")

    def wakeup_ns(self, k: int) -> float:
        # the exact expression (and float evaluation order) of the eager
        # marker builder in Cluster._emit_writes — cycle rounding must agree
        t = self.base_ns + self.span_ns * (k + 1) / (self.count + 1)
        return t if t >= self.min_ns else self.min_ns

    def materialize(self, k: int) -> RegisteredWrite:
        if not (0 <= k < self.count):
            raise IndexError(f"run member {k} out of range [0, {self.count})")
        # hot path: member fields are valid by construction (the descriptor
        # is built from an already-validated eager write recipe), so skip the
        # frozen-dataclass __init__/__post_init__ re-validation
        t = self.base_ns + self.span_ns * (k + 1) / (self.count + 1)
        if t < self.min_ns:
            t = self.min_ns
        w = RegisteredWrite.__new__(RegisteredWrite)
        w.__dict__.update(
            wakeup_ns=t,
            addr=self.addr_base + k * self.addr_stride,
            data=self.data,
            size=self.size,
            src=self.src,
            seq=self.seq0 + k,
        )
        return w


class _RunCursor:
    """Mutable heap payload: ``run`` with members ``k..count-1`` pending."""

    __slots__ = ("run", "k")

    def __init__(self, run: LazyWriteRun, k: int = 0):
        self.run = run
        self.k = k


RegistrationLike = Union[RegisteredWrite, LazyWriteRun]


class WriteTrackingTable:
    """Priority queue of pending emulated writes, keyed by wakeup cycle."""

    def __init__(self, clock_ghz: float = 1.5):
        if clock_ghz <= 0:
            raise ValueError("clock_ghz must be positive")
        self.clock_ghz = float(clock_ghz)
        # Heap entries: (wakeup_cycle, registration_no, RegisteredWrite).
        # The tie-break is this table's OWN monotonic registration counter,
        # not the write's ``seq``: seqs are only unique within one producer
        # (trace bundles and a Cluster's emission counter both start at 0),
        # so a warm-started closed loop can hold two same-cycle writes with
        # equal seqs — and RegisteredWrite is unorderable, which would make
        # heapq fall through to comparing the writes and raise TypeError.
        # For every single-producer table (all pre-cohort callers) writes are
        # registered in seq order, so pop order is unchanged.
        # Payloads are RegisteredWrite or _RunCursor (a LazyWriteRun with a
        # next-member index); a cursor stands for its remaining members, each
        # synthesized on pop at its own (cycle, reg_no) key.
        self._heap: List[Tuple[int, int, object]] = []
        self._next_reg = 0
        # logical pending count minus heap entries: a cursor covering m
        # remaining members contributes m - 1 here
        self._extra = 0
        self.stats = WTTStats()
        # Optional engine hook: called with the wakeup cycle of every newly
        # registered write, so a global event calendar can track cross-device
        # registrations without rescanning each table per event.
        self.on_register: Optional[Callable[[int], None]] = None

    # -- time conversion -----------------------------------------------------

    def ns_to_cycles(self, ns: float) -> int:
        return int(round(ns * self.clock_ghz))

    def cycles_to_ns(self, cycles: int) -> float:
        return cycles / self.clock_ghz

    # -- registration --------------------------------------------------------

    def register(self, write: RegisteredWrite) -> None:
        cyc = self.ns_to_cycles(write.wakeup_ns)
        heapq.heappush(self._heap, (cyc, self._next_reg, write))
        self._next_reg += 1
        self.stats.registered += 1
        self.stats.max_pending = max(self.stats.max_pending, len(self))
        if self.on_register is not None:
            self.on_register(cyc)

    def register_run(self, run: LazyWriteRun) -> None:
        """Register a :class:`LazyWriteRun` descriptor — O(log n), not O(count).

        Reserves a contiguous ``count``-wide block of the registration
        counter so the synthesized members pop exactly where ``count``
        sequential :meth:`register` calls would have placed them.
        """
        reg0 = self._next_reg
        self._next_reg = reg0 + run.count
        cyc = self.ns_to_cycles(run.wakeup_ns(0))
        heapq.heappush(self._heap, (cyc, reg0, _RunCursor(run, 0)))
        self._extra += run.count - 1
        self.stats.registered += run.count
        self.stats.max_pending = max(self.stats.max_pending, len(self))
        if self.on_register is not None:
            self.on_register(cyc)

    def register_many(self, writes: Sequence[RegistrationLike]) -> None:
        """Register a batch of writes with one heap restructure.

        Bit-identical to calling :meth:`register` once per write in order —
        heap pops are fully determined by the sorted ``(cycle, reg_no)`` keys,
        and batch reg_nos are assigned in the same order the sequential calls
        would have used — but the heap invariant is restored once per batch
        (``heapify``, O(n)) instead of once per write (``heappush``,
        O(log n) each), and the engine's ``on_register`` calendar hook fires
        once with the batch's earliest wakeup cycle instead of per write
        (sufficient: after every calendar pop the engine re-reads the table's
        actual head).  This is the closed-loop incast lever: an ``all_to_all``
        dispatch completion lands O(devices) marker+flag bursts per peer —
        O(devices^2) registrations per run — previously each paying its own
        push and hook call.

        Items may be plain :class:`RegisteredWrite`\\ s or
        :class:`LazyWriteRun` descriptors, freely mixed; a descriptor costs
        one heap entry regardless of its ``count`` (see :meth:`register_run`).
        """
        heap = self._heap
        n2c = self.ns_to_cycles
        reg = self._next_reg
        entries: List[Tuple[int, int, object]] = []
        logical = 0
        mn = None
        for item in writes:
            if type(item) is LazyWriteRun:
                c = n2c(item.wakeup_ns(0))
                entries.append((c, reg, _RunCursor(item, 0)))
                reg += item.count
                logical += item.count
            else:
                c = n2c(item.wakeup_ns)
                entries.append((c, reg, item))
                reg += 1
                logical += 1
            if mn is None or c < mn:
                mn = c
        if not entries:
            return
        self._next_reg = reg
        self._extra += logical - len(entries)
        # a few pushes into a big heap beat re-heapifying the whole heap
        if len(entries) * 8 < len(heap):
            for e in entries:
                heapq.heappush(heap, e)
        else:
            heap.extend(entries)
            heapq.heapify(heap)
        self.stats.registered += logical
        self.stats.max_pending = max(self.stats.max_pending, len(self))
        if self.on_register is not None:
            self.on_register(mn)

    def register_bundle(self, bundle: TraceBundle) -> None:
        for w in bundle:
            self.register(w)

    # -- queries -------------------------------------------------------------

    def __len__(self) -> int:
        # logical pending count: run cursors count their remaining members
        return len(self._heap) + self._extra

    @property
    def empty(self) -> bool:
        return not self._heap

    def _pop_head(self) -> RegisteredWrite:
        """Pop one logical write, synthesizing run members on demand.

        When the head is a run cursor, member ``k`` is materialized and the
        cursor is re-pushed at member ``k + 1``'s (cycle, reg_no) key — so
        ordinary writes and other runs landing between two members interleave
        exactly as they would against materialized registrations.
        """
        heap = self._heap
        cyc, reg, payload = heapq.heappop(heap)
        if type(payload) is not _RunCursor:
            return payload  # type: ignore[return-value]
        run = payload.run
        k = payload.k
        nk = k + 1
        if nk < run.count:
            payload.k = nk
            heapq.heappush(
                heap, (self.ns_to_cycles(run.wakeup_ns(nk)), reg + 1, payload)
            )
            self._extra -= 1
        return run.materialize(k)

    def pop_due_run(
        self, stop_cycle: Optional[int] = None
    ) -> Optional[Tuple[List[int], List[int], int, int]]:
        """Bulk-pop the maximal due prefix of a head run cursor.

        Returns ``(cycles, addrs, data, size)`` — parallel cycle/address
        lists plus the run's shared payload word — or ``None`` when the
        table is empty or the head is a plain write.  Members are synthesized
        while their ``(cycle, reg_no)`` key stays strictly ahead of every
        other heap entry and their cycle does not exceed ``stop_cycle``
        (``None`` = unbounded) — i.e. exactly the writes that consecutive
        :meth:`pop_next_group` calls would have yielded next, without the
        per-member heap pop/push round trip or per-member RegisteredWrite
        construction (every member of a run carries the same data/size, so
        the enactor splits the payload into bytes once per batch).  The
        timeline engine uses this to drain marker runs in one call; pop
        order (and therefore enactment order) is unchanged.
        """
        heap = self._heap
        if not heap:
            return None
        cyc, reg, payload = heap[0]
        if type(payload) is not _RunCursor:
            return None
        heapq.heappop(heap)
        nxt = heap[0] if heap else None
        run = payload.run
        k = payload.k
        count = run.count
        n2c = self.ns_to_cycles
        # member wakeup math inlined from LazyWriteRun.wakeup_ns (hot loop)
        base = run.base_ns
        span = run.span_ns
        mn = run.min_ns
        cnt1 = count + 1
        addr = run.addr_base
        stride = run.addr_stride
        cycles = [cyc]
        addrs = [addr + k * stride]
        k += 1
        while k < count:
            t = base + span * (k + 1) / cnt1
            if t < mn:
                t = mn
            cyc = n2c(t)
            reg += 1
            if stop_cycle is not None and cyc > stop_cycle:
                break
            if nxt is not None and (
                nxt[0] < cyc or (nxt[0] == cyc and nxt[1] < reg)
            ):
                break
            cycles.append(cyc)
            addrs.append(addr + k * stride)
            k += 1
        j = len(addrs)
        if k < count:
            payload.k = k
            heapq.heappush(heap, (cyc, reg, payload))
            self._extra -= j
        else:
            self._extra -= j - 1
        self.stats.enacted += j
        return cycles, addrs, run.data, run.size

    def peek_wakeup_cycle(self) -> Optional[int]:
        """Wakeup cycle of the head entry, or None if empty.  O(1)."""
        if not self._heap:
            return None
        return self._heap[0][0]

    # -- the per-cycle poll ---------------------------------------------------

    def poll(self, now_cycle: int) -> List[RegisteredWrite]:
        """The paper's per-cycle head check.

        Returns the (possibly empty) list of writes due at ``now_cycle``.
        In the common case the head lies in the future and this is a single
        comparison.  When due, all head entries with wakeup <= now are popped
        in (wakeup, seq) order.  Popping *everything* <= now (rather than == now
        only) makes the engine robust to coarse stepping, while remaining
        identical to the paper's behaviour under per-cycle stepping.
        """
        self.stats.head_polls += 1
        if not self._heap or self._heap[0][0] > now_cycle:
            return []
        due: List[RegisteredWrite] = []
        while self._heap and self._heap[0][0] <= now_cycle:
            due.append(self._pop_head())
        self.stats.enacted += len(due)
        return due

    def pop_next_group(self) -> Tuple[Optional[int], List[RegisteredWrite]]:
        """Event-queue mode: pop the next timestamp group without polling.

        Returns ``(wakeup_cycle, writes)`` for the earliest pending timestamp,
        or ``(None, [])`` if empty.  Used by the event-driven engine (the
        paper's §3.2.2 proposed design) and by the vectorized engine.
        """
        if not self._heap:
            return None, []
        cyc = self._heap[0][0]
        group: List[RegisteredWrite] = []
        while self._heap and self._heap[0][0] == cyc:
            group.append(self._pop_head())
        self.stats.enacted += len(group)
        return cyc, group

    # -- inspection (the paper highlights WTT debuggability) ------------------

    def pending(self) -> List[RegisteredWrite]:
        """All pending writes in chronological order (non-destructive).

        Run cursors are expanded to their remaining members at each member's
        own (cycle, reg_no) key before sorting, so the listing matches the
        exact pop order.
        """
        items: List[Tuple[int, int, RegisteredWrite]] = []
        for cyc, reg, payload in self._heap:
            if type(payload) is _RunCursor:
                run, k = payload.run, payload.k
                for j in range(k, run.count):
                    items.append(
                        (
                            self.ns_to_cycles(run.wakeup_ns(j)),
                            reg + (j - k),
                            run.materialize(j),
                        )
                    )
            else:
                items.append((cyc, reg, payload))
        items.sort(key=lambda e: (e[0], e[1]))
        return [w for _, _, w in items]
