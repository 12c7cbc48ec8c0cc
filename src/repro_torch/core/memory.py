"""Directory memory model with flag-region traffic accounting (port of
``repro/core/memory.py``).

The paper models inter-GPU synchronization flags as *non-cacheable* memory:
peer writes complete atomically at the target GPU's cache directory, and local
polling reads always observe the latest value (§2.2).  This is that contract,
a flat byte-addressed space with a designated flag region where enacted peer
writes are serialized against polling reads, without L1/L2 structure (the
paper's measured quantities never depend on it).

Traffic accounting follows the paper's Figures 6/9: every read is a *flag
read* (spin-wait / monitor-validation traffic) or a *non-flag read* (matrix
sectors, vector, partial tiles).  :class:`AddressMap` keeps the reference's
bases and fields, which ``core/capture.py`` reads to address its traces.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

from .events import RegisteredWrite

__all__ = ["AddressMap", "DirectoryMemory", "TrafficCounters"]

LINE_BYTES = 64  # coherence line size used for Monitor Log line addresses


@dataclass(frozen=True)
class AddressMap:
    """Layout of the target device's simulated address space.

    Mirrors a rocSHMEM-style symmetric heap: every participating device sees
    the same layout, so flag addresses computed on one device are valid pointers
    on its peers (§2.2: "allocates a single symmetric heap across all
    participating GPUs ... ensures a uniform address layout").

    Regions (byte offsets, half-open):
      [flag_base, flag_base + flag_slots*n_devices*flag_stride)  flag variables
      [partial_base, ...)                              peer partial-tile buffers
      [data_base, ...)                                 everything else

    ``flag_slots`` generalises the single ``flags[src]`` array of the fused
    GEMV+AllReduce kernel to scenarios that synchronise more than once per
    peer (e.g. one flag per ring step, or per pipeline microbatch): slot ``s``
    is a second index into the flag region, and ``flag_addr(src)`` with the
    default slot 0 is byte-identical to the original layout.
    """

    flag_base: int = 0x3F_D004_F00
    flag_stride: int = LINE_BYTES  # padded flags to prevent false sharing
    n_devices: int = 4
    flag_slots: int = 1
    flags_share_line: bool = False  # paper Fig. 7 shows both layouts exist
    partial_base: int = 0x3F_E000_000
    data_base: int = 0x100_000

    def claim_flag_block(self, label: str, slot_lo: int, slot_hi: int) -> None:
        """Claim slots ``[slot_lo, slot_hi)`` across *all* devices.

        Equivalent to ``claim_flag_slots(label, ((d, s) for d in
        range(n_devices) for s in range(slot_lo, slot_hi)))`` but recorded as
        a slot interval, so pod-scale scenarios (devices × slots in the
        millions) pay O(#claims) for the collision guarantee instead of
        O(devices × slots).
        """
        if not (0 <= slot_lo <= slot_hi <= self.flag_slots):
            raise ValueError(
                f"flag-slot claim {label!r}: slot range [{slot_lo}, "
                f"{slot_hi}) out of range (flag_slots={self.flag_slots})"
            )
        blocks = self.__dict__.get("_slot_blocks")
        if blocks is None:
            # the dataclass is frozen; the claim registry is bookkeeping, not
            # layout state, so it lives outside the declared fields
            blocks = []
            object.__setattr__(self, "_slot_blocks", blocks)
        for lo, hi, owner in blocks:
            if owner != label and slot_lo < hi and lo < slot_hi:
                raise ValueError(
                    f"flag slot collision: slots [{max(slot_lo, lo)}, "
                    f"{min(slot_hi, hi)}) already allocated to {owner!r}, "
                    f"now claimed by {label!r} — give each synchronization "
                    "stage its own slot range"
                )
        claims = self.__dict__.get("_slot_claims")
        if claims:
            for (device, slot), owner in claims.items():
                if owner != label and slot_lo <= slot < slot_hi:
                    raise ValueError(
                        f"flag slot collision: (device={device}, "
                        f"slot={slot}) already allocated to {owner!r}, now "
                        f"claimed by {label!r} — give each synchronization "
                        "stage its own slot range"
                    )
        blocks.append((slot_lo, slot_hi, label))

    def claim_flag_slots(self, label: str, pairs) -> None:
        """Register ``(device, slot)`` flag allocations under ``label``.

        Scenario builders call this for every slot range they lay out, so a
        collision — two different allocation sites landing on the same
        ``(device, slot)`` — fails loudly at scenario-construction time with
        both owners named, instead of surfacing as confusing runtime behavior
        (a flag satisfied by the wrong stage).  Re-claiming a pair under the
        same label is idempotent (builders may run per rank).  Full-device ×
        slot-interval claims should prefer :meth:`claim_flag_block`, which
        records an interval instead of one entry per pair.
        """
        claims = self.__dict__.get("_slot_claims")
        if claims is None:
            claims = {}
            object.__setattr__(self, "_slot_claims", claims)
        new = dict.fromkeys(pairs, label)  # C-speed dedup of the pair stream
        nd = self.n_devices
        ns = self.flag_slots
        for device, slot in new:
            if not (0 <= device < nd):
                raise ValueError(
                    f"flag-slot claim {label!r}: device {device} out of "
                    f"range for {nd} devices"
                )
            if not (0 <= slot < ns):
                raise ValueError(
                    f"flag-slot claim {label!r}: slot {slot} out of range "
                    f"(flag_slots={ns})"
                )
        blocks = self.__dict__.get("_slot_blocks")
        if blocks:
            for lo, hi, owner in blocks:
                if owner == label:
                    continue
                for device, slot in new:
                    if lo <= slot < hi:
                        raise ValueError(
                            f"flag slot collision: (device={device}, "
                            f"slot={slot}) already allocated to {owner!r}, "
                            f"now claimed by {label!r} — give each "
                            "synchronization stage its own slot range"
                        )
        if claims:
            for key in new.keys() & claims.keys():
                owner = claims[key]
                if owner != label:
                    device, slot = key
                    raise ValueError(
                        f"flag slot collision: (device={device}, "
                        f"slot={slot}) already allocated to {owner!r}, now "
                        f"claimed by {label!r} — give each synchronization "
                        "stage its own slot range"
                    )
        claims.update(new)

    def flag_addr(self, src_device: int, slot: int = 0) -> int:
        """Address of ``flags[slot][src_device]`` in the target's memory."""
        if not (0 <= src_device < self.n_devices):
            raise ValueError(f"device {src_device} out of range")
        if not (0 <= slot < self.flag_slots):
            raise ValueError(f"flag slot {slot} out of range")
        idx = slot * self.n_devices + src_device
        if self.flags_share_line:
            # 8-byte flags packed into one line (monitor-mask exercise)
            return self.flag_base + 8 * idx
        return self.flag_base + self.flag_stride * idx

    def flag_linear(self) -> Tuple[int, int]:
        """``(base, unit)`` of the flag pool's linear address form.

        ``flag_addr(src, slot) == base + unit * (slot * n_devices + src)``
        for every in-range pair — the affine family the parametric layout
        prover of ``repro.analysis.layout`` reasons over without
        enumerating slots.  ``unit`` is the per-flag pitch (8 bytes when
        flags share a line, else ``flag_stride``).
        """
        unit = 8 if self.flags_share_line else self.flag_stride
        return (self.flag_base, unit)

    def flag_region(self) -> Tuple[int, int]:
        n_flags = self.n_devices * self.flag_slots
        if self.flags_share_line:
            hi = self.flag_base + 8 * n_flags
        else:
            hi = self.flag_base + self.flag_stride * n_flags
        return (self.flag_base, hi)

    def is_flag(self, addr: int) -> bool:
        lo, hi = self.flag_region()
        return lo <= addr < hi

    def decode_flag(self, addr: int) -> Optional[Tuple[int, int]]:
        """Inverse of :meth:`flag_addr`: ``(src_device, slot)`` or ``None``.

        Returns ``None`` for addresses outside the flag region or not aligned
        to a flag base (diagnostics must not misattribute stray addresses).
        """
        lo, hi = self.flag_region()
        if not (lo <= addr < hi):
            return None
        stride = 8 if self.flags_share_line else self.flag_stride
        off = addr - self.flag_base
        if off % stride:
            return None
        idx = off // stride
        return (idx % self.n_devices, idx // self.n_devices)

    def line_of(self, addr: int) -> int:
        return addr & ~(LINE_BYTES - 1)

    def with_partial_clearance(self) -> "AddressMap":
        """Return a map whose partial-tile region starts above the flag
        region.

        The default bases leave ~16 MB between ``flag_base`` and
        ``partial_base``; a pod-scale flag pool (``flag_slots * n_devices *
        flag_stride`` bytes) can overrun that gap, and data-marker writes —
        allocated upward from ``partial_base`` — then *alias high flag
        slots*, so a stale marker satisfies a flag wait long before the
        real emission arrives.  Scenarios with per-step flag slots must
        call this when constructing their map so the two regions never
        overlap.  A no-op (returns ``self``) when the gap already clears.
        """
        hi = self.flag_region()[1]
        if hi <= self.partial_base:
            return self
        page = 0x1000
        bumped = (hi + page - 1) // page * page
        return replace(self, partial_base=bumped)


@dataclass
class TrafficCounters:
    """Read/write accounting in the categories the paper reports."""

    flag_reads: int = 0
    nonflag_reads: int = 0
    local_writes: int = 0
    xgmi_writes_in: int = 0   # peer writes enacted at this device's directory
    xgmi_writes_out: int = 0  # writes this device issued to peers
    xgmi_bytes_in: int = 0
    xgmi_bytes_out: int = 0
    read_bytes: int = 0
    write_bytes: int = 0

    @property
    def total_reads(self) -> int:
        return self.flag_reads + self.nonflag_reads

    def as_dict(self) -> Dict[str, int]:
        return {
            "flag_reads": self.flag_reads,
            "nonflag_reads": self.nonflag_reads,
            "total_reads": self.total_reads,
            "local_writes": self.local_writes,
            "xgmi_writes_in": self.xgmi_writes_in,
            "xgmi_writes_out": self.xgmi_writes_out,
            "xgmi_bytes_in": self.xgmi_bytes_in,
            "xgmi_bytes_out": self.xgmi_bytes_out,
            "read_bytes": self.read_bytes,
            "write_bytes": self.write_bytes,
        }


class DirectoryMemory:
    """Flat memory + directory semantics for the detailed target device."""

    def __init__(self, amap: AddressMap):
        self.amap = amap
        self._mem: Dict[int, int] = {}  # byte address -> byte value
        self.traffic = TrafficCounters()
        # Observers called on every enacted peer write (the Monitor Log hooks
        # here: "each memory write that completes at the cache directory is
        # compared against the entries in the Monitor Log").
        self._write_observers: List[Callable[[int, int, int, int], None]] = []

    # -- observer registration ------------------------------------------------

    def add_write_observer(self, fn: Callable[[int, int, int, int], None]) -> None:
        """fn(addr, data, size, cycle) called after each directory write."""
        self._write_observers.append(fn)

    # -- raw value plumbing ----------------------------------------------------

    def _store(self, addr: int, data: int, size: int) -> None:
        mem = self._mem
        try:
            # int.to_bytes does the little-endian byte split in C
            bts = data.to_bytes(size, "little")
        except OverflowError:  # negative or wider than size: masked split
            for i in range(size):
                mem[addr + i] = (data >> (8 * i)) & 0xFF
            return
        for i, b in enumerate(bts):
            mem[addr + i] = b

    def _load(self, addr: int, size: int) -> int:
        val = 0
        for i in range(size):
            val |= self._mem.get(addr + i, 0) << (8 * i)
        return val

    # -- the architectural operations ------------------------------------------

    def read(self, addr: int, size: int = 4, *, count: bool = True) -> int:
        """A read issued by the detailed device (polling or data)."""
        val = self._load(addr, size)
        if count:
            if self.amap.is_flag(addr):
                self.traffic.flag_reads += 1
            else:
                self.traffic.nonflag_reads += 1
            self.traffic.read_bytes += size
        return val

    def bulk_reads(self, n: int, *, bytes_each: int, flag: bool = False) -> None:
        """Account ``n`` homogeneous reads without simulating each one.

        Used by the closed-form phases of the workload model (matrix sector
        streaming), where per-request simulation adds nothing the paper
        measures.  Counts are identical to issuing ``read`` n times.
        """
        if flag:
            self.traffic.flag_reads += n
        else:
            self.traffic.nonflag_reads += n
        self.traffic.read_bytes += n * bytes_each

    def write_local(self, addr: int, data: int, size: int = 4) -> None:
        self._store(addr, data, size)
        self.traffic.local_writes += 1
        self.traffic.write_bytes += size

    def bulk_local_writes(self, n: int, *, bytes_each: int) -> None:
        self.traffic.local_writes += n
        self.traffic.write_bytes += n * bytes_each

    def issue_xgmi_out(self, n: int, *, bytes_each: int) -> None:
        """Writes the detailed device pushes to a peer (partials, flags)."""
        self.traffic.xgmi_writes_out += n
        self.traffic.xgmi_bytes_out += n * bytes_each

    def enact_xgmi_write(self, w: RegisteredWrite, cycle: int) -> None:
        """Enact a registered peer write at the directory (atomic).

        This is the WTT -> memory handoff of §3.1: 'the write transaction
        completes at the cache directory level ... the memory state of the
        receiving GPU is updated to reflect the new flag value'.
        """
        self._store(w.addr, w.data, w.size)
        self.traffic.xgmi_writes_in += 1
        self.traffic.xgmi_bytes_in += w.size
        for fn in self._write_observers:
            fn(w.addr, w.data, w.size, cycle)

    def enact_xgmi_group(
        self, group: List[RegisteredWrite], cycle: int
    ) -> None:
        """Enact one WTT timestamp group: identical to calling
        :meth:`enact_xgmi_write` per write in order, with the counter adds
        coalesced (store order and observer order are preserved)."""
        mem = self._mem
        obs = self._write_observers
        nbytes = 0
        for w in group:
            data = w.data
            size = w.size
            addr = w.addr
            try:
                bts = data.to_bytes(size, "little")
            except OverflowError:
                bts = ((data >> (8 * i)) & 0xFF for i in range(size))
            for i, b in enumerate(bts):
                mem[addr + i] = b
            nbytes += size
            for fn in obs:
                fn(addr, data, size, cycle)
        self.traffic.xgmi_writes_in += len(group)
        self.traffic.xgmi_bytes_in += nbytes

    def enact_xgmi_run(
        self, addrs: List[int], cycles: List[int], data: int, size: int
    ) -> None:
        """Enact a bulk-popped run prefix: same-payload writes at per-write
        cycles (see ``WriteTrackingTable.pop_due_run``).  Identical to
        per-write :meth:`enact_xgmi_write` calls in order, with the byte
        split and counter adds done once for the batch."""
        mem = self._mem
        obs = self._write_observers
        try:
            bts = tuple(enumerate(data.to_bytes(size, "little")))
        except OverflowError:  # negative or wider than size: masked split
            bts = tuple(
                (i, (data >> (8 * i)) & 0xFF) for i in range(size)
            )
        if obs:
            for addr, cyc in zip(addrs, cycles):
                for i, b in bts:
                    mem[addr + i] = b
                for fn in obs:
                    fn(addr, data, size, cyc)
        else:
            for addr in addrs:
                for i, b in bts:
                    mem[addr + i] = b
        n = len(addrs)
        self.traffic.xgmi_writes_in += n
        self.traffic.xgmi_bytes_in += n * size

    # -- debugging convenience --------------------------------------------------

    def peek(self, addr: int, size: int = 4) -> int:
        """Uncounted read (simulator introspection, not device traffic)."""
        return self._load(addr, size)
