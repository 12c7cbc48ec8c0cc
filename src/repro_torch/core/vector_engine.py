"""The vectorized batch-replay engine and its spin-wait closed form, on a
torch device (port of ``repro/core/vector_engine.py``).

Eidolons are replay-only: their write times do not depend on the target's
state, so every workgroup's wait is a pure function of its phase schedule and
the flags' visibility times.  :func:`run_vectorized` turns the WTT poll loop
into a few dense passes over all workgroups at once: the per-workgroup
schedule, cursors and flag reads are int64 tensors on the run's device (the
reference's are numpy arrays on the host), the loop over the peers' flags
runs on the host.  Its report equals the cycle and event engines' field for
field, apart from the engine-specific ``wtt_head_polls`` and the closed-form
``monitor_stats``, as the reference's does.

:func:`spin_reads` is the port of ``spin_reads_jax``: the SPIN wait alone,
from given wait-entry cycles.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .cohort_timeline import spin_wait
from .config import SimConfig, SyncPolicy
from .events import Segment, effective_writes

__all__ = ["run_vectorized", "spin_reads"]


def run_vectorized(sim) -> "Report":  # noqa: F821 - avoids circular import
    """Replay ``sim`` (an :class:`repro_torch.core.simulator.Eidola` of the
    ``gemv_allreduce`` scenario) in closed form on ``sim.device``."""
    from .simulator import Report
    from .workload import GemvAllReduceWorkload

    t0 = time.perf_counter()
    cfg: SimConfig = sim.cfg
    dev = sim.device
    workload = GemvAllReduceWorkload(cfg, sim.amap)
    plans = workload.plans
    nwg = len(plans)
    order = workload.flag_order()

    writes = effective_writes(
        sim.traces, latency_ns=cfg.xgmi_enact_latency_ns, perturb=sim.perturb
    )

    # Flag visibility cycles: first write to each (src_device, slot) wins,
    # over the writes in (wakeup_ns, seq) order; decode_flag covers every
    # slot, so a multi-slot bundle's flags are seen (and named if slot 0's
    # are missing).
    flag_T: Dict[tuple, int] = {}
    for w in sorted(writes, key=lambda w: (w.wakeup_ns, w.seq)):
        decoded = sim.amap.decode_flag(w.addr)
        if decoded is not None and decoded not in flag_T:
            flag_T[decoded] = cfg.ns_to_cycles(w.wakeup_ns)
    # the gemv workload polls each peer's slot-0 flag, in flag_order()
    missing = [g for g in order if (g, 0) not in flag_T]
    if missing:
        from .target import EidolaDeadlock

        have = sorted(flag_T)
        raise EidolaDeadlock(
            f"no slot-0 flag writes for peers {missing} in trace"
            + (
                f" (bundle carries flags for (src, slot) {have})"
                if have
                else ""
            )
        )

    # --- per-WG static schedule (perturbable), int64 on the device ----------
    def dur(wg_i: int, state: str, base: int) -> int:
        if sim.perturb is not None and base > 0:
            return sim.perturb.scale_phase(wg_i, state, base)
        return base

    def column(values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int64, device=dev)

    dispatch = column([p.dispatch_cycle for p in plans])
    remote = column([dur(p.wg, "remote_tiles", p.remote_cycles) for p in plans])
    flagw = column([dur(p.wg, "flag_write", p.flag_write_cycles) for p in plans])
    local = column([dur(p.wg, "local_tiles", p.local_cycles) for p in plans])
    reduce_d = column([dur(p.wg, "reduce", p.reduce_cycles) for p in plans])
    bcast_d = column([dur(p.wg, "broadcast", p.broadcast_cycles) for p in plans])
    cu = column([p.cu for p in plans])

    wait_start = dispatch + remote + flagw + local
    c = wait_start.clone()
    flag_reads = torch.zeros_like(c)
    poll = cfg.poll_interval_cycles
    check = cfg.flag_check_cycles
    arm = cfg.monitor_arm_cycles
    wl = cfg.wake_latency_cycles
    jit = torch.arange(nwg, dtype=torch.int64, device=dev) % max(1, cfg.requeue_jitter_mod)

    # SyncMon: blocked workgroups per CU, accumulated per wake cycle across
    # the flags that share it (the (wake_c, cu) groups of the reference)
    coalesce_groups: Dict[int, torch.Tensor] = {}
    n_blocked = torch.zeros((), dtype=torch.int64, device=dev)
    n_race = torch.zeros_like(n_blocked)
    writes_checked = torch.zeros_like(n_blocked)
    desched: List[Tuple[torch.Tensor, torch.Tensor, int]] = []  # (blocked, t_arm, wake_c)

    for g in order:
        T = flag_T[(g, 0)]
        if cfg.sync == SyncPolicy.SPIN:
            # ceil((T - c) / poll) polls in int64, equal to the reference's
            # float64 np.ceil for every cycle count below 2**53
            step_reads, c = spin_wait(c, T, poll, check)
            flag_reads += step_reads
            continue
        already = T <= c
        flag_reads += 1  # check/observe read
        t_arm = c + arm
        race = ~already & (T <= t_arm)
        blocked = ~already & (T > t_arm)
        flag_reads += race
        wake_c = T + wl
        # one count of the blocked workgroups by CU (no host round trip)
        per_cu = torch.zeros(cfg.n_cus, dtype=torch.int64, device=dev).index_add_(
            0, cu, blocked.long())
        if wake_c in coalesce_groups:
            coalesce_groups[wake_c] += per_cu
        else:
            coalesce_groups[wake_c] = per_cu
        nb = blocked.sum()
        n_blocked += nb
        n_race += race.sum()
        writes_checked += (nb > 0).long()
        if sim.collect_segments:
            desched.append((blocked, t_arm, wake_c))
        resume = wake_c + jit
        c = torch.where(
            already,
            c + check,
            torch.where(race, t_arm + check, resume + check),
        )

    width = max(1, cfg.wake_coalesce_width)
    coalesced_reads = sum(
        int(((n + width - 1) // width).sum()) for n in coalesce_groups.values()
    )
    total_flag_reads = int(flag_reads.sum()) + coalesced_reads

    wait_end = c
    reduce_end = wait_end + reduce_d
    bcast_end = reduce_end + bcast_d
    kernel_end = int(bcast_end.max()) if nwg else 0
    # writes beyond kernel end still enact (drained), matching event engine
    last_write_cycle = max(
        (cfg.ns_to_cycles(w.wakeup_ns) for w in writes), default=0
    )
    sim_cycles = max(kernel_end, last_write_cycle)

    monitor_stats: Dict[str, int] = {}
    if cfg.sync == SyncPolicy.SYNCMON:
        armed = int(n_blocked) + int(n_race)
        monitor_stats = {
            "monitors_armed": armed,
            "mwaits": armed,
            "wakes": armed,
            "immediate_mwait_returns": int(n_race),
            "writes_checked": int(writes_checked),
        }

    # --- closed-form non-flag traffic ---------------------------------------
    nonflag = sum(
        p.remote_sector_reads + p.local_sector_reads + p.reduce_reads for p in plans
    )
    sector_reads = sum(p.remote_sector_reads + p.local_sector_reads for p in plans)
    reduce_reads = sum(p.reduce_reads for p in plans)
    local_writes = sum(
        p.local_partial_writes + p.broadcast_local_writes for p in plans
    )
    xgmi_out = sum(
        p.remote_xgmi_writes + p.broadcast_xgmi_writes for p in plans
    ) + nwg * len(order)
    xgmi_out_bytes = (
        sum(p.remote_xgmi_writes + p.broadcast_xgmi_writes for p in plans)
        * cfg.elem_bytes
        * cfg.N
        + nwg * len(order) * 8
    )
    traffic = {
        "flag_reads": total_flag_reads,
        "nonflag_reads": nonflag,
        "total_reads": total_flag_reads + nonflag,
        "local_writes": local_writes,
        "xgmi_writes_in": len(writes),
        "xgmi_writes_out": xgmi_out,
        "xgmi_bytes_in": sum(w.size for w in writes),
        "xgmi_bytes_out": xgmi_out_bytes,
        "read_bytes": sector_reads * cfg.sector_bytes
        + reduce_reads * cfg.elem_bytes
        + total_flag_reads * 8,
        "write_bytes": local_writes * cfg.elem_bytes * cfg.N,
    }

    segments: List[Segment] = []
    if sim.collect_segments:
        ns = cfg.cycles_to_ns
        rows = torch.stack([dispatch, remote, flagw, wait_start, wait_end, reduce_end,
                            bcast_end], dim=1).tolist()
        for p, (t, rem, fw, ws, we, re, be) in zip(plans, rows):
            bounds = [
                ("remote_tiles", t, t + rem),
                ("flag_write", t + rem, t + rem + fw),
                ("local_tiles", t + rem + fw, ws),
                ("wait_flags", ws, we),
                ("reduce", we, re),
                ("broadcast", re, be),
            ]
            for name, s, e in bounds:
                segments.append(
                    Segment(wg=p.wg, phase=name, start_ns=ns(s), end_ns=ns(e))
                )
        for blocked, t_arm, wake_c in desched:
            idx = torch.nonzero(blocked).flatten()
            for wg_i, t_arm_i in zip(idx.tolist(), t_arm[idx].tolist()):
                segments.append(
                    Segment(
                        wg=plans[wg_i].wg,
                        phase="descheduled",
                        start_ns=ns(t_arm_i),
                        end_ns=ns(wake_c),
                    )
                )
        segments.sort(key=lambda s: (s.wg, s.start_ns))

    return Report(
        engine="vector",
        sync=cfg.sync.value,
        traffic=traffic,
        flag_reads=total_flag_reads,
        nonflag_reads=nonflag,
        kernel_span_ns=cfg.cycles_to_ns(kernel_end),
        sim_cycles=sim_cycles,
        wall_time_s=time.perf_counter() - t0,
        wtt_registered=len(writes),
        wtt_enacted=len(writes),
        wtt_head_polls=0,
        monitor_stats=monitor_stats,
        segments=segments,
        meta=dict(sim.traces.meta),
        n_devices=1,
        per_device={0: dict(traffic)},
        closed_loop=False,
    )


def spin_reads(wait_start, flag_T, poll: int, check: int, device=None):
    """Flag reads and the cursor after the last flag, per workgroup, in SPIN mode.

    ``wait_start``: per-workgroup wait-phase entry cycles; ``flag_T``: the
    flags' visibility cycles in polling order.  A flag already visible costs
    one read and ``check`` cycles; otherwise ``ceil((T - c) / poll)`` more
    polls.  Returns ``(reads_per_wg, cursor_after)`` as int64 tensors on
    ``device`` (the CUDA device unless the caller passes ``"cpu"``).  The
    reference's JAX scan carries the cursor in float32; this port keeps
    integer cycles in int64, as the numpy closed form does.
    """
    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(wait_start, np.int64), device=dev)
    reads = torch.zeros_like(c)
    for T in np.asarray(flag_T, np.int64).tolist():
        step_reads, c = spin_wait(c, T, poll, check)
        reads += step_reads
    return reads, c
