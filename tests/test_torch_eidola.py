"""The port's open-loop Eidola simulator against the reference's, field for field.

Every case runs the reference (``repro.core``) and the port
(``repro_torch.core``, ``device="cpu"``) on the same configuration, trace and
perturbation, and holds the port's ``Report`` equal to the reference's on
every field but ``wall_time_s``: exact integers (Python ``int``, never a
tensor or a numpy scalar) and equal floats, segments included.

- Table 1 (the paper's configuration): {SPIN, SYNCMON} x {CYCLE, EVENT,
  VECTOR} x flag delays {0, 5, 20, 40 us, per peer [0, 12.5, 40] us} x
  perturbations {none, Gaussian, two peers delayed}; the port's three engines
  agree with each other as the reference's do, here, on seeded random
  configurations and at the edges of SyncMon's race window.
- Figs. 10 and 11's shapes (M 4096; 255 eGPUs, weak scaling, K 2048), a
  non-default configuration (Hoare monitors, 8 CUs, 100 workgroups), the
  deadlocks with the reference's messages, the multi-slot vector case.
- Units: ``SimConfig`` and its errors, the WTT's pop and poll order (lazy
  runs too), the Monitor Log's Hoare and Mesa wakes and its line-straddle
  rejection, the address map, the directory memory, the perturbations,
  ``TraceBundle`` JSON both ways, the trace renderers, ``SweepRunner.to_csv``
  and the command line, whose summary lines equal the reference's once
  ``wall=`` is masked.
"""

import contextlib
import dataclasses
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core import trace_render as ref_render
from repro.core.wtt import LazyWriteRun as RefRun
from repro_torch.core import trace_render as port_render
from repro_torch.core.wtt import LazyWriteRun as PortRun
from repro_torch.launch import scenario as port_cli

SRC = Path(__file__).resolve().parents[1] / "src"
SYNCS = ("spin", "syncmon")
ENGINES = ("cycle", "event", "vector")
DELAYS = {"0us": 0.0, "5us": 5_000.0, "20us": 20_000.0, "40us": 40_000.0,
          "per_peer": [0.0, 12_500.0, 40_000.0]}
PERTURBS = {
    "none": lambda M: None,
    "gaussian": lambda M: M.GaussianPerturb(seed=3, phase_sigma=0.05, write_sigma_ns=10),
    "peer_delay": lambda M: M.PeerDelayPerturb({2: 25_000, 3: 25_000}),
}
# fields the engines account differently in the reference too: the cycle
# engine's per-cycle head polls, the vector engine's closed-form monitor stats
ENGINE_SPECIFIC = ("engine", "wall_time_s", "wtt_head_polls", "monitor_stats")


def _fields(report, drop=("wall_time_s",)) -> dict:
    d = dataclasses.asdict(report)
    for k in drop:
        d.pop(k)
    return d


def _python_ints(report) -> None:
    ints = [report.flag_reads, report.nonflag_reads, report.sim_cycles, report.wtt_registered,
            report.wtt_enacted, report.wtt_head_polls, report.n_devices,
            *report.traffic.values(), *report.monitor_stats.values(),
            *(v for t in report.per_device.values() for v in t.values())]
    assert all(type(v) is int for v in ints)
    assert type(report.kernel_span_ns) is float


def _both(run, **kw):
    """``run(M, **kw)`` on the reference and the port; the port's report must
    equal the reference's on every field but the wall."""
    ref = run(R, **kw)
    port = run(P, **kw)
    assert _fields(port) == _fields(ref)
    _python_ints(port)
    return port


def _gemv(pkg, sync, engine, delay, perturb, collect_segments=True, **cfg):
    c = pkg.SimConfig(sync=pkg.SyncPolicy(sync), engine=pkg.EngineKind(engine), **cfg)
    extra = {} if pkg is R else {"device": "cpu"}
    return pkg.run_gemv_allreduce(c, delay, perturb=PERTURBS[perturb](pkg),
                                  collect_segments=collect_segments, **extra)


@pytest.mark.parametrize("perturb", sorted(PERTURBS))
@pytest.mark.parametrize("delay", sorted(DELAYS))
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("sync", SYNCS)
def test_table1_report_equals_the_reference(sync, engine, delay, perturb):
    port = _both(_gemv, sync=sync, engine=engine, delay=DELAYS[delay], perturb=perturb)
    assert port.nonflag_reads == 65_792 and port.segments
    # the engines agree: each one's report is the event engine's but for
    # the fields each accounts its own way
    event = _gemv(R, sync, "event", DELAYS[delay], perturb)
    assert _fields(port, ENGINE_SPECIFIC) == _fields(event, ENGINE_SPECIFIC)


@pytest.mark.parametrize("engine", ("event", "vector"))
@pytest.mark.parametrize("sync", SYNCS)
@pytest.mark.parametrize("shape", [dict(M=4096), dict(n_egpus=255, weak_scaling=True, K=2048)],
                         ids=["fig10_M4096", "fig11_255_egpus"])
def test_scaling_shapes_equal_the_reference(shape, sync, engine):
    _both(_gemv, sync=sync, engine=engine, delay=10_000.0, perturb="none",
          collect_segments=False, **shape)


@pytest.mark.parametrize("engine", ENGINES)
def test_hoare_monitors_on_eight_cus(engine):
    port = _both(_gemv, sync="syncmon", engine=engine, delay=[3_000.0, 7_000.0, 11_000.0],
                 perturb="gaussian", monitor_semantics="hoare", n_cus=8, workgroups=100)
    assert {s.wg for s in port.segments} == set(range(100))


def _random_case(seed):
    """A seeded configuration off Table 1: peers, CUs, workgroups, shape, the
    timing knobs the waits read, and per-peer delays on a 250 ns grid (so
    flags share visibility cycles and waits land on the race window's edge)."""
    rng = np.random.default_rng(seed)
    n_egpus = int(rng.choice([1, 3, 7]))
    n = n_egpus + 1
    cfg = dict(n_egpus=n_egpus, n_cus=int(rng.choice([2, 4, 8])),
               workgroups=int(rng.integers(8, 120)), M=n * int(rng.integers(4, 40)),
               K=n * 256 * int(rng.integers(1, 4)), poll_interval_cycles=int(rng.integers(8, 100)),
               flag_check_cycles=int(rng.integers(1, 9)),
               wake_latency_cycles=int(rng.integers(0, 64)),
               monitor_arm_cycles=int(rng.integers(0, 200)),
               wake_coalesce_width=int(rng.integers(1, 5)),
               requeue_jitter_mod=int(rng.integers(1, 33)),
               monitor_semantics=str(rng.choice(["mesa", "hoare"])),
               xgmi_enact_latency_ns=float(rng.integers(0, 3) * 500.0))
    return cfg, [float(d) for d in rng.integers(0, 40, n_egpus) * 250.0]


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("sync", SYNCS)
def test_random_configurations_equal_the_reference(sync, seed):
    cfg, delays = _random_case(seed)
    reports = [_fields(_both(_gemv, sync=sync, engine=e, delay=delays, perturb="none", **cfg),
                       ENGINE_SPECIFIC) for e in ENGINES]
    assert reports[0] == reports[1] == reports[2]


@pytest.mark.parametrize("edge", (-1, 0, 1))
def test_syncmon_race_window_edges(edge):
    """The first flag becomes visible exactly ``monitor_arm_cycles`` (+ edge)
    after the first wave enters its wait: at 0 the write lands on the arming
    cycle itself, the race window's last cycle."""
    cfg = P.SimConfig()
    p0 = P.GemvAllReduceWorkload(cfg).plans[0]
    wait_start = p0.remote_cycles + p0.flag_write_cycles + p0.local_cycles
    T = cfg.ns_to_cycles(4_000.0 + cfg.xgmi_enact_latency_ns)
    arm = T - wait_start - edge
    reports = [_fields(_both(_gemv, sync="syncmon", engine=e, delay=[4_000.0, 4_600.0, 5_200.0],
                             perturb="none", monitor_arm_cycles=arm), ENGINE_SPECIFIC)
               for e in ENGINES]
    assert reports[0] == reports[1] == reports[2]


def _missing_peer_bundle(M):
    sc = M.get_scenario("gemv_allreduce")(M.SimConfig(), flag_delays_ns=5000.0)
    bundle = sc.traces()
    return M.TraceBundle(meta=bundle.meta, writes=[w for w in bundle.writes if w.src != 2])


def _deadlock_message(run, M):
    with pytest.raises(M.EidolaDeadlock) as err:
        run(M)
    return str(err.value)


@pytest.mark.parametrize("engine", ("cycle", "event"))
@pytest.mark.parametrize("sync", SYNCS)
def test_deadlock_message_equals_the_reference(sync, engine):
    def run(M):
        cfg = M.SimConfig(sync=M.SyncPolicy(sync), engine=M.EngineKind(engine))
        extra = {} if M is R else {"device": "cpu"}
        M.Eidola(cfg, _missing_peer_bundle(M), **extra).run()

    msg = _deadlock_message(run, P)
    assert msg == _deadlock_message(run, R)
    assert "src_device=2, slot=0" in msg and "208 workgroups blocked" in msg


def _multi_slot(M, engine, slots=(1, 3), slot0=True):
    """The reference's multi-slot case (tests/test_eidola_core.py): the gemv
    scenario on a 4-slot map, its trace plus flags in higher slots; with
    ``slot0=False`` the bundle carries only the higher slots' flags."""
    cfg = M.SimConfig(engine=M.EngineKind(engine))
    amap = M.AddressMap(n_devices=cfg.n_devices, flag_slots=4)
    sc = M.get_scenario("gemv_allreduce")(cfg, amap, flag_delays_ns=9_000.0)
    bundle = sc.traces() if slot0 else M.TraceBundle()
    for g in range(1, cfg.n_devices):
        for slot in slots:
            bundle.add(wakeup_ns=2_000.0 * g + 100.0 * slot, addr=amap.flag_addr(g, slot=slot),
                       data=1, size=8, src=g)
    extra = {} if M is R else {"device": "cpu"}
    return M.Eidola(cfg, bundle, scenario=sc, collect_segments=False, **extra).run()


def test_vector_engine_multi_slot_bundle():
    vec = _both(_multi_slot, engine="vector")
    event = _both(_multi_slot, engine="event")
    assert _fields(vec, ENGINE_SPECIFIC) == _fields(event, ENGINE_SPECIFIC)
    assert vec.wtt_enacted == 3 * 64 + 3 + 6  # partials, slot-0 flags, slots 1 and 3
    msg = _deadlock_message(lambda M: _multi_slot(M, "vector", (2,), slot0=False), P)
    assert msg == _deadlock_message(lambda M: _multi_slot(M, "vector", (2,), slot0=False), R)
    assert "slot-0" in msg and "(1, 2)" in msg


def test_simconfig_fields_and_errors():
    ref = [(f.name, f.default) for f in dataclasses.fields(R.SimConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(P.SimConfig)] == ref
    for M in (R, P):
        cfg = M.SimConfig()
        assert (cfg.k_slice, cfg.rows_per_device, cfg.row_cycles, cfg.sectors_per_row) == \
            (2048, 64, 832, 256)
        assert cfg.ns_to_cycles(1000.4) == 1501 and cfg.cycles_to_ns(3) == 2.0
    for bad in (dict(n_cus=0), dict(workgroups=-1), dict(n_egpus=0)):
        with pytest.raises(ValueError) as r_err:
            R.SimConfig(**bad).validate()
        with pytest.raises(ValueError, match=re.escape(str(r_err.value))):
            P.SimConfig(**bad).validate()
    for cfg_kw, prop in ((dict(K=1001), "k_slice"), (dict(M=250), "rows_per_device")):
        with pytest.raises(ValueError) as r_err:
            getattr(R.SimConfig(**cfg_kw), prop)
        with pytest.raises(ValueError, match=re.escape(str(r_err.value))):
            getattr(P.SimConfig(**cfg_kw), prop)
    with pytest.raises(ValueError, match="devices must be >= 2"):
        P.SimConfig().with_devices(1)
    assert P.SimConfig().with_devices(8).n_egpus == 7


def _writes(M, rng, n=300):
    """Seeded writes with many shared wakeup cycles, registered out of order."""
    ns = rng.integers(0, 40, n) * 666.5 + rng.integers(0, 2, n) * 0.2
    return [M.RegisteredWrite(wakeup_ns=float(t), addr=int(a), data=int(d), size=int(s),
                              src=int(src), seq=int(q))
            for t, a, d, s, src, q in zip(ns, rng.integers(0, 1 << 20, n), rng.integers(0, 255, n),
                                          rng.integers(1, 9, n), rng.integers(0, 4, n),
                                          rng.permutation(n))]


def _drain(wtt, how):
    out = []
    if how == "poll":
        for cycle in range(0, 40_000, 97):
            out.append([dataclasses.astuple(w) for w in wtt.poll(cycle)])
    else:
        while not wtt.empty:
            cyc, group = wtt.pop_next_group()
            out.append((cyc, [dataclasses.astuple(w) for w in group]))
    return out, dataclasses.astuple(wtt.stats)


@pytest.mark.parametrize("how", ("poll", "group"))
def test_wtt_pop_and_poll_order(how):
    got = {}
    for M in (R, P):
        wtt = M.WriteTrackingTable(clock_ghz=1.5)
        for w in _writes(M, np.random.default_rng(5))[:100]:
            wtt.register(w)
        wtt.register_many(_writes(M, np.random.default_rng(6)))
        got[M] = _drain(wtt, how)
    assert got[P] == got[R]
    cycles = [c for c, _ in got[P][0]] if how == "group" else []
    assert cycles == sorted(cycles)


def test_wtt_lazy_runs_pop_as_the_reference():
    got = {}
    for M, Run in ((R, RefRun), (P, PortRun)):
        wtt = M.WriteTrackingTable(clock_ghz=1.5)
        wtt.register_many([Run(count=40, base_ns=100.0, span_ns=900.0, addr_base=4096,
                               addr_stride=64, data=7, src=1, min_ns=300.0),
                           *_writes(M, np.random.default_rng(7), 50)])
        wtt.register_run(Run(count=9, base_ns=0.0, span_ns=3000.0, addr_base=0, addr_stride=8,
                             data=-3, size=2, src=2, seq0=100))
        pending = [dataclasses.astuple(w) for w in wtt.pending()]
        runs = []
        while not wtt.empty:
            bulk = wtt.pop_due_run(stop_cycle=2500)
            runs.append(bulk if bulk is not None else
                        [dataclasses.astuple(w) for w in wtt.pop_next_group()[1]])
        got[M] = (pending, runs, dataclasses.astuple(wtt.stats))
    assert got[P] == got[R]


@pytest.mark.parametrize("semantics", ("hoare", "mesa"))
def test_monitor_wakes_and_line_straddle(semantics):
    got = {}
    for M in (R, P):
        mem = M.DirectoryMemory(M.AddressMap())
        log = M.MonitorLog(mem, semantics=semantics, wake_latency_cycles=6)
        addr = mem.amap.flag_addr(1)
        entry = log.monitor(addr, 8, 2)
        other = log.monitor(addr + 8, 4, 1)
        assert not log.mwait(entry, wf_id=7, now_cycle=0)
        assert not log.mwait(other, wf_id=9, now_cycle=0)
        wakes = []
        for cycle, data in ((10, 1), (20, 2), (30, 2)):
            mem.enact_xgmi_write(M.RegisteredWrite(wakeup_ns=0.0, addr=addr, data=data, size=8),
                                 cycle)
            wakes.append(log.pop_wakes_until(10_000))
        mem.write_local(addr, 2, 8)
        wakes.append(log.mwait(log.monitor(addr, 8, 2), wf_id=3, now_cycle=40))
        with pytest.raises(ValueError, match="straddle"):
            log.monitor(mem.amap.flag_base + 60, 8, 1)
        with pytest.raises(ValueError, match="within one line"):
            log.monitor(addr, 65, 1)
        got[M] = (wakes, dict(log.stats), log.waiting_count(), log.next_wake_cycle(),
                  mem.traffic.as_dict())
    assert got[P] == got[R]
    assert got[P][0][0] == ([] if semantics == "hoare" else [(7, 16)])


def test_address_map_and_directory_memory():
    base = R.AddressMap().flag_base
    strays = [int(a) for a in np.random.default_rng(11).integers(base - 64, base + 3000, 40)]
    got = {}
    for M in (R, P):
        out = []
        for share in (False, True):
            amap = M.AddressMap(n_devices=6, flag_slots=5, flags_share_line=share)
            probes = [amap.flag_addr(d, s) for d in range(6) for s in range(5)] + strays
            out.append([amap.decode_flag(a) for a in probes])
            out.append([(amap.is_flag(a), amap.line_of(a)) for a in probes])
            out.append((amap.flag_region(), amap.flag_linear()))
        wide = M.AddressMap(n_devices=4096, flag_slots=64)
        out.append(wide.with_partial_clearance().partial_base)
        amap = M.AddressMap(n_devices=4, flag_slots=8)
        amap.claim_flag_block("ring", 0, 4)
        amap.claim_flag_slots("p2p", [(1, 4), (2, 5)])
        for claim in (lambda: amap.claim_flag_block("late", 3, 6),
                      lambda: amap.claim_flag_slots("late", [(2, 5)])):
            with pytest.raises(ValueError) as err:
                claim()
            out.append(str(err.value))
        mem = M.DirectoryMemory(amap)
        seen = []
        mem.add_write_observer(lambda *a: seen.append(a))
        mem.enact_xgmi_run([amap.flag_addr(1), amap.flag_addr(2)], [5, 6], -2, 4)
        mem.enact_xgmi_group([M.RegisteredWrite(0.0, amap.partial_base, 0x1234, 2)], 9)
        mem.bulk_reads(3, bytes_each=32)
        out += [seen, mem.read(amap.flag_addr(1), 4), mem.read(amap.partial_base, 2),
                mem.peek(amap.flag_addr(2), 8), mem.traffic.as_dict()]
        got[M] = out
    assert got[P] == got[R]


def test_perturbations_draw_the_reference_streams():
    rng = np.random.default_rng(13)
    writes = {M: _writes(M, np.random.default_rng(14), 50) for M in (R, P)}
    keys = [(int(wg), str(state), int(base)) for wg, state, base in
            zip(rng.integers(0, 208, 50), rng.choice(["remote_tiles", "reduce"], 50),
                rng.integers(1, 5000, 50))]
    got = {}
    for M in (R, P):
        perturbs = [M.NullPerturb(), PERTURBS["gaussian"](M), PERTURBS["peer_delay"](M),
                    M.perturb.compose(PERTURBS["gaussian"](M), PERTURBS["peer_delay"](M))]
        got[M] = [([p.scale_phase(*k) for k in keys],
                   [dataclasses.astuple(p.jitter_write(w)) for w in writes[M]]) for p in perturbs]
    assert got[P] == got[R]


def test_trace_bundle_json_both_ways(tmp_path):
    for delays in ([1000.0, 2000.0, 3000.0], 12_345.6):
        ref = R.make_gemv_allreduce_traces(R.SimConfig(), delays)
        port = P.make_gemv_allreduce_traces(P.SimConfig(), delays)
        assert port.to_json() == ref.to_json()
        assert P.TraceBundle.from_json(ref.to_json()).to_json() == ref.to_json()
        assert R.TraceBundle.from_json(port.to_json()).to_json() == port.to_json()
    port.save(str(tmp_path / "t.json"))
    back = R.TraceBundle.load(str(tmp_path / "t.json"))
    ext_r, ext_p = R.TraceBundle(), P.TraceBundle()
    ext_r.extend(reversed(back.writes))
    ext_p.extend(reversed(port.writes))
    assert ext_p.to_json() == ext_r.to_json()
    assert [dataclasses.astuple(w) for w in ext_p.sorted()] == \
        [dataclasses.astuple(w) for w in ext_r.sorted()]
    assert {s: len(ws) for s, ws in ext_p.by_src().items()} == \
        {s: len(ws) for s, ws in ext_r.by_src().items()}
    # the registries are the port's own
    assert P.events.PHASE_COLORS is not R.events.PHASE_COLORS
    assert P.PHASES == R.PHASES


def test_trace_renderers_equal_the_reference():
    segs = {M: _gemv(M, "syncmon", "event", [0.0, 12_500.0, 40_000.0], "gaussian").segments
            for M in (R, P)}
    for name in ("to_chrome_trace", "to_csv", "ascii_timeline", "phase_totals"):
        assert getattr(port_render, name)(segs[P]) == getattr(ref_render, name)(segs[R])
    assert "descheduled" in port_render.phase_totals(segs[P])
    with pytest.raises(ValueError, match="unknown phase"):
        P.Segment(wg=0, phase="no_such_phase", start_ns=0.0, end_ns=1.0)


def test_sweep_csv_equals_the_reference_but_the_wall():
    grid = {"flag_delays_ns": [0.0, 8000.0], "n_egpus": [3, 7]}
    engines = {M: [M.EngineKind.EVENT, M.EngineKind.VECTOR] for M in (R, P)}
    ref = R.SweepRunner("gemv_allreduce", R.SimConfig(sync=R.SyncPolicy.SYNCMON),
                        engines=engines[R]).run(grid)
    port = P.SweepRunner("gemv_allreduce", P.SimConfig(sync=P.SyncPolicy.SYNCMON),
                         engines=engines[P], device="cpu").run(grid)

    def masked(points, M):
        lines = M.SweepRunner.to_csv(points).splitlines()
        return [line.rsplit(",", 1)[0] for line in lines]

    assert masked(port, P) == masked(ref, R)
    assert P.SweepRunner.to_csv(port).splitlines()[0].endswith(",wall_time_s")
    assert len(port) == 8


def _cli(module, *args):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    return subprocess.run([sys.executable, "-m", module, *args], env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_summary_lines_equal_the_reference():
    args = ("--scenario", "gemv_allreduce", "--engines", "cycle,event,vector", "--sync",
            "syncmon", "-p", "flag_delays_ns=20000")
    port = _cli("repro_torch.launch.scenario", "--device", "cpu", *args)
    ref = _cli("repro.launch.scenario", *args)
    assert port.returncode == ref.returncode == 0, port.stderr
    mask = lambda text: re.sub(r"wall=[0-9.]+ms", "wall=<masked>", text).splitlines()  # noqa: E731
    assert mask(port.stdout) == mask(ref.stdout)
    assert len(mask(port.stdout)) == 3


@pytest.mark.parametrize("flags", [["--verify"], ["--prove-layout"], ["--sanitize"],
                                   ["--sanitize", "--detailed", "all", "--devices", "4"]])
def test_cli_refuses_closed_loop_flags(flags):
    # the name is kept from before the static analyzer was ported: the three
    # flags now behave as the reference's (the verdict, the proof, the
    # --detailed requirement, the sanitized run)
    from repro.launch import scenario as ref_cli

    outs = []
    for main, pre in ((ref_cli.main, []), (port_cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                code = main([*pre, "--scenario", "ring_allreduce", "--devices", "4", *flags,
                             "-p", "workgroups=8"])
            except SystemExit as e:
                code = e.code
        masked = re.sub(r"wall=[0-9.]+ms", "wall=<w>", buf.getvalue())
        outs.append((code, re.sub(r"built in [0-9.]+ ms", "built in <t>", masked)))
    assert outs[1] == outs[0]
    assert outs[1][1] or str(outs[1][0]).startswith("error: --sanitize requires --detailed all")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = P.SimConfig(engine=P.EngineKind.VECTOR)
    bundle = P.make_gemv_allreduce_traces(cfg, 0.0)
    for call in (lambda: P.simulate("gemv_allreduce", cfg),
                 lambda: P.Eidola(cfg, bundle),
                 lambda: P.run_gemv_allreduce(cfg, 0.0),
                 lambda: P.SweepRunner("gemv_allreduce", cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(SystemExit) as err:
        port_cli.main(["--engine", "vector"])
    assert str(err.value.code).startswith("error: no CUDA device")
    assert P.simulate("gemv_allreduce", cfg, device="cpu").flag_reads == 52_728  # 10 us


def test_closed_loop_raises_not_implemented():
    # the name is kept from before the sanitizer was ported: a sanitized
    # closed-loop run now equals the reference's
    reports = [M.simulate("ring_allreduce", M.SimConfig(workgroups=8).with_devices(4),
                          closed_loop=True, sanitize=True,
                          **({"device": "cpu"} if M is P else {})) for M in (R, P)]
    assert reports[1].meta["sanitized"] is True
    fields = [_fields(r) for r in reports]
    for d in fields:
        d["meta"].pop("wall_breakdown", None)
        d["meta"]["program_stats"].pop("construct_wall_s")
    assert fields[1] == fields[0]
    sc = P.get_scenario("gemv_allreduce")(P.SimConfig())
    sc._setup_fabric(fabric="fat_tree")
    assert sc.fabric_name == "fat_tree" and sc.interconnect.n_devices == 4
