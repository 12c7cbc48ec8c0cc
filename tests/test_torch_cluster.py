"""The port's closed loop (``Cluster``, the four closed-loop scenarios, the
timeline engine) against the reference's, field for field.

Every case runs the reference (``repro.core``) and the port
(``repro_torch.core``, ``device="cpu"``) on the same configuration, scenario,
fabric and perturbation, and holds the port's ``Report`` equal to the
reference's on every field but the walls (``wall_time_s``, the
``wall_breakdown`` and the program construction time): counters, spans,
fabric stats (floats included), per-device traffic and segments.

- every closed-loop scenario x {SPIN, SYNCMON} x {CYCLE, EVENT} at 4 devices;
- every scenario flat and on every fabric preset at 8 and 16 devices, and one
  preset under the cycle engine;
- one rank slowed (its downstream ranks wait longer, as in the reference),
  seeded write jitter, the singleton interpreter (``cohorts=False``);
- the deadlock message, the sweep's devices / nodes axes, the command line's
  closed-loop flags and its exit-1 cases;
- ``Cluster(device=None)`` and ``simulate`` raising without a card, and the
  sanitizer running as the reference's;
- the eGPU write-stream generators (``egpu``) and ``merge_streams``.
"""

import contextlib
import dataclasses
import io
import re

import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.launch import scenario as ref_cli
from repro_torch.launch import scenario as port_cli

CLOSED_LOOP = ("ring_allreduce", "all_to_all", "pipeline_p2p", "hierarchical_allreduce")
SYNCS = ("spin", "syncmon")
FABRICS = ("flat", "two_tier", "fat_tree", "rail_optimized", "torus2d")
FAST = dict(workgroups=12, n_cus=4)


def _fields(report) -> dict:
    d = dataclasses.asdict(report)
    d.pop("wall_time_s")
    d["meta"].pop("wall_breakdown", None)
    d["meta"]["program_stats"].pop("construct_wall_s")
    return d


def _run(M, name, *, engine="event", sync="spin", devices=4, cfg_kw=FAST, **kw):
    cfg = M.SimConfig(engine=M.EngineKind(engine), sync=M.SyncPolicy(sync), **cfg_kw)
    if M is P:
        kw["device"] = "cpu"
    return M.simulate(name, cfg, devices=devices, closed_loop=True, **kw)


def _both(name, **kw) -> tuple:
    ref, port = _run(R, name, **kw), _run(P, name, **kw)
    assert _fields(port) == _fields(ref)
    assert port.closed_loop and port.n_devices == ref.n_devices
    assert all(type(v) is int for t in port.per_device.values() for v in t.values())
    return ref, port


@pytest.mark.parametrize("engine", ("cycle", "event"))
@pytest.mark.parametrize("sync", SYNCS)
@pytest.mark.parametrize("name", CLOSED_LOOP)
def test_four_devices_equal_the_reference(name, sync, engine):
    ref, port = _both(name, engine=engine, sync=sync)
    assert port.segments and port.flag_reads > 0


def _fabric_kw(fabric: str, devices: int) -> dict:
    if fabric == "flat":
        return {}
    if fabric == "torus2d":
        return {"fabric": "torus2d"}
    return {"fabric": fabric, "nodes": devices // 4 if devices > 8 else 2}


@pytest.mark.parametrize("devices", (8, 16))
@pytest.mark.parametrize("fabric", FABRICS)
@pytest.mark.parametrize("name", CLOSED_LOOP)
def test_every_fabric_equals_the_reference(name, fabric, devices):
    ref, port = _both(name, devices=devices, **_fabric_kw(fabric, devices))
    want = "ring" if fabric == "flat" else fabric
    assert port.meta["fabric_name"] == want


@pytest.mark.parametrize("name", ("all_to_all", "hierarchical_allreduce"))
def test_cycle_engine_on_a_graph_preset_equals_the_reference(name):
    _both(name, engine="cycle", devices=8, fabric="rail_optimized", nodes=2)


class _SlowReduce:
    """Stretch one rank's ring_reduce phases 16x (the reference test's)."""

    def scale_phase(self, wg, name, base_cycles):
        return base_cycles * 16 if name == "ring_reduce" else base_cycles

    def jitter_write(self, w):
        return w


def _wait_ends(report, device):
    return [s.end_ns for s in report.segments if s.device == device and s.phase == "wait_flags"]


@pytest.mark.parametrize("engine", ("cycle", "event"))
def test_a_slow_rank_delays_its_downstream_ranks_as_in_the_reference(engine):
    _, base = _both("ring_allreduce", engine=engine)
    _, slow = _both("ring_allreduce", engine=engine, perturb={1: _SlowReduce()})
    for dev in (2, 3, 0):
        assert sum(_wait_ends(slow, dev)) > sum(_wait_ends(base, dev)), dev
    assert max(_wait_ends(slow, 2)) > max(_wait_ends(base, 2))
    assert slow.kernel_span_ns > base.kernel_span_ns
    assert slow.meta["engine_impl"] == engine  # a perturbation rules out the timeline


@pytest.mark.parametrize("name", ("ring_allreduce", "all_to_all"))
def test_seeded_write_jitter_equals_the_reference(name):
    reports = {}
    for engine in ("cycle", "event"):
        perturb = {M: M.GaussianPerturb(seed=7, phase_sigma=0.1, write_sigma_ns=300.0)
                   for M in (R, P)}
        ref = _run(R, name, engine=engine, perturb=perturb[R])
        port = _run(P, name, engine=engine, perturb=perturb[P])
        assert _fields(port) == _fields(ref)
        reports[engine] = port
    assert reports["cycle"].traffic == reports["event"].traffic


@pytest.mark.parametrize("name", CLOSED_LOOP)
def test_singleton_interpreter_equals_the_reference(name):
    cfgs = {M: M.SimConfig(engine=M.EngineKind.EVENT, sync=M.SyncPolicy.SYNCMON,
                           **FAST).with_devices(4) for M in (R, P)}
    reports = {}
    for M in (R, P):
        sc = M.get_scenario(name)(cfgs[M], closed_loop=True)
        kw = {"device": "cpu"} if M is P else {}
        reports[M] = M.Cluster(cfgs[M], sc, cohorts=False, **kw).run()
    assert _fields(reports[P]) == _fields(reports[R])


def _silent_ring(M):
    """ring_allreduce built closed-loop whose ranks wait on every step's flag
    but never emit one: every device deadlocks."""
    base = M.get_scenario("ring_allreduce")

    class Silent(base):
        name = "silent_ring"

        def programs_for(self, device):
            return self.programs()

    return Silent


@pytest.mark.parametrize("how", ("cycle", "event", "timeline"))
def test_deadlock_message_equals_the_reference(how):
    msgs = []
    for M in (R, P):
        engine = "cycle" if how == "cycle" else "event"
        cfg = M.SimConfig(engine=M.EngineKind(engine), **FAST).with_devices(4)
        sc = _silent_ring(M)(cfg, closed_loop=True)
        kw = {"device": "cpu"} if M is P else {}
        with pytest.raises(M.EidolaDeadlock) as err:
            M.Cluster(cfg, sc, timeline=(how == "timeline"), **kw).run()
        msgs.append(str(err.value))
    # the static analyzer's diagnosis (the blame chain) on the lines after
    # the message, in both packages
    assert msgs[1] == msgs[0]
    assert "'silent_ring'" in msgs[1] and "device 3: wg 0-11" in msgs[1]
    assert "\nstatic analysis:\n" in msgs[1]


def test_sweep_devices_and_nodes_axes_equal_the_reference():
    grid = {"devices": [4, 8], "nodes": [2], "closed_loop": [True]}
    rows = []
    for M in (R, P):
        kw = {"device": "cpu"} if M is P else {}
        points = M.SweepRunner("ring_allreduce", M.SimConfig(**FAST),
                               engines=[M.EngineKind.EVENT], **kw).run(grid)
        rows.append([{k: v for k, v in p.row().items() if k != "wall_time_s"} for p in points])
    assert rows[1] == rows[0]
    assert [r["devices_per_node"] for r in rows[1]] == [2, 4]


def test_sanitizer_is_not_ported():
    # the name is kept from before the sanitizer was ported: it now runs, the
    # sanitized report (and the solver's refusal) equal to the reference's
    reports = []
    for M in (R, P):
        cfg = M.SimConfig(**FAST).with_devices(4)
        sc = M.get_scenario("ring_allreduce")(cfg, closed_loop=True)
        kw = {"device": "cpu"} if M is P else {}
        M.Cluster(cfg, sc, sanitize=True, **kw)
        reports.append(M.simulate("ring_allreduce", cfg, closed_loop=True, sanitize=True,
                                  collect_segments=False, **kw))
    assert reports[1].meta["sanitized"] is True
    assert reports[1].meta["lockstep_reason"] == (
        "traffic sanitization observes individual write enactments")
    assert _fields(reports[1]) == _fields(reports[0])


def test_cluster_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = P.SimConfig(**FAST).with_devices(4)
    sc = P.get_scenario("ring_allreduce")(cfg, closed_loop=True)
    for call in (lambda: P.Cluster(cfg, sc),
                 lambda: P.simulate("ring_allreduce", cfg, closed_loop=True),
                 lambda: P.SweepRunner("ring_allreduce", cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(SystemExit) as err:
        port_cli.main(["--scenario", "ring_allreduce", "--devices", "4", "--detailed", "all"])
    assert str(err.value.code).startswith("error: no CUDA device")
    assert P.Cluster(cfg, sc, device="cpu").device.type == "cpu"


def _cli_out(main, argv) -> tuple:
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code
    masked = re.sub(r"wall=[0-9.]+ms", "wall=<w>", out.getvalue())
    return code, re.sub(r"built in [0-9.]+ ms", "built in <t>", masked)


CLI_RUNS = {
    "ring8": ["--scenario", "ring_allreduce", "--devices", "8", "--detailed", "all",
              "--engines", "cycle,event", "-p", "workgroups=8"],
    "hier_dci": ["--scenario", "hierarchical_allreduce", "--devices", "8", "--nodes", "2",
                 "--dci-bw", "6.25", "--detailed", "all", "-p", "workgroups=8"],
    "a2a_rail": ["--scenario", "all_to_all", "--devices", "8", "--nodes", "2", "--detailed",
                 "all", "--fabric", "rail_optimized", "-p", "workgroups=8"],
    "fat_link": ["--scenario", "ring_allreduce", "--devices", "8", "--nodes", "4", "--detailed",
                 "all", "--fabric", "fat_tree", "--link", "spine=3.125", "-p", "workgroups=8"],
    "sweep": ["--scenario", "pipeline_p2p", "--devices", "4", "--detailed", "all",
              "--sweep", "microbatches=2,3", "-p", "workgroups=8"],
    "list_fabrics": ["--list-fabrics"],
    "bad_nodes": ["--scenario", "ring_allreduce", "--devices", "8", "--nodes", "3",
                  "--detailed", "all"],
    "bad_fabric": ["--fabric", "nope", "--detailed", "all"],
    "bad_class": ["--scenario", "ring_allreduce", "--devices", "8", "--nodes", "2",
                  "--detailed", "all", "--fabric", "rail_optimized", "--dci-bw", "5"],
    "bad_link": ["--scenario", "ring_allreduce", "--devices", "8", "--detailed", "all",
                 "--link", "ici"],
    "gemv_closed": ["--scenario", "gemv_allreduce", "--detailed", "all"],
}
TIERED_RUNS = ("hier_dci", "a2a_rail", "fat_link")


@pytest.mark.parametrize("run", sorted(CLI_RUNS))
def test_cli_closed_loop_equals_the_reference(run):
    argv = CLI_RUNS[run]
    ref = _cli_out(ref_cli.main, argv)
    port = _cli_out(port_cli.main, ["--device", "cpu", *argv])
    if port[0] not in (0, None):  # an error: the same message, exit 1
        assert str(port[0]).startswith("error: ")
    if run in TIERED_RUNS:  # both engage their tiered solvers
        assert "lockstep: engaged" in port[1]
    assert port == ref


EGPU_STREAMS = {
    "uniform": lambda E: E.uniform_stream(3, 40, 20_000.0, seed=5),
    "poisson": lambda E: E.poisson_stream(3, 2.5, 30_000.0, seed=6),
    "burst": lambda E: E.burst_stream(3, 4, 6, 50_000.0, burst_width_ns=150.0, seed=7),
    "periodic": lambda E: E.periodic_stream(3, 2_500.0, 20_000.0, phase_ns=100.0),
}


@pytest.mark.parametrize("stream", sorted(EGPU_STREAMS))
def test_egpu_streams_equal_the_reference(stream):
    from repro.core import egpu as ref_egpu
    from repro_torch.core import egpu as port_egpu

    ref, port = EGPU_STREAMS[stream](ref_egpu), EGPU_STREAMS[stream](port_egpu)
    assert port.to_json() == ref.to_json()
    merged = {M: E.merge_streams(EGPU_STREAMS[stream](E), E.periodic_stream(3, 900.0, 5_000.0))
              for M, E in ((R, ref_egpu), (P, port_egpu))}
    assert merged[P].to_json() == merged[R].to_json() and len(merged[P]) > len(port)
    # the stream drives the open loop as the reference's does
    cfg = {M: M.SimConfig(workgroups=16, n_egpus=max(w.src for w in ref)) for M in (R, P)}
    reports = [R.Eidola(cfg[R], ref).run(), P.Eidola(cfg[P], port, device="cpu").run()]
    assert reports[0].flag_reads == reports[1].flag_reads > 0


def test_registry_and_layout_obligations_equal_the_reference():
    from repro.core import scenario as ref_scenario
    from repro_torch.core import scenario as port_scenario

    assert P.list_scenarios() == R.list_scenarios()
    for name in R.list_scenarios():
        ref, port = R.get_scenario(name), P.get_scenario(name)
        assert (port.closed_loop_capable, port.max_devices) == \
            (ref.closed_loop_capable, ref.max_devices)
    assert sorted(port_scenario.LAYOUT_PROOF_OBLIGATIONS) == \
        sorted(ref_scenario.LAYOUT_PROOF_OBLIGATIONS) == sorted(CLOSED_LOOP)
