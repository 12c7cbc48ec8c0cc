"""The port's flat lockstep solver and its ordered scan, against the
reference's solver and the port's own timeline engine, exactly.

- ring_allreduce and all_to_all closed-loop at 2-64 ranks on the flat ring,
  SPIN, no segments (the solver's conditions): the port's solver on
  ``device="cpu"`` engages where the reference's does and its ``Report``
  equals the reference's solver's on every field but the walls (fabric
  ``queued_ns`` floats and port stats included); and it equals the port's
  timeline engine (``lockstep=False``) on every counter: traffic per device,
  span, cycles, WTT, fabric messages, bytes and per-port stats.  The float
  ``queued_ns`` aggregates and the head polls are the two engines' own, as in
  the reference (``repro/core/lockstep.py:40-46``).
- A sweep revisiting a shape reuses the compiled plan, as the reference's.
- The ordered scan's plain version against ``np.add.accumulate`` on inputs
  where any other order of the adds gives another result.
- On the tiered presets both packages engage their tiered solvers, the
  port's ``Report`` equal to the reference's, and ``lockstep=True`` engages
  too (``tests/test_torch_tiered.py`` holds the tiered solver in full).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro_torch.kernels.ordered_scan import (
    ordered_scan,
    ordered_scan_plan,
    ordered_scan_ref,
    ordered_total,
    ordered_total_ref,
)

RANKS = (2, 3, 4, 5, 8, 16, 33, 64)
SOLVED = ("ring_allreduce", "all_to_all")
COUNTERS = ("flag_reads", "nonflag_reads", "kernel_span_ns", "sim_cycles", "wtt_registered",
            "wtt_enacted", "traffic", "per_device", "n_devices")


def _fields(report) -> dict:
    d = dataclasses.asdict(report)
    d.pop("wall_time_s")
    d["meta"].pop("wall_breakdown", None)
    d["meta"]["program_stats"].pop("construct_wall_s")
    return d


def _run(M, name, devices, **kw):
    cfg = M.SimConfig(engine=M.EngineKind.EVENT, workgroups=64)
    if M is P:
        kw.setdefault("device", "cpu")
    return M.simulate(name, cfg, devices=devices, closed_loop=True, collect_segments=False,
                      **kw)


def _counters(report) -> dict:
    fabric = {k: v for k, v in report.meta["fabric"].items() if not k.endswith("queued_ns")}
    return {**{k: getattr(report, k) for k in COUNTERS}, "fabric": fabric}


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", SOLVED)
def test_flat_solver_equals_the_reference_and_the_timeline(name, n):
    ref = _run(R, name, n)
    port = _run(P, name, n)
    assert ref.meta["lockstep_reason"] == port.meta["lockstep_reason"] == "engaged"
    assert port.meta["program_stats"]["lockstep"] is True
    assert _fields(port) == _fields(ref)
    timeline = _run(P, name, n, lockstep=False)
    assert timeline.meta["lockstep_reason"] == "lockstep=False disables the bulk solver"
    assert timeline.meta["engine_impl"] == port.meta["engine_impl"] == "timeline"
    assert _counters(port) == _counters(timeline)
    assert port.flag_reads > 0 and all(type(v) is int for v in port.traffic.values())


@pytest.mark.parametrize("name", SOLVED)
def test_solver_fabric_ports_equal_the_reference(name):
    """The fabric the solver writes back: every port's busy time and stats."""
    fabs = {}
    for M in (R, P):
        cfg = M.SimConfig(engine=M.EngineKind.EVENT, workgroups=64).with_devices(16)
        sc = M.get_scenario(name)(cfg, closed_loop=True)
        kw = {"device": "cpu"} if M is P else {}
        cl = M.Cluster(cfg, sc, collect_segments=False, lockstep=True, **kw)
        cl.run()
        fabs[M] = (dict(cl.fabric._busy_until_ns), {k: list(v) for k, v in
                                                      cl.fabric.port_stats.items()},
                   dict(cl.fabric.stats), cl._seq, dict(cl._data_marks),
                   [n.target.kernel_end_cycle for n in cl.nodes])
    assert fabs[P] == fabs[R]
    assert len(fabs[P][0]) > 0


def test_solver_keeps_its_state_on_the_clusters_device():
    cfg = P.SimConfig(engine=P.EngineKind.EVENT, workgroups=64).with_devices(8)
    sc = P.get_scenario("all_to_all")(cfg, closed_loop=True)
    cl = P.Cluster(cfg, sc, collect_segments=False, device="cpu")
    eng = P.LockstepEngine(cl)
    assert eng.compile() is None
    assert cl.device == torch.device("cpu")
    eng.run()
    assert eng.breakdown["solve_s"] > 0 and "writeback_s" in eng.breakdown


def test_sweep_reuses_the_compiled_plan():
    for M in (R, P):
        kw = {"device": "cpu"} if M is P else {}
        runner = M.SweepRunner("ring_allreduce", M.SimConfig(workgroups=16),
                               engines=[M.EngineKind.EVENT], **kw)
        points = runner.run({"devices": [8], "closed_loop": [True], "payload_bytes": [1 << 20]})
        again = runner.run({"devices": [8], "closed_loop": [True], "payload_bytes": [1 << 20]})
        assert len(runner._plan_cache) == 1
        assert again[0].report.meta["wall_breakdown"]["compile_cached"] == 1.0
        assert again[0].report.flag_reads == points[0].report.flag_reads


def _adversarial(rng, rows: int, cols: int) -> np.ndarray:
    """Columns like [1e16, 1, -1e16, 1, ...] with noise: a sum in any order
    but left to right loses or keeps the ones differently."""
    x = rng.standard_normal((rows, cols))
    x[0::4] += 1e16
    x[1::4] = 1.0
    x[2::4] -= 1e16
    x[3::4] = rng.uniform(0.5, 1.5, x[3::4].shape)
    return x


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (64, 5), (1000, 2), (4096, 1)])
def test_ordered_scan_equals_add_accumulate(shape):
    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    x = _adversarial(rng, *shape)
    want = np.add.accumulate(x, axis=0)
    got = ordered_scan(torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ordered_scan_ref(torch.from_numpy(x)).numpy(), want)
    if shape[0] >= 64:  # the test has teeth: a pairwise order differs
        pairwise = np.ascontiguousarray(x.T).sum(axis=1)  # numpy's pairwise summation
        assert not np.array_equal(pairwise, want[-1])


def test_ordered_scan_refuses_what_it_does_not_take():
    for bad in (torch.zeros(3), torch.zeros((0, 2), dtype=torch.float64),
                torch.zeros((2, 2), dtype=torch.float32)):
        with pytest.raises(ValueError, match="float64"):
            ordered_scan(bad)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64).view(np.int64)


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (64, 5), (1000, 2), (4096, 1)])
def test_ordered_total_equals_the_last_row_of_add_accumulate(shape):
    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    x = _adversarial(rng, *shape)
    want = np.add.accumulate(x, axis=0)[-1]
    for total in (ordered_total, ordered_total_ref):
        got = total(torch.from_numpy(x))
        assert got.dtype == torch.float64 and got.shape == (shape[1],)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_ordered_total_keeps_signed_zeros_and_non_finite_values():
    """Row 0 is copied, not added to +0.0: a column of -0.0 totals -0.0."""
    nan, inf = float("nan"), float("inf")
    x = np.array([[-0.0, -0.0, inf, nan, 1.0, -0.0],
                  [-0.0, 0.0, -inf, 1.0, inf, 1e308],
                  [-0.0, -0.0, 1.0, 2.0, 1.0, 1e308]])
    with np.errstate(invalid="ignore", over="ignore"):  # inf + -inf, 1e308 + 1e308
        want = np.add.accumulate(x, axis=0)
    for scan in (ordered_scan, ordered_scan_ref):
        np.testing.assert_array_equal(_bits(scan(torch.from_numpy(x)).numpy()), _bits(want))
    for total in (ordered_total, ordered_total_ref):
        np.testing.assert_array_equal(_bits(total(torch.from_numpy(x)).numpy()),
                                      _bits(want[-1]))


def test_ordered_total_refuses_what_ordered_scan_refuses():
    for bad in (torch.zeros(3), torch.zeros((0, 2), dtype=torch.float64),
                torch.zeros((2, 0), dtype=torch.float64),
                torch.zeros((2, 2), dtype=torch.float32)):
        for entry in (ordered_scan, ordered_total, ordered_total_ref):
            with pytest.raises(ValueError, match="float64"):
                entry(bad)


@pytest.mark.parametrize("L, R, aligned, plan", [
    (1, 1, True, ("tiny", 8)), (16, 4096, True, ("tiny", 8)), (17, 1, True, ("narrow", 16)),
    (1000, 5, True, ("narrow", 16)), (3000, 15, False, ("narrow", 8)),
    (17, 16, True, ("wide", 16)), (2049, 4096, True, ("wide", 16)),
    (257, 4097, True, ("wide", 8)), (300, 256, False, ("wide", 8)),
])
def test_ordered_scan_plan(L, R, aligned, plan):
    assert ordered_scan_plan(L, R, aligned) == plan


@pytest.mark.parametrize("fabric", ("two_tier", "fat_tree", "rail_optimized"))
@pytest.mark.parametrize("name", ("ring_allreduce", "all_to_all", "hierarchical_allreduce"))
def test_tiered_fabric_falls_back_with_the_reference_counters(name, fabric):
    kw = dict(nodes=4, fabric=fabric)
    ref = _run(R, name, 16, **kw)
    port = _run(P, name, 16, **kw)
    assert ref.meta["lockstep_reason"] == port.meta["lockstep_reason"] == "engaged"
    assert port.meta["engine_impl"] == "timeline"
    assert _fields(port) == _fields(ref)
    forced = _run(P, name, 16, lockstep=True, **kw)
    assert _fields(forced) == _fields(port)


@pytest.mark.parametrize("case", ["segments", "syncmon", "torus2d", "pipeline"])
def test_declined_reasons_equal_the_reference(case):
    kw = {"segments": dict(collect_segments=True), "torus2d": dict(fabric="torus2d")}.get(case, {})
    name = "pipeline_p2p" if case == "pipeline" else "ring_allreduce"
    reports = []
    for M in (R, P):
        cfg = M.SimConfig(engine=M.EngineKind.EVENT, workgroups=16,
                          sync=M.SyncPolicy.SYNCMON if case == "syncmon" else M.SyncPolicy.SPIN)
        extra = {"device": "cpu"} if M is P else {}
        reports.append(M.simulate(name, cfg, devices=8, closed_loop=True,
                                  **{"collect_segments": False, **kw, **extra}))
    assert reports[1].meta["lockstep_reason"] == reports[0].meta["lockstep_reason"] != "engaged"
    assert _fields(reports[1]) == _fields(reports[0])
