"""The port's tiered lockstep solver and its two kernels' plain versions,
against the reference's solver and the port's own timeline engine, exactly.

- every closed-loop scenario on ``two_tier``, ``fat_tree`` and
  ``rail_optimized`` at 12 devices, 4 a node, the reference's three seeded
  shapes (``tests/test_tiered_lockstep.py``) and hierarchical_allreduce at 33
  devices, 3 a node: the port (``device="cpu"``) gives the reference's
  ``lockstep_reason``, and where the solver engages its ``Report`` equals the
  reference's on every field but the walls (the fabric's float ``queued_ns``
  included), the fabric it writes back (every port's busy time and stats)
  equals the reference's, and every counter equals the port's own timeline
  engine's;
- the group schedule replays each rank's ``SymbolicProgram.expand()``;
- the refusals: the legacy map's marker alias (512 devices, 2 a node) under
  ``lockstep=True``, ``torus2d`` outside the presets, pipeline_p2p's blame;
- hierarchical_allreduce at 512 devices, 2 a node, engaging;
- the plain port chain against the reference's ``_chain`` (restart runs,
  ties, busy runs past the 32 and 64 chunk doublings) and the plain numpy
  sum against ``np.sum`` at lengths 1-299, 1,000, 4,095-4,097 and
  8,191-8,193, 16,385 and 65,280, where a left-to-right sum differs;
- the numpy-sum kernel's launch plan at its extremes, and its constants
  (read from its source) against the plain version's tree.
"""

import dataclasses
import functools
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.lockstep_tiered import _chain
from repro_torch.kernels.numpy_sum import (BLOCK, LEAF, numpy_sum, numpy_sum_plan,
                                           numpy_sum_ref)
from repro_torch.kernels.port_chain import port_chain, port_chain_ref

TIERED = ("two_tier", "fat_tree", "rail_optimized")
CLOSED_LOOP = ("ring_allreduce", "all_to_all", "hierarchical_allreduce", "pipeline_p2p")
COUNTERS = ("flag_reads", "nonflag_reads", "kernel_span_ns", "sim_cycles", "wtt_registered",
            "wtt_enacted", "traffic", "per_device", "n_devices")


def _fields(report) -> dict:
    d = dataclasses.asdict(report)
    d.pop("wall_time_s")
    d["meta"].pop("wall_breakdown", None)
    d["meta"]["program_stats"].pop("construct_wall_s")
    return d


def _counters(report) -> dict:
    fabric = {k: v for k, v in report.meta["fabric"].items() if not k.endswith("queued_ns")}
    return {**{k: getattr(report, k) for k in COUNTERS}, "fabric": fabric}


def _cluster(M, name, n, dpn, fabric, workgroups=4, **kw):
    cfg = M.SimConfig(engine=M.EngineKind.EVENT, workgroups=workgroups).with_devices(n)
    sc = M.get_scenario(name)(cfg, closed_loop=True, devices_per_node=dpn, fabric=fabric)
    if M is P:
        kw["device"] = "cpu"
    return M.Cluster(cfg, sc, collect_segments=False, **kw)


def _check(name, n, dpn, fabric, workgroups=4):
    """The port's report and fabric against the reference's, and its solver
    against its timeline engine."""
    clusters = [_cluster(M, name, n, dpn, fabric, workgroups) for M in (R, P)]
    ref, port = (c.run() for c in clusters)
    assert port.meta["lockstep_reason"] == ref.meta["lockstep_reason"]
    assert _fields(port) == _fields(ref)
    fabs = [c.fabric for c in clusters]
    assert fabs[1]._busy_until_ns == fabs[0]._busy_until_ns
    assert fabs[1].port_stats == fabs[0].port_stats
    if port.meta["lockstep_reason"] == "engaged":
        timeline = _cluster(P, name, n, dpn, fabric, workgroups, lockstep=False).run()
        assert timeline.meta["engine_impl"] == "timeline"
        assert _counters(timeline) == _counters(port)
    return port


@pytest.mark.parametrize("fabric", TIERED)
@pytest.mark.parametrize("name", CLOSED_LOOP)
def test_tiered_solver_equals_the_reference(name, fabric):
    port = _check(name, 12, 4, fabric)
    if name == "pipeline_p2p":  # cross-group pipelined chains: declined with blame
        assert "of group 'interior'" in port.meta["lockstep_reason"]
    else:
        assert port.meta["lockstep_reason"] == "engaged"
        assert port.meta["program_stats"]["lockstep"] is True


def _seeded_shapes():
    rng = random.Random(0x51D07A)  # the reference's seeded draw, in its order
    names = ["ring_allreduce", "all_to_all", "hierarchical_allreduce"]
    shapes = []
    for _ in range(3):
        name, fabric, dpn = rng.choice(names), rng.choice(TIERED), rng.choice([2, 3, 4])
        shapes.append((name, dpn * rng.randint(2, 5), dpn, fabric))
    return shapes + [("hierarchical_allreduce", 33, 3, "two_tier")]


@pytest.mark.parametrize("name,n,dpn,fabric", _seeded_shapes())
def test_seeded_shapes_equal_the_reference(name, n, dpn, fabric):
    assert _check(name, n, dpn, fabric).meta["lockstep_reason"] == "engaged"


@pytest.mark.parametrize("name,n,dpn", [("ring_allreduce", 12, 4), ("all_to_all", 12, 4),
                                        ("hierarchical_allreduce", 12, 4),
                                        ("hierarchical_allreduce", 33, 3)])
def test_group_schedule_roundtrips_expand(name, n, dpn):
    from repro_torch.core.lockstep_tiered import compile_tiered
    from repro_torch.core.scenario import as_symbolic

    cluster = _cluster(P, name, n, dpn, "two_tier")
    plan = compile_tiered(cluster)
    seen = set()
    for grp in plan.groups:
        sched = [ph.name for seg in grp.segs for _ in range(seg.count) for ph in seg.body]
        for dev in grp.devs.tolist():
            seen.add(dev)
            sp = as_symbolic(cluster.scenario.programs_for(dev)[0].phases)
            assert sched == [p.name for p in sp.expand()], (name, dev)
    assert seen == set(range(n))


def test_marker_alias_declines_with_the_reference_blame():
    msgs = []
    for M in (R, P):
        legacy = M.AddressMap(n_devices=512, flag_slots=513)
        assert legacy.flag_region()[1] > legacy.partial_base
        cfg = M.SimConfig(engine=M.EngineKind.EVENT, workgroups=4).with_devices(512)
        kw = {"device": "cpu"} if M is P else {}
        with pytest.raises(ValueError) as err:
            M.simulate("hierarchical_allreduce", cfg, devices=512, closed_loop=True,
                       collect_segments=False, devices_per_node=2, fabric="two_tier",
                       lockstep=True, amap=legacy, **kw)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]
    assert "data-marker writes on rank" in msgs[1] and "reach flag (writer" in msgs[1]


def test_torus2d_is_outside_the_tiered_presets():
    from repro.core.lockstep import UnsupportedProgram as RefUnsupported
    from repro.core.lockstep_tiered import compile_tiered as ref_compile
    from repro_torch.core.lockstep import UnsupportedProgram
    from repro_torch.core.lockstep_tiered import compile_tiered

    msgs = []
    for M, compile_, exc in ((R, ref_compile, RefUnsupported),
                             (P, compile_tiered, UnsupportedProgram)):
        cfg = M.SimConfig(engine=M.EngineKind.EVENT, workgroups=4).with_devices(8)
        sc = M.get_scenario("ring_allreduce")(cfg, closed_loop=True, fabric="torus2d")
        cluster = M.Cluster(cfg, sc, collect_segments=False,
                            **({"device": "cpu"} if M is P else {}))
        with pytest.raises(exc) as err:
            compile_(cluster)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0] and "outside the tiered solver's presets" in msgs[1]


def test_hierarchical_pod_engages():
    port = _cluster(P, "hierarchical_allreduce", 512, 2, "two_tier", lockstep=True).run()
    ref = _cluster(R, "hierarchical_allreduce", 512, 2, "two_tier", lockstep=True).run()
    assert port.meta["lockstep_reason"] == "engaged"
    assert _fields(port) == _fields(ref)


def _reference_chain_case(rng, kind: str):
    """Ready times, the busy time before them and the serialization time."""
    ser = 0.37 + rng.random()
    if kind == "restarts":  # the port drains between touches
        rdy = np.cumsum(ser + 0.5 + rng.random(40))
    elif kind == "ties":  # ready exactly at the busy time, and repeated
        rdy = np.repeat(np.arange(12) * ser * 3.0, 3)
    else:  # busy runs of 100 and 300 touches (chunks of 32, 64 and 128), a restart
        rdy = np.concatenate((np.full(100, 1.0), np.full(300, 1.0e4) + rng.random(300)))
    return rdy.astype(np.float64), float(rng.random()), ser


@pytest.mark.parametrize("kind", ("restarts", "ties", "long_runs"))
def test_plain_port_chain_equals_the_reference_chain(kind):
    rng = np.random.default_rng({"restarts": 1, "ties": 2, "long_runs": 3}[kind])
    rdys, b0s, sers, qd0s = [], [], [], []
    for _ in range(3):  # three ports in one call
        rdy, b0, ser = _reference_chain_case(rng, kind)
        rdys.append(rdy), b0s.append(b0), sers.append(ser), qd0s.append(rng.random())
    offs = torch.tensor(np.concatenate(([0], np.cumsum([len(r) for r in rdys]))))
    port = torch.tensor([2, 0, 4])
    busy = torch.zeros(5, dtype=torch.float64)
    qd = torch.zeros(5, dtype=torch.float64)
    f64 = torch.float64
    busy[port], qd[port] = torch.tensor(b0s, dtype=f64), torch.tensor(qd0s, dtype=f64)
    starts = port_chain(torch.tensor(np.concatenate(rdys)), offs, port,
                        torch.tensor(sers, dtype=f64), busy, qd)
    for i, (rdy, b0, ser, qd0) in enumerate(zip(rdys, b0s, sers, qd0s)):
        want, bfin = _chain(b0, rdy, ser)
        got = starts[offs[i]:offs[i + 1]].numpy()
        assert np.array_equal(got, want) and busy[port[i]].item() == bfin
        assert qd[port[i]].item() == float(np.cumsum(np.concatenate(([qd0], want - rdy)))[-1])
    # the plain version is what the CPU dispatch runs
    busy2, qd2 = busy.clone(), qd.clone()
    busy2[port], qd2[port] = torch.tensor(b0s, dtype=f64), torch.tensor(qd0s, dtype=f64)
    again = port_chain_ref(torch.tensor(np.concatenate(rdys)), offs, port,
                           torch.tensor(sers, dtype=f64), busy2, qd2)
    assert torch.equal(again, starts) and torch.equal(busy2, busy) and torch.equal(qd2, qd)


def test_port_chain_refuses_what_it_does_not_take():
    z = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="float64 rdy"):
        port_chain(z.float(), torch.tensor([0, 3]), torch.tensor([0]), z[:1], z, z)


SUM_LENGTHS = [*range(1, 300), 1000, 4095, 4096, 4097, 8191, 8192, 8193, 16385, 65280]


def test_plain_numpy_sum_equals_np_sum():
    rng = np.random.default_rng(7)
    xs = [rng.random(n) * 10.0 ** rng.integers(-4, 4, n) for n in SUM_LENGTHS]
    offs = torch.tensor(np.concatenate(([0], np.cumsum(SUM_LENGTHS))))
    got = numpy_sum(torch.tensor(np.concatenate(xs)), offs).numpy()
    want = np.array([np.sum(x) for x in xs])
    assert np.array_equal(got, want)
    # the order matters: a left-to-right sum differs at most lengths
    left_to_right = np.array([np.cumsum(x)[-1] for x in xs])
    assert (left_to_right != want).sum() > len(SUM_LENGTHS) // 2
    assert numpy_sum_ref(torch.zeros(0, dtype=torch.float64), torch.zeros(1, dtype=torch.int64)
                         ).numel() == 0


def test_numpy_sum_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="float64"):
        numpy_sum(torch.zeros(3), torch.tensor([0, 3]))


@pytest.mark.parametrize("S,T,plan", [
    (0, 0, (0, 1)),                       # no segment
    (5, 0, (5, 1)),                       # an empty x: five empty segments
    (1, 1 << 20, (128, 128)),             # one segment of 2^20: 127 later blocks
    (100_000, 100_000, (100_012, 13)),    # 10^5 one-element segments
    (256, 256 * 65_280, (2_295, 2_040)),  # the level of 256 up ports
])
def test_numpy_sum_plan_at_its_extremes(S, T, plan):
    """The grid is ``S`` plus one CTA a later 8,192-element window of x; the
    workspace has a slot a window (window 0 too)."""
    got = numpy_sum_plan(S, T)
    assert (got.ctas, got.windows) == plan
    with pytest.raises(ValueError, match="S >= 0"):
        numpy_sum_plan(-1, T)
    with pytest.raises(ValueError, match="more than a grid"):
        numpy_sum_plan(2**31, 0)


@functools.lru_cache(maxsize=None)
def _tree_depth(n):
    if n <= LEAF:
        return 0
    m2 = (n // 2) & ~7
    return 1 + max(_tree_depth(m2), _tree_depth(n - m2))


def test_numpy_sum_tree_is_at_most_7_deep():
    """The kernel names a block's nodes by 7-bit paths: its block, leaf and
    depth constants, read from its source, are the plain version's and hold
    numpy's deepest tree."""
    src = (Path(numpy_sum_ref.__code__.co_filename).parent / "csrc" / "numpy_sum.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr \w+ (k\w+) = (\d+);", src)}
    assert (const["kBlock"], const["kLeaf"]) == (BLOCK, LEAF)
    assert max(_tree_depth(n) for n in range(1, BLOCK + 1)) == const["kDepth"] == 7
