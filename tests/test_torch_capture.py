"""The capture bridge: the port's copies of the reference's collective algebra,
roofline and trace lowering, and the capture of a rank's collective schedule.

- The copies (``core/topology.py``, ``core/predictor.py``, ``core/capture.py``'s
  ``schedule_to_trace``, ``core/events.py``, ``configs/shapes.py``) equal the
  reference's bit for bit on numpy-seeded inputs (ops without ``axes``, which
  the reference does not know).
- A trace the port writes loads in ``repro.core.events.TraceBundle`` and
  replays in ``repro.core.Eidola`` (EVENT engine, SPIN and SYNCMON) with the
  reference trace's ``flag_reads`` and ``kernel_span_ns``; in the port's own
  ``Eidola`` it gives the reference's report, field for field.
- Capture equals execution: in a gloo world of 4 CPU ranks on a (2, 2) mesh,
  each rank's executed schedule of one train step of reduced gemma3-1b and
  olmoe-1b-7b (expert-parallel) equals, op for op, the abstract capture of
  that rank (``meta`` tensors, no world): kind, dtype, bytes, group size,
  axes and order; its bytes by collective equal ``EXCHANGED``; and
  ``Mesh.bind_abstract`` gives each rank the coordinates, group sizes and
  group ranks that ``Mesh.bind`` gives it.  A float32 prefill on the bound
  mesh gives the unsharded model's logits, with its schedule captured too.
- An oracle that belongs to neither program: on (2, 2), (1, 4) and (4, 1)
  the float32 data-axis gradient sums of reduced gemma3-1b add up to 4 bytes
  times the local elements of every parameter the batch axes do not shard,
  and the ZeRO-1 all-gathers to the bytes of the new parameter shards, both
  computed from ``param_shardings`` and ``zero1_from_params``, exactly.

The reference is imported inside the tests: the spawned ranks import this
module, which imports no JAX.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cells_for
from repro_torch.core import capture
from repro_torch.core.capture import (CaptureGroup, CollectiveOp, capture_collectives,
                                      schedule_to_trace)
from repro_torch.core.events import TraceBundle
from repro_torch.core.interconnect import H100_SXM, V5E
from repro_torch.core.predictor import predict_step, roofline
from repro_torch.core.topology import Topology
from repro_torch.distributed import collectives, run_world
from repro_torch.distributed.sharding import param_shardings, spec_axes, use_full
from repro_torch.distributed.zero import zero1_from_params
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.roofline import topo_for
from repro_torch.models.model import param_specs

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
TOPOLOGIES = {  # (axis sizes, names, dci axes)
    "single": ((16, 16), ("data", "model"), ("pod",)),
    "multi": ((2, 16, 16), ("pod", "data", "model"), ("pod",)),
    "2x4": ((2, 4), ("data", "model"), ("data",)),
}
WORLD_ARCHS = ("gemma3-1b", "olmoe-1b-7b")
WORLD_SHAPE = ShapeSpec("world", 16, 8, "train")  # B 8 x S 16
WORLD_OPTS = {"microbatches": 2}
PREFILL_SHAPE = ShapeSpec("world_prefill", 16, 4, "prefill")  # B 4 x S 16


def _ref_hw(hw):
    from repro.core.interconnect import HardwareSpec

    names = {f.name for f in dataclasses.fields(HardwareSpec)}
    return HardwareSpec(**{k: v for k, v in dataclasses.asdict(hw).items() if k in names})


def _pair_topologies(name, hw):
    from repro.core.topology import Topology as RefTopology

    sizes, names, dci = TOPOLOGIES[name]
    return Topology(sizes, names, hw, dci), RefTopology(sizes, names, _ref_hw(hw), dci)


def _random_ops(seed, n=60, group_sizes=(1, 2, 4, 16, 32)):
    """Ops as the reference's parser gives them (no axes), from a seed."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = KINDS[rng.integers(len(KINDS))]
        g = int(rng.choice(group_sizes))
        result = int(rng.integers(1, 1 << 30))
        ops.append(CollectiveOp(kind=kind, result_bytes=result,
                                operand_bytes=capture._operand_bytes(kind, result, g),
                                group_size=g, dtype=("bf16", "f32")[rng.integers(2)],
                                line=f"op{len(ops)}"))
    return ops


def _ref_ops(ops):
    from repro.core.hlo_capture import CollectiveOp as RefOp

    return [RefOp(kind=o.kind, result_bytes=o.result_bytes, operand_bytes=o.operand_bytes,
                  group_size=o.group_size, dtype=o.dtype, line=o.line) for o in ops]


@pytest.mark.parametrize("hw", [V5E, H100_SXM], ids=["v5e", "h100"])
@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
def test_collective_algebra_is_the_reference_bit_for_bit(topo_name, hw):
    port, ref = _pair_topologies(topo_name, hw)
    rng = np.random.default_rng(7)
    for _ in range(200):
        kind = KINDS[rng.integers(len(KINDS))]
        nbytes = int(rng.integers(0, 1 << 34))
        axis = port.axis_names[rng.integers(len(port.axis_names))]
        assert dataclasses.astuple(port.collective(kind, nbytes, axis)) == \
            dataclasses.astuple(ref.collective(kind, nbytes, axis))
        assert port.collective(kind, nbytes, axis).arrival_times_s(1e-3) == \
            ref.collective(kind, nbytes, axis).arrival_times_s(1e-3)
        for a in (None, *port.axis_names):
            assert port.flat_collective_seconds(nbytes, a) == ref.flat_collective_seconds(nbytes, a)
    assert port.n_chips == ref.n_chips
    if hw == V5E:
        assert port.describe() == ref.describe()


@pytest.mark.parametrize("hw", [V5E, H100_SXM], ids=["v5e", "h100"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roofline_and_predict_step_are_the_reference_bit_for_bit(seed, hw):
    from repro.core.predictor import predict_step as ref_predict
    from repro.core.predictor import roofline as ref_roofline

    port_topo, ref_topo = _pair_topologies("single", hw)
    ops = _random_ops(seed)
    rng = np.random.default_rng(100 + seed)
    kw = dict(arch="a", shape="s", mesh="single", hlo_flops_per_device=float(rng.uniform(1e9, 1e15)),
              hlo_bytes_per_device=float(rng.uniform(1e6, 1e12)),
              model_flops_total=float(rng.uniform(1e12, 1e18)),
              bytes_per_device_hbm=int(rng.integers(1, 1 << 36)), note="n")
    for coll in ({"collective_ops": ops}, {"collective_bytes_per_device": 123456789},
                 {"collective_ops": ops, "collective_axis": "data"}):
        got = roofline(topo=port_topo, **kw, **coll)
        want = ref_roofline(topo=ref_topo, **kw, **({**coll, "collective_ops": _ref_ops(ops)}
                                                   if "collective_ops" in coll else coll))
        assert got.as_dict() == want.as_dict()
        for overlap in (0.0, 0.35):
            assert predict_step(got, port_topo, ops, overlap_fraction=overlap).as_dict() == \
                ref_predict(want, ref_topo, _ref_ops(ops), overlap_fraction=overlap).as_dict()


@pytest.mark.parametrize("gap", [0.0, 2000.0])
@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
def test_schedule_to_trace_is_the_reference_json_text(topo_name, gap):
    from repro.core.hlo_capture import schedule_to_trace as ref_trace

    port_topo, ref_topo = _pair_topologies(topo_name, V5E)
    ops = _random_ops(11, n=25, group_sizes=(1, 2, 3, 4, 16))
    for axis_for_group in (None, {3: port_topo.axis_names[0]}):
        got = schedule_to_trace(ops, port_topo, axis_for_group=axis_for_group, compute_gap_ns=gap)
        want = ref_trace(_ref_ops(ops), ref_topo, axis_for_group=axis_for_group,
                         compute_gap_ns=gap)
        assert got.to_json() == want.to_json()
        assert (got.span_ns(), got.total_bytes(), len(got)) == \
            (want.span_ns(), want.total_bytes(), len(want))
        assert TraceBundle.from_json(got.to_json()).to_json() == got.to_json()


def test_shapes_and_cells_are_the_reference():
    from repro.configs import REGISTRY as REF_REGISTRY
    from repro.configs.shapes import SHAPES as REF_SHAPES
    from repro.configs.shapes import cells_for as ref_cells_for

    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}
    assert list(SHAPES) == list(REF_SHAPES)
    for arch, fn in REF_REGISTRY.items():
        assert cells_for(get_config(arch)) == ref_cells_for(fn()), arch


def test_h100_spec_and_topology():
    """The data sheet's numbers, and the 8-GPU NVLink nodes of the roofline's
    topology: model (16) crosses nodes on the production meshes."""
    assert (H100_SXM.peak_flops_bf16, H100_SXM.hbm_bw, H100_SXM.ici_link_bw
            * H100_SXM.ici_links_per_axis, H100_SXM.dci_link_bw) == (989e12, 3.35e12, 450e9, 50e9)
    assert topo_for("single", H100_SXM).dci_axes == ("data", "model")
    assert topo_for("multi", H100_SXM).describe() == \
        "<Topology 512 chips: pod=2 (IB), data=16 (IB), model=16 (IB); h100-sxm5>"
    assert topo_for("2x4", H100_SXM).dci_axes == ()
    assert topo_for("4x4", H100_SXM).dci_axes == ("data",)
    # meshes whose spans do not divide 8: inside one node, or groups crossing one
    assert topo_for("2x3", H100_SXM).dci_axes == topo_for("3x2", H100_SXM).dci_axes == ()
    assert topo_for("3x4", H100_SXM).dci_axes == ("data",)
    assert topo_for("2x6", H100_SXM).dci_axes == ("data", "model")
    assert topo_for("single", V5E) == Topology((16, 16), ("data", "model"), V5E)
    # a group over two axes is one ring over both at the slower fabric
    topo = topo_for("4x4", H100_SXM)
    two = topo.collective_on("all-reduce", 1 << 20, ("data", "model"))
    assert (two.axis_size, two.steps) == (16, 30)
    assert two.time_s == pytest.approx(2 * (1 << 20) * 15 // 16 / 50e9 + 30 * 5e-6)
    assert topo.collective_on("all-gather", 64, ("model",)) == topo.collective("all-gather", 64,
                                                                                 "model")


def test_exchanges_over_a_capture_group_record_and_exchange_nothing():
    g = CaptureGroup(("model",), 4, 1)
    t = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    with capture_collectives() as ops:
        r = collectives._all_reduce(t, g)
        a = collectives._all_gather(t, g)
        b = collectives._all_to_all(t.float().reshape(1, 6), g)
        c = collectives._ring_shift(t, g)
    assert torch.equal(r, t) and r.data_ptr() != t.data_ptr()
    assert a.shape == (4, 2, 3) and torch.equal(a[3], t)
    assert torch.equal(b, t.float().reshape(1, 6)) and torch.equal(c, t)
    assert [(o.kind, o.result_bytes, o.operand_bytes, o.group_size, o.dtype, o.axes) for o in ops] == [
        ("all-reduce", 12, 12, 4, "bf16", ("model",)), ("all-gather", 48, 12, 4, "bf16", ("model",)),
        ("all-to-all", 24, 24, 4, "f32", ("model",)),
        ("collective-permute", 12, 12, 4, "bf16", ("model",))]
    assert collectives._own(torch.arange(8), g, 0).tolist() == [2, 3]
    assert collectives.exchange_device(t, g) == t.device
    with capture_collectives() as outer:  # nested captures each receive the op
        with capture_collectives() as inner:
            collectives._all_reduce(t, g)
    assert outer == inner and len(inner) == 1


@pytest.mark.parametrize("sum_over", [("model",), ()], ids=["partial", "whole"])
def test_a_gathered_weight_used_in_part_takes_one_reduce_scatter(sum_over):
    """``use_full`` of a weight cut over ``model`` whose every rank uses a
    part of it (``sum_over``): its gradient is summed over ``model`` and
    this rank's slice kept, as one reduce-scatter of the whole gradient
    (the capture group keeps the rank's chunk of its own); used whole by
    every rank, the gradient is the rank's slice with no exchange."""
    mesh = Mesh({"data": 2, "model": 2}).bind_abstract(3)
    g = CaptureGroup(("model",), 4, 1)
    assert collectives._reduce_scatter(torch.arange(8.).reshape(2, 4), g, 1).tolist() == \
        [[1.], [5.]]
    w = torch.randn(3, 4, requires_grad=True)
    with capture_collectives() as ops:
        full = use_full(w, (None, "model"), mesh, sum_over)
        (full * torch.arange(8.)).sum().backward()
    assert full.shape == (3, 8) and torch.equal(w.grad, torch.arange(4., 8.).expand(3, 4))
    kinds = [(o.kind, o.operand_bytes, o.result_bytes, o.axes) for o in ops]
    assert kinds[0] == ("all-gather", 48, 96, ("model",))
    assert kinds[1:] == ([("reduce-scatter", 96, 48, ("model",))] if sum_over else [])


def _trace_ops(cfg, dims, rank):
    mesh = Mesh({"data": dims[0], "model": dims[1]})
    return trace_cell(cfg, WORLD_SHAPE, mesh, rank, WORLD_OPTS)


def test_port_trace_replays_in_the_reference_simulator():
    from repro.core import EngineKind, Eidola, SimConfig, SyncPolicy
    from repro.core.events import TraceBundle as RefBundle
    from repro.core.hlo_capture import schedule_to_trace as ref_trace
    from repro.core.topology import Topology as RefTopology

    ops = _trace_ops(reduced(get_config("gemma3-1b")), (2, 2), 0)["ops"]
    assert ops and all(o.axes for o in ops)
    bare = [dataclasses.replace(o, axes=()) for o in ops]
    topo = Topology((2, 2), ("data", "model"), V5E)
    ref_topo = RefTopology((2, 2), ("data", "model"))
    port_json = schedule_to_trace(bare, topo, compute_gap_ns=2000.0).to_json()
    want = ref_trace(_ref_ops(bare), ref_topo, compute_gap_ns=2000.0)
    assert port_json == want.to_json()
    with_axes = RefBundle.from_json(schedule_to_trace(ops, topo, compute_gap_ns=2000.0).to_json())
    for sync in (SyncPolicy.SPIN, SyncPolicy.SYNCMON):
        cfg = SimConfig(sync=sync, engine=EngineKind.EVENT)
        got = Eidola(cfg, RefBundle.from_json(port_json)).run()
        ref = Eidola(cfg, want).run()
        assert (got.flag_reads, got.kernel_span_ns) == (ref.flag_reads, ref.kernel_span_ns)
        assert got.flag_reads > 0
        # the ops priced on their own axes replay too
        assert Eidola(cfg, with_axes).run().kernel_span_ns > 0


def test_port_trace_replays_in_the_port_simulator():
    from repro.core import EngineKind as RefEngine, Eidola as RefEidola
    from repro.core import SimConfig as RefConfig, SyncPolicy as RefSync
    from repro.core.events import TraceBundle as RefBundle

    from repro_torch.core import EngineKind, Eidola, SimConfig, SyncPolicy

    ops = _trace_ops(reduced(get_config("gemma3-1b")), (2, 2), 0)["ops"]
    bundle = schedule_to_trace(ops, Topology((2, 2), ("data", "model"), V5E),
                               compute_gap_ns=2000.0)
    for sync in ("spin", "syncmon"):
        got = Eidola(SimConfig(sync=SyncPolicy(sync), engine=EngineKind.EVENT),
                     TraceBundle.from_json(bundle.to_json()), device="cpu").run()
        ref = RefEidola(RefConfig(sync=RefSync(sync), engine=RefEngine.EVENT),
                        RefBundle.from_json(bundle.to_json())).run()
        want = dataclasses.asdict(ref)
        have = dataclasses.asdict(got)
        want.pop("wall_time_s"), have.pop("wall_time_s")
        assert have == want
        assert got.flag_reads > 0 and got.kernel_span_ns > 0
        assert got.wtt_enacted == len(bundle)


def _rank_schedules(rank, world, archs, dims):
    """One rank: each arch's train step on ``dims`` in the gloo world, its
    schedule captured; ``EXCHANGED``; and its groups as ``bind`` makes them."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import EXCHANGED
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.launch.specs import rank_rows
    from repro_torch.models import Model
    from repro_torch.training import TrainConfig, build_train_step

    mesh = Mesh({"data": dims[0], "model": dims[1]})
    bound = mesh.bind()
    groups = {axes: (dist.get_world_size(g), dist.get_rank(g)) for axes, g in bound._groups.items()}
    out = {"coord": bound.coord, "groups": groups}
    rng = np.random.default_rng(0)
    for arch in archs:
        cfg = reduced(get_config(arch))
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (WORLD_SHAPE.global_batch,
                                                             WORLD_SHAPE.seq_len)).astype(np.int32))
        model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        step = build_train_step(model, TrainConfig(**WORLD_OPTS), bound)
        state = step.init_state()
        EXCHANGED.clear()
        with capture_collectives() as ops:
            step(state, tokens, tokens)
        out[arch] = {"ops": [dataclasses.asdict(o) for o in ops], "exchanged": dict(EXCHANGED)}
    # prefill on the bound mesh against the unsharded model, float32
    cfg = reduced(get_config("gemma3-1b")).with_(param_dtype=torch.float32)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (PREFILL_SHAPE.global_batch,
                                                         PREFILL_SHAPE.seq_len)).astype(np.int32))
    full = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    sharded = Model(cfg, device="cpu")
    sharded.load_state_dict(full.state_dict())
    shard_params(sharded, bound)
    rows = rank_rows(tokens, bound)
    with capture_collectives() as ops:
        logits, caches = sharded.prefill(rows)
    want, _ = full.prefill(rows)
    out["prefill"] = {"ops": [dataclasses.asdict(o) for o in ops], "shape": list(logits.shape),
                      "max_abs_err": float((logits - want).abs().max()),
                      "k_shape": list(caches[0]["k"].shape)}
    return out


@pytest.fixture(scope="module")
def world():
    return run_world(_rank_schedules, 4, WORLD_ARCHS, (2, 2), timeout=300)


@pytest.mark.parametrize("arch", WORLD_ARCHS)
def test_each_ranks_executed_schedule_is_its_abstract_capture(world, arch):
    cfg = reduced(get_config(arch))
    for rank, got in enumerate(world):
        ops = _trace_ops(cfg, (2, 2), rank)["ops"]
        executed = [CollectiveOp(**{**d, "axes": tuple(d["axes"])}) for d in got[arch]["ops"]]
        assert len(executed) == len(ops) > 0
        for i, (a, b) in enumerate(zip(executed, ops)):
            assert a == b, (rank, i, a, b)
        sums = {}
        for o in executed:
            name = {v: k for k, v in capture.KINDS.items()}[o.kind]
            sums[name] = sums.get(name, 0) + o.operand_bytes
        assert sums == got[arch]["exchanged"]
    if arch == "olmoe-1b-7b":
        assert any(o["kind"] == "all-to-all" for o in world[0][arch]["ops"])


def test_prefill_on_the_bound_mesh_and_its_capture(world):
    """float32 reduced gemma3-1b: each rank's prefill of its rows on (2, 2)
    gives the unsharded model's last-token logits over the whole vocabulary
    (within 1e-5), caches for its rows (the single KV head, which every
    model rank gathers), and its schedule is its abstract capture."""
    cfg = reduced(get_config("gemma3-1b")).with_(param_dtype=torch.float32)
    for rank, got in enumerate(world):
        pre = got["prefill"]
        assert pre["shape"] == [PREFILL_SHAPE.global_batch // 2, cfg.vocab]
        assert pre["max_abs_err"] < 1e-5
        assert pre["k_shape"] == [PREFILL_SHAPE.global_batch // 2, PREFILL_SHAPE.seq_len,
                                  cfg.n_kv_heads, cfg.hd]
        ops = trace_cell(cfg, PREFILL_SHAPE, Mesh({"data": 2, "model": 2}), rank)["ops"]
        executed = [CollectiveOp(**{**d, "axes": tuple(d["axes"])}) for d in pre["ops"]]
        assert executed == ops and ops


def test_bind_abstract_gives_each_rank_what_bind_gives(world):
    mesh = Mesh({"data": 2, "model": 2})
    for rank, got in enumerate(world):
        abstract = mesh.bind_abstract(rank)
        assert abstract.coord == got["coord"]
        assert {axes: (g.size, g.rank) for axes, g in abstract._groups.items()} == got["groups"]


@pytest.mark.parametrize("dims", [(2, 2), (1, 4), (4, 1)], ids=["2x2", "1x4", "4x1"])
def test_gradient_sums_and_zero_gathers_match_the_oracle(dims):
    """The oracle from the sharding rules alone.  The step's schedule ends
    with the gradient sums over ``data`` (a parameter the batch axes do not
    shard), then the global norm's all-reduce over every axis, then the
    ZeRO-1 all-gathers of the new parameter pieces."""
    cfg = reduced(get_config("gemma3-1b"))
    mesh = Mesh({"data": dims[0], "model": dims[1]})
    specs = param_specs(cfg)
    pspecs, _ = param_shardings(specs, mesh)
    shapes = {k: s.shape for k, s in specs.items()}
    zspecs = zero1_from_params(pspecs, shapes, mesh, ("data",))
    local = {k: math.prod(s.shape) // mesh.axis_size(spec_axes(pspecs[k])) for k, s in specs.items()}
    summed = [k for k in specs if "data" not in spec_axes(pspecs[k])]
    # a piece is gathered where ZeRO-1 cuts the parameter's shard again
    # over data; with one data rank there is nothing to gather
    pieces = [k for k in specs if zspecs[k] != pspecs[k]] if dims[0] > 1 else []
    want_sums = 4 * sum(local[k] for k in summed) if dims[0] > 1 else 0
    want_gathers = sum(local[k] // dims[0] * specs[k].dtype.itemsize for k in pieces)
    for rank in range(4):
        ops = _trace_ops(cfg, dims, rank)["ops"]
        norm = max(i for i, o in enumerate(ops) if o.axes == ("data", "model"))
        assert ops[norm].kind == "all-reduce" and ops[norm].operand_bytes == 4
        n_sums = len(summed) if dims[0] > 1 else 0
        sums, gathers = ops[norm - n_sums:norm], ops[norm + 1:]
        assert all((o.kind, o.dtype, o.axes) == ("all-reduce", "f32", ("data",)) for o in sums)
        assert sum(o.operand_bytes for o in sums) == want_sums
        assert all((o.kind, o.axes) == ("all-gather", ("data",)) for o in gathers)
        assert len(gathers) == len(pieces) and sum(o.operand_bytes for o in gathers) == want_gathers
