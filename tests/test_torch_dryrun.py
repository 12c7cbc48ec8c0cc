"""The port's dry run (``launch/dryrun.py``), its costs (``core/cost.py``) and
its roofline (``launch/roofline.py``), on ``meta`` tensors: no world, no
device memory, no card.

Dot FLOPs against the reference: ``analyze_hlo(...).dot_flops()`` of the
compiled ``jax.value_and_grad(Model.loss_fn)`` against the port's counted
dot FLOPs of ``loss_fn`` and its backward, one device, B 2 x S 32, reduced
configs.  xlstm-125m agrees within 1%.  The other two differ by more, and
each difference is pinned exactly to its cause, read off the compiled
module's dot shapes:

- gemma3-1b (one KV head for 4 query heads): XLA's module issues 11 products
  of the attention's size a layer, the port 6 (scores and PV forward; dP,
  dV, dQ, dK backward).  XLA's has the forward's scores and PV twice and dQ,
  dK and dV each in a second layout: 5 more a layer.  Every other product
  matches: the port's count is exactly 3 x its forward.
- olmoe-1b-7b: XLA's CPU backend lowers ``ragged_dot`` to a dense product
  over all 8 experts (contraction experts x d), 8 times the routed product;
  the port counts ``_grouped_mm``'s rows (``core/cost.py``).  The difference
  is 7 x the port's expert products.
"""

import json

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.core.capture import CollectiveOp
from repro_torch.core.cost import count_cost, grouped_mm_flop, output_bytes
from repro_torch.core.events import TraceBundle
from repro_torch.kernels import ops
from repro_torch.distributed.sharding import shard_params
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import Mesh, make_mesh_by_name
from repro_torch.models import Model
from repro_torch.models.model import decode_launches, layer_blocks

B, S = 2, 32


def _attention_product(cfg) -> int:
    """FLOPs of one attention-sized product (scores or PV) at B x S."""
    return 2 * B * cfg.n_heads * S * S * cfg.hd


def _forward_dot_flops(cfg) -> int:
    """The dense configs' forward products at B x S, counted by hand."""
    T, d, hd = B * S, cfg.d_model, cfg.hd
    proj = 2 * T * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)   # q, k, v, o
    mlp = 3 * 2 * T * d * cfg.d_ff
    return cfg.n_layers * (proj + mlp + 2 * _attention_product(cfg)) + 2 * T * d * cfg.vocab


def _reference_dot_flops(arch: str) -> float:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.configs import reduced as ref_reduced
    from repro.core.hlo_analyzer import analyze_hlo
    from repro.models import Model as RefModel

    model = RefModel(ref_reduced(ref_config(arch)))
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    text = jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True)).lower(
        model.abstract_params(), tokens).compile().as_text()
    return analyze_hlo(text).dot_flops()


def _port_dot_flops(cfg) -> int:
    model = Model.abstract(cfg)
    model.requires_grad_(True)
    with count_cost() as cost:
        loss, _ = model.loss_fn(torch.empty(B, S, dtype=torch.int32, device="meta"))
        loss.backward()
    assert cost.kernel_calls == {"rmsnorm": decode_launches(cfg)["rmsnorm"],
                                 "rmsnorm_bwd": decode_launches(cfg)["rmsnorm"]}
    return cost.dot_flops


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b", "xlstm-125m"])
def test_dot_flops_against_the_reference(arch):
    cfg = reduced(get_config(arch))
    got, want = _port_dot_flops(cfg), _reference_dot_flops(arch)
    if arch == "xlstm-125m":
        assert abs(got - want) <= 0.01 * want
    elif arch == "gemma3-1b":
        assert got == 3 * _forward_dot_flops(cfg)
        assert want - got == 5 * cfg.n_layers * _attention_product(cfg)
        assert got / want == pytest.approx(0.9264705882352942, abs=1e-15)
    else:
        T, k = B * S, cfg.experts_per_token
        experts = 3 * 3 * 2 * T * k * cfg.d_model * cfg.d_ff * (cfg.n_layers
                                                                 - cfg.first_dense_layers)
        assert want - got == (cfg.n_experts - 1) * experts


def test_grouped_mm_formula_and_costs_on_meta():
    assert grouped_mm_flop((64, 32), (4, 32, 16)) == 2 * 64 * 32 * 16
    assert grouped_mm_flop((16, 64), (64, 8)) == 2 * 16 * 64 * 8      # the groups cut K
    x = torch.empty(64, 32, device="meta", dtype=torch.bfloat16, requires_grad=True)
    w = torch.empty(4, 32, 16, device="meta", dtype=torch.bfloat16, requires_grad=True)
    g = torch.empty(32, device="meta", dtype=torch.bfloat16, requires_grad=True)
    offs = torch.empty(4, device="meta", dtype=torch.int32)
    with count_cost([x, w, g]) as cost:
        h = ops.rmsnorm(x, g)
        y = torch._grouped_mm(h, w, offs=offs)
        y.float().sum().backward()
    assert cost.dot_flops == 3 * 2 * 64 * 32 * 16
    assert cost.kernel_calls == {"rmsnorm": 1, "rmsnorm_bwd": 1}
    assert cost.argument_bytes == (64 * 32 + 4 * 32 * 16 + 32) * 2
    assert x.grad.shape == x.shape and g.grad.shape == g.shape and w.grad.shape == w.shape


def test_peak_live_bytes_follow_the_storages():
    x = torch.empty(1000, device="meta")
    with count_cost([x]) as cost:
        ys = [x * 2 for _ in range(5)]  # five results alive at once
        del ys
        z = x + 1
        v = z.view(10, 100)  # a view moves nothing
        out = v.t().contiguous()
    assert (cost.argument_bytes, cost.peak_live_bytes) == (4000, 24000)
    assert cost.bytes == 5 * 8000 + 8000 + 8000  # each op's operand and result
    assert output_bytes((out, x), [x]) == 4000


def test_the_cpu_path_calls_no_kernel_operator():
    x = torch.randn(4, 64, requires_grad=True)
    g = torch.zeros(64, requires_grad=True)
    with count_cost() as cost:
        ops.rmsnorm(x, g).sum().backward()
    assert cost.kernel_calls == {} and x.grad is not None


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_cells_on_a_2x2_abstract_mesh(arch, shape):
    cfg = reduced(get_config(arch))
    opts = {"microbatches": 2} if shape == "train_4k" else {}
    rec = dryrun.run_cell(arch, shape, "2x2", opts, rank=3, cfg=cfg, verbose=False)
    if shape == "long_500k" and not cfg.supports_500k:
        assert rec["status"] == "skipped"
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["coord"] == {"data": 1, "model": 1} and rec["axes"] == {"data": 2, "model": 2}
    assert min(rec["flops_per_device"], rec["bytes_per_device"],
               rec["collective_bytes_per_device"]) > 0
    norms = decode_launches(cfg)["rmsnorm"]
    if shape == "train_4k":
        assert rec["kernel_calls"] == {"rmsnorm": 2 * norms, "rmsnorm_bwd": 2 * norms}
        mem = rec["memory"]
        # .grad in the param dtype, and float32 accumulators with microbatches
        assert mem["state_bytes"] > 0 and mem["grad_buffer_bytes"] > 2 * mem["param_bytes"]
    elif SHAPES[shape].mode == "decode":
        # one launch of each kernel a norm and a GQA block, as on the card;
        # long_500k's one row is sequence-parallel over data (its partial entry)
        assert rec["kernel_calls"] == decode_launches(cfg)
        assert rec["memory"]["cache_bytes"] > 0
        kinds = {"decode_32k": {"all-reduce"}, "long_500k": {"all-reduce", "all-gather"}}
        assert kinds[shape] <= set(rec["collectives"])
    else:
        assert rec["kernel_calls"] == {"rmsnorm": norms}
    assert rec["hbm_bytes_per_device"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["n_collective_ops"] == len(rec["collective_schedule"])
    assert sum(v["bytes"] for v in rec["collectives"].values()) == \
        rec["collective_bytes_per_device"]
    factor = 6.0 if shape == "train_4k" else 2.0
    tokens = SHAPES[shape].global_batch if SHAPES[shape].mode == "decode" else SHAPES[shape].tokens
    assert rec["model_flops"] == factor * rec["n_active_params"] * tokens


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_cli_full_gemma3_1b_train_cell_and_its_trace(tmp_path, mesh):
    out = str(tmp_path)
    dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--mesh", mesh, "--trace",
                 "--out", out])
    with open(dryrun.cell_path(out, "gemma3-1b", "train_4k", mesh)) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["collective_schedule"]
    assert rec["kernel_calls"] == {"rmsnorm": 53, "rmsnorm_bwd": 53}  # one microbatch
    assert rec["memory"]["param_bytes"] > 0 and rec["n_params"] == Model.abstract(
        get_config("gemma3-1b")).n_params()
    ops_ = dryrun.schedule_of(rec)
    assert all(isinstance(o, CollectiveOp) and o.axes for o in ops_)
    bundle = TraceBundle.load(dryrun.trace_path(out, "gemma3-1b", "train_4k", mesh))
    assert len(bundle) > len(ops_) and bundle.span_ns() > 0
    assert "h100-sxm5" in bundle.meta["topology"]
    for hw in ("h100", "v5e"):
        table = str(tmp_path / "tables" / f"roofline_{hw}")
        roofline.main(["--dir", out, "--hw", hw, "--json", table + ".json", "--md", table + ".md"])
        with open(table + ".json") as f:
            rows = json.load(f)
        assert [r["dominant"] for r in rows if r["status"] == "ok"] and \
            all(r["compute_s"] > 0 and r["collective_s"] > 0 for r in rows)


def test_cli_decode_cell_is_not_ported_and_refuses_foreign_options(tmp_path):
    """The decode cell runs from the command line (it was not ported before
    sharded serving); ``--attn-constraints`` stays refused, ``--no-master``
    and ``--mla-absorbed`` run."""
    out = str(tmp_path)
    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh", "single",
                 "--out", out])
    with open(dryrun.cell_path(out, "gemma3-1b", "decode_32k", "single")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["kernel_calls"] == {"rmsnorm": 53, "decode_attention": 26}
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--mesh", "2x2",
                     "--out", out, "--attn-constraints"])
    assert e.value.code == 2
    with pytest.raises(ValueError, match="sharding constraints"):
        dryrun.run_cell("gemma3-1b", "train_4k", "2x2", {"attn_constraints": True})
    dryrun.main(["--arch", "minicpm3-4b", "--shape", "decode_32k", "--mesh", "2x2",
                 "--out", out, "--mla-absorbed", "--tag", "absorbed"])
    with open(dryrun.cell_path(out, "minicpm3-4b", "decode_32k", "2x2", "absorbed")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["options"] == {"mla_absorbed": True}


def test_no_master_lowers_state_bytes_by_the_master():
    """A train cell with ``--no-master``: the state bytes drop by the rank's
    float32 master, 4 B a ZeRO-1 piece element (a third of the state: the
    moments are float32 pieces too), and so do the argument bytes; the
    schedule, the products, the kernel calls and the parameter and gradient
    bytes stay as they were."""
    cfg = reduced(get_config("gemma3-1b"))
    shape = ShapeSpec("t", 32, 8, "train")
    mesh = Mesh({"data": 2, "model": 2})
    base = dryrun.trace_cell(cfg, shape, mesh, 1)
    bare = dryrun.trace_cell(cfg, shape, mesh, 1, {"no_master": True})
    master = base["bytes"]["state_bytes"] // 3
    assert master > 0 and base["bytes"]["state_bytes"] == 3 * master
    assert base["bytes"] == {**bare["bytes"], "state_bytes": bare["bytes"]["state_bytes"] + master}
    assert base["cost"].argument_bytes - bare["cost"].argument_bytes == master
    assert base["ops"] == bare["ops"] and base["cost"].dot_flops == bare["cost"].dot_flops
    assert base["cost"].kernel_calls == bare["cost"].kernel_calls
    rec = dryrun.run_cell("gemma3-1b", "train_4k", "2x2", {"no_master": True}, cfg=cfg,
                          verbose=False)
    assert rec["status"] == "ok" and rec["options"] == {"no_master": True}


def test_abstract_model_has_no_data_and_decode_refuses_a_mesh():
    """The abstract model holds no data; bound to a mesh, its decode refuses
    caches that are not placed on it, and decodes its abstract caches: the
    rank's rows (B 4 over data), its KV heads (the one KV head, read by both
    model ranks) and the whole vocabulary's logits."""
    cfg = reduced(get_config("gemma3-1b"))
    model = Model.abstract(cfg)
    assert {p.device.type for p in model.parameters()} == {"meta"}
    with pytest.raises(NotImplementedError):
        model.embed.tolist()
    shard_params(model, make_mesh_by_name("2x2").bind_abstract(0))
    tokens = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="placed on it"):
        model.decode_step([], tokens, 0)
    caches = model.abstract_caches(4, 24)
    assert caches.specs[0] == {"k": ("data",), "v": ("data",)}
    assert caches[0]["k"].shape == (2, 16, 1, cfg.hd) and caches[1]["k"].shape == (2, 24, 1, cfg.hd)
    logits, _ = model.decode_step(caches, tokens, 23)
    assert logits.shape == (2, cfg.vocab) and logits.device.type == "meta"


def test_full_gemma3_1b_sharded_step_as_the_card_runs_it():
    """The card's sharded phase: full gemma3-1b, B 4 x S 1024 in 2 microbatches
    on (2, 2): 106 / 106 kernel calls a step and rank, and a rank's bytes of
    parameters, gradient buffers and ZeRO-1 state from their shapes."""
    shape = ShapeSpec("chip_train", 1024, 4, "train")
    trace = dryrun.trace_cell(get_config("gemma3-1b"), shape, Mesh({"data": 2, "model": 2}), 3,
                              {"microbatches": 2})
    assert trace["cost"].kernel_calls == {"rmsnorm": 106, "rmsnorm_bwd": 106}
    assert trace["bytes"] == {"param_bytes": 999_873_792, "grad_buffer_bytes": 2_999_621_376,
                              "state_bytes": 2_999_621_376}
    assert len(trace["ops"]) == 901


@pytest.mark.parametrize("arch,dtype,marked", [
    ("olmoe-1b-7b", torch.float32, True), ("olmoe-1b-7b", torch.bfloat16, False),
    ("gemma3-1b", torch.float32, False),
])
def test_moe_trace_off_bf16_marks_its_bytes_approximate(arch, dtype, marked):
    """A MoE cell traced in float32 takes its expert products on bf16
    stand-ins, and its record says that its bytes are approximate; a bf16
    MoE cell and a dense float32 one do not."""
    cfg = reduced(get_config(arch)).with_(param_dtype=dtype)
    trace = dryrun.trace_cell(cfg, ShapeSpec("d", 24, 4, "decode"), Mesh({"data": 2, "model": 2}))
    line = dryrun.MOE_STANDIN_BYTES.format(dtype="float32")
    assert (line in trace["fallbacks"]) == marked
    assert not any(f.startswith("grouped_ffn") for f in trace["fallbacks"] if f != line)


def test_decode_takes_the_kv_columns_once_a_batch():
    """Head-parallel decode whose single KV head ``model`` does not divide
    (reduced gemma3-1b on 2x2): the caches carry the rank's ``w_k`` /
    ``w_v`` columns, taken when they are made, so a step gathers only the
    logits; caches without them are refused."""
    from repro_torch.core.capture import capture_collectives
    from repro_torch.models.model import Caches

    cfg = reduced(get_config("gemma3-1b"))
    model = Model.abstract(cfg)
    shard_params(model, make_mesh_by_name("2x2").bind_abstract(1))
    with capture_collectives() as made:
        caches = model.abstract_caches(4, 24)
    assert [op.kind for op in made] == ["all-gather"] * 2 * cfg.n_layers
    assert all(cols["w_k"].shape == (cfg.d_model, cfg.hd) for cols in caches.kv)
    tokens = torch.zeros(2, dtype=torch.int64, device="meta")
    with capture_collectives() as ops:
        model.decode_step(caches, tokens, 23)
    gathers = [op for op in ops if op.kind == "all-gather"]
    assert len(gathers) == 1 and "over model" in gathers[0].line
    with pytest.raises(ValueError, match="K/V columns"):
        model.decode_step(Caches(caches, caches.specs), tokens, 23)


# the blocks that compute their heads' share on a mesh: (arch, block kind)
PARTITIONED = [("zamba2-2.7b", "mamba"), ("xlstm-125m", "xlstm_m"), ("minicpm3-4b", "dense"),
               ("kimi-k2-1t-mla", "dense")]


def _duplicates(cfg, kind: str, tokens: int, train: bool) -> int:
    """One device's dot FLOPs of the products every ``model`` rank computes
    whole (their forward, and in training the input's and the weight's
    gradient): in the full pass a Mamba block's B and C columns of ``w_in``
    and an mLSTM cell's x_m; at decode, where each rank projects on its own
    columns, only the conv window's B and C channels; MLA's latent and
    compressed query."""
    d, T = cfg.d_model, tokens
    if kind == "mamba":
        f = 2 * T * d * 2 * cfg.ssm_state if train else 2 * T * cfg.ssm_conv * 2 * cfg.ssm_state
    elif kind == "xlstm_m":
        f = 2 * T * d * d if train else 0
    else:
        f = 2 * T * d * (cfg.mla_kv_rank + cfg.mla_rope_dim + cfg.mla_q_rank)
    return 3 * f if train else f


def _block_dot_flops(cfg, kind: str, rows: int, S: int, train: bool, mesh=None,
                     rank: int = 0) -> int:
    """Dot FLOPs of the first ``kind`` block on ``rows`` rows: its forward and
    backward on S tokens (``train``), or one decode step over a cache of S
    slots at its last slot; on ``mesh``'s ``rank`` (abstract) or one device."""
    model = Model.abstract(cfg)
    if mesh is not None:
        shard_params(model, mesh.bind_abstract(rank))
    li = next(i for i, b in enumerate(model.entries) if b.kind == kind)
    block = model.entries[li]
    x = torch.empty(rows, 1 if not train else S, cfg.d_model, dtype=cfg.param_dtype,
                    device="meta", requires_grad=train)
    if train:
        model.requires_grad_(True)
        positions = torch.zeros(rows, S, dtype=torch.int32, device="meta")
        with count_cost() as cost:
            y, _, _ = block(x, positions, li)
            y.float().sum().backward()
        return cost.dot_flops
    batch = rows * (1 if mesh is None else mesh.shape["data"])
    caches = model.abstract_caches(batch, S)
    specs = caches.specs[li] if caches.specs else None
    kv = caches.kv[li] if caches.kv else None
    with count_cost() as cost:
        block.decode(x, caches[li], S - 1, specs, kv)
    return cost.dot_flops


@pytest.mark.parametrize("train", [True, False], ids=["train", "decode"])
@pytest.mark.parametrize("arch,kind", PARTITIONED)
def test_partitioned_products_are_each_ranks_share(arch, kind, train):
    """On an abstract 2x2 mesh, a head-parallel block's dot FLOPs on a rank's
    rows are exactly half the one-device count on those rows, but for the
    named duplicates, which count whole (FLOPs depend on shapes alone, so
    the count is exact).  Reduced configs: their heads divide over 2."""
    cfg = reduced(get_config(arch))
    rows, S = 2, 32
    one = _block_dot_flops(cfg, kind, rows, S, train)
    dup = _duplicates(cfg, kind, rows * (S if train else 1), train)
    mesh = make_mesh_by_name("2x2")
    for rank in (0, 3):
        got = _block_dot_flops(cfg, kind, rows, S, train, mesh, rank)
        assert got == (one - dup) // 2 + dup, (got, one, dup)


@pytest.mark.parametrize("arch,kind", PARTITIONED[:2])
def test_a_recurrent_decode_step_moves_activations_not_weights(arch, kind):
    """On an abstract 2x2 rank, a head-parallel Mamba block or mLSTM cell
    decodes a token from its own weight columns: one all-gather over
    ``model`` of its rows' projection on them (and a Mamba block's own
    ``conv_w`` columns), then the output's sum; no weight is gathered and
    the caches carry no columns for it."""
    from repro_torch.core.capture import capture_collectives

    cfg = reduced(get_config(arch))
    model = Model.abstract(cfg)
    shard_params(model, make_mesh_by_name("2x2").bind_abstract(1))
    li = next(i for i, b in enumerate(model.entries) if b.kind == kind)
    block, caches = model.entries[li], model.abstract_caches(4, 16)
    assert block.head_parallel() and caches.kv[li] is None
    x = torch.empty(2, 1, cfg.d_model, dtype=cfg.param_dtype, device="meta")
    with capture_collectives() as ops:
        block.decode(x, caches[li], 15, caches.specs[li], caches.kv[li])
    size = cfg.param_dtype.itemsize
    if kind == "mamba":
        d_inner, ds = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
        proj = 2 * d_inner + 2 * ds + max(1, d_inner // 64)  # z | x | B | C | dt
        sent = 2 * proj // 2 + cfg.ssm_conv * (d_inner + 2 * ds) // 2
    else:
        sent = 2 * 2 * cfg.d_model // 2
    assert [(o.kind, o.operand_bytes, o.axes) for o in ops] == [
        ("all-gather", sent * size, ("model",)),
        ("all-reduce", 2 * cfg.d_model * size, ("model",))]


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_recurrent_states_are_each_ranks_share(arch):
    """A head-parallel block's state on a 2x2 rank: its rows (B 4 over data)
    and half its heads; a Mamba conv window the x channels of those heads
    and all of B and C; an sLSTM state its rows alone."""
    cfg = reduced(get_config(arch))
    model = Model.abstract(cfg)
    shard_params(model, make_mesh_by_name("2x2").bind_abstract(1))
    caches = model.abstract_caches(4, 64)
    one = Model.abstract(cfg).abstract_caches(4, 64)
    for block, mine, full in zip(model.entries, caches, one):
        for name, t in mine.items():
            rows_bytes = full[name].numel() * full[name].element_size() // 2
            got = t.numel() * t.element_size()
            if block.kind == "xlstm_s":
                assert got == rows_bytes, name
            elif name == "conv":
                d_inner, ds = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
                assert t.shape[2] == d_inner // 2 + 2 * ds
                assert got == rows_bytes * (d_inner // 2 + 2 * ds) // (d_inner + 2 * ds)
            elif block.kind in ("mamba", "xlstm_m"):
                assert got * 2 == rows_bytes, name


def _mamba_meta(dtype, B=4, H=2, d_head=64, ds=16, K=4):
    """A Mamba2 block's decode operands on ``meta``: ``(cfg, p, proj, state)``,
    ``w_out`` square so that a decode's output has the gated y's shape."""
    cfg = reduced(get_config("zamba2-2.7b")).with_(ssm_state=ds, ssm_conv=K)
    d_inner = H * d_head
    C = d_inner + 2 * ds

    def meta(*shape, dt=torch.float32):
        return torch.empty(*shape, dtype=dt, device="meta")

    p = {"conv_w": meta(K, C, dt=dtype), "norm_z": meta(d_inner, dt=dtype),
         "a_log": meta(H), "dt_bias": meta(H), "d_skip": meta(H),
         "w_out": meta(d_inner, d_inner, dt=dtype)}
    state = {"h": meta(B, H, d_head, ds), "conv": meta(B, K - 1, C)}
    return cfg, p, meta(B, 1, 2 * d_inner + 2 * ds + H, dt=dtype), state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,ds", [(4, 2, 16), (3, 20, 64), (2, 80, 64), (1, 4, 128)])
def test_mamba_decode_shape_function_gives_the_plain_decodes_outputs(dtype, B, H, ds):
    """``repro_torch::mamba_decode`` on ``meta`` tensors: the gated y and the
    window of the plain version (shapes and dtypes), h as it was; one kernel
    call, and the products the plain version counts."""
    from repro_torch.kernels.mamba_decode import mamba_decode_ref

    _, p, proj, state = _mamba_meta(dtype, B=B, H=H, ds=ds)
    h = state["h"]
    args = [p[k] for k in ("conv_w", "dt_bias", "a_log", "d_skip", "norm_z")]
    with count_cost() as plain:
        y_plain, conv_plain = mamba_decode_ref(proj, state["conv"], h.clone(), *args)
    with count_cost() as kernel:
        y, conv = ops.mamba_decode(proj, state["conv"], h, *args)
    assert (y.shape, y.dtype) == (y_plain.shape, y_plain.dtype) == ((B, 1, H * 64), dtype)
    assert (conv.shape, conv.dtype) == (conv_plain.shape, torch.float32)
    assert (h.shape, h.dtype) == ((B, H, 64, ds), torch.float32)
    assert kernel.kernel_calls == {"mamba_decode": 1} and plain.kernel_calls == {}
    assert kernel.dot_flops == plain.dot_flops > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_decode_on_the_cpu_is_the_plain_recurrence(dtype):
    """A CPU tensor takes the plain version: bit for bit the conv over the
    window, ``_ssm_step`` (the prefill's recurrence) and the gate, with ``h``
    updated in place and the window moved on by one token."""
    from repro_torch.models import ssm

    g = torch.Generator().manual_seed(7)
    B, H, dh, ds, K = 3, 4, 64, 16, 4
    d_inner, C = H * dh, H * dh + 2 * ds
    proj = torch.randn(B, 1, 2 * d_inner + 2 * ds + H, generator=g).to(dtype)
    conv, h = torch.randn(B, K - 1, C, generator=g), torch.randn(B, H, dh, ds, generator=g) * 0.1
    conv_w = (torch.randn(K, C, generator=g) * 0.5).to(dtype)
    norm_z = (torch.randn(d_inner, generator=g) * 0.1).to(dtype)
    dt_bias, a_log, d_skip = (torch.randn(H, generator=g) * 0.5 for _ in range(3))

    z, xbc_t, dt_raw = torch.split(proj, [d_inner, C, H], dim=-1)
    win = torch.cat([conv, xbc_t.float()], dim=1)
    xbc = torch.nn.functional.silu(torch.einsum("bkc,kc->bc", win, conv_w.float())).to(dtype)
    x, Bm, Cm = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    dt = torch.nn.functional.softplus(dt_raw[:, 0].float() + dt_bias)
    h_want, y_want = ssm._ssm_step(h, x.reshape(B, H, dh).float(), Bm.float(), Cm.float(), dt,
                                   torch.exp(a_log), d_skip)
    y_want = y_want.reshape(B, 1, d_inner).to(dtype) * torch.nn.functional.silu(z + norm_z)

    h_in = h.clone()
    y, conv_out = ops.mamba_decode(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z)
    assert torch.equal(y, y_want) and torch.equal(h, h_want) and not torch.equal(h, h_in)
    assert torch.equal(conv_out, win[:, 1:]) and conv_out.dtype == torch.float32


@pytest.mark.parametrize("mesh", ["single", "2x2"])
def test_zamba2_decode_cell_counts_one_mamba_decode_a_layer(mesh):
    """A zamba2 decode cell's kernel calls are ``decode_launches``: one
    ``mamba_decode`` a Mamba2 layer (a rank's heads on the 2x2 mesh), beside
    the norms and the shared block's attention."""
    cfg = reduced(get_config("zamba2-2.7b"))
    rec = dryrun.run_cell("zamba2-2.7b", "decode_32k", mesh, {}, rank=3, cfg=cfg, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    mamba = sum(kind == "mamba" for kind, _ in layer_blocks(cfg))
    assert rec["kernel_calls"] == decode_launches(cfg)
    assert rec["kernel_calls"]["mamba_decode"] == mamba == cfg.n_layers


@pytest.mark.parametrize("arch,launches", [
    ("gemma3-1b", {"rmsnorm": 53, "decode_attention": 26}),
    ("olmoe-1b-7b", {"rmsnorm": 33, "decode_attention": 16}),
    ("xlstm-125m", {"rmsnorm": 13, "decode_attention": 0}),
    ("zamba2-2.7b", {"rmsnorm": 73, "decode_attention": 9, "mamba_decode": 54})])
def test_decode_launches_name_mamba_decode_only_where_mamba_blocks_are(arch, launches):
    assert decode_launches(get_config(arch)) == launches


def test_the_cpu_decode_of_a_mamba_model_calls_no_kernel_operator():
    cfg = reduced(get_config("zamba2-2.7b"))
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    caches = model.init_caches(2, 4)
    with count_cost() as cost:
        logits, _ = model.decode_step(caches, torch.tensor([3, 4]), 0)
    assert cost.kernel_calls == {} and torch.isfinite(logits).all()
