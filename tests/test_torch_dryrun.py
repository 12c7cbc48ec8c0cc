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
from repro_torch.models.model import decode_launches

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
    if shape == "decode_32k":
        assert rec["status"] == "not_ported" and "slice 4d" in rec["skip_reason"]
        return
    if shape == "long_500k":
        assert rec["status"] == ("not_ported" if cfg.supports_500k else "skipped")
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
    else:
        assert rec["kernel_calls"] == {"rmsnorm": norms}
    assert rec["hbm_bytes_per_device"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["n_collective_ops"] == len(rec["collective_schedule"])
    assert sum(v["bytes"] for v in rec["collectives"].values()) == \
        rec["collective_bytes_per_device"]
    factor = 6.0 if shape == "train_4k" else 2.0
    assert rec["model_flops"] == factor * rec["n_active_params"] * SHAPES[shape].tokens


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
    out = str(tmp_path)
    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh", "single",
                 "--out", out])
    with open(dryrun.cell_path(out, "gemma3-1b", "decode_32k", "single")) as f:
        assert json.load(f)["status"] == "not_ported"
    for flag in ("--attn-constraints", "--no-master"):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--mesh", "2x2",
                         "--out", out, flag])
        assert e.value.code == 2
    with pytest.raises(ValueError, match="float32 master"):
        dryrun.run_cell("gemma3-1b", "train_4k", "2x2", {"no_master": True})


def test_abstract_model_has_no_data_and_decode_refuses_a_mesh():
    model = Model.abstract(reduced(get_config("gemma3-1b")))
    assert {p.device.type for p in model.parameters()} == {"meta"}
    with pytest.raises(NotImplementedError):
        model.embed.tolist()
    shard_params(model, make_mesh_by_name("2x2").bind_abstract(0))
    with pytest.raises(NotImplementedError, match="unsharded"):
        model.decode_step([], torch.zeros(2, dtype=torch.int64, device="meta"), 0)


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
