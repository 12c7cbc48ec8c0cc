"""The port's logical-axis sharding (``distributed/sharding.py``,
``launch/mesh.py``) against the reference's ``param_shardings``.

The reference runs once, in a subprocess with 16 forced host devices: the
spec and the fallback log of every parameter of all 11 configs of the
registry, at full size (abstract, nothing allocated), on meshes (1, 16),
(2, 4) and (4, 4), the ZeRO-1 specs ``test_torch_zero.py`` reads, and the
reduced gemma3-1b's parameters from ``Model.init(PRNGKey(0))``.

The reference stacks a scan stage's layers on a leading ``layers`` dim that
its rules never shard; the port keeps a tensor a layer (``blocks.<i>.*``), so
its spec is the reference's with that dim dropped, and a reference leaf's
fallback is logged once for each layer under the port's name (the reference
logs the leaf's index in its flattened tree).

One world of 4 gloo ranks at (2, 2) then checks the placement: every rank
draws the whole parameters and keeps its slice, so ``gather_params`` gives
the unsharded model's parameters bit for bit; ``params_from_jax`` with the
mesh gives each rank's slice; and the forward of five reduced configs in
float32 (tensor-parallel attention and MLP, expert-parallel MoE at capacity
factor 4 where nothing drops, Mamba2, the mLSTM cells and MLA head-parallel,
the sLSTM cell gathered) equals the unsharded forward within 1e-5.  This
file imports no JAX: the spawned ranks import it.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.distributed import run_world
from repro_torch.distributed.collectives import raw_all_gather
from repro_torch.distributed.sharding import (DEFAULT_RULES, ShardingRules, batch_spec, constrain,
                                              gather_params, param_shardings, resolve_spec,
                                              shard_params, shard_tensor)
from repro_torch.launch.mesh import Mesh, make_mesh_by_name, make_production_mesh
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_plan, param_specs

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = ("1x16", "2x4", "4x4")
ARCHS = sorted(REGISTRY)
# the forward under the mesh: dense, MoE (expert-parallel), Mamba2 / shared
# attention, xLSTM, MLA
FORWARD_ARCHS = ("gemma3-1b", "olmoe-1b-7b", "zamba2-2.7b", "xlstm-125m", "minicpm3-4b")

REFERENCE = """
import json, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import REGISTRY, get_config, reduced
from repro.models import Model
from repro.distributed import DEFAULT_RULES, param_shardings, batch_spec
from repro.distributed.zero import zero1_from_params, zero1_shardings, zero1_spec

def spec_list(p):
    return [list(a) if isinstance(a, tuple) else a for a in p]

out = {}
for dims in ((1, 16), (2, 4), (4, 4)):
    mesh = Mesh(np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims), ("data", "model"))
    name = f"{dims[0]}x{dims[1]}"
    for arch in sorted(REGISTRY):
        m = Model(get_config(arch))
        axes, shapes = m.param_axes(), m.abstract_params()
        sh, fb = param_shardings(axes, shapes, mesh, DEFAULT_RULES)
        flat = jax.tree_util.tree_flatten_with_path(axes, is_leaf=lambda x: isinstance(x, tuple))
        out[f"{name}/{arch}"] = {
            "paths": [jax.tree_util.keystr(kp, simple=True, separator="/") for kp, _ in flat[0]],
            "specs": [spec_list(s.spec) for s in jax.tree.leaves(sh)],
            "shapes": [list(s.shape) for s in jax.tree.leaves(shapes)], "fallbacks": fb,
            "zero": [spec_list(s.spec) for s in
                     jax.tree.leaves(zero1_from_params(sh, shapes, mesh, ("data",)))],
            "zero_plain": [spec_list(s.spec) for s in
                           jax.tree.leaves(zero1_shardings(shapes, mesh, ("data",)))]}
    out[f"{name}/batch"] = [spec_list(batch_spec(mesh)), spec_list(batch_spec(mesh, pods=True))]
    out[f"{name}/zero1_spec"] = [
        spec_list(zero1_spec(s, mesh, ("data",), model_dim=md))
        for s in ((8, 6), (6, 8), (3, 5), (4, 16), (16,), (32, 12, 20))
        for md in (False, True)]
out["pod_mesh_batch"] = spec_list(batch_spec(jax.make_mesh((1, 2, 2), ("pod", "data", "model")),
                                             pods=True))
json.dump(out, open(sys.argv[1] + ".json", "w"))
params = Model(reduced(get_config("gemma3-1b")).with_(param_dtype=jnp.float32)).init(
    jax.random.PRNGKey(0))
pickle.dump(jax.tree.map(np.asarray, params), open(sys.argv[1] + ".pkl", "wb"))
"""


def run_reference(tmp_path_factory, tag: str) -> tuple:
    """``(specs by "mesh/arch", reduced gemma3-1b parameters as numpy)``."""
    path = tmp_path_factory.mktemp(tag) / "reference"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=16",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(f"{path}.pkl", "rb") as f:
        params = pickle.load(f)
    return json.load(open(f"{path}.json")), params


def as_spec(spec: list) -> tuple:
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


def port_names(path: str, cfg) -> tuple:
    """``(the port's names of a reference leaf, whether it is layer-stacked)``."""
    parts = path.split("/")
    if parts[0] == "stages":
        i, rest, plan = int(parts[1]), ".".join(parts[2:]), build_plan(cfg)
        first = sum(st.n for st in plan[:i] if st.kind != "shared")
        if plan[i].kind == "scan":
            return [f"blocks.{first + j}.{rest}" for j in range(plan[i].n)], True
        return [f"blocks.{first}.{rest}"], False
    if parts[0] == "shared":
        return ["shared." + ".".join(parts[1:])], False
    return [path], False


def mesh_of(name: str) -> Mesh:
    return make_mesh_by_name(name)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "sharding")


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(reference, mesh_name, arch):
    ref = reference[0][f"{mesh_name}/{arch}"]
    cfg = get_config(arch)
    specs, _ = param_shardings(param_specs(cfg), mesh_of(mesh_name))
    want = {}
    for path, spec in zip(ref["paths"], ref["specs"]):
        names, stacked = port_names(path, cfg)
        want.update({n: as_spec(spec[1:] if stacked else spec) for n in names})
    assert specs == want


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_fallback_logs_equal_the_reference(reference, mesh_name, arch):
    ref = reference[0][f"{mesh_name}/{arch}"]
    cfg = get_config(arch)
    _, fallbacks = param_shardings(param_specs(cfg), mesh_of(mesh_name))
    want = []
    for entry in ref["fallbacks"]:
        index, rest = entry.split("[", 1)
        want += [f"{n}[{rest}" for n in port_names(ref["paths"][int(index)], cfg)[0]]
    assert sorted(fallbacks) == sorted(want)
    if mesh_name == "1x16" and arch == "minicpm3-4b":  # vocab 73448 % 16 != 0
        assert sorted(fallbacks) == ["embed[vocab->model]: replicated (73448 % 16 != 0)",
                                     "lm_head[vocab->model]: replicated (73448 % 16 != 0)"]
    if mesh_name == "1x16" and arch == "xlstm-125m":
        assert len(ref["fallbacks"]) == 9  # 8 heads on a 16-way model axis


@pytest.mark.parametrize("mesh_name", MESHES)
def test_batch_spec_equals_the_reference(reference, mesh_name):
    mesh = mesh_of(mesh_name)
    want = [as_spec(s) for s in reference[0][f"{mesh_name}/batch"]]
    assert [batch_spec(mesh), batch_spec(mesh, pods=True)] == want
    assert batch_spec(Mesh({"pod": 1, "data": 2, "model": 2}), pods=True) == as_spec(
        reference[0]["pod_mesh_batch"])


def test_meshes_by_name():
    assert make_mesh_by_name("single").shape == {"data": 16, "model": 16}
    assert make_mesh_by_name("multi").shape == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh().size == 256 and make_production_mesh(multi_pod=True).size == 512
    m = make_mesh_by_name("2x2x4")
    assert m.shape == {"pod": 2, "data": 2, "model": 4} and m.batch_axes == ("pod", "data")
    assert m.coords(13) == {"pod": 1, "data": 1, "model": 1} and m.coords(16) is None
    assert m.axis_size(("data", "pod")) == 4 and m.axes_in_order(("model", "pod")) == (
        "pod", "model")
    assert make_mesh_by_name("8").shape == {"data": 8}


def test_resolve_spec_rules():
    mesh = Mesh({"data": 2, "model": 4})
    log = []
    assert resolve_spec((6, 8), ("heads", "mlp"), DEFAULT_RULES, mesh, path="w",
                        fallbacks=log) == (None, "model")
    assert log == ["w[heads->model]: replicated (6 % 4 != 0)"]
    log.clear()
    assert resolve_spec((8, 8), ("heads", "mlp"), DEFAULT_RULES, mesh, path="w",
                        fallbacks=log) == ("model",)
    assert log == ["w[mlp->model]: replicated (reused)"]
    with pytest.raises(ValueError, match="not divisible"):
        resolve_spec((6,), ("heads",), ShardingRules(DEFAULT_RULES.rules, strict=True), mesh)
    assert resolve_spec((8,), ("heads",), DEFAULT_RULES.with_rule("heads", None), mesh) == ()
    x = torch.ones(2)
    assert constrain(x, mesh, "data") is x


def _rank_job(rank: int, world: int, jax_params) -> dict:
    torch.set_num_threads(1)
    mesh = Mesh({"data": 2, "model": 2}).bind()
    out = {"coord": mesh.coord}
    gen = np.random.default_rng(0)
    for arch in FORWARD_ARCHS:
        cfg = reduced(get_config(arch)).with_(param_dtype=torch.float32, capacity_factor=4.0)
        model = Model(cfg, device="cpu")
        shard_params(model, mesh)
        model.init(torch.Generator().manual_seed(0))
        whole = {k: v.numpy() for k, v in gather_params(model).items()}
        tokens = torch.from_numpy(gen.integers(0, cfg.vocab, (4, 20)))
        with torch.no_grad():
            logits, aux = model.forward(shard_tensor(tokens, ("data",), mesh))
        logits = raw_all_gather(raw_all_gather(logits, mesh, "model", 2), mesh, "data", 0)
        out[arch] = {"params": whole, "tokens": tokens.numpy(), "logits": logits.numpy(),
                     "aux": {k: float(v) for k, v in aux.items()},
                     "unpartitioned": model.unpartitioned(),
                     "local_shapes": {k: tuple(p.shape) for k, p in model.named_parameters()}}
    cfg = reduced(get_config("gemma3-1b")).with_(param_dtype=torch.float32)
    out["from_jax"] = {k: v.numpy() for k, v in params_from_jax(jax_params, cfg, mesh).items()}
    return out


@pytest.fixture(scope="module")
def ranks(reference):
    return run_world(_rank_job, 4, reference[1], timeout=240)


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_init_is_mesh_invariant(ranks, arch):
    cfg = reduced(get_config(arch)).with_(param_dtype=torch.float32, capacity_factor=4.0)
    single = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for out in ranks:
        for k, p in single.named_parameters():
            np.testing.assert_array_equal(out[arch]["params"][k], p.detach().numpy(), err_msg=k)


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_sharded_forward_equals_the_unsharded(ranks, arch):
    cfg = reduced(get_config(arch)).with_(param_dtype=torch.float32, capacity_factor=4.0)
    single = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits, aux = single.forward(torch.from_numpy(ranks[0][arch]["tokens"]))
    for out in ranks:
        np.testing.assert_allclose(out[arch]["logits"], logits.numpy(), rtol=1e-5, atol=1e-5)
        for k, v in aux.items():
            np.testing.assert_allclose(out[arch]["aux"][k], float(v), rtol=1e-5, atol=1e-6)


def test_unpartitioned_blocks_are_listed(ranks):
    out = ranks[0]
    assert out["gemma3-1b"]["unpartitioned"] == [] and out["olmoe-1b-7b"]["unpartitioned"] == []
    # Mamba2 (2 heads), the mLSTM cells (4 heads) and MLA (4 heads) over model 2,
    # the shared block too; the sLSTM cell (pattern "mmms") runs whole
    assert out["zamba2-2.7b"]["unpartitioned"] == []
    assert out["xlstm-125m"]["unpartitioned"] == ["blocks.3.cell"]
    assert out["minicpm3-4b"]["unpartitioned"] == []


def test_each_rank_holds_its_slice(ranks):
    for out in ranks:
        shapes = out["gemma3-1b"]["local_shapes"]
        assert shapes["embed"] == (128, 64)                  # vocab 256 over model 2
        assert shapes["blocks.0.attn.w_q"] == (64, 32)       # 4 heads of 16 over model
        assert shapes["blocks.0.attn.w_k"] == (64, 8)        # one KV head of 16, cut in two
        assert shapes["blocks.0.mlp.w_down"] == (64, 64)
        assert shapes["blocks.0.ln1"] == (64,)
        assert shapes["final_norm"] == (64,)
        moe = out["olmoe-1b-7b"]["local_shapes"]
        assert moe["blocks.0.moe.w_gate"] == (4, 64, 64)    # experts over model, ff over data


def test_params_from_jax_gives_each_rank_its_slice(ranks, reference):
    cfg = reduced(get_config("gemma3-1b")).with_(param_dtype=torch.float32)
    whole = params_from_jax(reference[1], cfg)
    specs, _ = param_shardings(param_specs(cfg), Mesh({"data": 2, "model": 2}))
    for out in ranks:
        mesh = Mesh({"data": 2, "model": 2})
        for k, v in whole.items():
            np.testing.assert_array_equal(out["from_jax"][k],
                                          shard_tensor(v, specs[k], mesh, out["coord"]).numpy())
