"""The port's expert-parallel MoE (``models/moe_ep.py``) on gloo CPU ranks
against the reference's ``moe_apply_ep``.

The reference runs once, in a subprocess with 8 forced host devices, at the
inputs of ``tests/test_distributed.py::test_ep_moe_matches_local_oracle_and_grads``
(8 experts top-2, one shared expert, capacity factor 4, x [4, 16, 32]) and of
``tests/test_substrate_more.py::test_moe_ep_capacity_drops_counted`` (top-4
of 8 at capacity factor 0.25, x [2, 64, 16]), on meshes (1, 4) and (2, 4),
each call inside ``jax.set_mesh`` (the reference's own tests call ``jit``
outside it, which jax 0.9 refuses).  S = 16 takes the scatter path, S = 1 the
gather path; at (2, 4) the FFN width 48 is sharded over ``data``.

The port runs one world of 4 ranks and one of 8.  Each rank holds its shard
of every tensor in ``ep_specs``' layout and its rows of x.  The loss is
sum(y^2) over the whole batch; a rank's gradients of tensors replicated over
``data`` are its rows' part, summed over ``data`` here as the train step
sums them.  Bounds: the reference test's (outputs 1e-4, gradients rtol 1e-3
/ atol 1e-4), dropped-pair counts exactly.

The load-balance and z losses are held to the reference's ``moe_apply`` on
the whole batch (1e-5): the port sums the routing statistics over the ranks
before it forms them, where the reference averages each rank's losses, which
for the load-balance loss (a product of two means) depends on the mesh.
This file imports no JAX: the spawned ranks import it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed import run_world
from repro_torch.distributed.collectives import raw_all_gather, raw_all_reduce
from repro_torch.distributed.sharding import gather_tensor, shard_tensor, spec_axes
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe_ep import ep_applicable, ep_specs, moe_apply_ep

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = ((1, 4), (2, 4))
KEYS = ("router", "w_gate", "w_up", "w_down", "sh_gate", "sh_up", "sh_down")

CFG = ModelConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=48, vocab=64,
                  n_experts=8, experts_per_token=2, n_shared_experts=1, capacity_factor=4.0,
                  param_dtype=torch.float32)
CFG_DROPS = ModelConfig(n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32, vocab=64,
                        n_experts=8, experts_per_token=4, capacity_factor=0.25,
                        param_dtype=torch.float32)

_REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models.common import ModelConfig, materialize
from repro.models.moe import moe_apply, moe_specs
from repro.models.moe_ep import moe_apply_ep

out = {}
cfg = ModelConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=48, vocab=64,
                  n_experts=8, experts_per_token=2, n_shared_experts=1, capacity_factor=4.0,
                  param_dtype=jnp.float32)
p = materialize(moe_specs(cfg), jax.random.PRNGKey(0))
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32), jnp.float32) * 0.5
out.update({f"p_{k}": v for k, v in p.items()})
out["x"] = x
loss = lambda f: (lambda p, x: jnp.sum(f(p, x)[0] ** 2))
for tag, xx in (("scatter", x), ("gather", x[:, :1])):
    _, aux = moe_apply(cfg, p, xx)
    out.update({f"local_{tag}_{k}": v for k, v in aux.items()})
for dims in ((1, 4), (2, 4)):
    mesh = Mesh(np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims), ("data", "model"))
    name = f"{dims[0]}x{dims[1]}"
    f = lambda p, x: moe_apply_ep(cfg, p, x, mesh)
    with jax.set_mesh(mesh):
        for tag, xx in (("scatter", x), ("gather", x[:, :1])):
            y, aux = jax.jit(f)(p, xx)
            g = jax.jit(jax.grad(loss(f)))(p, xx)
            out[f"{name}_{tag}_y"] = y
            out.update({f"{name}_{tag}_{k}": v for k, v in aux.items()})
            out.update({f"{name}_{tag}_g_{k}": v for k, v in g.items()})
cfg2 = ModelConfig(n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32, vocab=64,
                   n_experts=8, experts_per_token=4, capacity_factor=0.25,
                   param_dtype=jnp.float32)
p2 = materialize(moe_specs(cfg2), jax.random.PRNGKey(0))
x2 = jax.random.normal(jax.random.PRNGKey(1), (2, 64, 16), jnp.float32)
out.update({f"p2_{k}": v for k, v in p2.items()})
out["x2"] = x2
for dims in ((1, 4), (2, 4)):
    mesh = Mesh(np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims), ("data", "model"))
    with jax.set_mesh(mesh):
        y, aux = jax.jit(lambda p, x: moe_apply_ep(cfg2, p, x, mesh))(p2, x2)
    out[f"drops_{dims[0]}x{dims[1]}_y"] = y
    out[f"drops_{dims[0]}x{dims[1]}_dropped"] = aux["moe_dropped"]
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""


def _run(cfg, params, x, mesh, grads: bool) -> dict:
    """This rank's moe_apply_ep of its shards; y and gradients made whole."""
    specs = ep_specs(cfg, mesh)
    p = {k: shard_tensor(torch.from_numpy(v), specs[k], mesh).clone().requires_grad_(grads)
         for k, v in params.items() if k in specs}
    y, aux = moe_apply_ep(cfg, p, shard_tensor(torch.from_numpy(x), ("data",), mesh), mesh)
    out = {"y": raw_all_gather(y.detach(), mesh, "data", 0).numpy(),
           **{k: float(v) for k, v in aux.items()}}
    if grads:
        (y ** 2).sum().backward()
        for k, t in p.items():
            g = t.grad if "data" in spec_axes(specs[k]) else raw_all_reduce(t.grad, mesh, "data")
            out[f"g_{k}"] = gather_tensor(g, specs[k], mesh).numpy()
    return out


def _rank_job(rank: int, world: int, dims, inputs: dict) -> dict:
    torch.set_num_threads(1)
    mesh = Mesh(dict(zip(("data", "model"), dims))).bind()
    params = {k: inputs[f"p_{k}"] for k in KEYS}
    x = inputs["x"]
    return {"scatter": _run(CFG, params, x, mesh, True),
            "gather": _run(CFG, params, x[:, :1], mesh, True),
            "drops": _run(CFG_DROPS, {k: inputs[f"p2_{k}"] for k in KEYS if f"p2_{k}" in inputs},
                          inputs["x2"], mesh, False)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_ep") / "reference.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(path) as data:
        return dict(data)


@pytest.fixture(scope="module", params=MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def world(request, reference):
    dims = request.param
    inputs = {k: v for k, v in reference.items() if k.startswith(("p_", "p2_", "x"))}
    return f"{dims[0]}x{dims[1]}", run_world(_rank_job, dims[0] * dims[1], dims, inputs,
                                              timeout=240)


@pytest.mark.parametrize("path", ["scatter", "gather"])
def test_outputs_match_the_reference(world, reference, path):
    name, ranks = world
    for out in ranks:
        np.testing.assert_allclose(out[path]["y"], reference[f"{name}_{path}_y"],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("path", ["scatter", "gather"])
def test_gradients_match_the_reference(world, reference, path):
    name, ranks = world
    for out in ranks:
        for k in KEYS:
            np.testing.assert_allclose(out[path][f"g_{k}"], reference[f"{name}_{path}_g_{k}"],
                                       rtol=1e-3, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("path", ["scatter", "gather"])
def test_aux_losses_are_the_whole_batch(world, reference, path):
    name, ranks = world
    for out in ranks:
        for k in ("moe_load_balance", "moe_z"):
            np.testing.assert_allclose(out[path][k], reference[f"local_{path}_{k}"],
                                       rtol=1e-5, err_msg=k)
        assert out[path]["moe_dropped"] == reference[f"{name}_{path}_moe_dropped"] == 0


def test_dropped_pairs_equal_the_reference(world, reference):
    name, ranks = world
    want = float(reference[f"drops_{name}_dropped"])
    assert want > 0
    for out in ranks:
        assert out["drops"]["moe_dropped"] == want
        np.testing.assert_allclose(out["drops"]["y"], reference[f"drops_{name}_y"],
                                   rtol=1e-4, atol=1e-4)


def test_ep_specs_and_applicability():
    mesh = Mesh({"data": 2, "model": 4})
    assert ep_applicable(CFG, mesh) and not ep_applicable(CFG, Mesh({"data": 4, "model": 1}))
    assert not ep_applicable(CFG, Mesh({"data": 1, "model": 3})) and not ep_applicable(CFG, None)
    assert ep_specs(CFG, mesh) == {"router": (), "w_gate": ("model", None, "data"),
                                   "w_up": ("model", None, "data"), "w_down": ("model", "data"),
                                   "sh_gate": (), "sh_up": (), "sh_down": ()}
    assert ep_specs(CFG_DROPS, Mesh({"data": 1, "model": 4}))["w_gate"] == ("model",)
