"""The port's GPipe pipeline (``distributed/pipeline.py``) on 4 gloo CPU ranks
against the reference's ``pipeline_apply``.

The reference runs once, in a subprocess with 4 forced host devices, at the
inputs of ``tests/test_distributed.py::test_pipeline_parallel_matches_sequential``
(8 tanh layers of width 16 over 4 stages, x [8, 16], 4 microbatches), inside
``jax.set_mesh`` (its own test calls ``jit`` outside it, which jax 0.9
refuses): the output and the gradient of sum(out^2) for every stage's
parameters, and the sequential stack's.  The port runs the same inputs on one
world of 4 ranks, each with its stage's layers, at 4 and at 8 microbatches
(2 rows and 1 row a microbatch).  Bound: 1e-5 on the output and the gradients.
This file imports no JAX: the spawned ranks import it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed import bubble_fraction, pipeline_apply, run_world, stack_stage_params
from repro_torch.distributed.collectives import raw_all_gather
from repro_torch.distributed.sharding import shard_tensor
from repro_torch.launch.mesh import Mesh

SRC = Path(__file__).resolve().parents[1] / "src"
STAGES = 4

_REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.distributed.pipeline import bubble_fraction, pipeline_apply, stack_stage_params

mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
L, d = 8, 16
W = jax.random.normal(jax.random.PRNGKey(0), (L, d, d), jnp.float32) * 0.25
b = jax.random.normal(jax.random.PRNGKey(1), (L, d), jnp.float32) * 0.1
layers = {"w": W, "b": b}
def layer_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])
x = jax.random.normal(jax.random.PRNGKey(2), (8, d), jnp.float32)
seq = lambda lp, x: jax.lax.fori_loop(0, L, lambda i, h: layer_fn(
    jax.tree.map(lambda a: a[i], lp), h), x)
out = {"w": W, "b": b, "x": x, "seq": seq(layers, x)}
g_seq = jax.grad(lambda lp: jnp.sum(seq(lp, x) ** 2))(layers)
out.update({"g_seq_w": g_seq["w"], "g_seq_b": g_seq["b"]})
with jax.set_mesh(mesh):
    for n_micro in (4, 8):
        apply = pipeline_apply(mesh, layer_fn, n_micro=n_micro)
        sp = stack_stage_params(layers, 4)
        out[f"out{n_micro}"] = jax.jit(apply)(sp, x)
        g = jax.jit(jax.grad(lambda sp: jnp.sum(apply(sp, x) ** 2)))(sp)
        out[f"g{n_micro}_w"], out[f"g{n_micro}_b"] = g["w"], g["b"]
out["bubble"] = np.array([bubble_fraction(s, m) for s in (1, 2, 4, 8) for m in (1, 4, 8, 32)])
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""


def _layer(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _rank_job(rank: int, world: int, inputs: dict) -> dict:
    torch.set_num_threads(1)
    mesh = Mesh({"pipe": world}).bind()
    layers = {k: torch.from_numpy(inputs[k]) for k in ("w", "b")}
    stages = stack_stage_params(layers, world)
    out = {}
    for n_micro in (4, 8):
        local = {k: shard_tensor(v, ("pipe",), mesh).clone().requires_grad_()
                 for k, v in stages.items()}
        x = torch.from_numpy(inputs["x"]).requires_grad_()
        y = pipeline_apply(mesh, _layer, n_micro=n_micro)(local, x)
        (y ** 2).sum().backward()
        out[f"out{n_micro}"] = y.detach().numpy()
        out[f"x_grad{n_micro}"] = x.grad.numpy()
        for k, t in local.items():
            out[f"g{n_micro}_{k}"] = raw_all_gather(t.grad, mesh, "pipe", 0).numpy()
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipeline") / "reference.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(path) as data:
        return dict(data)


@pytest.fixture(scope="module")
def ranks(reference):
    inputs = {k: reference[k] for k in ("w", "b", "x")}
    return run_world(_rank_job, STAGES, inputs, timeout=180)


@pytest.mark.parametrize("n_micro", [4, 8])
def test_forward_matches_the_reference_and_the_stack(ranks, reference, n_micro):
    for out in ranks:  # every stage gets the result
        np.testing.assert_allclose(out[f"out{n_micro}"], reference[f"out{n_micro}"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out[f"out{n_micro}"], reference["seq"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_micro", [4, 8])
def test_gradients_match_the_reference_and_the_stack(ranks, reference, n_micro):
    for out in ranks:
        for k in ("w", "b"):
            got = out[f"g{n_micro}_{k}"]
            np.testing.assert_allclose(got, reference[f"g{n_micro}_{k}"].reshape(got.shape),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got, reference[f"g_seq_{k}"].reshape(got.shape),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_input_gradient_reaches_every_stage(ranks, reference):
    """Stage 0 reads x; the gradient of x is summed over the stages, so each
    has the sequential stack's."""
    x = torch.from_numpy(reference["x"]).requires_grad_()
    h = x
    for i in range(8):
        h = _layer({"w": torch.from_numpy(reference["w"][i]),
                    "b": torch.from_numpy(reference["b"][i])}, h)
    (h ** 2).sum().backward()
    for out in ranks:
        for n_micro in (4, 8):
            np.testing.assert_allclose(out[f"x_grad{n_micro}"], x.grad.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_bubble_fraction_equals_the_reference(reference):
    got = np.array([bubble_fraction(s, m) for s in (1, 2, 4, 8) for m in (1, 4, 8, 32)])
    np.testing.assert_array_equal(got, reference["bubble"])
    assert bubble_fraction(4, 4) == 3 / 7


def test_stack_stage_params_reshapes_every_leaf():
    tree = {"w": torch.arange(24.0).reshape(8, 3), "n": [torch.arange(8.0)]}
    out = stack_stage_params(tree, 4)
    assert out["w"].shape == (4, 2, 3) and out["n"][0].shape == (4, 2)
    assert torch.equal(out["w"][1, 0], tree["w"][2])
