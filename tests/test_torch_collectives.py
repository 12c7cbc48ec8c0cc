"""The port's collectives on gloo CPU ranks against the reference's shard_map.

The reference runs once, in a subprocess with
``--xla_force_host_platform_device_count=8`` (as tests/test_distributed.py
runs it), on meshes of 2, 4 and 8 devices at that test's inputs:
x [4, 256] and w [256, 64] * 0.05 for the products, g [8, 64] for the ring
and the compressed all-reduce.  It saves the inputs and every output to
``tmp_path``.  The port runs the same inputs on one spawned gloo world per
size (``repro_torch.distributed.run_world``), each rank with its shard.

Tolerances: the JAX test's 1e-4 for the float32 products (only the order of
the sums differs); exact for ``compressed_psum``, whose int32 sum and scale
are the same operations on both sides.  N / n (8, 16, 32 columns a tile) is
never B = 4, so a transposed all-gather cannot pass.  This file imports no
JAX: the spawned ranks import it to find their job, and need torch only.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed import (
    compressed_psum,
    fused_gemv_allreduce,
    overlap_grad_allreduce,
    psum_matmul,
    ring_allreduce,
    run_world,
)
from repro_torch.kernels.gemv_tiles import remote_first_order

SRC = Path(__file__).resolve().parents[1] / "src"
WORLDS = (2, 4, 8)
BF16_UNIT_ROUNDOFF = 2.0 ** -8  # bf16 keeps 8 significant bits

_REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.collectives import (compressed_psum, fused_gemv_allreduce,
                                           overlap_grad_allreduce, psum_matmul,
                                           ring_allreduce)
from repro.distributed.compat import SHARD_MAP_NO_CHECK, shard_map

x = jax.random.normal(jax.random.PRNGKey(0), (4, 256), jnp.float32)
w = jax.random.normal(jax.random.PRNGKey(1), (256, 64), jnp.float32) * 0.05
g = jax.random.normal(jax.random.PRNGKey(0), (8, 64), jnp.float32)
out = {"x": x, "w": w, "g": g}
for n in (2, 4, 8):
    model = Mesh(np.array(jax.devices()[:n]), ("model",))
    data = Mesh(np.array(jax.devices()[:n]), ("data",))
    out[f"psum{n}"] = jax.jit(psum_matmul(model))(x, w)
    out[f"fused{n}"] = jax.jit(fused_gemv_allreduce(model))(x, w)
    out[f"ring{n}"] = jax.jit(ring_allreduce(data, "data"))(g)
    out[f"compressed{n}"] = jax.jit(shard_map(
        lambda s: compressed_psum(s, "data"), mesh=data, in_specs=P("data"),
        out_specs=P("data"), **SHARD_MAP_NO_CHECK))(g)
    tree = {"a": g[:2], "b": [w[:3, :5], (x[:, :7],)]}
    for tag, compress in (("grads", False), ("grads_int8", True)):
        red = overlap_grad_allreduce(data, "data", compress=compress)(tree)
        out[f"{tag}{n}_a"], out[f"{tag}{n}_b0"] = red["a"], red["b"][0]
        out[f"{tag}{n}_b10"] = red["b"][1][0]
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""


def _flat(tree) -> dict:
    """The leaves of ``{"a": ., "b": [., (.,)]}`` under the reference script's keys."""
    return {"a": tree["a"].numpy(), "b0": tree["b"][0].numpy(), "b10": tree["b"][1][0].numpy()}


def _rank_job(rank: int, world: int, inputs: dict) -> dict:
    """One rank's share of every check, returned as numpy arrays."""
    torch.set_num_threads(1)
    x, w, g = (torch.from_numpy(inputs[k]) for k in ("x", "w", "g"))
    k_shard, g_rows = x.shape[1] // world, g.shape[0] // world
    xs, ws = x[:, rank * k_shard:(rank + 1) * k_shard], w[rank * k_shard:(rank + 1) * k_shard]
    gs = g[rank * g_rows:(rank + 1) * g_rows]
    fused, owner_served = fused_gemv_allreduce(xs, ws)
    fused_bf16, _ = fused_gemv_allreduce(xs.to(torch.bfloat16), ws.to(torch.bfloat16))
    tree = {"a": g[:2], "b": [w[:3, :5], (x[:, :7],)]}
    return {
        "psum": psum_matmul(xs, ws).numpy(), "fused": fused.numpy(),
        "owner_served": owner_served.numpy(),
        "psum_bf16": psum_matmul(xs.to(torch.bfloat16), ws.to(torch.bfloat16)).float().numpy(),
        "fused_bf16": fused_bf16.float().numpy(),
        "ring": ring_allreduce(gs).numpy(), "compressed": compressed_psum(gs).numpy(),
        "grads": _flat(overlap_grad_allreduce(tree)),
        "grads_int8": _flat(overlap_grad_allreduce(tree, compress=True)),
    }


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("collectives") / "reference.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(path) as data:
        return dict(data)


@pytest.fixture(scope="module", params=WORLDS, ids=[f"world{n}" for n in WORLDS])
def world(request, reference):
    n = request.param
    inputs = {k: reference[k] for k in ("x", "w", "g")}
    return n, run_world(_rank_job, n, inputs, timeout=180)


def test_products_match_the_reference(world, reference):
    n, ranks = world
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["psum"], reference[f"psum{n}"], rtol=1e-4, atol=1e-4,
                                   err_msg=f"psum_matmul, rank {r}")
        np.testing.assert_allclose(out["fused"], reference[f"fused{n}"], rtol=1e-4,
                                   atol=1e-4, err_msg=f"fused_gemv_allreduce, rank {r}")
        np.testing.assert_allclose(out["fused"], out["psum"], rtol=1e-4, atol=1e-4)


def test_each_rank_serves_remote_tiles_first(world):
    n, ranks = world
    tiles_per_dev = 1  # bm = min(64, 64 // n) rows: one tile per owner
    for r, out in enumerate(ranks):
        expect = [t // tiles_per_dev for t in remote_first_order(n, r, tiles_per_dev)]
        assert out["owner_served"].tolist() == expect
        assert expect[0] == (r + 1) % n and expect[-1] == r


def test_bf16_products_within_their_roundings(world, reference):
    """In bf16 each rank's partial is rounded once (n roundings) and the ring
    adds n - 1 times in bf16 (collectives.py:92); the all-reduce of
    ``psum_matmul`` adds n - 1 times too.  Each rounding errs by at most
    2^-8 of a value no larger than sum_r |p_r|, so both stay within
    (2n - 1) * 2^-8 * sum_r |p_r| of the float32 product of the bf16 inputs.
    Dropping one rank's partial must break that bound."""
    n, ranks = world
    x = torch.from_numpy(reference["x"]).to(torch.bfloat16).double()
    w = torch.from_numpy(reference["w"]).to(torch.bfloat16).double()
    k = x.shape[1] // n
    partials = [x[:, r * k:(r + 1) * k] @ w[r * k:(r + 1) * k] for r in range(n)]
    exact = sum(partials).numpy()
    limit = (2 * n - 1) * BF16_UNIT_ROUNDOFF * sum(p.abs() for p in partials).numpy()
    for out in ranks:
        for key in ("psum_bf16", "fused_bf16"):
            assert (np.abs(out[key] - exact) <= limit).all(), key
    dropped = (sum(partials[1:]).float().to(torch.bfloat16).double()).numpy()
    assert not (np.abs(dropped - exact) <= limit).all()


def test_ring_allreduce_matches_the_reference(world, reference):
    n, ranks = world
    rows = 8 // n
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["ring"], reference[f"ring{n}"][r * rows:(r + 1) * rows],
                                   rtol=1e-5, atol=1e-5)


def test_compressed_psum_is_exact(world, reference):
    n, ranks = world
    rows = 8 // n
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(
            out["compressed"], reference[f"compressed{n}"][r * rows:(r + 1) * rows])


@pytest.mark.parametrize("tag", ["grads", "grads_int8"])
def test_overlap_grad_allreduce_per_leaf(world, reference, tag):
    """Every rank passes the same tree, as the reference's replicated leaves."""
    n, ranks = world
    for out in ranks:
        for leaf, got in out[tag].items():
            want = reference[f"{tag}{n}_{leaf}"]
            if tag == "grads_int8":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _failing_job(rank: int, world: int) -> None:
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    time.sleep(120)  # a rank still busy when another fails: the parent ends it


def test_run_world_reports_a_failing_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*on purpose"):
        run_world(_failing_job, 2, timeout=60)
    assert time.monotonic() - t0 < 60  # the sleeping rank was ended, not awaited
