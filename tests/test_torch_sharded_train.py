"""The port's sharded train step (``training/trainer.py`` with a mesh) on gloo
CPU worlds against the single-device step.

The reference's own sharded step fails on jax 0.9 (``params["embed"][tokens]``
on a model-sharded table raises ``ShardingTypeError``), so the step is held
to the port's single-device step, which ``test_torch_train.py`` holds to the
reference's ``jax.value_and_grad(Model.loss_fn)`` and ``adamw_step``.  The
reference runs once, in a subprocess: ``Model.init(PRNGKey(0))`` of the
reduced gemma3-1b and olmoe-1b-7b and their loss on the test's first batch,
in float32 and bf16.  Both port sides start from those
weights (each rank through ``params_from_jax`` with its mesh).

One world of 4 ranks a mesh, (2, 2), (1, 4) and (4, 1): tensor-parallel
attention (the single KV head of gemma3-1b gathered on every model rank),
MLP, vocab-parallel embedding, head and cross-entropy, expert-parallel MoE
(capacity factor 4, so no pair drops and the layer equals the dropless
``moe_apply``), batch rows over ``data`` in 2 microbatches, ZeRO-1.

Bounds: float32, the loss of the whole batch within 1e-3 of the
single-device step's (and of the reference's), every gathered gradient
within 1e-4, the parameters after 2 AdamW steps within 1e-5, except where
AdamW magnifies a rounding, as ``test_torch_train.py`` sets out: an entry
whose step gradient (the mean of the microbatches' gradients, which AdamW
takes) is a near-cancelling sum, so that its float32 rounding shows, may move
by up to a whole update (a first update is ``lr * g / (|g| + 1e-8)``).  Such
an entry is known by its own float32 error: the two runs' step gradients of
it differ by more than ``GRAD_SPREAD`` of it at some step, where a sum far
from cancelling differs by about 1e-6.  It is held to ``2 * sum(lr)``, and
such entries must be fewer than 1 in 10^4; bf16, the
losses of all meshes and the single device within 0.05 (the reference's
cross-mesh bound, ``tests/test_distributed.py``).  On each mesh the step
under remat "dots" (the exchanges recomputed with the rest) equals the step
without remat within 1e-6.

The same worlds hold the blocks that compute their heads' share under a
mesh (``BLOCK_VARIANTS``, float32): zamba2-2.7b's Mamba2 blocks (reduced, 2
heads: head-parallel on (2, 2), whole on every rank of (1, 4); at d_model
128, 4 heads: head-parallel on both), xlstm-125m's mLSTM cells (its sLSTM
cell whole) and minicpm3-4b's MLA attention.  Their loss and gradients are
held to the single device's and to the reference's
``jax.value_and_grad(Model.loss_fn)`` (run in the same subprocess), and
their two steps' parameters to the single device's, at the float32 bounds
above.  This file imports no JAX: the spawned ranks import it.
"""

import os
import pickle
import subprocess
import sys
from contextlib import nullcontext
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import run_world
from repro_torch.distributed.collectives import raw_all_reduce
from repro_torch.distributed.sharding import gather_params, gather_tensor, shard_tensor, spec_axes
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig, adamw_step
from repro_torch.training import TrainConfig, build_train_step
from repro_torch.training import trainer

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("gemma3-1b", "olmoe-1b-7b")
DTYPES = ("float32", "bfloat16")
MESHES = ((2, 2), (1, 4), (4, 1))
BLOCK_VARIANTS = {  # name: (arch, config overrides)
    "zamba2-2.7b": ("zamba2-2.7b", {}),
    "zamba2-2.7b-d128": ("zamba2-2.7b", {"d_model": 128}),
    "xlstm-125m": ("xlstm-125m", {}),
    "minicpm3-4b": ("minicpm3-4b", {}),
}
B, S, MB, STEPS = 8, 24, 2, 2
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
LR_SUM = 5e-4 + 1e-3  # the two steps' learning rates (warmup 2)
GRAD_SPREAD = 1e-3  # relative difference of two runs' step gradients that marks a rounding

_REFERENCE = """
import ast, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.models import Model

rng = np.random.default_rng(0)
batches = [(rng.integers(0, 256, (8, 24)).astype(np.int32),
            rng.integers(0, 256, (8, 24)).astype(np.int32)) for _ in range(2)]
out = {"batches": batches}
for arch in ("gemma3-1b", "olmoe-1b-7b"):
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        model = Model(reduced(get_config(arch)).with_(param_dtype=dt))
        params = model.init(jax.random.PRNGKey(0))
        tok, lab = batches[0]
        loss, _ = jax.jit(model.loss_fn)(params, jnp.asarray(tok), jnp.asarray(lab))
        out[f"{arch}/{name}"] = {"params": jax.tree.map(np.asarray, params), "loss": float(loss)}
for name, (arch, kw) in ast.literal_eval(sys.argv[2]).items():
    model = Model(reduced(get_config(arch)).with_(param_dtype=jnp.float32, **kw))
    params = model.init(jax.random.PRNGKey(0))
    tok, lab = batches[0]
    (loss, _), grads = jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True))(
        params, jnp.asarray(tok), jnp.asarray(lab))
    out[name] = {"params": jax.tree.map(np.asarray, params), "loss": float(loss),
                 "grads": jax.tree.map(np.asarray, grads)}
pickle.dump(out, open(sys.argv[1], "wb"))
"""


def _cfg(arch: str, dtype: str, **kw):
    return reduced(get_config(arch)).with_(param_dtype=getattr(torch, dtype), capacity_factor=4.0,
                                           **kw)


def _block_cfg(name: str):
    arch, kw = BLOCK_VARIANTS[name]
    return _cfg(arch, "float32", **kw)


def _tcfg(remat: str = "none") -> TrainConfig:
    return TrainConfig(microbatches=MB, remat_policy=remat, optim=OPT)


def _grads(model, tokens, labels, mesh=None) -> tuple[float, dict]:
    """The loss of a batch and its gradients, whole tensors; under a mesh from
    this rank's rows, summed over the batch axes where they do not shard the
    parameter (a sharded one's sum happens in its gather's backward), gathered."""
    tokens, labels = torch.from_numpy(tokens), torch.from_numpy(labels)
    if mesh is not None:
        tokens, labels = (shard_tensor(t, ("data",), mesh) for t in (tokens, labels))
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss_fn(tokens, labels)
    loss.backward()
    grads = {}
    for k, p in model.named_parameters():
        g = p.grad.float()
        if mesh is not None:
            spec = model.shardings[k]
            if not set(spec_axes(spec)) & set(mesh.batch_axes):
                g = raw_all_reduce(g, mesh, mesh.batch_axes)
            g = gather_tensor(g, spec, mesh)
        grads[k] = g.numpy().copy()
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def _train(model, step, batches, mesh=None, record=False) -> dict:
    """Losses, gradient norms and parameters after the steps; with ``record``
    each step's gradients too, as AdamW takes them (gathered whole)."""
    state = step.init_state()
    taken = []

    def recording(params, grads, *args, **kwargs):
        taken.append({k: g.detach().clone() for k, g in grads.items()})
        return adamw_step(params, grads, *args, **kwargs)

    out = {"losses": [], "grad_norms": []}
    with mock.patch.object(trainer, "adamw_step", recording) if record else nullcontext():
        for tokens, labels in batches:
            state, metrics = step(state, torch.from_numpy(tokens), torch.from_numpy(labels))
            out["losses"].append(float(metrics["loss"]))
            out["grad_norms"].append(float(metrics["grad_norm"]))
    specs = step.shardings["state"] if mesh is not None else None
    out["step_grads"] = [{k: (g if mesh is None else gather_tensor(g, specs[k], mesh)).numpy()
                          for k, g in grads.items()} for grads in taken]
    whole = dict(model.named_parameters()) if mesh is None else gather_params(model)
    out["params"] = {k: v.detach().float().numpy().copy() for k, v in whole.items()}
    return out


def _rank_job(rank: int, world: int, dims, reference) -> dict:
    torch.set_num_threads(1)
    mesh = Mesh(dict(zip(("data", "model"), dims))).bind()
    batches = reference["batches"]
    out = {}
    variants = [(a, d, "none") for a in ARCHS for d in DTYPES]
    variants += [(a, "float32", "dots") for a in ARCHS]
    for arch, dtype, remat in variants:
        cfg = _cfg(arch, dtype)
        model = Model(cfg, device="cpu")
        step = build_train_step(model, _tcfg(remat), mesh)
        model.load_state_dict(params_from_jax(reference[f"{arch}/{dtype}"]["params"], cfg, mesh))
        res = {}
        if remat == "none":  # the whole batch's loss and gradients
            res["loss"], res["grads"] = _grads(model, *batches[0], mesh)
        res.update(_train(model, step, batches, mesh,
                          record=(dtype, remat) == ("float32", "none")))
        out[(arch, dtype, remat)] = res
    for name in BLOCK_VARIANTS:
        cfg = _block_cfg(name)
        model = Model(cfg, device="cpu")
        step = build_train_step(model, _tcfg(), mesh)
        model.load_state_dict(params_from_jax(reference[name]["params"], cfg, mesh))
        res = {"unpartitioned": step.unpartitioned}
        res["loss"], res["grads"] = _grads(model, *batches[0], mesh)
        res.update(_train(model, step, batches, mesh, record=True))
        out[name] = res
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_train") / "reference.pkl"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(path), repr(BLOCK_VARIANTS)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def single(reference):
    """The single-device step from the reference's weights: loss, gradients,
    each step's gradients (float32) and the parameters after the steps."""
    out = {}
    for arch in ARCHS:
        for dtype in DTYPES:
            cfg = _cfg(arch, dtype)
            model = Model(cfg, device="cpu")
            model.load_state_dict(params_from_jax(reference[f"{arch}/{dtype}"]["params"], cfg))
            model.requires_grad_(True)
            loss, grads = _grads(model, *reference["batches"][0])
            step = build_train_step(model, _tcfg())
            out[(arch, dtype)] = {"loss": loss, "grads": grads,
                                  **_train(model, step, reference["batches"],
                                           record=dtype == "float32")}
    for name in BLOCK_VARIANTS:
        cfg = _block_cfg(name)
        model = Model(cfg, device="cpu")
        model.load_state_dict(params_from_jax(reference[name]["params"], cfg))
        model.requires_grad_(True)
        loss, grads = _grads(model, *reference["batches"][0])
        step = build_train_step(model, _tcfg())
        out[name] = {"loss": loss, "grads": grads,
                     **_train(model, step, reference["batches"], record=True)}
    return out


@pytest.fixture(scope="module", params=MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def world(request, reference):
    dims = request.param
    return dims, run_world(_rank_job, dims[0] * dims[1], dims, reference, timeout=300)


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_loss_and_gradients_equal_the_single_device(world, single, reference, arch):
    _, ranks = world
    want = single[(arch, "float32")]
    assert abs(want["loss"] - reference[f"{arch}/float32"]["loss"]) < 3e-5
    for out in ranks:
        got = out[(arch, "float32", "none")]
        assert abs(got["loss"] - want["loss"]) < 1e-3
        assert abs(got["loss"] - reference[f"{arch}/float32"]["loss"]) < 1e-3
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=1e-4, atol=1e-4, err_msg=k)


def _steps_equal(got: dict, want: dict) -> None:
    """Two steps' losses, gradient norms and parameters at the float32 bounds."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-4)
    outside, total = 0, 0
    for k, p in want["params"].items():
        diff = np.abs(got["params"][k] - p)
        out_mask = diff > 1e-5 + 1e-5 * np.abs(p)
        rounded = np.zeros(p.shape, bool)  # a step gradient whose float32 rounding shows
        for mine, theirs in zip(got["step_grads"], want["step_grads"]):
            rounded |= np.abs(mine[k] - theirs[k]) > GRAD_SPREAD * np.abs(theirs[k])
        assert rounded[out_mask].all(), k
        assert (diff[out_mask] <= 2 * LR_SUM).all(), k
        outside += int(out_mask.sum())
        total += p.size
    assert outside <= 1e-4 * total


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_steps_equal_the_single_device(world, single, arch):
    _, ranks = world
    want = single[(arch, "float32")]
    for out in ranks:
        _steps_equal(out[(arch, "float32", "none")], want)


def _reference_grads(reference, name: str) -> dict:
    """The reference's gradients of a block variant, by the port's names."""
    cfg = _block_cfg(name)
    grads = params_from_jax(reference[name]["grads"], cfg)
    return {k: v.numpy() for k, v in grads.items()}


@pytest.mark.parametrize("name", list(BLOCK_VARIANTS))
def test_partitioned_blocks_loss_and_gradients(world, single, reference, name):
    """The head-parallel blocks' loss and gradients against the single
    device's and the reference's ``jax.value_and_grad`` (the single device's
    within 3e-5 of the reference's, as ``test_torch_train.py`` holds it)."""
    _, ranks = world
    want, ref_grads = single[name], _reference_grads(reference, name)
    assert abs(want["loss"] - reference[name]["loss"]) < 3e-5
    for k, g in want["grads"].items():
        np.testing.assert_allclose(g, ref_grads[k], rtol=3e-5, atol=3e-5, err_msg=k)
    for out in ranks:
        got = out[name]
        assert abs(got["loss"] - want["loss"]) < 1e-3
        assert abs(got["loss"] - reference[name]["loss"]) < 1e-3
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=1e-4, atol=1e-4, err_msg=k)
            np.testing.assert_allclose(got["grads"][k], ref_grads[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("name", list(BLOCK_VARIANTS))
def test_partitioned_blocks_steps_equal_the_single_device(world, single, name):
    _, ranks = world
    for out in ranks:
        _steps_equal(out[name], single[name])


def test_the_blocks_each_mesh_partitions(world):
    """``unpartitioned``: nothing where ``model`` divides the heads (and on
    (4, 1), where ``model`` has one rank) but the sLSTM cell; the reduced
    zamba2's Mamba2 blocks (2 heads) on (1, 4)."""
    dims, ranks = world
    got = {name: ranks[0][name]["unpartitioned"] for name in BLOCK_VARIANTS}
    model = dims[1] > 1
    assert got["zamba2-2.7b"] == ([f"blocks.{i}.mamba" for i in range(4)]
                                  if dims[1] == 4 else [])
    assert got["zamba2-2.7b-d128"] == got["minicpm3-4b"] == []
    assert got["xlstm-125m"] == (["blocks.3.cell"] if model else [])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_losses_within_the_cross_mesh_bound(world, single, arch):
    _, ranks = world
    want = single[(arch, "bfloat16")]
    for out in ranks:
        got = out[(arch, "bfloat16", "none")]
        spread = np.abs(np.array(got["losses"] + [got["loss"]])
                        - np.array(want["losses"] + [want["loss"]])).max()
        assert spread < 0.05, spread


def test_every_rank_agrees(world):
    _, ranks = world
    for key, first in ranks[0].items():
        for out in ranks[1:]:
            assert out[key]["losses"] == first["losses"], key


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_equals_no_remat_on_the_mesh(world, arch):
    _, ranks = world
    for out in ranks:
        base, dots = out[(arch, "float32", "none")], out[(arch, "float32", "dots")]
        np.testing.assert_allclose(dots["losses"], base["losses"], rtol=0, atol=1e-6)
        for k, p in base["params"].items():
            np.testing.assert_allclose(dots["params"][k], p, rtol=1e-6, atol=1e-6, err_msg=k)
