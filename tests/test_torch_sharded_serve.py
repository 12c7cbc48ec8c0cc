"""Sharded serving: ``Model.prefill``, ``Model.decode_step`` and
``ServeEngine.generate`` on a model bound to a mesh, in gloo CPU worlds,
against the port's one-rank model on the same weights and the reference's
unsharded ``decode_step``.

The reference runs once, in a subprocess: ``Model.init(PRNGKey(0))`` of
each variant's reduced config in float32, and for gemma3-1b, olmoe-1b-7b,
zamba2-2.7b and xlstm-125m its jitted ``decode_step`` over a prompt of 6
tokens and 4 greedy ones (B 4), as the engine steps.  Its sharded decode is
not run: it hits jax 0.9's ``ShardingTypeError`` (``ROADMAP.md``, the
reference's 7 failing tests).  Every port model takes those weights through
``params_from_jax`` (with the mesh, each rank's shards).

One world of 4 ranks a mesh, (2, 2) and (1, 4), spawned once each.  On every
rank, for each variant: ``prefill`` of its rows of the prompts into caches
of prompt + new slots (``max_len``), greedy ``decode_step``s from them (the
last one's collectives captured), and ``ServeEngine.generate`` of the
prompts with every step's logits recorded.
The variants:

- gemma3-1b, B 4: head-parallel attention, the single KV head read by every
  model rank, the vocab-parallel embedding and head;
- gemma3-1b, B 1, prompt 10 + 8 new tokens: the rows do not divide over
  ``data``, so on (2, 2) every cache's slots are cut over ``data``
  (sequence-parallel) and the 16-slot ring of a local layer wraps across
  the two data ranks, the second starting with an empty slice (and after
  the prompt's prefill holding 2 of its 8 slots);
- olmoe-1b-7b: the expert-parallel MoE's gather path;
- minicpm3-4b, naive and absorbed: MLA head-parallel, its latents' slots
  cut over ``model`` (every head's query gathered to attend the rank's
  slots, the rank's heads kept after the join);
- zamba2-2.7b: Mamba2 head-parallel on (2, 2) (2 heads), whole on every
  rank of (1, 4), the shared attention block head-parallel; at d_model 128
  (4 heads) head-parallel on both meshes, its states the rank's heads';
- xlstm-125m: the mLSTM cells head-parallel, the sLSTM cell whole.

Bounds, float32: the logits within 1e-5 of the one-rank model's at every
step (prefill, decode and every engine step), the one-rank model's prefill
and decode steps within 1e-5 of its engine's token-by-token steps; greedy
tokens and the engine's
outputs and stats equal; each rank's executed schedule of a decode step
equal, op for op, to ``trace_cell``'s abstract capture of that rank; on
(2, 2) the sharded gemma3-1b, olmoe-1b-7b, zamba2-2.7b and xlstm-125m
engines' logits within 3e-5 of the reference's ``decode_step`` at every step
and their tokens equal.  This
file imports no JAX: the spawned ranks import it.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.capture import CollectiveOp, capture_collectives
from repro_torch.distributed import run_world
from repro_torch.distributed.sharding import rows_spec, shard_tensor
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServeConfig, ServeEngine

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = ((2, 2), (1, 4))
VARIANTS = {  # name: (arch, batch, prompt tokens, new tokens, absorbed MLA decode)
    "gemma3-1b": ("gemma3-1b", 4, 6, 4, False),
    "gemma3-1b-seq": ("gemma3-1b", 1, 10, 8, False),
    "olmoe-1b-7b": ("olmoe-1b-7b", 4, 6, 4, False),
    "minicpm3-4b": ("minicpm3-4b", 4, 8, 4, False),
    "minicpm3-4b-absorbed": ("minicpm3-4b", 4, 8, 4, True),
    "zamba2-2.7b": ("zamba2-2.7b", 4, 6, 4, False),
    "zamba2-2.7b-d128": ("zamba2-2.7b", 4, 6, 4, False),
    "xlstm-125m": ("xlstm-125m", 4, 6, 4, False),
}
WIDER = {"zamba2-2.7b-d128": {"d_model": 128}}  # config overrides of a variant
REFERENCE_DECODE = ("gemma3-1b", "olmoe-1b-7b", "zamba2-2.7b", "xlstm-125m")
TOL, REF_TOL = 1e-5, 3e-5

_REFERENCE = """
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.models import Model

prompts, decode, configs = pickle.load(open(sys.argv[2], "rb"))
out = {}
for arch, (name, kw) in configs.items():
    model = Model(reduced(get_config(name)).with_(param_dtype=jnp.float32, **kw))
    params = model.init(jax.random.PRNGKey(0))
    out[arch] = {"params": jax.tree.map(np.asarray, params)}
    if arch in decode:
        toks, n_new = prompts[arch], decode[arch]
        B, P = toks.shape
        step = jax.jit(model.decode_step)
        caches = model.init_caches(B, P + n_new)
        tok, logits_all, new = jnp.asarray(toks[:, 0], jnp.int32), [], []
        for t in range(P + n_new):
            logits, caches = step(params, caches, tok, jnp.int32(t))
            logits_all.append(np.asarray(logits))
            tok = jnp.asarray(toks[:, t + 1], jnp.int32) if t + 1 < P else jnp.argmax(logits, -1)
            if t + 1 >= P:
                new.append(np.asarray(tok))
        out[arch].update(logits=np.stack(logits_all), tokens=np.stack(new[:n_new], 1))
pickle.dump(out, open(sys.argv[1], "wb"))
"""


def _cfg(name: str):
    """A variant's config: its reduced arch in float32."""
    arch, absorbed = VARIANTS[name][0], VARIANTS[name][4]
    return reduced(get_config(arch)).with_(param_dtype=torch.float32,
                                           mla_absorbed_decode=absorbed, **WIDER.get(name, {}))


def _weights(name: str) -> str:
    """The reference's weights a variant takes (its arch's, or its own width's)."""
    return name if name in WIDER else VARIANTS[name][0]


def _prompts() -> dict:
    rng = np.random.default_rng(0)
    return {name: rng.integers(1, 256, (B, P)) for name, (_, B, P, _, _) in VARIANTS.items()}


def _serve(model, prompts: np.ndarray, n_new: int, mesh=None) -> dict:
    """One variant on one rank (or on one device): prefill and greedy decode
    steps from its caches (the last step's collectives captured), then the
    engine with every step's logits."""
    B, P = prompts.shape
    tokens = torch.from_numpy(prompts)
    rows = None if mesh is None else rows_spec(mesh, B)
    mine = tokens if rows is None else shard_tensor(tokens, (rows,), mesh)
    logits, caches = model.prefill(mine, batch=B, max_len=P + n_new)
    out = {"prefill": logits.numpy().copy(), "decode": [], "tokens": []}
    for k in range(n_new):
        nxt = torch.argmax(logits, dim=-1)
        out["tokens"].append(nxt.numpy().copy())
        with capture_collectives() as ops:
            logits, caches = model.decode_step(caches, nxt, P + k)
        out["decode"].append(logits.numpy().copy())
    out["ops"] = [dataclasses.asdict(o) for o in ops]
    out["cache_specs"] = caches.specs
    engine = ServeEngine(model, ServeConfig(max_batch=B))
    step, seen = model.decode_step, []

    def recording(*args, **kwargs):
        result = step(*args, **kwargs)
        seen.append(result[0].numpy().copy())
        return result

    model.decode_step = recording
    out["outputs"] = engine.generate(prompts.tolist(), n_new)
    del model.decode_step
    out.update(stats=dict(engine.stats), engine_logits=np.stack(seen))
    return out


def _rank_job(rank: int, world: int, dims, reference, prompts) -> dict:
    torch.set_num_threads(1)
    mesh = Mesh({"data": dims[0], "model": dims[1]}).bind()
    out = {}
    for name, (_, B, P, n_new, _) in VARIANTS.items():
        cfg = _cfg(name)
        model = Model(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(params_from_jax(reference[_weights(name)]["params"], cfg, mesh))
        out[name] = _serve(model, prompts[name], n_new, mesh)
        out[name]["unpartitioned"] = model.unpartitioned()
    return out


@pytest.fixture(scope="module")
def prompts():
    return _prompts()


@pytest.fixture(scope="module")
def reference(tmp_path_factory, prompts):
    tmp = tmp_path_factory.mktemp("sharded_serve")
    path, inputs = tmp / "reference.pkl", tmp / "inputs.pkl"
    configs = {_weights(name): (VARIANTS[name][0], WIDER.get(name, {})) for name in VARIANTS}
    with open(inputs, "wb") as f:
        pickle.dump(({a: prompts[a] for a in REFERENCE_DECODE},
                     {a: VARIANTS[a][3] for a in REFERENCE_DECODE}, configs), f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(path), str(inputs)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def single(reference, prompts):
    """The one-rank port model of each variant on the reference's weights."""
    out = {}
    for name, (_, _, _, n_new, _) in VARIANTS.items():
        cfg = _cfg(name)
        model = Model(cfg, device="cpu")
        model.load_state_dict(params_from_jax(reference[_weights(name)]["params"], cfg))
        out[name] = _serve(model, prompts[name], n_new)
    return out


@pytest.fixture(scope="module")
def worlds(reference, prompts):
    """Each mesh's world, spawned once: ``worlds(dims)`` gives its ranks' results."""
    done = {}

    def get(dims):
        if dims not in done:
            done[dims] = run_world(_rank_job, dims[0] * dims[1], dims, reference, prompts,
                                   timeout=300)
        return done[dims]
    return get


@pytest.fixture(scope="module", params=MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def world(request, worlds):
    return request.param, worlds(request.param)


def _mine(a: np.ndarray, mesh, batch: int, dim: int = 0) -> np.ndarray:
    """This rank's rows of a whole batch's array (rows on ``dim``)."""
    rows = rows_spec(mesh, batch)
    if rows is None:
        return a
    spec = (None,) * dim + (rows,)
    return shard_tensor(torch.from_numpy(a), spec, mesh).numpy()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_and_decode_steps_equal_the_one_rank_model(world, single, name):
    dims, ranks = world
    B = VARIANTS[name][1]
    want = single[name]
    mesh = Mesh({"data": dims[0], "model": dims[1]})
    for rank, got in enumerate(ranks):
        bound = mesh.bind_abstract(rank)
        got = got[name]
        np.testing.assert_allclose(got["prefill"], _mine(want["prefill"], bound, B),
                                   rtol=0, atol=TOL)
        for step, (a, b) in enumerate(zip(got["decode"], want["decode"])):
            np.testing.assert_allclose(a, _mine(b, bound, B), rtol=0, atol=TOL,
                                       err_msg=f"rank {rank} step {step}")
        for a, b in zip(got["tokens"], want["tokens"]):
            assert np.array_equal(a, _mine(b, bound, B))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_to_max_len_goes_on_as_the_token_by_token_decode(single, name):
    """One rank: the prefill's logits and the decode steps after it equal the
    engine's token-by-token steps from the prompt's last token on (the same
    greedy tokens)."""
    P, n_new = VARIANTS[name][2:4]
    got = single[name]
    steps = got["engine_logits"][P - 1:P + n_new]
    np.testing.assert_allclose(np.stack([got["prefill"], *got["decode"]]), steps,
                               rtol=0, atol=TOL)
    assert np.array_equal(np.stack(got["tokens"], 1),
                          np.array([o[P:] for o in got["outputs"]]))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_engine_tokens_stats_and_logits_equal_the_one_rank_engine(world, single, name):
    dims, ranks = world
    B = VARIANTS[name][1]
    want = single[name]
    mesh = Mesh({"data": dims[0], "model": dims[1]})
    for rank, got in enumerate(ranks):
        got = got[name]
        assert got["outputs"] == want["outputs"] and got["stats"] == want["stats"]
        np.testing.assert_allclose(got["engine_logits"],
                                   _mine(want["engine_logits"], mesh.bind_abstract(rank), B, 1),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_decode_schedule_is_the_abstract_capture(world, name):
    """A decode step's collectives as each rank ran them equal ``trace_cell``'s
    capture of that rank (``meta`` tensors, no world) at the same batch and
    cache slots."""
    dims, ranks = world
    _, B, P, n_new, _ = VARIANTS[name]
    mesh = Mesh({"data": dims[0], "model": dims[1]})
    shape = ShapeSpec("serve", P + n_new, B, "decode")
    for rank, got in enumerate(ranks):
        executed = [CollectiveOp(**{**d, "axes": tuple(d["axes"])}) for d in got[name]["ops"]]
        abstract = trace_cell(_cfg(name), shape, mesh, rank)
        assert executed == abstract["ops"] and executed, (rank, len(executed))
        assert abstract["cost"].kernel_calls.get("rmsnorm", 0) > 0


def test_the_placements_each_variant_takes(world):
    """The caches' specs: rows over data at B 4 (2, 2); at B 1 on (2, 2) the
    slots of every KV cache over data (sequence-parallel), on (1, 4) whole;
    olmoe's KV heads over model; MLA latents' slots over model; a Mamba
    ``h`` and an mLSTM state over model on their heads where the block is
    head-parallel (the reduced zamba2's 2 heads are not cut over 4), a conv
    window and an sLSTM state by their rows alone; and the blocks that run
    whole."""
    dims, ranks = world
    got = {name: ranks[0][name]["cache_specs"] for name in VARIANTS}
    rows = ("data",) if dims[0] > 1 else ()
    assert got["gemma3-1b"][0] == {"k": rows, "v": rows}
    assert got["gemma3-1b-seq"][0] == ({"k": (None, "data"), "v": (None, "data")}
                                       if dims[0] > 1 else {"k": (), "v": ()})
    assert got["olmoe-1b-7b"][0] == {"k": (rows[0] if rows else None, None, "model")} | \
        {"v": (rows[0] if rows else None, None, "model")}
    assert got["minicpm3-4b"][0] == {"c_kv": (rows[0] if rows else None, "model"),
                                     "k_pe": (rows[0] if rows else None, "model")}
    r = rows[0] if rows else None
    cut = dims[1] == 2  # the reduced zamba2's 2 Mamba heads
    assert got["zamba2-2.7b"][0] == {"h": (r, "model") if cut else rows, "conv": rows}
    assert got["zamba2-2.7b-d128"][0] == {"h": (r, "model"), "conv": rows}
    assert got["xlstm-125m"][0] == {"C": (r, "model"), "n": (r, "model"), "m": (r, "model")}
    assert got["xlstm-125m"][3] == {k: rows for k in ("c", "n", "m", "h")}
    whole = {name: ranks[0][name]["unpartitioned"] for name in VARIANTS}
    assert whole["zamba2-2.7b"] == ([] if cut else [f"blocks.{i}.mamba" for i in range(4)])
    assert whole["xlstm-125m"] == ["blocks.3.cell"]
    assert whole["minicpm3-4b"] == whole["zamba2-2.7b-d128"] == []


@pytest.mark.parametrize("arch", REFERENCE_DECODE)
def test_sharded_engine_matches_the_reference_decode_step(worlds, reference, arch):
    ranks = worlds((2, 2))
    want = reference[arch]
    B = VARIANTS[arch][1]
    mesh = Mesh({"data": 2, "model": 2})
    for rank, got in enumerate(ranks):
        got = got[arch]
        bound = mesh.bind_abstract(rank)
        np.testing.assert_allclose(got["engine_logits"], _mine(want["logits"], bound, B, 1),
                                   rtol=0, atol=REF_TOL)
        new = np.array([o[VARIANTS[arch][2]:] for o in got["outputs"]])
        assert np.array_equal(new, want["tokens"])
