"""The caches' placement of the port's sharded serving against the
reference's ``_cache_leaf_spec`` (``repro/launch/specs.py``).

On the cache shapes of every registry config (the port's ``init_caches``,
which are the reference's ``abstract_caches`` shapes), at S 32768 and an S
no mesh axis divides, with B 128 and B 1, on the meshes single (16 x 16),
multi (2 x 16 x 16), 2x2 and 1x4: the port's spec of each cache tensor is
the reference's wherever none of its four deviations applies, and each
deviation is asserted by name where it does:

- ``state_heads`` (a): a Mamba or mLSTM state is cut over ``model`` on its
  heads (dim 1) where its block is head-parallel, else by its rows alone
  (an sLSTM cell's ``[B, d]`` state is the reference's placement);
- ``kv_heads_read`` (b): under head-parallel attention whose KV heads
  ``model`` does not divide, the rank holds the heads its query heads read,
  so dim 2 stays uncut (the reference's replicated placement has the same
  spec there, and the rank's shard holds only those heads);
- ``pod_rows`` (c): the rows over ("pod", "data"), as the tokens are;
- ``conv_channels_read`` (d): a head-parallel Mamba block's conv window
  holds the channels its heads read (its x channels, all of B and C), so
  dim 2 stays uncut in the spec.

The reference's function reads only ``mesh.shape``, so it runs on a stand-in.
"""

import types

import pytest
import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.distributed.sharding import (CACHE_DEVIATIONS, cache_leaf_spec, param_shardings,
                                              rows_spec, shard_params)
from repro_torch.launch.mesh import make_mesh_by_name
from repro_torch.models import Model
from repro_torch.models.model import (_cache_role, _head_parallel, cache_specs, init_caches,
                                      layer_blocks, param_specs)

MESHES = ("single", "multi", "2x2", "1x4")
BATCHES = (128, 1)
SEQS = (32768, 1001)  # 1001: neither data nor model divides the slots


def _padded(spec, n):
    return list(spec) + [None] * (n - len(spec))


def _check(port, devs, ref, role, parallel, shape, mesh, batch):
    """The port's spec is the reference's but for the named deviations."""
    p, r = _padded(port, len(shape)), _padded(ref, len(shape))
    if "pod_rows" in devs:
        assert mesh.shape.get("pod", 1) > 1 and p[0] == rows_spec(mesh, batch) != r[0]
        p[0] = r[0] = None
    if "state_heads" in devs:
        assert role in ("state", "conv") and r[1:] != p[1:]
        assert p[1:] == (["model"] + [None] * (len(shape) - 2)
                         if parallel and role == "state" else [None] * (len(shape) - 1))
        r[1:] = p[1:]
    elif role in ("state", "conv"):
        assert not parallel or role == "conv" or len(shape) < 2 or p[1] == "model"
    if "conv_channels_read" in devs:
        assert role == "conv" and parallel and not any(p[1:])
    else:
        assert not (role == "conv" and parallel and mesh.shape["model"] > 1)
    if "kv_heads_read" in devs:
        msz = mesh.shape["model"]
        assert role == "kv" and p[2] is None
        assert (parallel and shape[2] % msz) or (not parallel and r[2] == "model")
        r[2] = None
    assert p == r


@pytest.fixture(scope="module")
def reference_leaf_spec():
    from repro.launch.specs import _cache_leaf_spec as ref

    return lambda shape, mesh, batch: tuple(ref(tuple(shape),
                                                types.SimpleNamespace(shape=dict(mesh.shape)),
                                                batch))


@pytest.mark.parametrize("mesh_name", MESHES)
def test_cache_leaf_specs_against_the_reference(mesh_name, reference_leaf_spec):
    mesh = make_mesh_by_name(mesh_name)
    seen = set()
    for arch in REGISTRY:
        cfg = get_config(arch)
        shardings, _ = param_shardings(param_specs(cfg), mesh)
        for batch in BATCHES:
            for S in SEQS:
                caches = init_caches(cfg, batch, S, torch.device("meta"))
                for (block, _), entry in zip(layer_blocks(cfg), caches):
                    parallel = _head_parallel(cfg, mesh, shardings, block)
                    for name, t in entry.items():
                        role = _cache_role(cfg, block, name)
                        port, devs = cache_leaf_spec(t.shape, mesh, batch, role,
                                                     head_parallel=parallel)
                        ref = reference_leaf_spec(t.shape, mesh, batch)
                        _check(port, devs, ref, role, parallel, t.shape, mesh, batch)
                        seen.update(devs)
    assert "recurrent_whole" not in CACHE_DEVIATIONS
    want = {"single": {"state_heads", "kv_heads_read", "conv_channels_read"},
            "multi": set(CACHE_DEVIATIONS),
            "2x2": {"state_heads", "kv_heads_read", "conv_channels_read"},
            "1x4": {"state_heads", "kv_heads_read", "conv_channels_read"}}[mesh_name]
    assert seen == want


def test_cache_shapes_are_the_reference_abstract_caches():
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import Model as RefModel

    for arch in REGISTRY:
        want = RefModel(ref_config(arch)).abstract_caches(2, 48)
        got = init_caches(get_config(arch), 2, 48, torch.device("meta"))
        assert len(got) == len(want), arch
        for g, w in zip(got, want):
            assert {k: tuple(v.shape) for k, v in g.items()} == \
                {k: tuple(v.shape) for k, v in w.items()}, arch
            assert jax.tree.structure(w).num_leaves == len(g)


@pytest.mark.parametrize("arch,mesh_name,batch,deviations", [
    ("gemma3-1b", "2x2", 4, {"kv_heads_read"}),
    ("gemma3-1b", "single", 1, set()),
    ("olmoe-1b-7b", "multi", 128, {"pod_rows"}),
    ("zamba2-2.7b", "single", 128, {"state_heads", "conv_channels_read"}),
    ("xlstm-125m", "1x4", 1, {"state_heads"}),
])
def test_cache_shardings_log_and_the_ranks_shards(arch, mesh_name, batch, deviations):
    """``cache_specs`` names each deviation once in its log, and a bound
    model's abstract caches are its rank's shards of those specs."""
    cfg = get_config(arch)
    mesh = make_mesh_by_name(mesh_name)
    specs, log = cache_specs(cfg, mesh, batch, 1024)
    assert {d for d in CACHE_DEVIATIONS for line in log if f"[{d}]" in line} == deviations
    model = Model.abstract(cfg)
    bound = mesh.bind_abstract(mesh.size - 1)
    shard_params(model, bound)
    caches = model.abstract_caches(batch, 1024)
    assert caches.specs == specs == cache_specs(cfg, bound, batch, 1024, model.shardings)[0]
    whole = init_caches(cfg, batch, 1024, torch.device("meta"))
    for entry, spec, full in zip(caches, specs, whole):
        for name, t in entry.items():
            for d, part in enumerate(_padded(spec[name], t.dim())):
                n = 1 if part is None else mesh.axis_size(part)
                if d == 2 and name == "conv" and "conv_channels_read" in deviations:
                    # the x channels of the rank's heads, and all of B and C
                    ds, msz = cfg.ssm_state, mesh.shape["model"]
                    assert t.shape[d] == (full[name].shape[d] - 2 * ds) // msz + 2 * ds
                elif not (d == 2 and "kv_heads_read" in deviations):
                    assert t.shape[d] == full[name].shape[d] // n, (name, d)
