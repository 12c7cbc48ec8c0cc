"""The port's ZeRO-1 (``distributed/zero.py``) against the reference's.

The reference's specs come from ``test_torch_sharding.REFERENCE`` (one
subprocess, 16 forced host devices): ``zero1_from_params`` (the trainer's
default) and ``zero1_shardings`` of every parameter of all 11 configs at full
size on meshes (1, 16), (2, 4) and (4, 4), and ``zero1_spec`` on a few shapes.

A rank's bytes of float32 state for a reference leaf are its shape's bytes
over the sizes of the axes its spec cuts.  The port keeps a tensor a layer
where the reference stacks them, and cuts a layer tensor on its own first
free divisible dim; its bytes a rank equal the reference's but for a layer
tensor that the reference cuts by layer and whose own dims leave none free:
zamba2-2.7b's per-head vectors ``a_log``, ``d_skip`` and ``dt_bias`` (80
heads) and ``norm_z`` (5120 wide) at (2, 4), whose one dim ``model`` takes;
6 layers a stage divide over ``data`` 2 there, not over 4 at (4, 4).  The
test names each.

One world of 4 gloo ranks at (2, 2) then trains the reduced gemma3-1b in
float32 for 2 AdamW steps with the state aligned to the parameters, as the
trainer keeps it: each rank's gradient norm, gathered parameters and state
equal the single-device step's within 1e-5.  This file imports no
JAX: the spawned ranks import it.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.distributed import run_world
from repro_torch.distributed.sharding import gather_params, gather_tensor, param_shardings
from repro_torch.distributed.zero import zero1_from_params, zero1_shardings, zero1_spec
from repro_torch.launch.mesh import Mesh, make_mesh_by_name
from repro_torch.models import Model
from repro_torch.models.model import param_specs
from repro_torch.optim import AdamWConfig
from repro_torch.training import TrainConfig, build_train_step
from test_torch_sharding import as_spec, port_names, run_reference

MESHES = ("1x16", "2x4", "4x4")
ARCHS = sorted(REGISTRY)
# (mesh, arch): the leaves whose bytes a rank differ, and why
NAMED = {("2x4", "zamba2-2.7b"): {"a_log", "d_skip", "dt_bias", "norm_z"}}
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "zero")[0]


def _bytes(shape, spec, mesh) -> int:
    """A rank's float32 bytes of a tensor of ``shape`` cut as ``spec`` says."""
    return 4 * math.prod(shape) // math.prod(mesh.axis_size(p) for p in spec if p is not None)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_bytes_a_rank_equal_the_reference(reference, mesh_name, arch):
    ref = reference[f"{mesh_name}/{arch}"]
    cfg, mesh = get_config(arch), make_mesh_by_name(mesh_name)
    specs = param_specs(cfg)
    pspecs, _ = param_shardings(specs, mesh)
    shapes = {k: s.shape for k, s in specs.items()}
    for key, zspecs in (("zero", zero1_from_params(pspecs, shapes, mesh, ("data",))),
                        ("zero_plain", zero1_shardings(shapes, mesh, ("data",)))):
        differ = set()
        for path, shape, zspec in zip(ref["paths"], ref["shapes"], ref[key]):
            names, stacked = port_names(path, cfg)
            mine = sum(_bytes(shapes[n], zspecs[n], mesh) for n in names)
            if mine != _bytes(shape, as_spec(zspec), mesh):
                # the reference cut the layers and nothing is left to cut here
                assert stacked and as_spec(zspec)[0] is not None, path
                differ.add(path.rsplit("/", 1)[1])
        if key == "zero":
            assert differ == NAMED.get((mesh_name, arch), set())


@pytest.mark.parametrize("mesh_name", MESHES)
def test_zero1_spec_equals_the_reference(reference, mesh_name):
    mesh = make_mesh_by_name(mesh_name)
    got = [zero1_spec(s, mesh, ("data",), model_dim=md)
           for s in ((8, 6), (6, 8), (3, 5), (4, 16), (16,), (32, 12, 20)) for md in (False, True)]
    assert got == [as_spec(s) for s in reference[f"{mesh_name}/zero1_spec"]]


def test_zero1_from_params_keeps_the_parameter_layout():
    mesh = Mesh({"pod": 2, "data": 2, "model": 2})
    out = zero1_from_params({"a": (None, "model"), "b": ("data",), "c": ()},
                            {"a": (8, 6), "b": (4, 4), "c": (3,)}, mesh, ("data", "pod"))
    assert out == {"a": (("data", "pod"), "model"), "b": ("data",), "c": ()}


def _cfg():
    return reduced(get_config("gemma3-1b")).with_(param_dtype=torch.float32)


def _batches(cfg):
    rng = np.random.default_rng(0)
    return [(torch.from_numpy(rng.integers(0, cfg.vocab, (8, 24))),
             torch.from_numpy(rng.integers(0, cfg.vocab, (8, 24)))) for _ in range(2)]


def _rank_job(rank: int, world: int) -> dict:
    torch.set_num_threads(1)
    mesh = Mesh({"data": 2, "model": 2}).bind()
    model = Model(_cfg(), device="cpu")
    step = build_train_step(model, TrainConfig(microbatches=2, optim=OPT), mesh)
    model.init(torch.Generator().manual_seed(0))
    state = step.init_state()
    zspecs = step.shardings["state"]
    out = {"piece_bytes": sum(t.numel() * 4 for t in state["mu"].values()), "zspecs": zspecs}
    for tokens, labels in _batches(model.cfg):
        state, metrics = step(state, tokens, labels)
    out["params"] = {k: v.numpy() for k, v in gather_params(model).items()}
    out["state"] = {key: {k: gather_tensor(t, zspecs[k], mesh).numpy()
                          for k, t in state[key].items()}
                    for key in ("mu", "nu", "master")}
    out["grad_norm"] = float(metrics["grad_norm"])
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_world(_rank_job, 4, timeout=240)


@pytest.fixture(scope="module")
def single():
    model = Model(_cfg(), device="cpu").init(torch.Generator().manual_seed(0))
    step = build_train_step(model, TrainConfig(microbatches=2, optim=OPT))
    state = step.init_state()
    for tokens, labels in _batches(model.cfg):
        state, metrics = step(state, tokens, labels)
    return model, state, float(metrics["grad_norm"])


@pytest.mark.parametrize("what", ["grad_norm", "params", "state"])
def test_zero1_step_equals_the_single_device_step(ranks, single, what):
    model, state, gnorm = single
    for got in ranks:
        if what == "grad_norm":
            np.testing.assert_allclose(got["grad_norm"], gnorm, rtol=1e-5)
        for k, p in model.named_parameters():
            if what == "params":
                np.testing.assert_allclose(got["params"][k], p.detach().numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=k)
            for key in ("mu", "nu", "master") if what == "state" else ():
                np.testing.assert_allclose(got["state"][key][k], state[key][k].numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=f"{key} {k}")


def test_each_rank_keeps_a_quarter_or_half_of_the_state(ranks):
    """At (2, 2) a tensor the model axis cuts is cut again over data, a
    replicated one over data alone: the aligned pieces of a rank add up to
    the bytes its specs give, and less than half the model's.  The
    reference's layout without regard to the parameter's cuts the same
    projection over data and model, and the embedding over data alone."""
    total = sum(math.prod(s.shape) * 4 for s in param_specs(_cfg()).values())
    mesh = Mesh({"data": 2, "model": 2})
    shapes = {k: s.shape for k, s in param_specs(_cfg()).items()}
    for out in ranks:
        want = sum(_bytes(shapes[k], z, mesh) for k, z in out["zspecs"].items())
        assert out["piece_bytes"] == want
        assert total / 4 <= want < total / 2
        assert out["zspecs"]["blocks.0.attn.w_q"] == ("data", "model")
    assert zero1_shardings(shapes, mesh, ("data",), model_dim=True)["blocks.0.attn.w_q"] == (
        "data", "model")
    assert zero1_shardings(shapes, mesh, ("data",))["embed"] == ("data",)
