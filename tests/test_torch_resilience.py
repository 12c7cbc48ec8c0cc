"""The port's fault-tolerance substrate (``ft/resilience.py``) and the
trainer's checkpoints under a mesh, against the reference's.

The reference runs once, in a subprocess with 8 forced host devices: the
data-axis sizes of ``ElasticMeshManager`` under the failures of
``tests/test_integration.py::test_elastic_mesh_shrinks_on_failure`` (8
devices, model-parallel 2), ``HeartbeatMonitor`` on an injected clock,
``StragglerMonitor``'s reports, and ``remesh_pytree`` of a tree onto a
1-device mesh.  The port's answers must be the same.

One world of 4 gloo ranks at (2, 2) then re-places the reduced gemma3-1b's
bf16 parameter shards onto (1, 2) with ``remesh_pytree``: ranks 0 and 1 get
their new shards bit for bit, ranks 2 and 3 nothing.  In the same world the
``Trainer`` runs 6 steps with checkpoints every 2 and a failure before step
4: it restarts from step 2, and the checkpoint of step 6, gathered to whole
tensors, holds the ranks' parameters and optimizer state bit for bit; a
one-device ``Trainer`` restores it (the store's format does not change with
the mesh).  A second world runs ``launch/train.py --mesh 2x2``.  This file
imports no JAX: the spawned ranks import it.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.distributed import run_world
from repro_torch.distributed.sharding import (gather_params, gather_tensor, param_shardings,
                                              shard_tensor)
from repro_torch.ft import (ElasticMeshManager, HeartbeatMonitor, SimulatedFailure,
                            StragglerMonitor, remesh_pytree)
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.models.model import param_specs
from repro_torch.optim import AdamWConfig
from repro_torch.training import TrainConfig, Trainer

SRC = Path(__file__).resolve().parents[1] / "src"
N_STEPS = 6

_REFERENCE = """
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ft import ElasticMeshManager, HeartbeatMonitor, SimulatedFailure, StragglerMonitor
from repro.ft import remesh_pytree

out = {}
mgr = ElasticMeshManager(list(range(8)), model_parallel=2)
sizes = [mgr.current_mesh().shape["data"]]
for fail in ([3], [0, 1, 2, 4, 5], [6]):
    mgr.fail_devices(fail)
    try:
        sizes.append(mgr.current_mesh().shape["data"])
    except SimulatedFailure:
        sizes.append("raise")
out["elastic"] = sizes
t = [0.0]
mon = HeartbeatMonitor([0, 1, 2], timeout_s=5.0, clock=lambda: t[0])
t[0] = 4.0
mon.beat(0)
mon.beat(1)
t[0] = 7.0
out["dead"], out["alive"] = mon.dead_hosts(), mon.alive_hosts()
t[0] = 12.5
mon.beat(2)
out["dead_later"], out["alive_later"] = mon.dead_hosts(), mon.alive_hosts()
smon = StragglerMonitor(threshold=1.5, window=4)
reports = []
for i in range(6):
    r = smon.record_step({0: 1.0, 1: 1.02 + 0.01 * i, 2: 0.98, 3: 2.5 if i < 4 else 1.0})
    reports.append((r.step, r.stragglers, r.median_s, r.worst_ratio))
out["stragglers"] = reports
tree = {"w": jnp.arange(16.0).reshape(4, 4)}
mesh1 = jax.make_mesh((1,), ("data",))
moved = remesh_pytree(tree, lambda m: {"w": NamedSharding(m, P())}, mesh1)
out["remesh"] = np.asarray(moved["w"])
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("resilience") / "reference.pkl"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def test_elastic_mesh_shrinks_as_the_reference(reference):
    mgr = ElasticMeshManager(list(range(8)), model_parallel=2)
    sizes = [mgr.current_mesh().shape["data"]]
    for fail in ([3], [0, 1, 2, 4, 5], [6]):
        mgr.fail_devices(fail)
        try:
            sizes.append(mgr.current_mesh().shape["data"])
        except SimulatedFailure:
            sizes.append("raise")
    assert sizes == reference["elastic"] == [4, 3, 1, "raise"]
    mgr = ElasticMeshManager(list(range(8)), model_parallel=2)
    mgr.fail_devices([3])
    mesh = mgr.current_mesh()
    # the replica of rank 3 is gone; the others keep their model groups
    assert mesh.devices.tolist() == [[0, 1], [2, 4], [5, 6]]
    assert mesh.coords(4) == {"data": 1, "model": 1} and mesh.coords(3) is None
    assert mgr.dp_size() == 3


def test_heartbeat_monitor_as_the_reference(reference):
    t = [0.0]
    mon = HeartbeatMonitor([0, 1, 2], timeout_s=5.0, clock=lambda: t[0])
    t[0] = 4.0
    mon.beat(0)
    mon.beat(1)
    t[0] = 7.0
    assert (mon.dead_hosts(), mon.alive_hosts()) == (reference["dead"], reference["alive"])
    t[0] = 12.5
    mon.beat(2)  # a dead host stays dead
    assert (mon.dead_hosts(), mon.alive_hosts()) == (reference["dead_later"],
                                                     reference["alive_later"])
    assert reference["dead_later"] == [0, 1, 2]


def test_straggler_reports_as_the_reference(reference):
    mon = StragglerMonitor(threshold=1.5, window=4)
    for i, want in enumerate(reference["stragglers"]):
        r = mon.record_step({0: 1.0, 1: 1.02 + 0.01 * i, 2: 0.98, 3: 2.5 if i < 4 else 1.0})
        assert (r.step, r.stragglers) == (want[0], want[1])
        np.testing.assert_allclose((r.median_s, r.worst_ratio), want[2:], rtol=1e-12)


def _cfg():
    return reduced(get_config("gemma3-1b"))


def _bits(t: torch.Tensor) -> np.ndarray:
    """A copy of the tensor's bits as numpy (bf16 as int16 words)."""
    t = t.detach().clone()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _shardings(mesh):
    return param_shardings(param_specs(_cfg()), mesh)[0]


def _rank_job(rank: int, world: int, ckpt_dir: str) -> dict:
    torch.set_num_threads(1)
    old = Mesh({"data": 2, "model": 2})
    mesh = old.bind()
    new = Mesh({"data": 1, "model": 2})
    model = Model(_cfg(), device="cpu")
    fails = {3}

    def inject(step):
        if step in fails:
            fails.discard(step)
            raise SimulatedFailure(f"injected before step {step + 1}")

    tcfg = TrainConfig(microbatches=2, optim=AdamWConfig(lr=1e-2, warmup_steps=2,
                                                         total_steps=N_STEPS))
    trainer = Trainer(model, tcfg, mesh=mesh, ckpt_dir=ckpt_dir, ckpt_every=2,
                      failure_injector=inject)
    trainer.init_state(torch.Generator().manual_seed(0))
    out = {"remesh_from": {k: _bits(v) for k, v in gather_params(model).items()}}
    moved = remesh_pytree({k: p.detach() for k, p in model.named_parameters()}, _shardings,
                          new, old_mesh=mesh)
    out["remesh"] = None if moved is None else {k: _bits(v) for k, v in moved.items()}
    out["new_coord"] = new.coords(rank)
    data = iter(SyntheticLMDataset(DataConfig(vocab=_cfg().vocab, seq_len=16, global_batch=4)))
    out["history"] = trainer.run(data, N_STEPS, log_every=0)
    out["params"] = {k: _bits(v) for k, v in gather_params(model).items()}
    zspecs = trainer.shardings["state"]
    out["state"] = {key: {k: gather_tensor(t, zspecs[k], mesh).numpy()
                          for k, t in trainer.opt_state[key].items()}
                    for key in ("mu", "nu", "master")}
    out["step"] = int(trainer.opt_state["step"])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("mesh_ckpt")
    return str(ckpt), run_world(_rank_job, 4, str(ckpt), timeout=240)


def test_remesh_keeps_values_bit_for_bit(ranks, reference):
    np.testing.assert_array_equal(reference["remesh"], np.arange(16.0).reshape(4, 4))
    _, outs = ranks
    new = Mesh({"data": 1, "model": 2})
    specs = _shardings(new)
    for rank, out in enumerate(outs):
        if rank >= 2:
            assert out["remesh"] is None and out["new_coord"] is None
            continue
        for k, whole in out["remesh_from"].items():
            want = shard_tensor(torch.from_numpy(whole), specs[k], new, out["new_coord"])
            np.testing.assert_array_equal(out["remesh"][k], want.numpy(), err_msg=k)
        assert out["remesh"]["embed"].shape == (128, 64)


def test_mesh_trainer_restarts_from_its_checkpoint(ranks):
    _, outs = ranks
    for out in outs:
        assert [h["step"] for h in out["history"]] == [1, 2, 3, 3, 4, 5, 6]
        assert [(h["loss"], h["grad_norm"]) for h in out["history"]] == [
            (h["loss"], h["grad_norm"]) for h in outs[0]["history"]]
        assert out["step"] == N_STEPS


def test_mesh_checkpoint_holds_whole_tensors_for_one_device(ranks):
    ckpt, outs = ranks
    model = Model(_cfg(), device="cpu")
    tr = Trainer(model, TrainConfig(optim=AdamWConfig(total_steps=N_STEPS)), ckpt_dir=ckpt)
    assert tr.maybe_restore() and tr.step == N_STEPS and tr.ckpt.steps() == [4, 6]
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(_bits(p), outs[0]["params"][k], err_msg=k)
        for key in ("mu", "nu", "master"):
            np.testing.assert_array_equal(tr.opt_state[key][k].numpy(), outs[0]["state"][key][k])


def test_train_cli_on_a_mesh_learns_as_one_device():
    args = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu", "--steps", "12", "--batch",
            "4", "--seq", "16", "--microbatches", "2", "--lr", "1e-2", "--log-every", "0"]
    single = train_cli.main(args)
    sharded = train_cli.main(args + ["--mesh", "2x2"])
    assert [h["step"] for h in sharded] == list(range(1, 13))
    np.testing.assert_allclose([h["loss"] for h in sharded], [h["loss"] for h in single],
                               atol=0.05)
    assert sharded[-1]["loss"] < sharded[0]["loss"]
