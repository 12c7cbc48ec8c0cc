"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU fallback."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.launch import train as train_cli
from repro_torch.models import Model
from repro_torch.serving import ServeConfig, ServeEngine

SRC = Path(repro_torch.__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
"""


def test_every_module_imports_without_jax_or_repro():
    expected = len(list(pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")))
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout.split()
    assert out == [str(expected), "[]"]
    assert expected >= 90  # every module of the slices so far was walked: moe.py and
    # the ten configs of the attention-family slice, ssm.py and xlstm.py, the
    # training slice's optim, data, checkpoint, ft, training and launch.train,
    # the sharded substrate's sharding, zero, remat, pipeline, moe_ep and mesh,
    # the open-loop simulator's twelve core modules and its command line, and
    # the closed loop's cluster, lockstep, egpu, four scenarios and the
    # ordered scan, and the last slice's tiered solver, its two kernels and
    # the static analyzer
    assert {"repro_torch.models.ssm", "repro_torch.models.xlstm", "repro_torch.optim.adamw",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.store",
            "repro_torch.ft.resilience", "repro_torch.training.trainer",
            "repro_torch.launch.train", "repro_torch.distributed.sharding",
            "repro_torch.distributed.zero", "repro_torch.distributed.remat",
            "repro_torch.distributed.pipeline", "repro_torch.models.moe_ep",
            "repro_torch.launch.mesh", "repro_torch.core.config", "repro_torch.core.wtt",
            "repro_torch.core.monitor", "repro_torch.core.perturb",
            "repro_torch.core.scenario", "repro_torch.core.scenarios",
            "repro_torch.core.scenarios.gemv_allreduce", "repro_torch.core.workload",
            "repro_torch.core.target", "repro_torch.core.engine",
            "repro_torch.core.simulator", "repro_torch.core.trace_render",
            "repro_torch.launch.scenario", "repro_torch.core.cluster",
            "repro_torch.core.lockstep", "repro_torch.core.egpu",
            "repro_torch.core.cohort_timeline", "repro_torch.core.interconnect",
            "repro_torch.core.topology", "repro_torch.core.scenarios.ring_allreduce",
            "repro_torch.core.scenarios.all_to_all", "repro_torch.core.scenarios.pipeline_p2p",
            "repro_torch.core.scenarios.hierarchical_allreduce",
            "repro_torch.kernels.ordered_scan", "repro_torch.core.lockstep_tiered",
            "repro_torch.core.timeline", "repro_torch.kernels.port_chain",
            "repro_torch.kernels.numpy_sum", "repro_torch.analysis",
            "repro_torch.analysis.layout", "repro_torch.analysis.verify",
            "repro_torch.analysis.program_graph", "repro_torch.analysis.sanitize",
            "repro_torch.analysis.__main__"} <= {
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}


def test_entry_points_raise_without_a_card(monkeypatch):
    # decided here, at call time: the test holds on a machine with a card too
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("gemma3-1b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg, device="cuda")
    model = Model(cfg, device="cpu")
    assert model.device.type == "cpu"
    assert ServeEngine(model, ServeConfig()).model.embed.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--reduced", "--steps", "1"])
