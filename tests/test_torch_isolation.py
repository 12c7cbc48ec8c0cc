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
    assert expected >= 41  # every module of the slices so far was walked: moe.py and
    # the ten configs of the attention-family slice, ssm.py and xlstm.py among them
    assert {"repro_torch.models.ssm", "repro_torch.models.xlstm"} <= {
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
