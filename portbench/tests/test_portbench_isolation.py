"""The benchmark runs the port alone, and its reference stands apart from
the port: checked by top-level module names, compared whole, in fresh
processes; and the result's last line carries the keys the contract asks
for, with the numbers compared last."""

import json
import os
import subprocess
import sys

import torch

from conftest import CONFIGS, ROOT, tiny_cell_name
from portbench import cells, run

_LOADED = """
import importlib, json, pkgutil, sys
sys.path[:0] = [{root!r}, {src!r}]
for name in {modules!r}:
    importlib.import_module(name)
if {walk!r}:
    import portbench
    for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
        if ".tests" not in m.name:
            importlib.import_module(m.name)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level(modules, walk=False):
    code = _LOADED.format(root=str(ROOT), src=str(ROOT / "src"), modules=list(modules), walk=walk)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True, capture_output=True,
                         text=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    names = _top_level(["repro_torch.models", "repro_torch.serving"], walk=True)
    assert "repro_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level([f"portbench.reference.{c['reference']}" for c in
                        (cells.load(ROOT, w).config for w in
                         (x["name"] for x in json.loads((ROOT / "BENCHMARK.json").read_text())
                          ["workloads"]))])
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["repro_torch", "repro_torch.models", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.core", "jaxlib.xla_client", "flax"]) == [
        "flax", "jaxlib", "repro"]


def test_without_a_card_the_command_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", str(2**31 + 7), "--seconds", "10", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr, out.stderr[-2000:]


def test_the_result_line_has_the_contracts_keys(tiny_root):
    cell = cells.load(tiny_root, tiny_cell_name(CONFIGS[1]))
    for trace in (False, True):
        result = run.run_cell(cell, 2**31 + 3, 0.1, trace, torch.device("cpu"), 0.0)
        assert list(result)[:3] == ["correct", "attempted", "failed"]
        assert list(result)[-1] == "checks" and {"metrics", "device"} <= set(result)
        assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        for check in result["checks"].values():
            assert {"value", "limit"} <= set(check)
        for metric in result["metrics"].values():
            assert set(metric) == {"value", "unit"}
        json.loads(json.dumps(result))
