"""Cells are resolved from files by name, ``BENCHMARK.json`` keeps to the
benchmark's contract, and a configuration, a traffic mix and a per-layer
metric are each added as new files alone: a throwaway cell made of new
files runs, and its new metric is read."""

import json
import re

import pytest
import torch

from conftest import ROOT, tiny_cell_name, write_tiny_root
from portbench import cells, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    names = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for e in BENCH["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for p in BENCH["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert p["moves"] in e2e and UNIT.match(p["unit"]) and NAME.match(p["name"])
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (ROOT / "portbench" / "metrics" / f"{p['name']}.py").is_file()
    assert any("mfu" in p["name"] for p in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_from_its_files(cell):
    c = cells.load(ROOT, cell)
    assert c.chips == 1 and c.traffic["batch"] >= 1
    assert c.config["reduced"] == [] and c.limits["malformed_outputs"]["limit"] == 0
    assert c.reference.params(c.model)
    assert {"gen_tokens_per_s", "itl_p95_ms", "setup_s"} <= set(c.end_to_end)
    for entry in c.per_layer:
        assert callable(c.reader(entry["name"]).read)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        cells.load(ROOT, "no-such.cell")


def test_a_new_config_mix_and_metric_are_new_files_alone(tmp_path):
    """A throwaway cell: a new configuration file, a new mix file, a new
    per-layer metric's reader and the cell's limits, added beside copies of
    the existing files with no edit to any of them, runs end to end."""
    root = write_tiny_root(tmp_path)
    pb = root / "portbench"
    config = json.loads((pb / "configs" / "tiny-olmoe-1b-7b.json").read_text())
    config["name"] = config["model"]["name"] = "throwaway"
    config["model"]["n_layers"] = 2
    (pb / "configs" / "throwaway.json").write_text(json.dumps(config))
    (pb / "traffic" / "few.json").write_text(json.dumps(
        {"loop": "closed_batches", "batch": 3, "prompt_len": [2, 5], "new_tokens": 4,
         "sampling": "greedy"}))
    (pb / "metrics" / "prompt_tokens.py").write_text(
        "def read(obs):\n    return float(sum(obs.prompt_lens))\n")
    (pb / "limits" / "throwaway.few.json").write_text(json.dumps(
        {"sample_requests": 2, "max_logit_gap": {"limit": 0.05},
         "malformed_outputs": {"limit": 0}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway", "source": "test", "reduced": [],
                             "file": "portbench/configs/throwaway.json", "why": "test"})
    bench["workloads"].append({"name": "throwaway.few", "config": "throwaway", "traffic": "few",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "prompt_tokens", "unit": "tokens", "better": "lower",
                               "source": "program_counter", "layer": "serving engine",
                               "moves": "gen_tokens_per_s", "workloads": ["throwaway.few"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load(root, "throwaway.few")
    assert cell.model["n_layers"] == 2 and cell.traffic["batch"] == 3
    plain = run.run_cell(cell, 9, 0.1, False, torch.device("cpu"), 0.0)
    traced = run.run_cell(cell, 9, 0.1, True, torch.device("cpu"), 0.0)
    assert plain["correct"] and traced["correct"] and plain["attempted"] == 3
    assert set(plain["metrics"]) == {"gen_tokens_per_s", "itl_p95_ms", "setup_s"}
    assert traced["metrics"]["prompt_tokens"]["value"] >= 6
    # the new metric is the new cell's alone: the other cells report what they did
    for other in ("olmoe-1b-7b", "zamba2-2.7b"):
        assert [p["name"] for p in cells.load(root, tiny_cell_name(other)).per_layer] == [
            p["name"] for p in BENCH["per_layer"]]
