"""A cell, resolved by its name from ``BENCHMARK.json`` and the files beside it.

Nothing here knows a cell, a configuration, a mix or a metric by name: each
lives in a file that is found from the names in ``BENCHMARK.json``.

- ``BENCHMARK.json`` ``workloads[i]``: the cell (``config``, ``traffic``,
  ``chips``); ``configs[j].file``: the configuration's file.
- ``<bench>/traffic/<traffic>.json``: the mix (``traffic.py``).
- ``<bench>/limits/<cell>.json``: the limits of the comparison that decides
  ``correct`` (``oracle.py``), with the readings they were set from.
- ``<bench>/metrics/<metric>.py``: one reader a per-layer metric, a function
  ``read(observed) -> float | None`` (``Observed`` below).
- ``<bench>/reference/<config's "reference">.py``: the plain model.

``<bench>`` is ``portbench/`` under the root that holds ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

from . import traffic as traffic_mod

BENCH = "portbench"


@dataclass
class Cell:
    name: str
    root: Path
    config: dict          # the configuration's file
    traffic: dict         # the mix's file
    limits: dict          # the limits' file
    chips: int
    end_to_end: List[str]
    per_layer: List[dict]  # the entries of BENCHMARK.json this cell reports

    @property
    def model(self) -> dict:
        """The sizes the program is built with (the file's ``model``)."""
        return self.config["model"]

    @property
    def reference(self) -> ModuleType:
        return importlib.import_module(f"{BENCH}.reference.{self.config['reference']}")

    def reader(self, metric: str) -> ModuleType:
        """The per-layer metric's reader, loaded from its file."""
        path = self.root / BENCH / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"{BENCH}_metric_{metric}", path)
        if spec is None or not path.is_file():
            raise FileNotFoundError(f"no reader for per-layer metric {metric!r} at {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path, name: str) -> Cell:
    """Cell ``name`` of ``root/BENCHMARK.json``, its files read and checked."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    mix = traffic_mod.validate(_json(root / BENCH / "traffic" / f"{w['traffic']}.json"))
    limits = _json(root / BENCH / "limits" / f"{name}.json")

    def mine(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return Cell(name=name, root=root, config=config, traffic=mix, limits=limits,
                chips=w["chips"], end_to_end=[e["name"] for e in bench["end_to_end"] if mine(e)],
                per_layer=[p for p in bench["per_layer"] if mine(p)])


@dataclass
class Observed:
    """What a per-layer reader reads: the traced batch and the cell.

    ``prompt_lens`` are the batch's real prompt lengths, ``steps`` the
    engine's steps for it (prompt steps and decode steps), ``stats`` the
    engine's counters for it, ``trace`` the :class:`trace.Trace` (None where
    the run had no device to trace), ``kind`` the card's name."""

    model: dict
    traffic: dict
    kind: str
    prompt_lens: List[int]
    steps: int
    stats: Dict[str, int]
    trace: Optional[object] = None

    @property
    def batch(self) -> int:
        return len(self.prompt_lens)

    @property
    def device_trace(self):
        """The trace where it holds device events, else None."""
        return self.trace if self.trace is not None and self.trace.kernels else None
