"""Shared pieces of the benchmark's tests: a throwaway benchmark root whose
cells are the real configurations cut to a CPU-sized width and depth, and
the ``cuda`` fixture that decides at run time whether a card is there."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _path in (ROOT, ROOT / "src"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

CONFIGS = ("olmoe-1b-7b", "zamba2-2.7b")
TINY = {"n_layers": 4, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
        "d_ff": 128, "vocab": 256}
TINY_FAMILY = {"moe": {"n_experts": 8, "experts_per_token": 4},
               "hybrid": {"attn_block_every": 2, "ssm_state": 16}}
TINY_MIX = {"loop": "closed_batches", "batch": 8, "prompt_len": [3, 10], "new_tokens": 12,
            "sampling": "greedy"}
# the number each tiny cell compares and its limit, from CPU readings at this
# size: olmoe's logit_err, the bfloat16 program at most 0.0273 over seeds
# 1-12, the float8 control at least 0.165 over seeds 1-4 (top-4 of 8
# experts: with top-2, a router tie that bfloat16 breaks the other way moves
# a token by half an expert; its logit_err_max, 0.012-0.218 against the
# control's 0.240-0.366, separates nothing); zamba2's logit_err_max, the
# program 0.0271-0.0416 over seeds 1-12, the control 0.394-0.464 over 1-4.
TINY_LIMITS = {"olmoe-1b-7b": ("logit_err", 0.06), "zamba2-2.7b": ("logit_err_max", 0.15)}


def tiny_cell_name(config: str) -> str:
    return f"tiny-{config}.tiny"


def write_tiny_root(root: Path) -> Path:
    """A benchmark root in ``root``: ``BENCHMARK.json`` with one tiny cell a
    configuration, its files, and a copy of the real metric readers."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "portbench" / "metrics", pb / "metrics")
    (pb / "traffic" / "tiny.json").write_text(json.dumps(TINY_MIX))
    configs, cells = [], []
    for name in CONFIGS:
        cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
        cfg["model"].update(TINY, **TINY_FAMILY[cfg["model"]["family"]])
        cfg["name"] = f"tiny-{name}"
        path = pb / "configs" / f"tiny-{name}.json"
        path.write_text(json.dumps(cfg))
        configs.append({"name": cfg["name"], "source": "test", "reduced": sorted(TINY),
                        "file": str(path.relative_to(root)), "why": "CPU test"})
        cells.append({"name": tiny_cell_name(name), "config": cfg["name"], "traffic": "tiny",
                      "chips": 1, "why": "CPU test"})
        number, limit = TINY_LIMITS[name]
        limits = {"sample_requests": 4, number: {"limit": limit},
                  "served_not_greedy": {"limit": 0}, "malformed_outputs": {"limit": 0}}
        if "state_dtype" in cfg:
            limits["state_dtype_mismatch"] = {"limit": 0}
        (pb / "limits" / f"{tiny_cell_name(name)}.json").write_text(json.dumps(limits))
    bench["configs"], bench["workloads"] = configs, cells
    for metric in bench["per_layer"]:
        metric.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return write_tiny_root(tmp_path)


@pytest.fixture
def cuda():
    """The card, decided here at run time; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
