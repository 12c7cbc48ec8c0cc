"""The tiny cells on the card: a run is correct there and a traced run reads
every per-layer metric from the device's trace.  Skips without a card; on
the card: ``python -m pytest -q portbench/tests -m cuda``."""

import pytest

from conftest import CONFIGS, tiny_cell_name
from portbench import cells, run


@pytest.mark.cuda
@pytest.mark.parametrize("config", CONFIGS)
def test_a_tiny_cell_runs_and_traces_on_the_card(tiny_root, cuda, config):
    cell = cells.load(tiny_root, tiny_cell_name(config))
    plain = run.run_cell(cell, 2**32 + 1, 0.5, False, cuda, 0.0)
    traced = run.run_cell(cell, 2**32 + 1, 0.5, True, cuda, 0.0)
    assert plain["correct"] and traced["correct"], (plain["checks"], traced["checks"])
    assert plain["device"]["platform"] == "gpu" and plain["device"]["memory_peak_bytes"] > 0
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    want = {p["name"] for p in cell.per_layer}
    assert want <= set(traced["metrics"]), sorted(traced["metrics"])
    for name in ("decode_attention_roofline", "rmsnorm_roofline", "mfu"):
        assert 0 < traced["metrics"][name]["value"] <= 100
