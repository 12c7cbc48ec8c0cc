"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (``run.run_cell`` on the CPU) and the
rest of a run is driven, once for each fault a serving cell on one chip can
have.  (The exchange between chips has no place on one chip.)"""

import pytest
import torch

from conftest import CONFIGS, tiny_cell_name
from portbench import cells, run


def _frozen_state(monkeypatch):
    """A step that returns its state unchanged: it computes on a copy of the
    caches and hands the old ones back."""
    from repro_torch.models import Model

    inner = Model.decode_step

    def step(self, caches, tokens, pos, **kw):
        copy = type(caches)([{k: v.clone() for k, v in c.items()} for c in caches])
        logits, _ = inner(self, copy, tokens, pos, **kw)
        return logits, caches

    monkeypatch.setattr(Model, "decode_step", step)


def _half_batch(monkeypatch):
    """Half of the batch left out: its rows' logits are the mean of the rest's."""
    from repro_torch.models import Model

    inner = Model.decode_step

    def step(self, caches, tokens, pos, **kw):
        logits, caches = inner(self, caches, tokens, pos, **kw)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:] = logits[:half].mean(0)
        return logits, caches

    monkeypatch.setattr(Model, "decode_step", step)


def _altered_token(monkeypatch):
    """A token altered where it is produced: the third new token of every
    request is the next id after the one sampled."""
    from repro_torch.serving import ServeEngine

    inner, calls = ServeEngine._sample, []

    def sample(self, logits, gen):
        out = inner(self, logits, gen)
        calls.append(1)
        if len(calls) == 3:
            out = (out + 1) % logits.shape[-1]
        return out

    monkeypatch.setattr(ServeEngine, "_sample", sample)


def _bf16_state(monkeypatch):
    """The recurrent state held in bfloat16 between steps, where the
    configuration states float32: each step computes from it widened, and
    hands on its new state narrowed."""
    from repro_torch.models import Model

    inner = Model.decode_step

    def step(self, caches, tokens, pos, **kw):
        wide = type(caches)([{k: v.float() if k in ("h", "conv") else v for k, v in c.items()}
                             for c in caches])
        logits, out = inner(self, wide, tokens, pos, **kw)
        return logits, type(out)([{k: v.bfloat16() if k in ("h", "conv") else v
                                   for k, v in c.items()} for c in out])

    monkeypatch.setattr(Model, "decode_step", step)


def test_a_state_held_below_its_stated_dtype_is_not_correct(tiny_root, monkeypatch):
    """zamba2 states its Mamba2 state in float32; the same run with the state
    kept in bfloat16 comes out not correct, by ``state_dtype_mismatch``."""
    cell = cells.load(tiny_root, tiny_cell_name("zamba2-2.7b"))
    _bf16_state(monkeypatch)
    result = run.run_cell(cell, 2, 0.1, False, torch.device("cpu"), 0.0)
    assert result["correct"] is False
    assert result["checks"]["state_dtype_mismatch"]["value"] > 0, result["checks"]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fault", [None, _frozen_state, _half_batch, _altered_token],
                         ids=["sound", "state_unchanged", "half_batch", "altered_token"])
def test_a_fault_under_the_timed_path_is_not_correct(tiny_root, monkeypatch, config, fault):
    cell = cells.load(tiny_root, tiny_cell_name(config))
    if fault is not None:
        fault(monkeypatch)
    result = run.run_cell(cell, 2, 0.1, False, torch.device("cpu"), 0.0)
    assert result["correct"] is (fault is None), result["checks"]
    assert result["attempted"] == cell.traffic["batch"] and result["failed"] == 0
