"""The port's tracer (``repro_torch.tracing``): off it records nothing and
reads no clock; on, spans nest with their parents and their batch, drain
onto the profiler's clock, and the serving path records one span of each
kind where the engine and the model do that work, with tokens unchanged."""

import time
from collections import Counter

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config, reduced
from repro_torch.models import Model
from repro_torch.serving import ServeConfig, ServeEngine

PROMPTS = [[5, 6, 7], [9, 10], [1, 2, 3, 4]]
NEW = 5


@pytest.fixture
def traced():
    """Tracing on for the test; off and drained after it, whatever happens."""
    tracing.drain()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


@pytest.fixture(scope="module")
def hybrid():
    """A reduced zamba2: Mamba2 blocks and the shared attention block."""
    cfg = reduced(get_config("zamba2-2.7b")).with_(param_dtype=torch.float32)
    return Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))


def test_off_span_is_the_shared_noop_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock with tracing off")

    tracing.drain()
    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    a, b = tracing.span("serve.batch", index=0), tracing.span("model.block", index=3)
    assert a is b is tracing.OFF
    with a as inside:
        assert inside is None
    monkeypatch.undo()
    assert tracing.drain() == []


def test_spans_nest_with_parents_and_share_their_batch(traced):
    with tracing.span("serve.batch", index=0) as outer:
        with tracing.span("serve.prefill_step", pos=0) as step:
            with tracing.span("model.block", index=1, kind="mamba", shared=False) as block:
                pass
        with tracing.span("serve.sample") as sample:
            pass
    with tracing.span("serve.batch", index=1) as other:
        pass
    spans = tracing.drain()
    assert [s.name for s in spans] == ["serve.batch", "serve.prefill_step", "model.block",
                                       "serve.sample", "serve.batch"]
    assert (outer.parent, step.parent, block.parent, sample.parent) == (0, outer.id, step.id,
                                                                        outer.id)
    assert {s.batch for s in (outer, step, block, sample)} == {outer.id}
    assert other.parent == 0 and other.batch == other.id != outer.id
    assert block.attrs == {"index": 1, "kind": "mamba", "shared": False}
    assert all(s.start <= s.end for s in spans)
    assert outer.start <= step.start <= block.start <= block.end <= step.end <= outer.end


def test_drain_empties_and_keeps_open_spans_for_later(traced):
    with tracing.span("serve.batch"):
        with tracing.span("serve.sample"):
            pass
        inner = tracing.drain()
        assert [s.name for s in inner] == ["serve.sample"]
        assert tracing.drain() == []
    assert [s.name for s in tracing.drain()] == ["serve.batch"]
    assert tracing.drain() == []


def test_drained_spans_lie_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    tracing.drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.enable()
        try:
            with tracing.span("serve.batch"):
                time.sleep(0.002)
                with record_function("inside"):
                    time.sleep(0.002)
                time.sleep(0.002)
        finally:
            tracing.disable()
    (sp,) = tracing.drain()
    marks = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside"]
    assert marks
    for e in marks:  # 2 ms of sleep on either side: the clocks agree within 1 ms
        assert e.start_ns() - sp.start >= 1_000_000, (sp, e.start_ns())
        assert sp.end - e.end_ns() >= 1_000_000, (sp, e.end_ns())


def _serve(model, on: bool):
    engine = ServeEngine(model, ServeConfig(max_batch=2))
    if not on:
        return engine.generate(PROMPTS, NEW), engine.stats, []
    tracing.enable()
    try:
        outs = engine.generate(PROMPTS, NEW)
    finally:
        tracing.disable()
    return outs, engine.stats, tracing.drain()


def test_serving_records_a_span_per_step_block_and_update(hybrid):
    tracing.drain()
    _, stats, spans = _serve(hybrid, on=True)
    kinds = [b.kind for b in hybrid.entries]
    mamba, entries = kinds.count("mamba"), len(kinds)
    batches = [PROMPTS[:2], PROMPTS[2:]]
    P = sum(max(len(p) for p in b) for b in batches)  # prompt steps, padding included
    D = NEW * len(batches)                               # decode steps
    n = Counter(s.name for s in spans)
    assert n["serve.batch"] == 2 and n["serve.gather"] == 2
    assert n["serve.prefill_step"] == P and n["serve.decode_step"] == D
    assert n["serve.sample"] == n["serve.readback"] == D
    assert n["model.embed"] == n["model.head"] == P + D
    assert n["mamba.update"] == mamba * (P + D) and n["model.block"] == entries * (P + D)
    assert stats["host_syncs"] == D + len(batches) and stats["decode_steps"] == D
    by_id = {s.id: s for s in spans}
    shared = [s for s in spans if s.name == "model.block" and s.attrs["shared"]]
    assert {s.attrs["kind"] for s in shared} == {"dense"}
    assert len(shared) == sum(hybrid.entry_shared) * (P + D)
    for s in spans:
        if s.name == "mamba.update":
            block = by_id[s.parent]
            assert block.name == "model.block" and block.attrs["kind"] == "mamba"
        if s.name in ("serve.prefill_step", "serve.decode_step", "serve.gather"):
            assert by_id[s.parent].name == "serve.batch"
    batch_ids = [s.id for s in spans if s.name == "serve.batch"]
    assert {s.batch for s in spans} == set(batch_ids)
    assert [s.attrs for s in spans if s.name == "serve.batch"] == [
        {"index": 0, "rows": 2, "prompt_len": 3}, {"index": 1, "rows": 1, "prompt_len": 4}]


def test_tokens_and_stats_are_equal_with_tracing_on_and_off(hybrid):
    tracing.drain()
    off, off_stats, none = _serve(hybrid, on=False)
    on, on_stats, spans = _serve(hybrid, on=True)
    assert none == [] and spans
    assert on == off and on_stats == off_stats
    assert off_stats == {"prefill_tokens": 10, "decode_steps": 10, "requests": 3,
                         "host_syncs": 12}
