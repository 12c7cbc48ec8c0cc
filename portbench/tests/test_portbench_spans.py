"""The join of the port's spans to a profiled batch (``portbench/spans.py``)
and the per-step numbers read from it, on made-up profiler events that carry
correlation ids; and ``host_syncs_per_step``, read from the engine's counter."""

import importlib.util
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT
from portbench import spans as spans_mod
from portbench import trace


def _evt(name, start, dur, corr=0, device="CUDA"):
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
                           device_type=lambda: f"DeviceType.{device}",
                           correlation_id=lambda: corr)


def _profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _span(name, id, parent, start, end, **attrs):
    """A drained span as ``repro_torch.tracing`` gives it."""
    return SimpleNamespace(name=name, id=id, parent=parent, batch=1, start=start, end=end,
                           attrs=attrs)


# one batch: a prompt step (a Mamba2 block with its update) and a decode
# step (a Mamba2 block with its update, then the shared block), each
# followed by the sampled token's read back
SPANS = [
    _span("serve.batch", 1, 0, 0, 10_000, index=0, rows=2, prompt_len=1),
    _span("serve.prefill_step", 2, 1, 100, 1_000, pos=0),
    _span("model.block", 3, 2, 150, 600, index=0, kind="mamba", shared=False),
    _span("mamba.update", 4, 3, 200, 400),
    _span("serve.readback", 5, 1, 1_100, 3_000),
    _span("serve.decode_step", 6, 1, 3_100, 4_100, pos=1),
    _span("model.block", 7, 6, 3_150, 3_600, index=0, kind="mamba", shared=False),
    _span("mamba.update", 8, 7, 3_200, 3_400),
    _span("model.block", 9, 6, 3_700, 4_000, index=1, kind="dense", shared=True),
    _span("serve.gather", 10, 1, 9_000, 9_900),
]
LAUNCHES = [  # (start, corr): each launch call lasts 10 ns
    (160, 1),    # model.block 3, outside its update
    (250, 2),    # mamba.update 4
    (700, 3),    # the prefill step itself
    (3_250, 4),  # mamba.update 8
    (3_300, 5),  # mamba.update 8
    (3_800, 6),  # the shared block 9
    (4_050, 7),  # the decode step itself
]
KERNELS = {1: 100, 2: 400, 3: 50, 4: 300, 5: 200, 6: 1_000, 7: 30}  # corr: device ns
COPIES = [(1_200, 1_900, 11), (9_100, 9_800, 12)]  # cudaMemcpyAsync (start, end, corr)


def _events(kernels=KERNELS, launches=LAUNCHES):
    events = [_evt("cudaLaunchKernel", t, 10, corr, "CPU") for t, corr in launches]
    events += [_evt("cudaMemcpyAsync", s, e - s, corr, "CPU") for s, e, corr in COPIES]
    t = 5_000
    for corr, dur in kernels.items():  # the device runs them later, back to back
        events.append(_evt(f"kernel_{corr}", t, dur, corr))
        t += dur
    events.append(_evt("Memcpy DtoH (Device -> Pageable)", 1_800, 50, 11))
    events.append(_evt("ProfilerStep#1", 0, 20_000, 0))
    return events


def _read(events, spans=SPANS):
    prof = _profile(events)
    tr, lk = trace._read(prof), spans_mod.links(prof)
    index = spans_mod.Spans(spans)
    return tr, lk, index, spans_mod.join(index, lk)


def test_each_kernel_goes_to_the_innermost_span_open_at_its_launch():
    _, lk, index, j = _read(_events())
    assert len(lk.kernels) == 7 and len(lk.launches) == 7  # the copy and the step are no kernels
    assert j.own == {3: 100, 4: 400, 2: 50, 8: 500, 9: 1_000, 6: 30}
    assert j.inclusive[1] == j.kernel_ns == j.joined_ns == 2_080
    assert j.inclusive[2] == 550 and j.inclusive[6] == 1_530 and j.inclusive[7] == 500
    assert (j.unlaunched, j.outside_ns) == (0, 0)
    assert index.at(3_250).id == 8 and index.at(3_500).id == 7 and index.at(3_650).id == 6
    assert index.at(5_000).id == 1 and index.at(10_001) is None and index.at(-1) is None


def test_the_per_step_numbers_are_the_hand_counted_ones():
    _, _, index, j = _read(_events())
    got = spans_mod.span_metrics(index, j)
    assert got == {"ssm_update_ms_per_step": pytest.approx(500 / 1e6),  # one decode step
                   "shared_block_ms_per_step": pytest.approx(1_000 / 1e6),
                   "prefill_share": pytest.approx(100 * 550 / 2_080),
                   "host_dispatch_ms_per_step": pytest.approx(1_000 / 1e6)}


def test_a_kernel_without_its_launch_call_leaves_the_device_numbers_unread():
    _, _, index, j = _read(_events(launches=LAUNCHES[:-1]))
    assert (j.unlaunched, j.unlaunched_ns) == (1, 30)
    got = spans_mod.span_metrics(index, j)
    assert got["ssm_update_ms_per_step"] is None and got["shared_block_ms_per_step"] is None
    assert got["prefill_share"] is None
    assert got["host_dispatch_ms_per_step"] == pytest.approx(1_000 / 1e6)  # the host's own


def test_no_spans_or_no_device_trace_reads_nothing():
    _, lk, _, _ = _read(_events())
    empty = spans_mod.Spans([])
    assert set(spans_mod.span_metrics(empty, spans_mod.join(empty, lk)).values()) == {None}
    index = spans_mod.Spans(SPANS)
    got = spans_mod.span_metrics(index, None)
    assert got["ssm_update_ms_per_step"] is None and got["prefill_share"] is None
    launched_outside = spans_mod.join(empty, lk)
    assert launched_outside.outside_ns == 2_080 and launched_outside.joined_ns == 0


def test_idle_gaps_are_named_by_the_span_and_unchanged_without_spans():
    tr, _, index, _ = _read(_events())
    plain = tr.idle_gaps()
    assert spans_mod.idle_gaps(tr, spans_mod.Spans([])) == plain
    named = spans_mod.idle_gaps(tr, index)
    assert [g[1] for g in named] == [g[1] for g in plain]
    assert plain[0][0].startswith("python after Memcpy DtoH")
    assert named[0][0] == "model.block" + plain[0][0][len("python"):]
    assert all(not g[0].startswith("python") for g in named)


def test_each_readback_holds_the_copy_of_its_read():
    tr, _, index, _ = _read(_events())
    assert spans_mod.readbacks_with_their_copy(tr, index) == (1, 1)
    late = [_span("serve.readback", 5, 1, 1_300, 3_000)]  # the copy began before it
    assert spans_mod.readbacks_with_their_copy(tr, spans_mod.Spans(late)) == (0, 1)


def test_the_report_sums_device_time_by_span_name():
    tr, lk, _, _ = _read(_events())
    out = spans_mod.report(tr, lk, SPANS)
    assert out["joined_share"] == 1.0 and out["decode_steps"] == 1
    assert out["readbacks_holding_their_copy"] == [1, 1]
    assert out["launches_per_mamba_update"] == [1, 2]
    assert out["launch_call_ms_per_decode_step"] == pytest.approx(4 * 10 / 1e6)
    assert out["launch_call_us_median_max"] == [10 / 1e3, 10 / 1e3]
    # one gap, from the read back's copy to the first kernel, while the host
    # was in the decode step's first block
    assert out["idle_s_by_span"] == {"decode: model.block[mamba]": pytest.approx(3_150e-9)}
    own = {k: v["device_s_own"] for k, v in out["by_span"].items()}
    assert own == pytest.approx({
        "decode: model.block[shared]": 1_000e-9, "decode: mamba.update": 500e-9,
        "prefill: mamba.update": 400e-9, "prefill: model.block[mamba]": 100e-9,
        "serve.prefill_step": 50e-9, "serve.decode_step": 30e-9,
        "decode: model.block[mamba]": 0, "serve.batch": 0, "serve.readback": 0,
        "serve.gather": 0})
    assert list(own)[0] == "decode: model.block[shared]"  # the most first


def test_profile_off_the_card_records_the_spans_alone():
    from repro_torch import tracing

    def run():
        with tracing.span("serve.batch"):
            return 7

    tr, lk, spans, out = spans_mod.profile(run, torch.device("cpu"))
    assert (tr, lk, out) == (None, None, 7)
    assert [s.name for s in spans] == ["serve.batch"]
    assert tracing.span("serve.batch") is tracing.OFF  # off again


def _host_syncs_reader():
    path = ROOT / "portbench" / "metrics" / "host_syncs_per_step.py"
    spec = importlib.util.spec_from_file_location("host_syncs_per_step", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("stats,want", [
    ({"prefill_tokens": 4, "decode_steps": 128, "requests": 2, "host_syncs": 129}, 129 / 128),
    ({"prefill_tokens": 4, "decode_steps": 128, "requests": 2}, None),  # an engine without it
    ({"prefill_tokens": 4, "decode_steps": 0, "requests": 2, "host_syncs": 1}, None),
])
def test_host_syncs_per_step_reads_the_engines_counter(stats, want):
    obs = SimpleNamespace(stats=stats)
    got = _host_syncs_reader().read(obs)
    assert got == (None if want is None else pytest.approx(want))
