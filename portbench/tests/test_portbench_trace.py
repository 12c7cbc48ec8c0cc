"""The trace reading that the device-based per-layer metrics rest on, on
made-up profiler events: what counts as a kernel, a copy or a launch, the
busy union, the idle gaps and what they are named by."""

from types import SimpleNamespace

import pytest

from portbench import trace


def _evt(name, start, dur, device="CUDA"):
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
                           device_type=lambda: f"DeviceType.{device}")


def _profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


EVENTS = [
    _evt("Memcpy HtoD (Pageable -> Device)", 0, 10),
    _evt("void rmsnorm_kernel<bf16, 2>", 100, 50),
    _evt("void decode_attention_kernel<bf16, 1>", 120, 80),   # overlaps the first
    _evt("ProfilerStep#1", 0, 10_000),                        # the profiler's own
    _evt("gemm", 1_000, 100),
    _evt("Memcpy DtoH (Device -> Pageable)", 1_200, 20),
    _evt("cudaLaunchKernel", 90, 5, "CPU"),
    _evt("cudaLaunchKernel", 110, 5, "CPU"),
    _evt("cuLaunchKernelEx", 900, 5, "CPU"),
    _evt("cudaStreamSynchronize", 1_110, 100, "CPU"),
]


def test_read_tells_kernels_copies_and_launches_apart():
    tr = trace._read(_profile(EVENTS))
    assert [k[0] for k in tr.kernels] == ["void rmsnorm_kernel<bf16, 2>",
                                          "void decode_attention_kernel<bf16, 1>", "gemm"]
    assert len(tr.other_device) == 2 and tr.launches == 3 and tr.complete
    assert tr.window == (0, 1_220) and tr.window_s == pytest.approx(1.22e-6)
    assert tr.calls == [("cudaStreamSynchronize", 1_110, 1_210)]


def test_busy_is_the_union_and_gaps_are_named_by_the_host():
    tr = trace._read(_profile(EVENTS))
    assert tr.busy_segments() == [(0, 10), (100, 200), (1_000, 1_100), (1_200, 1_220)]
    assert tr.busy_s == pytest.approx(230e-9)
    gaps = tr.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([800e-9, 100e-9, 90e-9])
    assert gaps[0][0] == "python after void decode_attention_kernel<bf16, 1>"
    assert gaps[1][0] == "cudaStreamSynchronize after gemm"
    assert tr.kernel_seconds(lambda n: "kernel" in n) == (pytest.approx(130e-9), 2)
    assert tr.top_kernels(1) == [["gemm", pytest.approx(100e-9)]]


def test_a_lost_kernel_record_makes_the_trace_incomplete():
    tr = trace._read(_profile(EVENTS + [_evt("cudaLaunchKernel", 950, 5, "CPU")]))
    assert not tr.complete


def test_a_profile_with_no_device_event_is_refused():
    with pytest.raises(RuntimeError, match="no device event"):
        trace._read(_profile([_evt("cudaLaunchKernel", 0, 1, "CPU")]))
