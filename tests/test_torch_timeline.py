"""The port's two scans against the reference's closed forms, exactly.

``replay_lane`` is held against ``replay_lane_numpy`` (the int64 ground
truth) and ``replay_lane_jax`` on tests/test_timeline.py's seeded draws, and
against the counters of a real closed-loop run; ``spin_reads`` against
``spin_reads_jax`` and the numpy closed form of the vector engine's SPIN
branch.  Every comparison is exact: the arithmetic is integer on both sides
(the JAX scans' int32 / float32 are exact at these sizes, except the one
float32 rounding of ``spin_reads_jax`` that a test below pins down).
"""

import numpy as np
import pytest
import torch

from repro.core import Cluster, SimConfig
from repro.core.cohort_timeline import lane_step_arrays, replay_lane_jax, replay_lane_numpy
from repro.core.scenarios.ring_allreduce import RingAllReduceScenario
from repro.core.vector_engine import spin_reads_jax
from repro_torch.core import replay_lane, spin_reads


def _lane_draw(rng):
    """One random lane, drawn as tests/test_timeline.py:550-558 draws it."""
    n_steps = rng.integers(1, 30)
    n_cohorts = rng.integers(1, 12)
    is_wait = rng.random(n_steps) < 0.5
    val = np.where(
        is_wait,
        rng.integers(0, 5000, n_steps),
        rng.integers(1, 400, n_steps),
    ).astype(np.int64)
    dispatch = rng.integers(0, 300, n_cohorts).astype(np.int64)
    return dispatch, is_wait, val


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_replay_lane_matches_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        dispatch, is_wait, val = _lane_draw(rng)
        r_np, t_np = replay_lane_numpy(dispatch, is_wait, val, poll=64, check=4)
        r_jx, t_jx = replay_lane_jax(dispatch, is_wait, val, poll=64, check=4)
        r_pt, t_pt = replay_lane(dispatch, is_wait, val, poll=64, check=4, device="cpu")
        assert r_pt.dtype == t_pt.dtype == torch.int64
        np.testing.assert_array_equal(r_pt.numpy(), r_np)
        np.testing.assert_array_equal(t_pt.numpy(), t_np)
        np.testing.assert_array_equal(r_pt.numpy(), np.asarray(r_jx, np.int64))
        np.testing.assert_array_equal(t_pt.numpy(), np.asarray(t_jx, np.int64))


def test_replay_lane_reproduces_a_closed_loop_run():
    cfg = SimConfig(workgroups=12, n_cus=4)
    sc = RingAllReduceScenario(cfg)
    sc.closed_loop = True
    cl = Cluster(cfg, sc, timeline=True)
    cl.run()
    for node in cl.nodes:
        tgt = node.target
        dispatch = np.array([c.program.dispatch_cycle for c in tgt.cohorts], np.int64)
        counts = np.array([c.count for c in tgt.cohorts], np.int64)
        is_wait, val = lane_step_arrays(tgt.cohorts[0].phases, tgt.flag_set_cycle)
        reads, end = replay_lane(dispatch, is_wait, val, poll=cfg.poll_interval_cycles,
                                 check=cfg.flag_check_cycles, device="cpu")
        assert int((reads.numpy() * counts).sum()) == node.memory.traffic.flag_reads
        assert int(end.max()) == tgt.kernel_end_cycle


def test_replay_lane_keeps_cycles_beyond_int32():
    """The port is int64 by design; the JAX scan's int32 would wrap here."""
    dispatch = np.array([0, 2 ** 31 - 10, 5 * 2 ** 31], np.int64)
    is_wait = np.array([False, True, False, True])
    val = np.array([2 ** 31, 6 * 2 ** 31, 7, 3 * 2 ** 33], np.int64)
    r_np, t_np = replay_lane_numpy(dispatch, is_wait, val, poll=64, check=4)
    r_pt, t_pt = replay_lane(dispatch, is_wait, val, poll=64, check=4, device="cpu")
    np.testing.assert_array_equal(r_pt.numpy(), r_np)
    np.testing.assert_array_equal(t_pt.numpy(), t_np)
    assert t_np.max() > 2 ** 34


def _spin_reads_numpy(wait_start, flag_T, poll, check):
    """The SPIN branch of repro/core/vector_engine.py:129-135, over flags in order."""
    c = np.array(wait_start, np.int64, copy=True)
    flag_reads = np.zeros_like(c)
    for T in flag_T:
        already = T <= c
        nticks = np.where(already, 0, np.ceil(np.maximum(T - c, 0) / poll).astype(np.int64))
        flag_reads += np.where(already, 1, nticks + 1)
        c = np.where(already, c + check, c + nticks * poll + check)
    return flag_reads, c


def _spin_draws(seed, polls):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        nwg, npeers = rng.integers(1, 64), rng.integers(1, 9)
        wait_start = rng.integers(0, 20000, nwg).astype(np.int64)
        flag_T = rng.integers(0, 40000, npeers).astype(np.int64)
        yield wait_start, flag_T, int(rng.choice(polls)), int(rng.integers(0, 20))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spin_reads_matches_jax_and_numpy(seed):
    """Poll intervals of powers of two: there the JAX scan's float32
    ``(T - c) / poll`` is exact, and all three agree exactly."""
    for wait_start, flag_T, poll, check in _spin_draws(seed, [1, 2, 4, 16, 64, 128]):
        r_np, c_np = _spin_reads_numpy(wait_start, flag_T, poll, check)
        r_jx, c_jx = spin_reads_jax(wait_start.astype(np.float32),
                                    flag_T.astype(np.float32), poll, check)
        r_pt, c_pt = spin_reads(wait_start, flag_T, poll, check, device="cpu")
        assert r_pt.dtype == c_pt.dtype == torch.int64
        np.testing.assert_array_equal(r_pt.numpy(), r_np)
        np.testing.assert_array_equal(c_pt.numpy(), c_np)
        np.testing.assert_array_equal(r_pt.numpy(), np.asarray(r_jx, np.int64))
        np.testing.assert_array_equal(c_pt.numpy(), np.asarray(c_jx, np.int64))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_spin_reads_matches_numpy_at_any_poll(seed):
    for wait_start, flag_T, poll, check in _spin_draws(seed, range(1, 200)):
        r_np, c_np = _spin_reads_numpy(wait_start, flag_T, poll, check)
        r_pt, c_pt = spin_reads(wait_start, flag_T, poll, check, device="cpu")
        np.testing.assert_array_equal(r_pt.numpy(), r_np)
        np.testing.assert_array_equal(c_pt.numpy(), c_np)


def test_spin_reads_jax_overcounts_an_exact_multiple_of_poll():
    """A reference observation, not a port fault: under ``lax.scan`` XLA turns
    ``/ 52`` into a multiply by float32(1/52), so ``ceil(52 k / 52)`` can give
    k + 1: one read and 52 cycles too many.  The integer closed form is exact."""
    wait_start, flag_T = np.array([0], np.int64), np.array([52 * 7], np.int64)
    r_np, c_np = _spin_reads_numpy(wait_start, flag_T, 52, 4)
    r_pt, c_pt = spin_reads(wait_start, flag_T, 52, 4, device="cpu")
    r_jx, c_jx = spin_reads_jax(wait_start.astype(np.float32), flag_T.astype(np.float32), 52, 4)
    assert (r_pt.tolist(), c_pt.tolist()) == (r_np.tolist(), c_np.tolist()) == ([8], [368])
    assert (np.asarray(r_jx).tolist(), np.asarray(c_jx).tolist()) == ([9], [420.0])


def test_scans_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay_lane([0], [True], [10], poll=4, check=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spin_reads([0], [10], 4, 1)
