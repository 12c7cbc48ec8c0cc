"""The port's plain gemv and gemv_tiles against the reference's Pallas kernels.

Inputs come from a seeded numpy Generator and go through
``repro.kernels.ops`` (Pallas in interpret mode, as tests/test_kernels.py
runs it) and through the port's CPU path, with the reference's sweeps and
tolerances: 3e-5 in float32, 3e-2 in bf16.  ``owner_served`` must equal the
Pallas kernel's progress output exactly.  The CUDA kernels are held against
these plain versions on the card, in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.gemv_tiles import remote_first_order as jax_remote_first_order
from repro_torch.kernels import ops, ref
from repro_torch.kernels.gemv import gemv_cuda
from repro_torch.kernels.gemv_tiles import gemv_tiles_cuda, remote_first_order

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SWEEP = [(128, 512, 1), (256, 1024, 1), (256, 2048, 4), (64, 256, 8)]  # test_kernels.py:19
SCHEDULES = [(4, 0), (4, 1), (4, 3), (8, 5)]                           # test_kernels.py:32


def _tol(dtype_name):
    return dict(rtol=3e-2, atol=3e-2) if dtype_name == "bfloat16" else dict(
        rtol=3e-5, atol=3e-5
    )


def _inputs(M, K, N, dtype_name, seed=0):
    """The same a [M, K], x [K, N] as JAX arrays and torch tensors of one dtype."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K), np.float32)
    x = rng.standard_normal((K, N), np.float32)
    jd, td = DTYPES[dtype_name]
    return (jnp.asarray(a).astype(jd), jnp.asarray(x).astype(jd),
            torch.from_numpy(a).to(td), torch.from_numpy(x).to(td))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("M,K,N", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["row_major", "w.T"])
def test_gemv_ref_matches_pallas(M, K, N, dtype, layout):
    ja, jx, ta, tx = _inputs(M, K, N, dtype)
    if layout == "w.T":  # the collectives' layout: a view of w[K, M], never a copy
        w = ta.T.contiguous()
        ta = w.T
        assert ta.stride() == (1, M) and ta.data_ptr() == w.data_ptr()
    y_pallas = jops.gemv(ja, jx, bm=64, bk=256)
    y_port = ops.gemv(ta, tx)
    assert y_port.dtype == DTYPES[dtype][1] and y_port.shape == (M, N)
    np.testing.assert_allclose(_np(y_port), _np(y_pallas), **_tol(dtype))
    # the plain version's sums do not depend on A's layout
    assert torch.equal(y_port, ref.gemv_ref(ta.contiguous(), tx))


@pytest.mark.parametrize("n_dev,my_dev", SCHEDULES)
def test_gemv_tiles_values_and_schedule_match_pallas(n_dev, my_dev):
    ja, jx, ta, tx = _inputs(256, 1024, 1, "float32", seed=2)
    y_pallas, prog = jops.gemv_tiles(ja, jx, n_dev=n_dev, my_dev=my_dev, bm=32, bk=256)
    y_port, owner_served = ops.gemv_tiles(ta, tx, n_dev=n_dev, my_dev=my_dev, bm=32)
    np.testing.assert_allclose(_np(y_port), _np(y_pallas), rtol=3e-5, atol=3e-5)
    assert owner_served.dtype == torch.int32
    assert owner_served.tolist() == np.asarray(prog).tolist()
    assert owner_served[-1] == my_dev  # local tiles computed last


@pytest.mark.parametrize("n_dev,my_dev", SCHEDULES)
def test_gemv_tiles_of_a_transposed_weight(n_dev, my_dev):
    ja, jx, ta, tx = _inputs(256, 1024, 4, "bfloat16", seed=3)
    y_pallas, prog = jops.gemv_tiles(ja, jx, n_dev=n_dev, my_dev=my_dev, bm=32, bk=256)
    y_port, owner_served = ops.gemv_tiles(ta.T.contiguous().T, tx, n_dev=n_dev,
                                          my_dev=my_dev, bm=32)
    np.testing.assert_allclose(_np(y_port), _np(y_pallas), **_tol("bfloat16"))
    assert owner_served.tolist() == np.asarray(prog).tolist()


@pytest.mark.parametrize("n_dev,my_dev,tiles_per_dev", [(1, 0, 3), (2, 1, 1), (4, 2, 21),
                                                        (8, 7, 2)])
def test_remote_first_order_is_the_reference_copy(n_dev, my_dev, tiles_per_dev):
    assert remote_first_order(n_dev, my_dev, tiles_per_dev) == np.asarray(
        jax_remote_first_order(n_dev, my_dev, tiles_per_dev)).tolist()


def test_gemv_tiles_keeps_the_reference_tile_rule():
    a, x = torch.zeros(256, 64), torch.zeros(64, 1)
    # bm = min(bm, M // n_dev): 256 rows over 8 devices cap bm at 32
    assert ref.gemv_tiles_ref(a, x, 8, 0)[1].shape == (8,)
    with pytest.raises(ValueError, match=r"M % \(n_dev \* bm\)"):
        ops.gemv_tiles(torch.zeros(100, 64), x, n_dev=4, my_dev=0, bm=16)
    with pytest.raises(ValueError, match="my_dev"):
        ops.gemv_tiles(a, x, n_dev=4, my_dev=4)


def test_cpu_dispatch_launches_nothing():
    _, _, ta, tx = _inputs(64, 256, 8, "float32", seed=4)
    before = (gemv_cuda.launches, gemv_tiles_cuda.launches)
    assert torch.equal(ops.gemv(ta, tx), ref.gemv_ref(ta, tx))
    y, owner_served = ops.gemv_tiles(ta, tx, n_dev=4, my_dev=1, bm=16)
    assert torch.equal(y, ref.gemv_ref(ta, tx))
    assert owner_served.tolist() == [2, 3, 0, 1]
    assert (gemv_cuda.launches, gemv_tiles_cuda.launches) == before


@pytest.mark.parametrize("kernel", ["gemv", "gemv_tiles"])
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(kernel):
    def call(a, x):
        if kernel == "gemv":
            return gemv_cuda(a, x)
        return gemv_tiles_cuda(a, x, n_dev=2, my_dev=0)

    a, x = torch.zeros(64, 256), torch.zeros(256, 4)
    before = (gemv_cuda.launches, gemv_tiles_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        call(a, x)                            # a CPU tensor: the plain path is ops'
    with pytest.raises(ValueError, match="N <= 8"):
        call(a, torch.zeros(256, 9))
    with pytest.raises(ValueError, match="stride_m == 1"):
        call(torch.zeros(64, 512)[:, ::2], x)  # neither axis contiguous
    with pytest.raises(ValueError, match="multiples of 4"):
        call(torch.zeros(64, 258)[:, :256], x)  # rows 1032 bytes apart
    with pytest.raises(ValueError, match="dtype"):
        call(a, x.to(torch.bfloat16))
    assert (gemv_cuda.launches, gemv_tiles_cuda.launches) == before
