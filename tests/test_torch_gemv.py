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
from repro_torch.kernels.gemv import GemvPlan, gemv_cuda, gemv_plan
from repro_torch.kernels.gemv_tiles import gemv_tiles_cuda, remote_first_order, tile_plan

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


@pytest.mark.parametrize("M,K,N", SWEEP)
def test_gemv_ref_does_not_depend_on_the_thread_count(M, K, N):
    """float64 sums rounded once: one thread and the default count give the
    same bits, and both meet 3e-5 against Pallas."""
    ja, jx, ta, tx = _inputs(M, K, N, "float32", seed=5)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        alone = ref.gemv_ref(ta, tx)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(ref.gemv_ref(ta, tx), alone)
    np.testing.assert_allclose(_np(alone), _np(jops.gemv(ja, jx, bm=64, bk=256)),
                               **_tol("float32"))


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


# --- gemv_plan: the split-K plan of the CUDA kernels, pure and checked here ---


def _slices(plan, K):
    """``(start, length)`` of each K slice, in slice order, as the kernels cut K."""
    return [(s * plan.slice_k, min(plan.slice_k, K - s * plan.slice_k))
            for s in range(plan.splits)]


def _smem_bytes(plan, N, itemsize):
    """A block's dynamic shared memory (``gemv_smem_bytes`` in csrc/gemv_tile.cuh):
    the ring, or the epilogue's partials if larger, then x's float32 slice."""
    box = next(r for r in (64, 128, 256) if plan.rows <= r)
    line_vecs = box * itemsize // 16
    parts = 8 if line_vecs < 32 else 256 // line_vecs
    np_ = 4 if N <= 4 else 8
    return max(4 * 8192, parts * box * np_ * 4) + plan.slice_k * np_ * 4


def _item_tiles(plan: GemvPlan, n_dev: int, my_dev: int, tiles_per_dev: int
               ) -> list[tuple[int, list[int]]]:
    """``(K slice, issued tiles)`` of each item in claim order, as csrc/gemv_tiles.cu
    maps the claimed index c.

    Item c is group ``c // splits``, slice ``c % splits``; the groups cut each
    owner's run of ``remote_first_order`` into chunks of up to ``plan.group``.
    """
    order = remote_first_order(n_dev, my_dev, tiles_per_dev)
    per_owner = -(-tiles_per_dev // plan.group)
    items = []
    for c in range(n_dev * per_owner * plan.splits):
        g, s = divmod(c, plan.splits)
        owner, chunk = divmod(g, per_owner)
        first = owner * tiles_per_dev + chunk * plan.group
        items.append((s, order[first:min(first + plan.group, (owner + 1) * tiles_per_dev)]))
    return items



H100_SMS = 132
GEMMA_SHARD = (5376, 5376, 4, 2)  # A = w.T of gemma3-27b's TP-4 down-projection shard, bf16
TABLE1_SHARD = (256, 2048, 1, 4)  # the paper's Table 1 over 4 ranks, float32
PLAN_CASES = [
    (GEMMA_SHARD, dict(bm=64)), (GEMMA_SHARD, dict(bm=128)), (GEMMA_SHARD, dict(bm=256)),
    ((5376, 5376, 8, 2), dict(bm=64)), (TABLE1_SHARD, dict(bm=64)),
    *[((M, K, N, 4), dict(bm=64)) for M, K, N in SWEEP],
    ((96, 1040, 3, 2), dict(bm=64)), ((136, 40, 8, 4), dict(bm=128)),
    *[(GEMMA_SHARD, dict(bm=64, group=g, tiles_per_dev=21)) for g in (1, 2, 4)],
    ((256, 1024, 1, 4), dict(bm=32, tiles_per_dev=2)),
    ((256, 1024, 1, 4), dict(bm=32, group=8, tiles_per_dev=1)),
]


@pytest.mark.parametrize("shape,kw", PLAN_CASES)
@pytest.mark.parametrize("items_per_sm", [2, 4, 8])
def test_gemv_plan_slices_cover_k_once_in_16_byte_multiples(shape, kw, items_per_sm):
    M, K, N, itemsize = shape
    plan = gemv_plan(M, K, N, itemsize, sms=H100_SMS, items_per_sm=items_per_sm, **kw)
    slices = _slices(plan, K)
    assert len(slices) == plan.splits >= 1
    assert [start for start, _ in slices] == [s * plan.slice_k for s in range(plan.splits)]
    assert all(length > 0 and (length * itemsize) % 16 == 0 for _, length in slices)
    assert sum(length for _, length in slices) == K
    covered = np.zeros(K, int)
    for start, length in slices:
        covered[start:start + length] += 1
    assert (covered == 1).all()
    assert plan.rows == kw.get("group", 1) * kw["bm"] <= 256
    # x's float32 slice and the ring fit a block's shared memory (227 KB)
    assert _smem_bytes(plan, N, itemsize) <= 232448


def test_gemv_plan_fills_the_card():
    # at least 2 items an SM at the gemma shard, more than one at Table 1
    for kw in (dict(), *(dict(tiles_per_dev=21, group=g) for g in (1, 2))):
        assert gemv_plan(*GEMMA_SHARD, 64, H100_SMS, **kw).items >= 2 * H100_SMS
    assert gemv_plan(*TABLE1_SHARD, 64, H100_SMS).items > H100_SMS
    for g in (1, 2):
        assert gemv_plan(*TABLE1_SHARD, 64, H100_SMS, tiles_per_dev=1, group=g).items > H100_SMS
    assert gemv_plan(*GEMMA_SHARD, 64, H100_SMS) == GemvPlan(rows=64, splits=4, slice_k=1344,
                                                            boxes=84)


def test_gemv_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="multiple of 8"):
        gemv_plan(64, 100, 1, 2, 64, H100_SMS)
    with pytest.raises(ValueError, match="256 rows"):
        gemv_plan(5376, 5376, 4, 2, 64, H100_SMS, group=8, tiles_per_dev=21)
    with pytest.raises(ValueError, match="N <= 8"):
        gemv_plan(64, 64, 9, 4, 64, H100_SMS)


@pytest.mark.parametrize("n_dev,my_dev,M,bm", [
    *[(n, r, 256, 32) for n, r in SCHEDULES],      # the reference's schedules
    *[(4, r, 5376, 64) for r in range(4)],         # the 4-rank gemma3-27b shard
    *[(4, r, 256, 64) for r in range(4)],          # the 4-rank Table-1 shard
])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_items_start_tiles_in_remote_first_order(n_dev, my_dev, M, bm, group):
    bm, tiles_per_dev = tile_plan(M, n_dev, my_dev, bm)
    plan = gemv_plan(M, 1024, 4, 2, bm, H100_SMS, group=group, tiles_per_dev=tiles_per_dev)
    items = _item_tiles(plan, n_dev, my_dev, tiles_per_dev)
    assert len(items) == plan.items
    started = []
    for c, (s, tiles) in enumerate(items):
        # a group's slices are claimed in slice order, one after the other
        assert s == c % plan.splits and tiles == items[c - s][1]
        # a group is consecutive rows of one owner
        assert tiles == list(range(tiles[0], tiles[0] + len(tiles))) and len(tiles) <= group
        assert len({t // tiles_per_dev for t in tiles}) == 1
        if s == 0:
            started += tiles
    assert started == remote_first_order(n_dev, my_dev, tiles_per_dev)


@pytest.mark.parametrize("M,K,N", [*SWEEP, (256, 2048, 1)])
def test_split_k_sum_in_slice_order_matches_pallas(M, K, N):
    ja, jx, ta, tx = _inputs(M, K, N, "float32", seed=5)
    plan = gemv_plan(M, K, N, 4, 64, H100_SMS)
    assert plan.splits > 1
    a, x = ta.numpy(), tx.numpy()
    y = np.zeros((M, N), np.float32)
    for start, length in _slices(plan, K):  # the last block's sum, slice by slice
        y += a[:, start:start + length] @ x[start:start + length]
    np.testing.assert_allclose(y, _np(jops.gemv(ja, jx, bm=64, bk=256)), rtol=3e-5, atol=3e-5)
