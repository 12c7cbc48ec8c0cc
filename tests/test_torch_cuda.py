"""The CUDA kernels against their plain versions, on the card (marker ``cuda``).

Every test takes the ``cuda`` fixture, which skips when no CUDA device is
present: the decision is made when the test runs, never at import, so every
pytest worker collects the same tests.  Run on a machine with an H100:
    python -m pytest -q -m cuda tests/test_torch_cuda.py

The plain version runs in float32 from the same inputs.  Tolerances: 3e-5 in
float32 (only the order of sums and the rsqrtf / expf ulps differ); in bf16
rtol 1e-2, atol 4e-3, about 5x the kernel's own rounding of its float32 result
to bf16 (relative error <= 2^-9).  That is tighter than the reference's 3e-2,
which would pass an attention that dropped a slot or accumulated in bf16
(chip_smoke.py reads such controls against it).  The gemv kernels take the
same tolerances; their float32 sums are blocked, as the plain version's are.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.gemv import gemv_cuda
from repro_torch.kernels.gemv_tiles import gemv_tiles_cuda, remote_first_order, tile_plan
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.models import Model
from repro_torch.serving import ServeConfig, ServeEngine

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": dict(rtol=3e-5, atol=3e-5), "bfloat16": dict(rtol=1e-2, atol=4e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


@pytest.mark.parametrize("shape", [(4, 1, 1152), (2, 1, 64), (2, 33, 256)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    x = _randn(shape, DTYPES[dtype], cuda, 0)
    g = _randn(shape[-1:], DTYPES[dtype], cuda, 1) * 0.2
    before = rmsnorm_cuda.launches
    y = rmsnorm_cuda(x, g)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(), ref.rmsnorm_ref(x.float(), g.float()),
                               **TOL[dtype])


@pytest.mark.parametrize("B,H,KV,D,S,length", [
    # the gemma3-1b serve path: local layers at S = 512, global at S = 544
    (4, 4, 1, 256, 512, 1), (4, 4, 1, 256, 512, 300), (4, 4, 1, 256, 512, 512),
    (4, 4, 1, 256, 544, 1), (4, 4, 1, 256, 544, 300), (4, 4, 1, 256, 544, 512),
    (4, 4, 1, 256, 544, 544),
    # the reference's sweep shapes and the reduced config
    (2, 8, 2, 64, 1024, 1017), (2, 8, 8, 32, 768, 761), (2, 4, 1, 16, 48, 40),
    # every bound R on rep the kernel is built for: rep 2, 3 (R = 4), 8, 16
    (2, 4, 2, 32, 100, 77), (1, 6, 2, 64, 150, 150), (2, 8, 1, 64, 200, 130),
    (1, 16, 1, 128, 300, 299),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_kernel_matches_plain(cuda, B, H, KV, D, S, length, dtype):
    dt = DTYPES[dtype]
    q = _randn((B, H, D), dt, cuda, 2)
    k = _randn((B, S, KV, D), dt, cuda, 3)
    v = _randn((B, S, KV, D), dt, cuda, 4)
    before = decode_attention_cuda.launches
    o = decode_attention_cuda(q, k, v, length)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    assert o.dtype == dt and o.shape == (B, H, D)
    torch.testing.assert_close(
        o.float(), ref.decode_attention_ref(q.float(), k.float(), v.float(), length),
        **TOL[dtype])


def test_decode_attention_kernel_ignores_slots_beyond_length(cuda):
    q = _randn((1, 2, 16), torch.float32, cuda, 5)
    k = _randn((1, 256, 1, 16), torch.float32, cuda, 6)
    v = _randn((1, 256, 1, 16), torch.float32, cuda, 7)
    o = decode_attention_cuda(q, k, v, 10)
    k[:, 10:] = 99.0
    v[:, 10:] = -99.0
    torch.testing.assert_close(decode_attention_cuda(q, k, v, 10), o, rtol=0, atol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_cuda(x.t(), torch.zeros(4, device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        rmsnorm_cuda(x, torch.zeros(64, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple"):
        rmsnorm_cuda(torch.zeros(4, 6, device=cuda), torch.zeros(6, device=cuda))
    q, k = torch.zeros(1, 4, 16, device=cuda), torch.zeros(1, 8, 1, 16, device=cuda)
    with pytest.raises(ValueError, match="length"):
        decode_attention_cuda(q, k, k, 0)
    with pytest.raises(ValueError, match="D <= 1024"):  # one 16-byte vector a thread
        big = torch.zeros(1, 8, 1, 2048, device=cuda, dtype=torch.bfloat16)
        decode_attention_cuda(big[:, 0], big, big, 4)
    with pytest.raises(ValueError, match="H % KV"):
        decode_attention_cuda(torch.zeros(1, 3, 16, device=cuda),
                              torch.zeros(1, 8, 2, 16, device=cuda),
                              torch.zeros(1, 8, 2, 16, device=cuda), 4)


def test_decode_step_launches_each_kernel_per_layer(cuda):
    cfg = reduced(get_config("gemma3-1b")).with_(param_dtype=torch.float32)
    model = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    caches = model.init_caches(2, 24)
    before = (rmsnorm_cuda.launches, decode_attention_cuda.launches)
    for pos in range(20):  # past the 16-slot window
        logits, caches = model.decode_step(caches, torch.tensor([3, 4], device=cuda), pos)
    assert torch.isfinite(logits).all()
    assert (rmsnorm_cuda.launches - before[0], decode_attention_cuda.launches - before[1]
            ) == (20 * (2 * cfg.n_layers + 1), 20 * cfg.n_layers)


def test_serve_on_the_card_matches_the_cpu(cuda):
    cfg = reduced(get_config("gemma3-1b")).with_(param_dtype=torch.float32)
    gpu = Model(cfg).init(torch.Generator().manual_seed(1))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    prompts = [[5, 6, 7], [9, 10], [1, 2, 3, 4],
               np.random.default_rng(1).integers(1, cfg.vocab, 21).tolist()]
    outs = {}
    for name, model in (("gpu", gpu), ("cpu", cpu)):
        eng = ServeEngine(model, ServeConfig(max_batch=2))
        outs[name] = (eng.generate(prompts, 12), eng.stats)
    assert outs["gpu"] == outs["cpu"]


def _gemv_operands(M, K, N, dtype, layout, device, seed):
    """a [M, K] row-major, or A = w.T of a row-major w [K, M]; x [K, N]."""
    a = _randn((M, K), dtype, device, seed)
    if layout == "w.T":
        a = a.T.contiguous().T
        assert a.stride() == (1, M)
    return a, _randn((K, N), dtype, device, seed + 1)


GEMV_SHAPES = [
    # the reference's sweep (tests/test_kernels.py:19), in both dtypes
    *[(*mkn, dtype) for mkn in [(128, 512, 1), (256, 1024, 1), (256, 2048, 4), (64, 256, 8)]
      for dtype in sorted(DTYPES)],
    # every N the kernels take, a ragged last tile (M % 32), K not a multiple of the chunk
    *[(96, 1040, n, dtype) for n in range(1, 9) for dtype in sorted(DTYPES)],
    *[(200, 3072, 3, dtype) for dtype in sorted(DTYPES)],
    # the fused GEMV+AllReduce's shards in their dtypes: Table 1 in float32, and
    # gemma3-27b's down-projection over 4 ranks in bf16 (in float32 at K = 5376 the
    # kernel and cuBLAS sum in orders that differ by ~3e-4 on outputs near 73)
    (256, 2048, 1, "float32"), (5376, 5376, 4, "bfloat16"),
]


@pytest.mark.parametrize("M,K,N,dtype", GEMV_SHAPES)
@pytest.mark.parametrize("layout", ["row_major", "w.T"])
def test_gemv_kernel_matches_plain(cuda, M, K, N, dtype, layout):
    a, x = _gemv_operands(M, K, N, DTYPES[dtype], layout, cuda, 10)
    before = gemv_cuda.launches
    y = gemv_cuda(a, x)
    torch.cuda.synchronize()
    assert gemv_cuda.launches == before + 1
    assert y.dtype == a.dtype and y.shape == (M, N)
    torch.testing.assert_close(y.float(), ref.gemv_ref(a.float(), x.float()), **TOL[dtype])
    assert torch.equal(gemv_cuda(a, x), y)  # no atomics on values: the same bits


@pytest.mark.parametrize("n_dev,my_dev,M,K,N,bm", [
    # the reference's schedules (tests/test_kernels.py:32)
    (4, 0, 256, 1024, 1, 32), (4, 1, 256, 1024, 1, 32), (4, 3, 256, 1024, 1, 32),
    (8, 5, 256, 1024, 1, 32),
    # several tiles an owner, every N, and the path's shards (4 ranks, bm = 64)
    *[(2, 1, 512, 512, n, 64) for n in range(1, 9)],
    *[(4, r, 256, 2048, 1, 64) for r in range(4)],
])
@pytest.mark.parametrize("layout", ["row_major", "w.T"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gemv_tiles_kernel_matches_plain_and_schedule(cuda, n_dev, my_dev, M, K, N, bm,
                                                      layout, dtype):
    _check_gemv_tiles(cuda, n_dev, my_dev, M, K, N, bm, layout, dtype)


@pytest.mark.parametrize("my_dev", range(4))
@pytest.mark.parametrize("layout", ["row_major", "w.T"])
def test_gemv_tiles_kernel_at_the_gemma3_27b_shard(cuda, my_dev, layout):
    _check_gemv_tiles(cuda, 4, my_dev, 5376, 5376, 4, 64, layout, "bfloat16")


def _check_gemv_tiles(cuda, n_dev, my_dev, M, K, N, bm, layout, dtype):
    a, x = _gemv_operands(M, K, N, DTYPES[dtype], layout, cuda, 20)
    before = gemv_tiles_cuda.launches
    y, owner_served = gemv_tiles_cuda(a, x, n_dev=n_dev, my_dev=my_dev, bm=bm)
    torch.cuda.synchronize()
    assert gemv_tiles_cuda.launches == before + 1
    torch.testing.assert_close(y.float(), ref.gemv_ref(a.float(), x.float()), **TOL[dtype])
    _, tiles_per_dev = tile_plan(M, n_dev, my_dev, bm)
    expect = [t // tiles_per_dev for t in remote_first_order(n_dev, my_dev, tiles_per_dev)]
    assert owner_served.dtype == torch.int32 and owner_served.tolist() == expect
    assert torch.equal(gemv_tiles_cuda(a, x, n_dev=n_dev, my_dev=my_dev, bm=bm)[0], y)


def test_gemv_wrappers_refuse_on_the_card(cuda):
    a, x = torch.zeros(256, 64, device=cuda), torch.zeros(64, 2, device=cuda)
    with pytest.raises(ValueError, match="bm <= 64"):
        gemv_tiles_cuda(a, x, n_dev=1, my_dev=0, bm=128)
    w = torch.zeros(64, 80, device=cuda, dtype=torch.bfloat16)  # A = w.T: bm = 20 rows
    with pytest.raises(ValueError, match="multiple of 8"):
        gemv_tiles_cuda(w.T, x.to(torch.bfloat16), n_dev=4, my_dev=0)
    with pytest.raises(ValueError, match="N <= 8"):
        gemv_cuda(a, torch.zeros(64, 9, device=cuda))
    with pytest.raises(ValueError, match="stride_m == 1"):
        gemv_cuda(torch.zeros(64, 512, device=cuda)[:, ::2], torch.zeros(256, 1, device=cuda))
