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

from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (DecodeAttentionPlan, decode_attention_cuda,
                                                  decode_attention_plan)
from repro_torch.kernels.gemv import GemvPlan, gemv_cuda, gemv_plan
from repro_torch.kernels.gemv_tiles import gemv_tiles_cuda, remote_first_order, tile_plan
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.models import Model, moe
from repro_torch.models.model import decode_launches
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
    # zamba2-2.7b's shared attention, H = KV = 32 at D 80 (10 bf16 vectors):
    # the serve path's S 544 and the families' S 40
    (4, 32, 32, 80, 544, 1), (4, 32, 32, 80, 544, 300), (4, 32, 32, 80, 544, 544),
    (4, 32, 32, 80, 40, 40),
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


# (H, KV, D) head layouts that reach every bound RT on the query rows a thread
# accumulates, ceil(rep / (256 // (D / vector))) rounded up to 1, 2, 4 or 8:
# bf16 RT 1, 1, 1, 2, 1, 4, 8 and float32 RT 1, 1, 1, 4, 1, 8 in this order
ATTENTION_HEADS = [(16, 1, 64), (8, 1, 112), (16, 2, 128), (16, 1, 256), (6, 2, 256),
                   (16, 1, 512), (9, 1, 1024)]
# (S, length, chunk): one split staged in two blocks; a ragged last chunk
# (290 = 6 x 48 + 2); length below one chunk; length 1; three chunks of three
# staged blocks each (128 + 128 + 16), the last chunk 56
ATTENTION_PLANS = [(200, 200, 208), (300, 290, 48), (64, 20, 32), (50, 1, 16),
                   (600, 600, 272)]


@pytest.mark.parametrize("H,KV,D,dtype", [
    (*heads, dtype) for heads in ATTENTION_HEADS for dtype in sorted(DTYPES)
    if heads[2] * (2 if dtype == "bfloat16" else 4) <= 16 * 128])
@pytest.mark.parametrize("S,length,chunk", ATTENTION_PLANS)
def test_decode_attention_kernel_under_explicit_plans(cuda, H, KV, D, dtype, S, length, chunk):
    dt = DTYPES[dtype]
    q = _randn((2, H, D), dt, cuda, 8)
    k = _randn((2, S, KV, D), dt, cuda, 9)
    v = _randn((2, S, KV, D), dt, cuda, 10)
    plan = decode_attention_plan(2, KV, H // KV, D, q.element_size(), length, 132, chunk=chunk)
    assert plan.splits == -(-length // chunk)
    o = decode_attention_cuda(q, k, v, length, plan=plan)
    torch.testing.assert_close(
        o.float(), ref.decode_attention_ref(q.float(), k.float(), v.float(), length),
        **TOL[dtype])
    assert torch.equal(decode_attention_cuda(q, k, v, length, plan=plan), o)


@pytest.mark.parametrize("S,length", [(544, 544), (512, 512), (544, 300)])
def test_decode_attention_kernel_repeats_its_bits(cuda, S, length):
    # the serve path's shapes under the default plan (17 chunks of 32 at 544)
    q = _randn((4, 4, 256), torch.bfloat16, cuda, 11)
    k = _randn((4, S, 1, 256), torch.bfloat16, cuda, 12)
    v = _randn((4, S, 1, 256), torch.bfloat16, cuda, 13)
    o = decode_attention_cuda(q, k, v, length)
    for _ in range(3):
        assert torch.equal(decode_attention_cuda(q, k, v, length), o)


def test_decode_attention_calls_on_two_streams_keep_their_own_workspace(cuda):
    # two launches in flight at once on two streams, nothing synchronised in
    # between: each call's partials and counters are its own
    ops = []
    for seed in (20, 23):
        q = _randn((4, 4, 256), torch.bfloat16, cuda, seed)
        k = _randn((4, 544, 1, 256), torch.bfloat16, cuda, seed + 1)
        v = _randn((4, 544, 1, 256), torch.bfloat16, cuda, seed + 2)
        ops.append((q, k, v, decode_attention_cuda(q, k, v, 544)))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for (q, k, v, _), stream in zip(ops, streams):
        with torch.cuda.stream(stream):
            outs.append(decode_attention_cuda(q, k, v, 544))
    torch.cuda.synchronize()
    for o, (q, k, v, want) in zip(outs, ops):
        assert torch.equal(o, want)
        torch.testing.assert_close(
            o.float(), ref.decode_attention_ref(q.float(), k.float(), v.float(), 544),
            **TOL["bfloat16"])


def test_decode_attention_kernel_ignores_slots_beyond_length_across_splits(cuda):
    q = _randn((2, 8, 64), torch.bfloat16, cuda, 14)
    k = _randn((2, 256, 2, 64), torch.bfloat16, cuda, 15)
    v = _randn((2, 256, 2, 64), torch.bfloat16, cuda, 16)
    plan = decode_attention_plan(2, 2, 4, 64, 2, 100, 132, chunk=16)  # 7 chunks, the last 4
    o = decode_attention_cuda(q, k, v, 100, plan=plan)
    o_default = decode_attention_cuda(q, k, v, 100)
    k[:, 100:] = 99.0
    v[:, 100:] = -99.0
    assert torch.equal(decode_attention_cuda(q, k, v, 100, plan=plan), o)
    assert torch.equal(decode_attention_cuda(q, k, v, 100), o_default)


def test_decode_attention_refuses_plans_that_do_not_fit(cuda):
    q, k = torch.zeros(1, 4, 16, device=cuda), torch.zeros(1, 64, 1, 16, device=cuda)
    with pytest.raises(ValueError, match="does not cover"):
        decode_attention_cuda(q, k, k, 40, plan=DecodeAttentionPlan(chunk=16, splits=2, block=16))
    with pytest.raises(ValueError, match="does not cover"):  # an empty last chunk
        decode_attention_cuda(q, k, k, 32, plan=DecodeAttentionPlan(chunk=16, splits=3, block=16))
    with pytest.raises(ValueError, match="does not cover"):
        decode_attention_cuda(q, k, k, 40, plan=DecodeAttentionPlan(chunk=64, splits=1, block=256))


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


ATTENTION_ARCHS = ["gemma3-1b", "gemma3-27b", "kimi-k2-1t-a32b", "kimi-k2-1t-mla", "minicpm3-4b",
                   "musicgen-large", "olmoe-1b-7b", "qwen2-vl-7b", "starcoder2-7b"]
RECURRENT_ARCHS = ["zamba2-2.7b", "xlstm-125m"]


@pytest.mark.parametrize("arch", ATTENTION_ARCHS + RECURRENT_ARCHS)
def test_decode_steps_of_each_family_on_the_card_match_the_cpu(cuda, arch):
    cfg = reduced(get_config(arch)).with_(param_dtype=torch.float32)
    gpu = Model(cfg).init(torch.Generator().manual_seed(1))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    gc, cc = gpu.init_caches(2, 12), cpu.init_caches(2, 12)
    before = (rmsnorm_cuda.launches, decode_attention_cuda.launches)
    for pos in range(8):
        toks = torch.tensor([5 + pos, 9])
        lg, gc = gpu.decode_step(gc, toks.to(cuda), pos)
        lc, cc = cpu.decode_step(cc, toks, pos)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        for gb, cb in zip(gpu.blocks, cpu.blocks):
            if hasattr(cb, "routing"):
                assert torch.equal(gb.routing.cpu(), cb.routing)
    expect = decode_launches(cfg)
    assert (rmsnorm_cuda.launches - before[0], decode_attention_cuda.launches - before[1]
            ) == (8 * expect["rmsnorm"], 8 * expect["decode_attention"])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b", "kimi-k2-1t-mla"])
def test_moe_decode_step_waits_on_the_host_for_nothing(cuda, arch):
    model = Model(reduced(get_config(arch))).init(torch.Generator(device="cuda").manual_seed(0))
    caches = model.init_caches(4, 8)
    toks = torch.tensor([1, 2, 3, 4], device=cuda)
    model.decode_step(caches, toks, 0)  # first use: kernels built, plans cached
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = model.decode_step(caches, toks, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_serve_on_the_card_matches_the_cpu(cuda, arch):
    cfg = reduced(get_config(arch)).with_(param_dtype=torch.float32)
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


@pytest.mark.parametrize("rows,E,d,ff", [(32, 64, 2048, 1024), (18, 8, 64, 128)])
def test_grouped_ffn_on_the_card_matches_its_plain_version(cuda, rows, E, d, ff):
    cfg = get_config("olmoe-1b-7b").with_(n_experts=E, d_model=d, d_ff=ff)
    g = torch.Generator(device="cpu").manual_seed(4)
    p = {k: (torch.randn(shape, generator=g) * shape[-2] ** -0.5).to(cuda, torch.bfloat16)
         for k, shape in (("w_gate", (E, d, ff)), ("w_up", (E, d, ff)), ("w_down", (E, ff, d)))}
    xs = torch.randn(rows, d, generator=g).to(cuda, torch.bfloat16)
    # rows for the first half of the experts only: the others' groups are empty
    counts = torch.bincount(torch.randint(0, E // 2, (rows,), generator=g), minlength=E)
    offsets = torch.cumsum(counts, 0).to(cuda, torch.int32)
    y = moe.grouped_ffn(cfg, p, xs, offsets)
    y_plain = moe.grouped_ffn_ref(cfg, {k: v.float() for k, v in p.items()}, xs.float(), offsets)
    assert y.dtype == torch.bfloat16 and y.shape == (rows, d)
    torch.testing.assert_close(y.float(), y_plain, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("D", [256, 512, 768, 1536, 2048])
def test_rmsnorm_kernel_at_the_mla_and_olmoe_widths(cuda, D):
    x = _randn((4, 1, D), torch.bfloat16, cuda, 5)
    g = _randn((D,), torch.bfloat16, cuda, 6) * 0.2
    torch.testing.assert_close(rmsnorm_cuda(x, g).float(), ref.rmsnorm_ref(x.float(), g.float()),
                               **TOL["bfloat16"])


def _norm_widths():
    """Every width the port's norms take: each config's d_model and MLA's
    latent ranks (kv and q)."""
    widths = set()
    for arch in REGISTRY:
        cfg = get_config(arch)
        widths.add(cfg.d_model)
        if cfg.attn_kind == "mla":
            widths.update(r for r in (cfg.mla_kv_rank, cfg.mla_q_rank) if r)
    return sorted(widths)


NORM_WIDTHS = _norm_widths()


@pytest.mark.parametrize("D", NORM_WIDTHS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows", [1, 4, 9])
def test_rmsnorm_kernel_at_every_width_of_the_port(cuda, D, dtype, rows):
    dt = DTYPES[dtype]
    x = _randn((rows, 1, D), dt, cuda, 7)
    g = _randn((D,), dt, cuda, 8) * 0.2
    before = rmsnorm_cuda.launches
    y = rmsnorm_cuda(x, g)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    assert y.dtype == dt and y.shape == x.shape
    torch.testing.assert_close(y.float(), ref.rmsnorm_ref(x.float(), g.float()), **TOL[dtype])
    assert torch.equal(rmsnorm_cuda(x, g), y)  # fixed sum orders: the same bits


def test_rmsnorm_kernel_refuses_rows_wider_than_it_takes(cuda):
    with pytest.raises(ValueError, match="at most 16384"):
        rmsnorm_cuda(torch.zeros(2, 16392, device=cuda, dtype=torch.bfloat16),
                     torch.zeros(16392, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="at most 8192"):
        rmsnorm_cuda(torch.zeros(2, 8196, device=cuda), torch.zeros(8196, device=cuda))


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


def _plan(M, K, rows, slice_k, vec):
    """A plan of boxes of ``rows`` rows and K slices of ``slice_k`` elements."""
    assert slice_k % vec == 0
    return GemvPlan(rows=rows, splits=-(-K // slice_k), slice_k=slice_k, boxes=-(-M // rows))


@pytest.mark.parametrize("M,K,N,rows,slice_k", [
    (192, 1000, 3, 64, 96),     # a ragged last slice: 10 x 96 + 40
    (192, 1000, 3, 128, 104),   # the same in 128-row boxes, ragged rows (192 = 128 + 64)
    (256, 2048, 5, 256, 520),   # 256-row boxes, the last slice 488
    (136, 256, 2, 64, 256),     # K within one slice: a single split writes y itself
    (136, 40, 8, 128, 40),      # K smaller than one ring stage
])
@pytest.mark.parametrize("layout", ["row_major", "w.T"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gemv_kernel_under_explicit_plans(cuda, M, K, N, rows, slice_k, layout, dtype):
    a, x = _gemv_operands(M, K, N, DTYPES[dtype], layout, cuda, 30)
    plan = _plan(M, K, rows, slice_k, 16 // a.element_size())
    y = gemv_cuda(a, x, plan=plan)
    torch.testing.assert_close(y.float(), ref.gemv_ref(a.float(), x.float()), **TOL[dtype])
    assert torch.equal(gemv_cuda(a, x, plan=plan), y)


@pytest.mark.parametrize("rows", [64, 128, 256])
@pytest.mark.parametrize("items_per_sm", [2, 4, 8])
@pytest.mark.parametrize("layout", ["row_major", "w.T"])
def test_gemv_kernel_at_the_gemma3_27b_shard_under_each_measured_plan(cuda, rows, items_per_sm,
                                                                      layout):
    a, x = _gemv_operands(5376, 5376, 4, torch.bfloat16, layout, cuda, 31)
    plan = gemv_plan(5376, 5376, 4, 2, rows, torch.cuda.get_device_properties(cuda)
                     .multi_processor_count, items_per_sm=items_per_sm)
    y = gemv_cuda(a, x, plan=plan)
    torch.testing.assert_close(y.float(), ref.gemv_ref(a.float(), x.float()), **TOL["bfloat16"])


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("my_dev", [0, 3])
@pytest.mark.parametrize("layout", ["row_major", "w.T"])
def test_gemv_tiles_kernel_groups_of_tiles(cuda, group, my_dev, layout):
    # 21 tiles an owner, as at the gemma3-27b shard: groups of 2 or 4 leave a
    # shorter group at the end of each owner's run
    M, K, N, bm = 4 * 21 * 64, 1024, 4, 64
    a, x = _gemv_operands(M, K, N, torch.bfloat16, layout, cuda, 32)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = gemv_plan(M, K, N, 2, bm, sms, group=group, tiles_per_dev=21)
    y, owner_served = gemv_tiles_cuda(a, x, n_dev=4, my_dev=my_dev, plan=plan)
    torch.testing.assert_close(y.float(), ref.gemv_ref(a.float(), x.float()), **TOL["bfloat16"])
    assert owner_served.tolist() == [t // 21 for t in remote_first_order(4, my_dev, 21)]
    assert torch.equal(gemv_tiles_cuda(a, x, n_dev=4, my_dev=my_dev, plan=plan)[0], y)


@pytest.mark.parametrize("kernel", ["gemv", "gemv_tiles"])
def test_gemv_calls_on_two_streams_keep_their_own_workspace(cuda, kernel):
    # two launches in flight at once on two streams, nothing synchronised in
    # between: each call's partials and counters are its own
    ops = []
    for seed in (40, 42):
        a, x = _gemv_operands(5376, 5376, 4, torch.bfloat16, "w.T", cuda, seed)
        ops.append((a, x, ref.gemv_ref(a.float(), x.float())))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for (a, x, _), stream in zip(ops, streams):
        with torch.cuda.stream(stream):
            if kernel == "gemv":
                outs.append(gemv_cuda(a, x))
            else:
                outs.append(gemv_tiles_cuda(a, x, n_dev=4, my_dev=1)[0])
    torch.cuda.synchronize()
    for y, (_, _, want) in zip(outs, ops):
        torch.testing.assert_close(y.float(), want, **TOL["bfloat16"])


def test_gemv_wrappers_refuse_plans_that_do_not_fit(cuda):
    a, x = torch.zeros(256, 64, device=cuda), torch.zeros(64, 2, device=cuda)
    with pytest.raises(ValueError, match="boxes"):
        gemv_cuda(a, x, plan=GemvPlan(rows=64, splits=1, slice_k=64, boxes=3))
    with pytest.raises(RuntimeError, match="CUDA error"):  # slices that miss K
        gemv_cuda(a, x, plan=GemvPlan(rows=64, splits=1, slice_k=32, boxes=4))
    with pytest.raises(ValueError, match="groups"):
        gemv_tiles_cuda(a, x, n_dev=4, my_dev=0,
                        plan=GemvPlan(rows=64, splits=1, slice_k=64, boxes=5))
