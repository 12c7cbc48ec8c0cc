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
same tolerances against the plain version's float64 sums, rounded once.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    DecodeAttentionPlan, combine_partials, decode_attention_cuda, decode_attention_partial_cuda,
    decode_attention_partial_ref, decode_attention_plan)
from repro_torch.kernels.gemv import GemvPlan, gemv_cuda, gemv_plan
from repro_torch.kernels.gemv_tiles import gemv_tiles_cuda, remote_first_order, tile_plan
from repro_torch.kernels.mamba_decode import mamba_decode_cuda, mamba_decode_ref
from repro_torch.kernels.rmsnorm import (RMSNormBwdPlan, rmsnorm_bwd_cuda, rmsnorm_bwd_ref,
                                         rmsnorm_bwd_workspace, rmsnorm_cuda)
from repro_torch.models import Model, moe, ssm
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


@pytest.mark.parametrize("H,KV,D", [(4, 1, 256), (16, 16, 128)], ids=["gemma3-1b", "olmoe"])
@pytest.mark.parametrize("R,length", [(2, 544), (2, 200), (4, 544), (4, 300)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_partial_kernel_over_slices_of_s(cuda, H, KV, D, R, length, dtype):
    """S 544 cut into R slices, the valid prefix ``length`` (a slice past it
    has length 0): each slice's (o, lse) against the plain partial from the
    same values in float32, and the slices combined against the whole
    attention; one launch a slice, the empty one included.  The output is
    float32, accumulated in float32 from either input dtype, so both are held
    at the float32 tolerance, which rejects the output rounded to bf16."""
    dt, B, S = DTYPES[dtype], 4, 544
    q = _randn((B, H, D), dt, cuda, 2)
    k = _randn((B, S, KV, D), dt, cuda, 3)
    v = _randn((B, S, KV, D), dt, cuda, 4)
    L = S // R
    before = (decode_attention_cuda.launches, decode_attention_partial_cuda.launches)
    parts, lengths = [], []
    for r in range(R):
        ks, vs = k[:, r * L:(r + 1) * L].contiguous(), v[:, r * L:(r + 1) * L].contiguous()
        n = min(max(length - r * L, 0), L)
        o, lse = decode_attention_partial_cuda(q, ks, vs, n)
        o_ref, lse_ref = decode_attention_partial_ref(q.float(), ks.float(), vs.float(), n)
        assert o.dtype == lse.dtype == torch.float32
        torch.testing.assert_close(o, o_ref, **TOL["float32"])
        if n:
            assert not torch.allclose(o_ref.to(torch.bfloat16).float(), o_ref, **TOL["float32"])
        torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
        if n == 0:
            assert torch.equal(o, torch.zeros_like(o)) and (lse < -1e38).all()
        parts.append((o, lse))
        lengths.append(n)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before[0] + R
    assert decode_attention_partial_cuda.launches == before[1] + R
    assert 0 in lengths or length == S
    got = combine_partials(torch.stack([o for o, _ in parts]), torch.stack([l for _, l in parts]))
    torch.testing.assert_close(
        got, ref.decode_attention_ref(q.float(), k.float(), v.float(), length), **TOL["float32"])


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


def _mamba_decode_case(cuda, B, H, ds, dtype, seed, d_head=64, K=4):
    """A Mamba2 block's decode parameters (Mamba2's ranges), a random state,
    and ``w_out`` the identity, so that ``_decode``'s output is the gated y."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    d_inner = H * d_head
    C = d_inner + 2 * ds
    dt = torch.exp(torch.empty(H).uniform_(np.log(1e-3), np.log(1e-1), generator=g))
    p = {"conv_w": (torch.randn(K, C, generator=g) * 0.5).to(cuda, dtype),
         "norm_z": (torch.randn(d_inner, generator=g) * 0.1).to(cuda, dtype),
         "a_log": torch.log(torch.empty(H).uniform_(1, 16, generator=g)).to(cuda),
         "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(cuda),
         "d_skip": (1 + 0.1 * torch.randn(H, generator=g)).to(cuda),
         "w_out": torch.eye(d_inner, dtype=dtype, device=cuda)}
    state = {"h": (torch.randn(B, H, d_head, ds, generator=g) * 0.1).to(cuda),
             "conv": torch.randn(B, K - 1, C, generator=g).to(cuda)}
    projs = [torch.randn(B, 1, 2 * d_inner + 2 * ds + H, generator=g).to(cuda, dtype)
             for _ in range(20)]
    return p, state, projs


def _plain_decode(p, proj, state):
    """``ssm._decode`` with the kernel's plain version in its place."""
    y, state["conv"] = mamba_decode_ref(proj, state["conv"], state["h"], p["conv_w"],
                                        p["dt_bias"], p["a_log"], p["d_skip"], p["norm_z"])
    return y @ p["w_out"], state


# zamba2-2.7b's widths (80 heads of 64, d_state 64) at B 4 and 64, one rank's
# 20 heads of a 4-way cut, and the reduced config's 2 heads with d_state 16
MAMBA_DECODE_SHAPES = [(4, 80, 64), (64, 80, 64), (4, 20, 64), (4, 2, 16)]


@pytest.mark.parametrize("B,H,ds", MAMBA_DECODE_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mamba_decode_kernel_matches_the_plain_decode(cuda, B, H, ds, dtype):
    """20 steps of the kernel and of its plain version from the same state,
    each carrying its own: the gated y every step, h and the window after."""
    cfg = reduced(get_config("zamba2-2.7b")).with_(ssm_state=ds)
    p, state, projs = _mamba_decode_case(cuda, B, H, ds, DTYPES[dtype], seed=B + H + ds)
    mine = {k: v.clone() for k, v in state.items()}
    before = mamba_decode_cuda.launches
    with torch.no_grad():
        for proj in projs:
            h_in = mine["h"]
            y, mine = ssm._decode(cfg, p, proj, mine)
            y_plain, state = _plain_decode(p, proj, state)
            assert mine["h"] is h_in  # updated in place
            assert y.dtype == proj.dtype and y.shape == (B, 1, H * 64)
            torch.testing.assert_close(y.float(), y_plain.float(), **TOL[dtype])
    torch.cuda.synchronize()
    assert mamba_decode_cuda.launches - before == len(projs)
    for name in ("h", "conv"):
        assert mine[name].dtype == torch.float32 and mine[name].is_contiguous()
        torch.testing.assert_close(mine[name], state[name], **TOL[dtype])


def test_mamba_decode_launches_once_a_layer_and_step(cuda):
    cfg = reduced(get_config("zamba2-2.7b")).with_(param_dtype=torch.float32)
    model = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    caches = model.init_caches(2, 24)
    before = mamba_decode_cuda.launches
    for pos in range(20):
        logits, caches = model.decode_step(caches, torch.tensor([3, 4], device=cuda), pos)
    assert torch.isfinite(logits).all()
    mamba = sum(b.kind == "mamba" for b in model.entries)
    assert mamba_decode_cuda.launches - before == 20 * decode_launches(cfg)["mamba_decode"] \
        == 20 * mamba
    for entry, block in zip(caches, model.entries):
        if block.kind == "mamba":
            assert all(t.dtype == torch.float32 and t.is_contiguous() for t in entry.values())


def test_mamba_decode_kernel_refuses_what_it_does_not_take(cuda):
    cfg = reduced(get_config("zamba2-2.7b"))
    p, state, projs = _mamba_decode_case(cuda, 2, 2, 16, torch.float32, seed=3)
    args = lambda st, **kw: ({**dict(proj=projs[0], conv=st["conv"], h=st["h"],  # noqa: E731
                                     **{k: p[k] for k in ("conv_w", "dt_bias", "a_log",
                                                          "d_skip", "norm_z")}), **kw})
    with torch.no_grad():
        y, conv = mamba_decode_cuda(**args(state))
        assert y.shape == (2, 1, 128) and conv.shape == state["conv"].shape
        p24, st24, proj24 = _mamba_decode_case(cuda, 2, 2, 24, torch.float32, seed=4)
        with pytest.raises(ValueError, match="d_state"):
            ssm._decode(cfg.with_(ssm_state=24), p24, proj24[0], st24)
        wide = torch.zeros(2, 2, 64, 32, device=cuda)[..., :16]
        with pytest.raises(ValueError, match="contiguous"):
            mamba_decode_cuda(**args(state, h=wide))
    w = p["conv_w"].clone().requires_grad_(True)
    with torch.enable_grad(), pytest.raises(ValueError, match="backward"):
        mamba_decode_cuda(**args(state, conv_w=w))


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


# the rmsnorm backward: the training shapes (gemma3-1b's microbatch of 2 x
# 1024 tokens at D 1152, a rank of its sharded step, xlstm-125m's 8 x 128 at
# D 768), rows that leave the last CTA a short run (2044: 12 of 16), and
# float32 at the parity configs' widths
RMSNORM_BWD_CASES = [((2048, 1152), "bfloat16"), ((1024, 768), "bfloat16"),
                     ((1024, 1152), "bfloat16"), ((2044, 1152), "bfloat16"),
                     ((2, 1024, 1152), "float32"), ((1000, 2560), "bfloat16"),
                     ((7, 64), "float32"), ((33, 256), "float32"), ((3, 5, 128), "bfloat16"),
                     ((300, 8192), "float32"), ((17, 16384), "bfloat16")]


@pytest.mark.parametrize("shape,dtype", RMSNORM_BWD_CASES)
def test_rmsnorm_bwd_kernel_matches_plain_and_repeats_its_bits(cuda, shape, dtype):
    dt = DTYPES[dtype]
    x = _randn(shape, dt, cuda, 20)
    g = _randn(shape[-1:], dt, cuda, 21) * 0.2
    dy = _randn(shape, dt, cuda, 22)
    before = rmsnorm_bwd_cuda.launches
    dx, dg = rmsnorm_bwd_cuda(x, g, dy)
    torch.cuda.synchronize()
    assert rmsnorm_bwd_cuda.launches == before + 1
    assert dx.dtype == dt and dx.shape == x.shape and dg.dtype == dt and dg.shape == g.shape
    want_dx, want_dg = rmsnorm_bwd_ref(x.float(), g.float(), dy.float())
    torch.testing.assert_close(dx.float(), want_dx, **TOL[dtype])
    torch.testing.assert_close(dg.float(), want_dg, **TOL[dtype])
    for _ in range(3):
        again = rmsnorm_bwd_cuda(x, g, dy)
        assert torch.equal(again[0], dx) and torch.equal(again[1], dg)


# explicit plans: the widest rows (bf16 D 16384, float32 8192, a row a block)
# with one block a CTA and with many, one reducer and the most; blocks of 4
# rows, 18 and a short one a CTA; blocks of 2 rows at 2 vectors a thread,
# the last CTA short or empty; a reducer past the columns
RMSNORM_BWD_PLANS = [
    ((64, 16384), "bfloat16", RMSNormBwdPlan(ctas=64, rows_per_cta=1, block=1, nv=8, reducers=64)),
    ((64, 16384), "bfloat16", RMSNormBwdPlan(ctas=16, rows_per_cta=4, block=1, nv=8, reducers=1)),
    ((40, 8192), "float32", RMSNormBwdPlan(ctas=40, rows_per_cta=1, block=1, nv=8, reducers=8)),
    ((40, 8192), "float32", RMSNormBwdPlan(ctas=8, rows_per_cta=5, block=1, nv=8, reducers=8)),
    ((600, 768), "bfloat16", RMSNormBwdPlan(ctas=8, rows_per_cta=75, block=4, nv=1, reducers=5)),
    ((500, 2560), "bfloat16", RMSNormBwdPlan(ctas=16, rows_per_cta=32, block=2, nv=2, reducers=16)),
    ((41, 4096), "bfloat16", RMSNormBwdPlan(ctas=8, rows_per_cta=6, block=2, nv=2, reducers=8)),
    ((48, 64), "float32", RMSNormBwdPlan(ctas=12, rows_per_cta=4, block=4, nv=1, reducers=12)),
]


@pytest.mark.parametrize("shape,dtype,plan", RMSNORM_BWD_PLANS)
def test_rmsnorm_bwd_kernel_under_explicit_plans(cuda, shape, dtype, plan):
    dt = DTYPES[dtype]
    x = _randn(shape, dt, cuda, 26)
    g = _randn(shape[-1:], dt, cuda, 27) * 0.2
    dy = _randn(shape, dt, cuda, 28)
    dx, dg = rmsnorm_bwd_cuda(x, g, dy, plan=plan)
    want_dx, want_dg = rmsnorm_bwd_ref(x.float(), g.float(), dy.float())
    torch.testing.assert_close(dx.float(), want_dx, **TOL[dtype])
    torch.testing.assert_close(dg.float(), want_dg, **TOL[dtype])
    again = rmsnorm_bwd_cuda(x, g, dy, plan=plan)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dg)


def test_rmsnorm_bwd_refuses_plans_that_do_not_fit_or_miss_rows(cuda):
    x = torch.zeros(64, 16384, dtype=torch.bfloat16, device=cuda)
    g = torch.zeros(16384, dtype=torch.bfloat16, device=cuda)
    plan = RMSNormBwdPlan(ctas=16, rows_per_cta=4, block=1, nv=8, reducers=16)
    for bad in (dict(rows_per_cta=3),   # 48 of the 64 rows
                dict(block=2),          # 16 vectors a thread a block
                dict(nv=4),             # 512 threads a row
                dict(reducers=0),
                dict(reducers=17)):     # more reducers than CTAs
        with pytest.raises(RuntimeError, match="CUDA error"):
            rmsnorm_bwd_cuda(x, g, x, plan=dataclasses.replace(plan, **bad))


def test_rmsnorm_bwd_makes_one_launch_and_leaves_its_tickets_at_zero(cuda):
    """One device kernel a call, no memset; both tickets (the CTAs done, the
    reducers past their wait) are back at 0 after it, on each stream."""
    x = _randn((2048, 1152), torch.bfloat16, cuda, 29)
    g = _randn((1152,), torch.bfloat16, cuda, 30) * 0.2
    dy = _randn((2048, 1152), torch.bfloat16, cuda, 31)
    rmsnorm_bwd_cuda(x, g, dy)  # the stream's workspace is made (and zeroed) once
    torch.cuda.synchronize()
    kernels = []
    for _ in range(3):  # the profiler may drop a record; it never adds one
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            rmsnorm_bwd_cuda(x, g, dy)
            torch.cuda.synchronize()
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if kernels:
            break
    assert len(kernels) == 1 and "rmsnorm_bwd_kernel" in kernels[0][0] and kernels[0][1] == 1
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        rmsnorm_bwd_cuda(x, g, dy)
    torch.cuda.synchronize()
    for s in (torch.cuda.current_stream(), stream):
        _, tickets = rmsnorm_bwd_workspace(x.device, s.cuda_stream)
        assert tickets.tolist() == [0, 0]


def test_rmsnorm_autograd_on_the_card_goes_through_both_kernels(cuda):
    from repro_torch.kernels import ops

    x = _randn((2, 16, 1152), torch.bfloat16, cuda, 23).requires_grad_(True)
    g = (_randn((1152,), torch.bfloat16, cuda, 24) * 0.2).requires_grad_(True)
    dy = _randn((2, 16, 1152), torch.bfloat16, cuda, 25)
    before = (rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches)
    y = ops.rmsnorm(x, g)
    assert y.grad_fn is not None
    y.backward(dy)
    assert (rmsnorm_cuda.launches - before[0], rmsnorm_bwd_cuda.launches - before[1]) == (1, 1)
    want = rmsnorm_bwd_cuda(x.detach(), g.detach(), dy)
    assert torch.equal(x.grad, want[0]) and torch.equal(g.grad, want[1])
    with torch.no_grad():  # the serve paths: the forward kernel alone, no graph
        assert ops.rmsnorm(x, g).grad_fn is None


@pytest.mark.parametrize("arch", ["gemma3-1b", "xlstm-125m", "zamba2-2.7b", "minicpm3-4b",
                                  "olmoe-1b-7b"])
def test_reduced_model_gradients_on_the_card_match_the_cpu(cuda, arch):
    """float32: the same ops, sums in other orders (cuBLAS, the kernels);
    each gradient within 1e-4 of its tensor's largest entry."""

    cfg = reduced(get_config(arch)).with_(param_dtype=torch.float32)
    gpu = Model(cfg).init(torch.Generator().manual_seed(1))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)))
    losses = {}
    before = rmsnorm_bwd_cuda.launches
    for name, model in (("gpu", gpu), ("cpu", cpu)):
        model.requires_grad_(True)
        loss, _ = model.loss_fn(toks.to(model.device))
        loss.backward()
        losses[name] = loss.item()
    assert rmsnorm_bwd_cuda.launches - before == decode_launches(cfg)["rmsnorm"]
    assert abs(losses["gpu"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
    grads = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        want = grads[name].grad
        scale = max(want.abs().max().item(), 1e-6)
        torch.testing.assert_close(p.grad.cpu() / scale, want / scale, rtol=1e-4, atol=1e-4,
                                   msg=name)


def test_vector_engine_on_the_card_equals_the_host_engines(cuda):
    """The Table 1 sweep (SPIN and SYNCMON, flag delays 0-40 us and per peer,
    no perturbation and two peers delayed): the vector engine's tensors on the
    card give the event engine's report on the host, apart from the
    engine-specific fields (the name, head polls, the closed-form monitor
    stats, the wall), and the CPU vector engine's, apart from the wall."""
    import dataclasses

    from repro_torch.core import EngineKind, PeerDelayPerturb, SimConfig, SyncPolicy
    from repro_torch.core import run_gemv_allreduce

    def fields(report, drop):
        d = dataclasses.asdict(report)
        for k in drop:
            d.pop(k)
        return d

    engine_specific = ("engine", "wall_time_s", "wtt_head_polls", "monitor_stats")
    for sync in SyncPolicy:
        for delay in (0.0, 5_000.0, 20_000.0, 40_000.0, [0.0, 12_500.0, 40_000.0]):
            for perturb in (None, PeerDelayPerturb({2: 25_000, 3: 25_000})):
                run = {(eng, dev): run_gemv_allreduce(SimConfig(sync=sync, engine=eng), delay,
                                                      perturb=perturb, device=dev)
                       for eng, dev in ((EngineKind.VECTOR, cuda), (EngineKind.VECTOR, "cpu"),
                                        (EngineKind.EVENT, "cpu"))}
                card = run[(EngineKind.VECTOR, cuda)]
                assert fields(card, ("wall_time_s",)) == \
                    fields(run[(EngineKind.VECTOR, "cpu")], ("wall_time_s",))
                assert fields(card, engine_specific) == \
                    fields(run[(EngineKind.EVENT, "cpu")], engine_specific)
                assert card.nonflag_reads == 65_792 and type(card.flag_reads) is int


# (L, R, x 8 bytes past a 16-byte boundary, the launch plan): every plan,
# odd R, L past a tile's depth (wide 256 rows, narrow 4,096 / R rounded down
# to even), the tiny plan's edge (16 rows) and L = 1
ORDERED_SCAN_CASES = {
    "wide_bulk": (2049, 4096, False, ("wide", 16)),
    "wide_bulk_tall": (4096, 256, False, ("wide", 16)),
    "wide_bulk_strip_edge": (300, 18, False, ("wide", 16)),
    "wide_8_odd": (257, 4097, False, ("wide", 8)),
    "wide_8_unaligned": (300, 256, True, ("wide", 8)),
    "wide_8_strip_edge": (129, 17, False, ("wide", 8)),
    "narrow_16_odd": (1000, 5, False, ("narrow", 16)),
    "narrow_8_unaligned": (3000, 3, True, ("narrow", 8)),
    "narrow_widest": (4097, 15, False, ("narrow", 16)),
    "narrow_tall": (100_000, 1, False, ("narrow", 16)),
    "narrow_17_rows": (17, 2, False, ("narrow", 16)),
    "tiny_16_rows_odd": (16, 5, True, ("tiny", 8)),
    "tiny_one_row": (1, 1, False, ("tiny", 8)),
    "tiny_one_row_wide": (1, 4097, False, ("tiny", 8)),
}


@pytest.mark.parametrize("case", sorted(ORDERED_SCAN_CASES))
@pytest.mark.parametrize("entry", ["ordered_scan", "ordered_total"])
def test_ordered_scan_kernel_adds_in_order(cuda, entry, case):
    """Each column added in order: bit for bit np.add.accumulate (the whole
    scan, or its last row) on columns where any other order gives another
    result, and the plain version on the card, with -0.0, inf and NaN in
    some columns (a NaN compared as NaN); one launch a call.  The control, a
    pairwise order (numpy's sum of each column), is rejected wherever
    L >= 64."""
    from repro_torch.kernels import ordered_scan as mod

    L, R, unaligned, plan = ORDERED_SCAN_CASES[case]
    rng = np.random.default_rng(sorted(ORDERED_SCAN_CASES).index(case))
    x = rng.standard_normal((L, R))
    x[0::4] += 1e16
    x[1::4] = 1.0
    x[2::4] -= 1e16
    special = rng.random(x.shape) < 0.001
    x[special] = rng.choice([-0.0, np.inf, -np.inf, np.nan], int(special.sum()))
    x[:, 0] = -0.0  # a column of -0.0 sums to -0.0 only if row 0 is copied
    with np.errstate(invalid="ignore"):
        want = np.add.accumulate(x, axis=0)
    flat = torch.from_numpy(np.concatenate(([0.0], x.ravel()))).to(cuda)
    xd = (flat[1:] if unaligned else flat[1:].clone()).view(L, R)
    assert mod.ordered_scan_plan(L, R, xd.data_ptr() % 16 == 0) == plan
    kernel = getattr(mod, f"{entry}_cuda")
    before = mod.ordered_scan_cuda.launches, mod.ordered_scan_cuda.by_shape[entry, L, R]
    got = kernel(xd)
    torch.cuda.synchronize()
    assert (mod.ordered_scan_cuda.launches, mod.ordered_scan_cuda.by_shape[entry, L, R]) == \
        (before[0] + 1, before[1] + 1)
    if entry == "ordered_total":
        want = want[-1]
    assert got.shape == want.shape
    finite = ~np.isnan(want)
    assert _same_bits(got.cpu()[torch.from_numpy(finite)], torch.from_numpy(want[finite]))
    assert np.isnan(got.cpu().numpy()[~finite]).all()
    if L <= 4096:  # the plain version launches a kernel a row
        # a NaN's payload is the add's choice (torch's add on the card may
        # pick the other operand's): equal bits elsewhere, NaN where it is
        plain = getattr(mod, f"{entry}_ref")(xd)
        nan = torch.isnan(plain)
        assert torch.equal(torch.isnan(got), nan) and _same_bits(got[~nan], plain[~nan])
    if L >= 64:
        with np.errstate(invalid="ignore"):
            pairwise = np.ascontiguousarray(x.T).sum(axis=1)
        keep = ~np.isnan(pairwise) & ~np.isnan(want[-1] if want.ndim == 2 else want)
        last = (want[-1] if want.ndim == 2 else want)[keep]
        assert not np.array_equal(pairwise[keep].view(np.int64), last.view(np.int64))


@pytest.mark.parametrize("name", ["ring_allreduce", "all_to_all"])
def test_flat_lockstep_solver_on_the_card_equals_the_cpu(cuda, name):
    """256 ranks closed-loop on the flat ring: the solver's tensors on the
    card give the CPU solver's report on every field but the walls, and the
    card run launches the ordered scan."""
    import dataclasses

    from repro_torch.core import EngineKind, SimConfig, simulate
    from repro_torch.kernels.ordered_scan import ordered_scan_cuda

    def fields(report):
        d = dataclasses.asdict(report)
        d.pop("wall_time_s")
        d["meta"].pop("wall_breakdown")
        d["meta"]["program_stats"].pop("construct_wall_s")
        return d

    cfg = SimConfig(engine=EngineKind.EVENT, workgroups=64)
    reports = {}
    for dev in ("cpu", cuda):
        before = ordered_scan_cuda.launches
        reports[str(dev)] = simulate(name, cfg, devices=256, closed_loop=True,
                                     collect_segments=False, device=dev)
        launched = ordered_scan_cuda.launches - before
        assert (launched > 0) == (dev == cuda)
    assert reports["cuda"].meta["lockstep_reason"] == "engaged"
    assert fields(reports["cuda"]) == fields(reports["cpu"])


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit: ``torch.equal`` takes -0.0 for +0.0."""
    return got.shape == want.shape and torch.equal(got.cpu().view(torch.int64),
                                                   want.cpu().view(torch.int64))


def _port_chain_ready(rng, kind: str, k: int, ser: float, b0: float) -> np.ndarray:
    """``k`` ready times of one port in queue order: ``restarts`` every touch
    after the port drained, ``busy`` every touch waiting, ``ties`` every
    touch ready exactly when the port frees, ``mixed`` busy runs with
    restarts between (arrivals a little faster than the port drains)."""
    if kind == "restarts":
        return b0 + np.cumsum(ser + 0.5 + rng.random(k))
    if kind == "busy":
        return np.zeros(k)
    if kind == "ties":
        r, b = np.empty(k), b0
        for t in range(k):
            r[t] = b
            b = max(r[t], b) + ser
        return r
    return np.sort(rng.random(k)) * (0.9 * k) * ser


KINDS = ("restarts", "busy", "ties", "mixed")
# (lengths, kinds) of one launch each
PORT_CHAIN_CASES = {
    # one node's up port at 4,096 devices on fat_tree (65,280) and a few short
    "solver_lengths": ([65_280, 1, 7, 300, 4_080], ("mixed",)),
    # a dependency level, cut short: lengths far apart in one launch
    "level": ([4_088, 2_044, 1, 0, 3, 7, 255, 256, 257, *range(13, 4_000, 61)], KINDS),
    # the 256-touch tiles' edges and one touch either side
    "tile_edges": ([255, 256, 257, 511, 512, 513, 767, 768, 769, 1_023, 1_024, 1_025], KINDS),
    "all_restarts": ([1, 8, 255, 256, 257, 1_000, 3_001, 4_096], ("restarts",)),
    "all_busy": ([1, 8, 255, 256, 257, 1_000, 3_001, 4_096], ("busy",)),
    "ties": ([1, 8, 255, 256, 257, 1_000, 3_001, 4_096], ("ties",)),
    "short": ([n % 8 for n in range(200)], KINDS),
    "one_segment": ([20_000], ("mixed",)),
    "wide": ([n * 7 % 41 for n in range(4_096)], KINDS),
}


@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("case", sorted(PORT_CHAIN_CASES))
def test_port_chain_kernel_equals_its_plain_version(cuda, case, unaligned):
    """One launch over segments of the solver's shapes, cut short, and of
    every kind of chain: the kernel's starts, busy and queued times bit for
    bit the plain version's.  ``unaligned``: the ready times start 8 bytes
    past a 16-byte boundary, so the tiles' copies split at the edges."""
    from repro_torch.kernels.port_chain import port_chain_cuda, port_chain_ref

    lens, kinds = PORT_CHAIN_CASES[case]
    rng = np.random.default_rng(sorted(PORT_CHAIN_CASES).index(case))
    S = len(lens)
    ser = 0.5 + rng.random(S)
    port = rng.permutation(2 * S)[:S]
    busy0, qd0 = rng.random(2 * S), rng.random(2 * S)
    rdy = np.concatenate([[0.0]] + [
        _port_chain_ready(rng, kinds[i % len(kinds)], k, ser[i], busy0[port[i]])
        for i, k in enumerate(lens)])
    offs = torch.tensor(np.concatenate(([0], np.cumsum(lens))))
    runs = {}
    for dev in ("cpu", cuda):
        ready = torch.from_numpy(rdy).to(dev)
        ready = ready[1:] if unaligned else ready[1:].clone()
        busy, qd = torch.from_numpy(busy0.copy()).to(dev), torch.from_numpy(qd0.copy()).to(dev)
        fn = port_chain_cuda if dev == cuda else port_chain_ref
        before = port_chain_cuda.launches
        starts = fn(ready, offs.to(dev), torch.from_numpy(port).to(dev),
                    torch.from_numpy(ser).to(dev), busy, qd)
        torch.cuda.synchronize()
        assert port_chain_cuda.launches - before == (1 if dev == cuda else 0)
        runs[str(dev)] = (starts, busy, qd)
    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert _same_bits(got, want)


def _sum_values(rng, n: int) -> np.ndarray:
    """Magnitudes over eight decades: any other order of the adds shows."""
    return rng.random(n) * 10.0 ** rng.integers(-4, 4, n)


LEAF_EDGES = [127, 128, 129, 135, 136]
# (lengths, segments of -0.0) of one launch each
NUMPY_SUM_CASES = {
    "lengths_1_to_8193": ([*range(1, 300), 1000, 4095, 4096, 4097, 8191, 8192, 8193, 65_280],
                          ()),
    # a dependency level, cut short: lengths far apart in one launch, the
    # blocks' edges and one element either side, 130,048 (16 blocks)
    "level": ([0, 1, 7, 8, *LEAF_EDGES, 4_088, 8_191, 8_192, 8_193, 16_383, 16_384, 16_385,
               24_577, 65_280, 130_048, *range(3, 20_000, 97)], ()),
    "leaves": ([*LEAF_EDGES, *(8_192 + n for n in LEAF_EDGES),
                *(16_384 + n for n in LEAF_EDGES)], ()),
    "short": ([n % 8 for n in range(10_000)], ()),
    "negative_zero": ([1, 5, 8, 136, 9_000, 3, 200], (0, 1, 2, 3, 4)),
    "one_segment": ([130_048], ()),
    "wide": ([n * 37 % 5_003 for n in range(4_096)], ()),
    "empty_ends": ([0, 0, 9_000, 0, 17, 0, 0], ()),
}


@pytest.mark.parametrize("case", sorted(NUMPY_SUM_CASES))
def test_numpy_sum_kernel_equals_np_sum(cuda, case):
    """One launch over segments of the solver's shapes, cut short, and at
    every edge of numpy's tree: the plain version's sums bit for bit, twice
    (the tickets reset themselves), the tickets left at 0; numpy's own where
    a segment is one tree.  Above 8,192 elements only numpy before 2.3 cuts
    the sum into 8,192-element blocks, as the reference's numpy does; the
    CPU tests hold the plain version to it there."""
    from repro_torch.kernels.numpy_sum import (BLOCK, numpy_sum_cuda, numpy_sum_plan,
                                               numpy_sum_ref, numpy_sum_workspace)

    lens, neg = NUMPY_SUM_CASES[case]
    rng = np.random.default_rng(sorted(NUMPY_SUM_CASES).index(case) + 6)
    xs = [np.full(k, -0.0) if i in neg else _sum_values(rng, k) for i, k in enumerate(lens)]
    x = torch.from_numpy(np.concatenate(xs))
    offs = torch.tensor(np.concatenate(([0], np.cumsum(lens))))
    before = numpy_sum_cuda.launches
    got = [numpy_sum_cuda(x.to(cuda), offs.to(cuda)) for _ in range(2)]
    torch.cuda.synchronize()
    assert numpy_sum_cuda.launches == before + 2
    want = numpy_sum_ref(x, offs)
    assert _same_bits(got[0], want) and _same_bits(got[1], want)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    tickets = numpy_sum_workspace(got[0].device, stream,
                                  numpy_sum_plan(len(lens), x.numel()).windows)[1]
    assert int(tickets.count_nonzero()) == 0
    one_tree = [i for i, k in enumerate(lens) if k <= BLOCK]
    assert _same_bits(got[0][one_tree], torch.tensor([np.sum(xs[i]) for i in one_tree]))
    if neg:
        assert _same_bits(got[0][list(neg)], torch.zeros(len(neg), dtype=torch.float64))


@pytest.mark.parametrize("name", ["ring_allreduce", "all_to_all", "hierarchical_allreduce"])
@pytest.mark.parametrize("fabric", ["two_tier", "fat_tree", "rail_optimized"])
def test_tiered_lockstep_solver_on_the_card_equals_the_cpu(cuda, name, fabric):
    """12 ranks, 4 a node: the tiered solver's tensors on the card give the
    CPU solver's report on every field but the walls, and the card run
    launches the port chain, numpy's sum and the ordered scan."""
    import dataclasses

    from repro_torch.core import EngineKind, SimConfig, simulate
    from repro_torch.kernels.numpy_sum import numpy_sum_cuda
    from repro_torch.kernels.ordered_scan import ordered_scan_cuda
    from repro_torch.kernels.port_chain import port_chain_cuda

    def fields(report):
        d = dataclasses.asdict(report)
        d.pop("wall_time_s")
        d["meta"].pop("wall_breakdown")
        d["meta"]["program_stats"].pop("construct_wall_s")
        return d

    cfg = SimConfig(engine=EngineKind.EVENT, workgroups=64)
    kernels = (port_chain_cuda, numpy_sum_cuda, ordered_scan_cuda)
    reports = {}
    for dev in ("cpu", cuda):
        before = [k.launches for k in kernels]
        reports[str(dev)] = simulate(name, cfg, devices=12, devices_per_node=4, fabric=fabric,
                                     closed_loop=True, collect_segments=False, device=dev)
        launched = [k.launches - b for k, b in zip(kernels, before)]
        assert all((n > 0) == (dev == cuda) for n in launched[1:])
    assert reports["cuda"].meta["lockstep_reason"] == "engaged"
    assert fields(reports["cuda"]) == fields(reports["cpu"])
