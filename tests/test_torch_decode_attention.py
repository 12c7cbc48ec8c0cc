"""The split-S plan of ``decode_attention`` and its combine, on the CPU.

``decode_attention_plan`` is pure, so its chunks are checked here at the
gemma3-1b serve shapes and at the CUDA tests' sweep shapes.  The kernel's
algebra (each chunk's max, sum and unnormalised accumulator, combined in
chunk order) is ``decode_attention_split_ref`` in plain PyTorch; it is held
against the reference's Pallas kernel in interpret mode (``repro.kernels.ops``)
with the reference's tolerances, 3e-5 in float32 and 3e-2 in bf16, with
ragged last chunks.  The CUDA kernel itself is held against the plain version
on the card, in tests/test_torch_cuda.py.

The sequence-parallel decode cuts S over ranks: each slice's partial output
and log-sum-exp (``decode_attention_partial_ref``), joined in rank order by
``combine_partials``, equal the whole attention (``decode_attention_ref``)
and the Pallas kernel within 3e-5 in float32, slices with no valid slot
included; the plan takes such a slice (length 0, one split); and a combine
that exponentiates before it subtracts the largest log-sum-exp, or takes
that largest over empty slices' ``-inf``, gives NaN where
``combine_partials`` does not, and the same check rejects it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels.decode_attention import (
    BLOCK_BYTES,
    CTAS_PER_SM,
    MAX_BLOCK,
    MIN_CHUNK,
    PLAN_CHUNK,
    DecodeAttentionPlan,
    combine_partials,
    decode_attention_partial_ref,
    decode_attention_plan,
    decode_attention_ref,
    decode_attention_split_ref,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=3e-5, atol=3e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}

# (B, H, KV, D, S, length): the serve path's and tests/test_torch_cuda.py's sweep
SWEEP = [
    (4, 4, 1, 256, 512, 1), (4, 4, 1, 256, 512, 300), (4, 4, 1, 256, 512, 512),
    (4, 4, 1, 256, 544, 1), (4, 4, 1, 256, 544, 300), (4, 4, 1, 256, 544, 512),
    (4, 4, 1, 256, 544, 544),
    (2, 8, 2, 64, 1024, 1017), (2, 8, 8, 32, 768, 761), (2, 4, 1, 16, 48, 40),
    (2, 4, 2, 32, 100, 77), (1, 6, 2, 64, 150, 150), (2, 8, 1, 64, 200, 130),
    (1, 16, 1, 128, 300, 299),
    # the head layouts the kernels phase times (B 4, S 1024): gemma3-27b,
    # qwen2-vl-7b, kimi-k2
    (4, 32, 16, 128, 1024, 1024), (4, 28, 4, 128, 1024, 1024), (4, 64, 8, 112, 1024, 1024),
]


def _chunks(plan: DecodeAttentionPlan, length: int):
    return [(i * plan.chunk, min((i + 1) * plan.chunk, length)) for i in range(plan.splits)]


@pytest.mark.parametrize("B,H,KV,D,S,length", SWEEP)
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("sms", [132, 114, 264, 528, 8])  # H100 SXM, H100 PCIe, and more or less
def test_plan_chunks_cover_the_prefix_once_within_one_wave(B, H, KV, D, S, length, itemsize, sms):
    valid = min(length, S)
    plan = decode_attention_plan(B, KV, H // KV, D, itemsize, valid, sms)
    chunks = _chunks(plan, valid)
    assert chunks[0][0] == 0 and chunks[-1][1] == valid
    assert all(lo < hi for lo, hi in chunks)  # no empty chunk
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))  # contiguous, no overlap
    assert plan.chunk >= MIN_CHUNK and plan.chunk % MIN_CHUNK == 0
    assert plan.ctas(B, KV) <= max(B * KV, CTAS_PER_SM * sms)  # at most one wave
    if valid <= plan.chunk or B * KV >= CTAS_PER_SM * sms:
        assert plan.splits == 1
    assert 1 <= plan.block <= min(plan.chunk, MAX_BLOCK)
    assert plan.block == MIN_CHUNK or 2 * plan.block * D * itemsize <= BLOCK_BYTES
    if plan.splits > 1 and plan.chunk > PLAN_CHUNK:  # no smaller chunk stays in the wave
        smaller = -(-valid // (plan.chunk - MIN_CHUNK))
        assert B * KV * smaller > CTAS_PER_SM * sms or smaller > 256


def test_plan_at_every_serve_step():
    # the global layers see length = pos + 1 <= 544; the local ones min(pos + 1, 512)
    for length in range(1, 545):
        plan = decode_attention_plan(4, 1, 4, 256, 2, length, 132)
        assert plan.chunk == PLAN_CHUNK and plan.ctas(4, 1) <= CTAS_PER_SM * 132
        assert (plan.splits - 1) * plan.chunk < length <= plan.splits * plan.chunk


def test_plan_at_the_serve_shape():
    assert decode_attention_plan(4, 1, 4, 256, 2, 544, 132) == DecodeAttentionPlan(32, 17, 32)
    assert decode_attention_plan(4, 1, 4, 256, 2, 512, 132) == DecodeAttentionPlan(32, 16, 32)
    # qwen2-vl-7b's heads at B 4, S 1024: 16 (b, kv head) rows, 16 chunks of 64
    assert decode_attention_plan(4, 4, 7, 128, 2, 1024, 132) == DecodeAttentionPlan(64, 16, 64)
    assert decode_attention_plan(4, 1, 4, 256, 2, 544, 132, chunk=128) == DecodeAttentionPlan(
        128, 5, 64)  # two staged blocks of 64 slots a chunk: 64 KB of K and V
    assert decode_attention_plan(4, 1, 4, 256, 2, 16, 132).splits == 1


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 16"):
        decode_attention_plan(4, 1, 4, 256, 2, 544, 132, chunk=24)
    with pytest.raises(ValueError, match="rep <= 16"):
        decode_attention_plan(1, 1, 17, 64, 2, 10, 132)
    with pytest.raises(ValueError, match="does not cover"):
        DecodeAttentionPlan(chunk=16, splits=2, block=16).check(33)
    with pytest.raises(ValueError, match="does not cover"):  # an empty last chunk
        DecodeAttentionPlan(chunk=16, splits=3, block=16).check(32)
    with pytest.raises(ValueError, match="does not cover"):
        DecodeAttentionPlan(chunk=256, splits=1, block=256).check(200)


def _qkv(seed, B, H, KV, D, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32))


@pytest.mark.parametrize("B,H,KV,D,S,length,bs,chunk", [
    (2, 8, 2, 64, 1024, 1017, 256, 48),    # ragged: 21 chunks of 48, the last 9
    (2, 8, 2, 64, 1024, 1017, 256, 16),    # 64 chunks, the last 9
    (2, 8, 2, 64, 1024, 1017, 256, 1024),  # one split
    (2, 8, 8, 32, 768, 761, 256, None),    # the default plan
    (1, 16, 1, 128, 512, 300, 128, 112),   # rep 16, the last chunk 76
    (4, 4, 1, 256, 544, 544, 32, None),    # the serve path's global layers: 17 x 32
    (4, 4, 1, 256, 544, 300, 32, 64),      # 300 = 4 x 64 + 44
    (2, 4, 1, 32, 64, 1, 64, 16),          # length 1
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_combine_matches_pallas(B, H, KV, D, S, length, bs, chunk, dtype):
    q, k, v = _qkv(7, B, H, KV, D, S)
    jd, td = DTYPES[dtype]
    plan = decode_attention_plan(B, KV, H // KV, D, 2 if dtype == "bfloat16" else 4,
                                 min(length, S), 132, chunk=chunk)
    assert chunk is None or plan.chunk == chunk
    o_pallas = jops.decode_attention(jnp.asarray(q).astype(jd), jnp.asarray(k).astype(jd),
                                     jnp.asarray(v).astype(jd), jnp.int32(length), bs=bs)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    o_split = decode_attention_split_ref(tq, tk, tv, length, plan)
    assert o_split.dtype == td and o_split.shape == (B, H, D)
    np.testing.assert_allclose(o_split.float().numpy(), np.asarray(o_pallas, np.float32),
                               **TOL[dtype])


def test_split_combine_ignores_slots_beyond_length():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 1, 4, 1, 32, 256))
    plan = decode_attention_plan(1, 1, 4, 32, 4, 100, 132, chunk=16)  # 7 chunks, the last 4
    o = decode_attention_split_ref(q, k, v, 100, plan)
    k[:, 100:], v[:, 100:] = 99.0, -99.0
    assert torch.equal(decode_attention_split_ref(q, k, v, 100, plan), o)
    torch.testing.assert_close(o, decode_attention_ref(q, k, v, 100), rtol=3e-5, atol=3e-5)


def _slices(q, k, v, length, R):
    """Each of R consecutive slices of S: its partial (o, lse) over the part
    of the valid prefix it holds, and that part's length."""
    L = k.shape[1] // R
    parts = []
    for r in range(R):
        n = min(max(length - r * L, 0), L)
        parts.append((*decode_attention_partial_ref(q, k[:, r * L:(r + 1) * L],
                                                    v[:, r * L:(r + 1) * L], n), n))
    return parts


@pytest.mark.parametrize("B,H,KV,D,S,length", [
    (4, 4, 1, 256, 544, 544), (4, 4, 1, 256, 544, 200), (4, 4, 1, 256, 544, 1),
    (4, 16, 16, 128, 544, 300), (2, 8, 2, 64, 1024, 1017), (1, 4, 1, 16, 16, 5),
])
@pytest.mark.parametrize("R", [2, 4])
def test_partial_slices_combined_equal_the_whole(B, H, KV, D, S, length, R):
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, B, H, KV, D, S))
    parts = _slices(q, k, v, length, R)
    assert any(n == 0 for *_, n in parts) == (length <= (R - 1) * S // R)
    for o, lse, n in parts:
        assert o.dtype == lse.dtype == torch.float32 and lse.shape == (B, H)
        if n == 0:
            assert torch.equal(o, torch.zeros_like(o)) and (lse < -1e38).all()
    got = combine_partials(torch.stack([o for o, _, _ in parts]),
                           torch.stack([lse for _, lse, _ in parts]))
    torch.testing.assert_close(got, decode_attention_ref(q, k, v, length), **TOL["float32"])
    o_pallas = jops.decode_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                     jnp.int32(length), bs=S // R if (S // R) % 8 == 0 else S)
    np.testing.assert_allclose(got.numpy(), np.asarray(o_pallas), **TOL["float32"])
    # rank order: the same bits on every run
    again = combine_partials(torch.stack([o for o, _, _ in parts]),
                             torch.stack([lse for _, lse, _ in parts]))
    assert torch.equal(again, got)


def test_plan_and_check_take_a_slice_with_no_valid_slot():
    plan = decode_attention_plan(4, 1, 4, 256, 2, 0, 132)
    assert plan.splits == 1 and plan.chunk >= MIN_CHUNK
    plan.check(0)
    DecodeAttentionPlan(chunk=16, splits=1, block=16).check(0)
    with pytest.raises(ValueError, match="does not cover"):
        DecodeAttentionPlan(chunk=16, splits=2, block=16).check(0)
    with pytest.raises(ValueError, match="does not cover"):
        DecodeAttentionPlan(chunk=16, splits=1, block=16).check(-1)
    with pytest.raises(ValueError, match="positive sizes"):
        decode_attention_plan(4, 1, 4, 256, 2, -1, 132)


def _exp_first(os, lses):
    """A faulty control: e^lse before any subtraction (it overflows)."""
    w = torch.exp(lses)
    return (w[..., None] * os).sum(dim=0) / w.sum(dim=0)[..., None]


def _max_over_every_slice(os, lses):
    """A faulty control: M over every slice, an empty one's -inf included."""
    w = torch.exp(lses - lses.amax(dim=0))
    return (w[..., None] * os).sum(dim=0) / w.sum(dim=0)[..., None]


def test_combine_rejects_a_nan_producing_order():
    q, k, v = (torch.from_numpy(a) for a in _qkv(10, 2, 4, 1, 64, 64))
    q = q * 64.0  # scores above 88: e^lse overflows float32
    parts = _slices(q, k, v, 40, 4)
    os = torch.stack([o for o, _, _ in parts])
    lses = torch.stack([lse for _, lse, _ in parts])
    want = decode_attention_ref(q, k, v, 40)
    assert lses.max() > 100
    torch.testing.assert_close(combine_partials(os, lses), want, **TOL["float32"])
    bad = _exp_first(os, lses)
    assert torch.isnan(bad).any()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(bad, want, **TOL["float32"])
    # a row whose slices are all empty, their lse -inf: 0, not NaN
    empty_os = torch.zeros(3, 2, 4, 64)
    empty_lses = torch.full((3, 2, 4), -float("inf"))
    assert torch.isnan(_max_over_every_slice(empty_os, empty_lses)).all()
    assert torch.equal(combine_partials(empty_os, empty_lses), torch.zeros(2, 4, 64))
    # -inf for the empty slice beside valid ones gives the same as -2e38
    inf_lses = torch.where(lses < -1e38, -float("inf"), lses)
    assert torch.equal(combine_partials(os, inf_lses), combine_partials(os, lses))
