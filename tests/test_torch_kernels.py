"""The port's plain kernel versions against the reference's Pallas kernels.

Inputs come from a seeded numpy Generator and go through
``repro.kernels.ops`` (Pallas in interpret mode, as tests/test_kernels.py
runs it) and through ``repro_torch.kernels.ref``, with the reference's
tolerances: 3e-5 in float32, 3e-2 in bf16 (both sides round the same float32
inputs to bf16, then compute in float32 and round the output).  The CUDA
kernels themselves are compared with these plain versions on the card, in
tests/test_torch_cuda.py.

The rmsnorm backward replaces no Pallas kernel: ``rmsnorm_bwd_ref`` is held
against ``jax.vjp`` of the function the reference's training differentiates,
``repro.models.common.rms_norm``, with the same tolerances (in bf16 both
sides round the float32 gradients once, to bf16), and against autograd of
``rmsnorm_ref`` in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.common import rms_norm as jrms_norm
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.rmsnorm import (BWD_BLOCK_VECTORS, BWD_BLOCKS, BWD_REDUCERS,
                                         RMSNormFunction, rmsnorm_bwd_cuda, rmsnorm_bwd_plan,
                                         rmsnorm_bwd_ref, rmsnorm_cuda, rmsnorm_plan)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype_name):
    return dict(rtol=3e-2, atol=3e-2) if dtype_name == "bfloat16" else dict(
        rtol=3e-5, atol=3e-5
    )


def _pair(a: np.ndarray, dtype_name: str):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(seed, B, H, KV, D, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32))


@pytest.mark.parametrize("B,H,KV,D,S", [(1, 4, 1, 32, 512), (2, 8, 2, 64, 1024),
                                        (2, 8, 8, 32, 768)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_ref_matches_pallas(B, H, KV, D, S, dtype):
    q, k, v = _qkv(0, B, H, KV, D, S)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    length = S - 7
    o_pallas = jops.decode_attention(jq, jk, jv, jnp.int32(length), bs=256)
    o_port = ref.decode_attention_ref(tq, tk, tv, length)
    assert o_port.dtype == DTYPES[dtype][1] and o_port.shape == (B, H, D)
    np.testing.assert_allclose(_np(o_port), _np(o_pallas), **_tol(dtype))


def test_decode_attention_ref_respects_length_mask():
    B, H, KV, D, S = 1, 2, 1, 16, 256
    q, k, v = _qkv(1, B, H, KV, D, S)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o_small = ops.decode_attention(tq, tk, tv, 10)
    # garbage beyond the length must not affect the result
    k2, v2 = tk.clone(), tv.clone()
    k2[:, 10:] = 99.0
    v2[:, 10:] = -99.0
    o_small2 = ops.decode_attention(tq, k2, v2, 10)
    np.testing.assert_allclose(_np(o_small), _np(o_small2), rtol=1e-6, atol=1e-6)
    o_pallas = jops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.int32(10), bs=64)
    np.testing.assert_allclose(_np(o_small2), _np(o_pallas), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("length", [1, 300, 512, 544])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_ref_ragged_cache(length, dtype):
    """S = 544 (the gemma3-1b serve path's global layers) is no multiple of the
    Pallas block, which refuses it; the jnp oracle takes it."""
    B, H, KV, D, S = 2, 4, 1, 32, 544
    q, k, v = _qkv(2, B, H, KV, D, S)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    o_port = ref.decode_attention_ref(tq, tk, tv, length)
    o_oracle = jref.decode_attention_ref(jq, jk, jv, length)
    np.testing.assert_allclose(_np(o_port), _np(o_oracle), **_tol(dtype))


@pytest.mark.parametrize("shape", [(4, 128), (2, 33, 256), (1, 7, 64)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_ref_matches_pallas(shape, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape, np.float32)
    g = rng.standard_normal(shape[-1], np.float32) * 0.2
    jx, tx = _pair(x, dtype)
    y_pallas = jops.rmsnorm(jx, jnp.asarray(g), br=32)
    y_port = ref.rmsnorm_ref(tx, torch.from_numpy(g))
    assert y_port.dtype == DTYPES[dtype][1] and y_port.shape == shape
    np.testing.assert_allclose(_np(y_port), _np(y_pallas), **_tol(dtype))


# (element size, D, vectors a thread): a CTA a row holds up to 256 threads
RMSNORM_PLANS = [(2, 256, 1), (2, 768, 1), (2, 2048, 1), (2, 2560, 2), (2, 5376, 4),
                 (2, 7168, 4), (2, 16384, 8),
                 (4, 256, 1), (4, 1024, 1), (4, 2560, 4), (4, 7168, 8), (4, 8192, 8)]


@pytest.mark.parametrize("element_size,d,nv", RMSNORM_PLANS)
def test_rmsnorm_plan_covers_each_row_with_the_fewest_vectors(element_size, d, nv):
    assert rmsnorm_plan(d, element_size) == nv
    nvec = d * element_size // 16
    assert nv * 256 >= nvec and (nv == 1 or nv // 2 * 256 < nvec)


@pytest.mark.parametrize("element_size,widest", [(2, 16384), (4, 8192)])
def test_rmsnorm_plan_refuses_rows_wider_than_the_kernel_takes(element_size, widest):
    assert rmsnorm_plan(widest, element_size) == 8
    with pytest.raises(ValueError, match=f"at most {widest} "):
        rmsnorm_plan(widest + 16 // element_size, element_size)


def test_cpu_dispatch_uses_plain_versions_and_launches_nothing():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 64), np.float32))
    g = torch.from_numpy(rng.standard_normal(64, np.float32))
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 4, 1, 16, 32))
    before = (rmsnorm_cuda.launches, decode_attention_cuda.launches)
    assert torch.equal(ops.rmsnorm(x, g), ref.rmsnorm_ref(x, g))
    assert torch.equal(ops.decode_attention(q, k, v, 20),
                       ref.decode_attention_ref(q, k, v, 20))
    assert (rmsnorm_cuda.launches, decode_attention_cuda.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(x, torch.zeros(64))
    q, k = torch.zeros(1, 4, 16), torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q, k, k, 4)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "CUDA_HOME", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    with pytest.raises(ValueError, match="unknown kernel"):
        build.build(["no_such_kernel"])


RMSNORM_BWD_SHAPES = [(4, 128), (2, 33, 256), (1, 7, 64), (16, 1152)]


def _rmsnorm_bwd_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, np.float32),
            rng.standard_normal(shape[-1], np.float32) * 0.2,
            rng.standard_normal(shape, np.float32))


@pytest.mark.parametrize("shape", RMSNORM_BWD_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_bwd_ref_matches_jax_vjp_of_rms_norm(shape, dtype):
    x, g, dy = _rmsnorm_bwd_inputs(shape, 5)
    (jx, tx), (jg, tg), (jdy, tdy) = _pair(x, dtype), _pair(g, dtype), _pair(dy, dtype)
    _, vjp = jax.vjp(lambda a, b: jrms_norm(a, b, 1e-6), jx, jg)
    jdx, jdg = vjp(jdy)
    dx, dg = rmsnorm_bwd_ref(tx, tg, tdy)
    assert dx.dtype == tx.dtype and dg.dtype == tg.dtype
    assert dx.shape == shape and dg.shape == shape[-1:]
    np.testing.assert_allclose(_np(dx), _np(jdx), **_tol(dtype))
    np.testing.assert_allclose(_np(dg), _np(jdg), **_tol(dtype))


@pytest.mark.parametrize("shape", RMSNORM_BWD_SHAPES)
def test_rmsnorm_bwd_ref_matches_autograd_of_rmsnorm_ref(shape):
    x, g, dy = (torch.from_numpy(a) for a in _rmsnorm_bwd_inputs(shape, 6))
    x.requires_grad_(True)
    g.requires_grad_(True)
    ref.rmsnorm_ref(x, g).backward(dy)
    dx, dg = rmsnorm_bwd_ref(x.detach(), g.detach(), dy)
    np.testing.assert_allclose(_np(dx), _np(x.grad), **_tol("float32"))
    np.testing.assert_allclose(_np(dg), _np(g.grad), **_tol("float32"))


def test_rmsnorm_function_wiring_with_the_plain_versions():
    """The autograd function with the plain forward and backward plugged in:
    one forward and one backward call each, the backward's own results as
    the gradients, none for an input that does not require one."""
    calls = []

    def fwd(x, g, eps):
        calls.append("fwd")
        return ref.rmsnorm_ref(x, g, eps)

    def bwd(x, g, dy, eps):
        calls.append(("bwd", eps, dy.is_contiguous()))
        return rmsnorm_bwd_ref(x, g, dy, eps)

    x, g, dy = (torch.from_numpy(a) for a in _rmsnorm_bwd_inputs((3, 5, 64), 7))
    x.requires_grad_(True)
    g.requires_grad_(True)
    y = RMSNormFunction.apply(x, g, 1e-5, (fwd, bwd))
    assert torch.equal(y, ref.rmsnorm_ref(x.detach(), g.detach(), 1e-5))
    dy_t = dy.transpose(0, 1).contiguous().transpose(0, 1)  # a strided gradient
    y.backward(dy_t)
    want = rmsnorm_bwd_ref(x.detach(), g.detach(), dy, 1e-5)
    assert torch.equal(x.grad, want[0]) and torch.equal(g.grad, want[1])
    assert calls == ["fwd", ("bwd", 1e-5, True)]

    x2 = x.detach().clone().requires_grad_(True)
    RMSNormFunction.apply(x2, g.detach(), 1e-6, (fwd, bwd)).sum().backward()
    assert x2.grad is not None
    # the shared gamma of zamba2's block: gradients of its uses add
    g2 = g.detach().clone().requires_grad_(True)
    xs = x.detach()
    (RMSNormFunction.apply(xs, g2, 1e-6, (fwd, bwd)).sum()
     + RMSNormFunction.apply(xs * 2, g2, 1e-6, (fwd, bwd)).sum()).backward()
    ones = torch.ones_like(xs)
    np.testing.assert_allclose(
        _np(g2.grad), _np(rmsnorm_bwd_ref(xs, g.detach(), ones)[1]
                          + rmsnorm_bwd_ref(xs * 2, g.detach(), ones)[1]), rtol=1e-6, atol=1e-6)


def test_cpu_rmsnorm_is_differentiable_and_launches_nothing():
    x, g, dy = (torch.from_numpy(a) for a in _rmsnorm_bwd_inputs((4, 64), 8))
    x.requires_grad_(True)
    g.requires_grad_(True)
    before = (rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches)
    ops.rmsnorm(x, g).backward(dy)
    dx, dg = rmsnorm_bwd_ref(x.detach(), g.detach(), dy)
    np.testing.assert_allclose(_np(x.grad), _np(dx), **_tol("float32"))
    np.testing.assert_allclose(_np(g.grad), _np(dg), **_tol("float32"))
    assert (rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches) == before


@pytest.mark.parametrize("rows,sms,per_cta", [(2048, 132, 8), (1024, 132, 4), (4, 132, 4),
                                              (264, 132, 4), (2113, 132, 12), (1, 1, 4)])
def test_rmsnorm_bwd_plan_spreads_rows_over_two_ctas_an_sm(rows, sms, per_cta):
    """Runs of whole blocks of consecutive rows over about two CTAs an SM."""
    plan = rmsnorm_bwd_plan(rows, 1152, 2, sms)
    assert plan.rows_per_cta == per_cta and per_cta % plan.block == 0
    assert (plan.ctas - 1) * per_cta < rows <= plan.ctas * per_cta
    assert plan.ctas <= 2 * sms or per_cta == plan.block


# the training paths on 132 SMs (gemma3-1b's microbatch, a sharded rank,
# xlstm-125m), a run that leaves the last CTA 4 rows, many rows, the widest
# rows, a reducer past the columns; (ctas, rows a CTA, block, vectors a
# thread, reducers, threads)
BWD_PLANS = [
    ((2048, 1152, 2), (256, 8, 4, 1, 64, 160)),
    ((1024, 1152, 2), (256, 4, 4, 1, 64, 160)),
    ((1024, 768, 2), (256, 4, 4, 1, 64, 96)),
    ((2044, 1152, 2), (256, 8, 4, 1, 64, 160)),
    ((65536, 1152, 2), (261, 252, 4, 1, 64, 160)),
    ((1, 16384, 2), (1, 1, 1, 8, 1, 256)),
    ((300, 8192, 4), (150, 2, 1, 8, 64, 256)),
    ((1000, 2560, 2), (250, 4, 2, 2, 64, 160)),
    ((48, 64, 4), (12, 4, 4, 1, 12, 32)),
]


@pytest.mark.parametrize("shape,want", BWD_PLANS, ids=[f"{r}x{d}x{e}" for (r, d, e), _ in BWD_PLANS])
def test_rmsnorm_bwd_plan_pins(shape, want):
    rows, d, esize = shape
    plan = rmsnorm_bwd_plan(rows, d, esize, 132)
    got = (plan.ctas, plan.rows_per_cta, plan.block, plan.nv, plan.reducers,
           plan.threads(d, esize))
    assert got == want


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("d", [64, 256, 768, 1152, 2048, 2560, 4096, 8192, 16384])
@pytest.mark.parametrize("rows", [1, 7, 2044, 100_000])
def test_rmsnorm_bwd_plan_covers_every_row_and_fits(rows, d, esize):
    """Every width the kernel takes (bf16 to D 16384, float32 to 8192): what
    csrc/rmsnorm.cu's rmsnorm_bwd_launch accepts, a block's loads within
    BWD_BLOCK_VECTORS a thread (or one row), every row covered, no CTA idle."""
    if d * esize > 32768:
        with pytest.raises(ValueError):
            rmsnorm_bwd_plan(rows, d, esize, 132)
        return
    plan = rmsnorm_bwd_plan(rows, d, esize, 132)
    threads = plan.threads(d, esize)
    assert 32 * (threads // 32 - 1) < -(-(d * esize // 16) // plan.nv) <= threads <= 256
    assert plan.block in BWD_BLOCKS and (plan.block * plan.nv <= BWD_BLOCK_VECTORS
                                         or plan.block == 1)
    assert plan.rows_per_cta % plan.block == 0 and plan.ctas * plan.rows_per_cta >= rows
    assert plan.reducers == min(plan.ctas, BWD_REDUCERS, d // 4)


def test_rmsnorm_bwd_plan_refuses_what_the_kernel_does_not_take():
    for rows, d, esize in [(0, 1152, 2), (4, 1150, 2), (4, 32776, 2)]:
        with pytest.raises(ValueError):
            rmsnorm_bwd_plan(rows, d, esize, 132)


def test_rmsnorm_bwd_cuda_refuses_cpu_tensors():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_bwd_cuda(x, torch.zeros(64), torch.zeros(2, 64))
