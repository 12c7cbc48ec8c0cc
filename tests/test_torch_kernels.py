"""The port's plain kernel versions against the reference's Pallas kernels.

Inputs come from a seeded numpy Generator and go through
``repro.kernels.ops`` (Pallas in interpret mode, as tests/test_kernels.py
runs it) and through ``repro_torch.kernels.ref``, with the reference's
tolerances: 3e-5 in float32, 3e-2 in bf16 (both sides round the same float32
inputs to bf16, then compute in float32 and round the output).  The CUDA
kernels themselves are compared with these plain versions on the card, in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda

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
        build.build(["gemv"])
