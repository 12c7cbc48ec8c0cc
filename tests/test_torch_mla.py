"""The port's MLA, M-RoPE and chunked attention against ``repro.models.attention``.

Inputs are made with numpy from a seed and handed to both sides.  M-RoPE
with three identical position streams is standard RoPE, bit for bit, and
with three different streams it matches the reference.  The chunked causal
attention is held to the reference's, full and windowed, with a ragged last
chunk, at GQA rep 2 and at MLA's unequal K and V widths.  MLA decode, naive
(the latent expanded to per-head K and V) and absorbed (scores and output in
latent space), follows the reference step by step over a growing cache, for
minicpm3's plan (q compressed) and kimi-k2-1t-mla's; the full forward's MLA
projection gives the reference's cache entries.  Then minicpm3-4b and
kimi-k2-1t-mla end to end through :func:`test_torch_families.check_arch`.

Tolerances: float32 3e-5 (the reference's ``_tol``); bf16 3e-2 (its bf16
``_tol``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import DTYPES, TOL, arch_cases, check_arch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import attention as jatt
from repro.models.common import materialize as jmaterialize
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention

MLA_ARCHS = ["minicpm3-4b", "kimi-k2-1t-mla"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _configs(arch, dtype, **kw):
    jd, td = DTYPES[dtype]
    return (jreduced(jget_config(arch)).with_(param_dtype=jd, **kw),
            reduced(get_config(arch)).with_(param_dtype=td, **kw))


def _attn_params(jcfg, tcfg, seed=0):
    jp = jmaterialize(jatt.attention_specs(jcfg), jax.random.PRNGKey(seed))
    specs = attention.attention_specs(tcfg)
    assert sorted(specs) == sorted(jp)
    tp = {k: torch.from_numpy(np.asarray(v).astype(np.float32)).to(specs[k].dtype)
          for k, v in jp.items()}
    for k, s in specs.items():
        assert tuple(tp[k].shape) == s.shape == jp[k].shape
    return jp, tp


# --- M-RoPE -------------------------------------------------------------------


def test_mrope_with_identical_streams_is_rope():
    pos = np.random.default_rng(0).integers(0, 4000, (2, 5)).astype(np.int32)
    t = torch.from_numpy(pos)
    c3, s3 = attention.rope_cos_sin(t[None].expand(3, 2, 5), 128, 1e6, (16, 24, 24))
    c, s = attention.rope_cos_sin(t, 128, 1e6)
    assert torch.equal(c3, c) and torch.equal(s3, s)


def test_mrope_with_three_streams_matches_reference():
    # positions up to qwen2-vl's 32768-token context and beyond: the float32
    # frequencies are the correctly rounded ones on both sides, and float32
    # cos / sin agree to a few ulps of the angle there
    pos = np.random.default_rng(1).integers(0, 131072, (3, 2, 5)).astype(np.int32)
    jc, js = jatt.rope_cos_sin(jnp.asarray(pos), 128, 1e6, (16, 24, 24))
    c, s = attention.rope_cos_sin(torch.from_numpy(pos), 128, 1e6, (16, 24, 24))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=3e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=3e-5)
    # each section rotates with its own stream
    for sec, (lo, hi) in enumerate([(0, 16), (16, 40), (40, 64)]):
        c1, _ = attention.rope_cos_sin(torch.from_numpy(pos[sec]), 128, 1e6)
        assert torch.equal(c[..., lo:hi], c1[..., lo:hi])
    with pytest.raises(ValueError, match="sections"):
        attention.rope_cos_sin(torch.from_numpy(pos), 128, 1e6, (16, 24, 23))


# --- the chunked causal attention -----------------------------------------------


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("heads", [(4, 2, 16, 16), (4, 4, 24, 16)])  # H, KV, Dk, Dv
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chunked_attention_matches_reference_with_a_ragged_last_chunk(window, heads, dtype):
    H, KV, Dk, Dv = heads
    B, S, chunk = 2, 19, 8  # chunks of 8, 8 and 3
    rng = np.random.default_rng(3)
    jq, q = _both(rng.standard_normal((B, S, H, Dk)), dtype)
    jk, k = _both(rng.standard_normal((B, S, KV, Dk)), dtype)
    jv, v = _both(rng.standard_normal((B, S, KV, Dv)), dtype)
    jo = jatt._chunked_attention(jq, jk, jv, window=window, chunk=chunk)
    o = attention._chunked_attention(q, k, v, window=window, chunk=chunk)
    assert o.dtype == q.dtype and o.shape == (B, S, H, Dv)
    np.testing.assert_allclose(_np(o), _np(jo), **TOL[dtype])
    # one chunk gives the same function
    np.testing.assert_allclose(
        _np(attention._chunked_attention(q, k, v, window=window, chunk=64)), _np(o),
        **TOL[dtype])


# --- MLA ------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MLA_ARCHS)
@pytest.mark.parametrize("absorbed", [False, True], ids=["naive", "absorbed"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_decode_matches_reference_step_by_step(arch, absorbed, dtype):
    jcfg, tcfg = _configs(arch, dtype, mla_absorbed_decode=absorbed)
    jp, tp = _attn_params(jcfg, tcfg)
    B, steps = 2, 9
    x = np.random.default_rng(4).standard_normal((steps, B, 1, tcfg.d_model))
    if absorbed and dtype == "bfloat16":
        # XLA's CPU backend has no bf16 x bf16 -> float32 product, which the
        # reference's absorbed einsums ask for (preferred_element_type), so it
        # runs in float32 on the same bf16 values: the port's bf16 roundings
        # stay within the bf16 tolerance of that
        jcfg = jcfg.with_(param_dtype=jnp.float32)
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    jcache = jatt.init_kv_cache(jcfg, B, steps + 3, 0)
    cache = attention.init_kv_cache(tcfg, B, steps + 3, 0, torch.device("cpu"))
    assert sorted(cache) == sorted(jcache) == ["c_kv", "k_pe"]
    jdecode = jax.jit(lambda p, xx, c, pos: jatt.attention_decode(jcfg, p, xx, c, pos))
    for pos in range(steps):
        jx, tx = _both(x[pos], dtype)
        jy, jcache = jdecode(jp, jx, jcache, jnp.int32(pos))
        y, cache = attention.attention_decode(tcfg, tp, tx, cache, pos)
        np.testing.assert_allclose(_np(y), _np(jy), **TOL[dtype], err_msg=f"step {pos}")
    for name in cache:
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), **TOL[dtype])


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_absorbed_and_naive_decode_agree(arch):
    jcfg, tcfg = _configs(arch, "float32")
    _, tp = _attn_params(jcfg, tcfg)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((6, 2, 1, tcfg.d_model)))
    outs = []
    for cfg in (tcfg, tcfg.with_(mla_absorbed_decode=True)):
        cache = attention.init_kv_cache(cfg, 2, 8, 0, torch.device("cpu"))
        outs.append([attention.attention_decode(cfg, tp, x[p].float(), cache, p)[0]
                     for p in range(6)])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("arch", MLA_ARCHS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_forward_matches_reference_with_its_cache_entries(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _attn_params(jcfg, tcfg)
    B, S = 2, 11
    jx, tx = _both(np.random.default_rng(6).standard_normal((B, S, tcfg.d_model)), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jy, (jc_kv, jk_pe) = jatt.attention_apply(jcfg, jp, jx, jnp.asarray(pos), chunk=4)
    y, (c_kv, k_pe) = attention.attention_apply(tcfg, tp, tx, torch.from_numpy(pos.copy()),
                                                chunk=4)
    assert c_kv.shape == (B, S, tcfg.mla_kv_rank) and k_pe.shape == (B, S, tcfg.mla_rope_dim)
    for a, b in ((y, jy), (c_kv, jc_kv), (k_pe, jk_pe)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL[dtype])


@pytest.mark.parametrize("arch,dtype,with_embeds", list(arch_cases(MLA_ARCHS)))
def test_mla_archs_forward_prefill_and_decode_match_reference(arch, dtype, with_embeds,
                                                              monkeypatch):
    check_arch(arch, dtype, with_embeds, monkeypatch)
