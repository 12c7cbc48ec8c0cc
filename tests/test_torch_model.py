"""The port's gemma3-1b decode path against the reference's, on the same weights.

The reference's ``Model.init(PRNGKey(0))`` parameters are converted to numpy
and loaded with ``params_from_jax``; both sides then run 40 ``decode_step``s
on the same seeded tokens at the reduced config (4 layers, window 16,
``global_every`` 2), past the window so the local layers' ring buffers wrap.

Tolerances: in float32 the two sides compute the same function, except that
the reference's ``attention_decode`` casts the softmax weights to v's dtype
before the PV product and the port (like the Pallas kernel) does not — a
no-op in float32 — and that XLA and PyTorch sum in other orders; 1e-4 covers
that over 40 steps.  In bf16 the cast is a real rounding, and XLA keeps some
bf16 intermediates in float32 where PyTorch rounds each op, so logits are held
to the reference's bf16 tolerance, 3e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models.attention import apply_rope as japply_rope
from repro.models.attention import rope_cos_sin as jrope_cos_sin
from repro.models.mlp import mlp_apply as jmlp_apply
from repro_torch.configs import get_config, reduced
from repro_torch.models import Model, count_params
from repro_torch.models.attention import apply_rope, rope_cos_sin
from repro_torch.models.convert import params_from_jax
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.model import param_specs

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOGIT_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=3e-2, atol=3e-2)}
CACHE_TOL = dict(rtol=1e-4, atol=1e-4)
N_STEPS, BATCH = 40, 2


def _configs(dtype_name):
    jd, td = DTYPES[dtype_name]
    jcfg = jreduced(jget_config("gemma3-1b")).with_(param_dtype=jd)
    tcfg = reduced(get_config("gemma3-1b")).with_(param_dtype=td)
    return jcfg, tcfg


def _pair_models(dtype_name):
    jcfg, tcfg = _configs(dtype_name)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    return jmodel, jparams, model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch_cfg", ["full", "reduced"])
def test_config_matches_reference_field_for_field(arch_cfg):
    jcfg, tcfg = jget_config("gemma3-1b"), get_config("gemma3-1b")
    if arch_cfg == "reduced":
        jcfg, tcfg = jreduced(jcfg), reduced(tcfg)
    jf, tf = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert set(jf) == set(tf)
    assert jnp.dtype(jf.pop("param_dtype")).name == str(tf.pop("param_dtype")).removeprefix(
        "torch.")
    assert jf == tf
    assert [tcfg.is_global_attn(i) for i in range(tcfg.n_layers)] == [
        jcfg.is_global_attn(i) for i in range(jcfg.n_layers)]
    assert tcfg.hd == jcfg.hd


def test_full_width_param_count_matches_reference():
    # specs only: nothing of the ~1.0 B parameters is allocated
    n = count_params(param_specs(get_config("gemma3-1b")))
    assert n == JModel(jget_config("gemma3-1b")).n_params() == 999_812_736


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_steps_match_reference_across_ring_wrap(dtype):
    jmodel, jparams, model = _pair_models(dtype)
    cfg = model.cfg
    max_len = N_STEPS + 8
    assert N_STEPS > 2 * cfg.sliding_window  # the ring wraps twice
    jcaches = jmodel.init_caches(BATCH, max_len)
    caches = model.init_caches(BATCH, max_len)
    assert [c["k"].shape[1] for c in caches] == [c["k"].shape[1] for c in jcaches] == [
        16, max_len, 16, max_len]
    jdecode = jax.jit(jmodel.decode_step)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (N_STEPS, BATCH))
    for pos in range(N_STEPS):
        jlogits, jcaches = jdecode(jparams, jcaches, jnp.asarray(toks[pos], jnp.int32),
                                   jnp.int32(pos))
        logits, caches = model.decode_step(caches, torch.from_numpy(toks[pos]), pos)
        assert logits.dtype == torch.float32 and logits.shape == (BATCH, cfg.vocab)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **LOGIT_TOL[dtype],
                                   err_msg=f"logits at step {pos}")
    if dtype == "float32":
        for li, (c, jc) in enumerate(zip(caches, jcaches)):
            for name in ("k", "v"):
                np.testing.assert_allclose(_np(c[name]), _np(jc[name]), **CACHE_TOL,
                                           err_msg=f"cache {name} of layer {li}")


def test_init_is_seeded_and_draws_the_reference_scales():
    _, tcfg = _configs("float32")
    a = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(7))
    b = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    # norms start at zero (the (1 + gamma) scale), embed at std 0.02,
    # projections at std 1/sqrt(fan_in)
    assert not a.final_norm.any() and not a.blocks[0].ln1.any()
    assert abs(a.embed.std().item() - 0.02) < 0.002
    w = a.blocks[0].attn["w_q"]
    assert abs(w.std().item() - tcfg.d_model ** -0.5) < 0.02


# --- the reference's bf16 rounding sites and its GELU, one test each ---------


def test_embed_scale_is_rounded_to_the_activation_dtype():
    """``_embed`` multiplies by sqrt(d_model) rounded to bf16: 33.94 -> 34.0."""
    jcfg, tcfg = (c.with_(d_model=1152, n_layers=1) for c in _configs("bfloat16"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    toks = np.array([[3], [200]])
    x = model._embed(torch.from_numpy(toks))
    assert torch.equal(x, model.embed[torch.from_numpy(toks)] * 34.0)
    np.testing.assert_array_equal(_np(x), _np(jmodel._embed(jparams, jnp.asarray(toks))))


def test_rope_casts_cos_sin_to_the_activation_dtype():
    x = np.random.default_rng(2).standard_normal((2, 1, 4, 256), np.float32)
    pos = np.array([[300], [543]], np.int32)
    jc, js = jrope_cos_sin(jnp.asarray(pos), 256, 10_000.0)
    c, s = rope_cos_sin(torch.from_numpy(pos), 256, 10_000.0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=3e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=3e-5)
    y = apply_rope(torch.from_numpy(x).to(torch.bfloat16), c, s)
    jy = japply_rope(jnp.asarray(x).astype(jnp.bfloat16), jc, js)
    assert y.dtype == torch.bfloat16
    # bf16 products of bf16 cos/sin, as the reference: equal to the last bit
    np.testing.assert_array_equal(_np(y), _np(jy))


def test_head_product_is_in_the_param_dtype_then_float32():
    _, tcfg = _configs("bfloat16")
    model = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(3))
    x = torch.randn(2, 1, tcfg.d_model, generator=torch.Generator().manual_seed(4))
    logits = model._head(x.to(torch.bfloat16))
    assert logits.dtype == torch.float32
    assert torch.equal(logits, logits.to(torch.bfloat16).float())  # bf16 values


def test_gelu_is_the_tanh_approximation_of_jax_nn_gelu():
    jcfg, tcfg = _configs("float32")
    rng = np.random.default_rng(5)
    p = {"w_gate": rng.standard_normal((64, 128), np.float32) * 0.3,
         "w_up": rng.standard_normal((64, 128), np.float32) * 0.3,
         "w_down": rng.standard_normal((128, 64), np.float32) * 0.1}
    x = rng.standard_normal((2, 1, 64), np.float32)
    y = mlp_apply(tcfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    jy = jmlp_apply(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    # the erf form F.gelu defaults to would miss that tolerance by far
    h = torch.from_numpy(x) @ torch.from_numpy(p["w_gate"])
    assert (torch.nn.functional.gelu(h) - torch.nn.functional.gelu(h, approximate="tanh")
            ).abs().max() > 1e-4


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_params_from_jax_refuses_a_tree_that_does_not_fit(fault):
    jcfg, tcfg = _configs("float32")
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
    if fault == "missing":
        del tree["stages"][0]["mlp"]["w_up"]
    else:
        tree["final_norm"] = np.zeros(tcfg.d_model + 1, np.float32)
    with pytest.raises(ValueError, match=fault):
        params_from_jax(tree, tcfg)


@pytest.mark.parametrize("arch", ["gemma3-1b", "minicpm3-4b", "zamba2-2.7b"])
def test_prefill_hands_the_norm_kernel_contiguous_rows(arch, monkeypatch):
    """``prefill`` of several rows hands every norm a contiguous ``x`` (the
    card's kernel refuses any other: the last token's rows of [B, S, d] are
    a strided view until copied)."""
    from repro_torch.kernels import ops

    plain, seen = ops.rmsnorm, []

    def checking(x, gamma, eps=1e-6):
        seen.append(x.is_contiguous())
        return plain(x, gamma, eps)

    monkeypatch.setattr(ops, "rmsnorm", checking)
    cfg = reduced(get_config(arch)).with_(param_dtype=torch.float32)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    model.prefill(torch.zeros(3, 8, dtype=torch.int64), max_len=12)
    assert seen and all(seen)
