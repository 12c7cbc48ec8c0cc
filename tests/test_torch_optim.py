"""The port's AdamW against ``repro.optim`` on the same numpy-seeded trees.

Tolerance: float32 3e-5 (the reference's ``_tol``): both sides run the same
float32 ops; XLA and PyTorch may round ``cos``, ``pow`` and the sums of
squares an ulp apart.  The gradients are the same on both sides, so AdamW's
normalisation has no rounding of its own to magnify.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_step as jadamw_step
from repro.optim import cosine_lr as jcosine_lr
from repro.optim import global_norm as jglobal_norm
from repro_torch.optim import AdamWConfig, adamw_init, adamw_step, cosine_lr, global_norm

TOL = dict(rtol=3e-5, atol=3e-5)
# a mixed tree: bf16 matrices and a norm, a float32 router (as the models have)
SHAPES = {"embed": ((64, 16), "bfloat16"), "ln": ((16,), "bfloat16"),
          "w": ((16, 32), "bfloat16"), "router": ((16, 4), "float32")}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dt) in SHAPES.items():
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        # torch gets its own copy: jnp.asarray may alias a on the CPU, and
        # adamw_step writes the parameters in place
        out[k] = (jnp.asarray(a).astype(dt), torch.tensor(a).to(getattr(torch, dt)))
    return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("cfg", [dict(), dict(warmup_steps=5, total_steps=20, lr=3e-3),
                                 dict(warmup_steps=0, total_steps=10, min_lr_ratio=0.0)])
def test_cosine_lr_matches_reference(cfg):
    jcfg, tcfg = JAdamWConfig(**cfg), AdamWConfig(**cfg)
    for step in (0, 1, 3, 5, 7, 10, 20, 99, 100, 5000, 10_000, 12_000):
        got = cosine_lr(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(jcosine_lr(jcfg, jnp.int32(step))), **TOL)


def test_global_norm_matches_reference():
    jtree, ttree = _tree(0)
    got = global_norm(ttree.values())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(jglobal_norm(jtree)), **TOL)


def test_adamw_init_matches_reference():
    jtree, ttree = _tree(1)
    jstate, state = jadamw_init(jtree, JAdamWConfig()), adamw_init(ttree, AdamWConfig())
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for key in ("mu", "nu", "master"):
        for k in SHAPES:
            assert state[key][k].dtype == torch.float32
            np.testing.assert_array_equal(_np(state[key][k]), _np(jstate[key][k]))
    assert "master" not in adamw_init(ttree, AdamWConfig(master_fp32=False))


@pytest.mark.parametrize("master_fp32", [True, False])
def test_five_adamw_steps_match_reference(master_fp32):
    """Gradients of two scales: a clipped one (norm above clip_norm) and not."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, master_fp32=master_fp32)
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    jparams, params = _tree(2)
    jstate, state = jadamw_init(jparams, jcfg), adamw_init(params, tcfg)
    for step in range(5):
        jg, g = _tree(10 + step, scale=0.5 if step % 2 else 0.01)
        jparams, jstate, jm = jax.jit(jadamw_step, static_argnums=3)(jparams, jg, jstate, jcfg)
        same_params, state, m = adamw_step(params, g, state, tcfg)
        assert same_params is params  # updated in place
        assert int(state["step"]) == step + 1
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(_np(m[key]), _np(jm[key]), **TOL, err_msg=key)
    for k, (_, dt) in SHAPES.items():
        assert params[k].dtype == getattr(torch, dt)
        np.testing.assert_allclose(_np(params[k]), _np(jparams[k]), **TOL, err_msg=k)
        for key in ("mu", "nu") + (("master",) if master_fp32 else ()):
            np.testing.assert_allclose(_np(state[key][k]), _np(jstate[key][k]), **TOL,
                                       err_msg=f"{key} {k}")


def test_adamw_differs_from_torch_optim():
    """The reference's eps placement, not torch.optim.AdamW's: the two part
    on a small second moment after one step."""
    w = torch.tensor([1.0, -2.0])
    g = torch.tensor([1e-9, 0.5])
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10, eps=1e-8, clip_norm=1e9)
    params = {"w": w.clone()}
    adamw_step(params, {"w": g}, adamw_init(params, cfg), cfg)
    tw = torch.nn.Parameter(w.clone())
    opt = torch.optim.AdamW([tw], lr=0.1, betas=(cfg.beta1, cfg.beta2), eps=cfg.eps,
                            weight_decay=cfg.weight_decay)
    tw.grad = g.clone()
    opt.step()
    assert not torch.allclose(params["w"], tw.detach(), rtol=1e-6, atol=1e-6)
