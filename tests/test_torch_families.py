"""Every attention-family architecture of the port against the reference.

The registry and the layer plans compare field for field and stage for
stage, for all 11 architectures.  Then, for each attention-family config at
the reference's reduced size (the dense ones here; :func:`check_arch` runs
the MoE ones in tests/test_torch_moe.py and the MLA ones in
tests/test_torch_mla.py, so pytest's workers share the load), the
reference's ``Model.init(PRNGKey(0))`` parameters are carried across with
``params_from_jax`` and both sides run ``forward`` (logits and aux losses), ``prefill`` (last
logits and every layer's cache) and a token-by-token ``decode_step``
sequence on the same numpy-seeded tokens, and in float32 also on
embeddings in place of tokens (the stub frontends' input: qwen2-vl's and
musicgen's, accepted by every config).  20
positions pass the sliding window of 16 (tests/test_torch_mla.py holds the
chunked attention itself with a ragged last chunk).

Tolerances: float32 3e-5 (the reference's ``_tol``): both sides compute the
same function, in sums of other orders.  bf16 3e-2, the reference's bf16
``_tol``: XLA keeps some bf16 intermediates in float32 where PyTorch rounds
each op, and the port's decode attention keeps the softmax weights in
float32 for the PV product (as the Pallas kernel does) where the reference
casts them to bf16.  The caches are held in float32 only, as
tests/test_torch_model.py holds them: in bf16 a K entry whose product rounds
one ulp apart (0.031 at magnitudes 4-8) can land near zero after RoPE's
cancellation, beyond 3e-2 of a small value.

MoE in bf16: one ulp of the hidden state moves a router probability by about
1e-3, so where the k-th and (k+1)-th probabilities of some token lie closer
than ``FLIP_MARGIN`` the two sides may pick different experts (olmoe's
reduced config does so at decode step 18, margin 8.8e-4).  From the first
such step on, the logits are held to the reference's own bound for a routing
flip, 0.35 (tests/test_arch_smoke.py); before it, to 3e-2.  The forward's
and prefill's logits likewise, if a near tie lies in their tokens.  In
float32 every step is held to 3e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models.model import build_plan as jbuild_plan
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import META, REGISTRY, get_config, reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Model, count_params
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_plan, layer_blocks, param_specs
from repro_torch.serving import ServeConfig, ServeEngine

ALL_ARCHS = sorted(JREGISTRY)
RECURRENT_ARCHS = [a for a in ALL_ARCHS if get_config(a).family in ("hybrid", "ssm")]
DENSE_ARCHS = [a for a in ALL_ARCHS if a not in RECURRENT_ARCHS
               and get_config(a).attn_kind != "mla" and not get_config(a).n_experts]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=3e-5, atol=3e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
B, S = 2, 20
FLIP_MARGIN, FLIP_ATOL = 2e-3, 0.35


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _field_dict(cfg):
    f = dataclasses.asdict(cfg)
    dt = f.pop("param_dtype")
    return f, dt if isinstance(dt, torch.dtype) else jnp.dtype(dt)


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_registry_matches_reference_field_for_field(size):
    assert sorted(REGISTRY) == sorted(META) == ALL_ARCHS and len(ALL_ARCHS) == 11
    for arch in ALL_ARCHS:
        jcfg, tcfg = jget_config(arch), get_config(arch)
        if size == "reduced":
            jcfg, tcfg = jreduced(jcfg), reduced(tcfg)
        (jf, jdt), (tf, tdt) = _field_dict(jcfg), _field_dict(tcfg)
        assert tf == jf, arch
        assert str(tdt).removeprefix("torch.") == jdt.name, arch
        L = tcfg.n_layers
        assert [tcfg.layer_kind(i) for i in range(L)] == [jcfg.layer_kind(i) for i in range(L)]
        assert [tcfg.is_global_attn(i) for i in range(L)] == [
            jcfg.is_global_attn(i) for i in range(L)]


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_build_plan_matches_reference_stage_for_stage(size):
    for arch in ALL_ARCHS:
        jcfg, tcfg = jget_config(arch), get_config(arch)
        if size == "reduced":
            jcfg, tcfg = jreduced(jcfg), reduced(tcfg)
        assert [dataclasses.astuple(st) for st in build_plan(tcfg)] == [
            dataclasses.astuple(st) for st in jbuild_plan(jcfg)], arch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_width_param_count_matches_reference(arch):
    # specs only: nothing of the full-width parameters is allocated; zamba2's
    # shared block counts once (2,422,386,848)
    assert count_params(param_specs(get_config(arch))) == JModel(jget_config(arch)).n_params()


_PAIRS = {}


def _pair(arch, dtype):
    """(reference model, its params, the port's model on the same weights), once.

    The bf16 parameters are the float32 ones cast, which is what the
    reference's ``init`` draws in bf16 (float32 normals, then a cast); the
    float32 router stays float32.
    """
    if (arch, dtype) not in _PAIRS:
        jd, td = DTYPES[dtype]
        jcfg = jreduced(jget_config(arch)).with_(param_dtype=jd)
        tcfg = reduced(get_config(arch)).with_(param_dtype=td)
        jmodel = JModel(jcfg)
        if dtype == "float32":
            jparams = jmodel.init(jax.random.PRNGKey(0))
        else:
            jparams = jax.tree.map(lambda a, s: a.astype(s.dtype), _pair(arch, "float32")[1],
                                   jmodel.abstract_params())
        model = Model(tcfg, device="cpu")
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
        _PAIRS[arch, dtype] = (jmodel, jparams, model)
    return _PAIRS[arch, dtype]


def _inputs(cfg, with_embeds):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, S))
    embeds = None
    if with_embeds:
        embeds = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(np.float32)
    return toks, embeds


def arch_cases(archs):
    """``(arch, dtype, with_embeds)`` cases: both dtypes on tokens, and
    float32 on embeddings (what a stub frontend delivers; ``_embed`` takes
    them for any config)."""
    for arch in archs:
        for dtype in DTYPES:
            yield pytest.param(arch, dtype, False, id=f"{arch}-{dtype}-tokens")
        yield pytest.param(arch, "float32", True, id=f"{arch}-float32-embeds")


def check_arch(arch, dtype, with_embeds, monkeypatch):
    """forward, prefill and a decode sequence of the port against the reference."""
    jmodel, jparams, model = _pair(arch, dtype)
    cfg = model.cfg
    toks, embeds = _inputs(cfg, with_embeds)
    jemb = None if embeds is None else jnp.asarray(embeds)
    temb = None if embeds is None else torch.from_numpy(embeds)
    jtoks, ttoks = (None, None) if with_embeds else (jnp.asarray(toks), torch.from_numpy(toks))
    tol = TOL[dtype]
    margins = []  # the smallest k-th minus (k+1)-th router probability of a step
    route = moe.route

    def route_and_margin(cfg, p, x2d, *args):
        probs = torch.softmax(x2d.float() @ p["router"], dim=-1).sort(-1, descending=True)[0]
        k = cfg.experts_per_token
        margins.append((probs[:, k - 1] - probs[:, k]).min().item())
        return route(cfg, p, x2d, *args)

    monkeypatch.setattr(moe, "route", route_and_margin)

    def held(tol=tol):
        """The step's tolerance: past a near tie in bf16, the flip bound."""
        near_tie = dtype == "bfloat16" and min(margins, default=1.0) < FLIP_MARGIN
        margins.clear()
        return dict(rtol=0, atol=FLIP_ATOL) if near_tie else tol

    jlogits, jaux = jmodel.forward(jparams, jtoks, embeds=jemb)
    logits, aux = model.forward(ttoks, embeds=temb)
    assert logits.dtype == torch.float32 and logits.shape == (B, S, cfg.vocab)
    forward_tol = held()
    np.testing.assert_allclose(_np(logits), _np(jlogits), **forward_tol, err_msg="forward logits")
    assert sorted(aux) == sorted(jaux)
    for key in aux:
        np.testing.assert_allclose(_np(aux[key]), _np(jaux[key]), **forward_tol, err_msg=key)

    jprefill = jax.jit(lambda p, t, e: jmodel.prefill(p, t, embeds=e))
    jlast, jcaches = jprefill(jparams, jtoks, jemb)
    last, caches = model.prefill(ttoks, embeds=temb)
    np.testing.assert_allclose(_np(last), _np(jlast), **held(), err_msg="prefill logits")
    assert len(caches) == len(jcaches) == len(layer_blocks(cfg))
    for li, (c, jc) in enumerate(zip(caches, jcaches)):
        assert sorted(c) == sorted(jc)
        for name in c:
            assert tuple(c[name].shape) == jc[name].shape
            if dtype == "float32":
                np.testing.assert_allclose(_np(c[name]), _np(jc[name]), **tol,
                                           err_msg=f"prefill cache {name} of layer {li}")

    jstep = jax.jit(lambda p, c, t, pos, e: jmodel.decode_step(p, c, t, pos, embeds=e))
    jc, c = jmodel.init_caches(B, S + 4), model.init_caches(B, S + 4)
    step_tol = tol
    for pos in range(S):
        je = None if embeds is None else jemb[:, pos:pos + 1]
        te = None if embeds is None else temb[:, pos:pos + 1]
        jt = None if with_embeds else jnp.asarray(toks[:, pos], jnp.int32)
        tt = None if with_embeds else torch.from_numpy(toks[:, pos])
        jlg, jc = jstep(jparams, jc, jt, jnp.int32(pos), je)
        lg, c = model.decode_step(c, tt, pos, embeds=te)
        step_tol = held(step_tol)  # a flip's effect stays in the cache
        np.testing.assert_allclose(_np(lg), _np(jlg), **step_tol, err_msg=f"decode step {pos}")


@pytest.mark.parametrize("arch,dtype,with_embeds", list(arch_cases(DENSE_ARCHS)))
def test_forward_prefill_and_decode_match_reference(arch, dtype, with_embeds, monkeypatch):
    check_arch(arch, dtype, with_embeds, monkeypatch)


def test_moe_engine_serves_greedy_tokens_and_stats_as_the_reference():
    jmodel, jparams, model = _pair("olmoe-1b-7b", "float32")
    prompts = [[5, 6, 7], [9, 10], [1, 2, 3, 4],
               [int(t) for t in np.random.default_rng(1).integers(1, 256, 11)]]
    jeng = JServeEngine(jmodel, jparams, JServeConfig(max_batch=2))
    eng = ServeEngine(model, ServeConfig(max_batch=2))
    jouts, outs = jeng.generate(prompts, 6), eng.generate(prompts, 6)
    assert outs == [[int(t) for t in o] for o in jouts]
    assert eng.stats == jeng.stats


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-mla", "qwen2-vl-7b", "zamba2-2.7b",
                                  "xlstm-125m"])
def test_cli_serves_any_ported_arch_reduced_on_cpu(arch, capsys):
    res = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                          "--prompt-len", "5", "--new-tokens", "3", "--max-batch", "2"])
    assert res["stats"] == {"prefill_tokens": 10, "decode_steps": 3, "requests": 2}
    assert [len(o) for o in res["outputs"]] == [8, 8]
    assert "tok/s on cpu" in capsys.readouterr().out
