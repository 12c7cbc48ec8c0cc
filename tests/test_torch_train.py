"""The port's training path against the reference's, on the same weights and data.

The reference's ``Model.init(PRNGKey(0))`` parameters are carried across with
``params_from_jax``; tokens come from a seeded numpy Generator.  The oracle is
the reference's own pieces without a mesh (its ``Trainer`` needs one):
``jax.value_and_grad(Model.loss_fn)`` and ``adamw_init`` / ``adamw_step``
composed in a plain loop, and for microbatches the scan of
``repro/training/trainer.py::build_train_step`` written out here.

Tolerances: float32 3e-5 (the reference's ``_tol``) on the loss, its metrics
and every gradient: the two sides compute the same function with sums in
other orders.  bf16 3e-2, the reference's bf16 ``_tol``, on the loss and on
each gradient relative to that tensor's largest entry (XLA keeps some bf16
intermediates in float32 where PyTorch rounds each op).  Parameters and
optimizer state after AdamW steps: 3e-5, except where AdamW magnifies a
gradient's rounding.  Its update is lr * m_hat / (sqrt(v_hat) + eps), about
lr * g / |g| for a gradient seen once, so a gradient g that the two sides
round apart by delta moves the update by about lr * delta / |g|.  A gradient
that is a near-cancelling sum (an embedding row of a token seen once, within
``G_NOISE`` of zero) is known only to some 1e-7 absolutely, so such an entry
of the master and the parameters is held to ``2 * sum(lr)`` of the steps: it
may move either way by a whole update.  With lr 1e-3 a rounding of 1e-7
moves the update of a gradient below 1e-5 by more than 1e-5.  An entry
outside 3e-5 must be such an entry, within that bound, and they must be
fewer than 1 in 10^4 (2 of 145,216 in xlstm-125m with 2 microbatches, none
in gemma3-1b).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_step as jadamw_step
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.ft import SimulatedFailure
from repro_torch.launch import train as train_cli
from repro_torch.models import Model
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.training import TrainConfig, Trainer, build_train_step

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=3e-5, atol=3e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# gemma3-1b (sliding windows), xlstm-125m (mLSTM / sLSTM), zamba2-2.7b (the
# shared block's gradient sums over its uses), minicpm3-4b (MLA's norm_kv and
# norm_q), olmoe-1b-7b (router aux losses)
ARCHS = ["gemma3-1b", "xlstm-125m", "zamba2-2.7b", "minicpm3-4b", "olmoe-1b-7b"]
B, S = 2, 24  # past the reduced window of 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)
G_NOISE = 1e-5  # a nonzero float32 gradient below this is near-cancelling noise


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(arch, dtype="float32"):
    jd, td = DTYPES[dtype]
    jcfg = jreduced(jget_config(arch)).with_(param_dtype=jd)
    tcfg = reduced(get_config(arch)).with_(param_dtype=td)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    return jmodel, jparams, model


def _tokens(cfg, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (batch, S)).astype(np.int32)
    return toks, labels


def _grads_np(jgrads, cfg):
    """The reference's gradient tree under the port's names, as float32 numpy."""
    return {k: _np(v) for k, v in params_from_jax(jax.tree.map(np.asarray, jgrads), cfg).items()}


def _assert_grads_close(model, want, tol, relative_to_max=False):
    for name, p in model.named_parameters():
        got = _np(p.grad) if p.grad is not None else np.zeros(p.shape, np.float32)
        if relative_to_max:
            scale = max(float(np.abs(want[name]).max()), 1e-6)
            np.testing.assert_allclose(got / scale, want[name] / scale, **tol, err_msg=name)
        else:
            np.testing.assert_allclose(got, want[name], **tol, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference_float32(arch):
    jmodel, jparams, model = _pair(arch)
    toks, _ = _tokens(model.cfg)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, jnp.asarray(toks))  # labels default to the shifted tokens
    model.requires_grad_(True)
    loss, metrics = model.loss_fn(torch.from_numpy(toks))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(_np(loss), _np(jloss), **TOL["float32"])
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(_np(metrics[k]), _np(jmetrics[k]), **TOL["float32"],
                                   err_msg=k)
    if model.cfg.n_experts:
        assert float(jmetrics["moe_load_balance"]) > 0 and float(jmetrics["moe_z"]) > 0
    want = _grads_np(jgrads, model.cfg)
    assert set(want) == {n for n, _ in model.named_parameters()}
    _assert_grads_close(model, want, TOL["float32"])


def test_loss_and_gradients_match_reference_bfloat16():
    jmodel, jparams, model = _pair("gemma3-1b", "bfloat16")
    toks, labels = _tokens(model.cfg, seed=1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, jnp.asarray(toks), jnp.asarray(labels))
    model.requires_grad_(True)
    loss, _ = model.loss_fn(torch.from_numpy(toks), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(_np(loss), _np(jloss), **TOL["bfloat16"])
    assert all(p.grad.dtype == torch.bfloat16 for p in model.parameters())
    _assert_grads_close(model, _grads_np(jgrads, model.cfg), TOL["bfloat16"],
                        relative_to_max=True)


def test_n_active_params_matches_reference():
    for arch in ARCHS:
        jcfg, tcfg = jreduced(jget_config(arch)), reduced(get_config(arch))
        assert Model(tcfg, device="cpu").n_active_params() == JModel(jcfg).n_active_params()


def _reference_steps(jmodel, jparams, batches, optim, mb):
    """The reference's train step without a mesh: value_and_grad (through the
    microbatch scan of build_train_step when mb > 1) and adamw_step."""

    def loss_for(params, tk, lb):
        return jmodel.loss_fn(params, tk, lb)

    @jax.jit
    def step(params, state, tokens, labels):
        if mb > 1:
            Bt = tokens.shape[0]
            tks = tokens.reshape(mb, Bt // mb, *tokens.shape[1:])
            lbs = labels.reshape(mb, Bt // mb, *labels.shape[1:])

            def micro(carry, xs):
                g_acc, loss_acc = carry
                (l, _), g = jax.value_and_grad(loss_for, has_aux=True)(params, xs[0], xs[1])
                return (jax.tree.map(lambda a, b: a + b, g_acc, g), loss_acc + l), None

            g0 = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
            (g, loss), _ = jax.lax.scan(micro, (g0, jnp.float32(0.0)), (tks, lbs))
            g = jax.tree.map(lambda x: x / mb, g)
            loss = loss / mb
        else:
            (loss, _), g = jax.value_and_grad(loss_for, has_aux=True)(params, tokens, labels)
        new_params, new_state, m = jadamw_step(params, g, state, optim)
        return new_params, new_state, loss, m["grad_norm"], m["lr"], g

    state = jadamw_init(jparams, optim)
    out, lr_sum, noisy = [], 0.0, None
    for tokens, labels in batches:
        jparams, state, loss, gnorm, lr, g = step(jparams, state, jnp.asarray(tokens),
                                                  jnp.asarray(labels))
        out.append((float(loss), float(gnorm)))
        lr_sum += float(lr)
        near = jax.tree.map(lambda x: (x != 0) & (jnp.abs(x) < G_NOISE), g)
        noisy = near if noisy is None else jax.tree.map(jnp.logical_or, noisy, near)
    return jparams, state, out, lr_sum, noisy


@pytest.mark.parametrize("arch,mb", [("gemma3-1b", 1), ("gemma3-1b", 2), ("xlstm-125m", 2)])
def test_three_train_steps_match_reference_composition(arch, mb):
    jmodel, jparams, model = _pair(arch)
    batches = [_tokens(model.cfg, seed=s, batch=4) for s in range(3)]
    jfinal, jstate, ref, lr_sum, noisy = _reference_steps(jmodel, jparams, batches,
                                                          JAdamWConfig(**OPT), mb)
    noisy = {k: v.numpy().astype(bool) for k, v in params_from_jax(
        jax.tree.map(lambda x: np.asarray(x).astype(np.float32), noisy), model.cfg).items()}

    tcfg = TrainConfig(microbatches=mb, optim=AdamWConfig(**OPT))
    step_fn = build_train_step(model, tcfg)
    params = dict(model.named_parameters())
    opt_state = adamw_init(params, tcfg.optim)
    for (tokens, labels), (jloss, jgnorm) in zip(batches, ref):
        opt_state, metrics = step_fn(opt_state, tokens, labels)
        np.testing.assert_allclose(_np(metrics["loss"]), jloss, **TOL["float32"])
        np.testing.assert_allclose(_np(metrics["grad_norm"]), jgnorm, **TOL["float32"])
        assert ("ce" in metrics) == (mb == 1)
        assert all(p.grad is None for p in params.values())  # none left behind
    assert int(opt_state["step"]) == int(jstate["step"]) == 3
    want = params_from_jax(jax.tree.map(np.asarray, jfinal), model.cfg)
    master = opt_state_from_jax(jax.tree.map(np.asarray, jstate), model.cfg)
    outside = 0
    for name, p in params.items():
        for key, got, ref_ in (("param", p, want[name]),
                               ("master", opt_state["master"][name], master["master"][name]),
                               ("mu", opt_state["mu"][name], master["mu"][name]),
                               ("nu", opt_state["nu"][name], master["nu"][name])):
            got, ref_ = _np(got), _np(ref_)
            if key in ("param", "master"):  # AdamW's magnified noise, see the docstring
                tol = TOL["float32"]
                out = np.abs(got - ref_) > tol["atol"] + tol["rtol"] * np.abs(ref_)
                assert np.all(noisy[name][out]), (key, name)
                assert np.all(np.abs(got - ref_)[out] <= 2 * lr_sum), (key, name)
                outside += int(out.sum())
                got, ref_ = got[~out], ref_[~out]
            np.testing.assert_allclose(got, ref_, **TOL["float32"], err_msg=f"{key} {name}")
    assert outside <= 1e-4 * 2 * sum(p.numel() for p in params.values())


def test_remat_full_equals_none():
    _, _, model = _pair("gemma3-1b")
    toks, labels = _tokens(model.cfg, seed=2)
    model.requires_grad_(True)
    grads = {}
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss_fn(torch.from_numpy(toks), torch.from_numpy(labels), remat=remat)
        loss.backward()
        grads[remat] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()})
    assert grads[True][0] == grads[False][0]
    for name, g in grads[False][1].items():
        assert torch.equal(grads[True][1][name], g), name


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_remat_policies_of_the_sharded_slice_raise(policy):
    """The sharded substrate's policies now run (they raised until it came):
    loss and gradients equal those without remat; an unknown name still
    raises."""
    _, _, model = _pair("gemma3-1b")
    toks, _ = _tokens(model.cfg)
    model.requires_grad_(True)
    grads = {}
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss_fn(torch.from_numpy(toks), remat=remat, remat_policy=policy)
        loss.backward()
        grads[remat] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()})
    assert grads[True][0] == grads[False][0]
    for name, g in grads[False][1].items():
        assert torch.equal(grads[True][1][name], g), name
    with pytest.raises(ValueError, match="unknown remat policy"):
        model.loss_fn(torch.from_numpy(toks), remat=True, remat_policy="some")


def test_opt_state_from_jax_keeps_float32():
    jmodel, jparams, model = _pair("gemma3-1b", "bfloat16")
    jstate = jadamw_init(jparams, JAdamWConfig())
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate), model.cfg)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for key in ("mu", "nu", "master"):
        assert set(state[key]) == {n for n, _ in model.named_parameters()}
        assert all(t.dtype == torch.float32 for t in state[key].values())
    mine = adamw_init(dict(model.named_parameters()), AdamWConfig())
    for name, t in mine["master"].items():
        assert torch.equal(state["master"][name], t), name


def test_failure_drill_restarts_from_the_last_checkpoint(tmp_path):
    cfg = reduced(get_config("gemma3-1b")).with_(param_dtype=torch.float32)
    model = Model(cfg, device="cpu")
    fails = {3}

    def inject(step):
        if step in fails:
            fails.discard(step)
            raise SimulatedFailure(f"injected at {step}")

    n_steps = 8
    tr = Trainer(model, TrainConfig(optim=AdamWConfig(lr=1e-2, warmup_steps=2,
                                                      total_steps=n_steps)),
                 ckpt_dir=str(tmp_path), ckpt_every=2, failure_injector=inject)
    assert not tr.maybe_restore()
    tr.init_state(torch.Generator().manual_seed(0))
    data = iter(SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)))
    hist = tr.run(data, n_steps, log_every=0)
    # steps 1-3 ran, the failure before step 4 restored step 2: 3 + 6 entries
    assert [h["step"] for h in hist] == [1, 2, 3, 3, 4, 5, 6, 7, 8]
    assert len(hist) > n_steps and tr.step == n_steps
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert tr.ckpt.steps() == [6, 8]  # keep = 2


def test_failure_before_the_first_checkpoint_raises(tmp_path):
    cfg = reduced(get_config("xlstm-125m")).with_(param_dtype=torch.float32)
    model = Model(cfg, device="cpu")

    def inject(step):
        if step == 1:
            raise SimulatedFailure("early")

    tr = Trainer(model, TrainConfig(), ckpt_dir=str(tmp_path), ckpt_every=5,
                 failure_injector=inject)
    tr.init_state(torch.Generator().manual_seed(0))
    data = iter(SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)))
    with pytest.raises(RuntimeError, match="before first checkpoint"):
        tr.run(data, 4, log_every=0)


def test_restore_gives_back_the_saved_tensors_bit_for_bit(tmp_path):
    cfg = reduced(get_config("gemma3-1b"))  # bf16 parameters, float32 state
    model = Model(cfg, device="cpu")
    tr = Trainer(model, TrainConfig(optim=AdamWConfig(warmup_steps=1, total_steps=4)),
                 ckpt_dir=str(tmp_path), ckpt_every=2)
    tr.init_state(torch.Generator().manual_seed(1))
    data = iter(SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)))
    tr.run(data, 2, log_every=0)
    saved = ({n: p.detach().clone() for n, p in model.named_parameters()},
             {k: {n: t.clone() for n, t in v.items()} for k, v in tr.opt_state.items()
              if isinstance(v, dict)})
    model2 = Model(cfg, device="cpu")
    tr2 = Trainer(model2, tr.tcfg, ckpt_dir=str(tmp_path), ckpt_every=2)
    assert tr2.maybe_restore() and tr2.step == 2
    assert int(tr2.opt_state["step"]) == 2 and tr2.opt_state["step"].dtype == torch.int32
    for n, p in model2.named_parameters():
        assert p.dtype == saved[0][n].dtype and torch.equal(p, saved[0][n]), n
    for k, tensors in saved[1].items():
        for n, t in tensors.items():
            assert torch.equal(tr2.opt_state[k][n], t), (k, n)


def test_train_cli_reduced_runs_and_learns(capsys):
    hist = train_cli.main(["--arch", "olmoe-1b-7b", "--reduced", "--steps", "20", "--batch", "4",
                           "--seq", "32", "--lr", "1e-2", "--log-every", "0",
                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert "on cpu" in out and len(hist) == 20
    seg = out.split("loss")[-1]
    a, b = (float(x.strip().rstrip(";")) for x in seg.split("->"))
    assert b < a, out
