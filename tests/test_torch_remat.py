"""The port's remat policies (``distributed/remat.py``) against the reference's.

The reference runs once, in a subprocess: ``jax.value_and_grad`` of
``Model.loss_fn`` under ``remat_policy`` "full", "dots" and "dots_no_batch"
and without remat, for the reduced gemma3-1b and olmoe-1b-7b in float32 on
``Model.init(PRNGKey(0))``, and its ``POLICIES`` names.  The port carries
the same weights across (``params_from_jax``) and computes the same: each
policy's loss and gradients equal the port's own without remat within 1e-6
(remat only moves where the forward's values come from), and the
reference's within 3e-5 (its ``_tol``).

What each policy keeps is checked op by op: the matrix products aten runs in
the backward, counted with a dispatch mode.  "dots" recomputes none of the
forward's products, "dots_no_batch" only the batched ones (``bmm``, the
attention's), "full" all of them.
"""

import os
import pickle
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.configs import get_config, reduced
from repro_torch.distributed.remat import POLICIES, get_policy, maybe_remat
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig
from repro_torch.training import TrainConfig, build_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("gemma3-1b", "olmoe-1b-7b")
REMAT = ("full", "dots", "dots_no_batch")

_REFERENCE = """
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.distributed.remat import POLICIES
from repro.models import Model

out = {"policies": sorted(POLICIES)}
for arch in ("gemma3-1b", "olmoe-1b-7b"):
    cfg = reduced(get_config(arch)).with_(param_dtype=jnp.float32)
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    out[arch] = {"params": jax.tree.map(np.asarray, params), "tokens": tokens}
    for policy in ("none", "full", "dots", "dots_no_batch"):
        f = lambda p: model.loss_fn(p, jnp.asarray(tokens), remat=policy != "none",
                                    remat_policy=policy if policy != "none" else "full")
        (loss, _), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        out[arch][policy] = (float(loss), jax.tree.map(np.asarray, g))
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("remat") / "reference.pkl"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _model(reference, arch) -> Model:
    cfg = reduced(get_config(arch)).with_(param_dtype=torch.float32)
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(reference[arch]["params"], cfg))
    return model.requires_grad_(True)


def _loss_and_grads(model, tokens, policy):
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss_fn(torch.from_numpy(tokens), remat=policy != "none",
                            remat_policy=policy if policy != "none" else "full")
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_policy_names_equal_the_reference(reference):
    assert sorted(POLICIES) == reference["policies"]
    assert get_policy("none") is None
    with pytest.raises(KeyError, match="unknown remat policy"):
        get_policy("some")
    f = lambda x: x * 2  # noqa: E731
    assert maybe_remat(f, "none") is f


def test_policies_keep_the_products_they_name():
    aten = torch.ops.aten
    keep = {name: {op for op in (aten.mm.default, aten.addmm.default, aten.bmm.default,
                                 aten.baddbmm.default, aten._grouped_mm.default, aten.add.Tensor)
                   if get_policy(name)(None, op) == CheckpointPolicy.MUST_SAVE}
            for name in REMAT}
    assert keep["full"] == set()
    assert keep["dots_no_batch"] == {aten.mm.default, aten.addmm.default}
    assert keep["dots"] == {aten.mm.default, aten.addmm.default, aten.bmm.default,
                            aten.baddbmm.default, aten._grouped_mm.default}


@pytest.mark.parametrize("policy", REMAT)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_no_remat_and_the_reference(reference, arch, policy):
    model = _model(reference, arch)
    tokens = reference[arch]["tokens"]
    base_loss, base = _loss_and_grads(model, tokens, "none")
    loss, grads = _loss_and_grads(model, tokens, policy)
    assert abs(loss - base_loss) <= 1e-6
    for name, g in base.items():
        torch.testing.assert_close(grads[name], g, rtol=1e-6, atol=1e-6, msg=name)
    ref_loss, ref_grads = reference[arch][policy]
    np.testing.assert_allclose(loss, ref_loss, rtol=3e-5, atol=3e-5)
    want = params_from_jax(ref_grads, model.cfg)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=3e-5, atol=3e-5,
                                   err_msg=name)


class _Products(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.counts[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


def test_backward_recomputes_what_the_policy_drops(reference):
    model = _model(reference, "gemma3-1b")
    tokens = torch.from_numpy(reference["gemma3-1b"]["tokens"])
    counts = {}
    for policy in ("none", *REMAT):
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss_fn(tokens, remat=policy != "none",
                                remat_policy=policy if policy != "none" else "full")
        with _Products() as mode:
            loss.backward()
        counts[policy] = mode.counts
    none = counts["none"]
    assert counts["dots"] == none                       # every product kept
    assert counts["dots_no_batch"]["mm"] == none["mm"]  # projections kept,
    assert counts["dots_no_batch"]["bmm"] > none["bmm"]  # attention recomputed
    assert counts["full"]["mm"] > none["mm"] and counts["full"]["bmm"] > none["bmm"]


@pytest.mark.parametrize("policy", REMAT)
def test_train_steps_under_each_policy_equal_no_remat(policy):
    cfg = reduced(get_config("olmoe-1b-7b")).with_(param_dtype=torch.float32)
    rng = np.random.default_rng(1)
    batches = [(rng.integers(0, cfg.vocab, (4, 16)), rng.integers(0, cfg.vocab, (4, 16)))
               for _ in range(2)]
    params = {}
    for name in ("none", policy):
        model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        tcfg = TrainConfig(microbatches=2, remat_policy=name,
                           optim=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6))
        step = build_train_step(model, tcfg)
        state = step.init_state()
        for tokens, labels in batches:
            state, _ = step(state, tokens, labels)
        params[name] = {k: p.detach().clone() for k, p in model.named_parameters()}
    for k, p in params["none"].items():
        torch.testing.assert_close(params[policy][k], p, rtol=1e-6, atol=1e-6, msg=k)
