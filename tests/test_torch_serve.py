"""The port's ServeEngine against the reference's, greedy, on the same weights.

Reduced gemma3-1b in float32; the reference's parameters are converted with
``params_from_jax``.  The prompts are those of
tests/test_integration.py::test_serving_generates_and_batches plus one longer
prompt whose prefill wraps the local layers' 16-slot ring buffer.  Greedy
tokens must be identical and the engines' ``stats`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServeConfig, ServeEngine

PROMPTS = [[5, 6, 7], [9, 10], [1, 2, 3, 4],
           [int(t) for t in np.random.default_rng(1).integers(1, 256, 21)]]


@pytest.fixture(scope="module")
def engines():
    jcfg = jreduced(jget_config("gemma3-1b")).with_(param_dtype=jnp.float32)
    tcfg = reduced(get_config("gemma3-1b")).with_(param_dtype=torch.float32)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    return (JServeEngine(jmodel, jparams, JServeConfig(max_batch=2)),
            ServeEngine(model, ServeConfig(max_batch=2)))


@pytest.mark.parametrize("max_new_tokens", [4, 12])
def test_greedy_tokens_and_stats_match_reference(engines, max_new_tokens):
    jeng, eng = engines
    assert len(PROMPTS[-1]) + max_new_tokens > 16  # past the local window
    jouts = jeng.generate(PROMPTS, max_new_tokens)
    outs = eng.generate(PROMPTS, max_new_tokens)
    assert [len(o) for o in outs] == [len(p) + max_new_tokens for p in PROMPTS]
    assert outs == [[int(t) for t in o] for o in jouts]
    # the port also counts its reads of the device: one a decode step, one a batch of 2
    syncs = jeng.stats["decode_steps"] + jeng.stats["requests"] // 2
    assert eng.stats == {**jeng.stats, "host_syncs": syncs}


def test_temperature_sampling_is_seeded(engines):
    _, eng = engines
    hot = ServeEngine(eng.model, ServeConfig(max_batch=2, temperature=1.0, seed=3))
    a = hot.generate(PROMPTS[:2], 6)
    b = hot.generate(PROMPTS[:2], 6)
    assert a == b
    assert all(0 <= t < eng.model.cfg.vocab for o in a for t in o)


def test_cli_serves_reduced_on_cpu(capsys):
    res = serve_cli.main(["--reduced", "--device", "cpu", "--requests", "3",
                          "--prompt-len", "6", "--new-tokens", "3", "--max-batch", "2"])
    assert res["stats"] == {"prefill_tokens": 18, "decode_steps": 6, "requests": 3,
                            "host_syncs": 8}
    assert [len(o) for o in res["outputs"]] == [9, 9, 9]
    assert "tok/s on cpu" in capsys.readouterr().out
