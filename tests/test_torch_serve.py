"""The port's ServeEngine and launch/serve.py on the CPU against the JAX
engine: same converted weights, same numpy prompts of unequal lengths
(left padding, no pad mask).  Logits are compared teacher-forced on the
JAX tokens; greedy tokens must agree wherever the top-2 logit gap leaves
no room for a rounding tie."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.api import ModelAPI as JModelAPI  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine, pad_prompts  # noqa

TOL = 2e-4
BATCH, MAX_SEQ, MAX_NEW = 3, 48, 6


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_engine_matches_jax_engine(kv):
    jcfg = dataclasses.replace(
        jconfigs.smoke_variant(jconfigs.ARCHS["smollm-135m"]),
        kv_cache_dtype=kv)
    tcfg = dataclasses.replace(
        configs.smoke_variant(configs.ARCHS["smollm-135m"]),
        kv_cache_dtype=kv)
    japi = JModelAPI(jcfg)
    params = japi.model.init(jax.random.key(5))
    api = ModelAPI(tcfg, device="cpu")
    load_jax_params(api.model, jax.tree.map(np.asarray, params))

    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, tcfg.vocab, n).astype(np.int32)
               for n in (5, 11, 8)]
    jouts = JServeEngine(japi, params, batch=BATCH, max_seq=MAX_SEQ) \
        .run_batch([JRequest(p, MAX_NEW) for p in prompts])
    engine = ServeEngine(api, batch=BATCH, max_seq=MAX_SEQ)
    outs = engine.run_batch([Request(p, MAX_NEW) for p in prompts])
    assert [len(o) for o in outs] == [MAX_NEW] * BATCH
    assert engine.stats["decode_steps"] == MAX_NEW

    # teacher-forced: both models step on the JAX engine's tokens
    toks = pad_prompts([Request(p) for p in prompts], BATCH)
    S = toks.shape[1]
    shape = jconfigs.ShapeConfig("serve", "prefill", MAX_SEQ, BATCH)
    jl, jc = japi.prefill(params, {"tokens": jnp.asarray(toks)}, shape)
    tl, tc = api.prefill({"tokens": torch.from_numpy(toks)}, engine.shape)
    jsteps, tsteps = [np.asarray(jl[:, -1])], [tl[:, -1].numpy()]
    for t in range(MAX_NEW - 1):
        cur = np.array([[o[t]] for o in jouts], np.int32)
        pos = np.full((BATCH, 1), S + t, np.int32)
        jl, jc = japi.serve_step(params, {"tokens": jnp.asarray(cur),
                                          "positions": jnp.asarray(pos)}, jc)
        tl, tc = api.serve_step({"tokens": torch.from_numpy(cur),
                                 "positions": torch.from_numpy(pos)}, tc)
        jsteps.append(np.asarray(jl[:, -1]))
        tsteps.append(tl[:, -1].numpy())
    for j, t in zip(jsteps, tsteps):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)

    # greedy tokens: equal until a near-tie (top-2 gap within tolerance)
    for i in range(BATCH):
        for t in range(MAX_NEW):
            top2 = np.sort(jsteps[t][i])[-2:]
            if top2[1] - top2[0] <= 2 * TOL:
                break
            assert outs[i][t] == jouts[i][t], (i, t)


def test_serve_main_runs_on_cpu(capsys):
    engine = serve.main(["--smoke", "--device", "cpu", "--rounds", "2",
                         "--batch", "2", "--max-new", "3"])
    assert engine.stats["decode_steps"] == 6
    assert engine.stats["prefill_tokens"] > 0
    zeros = dict.fromkeys(ops.launch_counts, 0)
    assert f"kernel launches {zeros}" in capsys.readouterr().out


def test_serve_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelAPI(configs.smoke_variant(configs.ARCHS["smollm-135m"]))


def test_engine_rejects_an_oversized_batch():
    api = ModelAPI(configs.smoke_variant(configs.ARCHS["smollm-135m"]),
                   device="cpu")
    engine = ServeEngine(api, batch=1, max_seq=16)
    with pytest.raises(ValueError):
        engine.run_batch([Request(np.ones(3, np.int32))] * 2)
