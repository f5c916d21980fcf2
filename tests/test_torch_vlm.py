"""The port's vlm family (internvl2-26b) on the CPU against the JAX
package, at float32 on its smoke variant (8 patch embeddings, 2 layers),
from the same weights (converted from the JAX init) and the same numpy
inputs (seeded normals for the patches, the InternViT frontend being a
stub in both packages):

- ``embed_inputs`` with patches, and without them (decode);
- ``loss_fn`` and its grads per JAX leaf against ``jax.grad``;
- prefill with patches, every cache leaf, then decode steps;
- train steps of ``make_train_step`` with AdamW and Adafactor, and with
  the batch split into two microbatches;
- the converter's round trip and snapshots across the two packages;
- text-only serving (``ServeEngine`` token for token against the JAX
  engine, and the launcher); the train launcher's ``ValueError``.

Tolerances as in tests/test_torch_moe.py: 1e-5 relative for module
outputs, the loss and the grads (relative L2 per leaf), 1e-4 over train
steps; logits and caches 2e-4 as in tests/test_torch_model.py."""
import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.api import ModelAPI as JModelAPI  # noqa: E402
from repro.runtime.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    flatten_paths, jax_leaves, load_jax_params, params_to_jax,
    train_state_from_jax, train_state_to_jax)
from repro_torch.runtime.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import trainstep  # noqa: E402

NAME = "internvl2-26b"
TOL = 1e-5
TRAJ_TOL = 1e-4
LOGIT_TOL = 2e-4
B, S, STEPS = 2, 40, 3          # S counts the 8 patches and 32 tokens


def cfgs(**over):
    return (dataclasses.replace(jconfigs.smoke_variant(jconfigs.ARCHS[NAME]),
                                **over),
            dataclasses.replace(configs.smoke_variant(configs.ARCHS[NAME]),
                                **over))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def inputs(japi, kind, seq, batch, seed):
    """Numpy inputs of the JAX ``input_specs``: seeded normals for float
    inputs, tokens in [1, vocab) for int32 ones."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, spec in japi.input_specs(jconfigs.ShapeConfig(
            "s", kind, seq, batch)).items():
        if spec.dtype == jnp.int32:
            out[k] = rng.integers(1, japi.cfg.vocab, spec.shape
                                  ).astype(np.int32)
        else:
            out[k] = rng.normal(size=spec.shape).astype(np.float32)
    return out


def jx(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tx(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def serving(seed=2, **over):
    jcfg, tcfg = cfgs(**over)
    japi = JModelAPI(jcfg)
    params = japi.model.init(jax.random.key(seed))
    api = ModelAPI(tcfg, device="cpu")
    load_jax_params(api.model, jax.tree.map(np.asarray, params))
    return japi, params, api


def build(seed=0, **over):
    jcfg, tcfg = cfgs(**over)
    japi, api = JModelAPI(jcfg), ModelAPI(tcfg, device="cpu")
    jstate = jtrainstep.init_state(japi, jax.random.key(seed))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                 api.model)
    return japi, jstate, api, state


def test_input_specs_match_jax():
    japi, _, api = serving()
    for kind in ("train", "prefill", "decode"):
        want = japi.input_specs(jconfigs.ShapeConfig("s", kind, S, B))
        got = api.input_specs(configs.ShapeConfig("s", kind, S, B))
        assert {k: (v.shape, str(v.dtype)[6:]) for k, v in got.items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert got["tokens"] == (B, 1)        # a Spec is its shape too


def test_embed_inputs_with_and_without_patches():
    japi, params, api = serving()
    b = inputs(japi, "prefill", S, B, 0)
    want = japi.model.embed_inputs(params, jnp.asarray(b["tokens"]),
                                   jnp.asarray(b["patches"]))
    with torch.no_grad():
        got = api.model.embed_inputs(t(b["tokens"]), t(b["patches"]))
    assert got.shape == (B, S, api.cfg.d_model)
    assert rel(got.numpy(), want) <= TOL
    with torch.no_grad():
        text = api.model.embed_inputs(t(b["tokens"]))
    np.testing.assert_array_equal(text.numpy(), got[:, 8:].numpy())


def test_loss_and_grads_match_jax():
    japi, jstate, api, _ = build(3)
    b = inputs(japi, "train", S, B, 4)
    jloss, jm = japi.train_loss(jstate["params"], jx(b))
    jgrads = jax.grad(lambda p: japi.train_loss(p, jx(b))[0])(
        jstate["params"])
    want = flatten_paths(jax.tree.map(np.asarray, jgrads))
    loss, m = api.train_loss(tx(b))
    assert sorted(m) == sorted(jm) == ["loss", "total_loss"]
    assert rel(loss.item(), jloss) <= TOL
    leaves = jax_leaves(api.model)
    assert [leaf.path for leaf in leaves] == list(want)
    params = [p for leaf in leaves for p in leaf.params]
    grads = dict(zip(params, torch.autograd.grad(loss, params)))
    for leaf in leaves:
        g = leaf.stack([grads[p] for p in leaf.params]).numpy()
        assert rel_l2(g, want[leaf.path]) <= TOL, leaf.path
    assert np.abs(want["vision_proj"]).max() > 0


def test_loss_needs_patches():
    _, _, api = serving()
    b = {k: v for k, v in inputs(JModelAPI(cfgs()[0]), "train", S, B,
                                 0).items() if k != "patches"}
    with pytest.raises(ValueError, match="patches"):
        api.train_loss(tx(b))


def test_prefill_with_patches_then_decode_match_jax():
    japi, params, api = serving()
    L = 64
    b = inputs(japi, "prefill", S, B, 5)
    shape = jconfigs.ShapeConfig("p", "prefill", L, B)
    jl, jc = japi.prefill(params, jx(b), shape)
    tl, tc = api.prefill(tx(b), configs.ShapeConfig("p", "prefill", L, B))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for g in range(api.model.groups):
        assert tc[g]["len"] == int(jc["b0"]["len"][g]) == S
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tc[g][leaf].numpy(),
                                       np.asarray(jc["b0"][leaf][g]),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for i in range(4):
        cur = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)[:, None]
        pos = np.full((B, 1), S + i, np.int32)
        jl, jc = japi.serve_step(params, {"tokens": jnp.asarray(cur),
                                          "positions": jnp.asarray(pos)}, jc)
        tl, tc = api.serve_step({"tokens": t(cur), "positions": t(pos)}, tc)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


def test_decode_matches_prefill_with_patches():
    """On the port alone: decode after the patches and S tokens against a
    prefill of the patches and S + 1 tokens."""
    _, _, api = serving(4)
    b = inputs(JModelAPI(cfgs()[0]), "prefill", 17, 2, 6)
    m = api.model
    full, _ = m.prefill(tx(b), cache_len=24)
    short = dict(tx(b), tokens=t(b["tokens"][:, :-1]))
    _, caches = m.prefill(short, cache_len=24)
    step, _ = m.decode_step(t(b["tokens"][:, -1:]), caches,
                            torch.full((2, 1), 16))
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 0].numpy(),
                               rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("opt,accum", [("adamw", 1), ("adafactor", 1),
                                       ("adamw", 2)])
def test_train_steps_match_make_train_step(opt, accum):
    """The metrics of every step and the state after them; accum 2 splits
    patches, tokens and labels into two microbatches."""
    japi, jstate, api, state = build(5, optimizer=opt)
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=STEPS, accum=accum)
    jstep = jax.jit(jtrainstep.make_train_step(japi, **kw))
    step = trainstep.make_train_step(api, **kw)
    keys = ("loss", "total_loss", "grad_norm", "lr")
    got, want = [], []
    for i in range(STEPS):
        b = inputs(japi, "train", S, B, 10 + i)
        jstate, jm = jstep(jstate, jx(b))
        state, m = step(state, tx(b))
        assert sorted(m) == sorted(jm)
        want.append([float(jm[k]) for k in keys])
        got.append([float(m[k]) for k in keys])
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=0)
    a = flatten_paths(train_state_to_jax(state))
    b = flatten_paths(jax.tree.map(np.asarray, jstate))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], rtol=TRAJ_TOL, atol=1e-6,
                                   err_msg=k)
    if opt == "adafactor":           # vision_proj (d, d): factored
        v = state["opt"]["v"]["vision_proj"]
        assert set(v) == {"vr", "vc"}


def test_bf16_casts_follow_jax():
    """The leaves the bf16 step computes with in bf16: those of two or
    more dims in the JAX layout, ``vision_proj`` among them."""
    _, _, api, _ = build(1)
    leaves = jax_leaves(api.model)
    comp = trainstep._compute_params(leaves, cast_bf16=True)
    cast = {leaf.path for leaf in leaves
            if comp[leaf.params[0]].dtype == torch.bfloat16}
    jparams = JModelAPI(cfgs()[0]).model.init(jax.random.key(0))
    want = {p for p, v in flatten_paths(jax.tree.map(np.asarray,
                                                     jparams)).items()
            if v.ndim >= 2}
    assert cast == want and "vision_proj" in cast
    assert "final_norm" not in cast and "blocks/b0/ln1" in cast


def test_converter_round_trips():
    japi, params, api = serving(7)
    want = flatten_paths(jax.tree.map(np.asarray, params))
    got = flatten_paths(params_to_jax(api.model))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_snapshots_restore_across_packages(tmp_path, opt):
    japi, jstate, api, _ = build(7, optimizer=opt)
    jstep = jax.jit(jtrainstep.make_train_step(japi, warmup=1))
    for i in range(2):
        jstate, _ = jstep(jstate, jx(inputs(japi, "train", S, B, 20 + i)))
    want = jax.tree.map(np.asarray, jstate)
    js = JStore(str(tmp_path / "jax"), async_io=True)
    js.save(2, want)
    js.close()
    other = ModelAPI(api.cfg, device="cpu")
    ts = CheckpointStore(str(tmp_path / "jax"))
    restored, mani = ts.restore(like=trainstep.init_state(
        other, torch.Generator().manual_seed(1)))
    ts.close()
    assert mani["step"] == 2
    ts = CheckpointStore(str(tmp_path / "port"))
    ts.save(2, restored)
    ts.close()
    got, _ = JStore(str(tmp_path / "port"), async_io=False).restore(
        2, like=want)
    for tree in (train_state_to_jax(restored), got):
        fa, fb = flatten_paths(tree), flatten_paths(want)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            x, y = np.asarray(fa[k]), np.asarray(fb[k])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k


def test_text_only_engine_matches_jax_engine():
    """Text-only prompts, as the JAX engine serves this family: greedy
    tokens equal until a near-tie (top-2 gap within the tolerance)."""
    japi, params, api = serving(6)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, api.cfg.vocab, n).astype(np.int32)
               for n in (5, 19, 30)]
    batch, max_seq, max_new = 3, 48, 5
    jouts = JServeEngine(japi, params, batch=batch, max_seq=max_seq) \
        .run_batch([JRequest(p, max_new) for p in prompts])
    engine = ServeEngine(api, batch=batch, max_seq=max_seq)
    outs = engine.run_batch([Request(p, max_new) for p in prompts])
    for i in range(batch):
        if outs[i] != jouts[i]:
            t0 = next(j for j in range(max_new) if outs[i][j] != jouts[i][j])
            toks = np.concatenate([prompts[i], jouts[i][:t0]])[None]
            jl, _ = japi.prefill(params, {"tokens": jnp.asarray(
                toks.astype(np.int32))}, jconfigs.ShapeConfig(
                    "p", "prefill", max_seq, 1))
            top2 = np.sort(np.asarray(jl[0, -1]))[-2:]
            assert top2[1] - top2[0] <= 2 * LOGIT_TOL, (i, t0)


def test_serve_main_serves_text_only_on_cpu(capsys):
    engine = serve.main(["--arch", NAME, "--smoke", "--device", "cpu",
                         "--rounds", "2", "--batch", "2", "--max-new", "3",
                         "--max-seq", "64"])
    assert engine.stats["decode_steps"] == 6
    zeros = dict.fromkeys(ops.launch_counts, 0)
    assert f"kernel launches {zeros}" in capsys.readouterr().out


def test_train_main_raises_for_want_of_patches(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(ValueError, match=r"'patches'.*queue 3, item s"):
        train.main(["--arch", NAME, "--smoke", "--device", "cpu",
                    "--steps", "1"])
    assert not list(tmp_path.iterdir())     # raised before any corpus
