"""The port's enc-dec family (whisper-medium) on the CPU against the JAX
package, at float32 on its smoke variant (2 encoder and 2 decoder
layers, 4 query and 2 KV heads), from the same weights (converted from
the JAX init) and the same numpy inputs (seeded normals for the frames,
the conv frontend being a stub in both packages):

- ``sinusoid_pos`` bit for bit;
- ``encode`` (train mode, and prefill mode through the flash wrapper's
  plain version), ``cross_kv``, the prefill's caches and 4 decode steps;
- ``loss_fn`` and its grads per JAX leaf against ``jax.grad``, with remat
  off and on;
- ``jax_leaves`` path for path against ``jax.tree.leaves``;
- train steps of ``make_train_step`` with AdamW and Adafactor, and with
  the batch split into two microbatches;
- snapshots across the two packages; both launchers' ``ValueError``.

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
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.api import ModelAPI as JModelAPI  # noqa: E402
from repro.runtime.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    flatten_paths, jax_leaves, load_jax_params, params_to_jax,
    train_state_from_jax, train_state_to_jax)
from repro_torch.runtime.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.train import trainstep  # noqa: E402

NAME = "whisper-medium"
TOL = 1e-5
TRAJ_TOL = 1e-4
LOGIT_TOL = 2e-4
B, S, STEPS = 2, 24, 3


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
    """Numpy inputs of the JAX ``input_specs``: seeded normals for the
    frames, tokens in [1, vocab)."""
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


@pytest.mark.parametrize("S_,d", [(1, 64), (24, 64), (1500, 1024),
                                  (7, 10)])
def test_sinusoid_pos_bit_for_bit(S_, d):
    got, want = encdec.sinusoid_pos(S_, d), jencdec.sinusoid_pos(S_, d)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_input_specs_match_jax():
    japi, _, api = serving()
    for kind in ("train", "prefill", "decode"):
        want = japi.input_specs(jconfigs.ShapeConfig("s", kind, S, B))
        got = api.input_specs(configs.ShapeConfig("s", kind, S, B))
        assert {k: (v.shape, str(v.dtype)[6:]) for k, v in got.items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_encode_and_cross_kv_match_jax(mode):
    japi, params, api = serving()
    frames = inputs(japi, "train", S, B, 0)["frames"]
    enc = japi.model.encode(params, jnp.asarray(frames))
    jk, jv = japi.model.cross_kv(params, enc)
    with torch.no_grad():
        got = api.model.encode(t(frames), mode)
        cross = api.model.cross_kv(got)
    assert rel(got.numpy(), enc) <= TOL
    assert len(cross) == api.cfg.n_layers
    for i, (k, v) in enumerate(cross):
        assert k.shape == (B, S, api.cfg.n_kv_heads, api.cfg.hd)
        assert rel(k.numpy(), jk[i]) <= TOL and rel(v.numpy(), jv[i]) <= TOL


def test_jax_leaves_follow_jax_tree_leaves():
    """Path for path, in order, and each leaf's layer stack equal to the
    JAX leaf (the stacked subtrees are enc_blocks and dec_blocks)."""
    japi, params, api = serving(1)
    jleaves = jax.tree_util.tree_leaves_with_path(params)
    want = ["/".join(k.key for k in path) for path, _ in jleaves]
    leaves = jax_leaves(api.model)
    assert [leaf.path for leaf in leaves] == want
    for leaf, (_, jl) in zip(leaves, jleaves):
        assert leaf.stacked == leaf.path.startswith(("enc_blocks/",
                                                     "dec_blocks/"))
        assert len(leaf.params) == (jl.shape[0] if leaf.stacked else 1)
        got = leaf.stack([p.detach() for p in leaf.params]).numpy()
        assert got.tobytes() == np.asarray(jl).tobytes(), leaf.path
    flat = flatten_paths(params_to_jax(api.model))
    assert list(flat) == want


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    japi, jstate, api, _ = build(3, remat=remat)
    b = inputs(japi, "train", S, B, 4)
    jloss, jm = japi.train_loss(jstate["params"], jx(b))
    jgrads = jax.grad(lambda p: japi.train_loss(p, jx(b))[0])(
        jstate["params"])
    want = flatten_paths(jax.tree.map(np.asarray, jgrads))
    loss, m = api.train_loss(tx(b))
    assert sorted(m) == sorted(jm) == ["loss", "total_loss"]
    assert rel(loss.item(), jloss) <= TOL
    leaves = jax_leaves(api.model)
    params = [p for leaf in leaves for p in leaf.params]
    grads = dict(zip(params, torch.autograd.grad(loss, params)))
    for leaf in leaves:
        g = leaf.stack([grads[p] for p in leaf.params]).numpy()
        assert rel_l2(g, want[leaf.path]) <= TOL, leaf.path
    assert np.abs(want["dec_blocks/cross/wk"]).max() > 0


def test_prefill_caches_and_decode_match_jax():
    """Prefill of a BOS against frames: logits, the self-attention caches
    and the cross (k, v); then 4 decode steps."""
    japi, params, api = serving()
    L = 16
    b = inputs(japi, "prefill", S, B, 5)
    jl, (jc, (jk, jv)) = japi.prefill(params, jx(b),
                                      jconfigs.ShapeConfig("p", "prefill",
                                                           L, B))
    tl, (tc, cross) = api.prefill(tx(b), configs.ShapeConfig(
        "p", "prefill", L, B))
    assert tuple(tl.shape) == (B, 1, api.cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for i in range(api.cfg.n_layers):
        assert tc[i]["len"] == int(jc["len"][i]) == 1
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tc[i][leaf].numpy(),
                                       np.asarray(jc[leaf][i]),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(cross[i][0].numpy(), jk[i],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(cross[i][1].numpy(), jv[i],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    jcaches, caches = (jc, (jk, jv)), (tc, cross)
    for i in range(4):
        cur = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)[:, None]
        pos = np.full((B, 1), 1 + i, np.int32)
        jl, jcaches = japi.serve_step(params, {
            "tokens": jnp.asarray(cur), "positions": jnp.asarray(pos)},
            jcaches)
        tl, caches = api.serve_step({"tokens": t(cur), "positions": t(pos)},
                                    caches)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
    assert caches[0][0]["len"] == 5


def test_decode_matches_prefill():
    """On the port alone: decode after a prompt of 5 tokens against a
    prefill of 6, over the same frames."""
    japi, _, api = serving(4)
    b = inputs(japi, "train", S, 2, 6)
    toks = t(b["tokens"][:, :6])
    m = api.model
    full, _ = m.prefill({"frames": t(b["frames"]), "tokens": toks},
                        cache_len=16)
    _, caches = m.prefill({"frames": t(b["frames"]), "tokens": toks[:, :5]},
                          cache_len=16)
    step, _ = m.decode_step(toks[:, 5:], caches, torch.full((2, 1), 5))
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 0].numpy(),
                               rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("opt,accum", [("adamw", 1), ("adafactor", 1),
                                       ("adafactor", 2)])
def test_train_steps_match_make_train_step(opt, accum):
    """The metrics of every step and the state after them; accum 2 splits
    frames, tokens and labels into two microbatches."""
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
    if opt == "adafactor":       # stacked (L, d) norms and dec_pos factored
        v = state["opt"]["v"]
        assert set(v["enc_blocks/ln1"]) == {"vr", "vc"}
        assert tuple(v["dec_blocks/lnx"]["vr"].shape) == (api.cfg.n_layers,)
        assert set(v["dec_pos"]) == {"vr", "vc"}
        assert set(v["enc_norm"]) == {"v"}


def test_bf16_casts_follow_jax():
    """The leaves the bf16 step computes with in bf16 are those of two or
    more dims in the JAX layout: the enc and dec stacks (norms too),
    ``embed`` and ``dec_pos``; not ``enc_norm`` or ``final_norm``."""
    japi, params, api = serving(1)
    leaves = jax_leaves(api.model)
    comp = trainstep._compute_params(leaves, cast_bf16=True)
    cast = {leaf.path for leaf in leaves
            if comp[leaf.params[0]].dtype == torch.bfloat16}
    want = {p for p, v in flatten_paths(jax.tree.map(np.asarray,
                                                     params)).items()
            if v.ndim >= 2}
    assert cast == want
    assert {"dec_pos", "enc_blocks/ln1", "dec_blocks/lnx"} <= cast
    assert not {"enc_norm", "final_norm"} & cast


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


def test_serve_main_raises_for_want_of_frames():
    with pytest.raises(ValueError, match=r"'frames'.*queue 3, item s"):
        serve.main(["--arch", NAME, "--smoke", "--device", "cpu"])


def test_train_main_raises_for_want_of_frames(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(ValueError, match=r"'frames'.*queue 3, item s"):
        train.main(["--arch", NAME, "--smoke", "--device", "cpu",
                    "--steps", "1"])
    assert not list(tmp_path.iterdir())     # raised before any corpus
