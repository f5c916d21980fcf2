"""The port's moe family (qwen3-moe-30b-a3b) on the CPU against the JAX
package, at float32 on its smoke variant (8 experts, top 2), from the
same weights (converted from the JAX init) and the same numpy inputs:

- ``moe_apply``: outputs, the aux metrics, and the routing (each token's
  experts and which sorted pairs the capacity keeps), at a token count
  where pairs drop, at one where none does, and with capacity_factor =
  n_experts / top_k, where none can;
- ``loss_fn`` with the aux losses, prefill and decode logits and caches;
- step 0's grads per JAX leaf (remat on and off: the aux sums are outputs
  of the checkpointed sub-block) and 10-step trajectories of
  ``make_train_step`` with both optimizers;
- the train state and snapshots across the two packages;
- decode against prefill on the port alone, with no pair dropped;
- ``ServeEngine`` against the JAX engine, and both launchers.

Tolerances as in tests/test_torch_train.py: 1e-5 relative for module
outputs, the loss and step 0's grads (relative L2 per leaf), 1e-4 over a
trajectory; logits 2e-4 as in tests/test_torch_model.py."""
import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.api import ModelAPI as JModelAPI  # noqa: E402
from repro.runtime.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import kdispatch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    flatten_paths, jax_leaves, load_jax_params, train_state_from_jax,
    train_state_to_jax)
from repro_torch.runtime.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import trainstep  # noqa: E402

NAME = "qwen3-moe-30b-a3b"
TOL = 1e-5
TRAJ_TOL = 1e-4
LOGIT_TOL = 2e-4
B, S, STEPS = 2, 32, 10


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


def jax_routing(p, x, cfg):
    """gate_e and keep of the JAX moe_apply's one-group path, by its own
    steps (moe.py:150-183)."""
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(-1, x.shape[-1])
    T = xt.shape[0]
    probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), -1)
    _, gate_e = jax.lax.top_k(probs, K)
    C = int(cfg.capacity_factor * K * T / E) or 1
    se = jnp.sort(gate_e.reshape(-1), stable=True)
    pos = jnp.arange(T * K) - jnp.searchsorted(se, se, side="left")
    return np.asarray(gate_e), np.asarray(pos < C)


MOE_CASES = [  # (B, S, capacity_factor, pairs drop)
    (2, 12, 1.25, True), (4, 16, 1.25, False), (2, 12, 4.0, False)]


@pytest.mark.parametrize("Bx,Sx,cf,drops", MOE_CASES)
def test_moe_apply_matches_jax(Bx, Sx, cf, drops):
    jcfg, cfg = cfgs(capacity_factor=cf)
    jp = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(1), jcfg,
                                                 jnp.float32))
    m = moe.MoE(cfg, torch.float32, "cpu")
    m.load_state_dict({k: t(v) for k, v in jp.items()}, strict=True)
    x = np.random.default_rng(Sx).normal(
        size=(Bx, Sx, cfg.d_model)).astype(np.float32)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, aux = m(t(x), cfg)
        logits, probs, gate_w, gate_e = moe.route(m.router,
                                                  t(x).view(-1, 64), cfg)
        C = int(cf * cfg.top_k * Bx * Sx / cfg.n_experts) or 1
        _, _, _, keep, _ = moe.dispatch(gate_e, gate_w, cfg.n_experts, C)
    want_e, want_keep = jax_routing(jp, x, jcfg)
    np.testing.assert_array_equal(gate_e.numpy(), want_e)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert rel(got.numpy(), want) <= TOL
    assert sorted(aux) == sorted(jaux) == sorted(moe.AUX_KEYS)
    for k in aux:
        assert rel(aux[k].item(), jaux[k]) <= TOL, k
    assert (aux["moe_dropped"].item() > 0) == drops


def build(seed=0, **over):
    jcfg, tcfg = cfgs(**over)
    japi, api = JModelAPI(jcfg), ModelAPI(tcfg, device="cpu")
    jstate = jtrainstep.init_state(japi, jax.random.key(seed))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                 api.model)
    return japi, jstate, api, state


def batches(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(1, vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(n)]


def jx(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tx(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_loss_fn_with_aux_matches_jax():
    japi, jstate, api, _ = build(1)
    b = batches(2, 1, api.cfg.vocab)[0]
    jloss, jm = japi.train_loss(jstate["params"], jx(b))
    loss, m = api.train_loss(tx(b))
    assert sorted(m) == sorted(jm) == sorted(
        ["loss", "total_loss", *moe.AUX_KEYS])
    for k in m:
        assert rel(m[k].item(), jm[k]) <= TOL, k
    assert rel(loss.item(), jloss) <= TOL
    assert loss.item() > m["loss"].item() and m["moe_dropped"].item() > 0


@pytest.mark.parametrize("remat", [False, True])
def test_step0_grads_match_jax(remat):
    japi, jstate, api, _ = build(3, remat=remat)
    b = batches(4, 1, api.cfg.vocab)[0]
    jgrads = jax.grad(lambda p: japi.train_loss(p, jx(b))[0])(
        jstate["params"])
    want = flatten_paths(jax.tree.map(np.asarray, jgrads))
    loss, _ = api.train_loss(tx(b))
    leaves = jax_leaves(api.model)
    assert [leaf.path for leaf in leaves] == list(want)
    params = [p for leaf in leaves for p in leaf.params]
    grads = dict(zip(params, torch.autograd.grad(loss, params)))
    for leaf in leaves:
        g = leaf.stack([grads[p] for p in leaf.params]).numpy()
        assert rel_l2(g, want[leaf.path]) <= TOL, leaf.path
    # the router's grad carries the aux losses (the xent alone reaches it
    # only through the gate weights)
    assert np.abs(want["blocks/b0/ffn/router"]).max() > 0


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_trajectory_matches_make_train_step(opt):
    japi, jstate, api, state = build(5, optimizer=opt)
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=STEPS)
    jstep = jax.jit(jtrainstep.make_train_step(japi, **kw))
    step = trainstep.make_train_step(api, **kw)
    keys = ("loss", "total_loss", "grad_norm", "lr", *moe.AUX_KEYS)
    got, want = [], []
    for b in batches(6, STEPS, api.cfg.vocab):
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
    if opt == "adafactor":       # wi (groups, E, d, f): factored last two
        v = state["opt"]["v"]["blocks/b0/ffn/wi"]
        G, E, d, f = (api.model.groups, api.cfg.n_experts, api.cfg.d_model,
                      api.cfg.d_ff)
        assert tuple(v["vr"].shape) == (G, E, d)
        assert tuple(v["vc"].shape) == (G, E, f)


def test_accumulation_averages_the_aux_metrics():
    """accum 2: the metrics (aux included) are the mean of the two
    microbatches', as trainstep.py:51-85 of the JAX package averages."""
    japi, jstate, api, state = build(5)
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=STEPS, accum=2)
    b = batches(7, 1, api.cfg.vocab)[0]
    _, jm = jax.jit(jtrainstep.make_train_step(japi, **kw))(jstate, jx(b))
    _, m = trainstep.make_train_step(api, **kw)(state, tx(b))
    for k in m:
        assert rel(m[k].item(), jm[k]) <= TRAJ_TOL, k


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_snapshots_restore_across_packages(tmp_path, opt):
    japi, jstate, api, _ = build(7, optimizer=opt)
    jstep = jax.jit(jtrainstep.make_train_step(japi, warmup=1))
    for b in batches(8, 2, api.cfg.vocab):
        jstate, _ = jstep(jstate, jx(b))
    want = jax.tree.map(np.asarray, jstate)
    state = train_state_from_jax(want, api.model)
    for tree in (train_state_to_jax(state),):
        fa, fb = flatten_paths(tree), flatten_paths(want)
        assert all(fa[k].tobytes() == np.asarray(fb[k]).tobytes()
                   for k in fb) and sorted(fa) == sorted(fb)
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


def serving(seed=2, **over):
    jcfg, tcfg = cfgs(**over)
    japi = JModelAPI(jcfg)
    params = japi.model.init(jax.random.key(seed))
    api = ModelAPI(tcfg, device="cpu")
    load_jax_params(api.model, jax.tree.map(np.asarray, params))
    return japi, params, api


@pytest.mark.parametrize("Sp", [12, 40])
def test_prefill_and_decode_match_jax(Sp):
    """Prefill logits and every cache leaf, then 4 decode steps (T = B = 3
    tokens a step: capacity 1, as in the JAX package)."""
    japi, params, api = serving()
    Bp, L = 3, 64
    toks = np.random.default_rng(Sp).integers(
        1, api.cfg.vocab, (Bp, Sp)).astype(np.int32)
    shape = jconfigs.ShapeConfig("p", "prefill", L, Bp)
    jl, jc = japi.prefill(params, {"tokens": jnp.asarray(toks)}, shape)
    tl, tc = api.prefill({"tokens": t(toks)}, configs.ShapeConfig(
        "p", "prefill", L, Bp))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for g in range(api.model.groups):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tc[g][leaf].numpy(),
                                       np.asarray(jc["b0"][leaf][g]),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for i in range(4):
        cur = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)[:, None]
        pos = np.full((Bp, 1), Sp + i, np.int32)
        jl, jc = japi.serve_step(params, {"tokens": jnp.asarray(cur),
                                          "positions": jnp.asarray(pos)}, jc)
        tl, tc = api.serve_step({"tokens": t(cur), "positions": t(pos)}, tc)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


def test_decode_matches_prefill_without_drops():
    """Decode after S tokens against a prefill of S + 1 on the port alone,
    with capacity_factor = n_experts / top_k so that C >= T and no pair
    can drop (at the served 1.25 a decode step of B tokens has capacity 1
    and drops pairs that the prefill keeps)."""
    _, tcfg = cfgs()
    cfg = dataclasses.replace(tcfg, capacity_factor=tcfg.n_experts /
                              tcfg.top_k)
    api = ModelAPI(cfg, device="cpu")
    api.model.init(torch.Generator().manual_seed(4))
    m = api.model
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 9)).astype(np.int32))
    full, _ = m.prefill({"tokens": toks}, cache_len=16)
    logits, caches = m.prefill({"tokens": toks[:, :8]}, cache_len=16)
    step, _ = m.decode_step(toks[:, 8:], caches, torch.full((2, 1), 8))
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 0].numpy(),
                               rtol=5e-3, atol=5e-3)


def test_engine_matches_jax_engine():
    """Greedy tokens of the port's engine == the JAX engine's, until a
    near-tie (top-2 gap within the tolerance)."""
    japi, params, api = serving(6)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, api.cfg.vocab, n).astype(np.int32)
               for n in (5, 19, 30)]
    batch, max_seq, max_new = 3, 48, 5
    jouts = JServeEngine(japi, params, batch=batch, max_seq=max_seq) \
        .run_batch([JRequest(p, max_new) for p in prompts])
    engine = ServeEngine(api, batch=batch, max_seq=max_seq)
    ops.reset_launch_counts()
    outs = engine.run_batch([Request(p, max_new) for p in prompts])
    assert engine.stats["decode_steps"] == max_new
    assert all(n == 0 for n in ops.launch_counts.values())   # CPU: plain
    for i in range(batch):
        if outs[i] != jouts[i]:
            t0 = next(j for j in range(max_new) if outs[i][j] != jouts[i][j])
            toks = np.concatenate([prompts[i], jouts[i][:t0]])[None]
            jl, _ = japi.prefill(params, {"tokens": jnp.asarray(
                toks.astype(np.int32))}, jconfigs.ShapeConfig(
                    "p", "prefill", max_seq, 1))
            top2 = np.sort(np.asarray(jl[0, -1]))[-2:]
            assert top2[1] - top2[0] <= 2 * LOGIT_TOL, (i, t0)


def test_serve_main_runs_moe_on_cpu(capsys):
    engine = serve.main(["--arch", NAME, "--smoke", "--device", "cpu",
                         "--rounds", "2", "--batch", "2", "--max-new", "3",
                         "--max-seq", "80"])
    assert engine.stats["decode_steps"] == 6
    zeros = dict.fromkeys(ops.launch_counts, 0)
    assert f"kernel launches {zeros}" in capsys.readouterr().out


def test_train_main_runs_moe_on_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))   # its corpus
    with kdispatch.using_device("cpu"):
        losses = train.main(["--arch", NAME, "--smoke", "--device", "cpu",
                             "--steps", "3", "--batch", "2", "--seq-len",
                             "32"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "done: 3 steps" in capsys.readouterr().out
