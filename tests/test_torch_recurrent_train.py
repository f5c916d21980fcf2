"""Training the port's ssm (rwkv6-3b) and hybrid (recurrentgemma-9b)
families on the CPU against the JAX package, at float32 on their smoke
variants, from the same weights (the JAX ``init_state`` converted) and the
same numpy batches:

- the chunked WKV-6 recurrence (``rwkv6.wkv6_chunked``), values and
  grads against ``jax.grad`` of the JAX model's ``wkv6_chunked``, and at
  lengths that are no multiple of its chunk (which the JAX function
  asserts; the port pads) against ``repro.kernels.ref.wkv6_ref``;
- the RG-LRU doubling scan (``rglru.rglru_scan``), values and grads
  against the JAX model's associative scan, with and without h0;
- the loss, step 0's grads per JAX leaf (remat on and off), and 10-step
  trajectories of ``make_train_step`` with both optimizers, with and
  without microbatch accumulation and remat, against
  ``repro.train.trainstep.make_train_step``;
- the leaves that the bf16 compute copies cast, and Adafactor's factored
  state on the stacked leaves;
- snapshots that each package writes and the other restores;
- train mode calls no kernel wrapper.

Tolerances as in tests/test_torch_train.py: 1e-5 relative for module
outputs and step 0's grads (relative L2 per leaf), 1e-4 over a
trajectory."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models.api import ModelAPI as JModelAPI  # noqa: E402
from repro.runtime.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import rglru, rwkv6  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    flatten_paths, jax_leaves, train_state_from_jax, train_state_to_jax)
from repro_torch.runtime.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.train import trainstep  # noqa: E402

TOL = 1e-5            # module outputs, loss and step 0's grads (relative)
TRAJ_TOL = 1e-4       # 10-step trajectories (relative)
MOMENT_TOL = 1e-3     # optimizer moments after 10 steps (relative L2)
B, S, STEPS = 2, 32, 10
ARCHS = ["rwkv6-3b", "recurrentgemma-9b"]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def t(a, grad=False):
    x = torch.from_numpy(np.asarray(a).copy())
    return x.requires_grad_() if grad else x


# --------------------------------------------------------------------------
# the recurrences
# --------------------------------------------------------------------------

def wkv_inputs(seed, S, Bw=2, H=2, N=8):
    """r, k, v, w (decays as the model makes them, log w in [-4, 0)),
    u, state, and the weights of a scalar loss over out and the state."""
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = (rng.normal(size=(Bw, S, H, N)).astype(f) for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-3.0, 1.3862, (Bw, S, H, N)))).astype(f)
    u = (rng.normal(size=(H, N)) * 0.3).astype(f)
    st = (rng.normal(size=(Bw, H, N, N)) * 0.3).astype(f)
    wo = rng.normal(size=(Bw, S, H, N)).astype(f)
    ws = rng.normal(size=(Bw, H, N, N)).astype(f)
    return (r, k, v, w, u, st), wo, ws


def port_wkv_grads(args, wo, ws):
    ts = [t(a, True) for a in args]
    out, st = rwkv6.wkv6_chunked(*ts)
    (out * t(wo)).sum().add((st * t(ws)).sum()).backward()
    return out.detach().numpy(), st.detach().numpy(), [x.grad.numpy()
                                                       for x in ts]


@pytest.mark.parametrize("S", [16, 32, 48])
def test_wkv6_chunked_matches_jax(S):
    args, wo, ws = wkv_inputs(S, S)

    def jloss(*a):
        out, st = jrwkv.wkv6_chunked(*a, chunk=min(16, S))
        return (out * wo).sum() + (st * ws).sum()
    want_out, want_st = jrwkv.wkv6_chunked(*args, chunk=min(16, S))
    want_g = jax.grad(jloss, argnums=tuple(range(6)))(*args)
    out, st, grads = port_wkv_grads(args, wo, ws)
    assert rel(out, want_out) <= TOL and rel(st, want_st) <= TOL
    for g, w in zip(grads, want_g):
        assert rel_l2(g, w) <= TOL


@pytest.mark.parametrize("S", [20, 37])
def test_wkv6_chunked_pads_what_jax_asserts(S):
    """At S 20 and 37 the JAX chunked form asserts; the port pads the tail
    with r = k = v = 0 and w = 1 and agrees with the sequential oracle,
    values and grads."""
    args, wo, ws = wkv_inputs(S, S)
    with pytest.raises(AssertionError, match="divisible by chunk"):
        jrwkv.wkv6_chunked(*args, chunk=16)

    def jloss(*a):
        out, st = jref.wkv6_ref(*a)
        return (out * wo).sum() + (st * ws).sum()
    want_out, want_st = jref.wkv6_ref(*args)
    want_g = jax.grad(jloss, argnums=tuple(range(6)))(*args)
    out, st, grads = port_wkv_grads(args, wo, ws)
    assert out.shape == (2, S, 2, 8)
    assert rel(out, want_out) <= TOL and rel(st, want_st) <= TOL
    for g, w in zip(grads, want_g):
        assert rel_l2(g, w) <= TOL


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rglru_scan_matches_jax(with_h0):
    """The doubling scan on the block's coefficients against the JAX
    model's associative scan: h and h_last, and the grads of a loss over
    both with respect to x, the block's weights and h0."""
    jcfg = jconfigs.smoke_variant(jconfigs.ARCHS["recurrentgemma-9b"])
    cfg = configs.smoke_variant(configs.ARCHS["recurrentgemma-9b"])
    jp = jax.tree.map(np.asarray, jrglru.rglru_init(jax.random.key(4), jcfg,
                                                     jnp.float32))
    m = rglru.RGLRU(cfg, torch.float32, "cpu")
    m.load_state_dict({k: t(v) for k, v in jp.items()}, strict=True)
    rng = np.random.default_rng(5)
    w = cfg.lru_width
    x = rng.normal(size=(2, 37, w)).astype(np.float32)
    h0 = (rng.normal(size=(2, w)) * 0.5).astype(np.float32) \
        if with_h0 else None
    wy = rng.normal(size=x.shape).astype(np.float32)
    wl = rng.normal(size=(2, w)).astype(np.float32)

    def jloss(p, x, h0):
        y, last = jrglru.rglru_scan(p, x, h0)
        return (y * wy).sum() + (last * wl).sum()
    want_y, want_last = jrglru.rglru_scan(jp, x, h0)
    jg = jax.grad(jloss, argnums=(0, 1, 2) if with_h0 else (0, 1))(
        jp, x, h0)
    tx = t(x, True)
    th0 = t(h0, True) if with_h0 else None
    y, last = rglru.rglru_scan(*rglru.coeffs(m, tx), th0)
    assert rel(y.detach().numpy(), want_y) <= TOL
    assert rel(last.detach().numpy(), want_last) <= TOL
    ((y * t(wy)).sum() + (last * t(wl)).sum()).backward()
    assert rel_l2(tx.grad.numpy(), jg[1]) <= TOL
    if with_h0:
        assert rel_l2(th0.grad.numpy(), jg[2]) <= TOL
    for name, p in m.named_parameters():
        if name in ("gate_a", "gate_x", "lam"):   # what the scan reads
            assert rel_l2(p.grad.numpy(), jg[0][name]) <= TOL, name


# --------------------------------------------------------------------------
# the models' training
# --------------------------------------------------------------------------

def build(name, seed=0, **over):
    jcfg = dataclasses.replace(
        jconfigs.smoke_variant(jconfigs.ARCHS[name]), **over)
    tcfg = dataclasses.replace(
        configs.smoke_variant(configs.ARCHS[name]), **over)
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


@pytest.mark.parametrize("name", ARCHS)
def test_loss_fn_matches_jax(name):
    japi, jstate, api, _ = build(name, 1)
    b = batches(2, 1, api.cfg.vocab)[0]
    jloss, jm = japi.train_loss(jstate["params"], jx(b))
    ops.reset_launch_counts()
    loss, m = api.train_loss(tx(b))
    assert sorted(m) == sorted(jm) == ["loss", "total_loss"]
    assert rel(loss.item(), jloss) <= TOL
    assert all(n == 0 for n in ops.launch_counts.values())


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_step0_grads_match_jax(name, remat):
    japi, jstate, api, _ = build(name, 3, remat=remat)
    b = batches(4, 1, api.cfg.vocab)[0]
    jgrads = jax.grad(lambda p: japi.train_loss(p, jx(b))[0])(
        jstate["params"])
    want = flatten_paths(jax.tree.map(np.asarray, jgrads))
    loss, _ = api.train_loss(tx(b))
    leaves = jax_leaves(api.model)
    params = [p for leaf in leaves for p in leaf.params]
    grads = dict(zip(params, torch.autograd.grad(loss, params)))
    assert [leaf.path for leaf in leaves] == list(want)
    for leaf in leaves:
        g = leaf.stack([grads[p] for p in leaf.params]).numpy()
        assert rel_l2(g, want[leaf.path]) <= TOL, leaf.path


def trajectories(name, opt, remat=False, **kw):
    japi, jstate, api, state = build(name, 5, optimizer=opt, remat=remat)
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=STEPS, **kw)
    jstep = jax.jit(jtrainstep.make_train_step(japi, **kw))
    step = trainstep.make_train_step(api, **kw)
    got, want = [], []
    for b in batches(6, STEPS, api.cfg.vocab):
        jstate, jm = jstep(jstate, jx(b))
        state, m = step(state, tx(b))
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        got.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    return np.array(got), np.array(want), state, jstate


TRAJ_CASES = [("adamw", 1, False), ("adafactor", 1, False),
              ("adamw", 2, False), ("adafactor", 2, False),
              ("adamw", 1, True)]


@pytest.mark.parametrize("opt,accum,remat", TRAJ_CASES)
@pytest.mark.parametrize("name", ARCHS)
def test_trajectory_matches_make_train_step(name, opt, accum, remat):
    got, want, state, jstate = trajectories(name, opt, remat, accum=accum)
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=0)
    # the train state after 10 steps in the JAX layout: the params element
    # by element, as tests/test_torch_train.py holds them; the optimizer's
    # moments per leaf by relative L2 at MOMENT_TOL.  rwkv's u enters only
    # through r . (u k) summed over tokens of both signs, so its grad
    # carries that cancellation's float32 noise, and Adafactor, which
    # normalises every update, turns it into moments that stand 1.8e-4
    # (relative L2 of vc at adafactor, accum 2) from JAX's after 10 steps,
    # while u itself stays within 0.17 of the params' bound
    a = flatten_paths(train_state_to_jax(state))
    b = flatten_paths(jax.tree.map(np.asarray, jstate))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if k.startswith("opt/"):
            assert rel_l2(a[k], b[k]) <= MOMENT_TOL, k
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=TRAJ_TOL, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_copies_follow_the_stacked_leaf(name):
    """The JAX step casts every float32 leaf of two or more dims after
    stacking, so the per-layer vectors (RG-LRU lam, rwkv w0, u, mu and
    ln_w, every block norm) compute in bf16; the final norm does not."""
    _, _, api, _ = build(name)
    comp = trainstep._compute_params(jax_leaves(api.model), True)
    dtypes = {n: comp[p].dtype for n, p in api.model.named_parameters()}
    per_layer = {"rwkv6-3b": ("time.w0", "time.u", "time.mu", "time.ln_w",
                              "channel.mu", "ln1.weight", "ln2.weight"),
                 "recurrentgemma-9b": ("mix.lam", "mix.conv", "ln1.weight",
                                       "ln2.weight")}[name]
    for leaf in per_layer:
        assert dtypes[f"blocks.0.{leaf}"] == torch.bfloat16, leaf
    assert dtypes["final_norm.weight"] == torch.float32
    assert all(d == torch.bfloat16 for n, d in dtypes.items()
               if n != "final_norm.weight")


def test_adafactor_factors_the_stacked_leaves():
    """rwkv's mu stacks to (groups, 5, d) and is factored over its last two
    axes, as the JAX optimizer factors it; the states' shapes equal the
    JAX init's leaf for leaf."""
    japi, jstate, api, state = build("rwkv6-3b", optimizer="adafactor")
    v = state["opt"]["v"]
    G, d = api.model.groups, api.cfg.d_model
    assert tuple(v["blocks/b0/time/mu"]["vr"].shape) == (G, 5)
    assert tuple(v["blocks/b0/time/mu"]["vc"].shape) == (G, d)
    a = flatten_paths(train_state_to_jax(state))
    b = flatten_paths(jax.tree.map(np.asarray, jstate))
    assert {k: a[k].shape for k in a} == {k: b[k].shape for k in b}


@pytest.mark.parametrize("name", ARCHS)
def test_snapshots_restore_across_packages(tmp_path, name):
    """A JAX train state after two steps, written by each package and
    restored by the other, bit for bit."""
    japi, jstate, api, _ = build(name, 7)
    jstep = jax.jit(jtrainstep.make_train_step(japi, warmup=1))
    for b in batches(8, 2, api.cfg.vocab):
        jstate, _ = jstep(jstate, jx(b))
    want = jax.tree.map(np.asarray, jstate)
    js = JStore(str(tmp_path / "jax"), async_io=True)
    js.save(2, want)
    js.close()
    fresh = trainstep.init_state(api, torch.Generator().manual_seed(1))
    ts = CheckpointStore(str(tmp_path / "jax"))
    state, mani = ts.restore(like=fresh)
    ts.close()
    assert mani["step"] == 2
    ts = CheckpointStore(str(tmp_path / "port"))
    ts.save(2, state)
    ts.close()
    got, _ = JStore(str(tmp_path / "port"), async_io=False).restore(
        2, like=want)
    for tree in (train_state_to_jax(state), got):
        fa, fb = flatten_paths(tree), flatten_paths(want)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            x, y = np.asarray(fa[k]), np.asarray(fb[k])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("name", ARCHS)
def test_train_mode_reaches_no_kernel_wrapper(monkeypatch, name):
    """Train mode runs the plain recurrences: with every kernel wrapper
    replaced by one that raises, a train step still runs; prefill reaches
    the wrappers."""
    _, _, api, state = build(name)

    def refuse(*a, **k):
        raise AssertionError("train mode reached a kernel wrapper")
    for w in ("wkv6", "rglru_scan", "flash_attention"):
        monkeypatch.setattr(ops, w, refuse)
    step = trainstep.make_train_step(api, warmup=1)
    state, m = step(state, tx(batches(9, 1, api.cfg.vocab)[0]))
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(AssertionError, match="kernel wrapper"):
        api.prefill(tx(batches(9, 1, api.cfg.vocab)[0]),
                    configs.ShapeConfig("p", "prefill", S, B))
