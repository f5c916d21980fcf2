"""The port's training path against the JAX package's, on the CPU, at
float32 on smoke_variant(smollm-135m) from the same weights (the JAX
``init_state`` converted with ``models.convert.train_state_from_jax``)
and the same numpy batches: the loss, step 0's gradients, the optimizers
on stacked leaves, 10-step trajectories of ``make_train_step`` (AdamW and
Adafactor; microbatch accumulation; bf16 compute copies), the schedule,
and train-mode attention's gradients."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models.api import ModelAPI as JModelAPI  # noqa: E402
from repro.train import optimizer as joptimizer  # noqa: E402
from repro.train import schedule as jschedule  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    flatten_paths, jax_leaves, train_state_from_jax, train_state_to_jax)
from repro_torch.train import optimizer, schedule, trainstep  # noqa: E402

TOL = 1e-5            # loss and step 0's grads (relative)
TRAJ_TOL = 1e-4       # 10-step trajectories (relative)
B, S, STEPS = 4, 32, 10


def build(seed=0, **over):
    """(JAX api, JAX train state, port api, port train state), the same
    weights and optimizer state."""
    jcfg = dataclasses.replace(
        jconfigs.smoke_variant(jconfigs.ARCHS["smollm-135m"]), **over)
    tcfg = dataclasses.replace(
        configs.smoke_variant(configs.ARCHS["smollm-135m"]), **over)
    japi, api = JModelAPI(jcfg), ModelAPI(tcfg, device="cpu")
    jstate = jtrainstep.init_state(japi, jax.random.key(seed))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                 api.model)
    return japi, jstate, api, state


def batches(seed, n, vocab, mask=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(1, vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(1, vocab, (B, S)).astype(np.int32)}
        if mask:
            b["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
        out.append(b)
    return out


def jx(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tx(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_jax_leaves_are_the_jax_pytree():
    japi, jstate, api, _ = build()
    want = flatten_paths(jax.tree.map(np.asarray, jstate["params"]))
    leaves = jax_leaves(api.model)
    assert [leaf.path for leaf in leaves] == list(want)
    assert [leaf.path for leaf in leaves] == [
        "/".join(str(k.key) for k in path) for path, _ in
        jax.tree_util.tree_leaves_with_path(jstate["params"])]
    for leaf in leaves:
        t = leaf.stack([p.detach() for p in leaf.params])
        assert tuple(t.shape) == want[leaf.path].shape, leaf.path
        np.testing.assert_array_equal(t.numpy(), want[leaf.path])


@pytest.mark.parametrize("mask", [False, True], ids=["mean", "loss_mask"])
def test_loss_fn_matches_jax(mask):
    japi, jstate, api, _ = build(1)
    b = batches(2, 1, api.cfg.vocab, mask)[0]
    jloss, jm = japi.train_loss(jstate["params"], jx(b))
    loss, m = api.train_loss(tx(b))
    assert sorted(m) == sorted(jm) == ["loss", "total_loss"]
    for k in m:
        assert rel(m[k].item(), jm[k]) <= TOL, k
    assert rel(loss.item(), jloss) <= TOL


@pytest.mark.parametrize("remat", [False, True])
def test_step0_grads_match_jax(remat):
    japi, jstate, api, _ = build(3, remat=remat)
    b = batches(4, 1, api.cfg.vocab)[0]
    jgrads = jax.grad(lambda p: japi.train_loss(p, jx(b))[0])(
        jstate["params"])
    want = flatten_paths(jax.tree.map(np.asarray, jgrads))
    loss, _ = api.train_loss(tx(b))
    leaves = jax_leaves(api.model)
    params = [p for leaf in leaves for p in leaf.params]
    grads = dict(zip(params, torch.autograd.grad(loss, params)))
    for leaf in leaves:
        g = leaf.stack([grads[p] for p in leaf.params]).numpy()
        assert rel_l2(g, want[leaf.path]) <= TOL, leaf.path


def trajectories(opt, **kw):
    japi, jstate, api, state = build(5, optimizer=opt)
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


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("accum", [1, 2])
def test_trajectory_matches_make_train_step(opt, accum):
    got, want, state, jstate = trajectories(opt, accum=accum)
    assert want[0, 2] == 0.0 and want[1, 2] > 0      # step 0 has lr 0
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=0)
    # the whole train state after 10 steps, in the JAX layout
    a = flatten_paths(train_state_to_jax(state))
    b = flatten_paths(jax.tree.map(np.asarray, jstate))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], rtol=TRAJ_TOL, atol=1e-6,
                                   err_msg=k)


#: bf16 compute copies: both packages take grads with respect to bf16
#: copies of the weights, so every grad element is rounded to bf16 (8
#: bits).  A float32 value that the two packages compute 1e-7 apart and
#: that lies next to a bf16 rounding boundary rounds one bf16 ulp (2^-8)
#: apart; AdamW and Adafactor normalise that element's update, so such a
#: flip moves one weight by a fraction of lr.  The trajectories then
#: agree to about 3e-5 (measured); the bound leaves a factor of 15.
BF16_TOL = 5e-4


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_bf16_compute_copies_match_make_train_step(opt):
    got, want, _, _ = trajectories(opt, cast_bf16=True)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=0)
    plain, _, _, _ = trajectories(opt)
    assert np.abs(got[:, 0] - plain[:, 0]).max() > 0   # the copies count


def test_bf16_copies_cast_the_per_layer_norms():
    """The JAX step casts every float32 leaf of two or more dims: the
    stacked (groups, d) norm weights are such leaves, the final norm
    (d,) is not."""
    _, _, api, _ = build()
    comp = trainstep._compute_params(jax_leaves(api.model), True)
    names = {p: n for n, p in api.model.named_parameters()}
    dtypes = {names[p]: t.dtype for p, t in comp.items()}
    assert dtypes["blocks.0.ln1.weight"] == torch.bfloat16
    assert dtypes["blocks.1.ln2.weight"] == torch.bfloat16
    assert dtypes["embed"] == torch.bfloat16
    assert dtypes["final_norm.weight"] == torch.float32


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_update_on_stacked_leaves_matches_jax(opt):
    """Random params and grads in the JAX layout: a norm stacked to
    (groups, d) (decayed by AdamW, factored across the layers by
    Adafactor), a stacked matrix, a vector and an embedding; three
    updates from the same state."""
    rng = np.random.default_rng(7)
    shapes = {"blocks/b0/ln1": (3, 8), "blocks/b0/mix/wq": (3, 8, 2, 4),
              "final_norm": (8,), "embed": (16, 8)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jopt = {"adamw": joptimizer.AdamW(), "adafactor": joptimizer.Adafactor()}
    jo, to = jopt[opt], optimizer.make_optimizer(opt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        lr = np.float32(1e-2 * (i + 1))
        jp, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp, jnp.asarray(lr))
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in
                            grads.items()}, ts, tp, torch.tensor(lr))
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert int(ts["count"]) == int(js["count"]) == 3


def test_warmup_cosine_matches_jax():
    """Equal at every step 0-120 up to the last bit of the cosine: XLA's
    and PyTorch's float32 cos differ in their last bit at some arguments
    (a float64 cos rounded once differs from XLA's too).  A last-bit flip
    of a cos near 1 (2^-24) moves lr by 0.45 * 2^-24 * peak_lr, and the
    rounding of lr adds at most one ulp of lr (2^-23 * peak_lr), so the
    bound is 2^-22 * peak_lr; measured at most 1.63 * 2^-24 * peak_lr."""
    for kw in (dict(peak_lr=1e-3, warmup=10, total=100),
               dict(peak_lr=3e-4, warmup=100, total=10000)):
        for i in range(121):
            want = np.asarray(jschedule.warmup_cosine(jnp.int32(i), **kw))
            got = schedule.warmup_cosine(torch.tensor(i, dtype=torch.int32),
                                         **kw)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=2.0 ** -22 * kw["peak_lr"],
                                       err_msg=f"{kw} step {i}")
    c = schedule.constant(torch.tensor(5), peak_lr=2e-3)
    assert c.dtype == torch.float32 and c.item() == np.float32(2e-3)


@pytest.mark.parametrize("window", [0, 24])
def test_train_attention_grads_match_jax(window):
    """chunked_attention under autograd, several query blocks (recomputed
    in the backward pass) and key chunks, GQA: its gradients against
    jax.grad of the JAX package's chunked_attention."""
    rng = np.random.default_rng(8)
    Bq, Sq, H, KV, hd = 2, 48, 4, 2, 16
    q, k, v = (rng.normal(size=(Bq, Sq, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    w = rng.normal(size=(Bq, Sq, H, hd)).astype(np.float32)
    kw = dict(causal=True, window=window, chunk=20, q_chunk=16)

    def jloss(q, k, v):
        return (jattention.chunked_attention(q, k, v, **kw) * w).sum()
    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attention.chunked_attention(*ts, **kw)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for t, want in zip(ts, jg):
        assert rel_l2(t.grad.numpy(), want) <= TOL


def test_sharding_options_raise():
    """What the sharding options refuse now that they run: a step on a
    mesh raises when the state was not placed there (``shard_state``), a
    mesh raises when its size is not the world's, and under an active
    mesh a plain tensor with a dimension cannot reach a ``constrain``
    site (on a one-rank gloo mesh)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import mesh as meshes
    from repro_torch.sharding import partition
    from torch_ranks import one_rank
    _, _, api, state = build()
    with pytest.raises(RuntimeError, match="init_distributed"):
        meshes.make_mesh_for(1, device="cpu")
    with one_rank():
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        step = trainstep.make_train_step(api, mesh=mesh)
        b = tx(batches(0, 1, api.cfg.vocab)[0])
        with pytest.raises(TypeError, match="shard_state"):
            step(state, b)
        with pytest.raises(ValueError, match="needs 4 ranks"):
            meshes.make_mesh_for(4, model_parallel=2, device="cpu")
        assert meshes.make_mesh_for(1, device="cpu").mesh_dim_names == \
            ("data", "model")
        with partition.use_mesh(mesh), \
                pytest.raises(TypeError, match="fell out of DTensor"):
            api.train_loss(b)


def test_grad_compression_without_a_pod_axis_matches_jax():
    """``grad_compression`` on a step with no "pod" axis (here, no mesh)
    compresses nothing, as in the JAX step: the state carries a float32
    zero residual per leaf, unchanged, and the trajectory is the plain
    step's."""
    japi, _, api, _ = build(5)
    jstate = jtrainstep.init_state(japi, jax.random.key(5),
                                   grad_compression=True)
    fresh = trainstep.init_state(api, grad_compression=True)
    assert sorted(fresh["residual"]) == [leaf.path for leaf in
                                         jax_leaves(api.model)]
    assert not any(t.any() for t in fresh["residual"].values())
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                 api.model)
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=STEPS,
              grad_compression=True)
    jstep = jax.jit(jtrainstep.make_train_step(japi, **kw))
    step = trainstep.make_train_step(api, **kw)
    for b in batches(6, 3, api.cfg.vocab):
        jstate, jm = jstep(jstate, jx(b))
        state, m = step(state, tx(b))
        assert rel(m["loss"].item(), jm["loss"]) <= TRAJ_TOL
    got = flatten_paths(train_state_to_jax(state))
    want = flatten_paths(jax.tree.map(np.asarray, jstate))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        if path.startswith("residual/"):
            assert not got[path].any(), path
        else:
            assert rel_l2(got[path], a) <= TRAJ_TOL, path
