"""The port's training runtime on the CPU: the checkpoint store and the
fleet monitor (the tests of tests/test_runtime.py, on the port), train
states carried between the JAX layout and the port's, snapshots restored
across the two packages, and the train launcher: train, save, resume."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.api import ModelAPI as JModelAPI  # noqa: E402
from repro.runtime.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import kdispatch  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    PipelineConfig, ZerrowDataPipeline)
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    flatten_paths, train_state_from_jax, train_state_to_jax)
from repro_torch.runtime.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.runtime.fault import (  # noqa: E402
    FaultConfig, FleetMonitor, RestartPolicy)
from repro_torch.train.trainstep import (  # noqa: E402
    init_state, make_train_step)


@pytest.fixture(autouse=True)
def cpu_kernels():
    with kdispatch.using_device("cpu"):
        yield


@pytest.fixture()
def store(tmp_path):
    s = CheckpointStore(str(tmp_path / "ckpt"), async_io=True)
    yield s
    s.close()


def tree(step, as_tensor=False):
    t = {"params": {"w": np.full((64, 64), float(step)),
                    "frozen": np.ones((128,))},
         "opt": {"mu": np.zeros((64, 64)), "count": np.array(step)}}
    if as_tensor:
        t = {k: {n: torch.from_numpy(v) for n, v in d.items()}
             for k, d in t.items()}
    return t


# -- tests/test_runtime.py:25-55, on the port ---------------------------------

@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "tensor"])
def test_checkpoint_roundtrip(store, as_tensor):
    t = tree(1, as_tensor)
    store.save(1, t)
    store.flush()
    out, mani = store.restore(1, like=t)
    w = out["params"]["w"]
    assert isinstance(w, torch.Tensor) == as_tensor
    np.testing.assert_array_equal(np.asarray(w), np.asarray(
        t["params"]["w"]))
    assert mani["step"] == 1


def test_checkpoint_content_dedup(store):
    store.save(1, tree(1))
    store.flush()
    w1 = store.stats["blobs_written"]
    store.save(2, tree(2))   # 'frozen' and 'mu' unchanged -> reused
    store.flush()
    assert store.stats["blobs_reused"] >= 2
    assert store.stats["blobs_written"] - w1 <= 2


def test_checkpoint_latest_and_restore_like(store):
    store.save(5, tree(5))
    store.save(9, tree(9))
    store.flush()
    assert store.latest_step() == 9
    out, mani = store.restore(like=tree(0))
    assert float(np.asarray(out["opt"]["count"])) == 9


def test_restore_onto_a_mesh_waits_for_sharding(store):
    """Restore onto a mesh, which no longer waits for the sharding
    slice: on a one-rank gloo mesh, ``shardings=`` places each leaf as a
    DTensor with its spec's placements (over size-1 mesh dims, replicas)
    and the snapshot's values (0-d leaves stay plain), and saving those
    DTensors writes the same snapshot again."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.sharding.partition import NamedSharding
    from torch_ranks import one_rank
    store.save(1, tree(1))
    store.flush()
    with one_rank():
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        sh = {"params": {"w": NamedSharding(mesh, ("data", "model")),
                         "frozen": NamedSharding(mesh, ())},
              "opt": {"mu": NamedSharding(mesh, (None, "model")),
                      "count": NamedSharding(mesh, ())}}
        got, _ = store.restore(1, like=tree(1, as_tensor=True),
                               shardings=sh)
        w, mu = got["params"]["w"], got["opt"]["mu"]
        assert isinstance(w, DTensor) and isinstance(mu, DTensor)
        assert tuple(w.placements) == sh["params"]["w"].placements == \
            (Replicate(), Replicate())
        assert tuple(mu.placements) == sh["opt"]["mu"].placements
        assert not isinstance(got["opt"]["count"], DTensor)
        want = tree(1)
        np.testing.assert_array_equal(w.full_tensor().numpy(),
                                      want["params"]["w"])
        assert int(got["opt"]["count"]) == 1
        mani = store.save(2, got)
        assert mani is not None
    flat, _ = store.restore(2)
    for path, arr in flatten_paths({"": want}).items():
        np.testing.assert_array_equal(flat[path], arr)


# -- tests/test_runtime.py:55-95, on the port ---------------------------------

def test_fleet_failure_detection():
    m = FleetMonitor(4, FaultConfig(grace_steps=2))
    for step in range(6):
        for w in range(4):
            if w == 3 and step > 1:
                continue          # worker 3 dies at step 2
            m.heartbeat(w, step, 0.1)
    assert m.detect_failures() == [3]
    assert m.healthy() == 3


def test_straggler_detection():
    m = FleetMonitor(5, FaultConfig())
    for step in range(10):
        for w in range(5):
            m.heartbeat(w, step, 1.0 if w != 2 else 3.0)
    assert m.detect_stragglers() == [2]


def test_restart_policy(tmp_path):
    cs = CheckpointStore(str(tmp_path / "c"), async_io=False)
    cs.save(42, {"w": np.ones(4)})
    m = FleetMonitor(4, FaultConfig(grace_steps=1))
    for s in range(4):
        for w in range(4):
            if w == 0 and s > 0:
                continue
            m.heartbeat(w, s, 0.1)
    plan = RestartPolicy(cs, m, min_workers=3).plan()
    assert plan["action"] == "restart" and plan["from_step"] == 42
    m.workers[1].failed = True
    m.workers[2].failed = True
    plan = RestartPolicy(cs, m, min_workers=3).plan()
    assert plan["action"] == "elastic_shrink" and plan["new_size"] == 1
    cs.close()


# -- train states across the two layouts ------------------------------------

def jax_state(opt, seed=0, steps=2):
    """A JAX train state of smoke smollm-135m after ``steps`` updates (so
    every optimizer leaf is nonzero), as numpy."""
    cfg = dataclasses.replace(
        jconfigs.smoke_variant(jconfigs.ARCHS["smollm-135m"]),
        optimizer=opt)
    api = JModelAPI(cfg)
    state = jtrainstep.init_state(api, jax.random.key(seed))
    step = jax.jit(jtrainstep.make_train_step(api, warmup=1))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        b = {k: rng.integers(1, cfg.vocab, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
        state, _ = step(state, b)
    return jax.tree.map(np.asarray, state)


def port_api(opt):
    return ModelAPI(dataclasses.replace(
        configs.smoke_variant(configs.ARCHS["smollm-135m"]), optimizer=opt),
        device="cpu")


def same_tree(a, b):
    fa, fb = flatten_paths(a), flatten_paths(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_train_state_jax_port_jax_is_bit_identical(opt):
    want = jax_state(opt)
    state = train_state_from_jax(want, port_api(opt).model)
    same_tree(train_state_to_jax(state), want)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_snapshots_restore_across_packages(tmp_path, opt):
    want = jax_state(opt)
    # JAX writes, the port restores into a fresh state
    js = JStore(str(tmp_path / "jax"), async_io=True)
    js.save(2, want)
    js.close()
    api = port_api(opt)
    fresh = init_state(api, torch.Generator().manual_seed(1))
    ts = CheckpointStore(str(tmp_path / "jax"))
    state, mani = ts.restore(like=fresh)
    ts.close()
    assert mani["step"] == 2 and state["params"] is api.model
    same_tree(train_state_to_jax(state), want)
    # the port writes, JAX restores; the same manifest paths and blobs
    ts = CheckpointStore(str(tmp_path / "port"))
    ts.save(2, state)
    ts.close()
    js = JStore(str(tmp_path / "port"), async_io=False)
    got, _ = js.restore(2, like=want)
    same_tree(got, want)
    manifests = []
    for d in ("jax", "port"):
        with open(tmp_path / d / "step-00000002.json") as f:
            manifests.append(json.load(f)["tensors"])
    assert manifests[0] == manifests[1]


# -- the launcher -------------------------------------------------------------

def test_train_save_resume_is_exact(tmp_path, capsys):
    """The launcher trains 6 steps and saves at 3 and 6; resuming from
    its step-3 snapshot and taking the same next 3 batches gives the same
    losses and, bit for bit, its step-6 state (tests/test_integration.py's
    resume check, through the port's launcher)."""
    data, ckpt = str(tmp_path / "corpus"), str(tmp_path / "ckpt")
    kw = dict(steps=6, batch=2, seq_len=32, smoke=True, ckpt_dir=ckpt,
              ckpt_every=3, data_dir=data, device="cpu")
    losses = launcher.train_loop("smollm-135m", **kw)
    assert len(losses) == 6 and all(np.isfinite(losses))

    api = ModelAPI(dataclasses.replace(
        configs.smoke_variant(configs.ARCHS["smollm-135m"]), vocab=257),
        device="cpu")
    store = CheckpointStore(ckpt)
    state, mani = store.restore(3, like=init_state(api))
    assert mani["step"] == 3 and int(state["step"]) == 3
    step = make_train_step(api, peak_lr=1e-3, total_steps=6)
    pipe = ZerrowDataPipeline(
        sorted(os.path.join(data, f) for f in os.listdir(data)),
        PipelineConfig(batch=2, seq_len=32))
    it = pipe.batches(epochs=10)
    resumed = []
    for i in range(6):
        b = next(it)
        if i >= 3:
            state, m = step(state, {k: torch.from_numpy(b[k])
                                    for k in ("tokens", "labels")})
            resumed.append(float(m["loss"]))
    pipe.close()
    assert resumed == losses[3:]
    other_api = ModelAPI(api.cfg, device="cpu")
    saved, mani = store.restore(6, like=init_state(other_api))
    store.close()
    assert mani["step"] == 6
    same_tree(train_state_to_jax(state), train_state_to_jax(saved))

    capsys.readouterr()
    more = launcher.main(["--smoke", "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq-len", "32", "--ckpt-dir",
                          ckpt, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and len(more) == 2
    for line in ("step     0 loss ", "pipeline stats:", "done: 2 steps"):
        assert line in out


def test_launcher_without_a_card_raises(monkeypatch):
    """Without --device cpu the launcher runs on CUDA; with no card it
    raises before it builds anything, and never trains on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--smoke", "--steps", "1"])
