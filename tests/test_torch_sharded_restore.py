"""Elastic restore of a sharded train state: 4 gloo CPU ranks on a
(2, 2) mesh under FSDP_RULES take 2 AdamW steps and save (rank 0
writes, in the JAX layout); the snapshot is then restored with
``shardings=`` for DEFAULT_RULES onto 2 ranks, a (2, 1) mesh, and onto
1, bit for bit, and read by the JAX package's ``CheckpointStore``; one
more step from each restore agrees with the port's unsharded step and
the JAX step from the same snapshot."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sharded_ref as ref  # noqa: E402
import torch_ranks  # noqa: E402
from repro.runtime.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch.models.convert import flatten_paths  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointStore  # noqa: E402

MESHES = {2: ((2, 1), ("data", "model")), 1: ((1, 1), ("data", "model"))}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded-ckpt"))
    batches = ref.make_batches(13, n=ref.STEPS + 1)
    first = ref.host(ref.jax_state("adamw", seed=2)[1])
    runs = [{"name": "saved", "mesh": ((2, 2), ("data", "model")),
             "rules": "FSDP_RULES", "optimizer": "adamw", "accum": 1,
             "compress": False, "state": first,
             "batches": batches[:ref.STEPS], "kw": ref.KW}]
    saved = torch_ranks.run(torch_ranks.train_runs, 4, runs, root)
    groups = {n: torch_ranks.Ranks(torch_ranks.restore_and_step, n, root,
                                   MESHES[n], "DEFAULT_RULES", "adamw",
                                   batches[-1], ref.KW)
              for n in MESHES}
    # the references: the snapshot restored plainly, then one more step
    flat, _ = CheckpointStore(root, async_io=False).restore()
    snap = flatten_paths(jax.tree.map(np.asarray, _nest(flat)))
    japi, jlike = ref.jax_state("adamw")
    jstate, _ = JStore(root, async_io=False).restore(
        like=jax.tree.map(np.asarray, jlike))
    plain = ref.port_run("adamw", jstate, batches[-1:], accum=1)
    jstep = jax.jit(jtrainstep.make_train_step(japi, **ref.KW))
    jnext, jm = jstep(jax.tree.map(jax.numpy.asarray, jstate),
                      {k: jax.numpy.asarray(v)
                       for k, v in batches[-1].items()})
    return (saved, snap, jstate, plain, (ref.host(jnext), float(jm["loss"])),
            {n: g.results() for n, g in groups.items()})


def _nest(flat):
    from repro_torch.models.convert import nest
    return nest({p[1:]: a for p, a in flat.items()})


def test_save_from_four_ranks_writes_the_whole_state(results):
    saved, snap, _, _, _, _ = results
    final = flatten_paths(saved[0]["saved"][1])
    assert sorted(final) == sorted(snap)
    for p, a in final.items():
        np.testing.assert_array_equal(snap[p], a, err_msg=p)
    for rank, out in enumerate(saved):
        assert out["saved"][2] == [], (rank, out["saved"][2][:5])


def test_the_jax_store_reads_the_snapshot(results):
    saved, _, jstate, _, _, _ = results
    want = flatten_paths(saved[0]["saved"][1])
    got = flatten_paths(jstate)
    assert sorted(got) == sorted(want)
    for p, a in want.items():
        np.testing.assert_array_equal(np.asarray(got[p]), a, err_msg=p)


@pytest.mark.parametrize("n", sorted(MESHES))
def test_restore_onto_fewer_ranks_is_bit_for_bit(n, results):
    _, snap, _, _, _, restores = results
    restored, _, _, faults = restores[n][0]
    got = flatten_paths(restored)
    assert sorted(got) == sorted(snap)
    for p, a in snap.items():
        np.testing.assert_array_equal(got[p], a, err_msg=p)
    for rank, out in enumerate(restores[n]):
        assert out[3] == [], (rank, out[3][:5])


@pytest.mark.parametrize("n", sorted(MESHES))
def test_one_more_step_after_restore_agrees(n, results):
    _, _, _, plain, (jnext, jloss), restores = results
    _, stepped, loss, _ = restores[n][0]
    err, path = ref.worst(stepped, plain[0])
    assert err <= ref.SHARD_TOL, (path, err)
    assert abs(loss - plain[1][0]["loss"]) <= \
        ref.SHARD_TOL * abs(plain[1][0]["loss"])
    err, path = ref.worst(stepped, jnext)
    assert err <= ref.TRAJ_TOL, (path, err)
    assert abs(loss - jloss) <= ref.TRAJ_TOL * abs(jloss)
    assert all(out[2] == loss for out in restores[n])
