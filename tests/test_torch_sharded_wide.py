"""The port's sharded train step on 8 gloo CPU ranks, a (4, 2) ("data",
"model") mesh under DEFAULT_RULES: smoke_variant(smollm-135m), 2 AdamW
steps with accum 2 from the JAX package's initial state, held to the
port's unsharded step, to the JAX step, and on every rank to its specs
and its replicas (as ``test_torch_sharded_train.py`` holds 4 ranks)."""
import pytest

torch = pytest.importorskip("torch")

import sharded_ref as ref  # noqa: E402
import torch_ranks  # noqa: E402


@pytest.fixture(scope="module")
def results():
    batches = ref.make_batches(12)
    first = ref.host(ref.jax_state("adamw", seed=1)[1])
    runs = [{"name": "wide", "mesh": ((4, 2), ("data", "model")),
             "rules": "DEFAULT_RULES", "optimizer": "adamw",
             "accum": ref.ACCUM, "compress": False, "state": first,
             "batches": batches, "kw": ref.KW}]
    group = torch_ranks.Ranks(torch_ranks.train_runs, 8, runs)
    jax_ref = ref.jax_run("adamw", batches, seed=1)
    plain = ref.port_run("adamw", first, batches)
    return jax_ref, plain, [r["wide"] for r in group.results()]


def test_eight_ranks_match_the_unsharded_step(results):
    _, plain, ranks = results
    metrics, final, _ = ranks[0]
    err, path = ref.worst(final, plain[0])
    assert err <= ref.SHARD_TOL, (path, err)
    for m, want in zip(metrics, plain[1]):
        for k in ("loss", "grad_norm"):
            assert abs(m[k] - want[k]) <= ref.SHARD_TOL * abs(want[k]), k


def test_eight_ranks_match_jax(results):
    jax_ref, _, ranks = results
    metrics, final, _ = ranks[0]
    err, path = ref.worst(final, jax_ref[1])
    assert err <= ref.TRAJ_TOL, (path, err)
    for m, want in zip(metrics, jax_ref[2]):
        assert abs(m["loss"] - want["loss"]) <= \
            ref.TRAJ_TOL * abs(want["loss"])


def test_eight_ranks_follow_the_specs(results):
    _, _, ranks = results
    for rank, (metrics, _, faults) in enumerate(ranks):
        assert faults == [], (rank, faults[:5])
        assert metrics == ranks[0][0]
