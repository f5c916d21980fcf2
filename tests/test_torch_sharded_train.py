"""The port's sharded train step on 4 gloo CPU ranks, a (2, 2) ("data",
"model") mesh: smoke_variant(smollm-135m), 2 steps with accum 2, from
the JAX package's initial state, under DEFAULT_RULES, FSDP_RULES and
ACT_SP_RULES with AdamW and under DEFAULT_RULES with Adafactor.  Each
run is held to the port's unsharded step (``sharded_ref.SHARD_TOL``
relative L2 per leaf), to the JAX step (``TRAJ_TOL``), and on every
rank to its specs: each DTensor's placements and local shape, and its
replicas bit for bit.  The ranks run in one spawned group (DTensor
plans each op's sharding once a process)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sharded_ref as ref  # noqa: E402
import torch_ranks  # noqa: E402

MESH = ((2, 2), ("data", "model"))
RUNS = {"default": ("DEFAULT_RULES", "adamw"),
        "fsdp": ("FSDP_RULES", "adamw"),
        "act_sp": ("ACT_SP_RULES", "adamw"),
        "adafactor": ("DEFAULT_RULES", "adafactor")}


@pytest.fixture(scope="module")
def results():
    batches = ref.make_batches(11)
    first = {opt: ref.host(ref.jax_state(opt)[1])
             for opt in ("adamw", "adafactor")}
    runs = [{"name": name, "mesh": MESH, "rules": rules, "optimizer": opt,
             "accum": ref.ACCUM, "compress": False, "state": first[opt],
             "batches": batches, "kw": ref.KW}
            for name, (rules, opt) in RUNS.items()]
    group = torch_ranks.Ranks(torch_ranks.train_runs, 4, runs)
    refs = {opt: ref.jax_run(opt, batches) for opt in first}
    plain = {opt: ref.port_run(opt, first[opt], batches) for opt in first}
    return refs, plain, group.results()


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_step_matches_the_unsharded_step(name, results):
    refs, plain, ranks = results
    opt = RUNS[name][1]
    metrics, final, _ = ranks[0][name]
    err, path = ref.worst(final, plain[opt][0])
    assert err <= ref.SHARD_TOL, (path, err)
    for m, want in zip(metrics, plain[opt][1]):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(m[k] - want[k]) <= ref.SHARD_TOL * abs(want[k]), k


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_step_matches_jax(name, results):
    refs, _, ranks = results
    opt = RUNS[name][1]
    metrics, final, _ = ranks[0][name]
    err, path = ref.worst(final, refs[opt][1])
    assert err <= ref.TRAJ_TOL, (path, err)
    for m, want in zip(metrics, refs[opt][2]):
        for k in ("loss", "total_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], want[k], rtol=ref.TRAJ_TOL,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(RUNS))
def test_shards_follow_the_specs_and_replicas_agree(name, results):
    _, _, ranks = results
    for rank, out in enumerate(ranks):
        assert out[name][2] == [], (rank, out[name][2][:5])
        assert (out[name][1] is None) == (rank != 0)
    # every rank saw the same metrics
    for out in ranks[1:]:
        assert out[name][0] == ranks[0][name][0]
