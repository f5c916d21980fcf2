"""The port's sharded train step for the moe, ssm, hybrid, vlm and audio
families on 4 gloo CPU ranks, a (2, 2) ("data", "model") mesh under
DEFAULT_RULES: the smoke variant of qwen3-moe-30b-a3b, rwkv6-3b,
recurrentgemma-9b (its window cut to 8 of 32 positions, so it masks),
internvl2-26b (12 query heads over 2 KV heads: G 6) and whisper-medium,
2 AdamW steps of B 8 x S 32 with accum 2 (patches and frames beside the
tokens), from the JAX package's initial state (``sharded_ref.
first_state``).  The ranks run in one spawned group, the JAX step under
the same mesh in one subprocess of 4 host devices.

Each family's sharded step runs in float64 (``torch_ranks.
float64_compute``: weights, inputs and every ``.float()``), and the
MoE's and rwkv6-3b's (``F32_FAMILIES``) also in their configured dtypes
(float32 masters and compute).  In float32 a sharded
and an unsharded step differ by their sums' rounding alone, which the
chunked WKV-6 form and Adam's first steps on zero-initialised norm
weights lift to 1e-6-1.2e-5 relative L2 (measured), above
``SHARD_TOL``; in float64 they agree to about 1e-13.  Each family is
held
- in float64, to the port's unsharded float64 step within ``SHARD_TOL``
  relative L2 per leaf, loss, total_loss and grad norm.  The MoE runs
  this at capacity_factor = n_experts / top_k, where no pair drops: its
  groups keep other pairs than the one group of the unsharded step
  whenever a group overflows;
- in float32, to the same float64 step within ``F32_NOISE_FACTOR``
  times the port's unsharded float32 step's own distance from it (per
  leaf and per metric), or ``SHARD_TOL``: there the float32 collectives
  run, and the MoE's expert-parallel partial is summed in float32;
- to the JAX step (float32) under the same mesh, as
  ``tests/test_torch_recurrent_train.py`` holds the unsharded steps: the
  params element by element within ``TRAJ_TOL`` and 1e-6, the
  optimizer's moments within ``MOMENT_TOL`` relative L2, the MoE's
  ``moe_dropped`` exactly (at its own capacity factor, where groups
  drop; the MoE dispatches one group per data shard and, with 2 "model"
  ranks and 8 experts, takes the expert-parallel path, as the JAX
  ``shard_map`` path does), and loss, total_loss and grad norm within
  ``TRAJ_TOL``, or within twice the step's float32 noise where that is
  larger: the relative distance of the JAX step, unsharded, from the
  port's float64 step on the same data.  That noise reaches 2.4e-4 on
  rwkv6-3b's second grad norm (measured: the JAX and port float32 steps
  stand 2.4e-4 and 2.2e-4 from float64 there), as ``chip_smoke.py``
  bounds rwkv6-3b's float32 grads by their distance from float64;
- in float64, each table's grad of the first step (the token lookup's,
  met by the head's where it is tied: whisper-medium; untied in the
  four others, beside the ``lm_head`` grad) to the unsharded float64
  step's within ``SHARD_TOL`` relative L2;
- on every rank to its specs: each DTensor's placements and local shape,
  its replicas bit for bit, and the same metrics on every rank; and its
  final state, saved from the mesh, restores with ``shardings=`` bit for
  bit and reads in the JAX package's store.

Where JAX cannot be imported the JAX comparisons skip and the rest runs
from the port's own initial state (README.md shows the command that
hides JAX on a card's host, where it must not run).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sharded_ref as ref  # noqa: E402
import torch_ranks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.convert import flatten_paths  # noqa: E402

FAMILIES = {"moe": "qwen3-moe-30b-a3b", "ssm": "rwkv6-3b",
            "hybrid": "recurrentgemma-9b", "vlm": "internvl2-26b",
            "audio": "whisper-medium"}
MESH = ((2, 2), ("data", "model"))
#: overrides of the smoke variants: recurrentgemma-9b's attention window
#: cut to 8 of the 32 positions, so the window masks train attention;
#: internvl2-26b at 12 query heads over 2 KV heads, its G of 6
CFG = {"hybrid": {"local_window": 8}, "vlm": {"n_heads": 12}}
_moe = configs.smoke_variant(configs.ARCHS[FAMILIES["moe"]])
#: the MoE against the unsharded step: no pair drops
NO_DROP = {"moe": {"capacity_factor": _moe.n_experts / _moe.top_k}}


def exact_cfg(f: str) -> dict:
    """``f``'s overrides for the runs held to the unsharded step."""
    return {**CFG.get(f, {}), **NO_DROP.get(f, {})}


#: the families also run in float32 on the ranks: the two whose step has
#: a region of its own on each rank's shards (``partition.per_shard``),
#: the MoE's expert-parallel dispatch and partial sum, and the RWKV-6
#: recurrence; the rest go through DTensor's own ops, as the dense
#: family's float32 runs do (``tests/test_torch_sharded_train.py``)
F32_FAMILIES = ("moe", "ssm")
#: the ranks' deadline: eight sharded runs, each planned on first sight,
#: beside the rest of the suite
DEADLINE_S = 300.0
METRICS = ("loss", "total_loss", "grad_norm")
#: a float32 sharded step against the float64 unsharded one: within this
#: many times the float32 unsharded step's own distance from float64
#: (per leaf, relative L2; per metric, relative), or SHARD_TOL
F32_NOISE_FACTOR = 4.0


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    data = {f: ref.make_batches(31 + i, arch=a)
            for i, (f, a) in enumerate(FAMILIES.items())}
    first = {f: ref.first_state("adamw", arch=a, cfg=CFG.get(f))
             for f, a in FAMILIES.items()}
    base = dict(mesh=MESH, rules="DEFAULT_RULES", optimizer="adamw",
                accum=ref.ACCUM, compress=False, kw=ref.KW, float64=True)
    ckpt = tmp_path_factory.mktemp("sharded-ckpt")
    runs = [dict(base, name=f, arch=a, state=first[f], batches=data[f],
                 cfg=exact_cfg(f), ckpt=str(ckpt / f), capture=True)
            for f, a in FAMILIES.items()]
    # each family in its configured dtypes (float32 masters), where the
    # float32 collectives and the MoE's float32 partial sum run
    runs += [dict(base, name=f"{f}/float32", arch=FAMILIES[f],
                  state=first[f], batches=data[f], cfg=exact_cfg(f),
                  float64=False) for f in F32_FAMILIES]
    # the MoE at its own capacity factor, where groups drop pairs
    runs.append(dict(base, name="moe/drops", arch=FAMILIES["moe"],
                     state=first["moe"], batches=data["moe"]))
    group = torch_ranks.Ranks(torch_ranks.train_runs, 4, runs,
                              deadline_s=DEADLINE_S)
    jax_mesh = ref.JaxMeshRuns(
        str(tmp_path_factory.mktemp("jax-mesh") / "run"), *MESH,
        "DEFAULT_RULES",
        [dict(name=f, arch=a, cfg=CFG.get(f, {}), optimizer="adamw",
              seed=0, accum=ref.ACCUM, batches=data[f])
         for f, a in FAMILIES.items()]) if ref.HAVE_JAX else None
    plain = {f: ref.port_run("adamw", first[f], data[f], arch=a,
                             cfg=exact_cfg(f), float64=True, capture=True)
             for f, a in FAMILIES.items()}
    plain32 = {f: ref.port_run("adamw", first[f], data[f],
                               arch=FAMILIES[f], cfg=exact_cfg(f))
               for f in F32_FAMILIES}
    out = dict(plain=plain, plain32=plain32, ckpt=ckpt)
    if ref.HAVE_JAX:
        # the port's float64 step unsharded at the JAX runs' config, and
        # each step's float32 noise: the JAX step unsharded against it
        truth = {f: plain[f][1] for f in FAMILIES if f not in NO_DROP}
        truth["moe"] = ref.port_run("adamw", first["moe"], data["moe"],
                                    arch=FAMILIES["moe"], float64=True)[1]
        noise = {}
        for f, a in FAMILIES.items():
            jm = ref.jax_run("adamw", data[f], arch=a, cfg=CFG.get(f))[2]
            noise[f] = [{k: abs(j[k] - t[k]) / abs(t[k]) for k in METRICS}
                        for j, t in zip(jm, truth[f])]
        out.update(truth=truth, noise=noise, jax_mesh=jax_mesh.results())
    out["ranks"] = group.results()
    return out


@pytest.fixture(scope="module")
def jax_results(results):
    """``results`` with the JAX references: skips where JAX is not
    installed."""
    pytest.importorskip("jax")
    return results


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_step_matches_the_unsharded_step(family, results):
    plain, ranks = results["plain"], results["ranks"]
    metrics, final, _ = ranks[0][family][:3]
    err, path = ref.worst(final, plain[family][0])
    assert err <= ref.SHARD_TOL, (path, err)
    for m, want in zip(metrics, plain[family][1]):
        for k in ("loss", "total_loss", "grad_norm", "lr"):
            assert abs(m[k] - want[k]) <= ref.SHARD_TOL * abs(want[k]), k
        if family == "moe":
            assert m["moe_dropped"] == want["moe_dropped"] == 0.0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_table_grads_match_the_unsharded_grads(family, results):
    got = results["ranks"][0][family][3]["grads"]
    want = results["plain"][family][2]
    tables = [p for p in ("embed", "lm_head") if p in want]
    assert tables == (["embed"] if family == "audio"
                      else ["embed", "lm_head"])
    for path in tables:
        err = ref.rel_l2(got[path], want[path])
        assert err <= ref.SHARD_TOL, (path, err)


@pytest.mark.parametrize("family", F32_FAMILIES)
def test_float32_sharded_step_within_the_float32_noise(family, results):
    """The sharded step in float32 against the float64 unsharded step:
    every leaf and metric within ``F32_NOISE_FACTOR`` times the float32
    unsharded step's own distance from float64, or ``SHARD_TOL``."""
    p64, p32 = results["plain"][family], results["plain32"][family]
    metrics, final, _ = results["ranks"][0][f"{family}/float32"][:3]
    got, want, own = (flatten_paths(t) for t in (final, p64[0], p32[0]))
    assert sorted(got) == sorted(want)
    for path in (p for p in want if np.asarray(want[p]).dtype.kind == "f"):
        noise = ref.rel_l2(own[path], want[path])
        err = ref.rel_l2(got[path], want[path])
        assert err <= max(ref.SHARD_TOL, F32_NOISE_FACTOR * noise), \
            (path, err, noise)
    for m, w, o in zip(metrics, p64[1], p32[1]):
        for k in METRICS:
            noise = abs(o[k] - w[k]) / abs(w[k])
            assert abs(m[k] - w[k]) <= max(
                ref.SHARD_TOL, F32_NOISE_FACTOR * noise) * abs(w[k]), \
                (k, noise)
        if family == "moe":
            assert m["moe_dropped"] == w["moe_dropped"] == 0.0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_step_matches_jax_under_the_mesh(family, jax_results):
    noise, jax_mesh, ranks = (jax_results[k] for k in
                              ("noise", "jax_mesh", "ranks"))
    metrics, final, _ = ranks[0]["moe/drops" if family == "moe"
                                 else family][:3]
    jfinal, jmetrics = jax_mesh[family]
    got, want = flatten_paths(final), flatten_paths(jfinal)
    assert sorted(got) == sorted(want)
    for path in (p for p in want if p.startswith("params/")):
        np.testing.assert_allclose(got[path], want[path], rtol=ref.TRAJ_TOL,
                                   atol=1e-6, err_msg=path)
    err, path = ref.worst(final, jfinal, "opt/")
    assert err <= ref.MOMENT_TOL, (path, err)
    for m, want, floor in zip(metrics, jmetrics, noise[family]):
        assert np.float32(m["lr"]) == np.float32(want["lr"])
        for k in METRICS:
            tol = max(ref.TRAJ_TOL, 2 * floor[k])
            assert abs(m[k] - want[k]) <= tol * abs(want[k]), (k, floor[k])
        if family == "moe":
            assert m["moe_dropped"] == want["moe_dropped"]


def test_moe_groups_drop_what_jax_drops_under_the_mesh(jax_results):
    """On the mesh each data shard's group takes its own capacity, so
    the MoE drops other pairs than its one group unsharded; the JAX step
    under the mesh drops the same share as the port's."""
    truth, jax_mesh, ranks = (jax_results[k] for k in
                              ("truth", "jax_mesh", "ranks"))
    got = [m["moe_dropped"] for m in ranks[0]["moe/drops"][0]]
    want = [m["moe_dropped"] for m in jax_mesh["moe"][1]]
    one_group = [m["moe_dropped"] for m in truth["moe"]]
    assert got == want
    assert all(g > 0 for g in got)
    assert got != one_group


@pytest.mark.parametrize("family", list(FAMILIES))
def test_shards_follow_the_specs_and_replicas_agree(family, results):
    ranks = results["ranks"]
    for name in (family,) + (f"{family}/float32",) * (
            family in F32_FAMILIES) + (("moe/drops",) * (family == "moe")):
        for rank, out in enumerate(ranks):
            assert out[name][2] == [], (rank, out[name][2][:5])
            assert (out[name][1] is None) == (rank != 0)
            assert out[name][0] == ranks[0][name][0]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_checkpoints_restore_onto_the_mesh(family, results):
    """Each family's sharded final state, saved from the mesh (rank 0
    writes the JAX layout: groups, or ``enc_blocks`` and ``dec_blocks``,
    stacked), restores with ``shardings=`` onto the mesh bit for bit and
    on its specs, and the JAX package's store reads the same leaves."""
    ranks, ckpt = results["ranks"], results["ckpt"]
    for rank, out in enumerate(ranks):
        same, faults = out[family][-1]
        assert same and faults == [], (rank, faults[:5])
    pytest.importorskip("jax")
    from repro.runtime.checkpoint import CheckpointStore as JStore
    final = flatten_paths(ranks[0][family][1])
    jstate, _ = JStore(str(ckpt / family), async_io=False).restore(
        ref.STEPS, like=ranks[0][family][1])
    got = flatten_paths(ref.host(jstate))
    assert sorted(got) == sorted(final)
    for k, v in final.items():
        assert np.asarray(got[k]).tobytes() == np.asarray(v).tobytes(), k
