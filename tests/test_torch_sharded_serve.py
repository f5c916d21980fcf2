"""The port's serving under a mesh (``launch/dryrun.py``'s
``_lower_prefill`` and ``_lower_decode``) on 4 gloo CPU ranks, one
spawned group that makes two meshes, ("data", "model") = (2, 2) and
(1, 4): the float32 smoke variants of smollm-135m (dense),
qwen3-moe-30b-a3b (MoE), recurrentgemma-9b (hybrid) and rwkv6-3b (ssm),
the four families the JAX package's own integration test lowers under
SERVE_RULES.  Each run prefills B 4 prompts of 30 tokens into caches of
64 positions (the hybrid's ring holds 32, so its 4 decode steps cross the
wrap: slots 30, 31, 0, 1, on both sides of a length shard's edge), then
takes 4 greedy decode steps.  The runs (``RUNS``):

- (2, 2) under SERVE_RULES: the four families;
- (2, 2) under SERVE_BIG_RULES (fsdp over "data"), under SERVE_RULES
  with the int8 KV cache, and with smollm-135m's 9 query and 3 KV heads,
  which the model axis does not divide: dense;
- (1, 4) under SERVE_RULES: dense and MoE, a 4-way split-K over the
  length; the MoE's 4 query heads over its 2 KV heads, which the model
  axis does not divide, so each rank takes the KV head of its own query
  head;
- the vlm (internvl2-26b, 8 patches before the 30 tokens) on (2, 2)
  under SERVE_RULES and SERVE_BIG_RULES, and the enc-dec (whisper-medium,
  64 frames and a BOS) on (2, 2) under both and on (1, 4): its encoder's
  flash on each rank's heads, its cross (k, v) length-sharded over
  "model" as ``cache_axes`` names it, so its cross-attention is a split-K
  in prefill and decode.

Each run is held
- to the port unsharded on the same weights and prompts: the logits at
  every step within ``MESH_TOL`` relative L2, equal tokens, the caches
  gathered within ``CACHE_TOL`` per leaf (the int8 codes bit for bit).
  The MoE runs on (2, 2) at capacity_factor = n_experts / top_k, where no
  pair drops: the mesh dispatches one group per data shard, each with
  its own capacity (ROADMAP queue 3 item r);
- to the JAX package under the same mesh (``sharded_ref.JaxMeshServe``:
  the jits that its ``_lower_prefill`` / ``_lower_decode`` build, fed
  the same float32 weights): the MoE's routing of every call first (queue
  3 item q), then the logits within ``sharded_ref.TRAJ_TOL``, equal
  tokens and equal ``moe_dropped``.  "moe/drops" is the MoE on (2, 2) at
  its own capacity factor, where its groups drop pairs that one group
  keeps; decode has T = B = 4 tokens, 2 a group, at least top_k as the
  JAX halving loop needs;
- on every rank: each cache leaf placed by its spec (the KV cache's
  length over "model"), its shard exactly the positions, rows and heads
  the spec names;
- the token lookup (``LOOKUP_RUNS``: the dense model's
  ``embed_inputs`` and the whisper decoder's, on (2, 2) and (1, 4)),
  placed under DEFAULT_RULES, FSDP_RULES, SERVE_RULES and
  SERVE_BIG_RULES in turn, to the unsharded lookup bit for bit in
  float32 and bf16, ids on every vocab shard's edges included; each
  rank holds its batch shard of it alone.

Where JAX cannot be imported the JAX comparisons skip (README.md shows
the command that hides JAX on a card's host).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sharded_ref as ref  # noqa: E402
import torch_ranks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.convert import params_to_jax  # noqa: E402

B, S, CACHE, STEPS = 4, 30, 64, 4
DM = ("data", "model")
_moe = configs.smoke_variant(configs.ARCHS["qwen3-moe-30b-a3b"])
NO_DROP = {"capacity_factor": _moe.n_experts / _moe.top_k}
_whisper = configs.smoke_variant(configs.ARCHS["whisper-medium"])
#: name -> (arch, mesh shape, rules, smoke overrides)
RUNS = {
    "dense": ("smollm-135m", (2, 2), "SERVE_RULES", {}),
    "moe": ("qwen3-moe-30b-a3b", (2, 2), "SERVE_RULES", NO_DROP),
    "moe/drops": ("qwen3-moe-30b-a3b", (2, 2), "SERVE_RULES", {}),
    "hybrid": ("recurrentgemma-9b", (2, 2), "SERVE_RULES", {}),
    "ssm": ("rwkv6-3b", (2, 2), "SERVE_RULES", {}),
    "dense/big": ("smollm-135m", (2, 2), "SERVE_BIG_RULES", {}),
    "dense/int8": ("smollm-135m", (2, 2), "SERVE_RULES",
                   {"kv_cache_dtype": "int8"}),
    "dense/odd-heads": ("smollm-135m", (2, 2), "SERVE_RULES",
                        {"n_heads": 9, "n_kv_heads": 3}),
    "dense/1x4": ("smollm-135m", (1, 4), "SERVE_RULES", {}),
    "moe/1x4": ("qwen3-moe-30b-a3b", (1, 4), "SERVE_RULES", {}),
    "vlm": ("internvl2-26b", (2, 2), "SERVE_RULES", {}),
    "vlm/big": ("internvl2-26b", (2, 2), "SERVE_BIG_RULES", {}),
    "encdec": ("whisper-medium", (2, 2), "SERVE_RULES", {}),
    "encdec/big": ("whisper-medium", (2, 2), "SERVE_BIG_RULES", {}),
    "encdec/1x4": ("whisper-medium", (1, 4), "SERVE_RULES", {}),
}
#: the runs held to the port unsharded ("moe/drops" drops other pairs)
EXACT = [n for n in RUNS if n != "moe/drops"]
#: the runs whose token lookup is also held under every rule set
LOOKUP_RUNS = ("dense", "dense/1x4", "encdec", "encdec/1x4")
#: mesh against unsharded, float32: the same sums split over shards (a
#: row-parallel product's partial sums, the split-K's parts)
MESH_TOL = 1e-5
CACHE_TOL = 1e-6
#: the ranks' deadline: fifteen runs, each planned by DTensor on first
#: sight
DEADLINE_S = 300.0


def weights(arch, cfg, seed):
    import dataclasses
    c = dataclasses.replace(configs.smoke_variant(configs.ARCHS[arch]),
                            **cfg)
    api = ModelAPI(c, device="cpu")
    api.model.init(torch.Generator().manual_seed(seed))
    return api, params_to_jax(api.model)


def lookup_ids(cfg, rng):
    """(B, S) seeded ids over the whole vocab, with the first and last
    id of every shard a model axis of 2 or 4 cuts first."""
    ids = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    edges = sorted({e for n in (2, 4) for k in range(n)
                    for e in (k * cfg.vocab // n,
                              (k + 1) * cfg.vocab // n - 1)})
    ids[0, :len(edges)] = edges
    return ids


def prompt_inputs(cfg, rng) -> dict:
    """Seeded normals for a vlm's patches (B, V, d) or an enc-dec's frames
    (B, CACHE, d): its cross cache holds CACHE frames, which the serve
    rules split over "model" as its self cache's length."""
    if cfg.is_encdec:
        return {"frames": rng.normal(size=(B, CACHE, cfg.d_model))
                .astype(np.float32)}
    if cfg.vision_tokens:
        return {"patches": rng.normal(size=(B, cfg.vision_tokens,
                                            cfg.d_model)).astype(np.float32)}
    return {}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(27)
    lookup_rng = np.random.default_rng(31)
    runs, apis = [], {}
    for i, (name, (arch, shape, rules, cfg)) in enumerate(RUNS.items()):
        api, params = weights(arch, cfg, seed=i)
        apis[name] = api
        runs.append(dict(name=name, arch=arch, cfg=cfg, mesh=(shape, DM),
                         rules=rules, params=params, cache=CACHE,
                         steps=STEPS, extra=prompt_inputs(api.cfg, rng),
                         tokens=rng.integers(
                             1, 256, (B, 1 if api.cfg.is_encdec else S)
                         ).astype(np.int32)))
        if name in LOOKUP_RUNS:
            runs[-1]["lookup"] = lookup_ids(api.cfg, lookup_rng)
    group = torch_ranks.Ranks(torch_ranks.serve_runs, 4, runs,
                              deadline_s=DEADLINE_S)
    jax_mesh = ref.JaxMeshServe(
        str(tmp_path_factory.mktemp("jax-serve") / "run"), runs) \
        if ref.HAVE_JAX else None
    plain = {}
    for r in runs:
        logits, toks, caches, dropped, routes = torch_ranks.serve_once(
            apis[r["name"]], r["tokens"], CACHE, STEPS, extra=r["extra"])
        plain[r["name"]] = dict(
            logits=logits, tokens=toks, dropped=dropped, routes=routes,
            caches=torch_ranks.cache_report(apis[r["name"]], caches, None,
                                            None)[2])
        if "lookup" in r:
            plain[r["name"]]["lookup"] = torch_ranks.lookup_bits(
                apis[r["name"]], r["lookup"])
    out = {"plain": plain, "runs": {r["name"]: r for r in runs}}
    if jax_mesh is not None:
        out["jax"] = jax_mesh.results()
    out["ranks"] = group.results()
    return out


@pytest.fixture(scope="module")
def jax_results(results):
    pytest.importorskip("jax")
    return results


def rel(a, b) -> float:
    return ref.rel_l2(a, b)


@pytest.mark.parametrize("name", EXACT)
def test_mesh_serving_matches_the_port_unsharded(name, results):
    got, want = results["ranks"][0][name], results["plain"][name]
    assert len(got["logits"]) == STEPS + 1
    for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        assert a.shape == b.shape == (B, 1, 256)
        assert np.isfinite(a).all()
        assert rel(a, b) <= MESH_TOL, (i, rel(a, b))
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["dropped"] == want["dropped"]
    caches, plain = got["caches"], want["caches"]
    assert sorted(caches) == sorted(plain)
    for path, w in plain.items():
        g = caches[path]
        if not isinstance(w, np.ndarray):
            assert g == w, path                      # "len"
        elif w.dtype == np.int8:
            assert g.tobytes() == w.tobytes(), path
        else:
            assert rel(g, w) <= CACHE_TOL, (path, rel(g, w))


def mesh_routing(ranks, name, T):
    """Each MoE call's routing (T, k) on the mesh: the groups of the
    ranks at "model" coordinate 0 in "data" order, or rank 0's where one
    rank holds every group."""
    firsts = sorted((r[name]["coord"], r[name]["routes"]) for r in ranks
                    if r[name]["coord"][1] == 0)
    out = []
    for c, calls in enumerate(ranks[0][name]["routes"]):
        whole = len(calls) == T[c]
        out.append(calls if whole else
                   np.concatenate([routes[c] for _, routes in firsts]))
    return out


def pairs(dropped: float, T: int) -> int:
    """The pairs a MoE call of T tokens dropped, from its moe_dropped."""
    return int(np.rint(dropped * T * _moe.top_k))


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_serving_matches_jax_under_the_mesh(name, jax_results):
    got = jax_results["ranks"][0][name]
    jlogits, jdropped, jroutes = jax_results["jax"][name]
    if RUNS[name][0] == "qwen3-moe-30b-a3b":
        # routing first: a flip between two correct float32 paths would
        # explain a logit difference (ROADMAP queue 3 item q)
        T = [len(r) for r in jroutes]
        routes = mesh_routing(jax_results["ranks"], name, T)
        assert len(routes) == len(jroutes) == 2 * (STEPS + 1)
        for c, (a, b) in enumerate(zip(routes, jroutes)):
            np.testing.assert_array_equal(a, b, err_msg=f"call {c}")
        # moe_dropped as a count of pairs: the packages round 1 - kept /
        # (T k) apart by an ulp (JAX's is -5.2e-8 where nothing drops)
        drops = [pairs(d, t) for d, t in zip(got["dropped"], T)]
        assert drops == [pairs(d, t) for d, t in zip(jdropped, T)]
        if name == "moe/drops":
            plain = jax_results["plain"][name]["dropped"]
            assert sum(drops) > 0
            assert drops != [pairs(d, t) for d, t in zip(plain, T)]
        elif name == "moe":
            assert not any(drops)
    for i, (a, b) in enumerate(zip(got["logits"], jlogits)):
        assert a.shape == b.shape
        assert rel(a, b) <= ref.TRAJ_TOL, (i, rel(a, b))
    jtoks = np.stack([x[:, -1].argmax(-1) for x in jlogits[:-1]], 1)
    np.testing.assert_array_equal(got["tokens"], jtoks)


@pytest.mark.parametrize("name", LOOKUP_RUNS)
def test_mesh_lookup_equals_the_unsharded_lookup_bit_for_bit(name, results):
    want = results["plain"][name]["lookup"]
    shape, _ = results["runs"][name]["mesh"]
    d = configs.smoke_variant(configs.ARCHS[RUNS[name][0]]).d_model
    for rank, out in enumerate(results["ranks"]):
        got = out[name]["lookup"]
        assert sorted(got) == sorted(torch_ranks.LOOKUP_RULES)
        for rules, bits in got.items():
            # the batch over "data", or over every rank under FSDP_RULES
            rows = B // (shape[0] * (shape[1] if rules == "FSDP_RULES"
                                     else 1))
            for dt in ("float32", "bfloat16"):
                np.testing.assert_array_equal(
                    bits[dt], want[dt], err_msg=f"{rules} {dt} rank {rank}")
                assert bits[f"{dt}/local"] == (rows, S, d), (rules, dt)


@pytest.mark.parametrize("name", list(RUNS))
def test_cache_shards_hold_what_their_specs_name(name, results):
    ranks = results["ranks"]
    for rank, out in enumerate(ranks):
        r = out[name]
        assert r["faults"] == [], (rank, r["faults"][:5])
        np.testing.assert_array_equal(r["tokens"], ranks[0][name]["tokens"])
        assert r["dropped"] == ranks[0][name]["dropped"]
    specs = ranks[0][name]["specs"]
    arch = RUNS[name][0]
    if arch == "rwkv6-3b":
        # the state per batch row over "data" and per head over "model"
        assert specs["0/time/state"] == ("data", "model")
        return
    attn = [p for p in specs if p.endswith("/k")]
    assert attn
    for p in attn:                  # the KV cache's length over "model"
        assert specs[p][:2] == ("data", "model"), (p, specs[p])
    if arch == "whisper-medium":
        # the cross (k, v) of every decoder layer: its frames over "model"
        cross = [p for p in specs if p.startswith("1/")]
        assert len(cross) == 2 * _whisper.n_layers
        for p in cross:
            assert specs[p] == ("data", "model"), (p, specs[p])
    if name == "dense/int8":
        assert specs["0/k_scale"][:2] == specs["0/k"][:2]
    if arch == "recurrentgemma-9b":
        assert specs["0/h"] == ("data", "model")
        assert specs["0/conv"] == ("data", None, "model")
