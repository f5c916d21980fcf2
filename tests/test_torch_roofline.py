"""The port's roofline (``launch/roofline.py``) against the JAX package's
(``repro.launch.roofline``, plain Python, no JAX):

- the analytic model (``analytic_model``, ``analytic_hbm_bytes``,
  ``kv_cache_bytes``) equal on every arch x shape;
- one count everywhere: a smoke cell counts the same FLOPs, bytes,
  kernels and ops on ``cpu`` (the kernels' plain versions, hidden from
  the count) as on ``meta``, host-to-device copies apart;
- the ring accounting on a fake process group of 8 ranks (and 16, which
  spans two nodes of 8): an all-reduce, an all-gather and an all-to-all
  count what the JAX ``_coll_payload`` gives;
- the counted FLOPs of the dense, MoE and ssm smoke cells (prefill,
  decode, train on a (1, 1) mesh) against the JAX ``HloAnalyzer`` on
  the same cell, lowered here by ``jax.jit(...).lower(...).compile()``
  (``repro.launch.dryrun`` is not imported: it sets ``XLA_FLAGS`` for 512
  host devices).  Tolerance ``HLO_TOL`` after one term: flash counts the
  causal pairs alone (4 B H S T hd / 2, as ``chip_smoke.py``'s bound),
  where the JAX prefill's chunked attention computes every (query, key)
  product and masks half of them, so that half of flash's count is added
  back before comparing (``pytest -s -k counted_flops`` prints each
  cell's numbers);
- each kernel's cost formula on its wrapper's meta path.
"""
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels import costs, ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402

#: counted against the JAX HLO walk, relative, after the flash term
HLO_TOL = 0.05


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_analytic_functions_equal_the_jax_package(arch):
    cfg, jcfg = configs.ARCHS[arch], jconfigs.ARCHS[arch]
    P, A = cfg.param_count(), cfg.active_param_count()
    for name, shape in configs.SHAPES_BY_NAME.items():
        jshape = jconfigs.SHAPES_BY_NAME[name]
        assert rl.analytic_model(cfg, shape, P, A) == \
            jrl.analytic_model(jcfg, jshape, P, A)
        assert rl.kv_cache_bytes(cfg, shape) == \
            jrl.kv_cache_bytes(jcfg, jshape)
        for chips, mp, dp, accum in ((256, 16, 16, 1), (512, 16, 32, 4),
                                     (8, 2, 4, 2)):
            kw = dict(chips=chips, mp=mp, dp=dp, accum=accum, n_params=P)
            assert rl.analytic_hbm_bytes(cfg, shape, **kw) == \
                jrl.analytic_hbm_bytes(jcfg, jshape, **kw)


def smoke(arch):
    return configs.smoke_variant(configs.ARCHS[arch])


SHAPES = {"prefill": ShapeConfig("smoke_prefill", "prefill", 32, 2),
          "decode": ShapeConfig("smoke_decode", "decode", 64, 2),
          "train": ShapeConfig("smoke_train", "train", 32, 2)}


def counts(cfg, shape, device):
    mesh = (1, 1) if device == "meta" else "world"
    _, info = dryrun.lower_cell(cfg, shape, mesh, save=False, device=device)
    return info


@pytest.mark.parametrize("arch,kind", [
    ("smollm-135m", "prefill"), ("smollm-135m", "decode"),
    ("rwkv6-3b", "prefill"), ("recurrentgemma-9b", "prefill")])
def test_a_cell_counts_the_same_on_cpu_and_meta(arch, kind):
    on_meta = counts(smoke(arch), SHAPES[kind], "meta")
    on_cpu = counts(smoke(arch), SHAPES[kind], "cpu")
    # RoPE's frequencies, made on the host, are copied to a card (or to
    # meta), and to no device on the CPU: counted apart, as PCIe bytes
    assert on_cpu["counts"].pop("host_copy_bytes") == 0
    assert on_meta["counts"].pop("host_copy_bytes") >= 0
    assert on_meta["counts"] == on_cpu["counts"]
    assert on_meta["arg_bytes_per_device"] == on_cpu["arg_bytes_per_device"]
    if kind == "prefill":
        assert on_cpu["counts"]["kernels"]
    assert on_meta["roofline"] == on_cpu["roofline"]


def test_ring_accounting_on_a_fake_group():
    import torch.distributed._functional_collectives as funcol
    x = torch.empty(64, 32, device="meta")
    want = {"all-reduce": 2 * 64 * 32 * 4 * 7 / 8,
            "all-gather": 8 * 64 * 32 * 4 * 7 / 8,
            "all-to-all": 64 * 32 * 4 * 7 / 8}
    with dryrun.fake_world((8,), ("x",)) as mesh:
        with rl.StepCounter() as c:
            funcol.all_reduce(x, "sum", (mesh, 0))
            funcol.all_gather_tensor(x, 0, (mesh, 0))
            funcol.all_to_all_single(x, None, None, (mesh, 0))
        total, secs, by_kind = rl.collective_terms(c.record())
    assert by_kind == pytest.approx(want)
    groups = "replica_groups={{0,1,2,3,4,5,6,7}}"
    ops_ = {"all-reduce": (64, 32), "all-gather": (512, 32),
            "all-to-all": (64, 32)}
    for kind, dims in ops_.items():
        assert by_kind[kind] == jrl.HloAnalyzer._coll_payload(
            kind, groups, [("f32", list(dims))])
    assert secs == pytest.approx(total / rl.NVLINK_BW)
    # 16 ranks are two nodes of 8: the group's link is a card's NIC
    with dryrun.fake_world((16,), ("x",)) as mesh:
        with rl.StepCounter() as c:
            funcol.all_reduce(x, "sum", (mesh, 0))
        total, secs, _ = rl.collective_terms(c.record())
        (coll,) = c.record()["collectives"]
    assert coll["spans_nodes"] and coll["group_size"] == 16
    assert total == 2 * 64 * 32 * 4 * 15 / 16
    assert secs == pytest.approx(total / rl.NIC_BW)


def jax_hlo_flops(arch, shape):
    """The JAX ``HloAnalyzer``'s FLOPs of the smoke cell, lowered as the
    JAX dry-run lowers it (bf16 serving weights, the train step's state)
    on a one-device mesh."""
    import jax
    import jax.numpy as jnp
    from repro.compat import make_mesh
    from repro.models.api import ModelAPI
    from repro.sharding.partition import (DEFAULT_RULES, SERVE_RULES,
                                          use_mesh)
    from repro.train.trainstep import init_state, make_train_step
    api = ModelAPI(jconfigs.smoke_variant(jconfigs.ARCHS[arch]))
    js = jconfigs.ShapeConfig(shape.name, shape.kind, shape.seq_len,
                              shape.global_batch)
    mesh = make_mesh((1, 1), ("data", "model"))
    params = jax.eval_shape(lambda: api.model.init(jax.random.key(0)))
    bf16 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
        s.shape, jnp.bfloat16 if jnp.issubdtype(s.dtype, jnp.floating)
        else s.dtype), params)
    batch = api.input_specs(js)
    with use_mesh(mesh, DEFAULT_RULES if shape.kind == "train"
                  else SERVE_RULES):
        if shape.kind == "train":
            state = jax.eval_shape(lambda: init_state(api,
                                                      jax.random.key(0)))
            low = jax.jit(make_train_step(api, mesh=mesh)).lower(state,
                                                                 batch)
        elif shape.kind == "prefill":
            low = jax.jit(lambda p, b: api.prefill(p, b, js)).lower(bf16,
                                                                   batch)
        else:
            low = jax.jit(api.serve_step).lower(bf16, batch,
                                                api.cache_specs(js))
    return jrl.HloAnalyzer(low.compile().as_text()).total().flops


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-30b-a3b",
                                  "rwkv6-3b"])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_counted_flops_match_the_jax_hlo(arch, kind):
    info = counts(smoke(arch), SHAPES[kind], "meta")
    roof = info["roofline"]
    port = roof["hlo_flops_per_chip"]
    flash = roof["kernels"].get("flash_attention", {"flops": 0.0})["flops"]
    want = jax_hlo_flops(arch, SHAPES[kind])
    print(f"{arch} {kind}: counted {port!r} flop + flash's masked half "
          f"{flash!r} against the JAX HLO walk's {want!r}: "
          f"{(port + flash) / want!r} (without the flash term "
          f"{port / want!r})")
    assert abs(port + flash - want) <= HLO_TOL * want, (port, flash, want)


def test_each_kernel_cost_on_the_meta_path():
    meta = dict(device="meta")
    q = torch.empty(2, 64, 8, 64, dtype=torch.bfloat16, **meta)
    kv = torch.empty(2, 64, 2, 64, dtype=torch.bfloat16, **meta)
    with rl.StepCounter() as c:
        out = ops.flash_attention(q, kv, kv)
        r = torch.empty(2, 16, 4, 64, dtype=torch.bfloat16, **meta)
        w = torch.empty(2, 16, 4, 64, **meta)
        u = torch.empty(4, 64, **meta)
        o, st = ops.wkv6(r, r, r, w, u)
        a = torch.empty(2, 16, 32, **meta)
        h, last = ops.rglru_scan(a, a)
        keys = torch.empty(100, dtype=torch.int64, **meta)
        hashes = ops.hash_fixed(keys)
        rows = ops.combine_hashes(hashes[None])
        got = ops.gather_payload(keys, torch.empty(50, dtype=torch.int64,
                                                   **meta))
        red, cnt = ops.grouped_reduce(keys, keys, torch.empty(
            7, dtype=torch.int64, **meta), None, ("count", "sum", "max"))
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert o.shape == r.shape and st.shape == (2, 4, 64, 64)
    assert h.shape == a.shape and last.shape == (2, 32)
    assert hashes.shape == rows.shape == (100,) and got.shape == (50,)
    assert cnt.shape == red["sum"].shape == red["max"].shape == (7,)
    k = c.record()["kernels"]
    assert k["flash_attention"] == {
        "calls": 1, "flops": 4 * 2 * 8 * 64 * 64 * 64 / 2,
        "bytes": 2 * (2 * q.numel() + 2 * kv.numel()), "tensor_cores": True}
    assert k["wkv6"]["flops"] == 5 * 64 * 64 * 2 * 16 * 4
    assert k["rglru_scan"]["bytes"] == 4 * (3 * 2 * 16 * 32 + 2 * 32)
    assert k["segreduce"]["bytes"] == 16 * 100 + 8 * 7 * 4
    assert k["filter_join_gather"]["bytes"] == 8 * 100 + 16 * 50
    assert c.record()["flops"] == {"tensor_cores": 0.0, "cuda_cores": 0.0}
    assert set(ops.launch_counts.values()) == {0}
    # the window counts the pairs each row keeps
    assert costs.visible_pairs(5, 5, True, 2) == 9
    assert costs.visible_pairs(4, 4, True, 0) == 8
