"""The port's logical-axis sharding against the JAX package's, on the
CPU and without devices: ``logical_to_spec`` and ``shardings_for_tree``
over every rule set, the meshes (1, 1), (2, 2), (4, 2), (16, 16) and
(2, 16, 16), and every leaf of the params, caches, inputs and train
states (AdamW and Adafactor) of every architecture at full width (shapes
from ``jax.eval_shape``); every axes tree leaf for leaf; the placements a
spec gives; ``constrain`` outside and inside a mesh; the dry-run's
planning functions.  The JAX functions read a mesh's ``axis_names`` and
``devices.shape`` alone, so they take a stand-in; the port's take a
``MeshShape``."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compat import make_mesh  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro.models.api import ModelAPI as JModelAPI  # noqa: E402
from repro.sharding import partition as jpartition  # noqa: E402
from repro.train import optimizer as joptimizer  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import attention, layers, lm, moe, rglru, rwkv6  # noqa: E402,E501
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.train import optimizer, trainstep  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

RULES = ("DEFAULT_RULES", "SP_RULES", "ACT_SP_RULES", "SERVE_RULES",
         "SERVE_BIG_RULES", "FSDP_RULES")
MESHES = {(1, 1): ("data", "model"), (2, 2): ("data", "model"),
          (4, 2): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
ARCH_NAMES = list(jconfigs.ARCHS)


def jmesh(shape):
    return SimpleNamespace(axis_names=MESHES[shape],
                           devices=np.empty(shape, dtype=object))


def tmesh(shape):
    return partition.MeshShape(MESHES[shape], shape)


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keys)


def jflat(axes_tree, specs_tree):
    """([(path, axes, shape)] of the leaves both trees hold, by the JAX
    package's own flattening and in its order; the paths that only one
    of them holds)."""
    axes = dict((_path(k), a) for k, a in
                jax.tree_util.tree_flatten_with_path(
                    axes_tree, is_leaf=jpartition._is_axes_leaf)[0])
    shapes = dict((_path(k), tuple(s.shape)) for k, s in
                  jax.tree_util.tree_flatten_with_path(specs_tree)[0])
    return ([(p, a, shapes[p]) for p, a in axes.items() if p in shapes],
            set(axes) ^ set(shapes))


def flatten_axes(tree, prefix: str = ""):
    """[(path, axes)] of every axes leaf of the port's tree of dicts,
    lists and tuples, in the order ``jax.tree.flatten`` gives (dict keys
    sorted)."""
    if partition._is_axes_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        raise TypeError(f"{prefix}: not an axes tree node: {tree!r}")
    out = []
    for k, v in items:
        out.extend(flatten_axes(v, f"{prefix}/{k}" if prefix else k))
    return out


def known_mismatch(name, label):
    """The reference's own axes/state mismatch (ROADMAP.md queue 3, item
    w): Adafactor's ``state_axes`` factors every leaf of two or more
    dims, its ``init`` only those whose last two dims are both >= 2, so
    a (groups, d, 1, hd) key or value projection (one kv head) has axes
    for vr/vc and a state of v."""
    if label != "state/adafactor":
        return set()
    cfg = jconfigs.ARCHS[name]
    if cfg.n_kv_heads != 1:
        return set()
    kinds = jlm.block_kinds(cfg)
    out = set()
    for i, kind in enumerate(kinds):
        if kind in ("attn", "moe"):
            for w in ("wk", "wv"):
                base = f"opt/v/blocks/b{i}/mix/{w}"
                out |= {base + "/vr", base + "/vc", base + "/v"}
    return out


_CACHE = {}


def trees(name):
    """{label: (JAX axes tree, JAX shapes tree, port axes tree)} of one
    architecture at full width: params, the train states of both
    optimizers (with the compression residual), the inputs of every
    applicable shape and the decode caches."""
    if name in _CACHE:
        return _CACHE[name]
    jcfg = jconfigs.ARCHS[name]
    out = {}
    for opt in ("adamw", "adafactor"):
        jc = dataclasses.replace(jcfg, optimizer=opt)
        tc = dataclasses.replace(configs.ARCHS[name], optimizer=opt)
        japi, api = JModelAPI(jc), ModelAPI(tc, device="meta")
        jst = jax.eval_shape(lambda: jtrainstep.init_state(
            japi, jax.random.key(0), grad_compression=True))
        out[f"state/{opt}"] = (
            jtrainstep.state_axes(japi, grad_compression=True), jst,
            trainstep.state_axes(api, grad_compression=True))
        if opt == "adamw":
            out["params"] = (japi.model.param_axes(), jst["params"],
                             api.model.param_axes())
    japi, api = JModelAPI(jcfg), ModelAPI(configs.ARCHS[name],
                                          device="meta")
    for shape in jconfigs.SHAPES:
        if not jconfigs.shape_applicable(jcfg, shape)[0]:
            continue
        tshape = configs.SHAPES_BY_NAME[shape.name]
        out[f"inputs/{shape.name}"] = (japi.input_axes(shape),
                                       japi.input_specs(shape),
                                       api.input_axes(tshape))
        if shape.kind == "decode":
            out[f"cache/{shape.name}"] = (japi.cache_axes(),
                                          japi.cache_specs(shape),
                                          api.cache_axes())
    _CACHE[name] = out
    return out


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_specs_equal_the_jax_package(name, rules):
    jrules, trules = getattr(jpartition, rules), getattr(partition, rules)
    n = 0
    for label, (jaxes, jspecs, taxes) in trees(name).items():
        leaves, only_one = jflat(jaxes, jspecs)
        assert only_one == known_mismatch(name, label), label
        leaves_t = [(p, a) for p, a in flatten_axes(taxes)
                    if p not in only_one]
        assert leaves_t == [(p, a) for p, a, _ in leaves], label
        for shape in MESHES:
            jm, tm = jmesh(shape), tmesh(shape)
            got = dict(_flat_shardings(partition.shardings_for_tree(
                taxes, tm, trules))) if only_one else \
                dict(_flat_shardings(partition.shardings_for_tree(
                    taxes, tm, trules, _shapes_like(taxes, leaves))))
            for path, axes, shp in leaves:
                want = tuple(jpartition.logical_to_spec(axes, jm, jrules,
                                                        shp))
                assert partition.logical_to_spec(axes, tm, trules,
                                                 shp) == want, \
                    (label, path, shape)
                if not only_one:
                    assert got[path].spec == want, (label, path, shape)
                # without the shape: no divisibility dropping
                assert partition.logical_to_spec(axes, tm, trules) == \
                    tuple(jpartition.logical_to_spec(axes, jm, jrules)), \
                    (label, path, shape)
                partition.spec_to_placements(want, tm)   # mesh order
                n += 1
    assert n > 0


def _shapes_like(axes_tree, leaves):
    """The port axes tree's structure with each leaf's JAX shape (as an
    object with a ``.shape``)."""
    by_path = {p: s for p, _, s in leaves}

    def walk(tree, prefix):
        if partition._is_axes_leaf(tree):
            return SimpleNamespace(shape=by_path[prefix])
        items = tree.items() if isinstance(tree, dict) else \
            enumerate(tree)
        built = {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                 for k, v in items}
        return built if isinstance(tree, dict) else \
            type(tree)(built[i] for i in range(len(tree)))
    return walk(axes_tree, "")


def _flat_shardings(tree, prefix=""):
    if isinstance(tree, partition.NamedSharding):
        yield prefix, tree
        return
    items = sorted(tree.items()) if isinstance(tree, dict) else \
        enumerate(tree)
    for k, v in items:
        yield from _flat_shardings(v, f"{prefix}/{k}" if prefix else str(k))


def test_shardings_for_tree_equals_jax_on_a_real_mesh():
    """On this process's one CPU device, the JAX ``shardings_for_tree``
    (NamedShardings on a real (1, 1) mesh) and the port's agree leaf for
    leaf, with and without shapes."""
    mesh = make_mesh((1, 1), ("data", "model"))
    tm = partition.MeshShape(("data", "model"), (1, 1))
    for label, (jaxes, jspecs, taxes) in trees("smollm-135m").items():
        leaves, only_one = jflat(jaxes, jspecs)
        assert not only_one
        for specs in (None, jspecs):
            want = jax.tree.leaves(
                jpartition.shardings_for_tree(
                    jaxes, mesh, jpartition.FSDP_RULES, specs),
                is_leaf=lambda x: hasattr(x, "spec"))
            got = partition.shardings_for_tree(
                taxes, tm, partition.FSDP_RULES,
                None if specs is None else _shapes_like(taxes, leaves))
            assert [s.spec for _, s in _flat_shardings(got)] == \
                [tuple(w.spec) for w in want], label


def test_rule_tables_are_copies():
    for rules in RULES:
        assert getattr(partition, rules).rules == \
            getattr(jpartition, rules).rules, rules


# -- axes trees, leaf for leaf ---------------------------------------------

def test_module_axes_equal_the_jax_package():
    assert attention.attn_axes() == jattention.attn_axes()
    for kind in ("swiglu", "squared_relu", "gelu"):
        assert layers.mlp_axes(kind) == jlayers.mlp_axes(kind)
    assert moe.moe_axes() == jmoe.moe_axes()
    assert rglru.rglru_axes() == jrglru.rglru_axes()
    assert rwkv6.rwkv_time_axes() == jrwkv6.rwkv_time_axes()
    assert rwkv6.rwkv_channel_axes() == jrwkv6.rwkv_channel_axes()


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_model_axes_trees_equal_the_jax_package(name):
    for cfg_t, cfg_j in ((configs.ARCHS[name], jconfigs.ARCHS[name]),
                         (configs.smoke_variant(configs.ARCHS[name]),
                          jconfigs.smoke_variant(jconfigs.ARCHS[name]))):
        for kv in ("model", "int8"):
            ct = dataclasses.replace(cfg_t, kv_cache_dtype=kv)
            cj = dataclasses.replace(cfg_j, kv_cache_dtype=kv)
            api, japi = ModelAPI(ct, device="meta"), JModelAPI(cj)
            assert api.model.param_axes() == japi.model.param_axes()
            assert api.model.cache_axes() == japi.model.cache_axes()
            assert api.cache_axes() == japi.cache_axes()
            for shape in jconfigs.SHAPES:
                assert api.input_axes(
                    configs.SHAPES_BY_NAME[shape.name]) == \
                    japi.input_axes(shape), shape.name
            if not ct.is_encdec:
                for kind in set(lm.block_kinds(ct)):
                    assert lm.sub_block_axes(kind, ct) == \
                        jlm.sub_block_axes(kind, cj)
                    assert lm.sub_block_cache_axes(kind, ct) == \
                        jlm.sub_block_cache_axes(kind, cj)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_state_axes_equal_the_jax_package(name, opt):
    api = ModelAPI(dataclasses.replace(configs.ARCHS[name], optimizer=opt),
                   device="meta")
    japi = JModelAPI(dataclasses.replace(jconfigs.ARCHS[name],
                                         optimizer=opt))
    pa = api.model.param_axes()
    assert optimizer.make_optimizer(opt).state_axes(pa) == \
        joptimizer.make_optimizer(opt).state_axes(pa)
    for comp in (False, True):
        assert trainstep.state_axes(api, grad_compression=comp) == \
            jtrainstep.state_axes(japi, grad_compression=comp)


# -- placements, constrain, context ----------------------------------------

def test_spec_to_placements():
    m = partition.MeshShape(("pod", "data", "model"), (2, 4, 2))
    assert partition.spec_to_placements((("pod", "data"), None, "model"),
                                        m) == (Shard(0), Shard(0), Shard(2))
    assert partition.spec_to_placements((), m) == (Replicate(),) * 3
    assert partition.spec_to_placements((None, "data"), m) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(AssertionError, match="mesh order"):
        partition.spec_to_placements((("data", "pod"),), m)
    # a shard over a mesh dim of size 1 is the whole tensor: replicated
    m1 = partition.MeshShape(("pod", "data", "model"), (1, 4, 1))
    assert partition.spec_to_placements((("pod", "data"), None, "model"),
                                        m1) == \
        (Replicate(), Shard(0), Replicate())


def test_constrain_outside_and_inside_a_mesh():
    x = torch.ones(4, 6)
    assert partition.current_mesh() is None
    assert partition.constrain(x, ("batch", None)) is x
    assert partition.constrain_tree({"a": x}, {"a": ("batch", None)})["a"] \
        is x
    assert partition.replicated_like(x, x) is x
    m = partition.MeshShape(("data", "model"), (2, 2))
    with partition.use_mesh(m, partition.FSDP_RULES) as got:
        assert got is m and partition.current_mesh() is m
        assert partition.current_rules() is partition.FSDP_RULES
        # a 0-d tensor passes; one with a dimension fell out of DTensor
        s = torch.ones(())
        assert partition.constrain(s, (None,)) is s
        with pytest.raises(TypeError, match="fell out of DTensor"):
            partition.constrain(x, ("batch", None))
    assert partition.current_mesh() is None
    assert partition.current_rules() is partition.DEFAULT_RULES


def test_divisible_pad_and_divisibility():
    assert partition.divisible_pad(9, 16) == 16
    assert partition.divisible_pad(32, 16) == 32
    m = tmesh((16, 16))
    # smollm's 9 heads cannot shard 16 ways: dropped
    assert partition.logical_to_spec(("fsdp", "heads"), m,
                                     partition.DEFAULT_RULES,
                                     (576, 9)) == ("data",)
    # ("pod", "data") on a batch divisible by 2 but not 32 keeps "pod"
    m3 = tmesh((2, 16, 16))
    assert partition.logical_to_spec(("batch", None), m3,
                                     partition.DEFAULT_RULES,
                                     (6, 4)) == ("pod",)


# -- the dry-run's planning ---------------------------------------------------

def h100_jax_auto_plan():
    """The JAX ``auto_plan`` with its budgets for a 16 GB chip (a 4e9-byte
    working set, 8e9 bytes of weights) set to the port's shares of the
    H100's 80 GB (``HBM_BYTES`` / 4 and / 2), the rest of its logic as it
    is (``tests/test_torch_dryrun.py`` lists the cells this moves)."""
    import inspect
    import textwrap
    src = textwrap.dedent(inspect.getsource(jdryrun.auto_plan))
    assert src.count("4e9") == 1 and src.count("8e9") == 1
    src = src.replace("4e9", repr(dryrun.HBM_BYTES / 4)).replace(
        "8e9", repr(dryrun.HBM_BYTES / 2))
    ns = dict(vars(jdryrun))
    exec(src, ns)
    return ns["auto_plan"]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_count_params_and_plans_equal_the_jax_package(name):
    cfg, jcfg = configs.ARCHS[name], jconfigs.ARCHS[name]
    api, japi = ModelAPI(cfg, device="meta"), JModelAPI(jcfg)
    total = dryrun.count_params(api)
    assert total == jdryrun.count_params(japi)
    assert dryrun.active_params(api, total) == \
        jdryrun.active_params(japi, total)
    jplan = h100_jax_auto_plan()
    for shape in jconfigs.SHAPES:
        for mshape in MESHES:
            acc, rules = dryrun.auto_plan(
                cfg, configs.SHAPES_BY_NAME[shape.name], tmesh(mshape))
            jacc, jrules = jplan(jcfg, shape, jmesh(mshape))
            assert (acc, rules.rules) == (jacc, jrules.rules), \
                (shape.name, mshape)


@pytest.mark.parametrize("name", ["smollm-135m", "qwen3-moe-30b-a3b",
                                  "rwkv6-3b", "recurrentgemma-9b",
                                  "internvl2-26b", "whisper-medium"])
def test_lower_train_steps_every_family(name):
    """``_lower_train`` places every family's smoke state on a one-rank
    ("data", "model") mesh and its step takes a batch of
    ``input_specs`` with accum 2 (the JAX dry-run test lowers four of
    them on 8 host devices): the loss equals the unsharded step's from
    the same weights, and every parameter is a DTensor on the mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeConfig
    from torch_ranks import one_rank
    cfg = configs.smoke_variant(configs.ARCHS[name])
    shape = ShapeConfig("t", "train", 16, 4)
    rng = np.random.default_rng(0)
    specs = ModelAPI(cfg, device="meta").input_specs(shape)
    batch = {k: torch.from_numpy(
        rng.integers(1, 256, s).astype(np.int32) if k in ("tokens", "labels")
        else rng.standard_normal(s).astype(np.float32))
        for k, s in specs.items()}
    kw = dict(peak_lr=1e-3, warmup=0, total_steps=10)
    plain = ModelAPI(cfg, device="cpu")
    state = trainstep.init_state(plain, torch.Generator().manual_seed(0))
    _, want = trainstep.make_train_step(plain, accum=2, **kw)(state, batch)
    with one_rank():
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        api = ModelAPI(cfg, device="cpu")
        state, step = dryrun._lower_train(
            api, shape, mesh, partition.DEFAULT_RULES, False, 2,
            generator=torch.Generator().manual_seed(0), **kw)
        assert all(isinstance(p, DTensor) and p.device_mesh == mesh
                   for p in api.model.parameters())
        _, got = step(state, batch)
        assert got["loss"].item() == want["loss"].item()
        assert got["grad_norm"].item() == want["grad_norm"].item()


MOE_T = (8, 12, 64, 96, 128, 1000, 1024, 4096)


@pytest.mark.parametrize("mshape", list(MESHES))
@pytest.mark.parametrize("rules", RULES)
def test_moe_dispatch_groups_equal_the_jax_package(rules, mshape):
    """``_dispatch_groups`` and the per-group capacity of the port's MoE
    equal the JAX ``moe_apply``'s (its group count halved while T % G or
    T // G < k, then C = int(cf * k * T / (G * E)) or 1), on stand-in
    meshes, for both MoE configs at several token counts; and the
    expert-parallel path applies where the JAX ``_token_path``'s
    conditions hold."""
    for arch in ("qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b"):
        cfg, jcfg = configs.ARCHS[arch], jconfigs.ARCHS[arch]
        jrules = getattr(jpartition, rules)
        with jpartition.use_mesh(jmesh(mshape), jrules):
            jg = jmoe._dispatch_groups(jcfg)
        with partition.use_mesh(tmesh(mshape), getattr(partition, rules)):
            assert moe._dispatch_groups(cfg) == jg
            for T in MOE_T:
                G = jg
                while T % G or T // G < jcfg.top_k:
                    G //= 2
                Tl = T // G
                C = int(jcfg.capacity_factor * jcfg.top_k * Tl
                        / jcfg.n_experts) or 1
                assert moe.group_plan(T, cfg) == (G, Tl, C), (arch, T)
                sizes = dict(zip(MESHES[mshape], mshape))
                mp = sizes.get("model", 1)
                gm = sizes.get("pod", 1) * sizes.get("data", 1)
                ep = mp > 1 and jcfg.n_experts % mp == 0 and G == gm
                assert moe.expert_ranks(cfg.n_experts, G) == \
                    (mp if ep else 0), (arch, T)
    # no mesh: one group, whatever T
    assert moe.group_plan(3, configs.ARCHS["qwen3-moe-30b-a3b"])[0] == 1
