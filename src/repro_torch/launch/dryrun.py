"""Multi-pod dry-run of the port: plan, build and count every (arch x
input shape x mesh) cell, the JAX package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

JAX lowers and compiles each cell for 512 host devices; torch has no
separate lowering, so a cell here is run once: on the production meshes
("single" 16 x 16, "multi" 2 x 16 x 16) as rank 0 of a fake process
group of that size (backend "fake", ``FakeStore``), the model, its state
and its inputs on the ``meta`` device, under ``roofline.StepCounter``.
No machine here has 256 cards; a meta run allocates nothing, so a
full-size cell counts its local shards on any host.  With ``--device
cuda`` (``--mesh world``) the cell runs for real on the ranks that exist
(a one-rank group on one card) and its measured step is printed beside
``step_time_bound_s``.  A cell SUCCEEDS when its step has run; its
memory per device, counts and roofline are printed and saved under
runs/dryrun/<arch>--<shape>--<mesh>/ (``REPRO_DRYRUN_DIR``): meta.json
and counts.json, the counted-op record ``launch/reanalyze.py`` reads.

``count_params``, ``active_params`` and ``auto_plan`` are the JAX
functions, the plan's budgets sized for the H100's 80 GB (``HBM_BYTES``).
``_lower_train``, ``_lower_prefill`` and ``_lower_decode`` build what the
JAX ones lower: the weights (and the train state, or the decode caches)
placed on the mesh by their logical axes, the inputs' placements (a
vlm's patches and an enc-dec's frames by their input axes), and the
function, ready to run.  Serving takes bf16 copies of the floating
weights (``_serve_param_specs``), the KV cache's length (and an enc-dec's
cross cache's frames) sharded over "model" under ``SERVE_RULES`` and
``SERVE_BIG_RULES``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple
from unittest import mock

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import ARCHS, SHAPES_BY_NAME, get_arch, shape_applicable
from ..configs.base import ShapeConfig
from ..models.api import ModelAPI
from ..models.convert import jax_leaves, nest, place_params
from ..models.layers import Spec, zero_caches
from ..sharding import partition
from ..sharding.partition import (ACT_SP_RULES, DEFAULT_RULES,
                                  SERVE_BIG_RULES, SERVE_RULES,
                                  ShardingRules, distribute, mesh_shape,
                                  mesh_sizes, shardings_for_tree, use_mesh)
from ..train.trainstep import init_state, make_train_step, shard_state
from . import mesh as meshes
from . import roofline as rl

RUNS = Path(os.environ.get(
    "REPRO_DRYRUN_DIR",
    Path(__file__).resolve().parents[3] / "runs" / "dryrun"))

#: one H100 SXM5's HBM (NVIDIA H100 Tensor Core GPU datasheet: 80 GB); the
#: plan keeps the JAX plan's shares of it (sized there for a 16 GB chip)
HBM_BYTES = 80e9


def count_params(api) -> int:
    return sum(p.numel() for p in api.model.parameters())


def active_params(api, total: int) -> int:
    cfg = api.cfg
    if not cfg.n_experts:
        return total
    per_expert = 3 * cfg.d_model * cfg.d_ff
    inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total - inactive


def auto_plan(arch, shape, mesh):
    """Pick grad-accumulation count + activation sharding so the saved
    remat working set (~6 B/elem: bf16 stack + the f32 backward copy)
    stays under a quarter of a card's HBM (20 GB of the H100's 80).
    Serving shapes use SERVE_RULES (weights replicated over 'data', KV
    cache length-sharded over 'model'), or SERVE_BIG_RULES where the bf16
    weights of a model shard pass half of HBM.  These are the JAX plan's
    shares of a 16 GB chip (4 and 8 GB)."""
    ms = mesh_shape(mesh)
    sizes = dict(zip(ms.axis_names, ms.shape))
    if shape.kind != "train":
        mp = sizes.get("model", 1)
        if arch.param_count() * 2 / mp > HBM_BYTES / 2:
            return 1, SERVE_BIG_RULES
        return 1, SERVE_RULES
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    mp = sizes.get("model", 1)
    budget = HBM_BYTES / 4
    L = arch.n_layers + arch.encoder_layers
    max_accum = max(shape.global_batch // dp, 1)
    accum = 1

    def carry(acc, sp):
        tokens_dev = shape.global_batch * shape.seq_len / dp / acc
        return L * tokens_dev * arch.d_model * 6 / (mp if sp else 1)
    while carry(accum, False) > budget and accum < max_accum:
        accum *= 2
    if carry(accum, False) <= budget:
        return accum, DEFAULT_RULES
    return accum, ACT_SP_RULES


def _lower_train(api, shape, mesh, rules: ShardingRules, compress_grads,
                 accum=1, cast_bf16=False, *, generator=None, **step_kw):
    """(state, step): ``init_state`` (weights from ``generator``, or the
    model's own when it is None) placed on ``mesh`` under ``rules``, and
    ``make_train_step`` on it.  ``shape`` is the global batch the step
    takes; ``step_kw`` go to ``make_train_step`` (peak_lr, warmup,
    total_steps)."""
    if shape.global_batch % accum:
        raise ValueError(f"global batch {shape.global_batch} is no "
                         f"multiple of accum {accum}")
    state = shard_state(api, init_state(api, generator,
                                        grad_compression=compress_grads),
                        mesh, rules, grad_compression=compress_grads)
    step = make_train_step(api, mesh=mesh, rules=rules,
                           grad_compression=compress_grads, accum=accum,
                           cast_bf16=cast_bf16, **step_kw)
    return state, step


class Lowered(NamedTuple):
    """What a serve cell runs: the model (its weights DTensors on the
    mesh), the inputs' ``NamedSharding``s (from ``input_axes``), the
    decode caches placed on the mesh (None for prefill) and the function:
    ``fn(batch)`` for prefill, ``fn(batch, caches)`` for decode.  ``fn``
    places a batch of plain tensors (the same on every rank) by the
    inputs' shardings and runs under the mesh and the rules."""
    params: Any
    inputs: Dict[str, Any]
    caches: Any
    fn: Callable


def _param_specs(api, floating: Optional[torch.dtype] = None) -> Dict:
    """``Spec``s of the model's parameters in the JAX layout (stacked over
    the groups), the floating ones in ``floating`` when it is given."""
    def spec(leaf):
        p = leaf.params[0]
        dt = floating if floating is not None and p.is_floating_point() \
            else p.dtype
        return Spec((len(leaf.params),) * leaf.stacked + tuple(p.shape), dt)
    return nest({leaf.path: spec(leaf) for leaf in jax_leaves(api.model)})


def _serve_param_specs(api) -> Dict:
    """Serving runs bf16 weights: the parameters' ``Spec``s with every
    floating leaf in bfloat16, as the JAX function gives them (the model
    code casts at use anyway)."""
    return _param_specs(api, torch.bfloat16)


def _place_for_serving(api, shape, mesh, rules: ShardingRules,
                       param_specs=None) -> Dict[str, Any]:
    """Cast the model's weights to ``param_specs`` (``_serve_param_specs``
    by default) and place them by ``param_axes`` under ``rules``; returns
    the inputs' shardings at ``shape``."""
    specs = param_specs if param_specs is not None \
        else _serve_param_specs(api)
    place_params(api.model, shardings_for_tree(
        api.model.param_axes(), mesh, rules, specs), specs)
    return shardings_for_tree(api.input_axes(shape), mesh, rules,
                              api.input_specs(shape))


def _placed(batch: Dict[str, torch.Tensor], shardings) -> Dict:
    return {k: v if isinstance(v, DTensor) else distribute(v, shardings[k])
            for k, v in batch.items()}


def _lower_prefill(api, shape, mesh, rules: ShardingRules,
                   param_specs=None) -> Lowered:
    """Prefill under ``mesh`` and ``rules``: the weights in
    ``param_specs``' dtypes (bf16 by default) placed by ``param_axes``,
    and ``fn(batch)`` -> (last logits placed ("batch", "act_seq",
    "vocab"), the caches of ``shape.seq_len`` positions, placed by
    ``cache_axes``)."""
    b_sh = _place_for_serving(api, shape, mesh, rules, param_specs)

    def fn(batch):
        with use_mesh(mesh, rules):
            return api.prefill(_placed(batch, b_sh), shape)
    return Lowered(api.model, b_sh, None, fn)


def _lower_decode(api, shape, mesh, rules: ShardingRules,
                  param_specs=None) -> Lowered:
    """One decode step under ``mesh`` and ``rules``: the weights as for
    ``_lower_prefill``, zero caches of ``cache_specs(shape)`` placed by
    ``cache_axes(stacked=False)`` (made in their shards), and ``fn(batch,
    caches)`` -> (logits, caches), the caches updated in place (JAX
    donates them).  ``fn`` takes these caches or prefill's, which are
    placed the same way."""
    b_sh = _place_for_serving(api, shape, mesh, rules, param_specs)
    with use_mesh(mesh, rules):
        caches = zero_caches(api.cache_specs(shape),
                             api.cache_axes(stacked=False), api.device)

    def fn(batch, caches):
        with use_mesh(mesh, rules):
            return api.serve_step(_placed(batch, b_sh), caches)
    return Lowered(api.model, b_sh, caches, fn)


# --------------------------------------------------------------------------
# a cell: plan, build, count, (on a card) time
# --------------------------------------------------------------------------

PRODUCTION = meshes.PRODUCTION
#: timed steps of a cell on a card, after its counted run
REPEATS = 5


def _layout(mesh) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of a mesh named "single" or "multi", or given
    by its sizes: ("data", "model"), or ("pod", "data", "model") for
    three."""
    if isinstance(mesh, str):
        return PRODUCTION[mesh]
    names = ("data", "model") if len(mesh) == 2 \
        else ("pod", "data", "model")
    return tuple(mesh), names


@contextlib.contextmanager
def _cuda_collectives():
    """DTensor swaps an all-to-all for an all-gather and a chunk on a CPU
    mesh (gloo has no all-to-all, torch 2.13); the fake world's CPU mesh
    stands for the cards', so it is made to issue what a CUDA mesh
    issues.  Where this torch has no such switch, nothing changes."""
    from torch.distributed.tensor import _collective_utils as cu
    if not hasattr(cu, "local_tensor_mode"):
        yield
        return
    with mock.patch.object(cu, "local_tensor_mode", lambda: True):
        yield


@contextlib.contextmanager
def fake_world(shape: Tuple[int, ...], names: Tuple[str, ...],
               rank: int = 0):
    """A ``DeviceMesh`` of ``shape`` on which this process is rank
    ``rank`` of a fake process group of that size (collectives return at
    once, their tensors untouched): what a dry run on ``meta`` needs, and
    a way to see one rank's shards of a mesh no host has.  The group is
    destroyed on exit; none may be up before."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is up already; a fake world "
                           "makes its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        with _cuda_collectives():
            yield init_device_mesh("cpu", tuple(shape),
                                   mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _real_world(mesh_name, device: torch.device):
    """The mesh of the ranks that exist: torchrun's group
    (``mesh.init_distributed``), or a one-rank group of this process (an
    in-memory store) when none is described; "world" is
    ``mesh_for_shape`` of the world size, else ``_layout``'s (which needs
    as many ranks)."""
    own = not dist.is_initialized()
    if own and "RANK" in os.environ:
        meshes.init_distributed(device)
    elif own:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    try:
        if mesh_name == "world":
            shape = meshes.mesh_for_shape(dist.get_world_size())
            yield meshes.make_mesh(shape, ("data", "model"), device)
        else:
            yield meshes.make_mesh(*_layout(mesh_name), device)
    finally:
        if own:
            dist.destroy_process_group()


def _inputs(api, shape: ShapeConfig, device: torch.device,
            generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    """Plain inputs of ``input_specs(shape)``: empty on ``meta``, else
    seeded ids in [1, vocab), decode positions at the cache's last place
    and normals for patches or frames."""
    out = {}
    for k, spec in api.input_specs(shape).items():
        kw = dict(dtype=spec.dtype, device=device)
        if device.type == "meta":
            out[k] = torch.empty(spec, **kw)
        elif spec.dtype.is_floating_point:
            out[k] = torch.randn(spec, generator=generator,
                                 device=device).to(spec.dtype)
        elif k == "positions":
            out[k] = torch.full(spec, shape.seq_len - 1, **kw)
        else:
            out[k] = torch.randint(1, api.cfg.vocab, spec,
                                   generator=generator, **kw)
    return out


def _build(api, shape: ShapeConfig, mesh, rules: ShardingRules, *,
           compress_grads: bool, accum: int, cast_bf16: bool,
           generator: Optional[torch.Generator]):
    """(the step's arguments, ``run()`` -> its outputs): one train step,
    prefill or decode step of the cell, its state or caches kept between
    runs (a train step's new state feeds the next)."""
    batch = _inputs(api, shape, api.device, generator)
    if shape.kind == "train":
        state, step = _lower_train(api, shape, mesh, rules, compress_grads,
                                   accum, cast_bf16, generator=generator)
        held = {"state": state}

        def run():
            held["state"], metrics = step(held["state"], batch)
            return held["state"], metrics
        return (state, batch), run
    if generator is not None:
        api.model.init(generator)
    if shape.kind == "prefill":
        low = _lower_prefill(api, shape, mesh, rules)
        return (low.params, batch), lambda: low.fn(batch)
    low = _lower_decode(api, shape, mesh, rules)
    return (low.params, batch, low.caches), \
        lambda: low.fn(batch, low.caches)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mesh_name(mesh) -> str:
    return mesh if isinstance(mesh, str) else "x".join(map(str, mesh))


def lower_cell(arch, shape, mesh, *, rules: ShardingRules = None,
               compress_grads: bool = False, save: bool = True,
               attention_impl: str = None, accum: int = None,
               cast_bf16: bool = False, kv_int8: bool = False,
               device="meta"):
    """Returns (ok, info-dict), as the JAX ``lower_cell``.  ``arch`` and
    ``shape`` are names (or configs: a smoke variant, a cut shape);
    ``mesh`` is "single" or "multi" (the production meshes), a tuple of
    sizes (``_layout``), or off meta "world" (the ranks that exist).  On
    ``meta`` the cell runs once in a fake world of the mesh's size; on
    ``cuda`` (or ``cpu``) it runs on the real ranks, once counted and
    then ``REPEATS`` times timed, with weights and inputs drawn from a
    seeded generator.  ``info`` holds the plan,
    ``run_s`` (building and the counted run: JAX's lower_s + compile_s),
    the memory per device, the roofline report, the counts (``counts``,
    saved as counts.json) and, off meta, each timed step's seconds
    (``step_s``)."""
    arch = get_arch(arch) if isinstance(arch, str) else arch
    if attention_impl:
        arch = dataclasses.replace(arch, attention_impl=attention_impl)
    if kv_int8:
        arch = dataclasses.replace(arch, kv_cache_dtype="int8")
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    ok, why = shape_applicable(arch, shape)
    if not ok:
        return True, {"skipped": why}
    dev = torch.device(device)
    world = fake_world(*_layout(mesh)) if dev.type == "meta" \
        else _real_world(mesh, dev)
    name = f"{arch.name}--{shape.name}--{_mesh_name(mesh)}"
    t0 = time.time()
    with world as dmesh:
        sizes = mesh_sizes(dmesh)
        auto_acc, auto_rules = auto_plan(arch, shape, dmesh)
        accum = auto_acc if accum is None else accum
        rules = auto_rules if rules is None else rules
        api = ModelAPI(arch, device=dev)
        total = count_params(api)
        gen = None if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(0)
        with use_mesh(dmesh, rules):
            args, run = _build(api, shape, dmesh, rules,
                               compress_grads=compress_grads, accum=accum,
                               cast_bf16=cast_bf16, generator=gen)
            with rl.StepCounter(args) as counter:
                out = run()
                _sync(dev)
            run_s = time.time() - t0
            memory = counter.memory(out)
            del out
            steps = []
            if dev.type != "meta":
                for _ in range(REPEATS):
                    _sync(dev)
                    t1 = time.perf_counter()
                    run()
                    _sync(dev)
                    steps.append(time.perf_counter() - t1)
    record = counter.record()
    chips = math.prod(sizes.values())
    info = {
        "arch": arch.name, "shape": shape.name, "mesh": _mesh_name(mesh),
        "device": dev.type, "chips": chips, "mesh_shape": sizes,
        "accum": accum, "bf16_params": cast_bf16,
        "act_sp": dict(rules.rules).get("act_seq") is not None,
        "rules": [k for k, v in vars(partition).items()
                  if isinstance(v, ShardingRules) and v == rules],
        "run_s": run_s, "params": total,
        "active_params": active_params(api, total), **memory,
        "arch_config": dataclasses.asdict(arch),
        "shape_config": dataclasses.asdict(shape),
    }
    roof = rl.roofline_report(
        record, chips=chips, arch=arch, shape=shape, n_params=total,
        n_active=info["active_params"], mp=sizes.get("model", 1),
        dp=sizes.get("data", 1) * sizes.get("pod", 1), accum=accum)
    info["roofline"] = roof
    if steps:
        info["step_s"] = steps
    info["counts"] = record
    print(f"[{arch.name} × {shape.name} × {_mesh_name(mesh)}] on "
          f"{dev.type}: run {run_s:.1f}s; per device: args "
          f"{memory['arg_bytes_per_device']} B, temp "
          f"{memory['temp_bytes_per_device']} B, peak "
          f"{memory['peak_bytes_per_device']} B")
    print(f"  counted: {roof['hlo_flops_per_chip']:.4g} flop "
          f"({roof['flops_tensor_cores']:.4g} on the tensor cores), "
          f"{roof['hlo_bytes_upper_bound']:.4g} bytes, collectives "
          f"{roof['collective_by_kind']}")
    print(f"  roofline: compute {roof['compute_s']*1e3:.3f}ms "
          f"memory {roof['memory_s']*1e3:.3f}ms "
          f"collective {roof['collective_s']*1e3:.3f}ms "
          f"-> {roof['dominant']}-bound "
          f"(useful-FLOP {roof['useful_flop_fraction']:.2f}, "
          f"roofline-frac {roof['roofline_fraction']:.3f})")
    if steps:
        med = statistics.median(steps)
        print(f"  measured step: median {med * 1e3:.3f}ms of {len(steps)} "
              f"against step_time_bound_s "
              f"{roof['step_time_bound_s'] * 1e3:.3f}ms "
              f"({roof['step_time_bound_s'] / med:.4f} of the bound)")
    if save:
        d = RUNS / name
        d.mkdir(parents=True, exist_ok=True)
        meta = {k: v for k, v in info.items() if k != "counts"}
        (d / "meta.json").write_text(json.dumps(meta, indent=1,
                                                default=float))
        (d / "counts.json").write_text(json.dumps(record, indent=1))
    return True, info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "world"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--attention-impl", default=None)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--act-sp", action="store_true")
    ap.add_argument("--fsdp-only", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--device", default="meta",
                    help="meta (count only, any mesh), or cuda / cpu: run "
                         "and time the cell on the ranks that exist")
    args = ap.parse_args(argv)

    rules = None          # auto (per-cell plan)
    if args.seq_parallel:
        rules = partition.SP_RULES
    if args.act_sp:
        rules = ACT_SP_RULES
    if args.fsdp_only:
        rules = partition.FSDP_RULES

    mesh_names = ["single", "multi"] if args.mesh == "both" \
        else [args.mesh]
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES_BY_NAME) if (args.all or not args.shape) \
        else [args.shape]

    results, failures = [], []
    for a in archs:
        for s in shapes:
            for m in mesh_names:
                try:
                    ok, info = lower_cell(
                        a, s, m, rules=rules,
                        compress_grads=args.compress_grads,
                        attention_impl=args.attention_impl,
                        accum=args.accum, cast_bf16=args.bf16_params,
                        kv_int8=args.kv_int8, device=args.device)
                    if "skipped" in info:
                        print(f"[{a} × {s} × {m}] {info['skipped']}")
                    results.append(info)
                except Exception as e:
                    traceback.print_exc()
                    failures.append((a, s, m, repr(e)))
    print(f"\n== dry-run: {len(results)} cells ok, "
          f"{len(failures)} failed ==")
    for f in failures:
        print("  FAIL:", f)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
