"""The port's dry-run (``launch/dryrun.py``): ``auto_plan`` against the
JAX package's on every arch x shape x production mesh, the cells its
budget for the H100's 80 GB changes listed; ``lower_cell`` on ``meta``
for smoke cells on the "single" mesh (256 ranks of a fake process
group), writing meta.json and counts.json; ``reanalyze`` giving the
same report from those files; the command line on a full-size cell; and
smollm-135m's ``prefill_32k`` on "single", where each device embeds its
own batch shard of the tokens alone.

The JAX ``auto_plan`` is read out of ``src/repro/launch/dryrun.py`` and
run alone: importing that module sets ``XLA_FLAGS`` for 512 host devices
(its line 2), which would reach every later JAX test of the process.
"""
import ast
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.sharding import partition as jpartition  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, reanalyze  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.sharding.partition import MeshShape  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: (arch, shape, mesh) -> ((JAX accum, rules), (port accum, rules)): the
#: cells the H100 budget moves.  Train keeps its working set under a
#: quarter of HBM (20 GB, was 4 GB of a 16 GB chip), so it takes fewer
#: microbatches and needs no activation sequence sharding; serving keeps
#: the bf16 weights of a model shard under half of HBM (40 GB, was 8), so
#: deepseek-67b and qwen3-moe-235b-a22b replicate their weights over
#: "data" (SERVE_RULES) on both production meshes.
CHANGED = {
    ("granite-8b", "train_4k", "single"): ((16, "DEFAULT_RULES"),
                                           (4, "DEFAULT_RULES")),
    ("smollm-135m", "train_4k", "single"): ((2, "DEFAULT_RULES"),
                                            (1, "DEFAULT_RULES")),
    ("deepseek-67b", "train_4k", "single"): ((16, "ACT_SP_RULES"),
                                             (16, "DEFAULT_RULES")),
    ("qwen3-moe-30b-a3b", "train_4k", "single"): ((16, "DEFAULT_RULES"),
                                                  (2, "DEFAULT_RULES")),
    ("qwen3-moe-235b-a22b", "train_4k", "single"): ((16, "ACT_SP_RULES"),
                                                    (8, "DEFAULT_RULES")),
    ("recurrentgemma-9b", "train_4k", "single"): ((16, "DEFAULT_RULES"),
                                                  (4, "DEFAULT_RULES")),
    ("internvl2-26b", "train_4k", "single"): ((16, "ACT_SP_RULES"),
                                              (8, "DEFAULT_RULES")),
    ("rwkv6-3b", "train_4k", "single"): ((16, "DEFAULT_RULES"),
                                         (2, "DEFAULT_RULES")),
    ("whisper-medium", "train_4k", "single"): ((8, "DEFAULT_RULES"),
                                               (1, "DEFAULT_RULES")),
    ("granite-8b", "train_4k", "multi"): ((8, "DEFAULT_RULES"),
                                          (2, "DEFAULT_RULES")),
    ("deepseek-67b", "train_4k", "multi"): ((8, "ACT_SP_RULES"),
                                            (8, "DEFAULT_RULES")),
    ("qwen3-moe-30b-a3b", "train_4k", "multi"): ((8, "DEFAULT_RULES"),
                                                 (1, "DEFAULT_RULES")),
    ("qwen3-moe-235b-a22b", "train_4k", "multi"): ((8, "ACT_SP_RULES"),
                                                   (4, "DEFAULT_RULES")),
    ("recurrentgemma-9b", "train_4k", "multi"): ((8, "DEFAULT_RULES"),
                                                 (2, "DEFAULT_RULES")),
    ("internvl2-26b", "train_4k", "multi"): ((8, "ACT_SP_RULES"),
                                             (4, "DEFAULT_RULES")),
    ("rwkv6-3b", "train_4k", "multi"): ((8, "DEFAULT_RULES"),
                                        (1, "DEFAULT_RULES")),
    ("whisper-medium", "train_4k", "multi"): ((4, "DEFAULT_RULES"),
                                              (1, "DEFAULT_RULES")),
}
CHANGED.update({
    (arch, shape, mesh): ((1, "SERVE_BIG_RULES"), (1, "SERVE_RULES"))
    for arch in ("deepseek-67b", "qwen3-moe-235b-a22b")
    for shape in ("prefill_32k", "decode_32k", "long_500k")
    for mesh in ("single", "multi")})


def jax_auto_plan():
    """The JAX package's ``auto_plan``, compiled from its source alone."""
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    src = path.read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "auto_plan")
    ns = {"__package__": "repro.launch", "__name__": "repro.launch.plan"}
    exec("from repro.sharding.partition import DEFAULT_RULES\n"
         + ast.get_source_segment(src, fn), ns)
    return ns["auto_plan"]


def rules_name(module, rules) -> str:
    return next(k for k, v in vars(module).items()
                if k.endswith("_RULES") and v == rules)


def plans(meshes):
    jplan = jax_auto_plan()
    for mesh, (shape, names) in meshes.items():
        fake = types.SimpleNamespace(axis_names=names,
                                     devices=np.empty(shape))
        for a in configs.ARCHS:
            for s in configs.SHAPES_BY_NAME:
                ja, jr = jplan(jconfigs.ARCHS[a], jconfigs.SHAPES_BY_NAME[s],
                               fake)
                pa, pr = dryrun.auto_plan(configs.ARCHS[a],
                                          configs.SHAPES_BY_NAME[s],
                                          MeshShape(names, shape))
                yield (a, s, mesh), (ja, rules_name(jpartition, jr)), \
                    (pa, rules_name(partition, pr))


def test_auto_plan_matches_jax_but_for_the_h100_budget():
    seen = {}
    for cell, jax_plan, port_plan in plans(dryrun.PRODUCTION):
        if jax_plan != port_plan:
            seen[cell] = (jax_plan, port_plan)
    assert seen == CHANGED
    assert len(list(plans(dryrun.PRODUCTION))) == 2 * len(configs.ARCHS) * 4


def test_auto_plan_serves_internvl2_on_two_model_ranks_replicated():
    """internvl2-26b's 52 GB of bf16 weights on a model axis of 2: 26 GB a
    card, over 8 GB of a 16 GB chip but under 40 GB of an H100."""
    cells = {c: (j, p) for c, j, p in plans({"4x2": ((4, 2),
                                                      ("data", "model"))})}
    jax_plan, port_plan = cells[("internvl2-26b", "decode_32k", "4x2")]
    assert jax_plan == (1, "SERVE_BIG_RULES")
    assert port_plan == (1, "SERVE_RULES")


SMOKE = configs.smoke_variant(configs.ARCHS["smollm-135m"])
#: smoke cells on the "single" mesh: 16 data ranks of 2 rows each
CELLS = {"train": ShapeConfig("smoke_train", "train", 64, 32),
         "decode": ShapeConfig("smoke_decode", "decode", 128, 32)}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun")
    old, dryrun.RUNS = dryrun.RUNS, root
    try:
        infos = {k: dryrun.lower_cell(SMOKE, s, "single")[1]
                 for k, s in CELLS.items()}
    finally:
        dryrun.RUNS = old
    return root, infos


@pytest.mark.parametrize("kind", list(CELLS))
def test_lower_cell_on_meta_writes_meta_json(kind, saved):
    root, infos = saved
    d = root / f"smollm-135m--{CELLS[kind].name}--single"
    meta = json.loads((d / "meta.json").read_text())
    counts = json.loads((d / "counts.json").read_text())
    assert meta["chips"] == 256 and meta["device"] == "meta"
    assert meta["mesh_shape"] == {"data": 16, "model": 16}
    assert meta["rules"] == (["DEFAULT_RULES"] if kind == "train"
                             else ["SERVE_RULES"])
    roof = meta["roofline"]
    for key in ("hlo_flops_per_chip", "hbm_bytes_per_chip",
                "hlo_bytes_upper_bound", "collective_bytes_per_chip",
                "collective_by_kind", "compute_s", "memory_s",
                "collective_s", "dominant", "model_flops_total",
                "model_bytes_total", "useful_flop_fraction",
                "step_time_bound_s", "roofline_fraction", "tokens"):
        assert key in roof, key
    assert roof["hlo_flops_per_chip"] > 0 and roof["step_time_bound_s"] > 0
    assert meta["arg_bytes_per_device"] > 0
    assert meta["peak_bytes_per_device"] >= meta["arg_bytes_per_device"]
    # every rank's data shard: B 32 over 16 data ranks
    assert counts["ops"] and counts["flops"]["cuda_cores"] > 0
    if kind == "train":
        # the grads' reduction over "data" crosses nodes of 8 cards
        assert any(c["spans_nodes"] and c["group_size"] == 16
                   for c in counts["collectives"])
        assert roof["collective_by_kind"]
    else:
        # the KV cache's 128 positions over 16 model ranks: 8 a rank
        assert meta["alias_bytes_per_device"] > 0


def test_reanalyze_gives_the_same_report(saved, capsys):
    root, infos = saved
    reanalyze.main([str(root)])
    for kind, s in CELLS.items():
        d = root / f"smollm-135m--{s.name}--single"
        meta = json.loads((d / "meta.json").read_text())
        assert meta["roofline"] == json.loads(json.dumps(
            infos[kind]["roofline"], default=float))
    assert "smoke_decode--single" in capsys.readouterr().out


def test_main_on_a_full_size_cell(tmp_path, monkeypatch, capsys):
    """The command line on granite-8b's decode_32k on the "single" mesh:
    every weight and the 32768-position cache of 128 rows at full size,
    on meta."""
    monkeypatch.setattr(dryrun, "RUNS", tmp_path)
    dryrun.main(["--arch", "granite-8b", "--shape", "decode_32k",
                 "--mesh", "single"])
    out = capsys.readouterr().out
    assert "1 cells ok, 0 failed" in out
    meta = json.loads((tmp_path / "granite-8b--decode_32k--single"
                       / "meta.json").read_text())
    assert meta["params"] == 8_172_695_552 or meta["params"] > 7e9
    assert meta["roofline"]["dominant"] in ("memory", "collective",
                                            "compute")


def test_prefill_embeds_each_devices_batch_shard_alone(monkeypatch):
    """smollm-135m's ``prefill_32k`` on the "single" mesh (16 x 16) on
    meta: the token lookup's output on a device is its batch shard (B 32
    over 16 data ranks: 2 rows), and no storage shaped like the global
    batch's embedding (32, 32768, 576) is live at the counter's peak
    (``tests/dryrun_memory.py``'s ``port_peak``)."""
    import dryrun_memory

    from repro_torch.models import lm
    seen, lookup = [], lm.embed_lookup

    def recording(tokens, embed, dtype):
        x = lookup(tokens, embed, dtype)
        seen.append((tuple(x.shape), tuple(x.to_local().shape)))
        return x
    monkeypatch.setattr(lm, "embed_lookup", recording)
    ok, info, live = dryrun_memory.port_peak("smollm-135m", "prefill_32k",
                                             "single", top=None)
    cell = configs.SHAPES_BY_NAME["prefill_32k"]
    whole = (cell.global_batch, cell.seq_len,
             configs.ARCHS["smollm-135m"].d_model)
    assert ok and info["rules"] == ["SERVE_RULES"]
    assert seen == [(whole, (whole[0] // 16,) + whole[1:])]
    assert live and not [k for _, _, k in live if k[1] == whole]
