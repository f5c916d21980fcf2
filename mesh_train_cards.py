#!/usr/bin/env python3
"""``chip_smoke.py`` phase 28's sharded training on every card of a machine.

    python3 mesh_train_cards.py

Spawns one NCCL rank a card through ``chip_smoke.phase_sharded`` (its
``_shard_rank`` and ``shard_runs``) and runs phase 28's cells there: on
4 cards the ("data", "model") mesh is (2, 2) and the ("pod", "data",
"model") mesh (2, 1, 2), so the batch is split over "data" (or "pod")
and the heads, the MLP and the vocab over "model":

- smollm-135m at full width, B 8 x S 1024 seeded tokens, 2 AdamW steps
  unsharded and on the mesh under DEFAULT_RULES and FSDP_RULES, and with
  the int8 pod all-reduce (each step's codes and scales held bit for bit
  to the CPU's plain run on the grads the step captured); then the
  DEFAULT run's checkpoint restored onto the mesh and onto the CPU;
- the five ``SHARD_FAMILIES`` at their cut depths, 2 steps each,
  unsharded and on the (2, 2) mesh under DEFAULT_RULES.  The MoE runs at
  capacity_factor = n_experts / top_k, where no pair drops: on the mesh
  each data shard dispatches a group with its own capacity (ROADMAP
  queue 3 item r).

Phase 28 itself computes in bf16 at world size 1, where each shard is
the whole tensor and the runs agree bit for bit.  Across cards a sharded
step sums in another order than the unsharded one, and at full width
float32 rounding alone moves a leaf by more than ``SHARD_TOL`` (1e-6
relative L2), most on the zero-initialised norm weights, whose first
updates are Adam's ratios of near-cancelling grads (ROADMAP queue 3 item
aa; on 4 H100s smollm-135m's ``blocks/b0/ln1`` stood 3.5e-6 and 4.5e-6
from unsharded in float32, PERF.md).  So, as the gloo tests hold these
runs: smollm-135m's cells run in float64 (weights, inputs and every
``.float()``) and are held to the unsharded float64 step within
``SHARD_TOL`` per leaf, loss and grad norm; each family runs in float32
and is held to float64 steps of the same weights and data on rank 0's
host within ``FLOOR_FACTOR`` times the unsharded float32 run's own
distance from them, per leaf and per metric.  For the MoE the token-layers
routed differently on the mesh than unsharded are counted (more than 1 %
fails) and moe_dropped is held equal.  Each cell's median step (the steps
after the first) and peak memory are printed beside the cards' name and
power limit.  Unlike ``chip_smoke.py`` it reports every failed check
before it exits non-zero, so one run shows all the cells.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

DEADLINE_S = 1500.0


def family_cfg(name: str, n_layers):
    """A phase 28 family at its cut depth, computing in float32; the MoE
    at a capacity where no pair drops."""
    cfg = dataclasses.replace(cs.big_cfg(name, n_layers), dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def seeded_batches(cfg) -> list:
    rng = np.random.default_rng(28)
    return [{k: rng.integers(1, cfg.vocab, (cs.TRAIN_B, cs.TRAIN_S))
             .astype(np.int32) for k in ("tokens", "labels")}
            for _ in range(cs.SHARD_STEPS)]


def report(out: dict) -> None:
    """Each cell's median step time and peak memory."""
    device = cs.smi_line() if cs.CUDA.type == "cuda" else "cpu"
    print(f"cells on world size {out['world']}, meshes (data, model) "
          f"{out['mesh2']} and (pod, data, model) {out['mesh3']} [{device}]:")
    runs = [(f"smollm-135m {name}", r) for name, r in out["runs"].items()]
    runs += [(f"{name} {run}", f[run]) for name, f in out["families"].items()
             for run in ("unsharded", "mesh")]
    for label, r in runs:
        med = statistics.median(r["times"][1:])
        print(f"  {label}: median step {med * 1e3:.2f} ms (steps "
              f"{[round(t * 1e3, 2) for t in r['times']]} ms); max memory "
              f"allocated {r['peak_gib']:.3f} GiB"
              + (f" beside the {r['held_gib']:.3f} GiB of the unsharded "
                 "state kept" if r.get("held_gib") else ""))


def run(world: int) -> list:
    """Phase 28's cells on ``world`` ranks, one a card (gloo ranks on the
    CPU where ``chip_smoke.CUDA`` is the CPU); the failed checks."""
    cfg = dataclasses.replace(cs.get_arch("smollm-135m"), dtype="float64",
                              param_dtype="float64")
    failed = []

    def note(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)
            print(f"CHECK FAILED: {what}", flush=True)
    strict = cs.check
    cs.check = note
    out = None
    try:
        out = cs.phase_sharded(
            seeded_batches(cfg), cfg=cfg, serve_cells=[],
            family_cfg=family_cfg,
            model_parallel=2 if world % 4 == 0 else 0, floor=True,
            world=world, deadline_s=DEADLINE_S)
    except Exception:
        note(False, f"phase 28 on {world} cards:\n{traceback.format_exc()}")
    finally:
        cs.check = strict
    if out is not None:
        report(out)
    return failed


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: no CUDA card", flush=True)
        return 1
    cs.phase_device()
    failed = run(torch.cuda.device_count())
    print(f"failed checks: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
