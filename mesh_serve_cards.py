#!/usr/bin/env python3
"""``chip_smoke.py`` phase 29's mesh serving on every card of a machine.

    python3 mesh_serve_cards.py

Spawns one NCCL rank a card and, on each ("data", "model") mesh the
world makes (on 4 cards (2, 2) and (1, 4); else (1, world)), runs
``chip_smoke.mesh_serve_runs`` on ``chip_smoke.serve_mesh_cells()`` in
every rank: each cell served unsharded on the rank's own card and on the
mesh under its rule sets, every step's logits against the unsharded
run's (the vlm and enc-dec cells too: internvl2-26b at one layer with
256 patches, whisper-medium at 2 + 2 layers with 1500 frames, its cross
cache 750 or 375 frames a rank).  The float32 int8 KV cell is held by
its own pair of checks instead of the 1e-5 gate: its prefill's k and v
differ from unsharded by float32 rounding, so a few codes round the
other way and stay in the cache; every code must lie within one quantum
of the unsharded cache's (the differing codes counted), and the mesh
cache, gathered and decoded unsharded, must give the mesh run's logits
within 1e-5.  Rank 0 prints each mesh's cells with ``phase_serve_sharded``'s
report (the per-rank kernel slices and the split-K, one card's work, are
left to ``chip_smoke.py``); every rank must see the same differences.
Unlike ``chip_smoke.py`` it reports every failed check before it exits
non-zero, so one run shows all the cells.  Each number beside the cards'
name and power limit.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import sys
import time
import traceback

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

DEADLINE_S = 900.0


def meshes(world: int):
    return [(2, 2), (1, 4)] if world == 4 else [(1, world)]


def _rank(rank, world, port, q):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        from repro_torch.launch.mesh import init_distributed, make_mesh
        init_distributed("cuda", timeout_s=120.0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", torch.cuda.current_device())
        out = {}
        for shape in meshes(world):
            mesh = make_mesh(shape, ("data", "model"), "cuda")
            t0 = time.perf_counter()
            cells = cs.mesh_serve_runs(cs.serve_mesh_cells(), dev, mesh,
                                       cs.sync)
            out[shape] = (cells, time.perf_counter() - t0)
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        q.close()
        q.join_thread()
        os._exit(1)
    torch.distributed.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: no CUDA card", flush=True)
        return 1
    cs.phase_device()
    cs.phase_build()
    world = torch.cuda.device_count()
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = cs._free_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, q))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    results, failure = {}, None
    try:
        while len(results) < world and failure is None:
            if time.perf_counter() - t0 > DEADLINE_S:
                failure = f"the ranks outlived the {DEADLINE_S} s deadline"
                break
            try:
                rank, ok, val = q.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    failure = "a rank died without a result"
                continue
            if ok:
                results[rank] = val
            else:
                failure = f"rank {rank} failed:\n{val}"
    finally:
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
    cs.check(failure is None, f"ranks: {failure}")
    print(f"world size {world}; {time.perf_counter() - t0:.1f} s with the "
          f"ranks' start")
    failed = []

    def note(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)
            print(f"CHECK FAILED: {what}", flush=True)
    strict = cs.check
    cs.check = note
    cs.phase_rank_slices = cs.phase_split_k = dict    # one card's work
    try:
        for shape in meshes(world):
            cells, secs = results[0][shape]
            print(f"mesh {shape}: {secs:.1f} s in the ranks")
            for r in range(1, world):
                for a, b in zip(cells, results[r][shape][0]):
                    for rules in a["mesh"]:
                        note(a["mesh"][rules]["errs"]
                             == b["mesh"][rules]["errs"],
                             f"rank {r}, {a['label']} {rules}: other "
                             "differences than rank 0's")
            cs.phase_serve_sharded(cells)
    finally:
        cs.check = strict
    print(f"failed checks: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
