"""Fault tolerance for the multi-pod training loop.

Designed for 1000+ nodes; implemented against this container's simulated
failure hooks so the policies are testable:

  * heartbeats + failure detection  — every worker publishes a step-stamped
    heartbeat; a worker silent for ``grace`` steps is declared failed.
  * checkpoint/restart              — on failure the coordinator rolls the
    job back to the last durable CheckpointStore snapshot (DAG rollback
    applied to training-in-time: recompute beats babysitting a sick node).
  * straggler mitigation           — per-worker step-time EWMA; a worker
    slower than ``straggler_factor`` x the fleet median is marked for
    replacement *between* checkpoint intervals (no global desync).  The
    EWMA + median-factor rule itself lives in
    ``core.faultplane.StragglerDetector`` — the same detector the flight
    worker pool uses for serving-plane request health, so the training
    and serving planes share one definition of "straggler".
  * elastic re-mesh                — a new mesh (e.g. 512 -> 448 chips)
    restores the same checkpoint with new shardings (restore(..,
    shardings=...)): data-parallel size changes, model state is intact.
    In the port that restore waits for sharding (ROADMAP.md queue 1,
    item 8); the policy that asks for it is here.

The PyTorch port's copy of the JAX package's ``runtime/fault.py``, over
the port's ``core.faultplane`` and ``runtime.checkpoint``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..core.faultplane import StragglerDetector
from .checkpoint import CheckpointStore


@dataclass
class WorkerState:
    worker_id: int
    last_step: int = -1
    last_beat: float = 0.0
    step_ewma: float = 0.0    # mirror of the shared detector's EWMA
    failed: bool = False
    straggler: bool = False


@dataclass
class FaultConfig:
    grace_steps: int = 3
    straggler_factor: float = 1.7
    ewma: float = 0.3
    checkpoint_every: int = 50


class FleetMonitor:
    """Coordinator-side view of the fleet (one per job)."""

    def __init__(self, n_workers: int, cfg: FaultConfig = FaultConfig()):
        self.cfg = cfg
        self.workers = {i: WorkerState(i) for i in range(n_workers)}
        self.global_step = 0
        self.events: List[dict] = []
        self.health = StragglerDetector(alpha=cfg.ewma,
                                        factor=cfg.straggler_factor,
                                        min_peers=3)

    # -- heartbeats ----------------------------------------------------------
    def heartbeat(self, worker_id: int, step: int, step_time: float,
                  now: Optional[float] = None) -> None:
        w = self.workers[worker_id]
        w.last_step = step
        w.last_beat = now if now is not None else time.monotonic()
        w.step_ewma = self.health.update(worker_id, step_time)
        self.global_step = max(self.global_step, step)

    # -- failure detection -----------------------------------------------------
    def detect_failures(self) -> List[int]:
        out = []
        for w in self.workers.values():
            if w.failed:
                continue
            if self.global_step - w.last_step > self.cfg.grace_steps:
                w.failed = True
                self.events.append({"kind": "failure", "worker": w.worker_id,
                                    "step": self.global_step})
                out.append(w.worker_id)
        return out

    # -- stragglers --------------------------------------------------------------
    def detect_stragglers(self) -> List[int]:
        alive = {w.worker_id for w in self.workers.values()
                 if not w.failed}
        slow_ids, median = self.health.flag(alive)
        if median == 0.0:               # fewer than min_peers populated
            return []
        slow = set(slow_ids)
        out = []
        for wid in alive:
            w = self.workers[wid]
            if w.step_ewma <= 0:
                continue
            if wid in slow and not w.straggler:
                w.straggler = True
                self.events.append({"kind": "straggler", "worker": wid,
                                    "ewma": w.step_ewma, "median": median})
                out.append(wid)
            elif wid not in slow:
                w.straggler = False
        return out

    def healthy(self) -> int:
        return sum(1 for w in self.workers.values() if not w.failed)


class RestartPolicy:
    """Decides how the job resumes after failures."""

    def __init__(self, store: CheckpointStore, monitor: FleetMonitor,
                 *, min_workers: int):
        self.store = store
        self.monitor = monitor
        self.min_workers = min_workers

    def plan(self) -> dict:
        """Returns an action plan:
        - 'continue'          no failures
        - 'restart'           reload last checkpoint on replacement nodes
        - 'elastic_shrink'    not enough spares: shrink the data axis and
                              restore with new shardings
        """
        failed = self.monitor.detect_failures()
        healthy = self.monitor.healthy()
        step = self.store.latest_step()
        if healthy < self.min_workers:
            return {"action": "elastic_shrink", "from_step": step,
                    "new_size": healthy}
        if failed:
            return {"action": "restart", "from_step": step,
                    "replace": failed}
        return {"action": "continue",
                "stragglers": self.monitor.detect_stragglers()}
