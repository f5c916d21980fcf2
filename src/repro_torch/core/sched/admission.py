"""Admission control: budget check, make-room sequencing, and the
serving-plane backpressure layer (paper §3.3, Fig 3a RM:alloc).

Admission is *non-destructive* (``admit`` only answers "does it fit right
now?"); making room is only performed for the definitively chosen node —
'outputs are evicted one by one until the available memory is larger than
the requirement of the node scheduled to run next'.  kswap/no-admission
configurations run the node anyway and let kernel swap / OOM handle the
overflow.

The serving extensions (all opt-in via ``RMConfig``) turn the controller
from a pure budget check into a backpressure valve:

  * **per-tenant budgets** (``tenant_budgets``) — reservations are also
    accounted per ``DAG.tenant``; a claim that would push a tenant past
    its ceiling is refused even when global memory is free, so one burst
    tenant cannot occupy the whole budget;
  * **bounded admission queue** (``max_queue_depth``) — ``offer`` sheds a
    DAG outright once the queue is full, with a typed
    ``"shed:overloaded"`` outcome instead of OOM-churning the eviction
    loop;
  * **overload-aware deadline shedding** — under combined queue +
    reservation pressure, a DAG whose latency ETA (node-latency EWMA x
    backlog / workers) already overshoots its deadline is shed as
    ``"shed:deadline"`` rather than admitted to miss;
  * **quarantine shedding** — DAGs carrying an op the RM has poisoned
    (see ``ProcessWorkerExecutor._request``) are shed as
    ``"shed:quarantined"``.

Shedding decision order (first match wins; see ARCHITECTURE.md for the
full table): quarantined op -> tenant budget impossible -> deadline
already expired -> queue full -> deadline hopeless under overload.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, FrozenSet, Optional, Tuple

from ..dag import DAG, NodeState


class AdmissionController:
    """Budget accounting against ``RMConfig.memory_limit``; ``rm`` is the
    owning ResourceManager (store + config + eviction engine).

    In-flight nodes hold a *reservation* of their ``est_mem`` from claim
    to completion, so concurrent workers cannot co-admit nodes whose
    combined estimates exceed the budget (a reservation is conservative:
    while a node runs, its real charges and its estimate both count).
    With one worker the reservation set is always empty at admission
    time, preserving the sequential semantics exactly.

    Reservation balance is an invariant, not an assumption: ``unreserve``
    raises ``RuntimeError`` when a release would drive the global or
    per-tenant balance negative (a bare assert would vanish under
    ``python -O`` and let the books corrupt silently).
    """

    #: EWMA smoothing for the node-latency estimate behind ``eta``
    LATENCY_ALPHA = 0.3

    def __init__(self, rm):
        self.rm = rm
        self.reserved = 0            # sum of in-flight nodes' est_mem
        self.tenant_reserved: Dict[str, int] = {}
        # serving-plane state: queued DAG ids -> node count, plus the
        # node-latency EWMA feeding the shedding ETA.  Guarded by its own
        # lock — offer/finished are called from submitter threads while
        # reserve/unreserve run under the executor's RM lock.
        self._stats_lock = threading.Lock()
        self.queued: Dict[int, int] = {}
        self._latency_ewma = 0.0

    # -- reservations ------------------------------------------------------
    def reserve(self, node: NodeState) -> None:
        self.reserved += node.spec.est_mem
        t = node.dag.tenant
        self.tenant_reserved[t] = \
            self.tenant_reserved.get(t, 0) + node.spec.est_mem

    def unreserve(self, node: NodeState) -> None:
        self.reserved -= node.spec.est_mem
        if self.reserved < 0:
            raise RuntimeError("unbalanced admission reservation "
                               f"(global {self.reserved} after releasing "
                               f"{node.dag.name}.{node.name})")
        t = node.dag.tenant
        left = self.tenant_reserved.get(t, 0) - node.spec.est_mem
        if left < 0:
            raise RuntimeError("unbalanced admission reservation "
                               f"(tenant {t!r} {left} after releasing "
                               f"{node.dag.name}.{node.name})")
        if left:
            self.tenant_reserved[t] = left
        else:
            self.tenant_reserved.pop(t, None)

    def available(self) -> int:
        cfg = self.rm.cfg
        if cfg.memory_limit is None:
            return 1 << 62
        return cfg.memory_limit - self.rm.store.global_charged \
            - self.reserved

    # -- per-tenant budgets ------------------------------------------------
    def tenant_budget(self, tenant: str) -> Optional[int]:
        budgets = self.rm.cfg.tenant_budgets
        return None if budgets is None else budgets.get(tenant)

    def tenant_fits(self, node: NodeState) -> bool:
        """Would claiming ``node`` keep its tenant within budget?"""
        budget = self.tenant_budget(node.dag.tenant)
        if budget is None:
            return True
        used = self.tenant_reserved.get(node.dag.tenant, 0)
        return used + node.spec.est_mem <= budget

    def admit(self, node: NodeState) -> bool:
        """Non-destructive admission check: does the node fit right now?"""
        if not self.rm.cfg.admission:
            return True
        if not self.tenant_fits(node):
            return False
        return node.spec.est_mem <= self.available()

    def make_room_for(self, node: NodeState,
                      extra_protect: FrozenSet[Tuple[int, str]] = frozenset(),
                      ) -> None:
        """Evict outputs one by one until the chosen node fits (§3.3).
        ``extra_protect`` shields the dependencies of in-flight nodes when
        the worker pool runs concurrently."""
        cfg = self.rm.cfg
        if cfg.policy in ("none", "kswap") or not cfg.admission:
            return
        need = node.spec.est_mem - self.available()
        if need > 0:
            self.rm.eviction.free_memory(need, protect=node,
                                         extra_protect=extra_protect)

    # -- serving-plane backpressure ----------------------------------------
    def count(self, key: str, n: int = 1) -> None:
        """Bump one ``rm.serve_stats`` counter (thread-safe)."""
        with self._stats_lock:
            self.rm.serve_stats[key] = self.rm.serve_stats.get(key, 0) + n

    def note_latency(self, dt: float) -> None:
        """Fold one completed node's exec latency into the ETA EWMA."""
        if dt <= 0:
            return
        with self._stats_lock:
            a = self.LATENCY_ALPHA
            self._latency_ewma = dt if self._latency_ewma == 0 \
                else a * dt + (1 - a) * self._latency_ewma

    def pressure(self) -> float:
        """Reservation pressure: fraction of the memory budget already
        charged or reserved (0.0 with no limit configured)."""
        limit = self.rm.cfg.memory_limit
        if not limit:
            return 0.0
        return (self.rm.store.global_charged + self.reserved) / limit

    def overloaded(self) -> bool:
        """Queue depth x reservation pressure against the threshold —
        deep queue alone (work drains fine) or high memory alone (few
        big DAGs) is not overload; both together is."""
        depth = self.rm.cfg.max_queue_depth
        if depth is None:
            return False
        with self._stats_lock:
            fill = len(self.queued) / depth
        return fill * self.pressure() >= self.rm.cfg.overload_threshold

    def eta(self, dag: DAG, now: float) -> float:
        """Crude completion-time estimate for an offered DAG: backlog
        plus its own nodes, each costing the node-latency EWMA, divided
        across the worker pool.  Deliberately optimistic — shedding on an
        optimistic ETA only sheds the truly hopeless."""
        with self._stats_lock:
            backlog = sum(self.queued.values())
            ewma = self._latency_ewma
        workers = max(self.rm.cfg.workers, 1)
        return now + ewma * (backlog + len(dag.nodes)) / workers

    def offer(self, dag: DAG, now: Optional[float] = None) -> Optional[str]:
        """Serving-plane admission: accept ``dag`` into the bounded queue
        or shed it.  Returns None when admitted, else the shed reason
        (also recorded as ``dag.outcome = "shed:<reason>"``)."""
        cfg = self.rm.cfg
        if now is None:
            now = time.monotonic()
        self.count("offered")
        reason = None
        if self.rm.quarantined:
            for st in dag.nodes.values():
                if self.rm.poison_key(st.spec.fn) in self.rm.quarantined:
                    reason = "quarantined"
                    break
        if reason is None and cfg.tenant_budgets is not None:
            budget = self.tenant_budget(dag.tenant)
            if budget is not None and any(
                    st.spec.est_mem > budget for st in dag.nodes.values()):
                reason = "tenant_budget"   # can never fit, not even alone
        if reason is None and cfg.enforce_deadlines and \
                dag.deadline is not None and now >= dag.deadline:
            reason = "deadline"            # dead on arrival
        if reason is None and cfg.max_queue_depth is not None:
            with self._stats_lock:
                full = len(self.queued) >= cfg.max_queue_depth
            if full:
                reason = "overloaded"
        if reason is None and cfg.enforce_deadlines and \
                dag.deadline is not None and self.overloaded() and \
                self.eta(dag, now) > dag.deadline:
            reason = "deadline"            # hopeless under overload
        if reason is not None:
            dag.outcome = f"shed:{reason}"
            dag.cancelled = True
            self.count("shed")
            self.count(f"shed_{reason}")
            return reason
        with self._stats_lock:
            self.queued[dag.id] = len(dag.nodes)
        self.count("admitted")
        return None

    def finished(self, dag: DAG) -> None:
        """Retire a previously offered DAG from the queue accounting and
        settle its outcome counter."""
        with self._stats_lock:
            was_queued = self.queued.pop(dag.id, None) is not None
        if not was_queued:
            return
        if dag.outcome is None or dag.outcome == "completed":
            self.count("completed")
        elif dag.outcome == "deadline_miss":
            pass    # counted at cancellation time (deadline_misses)
        elif dag.outcome == "poisoned":
            pass    # counted at quarantine time (poisoned)
        elif dag.outcome.startswith("failed"):
            self.count("failed")
