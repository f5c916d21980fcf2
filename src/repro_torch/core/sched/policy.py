"""Scheduling priority policies (paper §3.1: 'closest-to-finishing first').

A :class:`SchedulePolicy` turns a runnable node into a sort key; the
executor runs candidates in ascending key order, tie-broken by DAG id
(older DAG first), then by node insertion order (the sort is stable).

Built-in policies:

  depth     — deepest node first: drives one DAG to completion before the
              next starts, minimizing the live intermediate set (the
              paper's default).
  breadth   — shallowest first: models concurrently-started DAGs.
  fair      — least-progressed tenant first (multi-tenant fair share):
              no tenant's DAGs run ahead while another's starve.  The
              per-tenant memory ceilings (``RMConfig.tenant_budgets``,
              enforced by the admission layer) are the other half of the
              isolation story: fair ordering shares the workers, budgets
              share the memory.
  deadline  — earliest-deadline-first over ``DAG.deadline``, depth-first
              within a DAG; deadline-less DAGs run last.

Ordering vs enforcement: a policy only *orders* candidates.  With
``RMConfig.enforce_deadlines`` on, ``DAG.deadline`` is additionally
interpreted against ``time.monotonic()`` — the executor cancels DAGs
past it and the admission layer sheds offers that are already hopeless
(see ``core/sched/admission.py``); with it off (default), deadlines
remain a pure ordering hint with no clock semantics, the seed behaviour.

Register a custom policy with :func:`register_schedule`; select it by name
via ``RMConfig(schedule=...)``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple, Type

from ..dag import COMPLETE, DAG, NodeState

SCHEDULES: Dict[str, Type["SchedulePolicy"]] = {}


def register_schedule(cls: Type["SchedulePolicy"]) -> Type["SchedulePolicy"]:
    SCHEDULES[cls.name] = cls
    return cls


def get_schedule(name: str) -> "SchedulePolicy":
    try:
        return SCHEDULES[name]()
    except KeyError:
        raise KeyError(f"unknown schedule policy {name!r}; "
                       f"choose from {sorted(SCHEDULES)}") from None


class SchedulePolicy:
    """Priority protocol: ``prepare`` once per scheduling round, then
    ``key`` per candidate.  Lower key = higher priority."""

    name = ""

    def prepare(self, dags: Iterable[DAG]) -> None:
        """Hook to precompute per-round state (e.g. per-DAG progress)."""

    def key(self, st: NodeState) -> Tuple:
        raise NotImplementedError


@register_schedule
class DepthFirst(SchedulePolicy):
    name = "depth"

    def key(self, st: NodeState) -> Tuple:
        return (-st.depth,)


@register_schedule
class BreadthFirst(SchedulePolicy):
    name = "breadth"

    def key(self, st: NodeState) -> Tuple:
        return (st.depth,)


@register_schedule
class FairShare(SchedulePolicy):
    """Least-progressed tenant first (progress = completed-node fraction
    across the tenant's active DAGs), then deepest node.  With one DAG per
    tenant this round-robins DAGs instead of finishing them serially."""

    name = "fair"

    def __init__(self) -> None:
        self._progress: Dict[str, float] = {}

    def prepare(self, dags: Iterable[DAG]) -> None:
        done: Dict[str, int] = {}
        total: Dict[str, int] = {}
        for d in dags:
            t = d.tenant
            done[t] = done.get(t, 0) + sum(
                1 for n in d.nodes.values() if n.status in COMPLETE)
            total[t] = total.get(t, 0) + len(d.nodes)
        self._progress = {t: done[t] / max(total[t], 1) for t in total}

    def key(self, st: NodeState) -> Tuple:
        return (self._progress.get(st.dag.tenant, 0.0), -st.depth)


@register_schedule
class DeadlineAware(SchedulePolicy):
    """Earliest-deadline-first over ``DAG.deadline``, depth-first within
    a DAG.  For ordering, any monotone clock works; only when
    ``RMConfig.enforce_deadlines`` is set must deadlines be
    ``time.monotonic()`` instants, since the executor then compares them
    against that clock to cancel overdue DAGs."""

    name = "deadline"

    def key(self, st: NodeState) -> Tuple:
        dl = st.dag.deadline
        return (dl if dl is not None else math.inf, -st.depth)
