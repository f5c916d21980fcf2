"""Lower logical plans to fingerprinted DAG nodes.

The compiler emits plain ``dag.NodeSpec``s whose ``fn``s are
``functools.partial``s over the module-level executors below — exactly
the shape every other layer already understands, so a compiled plan
flows unchanged through:

* the thread/process executors (partials pickle across the Flight
  boundary; no new wire ops);
* chain shipping (linear filter/select/sort segments fuse into
  ``exec_chain`` like any hand-built DAG);
* differential caching (the partial's keywords canonicalize via the
  expression trees' stable reprs, so the same plan built next run
  fingerprints identically, and the executor fns declare
  ``__fp_includes__`` for the kernels *and the optimizer rules* they
  embody — editing a rewrite rule invalidates the outputs it shaped).

Sharing: with ``optimize=True`` the lowering memoizes on ``LNode.key()``
— structurally identical subtrees across sinks become ONE node cone
(one loader, one DeCache entry, one manifest row).  With
``optimize=False`` (the naive baseline) every occurrence lowers to its
own nodes, which is what a hand-wired per-mart pipeline would build.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional, Sequence, Union

from .. import ops
from ..dag import DAG, NodeSpec
from .builder import (Filter, FilterJoin, GroupBy, Join, Limit, LNode,
                      Plan, Project, Scan, Sort)
from .expr import EVAL_FP, eval_predicate
from .rules import (Trace, fuse_filter_join, optimize_plans,
                    prune_projections, pushdown_filters, subplan_counts)

__all__ = ["CompiledPlan", "compile_plans", "explain_plans",
           "filter_exec", "project_exec", "sort_exec", "limit_exec",
           "filter_join_exec"]

_MIN_EST = 1 << 20


# --------------------------------------------------------------------------
# node executors (module-level: picklable + fingerprintable as partials)
# --------------------------------------------------------------------------

def filter_exec(tables, predicate):
    return ops.filter_rows(
        tables[0], functools.partial(eval_predicate, expr=predicate))


def project_exec(tables, columns):
    return ops.select_columns(tables[0], list(columns))


def sort_exec(tables, by, descending=False):
    return ops.sort_by(tables[0], by, descending)


def limit_exec(tables, n):
    return ops.slice_rows(tables[0], 0, n)


def filter_join_exec(tables, on, how="inner", suffix="_right",
                     left_pred=None, right_pred=None):
    lm = None if left_pred is None else \
        functools.partial(eval_predicate, expr=left_pred)
    rm = None if right_pred is None else \
        functools.partial(eval_predicate, expr=right_pred)
    return ops.filter_join(tables[0], tables[1], on=on, how=how,
                           suffix=suffix, left_mask=lm, right_mask=rm)


#: fingerprint pinning (same contract as ops.join pinning the relational
#: vkernels): each executor folds in (a) the op + predicate-evaluation
#: code it runs and (b) the REWRITE RULES that may have shaped the node —
#: editing pushdown/fusion/pruning invalidates the cached outputs those
#: rules produced, even when the lowered structure happens to coincide
filter_exec.__fp_includes__ = \
    (ops.filter_rows, pushdown_filters) + EVAL_FP
project_exec.__fp_includes__ = (ops.select_columns, prune_projections)
sort_exec.__fp_includes__ = (ops.sort_by,)
limit_exec.__fp_includes__ = (ops.slice_rows,)
filter_join_exec.__fp_includes__ = \
    (ops.filter_join, fuse_filter_join, pushdown_filters) + EVAL_FP


# --------------------------------------------------------------------------
# lowering
# --------------------------------------------------------------------------

def _normalize(plans) -> Dict[str, LNode]:
    if isinstance(plans, (Plan, LNode)):
        plans = {"plan": plans}
    elif isinstance(plans, (list, tuple)):
        plans = {f"sink{i}": p for i, p in enumerate(plans)}
    return {sink: (p.root if isinstance(p, Plan) else p)
            for sink, p in plans.items()}


class CompiledPlan:
    """A lowered plan: one DAG plus the sink-name -> node-name map."""

    def __init__(self, dag: DAG, sinks: Dict[str, str], trace: Trace,
                 roots: Dict[str, LNode]):
        self.dag = dag
        self.sinks = sinks
        self.trace = trace
        self.roots = roots          # post-optimization logical roots

    def read(self, store, sink: Optional[str] = None):
        """Materialize a sink's output table (after ``executor.run``)."""
        from ..sipc import SipcReader
        if sink is None:
            assert len(self.sinks) == 1, \
                f"multiple sinks {sorted(self.sinks)}: name one"
            sink = next(iter(self.sinks))
        node = self.dag.nodes[self.sinks[sink]]
        assert node.output is not None, f"sink {sink!r} has no output " \
            f"(run the DAG first, and keep_output must hold it)"
        return SipcReader(store).read_table(node.output)

    def __repr__(self):
        return (f"CompiledPlan<{self.dag.name}: {len(self.dag.nodes)} "
                f"nodes, sinks={sorted(self.sinks)}>")


def _scan_est(node: Scan) -> int:
    try:
        size = os.path.getsize(node.path)
    except OSError:
        return _MIN_EST
    sel = node.schema()                 # also caches the footer names
    full_n = len(node._footer_names)
    frac = len(sel) / full_n if full_n else 1.0
    return max(int(size * 8 * frac), _MIN_EST)


def compile_plans(plans, *, optimize: bool = True, name: str = "query",
                  deadline: Optional[float] = None,
                  tenant: Optional[str] = None) -> CompiledPlan:
    """Compile one or more sink plans into a single DAG.

    ``plans``: a ``Plan``, a list of plans, or ``{sink_name: Plan}``.
    ``optimize=False`` lowers the trees verbatim, one node per
    occurrence — the naive baseline benchmarked in bench_query.
    ``deadline``/``tenant`` plumb through to the DAG for the
    deadline-aware and fair-share scheduling policies."""
    roots = _normalize(plans)
    trace = Trace()
    if optimize:
        roots, trace = optimize_plans(roots, trace)

    specs: List[NodeSpec] = []
    by_name: Dict[str, NodeSpec] = {}
    used = set()
    memo: Dict[str, str] = {}

    def fresh(base: str) -> str:
        nm, i = base, 1
        while nm in used:
            nm = f"{base}~{i}"
            i += 1
        used.add(nm)
        return nm

    def lower(node: LNode, prefer: Optional[str] = None) -> str:
        if optimize and prefer is None and node.key() in memo:
            return memo[node.key()]
        deps = [lower(c) for c in node.children]
        if isinstance(node, Scan):
            stem = os.path.splitext(os.path.basename(node.path))[0]
            spec = NodeSpec(
                fresh(prefer or f"scan_{stem}"), source=node.path,
                dict_columns=tuple(node.dict_columns),
                columns=node.columns, est_mem=_scan_est(node))
        else:
            dep_est = [by_name[d].est_mem for d in deps]
            if isinstance(node, Filter):
                fn = functools.partial(filter_exec,
                                       predicate=node.predicate)
                est = dep_est[0]
            elif isinstance(node, Project):
                fn = functools.partial(project_exec,
                                       columns=tuple(node.columns))
                est = dep_est[0]
            elif isinstance(node, Sort):
                fn = functools.partial(sort_exec, by=node.by,
                                       descending=node.descending)
                est = dep_est[0]
            elif isinstance(node, Limit):
                fn = functools.partial(limit_exec, n=node.n)
                est = max(dep_est[0] // 2, _MIN_EST)
            elif isinstance(node, Join):
                fn = functools.partial(ops.join_node, on=list(node.on),
                                       how=node.how, suffix=node.suffix)
                est = sum(dep_est)
            elif isinstance(node, FilterJoin):
                fn = functools.partial(
                    filter_join_exec, on=list(node.on), how=node.how,
                    suffix=node.suffix, left_pred=node.left_pred,
                    right_pred=node.right_pred)
                est = sum(dep_est)
            elif isinstance(node, GroupBy):
                fn = functools.partial(ops.group_by_node,
                                       keys=list(node.keys),
                                       aggs=dict(node.aggs))
                est = max(dep_est[0] // 2, _MIN_EST)
            else:
                raise TypeError(f"unknown node kind: {node.kind}")
            spec = NodeSpec(fresh(prefer or node.kind), fn=fn, deps=deps,
                            est_mem=max(est, _MIN_EST))
        specs.append(spec)
        by_name[spec.name] = spec
        if optimize:
            memo[node.key()] = spec.name
        return spec.name

    sinks: Dict[str, str] = {}
    for sink, root in roots.items():
        if optimize and root.key() in memo:
            sinks[sink] = memo[root.key()]       # two identical sinks
        else:
            sinks[sink] = lower(root, prefer=sink)
    for nm in set(sinks.values()):
        by_name[nm].keep_output = True

    dag = DAG(specs, name=name, deadline=deadline, tenant=tenant)
    return CompiledPlan(dag, sinks, trace, roots)


# --------------------------------------------------------------------------
# explain
# --------------------------------------------------------------------------

def _render(node: LNode, depth: int, lines: List[str],
            counts: Dict[str, int]) -> None:
    mark = " [shared]" if counts.get(node.key(), 0) > 1 else ""
    lines.append("  " * depth + node.describe() + mark)
    for c in node.children:
        _render(c, depth + 1, lines, counts)


def explain_plans(plans, optimize: bool = True) -> str:
    """Pre/post-optimization tree dump with per-pass annotations.
    Structurally shared subtrees in the optimized forest are marked
    ``[shared]`` (they compile to one node cone)."""
    roots = _normalize(plans)
    lines = ["== logical plan" +
             (" (pre-optimization)" if optimize else "") + " =="]
    for sink, root in roots.items():
        lines.append(f"{sink}:")
        _render(root, 1, lines, {})
    if optimize:
        opt, trace = optimize_plans(roots)
        lines += ["", "== optimizer passes =="]
        lines += trace.lines() or ["(no rewrites)"]
        lines += ["", "== optimized plan =="]
        counts = subplan_counts(opt)
        for sink, root in opt.items():
            lines.append(f"{sink}:")
            _render(root, 1, lines, counts)
    return "\n".join(lines)
