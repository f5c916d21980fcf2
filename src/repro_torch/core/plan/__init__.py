"""Declarative query frontend + zero-copy-aware logical optimizer.

Users of the op surface (select/filter/sort/dict-encode/join/group_by/
filter_join) no longer hand-wire DAG nodes: a dataframe-style builder
(:mod:`builder`) constructs a logical plan, a rule-based optimizer
(:mod:`rules`) rewrites it, and the compiler (:mod:`compiler`) lowers it
to the existing fingerprinted ``dag.py`` nodes — so plans flow unchanged
through the thread/process executors, chain shipping, and the
differential cache (the Bauplan framing: pipelines are declaratively
specified function DAGs the platform is free to re-plan).

    from repro_torch.core.plan import scan, col, compile_plans

    orders = scan("orders.zq")
    cust   = scan("customers.zq", dict_columns=("country",))
    mart   = (orders.filter(col("amount") > 0)
                    .join(cust, on="cust")
                    .group_by("country", {"rev": ("amount", "sum")}))
    cp = compile_plans({"mart": mart})       # one optimized DAG
    executor.run([cp.dag]); table = cp.read(store, "mart")

Optimizer passes (all unusually profitable under zero-copy):
  * projection pruning — loaders narrow to the referenced column subset
    (``NodeSpec.columns`` -> ``zarquet.read_table(columns=)``): unused
    columns are never read, decompressed, charged, or deanonymized;
  * filter pushdown — filters sink below joins/projects/sorts, shrinking
    every downstream gather;
  * filter->join fusion — a filter directly under a join rewrites to the
    fused ``ops.filter_join`` gather (one gather, no materialized
    filtered intermediate);
  * common-subplan dedup — structurally identical subtrees across sink
    plans compile to ONE DAG node cone; node fingerprints then make the
    shared cone DeCache/manifest-shared across runs too.

``explain_plans``/``Plan.explain`` dump the pre/post-optimization trees
with per-pass annotations.
"""

from .expr import Col, Expr, Lit, col, eval_predicate, lit
from .builder import (Filter, FilterJoin, GroupBy, Join, Limit, LNode,
                      Plan, Project, Scan, Sort, scan)
from .rules import Trace, optimize_plans
from .compiler import CompiledPlan, compile_plans, explain_plans

__all__ = [
    "Col", "Expr", "Lit", "col", "eval_predicate", "lit",
    "Filter", "FilterJoin", "GroupBy", "Join", "Limit", "LNode", "Plan",
    "Project", "Scan", "Sort", "scan",
    "Trace", "optimize_plans",
    "CompiledPlan", "compile_plans", "explain_plans",
]
