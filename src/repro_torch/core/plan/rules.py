"""Rule-based logical optimizer: rewrites that are cheap to prove and
unusually profitable under zero-copy execution.

Pass order matters and is fixed:

1. ``pushdown_filters`` (per sink, to fixpoint) — filters sink through
   projects/sorts and below joins.  Conjuncts of a top-level ``&`` route
   independently: a conjunct reading only left-side columns pushes left
   under *inner and left* joins (left values are copied verbatim to the
   output, one-or-more output rows per surviving left row); a conjunct
   reading only right-side columns pushes right under *inner* joins
   only — under a left join it would resurrect unmatched rows as
   null-padded output that the original plan filtered out.  A conjunct
   naming a suffixed collision column (``x_right``) or columns from both
   sides stays above the join.
2. ``fuse_filter_join`` (per sink) — a ``Filter`` directly under either
   join input lifts into the fused ``FilterJoin`` node
   (``ops.filter_join``: masks compose into the join gather, the
   filtered intermediate is never materialized).  This is a literal
   rewrite — ``filter_join(l, r, left_mask=p)`` is *defined* as
   ``join(filter(l, p), r)`` for both join types — so it needs no
   side conditions.
3. ``prune_projections`` (global, across all sinks) — walks every sink
   top-down accumulating the demanded column set per *structural* scan
   key, then narrows each ``Scan`` to the union of demands.  Only scans
   are rewritten: narrowing interior nodes could change join collision
   naming, and per-sink narrowing would split structurally shared
   subtrees into per-sink variants (defeating pass 4).  The union keeps
   a scan shared by two marts identical in both — one loader node, one
   DeCache entry, one manifest row.  Collision naming is preserved
   explicitly: when a plan demands ``x_right``, the pruner keeps ``x``
   on *both* sides so the right column still collides and still gets
   the suffix.
4. ``dedup_subplans`` (global) — annotation pass: counts structurally
   identical subtrees (equal ``LNode.key()``) across sinks.  The
   compiler realizes the sharing by memoizing lowered nodes on the same
   key, so two marts over one staging subtree compile to a single
   shared node cone (and, via node fingerprints, to one cached cone
   across runs).

Every rewrite appends a human-readable note to the ``Trace``;
``explain()`` replays them between the pre- and post-optimization trees.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from .builder import (Filter, FilterJoin, GroupBy, Join, Limit, LNode,
                      Project, Scan, Sort)
from .expr import and_all, split_conjuncts

__all__ = ["Trace", "pushdown_filters", "fuse_filter_join",
           "prune_projections", "dedup_subplans", "optimize_plans"]

#: safety valve for the pushdown fixpoint loop (plans are tiny; a
#: correct pass converges in O(depth) iterations)
_MAX_PUSHDOWN_ROUNDS = 10


class Trace:
    """Ordered per-pass annotations accumulated during optimization."""

    def __init__(self):
        self.notes: List[Tuple[str, str]] = []

    def add(self, rule: str, note: str) -> None:
        self.notes.append((rule, note))

    def lines(self) -> List[str]:
        return [f"[{rule}] {note}" for rule, note in self.notes]

    def __repr__(self):
        return f"Trace({len(self.notes)} notes)"


# --------------------------------------------------------------------------
# pass 1: filter pushdown
# --------------------------------------------------------------------------

def pushdown_filters(root: LNode, trace: Trace, sink: str = "plan") -> LNode:
    """Sink filters toward the scans (see module docstring for the join
    side conditions).  Runs bottom-up passes to fixpoint."""
    for _ in range(_MAX_PUSHDOWN_ROUNDS):
        new = _push(root, trace, sink)
        if new.key() == root.key():
            return new
        root = new
    return root


def _push(node: LNode, trace: Trace, sink: str) -> LNode:
    node = node.with_children([_push(c, trace, sink)
                               for c in node.children])
    if not isinstance(node, Filter):
        return node
    child = node.children[0]
    pred = node.predicate

    if isinstance(child, Filter):
        # merge adjacent filters so conjunct routing sees all pieces
        return Filter(child.children[0],
                      and_all([child.predicate, pred]))

    if isinstance(child, (Project, Sort)):
        # predicate columns are a subset of the child's output, which
        # project/sort pass through unchanged -> commute
        trace.add("pushdown_filter",
                  f"{sink}: pushed {pred!r} below {child.kind}")
        return child.with_children(
            [Filter(child.children[0], pred)])

    if isinstance(child, Join):
        left, right = child.children
        lnames, rnames = left.schema(), right.schema()
        lset, rset = set(lnames), set(rnames)
        keys = set(child.on)
        to_left, to_right, keep = [], [], []
        for c in split_conjuncts(pred):
            cols = c.columns()
            if cols and cols <= lset:
                to_left.append(c)
            elif (child.how == "inner" and cols and cols <= rset
                  and not (cols & (lset - keys))):
                # non-key left/right name collisions resolve to the LEFT
                # column in the join output, so only push right when no
                # referenced column collides; key columns are equal on
                # matched rows (inner join ⇒ no null keys in output)
                to_right.append(c)
            else:
                keep.append(c)
        if not to_left and not to_right:
            return node
        if to_left:
            left = Filter(left, and_all(to_left))
            trace.add("pushdown_filter",
                      f"{sink}: pushed {and_all(to_left)!r} below join "
                      f"(left side)")
        if to_right:
            right = Filter(right, and_all(to_right))
            trace.add("pushdown_filter",
                      f"{sink}: pushed {and_all(to_right)!r} below join "
                      f"(right side)")
        out: LNode = child.with_children([left, right])
        if keep:
            out = Filter(out, and_all(keep))
        return out

    # Limit: NOT safe (filter-then-limit != limit-then-filter);
    # GroupBy/FilterJoin/Scan: stop
    return node


# --------------------------------------------------------------------------
# pass 2: filter -> join fusion
# --------------------------------------------------------------------------

def fuse_filter_join(root: LNode, trace: Trace, sink: str = "plan") -> LNode:
    """Rewrite ``Join`` whose input(s) are ``Filter``s into the fused
    ``FilterJoin`` node (lowered to ``ops.filter_join``)."""
    def rec(node: LNode) -> LNode:
        node = node.with_children([rec(c) for c in node.children])
        if not isinstance(node, Join):
            return node
        left, right = node.children
        lp = rp = None
        if isinstance(left, Filter):
            lp, left = left.predicate, left.children[0]
        if isinstance(right, Filter):
            rp, right = right.predicate, right.children[0]
        if lp is None and rp is None:
            return node
        sides = "+".join(s for s, p in
                         (("left", lp), ("right", rp)) if p is not None)
        trace.add("fuse_filter_join",
                  f"{sink}: fused {sides} filter(s) into filter_join "
                  f"on={node.on!r}")
        return FilterJoin(left, right, node.on, node.how, node.suffix,
                          lp, rp)
    return rec(root)


# --------------------------------------------------------------------------
# pass 3: projection pruning (global)
# --------------------------------------------------------------------------

def _child_demands(node: LNode, needed: set) -> List[set]:
    """Column sets each child must provide so that ``node`` can emit
    ``needed`` (needed ⊆ node.schema())."""
    if isinstance(node, Scan):
        return []
    if isinstance(node, Project):
        # the project is a demand anchor: its output IS the user's ask
        return [set(node.columns)]
    if isinstance(node, Filter):
        return [needed | node.predicate.columns()]
    if isinstance(node, Sort):
        return [needed | {node.by}]
    if isinstance(node, Limit):
        return [set(needed)]
    if isinstance(node, GroupBy):
        return [set(node.keys) |
                {src for src, _how in node.aggs.values()}]
    if isinstance(node, (Join, FilterJoin)):
        left, right = node.children
        lnames, rnames = left.schema(), right.schema()
        lset, rset = set(lnames), set(rnames)
        keys = set(node.on)
        ln, rn = set(keys), set(keys)
        sfx = node.suffix
        for n in needed:
            if n in lset:
                ln.add(n)
            if n in rset and n not in lset:
                rn.add(n)
            if n.endswith(sfx):
                base = n[:-len(sfx)]
                if base in lset and base in rset and base not in keys:
                    # keep the collision on BOTH sides so the right
                    # column still gets its suffix
                    ln.add(base)
                    rn.add(base)
        if isinstance(node, FilterJoin):
            if node.left_pred is not None:
                ln |= node.left_pred.columns()
            if node.right_pred is not None:
                rn |= node.right_pred.columns()
        return [ln & lset, rn & rset]
    raise TypeError(f"unknown node kind: {node.kind}")


def prune_projections(roots: Dict[str, LNode], trace: Trace
                      ) -> Dict[str, LNode]:
    """Narrow every ``Scan`` to the union of columns demanded across ALL
    sink plans (union keeps shared subtrees structurally identical)."""
    demand: Dict[str, set] = {}

    def walk(node: LNode, needed: set) -> None:
        if isinstance(node, Scan):
            demand.setdefault(node.key(), set()).update(needed)
            return
        for child, cn in zip(node.children, _child_demands(node, needed)):
            walk(child, cn)

    for root in roots.values():
        walk(root, set(root.schema()))

    rewritten: Dict[str, LNode] = {}

    def rewrite(node: LNode) -> LNode:
        k = node.key()
        if k in rewritten:
            return rewritten[k]
        if isinstance(node, Scan):
            footer = node.schema()
            want = demand.get(k, set(footer))
            cols = [n for n in footer if n in want] or footer[:1]
            if set(cols) == set(footer) and node.columns is None:
                out: LNode = node
            elif node.columns is not None and set(cols) == set(node.columns):
                out = node
            else:
                out = Scan(node.path, tuple(cols),
                           tuple(d for d in node.dict_columns
                                 if d in set(cols)))
                trace.add("prune_projection",
                          f"scan {os.path.basename(node.path)}: load "
                          f"{len(cols)}/{len(footer)} columns "
                          f"{tuple(cols)!r}")
        else:
            out = node.with_children([rewrite(c) for c in node.children])
        rewritten[k] = out
        return out

    return {sink: rewrite(root) for sink, root in roots.items()}


# --------------------------------------------------------------------------
# pass 4: common-subplan dedup (annotation; the compiler's key-memo
# realizes the sharing)
# --------------------------------------------------------------------------

def subplan_counts(roots: Dict[str, LNode]) -> Dict[str, int]:
    """Occurrences of each structural key across the sink forest (each
    distinct parent edge counts once)."""
    counts: Dict[str, int] = {}

    def walk(node: LNode) -> None:
        counts[node.key()] = counts.get(node.key(), 0) + 1
        for c in node.children:
            walk(c)

    for root in roots.values():
        walk(root)
    return counts


def dedup_subplans(roots: Dict[str, LNode], trace: Trace) -> None:
    counts = subplan_counts(roots)
    shared = {k: n for k, n in counts.items() if n > 1}
    if shared:
        saved = sum(n - 1 for n in shared.values())
        trace.add("dedup_subplan",
                  f"{len(shared)} shared subtree(s) across "
                  f"{len(roots)} sink(s): {saved} duplicate node "
                  f"cone(s) elided at compile")


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def optimize_plans(roots: Dict[str, LNode],
                   trace: Optional[Trace] = None
                   ) -> Tuple[Dict[str, LNode], Trace]:
    """Run all passes in order; returns (optimized roots, trace)."""
    if trace is None:
        trace = Trace()
    out = {}
    for sink, root in roots.items():
        root = pushdown_filters(root, trace, sink)
        root = fuse_filter_join(root, trace, sink)
        out[sink] = root
    out = prune_projections(out, trace)
    dedup_subplans(out, trace)
    return out, trace
