"""Logical plan nodes + the dataframe-style ``Plan`` builder.

A logical plan is an immutable tree of ``LNode``s.  Each node knows:

* ``key()`` — a canonical structural string (kind + args + child keys).
  Two nodes with equal keys compute the same table from the same
  sources; the optimizer's common-subplan dedup and the compiler's
  node-sharing memo both hang off it.  It is built from stable reprs
  only (paths absolutized, exprs via their address-free repr), so it is
  deterministic across processes.
* ``schema()`` — output column names in order, derived without touching
  data (scans read only the zarquet footer).  The optimizer's
  projection pruning and join-side routing are schema-driven.
* ``describe()`` — one ``explain()`` line.

``Plan`` wraps a root ``LNode`` and exposes the builder surface
(``scan/select/filter/join/group_by/sort/limit``).  Plans are cheap
values: every builder call returns a new ``Plan`` sharing existing
nodes, so ``staging = scan(...).filter(...); a = staging.group_by(...);
b = staging.group_by(...)`` naturally shares the staging subtree — the
dedup pass turns that sharing (or any *structurally equal* rebuild of
it) into a single compiled node cone.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .. import zarquet
from .expr import Expr

__all__ = ["LNode", "Scan", "Project", "Filter", "Join", "FilterJoin",
           "GroupBy", "Sort", "Limit", "Plan", "scan"]


class LNode:
    kind = "?"
    children: Tuple["LNode", ...] = ()

    def args_key(self) -> str:
        """Canonical text of the node-local arguments."""
        raise NotImplementedError

    def key(self) -> str:
        k = getattr(self, "_key", None)
        if k is None:
            k = f"{self.kind}[{self.args_key()}]" + \
                "".join(f"({c.key()})" for c in self.children)
            self._key = k
        return k

    def schema(self) -> List[str]:
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError

    def with_children(self, children: Sequence["LNode"]) -> "LNode":
        raise NotImplementedError


class Scan(LNode):
    kind = "scan"

    def __init__(self, path: str, columns: Optional[Tuple[str, ...]] = None,
                 dict_columns: Tuple[str, ...] = ()):
        self.path = os.path.abspath(path)
        self.columns = None if columns is None else tuple(columns)
        self.dict_columns = tuple(dict_columns)

    def args_key(self):
        # canonicalize the column subset to footer order (via schema()):
        # a scan's identity is *which* columns it loads, never the order
        # the user spelled them — read_table assembles in footer order
        # regardless — so scan(p, ["a","b"]) and scan(p, ["b","a"]) must
        # be one loader for subplan dedup, the compiler memo and the
        # cross-run manifest, not two loaders with double loaded bytes
        cols = None if self.columns is None else tuple(self.schema())
        return f"{self.path!r},cols={cols!r}," \
               f"dict={tuple(sorted(self.dict_columns))!r}"

    def schema(self):
        """Output column names — deliberately in *footer order* (the
        order ``zarquet.read_table`` assembles), restricted to
        ``columns`` when set; the order the user passed to ``scan()`` is
        irrelevant.  Unknown names raise KeyError."""
        names = getattr(self, "_footer_names", None)
        if names is None:
            names = [cm["name"] for cm in
                     zarquet.read_footer(self.path)["columns"]]
            self._footer_names = names
        if self.columns is None:
            return list(names)
        want = set(self.columns)
        missing = want - set(names)
        if missing:
            raise KeyError(f"scan {self.path}: no such column(s) "
                           f"{sorted(missing)}")
        return [n for n in names if n in want]

    def describe(self):
        s = f"scan {os.path.basename(self.path)}"
        if self.columns is not None:
            s += f" columns={tuple(self.schema())!r}"
        if self.dict_columns:
            s += f" dict={self.dict_columns!r}"
        return s

    def with_children(self, children):
        assert not children
        return self


class Project(LNode):
    kind = "project"

    def __init__(self, child: LNode, columns: Tuple[str, ...]):
        self.children = (child,)
        self.columns = tuple(columns)

    def args_key(self):
        return repr(self.columns)

    def schema(self):
        have = set(self.children[0].schema())
        missing = set(self.columns) - have
        if missing:
            raise KeyError(f"select: no such column(s) {sorted(missing)}")
        return list(self.columns)

    def describe(self):
        return f"select columns={self.columns!r}"

    def with_children(self, children):
        (c,) = children
        return Project(c, self.columns)


class Filter(LNode):
    kind = "filter"

    def __init__(self, child: LNode, predicate: Expr):
        # validate at construction, not at runtime: a predicate over
        # columns the child does not produce must fail in BOTH modes.
        # Without this, pushdown_filters would commute such a filter
        # below the Project that dropped the column and the plan would
        # "work" under optimize=True while crashing under optimize=False
        # — the optimizer must never repair an invalid plan
        have = child.schema()
        missing = predicate.columns() - set(have)
        if missing:
            raise KeyError(
                f"filter {predicate!r}: no such column(s) "
                f"{sorted(missing)} in the input schema {have}")
        self.children = (child,)
        self.predicate = predicate

    def args_key(self):
        return repr(self.predicate)

    def schema(self):
        return self.children[0].schema()

    def describe(self):
        return f"filter {self.predicate!r}"

    def with_children(self, children):
        (c,) = children
        return Filter(c, self.predicate)


def _join_schema(left: List[str], right: List[str], on: Tuple[str, ...],
                 suffix: str) -> List[str]:
    """Mirror of ops._join_output naming: all left columns, then right
    non-key columns, suffixed on collision with a left name."""
    keys = set(on)
    out = list(left)
    for n in right:
        if n in keys:
            continue
        out.append(n + suffix if n in left else n)
    return out


class Join(LNode):
    kind = "join"

    def __init__(self, left: LNode, right: LNode, on: Tuple[str, ...],
                 how: str = "inner", suffix: str = "_right"):
        assert how in ("inner", "left"), how
        self.children = (left, right)
        self.on = tuple(on)
        self.how = how
        self.suffix = suffix

    def args_key(self):
        return f"on={self.on!r},how={self.how!r},suffix={self.suffix!r}"

    def schema(self):
        l, r = self.children
        return _join_schema(l.schema(), r.schema(), self.on, self.suffix)

    def describe(self):
        return f"join on={self.on!r} how={self.how!r}"

    def with_children(self, children):
        l, r = children
        return Join(l, r, self.on, self.how, self.suffix)


class FilterJoin(LNode):
    """Optimizer-emitted fused node: ``join(filter(l), filter(r))``
    lowered to one ``ops.filter_join`` gather.  Never built directly by
    the Plan surface — the fuse_filter_join rule rewrites to it."""
    kind = "filter_join"

    def __init__(self, left: LNode, right: LNode, on: Tuple[str, ...],
                 how: str, suffix: str, left_pred: Optional[Expr],
                 right_pred: Optional[Expr]):
        assert how in ("inner", "left"), how
        self.children = (left, right)
        self.on = tuple(on)
        self.how = how
        self.suffix = suffix
        self.left_pred = left_pred
        self.right_pred = right_pred

    def args_key(self):
        return (f"on={self.on!r},how={self.how!r},suffix={self.suffix!r},"
                f"lp={self.left_pred!r},rp={self.right_pred!r}")

    def schema(self):
        l, r = self.children
        return _join_schema(l.schema(), r.schema(), self.on, self.suffix)

    def describe(self):
        s = f"filter_join on={self.on!r} how={self.how!r}"
        if self.left_pred is not None:
            s += f" left_pred={self.left_pred!r}"
        if self.right_pred is not None:
            s += f" right_pred={self.right_pred!r}"
        return s

    def with_children(self, children):
        l, r = children
        return FilterJoin(l, r, self.on, self.how, self.suffix,
                          self.left_pred, self.right_pred)


class GroupBy(LNode):
    kind = "group_by"

    def __init__(self, child: LNode, keys: Tuple[str, ...],
                 aggs: Dict[str, Tuple[str, str]]):
        self.children = (child,)
        self.keys = tuple(keys)
        # insertion order is output order — keep it in the key
        self.aggs = dict(aggs)

    def args_key(self):
        return f"keys={self.keys!r},aggs={list(self.aggs.items())!r}"

    def schema(self):
        return list(self.keys) + list(self.aggs)

    def describe(self):
        return f"group_by keys={self.keys!r} aggs={self.aggs!r}"

    def with_children(self, children):
        (c,) = children
        return GroupBy(c, self.keys, self.aggs)


class Sort(LNode):
    kind = "sort"

    def __init__(self, child: LNode, by: str, descending: bool = False):
        self.children = (child,)
        self.by = by
        self.descending = bool(descending)

    def args_key(self):
        return f"by={self.by!r},desc={self.descending!r}"

    def schema(self):
        return self.children[0].schema()

    def describe(self):
        return f"sort by={self.by!r}" + \
               (" descending" if self.descending else "")

    def with_children(self, children):
        (c,) = children
        return Sort(c, self.by, self.descending)


class Limit(LNode):
    kind = "limit"

    def __init__(self, child: LNode, n: int):
        assert n >= 0, n
        self.children = (child,)
        self.n = int(n)

    def args_key(self):
        return repr(self.n)

    def schema(self):
        return self.children[0].schema()

    def describe(self):
        return f"limit {self.n}"

    def with_children(self, children):
        (c,) = children
        return Limit(c, self.n)


# --------------------------------------------------------------------------
# builder surface
# --------------------------------------------------------------------------

class Plan:
    """Immutable dataframe-style handle over a logical-plan root."""

    def __init__(self, root: LNode):
        self.root = root

    # builders -------------------------------------------------------------
    def select(self, *columns: str) -> "Plan":
        return Plan(Project(self.root, tuple(columns)))

    def filter(self, predicate: Expr) -> "Plan":
        assert isinstance(predicate, Expr), predicate
        return Plan(Filter(self.root, predicate))

    def join(self, other: "Plan", on: Union[str, Sequence[str]],
             how: str = "inner", suffix: str = "_right") -> "Plan":
        on = (on,) if isinstance(on, str) else tuple(on)
        return Plan(Join(self.root, other.root, on, how, suffix))

    def group_by(self, keys: Union[str, Sequence[str]],
                 aggs: Dict[str, Tuple[str, str]]) -> "Plan":
        keys = (keys,) if isinstance(keys, str) else tuple(keys)
        return Plan(GroupBy(self.root, keys, aggs))

    def sort(self, by: str, descending: bool = False) -> "Plan":
        return Plan(Sort(self.root, by, descending))

    def limit(self, n: int) -> "Plan":
        return Plan(Limit(self.root, n))

    # introspection --------------------------------------------------------
    def schema(self) -> List[str]:
        return self.root.schema()

    def explain(self, optimize: bool = True) -> str:
        from .compiler import explain_plans
        return explain_plans({"plan": self.root}, optimize=optimize)

    def __repr__(self):
        return f"Plan<{self.root.key()}>"


def scan(path: str, columns: Optional[Sequence[str]] = None,
         dict_columns: Sequence[str] = ()) -> Plan:
    """Start a plan from a zarquet file.  ``columns`` narrows the load
    up front (the pruning pass narrows it further to what the plan
    actually references); ``dict_columns`` dictionary-encode at load."""
    return Plan(Scan(path, None if columns is None else tuple(columns),
                     tuple(dict_columns)))
