"""Picklable expression trees for plan predicates.

``col("amount") > 0`` builds a tiny AST (module-level classes, plain
attributes) with three properties the rest of the stack depends on:

* **picklable** — a predicate crosses the Flight process boundary inside
  a ``functools.partial(eval_predicate, expr=...)`` op, so every node is
  a module-level class holding only plain-Python values;
* **stable repr** — ``repr`` is deterministic and address-free
  (``(col('amount') > lit(0.0))``), because node fingerprints
  canonicalize partial keywords via ``repr``: the same predicate built
  next run must fingerprint identically, and an edited predicate must
  not;
* **null semantics fixed per comparison** — a comparison involving a
  null row is ``False`` (SQL WHERE semantics), and ``&``/``|``/``~``
  are plain boolean algebra over those masks.  Because each conjunct
  evaluates independently of its siblings, the optimizer may split a
  top-level ``&`` and push the pieces to different join sides without
  changing the result.  Nulls are *tested* with
  ``col(...).is_null()``/``is_not_null()`` — ``lit(None)`` is rejected
  at construction because every comparison against it would silently be
  False.  Arithmetic is IEEE with warnings contained (``np.errstate``):
  ``x/0 → ±inf``, ``0/0 → NaN``, and NaN fails every comparison, so
  undefined rows drop out of the mask like null rows do.

Evaluation is vectorized per record batch: primitive and dict-encoded
numeric columns compare via numpy on the logical values; utf8 equality
against a literal compares lengths first, then gathers only the
length-matching rows' bytes (dict-encoded utf8 compares once per
dictionary entry, then projects through the codes — dictionary sharing
makes this O(unique)).
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

import numpy as np

__all__ = ["Expr", "Col", "Lit", "Cmp", "BoolOp", "Not", "Arith",
           "IsNull", "col", "lit", "eval_predicate", "split_conjuncts",
           "and_all", "EVAL_FP"]


def _wrap(v) -> "Expr":
    return v if isinstance(v, Expr) else Lit(v)


class Expr:
    """Base node: operator overloads build the tree."""

    # comparisons ----------------------------------------------------------
    def __eq__(self, other):            # noqa: D105 — builds an AST node
        return Cmp("==", self, _wrap(other))

    def __ne__(self, other):
        return Cmp("!=", self, _wrap(other))

    def __lt__(self, other):
        return Cmp("<", self, _wrap(other))

    def __le__(self, other):
        return Cmp("<=", self, _wrap(other))

    def __gt__(self, other):
        return Cmp(">", self, _wrap(other))

    def __ge__(self, other):
        return Cmp(">=", self, _wrap(other))

    __hash__ = object.__hash__          # __eq__ override would drop it

    # boolean algebra ------------------------------------------------------
    def __and__(self, other):
        return BoolOp("&", self, _wrap(other))

    def __or__(self, other):
        return BoolOp("|", self, _wrap(other))

    def __invert__(self):
        return Not(self)

    # null tests -----------------------------------------------------------
    def is_null(self) -> "IsNull":
        """True exactly on null rows — the *only* way to test for nulls
        (a comparison against a null is always False, and ``lit(None)``
        is rejected for that reason)."""
        return IsNull(self)

    def is_not_null(self) -> "IsNull":
        return IsNull(self, negate=True)

    # arithmetic -----------------------------------------------------------
    def __add__(self, other):
        return Arith("+", self, _wrap(other))

    def __sub__(self, other):
        return Arith("-", self, _wrap(other))

    def __mul__(self, other):
        return Arith("*", self, _wrap(other))

    def __truediv__(self, other):
        return Arith("/", self, _wrap(other))

    # analysis -------------------------------------------------------------
    def columns(self) -> Set[str]:
        """Column names this expression reads."""
        out: Set[str] = set()
        self._collect(out)
        return out

    def _collect(self, out: Set[str]) -> None:
        raise NotImplementedError

    # evaluation -----------------------------------------------------------
    def mask(self, batch) -> np.ndarray:
        raise TypeError(f"{self!r} is not a boolean predicate")

    def _value(self, batch) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(values, valid) for numeric evaluation; valid None == all."""
        raise TypeError(f"{self!r} is not a value expression")


class Col(Expr):
    def __init__(self, name: str):
        assert isinstance(name, str) and name, name
        self.name = name

    def __repr__(self):
        return f"col({self.name!r})"

    def _collect(self, out):
        out.add(self.name)

    def _value(self, batch):
        c = batch.column(self.name)
        if c._kindof() == "utf8":
            raise TypeError(f"col({self.name!r}): utf8 columns support "
                            f"only ==/!= against another column or a "
                            f"string literal")
        vals = c._logical()
        valid = None if c.validity is None else c.valid_mask()
        return vals, valid

    def mask(self, batch):
        # a bare column used as predicate: truthy and non-null
        vals, valid = self._value(batch)
        m = vals != 0
        return m if valid is None else (m & valid)


class Lit(Expr):
    def __init__(self, value):
        if isinstance(value, np.generic):    # np.float64(3) reprs unstably
            value = value.item()
        if value is None:
            # SQL three-valued logic is deliberately not implemented: a
            # null literal would make every comparison silently False
            raise TypeError(
                "lit(None)/literal None has no comparison semantics "
                "(a null row is never ==, !=, < or > anything); test "
                "for nulls with col(...).is_null() / "
                "col(...).is_not_null() instead")
        assert isinstance(
            value, (bool, int, float, str, bytes)), type(value)
        self.value = value

    def __repr__(self):
        return f"lit({self.value!r})"

    def _collect(self, out):
        pass

    def _value(self, batch):
        if isinstance(self.value, (str, bytes)):
            raise TypeError(f"{self!r} is not numeric")
        return self.value, None


class Cmp(Expr):
    OPS = ("==", "!=", "<", "<=", ">", ">=")

    def __init__(self, op: str, left: Expr, right: Expr):
        assert op in self.OPS, op
        self.op, self.left, self.right = op, left, right

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"

    def _collect(self, out):
        self.left._collect(out)
        self.right._collect(out)

    def _is_utf8_side(self, e: Expr, batch) -> bool:
        if isinstance(e, Lit):
            return isinstance(e.value, (str, bytes))
        if isinstance(e, Col):
            return batch.column(e.name)._kindof() == "utf8"
        return False

    def mask(self, batch):
        if self._is_utf8_side(self.left, batch) or \
           self._is_utf8_side(self.right, batch):
            return self._utf8_mask(batch)
        av, avalid = self.left._value(batch)
        bv, bvalid = self.right._value(batch)
        if self.op == "==":
            m = av == bv
        elif self.op == "!=":
            m = av != bv
        elif self.op == "<":
            m = av < bv
        elif self.op == "<=":
            m = av <= bv
        elif self.op == ">":
            m = av > bv
        else:
            m = av >= bv
        m = np.asarray(m)
        if m.ndim == 0:                     # scalar-vs-scalar literal
            m = np.full(batch.num_rows, bool(m))
        if avalid is not None:
            m = m & avalid
        if bvalid is not None:
            m = m & bvalid
        return m

    def _utf8_mask(self, batch):
        if self.op not in ("==", "!="):
            raise TypeError(f"utf8 comparison supports ==/!=, not "
                            f"{self.op!r}: {self!r}")
        a, b = self.left, self.right
        if isinstance(a, Lit):              # canonical: column on the left
            a, b = b, a
        if not isinstance(a, Col):
            raise TypeError(f"unsupported utf8 comparison: {self!r}")
        ca = batch.column(a.name)
        # kinds must match on both sides (same contract as join keys,
        # ops.hash_keys) — named error instead of a bare assert deep in
        # the byte-compare path
        if isinstance(b, Col):
            cb = batch.column(b.name)
            if ca._kindof() != "utf8" or cb._kindof() != "utf8":
                raise TypeError(
                    f"comparison {self!r}: {a.name!r} vs {b.name!r}: "
                    f"{ca._kindof()} vs {cb._kindof()} columns (utf8 "
                    f"compares only against utf8)")
            eq = _utf8_eq_pair(ca, cb)
        elif isinstance(b, Lit):
            if not isinstance(b.value, (str, bytes)):
                raise TypeError(
                    f"comparison {self!r}: column {a.name!r} is utf8 but "
                    f"{b!r} is {type(b.value).__name__} (utf8 compares "
                    f"only against utf8)")
            if ca._kindof() != "utf8":
                raise TypeError(
                    f"comparison {self!r}: column {a.name!r} is "
                    f"{ca._kindof()} but {b!r} is utf8 (utf8 compares "
                    f"only against utf8)")
            needle = b.value.encode() if isinstance(b.value, str) else b.value
            eq = _utf8_eq_scalar(ca, needle)
        else:
            raise TypeError(f"unsupported utf8 comparison: {self!r}")
        valid = ca.valid_mask()
        if isinstance(b, Col):
            valid = valid & batch.column(b.name).valid_mask()
        # null rows are False for BOTH == and != (SQL WHERE semantics)
        return (eq if self.op == "==" else ~eq) & valid


def _utf8_eq_scalar(c, needle: bytes) -> np.ndarray:
    """Per-row equality of a utf8/dict-utf8 column against one bytes
    value.  Length-filter first, then one vectorized gather+compare of
    just the candidate rows; dict columns compare per dictionary entry
    and project through the codes."""
    if c.type.is_dict:
        return _utf8_eq_scalar(c.dictionary, needle)[c.values]
    off = np.asarray(c.offsets, dtype=np.int64)
    eq = (off[1:] - off[:-1]) == len(needle)
    if len(needle):
        idx = np.nonzero(eq)[0]
        if len(idx):
            gathered = np.asarray(c.values)[
                off[idx][:, None] + np.arange(len(needle))]
            pat = np.frombuffer(needle, dtype=np.uint8)
            eq = eq.copy()
            eq[idx] = (gathered == pat).all(axis=1)
    return eq


def _utf8_eq_pair(ca, cb) -> np.ndarray:
    """Row-wise equality of two utf8-kind columns (slow path: per-row
    bytes compare on the length-matching candidates)."""
    n = ca.length
    assert cb.length == n
    la = np.asarray([len(ca._get_logical_bytes(i)) for i in range(n)])
    lb = np.asarray([len(cb._get_logical_bytes(i)) for i in range(n)])
    eq = la == lb
    for i in np.nonzero(eq)[0]:
        eq[i] = ca._get_logical_bytes(int(i)) == cb._get_logical_bytes(int(i))
    return eq


class BoolOp(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        assert op in ("&", "|"), op
        self.op, self.left, self.right = op, left, right

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"

    def _collect(self, out):
        self.left._collect(out)
        self.right._collect(out)

    def mask(self, batch):
        a = self.left.mask(batch)
        b = self.right.mask(batch)
        return (a & b) if self.op == "&" else (a | b)


class Not(Expr):
    def __init__(self, expr: Expr):
        self.expr = expr

    def __repr__(self):
        return f"(~{self.expr!r})"

    def _collect(self, out):
        self.expr._collect(out)

    def mask(self, batch):
        return ~self.expr.mask(batch)


class IsNull(Expr):
    """Null test — works on every column kind (including utf8, which has
    no numeric ``_value``) and on computed expressions (null iff any
    input column is null on that row)."""

    def __init__(self, expr: Expr, negate: bool = False):
        self.expr = expr
        self.negate = bool(negate)

    def __repr__(self):
        return f"{self.expr!r}.is_{'not_' if self.negate else ''}null()"

    def _collect(self, out):
        self.expr._collect(out)

    def mask(self, batch):
        if isinstance(self.expr, Col):
            valid = batch.column(self.expr.name).valid_mask()
        else:
            _, valid = self.expr._value(batch)
            if valid is None:
                valid = np.ones(batch.num_rows, dtype=bool)
            else:
                valid = np.asarray(valid)
                if valid.ndim == 0:         # literal-only expression
                    valid = np.full(batch.num_rows, bool(valid))
        return valid if self.negate else ~valid


class Arith(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        assert op in ("+", "-", "*", "/"), op
        self.op, self.left, self.right = op, left, right

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"

    def _collect(self, out):
        self.left._collect(out)
        self.right._collect(out)

    def _value(self, batch):
        av, avalid = self.left._value(batch)
        bv, bvalid = self.right._value(batch)
        # IEEE semantics, warnings suppressed (they must not escape
        # eval_predicate — callers running under `-W error` would crash
        # on data-dependent values): x/0 -> ±inf, 0/0 -> NaN, float
        # overflow -> inf.  NaN then fails every comparison, so rows
        # whose expression is undefined drop out of the mask exactly
        # like null rows do.  Note `/` is numpy true division: int/int
        # promotes to float64
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            if self.op == "+":
                v = av + bv
            elif self.op == "-":
                v = av - bv
            elif self.op == "*":
                v = av * bv
            else:
                v = av / bv
        if avalid is None:
            valid = bvalid
        elif bvalid is None:
            valid = avalid
        else:
            valid = avalid & bvalid
        return v, valid


# --------------------------------------------------------------------------
# module-level entry points (picklable partial targets)
# --------------------------------------------------------------------------

def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Lit:
    return Lit(value)


def eval_predicate(batch, expr: Expr) -> np.ndarray:
    """Evaluate a predicate to a bool mask over one record batch.  The
    compiler ships ``functools.partial(eval_predicate, expr=pred)`` as
    the mask callable of ``ops.filter_rows``/``ops.filter_join`` — the
    partial pickles across the Flight boundary and fingerprints via the
    expression's stable repr."""
    m = np.asarray(expr.mask(batch))
    if m.dtype != np.bool_:
        m = m != 0
    return m


def split_conjuncts(expr: Expr):
    """Top-level ``&`` split: [a, b, c] for ``a & b & c``.  Safe because
    each conjunct's mask is independent of its siblings (nulls resolve
    per comparison, not per WHERE clause)."""
    if isinstance(expr, BoolOp) and expr.op == "&":
        return split_conjuncts(expr.left) + split_conjuncts(expr.right)
    return [expr]


def and_all(exprs) -> Expr:
    """Re-combine conjuncts: inverse of split_conjuncts."""
    exprs = list(exprs)
    assert exprs
    out = exprs[0]
    for e in exprs[1:]:
        out = BoolOp("&", out, e)
    return out


#: evaluation-semantics dependency set: any op that ships an expression
#: (``partial(eval_predicate, ...)``) folds these into its code identity
#: via ``__fp_includes__`` — editing how predicates evaluate invalidates
#: every cached filtered/fused-join output (same contract as ops.join
#: pinning the relational vkernels)
EVAL_FP = (Cmp.mask, Cmp._utf8_mask, BoolOp.mask, Not.mask, Col.mask,
           Col._value, Lit._value, Arith._value, IsNull.mask,
           _utf8_eq_scalar, _utf8_eq_pair)

eval_predicate.__fp_includes__ = EVAL_FP
