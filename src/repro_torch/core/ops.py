"""Table transformations — the 'user code' run inside DAG nodes.

Each op is written the way an Arrow-ecosystem library would write it:
it computes over input buffers and returns a Table whose buffers are,
wherever the semantics allow, *views* of the input buffers.  Whether those
views are reshared (references) or copied is decided downstream by SIPC's
IPC inspection — the op itself is unmodified, ordinary code (Goal G5).

Every public op, with its one-line contract (classes match paper Fig 6):

Subtractive (pure views — zero new bytes):
  ``select_columns(t, names)``   keep the named columns, by reference.
  ``drop_columns(t, names)``     drop the named columns; rest by reference.
  ``slice_rows(t, start, stop)`` row-slice across batches; every buffer a
      view (utf8 offsets need not start at zero).

Additive (new data only — inputs ride through by reference):
  ``add_column(t, name, col)``   append one column.
  ``concat_tables(ts)``          row concat == batch concat; no new bytes.

Fine-grained (row granularity — codes/values copy, dictionaries reshare):
  ``take(t, idx)``               global row gather (dictionary sharing).
  ``filter_rows(t, mask)``       keep mask-true rows, per batch.
  ``sort_by(t, name, descending=False)``  stable sort by one column
      (vectorized bytes sort for utf8; dict ranks for dict-of-utf8).

Rewriting:
  ``upper(t, name)``             utf8 upper-case; the ASCII fast path
      reshares the offsets buffer (the paper's UTF-16 observation).
  ``dict_encode(t, names)``      dictionary-encode utf8 columns.

Relational (reshuffle rows across tables — hash-join engine):
  ``join(left, right, on, how='inner'|'left')``  multi-key hash
      equi-join; null keys never match (SQL); output is left-major with
      build matches ascending; payload dictionaries reshare by reference.
  ``group_by(t, keys, aggs)``    hash-free exact group-by (dense key
      codes + segment reducers): one row per distinct key tuple (nulls
      form one group, sorted last), aggs from sum/min/max/count/mean.
  ``filter_join(left, right, on, how, left_mask=, right_mask=)``  fused
      filter->join: per-side row masks compose into the join's
      take-gather (one gather over the original columns, no
      materialized filtered table); bit-identical to the unfused pair.

Compute helpers (paper workloads):
  ``sum_all_ints(t)``            Fig 2 reader-node reduction.
  ``add_columns_compute(t, a, b, out, repeat=1)``  Fig 7/10 column math.

These ops are also the lowering targets of the declarative query
frontend (``core/plan/``): its compiler emits ``select_columns`` /
``filter_rows`` / ``sort_by`` / ``slice_rows`` / ``join_node`` /
``group_by_node`` nodes, and its filter->join fusion rule rewrites
filter-under-join trees onto ``filter_join`` — so a plan-built DAG and a
hand-wired one exercise the identical op (and fingerprint) surface.

The port's own copy of the JAX package's ``core/ops.py``.  Its relational
ops reach the hand-written CUDA kernels through the port's
``kdispatch``, on the card unless ``kdispatch.set_device("cpu")`` asks
for the CPU.  The ``__fp_includes__`` declarations of the reference wait
for the port's copy of the executor and its fingerprints.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import kdispatch as kd
from . import vkernels
from .arrow import (Column, Field, RecordBatch, Schema, Table, UTF8,
                    pack_validity, type_for_np)

# --------------------------------------------------------------------------
# subtractive ops (pure views)
# --------------------------------------------------------------------------

def select_columns(table: Table, names: Sequence[str]) -> Table:
    idx = [table.schema.index(n) for n in names]
    schema = Schema([table.schema.fields[i] for i in idx])
    return Table([RecordBatch(schema, [b.columns[i] for i in idx])
                  for b in table.batches])


def drop_columns(table: Table, names: Sequence[str]) -> Table:
    keep = [n for n in table.schema.names() if n not in set(names)]
    return Table(select_columns(table, keep).batches)


def slice_rows(table: Table, start: int, stop: int) -> Table:
    """Row-slice across batches: every buffer is a view."""
    out = []
    pos = 0
    for b in table.batches:
        lo = max(start - pos, 0)
        hi = min(stop - pos, b.num_rows)
        if lo < hi:
            out.append(RecordBatch(b.schema,
                                   [c.slice(lo, hi) for c in b.columns]))
        pos += b.num_rows
    if not out:
        out = [RecordBatch(table.schema,
                           [c.slice(0, 0) for c in table.batches[0].columns])]
    return Table(out)


# --------------------------------------------------------------------------
# additive ops (new data only)
# --------------------------------------------------------------------------

def add_column(table: Table, name: str, column: Union[Column, np.ndarray]
               ) -> Table:
    """Append a column; existing columns pass through by reference."""
    if isinstance(column, np.ndarray):
        column = Column.primitive(column)
    assert column.length == table.num_rows
    schema = Schema(list(table.schema.fields) + [Field(name, column.type)])
    out, pos = [], 0
    for b in table.batches:
        piece = column.slice(pos, pos + b.num_rows)
        out.append(RecordBatch(schema, list(b.columns) + [piece]))
        pos += b.num_rows
    return Table(out)


def concat_tables(tables: Sequence[Table]) -> Table:
    """Row-concatenation = batch concatenation: zero new data."""
    schema = tables[0].schema
    batches: List[RecordBatch] = []
    for t in tables:
        assert t.schema.equals(schema)
        batches.extend(t.batches)
    return Table(batches)


# --------------------------------------------------------------------------
# fine-grained-overlap ops (row granularity)
# --------------------------------------------------------------------------

def take(table: Table, indices: np.ndarray) -> Table:
    """Global row gather; materializes (except dictionaries)."""
    t = table.combine()
    b = t.batches[0]
    return Table.from_batch(t.schema, [c.take(indices) for c in b.columns])


def filter_rows(table: Table, mask: Union[np.ndarray, Callable[[RecordBatch], np.ndarray]]
                ) -> Table:
    """Keep rows where mask is True.  Per-batch: codes/values copied,
    dictionaries ride through by reference (dictionary sharing)."""
    out, pos = [], 0
    for b in table.batches:
        m = mask(b) if callable(mask) else np.asarray(mask[pos:pos + b.num_rows])
        idx = np.nonzero(m)[0]
        out.append(RecordBatch(b.schema, [c.take(idx) for c in b.columns]))
        pos += b.num_rows
    return Table(out)


def sort_by(table: Table, name: str, descending: bool = False) -> Table:
    t = table.combine()
    col = t.batches[0].column(name)
    if col.type.is_utf8:
        # direct stable bytes sort replaces the per-row bytes-object keys
        order = vkernels.sort_order_var(col.offsets, col.values)
    elif col.type.is_dict and col.dictionary.type.is_utf8:
        d = col.dictionary
        rank = vkernels.sort_keys_var(d.offsets, d.values)
        order = np.argsort(rank[col.values], kind="stable")
    else:
        order = np.argsort(col._logical(), kind="stable")
    if descending:
        order = order[::-1].copy()
    return take(t, order)


# --------------------------------------------------------------------------
# rewriting op: upper-case (paper §5.3's counter-example)
# --------------------------------------------------------------------------

def upper(table: Table, name: str, assume_ascii: Optional[bool] = None) -> Table:
    """Upper-case a utf8 column.

    General UTF-8 path: byte lengths may change ('ß' -> 'SS'), so both the
    values *and offsets* buffers are new — no resharing possible (paper).
    ASCII fast path (beyond-paper): if all bytes < 0x80, lengths are
    preserved; the offsets buffer passes through as a view and becomes
    reshareable — the paper's UTF-16 observation realized for ASCII UTF-8.
    """
    j = table.schema.index(name)
    out = []
    for b in table.batches:
        col = b.column(name)
        assert col.type.is_utf8
        lo, hi = int(col.offsets[0]), int(col.offsets[-1])
        window = col.values[lo:hi]
        ascii_ok = assume_ascii if assume_ascii is not None \
            else (window.size == 0 or int(window.max()) < 0x80)
        if ascii_ok:
            vals = window.copy()
            lower = (vals >= 0x61) & (vals <= 0x7A)
            vals[lower] -= 0x20
            if lo == 0 and hi == col.values.nbytes:
                new = Column(UTF8, col.length, vals, offsets=col.offsets,
                             validity=col.validity)   # offsets reshared!
            else:
                new = Column(UTF8, col.length, vals,
                             offsets=col.offsets - lo, validity=col.validity)
        else:
            new_off, vals = vkernels.upper_var(col.offsets, col.values)
            new = Column.utf8(new_off, vals, validity=col.validity)
        cols = list(b.columns)
        cols[j] = new
        out.append(RecordBatch(b.schema, cols))
    return Table(out)


# --------------------------------------------------------------------------
# relational ops: hash join + group-by (reshuffle rows across tables)
# --------------------------------------------------------------------------

def _key_hashes(batch: RecordBatch, keys: Sequence[str],
                cast: Dict[str, np.dtype]):
    """(uint64 row hashes, all-keys-valid mask) for one table's key
    columns.  Hashes depend only on logical values, never representation:
    a dict-of-utf8 key hashes its dictionary once and scatters through
    the codes, landing on exactly ``hash_var`` of the decoded rows, so
    it matches a plain utf8 key on the other side; primitive keys hash
    through the two sides' common dtype (``cast``), so an int64 -1
    matches an int32 -1; float zeros are canonicalized inside the
    kernels."""
    n = batch.num_rows
    parts: List[np.ndarray] = []
    valid = np.ones(n, dtype=bool)
    for name in keys:
        c = batch.column(name)
        valid &= c.valid_mask()
        if c.type.is_utf8:
            parts.append(vkernels.hash_var(c.offsets, c.values))
        elif c.type.is_dict:
            d = c.dictionary
            hd = vkernels.hash_var(d.offsets, d.values) \
                if d.type.is_utf8 else kd.hash_fixed(
                    d.values.astype(cast[name], copy=False))
            parts.append(hd[c.values])
        else:
            parts.append(kd.hash_fixed(
                c.values.astype(cast[name], copy=False)))
    return kd.combine_hashes(parts, n), valid


def _key_cast_map(lb: RecordBatch, rb: RecordBatch,
                  keys: Sequence[str]) -> Dict[str, np.dtype]:
    """Common hash dtype per primitive-kind key column: both sides hash
    through ``np.result_type`` of their logical dtypes, so bit patterns
    agree whenever ``==`` would.  Mixed int64/uint64 hashes through
    float64 — complete for candidate generation (equal integers cast to
    the same float), with float-rounding collisions filtered by the
    exact-integer confirm in ``_key_pairs_equal``.  Joining a utf8-kind
    key against a primitive-kind key is a type error, not an empty
    result."""
    def prim_dtype(c: Column) -> np.dtype:
        t = c.type.value_type if c.type.is_dict else c.type
        return np.dtype(t.np_dtype)

    cast: Dict[str, np.dtype] = {}
    for name in keys:
        lc, rc = lb.column(name), rb.column(name)
        if lc._kindof() != rc._kindof():
            raise TypeError(f"join key {name!r}: {lc._kindof()} vs "
                            f"{rc._kindof()} columns")
        if lc._kindof() == "prim":
            cast[name] = np.result_type(prim_dtype(lc), prim_dtype(rc))
    return cast


def _exact_int_equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact elementwise == for integer arrays numpy would promote to
    float64 (int64 vs uint64): a negative signed value never equals any
    unsigned value; the rest compare as uint64 with no precision loss."""
    ok = np.ones(len(a), dtype=bool)
    if np.issubdtype(a.dtype, np.signedinteger):
        ok &= a >= 0
    if np.issubdtype(b.dtype, np.signedinteger):
        ok &= b >= 0
    return ok & (a.astype(np.uint64) == b.astype(np.uint64))


def _key_pairs_equal(lcol: Column, li: np.ndarray,
                     rcol: Column, ri: np.ndarray) -> np.ndarray:
    """Confirm candidate pairs: bool per pair, left row li[p] == right
    row ri[p] on this key column (the hash-collision filter)."""
    if lcol._kindof() == "utf8":
        off_a, val_a = lcol._logical_var(li)
        off_b, val_b = rcol._logical_var(ri)
        return vkernels.bytes_rows_equal(off_a, val_a, off_b, val_b)
    a, b = lcol._logical()[li], rcol._logical()[ri]
    if (np.issubdtype(a.dtype, np.integer)
            and np.issubdtype(b.dtype, np.integer)
            and not np.issubdtype(np.result_type(a, b), np.integer)):
        return _exact_int_equal(a, b)
    return a == b


def _join_gather_indices(lb: RecordBatch, rb: RecordBatch,
                         keys: Sequence[str], how: str,
                         lmask: Optional[np.ndarray] = None,
                         rmask: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right) original-domain gather index arrays for the join
    output rows (``-1`` right index = left-join miss).  ``lmask`` /
    ``rmask`` restrict each side to mask-true rows — the fused
    filter->join path: the selection composes into the probe/build
    subsets (via ``vkernels.filter_join_gather``), so the caller gathers
    payload columns exactly once from the *unfiltered* batches."""
    cast = _key_cast_map(lb, rb, keys)
    lh, lvalid = _key_hashes(lb, keys, cast)
    rh, rvalid = _key_hashes(rb, keys, cast)
    if lmask is not None:
        lvalid &= lmask
    if rmask is not None:
        rvalid &= rmask
    # null keys never match: probe/build over the valid-key subsets only
    pidx = np.nonzero(lvalid)[0]
    bidx = np.nonzero(rvalid)[0]
    pi, bi = vkernels.hash_join_probe(rh[bidx], lh[pidx])
    li = kd.filter_join_gather(pidx, pi)
    ri = kd.filter_join_gather(bidx, bi)
    keep = np.ones(len(li), dtype=bool)
    for k in keys:
        keep &= _key_pairs_equal(lb.column(k), li, rb.column(k), ri)
    li, ri = li[keep], ri[keep]
    if how == "left":
        matched = np.zeros(lb.num_rows, dtype=bool)
        matched[li] = True
        cand = ~matched if lmask is None else lmask & ~matched
        miss = np.nonzero(cand)[0]
        li = np.concatenate([li, miss])
        ri = np.concatenate([ri, np.full(len(miss), -1, dtype=np.int64)])
        order = np.argsort(li, kind="stable")   # restore left-major order
        li, ri = li[order], ri[order]
    return li, ri


def _join_output(lb: RecordBatch, rb: RecordBatch, keys: Sequence[str],
                 li: np.ndarray, ri: np.ndarray, suffix: str) -> Table:
    """Assemble the join output: one gather per left column, one
    nullable gather per right payload column."""
    fields: List[Field] = []
    cols: List[Column] = []
    rkeys = set(keys)
    lnames = set(lb.schema.names())
    for f, c in zip(lb.schema.fields, lb.columns):
        fields.append(f)
        cols.append(c.take(li))
    used = set(lnames)
    for f, c in zip(rb.schema.fields, rb.columns):
        if f.name in rkeys:
            continue                 # equal to the left key by definition
        name = f.name + suffix if f.name in lnames else f.name
        if name in used:
            raise ValueError(
                f"join output column {name!r} is ambiguous (suffixed "
                f"right column collides with an existing column); rename "
                f"it or pass a different suffix")
        used.add(name)
        fields.append(Field(name, c.type))
        cols.append(c.take_nullable(ri))
    return Table.from_batch(Schema(fields), cols)


def join(left: Table, right: Table, on: Union[str, Sequence[str]],
         how: str = "inner", suffix: str = "_right") -> Table:
    """Multi-key hash equi-join (probe = left, build = right).

    ``on`` names key columns present in both tables (same logical kind:
    utf8 and dict-of-utf8 mix freely; primitives must compare with
    ``==``, except that mixed signed/unsigned 64-bit integer keys are
    compared *exactly* — numpy's float64 promotion would conflate
    distinct integers beyond 2**53).  Null keys never match (SQL
    semantics): inner drops them,
    left preserves the row with all-null right payloads.  Output rows
    are left-major (left row order preserved) with matching right rows
    ascending; columns are the left table's, then right's non-key
    columns (name collisions get ``suffix``; a name that still collides
    after suffixing raises ``ValueError`` rather than emitting a
    duplicate field).  Left payloads are
    take-gathers, right payloads nullable take-gathers — dictionary
    buffers of dict-encoded payloads pass through by reference, so SIPC
    reshares them on the output (no re-deanonymization).
    """
    assert how in ("inner", "left"), how
    keys = [on] if isinstance(on, str) else list(on)
    lb = left.combine().batches[0]
    rb = right.combine().batches[0]
    li, ri = _join_gather_indices(lb, rb, keys, how)
    return _join_output(lb, rb, keys, li, ri, suffix)


#: a mask for one side of a fused filter->join: a bool/int array over the
#: (combined) batch rows, or a callable evaluated on the combined batch
MaskLike = Union[np.ndarray, Callable[[RecordBatch], np.ndarray]]


def _resolve_mask(mask: MaskLike, batch: RecordBatch) -> np.ndarray:
    m = np.asarray(mask(batch) if callable(mask) else mask)
    if m.dtype != np.bool_:
        m = m != 0
    assert len(m) == batch.num_rows, \
        f"mask length {len(m)} != batch rows {batch.num_rows}"
    return m


def filter_join(left: Table, right: Table, on: Union[str, Sequence[str]],
                how: str = "inner", suffix: str = "_right",
                left_mask: Optional[MaskLike] = None,
                right_mask: Optional[MaskLike] = None) -> Table:
    """Fused filter->join: ``join(filter_rows(left, left_mask),
    filter_rows(right, right_mask), on, how)`` without materializing
    either filtered intermediate table.

    The masks compose into the join's probe/build row selection
    (``vkernels.filter_join_gather``), so payload columns are gathered
    exactly *once* from the original batches — the unfused pair gathers
    the filtered side twice (filter take + join take) and pays the
    intermediate's allocation, deanonymization and (in process mode)
    wire hop.  Output is bit-identical to the unfused pair: same rows,
    same left-major order, same buffers.  A mask may be an array over
    the side's combined rows or a picklable callable evaluated on the
    combined batch (so a ``functools.partial`` of this op crosses the
    Flight process boundary)."""
    assert how in ("inner", "left"), how
    keys = [on] if isinstance(on, str) else list(on)
    lb = left.combine().batches[0]
    rb = right.combine().batches[0]
    lm = None if left_mask is None else _resolve_mask(left_mask, lb)
    rm = None if right_mask is None else _resolve_mask(right_mask, rb)
    li, ri = _join_gather_indices(lb, rb, keys, how, lmask=lm, rmask=rm)
    return _join_output(lb, rb, keys, li, ri, suffix)


def _group_codes(col: Column) -> np.ndarray:
    """Dense int64 group codes for one key column: equal logical rows
    share a code, codes ascend in value order (bytes order for utf8),
    float NaNs collapse into one group after the real values, and null
    rows share the single largest code (SQL: nulls group together)."""
    valid = col.valid_mask()
    if col._kindof() == "utf8":
        if col.type.is_dict:
            d = col.dictionary
            ranks = vkernels.sort_keys_var(d.offsets,
                                           d.values).astype(np.int64)
            codes = ranks[col.values.astype(np.int64)] \
                if col.length else np.empty(0, np.int64)
            ncodes = int(ranks.max(initial=-1)) + 1
        else:
            c32, uoff, _ = vkernels.dict_encode_var(col.offsets, col.values)
            codes, ncodes = c32.astype(np.int64), len(uoff) - 1
    else:
        v = col._logical()
        nan = None
        if np.issubdtype(v.dtype, np.floating):
            nan = np.isnan(v)
            v = np.where(nan | (v == 0), 0, v)   # -0.0 == +0.0; NaN later
        uniq, inv = np.unique(v, return_inverse=True)
        codes, ncodes = inv.astype(np.int64).reshape(-1), len(uniq)
        if nan is not None and nan.any():
            codes = np.where(nan, ncodes, codes)
            ncodes += 1
    if not valid.all():
        codes = np.where(valid, codes, ncodes)
    return codes


#: agg spec: {out_name: (column_name, how)} with how one of
#: vkernels.GROUPED_REDUCERS — 'sum', 'min', 'max', 'count', 'mean'
AggSpec = Dict[str, Tuple[str, str]]


def group_by(table: Table, keys: Union[str, Sequence[str]],
             aggs: AggSpec) -> Table:
    """Group by key columns and reduce payload columns.

    Exact (no hashing): per-key dense codes + one lexsort find the
    groups, segment reducers aggregate.  One output row per distinct key
    tuple, sorted by key values ascending (float NaNs after real values,
    the null group last); key columns come first (dictionary-encoded
    keys keep their dictionary by reference), then one column per agg in
    ``aggs`` order.  Nulls are excluded from every aggregate; a group
    whose payload is all-null aggregates to null (count: 0).
    """
    keys = [keys] if isinstance(keys, str) else list(keys)
    clash = [n for n in aggs if n in keys]
    if clash:
        raise ValueError(f"agg output name(s) {clash} collide with key "
                         f"column(s); pick a different out_name")
    b = table.combine().batches[0]
    order, starts = vkernels.group_ranges(
        [_group_codes(b.column(k)) for k in keys])
    reps = order[starts]
    fields: List[Field] = []
    cols: List[Column] = []
    for k in keys:
        c = b.column(k).take(reps)
        fields.append(Field(k, c.type))
        cols.append(c)
    # one dispatch per column computes all of its aggregates
    hows: Dict[str, List[str]] = {}
    for col_name, how in aggs.values():
        hows.setdefault(col_name, []).append(how)
    reduced = {}
    for col_name, col_hows in hows.items():
        c = b.column(col_name)
        on_values = [h for h in col_hows if h != "count"]
        if not on_values:
            v = np.empty(c.length, dtype=np.int64)    # values unused
        else:
            assert c._kindof() == "prim", \
                f"{on_values[0]}({col_name}): non-numeric column"
            v = c._logical()
        valid = None if c.validity is None else c.valid_mask()
        reduced[col_name] = (v, kd.grouped_reduce(v, order, starts, valid,
                                                  col_hows))
    for out_name, (col_name, how) in aggs.items():
        v, res = reduced[col_name]
        vals, counts = res[how]
        if how in ("min", "max") and v.dtype == np.bool_:
            vals = vals.astype(bool)
        validity = None
        if how != "count" and (counts == 0).any():
            validity = pack_validity(counts > 0)      # all-null group
        fields.append(Field(out_name, type_for_np(vals.dtype)))
        cols.append(Column.primitive(vals, validity=validity))
    return Table.from_batch(Schema(fields), cols)


def join_node(tables: Sequence[Table], on, how: str = "inner",
              suffix: str = "_right") -> Table:
    """DAG-node form of ``join``: ``tables == [left, right]``.  Module-
    level so a ``functools.partial`` over it pickles across the Flight
    process boundary and fingerprints deterministically."""
    return join(tables[0], tables[1], on=on, how=how, suffix=suffix)


def group_by_node(tables: Sequence[Table], keys, aggs: AggSpec) -> Table:
    """DAG-node form of ``group_by`` (see ``join_node``)."""
    return group_by(tables[0], keys, aggs)


def filter_join_node(tables: Sequence[Table], on, how: str = "inner",
                     suffix: str = "_right",
                     left_mask: Optional[MaskLike] = None,
                     right_mask: Optional[MaskLike] = None) -> Table:
    """DAG-node form of ``filter_join`` (see ``join_node``)."""
    return filter_join(tables[0], tables[1], on=on, how=how, suffix=suffix,
                       left_mask=left_mask, right_mask=right_mask)




# --------------------------------------------------------------------------
# compute helpers used by the paper's workloads
# --------------------------------------------------------------------------

def sum_all_ints(table: Table) -> int:
    """Reader-node workload of paper Fig 2."""
    total = 0
    for b in table.batches:
        for c in b.columns:
            if c.type.is_primitive and np.issubdtype(np.dtype(c.type.np_dtype),
                                                     np.integer):
                total += int(c.values.sum())
    return total


def add_columns_compute(table: Table, a: str, b: str, out_name: str,
                        repeat: int = 1) -> Table:
    """The Fig 7/10 'column-adding function': out = f(col_a, col_b) with a
    tunable amount of compute (``repeat`` additions)."""
    t0 = table.combine()
    ca = t0.batches[0].column(a).to_numpy()
    cb = t0.batches[0].column(b).to_numpy()
    acc = ca + cb
    for _ in range(repeat - 1):
        acc = acc + cb
    return add_column(table, out_name, Column.primitive(acc))


def dict_encode(table: Table, names: Sequence[str]) -> Table:
    """Dictionary-encode utf8 columns (what read_dictionary does at load)."""
    name_set = set(names)
    out = []
    for b in table.batches:
        cols = []
        for f, c in zip(b.schema.fields, b.columns):
            if f.name in name_set and c.type.is_utf8:
                codes, uoff, uvals = vkernels.dict_encode_var(c.offsets,
                                                              c.values)
                dic = Column.utf8(uoff, uvals)
                c = Column.dictionary_encoded(codes, dic,
                                              validity=c.validity)
            cols.append(c)
        schema = Schema([Field(f.name, c.type)
                         for f, c in zip(b.schema.fields, cols)])
        out.append(RecordBatch(schema, cols))
    return Table(out)
