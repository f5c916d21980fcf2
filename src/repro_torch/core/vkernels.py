"""Vectorized columnar kernels — GIL-releasing bulk ops over Arrow buffers.

The port's own copy of the JAX package's ``core/vkernels.py``, numpy
only; the code is the same, only this docstring differs.

Every kernel works directly on raw (offsets, values, validity) buffers of
the Arrow computational format and replaces a per-row Python loop on the
compute path.  One-line contracts for every public kernel:

Var-length gather:
  ``ranges(lens)``            [0..lens[0]) .. [0..lens[n-1]) concatenated.
  ``gather_var(v, starts, lens)``  gather N byte-ranges out of ``v`` ->
      (new_offsets, out) in three bulk ops (repeat / arange / take).
  ``take_var(off, v, idx)``   row-gather on a var-length column: select
      rows ``idx`` -> (new_offsets, new_values).  Used by ``Column.take``,
      ``Column.decode_dictionary`` and the utf8 ``Column.equals`` branch.

Dictionary encode / sort:
  ``dict_encode_var(off, v)`` -> (codes i32, uniq_offsets, uniq_values):
      exactly ``np.unique`` over the row byte-strings (uniques in
      bytes-lexicographic order) without a Python object per row.
      Fixed-width fast path: rows viewed as an ``np.void`` record array,
      one ``np.unique`` (memcmp order == bytes order at equal width).
      General path: rows zero-padded into big-endian uint64 chunks +
      ``np.lexsort`` with the true length as final tiebreaker (a prefix
      sorts before its extensions; trailing NULs are significant).
      Length-skewed columns (padded matrix > 32x data and > 64 MiB) fall
      back to a per-row path instead of OOMing.
  ``sort_keys_var(off, v)``   dense int32 lexicographic ranks (equal rows
      share a rank): ``np.argsort(keys, kind='stable')`` == stable bytes
      sort.  Also the var-length group-code builder for ``group_ranges``.
  ``sort_order_var(off, v)``  direct stable bytes-sort permutation (one
      lexsort over packed chunks, no second argsort over ranks).

Rewriting:
  ``upper_var(off, v)``       bulk non-ASCII utf8 upper-case: one
      whole-window decode, a per-*alphabet* (not per-row) uppercase
      table, one var-gather.  Handles length changes ('ß' -> 'SS').

Relational (hash join + group-by, the zero-copy relational engine):
  ``hash_fixed(v)``           uint64 splitmix64 hash of a fixed-width
      array's bit patterns (float -0.0 canonicalized to +0.0).
  ``hash_var(off, v)``        uint64 hash of each var-length row: XOR of
      position-salted mixed chunks over the row's own ceil(len/8)
      big-endian uint64 chunks, length-seeded — a pure function of the
      row bytes (identical across column widths, slices, and the
      per-row skew fallback), so equal bytes always hash equal.
  ``hash_keys(keys, n)``      combine raw key buffers (ndarray = fixed
      width, (offsets, values) tuple = var-length) into one order-
      sensitive uint64 row hash per table row.
  ``combine_hashes(hs, n)``   the representation-free combiner under
      ``hash_keys``: fold precomputed per-column uint64 hashes (how a
      dict key hashes its dictionary once yet matches a plain utf8 key).
  ``hash_join_probe(bh, ph)`` hash-equality candidate pairs: sort the
      build hashes once, searchsorted every probe hash -> (probe_idx,
      build_idx) index arrays, probe-major, build ascending within a
      probe row.  Collisions survive; the caller confirms key equality.
  ``filter_join_gather(sel, idx)``  compose a filter's selection with a
      join's gather indices in one step (-1 miss sentinels preserved) —
      the fused filter->join never materializes the filtered table.
  ``bytes_rows_equal(off_a, v_a, off_b, v_b)``  per-row bool: row i of A
      == row i of B (length compare + one flat gather-and-compare).
  ``group_ranges(codes)``     group boundary detection over per-column
      dense codes: (order, starts) with ``order`` a stable lexsort
      permutation and ``starts`` each group's first sorted position.
  ``grouped_count / grouped_sum / grouped_min / grouped_max /
  grouped_mean(values, order, starts, valid=None)``  segment reducers
      over ``group_ranges`` boundaries; nulls are excluded and each
      returns per-group ``(values, counts)`` (count of non-null rows) so
      the caller can null out empty (all-null) groups.

Kernels take and return plain numpy arrays (no Column/Table types), so
this module sits below ``arrow.py`` with no import cycle, and the big
array ops release the GIL — which is what lets the worker-pool executor
actually overlap compute-adjacent work across threads (see
docs/ARCHITECTURE.md "Compute kernels & the GIL").

This module is also the *reference semantics* for the card:
``core/kdispatch.py`` routes hashing, join gathers and the integer
segment reducers to the hand-written CUDA kernels of
``repro_torch.kernels`` (or, for data on the CPU, to their plain PyTorch
versions), which must give exactly the bits of the functions here.
Order-sensitive float reductions (``grouped_sum``'s sequential
``np.bincount`` accumulation, ``reduceat`` extreme ties) stay on this
code path by registry.  Behavior changes here are contract changes for
every device.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

__all__ = [
    "ranges", "gather_var", "take_var", "dict_encode_var",
    "sort_keys_var", "sort_order_var", "upper_var",
    "hash_fixed", "hash_var", "hash_keys", "combine_hashes",
    "hash_join_probe",
    "bytes_rows_equal", "group_ranges", "grouped_count", "grouped_sum",
    "grouped_min", "grouped_max", "grouped_mean",
]


# --------------------------------------------------------------------------
# variable-length gather
# --------------------------------------------------------------------------

def ranges(lens: np.ndarray) -> np.ndarray:
    """[0..lens[0]), [0..lens[1]), ... concatenated."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    excl = np.cumsum(lens) - lens           # exclusive prefix sums
    return np.arange(total, dtype=np.int64) - np.repeat(excl, lens)


def gather_var(values: np.ndarray, starts: np.ndarray, lens: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather ``len(starts)`` byte-ranges out of ``values``.

    Returns ``(new_offsets, out)`` with
    ``out[new_offsets[i]:new_offsets[i+1]] == values[starts[i]:starts[i]+lens[i]]``.
    """
    new_off = np.zeros(len(starts) + 1, dtype=np.int64)
    np.cumsum(lens, out=new_off[1:])
    out = np.empty(int(new_off[-1]), dtype=np.uint8)
    if len(starts) and out.nbytes:
        idx = np.repeat(starts, lens) + ranges(lens)
        np.take(values, idx, out=out)
    return new_off, out


def take_var(offsets: np.ndarray, values: np.ndarray, indices: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Row-gather on a var-length column: select rows ``indices`` from
    ``(offsets, values)``.  Returns ``(new_offsets, new_values)``."""
    lens = (offsets[1:] - offsets[:-1])[indices]
    starts = offsets[:-1][indices]
    return gather_var(values, starts, lens)


# --------------------------------------------------------------------------
# dictionary encode
# --------------------------------------------------------------------------

def _empty_encode(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    if n == 0:
        return (np.empty(0, np.int32), np.zeros(1, np.int64),
                np.empty(0, np.uint8))
    # n rows, all of them the empty string: one dictionary entry
    return (np.zeros(n, np.int32), np.zeros(2, np.int64),
            np.empty(0, np.uint8))


#: the padded matrix costs ~2 * n_rows * pad(max_len) bytes; on a
#: length-skewed column (many short rows, one huge outlier) that can
#: dwarf the actual data.  Past BOTH limits the kernels fall back to the
#: per-row path rather than OOM: padded bytes > _SKEW_RATIO x data bytes
#: and > _SKEW_FLOOR absolute.
_SKEW_RATIO = 32
_SKEW_FLOOR = 64 << 20


def _skewed(n: int, lens: np.ndarray) -> bool:
    padded = n * (-(-int(lens.max()) // 8) * 8)
    return padded > _SKEW_FLOOR and \
        padded > _SKEW_RATIO * max(int(lens.sum()), 1)


def _row_bytes(offsets: np.ndarray, values: np.ndarray) -> list:
    """Per-row bytes objects — the skew-fallback reader."""
    return [values[offsets[i]:offsets[i + 1]].tobytes()
            for i in range(len(offsets) - 1)]


def _padded_chunks(offsets: np.ndarray, values: np.ndarray,
                   lens: np.ndarray) -> np.ndarray:
    """Rows zero-padded to a multiple of 8 bytes and packed into
    big-endian uint64 chunks: chunk-tuple comparison == memcmp of the
    padded bytes == bytes-lexicographic order, except that rows
    differing only in trailing NUL padding tie (the caller breaks ties
    with the true length)."""
    n = len(offsets) - 1
    lo, hi = int(offsets[0]), int(offsets[-1])
    window = np.ascontiguousarray(values[lo:hi])
    w = int(lens.max())
    w8 = -(-w // 8) * 8
    mat = np.zeros((n, w8), dtype=np.uint8)
    # rows are adjacent in the values window (offsets are cumulative), so
    # the window itself is already the concatenated row bytes
    if int(lens.min()) == w:
        mat[:, :w] = window.reshape(n, w)
    else:
        mat[np.repeat(np.arange(n, dtype=np.int64), lens),
            ranges(lens)] = window
    return mat.view(">u8").astype(np.uint64)    # native ints, same order


def _lex_order(chunks: np.ndarray, lens: np.ndarray,
               tiebreak: bool) -> np.ndarray:
    """Stable bytes-lexicographic sort permutation from padded chunks;
    ~w/8 integer sort keys instead of w byte keys."""
    keys = [chunks[:, j] for j in range(chunks.shape[1] - 1, -1, -1)]
    if tiebreak:
        keys = [lens] + keys
    return np.lexsort(keys)


def dict_encode_var(offsets: np.ndarray, values: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dictionary-encode a var-length byte column.

    Returns ``(codes int32, uniq_offsets int64, uniq_values uint8)`` where
    the unique values are in bytes-lexicographic order and
    ``uniq[codes[i]] == row i`` — exactly ``np.unique(rows,
    return_inverse=True)`` over the row byte-strings, without building a
    Python object per row.
    """
    offsets = np.asarray(offsets)
    n = len(offsets) - 1
    lens = offsets[1:] - offsets[:-1]
    if n == 0 or int(lens.max(initial=0)) == 0:
        return _empty_encode(n)
    lo, hi = int(offsets[0]), int(offsets[-1])
    window = values[lo:hi]

    if int(lens.min()) == int(lens.max()):
        # fixed-width fast path: rows as an np.void record array; memcmp
        # order == lexicographic order at equal width — one np.unique
        w = int(lens[0])
        mat = np.ascontiguousarray(window).reshape(n, w)
        rows = mat.view(np.dtype((np.void, w))).ravel()
        uniq, codes = np.unique(rows, return_inverse=True)
        uvals = uniq.view(np.uint8).reshape(len(uniq), w).reshape(-1).copy()
        uoff = np.arange(0, (len(uniq) + 1) * w, w, dtype=np.int64)
        return codes.astype(np.int32), uoff, uvals

    if _skewed(n, lens):
        # length-skewed column: the padded matrix would dwarf the data
        rows = _row_bytes(offsets, values)
        uniq = sorted(set(rows))
        index = {s: i for i, s in enumerate(uniq)}
        codes = np.fromiter((index[r] for r in rows), dtype=np.int32,
                            count=n)
        ulens = np.fromiter((len(u) for u in uniq), dtype=np.int64,
                            count=len(uniq))
        uoff = np.zeros(len(uniq) + 1, dtype=np.int64)
        np.cumsum(ulens, out=uoff[1:])
        uvals = np.frombuffer(b"".join(uniq), dtype=np.uint8)
        return codes, uoff, uvals
    # general path: padded big-endian chunks, stable lexicographic sort
    # (prefixes sort before extensions; true length breaks pad ties)
    chunks = _padded_chunks(offsets, values, lens)
    order = _lex_order(chunks, lens, tiebreak=True)
    schunks, slens = chunks[order], lens[order]
    new_group = np.empty(n, dtype=bool)
    new_group[0] = True
    new_group[1:] = (schunks[1:] != schunks[:-1]).any(axis=1) | \
                    (slens[1:] != slens[:-1])
    group = np.cumsum(new_group) - 1
    codes = np.empty(n, dtype=np.int32)
    codes[order] = group.astype(np.int32)
    firsts = order[new_group]           # representative row per unique
    uoff, uvals = gather_var(values, offsets[:-1][firsts], lens[firsts])
    return codes, uoff, uvals


def sort_keys_var(offsets: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Dense int32 lexicographic ranks of a var-length byte column:
    ``np.argsort(sort_keys_var(...), kind='stable')`` == a stable sort by
    row bytes.  Use for *rank* lookups (e.g. dictionary-rank sorting);
    for a direct row sort, ``sort_order_var`` skips the second argsort."""
    codes, _, _ = dict_encode_var(offsets, values)
    return codes


def sort_order_var(offsets: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Stable bytes-lexicographic sort permutation of a var-length byte
    column — one lexsort over packed chunks, no per-row keys and no
    second argsort over ranks."""
    offsets = np.asarray(offsets)
    n = len(offsets) - 1
    lens = offsets[1:] - offsets[:-1]
    if n == 0 or int(lens.max(initial=0)) == 0:
        return np.arange(n, dtype=np.int64)
    if _skewed(n, lens):
        return np.argsort(np.array(_row_bytes(offsets, values),
                                   dtype=object), kind="stable")
    chunks = _padded_chunks(offsets, values, lens)
    fixed = int(lens.min()) == int(lens.max())
    return _lex_order(chunks, lens, tiebreak=not fixed)


# --------------------------------------------------------------------------
# bulk utf8 upper-case
# --------------------------------------------------------------------------

def upper_var(offsets: np.ndarray, values: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Upper-case every row of a utf8 column in bulk.

    Handles the general (non-ASCII) case where byte lengths change
    ('ß' -> 'SS'): the whole values window is decoded once, the uppercase
    mapping is computed per *unique code point* (alphabet-sized, not
    row-sized), and the output bytes are re-assembled with the var-gather
    kernel.  Returns ``(new_offsets, new_values)`` with zero-based
    offsets.  Raises ``UnicodeDecodeError`` on invalid utf8, like the
    per-row decode it replaces.
    """
    offsets = np.asarray(offsets)
    n = len(offsets) - 1
    lo, hi = int(offsets[0]), int(offsets[-1])
    window = np.ascontiguousarray(values[lo:hi])
    if window.size == 0:
        return offsets - lo, np.empty(0, np.uint8)
    text = window.tobytes().decode("utf-8")
    cps = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)
    # character index of every byte -> row boundaries in character space
    is_start = (window & 0xC0) != 0x80
    nchars = np.zeros(len(window) + 1, dtype=np.int64)
    np.cumsum(is_start, out=nchars[1:])
    char_off = nchars[offsets - lo]               # (n+1,) char boundaries
    # per-unique-codepoint uppercase expansion (alphabet-sized loop)
    uniq_cp, inv = np.unique(cps, return_inverse=True)
    upper_bytes = [chr(int(c)).upper().encode("utf-8") for c in uniq_cp]
    ulens = np.fromiter((len(b) for b in upper_bytes), dtype=np.int64,
                        count=len(upper_bytes))
    uoff = np.zeros(len(upper_bytes) + 1, dtype=np.int64)
    np.cumsum(ulens, out=uoff[1:])
    uvals = np.frombuffer(b"".join(upper_bytes), dtype=np.uint8) \
        if upper_bytes else np.empty(0, np.uint8)
    # per-input-character output lengths -> new row offsets + one gather
    clens = ulens[inv]
    ccum = np.zeros(len(cps) + 1, dtype=np.int64)
    np.cumsum(clens, out=ccum[1:])
    new_off = ccum[char_off]
    _, out = gather_var(uvals, uoff[:-1][inv], clens)
    return new_off, out


# --------------------------------------------------------------------------
# bulk hashing (the hash-join key path)
# --------------------------------------------------------------------------

#: one key spec for ``hash_keys``: a fixed-width array, or the
#: (offsets, values) buffer pair of a var-length column
KeyBuf = Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix64(h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, elementwise over a uint64 array."""
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint64(30))
        h = h * np.uint64(0xBF58476D1CE4E5B9)
        h = h ^ (h >> np.uint64(27))
        h = h * np.uint64(0x94D049BB133111EB)
        return h ^ (h >> np.uint64(31))


def hash_fixed(values: np.ndarray) -> np.ndarray:
    """uint64 hash per element of a fixed-width array, from the bit
    pattern.  Float ``-0.0`` is canonicalized to ``+0.0`` first so equal
    values (under ``==``) always hash equal; NaNs hash by bit pattern,
    which is fine because NaN never equals anything."""
    values = np.ascontiguousarray(values)
    if np.issubdtype(values.dtype, np.floating):
        values = np.where(values == 0, 0, values)
    w = values.dtype.itemsize
    bits = np.ascontiguousarray(values).view(f"u{w}").astype(np.uint64) \
        if w < 8 else np.ascontiguousarray(values).view(np.uint64)
    return _mix64(bits ^ _GOLDEN)


def _chunk_salts(m: int) -> np.ndarray:
    """Per-position uint64 salts for the chunk hash (position-keyed, so
    'ab'+'cd' cannot collide with 'cd'+'ab')."""
    with np.errstate(over="ignore"):
        return _mix64((np.arange(m, dtype=np.uint64) + np.uint64(1))
                      * _GOLDEN)


def hash_var(offsets: np.ndarray, values: np.ndarray) -> np.ndarray:
    """uint64 hash per row of a var-length byte column.

    A pure function of the row's bytes: ``mix(mix(len) ^ XOR_j
    mix(chunk_j ^ salt_j))`` over the row's *own* zero-padded big-endian
    uint64 chunks — the XOR runs over exactly ``ceil(len/8)`` positions,
    so the hash is identical across columns of different widths, across
    slices, and across the length-skewed fallback (which computes the
    same formula row by row).  The length seed keeps strings that differ
    only in trailing NULs distinct."""
    offsets = np.asarray(offsets)
    n = len(offsets) - 1
    lens = offsets[1:] - offsets[:-1]
    h = _mix64(lens.astype(np.uint64) ^ _GOLDEN)
    if n == 0 or int(lens.max(initial=0)) == 0:
        # all rows empty: acc is 0 for every row, but the final mix must
        # still run or an empty row here would hash differently from an
        # empty row in a mixed column
        return _mix64(h)
    if _skewed(n, lens):
        acc = np.fromiter(
            (_row_chunk_acc(r) for r in _row_bytes(offsets, values)),
            dtype=np.uint64, count=n)
        return _mix64(h ^ acc)
    chunks = _padded_chunks(offsets, values, lens)
    salts = _chunk_salts(chunks.shape[1])
    nchunks = (lens + 7) // 8
    acc = np.zeros(n, dtype=np.uint64)
    for j in range(chunks.shape[1]):
        term = _mix64(chunks[:, j] ^ salts[j])
        acc ^= np.where(j < nchunks, term, np.uint64(0))
    return _mix64(h ^ acc)


def _row_chunk_acc(row: bytes) -> np.uint64:
    """One row's chunk accumulator (the skew fallback), same formula as
    the vectorized path but over a single row's chunk array."""
    m = -(-len(row) // 8)
    if m == 0:
        return np.uint64(0)
    arr = np.frombuffer(row.ljust(m * 8, b"\0"), dtype=">u8") \
        .astype(np.uint64)
    return np.bitwise_xor.reduce(_mix64(arr ^ _chunk_salts(m)))


def combine_hashes(col_hashes: Sequence[np.ndarray], n: int) -> np.ndarray:
    """Fold per-column uint64 hash arrays into one row hash.
    Order-sensitive: the same columns in a different order hash
    differently.  This is the representation-free half of ``hash_keys``:
    a dict-encoded key column can hash its dictionary once, scatter
    through its codes, and still combine identically to the plain utf8
    column it decodes to."""
    h = np.full(n, _GOLDEN, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for hk in col_hashes:
            h = _mix64(h * _GOLDEN ^ hk)
    return h


def hash_keys(keys: Sequence[KeyBuf], n: int) -> np.ndarray:
    """Combine raw key buffers into one uint64 row hash.  Each key is a
    fixed-width ndarray or an ``(offsets, values)`` pair; ``n`` is the
    row count (needed for the zero-key edge).  ``ops._key_hashes``
    composes the same primitives directly (a dict-encoded key needs a
    hash-the-dictionary-then-scatter step a raw KeyBuf cannot express)
    and must stay hash-identical to this on plain columns."""
    return combine_hashes(
        [hash_var(*k) if isinstance(k, tuple) else hash_fixed(k)
         for k in keys], n)


def hash_join_probe(build_hash: np.ndarray, probe_hash: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Hash-equality candidate pairs between a build and a probe side.

    Sorts the build hashes once (the 'build' phase), then binary-searches
    every probe hash into the sorted order and expands the equal-hash
    runs: returns ``(probe_idx, build_idx)`` int64 index arrays, one
    entry per candidate pair, probe-major with build indices ascending
    within each probe row.  Distinct keys that collide on the 64-bit
    hash survive as candidates — the caller confirms real key equality.
    """
    order = np.argsort(build_hash, kind="stable")
    sh = build_hash[order]
    lo = np.searchsorted(sh, probe_hash, side="left")
    hi = np.searchsorted(sh, probe_hash, side="right")
    counts = hi - lo
    probe_idx = np.repeat(np.arange(len(probe_hash), dtype=np.int64),
                          counts)
    build_pos = np.repeat(lo, counts) + ranges(counts)
    return probe_idx, order[build_pos]


def filter_join_gather(sel: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Compose a filter's row selection with a join's gather indices.

    ``sel`` maps a filtered (or valid-key) domain back to original row
    ids; ``idx`` gathers within that domain, with ``-1`` the left-join
    miss sentinel.  Returns original-domain gather indices with every
    ``-1`` preserved — the fusion step that lets a filter feeding a join
    run as *one* gather over the original columns instead of
    materializing the filtered intermediate table first."""
    sel = np.ascontiguousarray(sel, dtype=np.int64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if (idx >= 0).all():
        return sel[idx]                    # inner join: no sentinels
    out = np.full(len(idx), -1, dtype=np.int64)
    hit = idx >= 0
    out[hit] = sel[idx[hit]]
    return out


def bytes_rows_equal(off_a: np.ndarray, val_a: np.ndarray,
                     off_b: np.ndarray, val_b: np.ndarray) -> np.ndarray:
    """Per-row equality of two equally-long var-length columns: bool[i]
    == (row i of A == row i of B).  Lengths first, then one flat
    gather-and-compare of the equal-length rows (cumulative-sum segment
    reduction, so zero-length rows are handled exactly)."""
    off_a, off_b = np.asarray(off_a), np.asarray(off_b)
    lens_a = off_a[1:] - off_a[:-1]
    eq = lens_a == (off_b[1:] - off_b[:-1])
    idx = np.nonzero(eq)[0]
    if len(idx) == 0:
        return eq
    ga_off, ga = take_var(off_a, val_a, idx)
    _, gb = take_var(off_b, val_b, idx)
    diff = ga != gb
    if diff.any():
        cs = np.zeros(len(diff) + 1, dtype=np.int64)
        np.cumsum(diff, out=cs[1:])
        eq[idx] &= (cs[ga_off[1:]] - cs[ga_off[:-1]]) == 0
    return eq


# --------------------------------------------------------------------------
# group-by: boundary detection + segment reducers
# --------------------------------------------------------------------------

def group_ranges(codes: Sequence[np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Group boundary detection over per-column dense codes.

    ``codes`` is one int array per key column; rows with equal code
    tuples form a group.  Returns ``(order, starts)``: ``order`` is a
    stable sort permutation that makes groups contiguous (primary key =
    ``codes[0]``, so groups come out in ascending code order), and
    ``starts`` marks each group's first position in the sorted order
    (``starts[0] == 0``; group g spans ``order[starts[g]:starts[g+1]]``).
    """
    n = len(codes[0])
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    order = np.lexsort(tuple(reversed([np.asarray(c) for c in codes])))
    new_group = np.zeros(n, dtype=bool)
    new_group[0] = True
    for c in codes:
        sc = np.asarray(c)[order]
        new_group[1:] |= sc[1:] != sc[:-1]
    return order, np.nonzero(new_group)[0]


def _group_ends(starts: np.ndarray, n: int) -> np.ndarray:
    return np.append(starts[1:], n)


def grouped_count(values: np.ndarray, order: np.ndarray,
                  starts: np.ndarray, valid=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group count of non-null rows (``values`` is ignored — the
    signature matches the other reducers for uniform dispatch)."""
    ends = _group_ends(starts, len(order))
    if valid is None:
        counts = (ends - starts).astype(np.int64)
        return counts, counts
    cs = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(valid[order].astype(np.int64), out=cs[1:])
    counts = cs[ends] - cs[starts]
    return counts, counts


def grouped_sum(values: np.ndarray, order: np.ndarray,
                starts: np.ndarray, valid=None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group sum over non-null rows -> (sums, counts).  Integer and
    bool inputs widen to int64 (SQL-style, no narrow-dtype wraparound;
    uint64 stays uint64 — widening to int64 would wrap values >= 2**63)
    and reduce with ``reduceat`` (integer addition is exact in any
    order).  The 64-bit accumulator itself wraps silently — numpy
    semantics — if a group's total exceeds int64/uint64 range; callers
    needing totals beyond 2**63 should aggregate in float.  Float
    inputs widen to float64 and accumulate with
    ``np.bincount``, whose C loop adds row by row in *original row
    order* — bit-identical to a naive left-to-right per-row loop, unlike
    ``reduceat``'s position-dependent SIMD accumulation.  A zero-count
    (all-null) group's sum is meaningless and should be nulled by the
    caller."""
    _, counts = grouped_count(values, order, starts, valid)
    n_groups = len(starts)
    if values.dtype == np.bool_ or np.issubdtype(values.dtype, np.integer):
        acc = np.uint64 if values.dtype == np.uint64 else np.int64
        if n_groups == 0:
            return np.empty(0, acc), counts
        v = values[order].astype(acc)
        if valid is not None:
            v = np.where(valid[order], v, v.dtype.type(0))
        return np.add.reduceat(v, starts), counts
    gid = np.empty(len(order), dtype=np.int64)
    gid[order] = np.repeat(np.arange(n_groups, dtype=np.int64),
                           _group_ends(starts, len(order)) - starts)
    w = values.astype(np.float64, copy=False)
    if valid is not None:
        w = np.where(valid, w, 0.0)
    return np.bincount(gid, weights=w, minlength=n_groups), counts


def _grouped_extreme(values, order, starts, valid, ufunc, sentinel):
    v = values[order]
    if v.dtype == np.bool_:
        v = v.astype(np.uint8)
    if valid is not None:
        v = np.where(valid[order], v, sentinel(v.dtype))
    _, counts = grouped_count(values, order, starts, valid)
    return ufunc.reduceat(v, starts), counts


def _dtype_max(dt):
    return np.inf if np.issubdtype(dt, np.floating) else np.iinfo(dt).max


def _dtype_min(dt):
    return -np.inf if np.issubdtype(dt, np.floating) else np.iinfo(dt).min


def grouped_min(values, order, starts, valid=None):
    """Per-group min over non-null rows -> (mins, counts)."""
    return _grouped_extreme(values, order, starts, valid,
                            np.minimum, _dtype_max)


def grouped_max(values, order, starts, valid=None):
    """Per-group max over non-null rows -> (maxs, counts)."""
    return _grouped_extreme(values, order, starts, valid,
                            np.maximum, _dtype_min)


def grouped_mean(values, order, starts, valid=None):
    """Per-group float64 mean over non-null rows -> (means, counts);
    zero-count groups produce NaN (the caller nulls them).  64-bit
    integer inputs accumulate in float64 (the result is float64 anyway,
    and an exact 64-bit sum could wrap the accumulator)."""
    if np.issubdtype(values.dtype, np.integer) and values.dtype.itemsize == 8:
        values = values.astype(np.float64)
    sums, counts = grouped_sum(values, order, starts, valid)
    with np.errstate(invalid="ignore", divide="ignore"):
        return sums.astype(np.float64) / counts, counts


#: reducer dispatch for ``ops.group_by`` (all share one signature)
GROUPED_REDUCERS = {
    "count": grouped_count, "sum": grouped_sum, "min": grouped_min,
    "max": grouped_max, "mean": grouped_mean,
}
