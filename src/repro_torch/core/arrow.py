"""A minimal-but-real Apache Arrow columnar format (computational layout).

Implements the subset of the Arrow spec Zerrow exercises (paper §2.1):
  * fixed-width primitive arrays (contiguous, indexable values buffer)
  * variable-length utf8 arrays (offsets buffer + values buffer)
  * validity ("null") bitmaps — packed bits, like Arrow
  * dictionary encoding (int32 codes + shared dictionary array)
  * record batches and (chunked) tables

Buffers are plain C-contiguous numpy arrays so that views are zero-copy and
the SIPC layer can track physical identity via virtual addresses.  Unlike
pyarrow, a utf8 array here is allowed to have offsets that do not start at
zero: a row-slice is then pure views (offsets sub-view + the *same* values
buffer), which is what makes slice resharing free (paper Fig 6).

The port's own copy of the JAX package's ``core/arrow.py``; the code is
the same, only this docstring differs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from . import vkernels
from .vkernels import ranges as _ranges  # noqa: F401  (back-compat export)

# --------------------------------------------------------------------------
# types
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ArrowType:
    name: str                                  # 'int64', 'float32', ..., 'utf8', 'dict'
    np_dtype: Optional[str] = None             # numpy dtype str for primitives / codes
    value_type: Optional["ArrowType"] = None   # for dictionary

    @property
    def is_primitive(self) -> bool:
        return self.name not in ("utf8", "dict")

    @property
    def is_utf8(self) -> bool:
        return self.name == "utf8"

    @property
    def is_dict(self) -> bool:
        return self.name == "dict"

    def to_json(self) -> dict:
        d = {"name": self.name}
        if self.np_dtype:
            d["np"] = self.np_dtype
        if self.value_type:
            d["value"] = self.value_type.to_json()
        return d

    @staticmethod
    def from_json(d: dict) -> "ArrowType":
        return ArrowType(d["name"], d.get("np"),
                         ArrowType.from_json(d["value"]) if "value" in d else None)


INT8 = ArrowType("int8", "int8")
INT16 = ArrowType("int16", "int16")
INT32 = ArrowType("int32", "int32")
INT64 = ArrowType("int64", "int64")
UINT8 = ArrowType("uint8", "uint8")
UINT64 = ArrowType("uint64", "uint64")
FLOAT32 = ArrowType("float32", "float32")
FLOAT64 = ArrowType("float64", "float64")
BOOL = ArrowType("bool", "bool")
UTF8 = ArrowType("utf8")


def dict_of(value_type: ArrowType = UTF8) -> ArrowType:
    return ArrowType("dict", "int32", value_type)


_PRIMITIVES = {t.name: t for t in
               (INT8, INT16, INT32, INT64, UINT8, UINT64, FLOAT32, FLOAT64,
                BOOL)}


def type_for_np(dt: np.dtype) -> ArrowType:
    t = _PRIMITIVES.get(np.dtype(dt).name)
    if t is None:
        raise TypeError(f"unsupported numpy dtype {dt}")
    return t


# --------------------------------------------------------------------------
# validity bitmaps
# --------------------------------------------------------------------------

def pack_validity(mask: np.ndarray) -> np.ndarray:
    """bool mask (True = valid) -> packed little-endian bitmap (Arrow rule)."""
    return np.packbits(mask.astype(bool), bitorder="little")


def unpack_validity(bitmap: np.ndarray, length: int) -> np.ndarray:
    return np.unpackbits(bitmap, count=length, bitorder="little").astype(bool)


# --------------------------------------------------------------------------
# columns
# --------------------------------------------------------------------------

class Column:
    """One Arrow array: type + buffers (+ optional dictionary column).

    Buffers may be numpy arrays or unforced ``LazyBuf`` mappings (the
    mmap-fault analogue); accessing ``.values``/``.offsets``/``.validity``
    forces them.  ``raw_*`` accessors expose the unforced handles so SIPC
    can reshare pass-through buffers without touching the data.
    """

    __slots__ = ("type", "length", "_validity", "_values", "_offsets",
                 "dictionary")

    def __init__(self, type: ArrowType, length: int,
                 values,
                 offsets=None,
                 validity=None,
                 dictionary: Optional["Column"] = None):
        self.type = type
        self.length = length
        self._values = values         # primitive values / utf8 bytes / dict codes
        self._offsets = offsets       # utf8 only (int64 offsets, length+1)
        self._validity = validity     # packed bitmap or None (= all valid)
        self.dictionary = dictionary  # dict only

    # -- buffer access (forces lazy mappings) --------------------------------
    @property
    def values(self) -> np.ndarray:
        from .buffers import LazyBuf
        if isinstance(self._values, LazyBuf):
            self._values = self._values.force()
        return self._values

    @property
    def offsets(self) -> Optional[np.ndarray]:
        from .buffers import LazyBuf
        if isinstance(self._offsets, LazyBuf):
            self._offsets = self._offsets.force()
        return self._offsets

    @property
    def validity(self) -> Optional[np.ndarray]:
        from .buffers import LazyBuf
        if isinstance(self._validity, LazyBuf):
            self._validity = self._validity.force()
        return self._validity

    # -- constructors -------------------------------------------------------
    @staticmethod
    def primitive(values: np.ndarray,
                  validity: Optional[np.ndarray] = None) -> "Column":
        values = np.ascontiguousarray(values)
        return Column(type_for_np(values.dtype), len(values), values,
                      validity=validity)

    @staticmethod
    def utf8(offsets, values, validity=None) -> "Column":
        if isinstance(offsets, np.ndarray):
            assert offsets.dtype == np.int64
            n = len(offsets) - 1
        else:
            n = offsets.length // 8 - 1
        return Column(UTF8, n, values, offsets=offsets, validity=validity)

    @staticmethod
    def from_strings(strings: Sequence[Union[str, bytes]],
                     validity: Optional[np.ndarray] = None) -> "Column":
        bs = [s.encode() if isinstance(s, str) else s for s in strings]
        lens = np.fromiter((len(b) for b in bs), dtype=np.int64, count=len(bs))
        offsets = np.zeros(len(bs) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        values = np.frombuffer(b"".join(bs), dtype=np.uint8).copy() \
            if bs else np.empty(0, np.uint8)
        return Column.utf8(offsets, values, validity)

    @staticmethod
    def dictionary_encoded(codes: np.ndarray, dictionary: "Column",
                           validity: Optional[np.ndarray] = None) -> "Column":
        codes = np.ascontiguousarray(codes.astype(np.int32, copy=False))
        return Column(dict_of(dictionary.type), len(codes), codes,
                      validity=validity, dictionary=dictionary)

    # -- buffer enumeration (for SIPC; returns raw, possibly-lazy handles) ---
    def buffers(self) -> List[tuple]:
        """[(buffer_name, ndarray-or-LazyBuf)] in IPC order, unforced."""
        out = []
        if self._validity is not None:
            out.append(("validity", self._validity))
        if self.type.is_utf8:
            out.append(("offsets", self._offsets))
        out.append(("values", self._values))
        return out

    @property
    def nbytes(self) -> int:
        n = self._values.nbytes
        if self._offsets is not None:
            n += self._offsets.nbytes
        if self._validity is not None:
            n += self._validity.nbytes
        if self.dictionary is not None:
            n += self.dictionary.nbytes
        return n

    # -- access --------------------------------------------------------------
    def valid_mask(self) -> np.ndarray:
        if self.validity is None:
            return np.ones(self.length, dtype=bool)
        return unpack_validity(self.validity, self.length)

    def get_bytes(self, i: int) -> bytes:
        assert self.type.is_utf8
        return self.values[self.offsets[i]:self.offsets[i + 1]].tobytes()

    def to_numpy(self) -> np.ndarray:
        if self.type.is_primitive:
            return self.values
        if self.type.is_dict and self.dictionary.type.is_primitive:
            return self.dictionary.values[self.values]
        raise TypeError("to_numpy on non-primitive column")

    def decode_dictionary(self) -> "Column":
        """Materialize a dict column back to its plain representation."""
        assert self.type.is_dict
        d = self.dictionary
        if d.type.is_primitive:
            return Column.primitive(d.values[self.values], self.validity)
        # utf8 dictionary: vectorized var-length gather (vkernels.take_var)
        new_off, out = vkernels.take_var(d.offsets, d.values, self.values)
        return Column.utf8(new_off, out, self.validity)

    # -- slicing (pure views / lazy subranges; the reshare-friendly path) ---
    def slice(self, start: int, stop: int) -> "Column":
        from .buffers import LazyBuf
        start = max(0, min(start, self.length))
        stop = max(start, min(stop, self.length))
        validity = None
        if self._validity is not None:
            validity = pack_validity(self.valid_mask()[start:stop])
        if self.type.is_utf8:
            # offsets sub-view + the SAME (possibly unfaulted) values buffer
            if isinstance(self._offsets, LazyBuf):
                offs = self._offsets.subrange(start * 8,
                                              (stop - start + 1) * 8, "int64")
            else:
                offs = self._offsets[start:stop + 1]
            return Column(UTF8, stop - start, self._values,
                          offsets=offs, validity=validity)
        isz = np.dtype(self.type.np_dtype).itemsize
        if isinstance(self._values, LazyBuf):
            vals = self._values.subrange(start * isz, (stop - start) * isz,
                                         self.type.np_dtype)
        else:
            vals = self._values[start:stop]
        return Column(self.type, stop - start, vals,
                      validity=validity, dictionary=self.dictionary)

    def take(self, indices: np.ndarray) -> "Column":
        """Row gather — the materializing op (filter/sort fall back to this)."""
        validity = None
        if self.validity is not None:
            validity = pack_validity(self.valid_mask()[indices])
        if self.type.is_dict:
            # dictionary sharing: codes copied, dictionary passed by reference
            return Column(self.type, len(indices), self.values[indices],
                          validity=validity, dictionary=self.dictionary)
        if self.type.is_utf8:
            # vectorized gather of variable-length rows
            new_off, out = vkernels.take_var(self.offsets, self.values,
                                             indices)
            return Column.utf8(new_off, out, validity)
        return Column(self.type, len(indices), self.values[indices],
                      validity=validity)

    def take_nullable(self, indices: np.ndarray) -> "Column":
        """Row gather where ``indices`` may contain -1: those output rows
        are null (the left-join miss gather).  Dictionary buffers still
        pass through by reference."""
        indices = np.asarray(indices, dtype=np.int64)
        miss = indices < 0
        if not miss.any():
            return self.take(indices)
        if self.length == 0:
            return _null_column(self.type, len(indices), self.dictionary)
        safe = np.where(miss, 0, indices)
        if self.type.is_utf8:
            # miss rows gather zero bytes — clamping the index alone
            # would copy row 0's payload once per miss
            off = self.offsets
            starts = off[:-1][safe]
            lens = np.where(miss, 0, off[1:][safe] - starts)
            new_off, vals = vkernels.gather_var(self.values, starts, lens)
            vm = self.valid_mask()[safe]
            vm[miss] = False
            return Column.utf8(new_off, vals, validity=pack_validity(vm))
        out = self.take(safe)
        vm = out.valid_mask()
        vm[miss] = False
        return Column(out.type, out.length, out._values,
                      offsets=out._offsets, validity=pack_validity(vm),
                      dictionary=out.dictionary)

    # -- equality (logical, for tests) --------------------------------------
    def equals(self, other: "Column") -> bool:
        if self.length != other.length:
            return False
        ms, mo = self.valid_mask(), other.valid_mask()
        if not np.array_equal(ms, mo):
            return False
        a, b = self._logical(), other._logical()
        if a.dtype != b.dtype or a.shape != b.shape:
            # utf8 compare elementwise below
            pass
        if self._kindof() != other._kindof():
            return False
        if self._kindof() == "utf8":
            idx = np.nonzero(ms)[0]
            off_a, val_a = self._logical_var(idx)
            off_b, val_b = other._logical_var(idx)
            return bool(np.array_equal(off_a, off_b) and
                        np.array_equal(val_a, val_b))
        return bool(np.array_equal(a[ms], b[mo]))

    def _kindof(self) -> str:
        t = self.type.value_type if self.type.is_dict else self.type
        return "utf8" if t.is_utf8 else "prim"

    def _logical(self) -> np.ndarray:
        if self.type.is_primitive:
            return self.values
        if self.type.is_dict and self.dictionary.type.is_primitive:
            return self.dictionary.values[self.values]
        return self.values  # utf8: compared via _get_logical_bytes

    def _get_logical_bytes(self, i: int) -> bytes:
        if self.type.is_utf8:
            return self.get_bytes(i)
        assert self.type.is_dict and self.dictionary.type.is_utf8
        return self.dictionary.get_bytes(int(self.values[i]))

    def _logical_var(self, indices: np.ndarray):
        """(offsets, flat bytes) of the selected rows' logical byte
        strings — one var-gather, no per-row Python."""
        if self.type.is_utf8:
            return vkernels.take_var(self.offsets, self.values, indices)
        assert self.type.is_dict and self.dictionary.type.is_utf8
        d = self.dictionary
        return vkernels.take_var(d.offsets, d.values, self.values[indices])


def _null_column(t: ArrowType, n: int,
                 dictionary: Optional[Column] = None) -> Column:
    """An all-null column of ``n`` rows (every left-join miss against an
    empty build side).  Values are zeros; the validity bitmap is all 0."""
    validity = pack_validity(np.zeros(n, dtype=bool))
    if t.is_utf8:
        return Column.utf8(np.zeros(n + 1, np.int64),
                           np.empty(0, np.uint8), validity)
    values = np.zeros(n, dtype=np.dtype(t.np_dtype))
    if t.is_dict:
        if dictionary is None or dictionary.length == 0:
            # codes must index a real dictionary row even when never read
            dictionary = Column.from_strings([b""]) \
                if t.value_type.is_utf8 else \
                Column.primitive(np.zeros(1, np.dtype(t.value_type.np_dtype)))
        return Column(t, n, values, validity=validity,
                      dictionary=dictionary)
    return Column(t, n, values, validity=validity)


# --------------------------------------------------------------------------
# schema / record batch / table
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Field:
    name: str
    type: ArrowType


class Schema:
    def __init__(self, fields: Sequence[Field]):
        self.fields = list(fields)
        self._index = {f.name: i for i, f in enumerate(self.fields)}

    def __len__(self) -> int:
        return len(self.fields)

    def index(self, name: str) -> int:
        return self._index[name]

    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def to_json_bytes(self) -> bytes:
        return json.dumps([{"name": f.name, "type": f.type.to_json()}
                           for f in self.fields]).encode()

    @staticmethod
    def from_json_bytes(b: bytes) -> "Schema":
        return Schema([Field(d["name"], ArrowType.from_json(d["type"]))
                       for d in json.loads(b.decode())])

    def equals(self, other: "Schema") -> bool:
        return [(f.name, f.type) for f in self.fields] == \
               [(f.name, f.type) for f in other.fields]


class RecordBatch:
    def __init__(self, schema: Schema, columns: Sequence[Column]):
        assert len(schema) == len(columns)
        ns = {c.length for c in columns}
        assert len(ns) <= 1, f"ragged batch: {ns}"
        self.schema = schema
        self.columns = list(columns)
        self.num_rows = columns[0].length if columns else 0

    def column(self, name: str) -> Column:
        return self.columns[self.schema.index(name)]

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns)


class Table:
    """A chunked table: list of record batches with a common schema.

    Chunking is what makes ``concat`` zero-copy (multiple record batches in
    one IPC stream — paper Fig 6 'concat costs only the additional data')."""

    def __init__(self, batches: Sequence[RecordBatch]):
        assert batches, "Table needs >= 1 batch (may be 0-row)"
        self.batches = list(batches)
        self.schema = batches[0].schema
        for b in batches[1:]:
            assert b.schema.equals(self.schema), "schema mismatch across batches"

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_batch(schema: Schema, columns: Sequence[Column]) -> "Table":
        return Table([RecordBatch(schema, columns)])

    @staticmethod
    def from_pydict(d: Dict[str, object]) -> "Table":
        fields, cols = [], []
        for name, v in d.items():
            if isinstance(v, Column):
                col = v
            elif isinstance(v, np.ndarray):
                col = Column.primitive(v)
            else:
                v = list(v)
                if v and isinstance(v[0], (str, bytes)):
                    col = Column.from_strings(v)
                else:
                    col = Column.primitive(np.asarray(v))
            fields.append(Field(name, col.type))
            cols.append(col)
        return Table.from_batch(Schema(fields), cols)

    # -- info ----------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return sum(b.num_rows for b in self.batches)

    @property
    def num_columns(self) -> int:
        return len(self.schema)

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.batches)

    def column_chunks(self, name: str) -> List[Column]:
        return [b.column(name) for b in self.batches]

    # -- materialization -------------------------------------------------------
    def combine(self) -> "Table":
        """Concatenate batches into one (materializes: real copies)."""
        if len(self.batches) == 1:
            return self
        cols = []
        for j, f in enumerate(self.schema.fields):
            chunks = [b.columns[j] for b in self.batches]
            cols.append(_concat_columns(chunks))
        return Table.from_batch(self.schema, cols)

    def to_pydict(self) -> Dict[str, list]:
        t = self.combine()
        out: Dict[str, list] = {}
        for f, c in zip(t.schema.fields, t.batches[0].columns):
            mask = c.valid_mask()
            if c._kindof() == "utf8":
                vals = [c._get_logical_bytes(i).decode() if mask[i] else None
                        for i in range(c.length)]
            else:
                lv = c._logical()
                vals = [lv[i].item() if mask[i] else None
                        for i in range(c.length)]
            out[f.name] = vals
        return out

    def equals(self, other: "Table") -> bool:
        if not self.schema.equals(other.schema):
            return False
        if self.num_rows != other.num_rows:
            return False
        a, b = self.combine(), other.combine()
        return all(ca.equals(cb) for ca, cb in
                   zip(a.batches[0].columns, b.batches[0].columns))


def _concat_columns(chunks: List[Column]) -> Column:
    t = chunks[0].type
    validity = None
    if any(c.validity is not None for c in chunks):
        validity = pack_validity(
            np.concatenate([c.valid_mask() for c in chunks]))
    if t.is_utf8:
        vals, offs, base = [], [np.zeros(1, np.int64)], 0
        for c in chunks:
            lo, hi = int(c.offsets[0]), int(c.offsets[-1])
            vals.append(c.values[lo:hi])
            offs.append(c.offsets[1:] - lo + base)
            base += hi - lo
        return Column.utf8(np.concatenate(offs),
                           np.concatenate(vals) if vals else np.empty(0, np.uint8),
                           validity)
    if t.is_dict:
        # re-encode against the first dictionary if they are identical objects,
        # else decode+concat (correctness first)
        d0 = chunks[0].dictionary
        if all(c.dictionary is d0 for c in chunks):
            return Column(t, sum(c.length for c in chunks),
                          np.concatenate([c.values for c in chunks]),
                          validity=validity, dictionary=d0)
        return _concat_columns([c.decode_dictionary() for c in chunks])
    return Column(t, sum(c.length for c in chunks),
                  np.concatenate([c.values for c in chunks]),
                  validity=validity)
