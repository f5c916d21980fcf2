"""SIPC — Shared Inter-Process Communication (paper §3.2, §4.2.2).

Extends the Arrow IPC protocol: Schema messages are copied to the sink as
usual (small), but RecordBatch and DictionaryBatch payloads are written as
``(file_id, offset, length)`` reference tuples into KernelZero-backed tmpfs
files.  A SIPC stream is therefore tiny: references, not data.

Implements the paper's three write-path techniques:

  * de-anonymization   — anonymous output buffers are transferred (not
                         copied) into per-column store files;
  * IPC inspection +
    resharing          — on write, each outgoing buffer's *physical address
                         range* is checked against the ranges mapped during
                         input reads; a hit emits a reference into the input
                         file instead of de-anonymizing again;
  * dictionary sharing — dictionaries ride through filter/sort by reference
                         even when the code buffers must be copied.

Degrees of copy avoidance (paper Fig 1) are selectable for benchmarking:
    mode='full_copy'    -> B: writer memcpy + reader memcpy
    mode='writer_copy'  -> C: writer memcpy, reader mmap (views)
    mode='zero'         -> D: de-anonymization + resharing (Zerrow)
    mode='zero_noreshare' -> ablation: deanon without IPC inspection

In zero mode every emitted output buffer counts toward
``StoreStats.reshare_hits`` (emitted as a reference — lazy pass-through
or AddressMap hit) or ``reshare_misses`` (de-anonymized); the hit-rate
is the per-buffer copy-avoidance score benchmarks report (e.g. the join
payload-dictionary path in ``benchmarks/bench_join.py``).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .arrow import (ArrowType, Column, RecordBatch, Schema, Table)
from .buffers import BufferStore, Cgroup, LazyBuf, addr_range
from .deanon import KernelZero

MODES = ("full_copy", "writer_copy", "zero", "zero_noreshare")


# --------------------------------------------------------------------------
# physical address interval map (the 'IPC inspection' index)
# --------------------------------------------------------------------------

class AddressMap:
    """Maps virtual-address intervals -> (file_id, file_offset).

    Holds references to the mapped arrays so the address space cannot be
    recycled while the map is alive (prevents false positives)."""

    def __init__(self) -> None:
        self._starts: List[int] = []
        self._entries: List[Tuple[int, int, int, int]] = []  # (start, end, fid, foff)
        self._keep: List[np.ndarray] = []

    def add(self, arr: np.ndarray, file_id: int, file_off: int) -> None:
        if arr.nbytes == 0:
            return
        a, n = addr_range(arr.view(np.uint8).reshape(-1))
        i = bisect.bisect_left(self._starts, a)
        self._starts.insert(i, a)
        self._entries.insert(i, (a, a + n, file_id, file_off))
        self._keep.append(arr)

    def lookup(self, arr: np.ndarray) -> Optional[Tuple[int, int]]:
        """Return (file_id, file_offset) if arr's memory is fully contained
        in a mapped input range."""
        if arr.nbytes == 0 or not arr.flags["C_CONTIGUOUS"]:
            return None
        a, n = addr_range(arr.view(np.uint8).reshape(-1))
        i = bisect.bisect_right(self._starts, a) - 1
        if i < 0:
            return None
        s, e, fid, foff = self._entries[i]
        if a >= s and a + n <= e:
            return fid, foff + (a - s)
        return None

    def merge_from(self, other: "AddressMap") -> None:
        for (s, e, fid, foff), keep in zip(other._entries, other._keep):
            i = bisect.bisect_left(self._starts, s)
            self._starts.insert(i, s)
            self._entries.insert(i, (s, e, fid, foff))
        self._keep.extend(other._keep)


# --------------------------------------------------------------------------
# reference messages (what actually goes over the 'wire')
# --------------------------------------------------------------------------

@dataclass
class BufRef:
    file_id: int
    offset: int
    length: int
    reshared: bool = False


@dataclass
class ColumnRefs:
    type: ArrowType
    length: int
    validity: Optional[BufRef]
    offsets: Optional[BufRef]
    values: BufRef
    dictionary: Optional["ColumnRefs"] = None

    def all_refs(self) -> List[BufRef]:
        out = [r for r in (self.validity, self.offsets, self.values) if r]
        if self.dictionary:
            out += self.dictionary.all_refs()
        return out


@dataclass
class BatchRefs:
    num_rows: int
    columns: List[ColumnRefs]


@dataclass
class SipcMessage:
    """The SIPC 'file': schema bytes (copied) + reference tuples."""
    schema_bytes: bytes
    batches: List[BatchRefs]
    new_bytes: int = 0          # physically new data (deanon'd or copied)
    reshared_bytes: int = 0     # data referenced back to inputs
    _store: Optional[BufferStore] = None
    _pinned: List[int] = field(default_factory=list)
    released: bool = False

    def all_refs(self) -> List[BufRef]:
        return [r for b in self.batches for c in b.columns for r in c.all_refs()]

    def files_referenced(self) -> Dict[int, int]:
        """IPC-inspection product: {file_id: bytes referenced} — what the RM
        needs for share-aware refcounting/GC (paper Challenge 6)."""
        out: Dict[int, int] = {}
        for r in self.all_refs():
            if r.file_id == 0:
                continue                     # canonical empty buffer
            out[r.file_id] = out.get(r.file_id, 0) + r.length
        return out

    def pin(self, store: BufferStore) -> None:
        assert not self._pinned
        self._store = store
        for fid in self.files_referenced():
            store.get(fid).incref()
            self._pinned.append(fid)

    def release(self) -> None:
        if self.released:
            return
        self.released = True
        for fid in self._pinned:
            f = self._store.files.get(fid)
            if f is not None:
                f.decref()
        self._pinned = []

    @property
    def wire_nbytes(self) -> int:
        """Size of the SIPC stream itself: schema + 3 ints per buffer."""
        return len(self.schema_bytes) + 24 * len(self.all_refs())


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

class SipcWriter:
    def __init__(self, store: BufferStore, kz: KernelZero, cgroup: Cgroup,
                 mode: str = "zero", input_map: Optional[AddressMap] = None,
                 label: str = ""):
        assert mode in MODES, mode
        self.store = store
        self.kz = kz
        self.cgroup = cgroup
        self.mode = mode
        self.input_map = input_map
        self.label = label
        self._emitted = AddressMap()   # dedup within one stream (e.g. A ⊕ A)

    def write_table(self, table: Table) -> SipcMessage:
        schema_bytes = bytes(table.schema.to_json_bytes())  # schema is copied
        # one store file per column (+1 for all dictionaries): paper §4.2.2
        col_files = [self.kz.new_file(self.cgroup, f"{self.label}.c{j}")
                     for j in range(table.num_columns)]
        dict_file = None
        msg = SipcMessage(schema_bytes, [])
        for b in table.batches:
            cols = []
            for j, col in enumerate(b.columns):
                if col.type.is_dict and dict_file is None:
                    dict_file = self.kz.new_file(self.cgroup, f"{self.label}.dict")
                cols.append(self._write_column(col, col_files[j], dict_file, msg))
            msg.batches.append(BatchRefs(b.num_rows, cols))
        # empty files (fully reshared columns) are deleted eagerly
        for f in col_files + ([dict_file] if dict_file else []):
            if f is not None and f.length == 0:
                self.store.delete_file(f.file_id)
        msg.pin(self.store)
        return msg

    def _write_column(self, col: Column, file, dict_file, msg: SipcMessage
                      ) -> ColumnRefs:
        # raw (possibly unforced-lazy) buffers: pass-through columns are
        # reshared straight from provenance without faulting any data
        bufs = dict(col.buffers())
        validity = self._emit(bufs["validity"], file, msg) \
            if "validity" in bufs else None
        offsets = self._emit(bufs["offsets"], file, msg) \
            if "offsets" in bufs else None
        values = self._emit(bufs["values"], file, msg)
        dic = None
        if col.dictionary is not None:
            dic = self._write_column(col.dictionary, dict_file, dict_file, msg)
        return ColumnRefs(col.type, col.length, validity, offsets, values, dic)

    def _emit(self, arr, file, msg: SipcMessage) -> BufRef:
        if getattr(arr, "nbytes", None) == 0 or \
                (isinstance(arr, LazyBuf) and arr.length == 0):
            return BufRef(0, 0, 0)           # canonical empty buffer
        if isinstance(arr, LazyBuf):
            if self.mode == "zero" and not arr.forced:
                # pass-through of an unfaulted mapping: reshare straight from
                # provenance — no data is ever touched (true zero copy)
                self.store.stats.bytes_reshared += arr.length
                self.store.stats.reshare_hits += 1
                msg.reshared_bytes += arr.length
                return BufRef(arr.file_id, arr.offset, arr.length,
                              reshared=True)
            arr = arr.force()
        arr = arr if arr.flags["C_CONTIGUOUS"] else np.ascontiguousarray(arr)
        n = arr.nbytes
        if self.mode in ("zero", "zero_noreshare"):
            if self.mode == "zero":
                # IPC inspection: does this buffer's memory live in an input
                # file we mapped (or something we already emitted)?
                hit = (self.input_map.lookup(arr) if self.input_map else None) \
                    or self._emitted.lookup(arr)
                if hit is not None:
                    fid, foff = hit
                    self.store.stats.bytes_reshared += n
                    self.store.stats.reshare_hits += 1
                    msg.reshared_bytes += n
                    return BufRef(fid, foff, n, reshared=True)
                self.store.stats.reshare_misses += 1
            off, _ = self.kz.deanon(file, arr)
            self._emitted.add(arr, file.file_id, off)
            msg.new_bytes += n
            return BufRef(file.file_id, off, n)
        # baseline: writer-side memcpy into the shared file
        off, _ = self.kz.writer_copy(file, arr)
        msg.new_bytes += n
        return BufRef(file.file_id, off, n)


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

class SipcReader:
    def __init__(self, store: BufferStore, mode: str = "zero",
                 record_map: Optional[AddressMap] = None,
                 fault_lock=None):
        assert mode in MODES, mode
        self.store = store
        self.mode = mode
        self.map = record_map if record_map is not None else AddressMap()
        # lock that LazyBuf faults must hold (the executor critical
        # section) when user code runs outside it
        self.fault_lock = fault_lock

    def read_table(self, msg: SipcMessage) -> Table:
        schema = Schema.from_json_bytes(msg.schema_bytes)
        batches = []
        for b in msg.batches:
            cols = [self._read_column(c) for c in b.columns]
            batches.append(RecordBatch(schema, cols))
        return Table(batches)

    def _read_column(self, c: ColumnRefs) -> Column:
        validity = self._mmap(c.validity, "uint8") if c.validity else None
        offsets = self._mmap(c.offsets, "int64") if c.offsets else None
        if c.type.is_utf8:
            values = self._mmap(c.values, "uint8")
        elif c.type.is_dict:
            values = self._mmap(c.values, "int32")
        else:
            values = self._mmap(c.values, c.type.np_dtype)
        dic = self._read_column(c.dictionary) if c.dictionary else None
        return Column(c.type, c.length, values, offsets=offsets,
                      validity=validity, dictionary=dic)

    def _mmap(self, ref: BufRef, np_dtype: str):
        if ref.length == 0:
            return np.empty(0, dtype=np.dtype(np_dtype))
        if self.mode == "full_copy":
            view = self.store.get(ref.file_id).read(ref.offset, ref.length)
            out = view.copy()                     # the reader-side copy
            self.store.stats.bytes_copied += out.nbytes
            return out.view(np.dtype(np_dtype))
        # lazy mapping: data faults in only when compute touches it; on
        # fault, record the mapped range for later resharing by address
        return LazyBuf(self.store, ref.file_id, ref.offset, ref.length,
                       np_dtype, on_force=self._on_force,
                       fault_lock=self.fault_lock)

    def _on_force(self, raw: np.ndarray, file_id: int, offset: int) -> None:
        self.map.add(raw, file_id, offset)
