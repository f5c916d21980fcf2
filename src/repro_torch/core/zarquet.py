"""zarquet — the on-disk columnar source format (Parquet stand-in).

pyarrow is unavailable offline, so Zerrow's sources are 'zarquet' files:
compressed column chunks with a JSON footer, keeping the Parquet
properties the paper relies on:
  * compressed on disk, uncompressed Arrow in memory (deserialization is
    real decompression work, parallelizable per column — paper Fig 2);
  * ``read_table(..., dict_columns=...)`` mirrors PyArrow's
    ``read_dictionary=`` argument: chosen utf8 columns are deserialized
    straight into dictionary encoding (paper §4.2.4);
  * ``read_table(..., columns=...)`` mirrors Parquet readers' column
    selection: unselected columns are never read or decompressed — the
    hook the plan optimizer's projection pruning bottoms out on
    (``core/plan/``: unused columns never get deanonymized because they
    are never loaded at all).

zstd is preferred when the ``zstandard`` package is installed; otherwise
stdlib ``zlib`` is used.  The codec is recorded in the footer, so files
written with either codec read back on any environment that has the
matching decompressor.  Both codecs release the GIL while (de)compressing,
which is what lets the worker-pool executor overlap deserialization
across loader nodes — and, within one ``read_table``, lets the reader
pool fan column-chunk decompression out across threads (the paper's
"real deserialization work, parallelizable per column", Fig 2).

Decompression is copy-free: each blob is decompressed *directly into*
the allocator-provided page-aligned destination buffer (zstd stream
``readinto``; chunked ``zlib.decompressobj`` writes into the destination
memoryview) instead of materializing an intermediate full-size ``bytes``
and memcpy-ing it over.

Batch layout:  [MAGIC][buffer blob .... ][footer json][footer_len u64][MAGIC]

Stream layout (``StreamWriter``) generalizes this to append-only *row
groups*: every commit appends the new groups' blobs plus a fresh footer
describing **all** groups, then atomically advances a sidecar commit
pointer (``<path>.commit``).  Superseded footers stay behind as dead
bytes — committed blob extents are immutable, so readers that mapped an
older version keep working, and a crash mid-append is invisible (the
pointer still names the previous durable footer; reopening truncates
the torn tail and the producer re-sends unACKed batches —
at-least-once).  Stream footers carry ``version`` (monotonic) and
``groups`` (per-group column metadata + a content hash that
``core/fingerprint.py`` uses so an append invalidates only consumers of
the new tail).
"""

from __future__ import annotations

import binascii
import hashlib
import io
import json
import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

try:
    import zstandard
except ImportError:                       # clean environment: stdlib only
    zstandard = None

from . import faultplane, vkernels
from .arrow import (ArrowType, Column, Field, RecordBatch, Schema, Table,
                    UTF8)
from .buffers import alloc_aligned

MAGIC = b"ZQ01"
DEFAULT_CODEC = "zstd" if zstandard is not None else "zlib"

#: zlib copy-free path decompresses in bounded chunks into the destination
_ZLIB_CHUNK = 1 << 20

#: below this much uncompressed data a reader pool costs more than it
#: saves (thread spin-up vs sub-ms decompression) — stay serial
_PARALLEL_MIN_BYTES = 1 << 20


def _default_readers() -> int:
    """Reader-pool width for one read_table call (per-column-chunk
    decompression fan-out): env ZERROW_READER_THREADS, else
    min(4, cpu count).  The codecs release the GIL, so this is real
    parallelism even under the thread executor."""
    env = os.environ.get("ZERROW_READER_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(4, os.cpu_count() or 1))


def _comp(data: np.ndarray, level: int, codec: str = DEFAULT_CODEC) -> bytes:
    raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1).tobytes()
    if codec == "zstd":
        return zstandard.ZstdCompressor(level=level).compress(raw)
    return zlib.compress(raw, level)


def _require_zstd() -> None:
    if zstandard is None:
        raise RuntimeError(
            "zarquet file was written with zstd but the 'zstandard' "
            "package is not installed; rewrite the source with the "
            "zlib codec or install zstandard")


def _decomp_into(blob: bytes, dest: np.ndarray, codec: str) -> None:
    """Decompress ``blob`` directly into ``dest`` (uint8, exactly the
    uncompressed length) — no intermediate full-size ``bytes`` object."""
    mv = memoryview(dest)
    rlen = len(mv)
    if codec == "zstd":
        _require_zstd()
        reader = zstandard.ZstdDecompressor().stream_reader(io.BytesIO(blob))
        if not hasattr(reader, "readinto"):
            # very old zstandard without stream readinto: one-shot with
            # the intermediate copy (correctness over copy-freedom)
            raw = zstandard.ZstdDecompressor().decompress(
                blob, max_output_size=rlen)
            if len(raw) != rlen:
                raise ValueError(
                    f"zarquet: zstd buffer decompressed to an unexpected "
                    f"size (got {len(raw)}, want {rlen})")
            mv[:] = raw
            return
        pos = 0
        while pos < rlen:
            k = reader.readinto(mv[pos:])
            if k == 0:
                break
            pos += k
        if pos != rlen or reader.read(1):
            raise ValueError(
                f"zarquet: zstd buffer decompressed to an unexpected size "
                f"(got {pos}, want {rlen})")
        return
    # feed the input in bounded slices: decompressobj returns the
    # not-yet-consumed input as a fresh bytes object on every capped
    # call, so capping output against the *whole* blob would re-copy an
    # O(blob) tail per chunk — bounding the fed slice bounds that re-copy
    d = zlib.decompressobj()
    src = memoryview(blob)
    pos = 0
    for a in range(0, max(len(src), 1), _ZLIB_CHUNK):
        data = src[a:a + _ZLIB_CHUNK]
        while True:
            remaining = rlen - pos
            chunk = d.decompress(data, min(remaining, _ZLIB_CHUNK)
                                 if remaining else 1)
            if chunk:
                if len(chunk) > remaining:
                    raise ValueError("zarquet: zlib buffer decompressed "
                                     "past the destination size")
                mv[pos:pos + len(chunk)] = chunk
                pos += len(chunk)
            data = d.unconsumed_tail
            if not data:
                break
        if d.eof:
            break
    tail = d.flush()
    if tail:
        if len(tail) > rlen - pos:
            raise ValueError("zarquet: zlib buffer decompressed past the "
                             "destination size")
        mv[pos:pos + len(tail)] = tail
        pos += len(tail)
    if pos != rlen:
        raise ValueError(
            f"zarquet: zlib buffer decompressed to an unexpected size "
            f"(got {pos}, want {rlen})")


def _encode_group(b, level: int, codec: str, off: int,
                  with_hash: bool = False):
    """Compress one RecordBatch into blobs + column metadata starting at
    file offset ``off``.  ``with_hash`` additionally computes the group's
    content hash: sha256 over the *uncompressed* stored representation
    (column names, types, buffer names and raw bytes), so group identity
    is codec- and placement-independent."""
    blobs: List[bytes] = []
    cols_meta = []
    d = hashlib.sha256() if with_hash else None
    for f, c in zip(b.schema.fields, b.columns):
        if c.type.is_dict:
            c = c.decode_dictionary()       # store plain; re-encode at read
        bufs_meta = []
        if d is not None:
            d.update(json.dumps([f.name, c.type.to_json(),
                                 c.length]).encode())
        for bname, arr in c.buffers():
            raw = np.ascontiguousarray(arr)
            if d is not None:
                d.update(bname.encode())
                d.update(raw.view(np.uint8).reshape(-1).data)
            blob = _comp(raw, level, codec)
            bufs_meta.append({"name": bname, "off": off, "clen": len(blob),
                              "rlen": raw.nbytes, "np": str(raw.dtype)})
            blobs.append(blob)
            off += len(blob)
        cols_meta.append({"name": f.name,
                          "type": (c.type.to_json()),
                          "nrows": c.length,
                          "buffers": bufs_meta})
    return blobs, cols_meta, (d.hexdigest() if d is not None else None), off


def write_table(path: str, table: Table, level: int = 1,
                codec: str = DEFAULT_CODEC) -> None:
    if codec == "zstd" and zstandard is None:
        raise RuntimeError("zstd codec requested but 'zstandard' is not "
                           "installed")
    t = table.combine()
    b = t.batches[0]
    blobs, cols_meta, _, _ = _encode_group(b, level, codec, len(MAGIC))
    footer = json.dumps({"columns": cols_meta, "nrows": b.num_rows,
                         "codec": codec}).encode()
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        for blob in blobs:
            fh.write(blob)
        fh.write(footer)
        fh.write(struct.pack("<Q", len(footer)))
        fh.write(MAGIC)


def _commit_path(path: str) -> str:
    return path + ".commit"


def _read_commit_pointer(path: str) -> Optional[dict]:
    """Parse the sidecar commit pointer; ``None`` when absent/corrupt
    (fall back to the physical tail — correct for quiescent files)."""
    try:
        with open(_commit_path(path), "rb") as fh:
            ptr = json.loads(fh.read().decode())
        body = f"{ptr['end']}:{ptr['version']}".encode()
        if ptr.get("crc") != (binascii.crc32(body) & 0xFFFFFFFF):
            return None
        return ptr
    except (OSError, ValueError, KeyError):
        return None


#: StreamWriter commit fault points, in execution order (the stream
#: analog of manifest.CRASH_POINTS; see tests/test_faultplane.py)
STREAM_CRASH_POINTS = ("stream_pre_blob", "stream_torn_blob",
                       "stream_pre_footer", "stream_torn_footer",
                       "stream_pre_sidecar", "stream_torn_sidecar",
                       "stream_post_commit")

faultplane.register_hook("stream_pre_blob", "StreamWriter flush: before "
                         "the first row-group blob write")
faultplane.register_hook("stream_torn_blob", "StreamWriter flush: half a "
                         "row-group blob written, then SIGKILL")
faultplane.register_hook("stream_pre_footer", "StreamWriter commit: blobs "
                         "written, before the footer")
faultplane.register_hook("stream_torn_footer", "StreamWriter commit: half "
                         "the footer written, then SIGKILL")
faultplane.register_hook("stream_pre_sidecar", "StreamWriter commit: "
                         "footer fsync'd, before the sidecar pointer")
faultplane.register_hook("stream_torn_sidecar", "StreamWriter commit: "
                         "sidecar tmp fsync'd, SIGKILL before os.replace")
faultplane.register_hook("stream_post_commit", "StreamWriter commit: "
                         "pointer replaced (batch durably committed)")


def _write_commit_pointer(path: str, end: int, version: int,
                          sync: bool = True) -> None:
    """Atomically advance the commit pointer (tmp + ``os.replace``):
    readers see either the previous durable footer or the new one,
    never a torn tail."""
    body = f"{end}:{version}".encode()
    ptr = json.dumps({"end": end, "version": version,
                      "crc": binascii.crc32(body) & 0xFFFFFFFF}).encode()
    tmp = _commit_path(path) + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(ptr)
        fh.flush()
        if sync:
            os.fsync(fh.fileno())
    if faultplane.fire("stream_torn_sidecar") == "torn":
        faultplane.kill()       # tmp durable, pointer not replaced: the
                                # reader must still see the OLD commit
    os.replace(tmp, _commit_path(path))
    faultplane.fire("stream_post_commit")


def committed_end(path: str) -> int:
    """Byte offset just past the last durably committed footer: the
    commit pointer when a valid sidecar exists (stream files), else the
    physical file size (batch files / quiescent streams)."""
    ptr = _read_commit_pointer(path)
    if ptr is not None:
        return int(ptr["end"])
    return os.path.getsize(path)


def read_footer(path: str) -> dict:
    """Read the footer of a batch or stream zarquet file.

    Stream footers (``"groups"`` present) are normalized so batch-era
    consumers keep working: ``meta["columns"]`` mirrors the schema of the
    first group (all groups share it) and ``meta["nrows"]`` is the total
    across groups.  For stream files the *committed* footer is read (the
    sidecar pointer names it), so an in-progress or torn append is never
    observed."""
    end = committed_end(path)
    with open(path, "rb") as fh:
        fh.seek(end - 12)
        tail = fh.read(12)
        assert tail[-4:] == MAGIC, "not a zarquet file"
        (flen,) = struct.unpack("<Q", tail[:8])
        fh.seek(end - 12 - flen)
        meta = json.loads(fh.read(flen).decode())
    groups = meta.get("groups")
    if groups is not None and "columns" not in meta:
        meta["columns"] = groups[0]["columns"] if groups else []
    return meta


def read_table(path: str, dict_columns: Sequence[str] = (),
               allocator: Callable[[int], np.ndarray] = alloc_aligned,
               on_buffer: Optional[Callable[[np.ndarray], None]] = None,
               reader_threads: Optional[int] = None,
               columns: Optional[Sequence[str]] = None,
               row_groups: Optional[Sequence[int]] = None) -> Table:
    """Deserialize to Arrow.  ``allocator`` controls where uncompressed
    buffers land (page-aligned by default: the de-anonymization fast path).
    ``on_buffer`` lets the share wrapper register each fresh buffer as
    sandbox-charged anonymous memory.

    ``reader_threads`` fans per-buffer decompression out across a small
    thread pool (the codecs release the GIL) — per-column parallel
    deserialization within a single source; ``None`` = auto, ``<= 1`` =
    serial.  Allocation, ``on_buffer`` callbacks and column assembly all
    stay on the calling thread, in footer order, so the
    allocator/on_buffer contract is unchanged; only the GIL-free
    decompress-into step runs on pool threads.

    ``columns`` restricts the read to a subset of columns (projection
    pushdown, mirroring Parquet readers' ``columns=``): unselected
    columns are never read, decompressed or allocated — their bytes stay
    on disk.  Output column order is footer order restricted to the
    selection (order of the ``columns`` sequence itself is irrelevant);
    unknown names raise ``KeyError``.

    ``row_groups`` restricts a *stream* file read to a subset of its
    committed row groups (indices into the footer's ``groups`` list, in
    the given order); unselected groups' bytes stay on disk.  The result
    is one RecordBatch per selected group — callers that need a single
    contiguous batch ``combine()``.  Batch files are a single group 0."""
    meta = read_footer(path)
    codec = meta.get("codec", "zstd")   # pre-codec files were always zstd
    dict_set = set(dict_columns)
    groups = meta.get("groups")
    if groups is None:
        groups = [{"columns": meta["columns"], "nrows": meta["nrows"]}]
    if row_groups is not None:
        bad = [g for g in row_groups if not 0 <= g < len(groups)]
        if bad:
            raise IndexError(
                f"zarquet {path}: no such row group(s) {bad} "
                f"(file has {len(groups)})")
        groups = [groups[g] for g in row_groups]
    if not groups:
        raise ValueError(f"zarquet {path}: stream has no committed row "
                         f"groups yet")
    per_group: List[list] = []          # selected cols_meta per group
    for gi, grp in enumerate(groups):
        cols_meta = grp["columns"]
        if columns is not None:
            want = set(columns)
            missing = want - {cm["name"] for cm in cols_meta}
            if missing:
                raise KeyError(f"zarquet {path}: no such column(s) "
                               f"{sorted(missing)}")
            cols_meta = [cm for cm in cols_meta if cm["name"] in want]
            if not cols_meta:
                raise KeyError(f"zarquet {path}: empty column selection")
        per_group.append(cols_meta)
    # 1) allocate destinations + record blob extents (group, footer order)
    spans: List[tuple] = []             # (file_off, clen) per buffer
    dests: List[np.ndarray] = []
    for cols_meta in per_group:
        for cm in cols_meta:
            for bm in cm["buffers"]:
                spans.append((bm["off"], bm["clen"]))
                dests.append(allocator(bm["rlen"]))
    # 2) decompress directly into the destinations, in parallel — one
    # pool across every selected group.  Blobs are read per job and
    # dropped as soon as they are consumed, so peak memory is
    # destinations + the in-flight blobs, never + the whole compressed
    # file
    n_threads = reader_threads if reader_threads is not None \
        else _default_readers()
    jobs = [i for i, d in enumerate(dests) if d.nbytes]
    total = sum(dests[i].nbytes for i in jobs)
    with open(path, "rb") as fh:
        io_lock = threading.Lock()

        def _decomp_job(i: int) -> None:
            off, clen = spans[i]
            with io_lock:
                fh.seek(off)
                blob = fh.read(clen)
            _decomp_into(blob, dests[i], codec)

        if n_threads > 1 and len(jobs) > 1 and total >= _PARALLEL_MIN_BYTES:
            with ThreadPoolExecutor(min(n_threads, len(jobs))) as pool:
                list(pool.map(_decomp_job, jobs))
        else:
            for i in jobs:
                _decomp_job(i)
    # 3) register buffers + assemble columns (calling thread, footer
    # order within each group; one RecordBatch per group)
    batches: List[RecordBatch] = []
    it = iter(dests)
    for cols_meta in per_group:
        fields, cols = [], []
        for cm in cols_meta:
            bufs: Dict[str, np.ndarray] = {}
            for bm in cm["buffers"]:
                out = next(it)
                if on_buffer is not None:
                    on_buffer(out)
                bufs[bm["name"]] = out.view(np.dtype(bm["np"]))
            t = ArrowType.from_json(cm["type"])
            validity = bufs.get("validity")
            if t.is_utf8:
                col = Column.utf8(bufs["offsets"].view(np.int64),
                                  bufs["values"].view(np.uint8), validity)
                if cm["name"] in dict_set:
                    col = _dict_encode_col(col, allocator, on_buffer)
            else:
                col = Column(t, cm["nrows"],
                             bufs["values"].view(np.dtype(t.np_dtype)),
                             validity=validity)
            fields.append(Field(cm["name"], col.type))
            cols.append(col)
        batches.append(RecordBatch(Schema(fields), cols))
    return Table(batches)


def _dict_encode_col(col: Column, allocator, on_buffer) -> Column:
    """Deserialize-with-dictionary: unique strings -> dictionary column
    (vectorized: vkernels.dict_encode_var, no per-row Python)."""
    codes, uoff, uvals = vkernels.dict_encode_var(col.offsets, col.values)
    # build dictionary buffers through the allocator (they are outputs too)
    values = allocator(uvals.nbytes)
    values[:] = uvals
    offsets = allocator(uoff.nbytes).view(np.int64)
    offsets[:] = uoff
    codes_buf = allocator(codes.size * 4).view(np.int32)
    codes_buf[:] = codes
    for a in (values, offsets, codes_buf):
        if on_buffer is not None:
            on_buffer(a)
    dic = Column.utf8(offsets, values)
    return Column.dictionary_encoded(codes_buf, dic, validity=col.validity)


# --------------------------------------------------------------------------
# streaming ingest (append-oriented micro-batch writer)
# --------------------------------------------------------------------------

class StreamWriter:
    """Append-oriented zarquet writer: micro-batches in, row groups out.

    Lifecycle (the Zerobus ingest shape): open/create the stream →
    ``ingest()`` micro-batches (buffered; a bounded in-flight window of
    ``max_inflight`` unACKed batches triggers an automatic commit) →
    ``flush()`` to force a commit → ``close()``.  A commit appends one
    row group per pending micro-batch, writes a fresh footer describing
    all groups with a monotonically increasing ``version``, fsyncs, and
    only then advances the sidecar commit pointer — the durability
    point.  Every micro-batch in the commit is then ACKed (sequence
    numbers via ``poll_acks()`` and/or the ``on_ack`` callback).

    Delivery is at-least-once: a batch whose ACK was observed is durable
    and will never be lost; a crash before the pointer advanced leaves a
    torn tail that reopening truncates, and the producer re-sends
    whatever it never saw ACKed.  Committed group extents are immutable,
    so concurrent readers of older versions are undisturbed and
    per-group content hashes stay valid forever.
    """

    def __init__(self, path: str, level: int = 1,
                 codec: str = DEFAULT_CODEC, max_inflight: int = 8,
                 sync: bool = True,
                 on_ack: Optional[Callable[[List[int], int], None]] = None):
        if codec == "zstd" and zstandard is None:
            raise RuntimeError("zstd codec requested but 'zstandard' is "
                               "not installed")
        self.path = path
        self.level = level
        self.codec = codec
        self.max_inflight = max(1, int(max_inflight))
        self.sync = sync
        self.on_ack = on_ack
        self._lock = threading.Lock()
        self._pending: List[tuple] = []         # (seq, combined batch)
        self._acked: List[int] = []
        self._next_seq = 0
        self._names: Optional[List[str]] = None
        self._groups: List[dict] = []
        self._nrows = 0
        if os.path.exists(path) and os.path.getsize(path) > len(MAGIC):
            self._recover()
        else:
            self.version = 0
            self._fh = open(path, "wb")
            self._fh.write(MAGIC)
            self._end = len(MAGIC)
            self._commit_footer()               # v0: readable when empty

    def _recover(self) -> None:
        """Reopen an existing stream for append: honor the commit
        pointer, drop any torn tail past it, resume at the committed
        version."""
        try:
            meta = read_footer(self.path)
        except (AssertionError, ValueError, KeyError, struct.error):
            if _read_commit_pointer(self.path) is not None:
                raise
            # torn during the *first* footer write, before any sidecar
            # pointer existed: no commit ever completed, so no batch can
            # have been ACKed — recover to an empty stream
            self.version = 0
            self._fh = open(self.path, "r+b")
            self._fh.truncate(len(MAGIC))
            self._end = len(MAGIC)
            self._commit_footer()
            return
        if meta.get("groups") is None:
            raise ValueError(
                f"zarquet {self.path}: batch file, not a stream "
                f"(write_table output cannot be appended to)")
        if meta.get("codec", "zstd") != self.codec:
            self.codec = meta["codec"]          # stick with the file's codec
        self.version = meta["version"]
        self._groups = list(meta["groups"])
        self._nrows = meta["nrows"]
        if self._groups:
            self._names = [cm["name"] for cm in self._groups[0]["columns"]]
        end = committed_end(self.path)
        self._fh = open(self.path, "r+b")
        if os.path.getsize(self.path) > end:
            self._fh.truncate(end)              # torn (uncommitted) tail
        self._end = end

    # -- ingest side -------------------------------------------------------

    @property
    def inflight(self) -> int:
        with self._lock:
            return len(self._pending)

    def ingest(self, table: Table) -> int:
        """Buffer one micro-batch; returns its sequence number.  The
        batch is *not* durable until a commit ACKs it.  When the
        in-flight window is full the call commits synchronously
        (bounded-window backpressure)."""
        b = table.combine().batches[0]
        names = [f.name for f in b.schema.fields]
        with self._lock:
            if self._names is None:
                self._names = names
            elif names != self._names:
                raise ValueError(
                    f"stream {self.path}: micro-batch schema {names} does "
                    f"not match the stream schema {self._names}")
            seq = self._next_seq
            self._next_seq += 1
            self._pending.append((seq, b))
            full = len(self._pending) >= self.max_inflight
        if full:
            self.flush()
        return seq

    def flush(self) -> int:
        """Commit all pending micro-batches (one row group each, one
        footer+pointer write total), fsync, advance the pointer, ACK.
        Returns the new footer version (unchanged if nothing pending)."""
        with self._lock:
            if not self._pending:
                return self.version
            pending, self._pending = self._pending, []
            off = self._end
            self._fh.seek(off)
            faultplane.fire("stream_pre_blob")
            new_groups = []
            for _seq, b in pending:
                blobs, cols_meta, ghash, off = _encode_group(
                    b, self.level, self.codec, off, with_hash=True)
                for blob in blobs:
                    if faultplane.fire("stream_torn_blob") == "torn":
                        # half a blob past the committed footer: reopen
                        # must truncate it (nothing was ACKed)
                        self._fh.write(blob[:max(len(blob) // 2, 1)])
                        self._fh.flush()
                        faultplane.kill()
                    self._fh.write(blob)
                new_groups.append({"columns": cols_meta,
                                   "nrows": b.num_rows, "hash": ghash})
            self._groups.extend(new_groups)
            self._nrows += sum(g["nrows"] for g in new_groups)
            self.version += 1
            self._write_footer_locked(off)
            for seq, _b in pending:
                self._acked.append(seq)
            acked = [seq for seq, _b in pending]
            version = self.version
        if self.on_ack is not None:
            self.on_ack(acked, version)
        return version

    def _write_footer_locked(self, off: int) -> None:
        footer = json.dumps({"groups": self._groups, "nrows": self._nrows,
                             "version": self.version,
                             "codec": self.codec}).encode()
        faultplane.fire("stream_pre_footer")
        if faultplane.fire("stream_torn_footer") == "torn":
            # half the footer, no pointer advance: the sidecar still
            # names the previous footer, so reopen recovers to it
            self._fh.write(footer[:max(len(footer) // 2, 1)])
            self._fh.flush()
            faultplane.kill()
        self._fh.write(footer)
        self._fh.write(struct.pack("<Q", len(footer)))
        self._fh.write(MAGIC)
        self._fh.flush()
        if self.sync:
            os.fsync(self._fh.fileno())
        faultplane.fire("stream_pre_sidecar")
        self._end = off + len(footer) + 8 + len(MAGIC)
        _write_commit_pointer(self.path, self._end, self.version,
                              sync=self.sync)

    def _commit_footer(self) -> None:
        with self._lock:
            self._fh.seek(self._end)
            self._write_footer_locked(self._end)

    def poll_acks(self) -> List[int]:
        """Drain and return the sequence numbers ACKed since the last
        poll (commit order)."""
        with self._lock:
            out, self._acked = self._acked, []
            return out

    def close(self) -> None:
        """Flush pending batches and release the file handle."""
        self.flush()
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "StreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --------------------------------------------------------------------------
# synthetic dataset generators (shared by benchmarks and tests)
# --------------------------------------------------------------------------

def gen_int_table(num_cols: int, bytes_per_col: int, seed: int = 0) -> Table:
    rng = np.random.default_rng(seed)
    n = bytes_per_col // 8
    return Table.from_pydict({
        f"i{j}": rng.integers(0, 1 << 40, size=n, dtype=np.int64)
        for j in range(num_cols)})


def gen_str_table(num_cols: int, bytes_per_col: int, str_len: int = 100,
                  repeats: int = 1, seed: int = 0) -> Table:
    """num_cols string columns; each unique value occurs ``repeats`` times."""
    rng = np.random.default_rng(seed)
    n = bytes_per_col // str_len
    uniq = n // repeats
    cols = {}
    for j in range(num_cols):
        letters = rng.integers(97, 123, size=(uniq, str_len), dtype=np.uint8)
        vals = np.repeat(letters, repeats, axis=0)[:n]
        perm = rng.permutation(len(vals))
        vals = vals[perm]
        offsets = np.arange(0, (len(vals) + 1) * str_len, str_len,
                            dtype=np.int64)
        cols[f"s{j}"] = Column.utf8(offsets, vals.reshape(-1).copy())
    return Table.from_pydict(cols)
