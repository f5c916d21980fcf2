"""SIPC wire encoding — reference-passing serialization of SipcMessages.

A SIPC stream between processes carries *references, never data*: the
schema bytes (small, copied — exactly as the in-process SIPC does) plus
one ``(file_path, offset, length)`` tuple per Arrow buffer.  Readers
reconstruct Tables by mmap'ing the referenced extents of the shared
store files; the frame itself is a few hundred bytes regardless of how
many gigabytes it describes (cf. "Benchmarking Apache Arrow Flight" —
reference-passing beats data-copying wire protocols by an order of
magnitude locally).

Frame layout (little-endian):

    magic   4s   b"SIP1"
    version u16
    schema  u32 len + bytes               (JSON schema, copied)
    paths   u16 count, each: u16 len + utf8 bytes   (backing-file table)
    batches u32 count, each:
        num_rows u64, n_cols u32, then per column (recursing into the
        dictionary column when flagged):
            type    u16 len + ArrowType JSON
            length  u64
            flags   u8   (1=validity, 2=offsets, 4=dictionary)
            refs    [validity?][offsets?][values], each:
                path_idx u32 (0xFFFFFFFF = canonical empty buffer)
                offset   u64
                length   u64
                reshared u8

Decoding adopts each referenced path into the local BufferStore —
``adopt_file`` recognises paths the store already owns, so a worker
output that reshares one of the parent's input files decodes into a
reference to the *original* file: resharing survives the process hop
with zero new bytes.
"""

from __future__ import annotations

import json
import os
import socket
import struct
from typing import Dict, List, Optional, Tuple

from ..arrow import ArrowType
from ..buffers import BufferStore, Cgroup
from ..sipc import BatchRefs, BufRef, ColumnRefs, SipcMessage

MAGIC = b"SIP1"
VERSION = 1
_EMPTY = 0xFFFFFFFF

_F_VALIDITY, _F_OFFSETS, _F_DICT = 1, 2, 4


class WireError(RuntimeError):
    """Malformed or version-incompatible SIPC frame."""


# --------------------------------------------------------------------------
# primitive packers
# --------------------------------------------------------------------------

def _pack_bytes(out: List[bytes], b: bytes, fmt: str = "<I") -> None:
    out.append(struct.pack(fmt, len(b)))
    out.append(b)


class _Cursor:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        return vals if len(vals) > 1 else vals[0]

    def take_bytes(self, fmt: str = "<I") -> bytes:
        n = self.take(fmt)
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise WireError("truncated SIPC frame")
        self.pos += n
        return b


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

def export_paths(msg: SipcMessage, store: BufferStore,
                 path_for=None) -> Dict[int, str]:
    """The store-mutating half of :func:`encode_message`: land every
    direct-swap extent in its backing file and resolve each referenced
    file's exported path.  The process executor runs this under its RM
    lock and then encodes the (now pure) frame outside it, so frame
    serialization overlaps with other scheduler threads instead of
    serializing on the critical section."""
    out: Dict[int, str] = {}
    for fid in msg.files_referenced():
        if fid == 0 or fid in out:
            continue
        # direct-swap extents live in a separate swap file until
        # faulted; land them in the backing file before exporting a
        # reference, or readers would map a sparse hole
        store.ensure_file_backed(fid)
        out[fid] = (path_for(fid) if path_for is not None
                    else store.backing_path(fid))
    return out


def encode_message(msg: SipcMessage, store: Optional[BufferStore] = None,
                   path_for=None,
                   fid_paths: Optional[Dict[int, str]] = None) -> bytes:
    """Serialize ``msg`` to a reference frame.  Requires a file-backed
    store (references must name real files other processes can map).

    ``path_for(file_id) -> str`` overrides the exported path per file —
    the manifest publishes frames whose references name the durable
    content-addressed objects (relative to the manifest root) instead of
    the live backing files.  ``fid_paths`` (from :func:`export_paths`)
    supplies the resolved paths up front, making this call pure — no
    store access, safe outside any lock.
    """
    paths: List[str] = []
    path_idx: Dict[int, int] = {}     # file_id -> index into `paths`

    def ref_idx(r: BufRef) -> int:
        if r.file_id == 0:
            return _EMPTY
        i = path_idx.get(r.file_id)
        if i is None:
            if fid_paths is not None:
                p = fid_paths[r.file_id]
            else:
                store.ensure_file_backed(r.file_id)
                p = (path_for(r.file_id) if path_for is not None
                     else store.backing_path(r.file_id))
            i = len(paths)
            paths.append(p)
            path_idx[r.file_id] = i
        return i

    body: List[bytes] = []

    def put_ref(r: Optional[BufRef]) -> None:
        if r is None:
            return
        body.append(struct.pack("<IQQB", ref_idx(r), r.offset, r.length,
                                1 if r.reshared else 0))

    def put_column(c: ColumnRefs) -> None:
        _pack_bytes(body, json.dumps(c.type.to_json()).encode(), "<H")
        flags = ((_F_VALIDITY if c.validity else 0) |
                 (_F_OFFSETS if c.offsets else 0) |
                 (_F_DICT if c.dictionary else 0))
        body.append(struct.pack("<QB", c.length, flags))
        put_ref(c.validity)
        put_ref(c.offsets)
        put_ref(c.values)
        if c.dictionary:
            put_column(c.dictionary)

    body.append(struct.pack("<I", len(msg.batches)))
    for b in msg.batches:
        body.append(struct.pack("<QI", b.num_rows, len(b.columns)))
        for c in b.columns:
            put_column(c)

    head: List[bytes] = [MAGIC, struct.pack("<H", VERSION)]
    _pack_bytes(head, msg.schema_bytes)
    head.append(struct.pack("<H", len(paths)))
    for p in paths:
        _pack_bytes(head, p.encode(), "<H")
    return b"".join(head + body)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

class ParsedFrame:
    """A fully parsed SIPC frame that has not yet touched any store.

    Buffer references hold *path indices* (into :attr:`paths`), not file
    ids — :func:`materialize_message` adopts the paths and rewrites the
    indices into store file ids.  Splitting decode this way lets the
    process executor do all byte-level parsing (struct unpacks, JSON
    schema/type decoding) outside its RM lock and keep only the
    store-mutation half (adopt, charge, pin) inside it."""

    __slots__ = ("schema_bytes", "paths", "batches")

    def __init__(self, schema_bytes: bytes, paths: List[str],
                 batches: List[BatchRefs]):
        self.schema_bytes = schema_bytes
        self.paths = paths
        self.batches = batches


def parse_frame(data: bytes) -> ParsedFrame:
    """Parse a frame to a :class:`ParsedFrame` — pure, no store access."""
    cur = _Cursor(data)
    magic = cur.data[:4]
    cur.pos = 4
    if magic != MAGIC:
        raise WireError(f"bad SIPC magic {magic!r}")
    version = cur.take("<H")
    if version != VERSION:
        raise WireError(f"unsupported SIPC version {version}")
    schema_bytes = cur.take_bytes()
    n_paths = cur.take("<H")
    paths = [cur.take_bytes("<H").decode() for _ in range(n_paths)]

    def take_ref() -> BufRef:
        idx, off, length, resh = cur.take("<IQQB")
        if idx == _EMPTY:
            return BufRef(0, 0, 0)
        if idx >= len(paths):
            raise WireError("path index out of range")
        # file_id field transiently holds the path index + 1 (0 is the
        # canonical-empty sentinel); materialize_message rewrites it
        return BufRef(idx + 1, off, length, reshared=bool(resh))

    def take_column() -> ColumnRefs:
        t = ArrowType.from_json(json.loads(cur.take_bytes("<H").decode()))
        length, flags = cur.take("<QB")
        validity = take_ref() if flags & _F_VALIDITY else None
        offsets = take_ref() if flags & _F_OFFSETS else None
        values = take_ref()
        dic = take_column() if flags & _F_DICT else None
        return ColumnRefs(t, length, validity, offsets, values, dic)

    batches: List[BatchRefs] = []
    for _ in range(cur.take("<I")):
        num_rows, n_cols = cur.take("<QI")
        batches.append(
            BatchRefs(num_rows, [take_column() for _ in range(n_cols)]))
    return ParsedFrame(schema_bytes, paths, batches)


def materialize_message(parsed: ParsedFrame, store: BufferStore,
                        owner: Optional[Cgroup] = None,
                        charge: bool = True,
                        adopt_owned: bool = False,
                        label: str = "wire",
                        path_base: Optional[str] = None) -> SipcMessage:
    """The store-mutating half of :func:`decode_message`: adopt the
    parsed frame's paths, rewrite path indices to file ids, account
    new/reshared bytes and pin.  Call under the lock that guards
    ``store``.  Consumes ``parsed`` (its BufRefs are rewritten in
    place); materialize a parsed frame at most once."""
    fids: List[int] = []
    adopted_new: set = set()
    for path in parsed.paths:
        if path_base is not None and not os.path.isabs(path):
            path = os.path.join(path_base, path)
        pre = store.path_index.get(os.path.abspath(path))
        f = store.adopt_file(path, owner=owner, charge=charge,
                             owns_path=adopt_owned, label=label)
        fids.append(f.file_id)
        if pre is None:
            adopted_new.add(f.file_id)

    msg = SipcMessage(parsed.schema_bytes, parsed.batches)
    reshared = 0

    def fix_ref(r: Optional[BufRef]) -> None:
        nonlocal reshared
        if r is None or r.file_id == 0:
            return
        fid = fids[r.file_id - 1]
        r.file_id = fid
        if fid in adopted_new:
            msg.new_bytes += r.length
        else:
            reshared += r.length

    def fix_column(c: ColumnRefs) -> None:
        fix_ref(c.validity)
        fix_ref(c.offsets)
        fix_ref(c.values)
        if c.dictionary is not None:
            fix_column(c.dictionary)

    for b in parsed.batches:
        for c in b.columns:
            fix_column(c)

    msg.reshared_bytes = reshared
    store.stats.bytes_reshared += reshared
    msg.pin(store)
    return msg


def decode_message(data: bytes, store: BufferStore,
                   owner: Optional[Cgroup] = None,
                   charge: bool = True,
                   adopt_owned: bool = False,
                   label: str = "wire",
                   path_base: Optional[str] = None) -> SipcMessage:
    """Reconstruct a SipcMessage, adopting referenced backing files into
    ``store``.  Paths already registered resolve to the existing StoreFile
    (reshared — zero new bytes); fresh paths are mmap'd (adopted).

    ``adopt_owned=True`` transfers unlink responsibility for *newly*
    adopted files to this store (parent RM taking ownership of worker
    output); pre-existing files are untouched.  ``path_base`` resolves
    relative references (manifest frames name objects relative to the
    manifest root so a cache directory can be relocated).

    Equivalent to ``materialize_message(parse_frame(data), ...)`` — the
    split form exists so callers holding a hot lock can parse outside
    it."""
    return materialize_message(parse_frame(data), store, owner=owner,
                               charge=charge, adopt_owned=adopt_owned,
                               label=label, path_base=path_base)


def frame_refs(data: bytes) -> List[Tuple[str, int, int]]:
    """Parse a frame's buffer references — (path, offset, length) per
    non-empty buffer — without touching any store.  The manifest uses
    this to validate that a journaled entry's objects still exist."""
    cur = _Cursor(data)
    if cur.data[:4] != MAGIC:
        raise WireError(f"bad SIPC magic {cur.data[:4]!r}")
    cur.pos = 4
    if cur.take("<H") != VERSION:
        raise WireError("unsupported SIPC version")
    cur.take_bytes()                              # schema
    paths = [cur.take_bytes("<H").decode() for _ in range(cur.take("<H"))]
    out: List[Tuple[str, int, int]] = []

    def take_ref() -> None:
        idx, off, length, _ = cur.take("<IQQB")
        if idx != _EMPTY:
            if idx >= len(paths):
                raise WireError("path index out of range")
            out.append((paths[idx], off, length))

    def take_column() -> None:
        cur.take_bytes("<H")                      # type json
        _, flags = cur.take("<QB")
        if flags & _F_VALIDITY:
            take_ref()
        if flags & _F_OFFSETS:
            take_ref()
        take_ref()
        if flags & _F_DICT:
            take_column()

    for _ in range(cur.take("<I")):
        _, n_cols = cur.take("<QI")
        for _ in range(n_cols):
            take_column()
    return out


# --------------------------------------------------------------------------
# socket framing (length-prefixed frames over a Unix-domain socket)
# --------------------------------------------------------------------------

_LEN = struct.Struct("<Q")
MAX_FRAME = 1 << 30     # sanity bound: control frames are tiny by design


def send_frame(sock: socket.socket, payload: bytes) -> int:
    """Send one length-prefixed frame; returns bytes put on the wire."""
    sock.sendall(_LEN.pack(len(payload)) + payload)
    return _LEN.size + len(payload)


def recv_frame(sock: socket.socket) -> bytes:
    head = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise WireError(f"frame of {n} bytes exceeds MAX_FRAME")
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed during SIPC frame")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)
