"""Persistent content-addressed manifest — the cross-run half of DeCache.

The paper's DeCache (§3.1, §4.2.4) amortizes deserialization *within* a
process lifetime; Bauplan pipelines are FaaS jobs that restart constantly,
so the real wins come from differential caching across invocations ("FaaS
and Furious", Tagliabue et al. 2024).  This module makes node outputs
survive the process:

    <root>/objects/<sha256>     content-addressed store files (hard links
                                to — or, cross-device, copies of — the live
                                backing files; immutable once published)
    <root>/MANIFEST.log         append-only journal of publish records

A *publish* makes one node output durable:

  1. every store file the output references is materialized in its backing
     file (direct-swap extents are landed first), fsync'd, content-hashed,
     and linked into ``objects/`` under its hash — idempotent, so two nodes
     publishing reshared views of the same file share one object;
  2. the objects directory is fsync'd;
  3. one journal record — the node fingerprint plus the output's SIPC wire
     frame re-pointed at the object paths — is appended with a CRC and
     fsync'd.  The journal append is the commit point: a crash anywhere
     before it leaves at most unreferenced objects (garbage, never
     corruption); a crash during it leaves a torn tail record that recovery
     discards.

Recovery (``Manifest`` load, used by ``BufferStore.reopen``) scans the
journal, stops at the first torn record (truncating it in writer mode),
and drops entries whose object files are missing or short — so a reopened
manifest contains exactly the journaled complete outputs, each remappable
with zero bytes copied via ``decode_message``/``adopt_file``.

Fault injection goes through ``core.faultplane``: the legacy
``ZERROW_CRASH=<point>:<n>`` env spelling still SIGKILLs the process the
n-th time the named publish fault point is reached (``CRASH_POINTS``),
and the same points also accept any ``ZERROW_FAULTS`` / programmatic
action.  ``torn_journal`` writes half a record before dying — the
torn-tail case recovery must survive.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import shutil
import struct
import threading
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

from . import faultplane

REC_MAGIC = b"ZMF1"
_REC_HEAD = struct.Struct("<4sII")      # magic, payload_len, crc32(payload)

#: publish fault points, in execution order (see tests/test_persistence.py)
CRASH_POINTS = ("pre_link", "post_link", "pre_journal", "torn_journal",
                "pre_fsync", "post_fsync")

faultplane.register_hook("pre_link", "manifest publish: object hashed, "
                         "before the hard link into objects/")
faultplane.register_hook("post_link", "manifest publish: object linked, "
                         "before its fsync")
faultplane.register_hook("pre_journal", "manifest publish: objects durable, "
                         "before the journal append")
faultplane.register_hook("torn_journal", "manifest publish: half the "
                         "journal record written, then SIGKILL")
faultplane.register_hook("pre_fsync", "manifest publish: record appended, "
                         "before the journal fsync")
faultplane.register_hook("post_fsync", "manifest publish: journal fsync'd "
                         "(entry committed), before the in-memory update")


def _maybe_crash(point: str) -> None:
    """Report a publish fault point (kill/raise/delay per installed spec)."""
    faultplane.fire(point)


def _fsync_fd_of(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@contextmanager
def _flocked(fd: int):
    """Inter-process exclusive lock on the journal fd.  Serializes
    appends against recovery's torn-tail truncation when several
    processes share one cache root (the kernel releases it on process
    death, so a SIGKILL'd holder cannot wedge the root)."""
    fcntl.flock(fd, fcntl.LOCK_EX)
    try:
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)


# content hashing: one helper for the whole cache layer — source files
# and store files alike are hashed by content, cached by
# (path, size, mtime_ns) so an in-place rewrite never serves a stale hash
from .fingerprint import file_fingerprint as hash_file  # noqa: E402


@dataclass
class ManifestEntry:
    fingerprint: str
    frame: bytes                 # SIPC wire frame, object-relative paths
    nbytes: int                  # total object bytes referenced
    schema_fp: str
    label: str = ""
    meta: dict = field(default_factory=dict)


class Manifest:
    """The on-disk publish journal + content-addressed object directory."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.objects_dir = os.path.join(self.root, "objects")
        self.log_path = os.path.join(self.root, "MANIFEST.log")
        os.makedirs(self.objects_dir, exist_ok=True)
        self.entries: Dict[str, ManifestEntry] = {}
        self.dropped_torn = 0        # torn tail records discarded
        self.dropped_incomplete = 0  # journaled but objects missing/short
        self.dropped_corrupt = 0     # content hash mismatch (verify mode)
        self.published = 0
        self.object_copies = 0       # cross-device publishes (copied, not linked)
        # verify-on-adopt: when on, _objects_intact re-hashes every
        # objects/-relative ref against its content-addressed name, so
        # at-rest corruption (bit rot, a torn copy) is detected instead
        # of served.  Off by default — hashing costs a full read; the
        # size check alone already catches truncation.
        self.verify_objects = bool(os.environ.get("ZERROW_VERIFY_OBJECTS"))
        self._lock = threading.Lock()
        flags = os.O_WRONLY | os.O_CREAT | os.O_APPEND
        self._log_fd = os.open(self.log_path, flags, 0o644)
        with _flocked(self._log_fd):
            # load under the journal lock: a concurrent writer's half-
            # visible append must not be mistaken for a torn tail
            good_end = self._load()
            # recover: a real torn tail would make every later append
            # unreadable
            if os.path.getsize(self.log_path) > good_end:
                os.ftruncate(self._log_fd, good_end)

    # -- recovery ----------------------------------------------------------
    def _load(self) -> int:
        """Scan the journal; returns the offset past the last good record."""
        if not os.path.exists(self.log_path):
            return 0
        with open(self.log_path, "rb") as fh:
            data = fh.read()
        pos = 0
        while pos < len(data):
            head = data[pos:pos + _REC_HEAD.size]
            if len(head) < _REC_HEAD.size:
                self.dropped_torn += 1
                break
            magic, plen, crc = _REC_HEAD.unpack(head)
            payload = data[pos + _REC_HEAD.size:pos + _REC_HEAD.size + plen]
            if magic != REC_MAGIC or len(payload) < plen or \
                    zlib.crc32(payload) != crc:
                self.dropped_torn += 1
                break
            pos += _REC_HEAD.size + plen
            try:
                rec = json.loads(payload.decode())
                entry = ManifestEntry(rec["fp"], bytes.fromhex(rec["frame"]),
                                      rec["bytes"], rec["schema_fp"],
                                      rec.get("label", ""),
                                      rec.get("meta", {}))
            except (ValueError, KeyError):
                self.dropped_torn += 1
                break
            if self._objects_intact(entry):
                self.entries[entry.fingerprint] = entry
            else:
                self.dropped_incomplete += 1
        return pos

    def _objects_intact(self, entry: ManifestEntry) -> bool:
        from .flight.wire import WireError, frame_refs
        try:
            refs = frame_refs(entry.frame)
        except WireError:
            return False
        for path, offset, length in refs:
            p = self.resolve(path)
            try:
                if os.path.getsize(p) < offset + length:
                    return False
            except OSError:
                return False
            if self.verify_objects and not os.path.isabs(path):
                # content-addressed: the object's basename IS its hash
                # (hash_file caches by (path, size, mtime_ns), so the
                # re-read cost is paid once per changed file)
                if hash_file(p) != os.path.basename(path):
                    self.dropped_corrupt += 1
                    return False
        return True

    def resolve(self, path: str) -> str:
        return path if os.path.isabs(path) else os.path.join(self.root, path)

    # -- publish -----------------------------------------------------------
    def publish(self, store, fingerprint: str, msg, label: str = "",
                meta: Optional[dict] = None) -> ManifestEntry:
        """Make one SipcMessage durable under ``fingerprint``.  Idempotent:
        an already-published fingerprint returns the existing entry."""
        from .flight.wire import encode_message
        e = self.entries.get(fingerprint)
        if e is not None:
            return e
        # hashing + linking + fsync run OUTSIDE the manifest lock —
        # they are slow, per-file idempotent (content addressing), and
        # concurrent publishers of the same object simply race to the
        # same link.  Only the entries check and the journal append need
        # serializing.
        obj_rel: Dict[int, str] = {}
        total = 0
        for fid in msg.files_referenced():
            store.ensure_file_backed(fid)
            src = store.backing_path(fid)
            _fsync_fd_of(src)           # mmap'd writes -> durable first
            sha = hash_file(src)
            rel = os.path.join("objects", sha)
            obj = os.path.join(self.root, rel)
            _maybe_crash("pre_link")
            if not os.path.exists(obj):
                try:
                    os.link(src, obj)
                except FileExistsError:
                    pass                # racing publisher won
                except OSError:         # cross-device: copy + atomic move
                    tmp = f"{obj}.tmp-{os.getpid()}"
                    shutil.copyfile(src, tmp)
                    _fsync_fd_of(tmp)
                    os.replace(tmp, obj)
                    self.object_copies += 1
            _maybe_crash("post_link")
            _fsync_fd_of(obj)
            obj_rel[fid] = rel
            total += os.path.getsize(obj)
        _fsync_fd_of(self.objects_dir)
        frame = encode_message(msg, store, path_for=obj_rel.__getitem__)
        schema_fp = hashlib.sha256(msg.schema_bytes).hexdigest()
        payload = json.dumps({
            "fp": fingerprint, "frame": frame.hex(), "bytes": total,
            "schema_fp": schema_fp, "label": label,
            "meta": meta or {}}).encode()
        record = _REC_HEAD.pack(REC_MAGIC, len(payload),
                                zlib.crc32(payload)) + payload
        with self._lock:
            e = self.entries.get(fingerprint)
            if e is not None:
                return e                # racing thread journaled it first
            _maybe_crash("pre_journal")
            with _flocked(self._log_fd):
                if faultplane.fire("torn_journal") == "torn":
                    # write half the record, then die: recovery must
                    # discard this torn tail (flock dies with us)
                    os.write(self._log_fd,
                             record[:max(len(record) // 2, 1)])
                    faultplane.kill()
                # one append: the commit point
                os.write(self._log_fd, record)
                _maybe_crash("pre_fsync")
                os.fsync(self._log_fd)
            _maybe_crash("post_fsync")
            e = ManifestEntry(fingerprint, frame, total, schema_fp, label,
                              meta or {})
            self.entries[fingerprint] = e
            self.published += 1
            return e

    # -- lookup / adoption -------------------------------------------------
    def get(self, fingerprint: Optional[str]) -> Optional[ManifestEntry]:
        if fingerprint is None:
            return None
        return self.entries.get(fingerprint)

    def __contains__(self, fingerprint) -> bool:
        return fingerprint is not None and fingerprint in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def decode(self, fingerprint: str, store, owner=None, charge: bool = True,
               label: str = ""):
        """Adopt a published output into ``store`` (zero bytes copied —
        ``adopt_file`` mmaps the objects).  Returns None and drops the
        entry when its objects vanished underneath us.  Objects are
        re-validated *before* any adoption so a vanished file cannot
        leave earlier refs of the same frame adopted-and-charged (an
        accounting leak the store could never drain)."""
        from .flight.wire import WireError, decode_message
        e = self.entries.get(fingerprint)
        if e is None:
            return None
        if not self._objects_intact(e):
            with self._lock:
                self.entries.pop(fingerprint, None)
            return None
        try:
            return decode_message(e.frame, store, owner=owner, charge=charge,
                                  path_base=self.root,
                                  label=label or e.label or "cached")
        except (OSError, WireError):
            with self._lock:
                self.entries.pop(fingerprint, None)
            return None

    def close(self) -> None:
        if self._log_fd is not None:
            try:
                os.close(self._log_fd)
            except OSError:
                pass
            self._log_fd = None
