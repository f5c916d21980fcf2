"""DeCache — the shared deserialization service (paper §3.1, §4.2.4).

When multiple DAGs (possibly submitted at different times) deserialize the
same source with the same dictionary configuration, the load runs once and
every consumer maps the same physical Arrow data.  Entries are keyed by
``(source_path, dict_columns)`` — the same source deserialized with
different ``read_dictionary`` settings gets distinct loader nodes, as in
the paper's Figure 3a (shows.parquet with and without dictionaries).

Entries are pinned in the store (``decache_pinned``) and survive DAG
completion until the RM uncaches them under memory pressure.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from .buffers import BufferStore
from .sipc import SipcMessage

Key = Tuple[Optional[str], tuple]


@dataclass
class DeCacheEntry:
    key: Key
    msg: SipcMessage
    load_latency: float
    bytes: int
    refcount: int = 0          # active attachments (running/queued consumers)
    last_use: float = field(default_factory=time.monotonic)
    hits: int = 0


class DeCache:
    def __init__(self, store: BufferStore, enabled: bool = True,
                 manifest=None):
        self.store = store
        self.enabled = enabled
        self.manifest = manifest       # persistent cross-run cache (may be
        #                              # None): misses on fingerprint keys
        #                              # warm from it instead of reloading
        self.entries: Dict[Key, DeCacheEntry] = {}
        self.loads = 0
        self.hits = 0
        self.warmed = 0                # entries materialized from manifest
        self._cgroup = None            # owner of warmed adoptions

    # -- lookup/attach --------------------------------------------------------
    def lookup(self, key: Key) -> Optional[DeCacheEntry]:
        if not self.enabled:
            return None
        e = self.entries.get(key)
        if e is None:
            e = self._warm(key)
        if e is not None:
            e.last_use = time.monotonic()
        return e

    def _warm(self, key: Key) -> Optional[DeCacheEntry]:
        """Materialize a fingerprint key from the persistent manifest: the
        published output is adopted (mmap'd, zero bytes copied) and pinned
        like any loader output — deserialization survives the process."""
        if self.manifest is None or not isinstance(key, str):
            return None
        if key not in self.manifest:
            return None
        if self._cgroup is None:
            self._cgroup = self.store.new_cgroup("decache")
        msg = self.manifest.decode(key, self.store, owner=self._cgroup,
                                   label="decache")
        if msg is None:
            return None
        self.warmed += 1
        e = self.insert(key, msg, load_latency=0.0)
        self.loads -= 1         # a warm adoption is not a deserialization
        return e

    def attach(self, e: DeCacheEntry) -> SipcMessage:
        e.refcount += 1
        e.hits += 1
        self.hits += 1
        e.last_use = time.monotonic()
        return e.msg

    def detach(self, e: DeCacheEntry) -> None:
        e.refcount -= 1
        assert e.refcount >= 0

    # -- insert (after a loader node ran) --------------------------------------
    def insert(self, key: Key, msg: SipcMessage, load_latency: float) -> DeCacheEntry:
        self.loads += 1
        if not self.enabled:
            return DeCacheEntry(key, msg, load_latency, msg.new_bytes)
        for fid in msg.files_referenced():
            f = self.store.files.get(fid)
            if f is not None:
                f.decache_pinned = True
        e = DeCacheEntry(key, msg, load_latency, msg.new_bytes)
        self.entries[key] = e
        return e

    # -- eviction ('RM:uncache') ------------------------------------------------
    def uncache_candidates(self):
        """Zero-reference entries, least recently used first."""
        free = [e for e in self.entries.values() if e.refcount == 0]
        free.sort(key=lambda e: e.last_use)
        return free

    def uncache(self, e: DeCacheEntry) -> int:
        del self.entries[e.key]
        freed = 0
        for fid in e.msg.files_referenced():
            f = self.store.files.get(fid)
            if f is not None:
                f.decache_pinned = False
                freed += f.resident_bytes()
        e.msg.release()
        # files with no other references are garbage collected now
        for fid in list(e.msg.files_referenced()):
            f = self.store.files.get(fid)
            if f is not None and f.refcount == 0:
                self.store.delete_file(fid)
        return freed

    def resident_bytes(self) -> int:
        total = 0
        for e in self.entries.values():
            for fid in e.msg.files_referenced():
                f = self.store.files.get(fid)
                if f is not None:
                    total += f.resident_bytes()
        return total
