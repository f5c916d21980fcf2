"""BufferStore: the tmpfs / kernel-memory analogue for Zerrow.

The paper's KernelZero operates on Linux physical pages, page tables and
tmpfs files.  This module provides the user-space equivalent with *real*
memory semantics:

  * ``StoreFile``    — an in-memory "tmpfs file": an append-only sequence of
                       extents.  Extents either hold a (read-only) numpy view
                       of user memory that was *transferred* (zero copy), or
                       bytes that were *copied* in (partial pages / baseline
                       writer-copy mode), or a swap handle on disk.
  * ``Cgroup``       — per-sandbox memory accounting with a limit; charging
                       past the limit triggers reclaim (swap-out) exactly like
                       cgroup-integrated kernel swap ("limit dropping").
  * ``BufferStore``  — the registry: file ids, refcounts, global kswap, LRU,
                       and the stats counters every benchmark reads.

Simulation notes (see DESIGN.md §2a):
  - Sharing is byte-granular here (user-space object sharing can do better
    than the kernel's page tables); the *cost model* of partial-page copies
    is retained: ``deanon`` really copies head/tail partial pages and the
    stats account for them.
  - Swap performs real disk I/O and virtual accounting.  RSS of the original
    arrays is not reclaimed (a user-space process cannot free memory that
    user code may still reference) — experiments are sized to fit RAM, and
    the *time* cost of swap (the quantity that drives the paper's Figures 4
    and 10) is real.

Backing modes (the Flight data plane, docs/ARCHITECTURE.md):
  - ``backing="ram"`` (default) — extents hold numpy views of user memory;
    zero-copy within one process, invisible to other processes.  This is
    the mode every pre-Flight benchmark and test runs in.
  - ``backing="file"`` — every StoreFile is a real file under ``data_dir``
    and resident extents are MAP_SHARED mmaps of it, so *any* process can
    map the same physical page-cache pages by ``(path, offset, length)``.
    De-anonymization writes the anonymous bytes into the backing file once
    (``bytes_file_ingest`` — the user-space tax for cross-process reality;
    the kernel module moves the pages instead) and the anonymous source is
    freed immediately after, so peak memory matches the transfer
    semantics.  ``adopt_file`` maps a file another process produced into
    this store without touching a single data byte — that is how Flight
    readers and the parent RM pick up worker outputs.  Swap-out of a
    file-backed extent just drops the mapping (the bytes stay durable in
    the backing file); swap-in re-maps it.
"""

from __future__ import annotations

import os
import threading
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

PAGE = 4096


# --------------------------------------------------------------------------
# aligned allocation (our jemalloc-with-page-alignment stand-in)
# --------------------------------------------------------------------------

def alloc_aligned(nbytes: int, align: int = PAGE) -> np.ndarray:
    """Allocate ``nbytes`` of uint8 page-aligned memory.

    Arrow allocators align to at least 64B; we align to PAGE so that
    de-anonymization transfers whole pages (the fast path).  The unaligned
    path is still supported (and tested) — it costs two partial-page copies,
    as in the paper.
    """
    if nbytes == 0:
        return np.empty(0, dtype=np.uint8)
    raw = np.empty(nbytes + align, dtype=np.uint8)
    addr = raw.__array_interface__["data"][0]
    off = (-addr) % align
    return raw[off : off + nbytes]  # .base keeps `raw` alive


def addr_range(arr: np.ndarray) -> tuple[int, int]:
    """(virtual address, nbytes) of a contiguous array's memory."""
    if not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("addr_range requires a C-contiguous array")
    a = arr.__array_interface__["data"][0]
    return a, arr.nbytes


def pages_of(nbytes: int) -> int:
    return -(-nbytes // PAGE)


def _file_extend(path: str, length: int) -> None:
    """Grow ``path`` to at least ``length`` bytes (sparse, no data I/O)."""
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
    try:
        if os.fstat(fd).st_size < length:
            os.ftruncate(fd, length)
    finally:
        os.close(fd)


def map_extent(path: str, offset: int, length: int) -> np.ndarray:
    """Read-only MAP_SHARED view of ``path[offset:offset+length]``.

    This is the reader half of the Flight data plane: any process that
    knows a ``(path, offset, length)`` reference maps the same physical
    page-cache pages — no data bytes move.
    """
    if length == 0:
        return np.empty(0, dtype=np.uint8)
    return np.memmap(path, dtype=np.uint8, mode="r", offset=offset,
                     shape=(length,))


# --------------------------------------------------------------------------
# stats
# --------------------------------------------------------------------------

@dataclass
class StoreStats:
    bytes_copied: int = 0            # real memcpys into store files
    bytes_deanon: int = 0            # zero-copy ownership transfers
    bytes_reshared: int = 0          # output refs that reused input files
    reshare_hits: int = 0            # output buffers emitted as references
    #                                # (lazy pass-through or AddressMap hit)
    reshare_misses: int = 0          # output buffers that had to be
    #                                # de-anonymized/copied in zero mode
    bytes_file_ingest: int = 0       # anon bytes written into backing files
    #                                # (file mode's deanon tax; not a SIPC
    #                                # wire/reader/writer copy)
    bytes_adopted: int = 0           # bytes mapped in from foreign files
    partial_page_bytes: int = 0      # head/tail partial-page copies
    swapout_bytes: int = 0
    swapin_bytes: int = 0
    swapout_events: int = 0          # extent-granular
    swapin_events: int = 0
    fg_swapin_pages: int = 0         # page-granular foreground swapins (Fig 4b/5b)
    direct_swap_bytes: int = 0       # swap entries moved without I/O
    files_created: int = 0
    files_deleted: int = 0
    oom_kills: int = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


# --------------------------------------------------------------------------
# cgroup accounting
# --------------------------------------------------------------------------

class OOMError(MemoryError):
    """Simulated cgroup / system OOM kill."""


class Cgroup:
    """Memory accounting for one sandbox (or the DeCache, or 'system').

    tmpfs memory for a file is charged to the cgroup that created it, as on
    Linux (§4.1); the cgroup survives process exit so outputs can be evicted
    later ("we modify SOCK so that cgroups are retained").
    """

    def __init__(self, name: str, store: "BufferStore", limit: Optional[int] = None):
        self.name = name
        self.store = store
        self.limit = limit
        self.charged = 0
        self.swap_charged = 0
        self.alive = True

    def charge(self, nbytes: int) -> None:
        self.charged += nbytes
        self.store._global_charge(nbytes)
        if self.limit is not None and self.charged > self.limit:
            self.store.reclaim_cgroup(self, self.charged - self.limit)

    def uncharge(self, nbytes: int) -> None:
        self.charged -= nbytes
        self.store._global_charge(-nbytes)

    def set_limit(self, limit: Optional[int]) -> None:
        """Dynamic limit adjustment — the 'limit dropping' mechanism."""
        self.limit = limit
        if limit is not None and self.charged > limit:
            self.store.reclaim_cgroup(self, self.charged - limit)


# --------------------------------------------------------------------------
# extents and files
# --------------------------------------------------------------------------

class Extent:
    """A contiguous range of a StoreFile's logical address space.

    state: resident (holds a read-only ndarray) or swapped (holds a path).
    """

    __slots__ = ("file", "logical_off", "length", "array", "swap_path",
                 "swap_off", "last_access", "pinned_resident", "file_backed")

    def __init__(self, file: "StoreFile", logical_off: int, length: int,
                 array: Optional[np.ndarray], swap_path: Optional[str] = None,
                 swap_off: int = 0):
        self.file = file
        self.logical_off = logical_off
        self.length = length
        self.array = array           # None when swapped out
        self.swap_path = swap_path   # set when a swap copy exists / is live
        self.swap_off = swap_off
        self.last_access = 0
        self.pinned_resident = False
        self.file_backed = False     # array is a MAP_SHARED mmap of the
        #                            # StoreFile's backing file (file mode)

    @property
    def resident(self) -> bool:
        return self.array is not None


class StoreFile:
    """A 'tmpfs file' assembled from de-anonymized extents.

    In-memory in RAM mode; a real file under the store's ``data_dir`` in
    file mode (``backing_path``), where resident extents are MAP_SHARED
    mmaps and the byte layout is exactly the logical layout (extent
    ``logical_off`` == file offset), so ``(backing_path, offset, length)``
    is a complete cross-process buffer reference.
    """

    def __init__(self, store: "BufferStore", file_id: int, owner: Cgroup,
                 label: str = "", backing_path: Optional[str] = None):
        self.store = store
        self.file_id = file_id
        self.owner = owner
        self.label = label
        self.extents: List[Extent] = []
        self.length = 0
        self.refcount = 0
        self.deleted = False
        self.decache_pinned = False
        self.backing_path = backing_path   # file mode only
        self.owns_path = backing_path is not None  # unlink on delete?

    # -- building ---------------------------------------------------------
    def append_extent(self, array: Optional[np.ndarray],
                      swap_path: Optional[str] = None,
                      length: Optional[int] = None,
                      charge: bool = True) -> int:
        if self.deleted:
            raise ValueError(f"append to deleted file {self.file_id}")
        n = array.nbytes if array is not None else int(length)  # type: ignore[arg-type]
        ext = Extent(self, self.length, n, array, swap_path)
        off = self.length
        self.extents.append(ext)
        self.length += n
        if self.backing_path is not None and n > 0:
            # the backing file always spans the logical length, so swapped
            # direct-swap entries have their region reserved up front
            _file_extend(self.backing_path, self.length)
        if array is not None:
            array = np.ascontiguousarray(array).view(np.uint8).reshape(-1)
            if self.backing_path is not None and n > 0:
                # file mode: the anonymous bytes are written into the
                # backing file once (the user-space stand-in for the kernel
                # module's page move) and the resident view becomes a
                # MAP_SHARED mmap any process can re-open
                mm = np.memmap(self.backing_path, dtype=np.uint8,
                               mode="r+", offset=off, shape=(n,))
                mm[:] = array
                mm.flags.writeable = False
                ext.array = mm
                ext.file_backed = True
                self.store.stats.bytes_file_ingest += n
            else:
                ext.array = array
                ext.array.flags.writeable = False  # post-deanon immutability
            if charge:
                self.owner.charge(n)
            self.store._lru_touch(ext)
        else:
            self.owner.swap_charged += n
        return off

    # -- reading ----------------------------------------------------------
    def read(self, offset: int, length: int, foreground: bool = True) -> np.ndarray:
        """Zero-copy view when the range sits in one resident extent;
        swaps in (real disk read) when needed; stitches across extents
        (copy, counted) otherwise."""
        if self.deleted:
            raise ValueError(f"read from deleted file {self.file_id} ({self.label})")
        end = offset + length
        if end > self.length:
            raise ValueError("read past end of store file")
        pieces: List[np.ndarray] = []
        for ext in self.extents:
            e0, e1 = ext.logical_off, ext.logical_off + ext.length
            if e1 <= offset or e0 >= end:
                continue
            # pin while faulting: the swap-in's charge may trigger reclaim,
            # which must not evict the very extent being accessed
            prev_pin = ext.pinned_resident
            ext.pinned_resident = True
            try:
                if not ext.resident:
                    self.store.swap_in(ext, foreground=foreground)
                self.store._lru_touch(ext)
                lo = max(offset, e0) - e0
                hi = min(end, e1) - e0
                pieces.append(ext.array[lo:hi])  # type: ignore[index]
            finally:
                ext.pinned_resident = prev_pin
        if len(pieces) == 1:
            return pieces[0]
        out = np.concatenate(pieces) if pieces else np.empty(0, np.uint8)
        self.store.stats.bytes_copied += out.nbytes  # stitch copy is a real copy
        return out

    # -- lifecycle --------------------------------------------------------
    def incref(self) -> None:
        self.refcount += 1

    def decref(self) -> None:
        self.refcount -= 1
        assert self.refcount >= 0, f"negative refcount on file {self.file_id}"

    def resident_bytes(self) -> int:
        return sum(e.length for e in self.extents if e.resident)


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------

class BufferStore:
    """Registry of StoreFiles + swap machinery + kswap + stats."""

    def __init__(self, swap_dir: Optional[str] = None,
                 system_limit: Optional[int] = None,
                 backing: str = "ram", data_dir: Optional[str] = None,
                 root: Optional[str] = None):
        assert backing in ("ram", "file"), backing
        if root is not None:
            backing = "file"      # durable mode implies real backing files
        self.files: Dict[int, StoreFile] = {}
        self._next_id = 1
        self.stats = StoreStats()
        self.swap_dir = swap_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), f"zerrow-swap-{uuid.uuid4().hex[:8]}")
        os.makedirs(self.swap_dir, exist_ok=True)
        self.backing = backing
        self.data_dir: Optional[str] = None
        self.root: Optional[str] = None
        self.manifest = None                   # set by attach_manifest
        self.path_index: Dict[str, int] = {}   # abs backing path -> file_id
        if backing == "file":
            if root is not None and data_dir is None:
                # live (unpublished) files go in a per-instance dir under
                # the root; publish hard-links them into <root>/objects
                data_dir = os.path.join(
                    os.path.abspath(root),
                    f"live-{os.getpid()}-{uuid.uuid4().hex[:8]}")
            self.data_dir = os.path.abspath(data_dir or os.path.join(
                os.environ.get("TMPDIR", "/tmp"),
                f"zerrow-store-{uuid.uuid4().hex[:8]}"))
            os.makedirs(self.data_dir, exist_ok=True)
        if root is not None:
            self.attach_manifest(root)
        self.system = Cgroup("system", self, limit=None)
        self.system_limit = system_limit
        self.global_charged = 0
        self._lru_clock = 0
        self._lock = threading.RLock()
        self.kswap_enabled = True
        self.anon_regions: List["AnonRegion"] = []
        self.on_oom: Optional[Callable[[int], bool]] = None  # returns True if it freed memory

    # -- durability (persistent content-addressed cache) -------------------
    def attach_manifest(self, root: str) -> None:
        """Turn this (file-backed) store durable: content-addressed
        objects + fsync'd publish journal under ``root``."""
        if self.backing != "file":
            raise ValueError(
                "a durable store needs real backing files: construct with "
                "BufferStore(backing='file', root=...)")
        from .manifest import Manifest       # deferred: avoids import cycle
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.manifest = Manifest(self.root)

    @classmethod
    def reopen(cls, root: str, **kw) -> "BufferStore":
        """Remap a durable store root left by earlier runs.

        Zero bytes are copied: the manifest journal is replayed (torn
        tails discarded, entries with missing objects dropped) and each
        surviving output is lazily re-mmap'd through ``adopt_file`` the
        first time a fingerprint hit decodes it."""
        return cls(backing="file", root=root, **kw)

    def publish(self, fingerprint: str, msg, label: str = "",
                meta: Optional[dict] = None):
        """Durably publish a SipcMessage under a node fingerprint."""
        if self.manifest is None:
            raise ValueError("publish requires a durable store "
                             "(BufferStore(root=...))")
        return self.manifest.publish(self, fingerprint, msg, label=label,
                                     meta=meta)

    @property
    def copied_bytes(self) -> int:
        """Real data-byte memcpys through the SIPC read/write paths — the
        quantity the zero-copy claims are asserted on.  File-mode ingest
        and adoption are accounted separately (``bytes_file_ingest`` /
        ``bytes_adopted``)."""
        return self.stats.bytes_copied

    # -- cgroups ----------------------------------------------------------
    def new_cgroup(self, name: str, limit: Optional[int] = None) -> Cgroup:
        return Cgroup(name, self, limit)

    def _global_charge(self, nbytes: int) -> None:
        self.global_charged += nbytes
        if nbytes > 0 and self.system_limit is not None and \
                self.global_charged > self.system_limit:
            need = self.global_charged - self.system_limit
            if self.kswap_enabled:
                freed = self.kswap(need)
                need -= freed
            if need > 0:
                if self.on_oom is not None and self.on_oom(need):
                    return
                self.stats.oom_kills += 1
                raise OOMError(
                    f"simulated OOM: charged {self.global_charged} > "
                    f"limit {self.system_limit}")

    # -- files ------------------------------------------------------------
    def new_file(self, owner: Cgroup, label: str = "",
                 backing_path: Optional[str] = None) -> StoreFile:
        with self._lock:
            fid = self._next_id
            self._next_id += 1
            path = None
            if self.backing == "file":
                path = os.path.abspath(backing_path or os.path.join(
                    self.data_dir, f"f{fid:06d}"))
                if backing_path is None:
                    _file_extend(path, 0)       # create empty backing file
                self.path_index[path] = fid
            f = StoreFile(self, fid, owner, label, backing_path=path)
            self.files[fid] = f
            self.stats.files_created += 1
            return f

    def get(self, file_id: int) -> StoreFile:
        return self.files[file_id]

    def backing_path(self, file_id: int) -> str:
        """The cross-process name of a StoreFile (file mode only)."""
        f = self.files[file_id]
        if f.backing_path is None:
            raise ValueError(
                f"store file {file_id} ({f.label!r}) has no backing file: "
                "construct the BufferStore with backing='file' to export "
                "wire references")
        return f.backing_path

    def ensure_file_backed(self, file_id: int) -> None:
        """Materialize every extent of a StoreFile in its backing file.

        A direct-swap entry (anon region swapped out *before* deanon, then
        transferred without I/O) lives in a separate swap file; its
        backing-file region is only reserved.  Exporting a wire reference
        to it would hand readers a sparse hole, so the wire encoder calls
        this before naming the path — the swap-in lands the bytes in the
        backing file and the extent becomes file-backed for good."""
        f = self.files[file_id]
        if f.backing_path is None:
            raise ValueError(f"store file {file_id} is not file-backed")
        for ext in f.extents:
            if not ext.file_backed and not ext.resident:
                self.swap_in(ext, foreground=False)

    def adopt_file(self, path: str, owner: Optional[Cgroup] = None,
                   label: str = "", charge: bool = True,
                   owns_path: bool = False) -> StoreFile:
        """Map a file produced by another process (or store) into this
        registry without touching any data bytes.

        Returns the existing StoreFile when ``path`` is already registered
        (e.g. a worker output that reshares one of our own input files).
        ``owns_path=True`` transfers unlink responsibility to this store —
        the ownership handover the parent RM performs on worker outputs.
        """
        if self.backing != "file":
            raise ValueError("adopt_file requires a file-backed store")
        path = os.path.abspath(path)
        with self._lock:
            fid = self.path_index.get(path)
            if fid is not None:
                return self.files[fid]
            length = os.path.getsize(path)
            f = self.new_file(owner or self.system, label,
                              backing_path=path)
            f.owns_path = owns_path
            if length:
                ext = Extent(f, 0, length, map_extent(path, 0, length))
                ext.file_backed = True
                f.extents.append(ext)
                f.length = length
                if charge:
                    f.owner.charge(length)
                self._lru_touch(ext)
            self.stats.bytes_adopted += length
            return f

    def delete_file(self, file_id: int) -> None:
        f = self.files.pop(file_id, None)
        if f is None or f.deleted:
            return
        f.deleted = True
        for ext in f.extents:
            if ext.resident:
                f.owner.uncharge(ext.length)
                ext.array = None
            elif ext.swap_path:
                f.owner.swap_charged -= ext.length
                if not ext.file_backed:
                    try:
                        os.unlink(ext.swap_path)
                    except OSError:
                        pass
        if f.backing_path is not None:
            self.path_index.pop(f.backing_path, None)
            if f.owns_path:
                try:
                    os.unlink(f.backing_path)
                except OSError:
                    pass
        self.stats.files_deleted += 1

    # -- swap -------------------------------------------------------------
    def _swap_path(self) -> str:
        return os.path.join(self.swap_dir, uuid.uuid4().hex)

    def swap_out(self, ext: Extent) -> None:
        if not ext.resident or ext.pinned_resident:
            return
        if ext.file_backed:
            # the bytes are durable in the backing file: dropping the
            # mapping is the page-cache-eviction analogue (no write I/O)
            ext.swap_path = ext.file.backing_path
            ext.array = None
        else:
            path = self._swap_path()
            ext.array.tofile(path)  # real disk write  # type: ignore[union-attr]
            ext.swap_path = path
            ext.array = None
        ext.file.owner.uncharge(ext.length)
        ext.file.owner.swap_charged += ext.length
        self.stats.swapout_bytes += ext.length
        self.stats.swapout_events += 1

    def swap_in(self, ext: Extent, foreground: bool = True) -> None:
        if ext.resident:
            return
        assert ext.swap_path is not None
        if ext.file_backed:
            ext.array = map_extent(ext.file.backing_path, ext.logical_off,
                                   ext.length)
            ext.swap_path = None
        else:
            data = np.fromfile(ext.swap_path, dtype=np.uint8,
                               count=ext.length)  # real read
            try:
                os.unlink(ext.swap_path)
            except OSError:
                pass
            ext.swap_path = None
            if ext.file.backing_path is not None:
                # file-mode store: land the faulted bytes in the backing
                # file (region was reserved at append) so the file stays a
                # complete cross-process image; future swaps are drops
                mm = np.memmap(ext.file.backing_path, dtype=np.uint8,
                               mode="r+", offset=ext.logical_off,
                               shape=(ext.length,))
                mm[:] = data
                mm.flags.writeable = False
                ext.array = mm
                ext.file_backed = True
            else:
                data.flags.writeable = False
                ext.array = data
        ext.file.owner.swap_charged -= ext.length
        ext.file.owner.charge(ext.length)  # may recursively reclaim elsewhere
        self.stats.swapin_bytes += ext.length
        self.stats.swapin_events += 1
        if foreground:
            self.stats.fg_swapin_pages += pages_of(ext.length)
        self._lru_touch(ext)

    def _lru_touch(self, ext: Extent) -> None:
        self._lru_clock += 1
        ext.last_access = self._lru_clock

    def _candidates(self, owner: Optional[Cgroup]) -> List:
        exts = [e for f in self.files.values() if not f.deleted
                for e in f.extents
                if e.resident and not e.pinned_resident
                and (owner is None or f.owner is owner)]
        # anonymous working-set pages are reclaimable too (per-cgroup LRU
        # over anon + file pages, as on Linux §4.1)
        anons = [r for r in self.anon_regions
                 if not r.swapped and r.array is not None
                 and (owner is None or r.cgroup is owner)]
        cands = [(e.last_access, e) for e in exts] + \
                [(r.last_access, r) for r in anons]
        cands.sort(key=lambda t: t[0])
        return [c for _, c in cands]

    def _reclaim_one(self, c) -> int:
        if isinstance(c, AnonRegion):
            n = c.nbytes
            c.swap_out(self)
            return n
        self.swap_out(c)
        return c.length

    def reclaim_cgroup(self, cg: Cgroup, need: int) -> int:
        """Swap out this cgroup's LRU pages until ``need`` bytes are freed.
        This is the mechanism 'limit dropping' manipulates."""
        freed = 0
        for c in self._candidates(cg):
            if freed >= need:
                break
            freed += self._reclaim_one(c)
        return freed

    def kswap(self, need: int) -> int:
        """Global LRU reclaim — the baseline 'kswap' behaviour."""
        freed = 0
        for c in self._candidates(None):
            if freed >= need:
                break
            freed += self._reclaim_one(c)
        return freed

    # -- file-level eviction helpers (RM mechanisms) -----------------------
    def swap_out_file(self, file_id: int) -> int:
        f = self.files.get(file_id)
        if f is None:
            return 0
        n = 0
        for ext in f.extents:
            if ext.resident and not ext.pinned_resident:
                n += ext.length
                self.swap_out(ext)
        return n

    def resident_total(self) -> int:
        return self.global_charged

    def close(self) -> None:
        for fid in list(self.files):
            self.delete_file(fid)
        if self.manifest is not None:
            # published objects + journal outlive the store: that is the
            # point of the durable mode.  Only the live dir is removed.
            self.manifest.close()
        try:
            for p in os.listdir(self.swap_dir):
                os.unlink(os.path.join(self.swap_dir, p))
            os.rmdir(self.swap_dir)
        except OSError:
            pass
        if self.data_dir is not None:
            try:
                for p in os.listdir(self.data_dir):
                    os.unlink(os.path.join(self.data_dir, p))
                os.rmdir(self.data_dir)
            except OSError:
                pass


# --------------------------------------------------------------------------
# lazy buffer views (the mmap-fault analogue)
# --------------------------------------------------------------------------

class LazyBuf:
    """A not-yet-faulted mapping of a store-file range.

    The paper's readers mmap tmpfs files: data is faulted in per page only
    when touched, so a swapped-out column that a node merely passes through
    never costs swap-in I/O.  We reproduce that at buffer granularity: a
    LazyBuf knows its (file, offset, length) provenance and materializes a
    numpy view only when compute actually accesses it.  SIPC's writer can
    reshare an *unforced* LazyBuf directly from provenance — passing a
    column through a node touches no data at all.
    """

    __slots__ = ("store", "file_id", "offset", "length", "np_dtype",
                 "_arr", "on_force", "fault_lock")

    def __init__(self, store: "BufferStore", file_id: int, offset: int,
                 length: int, np_dtype: str = "uint8", on_force=None,
                 fault_lock=None):
        self.store = store
        self.file_id = file_id
        self.offset = offset
        self.length = length
        self.np_dtype = np_dtype
        self._arr: Optional[np.ndarray] = None
        self.on_force = on_force
        # executor critical-section guard: when user code running *outside*
        # the RM lock faults this mapping, the store-mutating read re-enters
        # the lock (see sched/executor.py "Concurrency model")
        self.fault_lock = fault_lock

    @property
    def forced(self) -> bool:
        return self._arr is not None

    @property
    def nbytes(self) -> int:
        return self.length

    def force(self) -> np.ndarray:
        if self._arr is None:
            if self.fault_lock is not None:
                with self.fault_lock:
                    self._force_locked()
            else:
                self._force_locked()
        return self._arr

    def _force_locked(self) -> None:
        if self._arr is not None:
            return
        raw = self.store.get(self.file_id).read(self.offset, self.length)
        arr = raw.view(np.dtype(self.np_dtype))
        if self.on_force is not None:
            self.on_force(raw, self.file_id, self.offset)
        self._arr = arr

    def subrange(self, byte_off: int, byte_len: int,
                 np_dtype: Optional[str] = None) -> "LazyBuf":
        """Lazy slice: adjust provenance, no fault."""
        assert byte_off + byte_len <= self.length
        return LazyBuf(self.store, self.file_id, self.offset + byte_off,
                       byte_len, np_dtype or self.np_dtype, self.on_force,
                       fault_lock=self.fault_lock)


def force_buf(b) -> np.ndarray:
    return b.force() if isinstance(b, LazyBuf) else b


# --------------------------------------------------------------------------
# anonymous memory regions (pre-deanon working memory of a sandbox)
# --------------------------------------------------------------------------

class AnonRegion:
    """A sandbox-owned anonymous allocation (malloc'd Arrow memory).

    Registered by the share wrapper so that (a) it is charged to the
    sandbox's cgroup and (b) it can be swapped under pressure *before*
    de-anonymization — the situation KernelZero's direct-swap optimizes.
    """

    __slots__ = ("array", "cgroup", "swap_path", "swapped", "nbytes",
                 "last_access")

    def __init__(self, array: np.ndarray, cgroup: Cgroup):
        self.array = np.ascontiguousarray(array).view(np.uint8).reshape(-1)
        self.nbytes = self.array.nbytes
        self.cgroup = cgroup
        self.swap_path: Optional[str] = None
        self.swapped = False
        store = cgroup.store
        store._lru_clock += 1
        self.last_access = store._lru_clock
        store.anon_regions.append(self)
        cgroup.charge(self.nbytes)  # may trigger reclaim (incl. of us)

    def swap_out(self, store: BufferStore) -> None:
        if self.swapped:
            return
        path = store._swap_path()
        self.array.tofile(path)
        self.swap_path = path
        self.swapped = True
        self.cgroup.uncharge(self.nbytes)
        self.cgroup.swap_charged += self.nbytes
        store.stats.swapout_bytes += self.nbytes
        store.stats.swapout_events += 1

    def swap_in(self, store: BufferStore) -> None:
        if not self.swapped:
            return
        data = np.fromfile(self.swap_path, dtype=np.uint8, count=self.nbytes)
        try:
            os.unlink(self.swap_path)
        except OSError:
            pass
        arr = self.array
        writeable = arr.flags.writeable
        arr.flags.writeable = True
        arr[:] = data
        arr.flags.writeable = writeable
        self.swap_path = None
        self.swapped = False
        self.cgroup.swap_charged -= self.nbytes
        self.cgroup.charge(self.nbytes)
        store.stats.swapin_bytes += self.nbytes
        store.stats.swapin_events += 1
        store.stats.fg_swapin_pages += pages_of(self.nbytes)

    def release(self) -> None:
        if self.swapped:
            self.cgroup.swap_charged -= self.nbytes
            if self.swap_path:
                try:
                    os.unlink(self.swap_path)
                except OSError:
                    pass
            self.swapped = False
            self.swap_path = None
        elif self.array is not None:
            self.cgroup.uncharge(self.nbytes)
        self.array = None  # type: ignore[assignment]
        try:
            self.cgroup.store.anon_regions.remove(self)
        except ValueError:
            pass
