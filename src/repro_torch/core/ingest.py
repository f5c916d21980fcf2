"""Continuous differential recompute over streaming zarquet ingest.

``zarquet.StreamWriter`` commits micro-batches as immutable row groups;
this module closes the loop: ``IncrementalRecompute`` watches a stream
table and, after each ACKed commit, re-runs its consumer DAG — one
loader per committed row group (``NodeSpec.row_groups=(g,)``), an
optional per-group map stage, and a reduce over all groups — through
the ordinary executor.  Because committed group extents (and therefore
their footer content hashes) are immutable, every loader and map node
over the *stable prefix* re-fingerprints to exactly the value it had
last refresh: the persistent manifest marks those cones ``CACHED`` before any
scheduling and the executor recomputes only the new tail's load→map
cone plus the reduce (whose input set changed).  Nodes recomputed per
micro-batch is O(tail), not O(table) — the one-shard-diff result made
continuous.

Serving stays concurrent with recompute: the latest reduce output is
held as a refcounted snapshot.  Readers pin it (``with
driver.snapshot() as (table, version)``) for zero-copy reads while the
next refresh runs; a superseded snapshot is released only when its last
reader lets go, so a swap never invalidates an in-progress query.

The reduce stage defaults to ``ops.concat_tables`` — row concatenation
is batch-list concatenation, zero new bytes — so "the whole table as of
version v" is itself a zero-copy view over per-group cached outputs.
Order-dependent aggregations (float sums) belong *after* the concat,
over the combined table, so incremental results stay bit-identical to a
from-scratch run over the same groups.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, List, Optional

from . import faultplane, ops, zarquet
from .arrow import Table
from .dag import DAG, NodeSpec
from .sipc import SipcReader

UserFn = Callable[[List[Table]], Table]

faultplane.register_hook("refresh_pre_swap", "ingest: fail a refresh "
                         "after the DAG ran but before the served "
                         "snapshot swaps (readers must keep the old "
                         "version)")


@dataclass
class RefreshStats:
    """What one ``refresh()`` did — the differential-recompute receipt."""
    version: int            # stream footer version this refresh is of
    groups: int             # committed row groups at that version
    nodes_total: int        # DAG size (cold run executes all of these)
    nodes_executed: int     # nodes actually run (the affected cone)
    cache_hits: int         # nodes satisfied CACHED from the manifest
    wall_s: float


def _release_msg(msg, store) -> None:
    """Release a kept output and GC its store files once unreferenced
    (same ownership discipline as the data pipeline's batch loop)."""
    msg.release()
    for fid in list(msg.files_referenced()):
        f = store.files.get(fid)
        if f is not None and f.refcount == 0 and not f.decache_pinned:
            store.delete_file(fid)


class _Snapshot:
    """Refcounted served table version.  The driver holds one reference;
    each in-progress reader holds one more.  The backing message is
    released when the last reference drops — after the driver swapped in
    a newer version AND every reader of this one finished."""

    def __init__(self, msg, version: int, store):
        self.msg = msg
        self.version = version
        self._store = store
        self._lock = threading.Lock()
        self._refs = 1

    def acquire(self) -> None:
        with self._lock:
            self._refs += 1

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            free = self._refs == 0
        if free:
            _release_msg(self.msg, self._store)


class IncrementalRecompute:
    """Differential rerun driver for one stream zarquet table.

    ``refresh()`` re-fingerprints the consumer DAG against the stream's
    committed footer and runs it; untouched group cones adopt from the
    manifest (``CACHED``), so only the new tail executes.  Requires a
    persistent manifest (``RMConfig(cache_root=...)``) — without it
    every refresh would re-execute the whole DAG, which defeats the
    point loudly rather than silently.

    ``map_fn`` (optional) runs once per row group — per-micro-batch
    transform work that is never repeated for old groups.  ``reduce_fn``
    combines the per-group outputs in group order (default
    ``ops.concat_tables``: zero-copy).  Both must be picklable
    module-level callables for process-mode workers and deterministic
    for fingerprinting (see ``core/fingerprint.py``).
    """

    def __init__(self, path: str, *, store, rm, executor,
                 map_fn: Optional[UserFn] = None,
                 reduce_fn: Optional[UserFn] = None,
                 dict_columns: tuple = (),
                 columns: Optional[tuple] = None,
                 name: Optional[str] = None,
                 tenant: str = "default",
                 deadline_s: Optional[float] = None):
        if rm.manifest is None:
            raise ValueError(
                "IncrementalRecompute needs cross-run fingerprint caching "
                "to be differential: construct the ResourceManager with "
                "RMConfig(cache_root=...)")
        self.path = path
        self.store = store
        self.rm = rm
        self.ex = executor
        self.map_fn = map_fn
        self.reduce_fn = reduce_fn if reduce_fn is not None \
            else ops.concat_tables
        self.dict_columns = tuple(dict_columns)
        self.columns = None if columns is None else tuple(columns)
        self._name = name or f"ingest-{os.path.basename(path)}"
        # admission identity of refresh DAGs: the per-tenant memory
        # budget and (when enforcement is on) the per-refresh deadline
        # apply to recompute work like to any other submitted DAG
        self.tenant = tenant
        self.deadline_s = deadline_s
        self._lock = threading.Lock()
        self._snap: Optional[_Snapshot] = None
        self.last = RefreshStats(0, 0, 0, 0, 0, 0.0)

    @property
    def version(self) -> int:
        """Stream footer version of the currently served snapshot."""
        with self._lock:
            return self._snap.version if self._snap is not None else 0

    def refresh(self) -> RefreshStats:
        """Rebuild + rerun the consumer DAG over the stream's committed
        groups, swap the served snapshot, and report the cone that
        actually executed.  Safe to call from an ingest/ACK thread while
        other threads serve queries (the executor's run gate serializes
        DAG batches; readers never block on a refresh)."""
        meta = zarquet.read_footer(self.path)
        groups = meta.get("groups")
        if groups is None:
            raise ValueError(f"{self.path}: not a stream zarquet table")
        k = len(groups)
        version = meta.get("version", 0)
        if k == 0:
            self.last = RefreshStats(version, 0, 0, 0, 0, 0.0)
            return self.last
        est = max(os.path.getsize(self.path) * 8 // k, 1 << 18)
        nodes: List[NodeSpec] = []
        reduce_deps: List[str] = []
        for g in range(k):
            lname = f"load_g{g}"
            nodes.append(NodeSpec(lname, source=self.path, est_mem=est,
                                  dict_columns=self.dict_columns,
                                  columns=self.columns, row_groups=(g,)))
            dep = lname
            if self.map_fn is not None:
                mname = f"map_g{g}"
                nodes.append(NodeSpec(mname, fn=self.map_fn, deps=[lname],
                                      est_mem=est))
                dep = mname
            reduce_deps.append(dep)
        nodes.append(NodeSpec("reduce", fn=self.reduce_fn,
                              deps=reduce_deps, est_mem=est * k,
                              keep_output=True))
        deadline = None if self.deadline_s is None \
            else time.monotonic() + self.deadline_s
        dag = DAG(nodes, name=f"{self._name}-v{version}",
                  tenant=self.tenant, deadline=deadline)
        runs0, hits0 = self.ex.node_runs, self.ex.cache_hits
        wall = self.ex.run([dag])
        out = dag.nodes["reduce"].output
        if dag.cancelled or out is None:
            # shed / deadline-missed / poisoned refresh: the served
            # snapshot is untouched — readers keep the previous version
            raise RuntimeError(
                f"{self._name}: refresh v{version} did not complete "
                f"(outcome={dag.outcome!r})")
        try:
            injected = faultplane.fire("refresh_pre_swap")
        except BaseException:
            _release_msg(out, self.store)
            raise
        if injected in ("torn", "corrupt"):
            # kill/raise execute inside fire(); delay/stall just slow the
            # swap down — only the write-mangling actions abort it here
            _release_msg(out, self.store)
            raise RuntimeError(
                f"{self._name}: refresh v{version} aborted pre-swap "
                "(injected)")
        new = _Snapshot(out, version, self.store)
        with self._lock:
            old, self._snap = self._snap, new
        if old is not None:
            old.release()           # readers of the old version keep it
        self.last = RefreshStats(
            version=version, groups=k, nodes_total=len(nodes),
            nodes_executed=self.ex.node_runs - runs0,
            cache_hits=self.ex.cache_hits - hits0, wall_s=wall)
        return self.last

    @contextmanager
    def snapshot(self):
        """Pin + yield ``(table, version)`` of the latest refresh.  The
        table is a zero-copy SIPC view of the reduce output; it stays
        mapped for the whole ``with`` block even if newer versions land
        meanwhile."""
        with self._lock:
            snap = self._snap
            if snap is None:
                raise RuntimeError(
                    f"{self._name}: no refresh has completed yet")
            snap.acquire()
        try:
            yield SipcReader(self.store).read_table(snap.msg), snap.version
        finally:
            snap.release()

    def close(self) -> None:
        """Drop the driver's reference to the served snapshot."""
        with self._lock:
            snap, self._snap = self._snap, None
        if snap is not None:
            snap.release()
