"""DAGs, node sandboxes and the share wrapper (paper §3.1, §4.2.3).

A DAG node runs arbitrary user code over Arrow tables.  Each node executes
inside a ``Sandbox`` — the container analogue: it owns a cgroup (memory
charging + dynamic limit for limit-dropping), an anonymous-memory registry
(the pre-deanon working set), and the *share wrapper* that (1) SIPC-reads
the inputs (recording mapped address ranges), (2) invokes the user
function, and (3) SIPC-writes the returned table, de-anonymizing or
resharing each output buffer.  User code never touches SIPC (Goals G4/G5).

The sandbox (cgroup) is retained after the node completes so the RM can
evict its outputs later (limit dropping) — exactly the SOCK modification
described in §4.2.3.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .arrow import Table
from .buffers import AnonRegion, BufferStore, Cgroup
from .deanon import KernelZero
from .sipc import AddressMap, SipcMessage, SipcReader, SipcWriter

UserFn = Callable[[List[Table]], Table]


@dataclass
class NodeSpec:
    name: str
    fn: Optional[UserFn] = None          # None for loader nodes
    deps: List[str] = field(default_factory=list)
    est_mem: int = 0                     # bytes the RM reserves at admission
    # loader-node parameters (generic loader code — paper §3.1):
    source: Optional[str] = None         # zarquet path
    dict_columns: tuple = ()
    columns: Optional[tuple] = None      # column subset to load (None =
    #                                    # all) — projection pruning: the
    #                                    # plan optimizer narrows loaders
    #                                    # so unused columns are never
    #                                    # read, decompressed or charged
    row_groups: Optional[tuple] = None   # row-group subset of a stream
    #                                    # zarquet source (None = whole
    #                                    # file) — the incremental-
    #                                    # recompute driver pins loaders
    #                                    # to committed groups, whose
    #                                    # content hashes are immutable,
    #                                    # so an append invalidates only
    #                                    # the new tail's consumers
    keep_output: bool = False            # survive DAG completion (sinks
    #                                    # consumed by an external reader)


# node lifecycle — an explicit state machine so the scheduler's claims are
# verifiable under concurrency (all transitions happen inside the
# executor's RM critical section; see core/sched/executor.py)
WAITING, READY, RUNNING, DONE, EVICTED, CACHED = \
    "waiting", "ready", "running", "done", "evicted", "cached"

#: node states that count as complete (outputs available / not needed)
COMPLETE = (DONE, CACHED)

#: legal lifecycle transitions.  WAITING/EVICTED -> RUNNING is the
#: scheduler's *claim* (exclusive: only one worker can perform it because
#: it happens under the executor lock); DONE -> EVICTED is a rollback.
#: WAITING/EVICTED -> CACHED is a cross-run differential-cache hit: the
#: output is adopted from the persistent manifest instead of executing;
#: CACHED -> EVICTED is a rollback of the adopted output (the durable
#: entry stays on disk, so the node can be re-adopted or re-executed).
VALID_TRANSITIONS = {
    WAITING: (READY, RUNNING, CACHED),
    READY: (WAITING, RUNNING, CACHED),
    RUNNING: (DONE, WAITING),
    DONE: (EVICTED,),
    CACHED: (EVICTED,),
    EVICTED: (RUNNING, CACHED),
}


class InvalidTransition(RuntimeError):
    """An illegal node-lifecycle transition (scheduler logic error)."""


class NodeState:
    def __init__(self, spec: NodeSpec, dag: "DAG"):
        self.spec = spec
        self.dag = dag
        self.status = WAITING
        self.output: Optional[SipcMessage] = None
        self.sandbox: Optional[Sandbox] = None
        self.exec_latency = 0.0          # for adaptive eviction
        self.output_bytes = 0
        self.depth = 0
        self.runs = 0                    # re-executions due to rollback
        self.fingerprint: Optional[str] = None   # cross-run cache identity

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def is_loader(self) -> bool:
        return self.spec.source is not None

    def decache_key(self):
        # fingerprints are content-addressed (source bytes, not path), so
        # keying the DeCache on them lets manifest warming serve re-runs;
        # fall back to the path key when fingerprinting is off/uncacheable
        if self.fingerprint is not None:
            return self.fingerprint
        return (self.spec.source, tuple(sorted(self.spec.dict_columns)),
                None if self.spec.columns is None
                else tuple(sorted(self.spec.columns)),
                None if self.spec.row_groups is None
                else tuple(self.spec.row_groups))

    def transition(self, new_status: str) -> None:
        """Move through the lifecycle, validating against
        ``VALID_TRANSITIONS``.  Callers must hold the executor lock when
        the DAG is being executed concurrently."""
        if new_status not in VALID_TRANSITIONS[self.status]:
            raise InvalidTransition(
                f"node {self.dag.name}.{self.name}: "
                f"{self.status} -> {new_status}")
        self.status = new_status

    def claim(self) -> None:
        """Scheduler claim: WAITING/EVICTED -> RUNNING."""
        self.transition(RUNNING)


class DAG:
    _next_id = 0
    _id_lock = threading.Lock()

    def __init__(self, nodes: Sequence[NodeSpec], name: str = "",
                 deadline: Optional[float] = None,
                 tenant: Optional[str] = None):
        with DAG._id_lock:
            DAG._next_id += 1
            self.id = DAG._next_id
        self.name = name or f"dag{self.id}"
        self.deadline = deadline        # for the deadline-aware policy;
        #                               # enforced against time.monotonic()
        #                               # when RMConfig.enforce_deadlines
        self.tenant = tenant or self.name   # fair-share grouping key
        # serving-plane outcome channel (core/sched/executor.py):
        # cancelled stops further claims (in-flight nodes drain); outcome
        # is a typed terminal string — "completed", "shed:<reason>",
        # "deadline_miss", "poisoned", "failed:<exc>" — or None while the
        # DAG is still live; error carries the poisoning/failing exception
        self.cancelled = False
        self.outcome: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.nodes: Dict[str, NodeState] = {s.name: NodeState(s, self)
                                            for s in nodes}
        self.children: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for s in nodes:
            for d in s.deps:
                self.children[d].append(s.name)
        # depth = longest distance from a root; priority = deeper first
        order = self.topo_order()
        for n in order:
            st = self.nodes[n]
            st.depth = max([self.nodes[d].depth + 1
                            for d in st.spec.deps], default=0)
        self.done = False

    def topo_order(self) -> List[str]:
        seen, out = set(), []
        def visit(n: str) -> None:
            if n in seen:
                return
            seen.add(n)
            for d in self.nodes[n].spec.deps:
                visit(d)
            out.append(n)
        for n in self.nodes:
            visit(n)
        return out

    def runnable(self) -> List[NodeState]:
        if self.cancelled:
            return []               # cooperative cancel: no new claims
        out = []
        for st in self.nodes.values():
            if st.status in (WAITING, EVICTED):
                deps = [self.nodes[d] for d in st.spec.deps]
                if all(d.status in COMPLETE and d.output is not None
                       and not d.output.released for d in deps):
                    out.append(st)
        return out

    def all_done(self) -> bool:
        if self.cancelled:
            # a cancelled DAG is finished once its in-flight nodes drain
            return not any(st.status == RUNNING
                           for st in self.nodes.values())
        return all(st.status in COMPLETE for st in self.nodes.values())


class Sandbox:
    """Container analogue: cgroup + anon registry + share wrapper."""

    def __init__(self, store: BufferStore, kz: KernelZero, name: str,
                 mode: str = "zero", mem_limit: Optional[int] = None):
        self.store = store
        self.kz = kz
        self.name = name
        self.mode = mode
        self.cgroup = store.new_cgroup(name, mem_limit)
        self.anon: List[AnonRegion] = []
        self.input_map = AddressMap()
        self.owned_files: List[int] = []

    # -- anonymous-memory management (the malloc'd working set) -------------
    def register_anon(self, arr: np.ndarray) -> AnonRegion:
        r = AnonRegion(arr, self.cgroup)
        self.anon.append(r)
        return r

    def anon_region_for(self, arr: np.ndarray) -> Optional[AnonRegion]:
        for r in self.anon:
            if r.array is arr or (r.array is not None and
                                  r.array.base is getattr(arr, "base", None)
                                  and arr.base is not None):
                return r
        return None

    # -- the share wrapper ---------------------------------------------------
    def run(self, fn: UserFn, inputs: List[SipcMessage],
            label: str = "", lock=None) -> SipcMessage:
        """SIPC-read inputs, invoke the user function, SIPC-write the
        result.  With ``lock`` (the executor's RM critical section), the
        store-mutating phases — input reads, output write, and any
        LazyBuf fault the user code triggers — run *inside* the lock
        while the user function itself runs outside it, so vectorized
        (GIL-releasing) compute overlaps across executor workers."""
        reader = SipcReader(self.store, self.mode, record_map=self.input_map,
                            fault_lock=lock)
        if lock is None:
            tables = [reader.read_table(m) for m in inputs]
            out_table = fn(tables)
            return self.write_output(out_table, label)
        with lock:
            tables = [reader.read_table(m) for m in inputs]
        out_table = fn(tables)
        with lock:
            return self.write_output(out_table, label)

    def write_output(self, table: Table, label: str = "") -> SipcMessage:
        writer = SipcWriter(self.store, self.kz, self.cgroup, self.mode,
                            input_map=self.input_map,
                            label=label or self.name)
        msg = writer.write_table(table)
        # anon regions whose memory was transferred are now file-owned;
        # release the remainder (the wrapper is the last code that runs and
        # never frees data already sent via SIPC — §4.2.3)
        for r in self.anon:
            if r.array is not None or r.swapped:
                r.release()
        self.anon = []
        self.owned_files.extend(
            fid for fid in msg.files_referenced()
            if fid in self.store.files and
            self.store.files[fid].owner is self.cgroup)
        return msg

    # -- eviction interface ---------------------------------------------------
    def drop_limit_and_swap(self) -> int:
        """Limit dropping: set the cgroup limit to 0, forcing its tmpfs
        pages out to swap, then restore (paper §3.1/§4.2.5)."""
        prev = self.cgroup.limit
        swapped = 0
        for fid in self.owned_files:
            swapped += self.store.swap_out_file(fid)
        self.cgroup.set_limit(prev)
        return swapped

    def destroy(self) -> None:
        for r in self.anon:
            r.release()
        self.anon = []
        self.cgroup.alive = False
