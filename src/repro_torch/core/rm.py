"""Resource Manager: accounting + back-compat facade over ``core/sched``
(paper §3.1, §3.3, §4.2.5).

The RM's four actions (Fig 3a) now live in separate layers:

  RM:alloc     — admission control (sched/admission.py) + priority
                 scheduling (sched/policy.py)
  RM:uncache   — drop zero-reference DeCache entries (sched/eviction.py,
                 step 1 of the memory-freeing sequence)
  RM:rollback  — delete a completed node's outputs; re-execute it later
                 (sched/eviction.py RollbackEviction)
  RM:limitdrop — drop the node sandbox's cgroup limit so its tmpfs output
                 swaps to disk (sched/eviction.py LimitDropEviction)

What remains here is what the RM actually *owns*: configuration, the
eviction counters, the completed-node set, and refcount-safe GC — the
share-awareness invariant that underlying files are freed only when
IPC-inspection-derived refcounts hit zero, so resharing never causes
use-after-free (Challenge 6).

``Executor`` is the worker-pool executor from sched/executor.py, re-
exported under its historical name; ``Executor(store, rm)`` with the
default ``workers=1`` reproduces the seed's sequential semantics exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .buffers import BufferStore, OOMError
from .dag import NodeState
from .deanon import KernelZero
from .decache import DeCache
from .sipc import SipcMessage
from .sched.admission import AdmissionController
from .sched.eviction import (EvictionPolicy, POLICIES, get_eviction)
from .sched.executor import ProcessWorkerExecutor, WorkerPoolExecutor
from .sched.policy import SCHEDULES, get_schedule

# historical name: benchmarks/tests/examples construct `Executor(store, rm)`
Executor = WorkerPoolExecutor

#: executor selection by name (``RMConfig.workers_mode``)
WORKERS_MODES = ("thread", "process")


@dataclass
class RMConfig:
    memory_limit: Optional[int] = None       # admission-control budget (bytes)
    admission: bool = True
    policy: str = "adaptive"                 # eviction mechanism (POLICIES)
    decache: bool = True
    sipc_mode: str = "zero"                  # full_copy|writer_copy|zero|...
    adaptive_threshold: float = 1.0 / (1.5e9)  # s/byte ≈ 1/swap-bandwidth
    direct_swap: bool = True
    schedule: str = "depth"   # scheduling priority (SCHEDULES):
    #                         # 'depth' (paper: closest-to-finishing first),
    #                         # 'breadth', 'fair', 'deadline'
    workers: int = 1          # executor worker-pool size (1 = sequential)
    reader_threads: Optional[int] = None   # per-loader zarquet reader pool:
    #                                      # fan column-chunk decompression
    #                                      # across this many threads inside
    #                                      # one read_table (None = auto:
    #                                      # ZERROW_READER_THREADS env, else
    #                                      # min(4, cpu count); 1 = serial)
    workers_mode: str = "thread"   # 'thread' (in-process pool) or 'process'
    #                              # (Flight: ops in spawned OS processes;
    #                              # needs BufferStore(backing='file'))
    cache_root: Optional[str] = None   # persistent content-addressed cache
    #                                  # directory: node outputs are
    #                                  # published under deterministic
    #                                  # fingerprints and re-runs adopt
    #                                  # unchanged nodes' outputs (CACHED)
    #                                  # instead of executing them
    publish_outputs: bool = True   # durable mode: publish every completed
    #                              # node output (False: adopt-only reader)
    flight_timeout_s: float = 600.0   # process mode: per-request reply
    #                                 # deadline on the flight data plane
    #                                 # (a worker past it is presumed hung
    #                                 # and retired; the request retries
    #                                 # on a surviving worker)
    chain_dispatch: bool = True    # process mode: ship linear picklable
    #                              # DAG segments as one exec_chain
    #                              # request (intermediates stay worker-
    #                              # local); False = per-node dispatch
    # -- overload & fault model (multi-tenant serving) ---------------------
    tenant_budgets: Optional[Dict[str, int]] = None   # per-tenant memory
    #                              # reservation ceilings (bytes); a DAG
    #                              # whose largest node cannot ever fit its
    #                              # tenant's budget is shed at offer time,
    #                              # and admission refuses claims that
    #                              # would push a tenant past its ceiling
    max_queue_depth: Optional[int] = None   # bounded admission queue: at
    #                              # most this many DAGs queued+active per
    #                              # executor; excess offers are shed with
    #                              # outcome "shed:overloaded" (None = no
    #                              # bound: batch mode, never sheds)
    overload_threshold: float = 1.0   # shed deadline-hopeless DAGs when
    #                              # (queue depth fraction) x (reservation
    #                              # pressure) reaches this
    enforce_deadlines: bool = False   # interpret DAG.deadline against
    #                              # time.monotonic() and cancel DAGs past
    #                              # it (False: deadline is an ordering
    #                              # hint only — the seed semantics)
    max_node_retries: int = 3      # process mode: transport-failure
    #                              # (FlightWorkerLost) retries per request
    #                              # before the op is quarantined as
    #                              # poisoned and fails its DAG
    retry_backoff_s: float = 0.05  # base of the capped exponential backoff
    #                              # between those retries
    verify_objects: bool = False   # manifest verify-on-adopt: re-hash
    #                              # objects against their content address
    #                              # before serving them (catches at-rest
    #                              # corruption at full-read cost)


def make_executor(store: BufferStore, rm: "ResourceManager",
                  workers: Optional[int] = None,
                  mode: Optional[str] = None) -> WorkerPoolExecutor:
    """Build the executor selected by ``mode`` (or ``rm.cfg.workers_mode``)."""
    mode = mode or getattr(rm.cfg, "workers_mode", "thread")
    assert mode in WORKERS_MODES, f"unknown workers_mode {mode!r}"
    if mode == "process":
        return ProcessWorkerExecutor(store, rm, workers)
    return WorkerPoolExecutor(store, rm, workers)


class ResourceManager:
    """Accounting + component wiring.  The admission/eviction/schedule
    components hold a back-reference here for counters and GC."""

    def __init__(self, store: BufferStore, config: RMConfig):
        assert config.policy in POLICIES, \
            f"unknown eviction policy {config.policy!r}"
        self.store = store
        self.cfg = config
        self.kz = KernelZero(store)
        self.manifest = getattr(store, "manifest", None)
        if config.cache_root and self.manifest is None:
            if store.backing != "file":
                raise ValueError(
                    "RMConfig.cache_root needs a file-backed store: "
                    "construct BufferStore(backing='file', "
                    "root=cache_root)")
            store.attach_manifest(config.cache_root)
            self.manifest = store.manifest
        self.decache = DeCache(store, enabled=config.decache,
                               manifest=self.manifest)
        if self.manifest is not None and config.verify_objects:
            self.manifest.verify_objects = True
        self.evictions = {"uncache": 0, "rollback": 0, "limitdrop": 0,
                          "spill": 0, "storm_breaks": 0}
        self.cache_stats = {"hits": 0, "published": 0, "adopted_bytes": 0}
        # serving-plane outcome counters (admission layer writes them);
        # the invariant the bench gates on: offered == admitted + shed,
        # and admitted == completed + deadline_misses + poisoned + failed
        self.serve_stats = {"offered": 0, "admitted": 0, "shed": 0,
                            "shed_overloaded": 0, "shed_deadline": 0,
                            "shed_tenant_budget": 0, "shed_quarantined": 0,
                            "deadline_misses": 0, "poisoned": 0,
                            "failed": 0, "completed": 0}
        #: poison keys (code fingerprints) of ops that repeatedly killed
        #: their worker — DAGs containing one are shed at offer time
        self.quarantined: Set[str] = set()
        self.completed_nodes: List[NodeState] = []   # eviction candidates
        self.schedule = get_schedule(config.schedule)
        self.admission = AdmissionController(self)
        self.eviction: EvictionPolicy = get_eviction(config.policy, self)
        # direct mechanism handles for the back-compat methods below
        self._rollback = get_eviction("rollback", self)
        self._limitdrop = get_eviction("limitdrop", self)

    # -- accounting (delegated to the admission layer) ---------------------
    def available(self) -> int:
        return self.admission.available()

    def admit(self, node: NodeState) -> bool:
        return self.admission.admit(node)

    def make_room_for(self, node: NodeState,
                      extra_protect: FrozenSet[Tuple[int, str]] = frozenset(),
                      ) -> None:
        self.admission.make_room_for(node, extra_protect)

    # -- poison quarantine (process-mode permanent failures) ---------------
    @staticmethod
    def poison_key(fn) -> Optional[str]:
        """Stable identity for a user op across DAG instances, so a
        quarantine entered by one request also sheds the next request
        carrying the same op.  Loader nodes (fn=None) are never
        quarantined — worker death while loading is environmental, not
        the op's fault."""
        if fn is None:
            return None
        from .fingerprint import code_fingerprint
        fp = code_fingerprint(fn)
        if fp is not None:
            return fp
        return f"{getattr(fn, '__module__', '?')}:" \
               f"{getattr(fn, '__qualname__', repr(fn))}"

    # -- memory-freeing sequence (delegated to the eviction layer) ---------
    MAX_EVICTIONS_PER_ALLOC = EvictionPolicy.MAX_EVICTIONS_PER_ALLOC

    def free_memory(self, need: int,
                    protect: Optional[NodeState] = None) -> int:
        return self.eviction.free_memory(need, protect)

    def eviction_candidates(self, protect: Optional[NodeState]
                            ) -> List[NodeState]:
        return self.eviction.victims(protect)

    def evict_node_output(self, st: NodeState) -> int:
        return self.eviction.evict(st)

    def rollback(self, st: NodeState) -> int:
        return self._rollback.evict(st)

    def limitdrop(self, st: NodeState) -> int:
        return self._limitdrop.evict(st)

    # -- cross-run differential cache (manifest adoption/publication) ------
    def adopt_cached(self, st: NodeState) -> Optional[SipcMessage]:
        """Adopt a node's published output from the manifest (zero bytes
        copied: the objects are mmap'd).  The adopted bytes are charged to
        a per-node consumer cgroup, exactly where executed-output bytes
        would land, so admission/eviction govern them.  Returns None on a
        miss (or when the entry's objects vanished)."""
        if self.manifest is None or st.fingerprint is None:
            return None
        cg = self.store.new_cgroup(f"{st.dag.name}.{st.name}.cached")
        msg = self.manifest.decode(st.fingerprint, self.store, owner=cg,
                                   label=st.name)
        if msg is None:
            return None
        st.output = msg
        st.output_bytes = msg.new_bytes
        self.cache_stats["hits"] += 1
        self.cache_stats["adopted_bytes"] += msg.new_bytes
        if st not in self.completed_nodes:
            self.completed_nodes.append(st)   # adopted bytes are evictable
        return msg

    def publish_output(self, st: NodeState) -> None:
        """Durably publish a completed node's output under its
        fingerprint (best-effort: a full disk must not fail the run)."""
        if (self.manifest is None or not self.cfg.publish_outputs
                or st.fingerprint is None or st.output is None
                or st.output.released):
            return
        try:
            self.manifest.publish(self.store, st.fingerprint, st.output,
                                  label=f"{st.dag.name}.{st.name}")
            self.cache_stats["published"] += 1
        except OSError:
            pass

    def is_durable(self, st: NodeState) -> bool:
        """True when this node's output is recoverable from the manifest,
        so eviction may spill (drop mappings) instead of discarding."""
        return self.manifest is not None and st.fingerprint in self.manifest

    # -- refcount GC (the share-awareness invariant) -----------------------
    def _resident_of(self, msg: SipcMessage) -> int:
        total = 0
        for fid in msg.files_referenced():
            f = self.store.files.get(fid)
            if f is not None and f.refcount == 1 and not f.decache_pinned:
                total += f.resident_bytes()
        return total

    def _gc(self, msg: SipcMessage) -> None:
        for fid in msg.files_referenced():
            f = self.store.files.get(fid)
            if f is not None and f.refcount == 0 and not f.decache_pinned:
                self.store.delete_file(fid)

    def release_output(self, st: NodeState) -> None:
        if st.output is not None and not st.output.released:
            msg = st.output
            msg.release()
            self._gc(msg)
