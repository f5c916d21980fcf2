"""Event-driven worker-pool DAG executor (the RM run loop, paper §3.1/§3.3).

``WorkerPoolExecutor`` replaces the seed's sequential ``Executor.run``
monolith with four pluggable layers:

  scheduling  — a :class:`~..sched.policy.SchedulePolicy` orders runnable
                nodes (``RMConfig.schedule``);
  admission   — the :class:`~.admission.AdmissionController` budget check;
  eviction    — an :class:`~.eviction.EvictionPolicy` frees memory for the
                chosen node (``RMConfig.policy``);
  execution   — N workers pull admitted nodes and run them concurrently.

Concurrency model (``workers > 1``):

  * One re-entrant lock — the *RM critical section* — protects all
    scheduler, RM, DeCache and BufferStore state.  Node *claims*
    (WAITING/EVICTED -> RUNNING transitions), completion bookkeeping,
    eviction, and SIPC reads/writes all happen under it.
  * Loader nodes release the lock around zarquet decompression, which
    drops the GIL (zstd/zlib), so deserialization overlaps across workers
    — the parallelism the paper notes in Fig 2.  Each decompressed buffer
    re-enters the lock briefly to register as sandbox anonymous memory.
  * Compute nodes release the lock around the user function: SIPC reads
    the inputs under the lock, the fn runs outside it (the vkernels bulk
    numpy ops release the GIL), and the SIPC output write re-enters it.
    A LazyBuf the fn faults mid-compute re-acquires the lock for the
    store-mutating read (``LazyBuf.fault_lock``).
  * Loads are single-flight per DeCache key: a worker that finds another
    worker already deserializing the same ``(source, dict_columns)`` waits
    and attaches to the cached entry instead of duplicating the load.
  * Eviction only runs when the pool is drained (no in-flight nodes):
    evicting an output a running node is reading would be a use-after-free.
    Workers that cannot admit anything while peers run simply wait for a
    completion event.

``workers=1`` executes inline on the calling thread with the exact
scheduling semantics of the seed's sequential loop (same node order, same
``node_runs`` / ``load_runs`` / eviction counts).
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..dag import (CACHED, COMPLETE, DAG, DONE, EVICTED, NodeState, RUNNING,
                   Sandbox, WAITING)
from ..fingerprint import fingerprint_dag
from .. import zarquet

#: sentinel: nothing runnable now, but in-flight nodes may unblock us
_WAIT = object()


class NodePoisonedError(RuntimeError):
    """A node op killed its worker ``max_node_retries`` times in a row.

    The op is treated as permanently poisonous: its code fingerprint is
    quarantined on the RM (subsequent DAGs carrying it are shed with
    ``"shed:quarantined"``) and *its own DAG* fails with outcome
    ``"poisoned"`` — the pool is healed and every other DAG keeps
    running.  ``fns`` carries the candidate culprit callables (the whole
    segment for a chain dispatch, where the killer step is unknowable —
    the worker died before saying which)."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.fns: list = []


class Ticket:
    """Serving-plane handle for one submitted DAG (``Executor.submit``).

    Resolves when the DAG reaches a terminal outcome — "completed",
    "shed:<reason>" (never ran), "deadline_miss", "poisoned", or
    "failed:<exc>".  ``wait`` never raises: overload is data, not an
    exception, in a serving loop."""

    def __init__(self, dag: DAG):
        self.dag = dag
        self.submitted_at = time.monotonic()
        self.finished_at: Optional[float] = None
        self._ev = threading.Event()

    def _resolve(self) -> None:
        self.finished_at = time.monotonic()
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float] = None) -> Optional[str]:
        """Block until terminal; returns the outcome (None on timeout)."""
        self._ev.wait(timeout)
        return self.dag.outcome if self._ev.is_set() else None

    @property
    def outcome(self) -> Optional[str]:
        return self.dag.outcome

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-terminal seconds (sheds resolve in microseconds)."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at


class WorkerPoolExecutor:
    """Pull-based executor: workers repeatedly (schedule -> execute ->
    complete) until every submitted DAG is done.

    ``workers`` defaults to ``rm.cfg.workers``.  The instance is reusable
    across ``run`` calls (counters accumulate, as before) but a single
    instance must not run concurrently with itself.
    """

    def __init__(self, store, rm, workers: Optional[int] = None,
                 force_threads: bool = False):
        self.store = store
        self.rm = rm
        if workers is None:
            workers = getattr(rm.cfg, "workers", 1)
        self.workers = max(int(workers or 1), 1)
        # run workers=1 through the thread pool instead of inline (used by
        # tests to prove pool(1) ≡ sequential)
        self.force_threads = force_threads
        # scheduler threads pulling nodes; the process executor runs more
        # of them than workers so that while every worker computes, spare
        # threads encode and submit the next requests (pipelined dispatch)
        self.sched_threads = self.workers
        self.node_runs = 0
        self.load_runs = 0
        self.cache_hits = 0     # nodes satisfied from the persistent
        #                       # manifest (marked CACHED, never executed)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # run() resets per-run state (_active/_attach/_inflight), so one
        # instance must never run two batches concurrently; the gate
        # serializes concurrent submitters (e.g. a streaming-ingest
        # refresh thread and serving threads sharing one executor)
        # instead of corrupting each other's run
        self._run_gate = threading.Lock()
        self._active: Dict[int, DAG] = {}
        self._attach: Dict[int, list] = {}
        self._inflight: Dict[Tuple[int, str], NodeState] = {}
        self._loading: Set[tuple] = set()
        self._error: Optional[BaseException] = None
        # serving-plane submission (submit/Ticket): offered DAGs queue
        # here and a lazily started dispatcher thread runs them in waves
        # through the normal run gate
        self._submit_cv = threading.Condition(threading.Lock())
        self._pending_tickets: List[Ticket] = []
        self._dispatcher: Optional[threading.Thread] = None
        self._shutdown = False

    # -- entry point -------------------------------------------------------
    def run(self, dags: List[DAG], deadline_s: float = 3600.0) -> float:
        with self._run_gate:
            return self._run_gated(dags, deadline_s)

    # -- serving-plane submission ------------------------------------------
    def submit(self, dag: DAG, now: Optional[float] = None) -> Ticket:
        """Offer one DAG to the bounded admission queue.  Returns a
        :class:`Ticket` immediately: shed DAGs resolve on the spot with a
        typed ``"shed:<reason>"`` outcome (no exception, no execution);
        admitted DAGs run in dispatcher waves and resolve when terminal.
        Safe to call concurrently from many request threads."""
        ticket = Ticket(dag)
        if self.rm.admission.offer(dag, now) is not None:
            ticket._resolve()
            return ticket
        with self._submit_cv:
            self._pending_tickets.append(ticket)
            if self._dispatcher is None:
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, name="zerrow-dispatch",
                    daemon=True)
                self._dispatcher.start()
            self._submit_cv.notify_all()
        return ticket

    def _dispatch_loop(self) -> None:
        """Run admitted DAGs in waves: everything queued when the run
        gate frees executes as one batch (sharing loads/cache hits), so
        burst arrivals amortize while the queue bound caps the wave."""
        while True:
            with self._submit_cv:
                while not self._pending_tickets and not self._shutdown:
                    self._submit_cv.wait(timeout=0.1)
                if not self._pending_tickets and self._shutdown:
                    return
                wave, self._pending_tickets = self._pending_tickets, []
            adm = self.rm.admission
            enforcing = getattr(self.rm.cfg, "enforce_deadlines", False)
            now, live = time.monotonic(), []
            for t in wave:
                d = t.dag
                if enforcing and d.deadline is not None \
                        and now >= d.deadline and not d.cancelled:
                    # expired while queued: already admitted, so this is
                    # a miss (not a shed) — cancel without running
                    d.outcome = "deadline_miss"
                    d.cancelled = True
                    adm.count("deadline_misses")
                    adm.finished(d)
                    t._resolve()
                    continue
                live.append(t)
            if not live:
                continue
            try:
                self.run([t.dag for t in live])
            except BaseException as e:
                # a run-level failure (scheduler error, pool loss past
                # recovery) fails the DAGs that did not finish; the
                # serving loop keeps accepting
                for t in live:
                    d = t.dag
                    if d.outcome is None:
                        d.outcome = f"failed:{type(e).__name__}"
                        d.error = e
                        d.cancelled = True
                        adm.finished(d)
            for t in live:
                t._resolve()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted DAG has resolved and stop the
        dispatcher (the executor remains usable; a later ``submit``
        restarts it)."""
        with self._submit_cv:
            self._shutdown = True
            self._submit_cv.notify_all()
            d = self._dispatcher
        if d is not None:
            d.join(timeout)
        with self._submit_cv:
            self._dispatcher = None
            self._shutdown = False

    def _run_gated(self, dags: List[DAG], deadline_s: float) -> float:
        t0 = time.perf_counter()
        self._t0 = t0
        self._deadline = deadline_s
        self._active = {d.id: d for d in dags}
        self._attach = {d.id: [] for d in dags}
        self._inflight = {}
        self._loading = set()
        self._error = None
        if self.rm.manifest is not None:
            # differential caching: fingerprint every node (topo order),
            # then satisfy fingerprint hits straight from the manifest —
            # whole unchanged sub-DAGs are skipped before any scheduling
            for d in dags:
                fingerprint_dag(d)
                with self._cond:
                    self._apply_cache_hits(d)
        if self.workers == 1 and not self.force_threads:
            self._run_sequential()
        else:
            self._run_threaded()
        if self._error is not None:
            raise self._error
        return time.perf_counter() - t0

    def _run_sequential(self) -> None:
        while True:
            with self._cond:
                st = self._schedule_locked()
            if st is None:
                return
            assert st is not _WAIT, "sequential run cannot have in-flight"
            try:
                self._execute(st)
            except BaseException:
                self._release_claim_locked(st)
                raise
            self._publish_output(st)
            with self._cond:
                self._complete_locked(st)

    def _run_threaded(self) -> None:
        threads = [threading.Thread(target=self._worker_loop,
                                    name=f"zerrow-worker-{i}", daemon=True)
                   for i in range(self.sched_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                st = None
                while st is None:
                    if self._error is not None:
                        return
                    try:
                        st = self._schedule_locked()
                    except BaseException as e:
                        self._error = e
                        self._cond.notify_all()
                        return
                    if st is None:
                        self._cond.notify_all()   # wake idle peers: done
                        return
                    if st is _WAIT:
                        st = None
                        self._cond.wait(timeout=0.1)
            try:
                self._execute(st)
            except NodePoisonedError as e:
                # permanent op failure: quarantine the op and fail ONLY
                # this DAG — peers and the pool keep serving
                with self._cond:
                    self._release_claim_locked(st)
                    if st.status == RUNNING:
                        st.transition(WAITING)
                    self._poison_locked(st, e)
                    self._cond.notify_all()
                continue
            except BaseException as e:
                with self._cond:
                    if self._error is None:
                        self._error = e
                    self._release_claim_locked(st)
                    self._cond.notify_all()
                return
            self._publish_output(st)
            with self._cond:
                self._complete_locked(st)
                self._cond.notify_all()

    # -- scheduling (RM critical section) ----------------------------------
    def _schedule_locked(self):
        """Pick, admit and claim the next node.  Returns the claimed
        NodeState, ``_WAIT`` (only possible with in-flight nodes), or
        ``None`` when every DAG is finished.  Caller holds the lock."""
        while True:
            if time.perf_counter() - self._t0 > self._deadline:
                raise TimeoutError("executor deadline exceeded")
            if getattr(self.rm.cfg, "enforce_deadlines", False):
                now = time.monotonic()
                for d in self._active.values():
                    if not d.cancelled and d.deadline is not None \
                            and now >= d.deadline:
                        self._cancel_dag_locked(d, "deadline_miss")
                self._finish_done_dags()
            if not self._active:
                return None
            cands = self._collect()
            if not cands:
                self._finish_done_dags()
                if not self._active:
                    return None
                if self._inflight:
                    return _WAIT
                # a rolled-back CACHED node can be blocked on skipped
                # (output-less) CACHED deps that normal candidate repair
                # never visits; repair every blocked node before
                # declaring a stall
                for d in self._active.values():
                    for st in d.nodes.values():
                        if st.status in (WAITING, EVICTED):
                            self._ensure_deps(st)
                if self._collect():
                    continue
                raise RuntimeError("scheduler stall: no runnable node")
            # repair evicted dependencies (cascading rollback) in priority
            # order, then re-plan: the cascade changes runnability
            for st in cands:
                self._ensure_deps(st)
            cands = self._collect()
            if not cands:
                continue
            # fast path: highest-priority node that already fits
            picked = None
            for st in cands:
                if self.rm.admit(st):
                    picked = st
                    break
            if picked is None:
                if self._inflight:
                    # memory may free when a running node completes, and
                    # evicting under a concurrent reader is unsafe — wait
                    return _WAIT
                # nothing fits: evict for the highest-priority node only
                # (paper: 'outputs are evicted one by one until the
                # available memory is larger than the requirement of the
                # node scheduled to run next'); kswap/no-admission runs it
                # anyway and lets kernel swap / OOM handle the overflow
                picked = cands[0]
                self.rm.make_room_for(picked,
                                      extra_protect=self._inflight_deps())
                if any(picked.dag.nodes[d].output is None or
                       picked.dag.nodes[d].output.released
                       for d in picked.spec.deps):
                    continue  # an eviction broke a dep; re-plan
            picked.claim()
            self._inflight[(picked.dag.id, picked.name)] = picked
            self.rm.admission.reserve(picked)
            self.node_runs += 1
            return picked

    def _collect(self) -> List[NodeState]:
        policy = self.rm.schedule
        policy.prepare(self._active.values())
        cands = [st for d in self._active.values() for st in d.runnable()]
        cands.sort(key=lambda st: (*policy.key(st), st.dag.id))
        return cands

    def _inflight_deps(self) -> Set[Tuple[int, str]]:
        prot: Set[Tuple[int, str]] = set()
        for st in self._inflight.values():
            for d in st.spec.deps:
                prot.add((st.dag.id, d))
        return prot

    # -- cross-run differential cache hits ---------------------------------
    def _apply_cache_hits(self, dag: DAG) -> None:
        """Mark fingerprint-hit nodes CACHED before scheduling starts.

        Children first (reverse topo): a hit node's output is *adopted*
        from the manifest only when someone will read it — it has an
        executing (non-hit) child or is a keep_output sink; hit nodes in
        the interior of a fully-hit cone are skipped outright (CACHED with
        no output, zero bytes touched).  An entry whose objects vanished
        demotes to a miss and the node executes normally."""
        man = self.rm.manifest
        order = dag.topo_order()
        hit = {name: (dag.nodes[name].fingerprint is not None
                      and dag.nodes[name].status == WAITING
                      and man.get(dag.nodes[name].fingerprint) is not None)
               for name in order}
        for name in reversed(order):
            if not hit[name]:
                continue
            st = dag.nodes[name]
            kids = dag.children[name]
            wanted = st.spec.keep_output or any(not hit[k] for k in kids)
            if wanted:
                if self.rm.adopt_cached(st) is None:
                    hit[name] = False    # vanished underneath us: execute
                    continue
                # adopted bytes honor the admission budget like executed
                # ones: past it, spill earlier adoptions back to disk
                over = -self.rm.available()
                if over > 0:
                    self.rm.free_memory(over, protect=st)
            st.transition(CACHED)
            self.cache_hits += 1

    # -- cascading rollback repair ----------------------------------------
    def _ensure_deps(self, st: NodeState) -> None:
        for dep_name in st.spec.deps:
            dep = st.dag.nodes[dep_name]
            if dep.status in COMPLETE and (dep.output is None or
                                           dep.output.released):
                if dep.is_loader and self.rm.decache.enabled:
                    e = self.rm.decache.lookup(dep.decache_key())
                    if e is not None:
                        dep.output = self.rm.decache.attach(e)
                        self._attach[dep.dag.id].append(e)
                        continue
                # a skipped/evicted durable output can be re-adopted from
                # the manifest instead of re-executing the dependency;
                # its own (possibly skipped) ancestors stay untouched —
                # the adopted output makes them unnecessary
                if self.rm.adopt_cached(dep) is not None:
                    if dep.status != CACHED:
                        dep.transition(EVICTED)
                        dep.transition(CACHED)
                    continue
                dep.transition(EVICTED)
                dep.output = None
                self._ensure_deps(dep)

    # -- node execution (outside the lock where safe) ----------------------
    def _execute(self, st: NodeState) -> None:
        t0 = time.perf_counter()
        if st.is_loader:
            self._run_loader(st)
        else:
            self._run_compute(st)
        st.exec_latency = time.perf_counter() - t0

    def _make_sandbox(self, st: NodeState) -> Sandbox:
        return Sandbox(self.store, self.rm.kz,
                       f"{st.dag.name}.{st.name}#{st.runs}",
                       mode=self.rm.cfg.sipc_mode)

    def _run_compute(self, st: NodeState) -> None:
        with self._lock:
            sb = self._make_sandbox(st)
            st.sandbox = sb
            inputs = [st.dag.nodes[d].output for d in st.spec.deps]
        msg = self._compute_output(st, sb, inputs)
        with self._lock:
            st.output = msg
            st.output_bytes = msg.new_bytes

    def _compute_output(self, st: NodeState, sb: Sandbox, inputs):
        """Run the node's user function; override point for process-mode
        execution.  Thread mode: the SIPC input reads, the output write
        and any LazyBuf fault user code triggers are store-mutating and
        run inside the critical section (``lock=``), but the user
        function itself runs outside it — vectorized kernels release the
        GIL, so computes overlap across workers alongside loader
        decompression."""
        return sb.run(st.spec.fn, inputs, label=st.name, lock=self._lock)

    def _run_loader(self, st: NodeState) -> None:
        key = st.decache_key()
        with self._cond:
            # single-flight: if a peer is deserializing this key, wait for
            # its DeCache insert instead of duplicating the load
            while key in self._loading:
                self._cond.wait(timeout=0.1)
            e = self.rm.decache.lookup(key)
            if e is not None:
                st.output = self.rm.decache.attach(e)
                self._attach[st.dag.id].append(e)
                st.output_bytes = 0
                return
            self._loading.add(key)
            self.load_runs += 1
            sb = self._make_sandbox(st)
            st.sandbox = sb
        try:
            msg = self._load_output(st, sb)
            with self._cond:
                st.output = msg
                st.output_bytes = msg.new_bytes
                if self.rm.decache.enabled:
                    e = self.rm.decache.insert(key, st.output,
                                               time.perf_counter())
                    self.rm.decache.attach(e)
                    self._attach[st.dag.id].append(e)
        finally:
            with self._cond:
                self._loading.discard(key)
                self._cond.notify_all()

    def _load_output(self, st: NodeState, sb: Sandbox):
        """Deserialize the node's zarquet source and SIPC-write the table;
        override point for process-mode execution.

        Generic loader 'user code' (paper §4.2.4): deserialize zarquet
        OUTSIDE the lock — decompression releases the GIL and overlaps
        across workers; each fresh buffer re-enters the lock to register
        as sandbox anonymous memory."""
        lock = self._lock

        def on_buffer(a):
            with lock:
                sb.register_anon(a)

        table = zarquet.read_table(
            st.spec.source, dict_columns=st.spec.dict_columns,
            columns=st.spec.columns, row_groups=st.spec.row_groups,
            on_buffer=on_buffer,
            reader_threads=getattr(self.rm.cfg, "reader_threads", None))
        with self._lock:
            return sb.write_output(table, label=st.name)

    # -- durable publication (outside the RM critical section) -------------
    def _publish_output(self, st: NodeState) -> None:
        """Publish a just-executed output under its fingerprint so the
        next run adopts it instead of re-executing.  Hashing + the four
        fsyncs are slow, so they run *off* the executor lock: the node is
        still in-flight (not yet DONE/in completed_nodes), so eviction
        cannot touch the message, and once its extents are landed in the
        backing files (done under the lock) the file bytes are immutable
        — a concurrent swap-out only drops mappings."""
        rm = self.rm
        if rm.manifest is None or st.fingerprint is None or \
                st.output is None:
            return
        try:
            with self._lock:
                for fid in st.output.files_referenced():
                    if fid in self.store.files:
                        self.store.ensure_file_backed(fid)
            rm.publish_output(st)
        except Exception:
            # publication is strictly best-effort: a full disk or a
            # vanished file must cost a future cache miss, never the run
            # (an escaped exception here would strand the in-flight node
            # and hang the pool until the deadline)
            pass

    # -- completion bookkeeping (RM critical section) ----------------------
    def _release_claim_locked(self, st: NodeState) -> None:
        """Release a claimed node's inflight entry + admission reservation
        exactly once.  Pop-guarded: completion and error paths can both
        reach a claim, and a double unreserve would corrupt the books
        (``unreserve`` now raises on imbalance rather than asserting)."""
        if self._inflight.pop((st.dag.id, st.name), None) is not None:
            self.rm.admission.unreserve(st)

    def _cancel_dag_locked(self, dag: DAG, outcome: str) -> None:
        """Cooperative cancellation: no new claims (``runnable`` goes
        empty), in-flight nodes drain through their normal completion
        path, and the DAG finishes with the given outcome once drained."""
        dag.cancelled = True
        if dag.outcome is None:
            dag.outcome = outcome
        if outcome == "deadline_miss":
            self.rm.admission.count("deadline_misses")

    def _poison_locked(self, st: NodeState, e: NodePoisonedError) -> None:
        """Quarantine a permanently failing op and cancel its DAG."""
        fns = getattr(e, "fns", None) or [st.spec.fn]
        keys = {self.rm.poison_key(fn) for fn in fns}
        keys.discard(None)          # loaders are never quarantined
        self.rm.quarantined.update(keys)
        self.rm.admission.count("poisoned")
        st.dag.error = e
        self._cancel_dag_locked(st.dag, "poisoned")
        self._finish_done_dags()

    def _complete_locked(self, st: NodeState) -> None:
        st.transition(DONE)
        st.runs += 1
        if st not in self.rm.completed_nodes:
            self.rm.completed_nodes.append(st)
        self._release_claim_locked(st)
        self.rm.admission.note_latency(st.exec_latency)
        # NOTE: outputs are retained until DAG completion (paper §3.1) —
        # freeing earlier would defeat rollback and share-aware eviction.
        self._finish_done_dags()

    def _owned_by_decache(self, st: NodeState) -> bool:
        if not self.rm.decache.enabled or st.output is None:
            return False
        e = self.rm.decache.entries.get(st.decache_key())
        return e is not None and e.msg is st.output

    def _finish_done_dags(self) -> None:
        for did in [i for i, d in self._active.items() if d.all_done()]:
            self._finish_dag(self._active.pop(did), self._attach.pop(did))

    def _finish_dag(self, dag: DAG, attachments: list) -> None:
        dag.done = True
        if dag.outcome is None:
            dag.outcome = "completed"
        for st in dag.nodes.values():
            if st in self.rm.completed_nodes:
                self.rm.completed_nodes.remove(st)
            # external consumers own keep_output sinks (they release the
            # msg) — unless the DAG was cancelled, in which case no
            # consumer will ever read the partial result
            if st.spec.keep_output and not dag.cancelled:
                continue
            # release everything except messages the DeCache owns (the
            # entry's own msg — shared by every DAG keyed on it; this
            # includes CACHED loaders repaired via a decache attach,
            # while manifest-adopted CACHED outputs are ours to release)
            if not self._owned_by_decache(st):
                self.rm.release_output(st)
            if st.sandbox is not None:
                st.sandbox.destroy()
        for e in attachments:
            self.rm.decache.detach(e)
        self.rm.admission.finished(dag)

    def reshare_stats(self) -> Dict[str, int]:
        """Writer-side copy-avoidance counters for every SIPC write this
        executor's nodes performed: reshare hits (buffers emitted as
        references) vs misses (buffers de-anonymized), bytes reshared,
        and real copied bytes.  ``ProcessWorkerExecutor`` folds in the
        counters echoed back from its worker processes, so the view is
        uniform across ``workers_mode`` (what ``benchmarks/bench_join.py``
        records as the reshare hit-rate)."""
        s = self.store.stats
        return {"reshare_hits": s.reshare_hits,
                "reshare_misses": s.reshare_misses,
                "bytes_reshared": s.bytes_reshared,
                "bytes_copied": s.bytes_copied}

    def close(self) -> None:
        """Release executor resources (the thread pool only has the
        dispatcher thread to stop)."""
        self.drain(timeout=30.0)


class ProcessWorkerExecutor(WorkerPoolExecutor):
    """Executor whose node ops run in spawned OS worker processes.

    Same scheduling, admission, eviction and DeCache behaviour as the
    thread executor — the N scheduler threads still claim nodes under the
    RM critical section — but ``_compute_output`` / ``_load_output``
    dispatch to a :class:`~..flight.worker.FlightWorkerPool` instead of
    running user code inline.  Inputs go out and outputs come back as
    SIPC wire references (never data), the worker maps the parent's
    store files, and the parent adopts the worker's output files with
    ownership, so the RM keeps full accounting, admission and eviction
    authority over every byte (paper §3.1: the RM owns memory; nodes are
    untrusted tenants).

    Requires a file-backed store (``BufferStore(backing="file")``) —
    references must name real files other processes can map.  Node
    functions must be picklable (module-level functions or
    ``functools.partial`` over them); unpicklable ops fall back to
    inline execution (counted in ``fallback_inline``).
    """

    def __init__(self, store, rm, workers: Optional[int] = None,
                 data_root: Optional[str] = None):
        super().__init__(store, rm, workers, force_threads=True)
        if store.backing != "file":
            raise ValueError(
                "ProcessWorkerExecutor needs BufferStore(backing='file'): "
                "worker processes can only map file-backed extents")
        self._pool = None
        self._data_root = data_root
        self.fallback_inline = 0   # unpicklable fns executed in-parent
        self.worker_retries = 0    # requests re-run after a worker died
        # data-plane counters from inside the workers (each reply echoes
        # its store-stats delta): without these, a reshare hit on a join
        # payload dictionary that happens wholly in a worker process
        # would be invisible to the parent's accounting.  The replies
        # also echo the workers' kernel launches (``launches:<kernel>``)
        self.worker_stats: Dict[str, int] = {}
        # pipelined dispatch: with one scheduler thread per worker, every
        # thread is parked in a blocking reply wait while its worker
        # computes — nobody is left to encode/submit the next request.
        # 2x threads keeps each worker's submission slot (the pool's
        # pipeline_depth) full.
        self.sched_threads = self.workers * 2
        # chain shipping: linear picklable segments dispatch as
        # one exec_chain request; intermediates stay worker-local
        self._chain_enabled = bool(getattr(rm.cfg, "chain_dispatch", True))
        self._chain_next: Dict[Tuple[int, str], str] = {}
        self._chain_claims: Dict[Tuple[int, str], List[NodeState]] = {}
        self.chains_shipped = 0        # exec_chain requests sent
        self.chain_nodes_shipped = 0   # nodes covered by those requests
        # fn identity -> (fn, pickled bytes | None): shard DAGs reuse the
        # same callable across hundreds of nodes — pickle it once, and
        # remember unpicklable fns so the fallback probe is paid once too
        self._fn_pickle: Dict[int, Tuple[object, Optional[bytes]]] = {}

    # -- pool lifecycle -----------------------------------------------------
    def _ensure_pool(self):
        if self._pool is None:
            from ..flight.worker import FlightWorkerPool
            self._pool = FlightWorkerPool(
                self.workers, sipc_mode=self.rm.cfg.sipc_mode,
                data_root=self._data_root,
                request_timeout=getattr(self.rm.cfg, "flight_timeout_s",
                                        600.0))
        return self._pool

    @property
    def socket_bytes(self) -> int:
        return self._pool.socket_bytes if self._pool is not None else 0

    def _run_gated(self, dags: List[DAG], deadline_s: float = 3600.0
                   ) -> float:
        # under the base class's run gate: chain planning resets
        # per-run state, so it must not race an in-progress run
        self._ensure_pool()
        self._chain_next = {}
        self._chain_claims = {}
        if self._chain_enabled:
            for d in dags:
                self._plan_chains(d)
        return super()._run_gated(dags, deadline_s)

    def close(self) -> None:
        super().close()             # stop the dispatcher first: a late
        if self._pool is not None:  # wave must not hit a closed pool
            self._pool.close()
            self._pool = None

    # -- chain shipping (subgraph dispatch) ---------------------------------
    def _fn_bytes(self, fn) -> Optional[bytes]:
        """Pickled bytes for ``fn`` (memoized by identity), or ``None``
        when it cannot cross the process boundary."""
        hit = self._fn_pickle.get(id(fn))
        if hit is not None and hit[0] is fn:
            return hit[1]
        try:
            b: Optional[bytes] = pickle.dumps(fn)
        except (pickle.PicklingError, TypeError, AttributeError):
            # closures/bound methods can't cross the process boundary
            b = None
        self._fn_pickle[id(fn)] = (fn, b)
        return b

    def _plan_chains(self, dag: DAG) -> None:
        """Structure-only planning pass: record every link ``a -> b``
        (a's only child is b) whose nodes can execute in a worker — a
        loader or picklable compute feeding a picklable compute.  ``b``
        may have further deps when each one is a *co-shippable loader
        root* (a dep-less loader whose only child is b): two loads
        feeding a join ship with it as one segment, so neither load
        output ever materializes.  Maximal runs of links form the
        shippable chains; node *status* is checked at claim time, so
        CACHED / evicted boundaries simply truncate what actually
        ships."""
        for name in dag.topo_order():
            st = dag.nodes[name]
            kids = dag.children[name]
            if len(kids) != 1:
                continue
            nxt = dag.nodes[kids[0]]
            if any(not (d == name or self._loader_root(dag, d, kids[0]))
                   for d in nxt.spec.deps):
                continue
            if not st.is_loader and self._fn_bytes(st.spec.fn) is None:
                continue
            if nxt.is_loader or self._fn_bytes(nxt.spec.fn) is None:
                continue
            self._chain_next[(dag.id, name)] = kids[0]

    @staticmethod
    def _loader_root(dag: DAG, name: str, child: str) -> bool:
        st = dag.nodes[name]
        return (st.is_loader and not st.spec.deps
                and list(dag.children[name]) == [child])

    def _schedule_locked(self):
        st = super()._schedule_locked()
        if st is None or st is _WAIT:
            return st
        self._claim_chain_rest(st)
        return st

    def _claim_chain_rest(self, st: NodeState) -> None:
        """Extend the picked node's claim down its chain (caller holds
        the lock).  Each suffix node gets the full claim protocol —
        RUNNING transition, inflight entry, admission reservation — so
        peers, eviction protection and rollback treat it exactly like an
        individually dispatched node."""
        chain = [st]
        cur = st
        while True:
            nxt = self._chain_next.get((st.dag.id, cur.name))
            if nxt is None:
                break
            n = st.dag.nodes[nxt]
            # WAITING only: a CACHED/EVICTED/DONE downstream truncates
            # the shipped segment; admission keeps the memory budget
            # honest even though intermediates stay worker-local
            if n.status != WAITING:
                break
            # co-shippable loader roots ride along (see _plan_chains);
            # an already-complete side dep travels as an input frame, a
            # RUNNING one (another scheduler thread owns it) blocks the
            # extension.  The DeCache would need its single-flight /
            # insert protocol per side loader, so claim only when it is
            # off — with it on, loads are cheap cache attaches anyway.
            side, ok = [], True
            for d in n.spec.deps:
                if d == cur.name:
                    continue
                ds = st.dag.nodes[d]
                if ds.status in (DONE, CACHED) and ds.output is not None:
                    continue
                if ds.status != WAITING or not ds.is_loader \
                        or self.rm.decache.enabled:
                    ok = False
                    break
                side.append(ds)
            if not ok:
                break
            group, claimed = side + [n], []
            for s in group:
                if not self.rm.admit(s):
                    break
                s.claim()
                self._inflight[(st.dag.id, s.name)] = s
                self.rm.admission.reserve(s)
                self.node_runs += 1
                claimed.append(s)
            if len(claimed) != len(group):
                # partial admission: roll the group back, truncate here
                for s in claimed:
                    self._release_claim_locked(s)
                    s.transition(WAITING)
                    self.node_runs -= 1
                break
            chain.extend(group)
            cur = n
        if len(chain) > 1:
            self._chain_claims[(st.dag.id, st.name)] = chain

    def _execute(self, st: NodeState) -> None:
        chain = self._chain_claims.pop((st.dag.id, st.name), None)
        if chain is None:
            return super()._execute(st)
        t0 = time.perf_counter()
        try:
            self._execute_chain(chain)
        except BaseException as e:
            # a chain's worker dies without saying which step killed it,
            # so quarantine must cover the whole shipped segment
            if isinstance(e, NodePoisonedError) and not e.fns:
                e.fns = [n.spec.fn for n in chain
                         if n.spec.fn is not None]
            # revert the suffix claims so a later run can redo them
            # node-by-node; the head's cleanup is the caller's normal
            # error path
            with self._cond:
                for n in chain[1:]:
                    self._release_claim_locked(n)
                    if n.status == RUNNING:
                        n.transition(WAITING)
                self._cond.notify_all()
            raise
        dt = (time.perf_counter() - t0) / len(chain)
        for n in chain:
            n.exec_latency = dt

    def _chain_echo(self, n: NodeState, is_tail: bool) -> bool:
        """Should this chain step's output cross the wire back?  Tails
        and keep_output sinks have consumers; loader outputs feed the
        DeCache; fingerprinted outputs feed the manifest (preserving the
        manifest's hit cones).  Everything else stays worker-local."""
        if is_tail or n.spec.keep_output:
            return True
        if n.is_loader and self.rm.decache.enabled:
            return True
        return (self.rm.manifest is not None and n.fingerprint is not None
                and getattr(self.rm.cfg, "publish_outputs", True))

    def _chain_step(self, n: NodeState, is_tail: bool,
                    pos: Dict[str, int]) -> dict:
        if n.is_loader:
            return {"kind": "load", "label": n.name,
                    "source": n.spec.source,
                    "dict_columns": tuple(n.spec.dict_columns),
                    "columns": n.spec.columns,
                    "row_groups": n.spec.row_groups,
                    "reader_threads": getattr(self.rm.cfg,
                                              "reader_threads", None),
                    "echo": self._chain_echo(n, is_tail)}
        return {"kind": "exec", "label": n.name,
                "fn": self._fn_bytes(n.spec.fn),
                # value indices of this step's inputs: chain inputs
                # first, then one slot per prior step (fan-in wiring)
                "args": [pos[d] for d in n.spec.deps],
                "echo": self._chain_echo(n, is_tail)}

    def _execute_chain(self, chain: List[NodeState]) -> None:
        """Ship one claimed chain as a single exec_chain request.

        The head resolves exactly like ``_run_loader`` would (DeCache
        single-flight: wait on a peer's in-progress load, attach on hit —
        a hit strips the head from the shipped segment).  Store mutation
        (sandboxes, input export, output adoption, DeCache insert) stays
        under the RM critical section; frame encode/decode and the
        socket round-trip run outside it.  Suffix nodes complete here;
        the head completes through the caller's normal path."""
        from ..flight import wire
        head = chain[0]
        key = None
        shipped = chain
        with self._cond:
            if head.is_loader:
                k = head.decache_key()
                while k in self._loading:
                    self._cond.wait(timeout=0.1)
                e = self.rm.decache.lookup(k)
                if e is not None:
                    head.output = self.rm.decache.attach(e)
                    self._attach[head.dag.id].append(e)
                    head.output_bytes = 0
                    shipped = chain[1:]
                    ext = [(head.name, head.output)]
                else:
                    self._loading.add(k)
                    key = k
                    self.load_runs += 1
                    ext = []
            else:
                ext = [(d, head.dag.nodes[d].output)
                       for d in head.spec.deps]
            # a shipped step's dep that is not itself shipped (upstream
            # DONE/CACHED boundary) travels as an exported input frame
            names = {n.name for n in shipped}
            have = {d for d, _ in ext}
            for n in shipped:
                if n.is_loader:
                    if n is not head:
                        self.load_runs += 1
                    continue
                for d in n.spec.deps:
                    if d not in names and d not in have:
                        ext.append((d, n.dag.nodes[d].output))
                        have.add(d)
        inputs = [m for _, m in ext]
        pos = {d: i for i, (d, _) in enumerate(ext)}
        for i, n in enumerate(shipped):
            pos[n.name] = len(ext) + i
        try:
            with self._lock:
                for n in shipped:
                    n.sandbox = self._make_sandbox(n)
                fid_paths = [wire.export_paths(m, self.store)
                             for m in inputs]
            enc = [wire.encode_message(m, fid_paths=fp)
                   for m, fp in zip(inputs, fid_paths)]
            steps = [self._chain_step(n, i == len(shipped) - 1, pos)
                     for i, n in enumerate(shipped)]
            reply = self._request({"op": "exec_chain",
                                   "label": shipped[-1].name,
                                   "steps": steps, "inputs": enc})
            self._accumulate_stats(reply)
            parsed = {e["i"]: wire.parse_frame(e["msg"])
                      for e in reply["chain"]}
            with self._cond:
                for i, n in enumerate(shipped):
                    p = parsed.get(i)
                    if p is None:
                        # worker-local intermediate: never adopted, never
                        # charged — its bytes lived and died in the worker
                        n.output = None
                        n.output_bytes = 0
                        continue
                    msg = self._materialize_frame(p, n, n.sandbox)
                    n.output = msg
                    n.output_bytes = msg.new_bytes
                if key is not None and self.rm.decache.enabled and \
                        head.output is not None:
                    e = self.rm.decache.insert(key, head.output,
                                               time.perf_counter())
                    self.rm.decache.attach(e)
                    self._attach[head.dag.id].append(e)
            self.chains_shipped += 1
            self.chain_nodes_shipped += len(shipped)
        finally:
            if key is not None:
                with self._cond:
                    self._loading.discard(key)
                    self._cond.notify_all()
        for n in chain[1:]:
            self._publish_output(n)
            with self._cond:
                self._complete_locked(n)
                self._cond.notify_all()

    # -- remote execution ---------------------------------------------------
    def _request(self, obj: dict) -> dict:
        """Pool request with crash recovery: a request that dies with its
        worker (SIGKILL, OOM, socket desync) is retried with capped
        exponential backoff — requests carry only references, so a
        replay is free and side-effect-safe.  A single death retries on
        the surviving peers; once the pool thins below half strength it
        is re-grown first, so repeated deaths cannot drain it.  Past
        ``max_node_retries`` the op is declared poisoned: the pool is
        healed and :class:`NodePoisonedError` fails *this DAG only* (the
        worker loop quarantines the op's fingerprint).  In-op exceptions
        are never retried — they are deterministic."""
        from ..flight.worker import FlightWorkerLost
        cfg = self.rm.cfg
        max_retries = max(int(getattr(cfg, "max_node_retries", 3)), 1)
        backoff = float(getattr(cfg, "retry_backoff_s", 0.05))
        attempts = 0
        while True:
            try:
                return self._pool.request(obj)
            except FlightWorkerLost as e:
                attempts += 1
                if attempts > max_retries:
                    self._heal_pool()
                    raise NodePoisonedError(
                        f"op {obj.get('label', '?')!r} lost its worker "
                        f"{attempts} times ({e}); quarantining") from e
                if self._pool.live_workers < max(1, self.workers // 2):
                    self._heal_pool()
                if self._pool.live_workers == 0:
                    # respawn failed outright: nothing left to retry on
                    raise NodePoisonedError(
                        f"op {obj.get('label', '?')!r} lost its worker "
                        f"and the pool could not be re-grown") from e
                self.worker_retries += 1
                time.sleep(min(backoff * (2 ** (attempts - 1)), 1.0))

    def _heal_pool(self) -> None:
        """Re-grow the worker pool back to strength (best-effort: spawn
        failure surfaces as an empty pool at the call site, never as an
        exception replacing the one being handled)."""
        try:
            self._pool.ensure_workers()
        except Exception:
            pass

    def _accumulate_stats(self, reply: dict) -> None:
        for k, v in (reply.get("stats") or {}).items():
            self.worker_stats[k] = self.worker_stats.get(k, 0) + v

    def _materialize_frame(self, parsed, st: NodeState, sb: Sandbox):
        """Adopt a parsed worker output frame under the lock: newly
        created files are adopted with ownership and charged to the
        node's cgroup (exactly where thread-mode output bytes land), so
        admission, limitdrop and rollback treat process outputs like any
        other node output.  The byte-level parse already happened
        outside the lock (``wire.parse_frame``)."""
        from ..flight.wire import materialize_message
        msg = materialize_message(parsed, self.store, owner=sb.cgroup,
                                  adopt_owned=True, label=st.name)
        sb.owned_files.extend(
            fid for fid in msg.files_referenced()
            if fid in self.store.files and
            self.store.files[fid].owner is sb.cgroup)
        return msg

    def _adopt_reply(self, reply: dict, st: NodeState, sb: Sandbox):
        from ..flight.wire import parse_frame
        self._accumulate_stats(reply)
        parsed = parse_frame(reply["msg"])      # pure: outside the lock
        with self._lock:
            return self._materialize_frame(parsed, st, sb)

    def _compute_output(self, st: NodeState, sb: Sandbox, inputs):
        fn_bytes = self._fn_bytes(st.spec.fn)
        if fn_bytes is None:
            # run unpicklable fns in-parent (correct, just not parallel)
            self.fallback_inline += 1
            return super()._compute_output(st, sb, inputs)
        from ..flight import wire
        # store-mutating export prepass under the lock; the byte-level
        # frame encode runs outside it (pipelined dispatch: another
        # scheduler thread can hold the critical section meanwhile)
        with self._lock:
            fid_paths = [wire.export_paths(m, self.store) for m in inputs]
        enc = [wire.encode_message(m, fid_paths=fp)
               for m, fp in zip(inputs, fid_paths)]
        reply = self._request(
            {"op": "exec", "label": st.name, "fn": fn_bytes, "inputs": enc})
        return self._adopt_reply(reply, st, sb)

    def _load_output(self, st: NodeState, sb: Sandbox):
        reply = self._request(
            {"op": "load", "label": st.name, "source": st.spec.source,
             "dict_columns": tuple(st.spec.dict_columns),
             "columns": st.spec.columns,
             "row_groups": st.spec.row_groups,
             "reader_threads": getattr(self.rm.cfg, "reader_threads",
                                       None)})
        return self._adopt_reply(reply, st, sb)

    def reshare_stats(self) -> Dict[str, int]:
        out = super().reshare_stats()
        for k in out:
            out[k] += self.worker_stats.get(k, 0)
        return out
