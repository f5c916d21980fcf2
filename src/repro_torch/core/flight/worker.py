"""Flight process workers — DAG node ops in separate OS processes.

Each worker is a spawned Python process with its own file-backed
BufferStore.  The parent executor sends it tiny control frames over a
Unix-domain socket:

    {"op": "exec", "label", "mode", "fn": <pickled callable>,
     "inputs": [<SIPC wire frame>, ...]}
    {"op": "load", "label", "mode", "source", "dict_columns", "columns",
     "row_groups"}
    {"op": "exec_chain", "mode", "steps": [<step>, ...],
     "inputs": [<SIPC wire frame>, ...]}
    {"op": "ping"} / {"op": "shutdown"}

and gets back ``{"ok": True, "msg": <SIPC wire frame>}`` (for
``exec_chain``: ``{"ok": True, "chain": [{"i", "msg"}, ...]}`` — one
entry per *echoed* step).  Inputs and
outputs are *references only* — the worker maps the parent's store files,
runs the op inside a normal Sandbox (same share wrapper, same SIPC
writer, so resharing and dictionary sharing work unchanged), writes its
output into its own store files, and hands the parent back paths.  After
the reply the worker forgets its handles; the files stay on disk and the
parent adopts them with ownership (it unlinks them at GC time).

``exec_chain`` runs a whole linear DAG segment in one request: each
step (a loader or a pickled fn) hands its raw in-memory table to the
next step, so a non-echoed intermediate never crosses the socket, is
never SIPC-encoded and never touches a store file at all — the fused
segment does strictly less store work than the same nodes executed
one-by-one.  Only *echoed* steps (tails, keep_output sinks, DeCache /
manifest feeds) are written and handed back as reference frames; any
input file an echoed frame still reshares stays on disk for the
parent to adopt.

Dispatch is *pipelined*: ``WorkerHandle.submit`` sends a frame and
returns a future; a per-handle receiver thread matches replies to
futures in FIFO order (the worker answers strictly in order).  The
parent can therefore encode and send request N+1 while the worker
computes request N — dispatch cost overlaps with worker compute
instead of serializing on a blocking request/reply turn.

Because the compute happens in another process, a Python-heavy op no
longer serializes on the parent's GIL or on the RM critical section —
this is what finally lets compute-bound pipeline stages scale with
``workers`` (the paper's separate-FaaS-processes deployment, which the
thread executor only approximated for GIL-releasing decompression).
"""

from __future__ import annotations

import collections
import multiprocessing as mp
import os
import pickle
import shutil
import socket
import tempfile
import threading
import time
import traceback
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .. import faultplane
from .wire import (WireError, decode_message, encode_message, frame_refs,
                   recv_frame, send_frame)

_SPAWN = mp.get_context("spawn")      # never fork: CUDA/threads unsafe

# Worker-side fault points (fired in the worker process, armed through the
# inherited environment — ZERROW_FAULTS crosses the spawn boundary):
faultplane.register_hook("worker_kill", "flight worker: die (kill) or "
                         "raise before handling a request")
faultplane.register_hook("worker_slow", "flight worker: delay before "
                         "handling a request (straggler simulation)")
faultplane.register_hook("worker_stall", "flight worker: stall before "
                         "sending the reply (parent timeout path)")
faultplane.register_hook("worker_chain_kill", "flight worker: die between "
                         "exec_chain steps (mid-chain crash)")


# --------------------------------------------------------------------------
# worker side
# --------------------------------------------------------------------------

def worker_main(sock_path: str, data_dir: str, device: str) -> None:
    """Entry point of one worker process (spawn target).  ``device`` is
    the parent's ``kdispatch.device_name()``: the worker's relational
    kernels run there.  It is set, not resolved, before the first
    request, so a worker asked for ``cuda`` with no card fails that
    request with ``resolve_device``'s ``RuntimeError`` (an in-op error,
    reported once and never retried) instead of dying or falling back to
    the CPU."""
    # imports deferred so the module object stays spawn-picklable cheaply
    from ..buffers import BufferStore
    from ..dag import Sandbox
    from ..deanon import KernelZero
    from .. import kdispatch, zarquet

    kdispatch.set_device(device)

    try:
        # batch scheduling: a worker is pure throughput compute — longer
        # timeslices mean fewer cross-address-space switches (each one
        # costs a TLB flush the thread executor's shared-mm switches
        # never pay), which is where process mode loses to threads on
        # core-starved boxes
        os.sched_setscheduler(0, os.SCHED_BATCH, os.sched_param(0))
    except (AttributeError, OSError, PermissionError):
        pass
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(sock_path)
    # identify ourselves: accept order is not spawn order, and the parent
    # must pair each socket with the right Process (retiring a dead
    # worker must never terminate a healthy one)
    send_frame(sock, pickle.dumps({"hello": os.getpid()}))
    store = BufferStore(backing="file", data_dir=data_dir)
    kz = KernelZero(store)
    try:
        while True:
            try:
                req: Dict[str, Any] = pickle.loads(recv_frame(sock))
            except (ConnectionError, EOFError):
                return
            op = req.get("op")
            if op == "shutdown":
                send_frame(sock, pickle.dumps({"ok": True}))
                return
            if op == "ping":
                send_frame(sock, pickle.dumps({"ok": True, "pid": os.getpid()}))
                continue
            real_op = op in ("exec", "load", "exec_chain")
            if real_op:
                # injected mid-request faults (never on warm/control ops,
                # so pool startup stays deterministic under injection)
                faultplane.fire("worker_slow")
                faultplane.fire("worker_kill")
            try:
                reply = _handle(req, store, kz, Sandbox, zarquet)
            except BaseException as e:  # noqa: BLE001 — report, don't die
                reply = {"ok": False, "error": repr(e),
                         "traceback": traceback.format_exc()}
            if real_op:
                faultplane.fire("worker_stall")
            send_frame(sock, pickle.dumps(reply))
            if op == "exec_chain" and reply.get("ok"):
                _forget_chain(store, [e["msg"] for e in reply["chain"]])
            else:
                _forget_all(store)
    finally:
        sock.close()
        store.close()


#: worker-side StoreStats counters echoed back per request so the parent
#: executor can aggregate data-plane behaviour that happens entirely
#: inside workers (e.g. a join reshare-hitting on payload dictionaries)
_ECHO_STATS = ("bytes_copied", "bytes_reshared", "reshare_hits",
               "reshare_misses")


def _counters(store) -> Dict[str, int]:
    """The echoed store counters, and the worker's kernel launches as
    ``launches:<kernel>`` (so the parent's ``worker_stats`` shows which
    kernels its workers launched: none, for a worker on the CPU)."""
    from ...kernels import ops as kops
    snap = store.stats.snapshot()
    out = {k: snap[k] for k in _ECHO_STATS}
    out.update((f"launches:{k}", v) for k, v in kops.launch_counts.items())
    return out


def _delta(store, before: Dict[str, int]) -> Dict[str, int]:
    after = _counters(store)
    return {k: after[k] - before[k] for k in after
            if after[k] != before[k] or k in _ECHO_STATS}


def _run_step(step, store, kz, Sandbox, zarquet, mode, inputs):
    """Run one chain step (a loader or a pickled fn over ``inputs``) in a
    fresh Sandbox; returns its output SipcMessage."""
    label = step.get("label", "node")
    sb = Sandbox(store, kz, label, mode=mode)
    if step["kind"] == "load":
        table = zarquet.read_table(step["source"],
                                   dict_columns=tuple(step["dict_columns"]),
                                   columns=step.get("columns"),
                                   row_groups=step.get("row_groups"),
                                   on_buffer=sb.register_anon,
                                   reader_threads=step.get("reader_threads"))
        return sb.write_output(table, label=label)
    fn = pickle.loads(step["fn"])
    return sb.run(fn, inputs, label=label)


def _handle(req, store, kz, Sandbox, zarquet) -> Dict[str, Any]:
    label = req.get("label", "node")
    mode = req.get("mode", "zero")
    before = _counters(store)
    if req["op"] == "warm":
        # a fresh worker's first real request otherwise pays one-time
        # costs measured in tens of milliseconds — op-module imports,
        # zarquet codec init, store data-file growth + first-touch page
        # faults, numpy kernel caches.  Run a miniature load -> encode ->
        # filter -> write cycle through a real zarquet file now, while
        # the pool is still starting up, so none of it lands on a user
        # request.
        from .. import ops
        from ..arrow import Table
        import numpy as np
        sb = Sandbox(store, kz, "warm", mode=mode)
        t = Table.from_pydict(
            {"k": np.arange(8192, dtype=np.int64),
             "s": ["warm%d" % (i & 7) for i in range(8192)]})
        path = os.path.join(store.data_dir, "warmup.zq")
        zarquet.write_table(path, t)
        t = zarquet.read_table(path, on_buffer=sb.register_anon)
        t = ops.dict_encode(t, ["s"])
        mask = np.arange(t.num_rows) % 3 != 0
        msg = sb.write_output(ops.filter_rows(t, mask), label="warm")
        encode_message(msg, store)
        msg.release()
        for fid in list(store.files):     # nothing to adopt: unlink now
            store.delete_file(fid)
        try:
            os.unlink(path)
        except OSError:
            pass
        return {"ok": True}
    if req["op"] == "exec_chain":
        from ..sipc import SipcReader
        inputs = [decode_message(b, store, charge=False, label=label)
                  for b in req.get("inputs", ())]
        # ONE sandbox for the whole segment: each step hands its raw
        # in-memory table straight to its successor, so a non-echoed
        # intermediate is never SIPC-written, never lands in a store
        # file, never faults a page — the fusion is what makes a shipped
        # chain cheaper than the same nodes run one-by-one (which must
        # materialize every output), not just the saved round trips.
        # The chain-wide input_map lets an echoed tail still reshare
        # buffers it passes through from the chain's real inputs.
        sb = Sandbox(store, kz, label, mode=mode)
        reader = SipcReader(store, mode, record_map=sb.input_map)
        # the values array: chain inputs first, then one slot per step;
        # each exec step picks its inputs by index (``args``), which is
        # how fan-in segments (two loads feeding a join) wire up
        vals = [reader.read_table(m) for m in inputs]
        chain, msgs = [], []
        for i, step in enumerate(req["steps"]):
            faultplane.fire("worker_chain_kill")
            if step["kind"] == "load":
                table = zarquet.read_table(
                    step["source"],
                    dict_columns=tuple(step["dict_columns"]),
                    columns=step.get("columns"),
                    row_groups=step.get("row_groups"),
                    on_buffer=sb.register_anon,
                    reader_threads=step.get("reader_threads"))
            else:
                table = pickle.loads(step["fn"])(
                    [vals[a] for a in step["args"]])
            if step["echo"]:
                # write_output releases the sandbox's anon registry, but
                # only the *accounting* — the arrays stay alive through
                # the table references later steps hold
                msg = sb.write_output(table, label=step.get("label", label))
                msgs.append(msg)
                chain.append({"i": i, "msg": encode_message(msg, store)})
            vals.append(table)
        for m in inputs:
            m.release()
        for m in msgs:
            m.release()
        return {"ok": True, "chain": chain, "stats": _delta(store, before)}
    if req["op"] == "exec":
        inputs = [decode_message(b, store, charge=False, label=label)
                  for b in req["inputs"]]
        msg = _run_step({"kind": "exec", "label": label, "fn": req["fn"]},
                        store, kz, Sandbox, zarquet, mode, inputs)
        for m in inputs:
            m.release()
    elif req["op"] == "load":
        msg = _run_step({"kind": "load", "label": label,
                         "source": req["source"],
                         "dict_columns": req["dict_columns"],
                         "columns": req.get("columns"),
                         "row_groups": req.get("row_groups"),
                         "reader_threads": req.get("reader_threads")},
                        store, kz, Sandbox, zarquet, mode, [])
    else:
        raise ValueError(f"unknown worker op {req['op']!r}")
    out = encode_message(msg, store)
    msg.release()
    return {"ok": True, "msg": out, "new_bytes": msg.new_bytes,
            "reshared_bytes": msg.reshared_bytes,
            "stats": _delta(store, before)}


def _forget_all(store) -> None:
    """Drop every file handle without unlinking: the bytes now belong to
    the parent (which adopted the paths with ownership)."""
    for fid in list(store.files):
        store.files[fid].owns_path = False
        store.delete_file(fid)


def _forget_chain(store, echoed_frames) -> None:
    """Post-``exec_chain`` cleanup.  Files referenced by an echoed frame
    belong to the parent now (it adopts them with ownership) — drop the
    handle without unlinking.  Everything else the worker owns is a
    chain intermediate nobody will ever map again: unlink it here, in
    the worker, so shipped chains cost the parent zero bytes and zero
    GC work for their intermediates."""
    keep = set()
    for fr in echoed_frames:
        for path, _off, _len in frame_refs(fr):
            keep.add(os.path.abspath(path))
    for fid in list(store.files):
        f = store.files[fid]
        if f.backing_path and os.path.abspath(f.backing_path) in keep:
            f.owns_path = False       # parent takes unlink responsibility
        store.delete_file(fid)        # unlinks only if owns_path held


# --------------------------------------------------------------------------
# parent side
# --------------------------------------------------------------------------

class FlightWorkerError(RuntimeError):
    """A worker process failed or died mid-request."""


class FlightWorkerLost(FlightWorkerError):
    """Transport failure: the worker died (or its socket desynced)
    mid-request.  Unlike an in-op exception, the request itself may be
    perfectly fine — the executor retries it on a surviving worker."""


class _Future:
    """Reply slot for one in-flight request (threading.Event based)."""

    __slots__ = ("_ev", "_result", "_exc", "t0")

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self.t0 = 0.0      # submit instant, for service-time health EWMA

    def set_result(self, r) -> None:
        self._result = r
        self._ev.set()

    def set_exception(self, e: BaseException) -> None:
        if not self._ev.is_set():      # first failure wins
            self._exc = e
            self._ev.set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("flight reply timed out")
        if self._exc is not None:
            raise self._exc
        return self._result


class WorkerHandle:
    """One connected worker process, with pipelined request dispatch.

    ``submit`` sends a frame and returns a :class:`_Future` immediately;
    the per-handle receiver thread matches replies to futures in FIFO
    order (the worker processes requests strictly in order, one reply
    each).  ``request`` is the blocking submit+complete composition.
    Any transport failure — dead worker, truncated frame, reply with no
    matching future, completion timeout — breaks the handle: every
    pending future fails with :class:`FlightWorkerLost` and the socket
    is closed, because a desynced stream can never be re-aligned."""

    def __init__(self, proc, sock: socket.socket):
        self.proc = proc
        self.sock = sock
        self.bytes_sent = 0
        self.bytes_received = 0
        self.broken = False      # socket desynced / worker dead: retire
        self._send_lock = threading.Lock()   # frame sends never interleave
        self._plock = threading.Lock()       # guards _pending
        self._pending: "collections.deque[_Future]" = collections.deque()
        self._on_reply = None    # pool wake-up callback
        self._health = None      # pool's StragglerDetector (keyed by pid)
        self._recv_thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Start the receiver thread (after the pool wired callbacks)."""
        self._recv_thread = threading.Thread(
            target=self._recv_loop, daemon=True,
            name=f"flight-recv-{getattr(self.proc, 'pid', '?')}")
        self._recv_thread.start()

    @property
    def pending(self) -> int:
        with self._plock:
            return len(self._pending)

    # -- submit / complete --------------------------------------------------
    def submit(self, obj: Dict[str, Any]) -> _Future:
        """Send one request frame; returns the future its reply fills."""
        payload = pickle.dumps(obj)
        fut = _Future()
        fut.t0 = time.monotonic()
        with self._send_lock:
            if self.broken:
                raise FlightWorkerLost(
                    f"worker pid={getattr(self.proc, 'pid', '?')} is "
                    f"broken (cannot submit {obj.get('op')!r})")
            with self._plock:
                self._pending.append(fut)
            try:
                self.bytes_sent += send_frame(self.sock, payload)
            except (ConnectionError, socket.timeout, OSError) as e:
                err = FlightWorkerLost(
                    f"worker pid={getattr(self.proc, 'pid', '?')} failed "
                    f"during {obj.get('op')!r}: {e!r}")
                self._break(err)
                raise err from e
        return fut

    def complete(self, fut: _Future, obj: Dict[str, Any],
                 timeout: float) -> Dict[str, Any]:
        """Wait for ``fut``; a timeout breaks the handle (its late reply
        would otherwise be matched to a request the caller already gave
        up on and retried elsewhere)."""
        try:
            reply = fut.result(timeout)
        except TimeoutError:
            err = FlightWorkerLost(
                f"worker pid={getattr(self.proc, 'pid', '?')} timed out "
                f"after {timeout}s during {obj.get('op')!r}")
            self._break(err)
            raise err from None
        if not reply.get("ok"):
            raise FlightWorkerError(
                f"worker op {obj.get('op')!r} raised {reply.get('error')}\n"
                f"{reply.get('traceback', '')}")
        return reply

    def request(self, obj: Dict[str, Any], timeout: float) -> Dict[str, Any]:
        return self.complete(self.submit(obj), obj, timeout)

    # -- receiver -----------------------------------------------------------
    def _recv_loop(self) -> None:
        while True:
            try:
                raw = recv_frame(self.sock)
            except (ConnectionError, socket.timeout, OSError, WireError) as e:
                self._break(FlightWorkerLost(
                    f"worker pid={getattr(self.proc, 'pid', '?')} "
                    f"connection lost: {e!r}"))
                return
            with self._plock:
                self.bytes_received += len(raw) + 8
                fut = self._pending.popleft() if self._pending else None
            if fut is None:
                self._break(FlightWorkerLost(
                    f"worker pid={getattr(self.proc, 'pid', '?')} sent an "
                    "unsolicited frame"))
                return
            health = self._health
            if health is not None and fut.t0:
                # service time (queue + compute) into the shared
                # straggler detector, keyed by worker pid
                health.update(getattr(self.proc, "pid", 0),
                              time.monotonic() - fut.t0)
            try:
                fut.set_result(pickle.loads(raw))
            except Exception as e:   # noqa: BLE001 — undecodable reply
                fut.set_exception(FlightWorkerLost(
                    f"worker pid={getattr(self.proc, 'pid', '?')} sent an "
                    f"undecodable reply: {e!r}"))
                self._break(FlightWorkerLost("reply stream desynced"))
                return
            cb = self._on_reply
            if cb is not None:
                cb()

    def _break(self, exc: FlightWorkerLost) -> None:
        """Mark broken, fail every pending future, close the socket."""
        self.broken = True
        with self._plock:
            pending, self._pending = list(self._pending), collections.deque()
        for f in pending:
            f.set_exception(exc)
        try:
            self.sock.close()
        except OSError:
            pass
        cb = self._on_reply
        if cb is not None:
            cb()

    def retire(self) -> None:
        self._break(FlightWorkerLost(
            f"worker pid={getattr(self.proc, 'pid', '?')} retired"))
        if self.proc.is_alive():
            self.proc.terminate()


class FlightWorkerPool:
    """N spawned worker processes behind a Unix-domain socket listener.

    Routing is event-driven: a condition variable wakes waiters the
    moment any reply lands or a handle breaks (no polling interval).
    Requests pack onto cache-hot workers first (see ``_pick_locked``),
    bounded by ``pipeline_depth`` — deep enough that the parent encodes
    request N+1 while the worker computes N, shallow enough that a
    worker death re-runs at most ``pipeline_depth`` requests."""

    #: max in-flight requests per worker (1 = strict request/reply).
    #: Scaled up with worker-to-core oversubscription at construction:
    #: when cores are scarce, deeper per-worker queues let the pack
    #: router keep requests on FEWER address spaces (every cross-process
    #: switch costs a TLB flush that thread-mode's shared-mm switches
    #: never pay); with ample cores the queues stay shallow so work
    #: spreads and actually overlaps.
    pipeline_depth = 2

    def __init__(self, workers: int, sipc_mode: str = "zero",
                 data_root: Optional[str] = None,
                 connect_timeout: float = 60.0,
                 request_timeout: float = 600.0):
        from .. import kdispatch
        self.workers = workers
        # the kernels' device is process-wide state of the parent, not an
        # environment variable, so each spawn is handed it explicitly
        self.device = kdispatch.device_name()
        self.sipc_mode = sipc_mode
        self.request_timeout = request_timeout
        cores = len(os.sched_getaffinity(0)) if hasattr(
            os, "sched_getaffinity") else (os.cpu_count() or 1)
        self.pipeline_depth = type(self).pipeline_depth * max(
            1, workers // max(cores, 1))
        # worker stores hold chain intermediates and freshly-produced
        # outputs; tmpfs makes their first-touch writes RAM-speed (no
        # block allocation / writeback) while staying path-addressable
        # for the parent's zero-copy mmap adoption — the shared-memory
        # object store arrangement the paper's data plane assumes
        self.data_root = data_root or tempfile.mkdtemp(
            prefix="zerrow-flight-",
            dir="/dev/shm" if os.access("/dev/shm", os.W_OK) else None)
        os.makedirs(self.data_root, exist_ok=True)
        self._sock_path = os.path.join(
            self.data_root, f"uds-{uuid.uuid4().hex[:8]}")
        self._handles: List[WorkerHandle] = []
        self._cv = threading.Condition()
        self._closed = False
        self._connect_timeout = connect_timeout
        # crash-recovery respawn accounting (``ensure_workers``): bounded
        # so a fault that kills every replacement cannot fork-bomb
        self._spawn_lock = threading.Lock()
        self._next_worker = 0
        self.respawns = 0
        self.max_respawns = workers * 8
        # shared per-worker service-time EWMA + straggler flagging — the
        # same detector runtime/fault.py's FleetMonitor uses for
        # training-fleet heartbeats (see core/faultplane.py)
        self.health = faultplane.StragglerDetector()

        # the listener stays open for the pool's lifetime: crash recovery
        # respawns workers through it long after startup
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self._sock_path)
        self._listener.listen(workers)
        self._listener.settimeout(connect_timeout)
        new = self._spawn_batch(workers, fatal=True)
        self._warm(new)

    def _spawn_batch(self, n: int, fatal: bool = False
                     ) -> List[WorkerHandle]:
        """Spawn ``n`` workers and pair their hello-pid connections.
        ``fatal`` (initial startup): an incomplete batch terminates the
        spawned procs and raises; otherwise (crash-recovery respawn) the
        stragglers are terminated and the paired survivors returned."""
        procs = []
        for _ in range(n):
            i = self._next_worker
            self._next_worker += 1
            p = _SPAWN.Process(
                target=worker_main,
                args=(self._sock_path,
                      os.path.join(self.data_root, f"w{i}"), self.device),
                name=f"zerrow-flight-{i}", daemon=True)
            p.start()
            procs.append(p)
        by_pid = {p.pid: p for p in procs}
        new: List[WorkerHandle] = []
        try:
            while by_pid:
                conn, _ = self._listener.accept()
                conn.settimeout(self._connect_timeout)
                hello = pickle.loads(recv_frame(conn))
                conn.settimeout(None)
                p = by_pid.pop(hello.get("hello"), None)
                if p is None:
                    conn.close()      # not from this batch: drop it
                    continue
                h = WorkerHandle(p, conn)
                h._on_reply = self._wake
                h._health = self.health
                new.append(h)
        except (socket.timeout, ConnectionError, WireError, OSError):
            for p in by_pid.values():
                p.terminate()
            if fatal:
                for h in new:
                    h.retire()
                raise FlightWorkerError(
                    f"worker pool: only {len(new)}/{n} workers "
                    "connected before timeout")
        self._handles.extend(new)
        for h in new:
            h.start()
        return new

    def _warm(self, handles: List[WorkerHandle]) -> None:
        """Cold-start amortization: eat each worker's one-time first-
        request costs off the request path, across all workers at once
        (best-effort: a worker that dies warming up is simply retired,
        like any other failure)."""
        warm = []
        for h in handles:
            try:
                warm.append((h, h.submit({"op": "warm",
                                          "mode": self.sipc_mode})))
            except FlightWorkerLost:
                pass
        for h, fut in warm:
            try:
                h.complete(fut, {"op": "warm"},
                           timeout=self._connect_timeout)
            except FlightWorkerError:
                pass

    def ensure_workers(self) -> int:
        """Crash recovery: re-grow the pool back to its configured size.
        Called by the executor's retry path when the pool has thinned.
        Bounded by ``max_respawns`` total replacement workers — a
        poisoned op that kills every replacement must exhaust its node
        retries, not the host's process table.  Returns the live count."""
        with self._spawn_lock:
            if self._closed:
                return self.live_workers
            missing = self.workers - self.live_workers
            if missing <= 0:
                return self.live_workers
            allowed = min(missing, self.max_respawns - self.respawns)
            if allowed <= 0:
                return self.live_workers
            new = self._spawn_batch(allowed)
            self.respawns += len(new)
            self._warm(new)
        self._wake()                  # submit waiters can route again
        return self.live_workers

    def stragglers(self) -> Tuple[List[int], float]:
        """(straggler pids, median service EWMA) over live workers —
        same flagging rule as runtime.fault.FleetMonitor."""
        alive = {getattr(h.proc, "pid", 0)
                 for h in self._handles if not h.broken}
        return self.health.flag(alive)

    def _wake(self) -> None:
        with self._cv:
            self._cv.notify_all()

    # -- request routing ---------------------------------------------------
    def _pick_locked(self) -> Optional[WorkerHandle]:
        """LIFO-style packing: among live handles under ``pipeline_depth``,
        prefer the one with the MOST in-flight requests.  A busy worker is
        a cache-hot worker (the same locality argument behind LIFO slots
        in work-stealing runtimes); idle workers are engaged only when the
        hot ones saturate their pipeline, which also minimizes process
        context-switch pressure when cores are scarce."""
        best, best_n = None, -1
        for h in self._handles:
            if h.broken:
                continue
            n = h.pending
            if n < self.pipeline_depth and n > best_n:
                best, best_n = h, n
        return best

    def submit(self, obj: Dict[str, Any]) -> Tuple[WorkerHandle, _Future]:
        """Send ``obj`` to the least-loaded live worker; returns the
        ``(handle, future)`` pair to complete later.  Blocks (event-
        driven, no polling) while every live handle is at
        ``pipeline_depth``; raises when the whole pool is dead."""
        obj.setdefault("mode", self.sipc_mode)
        while True:
            with self._cv:
                while True:
                    h = self._pick_locked()
                    if h is not None:
                        break
                    if all(x.broken for x in self._handles):
                        raise FlightWorkerError(
                            "no live workers in the pool")
                    # the 1s cap is a safety net against a lost wakeup,
                    # not a polling interval — replies notify _cv
                    self._cv.wait(timeout=1.0)
            try:
                return h, h.submit(obj)
            except FlightWorkerLost:
                h.retire()            # always retire a broken handle
                self._wake()          # re-route to a survivor

    def request(self, obj: Dict[str, Any],
                timeout: Optional[float] = None) -> Dict[str, Any]:
        """Run one request on the least-loaded live worker.

        A handle that fails (dead worker, timeout, desynced stream) is
        always retired — its socket can no longer be trusted to be
        frame-aligned.  The error propagates to the executor's normal
        error path; when every worker has died the pool raises
        immediately."""
        timeout = self.request_timeout if timeout is None else timeout
        h, fut = self.submit(obj)
        try:
            return h.complete(fut, obj, timeout)
        except FlightWorkerLost:
            h.retire()
            raise
        finally:
            self._wake()              # a pipeline slot opened up

    # -- stats / lifecycle --------------------------------------------------
    @property
    def live_workers(self) -> int:
        return sum(1 for h in self._handles if not h.broken)

    @property
    def socket_bytes(self) -> int:
        """Total bytes that crossed the control sockets, both directions —
        the quantity the zero-copy wire claim is asserted on."""
        return sum(h.bytes_sent + h.bytes_received for h in self._handles)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        for h in self._handles:
            if not h.broken:      # retired handles have dead/closed sockets
                try:
                    h.request({"op": "shutdown"}, timeout=5.0)
                except (FlightWorkerError, OSError):
                    pass
            try:
                h.sock.close()
            except OSError:
                pass
        for h in self._handles:
            h.proc.join(timeout=5.0)
            if h.proc.is_alive():
                h.proc.terminate()
            if h._recv_thread is not None:
                h._recv_thread.join(timeout=1.0)
        shutil.rmtree(self.data_root, ignore_errors=True)
