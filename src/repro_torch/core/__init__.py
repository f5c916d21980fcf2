"""Zerrow core: true zero-copy Arrow pipelines (the paper's contribution).

Data-plane subsystems (paper §4.2):
  arrow    — Arrow computational format (columns, batches, chunked tables)
  buffers  — BufferStore: tmpfs analogue, cgroup charging, swap
  deanon   — KernelZero: de-anonymization (ownership transfer, direct swap)
  sipc     — Shared IPC: reference-passing streams, IPC inspection,
             resharing, dictionary sharing
  zarquet  — on-disk compressed columnar source format (Parquet stand-in;
             zstd with stdlib-zlib fallback, codec recorded per file;
             reader-pool parallel, copy-free decompression into
             allocator-provided buffers)
  vkernels — vectorized columnar kernels: GIL-releasing numpy bulk ops
             over raw (offsets, values, validity) buffers (var-length
             gather, dictionary encode, utf8 sort keys, bulk upper)
  kdispatch — the numpy <-> tensor edge: key hashing, join gathers and
             integer segment reductions on the hand-written CUDA kernels
             (or, on request, their plain PyTorch versions on the CPU)
  ops      — table transformations, among them join, filter_join and
             group_by, that run inside DAG nodes
  decache  — shared deserialization cache
  dag      — DAGs, node lifecycle state machine, sandboxes, share wrapper
  ingest   — streaming ingest loop: zarquet.StreamWriter micro-batch
             commits (ACK/at-least-once, bounded in-flight window)
             driving IncrementalRecompute — per-row-group fingerprinted
             DAGs whose stable prefix stays CACHED, so each ACKed
             micro-batch recomputes only its own cone while refcounted
             snapshots serve queries concurrently

Control-plane subsystems (paper §3.1/§3.3, layered — docs/ARCHITECTURE.md):
  sched.policy     — scheduling priority protocol + registry (SCHEDULES):
                     depth-first, breadth-first, fair-share, deadline-aware
  sched.admission  — AdmissionController: budget check + make-room
  sched.eviction   — EvictionPolicy classes + registry (POLICIES):
                     none/kswap/rollback/limitdrop/adaptive
  sched.executor   — WorkerPoolExecutor: N workers pull admitted nodes
                     concurrently (loader decompression overlaps across
                     workers); workers=1 is the exact sequential semantics.
                     ProcessWorkerExecutor: same scheduling, but node ops
                     run in spawned OS processes over the Flight data
                     plane (select with RMConfig.workers_mode='process')
  flight   — the cross-process zero-copy data plane: SIPC wire protocol
             (schema bytes + (file_path, offset, length) references over a
             Unix-domain socket), FlightServer/FlightClient named-ticket
             exchange, and the process-worker pool.  Pairs with
             BufferStore(backing='file'), whose store files are real
             mmap'd files any process can map
  rm       — ResourceManager: accounting, counters, refcount-safe GC, and
             the wiring of the three sched components; re-exports the
             executor under its historical ``Executor`` name and the
             ``make_executor`` factory (workers_mode -> class)

Frontend (post-paper, docs/ARCHITECTURE.md "Query frontend"):
  plan     — declarative query layer: picklable expression trees,
             dataframe-style plan builder, rule-based logical optimizer
             (projection pruning, filter pushdown, filter->join fusion,
             common-subplan dedup), compiled to ordinary fingerprinted
             DAG nodes (``plan.scan(...).filter(...)`` ->
             ``plan.compile_plans``)

This package is the PyTorch port's own copy of the JAX package's
``core/``: the modules keep their names and public API, and only their
imports and the seams where the numpy core meets the card differ
(``kdispatch``'s edge and fingerprint tags, the device a spawned Flight
worker runs on, the launch counters under the executor's threads).

Register a new policy by subclassing ``EvictionPolicy`` (decorate with
``sched.register_eviction``) or ``SchedulePolicy`` (``register_schedule``)
and selecting it by name in ``RMConfig``.
"""


from . import faultplane, kdispatch, ops, vkernels
from .faultplane import (FaultInjected, FaultPlane, StragglerDetector,
                         PLANE)
from .arrow import (ArrowType, Column, Field, RecordBatch, Schema, Table,
                    BOOL, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64,
                    UINT8, UINT64, UTF8, dict_of, pack_validity,
                    unpack_validity)
from .buffers import (PAGE, AnonRegion, BufferStore, Cgroup, OOMError,
                      StoreFile, StoreStats, alloc_aligned)
from .dag import (CACHED, DAG, InvalidTransition, NodeSpec, NodeState,
                  Sandbox, VALID_TRANSITIONS)
from .deanon import KernelZero
from .decache import DeCache
from .fingerprint import (code_fingerprint, file_fingerprint,
                          fingerprint_dag, node_fingerprint,
                          source_fingerprint)
from .ingest import IncrementalRecompute, RefreshStats
from .zarquet import StreamWriter
from .flight import (FlightClient, FlightError, FlightServer,
                     FlightWorkerError, FlightWorkerLost, FlightWorkerPool,
                     WireError, decode_message, encode_message, frame_refs)
from .manifest import Manifest, ManifestEntry
from .rm import (Executor, POLICIES, RMConfig, ResourceManager,
                 WORKERS_MODES, make_executor)
from .sched import (AdmissionController, EvictionPolicy,
                    NodePoisonedError, ProcessWorkerExecutor, SCHEDULES,
                    SchedulePolicy, Ticket, WorkerPoolExecutor,
                    get_eviction, get_schedule, register_eviction,
                    register_schedule)
from .sipc import (AddressMap, BufRef, SipcMessage, SipcReader, SipcWriter)
from . import plan

__all__ = [
    "ArrowType", "Column", "Field", "RecordBatch", "Schema", "Table",
    "BOOL", "FLOAT32", "FLOAT64", "INT8", "INT16", "INT32", "INT64",
    "UINT8", "UINT64", "UTF8", "dict_of", "pack_validity",
    "unpack_validity",
    "PAGE", "AnonRegion", "BufferStore", "Cgroup", "OOMError", "StoreFile",
    "StoreStats", "alloc_aligned", "CACHED", "DAG", "InvalidTransition",
    "NodeSpec", "NodeState", "Sandbox", "VALID_TRANSITIONS",
    "Manifest", "ManifestEntry", "code_fingerprint", "file_fingerprint",
    "fingerprint_dag", "node_fingerprint", "source_fingerprint",
    "IncrementalRecompute", "RefreshStats", "StreamWriter",
    "KernelZero", "DeCache", "Executor", "POLICIES", "RMConfig",
    "ResourceManager", "WORKERS_MODES", "make_executor",
    "AdmissionController", "EvictionPolicy", "SCHEDULES",
    "SchedulePolicy", "NodePoisonedError", "ProcessWorkerExecutor",
    "Ticket", "WorkerPoolExecutor", "get_eviction", "get_schedule",
    "register_eviction", "register_schedule",
    "FaultInjected", "FaultPlane", "PLANE", "StragglerDetector",
    "faultplane",
    "AddressMap", "BufRef", "SipcMessage", "SipcReader", "SipcWriter",
    "FlightClient", "FlightError", "FlightServer", "FlightWorkerError",
    "FlightWorkerLost", "FlightWorkerPool", "WireError", "decode_message",
    "encode_message", "frame_refs", "vkernels", "plan", "kdispatch",
    "ops",
]
