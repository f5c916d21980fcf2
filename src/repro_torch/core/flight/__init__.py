"""Flight — the cross-process zero-copy data plane.

Three layers on top of the file-backed BufferStore mode:

  wire    — SIPC wire protocol: a SipcMessage serializes to schema bytes
            plus ``(file_path, offset, length)`` reference tuples; data
            never crosses the socket (readers mmap the referenced extents)
  server/
  client  — FlightServer/FlightClient: a named-ticket exchange over a
            Unix-domain socket for long-lived cross-process sharing
  worker  — FlightWorkerPool: spawned worker processes that run DAG node
            ops, receiving inputs and returning outputs as wire
            references (driven by ``ProcessWorkerExecutor``)

See docs/ARCHITECTURE.md §"Flight data plane".
"""

from .client import FlightClient, FlightError
from .server import FlightServer
from .wire import (WireError, decode_message, encode_message, frame_refs,
                   recv_frame, send_frame)
from .worker import (FlightWorkerError, FlightWorkerLost, FlightWorkerPool,
                     worker_main)

__all__ = [
    "FlightClient", "FlightError", "FlightServer",
    "WireError", "decode_message", "encode_message", "frame_refs",
    "recv_frame", "send_frame",
    "FlightWorkerError", "FlightWorkerLost", "FlightWorkerPool",
    "worker_main",
]
