"""FlightClient — the consumer half of the named-ticket SIPC exchange.

Connects to a FlightServer's Unix-domain socket.  ``get`` returns a
SipcMessage decoded into the *caller's* store (mapping the server's
files — zero data bytes moved); ``put`` publishes a local message by
reference.  Counters record exactly how many bytes crossed the socket
so zero-copy claims are checkable.
"""

from __future__ import annotations

import pickle
import socket
from typing import List, Optional

from .. import faultplane
from ..buffers import BufferStore
from ..sipc import SipcMessage
from .wire import decode_message, encode_message, recv_frame, send_frame

faultplane.register_hook("client_call", "flight client: fail/stall a "
                         "ticket-exchange call before it hits the wire")


class FlightError(RuntimeError):
    pass


class FlightClient:
    def __init__(self, sock_path: str, store: Optional[BufferStore] = None,
                 timeout: float = 60.0):
        self.store = store or BufferStore(backing="file")
        if self.store.backing != "file":
            raise ValueError("FlightClient requires a file-backed store")
        self.timeout = timeout
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout)
        self.sock.connect(sock_path)
        self.wire_bytes = 0

    def _call(self, req: dict) -> dict:
        faultplane.fire("client_call")
        try:
            self.wire_bytes += send_frame(self.sock, pickle.dumps(req))
            raw = recv_frame(self.sock)
        except socket.timeout:
            # a half-finished exchange leaves the stream unframed; the
            # typed error lets callers retire this client cleanly
            raise FlightError(
                f"flight client timed out after {self.timeout}s during "
                f"{req.get('op')!r}") from None
        self.wire_bytes += len(raw) + 8
        reply = pickle.loads(raw)
        if not reply.get("ok"):
            raise FlightError(reply.get("error", "flight request failed"))
        return reply

    # -- API ----------------------------------------------------------------
    def put(self, ticket: str, msg: SipcMessage) -> None:
        self._call({"op": "put", "ticket": ticket,
                    "msg": encode_message(msg, self.store)})

    def get(self, ticket: str) -> SipcMessage:
        reply = self._call({"op": "get", "ticket": ticket})
        return decode_message(reply["msg"], self.store,
                              label=f"ticket:{ticket}")

    def drop(self, ticket: str) -> None:
        self._call({"op": "drop", "ticket": ticket})

    def list(self) -> List[str]:
        return self._call({"op": "list"})["tickets"]

    def stats(self) -> dict:
        return self._call({"op": "stats"})

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
