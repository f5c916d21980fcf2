"""FlightServer — a named-ticket SIPC exchange over a Unix-domain socket.

The server owns a file-backed BufferStore and a registry of named
SipcMessages ("tickets").  Clients in other processes ``put`` and
``get`` messages by name; only schema bytes and file references cross
the socket — getting a 10 GB table costs a few hundred wire bytes, and
the client maps the server's store files directly.

Request/response are length-prefixed pickled dicts (trusted, same-host):

    {"op": "put", "ticket": str, "msg": <wire frame>}  -> {"ok": True}
    {"op": "get", "ticket": str}    -> {"ok": True, "msg": <wire frame>}
    {"op": "list"}                  -> {"ok": True, "tickets": [...]}
    {"op": "drop", "ticket": str}   -> {"ok": True}
    {"op": "stats"}                 -> {"ok": True, ...counters}

This is the long-lived service half of the Flight data plane (the
executor's worker pool is the ephemeral half): engine replicas or
separate pipeline processes exchange Arrow tables through it without
ever serializing data.
"""

from __future__ import annotations

import os
import pickle
import socket
import threading
from typing import Dict, Optional

from ..buffers import BufferStore
from ..sipc import SipcMessage
from .wire import decode_message, encode_message, recv_frame, send_frame


class FlightServer:
    def __init__(self, store: Optional[BufferStore] = None,
                 sock_path: Optional[str] = None):
        self.store = store or BufferStore(backing="file")
        if self.store.backing != "file":
            raise ValueError("FlightServer requires a file-backed store")
        self.sock_path = sock_path or os.path.join(
            self.store.data_dir, "flight.sock")
        self.tickets: Dict[str, SipcMessage] = {}
        self.requests = 0
        self.wire_bytes = 0          # bytes through the socket, both ways
        self._lock = threading.RLock()
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.sock_path)
        self._listener.listen(16)
        self._closed = False
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="flight-server", daemon=True)
        self._thread.start()

    # -- local (in-process) API --------------------------------------------
    def put(self, ticket: str, msg: SipcMessage) -> None:
        """Register a message already living in the server's store."""
        with self._lock:
            if not msg._pinned:
                msg.pin(self.store)
            self._store_ticket(ticket, msg)

    def _store_ticket(self, ticket: str, msg: SipcMessage) -> None:
        """Replace a ticket, releasing (and GC'ing) the previous message
        so publish-refresh cycles don't leak pinned store files.
        Caller holds the lock."""
        old = self.tickets.get(ticket)
        self.tickets[ticket] = msg
        if old is not None and old is not msg:
            self._release_and_gc(old)

    def _release_and_gc(self, msg: SipcMessage) -> None:
        msg.release()
        for fid in list(msg.files_referenced()):
            f = self.store.files.get(fid)
            if f is not None and f.refcount == 0 \
                    and not f.decache_pinned:
                self.store.delete_file(fid)

    # -- socket loop --------------------------------------------------------
    def _serve_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._client_loop, args=(conn,),
                             daemon=True).start()

    def _client_loop(self, conn: socket.socket) -> None:
        try:
            while True:
                try:
                    raw = recv_frame(conn)
                except (ConnectionError, OSError):
                    return
                self.wire_bytes += len(raw) + 8
                reply = self._dispatch(pickle.loads(raw))
                self.wire_bytes += send_frame(conn, pickle.dumps(reply))
        finally:
            conn.close()

    def _dispatch(self, req: dict) -> dict:
        self.requests += 1
        try:
            op = req.get("op")
            with self._lock:
                if op == "put":
                    msg = decode_message(req["msg"], self.store,
                                         adopt_owned=True,
                                         label=f"ticket:{req['ticket']}")
                    self._store_ticket(req["ticket"], msg)
                    return {"ok": True, "new_bytes": msg.new_bytes}
                if op == "get":
                    msg = self.tickets.get(req["ticket"])
                    if msg is None:
                        return {"ok": False,
                                "error": f"no ticket {req['ticket']!r}"}
                    return {"ok": True,
                            "msg": encode_message(msg, self.store)}
                if op == "drop":
                    msg = self.tickets.pop(req["ticket"], None)
                    if msg is not None:
                        self._release_and_gc(msg)
                    return {"ok": True}
                if op == "list":
                    return {"ok": True, "tickets": sorted(self.tickets)}
                if op == "stats":
                    return {"ok": True, "requests": self.requests,
                            "wire_bytes": self.wire_bytes,
                            "tickets": len(self.tickets),
                            **self.store.stats.snapshot()}
            return {"ok": False, "error": f"unknown op {op!r}"}
        except Exception as e:  # noqa: BLE001 — report to the client
            return {"ok": False, "error": repr(e)}

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass
