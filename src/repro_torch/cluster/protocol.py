"""Length-prefixed worker wire protocol — the cluster's one framing layer.

Counterpart of ``repro/cluster/protocol.py``, unchanged on the wire: the
same magic, header and frame cap, so a frame written by either package
decodes in the other.

Every byte between the router (or a load generator) and an engine worker
moves through here: a fixed 8-byte header — ``b"SPRP"`` magic + big-endian
``uint32`` payload length — followed by a pickled payload dict.  Requests
are ``{"verb": str, ...fields}``; replies are ``{"ok": True, "result": ...}``
or ``{"ok": False, "error", "error_type", "traceback"}``.  Pickle (not JSON)
because request payloads and result rows are numpy arrays and the sockets
are AF_UNIX — same machine, same trust domain; plans still cross as the
JSON-able IR inside the payload so nothing *semantic* depends on pickle
(docs/cluster.md#worker-protocol, written for the JAX package).

Failure taxonomy (what the router's failover keys on):

  * :class:`ConnectionClosed` — clean EOF mid-conversation.
  * :class:`WorkerLostError` — the peer died or the pipe broke; carries
    ``reason = "worker_lost"``, the shed reason the replay report surfaces
    when failover cannot save a request.
  * :class:`RemoteError` — the worker executed the verb and *it* raised;
    the remote traceback rides along.  Not a worker loss: the worker is
    healthy, the request was bad.
"""

from __future__ import annotations

import pickle
import socket
import struct
import time

__all__ = [
    "MAGIC",
    "HEADER",
    "MAX_FRAME",
    "ConnectionClosed",
    "RemoteError",
    "WorkerLostError",
    "send_msg",
    "recv_msg",
    "WorkerClient",
]

MAGIC = b"SPRP"
HEADER = struct.Struct("!4sI")  # magic, payload length
MAX_FRAME = 1 << 30  # 1 GiB: no sane request frame is larger; corrupt
# headers must not trigger a 4 GiB recv allocation


class ConnectionClosed(Exception):
    """The peer closed the connection cleanly (EOF at a frame boundary)."""


class WorkerLostError(RuntimeError):
    """The worker process (or its socket) died mid-conversation.

    ``reason`` is the shed-reason string the serving report uses when the
    router cannot re-route the request to a surviving worker.
    """

    reason = "worker_lost"

    def __init__(self, worker_id: str, detail: str = ""):
        self.worker_id = worker_id
        super().__init__(
            f"worker {worker_id!r} lost" + (f": {detail}" if detail else "")
        )


class RemoteError(RuntimeError):
    """The worker ran the verb and raised; the remote traceback rides along."""

    def __init__(self, error_type: str, error: str, traceback_text: str = ""):
        self.error_type = error_type
        self.remote_traceback = traceback_text
        super().__init__(f"{error_type}: {error}")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ConnectionClosed on EOF."""
    chunks = []
    while n > 0:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionClosed("peer closed the connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def send_msg(sock: socket.socket, obj) -> None:
    """Frame and send one message (header + pickled payload, one sendall)."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(payload)} > {MAX_FRAME}")
    sock.sendall(HEADER.pack(MAGIC, len(payload)) + payload)


def recv_msg(sock: socket.socket):
    """Receive one framed message; validates magic and length bounds.

    Raises:
      ConnectionClosed: clean EOF before/inside a frame.
      ValueError: bad magic or an out-of-bounds length (corrupt stream —
        there is no resynchronizing a length-prefixed stream, hang up).
    """
    magic, length = HEADER.unpack(_recv_exact(sock, HEADER.size))
    if magic != MAGIC:
        raise ValueError(f"bad frame magic {magic!r} (expected {MAGIC!r})")
    if length > MAX_FRAME:
        raise ValueError(f"frame length {length} exceeds cap {MAX_FRAME}")
    return pickle.loads(_recv_exact(sock, length))


class WorkerClient:
    """One caller's connection to one worker: request/reply over AF_UNIX.

    A client is cheap (one socket) and single-conversation: a lock
    serializes request/reply pairs so multiple threads may share one
    client without interleaving frames.  Higher layers that want true
    concurrency per worker open one client per thread — the worker side
    is thread-per-connection.
    """

    def __init__(self, address: str, *, connect_timeout: float = 60.0,
                 worker_id: str = ""):
        """Connect, retrying until the worker binds its socket.

        Args:
          address: the worker's AF_UNIX socket path.
          connect_timeout: seconds to keep retrying (worker start pays a
            torch import and the card's context, which dwarf socket setup).
          worker_id: identity used in WorkerLostError diagnostics.

        Raises:
          WorkerLostError: the worker never came up within the timeout.
        """
        import threading

        self.address = address
        self.worker_id = worker_id or address
        self._lock = threading.Lock()
        deadline = time.monotonic() + connect_timeout
        last: Exception = None
        while True:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                sock.connect(address)
                self._sock = sock
                return
            except OSError as e:
                sock.close()
                last = e
                if time.monotonic() >= deadline:
                    raise WorkerLostError(
                        self.worker_id, f"never connected: {last}"
                    ) from last
                time.sleep(0.05)

    def request(self, verb: str, **fields):
        """One verb round-trip; returns the reply's ``result``.

        Raises:
          WorkerLostError: the socket broke mid-conversation (the worker
            died) — the router's failover trigger.
          RemoteError: the worker raised while executing the verb.
        """
        msg = {"verb": verb, **fields}
        with self._lock:
            try:
                send_msg(self._sock, msg)
                reply = recv_msg(self._sock)
            except (ConnectionClosed, OSError) as e:
                raise WorkerLostError(self.worker_id, str(e)) from e
        if reply.get("ok"):
            return reply.get("result")
        raise RemoteError(
            reply.get("error_type", "RuntimeError"),
            reply.get("error", "worker error"),
            reply.get("traceback", ""),
        )

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
