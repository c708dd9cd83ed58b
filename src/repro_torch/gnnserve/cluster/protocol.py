"""Length-prefixed JSON/binary framing for the cluster serving tier —
the port's copy of ``repro.gnnserve.cluster.protocol``, byte for byte
the same frames, so either package's ``recv_msg`` reads the other's.

Standard library only (sockets, struct, json) plus numpy.

Wire format, one frame per message:

    u32 frame_len                           # bytes after this field
    u32 header_len
    header_len bytes of UTF-8 JSON          # op/fields + array manifest
    concatenated raw array bytes            # in manifest order

The JSON header carries the small fields (op name, seq numbers, stats
trees); numpy arrays ride OUTSIDE the JSON as raw bytes, described by a
``_arrays`` manifest (``[{name, dtype, shape}, ...]``) so a large
float32 gather never round-trips through decimal text.  Both directions
use the same frame; responses carry ``ok: true`` or ``ok: false`` +
``error`` + ``traceback``.

``Channel`` is the client half: one persistent connection, one
request/response in flight at a time (a lock serializes callers), a
configurable timeout that surfaces as ``WorkerTimeout`` so the
deployment can consult the worker's heartbeat file and diagnose a wedge
by stage name instead of a bare socket timeout.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

# one u32 length prefix; frames above this are a protocol error, not an
# allocation bomb — a corrupt/malicious prefix must not trigger a
# multi-GiB allocation in ``_recv_exact``.  One level of a 1,048,576-node
# world at 128 f32 columns is 512 MiB, over the cap: look rows up in
# queries of their own size, and compare whole worlds with the
# ``digest`` op.  Callers with larger frames pass ``max_frame``.
MAX_FRAME = 1 << 28


class ProtocolError(RuntimeError):
    """Malformed frame / unexpected EOF on the wire."""


class WorkerError(RuntimeError):
    """The remote worker raised; carries its traceback text."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback


class WorkerTimeout(RuntimeError):
    """No response within the channel timeout — the caller should check
    the worker's heartbeat file before deciding dead vs slow."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(min(n - len(buf), 1 << 20))
        except socket.timeout as exc:
            raise WorkerTimeout(
                f"no bytes for {sock.gettimeout()}s mid-frame") from exc
        if not chunk:
            raise ProtocolError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def send_msg(sock: socket.socket, header: Dict,
             arrays: Optional[Dict[str, np.ndarray]] = None, *,
             max_frame: int = MAX_FRAME) -> None:
    """Send one frame: JSON ``header`` plus raw ``arrays`` payloads."""
    arrays = arrays or {}
    manifest = []
    blobs = []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        manifest.append({"name": name, "dtype": arr.dtype.str,
                         "shape": list(arr.shape)})
        blobs.append(arr.tobytes())
    doc = dict(header)
    doc["_arrays"] = manifest
    head = json.dumps(doc).encode()
    body = b"".join([struct.pack("<I", len(head)), head] + blobs)
    if len(body) + 4 > max_frame:
        raise ProtocolError(f"frame too large ({len(body)} bytes)")
    sock.sendall(struct.pack("<I", len(body)) + body)


def recv_msg(sock: socket.socket, *, max_frame: int = MAX_FRAME
             ) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Receive one frame -> (header, arrays).  Raises ProtocolError on
    EOF/garbage, WorkerTimeout if a frame stalls mid-flight.  A timeout
    BEFORE any byte of a frame arrives re-raises ``socket.timeout``
    as-is — that's idleness at a frame boundary, not a torn frame, and
    the worker serve loop uses it to stamp heartbeats while idle
    (``Channel.request`` converts it to WorkerTimeout: there a silent
    peer IS the failure)."""
    raw = sock.recv(4)
    if not raw:
        raise ProtocolError("connection closed")
    raw += _recv_exact(sock, 4 - len(raw)) if len(raw) < 4 else b""
    (frame_len,) = struct.unpack("<I", raw)
    if frame_len > max_frame:
        raise ProtocolError(f"frame length {frame_len} exceeds cap")
    body = _recv_exact(sock, frame_len)
    (head_len,) = struct.unpack("<I", body[:4])
    if head_len + 4 > frame_len:
        raise ProtocolError("header length exceeds frame")
    try:
        header = json.loads(body[4:4 + head_len].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ProtocolError(f"bad JSON header: {exc}") from None
    arrays: Dict[str, np.ndarray] = {}
    off = 4 + head_len
    for spec in header.pop("_arrays", []):
        dt = np.dtype(spec["dtype"])
        shape = tuple(int(x) for x in spec["shape"])
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if off + n > len(body):
            raise ProtocolError(
                f"array {spec['name']!r} overruns the frame")
        arrays[spec["name"]] = np.frombuffer(
            body[off:off + n], dtype=dt).reshape(shape).copy()
        off += n
    return header, arrays


class Channel:
    """One persistent client connection to a ShardWorker, with a lock so
    concurrent router threads serialize their request/response pairs."""

    def __init__(self, host: str, port: int, *,
                 timeout: Optional[float] = 30.0,
                 connect_timeout: float = 5.0):
        self.host, self.port = host, int(port)
        self.timeout = timeout
        self._lock = threading.Lock()
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=connect_timeout)
        self._sock.settimeout(timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def request(self, op: str,
                arrays: Optional[Dict[str, np.ndarray]] = None,
                **fields) -> Tuple[Dict, Dict[str, np.ndarray]]:
        """One round trip.  Raises ``WorkerError`` when the remote
        handler failed, ``WorkerTimeout``/``ProtocolError`` when the
        connection did."""
        header = {"op": op, **fields}
        with self._lock:
            send_msg(self._sock, header, arrays)
            try:
                resp, resp_arrays = recv_msg(self._sock)
            except socket.timeout as exc:
                raise WorkerTimeout(
                    f"no response to {op!r} within "
                    f"{self._sock.gettimeout()}s") from exc
        if not resp.get("ok", False):
            raise WorkerError(
                f"shard op {op!r} failed: {resp.get('error', '?')}",
                resp.get("traceback", ""))
        return resp, resp_arrays

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


__all__ = ["Channel", "MAX_FRAME", "ProtocolError", "WorkerError",
           "WorkerTimeout", "recv_msg", "send_msg"]
