"""Socket framing of the serving wire — the framing half of
``gofr_tpu/ml/multihost.py``, on the same wire format.

Two frame types share one wire, distinguished by the top bit of the
4-byte big-endian length prefix:

- JSON frames (bit clear): ``send_frame`` writes ``json.dumps(obj)``;
- BINARY frames (bit set, ``send_bytes``): the payload is raw bytes. KV
  page slabs ride these (``ml/kv_transport.py``), where base64 inside a
  JSON frame would cost a third more on the wire and a copy each side.

The flag bit caps one frame at 2 GiB. ``recv_frame`` returns parsed JSON
for a JSON frame, ``bytes`` for a binary one and ``None`` on EOF, so a
frame written by either package reads in the other.

Each call takes an optional chaos hook (``testutil/faults.py``):
``peer_send`` fires before the bytes hit the wire and ``peer_recv`` before
the header read, so an injected fault looks exactly like a torn
connection.

The multi-host serving topology that rides this wire in the JAX package,
``MultiHostWorker`` and ``MultiHostLLMClient`` (a ``torch.distributed``
mesh of workers behind a front-end), is not ported yet: it waits for a
cell with several hosts (ROADMAP A.14b).
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any

__all__ = ["send_frame", "send_bytes", "recv_frame"]

_BIN_FLAG = 0x8000_0000


def send_frame(sock: socket.socket, obj: Any, fault=None) -> None:
    """Send one JSON frame."""
    if fault is not None:
        fault("peer_send")
    raw = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(raw)) + raw)


def send_bytes(sock: socket.socket, payload: bytes, fault=None) -> None:
    """Send one raw-bytes frame (received as ``bytes`` by ``recv_frame``)."""
    if fault is not None:
        fault("peer_send")
    if len(payload) >= _BIN_FLAG:
        raise ValueError(
            f"binary frame too large ({len(payload)} bytes; max 2 GiB)")
    sock.sendall(struct.pack(">I", _BIN_FLAG | len(payload)) + payload)


def recv_frame(sock: socket.socket, fault=None) -> Any | None:
    """One frame: parsed JSON for a JSON frame, ``bytes`` for a binary
    frame, ``None`` on EOF."""
    if fault is not None:
        fault("peer_recv")
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (size,) = struct.unpack(">I", header)
    body = _recv_exact(sock, size & ~_BIN_FLAG)
    if body is None:
        return None
    if size & _BIN_FLAG:
        return body
    return json.loads(body)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)
