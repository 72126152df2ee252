"""Framing: 4-byte big-endian length + JSON body.

The reference multiplexes msgpack-RPC streams over yamux
(nomad/rpc.go:104); here each pooled connection carries one in-flight
request, so plain length-prefixed frames suffice and stay debuggable.

The counterpart of `nomad_tpu.rpc.wire`: the same bytes on the wire, so
the two packages' clients and servers talk to each other.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Any

MAX_FRAME = 64 * 1024 * 1024    # snapshots ship over this transport


def send_frame(sock: socket.socket, obj: Any) -> None:
    body = json.dumps(obj, separators=(",", ":")).encode()
    if len(body) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(body)}")
    sock.sendall(struct.pack(">I", len(body)) + body)


def recv_frame(sock: socket.socket) -> Any:
    header = _recv_exact(sock, 4)
    (n,) = struct.unpack(">I", header)
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    return json.loads(_recv_exact(sock, n).decode())


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf.extend(chunk)
    return bytes(buf)
