"""Threaded RPC server: dispatches framed requests to named handlers.

Reference: nomad/rpc.go handleConn/handleNomadConn — a goroutine per
connection decoding requests and dispatching to registered endpoints.

The counterpart of `nomad_tpu.rpc.server`.
"""
from __future__ import annotations

import logging
import socket
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from .wire import recv_frame, send_frame

_log = logging.getLogger(__name__)


class RpcServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 tls=None, region: str = "global"):
        """`tls`: an ssl.SSLContext from tlsutil.server_context —
        mutual TLS; a client with no CA-signed cert fails the
        handshake before a single frame is read (reference:
        nomad/rpc.go:99-115 wraps every conn in tls.Server).

        `region` names the server SAN role (`server.<region>.nomad`)
        that verbs registered with server_only=True require of the
        PEER's certificate — the reference's certificate-role check
        (nomad/rpc.go validateServerHostname): with mutual TLS on, a
        client-role cert must not reach raft or other server-to-server
        verbs."""
        self._handlers: Dict[str, Tuple[Callable[[List[Any]], Any],
                                        bool]] = {}
        self._tls = tls
        self.region = region
        self._server_role = f"server.{region}.nomad"
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.addr: Tuple[str, int] = self._sock.getsockname()
        self._shutdown = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None

    def register(self, method: str, fn: Callable[[List[Any]], Any],
                 server_only: bool = False) -> None:
        """fn receives the params list and returns a JSON-able result;
        raising RpcHandlerError sends a typed error frame.
        `server_only` verbs (raft, server-to-server forwarding) require
        the mTLS peer to present a server.<region>.nomad role cert."""
        self._handlers[method] = (fn, server_only)

    def start(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"rpc-accept-{self.addr[1]}")
        self._accept_thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _peer = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        role: Optional[str] = None
        if self._tls is not None:
            try:
                # a short handshake deadline so a plaintext client
                # can't pin the thread; cleared for the frame loop
                conn.settimeout(5.0)
                conn = self._tls.wrap_socket(conn, server_side=True)
                conn.settimeout(None)
            except (OSError, ValueError) as e:
                _log.debug("rpc tls handshake rejected: %s", e)
                try:
                    conn.close()
                except OSError:
                    pass
                return
            from ..utils.tlsutil import peer_role
            role = peer_role(conn)
        try:
            while not self._shutdown.is_set():
                try:
                    req = recv_frame(conn)
                except (ConnectionError, ValueError, OSError):
                    return
                # a stopped server must not answer a request that raced
                # the shutdown (callers probe liveness through these
                # sockets — e.g. the gossip failure detector)
                if self._shutdown.is_set():
                    return
                try:
                    resp = self._dispatch(req, role)
                    send_frame(conn, resp)
                except OSError:
                    return
                except Exception:               # noqa: BLE001
                    # malformed request shape or unserializable handler
                    # result: answer with a typed error instead of
                    # killing the connection
                    _log.exception("rpc dispatch failed")
                    try:
                        rid = req.get("id") if isinstance(req, dict) \
                            else None
                        send_frame(conn, {"id": rid, "error": {
                            "kind": "internal",
                            "message": "dispatch failed"}})
                    except OSError:
                        return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, req: Any, role: Optional[str] = None) -> Any:
        if not isinstance(req, dict):
            return {"id": None, "error": {"kind": "bad_request",
                                          "message": "frame is not an object"}}
        rid = req.get("id")
        method = req.get("method", "")
        ent = self._handlers.get(method)
        if ent is None:
            return {"id": rid, "error": {"kind": "unknown_method",
                                         "message": method}}
        fn, server_only = ent
        if server_only and self._tls is not None \
                and role != self._server_role:
            # certificate-role confusion guard: with mTLS on, ANY
            # CA-signed cert completes the handshake, but only a
            # server-role cert may speak server-to-server verbs
            _log.warning("rpc %s denied: peer role %r != %r", method,
                         role, self._server_role)
            return {"id": rid, "error": {
                "kind": "permission_denied",
                "message": f"{method} requires a "
                           f"{self._server_role} certificate"}}
        try:
            return {"id": rid, "result": fn(req.get("params", []))}
        except RpcHandlerError as e:
            return {"id": rid, "error": e.wire()}
        except Exception as e:                      # noqa: BLE001
            _log.exception("rpc handler %s failed", method)
            return {"id": rid, "error": {"kind": "internal",
                                         "message": f"{type(e).__name__}: {e}"}}


class RpcHandlerError(Exception):
    """Typed application error carried over the wire (e.g. not_leader
    with a forwarding hint)."""

    def __init__(self, kind: str, message: str = "",
                 data: Optional[Dict[str, Any]] = None):
        super().__init__(message or kind)
        self.kind = kind
        self.message = message
        self.data = data or {}

    def wire(self) -> Dict[str, Any]:
        return {"kind": self.kind, "message": self.message,
                "data": self.data}
