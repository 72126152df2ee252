"""Pooled RPC client.

Reference: helper/pool ConnPool — persistent connections per server,
reused across requests. One in-flight request per pooled connection;
concurrent callers draw distinct sockets.

The counterpart of `nomad_tpu.rpc.client`; `NOMAD_TPU_RPC_RETRIES`
sets the retry count at import, and `RpcClient(retries=)` wins.  Each
attempt consults the chaos site "rpc_transport" (one dict lookup while
nothing is armed): an armed injection fires and the attempt fails as a
transport fault, which the retry loop treats as any other.  A request
over the frame limit raises ValueError at once, where the reference
retries it as a transport fault (ROADMAP.md Queue 3, the frame fault).
"""
from __future__ import annotations

import itertools
import os
import random
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..chaos.injection import global_injections
from .wire import recv_frame, send_frame

DIAL_TIMEOUT_S = 0.5
CALL_TIMEOUT_S = 30.0           # > blocking-query timeouts
# transient-transport retry policy: attempts beyond the first, capped
# jittered exponential backoff between them, all inside the per-call
# deadline (default: the call timeout, so existing callers' worst-case
# latency is unchanged)
MAX_RETRIES = int(os.environ.get("NOMAD_TPU_RPC_RETRIES", "2"))
RETRY_BASE_S = 0.02
RETRY_CAP_S = 0.25


class RpcError(Exception):
    def __init__(self, kind: str, message: str = "",
                 data: Optional[Dict[str, Any]] = None):
        super().__init__(f"{kind}: {message}" if message else kind)
        self.kind = kind
        self.message = message
        self.data = data or {}


class RpcClient:
    def __init__(self, addr: Tuple[str, int], pool_size: int = 4,
                 tls=None, verify_hostname: str = ""):
        """`tls`: an ssl.SSLContext from tlsutil.client_context —
        presents this node's cert and verifies the server against the
        cluster CA on every pooled dial.

        `verify_hostname`: expected SAN role of the PEER (e.g.
        "server.global.nomad") — applied post-handshake on every fresh
        dial (reference: VerifyServerHostname).  CA pinning alone
        accepts ANY cluster cert; the role check stops a client-role
        cert from impersonating a server."""
        self.addr = (addr[0], int(addr[1]))
        self._pool: List[socket.socket] = []
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._pool_size = pool_size
        self._tls = tls
        self._verify_hostname = verify_hostname
        self._rng = random.Random()     # the retry backoff's jitter

    def call(self, method: str, params: List[Any],
             timeout: float = CALL_TIMEOUT_S,
             retries: Optional[int] = None,
             deadline_s: Optional[float] = None) -> Any:
        """One request/response. Raises RpcError for typed application
        errors, ConnectionError for transport failures and ValueError
        for a request over the frame limit (never retried).

        Transient transport failures (dial refused, reset, torn frame)
        retry up to `retries` extra attempts with capped jittered
        exponential backoff, all inside one wall-clock deadline —
        `deadline_s` when given, else `timeout`, so a probe with
        timeout=0.5 still fails within ~0.5s total and liveness
        detection latency is unchanged.  Typed RpcErrors (the server
        answered) never retry."""
        retries = MAX_RETRIES if retries is None else int(retries)
        deadline = time.monotonic() + (
            timeout if deadline_s is None else deadline_s)
        attempt = 0
        while True:
            try:
                remaining = deadline - time.monotonic()
                if attempt and remaining <= 0:
                    raise ConnectionError(
                        f"rpc to {self.addr}: deadline exceeded after "
                        f"{attempt} attempt(s)")
                return self._call_once(method, params,
                                       min(timeout, max(remaining,
                                                        0.001)))
            except ConnectionError:
                from ..utils.metrics import global_metrics as _m
                attempt += 1
                if attempt > retries:
                    if attempt > 1:
                        _m.incr_counter("rpc.client.retries_exhausted")
                    raise
                delay = min(RETRY_CAP_S,
                            RETRY_BASE_S * (2 ** (attempt - 1)))
                delay *= 0.5 + self._rng.random() / 2.0
                if time.monotonic() + delay >= deadline:
                    _m.incr_counter("rpc.client.deadline_exceeded")
                    raise
                _m.incr_counter("rpc.client.retries")
                time.sleep(delay)

    def _call_once(self, method: str, params: List[Any],
                   timeout: float) -> Any:
        inj = global_injections.get("rpc_transport")
        if inj is not None:
            inj.fire()
            raise ConnectionError(
                f"rpc to {self.addr}: injected transport fault")
        try:
            sock = self._checkout()
        except OSError as e:
            # dial/handshake failures (incl. TLS verification) present
            # uniformly as transport errors
            raise ConnectionError(f"rpc dial {self.addr}: {e}") from e
        try:
            sock.settimeout(timeout)
            send_frame(sock, {"id": next(self._ids), "method": method,
                              "params": params})
        except ValueError:
            # a request over the frame limit: nothing was sent, and a
            # retry would fail the same way, so it is the caller's error
            # and not a transport fault
            self._checkin(sock)
            raise
        except OSError as e:
            try:
                sock.close()
            except OSError:
                pass
            raise ConnectionError(
                f"rpc to {self.addr}: {e}") from e
        try:
            resp = recv_frame(sock)
        except (OSError, ValueError) as e:
            try:
                sock.close()
            except OSError:
                pass
            raise ConnectionError(
                f"rpc to {self.addr}: {e}") from e
        self._checkin(sock)
        err = resp.get("error")
        if err is not None:
            raise RpcError(err.get("kind", "error"),
                           err.get("message", ""), err.get("data"))
        return resp.get("result")

    def close(self) -> None:
        with self._lock:
            for s in self._pool:
                try:
                    s.close()
                except OSError:
                    pass
            self._pool.clear()

    # ------------------------------------------------------------------
    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._pool:
                return self._pool.pop()
        sock = socket.create_connection(self.addr,
                                        timeout=DIAL_TIMEOUT_S)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._tls is not None:
            sock = self._tls.wrap_socket(
                sock, server_hostname=self.addr[0])
            if self._verify_hostname:
                from ..utils.tlsutil import peer_role
                role = peer_role(sock)
                if role != self._verify_hostname:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    raise OSError(
                        f"peer presented role {role!r}, expected "
                        f"{self._verify_hostname!r}")
        return sock

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if len(self._pool) < self._pool_size:
                self._pool.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass


class ClientPool:
    """Keyed RpcClient pool shared by the raft transport and the server
    endpoints; replacing a key's address closes the old client."""

    def __init__(self, tls=None, verify_hostname: str = ""):
        self._clients: Dict[str, RpcClient] = {}
        self._lock = threading.Lock()
        self._tls = tls
        self._verify_hostname = verify_hostname

    def get(self, key: str, addr: Tuple[str, int]) -> RpcClient:
        addr = (addr[0], int(addr[1]))
        with self._lock:
            c = self._clients.get(key)
            if c is None or c.addr != addr:
                if c is not None:
                    c.close()
                c = RpcClient(addr, tls=self._tls,
                              verify_hostname=self._verify_hostname)
                self._clients[key] = c
            return c

    def close(self) -> None:
        with self._lock:
            for c in self._clients.values():
                c.close()
            self._clients.clear()
