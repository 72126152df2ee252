"""Raft peer transport over the RPC substrate.

Reference: nomad/raft_rpc.go — raft gets its own stream family on the
shared listener. Here the raft verbs register as `raft.*` methods on
the server's RpcServer, and `call` dials peers through pooled clients.
Implements the same surface as raft.node.InProcTransport, so RaftNode
is transport-agnostic.

The counterpart of `nomad_tpu.rpc.transport`, with one addition: every
raft call is one frame, and the wire refuses a frame over
`wire.MAX_FRAME`, so the transport states `max_append_bytes`, the most
that one AppendEntries may carry in encoded entries, and
`max_snapshot_chunk_bytes`, the snapshot bytes one InstallSnapshot
chunk may carry.  `RaftNode` cuts each batch and each snapshot chunk to
them (the reference ships up to 512 entries
whatever their size, and a whole snapshot in one call, and a follower
that falls behind by more than a frame's worth never catches up).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Tuple

from ..utils.codec import from_wire, to_wire
from .client import ClientPool, RpcError
from . import wire
from .server import RpcHandlerError, RpcServer

_log = logging.getLogger(__name__)

# raft verbs must fail FAST on dead peers: the replication loop is
# sequential and the election timeout is 150-300ms, so a blocking dial
# would destabilize the healthy majority. A failed peer backs off
# exponentially (capped) before the next dial attempt.
RAFT_CALL_TIMEOUT_S = 2.0
BACKOFF_BASE_S = 0.25
BACKOFF_MAX_S = 5.0
VOTE_PROBE_TIMEOUT_S = 1.0
# the exempt-probe window must cover at least one full blocked dial,
# or a black-holed peer gets a fresh blocking probe every election
# round (each round is naturally spaced by the dial timeout itself)
VOTE_PROBE_WINDOW_S = 2 * VOTE_PROBE_TIMEOUT_S
# room left in a frame for the request envelope around the entries
# (id, method name, term, leader id, indexes)
FRAME_HEADROOM = 64 * 1024
# an InstallSnapshot chunk's call: the last chunk's answer waits out the
# follower's restore of the whole snapshot (tens of seconds at config 3)
INSTALL_CALL_TIMEOUT_S = 300.0
# JSON bytes around a bytes argument's base64 text (`{"__b64__":"..."}`)
_B64_ENVELOPE = 13


class TcpRaftTransport:
    def __init__(self, rpc_server: RpcServer,
                 peer_addrs: Dict[str, Tuple[str, int]], tls=None,
                 verify_hostname: str = ""):
        """peer_addrs: raft node id -> (host, port) of that peer's
        RpcServer (including this node's own).  `tls`: client-side
        ssl context for peer dials (mutual TLS); `verify_hostname`
        additionally pins the dialed peer's SAN role (raft peers must
        present server.<region>.nomad)."""
        self.rpc_server = rpc_server
        self.peer_addrs = dict(peer_addrs)
        self._pool = ClientPool(tls=tls, verify_hostname=verify_hostname)
        self._lock = threading.Lock()
        self._local: Dict[str, Any] = {}
        self._backoff: Dict[str, Tuple[float, int]] = {}  # until, fails
        self._vote_probe: Dict[str, float] = {}  # last exempt vote dial

    # -- the InProcTransport surface ----------------------------------
    @property
    def max_append_bytes(self) -> int:
        """Encoded bytes of entries that one AppendEntries may carry."""
        return wire.MAX_FRAME - FRAME_HEADROOM

    @property
    def max_snapshot_chunk_bytes(self) -> int:
        """Snapshot bytes that one InstallSnapshot chunk may carry: the
        codec sends bytes as base64 text (4 bytes for every 3) inside
        `{"__b64__":"..."}`, and that must fit `max_append_bytes`."""
        return (self.max_append_bytes - _B64_ENVELOPE) // 4 * 3

    def register(self, node) -> None:
        self._local[node.id] = node

        def handler(params, _v, _n):
            # the InProcTransport contract: a stopped (or replaced) node
            # is unreachable — it must not vote or ACK appends, or a
            # leader could count a non-durable ACK toward majority
            if not _n.running or self._local.get(_n.id) is not _n:
                raise RpcHandlerError("unreachable",
                                      f"raft node {_n.id} not running")
            return _to_jsonable(getattr(_n, _v)(*_decode_args(_v, params)))

        for verb in ("rpc_request_vote", "rpc_append_entries",
                     "rpc_install_snapshot"):
            # raft is strictly server-to-server: with mTLS on, a
            # client-role cert must not be able to vote or append
            self.rpc_server.register(
                f"raft.{verb}",
                lambda params, _v=verb, _n=node: handler(params, _v, _n),
                server_only=True)

    def unregister(self, node_id: str) -> None:
        self._local.pop(node_id, None)

    def call(self, target: str, method: str, *args):
        local = self._local.get(target)
        if local is not None:
            if not local.running:
                raise ConnectionError(f"peer {target} unreachable")
            return getattr(local, method)(*args)
        addr = self.peer_addrs.get(target)
        if addr is None:
            raise ConnectionError(f"no address for peer {target}")
        now = time.monotonic()
        with self._lock:
            until, fails = self._backoff.get(target, (0.0, 0))
            if now < until:
                # elections must still be able to reach a slow-but-
                # alive peer, but a black-holed peer must not reinstate
                # blocking dials in the sequential election loop: allow
                # ONE exempt vote probe per probe window (the window is
                # wider than the probe's own dial timeout, so at most
                # half of any period can be spent blocked on one peer)
                if method != "rpc_request_vote":
                    raise ConnectionError(f"peer {target} backing off")
                last = self._vote_probe.get(target, 0.0)
                if now - last < VOTE_PROBE_WINDOW_S:
                    raise ConnectionError(f"peer {target} backing off")
                self._vote_probe[target] = now
        client = self._pool.get(target, addr)
        try:
            out = client.call(f"raft.{method}",
                              _encode_args(method, list(args)),
                              timeout=_CALL_TIMEOUT_S.get(
                                  method, RAFT_CALL_TIMEOUT_S))
        except RpcError as e:
            raise ConnectionError(f"peer {target}: {e}") from e
        except ValueError as e:
            # a request over the frame limit: every retry fails the
            # same way, so say so loudly
            _log.error("raft %s to %s exceeds the frame limit: %s",
                       method, target, e)
            raise ConnectionError(f"peer {target}: {e}") from e
        except ConnectionError:
            with self._lock:
                _until, fails = self._backoff.get(target, (0.0, 0))
                delay = min(BACKOFF_BASE_S * (2 ** fails), BACKOFF_MAX_S)
                self._backoff[target] = (time.monotonic() + delay,
                                         fails + 1)
            raise
        with self._lock:
            self._backoff.pop(target, None)
        return _decode_result(method, out)


_CALL_TIMEOUT_S = {"rpc_request_vote": VOTE_PROBE_TIMEOUT_S,
                   "rpc_install_snapshot": INSTALL_CALL_TIMEOUT_S}


# bytes (snapshot payloads) ride the codec's base64 envelope; everything
# else in the raft verbs is already JSON-able (entries are tuples of
# JSON payloads)
def _encode_args(method: str, args):
    return [to_wire(a) if isinstance(a, bytes) else a for a in args]


def _decode_args(method: str, params):
    return [from_wire(bytes, p)
            if isinstance(p, dict) and "__b64__" in p else p
            for p in params]


def _to_jsonable(result):
    if isinstance(result, tuple):
        return list(result)
    return result


def _decode_result(method: str, out):
    # callers unpack fixed-arity tuples
    if isinstance(out, list):
        return tuple(out)
    return out
