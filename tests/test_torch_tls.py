"""Mutual TLS on the port's RPC plane (`nomad_tpu_torch.utils.tlsutil`
with `nomad_tpu_torch.rpc`): the RPC cases of the JAX package's
`tests/test_tls.py`, on the port.

Every listener and dial is wrapped in CA-pinned mutual TLS; a plaintext
or certless client never gets a frame served; a certificate of another
CA fails both ways; raft and other server-to-server verbs also require
the `server.<region>.nomad` role; `verify_hostname` pins the dialed
peer's role; a two-server cluster elects and forwards over mTLS, with
and without the role pin.  The PKI is minted with `cryptography`, and
the tests skip where it is missing (the RPC layer itself needs only
`ssl`).  The HTTP and CLI cases wait for the port's `api/` and `cli/`."""
import socket
import ssl
import subprocess
import sys
import time
from pathlib import Path

import pytest

from nomad_tpu.rpc.server import RpcServer as RefRpcServer
from nomad_tpu.utils import tlsutil as ref_tlsutil
from nomad_tpu_torch import mock
from nomad_tpu_torch.rpc.client import RpcClient, RpcError
from nomad_tpu_torch.rpc.endpoints import RpcServerEndpoints, serve_cluster
from nomad_tpu_torch.rpc.server import RpcServer
from nomad_tpu_torch.utils import tlsutil


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    pytest.importorskip("cryptography",
                        reason="PKI minting needs cryptography")
    return tlsutil.write_pki(str(tmp_path_factory.mktemp("pki")))


@pytest.fixture(scope="module")
def other_pki(tmp_path_factory):
    pytest.importorskip("cryptography",
                        reason="PKI minting needs cryptography")
    return tlsutil.write_pki(str(tmp_path_factory.mktemp("pki2")))


def wait_until(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def ping_server(pki_role, **kw):
    srv = RpcServer(tls=tlsutil.server_context(pki_role), **kw)
    srv.register("Status.Ping", lambda params: {"pong": params})
    srv.start()
    return srv


# ------------------------------------------------------------------ RPC
def test_rpc_runs_without_cryptography():
    """Only the PKI minting needs `cryptography`: with it missing, the
    RPC, transport, membership and the TLS contexts still import."""
    code = ("import sys\n"
            "sys.modules['cryptography'] = None\n"
            "import nomad_tpu_torch.rpc, nomad_tpu_torch.membership\n"
            "from nomad_tpu_torch.utils import tlsutil\n"
            "assert callable(tlsutil.server_context)\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_rpc_mutual_tls_roundtrip(pki):
    srv = ping_server(pki["server.global.nomad"])
    try:
        cli = RpcClient(srv.addr, tls=tlsutil.client_context(
            pki["cli.global.nomad"]))
        assert cli.call("Status.Ping", [1, 2]) == {"pong": [1, 2]}
        cli.close()
    finally:
        srv.stop()


def test_port_client_reaches_reference_server_over_mtls(pki):
    """The port's contexts and client complete the reference server's
    mutual handshake (and its contexts, built from the same files, are
    interchangeable with the port's)."""
    srv = RefRpcServer(tls=ref_tlsutil.server_context(
        pki["server.global.nomad"]))
    srv.register("Status.Ping", lambda params: {"pong": params})
    srv.start()
    try:
        cli = RpcClient(srv.addr, tls=tlsutil.client_context(
            pki["cli.global.nomad"]))
        assert cli.call("Status.Ping", ["x"]) == {"pong": ["x"]}
        cli.close()
    finally:
        srv.stop()


def test_rpc_rejects_plaintext_and_certless_clients(pki):
    srv = ping_server(pki["server.global.nomad"])
    try:
        # 1. plaintext client: no handshake, no frames served
        plain = RpcClient(srv.addr)
        with pytest.raises(ConnectionError):
            plain.call("Status.Ping", [], timeout=3.0)
        plain.close()
        # 2. TLS client with NO certificate: the handshake fails
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(pki["ca"])
        ctx.check_hostname = False
        raw = socket.create_connection(srv.addr, timeout=3.0)
        with pytest.raises(ssl.SSLError):
            s = ctx.wrap_socket(raw)
            # some stacks surface the rejection on first read
            s.settimeout(3.0)
            if not s.recv(1):
                raise ssl.SSLError("connection closed by server")
        raw.close()
        # the server still serves legitimate clients
        cli = RpcClient(srv.addr, tls=tlsutil.client_context(
            pki["cli.global.nomad"]))
        assert cli.call("Status.Ping", []) == {"pong": []}
        cli.close()
    finally:
        srv.stop()


def test_rpc_rejects_cert_from_wrong_ca(pki, other_pki):
    srv = ping_server(pki["server.global.nomad"])
    try:
        cli = RpcClient(srv.addr, tls=tlsutil.client_context(
            other_pki["cli.global.nomad"]))
        with pytest.raises(ConnectionError):
            cli.call("Status.Ping", [], timeout=3.0)
        cli.close()
    finally:
        srv.stop()


def test_client_role_cert_rejected_from_server_verbs(pki):
    """Any CA-signed cert completes the handshake, but raft and the
    other server-to-server verbs also require the server role: a
    client-role cert gets a typed permission_denied there, and public
    verbs still answer it."""
    srv = ping_server(pki["server.global.nomad"], region="global")
    srv.register("raft.rpc_request_vote", lambda params: "granted",
                 server_only=True)
    try:
        cli = RpcClient(srv.addr, tls=tlsutil.client_context(
            pki["client.global.nomad"]))
        assert cli.call("Status.Ping", []) == {"pong": []}
        with pytest.raises(RpcError) as e:
            cli.call("raft.rpc_request_vote", [])
        assert e.value.kind == "permission_denied"
        cli.close()
        peer = RpcClient(srv.addr, tls=tlsutil.client_context(
            pki["server.global.nomad"]))
        assert peer.call("raft.rpc_request_vote", []) == "granted"
        peer.close()
    finally:
        srv.stop()


def test_verify_hostname_rejects_non_server_peer(pki):
    """With verify_hostname set, a listener presenting a client-role cert
    is refused after the handshake although the CA pins it."""
    impostor = ping_server(pki["client.global.nomad"])
    try:
        cli = RpcClient(impostor.addr,
                        tls=tlsutil.client_context(
                            pki["server.global.nomad"]),
                        verify_hostname="server.global.nomad")
        with pytest.raises(ConnectionError):
            cli.call("Status.Ping", [], timeout=3.0)
        cli.close()
        lax = RpcClient(impostor.addr, tls=tlsutil.client_context(
            pki["server.global.nomad"]))
        assert lax.call("Status.Ping", []) == {"pong": []}
        lax.close()
    finally:
        impostor.stop()


@pytest.mark.parametrize("verify_hostname", ["", "server.global.nomad"],
                         ids=["ca_pinned", "role_gated"])
def test_two_node_cluster_over_mtls(pki, verify_hostname):
    """Two port servers with every RPC (raft heartbeats, appends,
    forwarding) over mutual TLS, with and without the role pin on
    server-to-server dials: a leader is elected, a registration through
    the endpoints lands on both, and a certless endpoint client reaches
    neither."""
    servers, server_rpcs, addrs = serve_cluster(
        n=2, num_workers=1, server_kwargs={"device": "cpu"},
        tls_server=tlsutil.server_context(pki["server.global.nomad"]),
        tls_client=tlsutil.client_context(pki["server.global.nomad"]),
        verify_hostname=verify_hostname)
    try:
        assert wait_until(lambda: any(s.is_leader() for s in servers)), \
            "mTLS raft failed to elect"
        job = mock.job()
        job.task_groups[0].count = 0
        eps = RpcServerEndpoints(
            list(addrs.values()),
            tls=tlsutil.client_context(pki["cli.global.nomad"]))
        eps.register_job(job)
        assert wait_until(lambda: all(
            s.store.job_by_id("default", job.id) is not None
            for s in servers))
        plain = RpcServerEndpoints(list(addrs.values()))
        with pytest.raises(ConnectionError):
            plain.register_job(mock.job())
        eps.close()
        plain.close()
    finally:
        for s, r in zip(servers, server_rpcs):
            s.stop()
            r.rpc.stop()
