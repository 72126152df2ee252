"""Wire RPC: length-prefixed JSON over TCP.

Reference: nomad/rpc.go — msgpack-RPC over yamux/TCP with region/leader
forwarding. The TPU build keeps the same three roles on one simpler
substrate (framed JSON over plain TCP, one in-flight request per pooled
connection):

  * RpcServer / RpcClient — the request/response substrate
    (nomad/rpc.go:24 handleConn + helper/pool ConnPool).
  * TcpRaftTransport — raft's peer transport (nomad/raft_rpc.go),
    pluggable against the same RaftNode the in-process transport drives.
  * ServerRpc — the server's RPC verbs (Node.*, Job.*, Status.*) with
    follower->leader forwarding (nomad/rpc.go forward()).
  * RpcServerEndpoints — the client agent's ServerEndpoints over the
    wire, with server-list failover (client/servers/).

The counterpart of `nomad_tpu.rpc`; the frames are byte for byte the
reference's, so either package's clients reach the other's servers.
"""
from .client import RpcClient, RpcError
from .endpoints import RpcServerEndpoints, ServerRpc
from .server import RpcServer
from .transport import TcpRaftTransport

__all__ = ["RpcClient", "RpcError", "RpcServer", "RpcServerEndpoints",
           "ServerRpc", "TcpRaftTransport"]
