"""The node agent's side of the client/server split.

The counterpart of `nomad_tpu.client`; only `agent.ServerEndpoints`,
`agent.InProcServer` and the simulated node agent `sim.SimClient` are
ported (ROADMAP.md Queue 1 item 16 holds the rest).
"""
