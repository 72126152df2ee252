"""The node agent's side of the client/server split.

The counterpart of `nomad_tpu.client`: the agent (`agent.Client` with
its `ServerEndpoints` / `InProcServer` server surface), its alloc and
task runners, the alloc dir and task environment, the state DB, the
node fingerprint, the alloc filesystem and stats, and the simulated node
agent `sim.SimClient`.  The CSI manager (`csimanager.py`) comes with CSI
(ROADMAP.md Queue 1 item 16b).
"""
