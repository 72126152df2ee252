"""The replicated state machine over StateStore.

Reference: nomad/fsm.go — Apply dispatches typed log entries to state
store writes (fsm.go:180 switch), Snapshot persists every table
(fsm.go:1189), Restore rebuilds the store (fsm.go:1203). Entries here
carry plain-JSON payloads (utils/codec) so the same bytes serve the
durable log, snapshots, and the wire.

Determinism: every apply writes the store purely from (index, payload,
current store state) — timestamps are stamped by the proposer and travel
in the payload, so leader and followers converge bit-for-bit.

The counterpart of `nomad_tpu.raft.fsm`; its snapshot is JSON lines
(`StateFSM.snapshot` says why), the reference's one JSON object.
"""
from __future__ import annotations

import json
from typing import Any, Dict

from ..state.store import JobSummary, SchedulerConfiguration, StateStore
from ..structs import (Allocation, DeploymentStatusUpdate,
                       DesiredTransition, Deployment, Evaluation, Job, Node,
                       PlanResult)
from ..utils.codec import from_wire, to_wire

# entry type -> (payload struct fields needing decode)
NOOP = "noop"


class StateFSM:
    """Applies committed log entries to a StateStore. Broker enqueue is
    NOT done here: the leader's write paths enqueue after propose()
    returns (reference: fsm.go:680 handleUpsertedEval is leader-gated
    for the same reason — follower FSMs only write state)."""

    def __init__(self, store: StateStore):
        self.store = store

    # ------------------------------------------------------------ apply
    def apply(self, index: int, etype: str, p: Any) -> None:
        if etype == NOOP:
            return
        handler = getattr(self, "_ap_" + etype, None)
        if handler is None:
            raise ValueError(f"unknown raft entry type {etype!r}")
        handler(index, p)

    def _ap_node_upsert(self, index, p):
        self.store.upsert_node(index, from_wire(Node, p["node"]))

    def _ap_node_status(self, index, p):
        # a committed entry may target a node a racing reap already
        # deleted; the no-op is deterministic (same state, same order on
        # every replica) — raising would poison the log instead
        if self.store.node_by_id(p["node_id"]) is None:
            return
        self.store.update_node_status(index, p["node_id"], p["status"])

    def _ap_node_eligibility(self, index, p):
        if self.store.node_by_id(p["node_id"]) is None:
            return
        self.store.update_node_eligibility(index, p["node_id"],
                                           p["eligibility"])

    def _ap_node_drain(self, index, p):
        from ..structs import DrainStrategy
        if self.store.node_by_id(p["node_id"]) is None:
            return
        ds = from_wire(DrainStrategy, p["drain_strategy"]) \
            if p.get("drain_strategy") is not None else None
        self.store.update_node_drain(index, p["node_id"], ds,
                                     p.get("mark_eligible", False))

    def _ap_nodes_reap(self, index, p):
        for nid in p["node_ids"]:
            self.store.delete_node(index, nid)

    def _ap_job_upsert(self, index, p):
        self.store.upsert_job(index, from_wire(Job, p["job"]))

    def _ap_job_delete(self, index, p):
        self.store.delete_job(index, p["namespace"], p["job_id"])

    def _ap_jobs_reap(self, index, p):
        for namespace, job_id in p["keys"]:
            self.store.delete_job(index, namespace, job_id)

    def _ap_evals_upsert(self, index, p):
        self.store.upsert_evals(
            index, [from_wire(Evaluation, e) for e in p["evals"]])

    def _ap_evals_reap(self, index, p):
        self.store.delete_eval(index, p["eval_ids"], p["alloc_ids"])

    def _ap_allocs_client(self, index, p):
        self.store.update_allocs_from_client(
            index, [from_wire(Allocation, a) for a in p["updates"]])

    def _ap_alloc_transition(self, index, p):
        self.store.update_alloc_desired_transition(
            index, p["alloc_ids"],
            from_wire(DesiredTransition, p["transition"]))

    def _ap_plan_result(self, index, p):
        result = from_wire(PlanResult, p["result"])
        job = from_wire(Job, p["job"]) if p.get("job") is not None else None
        self.store.upsert_plan_results(index, result, job)

    def _ap_plan_results_batch(self, index, p):
        # group commit: K plan results in one log entry, in
        # submission order, all under the shared commit index — the same
        # store state K consecutive plan_result entries would produce
        for item in p["items"]:
            result = from_wire(PlanResult, item["result"])
            job = from_wire(Job, item["job"]) \
                if item.get("job") is not None else None
            self.store.upsert_plan_results(index, result, job)

    def _ap_job_stability(self, index, p):
        self.store.update_job_stability(index, p["namespace"],
                                        p["job_id"], p["version"],
                                        p["stable"])

    def _ap_deployment_status(self, index, p):
        self.store.upsert_deployment_updates(
            index,
            [from_wire(DeploymentStatusUpdate, u) for u in p["updates"]])
        if p.get("mark_stable") is not None:
            namespace, job_id, version = p["mark_stable"]
            self.store.update_job_stability(index, namespace, job_id,
                                            version, True)

    def _ap_deployment_promote(self, index, p):
        if self.store.deployment_by_id(p["dep_id"]) is None:
            return
        self.store.update_deployment_promotion(index, p["dep_id"],
                                               p.get("groups"))

    def _ap_deployments_reap(self, index, p):
        self.store.delete_deployment(index, p["dep_ids"])

    def _ap_periodic_launch(self, index, p):
        self.store.upsert_periodic_launch(index, p["namespace"],
                                          p["job_id"], p["launch"])

    def _ap_secret_upsert(self, index, p):
        self.store.upsert_secret(index, p["namespace"], p["path"],
                                 p["data"])

    def _ap_secret_delete(self, index, p):
        self.store.delete_secret(index, p["namespace"], p["path"])

    def _ap_acl_policy_upsert(self, index, p):
        from ..acl import ACLPolicy
        self.store.upsert_acl_policy(index,
                                     from_wire(ACLPolicy, p["policy"]))

    def _ap_acl_policy_delete(self, index, p):
        self.store.delete_acl_policy(index, p["name"])

    def _ap_acl_token_upsert(self, index, p):
        from ..acl import ACLToken
        self.store.upsert_acl_token(index,
                                    from_wire(ACLToken, p["token"]))
        if p.get("bootstrap"):
            self.store.set_acl_bootstrapped(index)

    def _ap_acl_token_delete(self, index, p):
        self.store.delete_acl_token(index, p["accessor_id"])

    def _ap_csi_volume_upsert(self, index, p):
        from ..structs import CSIVolume
        self.store.upsert_csi_volume(index,
                                     from_wire(CSIVolume, p["volume"]))

    def _ap_csi_volume_delete(self, index, p):
        try:
            self.store.delete_csi_volume(index, p["namespace"],
                                         p["volume_id"])
        except ValueError:
            pass    # in-use: deterministic no-op on every replica

    def _ap_csi_volume_claim(self, index, p):
        try:
            self.store.claim_csi_volume(
                index, p["namespace"], p["volume_id"], p["mode"],
                p["alloc_id"], p["node_id"])
        except (KeyError, ValueError):
            pass    # validated by the proposer; tolerate races

    def _ap_csi_claims_release(self, index, p):
        self.store.release_csi_claims(index, p["alloc_id"])

    def _ap_scheduler_config(self, index, p):
        cfg = SchedulerConfiguration()
        cfg.__dict__.update(p["config"])
        self.store.set_scheduler_config(index, cfg)

    # --------------------------------------------------------- snapshot
    _STRUCT_TABLES = {
        "nodes": Node, "jobs": Job, "evals": Evaluation,
        "allocs": Allocation, "deployments": Deployment,
    }
    _TUPLE_KEY_TABLES = ("jobs", "job_versions", "job_summaries",
                         "periodic_launches", "csi_volumes")

    def snapshot(self) -> bytes:
        """Serialize every replicated table (fsm.go:1189 Snapshot +
        nomad/state snapshot persisters) as JSON lines: a header, then
        one `[table, row]` line per row.  No single encode or decode
        holds the interpreter for the whole store (a 200 MB snapshot at
        config 3 took seconds in one `json.dumps`, and raft's heartbeats
        of every server in the process stalled past the election
        timeout); the reference writes one JSON object."""
        st = self.store
        with st._lock:
            out: Dict[str, Any] = {"latest_index": st.index,
                                   "table_indexes": dict(st._ix)}
            tables: Dict[str, list] = {}
            for name, cls in self._STRUCT_TABLES.items():
                tables[name] = [[self._key(name, k), to_wire(v)]
                                for k, v in st._t[name].items()]
            tables["job_versions"] = [
                [list(k), [to_wire(j) for j in v]]
                for k, v in st._t["job_versions"].items()]
            tables["job_summaries"] = [
                [list(k), to_wire(v)]
                for k, v in st._t["job_summaries"].items()]
            tables["periodic_launches"] = [
                [list(k), v] for k, v in st._t["periodic_launches"].items()]
            tables["csi_volumes"] = [
                [list(k), to_wire(v)]
                for k, v in st._t["csi_volumes"].items()]
            tables["acl_policies"] = [
                [k, to_wire(v)] for k, v in st._t["acl_policies"].items()]
            tables["acl_tokens"] = [
                [k, to_wire(v)] for k, v in st._t["acl_tokens"].items()]
            tables["cluster_meta"] = [
                [k, v] for k, v in st._t["cluster_meta"].items()]
            tables["services"] = [
                [k, to_wire(v)] for k, v in st._t["services"].items()]
            tables["secrets"] = [
                [list(k), v] for k, v in st._t["secrets"].items()]
            tables["scheduler_config"] = [
                [k, to_wire(v)] for k, v in st._t["scheduler_config"].items()]
        encode = json.JSONEncoder(separators=(",", ":")).encode
        lines = [encode(out)]
        for name, rows in tables.items():
            lines.extend(encode([name, row]) for row in rows)
        return "\n".join(lines).encode()

    def restore(self, data: bytes) -> None:
        """Rebuild the store from a snapshot (fsm.go:1203 Restore),
        including the derived secondary indexes."""
        head, *rows = data.split(b"\n")
        snap = json.loads(head)
        t: Dict[str, list] = {}
        for line in rows:
            name, row = json.loads(line)
            t.setdefault(name, []).append(row)
        st = self.store
        with st._lock:
            for name in st._t:
                st._t[name].clear()
            for name, cls in self._STRUCT_TABLES.items():
                for k, wire in t.get(name, ()):  # noqa: B007
                    st._t[name][self._unkey(name, k)] = from_wire(cls, wire)
            for k, versions in t.get("job_versions", ()):
                st._t["job_versions"][tuple(k)] = [
                    from_wire(Job, j) for j in versions]
            for k, wire in t.get("job_summaries", ()):
                s = JobSummary(wire.get("job_id", ""),
                               wire.get("namespace", "default"))
                s.__dict__.update(wire)
                st._t["job_summaries"][tuple(k)] = s
            for k, launch in t.get("periodic_launches", ()):
                st._t["periodic_launches"][tuple(k)] = launch
            from ..structs import CSIVolume
            for k, wire in t.get("csi_volumes", ()):
                st._t["csi_volumes"][tuple(k)] = from_wire(CSIVolume, wire)
            from ..acl import ACLPolicy, ACLToken
            for k, wire in t.get("acl_policies", ()):
                st._t["acl_policies"][k] = from_wire(ACLPolicy, wire)
            for k, wire in t.get("acl_tokens", ()):
                st._t["acl_tokens"][k] = from_wire(ACLToken, wire)
            for k, v in t.get("cluster_meta", ()):
                st._t["cluster_meta"][k] = v
            from ..structs.services import ServiceRegistration
            for k, wire in t.get("services", ()):
                st._t["services"][k] = from_wire(ServiceRegistration,
                                                 wire)
            for k, v in t.get("secrets", ()):
                st._t["secrets"][tuple(k)] = v
            for k, wire in t.get("scheduler_config", ()):
                cfg = SchedulerConfiguration()
                cfg.__dict__.update(wire)
                st._t["scheduler_config"][k] = cfg
            # rebuild derived indexes
            by_node: Dict[str, set] = {}
            by_job: Dict[tuple, set] = {}
            for a in st._t["allocs"].values():
                by_node.setdefault(a.node_id, set()).add(a.id)
                by_job.setdefault((a.namespace, a.job_id), set()).add(a.id)
            st._t["_allocs_by_node"] = by_node
            st._t["_allocs_by_job"] = by_job
            st._ix = dict(snap.get("table_indexes", {}))
            st.index = snap.get("latest_index", 0)
            st._watch.notify_all()

    @staticmethod
    def _key(table: str, k):
        return list(k) if table == "jobs" else k

    @staticmethod
    def _unkey(table: str, k):
        return tuple(k) if table == "jobs" else k
