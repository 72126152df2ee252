"""Compiled ACLs (reference: acl/acl.go, acl/policy.go).

A token names policies; policies carry namespace rules (coarse policy
level and/or fine-grained capabilities), plus node/agent/operator
levels. `compile_acl` merges any number of policies into one ACL whose
checks the endpoints consult. Namespace rules support exact names and
a trailing-* glob (the reference uses full glob matching; prefix
globs cover its documented uses).  The counterpart of
`nomad_tpu.acl.acl`."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

POLICY_DENY = "deny"
POLICY_READ = "read"
POLICY_WRITE = "write"
_LEVEL = {POLICY_DENY: 0, "": 0, POLICY_READ: 1, POLICY_WRITE: 2}

# namespace capabilities (reference: acl/policy.go:47-76)
CAP_DENY = "deny"
CAP_LIST_JOBS = "list-jobs"
CAP_READ_JOB = "read-job"
CAP_SUBMIT_JOB = "submit-job"
CAP_DISPATCH_JOB = "dispatch-job"
CAP_READ_LOGS = "read-logs"
CAP_READ_FS = "read-fs"
CAP_ALLOC_EXEC = "alloc-exec"
CAP_ALLOC_LIFECYCLE = "alloc-lifecycle"
CAP_CSI_REGISTER_PLUGIN = "csi-register-plugin"
CAP_CSI_WRITE_VOLUME = "csi-write-volume"
CAP_CSI_READ_VOLUME = "csi-read-volume"
CAP_CSI_LIST_VOLUME = "csi-list-volume"
CAPABILITIES = (CAP_LIST_JOBS, CAP_READ_JOB, CAP_SUBMIT_JOB,
                CAP_DISPATCH_JOB, CAP_READ_LOGS, CAP_READ_FS,
                CAP_ALLOC_EXEC, CAP_ALLOC_LIFECYCLE,
                CAP_CSI_REGISTER_PLUGIN, CAP_CSI_WRITE_VOLUME,
                CAP_CSI_READ_VOLUME, CAP_CSI_LIST_VOLUME)

_READ_CAPS = {CAP_LIST_JOBS, CAP_READ_JOB, CAP_CSI_LIST_VOLUME,
              CAP_CSI_READ_VOLUME}
_WRITE_CAPS = _READ_CAPS | {
    CAP_SUBMIT_JOB, CAP_DISPATCH_JOB, CAP_READ_LOGS, CAP_READ_FS,
    CAP_ALLOC_EXEC, CAP_ALLOC_LIFECYCLE, CAP_CSI_WRITE_VOLUME}


@dataclass
class NamespaceRule:
    name: str = "default"            # exact, or trailing-* glob
    policy: str = ""                 # deny|read|write
    capabilities: List[str] = field(default_factory=list)

    def expanded_capabilities(self) -> set:
        caps = set(self.capabilities)
        if self.policy == POLICY_READ:
            caps |= _READ_CAPS
        elif self.policy == POLICY_WRITE:
            caps |= _WRITE_CAPS
        if self.policy == POLICY_DENY or CAP_DENY in caps:
            return {CAP_DENY}
        return caps


@dataclass
class ACLPolicy:
    name: str = ""
    description: str = ""
    namespaces: List[NamespaceRule] = field(default_factory=list)
    node: str = ""                   # deny|read|write
    agent: str = ""
    operator: str = ""
    create_index: int = 0
    modify_index: int = 0


@dataclass
class ACLToken:
    accessor_id: str = ""
    secret_id: str = ""
    name: str = ""
    type: str = "client"             # client | management
    policies: List[str] = field(default_factory=list)
    global_: bool = False
    create_index: int = 0
    modify_index: int = 0

    def is_management(self) -> bool:
        return self.type == "management"


class ACL:
    """Compiled capability matrix (reference: acl/acl.go ACL)."""

    def __init__(self, management: bool = False):
        self.management = management
        self._ns_caps: Dict[str, set] = {}       # rule name -> caps
        self.node = ""
        self.agent = ""
        self.operator = ""

    # -- namespaces --
    def _caps_for(self, namespace: str) -> set:
        """Longest-match rule wins (reference: acl.go
        AllowNamespaceOperation's glob resolution)."""
        best, best_len = set(), -1
        for pattern, caps in self._ns_caps.items():
            if pattern == namespace:
                return caps
            if pattern.endswith("*") \
                    and namespace.startswith(pattern[:-1]) \
                    and len(pattern) > best_len:
                best, best_len = caps, len(pattern)
        return best

    def allow_namespace_op(self, namespace: str, cap: str) -> bool:
        if self.management:
            return True
        caps = self._caps_for(namespace)
        return cap in caps and CAP_DENY not in caps

    def allow_namespace(self, namespace: str) -> bool:
        """Any access at all (reference: acl.go AllowNamespace)."""
        if self.management:
            return True
        caps = self._caps_for(namespace)
        return bool(caps) and CAP_DENY not in caps

    # -- coarse scopes --
    def allow_node_read(self) -> bool:
        return self.management or _LEVEL[self.node] >= 1

    def allow_node_write(self) -> bool:
        return self.management or _LEVEL[self.node] >= 2

    def allow_agent_read(self) -> bool:
        return self.management or _LEVEL[self.agent] >= 1

    def allow_agent_write(self) -> bool:
        return self.management or _LEVEL[self.agent] >= 2

    def allow_operator_read(self) -> bool:
        return self.management or _LEVEL[self.operator] >= 1

    def allow_operator_write(self) -> bool:
        return self.management or _LEVEL[self.operator] >= 2


def compile_acl(policies: Sequence[ACLPolicy]) -> ACL:
    """Merge policies; within one namespace rule name, capability sets
    union and an explicit deny dominates (acl.go NewACL)."""
    acl = ACL()
    for p in policies:
        for rule in p.namespaces:
            caps = rule.expanded_capabilities()
            cur = acl._ns_caps.setdefault(rule.name, set())
            if CAP_DENY in caps or CAP_DENY in cur:
                acl._ns_caps[rule.name] = {CAP_DENY}
            else:
                cur |= caps
        for scope in ("node", "agent", "operator"):
            lvl = getattr(p, scope)
            if _LEVEL[lvl] > _LEVEL[getattr(acl, scope)]:
                setattr(acl, scope, lvl)
    return acl


def management_acl() -> ACL:
    return ACL(management=True)
