"""ACL: tokens, policies, capability checks.

Reference: acl/acl.go (compiled ACL object + capability checks),
acl/policy.go (policy schema), nomad/acl.go (token resolution),
nomad/acl_endpoint.go (bootstrap/upsert verbs). Policies here are
JSON-shaped rather than HCL1 — the jobspec layer already made that
trade (SURVEY §5.6) — with the same namespace/node/agent/operator rule
classes, coarse policy levels and fine-grained capabilities.

The counterpart of `nomad_tpu.acl`: the FSM's ACL entries and the
server's token paths use it.
"""
from .acl import (CAPABILITIES, ACL, ACLPolicy, ACLToken, NamespaceRule,
                  compile_acl, management_acl)

__all__ = ["ACL", "ACLPolicy", "ACLToken", "CAPABILITIES",
           "NamespaceRule", "compile_acl", "management_acl"]
