"""Agent configuration files.

Reference: command/agent/config.go + config_parse.go — HCL/JSON agent
config files merged with CLI flags (flags win). The subset here covers
the stanzas the dev agent honors: top-level knobs, `server`, `client`,
`acl`, `tls` and `ports`.

    bind_addr = "0.0.0.0"
    data_dir  = "/var/lib/nomad-tpu"
    ports { http = 4646 }
    server {
      enabled          = true
      num_schedulers   = 2
      serving {                 # serving tier knobs
        slo_budget_s = 0.05
        max_batch    = 64
      }
    }
    client {
      enabled    = true
      datacenter = "dc1"
      meta { rack = "r1" }
    }
    acl { enabled = true }

The counterpart of `nomad_tpu.cli.config`: a reference config file
parses here unchanged.  `server.compile_cache_dir` is parsed and has no
effect (see `AgentConfig.compile_cache_dir`).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..jobspec.hcl import parse_hcl


@dataclass
class AgentConfig:
    bind_addr: str = "127.0.0.1"
    data_dir: str = "/tmp/nomad-tpu-dev"
    http_port: int = 4646
    server_enabled: bool = True
    num_schedulers: int = 2
    #: parsed so that a reference config file keeps parsing, and has no
    #: effect: the port has no compile cache to point at — its kernels
    #: are built once into a directory keyed on their source's hash
    compile_cache_dir: str = ""
    #: serving-tier overrides (server/serving.py ServingTier.KNOBS:
    #: slo_budget_s, max_batch, max_pending, bypass_priority, brownout
    #: thresholds, adaptive), handed to `Server(serving_config=)`;
    #: config wins over the environment and the defaults
    serving: Dict[str, object] = field(default_factory=dict)
    client_enabled: bool = True
    datacenter: str = "dc1"
    meta: Dict[str, str] = field(default_factory=dict)
    acl_enabled: bool = False
    log_level: str = "info"   # reference: config.Config.LogLevel
    # tls stanza (reference: config.TLSConfig — http/rpc toggles over
    # one CA + cert pair)
    tls_http: bool = False
    tls_rpc: bool = False
    tls_ca_file: str = ""
    tls_cert_file: str = ""
    tls_key_file: str = ""

    def tls_config(self):
        from ..utils.tlsutil import TLSConfig
        if not (self.tls_ca_file and self.tls_cert_file
                and self.tls_key_file):
            return None
        return TLSConfig(ca_file=self.tls_ca_file,
                         cert_file=self.tls_cert_file,
                         key_file=self.tls_key_file)


class AgentConfigError(ValueError):
    pass


def parse_agent_config(text: str, path: str = "<config>") -> AgentConfig:
    """HCL or JSON by content (config_parse.go sniffs the same way).
    Both formats lower to one nested dict before the merge, so every
    knob exists in exactly one place."""
    try:
        stripped = text.lstrip()
        if stripped.startswith("{"):
            d = json.loads(text)
        else:
            d = _hcl_to_dict(parse_hcl(text))
    except (ValueError, KeyError) as e:
        raise AgentConfigError(f"{path}: {e}") from e
    return _from_dict(d)


def _hcl_to_dict(body) -> dict:
    """Lower a parsed HCL Body (attrs + one level of named blocks, with
    the client.meta sub-block folded in) to the JSON config shape."""
    d = dict(body.attrs)
    for name in ("ports", "server", "client", "acl", "tls"):
        for _labels, blk in body.blocks_named(name):
            sub = d.setdefault(name, {})
            sub.update(blk.attrs)
            for _ml, meta in blk.blocks_named("meta"):
                sub.setdefault("meta", {}).update(meta.attrs)
            for _sl, srv in blk.blocks_named("serving"):
                sub.setdefault("serving", {}).update(srv.attrs)
    return d


def _from_dict(d: dict) -> AgentConfig:
    cfg = AgentConfig()
    cfg.bind_addr = d.get("bind_addr", cfg.bind_addr)
    cfg.data_dir = d.get("data_dir", cfg.data_dir)
    cfg.http_port = int((d.get("ports") or {}).get("http",
                                                   cfg.http_port))
    srv = d.get("server") or {}
    cfg.server_enabled = bool(srv.get("enabled", cfg.server_enabled))
    cfg.num_schedulers = int(srv.get("num_schedulers",
                                     cfg.num_schedulers))
    cfg.compile_cache_dir = srv.get("compile_cache_dir",
                                    cfg.compile_cache_dir)
    serving = srv.get("serving") or {}
    if not isinstance(serving, dict):
        raise AgentConfigError("server.serving must be a block/object")
    cfg.serving.update(serving)
    cl = d.get("client") or {}
    cfg.client_enabled = bool(cl.get("enabled", cfg.client_enabled))
    cfg.datacenter = cl.get("datacenter", cfg.datacenter)
    cfg.meta.update({k: str(v) for k, v in (cl.get("meta") or {}).items()})
    cfg.acl_enabled = bool((d.get("acl") or {}).get("enabled",
                                                    cfg.acl_enabled))
    cfg.log_level = str(d.get("log_level", cfg.log_level))
    tls = d.get("tls") or {}
    cfg.tls_http = bool(tls.get("http", cfg.tls_http))
    cfg.tls_rpc = bool(tls.get("rpc", cfg.tls_rpc))
    cfg.tls_ca_file = tls.get("ca_file", cfg.tls_ca_file)
    cfg.tls_cert_file = tls.get("cert_file", cfg.tls_cert_file)
    cfg.tls_key_file = tls.get("key_file", cfg.tls_key_file)
    return cfg


def load_agent_config(path: str) -> AgentConfig:
    with open(path, encoding="utf-8") as f:
        return parse_agent_config(f.read(), path)
