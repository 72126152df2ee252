"""HCL jobspec -> structs.Job (reference: jobspec/parse.go:27 Parse,
parse_job.go, parse_group.go, parse_task.go — HCL1 with strict key
validation per block).

Durations accept Go syntax ("30s", "5m", "1h30m"); the mapped fields are
the *_s float fields of the structs.

The counterpart of `nomad_tpu.jobspec.parse`.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from ..structs import (Affinity, Artifact, Constraint, DispatchPayloadConfig,
                       EphemeralDisk, Job, LogConfig, MigrateStrategy,
                       NetworkResource, ParameterizedJobConfig,
                       PeriodicConfig, Port, RequestedDevice,
                       ReschedulePolicy, Resources, RestartPolicy, Service,
                       ServiceCheck, Spread, SpreadTarget, Task, TaskGroup,
                       Template, UpdateStrategy, VolumeMount, VolumeRequest)
from .hcl import Body, HCLParseError, parse_hcl


class JobspecParseError(ValueError):
    pass


_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h|d)")
_DUR_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
              "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_duration_s(v: Any) -> float:
    """Go-style duration string -> seconds ("1h30m", "15s", "500ms")."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    if not s:
        return 0.0
    total, pos = 0.0, 0
    for m in _DUR_RE.finditer(s):
        if m.start() != pos:
            raise JobspecParseError(f"bad duration {v!r}")
        total += float(m.group(1)) * _DUR_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise JobspecParseError(f"bad duration {v!r}")
    return total


def _check_keys(body: Body, allowed, where: str) -> None:
    """Strict key validation (reference: helper checkHCLKeys)."""
    extra = body.keys() - set(allowed)
    if extra:
        raise JobspecParseError(
            f"invalid key(s) in {where}: {', '.join(sorted(extra))}")


def _str_map(v: Any, where: str) -> Dict[str, str]:
    if v is None:
        return {}
    if not isinstance(v, dict):
        raise JobspecParseError(f"{where} must be a map")
    return {str(k): str(val) for k, val in v.items()}


# ---------------------------------------------------------------- shared
def _parse_constraints(body: Body) -> List[Constraint]:
    out = []
    for labels, b in body.blocks_named("constraint"):
        _check_keys(b, {"attribute", "operator", "value", "distinct_hosts",
                        "distinct_property", "regexp", "version", "semver",
                        "set_contains"}, "constraint")
        operand = str(b.attrs.get("operator", "="))
        lt = str(b.attrs.get("attribute", ""))
        rt = str(b.attrs.get("value", ""))
        for sugar in ("regexp", "version", "semver", "set_contains"):
            if sugar in b.attrs:
                operand, rt = sugar, str(b.attrs[sugar])
        if b.attrs.get("distinct_hosts"):
            operand = "distinct_hosts"
        if "distinct_property" in b.attrs:
            operand = "distinct_property"
            lt = str(b.attrs["distinct_property"])
        out.append(Constraint(ltarget=lt, rtarget=rt, operand=operand))
    return out


def _parse_affinities(body: Body) -> List[Affinity]:
    out = []
    for labels, b in body.blocks_named("affinity"):
        _check_keys(b, {"attribute", "operator", "value", "weight",
                        "regexp", "version", "semver", "set_contains",
                        "set_contains_any"}, "affinity")
        operand = str(b.attrs.get("operator", "="))
        rt = str(b.attrs.get("value", ""))
        for sugar in ("regexp", "version", "semver", "set_contains",
                      "set_contains_any"):
            if sugar in b.attrs:
                operand, rt = sugar, str(b.attrs[sugar])
        out.append(Affinity(ltarget=str(b.attrs.get("attribute", "")),
                            rtarget=rt, operand=operand,
                            weight=float(b.attrs.get("weight", 50))))
    return out


def _parse_spreads(body: Body) -> List[Spread]:
    out = []
    for labels, b in body.blocks_named("spread"):
        _check_keys(b, {"attribute", "weight", "target"}, "spread")
        targets = []
        for tlabels, tb in b.blocks_named("target"):
            _check_keys(tb, {"value", "percent"}, "spread target")
            targets.append(SpreadTarget(
                value=str(tb.attrs.get("value", tlabels[0] if tlabels
                                       else "")),
                percent=int(tb.attrs.get("percent", 0))))
        out.append(Spread(attribute=str(b.attrs.get("attribute", "")),
                          weight=float(b.attrs.get("weight", 50)),
                          spread_targets=targets))
    return out


def _parse_network(b: Body) -> NetworkResource:
    _check_keys(b, {"mbits", "port", "mode"}, "network")
    net = NetworkResource(mbits=int(b.attrs.get("mbits", 0)),
                          mode=str(b.attrs.get("mode", "host")))
    for labels, pb in b.blocks_named("port"):
        _check_keys(pb, {"static", "to", "host_network"}, "port")
        label = labels[0] if labels else ""
        port = Port(label=label, value=int(pb.attrs.get("static", 0)),
                    to=int(pb.attrs.get("to", 0)),
                    host_network=str(pb.attrs.get("host_network", "")))
        (net.reserved_ports if port.value else net.dynamic_ports).append(port)
    return net


def _parse_resources(b: Body) -> Resources:
    _check_keys(b, {"cpu", "memory", "disk", "iops", "network", "device"},
                "resources")
    res = Resources(cpu=int(b.attrs.get("cpu", 100)),
                    memory_mb=int(b.attrs.get("memory", 300)),
                    disk_mb=int(b.attrs.get("disk", 0)))
    for labels, nb in b.blocks_named("network"):
        res.networks.append(_parse_network(nb))
    for labels, db in b.blocks_named("device"):
        _check_keys(db, {"count", "constraint", "affinity"}, "device")
        res.devices.append(RequestedDevice(
            name=labels[0] if labels else "",
            count=int(db.attrs.get("count", 1)),
            constraints=_parse_constraints(db),
            affinities=_parse_affinities(db)))
    return res


def _parse_update(b: Body) -> UpdateStrategy:
    _check_keys(b, {"stagger", "max_parallel", "health_check",
                    "min_healthy_time", "healthy_deadline",
                    "progress_deadline", "auto_revert", "auto_promote",
                    "canary"}, "update")
    u = UpdateStrategy()
    if "stagger" in b.attrs:
        u.stagger_s = parse_duration_s(b.attrs["stagger"])
    u.max_parallel = int(b.attrs.get("max_parallel", u.max_parallel))
    u.health_check = str(b.attrs.get("health_check", u.health_check))
    if "min_healthy_time" in b.attrs:
        u.min_healthy_time_s = parse_duration_s(b.attrs["min_healthy_time"])
    if "healthy_deadline" in b.attrs:
        u.healthy_deadline_s = parse_duration_s(b.attrs["healthy_deadline"])
    if "progress_deadline" in b.attrs:
        u.progress_deadline_s = parse_duration_s(
            b.attrs["progress_deadline"])
    u.auto_revert = bool(b.attrs.get("auto_revert", False))
    u.auto_promote = bool(b.attrs.get("auto_promote", False))
    u.canary = int(b.attrs.get("canary", 0))
    return u


def _parse_service(b: Body) -> Service:
    _check_keys(b, {"name", "port", "tags", "canary_tags", "address_mode",
                    "check"}, "service")
    svc = Service(name=str(b.attrs.get("name", "")),
                  port_label=str(b.attrs.get("port", "")),
                  tags=[str(t) for t in b.attrs.get("tags", [])],
                  canary_tags=[str(t) for t in
                               b.attrs.get("canary_tags", [])],
                  address_mode=str(b.attrs.get("address_mode", "auto")))
    for labels, cb in b.blocks_named("check"):
        _check_keys(cb, {"name", "type", "path", "command", "args",
                         "interval", "timeout", "port"}, "check")
        svc.checks.append(ServiceCheck(
            name=str(cb.attrs.get("name", "")),
            type=str(cb.attrs.get("type", "")),
            path=str(cb.attrs.get("path", "")),
            command=str(cb.attrs.get("command", "")),
            args=[str(a) for a in cb.attrs.get("args", [])],
            interval_s=parse_duration_s(cb.attrs.get("interval", "10s")),
            timeout_s=parse_duration_s(cb.attrs.get("timeout", "2s")),
            port_label=str(cb.attrs.get("port", ""))))
    return svc


# ------------------------------------------------------------------ task
def _parse_task(name: str, b: Body) -> Task:
    _check_keys(b, {"driver", "user", "config", "env", "service",
                    "resources", "constraint", "affinity", "meta",
                    "kill_timeout", "kill_signal", "leader",
                    "shutdown_delay", "volume_mount", "template",
                    "artifact", "dispatch_payload", "logs", "lifecycle"},
                f"task {name!r}")
    task = Task(name=name, driver=str(b.attrs.get("driver", "")),
                user=str(b.attrs.get("user", "")),
                leader=bool(b.attrs.get("leader", False)),
                kill_signal=str(b.attrs.get("kill_signal", "")))
    if "kill_timeout" in b.attrs:
        task.kill_timeout_s = parse_duration_s(b.attrs["kill_timeout"])
    if "shutdown_delay" in b.attrs:
        task.shutdown_delay_s = parse_duration_s(b.attrs["shutdown_delay"])
    cfg = b.one_block("config")
    if cfg is not None:
        task.config = dict(cfg.attrs)
        for cname, _, cb in cfg.blocks:
            task.config.setdefault(cname, dict(cb.attrs))
    env = b.one_block("env")
    if env is not None:
        task.env = _str_map(env.attrs, "env")
    elif "env" in b.attrs:
        task.env = _str_map(b.attrs["env"], "env")
    meta = b.one_block("meta")
    if meta is not None:
        task.meta = _str_map(meta.attrs, "meta")
    res = b.one_block("resources")
    if res is not None:
        task.resources = _parse_resources(res)
    task.constraints = _parse_constraints(b)
    task.affinities = _parse_affinities(b)
    for _, sb in b.blocks_named("service"):
        task.services.append(_parse_service(sb))
    for _, vb in b.blocks_named("volume_mount"):
        _check_keys(vb, {"volume", "destination", "read_only"},
                    "volume_mount")
        task.volume_mounts.append(VolumeMount(
            volume=str(vb.attrs.get("volume", "")),
            destination=str(vb.attrs.get("destination", "")),
            read_only=bool(vb.attrs.get("read_only", False))))
    for _, tb in b.blocks_named("template"):
        _check_keys(tb, {"source", "destination", "data", "change_mode",
                         "change_signal"}, "template")
        task.templates.append(Template(
            source_path=str(tb.attrs.get("source", "")),
            dest_path=str(tb.attrs.get("destination", "")),
            embedded_tmpl=str(tb.attrs.get("data", "")),
            change_mode=str(tb.attrs.get("change_mode", "restart")),
            change_signal=str(tb.attrs.get("change_signal", ""))))
    for _, ab in b.blocks_named("artifact"):
        _check_keys(ab, {"source", "destination", "options"}, "artifact")
        opts = ab.one_block("options")
        task.artifacts.append(Artifact(
            getter_source=str(ab.attrs.get("source", "")),
            relative_dest=str(ab.attrs.get("destination", "")),
            getter_options=_str_map(opts.attrs if opts else
                                    ab.attrs.get("options"), "options")))
    dp = b.one_block("dispatch_payload")
    if dp is not None:
        _check_keys(dp, {"file"}, "dispatch_payload")
        task.dispatch_payload = DispatchPayloadConfig(
            file=str(dp.attrs.get("file", "")))
    logs = b.one_block("logs")
    if logs is not None:
        _check_keys(logs, {"max_files", "max_file_size"}, "logs")
        task.log_config = LogConfig(
            max_files=int(logs.attrs.get("max_files", 10)),
            max_file_size_mb=int(logs.attrs.get("max_file_size", 10)))
    return task


# ----------------------------------------------------------------- group
def _parse_group(name: str, b: Body) -> TaskGroup:
    _check_keys(b, {"count", "constraint", "affinity", "spread", "task",
                    "restart", "reschedule", "ephemeral_disk", "update",
                    "migrate", "network", "meta", "volume",
                    "stop_after_client_disconnect"}, f"group {name!r}")
    tg = TaskGroup(name=name, count=int(b.attrs.get("count", 1)))
    tg.constraints = _parse_constraints(b)
    tg.affinities = _parse_affinities(b)
    tg.spreads = _parse_spreads(b)
    meta = b.one_block("meta")
    if meta is not None:
        tg.meta = _str_map(meta.attrs, "meta")
    restart = b.one_block("restart")
    if restart is not None:
        _check_keys(restart, {"attempts", "interval", "delay", "mode"},
                    "restart")
        tg.restart_policy = RestartPolicy(
            attempts=int(restart.attrs.get("attempts", 2)),
            interval_s=parse_duration_s(
                restart.attrs.get("interval", "30m")),
            delay_s=parse_duration_s(restart.attrs.get("delay", "15s")),
            mode=str(restart.attrs.get("mode", "fail")))
    resched = b.one_block("reschedule")
    if resched is not None:
        _check_keys(resched, {"attempts", "interval", "delay",
                              "delay_function", "max_delay", "unlimited"},
                    "reschedule")
        tg.reschedule_policy = ReschedulePolicy(
            attempts=int(resched.attrs.get("attempts", 0)),
            interval_s=parse_duration_s(resched.attrs.get("interval", 0)),
            delay_s=parse_duration_s(resched.attrs.get("delay", "30s")),
            delay_function=str(resched.attrs.get("delay_function",
                                                 "exponential")),
            max_delay_s=parse_duration_s(resched.attrs.get("max_delay",
                                                           "1h")),
            unlimited=bool(resched.attrs.get("unlimited", False)))
    disk = b.one_block("ephemeral_disk")
    if disk is not None:
        _check_keys(disk, {"sticky", "size", "migrate"}, "ephemeral_disk")
        tg.ephemeral_disk = EphemeralDisk(
            sticky=bool(disk.attrs.get("sticky", False)),
            size_mb=int(disk.attrs.get("size", 300)),
            migrate=bool(disk.attrs.get("migrate", False)))
    upd = b.one_block("update")
    if upd is not None:
        tg.update = _parse_update(upd)
    mig = b.one_block("migrate")
    if mig is not None:
        _check_keys(mig, {"max_parallel", "health_check",
                          "min_healthy_time", "healthy_deadline"},
                    "migrate")
        tg.migrate = MigrateStrategy(
            max_parallel=int(mig.attrs.get("max_parallel", 1)),
            health_check=str(mig.attrs.get("health_check", "checks")),
            min_healthy_time_s=parse_duration_s(
                mig.attrs.get("min_healthy_time", "10s")),
            healthy_deadline_s=parse_duration_s(
                mig.attrs.get("healthy_deadline", "5m")))
    for labels, nb in b.blocks_named("network"):
        tg.networks.append(_parse_network(nb))
    for labels, vb in b.blocks_named("volume"):
        _check_keys(vb, {"type", "source", "read_only"}, "volume")
        vname = labels[0] if labels else ""
        tg.volumes[vname] = VolumeRequest(
            name=vname, type=str(vb.attrs.get("type", "host")),
            source=str(vb.attrs.get("source", "")),
            read_only=bool(vb.attrs.get("read_only", False)))
    if "stop_after_client_disconnect" in b.attrs:
        tg.stop_after_client_disconnect_s = parse_duration_s(
            b.attrs["stop_after_client_disconnect"])
    for labels, taskb in b.blocks_named("task"):
        if not labels:
            raise JobspecParseError(f"task in group {name!r} needs a name")
        tg.tasks.append(_parse_task(labels[0], taskb))
    return tg


# ------------------------------------------------------------------- job
def parse_job(text: str) -> Job:
    """Parse an HCL jobspec into a structs.Job
    (reference: jobspec.Parse, jobspec/parse.go:27)."""
    try:
        root = parse_hcl(text)
    except HCLParseError as e:
        raise JobspecParseError(str(e))
    jobs = root.blocks_named("job")
    if len(jobs) != 1:
        raise JobspecParseError("jobspec must contain exactly one "
                                f"'job' block, found {len(jobs)}")
    labels, b = jobs[0]
    if not labels:
        raise JobspecParseError("'job' block requires a name label")
    _check_keys(b, {"id", "name", "region", "namespace", "all_at_once",
                    "priority", "datacenters", "type", "constraint",
                    "affinity", "spread", "group", "task", "update",
                    "periodic", "parameterized", "meta", "vault_token"},
                "job")
    job = Job(id=str(b.attrs.get("id", labels[0])),
              name=str(b.attrs.get("name", labels[0])))
    job.region = str(b.attrs.get("region", "global"))
    job.namespace = str(b.attrs.get("namespace", "default"))
    job.type = str(b.attrs.get("type", "service"))
    job.priority = int(b.attrs.get("priority", 50))
    job.all_at_once = bool(b.attrs.get("all_at_once", False))
    job.datacenters = [str(d) for d in b.attrs.get("datacenters", ["dc1"])]
    job.vault_token = str(b.attrs.get("vault_token", ""))
    job.constraints = _parse_constraints(b)
    job.affinities = _parse_affinities(b)
    job.spreads = _parse_spreads(b)
    meta = b.one_block("meta")
    if meta is not None:
        job.meta = _str_map(meta.attrs, "meta")
    upd = b.one_block("update")
    if upd is not None:
        job.update = _parse_update(upd)
    per = b.one_block("periodic")
    if per is not None:
        _check_keys(per, {"cron", "prohibit_overlap", "time_zone",
                          "enabled"}, "periodic")
        job.periodic = PeriodicConfig(
            enabled=bool(per.attrs.get("enabled", True)),
            spec=str(per.attrs.get("cron", "")),
            prohibit_overlap=bool(per.attrs.get("prohibit_overlap", False)),
            timezone=str(per.attrs.get("time_zone", "UTC")))
    par = b.one_block("parameterized")
    if par is not None:
        _check_keys(par, {"payload", "meta_required", "meta_optional"},
                    "parameterized")
        job.parameterized = ParameterizedJobConfig(
            payload=str(par.attrs.get("payload", "optional")),
            meta_required=[str(m) for m in
                           par.attrs.get("meta_required", [])],
            meta_optional=[str(m) for m in
                           par.attrs.get("meta_optional", [])])
    for glabels, gb in b.blocks_named("group"):
        if not glabels:
            raise JobspecParseError("'group' block requires a name label")
        job.task_groups.append(_parse_group(glabels[0], gb))
    # a bare task at job level becomes a single-task group of the same
    # name (reference: jobspec/parse.go job-level task sugar)
    for tlabels, tb in b.blocks_named("task"):
        if not tlabels:
            raise JobspecParseError("'task' block requires a name label")
        task = _parse_task(tlabels[0], tb)
        job.task_groups.append(TaskGroup(name=task.name, count=1,
                                         tasks=[task]))
    job.canonicalize()
    errs = job.validate()
    if errs:
        raise JobspecParseError("; ".join(errs))
    return job


def parse_file(path: str) -> Job:
    with open(path) as f:
        return parse_job(f.read())
