"""Alloc filesystem introspection + host/alloc resource stats.

Reference: client/fs_endpoint.go (List/Stat/ReadAt/Stream over the
alloc dir, secrets dirs excluded), client/stats/host.go (host cpu/
memory/disk/uptime gauges), and the task-runner stats hooks
(client/allocrunner/taskrunner — per-task ResourceUsage from pids).

All functions are plain host-side reads; the HTTP layer routes them to
the owning agent (api/http_server.py `_client_route`).

The counterpart of `nomad_tpu.client.fs`.
"""
from __future__ import annotations

import os
import stat as statmod
import time
from typing import Dict, List, Optional

#: path components never served (reference: allocdir filters the
#: secrets dir out of every fs listing/read — fs_endpoint.go)
_DENIED_COMPONENTS = {"secrets"}


class FSError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code
        self.msg = msg


def resolve(root: str, rel: str) -> str:
    """Resolve a user path strictly inside `root` (symlink-safe), with
    the secrets dirs denied."""
    rel = (rel or "/").lstrip("/")
    for comp in rel.split("/"):
        if comp in _DENIED_COMPONENTS:
            raise FSError(403, "secrets directories are not accessible "
                               "through the fs API")
    p = os.path.realpath(os.path.join(root, rel))
    rootr = os.path.realpath(root)
    if p != rootr and not p.startswith(rootr + os.sep):
        raise FSError(403, "path escapes the allocation directory")
    # Re-check the *resolved* path's components: a symlink inside the
    # alloc dir may point at a secrets dir that the raw-path check above
    # never saw (reference: fs_endpoint.go checks the final joined path
    # against SecretsDir).
    if p != rootr:
        for comp in os.path.relpath(p, rootr).split(os.sep):
            if comp in _DENIED_COMPONENTS:
                raise FSError(403, "secrets directories are not accessible "
                                   "through the fs API")
    return p


def _entry(path: str, name: str) -> Dict:
    st = os.lstat(path)
    return {
        "name": name,
        "is_dir": statmod.S_ISDIR(st.st_mode),
        "size": st.st_size,
        "file_mode": statmod.filemode(st.st_mode),
        "mod_time": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                  time.gmtime(st.st_mtime)),
    }


def list_dir(root: str, rel: str) -> List[Dict]:
    p = resolve(root, rel)
    if not os.path.isdir(p):
        raise FSError(400, f"{rel!r} is not a directory")
    out = []
    for name in sorted(os.listdir(p)):
        if name in _DENIED_COMPONENTS:
            continue
        try:
            out.append(_entry(os.path.join(p, name), name))
        except OSError:
            continue
    return out


def stat_path(root: str, rel: str) -> Dict:
    p = resolve(root, rel)
    if not os.path.exists(p):
        raise FSError(404, f"no such file: {rel!r}")
    return _entry(p, os.path.basename(p.rstrip("/")) or "/")


def read_at(root: str, rel: str, offset: int = 0,
            limit: int = 1 << 20) -> bytes:
    p = resolve(root, rel)
    if os.path.isdir(p):
        raise FSError(400, f"{rel!r} is a directory")
    try:
        with open(p, "rb") as f:
            f.seek(max(0, offset))
            return f.read(max(0, min(limit, 1 << 24)))
    except FileNotFoundError:
        raise FSError(404, f"no such file: {rel!r}")


def stream_from(root: str, rel: str, offset: int,
                wait_s: float = 2.0, limit: int = 1 << 20) -> Dict:
    """Blocking tail: wait up to `wait_s` for the file to grow past
    `offset`, then return the new bytes and the next offset
    (reference: fs_endpoint.go Stream's follow frames, recast as a
    long-poll so it proxies as plain JSON)."""
    p = resolve(root, rel)
    deadline = time.monotonic() + max(0.0, min(wait_s, 30.0))
    while True:
        try:
            size = os.stat(p).st_size
        except FileNotFoundError:
            size = 0
        if size > offset or time.monotonic() >= deadline:
            break
        time.sleep(0.1)
    data = read_at(root, rel, offset, limit) if size > offset else b""
    return {"offset": offset + len(data), "data": data,
            "size": max(size, offset)}


# ----------------------------------------------------------- stats
def host_stats(data_dir: str) -> Dict:
    """Host gauges (reference: client/stats/host.go — cpu ticks,
    memory, uptime, and the data_dir disk)."""
    out: Dict = {"timestamp": time.time()}
    try:
        with open("/proc/meminfo") as f:
            mem = {}
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    mem[parts[0].rstrip(":")] = int(parts[1]) * 1024
        out["memory"] = {
            "total": mem.get("MemTotal", 0),
            "available": mem.get("MemAvailable", 0),
            "free": mem.get("MemFree", 0),
            "used": max(0, mem.get("MemTotal", 0)
                        - mem.get("MemAvailable", 0)),
        }
    except OSError:
        out["memory"] = {}
    try:
        with open("/proc/stat") as f:
            first = f.readline().split()
        ticks = [int(x) for x in first[1:8]]
        out["cpu"] = {
            "user_ticks": ticks[0], "system_ticks": ticks[2],
            "idle_ticks": ticks[3],
            "total_ticks": sum(ticks),
        }
    except (OSError, ValueError, IndexError):
        out["cpu"] = {}
    try:
        with open("/proc/uptime") as f:
            out["uptime_s"] = float(f.read().split()[0])
    except (OSError, ValueError):
        out["uptime_s"] = 0.0
    try:
        import shutil
        du = shutil.disk_usage(data_dir)
        out["disk"] = {"path": data_dir, "total": du.total,
                       "used": du.used, "free": du.free}
    except OSError:
        out["disk"] = {}
    return out


def _pid_stats(pid: int) -> Optional[Dict]:
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            raw = f.read().decode("ascii", "replace")
        rest = raw[raw.rfind(")") + 2:].split()
        utime, stime = int(rest[11]), int(rest[12])
        rss_pages = int(rest[21])
        return {"cpu_ticks": utime + stime,
                "rss_bytes": rss_pages * os.sysconf("SC_PAGE_SIZE")}
    except (OSError, ValueError, IndexError):
        return None


def _descendants(pid: int) -> List[int]:
    """pid plus its process subtree via /proc children files."""
    out, queue, seen = [], [pid], set()
    while queue:
        p = queue.pop()
        if p in seen:
            continue
        seen.add(p)
        out.append(p)
        try:
            for tid in os.listdir(f"/proc/{p}/task"):
                try:
                    with open(f"/proc/{p}/task/{tid}/children") as f:
                        queue.extend(int(c) for c in f.read().split())
                except (OSError, ValueError):
                    continue
        except OSError:
            continue
    return out


def task_stats(pid: int) -> Dict:
    """Aggregated ResourceUsage for a task's process subtree
    (reference: drivers/shared/executor pid_collector.go)."""
    cpu = rss = nprocs = 0
    for p in _descendants(pid):
        st = _pid_stats(p)
        if st is None:
            continue
        cpu += st["cpu_ticks"]
        rss += st["rss_bytes"]
        nprocs += 1
    return {"pid": pid, "num_procs": nprocs,
            "cpu_ticks": cpu, "rss_bytes": rss,
            "timestamp": time.time()}
