"""Durable typed entry log (reference: hashicorp/raft LogStore backed by
raft-boltdb in nomad/server.go:1293; entry shape raft.Log).

Entries are JSON lines `{"i": index, "t": term, "y": type, "p": payload}`
appended to a single file and truncated from the front at snapshot time
(FileSnapshotStore analog) or from the back on follower conflict.
`data_dir=None` keeps the log purely in memory (tests, throwaway
clusters) — same interface, no files.  The counterpart of
`nomad_tpu.raft.log`.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class LogEntry:
    index: int
    term: int
    etype: str
    payload: Any
    #: the entry's encoded size on the wire, measured once when a
    #: transport with a frame limit first ships it
    wire_bytes: Optional[int] = field(default=None, compare=False,
                                      repr=False)

    def encoded_bytes(self) -> int:
        """Bytes of the entry as one AppendEntries frame carries it (the
        `[index, term, type, payload]` array, compact JSON)."""
        if self.wire_bytes is None:
            self.wire_bytes = len(json.dumps(
                [self.index, self.term, self.etype, self.payload],
                separators=(",", ":")).encode())
        return self.wire_bytes


class RaftLog:
    def __init__(self, data_dir: Optional[str] = None,
                 fsync: bool = False):
        self._lock = threading.Lock()
        self.entries: List[LogEntry] = []
        self.offset = 0               # index of entries[0] - 1
        self._dir = data_dir
        self._fsync = fsync
        self._fh = None
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._path = os.path.join(data_dir, "raft.log")
            self._load()
            self._fh = open(self._path, "a", encoding="utf-8")

    # ------------------------------------------------------------ reads
    def last_index(self) -> int:
        with self._lock:
            return self.offset + len(self.entries)

    def term_at(self, index: int) -> int:
        with self._lock:
            if index <= self.offset or index > self.offset + len(self.entries):
                return 0
            return self.entries[index - self.offset - 1].term

    def get(self, index: int) -> Optional[LogEntry]:
        with self._lock:
            i = index - self.offset - 1
            if 0 <= i < len(self.entries):
                return self.entries[i]
            return None

    def slice_from(self, index: int, limit: int = 512) -> List[LogEntry]:
        with self._lock:
            i = max(index - self.offset - 1, 0)
            return self.entries[i:i + limit]

    # ----------------------------------------------------------- writes
    def append(self, entries: List[LogEntry]) -> None:
        with self._lock:
            self.entries.extend(entries)
            if self._fh:
                for e in entries:
                    self._fh.write(json.dumps(
                        {"i": e.index, "t": e.term, "y": e.etype,
                         "p": e.payload}, separators=(",", ":")) + "\n")
                self._fh.flush()
                if self._fsync:
                    os.fsync(self._fh.fileno())

    def truncate_from(self, index: int) -> None:
        """Drop index and everything after it (follower conflict)."""
        with self._lock:
            keep = max(index - self.offset - 1, 0)
            if keep >= len(self.entries):
                return
            del self.entries[keep:]
            self._rewrite_locked()

    def compact_to(self, index: int) -> None:
        """Drop everything up to and including `index` (it is captured in
        a snapshot)."""
        with self._lock:
            drop = index - self.offset
            if drop <= 0:
                return
            del self.entries[:drop]
            self.offset = index
            self._rewrite_locked()

    # ------------------------------------------------------------- disk
    def _rewrite_locked(self) -> None:
        # caller holds self._lock (truncate_from / compact_to)
        if not self._dir:
            return
        if self._fh:
            self._fh.close()
        tmp = self._path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps({"__offset__": self.offset}) + "\n")
            for e in self.entries:
                f.write(json.dumps({"i": e.index, "t": e.term,
                                    "y": e.etype, "p": e.payload},
                                   separators=(",", ":")) + "\n")
        os.replace(tmp, self._path)
        self._fh = open(self._path, "a", encoding="utf-8")

    def _load(self) -> None:
        if not os.path.exists(self._path):
            return
        # ctor-time only, but the lock is uncontended there and makes
        # the write discipline uniform
        with self._lock, open(self._path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    break              # torn tail write: stop at the tear
                if "__offset__" in rec:
                    self.offset = rec["__offset__"]
                    self.entries.clear()
                    continue
                self.entries.append(LogEntry(rec["i"], rec["t"], rec["y"],
                                             rec["p"]))

    def close(self) -> None:
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None
