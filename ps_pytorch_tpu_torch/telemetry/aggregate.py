"""Cross-process step telemetry over the control-plane KV: a copy of the
JAX package's ``telemetry/aggregate.py``.

Every process publishes its per-step record (true step time, data wait,
span phase summary) through the KV the Coordinator rides
(``runtime/coordinator.py``: ``KVStore`` in one process, ``DistributedKV``
over the group's TCPStore), and process 0 drains them into one merged
JSONL, a per-replica timeline: a straggler is a visible row.

Keys are the JAX package's: ``<run>/tel/<pid>/<step>`` is written before
the ``<run>/tel/<pid>/last`` pointer moves, and publishers delete their
own keys beyond ``window`` steps. Every read is a ``get`` of a named key
with a default: ``DistributedKV.get`` answers the default at once for a
missing key, also one deleted while it reads (``TCPStore.get`` would
block), so a missing step never hangs the leader, and nothing scans
(``DistributedKV.keys`` raises).
"""

import json
import os
import time
from typing import IO, List, Optional

SCHEMA_VERSION = 2


class TelemetryAggregator:
    """Per-process publisher + leader-side merger of step telemetry."""

    def __init__(self, kv, process_index: int, num_processes: int,
                 run_id: str = "run", window: int = 512):
        self.kv = kv
        self.pid = int(process_index)
        self.n = int(num_processes)
        self.run_id = run_id
        self.window = max(int(window), 2)
        # Leader-side drain cursors: last step already merged, per process.
        self._cursor = [0] * self.n
        self._fh: Optional[IO] = None
        self.rows_written = 0

    def _key(self, pid: int, step) -> str:
        return f"{self.run_id}/tel/{pid}/{step}"

    # ---- every process: publish ----
    def publish_step(self, step: int, record: dict) -> None:
        """Publish this process's record for ``step``; payload before
        pointer, then GC our own key beyond the window."""
        self.kv.set(self._key(self.pid, step), json.dumps(record))
        self.kv.set(self._key(self.pid, "last"), str(step))
        if step > self.window:
            self.kv.delete(self._key(self.pid, step - self.window))

    def last_published(self, pid: int) -> int:
        v = self.kv.get(self._key(pid, "last"), None)
        return int(v) if v is not None else 0

    def fetch(self, pid: int, step: int) -> Optional[dict]:
        v = self.kv.get(self._key(pid, step), None)
        return json.loads(v) if v is not None else None

    # ---- leader: merge ----
    def drain(self) -> List[dict]:
        """Newly-published rows from every process, in (step, process)
        order. A GC'd/lost step advances the cursor (a hole in the
        timeline, visible as a gap, must not wedge the merge)."""
        rows = []
        for pid in range(self.n):
            last = self.last_published(pid)
            for step in range(self._cursor[pid] + 1, last + 1):
                rec = self.fetch(pid, step)
                if rec is not None:
                    rows.append({"schema_version": SCHEMA_VERSION,
                                 "step": step, "process": pid, **rec})
            self._cursor[pid] = max(self._cursor[pid], last)
        rows.sort(key=lambda r: (r["step"], r["process"]))
        return rows

    def open_timeline(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, "w")

    def drain_to_file(self) -> int:
        if self._fh is None:
            return 0
        rows = self.drain()
        for r in rows:
            self._fh.write(json.dumps(r) + "\n")
        if rows:
            self._fh.flush()
            self.rows_written += len(rows)
        return len(rows)

    def close(self, final_step: Optional[int] = None,
              timeout_s: float = 10.0, poll_s: float = 0.05) -> None:
        """Final drain. With ``final_step``, wait (bounded) for every
        process to publish through it — followers lag the leader by the
        async-dispatch depth, and the artifact should not end mid-step."""
        if self._fh is None:
            return
        deadline = time.monotonic() + timeout_s
        while True:
            self.drain_to_file()
            if final_step is None or \
                    all(c >= final_step for c in self._cursor):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(poll_s)
        self._fh.close()
        self._fh = None


def read_timeline(path: str) -> List[dict]:
    """Merged-timeline JSONL -> rows (what the JAX package's
    ``tools/analyze.py timeline`` reads)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(r, dict) and "step" in r:
                rows.append(r)
    return rows
