"""Per-request lifecycle traces with tail-based sampling: the JAX
package's ``serving/reqtrace.py``.

Aggregate histograms say the p99 moved; they can't say WHY request
``a3f9…`` took 1.8 s. This module keeps a bounded ring of per-request
lifecycle records — submit → enqueue → admit → first token → per-step
decode ticks → terminal outcome — with the phase durations that partition
the request's latency exactly::

    queue_wait   t_submit → t_admit   (or → t_done for never-admitted)
    prefill      t_admit  → t_first   (admission prefill + first sample)
    decode       t_first  → t_last    (the batched tick loop)
    stream_out   t_last   → t_done    (resolve/wake the waiting caller)

so ``queue_wait + prefill + decode + stream_out == latency`` for every
outcome (pinned by tests). Capture is pure host-side observation — clock
reads and list appends, never device work and never the sampling key
chain — so token streams stay bit-identical to ``generate()`` with
tracing enabled.

**Tail-based sampling** (the ring is bounded; which requests deserve a
slot is decided at terminal time, when the latency is known): every
non-``done`` outcome is always admitted to the ring, as is any ``done``
request in the slowest ``slow_frac`` of a trailing latency window; the
fast majority is down-sampled by a deterministic hash of the request id
(``sample`` fraction), so replays keep identical rings.

Chrome export: each kept trace renders its phases as ``X`` spans in the
same ``time.monotonic`` microsecond domain as the engine's span tracer,
carrying ``corr="req/<rid>"`` — the engine stamps the same correlation id
on its ``serve_admit``/``serve_decode`` spans, and the JAX package's
``tools/analyze.py stitch`` joins them into request↔engine flow arrows.
"""

import threading
import time
import zlib
from collections import Counter, deque
from dataclasses import asdict, dataclass, field
from typing import Callable, List, Optional

TERMINAL_STATES = ("done", "shed", "rejected", "failed", "evicted")


def corr_id(rid: str) -> str:
    """The correlation-id namespace shared with the engine's spans."""
    return f"req/{rid}"


@dataclass
class RequestTrace:
    """One request's lifecycle, frozen at terminal time. Timestamps are
    engine-clock (``time.monotonic``) absolutes; 0.0 means the request
    never reached that point."""
    rid: str
    outcome: str
    error: str = ""
    prompt_len: int = 0
    n_new: int = 0
    n_tokens: int = 0
    model_step: Optional[int] = None
    t_submit: float = 0.0
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_last: float = 0.0
    t_done: float = 0.0
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    stream_out_s: float = 0.0
    latency_s: float = 0.0
    ticks: List[float] = field(default_factory=list)
    kept: str = ""            # why the ring kept it: outcome|slow|sampled

    def to_dict(self) -> dict:
        d = asdict(self)
        d["ticks"] = [round(t, 6) for t in self.ticks]
        return d


def trace_from_request(req, now: Optional[float] = None) -> RequestTrace:
    """Freeze a terminal ``engine.Request`` into a RequestTrace. ``now``
    backfills ``t_done`` for outcomes that never reached the engine's
    completion path (shed/rejected/failed)."""
    t_done = req.t_done or (now if now is not None else 0.0) or 0.0
    t_last = getattr(req, "t_last", 0.0) or req.t_first
    tr = RequestTrace(
        rid=req.rid, outcome=req.state, error=req.error,
        prompt_len=int(len(req.prompt)), n_new=int(req.n_new),
        n_tokens=len(req.tokens), model_step=req.model_step,
        t_submit=req.t_submit, t_enqueue=getattr(req, "t_enqueue", 0.0),
        t_admit=req.t_admit, t_first=req.t_first, t_last=t_last,
        t_done=t_done, ticks=list(getattr(req, "tick_t", ())))
    if tr.t_submit and t_done:
        tr.latency_s = max(0.0, t_done - tr.t_submit)
        if tr.t_admit:
            tr.queue_wait_s = max(0.0, tr.t_admit - tr.t_submit)
            if tr.t_first:
                tr.prefill_s = max(0.0, tr.t_first - tr.t_admit)
                tr.decode_s = max(0.0, t_last - tr.t_first)
                tr.stream_out_s = max(0.0, t_done - t_last)
            else:
                # admitted but resolved before a token (evicted/failed)
                tr.stream_out_s = max(0.0, t_done - tr.t_admit)
        else:
            # never admitted: the whole latency was queue wait
            tr.queue_wait_s = tr.latency_s
    return tr


def _hash_frac(rid: str) -> float:
    """Deterministic [0, 1) hash of the request id — the sampling coin."""
    return (zlib.crc32(rid.encode()) & 0xFFFFFFFF) / 2**32


class RequestTraceLog:
    """Bounded ring of :class:`RequestTrace` with tail-based admission.

    ``offer``/``offer_request`` are O(window) worst case (a sort over the
    trailing-latency deque only when deciding a ``done`` trace against the
    slow threshold) and touch no device state — cheap enough for the
    serving hot path. The ring itself evicts oldest-first once full, so
    retention of slow/non-done traces is "never sampled away", bounded by
    ``keep``.
    """

    def __init__(self, keep: int = 256, *, sample: float = 0.05,
                 slow_frac: float = 0.05, window: int = 512,
                 min_window: int = 20,
                 clock: Callable[[], float] = time.monotonic):
        if keep < 1:
            raise ValueError(f"keep={keep} (need >= 1)")
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample={sample} (need 0..1)")
        if not 0.0 < slow_frac <= 1.0:
            raise ValueError(f"slow_frac={slow_frac} (need (0, 1])")
        self.keep = int(keep)
        self.sample = float(sample)
        self.slow_frac = float(slow_frac)
        self.min_window = int(min_window)
        self.clock = clock
        self._ring: deque = deque(maxlen=self.keep)
        self._lat: deque = deque(maxlen=int(window))
        self._lock = threading.Lock()
        self.offered = 0
        self.dropped = 0
        self.by_outcome: Counter = Counter()

    # ---- admission decision ----
    def _keep_reason(self, tr: RequestTrace) -> str:
        if tr.outcome != "done":
            return "outcome"
        if len(self._lat) >= self.min_window:
            thr = sorted(self._lat)[
                max(0, int(len(self._lat) * (1.0 - self.slow_frac)) - 1)]
            if tr.latency_s >= thr:
                return "slow"
        if _hash_frac(tr.rid) < self.sample:
            return "sampled"
        return ""

    def offer(self, tr: RequestTrace) -> bool:
        """Admit-or-drop one terminal trace; returns whether it was kept."""
        with self._lock:
            self.offered += 1
            self.by_outcome[tr.outcome] += 1
            reason = self._keep_reason(tr)
            if tr.outcome == "done":
                self._lat.append(tr.latency_s)
            if not reason:
                self.dropped += 1
                return False
            tr.kept = reason
            self._ring.append(tr)
            return True

    def offer_request(self, req, now: Optional[float] = None) -> bool:
        """Freeze + offer a terminal ``engine.Request`` (the engine/queue
        call site)."""
        now = self.clock() if now is None else now
        return self.offer(trace_from_request(req, now))

    # ---- read side ----
    def traces(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> List[dict]:
        """Ring contents as dicts, oldest first (the /debug/requests body
        and the JSONL dump row shape)."""
        return [tr.to_dict() for tr in self.traces()]

    def stats(self) -> dict:
        with self._lock:
            return {"offered": self.offered, "kept": len(self._ring),
                    "dropped": self.dropped, "keep": self.keep,
                    "sample": self.sample, "slow_frac": self.slow_frac,
                    "by_outcome": dict(self.by_outcome)}

    def chrome_events(self, pid: int = 0) -> List[dict]:
        """Kept traces as Chrome ``X`` spans (µs, same monotonic domain as
        telemetry/trace.py) — one row (tid) per request, one span per
        nonzero phase, all carrying ``corr="req/<rid>"`` for stitch. Feed
        these to ``Tracer.write_chrome_trace(extra_events=...)``."""
        events = []
        phases = (("req_queue_wait", "t_submit", "queue_wait_s"),
                  ("req_prefill", "t_admit", "prefill_s"),
                  ("req_decode", "t_first", "decode_s"),
                  ("req_stream_out", "t_last", "stream_out_s"))
        for tr in self.traces():
            tid = 1 + (zlib.crc32(tr.rid.encode()) % 997)
            base = {"rid": tr.rid, "corr": corr_id(tr.rid),
                    "outcome": tr.outcome}
            if tr.t_submit and tr.latency_s >= 0:
                events.append({
                    "name": "request", "cat": "reqtrace", "ph": "X",
                    "ts": tr.t_submit * 1e6, "dur": tr.latency_s * 1e6,
                    "pid": pid, "tid": tid,
                    "args": {**base, "n_tokens": tr.n_tokens,
                             "kept": tr.kept}})
            for name, t_attr, dur_attr in phases:
                t0 = getattr(tr, t_attr)
                dur = getattr(tr, dur_attr)
                if t0 and dur > 0:
                    events.append({
                        "name": name, "cat": "reqtrace", "ph": "X",
                        "ts": t0 * 1e6, "dur": dur * 1e6,
                        "pid": pid, "tid": tid, "args": dict(base)})
        return events


def format_requests_table(rows: List[dict]) -> str:
    """The ``/debug/requests?text=1`` rendering: one aligned line per kept
    trace, phases in ms, newest last."""
    cols = ("rid", "outcome", "kept", "tok", "queue_ms", "prefill_ms",
            "decode_ms", "stream_ms", "latency_ms")
    table = [cols]
    for r in rows:
        table.append((
            r.get("rid", "?"), r.get("outcome", "?"), r.get("kept", ""),
            str(r.get("n_tokens", 0)),
            f"{r.get('queue_wait_s', 0.0) * 1e3:.1f}",
            f"{r.get('prefill_s', 0.0) * 1e3:.1f}",
            f"{r.get('decode_s', 0.0) * 1e3:.1f}",
            f"{r.get('stream_out_s', 0.0) * 1e3:.1f}",
            f"{r.get('latency_s', 0.0) * 1e3:.1f}"))
    widths = [max(len(row[i]) for row in table) for i in range(len(cols))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
             for row in table]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines) + "\n"


def record_terminal(req, *, reqtrace: Optional[RequestTraceLog] = None,
                    slo=None, now: Optional[float] = None) -> None:
    """The ONE call every terminal request funnels through (engine
    completion, queue reject/shed, drive-loop failure): freeze the
    lifecycle into the trace ring and feed the SLO tracker. Either sink
    may be absent."""
    if reqtrace is None and slo is None:
        return
    if reqtrace is not None:
        reqtrace.offer_request(req, now)
    if slo is not None:
        ttft = latency = qwait = None
        if req.state == "done" and req.t_submit and req.t_done:
            latency = max(0.0, req.t_done - req.t_submit)
            if req.t_first:
                ttft = max(0.0, req.t_first - req.t_submit)
            if req.t_admit:
                qwait = max(0.0, req.t_admit - req.t_submit)
        slo.observe_request(outcome=req.state, ttft_s=ttft,
                            latency_s=latency, queue_wait_s=qwait, now=now)
