#!/usr/bin/env python
"""Log -> scaling/speedup analysis: the JAX package's ``tools/analyze.py``
(its subcommands, tables and JSON) on the port's own readers. It reads the
STEP lines, metrics JSONL, span files, flight recordings and request traces
of either package: the two write the same formats.

Replaces the reference's offline notebooks (``analysis/Speedup_Comparisons_
LeNet.ipynb``, ``analysis/Speedups_with_GradCompression.ipynb``), which
regex-parse per-worker stdout logs into per-step times and report two curves
per cluster size (SURVEY §6): "normal" speedup (slowest worker's step time —
what the synchronous system actually achieves) and "ideal" speedup (fastest
worker — what it could achieve with perfect straggler mitigation).

Input: one or more runs, each a set of STEP-line logs or metrics JSONL files
(multiple files per run = one per host). Per step, the max step_time across
files is the "normal" time and the min is the "ideal" time — exactly the
notebooks' max/min-per-step computation. Speedups are reported against the
run labeled as baseline (default: the smallest device count).

    python -m ps_pytorch_tpu_torch.tools.analyze 1=logs/n1.jsonl \\
        8=logs/n8_host*.log

Timeline mode reads the telemetry the trainers now emit — per-step phase
span summaries (``phases`` in metrics JSONL) or the leader-merged
per-replica timeline (telemetry/aggregate.py) — and prints where the step
time actually goes, per phase; ``--json`` additionally emits the
(step, process, step_time) grid that a straggler heatmap plots directly:

    python -m ps_pytorch_tpu_torch.tools.analyze timeline /tmp/m.jsonl
    python -m ps_pytorch_tpu_torch.tools.analyze timeline \\
        run.jsonl.timeline --json

Faults mode summarizes a resilience run: the trainers merge the fault/
retry/liveness counters (telemetry/registry.RESILIENCE_COUNTERS) into the
step records whenever a resilience plane is active; this mode folds them
back into one table (counters are cumulative — the max across records is
the run total) plus the steps covered and final mask changes:

    python -m ps_pytorch_tpu_torch.tools.analyze faults /tmp/m.jsonl
    python -m ps_pytorch_tpu_torch.tools.analyze faults chaos.jsonl --json

Wire mode reads a span timeline (the Tracer's span-dict JSONL or an
exported Chrome trace) and breaks the overlapped gradient wire down:
per-stage totals (wire_publish/encode/put/read/decode), per-bucket
encode/put/decode seconds + bytes, and the publish/read overlap fractions
(1 - wall/serial; see wire_summary):

    python -m ps_pytorch_tpu_torch.tools.analyze wire /tmp/wire_spans.jsonl
    python -m ps_pytorch_tpu_torch.tools.analyze wire trace.json --json

Codec mode reads the same span timelines and reports the grad-codec byte
accounting the wire now stamps on every encode: per-bucket raw (pre-codec)
vs armoured (on-wire) bytes, the per-bucket and total compression ratios,
and publish-level totals — how much of the wire cut each bucket earns:

    python -m ps_pytorch_tpu_torch.tools.analyze codec /tmp/wire_spans.jsonl
    python -m ps_pytorch_tpu_torch.tools.analyze codec trace.json --json

Zero mode reads the same span timelines from a --shard-wire run
(parallel/zero_wire.py stamps zw_publish/zw_update/zw_put/zw_assemble/
zw_get) and breaks the sharded weight update down: per-shard update/put/
get seconds + bytes and the publish/assemble overlap fractions — how much
of the per-shard KV wait the worker pool actually hid:

    python -m ps_pytorch_tpu_torch.tools.analyze zero /tmp/zw_spans.jsonl
    python -m ps_pytorch_tpu_torch.tools.analyze zero trace.json --json

Flight mode renders a flight-recorder crash dump (telemetry/flightrec.py)
as a post-mortem: health events, recent steps/spans/events, and the final
metric snapshot. Stitch mode merges per-process Chrome traces into one and
adds flow events joining each worker's wire_publish to the leader's
wire_read via the correlation id transport.py stamps on both legs:

    python -m ps_pytorch_tpu_torch.tools.analyze flight \\
        ./train_dir/flightrec.json
    python -m ps_pytorch_tpu_torch.tools.analyze stitch 'trace.json*' \\
        --out all.json

Membership mode reads the same flight dumps from an elastic run
(``--elastic``) and renders the control-plane history as one epoch
timeline — elections won/lost, joins/leaves/evictions, shard replans —
merged chronologically across every process's dump:

    python -m ps_pytorch_tpu_torch.tools.analyze membership \\
        'run/flightrec.json*'

Requests mode reads request-lifecycle traces (the /debug/requests JSON
body or a JSONL dump of serving/reqtrace.py rows) and prints a per-phase
waterfall — mean/p50/max of queue_wait/prefill/decode/stream_out and each
phase's share of total latency — plus the slowest-request exemplars.
Stitch also joins request spans to the engine's serve_admit/serve_decode
spans (corr ``req/<rid>``; decode ticks fan out via ``args.rids``):

    python -m ps_pytorch_tpu_torch.tools.analyze requests /tmp/requests.json
    python -m ps_pytorch_tpu_torch.tools.analyze requests 'reqs*.jsonl' --json
"""

import argparse
import glob
import json
import statistics
import sys
from typing import Dict, List

from ps_pytorch_tpu_torch.runtime.metrics import parse_line


def read_records(path: str) -> List[dict]:
    """STEP-schema log or metrics JSONL -> list of step records."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "step" in rec and "step_time" in rec:
                    records.append(rec)
                continue
            rec = parse_line(line)
            if rec:
                records.append(rec)
    return records


def per_step_times(paths: List[str], skip_first: int = 1) -> Dict[str, float]:
    """-> {"normal": mean slowest-host step time, "ideal": mean fastest,
    "steps": N}. skip_first drops compile-dominated steps."""
    by_step: Dict[int, List[float]] = {}
    for path in paths:
        for rec in read_records(path):
            by_step.setdefault(rec["step"], []).append(rec["step_time"])
    steps = sorted(by_step)[skip_first:]
    if not steps:
        raise ValueError(f"no step records found in {paths}")
    normal = statistics.fmean(max(by_step[s]) for s in steps)
    ideal = statistics.fmean(min(by_step[s]) for s in steps)
    return {"normal": normal, "ideal": ideal, "steps": len(steps)}


def analyze(runs: Dict[str, List[str]], baseline: str = "",
            skip_first: int = 1) -> List[dict]:
    """runs: label -> list of files. Labels sort numerically when possible."""
    def key(label: str):
        try:
            return (0, float(label))
        except ValueError:
            return (1, label)

    labels = sorted(runs, key=key)
    stats = {l: per_step_times(runs[l], skip_first) for l in labels}
    base = baseline or labels[0]
    b = stats[base]
    rows = []
    for l in labels:
        s = stats[l]
        rows.append({
            "run": l, "steps": s["steps"],
            "step_time_normal_s": round(s["normal"], 5),
            "step_time_ideal_s": round(s["ideal"], 5),
            "speedup_normal": round(b["normal"] / s["normal"], 3),
            "speedup_ideal": round(b["ideal"] / s["ideal"], 3),
        })
    return rows


def to_markdown(rows: List[dict]) -> str:
    """BASELINE.md-compatible table."""
    head = ("| run | steps | step time (normal) | step time (ideal) | "
            "speedup (normal) | speedup (ideal) |")
    sep = "|---|---|---|---|---|---|"
    body = [
        f"| {r['run']} | {r['steps']} | {r['step_time_normal_s']:.5f} s "
        f"| {r['step_time_ideal_s']:.5f} s | {r['speedup_normal']:.2f}x "
        f"| {r['speedup_ideal']:.2f}x |"
        for r in rows]
    return "\n".join([head, sep] + body)


# ---- timeline mode (per-phase breakdown + straggler heatmap input) ----

def phase_breakdown(rows: List[dict], skip_first: int = 1) -> List[dict]:
    """Step records carrying ``phases`` -> one row per phase:
    mean/max/total seconds and the share of the mean step time. Phases are
    the trainers' span names (data_wait, host_dispatch, device_sync,
    metrics_sync, checkpoint, coordinator_mask, wire_*...); 'other' is the
    un-spanned remainder of the step."""
    steps = sorted({r["step"] for r in rows})[skip_first:]
    keep = [r for r in rows if r["step"] in set(steps)]
    if not keep:
        raise ValueError("no step records with phase data")
    per_phase: Dict[str, List[float]] = {}
    step_times = []
    for r in keep:
        st = float(r.get("step_time") or 0.0)
        step_times.append(st)
        spanned = 0.0
        for name, dur in (r.get("phases") or {}).items():
            per_phase.setdefault(name, []).append(float(dur))
            spanned += float(dur)
        if st > spanned >= 0:
            per_phase.setdefault("other", []).append(st - spanned)
    mean_step = statistics.fmean(step_times) if step_times else 0.0
    out = []
    for name in sorted(per_phase, key=lambda n: -sum(per_phase[n])):
        vals = per_phase[name]
        mean = statistics.fmean(vals)
        out.append({
            "phase": name, "count": len(vals),
            "mean_s": round(mean, 6), "max_s": round(max(vals), 6),
            "total_s": round(sum(vals), 6),
            "frac_of_step": round(mean / mean_step, 4) if mean_step > 0 else 0.0,
        })
    return out


def straggler_grid(rows: List[dict]) -> List[dict]:
    """(step, process, step_time) triples — the heatmap input. Metrics
    JSONL has no process column (one file per host); the merged timeline
    does."""
    return [{"step": r["step"], "process": int(r.get("process", 0)),
             "step_time": float(r.get("step_time") or 0.0)}
            for r in sorted(rows, key=lambda r: (r["step"],
                                                 r.get("process", 0)))]


def timeline_markdown(breakdown: List[dict]) -> str:
    head = "| phase | count | mean | max | total | % of step |"
    sep = "|---|---|---|---|---|---|"
    body = [
        f"| {r['phase']} | {r['count']} | {r['mean_s']:.6f} s "
        f"| {r['max_s']:.6f} s | {r['total_s']:.6f} s "
        f"| {100 * r['frac_of_step']:.1f}% |"
        for r in breakdown]
    return "\n".join([head, sep] + body)


def timeline_main(args, parser) -> int:
    files: List[str] = []
    for pattern in args.runs:
        files.extend(sorted(glob.glob(pattern)) or
                     parser.error(f"no files match {pattern!r}") or [])
    rows = [r for path in files for r in read_records(path)]
    if not rows:
        parser.error(f"no step records in {files}")
    breakdown = phase_breakdown(rows, skip_first=args.skip_first)
    if args.json:
        print(json.dumps({"phases": breakdown,
                          "heatmap": straggler_grid(rows)}))
    else:
        print(timeline_markdown(breakdown))
    return 0


# ---- wire mode (overlapped-wire span breakdown) ----

def read_span_events(path: str) -> List[dict]:
    """Span-timeline file -> [{"name", "t0", "dur", "args"}] (seconds).

    Accepts either the Tracer's span-dict JSONL (telemetry/trace.py
    ``spans()``, one dict per line with t0/dur in seconds) or an exported
    Chrome trace JSON (``write_chrome_trace``, 'X' events with ts/dur in
    microseconds)."""
    with open(path) as f:
        text = f.read().strip()
    events: List[dict] = []
    doc = None
    try:
        doc = json.loads(text)
    except ValueError:
        pass
    if isinstance(doc, dict) and "traceEvents" in doc:
        for e in doc["traceEvents"]:
            if e.get("ph") == "X":
                events.append({"name": e["name"], "t0": e["ts"] / 1e6,
                               "dur": e["dur"] / 1e6,
                               "args": e.get("args", {})})
        return events
    for line in text.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "name" in rec and "dur" in rec:
            events.append({"name": rec["name"], "t0": float(rec.get("t0", 0)),
                           "dur": float(rec["dur"]),
                           "args": rec.get("args", {})})
    return events


def wire_summary(events: List[dict]) -> dict:
    """wire_* spans -> per-stage totals, per-bucket breakdown, and overlap
    fractions.

    overlap fraction = 1 - wall / serial, where serial is the summed time
    of the pipelined sub-stages (encode+put under a wire_publish; decode
    under a wire_read) and wall is the enclosing span's duration: 0 means
    the schedule ran fully serial, ->1 means the sub-stage work was almost
    entirely hidden by pipelining. The blocking wire has no sub-spans, so
    its fractions read as null."""
    stages: Dict[str, dict] = {}
    per_bucket: Dict[int, dict] = {}
    for e in events:
        name = e["name"]
        if not name.startswith("wire_"):
            continue
        st = stages.setdefault(name, {"count": 0, "total_s": 0.0, "bytes": 0})
        st["count"] += 1
        st["total_s"] += e["dur"]
        args = e.get("args") or {}
        if "bytes" in args:
            st["bytes"] += int(args["bytes"])
        if "bucket" in args and name in ("wire_encode", "wire_put",
                                         "wire_decode"):
            b = per_bucket.setdefault(int(args["bucket"]),
                                      {"bucket": int(args["bucket"]),
                                       "encode_s": 0.0, "put_s": 0.0,
                                       "decode_s": 0.0, "bytes": 0})
            b[name[len("wire_"):] + "_s"] += e["dur"]
            if "bytes" in args:
                b["bytes"] += int(args["bytes"])
    for st in stages.values():
        st["total_s"] = round(st["total_s"], 6)

    def frac(wall: float, serial: float):
        if wall <= 0 or serial <= 0:
            return None
        return round(max(0.0, 1.0 - wall / serial), 4)

    pub_wall = stages.get("wire_publish", {}).get("total_s", 0.0)
    pub_serial = (stages.get("wire_encode", {}).get("total_s", 0.0)
                  + stages.get("wire_put", {}).get("total_s", 0.0))
    read_wall = stages.get("wire_read", {}).get("total_s", 0.0)
    read_serial = stages.get("wire_decode", {}).get("total_s", 0.0)
    return {"stages": {k: stages[k] for k in sorted(stages)},
            "buckets": [dict(per_bucket[k],
                             encode_s=round(per_bucket[k]["encode_s"], 6),
                             put_s=round(per_bucket[k]["put_s"], 6),
                             decode_s=round(per_bucket[k]["decode_s"], 6))
                        for k in sorted(per_bucket)],
            "publish_overlap_fraction": frac(pub_wall, pub_serial),
            "read_overlap_fraction": frac(read_wall, read_serial)}


def wire_markdown(summary: dict) -> str:
    lines = ["| stage | count | total | bytes |", "|---|---|---|---|"]
    for name, st in summary["stages"].items():
        lines.append(f"| {name} | {st['count']} | {st['total_s']:.6f} s "
                     f"| {st['bytes']} |")
    if summary["buckets"]:
        lines += ["", "| bucket | encode | put | decode | bytes |",
                  "|---|---|---|---|---|"]
        for b in summary["buckets"]:
            lines.append(f"| {b['bucket']} | {b['encode_s']:.6f} s "
                         f"| {b['put_s']:.6f} s | {b['decode_s']:.6f} s "
                         f"| {b['bytes']} |")
    for side in ("publish", "read"):
        v = summary[f"{side}_overlap_fraction"]
        lines.append(f"\n{side} overlap fraction: "
                     + ("n/a (no pipelined sub-spans)" if v is None
                        else f"{v:.4f}"))
    return "\n".join(lines)


def codec_summary(events: List[dict]) -> dict:
    """wire_encode/wire_publish spans -> per-bucket compressed-vs-raw byte
    accounting. Transport stamps every wire_encode span with ``bytes``
    (armoured, post-codec) and ``bytes_raw`` (pre-codec float payload), so
    a publish trace is enough to see where the wire's compression ratio
    comes from — which buckets carry dense int8 lattices vs sparse index
    payloads vs incompressible float residue."""
    per_bucket: Dict[int, dict] = {}
    publish = {"count": 0, "bytes": 0, "bytes_raw": 0}
    for e in events:
        args = e.get("args") or {}
        if e["name"] == "wire_publish":
            publish["count"] += 1
            publish["bytes"] += int(args.get("bytes", 0))
            publish["bytes_raw"] += int(args.get("bytes_raw", 0))
            continue
        if e["name"] != "wire_encode" or "bucket" not in args:
            continue
        b = per_bucket.setdefault(int(args["bucket"]),
                                  {"bucket": int(args["bucket"]),
                                   "encode_s": 0.0, "bytes": 0,
                                   "bytes_raw": 0})
        b["encode_s"] += e["dur"]
        b["bytes"] += int(args.get("bytes", 0))
        b["bytes_raw"] += int(args.get("bytes_raw", 0))

    def ratio(raw: int, comp: int):
        return round(raw / comp, 3) if comp > 0 and raw > 0 else None

    buckets = [dict(per_bucket[k], encode_s=round(per_bucket[k]["encode_s"],
                                                  6),
                    ratio=ratio(per_bucket[k]["bytes_raw"],
                                per_bucket[k]["bytes"]))
               for k in sorted(per_bucket)]
    tot_c = sum(b["bytes"] for b in buckets) or publish["bytes"]
    tot_r = sum(b["bytes_raw"] for b in buckets) or publish["bytes_raw"]
    return {"buckets": buckets, "publish": publish,
            "total_bytes": tot_c, "total_bytes_raw": tot_r,
            "total_ratio": ratio(tot_r, tot_c)}


def codec_markdown(summary: dict) -> str:
    lines = ["| bucket | encode | raw bytes | wire bytes | ratio |",
             "|---|---|---|---|---|"]
    for b in summary["buckets"]:
        r = "n/a" if b["ratio"] is None else f"{b['ratio']:.3f}x"
        lines.append(f"| {b['bucket']} | {b['encode_s']:.6f} s "
                     f"| {b['bytes_raw']} | {b['bytes']} | {r} |")
    r = summary["total_ratio"]
    lines.append(f"\ntotal: {summary['total_bytes_raw']} raw -> "
                 f"{summary['total_bytes']} on wire"
                 + ("" if r is None else f" ({r:.3f}x)"))
    return "\n".join(lines)


def codec_main(args, parser) -> int:
    files: List[str] = []
    for pattern in args.runs:
        files.extend(sorted(glob.glob(pattern)) or
                     parser.error(f"no files match {pattern!r}") or [])
    events = [e for path in files for e in read_span_events(path)]
    if not any(e["name"] in ("wire_encode", "wire_publish")
               for e in events):
        parser.error(f"no wire_encode/wire_publish spans in {files}")
    summary = codec_summary(events)
    if args.json:
        print(json.dumps(summary))
    else:
        print(codec_markdown(summary))
    return 0


def wire_main(args, parser) -> int:
    files: List[str] = []
    for pattern in args.runs:
        files.extend(sorted(glob.glob(pattern)) or
                     parser.error(f"no files match {pattern!r}") or [])
    events = [e for path in files for e in read_span_events(path)]
    if not any(e["name"].startswith("wire_") for e in events):
        parser.error(f"no wire_* spans in {files}")
    summary = wire_summary(events)
    if args.json:
        print(json.dumps(summary))
    else:
        print(wire_markdown(summary))
    return 0


# ---- zero mode (ZeRO-over-the-wire span timeline) ----

def zero_summary(events: List[dict]) -> dict:
    """zw_* spans (parallel/zero_wire.py) -> per-shard publish/read byte
    accounting and overlap fractions.

    publish overlap = 1 - zw_publish wall / (zw_update + zw_put serial):
    the per-shard KV puts ride the worker pool while the next shard's
    host update runs, so ->1 means the wire wait was hidden behind
    compute. assemble overlap is the same over zw_assemble vs its
    zw_get legs (foreign shards fetched pool-parallel)."""
    stages: Dict[str, dict] = {}
    per_shard: Dict[int, dict] = {}
    for e in events:
        name = e["name"]
        if not name.startswith("zw_"):
            continue
        st = stages.setdefault(name, {"count": 0, "total_s": 0.0, "bytes": 0})
        st["count"] += 1
        st["total_s"] += e["dur"]
        args = e.get("args") or {}
        if "bytes" in args:
            st["bytes"] += int(args["bytes"])
        if "shard" in args and name in ("zw_put", "zw_get", "zw_update"):
            s = per_shard.setdefault(int(args["shard"]),
                                     {"shard": int(args["shard"]),
                                      "update_s": 0.0, "put_s": 0.0,
                                      "get_s": 0.0, "put_bytes": 0,
                                      "get_bytes": 0})
            s[name[len("zw_"):] + "_s"] += e["dur"]
            if "bytes" in args:
                s[f"{name[len('zw_'):]}_bytes"] += int(args["bytes"])
    for st in stages.values():
        st["total_s"] = round(st["total_s"], 6)

    def frac(wall: float, serial: float):
        if wall <= 0 or serial <= 0:
            return None
        return round(max(0.0, 1.0 - wall / serial), 4)

    pub_wall = stages.get("zw_publish", {}).get("total_s", 0.0)
    pub_serial = (stages.get("zw_update", {}).get("total_s", 0.0)
                  + stages.get("zw_put", {}).get("total_s", 0.0))
    asm_wall = stages.get("zw_assemble", {}).get("total_s", 0.0)
    asm_serial = stages.get("zw_get", {}).get("total_s", 0.0)
    return {"stages": {k: stages[k] for k in sorted(stages)},
            "shards": [dict(per_shard[k],
                            update_s=round(per_shard[k]["update_s"], 6),
                            put_s=round(per_shard[k]["put_s"], 6),
                            get_s=round(per_shard[k]["get_s"], 6))
                       for k in sorted(per_shard)],
            "publish_overlap_fraction": frac(pub_wall, pub_serial),
            "assemble_overlap_fraction": frac(asm_wall, asm_serial)}


def zero_markdown(summary: dict) -> str:
    lines = ["| stage | count | total | bytes |", "|---|---|---|---|"]
    for name, st in summary["stages"].items():
        lines.append(f"| {name} | {st['count']} | {st['total_s']:.6f} s "
                     f"| {st['bytes']} |")
    if summary["shards"]:
        lines += ["", "| shard | update | put | get | put bytes | get bytes |",
                  "|---|---|---|---|---|---|"]
        for s in summary["shards"]:
            lines.append(f"| {s['shard']} | {s['update_s']:.6f} s "
                         f"| {s['put_s']:.6f} s | {s['get_s']:.6f} s "
                         f"| {s['put_bytes']} | {s['get_bytes']} |")
    for side in ("publish", "assemble"):
        v = summary[f"{side}_overlap_fraction"]
        lines.append(f"\n{side} overlap fraction: "
                     + ("n/a (no pipelined sub-spans)" if v is None
                        else f"{v:.4f}"))
    return "\n".join(lines)


def zero_main(args, parser) -> int:
    files: List[str] = []
    for pattern in args.runs:
        files.extend(sorted(glob.glob(pattern)) or
                     parser.error(f"no files match {pattern!r}") or [])
    events = [e for path in files for e in read_span_events(path)]
    if not any(e["name"].startswith("zw_") for e in events):
        parser.error(f"no zw_* spans in {files}")
    summary = zero_summary(events)
    if args.json:
        print(json.dumps(summary))
    else:
        print(zero_markdown(summary))
    return 0


# ---- serving mode (BENCH_SERVE artifact summary) ----

def serving_summary(rows: List[dict]) -> dict:
    """BENCH_SERVE JSON-lines -> {"rows": [engine rows], "wins": [derived
    serve_batch_win_* rows], "errors": [...]}. Keeps the artifact's own
    verdicts (ok / bitwise_identical) — analysis reads them back, it does
    not re-decide them."""
    engine = [r for r in rows
              if "slots" in r and "tokens_per_sec" in r and "error" not in r]
    wins = [r for r in rows
            if str(r.get("config", "")).startswith("serve_batch_win")]
    errors = [r for r in rows if "error" in r]
    if not engine and not wins:
        raise ValueError("no serving rows")
    return {"rows": engine, "wins": wins, "errors": errors}


def serving_markdown(summary: dict) -> str:
    lines = ["| config | slots | tokens/s | ttft p50/p99 (ms) "
             "| latency p50/p99 (ms) |", "|---|---|---|---|---|"]
    for r in summary["rows"]:
        lines.append(
            f"| {r['config']} | {r['slots']} | {r['tokens_per_sec']} "
            f"| {r['ttft_p50_ms']} / {r['ttft_p99_ms']} "
            f"| {r['latency_p50_ms']} / {r['latency_p99_ms']} |")
    for w in summary["wins"]:
        lines.append(
            f"\n{w['config']}: {w['ratio']}x tokens/s vs sequential, "
            f"bitwise_identical={w['bitwise_identical']}, ok={w['ok']}")
    for e in summary["errors"]:
        lines.append(f"\nERROR {e.get('config', '?')}: {e['error'][:80]}")
    return "\n".join(lines)


def read_json_lines(path: str) -> List[dict]:
    """Bench-artifact JSON-lines -> list of dicts (non-JSON lines skipped;
    read_records is for STEP-schema logs and drops bench rows)."""
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                rows.append(rec)
    return rows


def serving_main(args, parser) -> int:
    files: List[str] = []
    for pattern in args.runs:
        files.extend(sorted(glob.glob(pattern)) or
                     parser.error(f"no files match {pattern!r}") or [])
    rows = [r for path in files for r in read_json_lines(path)]
    try:
        summary = serving_summary(rows)
    except ValueError as e:
        parser.error(f"{e} in {files}")
    if args.json:
        print(json.dumps(summary))
    else:
        print(serving_markdown(summary))
    return 0


# ---- faults mode (resilience counter summary) ----

def fault_summary(rows: List[dict]) -> dict:
    """Step records -> run-level resilience summary. Counters are
    CUMULATIVE at emission time, so the run total of each is its max over
    the records (records may come from several files/processes; max still
    holds per counter because every emitter only grows them)."""
    from ps_pytorch_tpu_torch.telemetry.registry import RESILIENCE_COUNTERS
    steps = sorted({r["step"] for r in rows if "step" in r})
    if not steps:
        raise ValueError("no step records")
    counters = {}
    for name, _, _ in RESILIENCE_COUNTERS:
        vals = [r[name] for r in rows if name in r]
        if vals:
            counters[name] = max(int(v) for v in vals)
    # resilience may also arrive nested (timeline records publish it as one
    # sub-object rather than flat columns).
    for r in rows:
        sub = r.get("resilience")
        if isinstance(sub, dict):
            for name, _, _ in RESILIENCE_COUNTERS:
                if name in sub:
                    counters[name] = max(counters.get(name, 0),
                                         int(sub[name]))
    return {"steps": len(steps), "first_step": steps[0],
            "last_step": steps[-1], "counters": counters,
            "clean": not any(counters.values())}


def faults_markdown(summary: dict) -> str:
    head = "| counter | total |"
    sep = "|---|---|"
    body = [f"| {k} | {v} |" for k, v in sorted(summary["counters"].items())]
    if not body:
        body = ["| (no resilience counters in records) | - |"]
    tail = (f"\nsteps {summary['first_step']}..{summary['last_step']} "
            f"({summary['steps']} records) clean={summary['clean']}")
    return "\n".join([head, sep] + body) + tail


def faults_main(args, parser) -> int:
    files: List[str] = []
    for pattern in args.runs:
        files.extend(sorted(glob.glob(pattern)) or
                     parser.error(f"no files match {pattern!r}") or [])
    rows = [r for path in files for r in read_records(path)]
    if not rows:
        parser.error(f"no step records in {files}")
    summary = fault_summary(rows)
    if args.json:
        print(json.dumps(summary))
    else:
        print(faults_markdown(summary))
    return 0


# ---- flight mode (flight-recorder post-mortem) ----

def flight_markdown(doc: dict) -> str:
    lines = [f"# flight recorder: {doc.get('reason', '?')}",
             f"written pid={doc.get('pid')} dumps={doc.get('dumps')}", ""]
    health = doc.get("health_events", [])
    if health:
        lines.append("## health events")
        lines.append("| step | detector | action | value | threshold |")
        lines.append("|---|---|---|---|---|")
        for h in health:
            lines.append(f"| {h.get('step')} | {h.get('detector')} | "
                         f"{h.get('action')} | {h.get('value')} | "
                         f"{h.get('threshold')} |")
        lines.append("")
    events = doc.get("events", [])
    if events:
        lines.append("## events")
        for ev in events[-16:]:
            payload = {k: v for k, v in ev.items() if k not in ("kind", "t")}
            lines.append(f"- {ev.get('kind')}: {json.dumps(payload)}")
        lines.append("")
    steps = doc.get("steps", [])
    if steps:
        lines.append(f"## last {min(len(steps), 8)} of {len(steps)} steps")
        keys = sorted({k for s in steps[-8:] for k in s})
        lines.append("| " + " | ".join(keys) + " |")
        lines.append("|" + "---|" * len(keys))
        for s in steps[-8:]:
            lines.append("| " + " | ".join(
                str(s.get(k, "")) for k in keys) + " |")
        lines.append("")
    spans = doc.get("spans", [])
    if spans:
        tail = spans[-12:]
        lines.append(f"## last {len(tail)} of {len(spans)} spans")
        for s in tail:
            lines.append(f"- {s.get('name')} step={s.get('step')} "
                         f"dur={s.get('dur', 0):.4f}s")
        lines.append("")
    final = doc.get("final_metrics") or {}
    if final:
        lines.append("## final metric snapshot")
        for k in sorted(final):
            lines.append(f"- {k}: {final[k]}")
    return "\n".join(lines)


def flight_main(args, parser) -> int:
    from ps_pytorch_tpu_torch.telemetry.flightrec import load_flight
    files: List[str] = []
    for pattern in args.runs:
        files.extend(sorted(glob.glob(pattern)) or
                     parser.error(f"no files match {pattern!r}") or [])
    for path in files:
        doc = load_flight(path)
        if args.json:
            print(json.dumps(doc))
        else:
            print(flight_markdown(doc))
    return 0


# ---- membership mode (elastic epoch timeline from flight dumps) ----

def membership_timeline(docs: List[dict]) -> tuple:
    """Flight-recorder docs -> (chronological control-plane timeline,
    summary). The elastic trainers drain election/membership/shard_replan
    events into the flight recorder (runtime/trainer.py ``_elastic_step``);
    this folds the dumps of every process back into one epoch history:
    who led which epoch, who joined/left/was evicted when, and where the
    shard plan was recomputed."""
    rows: List[dict] = []
    for doc in docs:
        for ev in doc.get("events", []):
            if ev.get("kind") in ("election", "membership", "shard_replan"):
                rows.append(dict(ev))
    if not rows:
        raise ValueError("no election/membership events")
    rows.sort(key=lambda e: float(e.get("t", 0)))
    counts: Dict[str, int] = {}
    epochs = set()
    for ev in rows:
        counts[ev.get("event", ev["kind"])] = \
            counts.get(ev.get("event", ev["kind"]), 0) + 1
        if "epoch" in ev:
            epochs.add(int(ev["epoch"]))
    summary = {"events": len(rows), "counts": counts,
               "epochs": sorted(epochs),
               "max_epoch": max(epochs) if epochs else 0}
    return rows, summary


def membership_markdown(rows: List[dict], summary: dict) -> str:
    t0 = float(rows[0].get("t", 0))
    lines = ["| t+s | kind | event | pid | epoch | step |",
             "|---|---|---|---|---|---|"]
    for ev in rows:
        lines.append(
            f"| {float(ev.get('t', t0)) - t0:+.3f} | {ev['kind']} "
            f"| {ev.get('event', '')} | {ev.get('pid', '')} "
            f"| {ev.get('epoch', '')} | {ev.get('step', '')} |")
    c = ", ".join(f"{k}={v}" for k, v in sorted(summary["counts"].items()))
    lines.append(f"\n{summary['events']} events ({c}); epochs "
                 f"{summary['epochs']} (max {summary['max_epoch']})")
    return "\n".join(lines)


def membership_main(args, parser) -> int:
    from ps_pytorch_tpu_torch.telemetry.flightrec import load_flight
    files: List[str] = []
    for pattern in args.runs:
        files.extend(sorted(glob.glob(pattern)) or
                     parser.error(f"no files match {pattern!r}") or [])
    docs = [load_flight(path) for path in files]
    try:
        rows, summary = membership_timeline(docs)
    except ValueError as e:
        parser.error(f"{e} in {files}")
    if args.json:
        print(json.dumps({"timeline": rows, "summary": summary}))
    else:
        print(membership_markdown(rows, summary))
    return 0


# ---- stitch mode (cross-process trace merge with wire flow events) ----

def stitch_chrome_traces(docs: List[dict]) -> tuple:
    """Merge per-process Chrome traces into one doc and add flow events
    joining spans by correlation id (``args.corr``):

    - wire flows: each worker's ``wire_publish``/``wire_put`` span to the
      leader's matching ``wire_read``/``get_decode`` span (transport.py
      stamps both legs);
    - request flows: each ``request`` lifecycle span (serving/reqtrace.py,
      corr ``req/<rid>``) to the engine's ``serve_admit`` span with the
      same corr AND to every ``serve_decode`` tick whose ``args.rids``
      lists that request — the request↔engine join.

    Flow ids are ``zlib.crc32(corr)`` — deterministic, so re-stitching the
    same traces yields identical ids. Returns ``(merged_doc, n_flows)``
    with n_flows counting both families."""
    import zlib
    merged: List[dict] = []
    pubs: Dict[str, dict] = {}
    reads: Dict[str, List[dict]] = {}
    req_pubs: Dict[str, dict] = {}
    req_reads: Dict[str, List[dict]] = {}
    for doc in docs:
        for e in doc.get("traceEvents", []):
            merged.append(e)
            if e.get("ph") != "X":
                continue
            eargs = e.get("args") or {}
            corr = eargs.get("corr")
            name = e.get("name")
            if name == "serve_decode":
                # one tick serves many requests: fan its rids out
                for rid in eargs.get("rids", ()):
                    req_reads.setdefault(f"req/{rid}", []).append(e)
                continue
            if not corr:
                continue
            if name in ("wire_publish", "wire_put"):
                # Last publisher wins: one writer per corr by construction
                # (the version/bucket id is in the corr string).
                pubs[corr] = e
            elif name in ("wire_read", "get_decode"):
                reads.setdefault(corr, []).append(e)
            elif name == "request":
                req_pubs[corr] = e
            elif name == "serve_admit":
                req_reads.setdefault(corr, []).append(e)

    def _flows(srcs, sinks, cat, fname, ts_of_src):
        out = []
        for corr, pub in sorted(srcs.items()):
            for rd in sinks.get(corr, []):
                fid = zlib.crc32(corr.encode("utf-8"))
                out.append({"ph": "s", "cat": cat, "name": fname,
                            "id": fid, "pid": pub["pid"], "tid": pub["tid"],
                            "ts": ts_of_src(pub), "args": {"corr": corr}})
                out.append({"ph": "f", "bp": "e", "cat": cat, "name": fname,
                            "id": fid, "pid": rd["pid"], "tid": rd["tid"],
                            "ts": rd["ts"], "args": {"corr": corr}})
        return out

    wire = _flows(pubs, reads, "wire", "wire_flow",
                  lambda pub: pub["ts"] + pub.get("dur", 0))
    # the request span COVERS its engine spans, so the arrow leaves its start
    reqf = _flows(req_pubs, req_reads, "reqtrace", "req_flow",
                  lambda pub: pub["ts"])
    n_flows = (len(wire) + len(reqf)) // 2
    out = {"traceEvents": merged + wire + reqf, "displayTimeUnit": "ms",
           "metadata": {"stitched_from": len(docs),
                        "wire_flows": len(wire) // 2,
                        "request_flows": len(reqf) // 2}}
    return out, n_flows


def stitch_main(args, parser) -> int:
    files: List[str] = []
    for pattern in args.runs:
        files.extend(sorted(glob.glob(pattern)) or
                     parser.error(f"no files match {pattern!r}") or [])
    docs = []
    for path in files:
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or "traceEvents" not in doc:
            parser.error(f"{path} is not a Chrome trace "
                         f"(no traceEvents)")
        docs.append(doc)
    merged, n_flows = stitch_chrome_traces(docs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(merged, f)
    meta = merged["metadata"]
    summary = {"files": len(files), "events": len(merged["traceEvents"]),
               "flows": n_flows, "wire_flows": meta["wire_flows"],
               "request_flows": meta["request_flows"],
               "out": args.out or None}
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"stitched {summary['files']} traces -> "
              f"{summary['events']} events, {meta['wire_flows']} wire + "
              f"{meta['request_flows']} request flow pairs"
              + (f" -> {args.out}" if args.out else ""))
    return 0


# ---- requests mode (per-request lifecycle waterfall) ----

REQUEST_PHASES = ("queue_wait_s", "prefill_s", "decode_s", "stream_out_s")


def read_request_rows(path: str) -> List[dict]:
    """Load request-trace rows from a /debug/requests JSON body
    (``{"requests": [...]}``), a bare JSON list, or JSON-lines of
    ``RequestTrace.to_dict()`` rows."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = [r for r in (json.loads(line) for line in text.splitlines()
                           if line.strip()) if isinstance(r, dict)]
    if isinstance(doc, dict):
        doc = doc.get("requests", [])
    return [r for r in doc if isinstance(r, dict) and "rid" in r]


def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    pos = (q / 100.0) * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (pos - lo) * (sorted_vals[hi] - sorted_vals[lo])


def requests_summary(rows: List[dict], top: int = 5) -> dict:
    """Per-phase waterfall over request-trace rows: mean/p50/max seconds
    per lifecycle phase plus each phase's share of total latency, and the
    slowest-request exemplars (the rows tail sampling is for)."""
    if not rows:
        raise ValueError("no request rows")
    phases = {}
    total_lat = sum(float(r.get("latency_s") or 0.0) for r in rows)
    for ph in REQUEST_PHASES:
        vals = sorted(float(r.get(ph) or 0.0) for r in rows)
        phases[ph] = {
            "mean_ms": 1e3 * sum(vals) / len(vals),
            "p50_ms": 1e3 * _pctl(vals, 50.0),
            "max_ms": 1e3 * vals[-1],
            "share": (sum(vals) / total_lat) if total_lat > 0 else 0.0,
        }
    outcomes: Dict[str, int] = {}
    for r in rows:
        out = str(r.get("outcome", "?"))
        outcomes[out] = outcomes.get(out, 0) + 1
    slowest = sorted(rows, key=lambda r: float(r.get("latency_s") or 0.0),
                     reverse=True)[:top]
    exemplars = [{
        "rid": r.get("rid"), "outcome": r.get("outcome"),
        "latency_ms": 1e3 * float(r.get("latency_s") or 0.0),
        "n_tokens": r.get("n_tokens"), "kept": r.get("kept"),
        **{ph[:-2] + "_ms": 1e3 * float(r.get(ph) or 0.0)
           for ph in REQUEST_PHASES},
    } for r in slowest]
    return {"requests": len(rows), "outcomes": outcomes, "phases": phases,
            "slowest": exemplars}


def requests_markdown(summary: dict) -> str:
    lines = [f"# request waterfall ({summary['requests']} traces; outcomes "
             + " ".join(f"{k}={v}"
                        for k, v in sorted(summary["outcomes"].items())) + ")",
             "", "| phase | mean_ms | p50_ms | max_ms | share |",
             "|---|---|---|---|---|"]
    for ph in REQUEST_PHASES:
        s = summary["phases"][ph]
        lines.append(f"| {ph[:-2]} | {s['mean_ms']:.2f} | {s['p50_ms']:.2f} "
                     f"| {s['max_ms']:.2f} | {100 * s['share']:.1f}% |")
    lines.append("")
    lines.append("## slowest requests")
    lines.append("| rid | outcome | latency_ms | queue | prefill | decode "
                 "| stream | tok |")
    lines.append("|---|---|---|---|---|---|---|---|")
    for r in summary["slowest"]:
        lines.append(
            f"| {r['rid']} | {r['outcome']} | {r['latency_ms']:.2f} "
            f"| {r['queue_wait_ms']:.2f} | {r['prefill_ms']:.2f} "
            f"| {r['decode_ms']:.2f} | {r['stream_out_ms']:.2f} "
            f"| {r.get('n_tokens', '')} |")
    return "\n".join(lines)


def requests_main(args, parser) -> int:
    files: List[str] = []
    for pattern in args.runs:
        files.extend(sorted(glob.glob(pattern)) or
                     parser.error(f"no files match {pattern!r}") or [])
    rows = [r for path in files for r in read_request_rows(path)]
    try:
        summary = requests_summary(rows)
    except ValueError as e:
        parser.error(f"{e} in {files}")
    if args.json:
        print(json.dumps(summary))
    else:
        print(requests_markdown(summary))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("runs", nargs="+",
                   help="LABEL=GLOB pairs, e.g. 1=n1.jsonl 8='n8_host*.log'; "
                        "or: timeline FILE... for a per-phase breakdown")
    p.add_argument("--baseline", default="", help="label to normalize against")
    p.add_argument("--skip-first", type=int, default=1)
    p.add_argument("--json", action="store_true", help="emit JSON rows instead")
    p.add_argument("--out", default="",
                   help="stitch mode: write the merged Chrome trace here")
    args = p.parse_args(argv)

    if args.runs[0] == "flight":
        args.runs = args.runs[1:] or p.error("flight mode needs FILE...")
        return flight_main(args, p)
    if args.runs[0] == "stitch":
        args.runs = args.runs[1:] or p.error("stitch mode needs FILE...")
        return stitch_main(args, p)
    if args.runs[0] == "timeline":
        args.runs = args.runs[1:] or p.error("timeline mode needs FILE...")
        return timeline_main(args, p)
    if args.runs[0] == "faults":
        args.runs = args.runs[1:] or p.error("faults mode needs FILE...")
        return faults_main(args, p)
    if args.runs[0] == "wire":
        args.runs = args.runs[1:] or p.error("wire mode needs FILE...")
        return wire_main(args, p)
    if args.runs[0] == "codec":
        args.runs = args.runs[1:] or p.error("codec mode needs FILE...")
        return codec_main(args, p)
    if args.runs[0] == "zero":
        args.runs = args.runs[1:] or p.error("zero mode needs FILE...")
        return zero_main(args, p)
    if args.runs[0] == "serving":
        args.runs = args.runs[1:] or p.error("serving mode needs FILE...")
        return serving_main(args, p)
    if args.runs[0] == "membership":
        args.runs = args.runs[1:] or p.error("membership mode needs FILE...")
        return membership_main(args, p)
    if args.runs[0] == "requests":
        args.runs = args.runs[1:] or p.error("requests mode needs FILE...")
        return requests_main(args, p)

    runs: Dict[str, List[str]] = {}
    for spec in args.runs:
        label, _, pattern = spec.partition("=")
        if not pattern:
            p.error(f"run spec {spec!r} is not LABEL=GLOB")
        files = sorted(glob.glob(pattern))
        if not files:
            p.error(f"no files match {pattern!r}")
        runs.setdefault(label, []).extend(files)

    rows = analyze(runs, baseline=args.baseline, skip_first=args.skip_first)
    if args.json:
        for r in rows:
            print(json.dumps(r))
    else:
        print(to_markdown(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
