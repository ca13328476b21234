#!/usr/bin/env python
"""Evidence index: one table over every committed benchmark/accuracy/memory
artifact in the repo root. The JAX package's ``tools/report.py`` in the
port, host-only: the same families, entries, JSON and table, with one
change: a headline counts as measured on an accelerator when its
``platform`` is ``"tpu"`` or ``"gpu"`` (the card's rows), where the JAX
tool accepts only ``"tpu"``.

The repo accumulates per-round JSON artifacts (the headline bench, suite runs,
headline captures, accuracy oracles, memory probes, multichip dryruns,
scaling tables). This tool is the one-command answer to "what is the
current evidence and which rows are stale or failing" — each artifact
family gets its newest-round file summarized with its key metric, platform,
and an ok flag where the artifact defines one.

    python -m ps_pytorch_tpu_torch.tools.report            # table
    python -m ps_pytorch_tpu_torch.tools.report --json     # machine-readable

Reference counterpart: none (the reference's evidence lived in notebook
cells); closest in spirit to its analysis notebooks' summary tables.
"""

import argparse
import glob
import json
import os
import re
import sys

# Platforms of a row measured on an accelerator: the TPU's and the card's.
ACCELERATORS = ("tpu", "gpu")


def _round_of(path: str):
    m = re.search(r"_r0*(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else -1


def _newest(pattern: str, repo: str, exclude: str = ""):
    """Newest-round file matching pattern (ties broken by name)."""
    paths = sorted((p for p in glob.glob(os.path.join(repo, pattern))
                    if not (exclude and exclude in os.path.basename(p))),
                   key=lambda p: (_round_of(p), p))
    return paths[-1] if paths else None


def _newest_with_section(pattern: str, repo: str, section: str):
    """Newest-round artifact carrying a given top-level section — drill
    families share the RESILIENCE_r*.json series, so the newest round of
    ONE family is usually not the newest file overall."""
    paths = sorted(glob.glob(os.path.join(repo, pattern)),
                   key=lambda p: (_round_of(p), p))
    for p in reversed(paths):
        d = _load(p)
        if isinstance(d, dict) and isinstance(d.get(section), dict):
            return p
    return None


def _load(path: str):
    """Parse a whole-JSON or JSON-lines artifact.

    Always returns a dict for single-object artifacts and a list for
    JSON-lines ones; a malformed/truncated artifact returns
    ``{"_parse_error": ...}`` so every family renders an ok=False row
    instead of crashing the index (surfacing bad artifacts is the tool's
    whole job)."""
    with open(path) as f:
        text = f.read().strip()
    try:
        return json.loads(text)
    except ValueError:
        rows = []
        for line in text.splitlines():
            try:
                r = json.loads(line)
            except ValueError:
                continue
            if isinstance(r, dict):
                rows.append(r)
        return rows if rows else {"_parse_error": f"unparseable: {path}"}


def _suite_summary(rows):
    if not isinstance(rows, list):
        rows = [rows]
    rows = [r for r in rows if isinstance(r, dict)]
    errors = [r.get("config", r.get("_parse_error", "?")) for r in rows
              if "error" in r or "_parse_error" in r]
    # Row-level verdict flags: any False means the artifact of record
    # carries a failing row (the exact situation VERDICT r4 weak #2
    # flagged — a committed artifact contradicting the narrative).
    bad_flags = []
    flags = {}
    for r in rows:
        cfg = r.get("config", "")
        if cfg == "lenet_convergence":
            flags["converged"] = r.get("converged")
            if r.get("converged") is False:
                bad_flags.append(cfg)
        if cfg.startswith("loader_vs_chip"):
            flags[cfg] = r.get("ratio")
            if r.get("ok") is False:
                bad_flags.append(cfg)
        if cfg == "pallas_conv_ab":
            flags["pallas_accepted"] = r.get("accepted")
    head = next((r for r in rows if r.get("config") == "resnet18_cifar10_dp"
                 and "images_per_sec" in r), None)
    return {
        "rows": len(rows),
        "value": head["images_per_sec"] if head else None,
        "unit": "img/s (resnet18 dp)",
        "platform": next((r.get("platform") for r in rows
                          if r.get("platform")), "?"),
        "ok": not errors and not bad_flags,
        "errors": errors, "failing_rows": bad_flags, **flags,
    }


def collect(repo: str):
    """One entry per artifact family: (label, path, summary dict)."""
    out = []

    def add(label, path, summary):
        if path:
            out.append({"family": label,
                        "artifact": os.path.basename(path), **summary})

    def as_dict(d):
        """Guard: families that expect a dict get an error marker (and an
        ok=False row) for list/garbage shapes instead of an AttributeError."""
        if isinstance(d, dict):
            return d
        return {"_parse_error": f"expected object, got {type(d).__name__}"}

    p = _newest("BENCH_r[0-9]*.json", repo, exclude="_headline")
    if p:
        d = as_dict(_load(p))
        if "tail" in d and "value" not in d:
            # Wrapper shape: the bench line is embedded in "tail".
            # Dict-guarded like bench.py's _last_metric_line — a stray
            # scalar/array line must not rebind d to a non-dict.
            for line in reversed(d["tail"].splitlines()):
                try:
                    cand = json.loads(line)
                except ValueError:
                    continue
                if isinstance(cand, dict) and "metric" in cand:
                    d = cand
                    break
        add("driver bench", p, {
            "value": d.get("value"), "unit": d.get("unit"),
            "platform": d.get("platform"),
            "vs_baseline": d.get("vs_baseline"),
            "ok": not d.get("fallback")
            and d.get("platform") in ACCELERATORS})
    p = _newest("BENCH_r*_headline.json", repo)
    if p:
        d = as_dict(_load(p))
        add("headline capture", p, {
            "value": d.get("value"), "unit": d.get("unit"),
            "platform": d.get("platform"), "mfu": d.get("mfu"),
            "vs_baseline": d.get("vs_baseline"),
            "ok": d.get("platform") in ACCELERATORS})
    for pat, label, excl in (
            ("BENCH_SUITE_r[0-9]*.json", "suite", "_quick"),
            ("BENCH_SUITE_r*_quick.json", "suite (quick pass)", "")):
        p = _newest(pat, repo, exclude=excl)
        if p:
            add(label, p, _suite_summary(_load(p)))
    p = _newest("BENCH_HOST_r[0-9]*.json", repo)
    if p:
        # Quiet-host loader evidence (JSON-lines of input_pipeline* rows) —
        # what PERF.md §5's feeding-budget table cites (ADVICE r5 #2). The
        # headline value prefers the augmented ImageNet row (the real train
        # path) over the augment-free ones.
        rows = _load(p)
        if isinstance(rows, dict):        # single-row file parses as dict
            rows = [rows]
        rows = [r for r in rows if isinstance(r, dict)]
        errors = [r.get("config", "?") for r in rows if "error" in r]
        loaders = [r for r in rows if "loader_images_per_sec" in r]
        best = next(
            (r for r in loaders
             if r.get("config") == "input_pipeline_imagenet_augmented"),
            loaders[0] if loaders else None)
        add("host pipeline", p, {
            "rows": len(rows),
            "value": best["loader_images_per_sec"] if best else None,
            "unit": "img/s ({})".format(
                best.get("config", "?") if best else "?"),
            "platform": "host",
            "ok": bool(loaders) and not errors,
            "errors": errors})
    for pat, label, key in (
            ("ACCURACY_r[0-9]*.json", "accuracy CNN", "prec1"),
            ("ACCURACY_LM_r[0-9]*.json", "accuracy LM", "perplexity"),
            ("ACCURACY_RESNET18*.json", "accuracy ResNet18", "prec1")):
        p = _newest(pat, repo)
        if p:
            d = as_dict(_load(p))
            add(label, p, {
                "value": d.get(key), "unit": key,
                "platform": d.get("platform"),
                "ok": bool(d.get("met_target"))})
    p = _newest("MEMORY_r[0-9]*.json", repo)
    if p:
        d = as_dict(_load(p))
        rows = [r for r in d.get("rows", []) if isinstance(r, dict)]
        add("memory probe", p, {
            "value": len(rows), "unit": "modes",
            "ok": bool(d.get("complete")) and
            not any("error" in r for r in rows)})
    p = _newest("MULTICHIP_r[0-9]*.json", repo)
    if p:
        d = as_dict(_load(p))
        add("multichip dryrun", p, {
            "value": d.get("n_devices"), "unit": "devices",
            "ok": d.get("ok") is True})
    p = _newest("SCALING_r[0-9]*.json", repo)
    if p:
        d = as_dict(_load(p))
        add("scaling table", p, {
            "value": ",".join(str(s) for s in d.get("sizes", [])),
            "unit": "workers", "platform": d.get("platform"),
            "ok": bool(d.get("modes"))})
    p = _newest("TELEMETRY_r[0-9]*.json", repo)
    if p:
        # Telemetry evidence: either the analyze-timeline --json object
        # ({"phases": [...], "heatmap": [...]}) or a raw metrics/timeline
        # JSONL of v2 step records.
        from ps_pytorch_tpu_torch.runtime.metrics import SCHEMA_VERSION
        d = _load(p)
        if isinstance(d, list):
            steps = [r for r in d if "step" in r]
            vers = {r.get("schema_version") for r in steps}
            add("telemetry", p, {
                "value": len(steps), "unit": "step records",
                "platform": "host",
                "ok": bool(steps) and vers <= {SCHEMA_VERSION}})
        else:
            d = as_dict(d)
            phases = d.get("phases") or []
            top = phases[0] if phases else {}
            add("telemetry", p, {
                "value": top.get("phase"),
                "unit": "top phase ({:.0f}% of step)".format(
                    100 * (top.get("frac_of_step") or 0)),
                "platform": d.get("platform", "host"),
                "ok": bool(phases) and "_parse_error" not in d})
    p = _newest("RESILIENCE_r[0-9]*.json", repo)
    if p:
        # Chaos-drill evidence (tools/analyze.py faults mode + the E2E
        # crash/restore scenario): ok means the drill recovered — resumed
        # from a valid checkpoint and/or completed under injected faults.
        d = as_dict(_load(p))
        c = d.get("counters") or {}
        add("resilience", p, {
            "value": d.get("scenario"), "unit": "chaos scenario",
            "platform": d.get("platform"),
            "crashes": c.get("crashes"),
            "kv_retries": c.get("kv_retries"),
            "ok": d.get("ok") is True and "_parse_error" not in d})
    p = _newest_with_section("RESILIENCE_r[0-9]*.json", repo, "router")
    if p:
        # Fleet-serving evidence (tools/router_drill.py): SIGKILL
        # under Poisson load absorbed by failover, rolling reload with
        # zero failed requests, hedging beating no-hedge p99.
        d = as_dict(_load(p))
        router = d.get("router") or {}
        kill = router.get("kill") or {}
        hedge = router.get("hedge") or {}
        reload_ = router.get("reload") or {}
        add("fleet serving", p, {
            "value": kill.get("availability"),
            "unit": "availability under replica SIGKILL",
            "platform": d.get("platform"),
            "replicas": router.get("replicas"),
            "hedge_p99_ratio": hedge.get("p99_ratio"),
            "ok": (d.get("ok") is True
                   and int(kill.get("failed_5xx", -1)) == 0
                   and int(reload_.get("failed_5xx", -1)) == 0
                   and bool(reload_.get("model_step_advanced")))})
    p = _newest_with_section("RESILIENCE_r[0-9]*.json", repo, "integrity")
    if p:
        # Gradient-integrity evidence (tools/poison_drill.py): poisoned
        # contributor quarantined and readmitted on the real wire, digests
        # catching bit-flips, no-screen control diverging, <2% overhead.
        d = as_dict(_load(p))
        integ = d.get("integrity") or {}
        add("gradient integrity", p, {
            "value": integ.get("quarantines"),
            "unit": "quarantines (readmitted {}, wire fails {})".format(
                integ.get("readmissions"),
                integ.get("wire_integrity_failures")),
            "platform": d.get("platform"),
            "overhead_frac": integ.get("overhead_frac"),
            "ok": (d.get("ok") is True
                   and int(integ.get("crashes", -1)) == 0
                   and bool(integ.get("control_diverged")))})
    p = _newest_with_section("RESILIENCE_r[0-9]*.json", repo, "kvrep")
    if p:
        # Coordination-plane evidence (tools/kvrep_drill.py): a KV backend
        # SIGKILLed then wiped with training completing on the quorum
        # (zero giveups, reborn backend resynced to tag equality), serving
        # holding availability 1.00 through the wipe, and the wire-bench
        # replication overhead inside its 5% budget.
        d = as_dict(_load(p))
        kvrep = d.get("kvrep") or {}
        train = kvrep.get("train") or {}
        serve = kvrep.get("serve") or {}
        add("coordination plane", p, {
            "value": serve.get("availability"),
            "unit": "availability under KV backend kill+wipe",
            "platform": d.get("platform"),
            "backends": d.get("backends"),
            "overhead_frac": (kvrep.get("overhead") or {}).get(
                "overhead_frac"),
            "ok": (d.get("ok") is True
                   and int(train.get("giveups", -1)) == 0
                   and bool(train.get("resync_tag_equal"))
                   and int(serve.get("failed_5xx", -1)) == 0)})
    p = _newest("BENCH_WIRE_r[0-9]*.json", repo)
    if p:
        # Wire-overlap evidence (bench_suite wire_blocking_*/wire_overlapped_*
        # pairs + derived wire_overlap_win_* rows): ok means every pair was
        # bitwise-identical to the blocking wire AND cleared its speedup bar.
        rows = _load(p)
        if isinstance(rows, dict):
            rows = [rows]
        rows = [r for r in rows if isinstance(r, dict)]
        errors = [r.get("config", r.get("_parse_error", "?")) for r in rows
                  if "error" in r or "_parse_error" in r]
        wins = [r for r in rows
                if str(r.get("config", "")).startswith("wire_overlap_win")]
        head = max(wins, key=lambda r: r.get("ratio") or 0.0, default=None)
        add("wire overlap", p, {
            "rows": len(rows),
            "value": head.get("ratio") if head else None,
            "unit": "x vs blocking ({})".format(
                head.get("config", "?") if head else "?"),
            "platform": next((r.get("platform") for r in rows
                              if r.get("platform")), "host"),
            "ok": bool(wins) and not errors
            and all(r.get("ok") is True and r.get("bitwise_identical") is True
                    for r in wins),
            "errors": errors})
    p = _newest("BENCH_ZERO_r[0-9]*.json", repo)
    if p:
        # ZeRO-over-the-wire evidence (bench_suite zero_wire_* rows +
        # derived zero_wire_win_*): ok means every N-shard run stayed
        # BITWISE identical to the replicated baseline while cutting
        # per-replica publish bytes and optimizer memory to ~1/N. The
        # headline value is the deepest shard count's wire_out_ratio.
        rows = _load(p)
        if isinstance(rows, dict):
            rows = [rows]
        rows = [r for r in rows if isinstance(r, dict)]
        errors = [r.get("config", r.get("_parse_error", "?")) for r in rows
                  if "error" in r or "_parse_error" in r]
        wins = [r for r in rows
                if str(r.get("config", "")).startswith("zero_wire_win")]
        head = max(wins, key=lambda r: r.get("shards") or 0, default=None)
        add("zero wire", p, {
            "rows": len(rows),
            "value": head.get("wire_out_ratio") if head else None,
            "unit": "x full-pytree publish bytes/replica ({} shards)".format(
                head.get("shards") if head else "?"),
            "opt_state_ratio": head.get("opt_state_ratio") if head else None,
            "platform": next((r.get("platform") for r in rows
                              if r.get("platform")), "host"),
            "ok": bool(wins) and not errors
            and all(r.get("ok") is True and r.get("bitwise_identical") is True
                    for r in wins),
            "errors": errors})
    p = _newest("BENCH_SERVE_r[0-9]*.json", repo)
    if p:
        # Serving evidence (bench_suite serve_sequential_8/serve_batched_8 +
        # derived serve_batch_win_8): ok means batched decode cleared the
        # 1.5x aggregate-tokens/sec bar over sequential AND both runs
        # sampled bitwise-identical tokens (slot-count invariance =
        # generate() parity), with the p99 bars recorded alongside.
        rows = _load(p)
        if isinstance(rows, dict):
            rows = [rows]
        rows = [r for r in rows if isinstance(r, dict)]
        errors = [r.get("config", r.get("_parse_error", "?")) for r in rows
                  if "error" in r or "_parse_error" in r]
        wins = [r for r in rows
                if str(r.get("config", "")).startswith("serve_batch_win")]
        head = max(wins, key=lambda r: r.get("ratio") or 0.0, default=None)
        add("serving", p, {
            "rows": len(rows),
            "value": head.get("ratio") if head else None,
            "unit": "x vs sequential (tokens/s)",
            "ttft_p99_ms": head.get("ttft_p99_ms") if head else None,
            "latency_p99_ms": head.get("latency_p99_ms") if head else None,
            "platform": next((r.get("platform") for r in rows
                              if r.get("platform")), "host"),
            "ok": bool(wins) and not errors
            and all(r.get("ok") is True and r.get("bitwise_identical") is True
                    and r.get("ttft_p99_ms") is not None
                    and r.get("latency_p99_ms") is not None
                    for r in wins),
            "errors": errors})
    p = _newest("BENCH_OPS_r[0-9]*.json", repo)
    if p:
        # Ops-plane overhead evidence (bench_suite ops_overhead row):
        # ok means the exporter+watchdog+flight-recorder work added <2%
        # to the bare step loop — the budget the regress gate enforces.
        rows = _load(p)
        if isinstance(rows, dict):
            rows = [rows]
        rows = [r for r in rows if isinstance(r, dict)]
        errors = [r.get("config", r.get("_parse_error", "?")) for r in rows
                  if "error" in r or "_parse_error" in r]
        head = max((r for r in rows if "overhead_frac" in r),
                   key=lambda r: r.get("overhead_frac") or 0.0, default=None)
        add("ops overhead", p, {
            "rows": len(rows),
            "value": head.get("overhead_frac") if head else None,
            "unit": "frac of bare step loop (<0.02 budget)",
            "platform": next((r.get("platform") for r in rows
                              if r.get("platform")), "host"),
            "ok": head is not None and not errors
            and all(r.get("ok") is True for r in rows
                    if "overhead_frac" in r),
            "errors": errors})
    p = _newest("SLO_r[0-9]*.json", repo)
    if p:
        # Goodput-under-SLO evidence (bench_suite slo_sweep +
        # serve_reqtrace_overhead rows): ok means the open-loop ladder
        # found a knee at/above the artifact's own knee_bar AND the full
        # request-observability plane stayed under its <2% budget with
        # bitwise-identical tokens.
        rows = _load(p)
        if isinstance(rows, dict):
            rows = [rows]
        rows = [r for r in rows if isinstance(r, dict)]
        errors = [r.get("config", r.get("_parse_error", "?")) for r in rows
                  if "error" in r or "_parse_error" in r]
        sweep = next((r for r in rows if r.get("config") == "slo_sweep"),
                     None)
        ovh = next((r for r in rows
                    if r.get("config") == "serve_reqtrace_overhead"), None)
        add("slo", p, {
            "rows": len(rows),
            "value": sweep.get("goodput_under_slo_tps") if sweep else None,
            "unit": "tok/s under SLO (knee {} rps)".format(
                sweep.get("knee_rps") if sweep else "?"),
            "reqtrace_overhead_frac": (ovh.get("overhead_frac")
                                       if ovh else None),
            "platform": next((r.get("platform") for r in rows
                              if r.get("platform")), "host"),
            "ok": sweep is not None and ovh is not None and not errors
            and sweep.get("ok") is True and ovh.get("ok") is True,
            "errors": errors})
    p = _newest("REGRESS_r[0-9]*.json", repo)
    if p:
        # Regression-gate verdict (tools/regress.py 'all' mode): every
        # watched bench family stayed within its tolerance of the previous
        # committed round.
        d = as_dict(_load(p))
        fams = d.get("families") or {}
        failed = sorted(k for k, v in fams.items()
                        if isinstance(v, dict) and v.get("ok") is False)
        add("regression", p, {
            "value": len(fams), "unit": "families gated",
            "failed": failed,
            "ok": d.get("ok") is True and "_parse_error" not in d})
    p = os.path.join(repo, "COPYCHECK.json")
    if os.path.exists(p):
        d = as_dict(_load(p))
        add("copycheck", p, {"value": len(d.get("flagged", [])),
                             "unit": "flagged files",
                             "ok": not d.get("flagged")
                             and not d.get("error")
                             and "_parse_error" not in d})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args(argv)
    entries = collect(args.repo)
    if args.json:
        print(json.dumps(entries, indent=1))
        return 0
    cols = ("family", "artifact", "value", "unit", "platform", "ok")
    widths = {c: max([len(c)] + [len(str(e.get(c, ""))) for e in entries])
              for c in cols}
    line = "  ".join(f"{{:{widths[c]}}}" for c in cols)
    print(line.format(*cols))
    for e in entries:
        print(line.format(*(str(e.get(c, "")) for c in cols)))
    stale = [e for e in entries if e.get("ok") is False]
    print(f"\n{len(entries)} artifact families; "
          f"{len(stale)} with ok=False: "
          f"{[e['family'] for e in stale] or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
