#!/usr/bin/env python
"""Bench regression gate: compare a fresh benchmark artifact against the
newest committed one of the same family and fail (non-zero exit) when a
watched metric moved past its tolerance in the bad direction.

The JAX package's ``tools/regress.py`` in the port, host-only: the same
13 families, verdict JSON and CLI, with one change. A relative metric
(``images_per_sec``, ``tokens_per_sec``, the wire seconds) is compared
only between rows of one device: where the candidate has chip rows (a
``platform`` other than ``"host"``), its baseline is the newest committed
artifact whose chip rows name the same ``platform``, ``device_kind``
and ``devices`` (the ranks a row spans); where none does, the gate
passes with "no committed baseline", as the JAX gate does for a family
with no artifact. So an H100 row is never judged against a TPU row, nor
a row over four ranks against one over one. Host rows keep the JAX rule.

Families and their watched metrics (direction, relative tolerance):

- ``wire``       BENCH_WIRE_r*.json     publish_s/read_s/total_s lower-is-
                                        better, 20% (host RTT noise)
- ``wire_codec`` BENCH_WIRE_r*.json     wire_codec_win_* rows: per-row ok,
                                        topk wire_ratio >= 2.0, int8lat
                                        bitwise_identical (bars travel in
                                        the artifact; no prior round)
- ``serve``      BENCH_SERVE_r*.json    tokens_per_sec higher-is-better,
                                        ttft_p99_ms/latency_p99_ms lower,
                                        25% (tail percentiles are noisy)
- ``suite``      BENCH_SUITE_r*.json    images_per_sec higher, 20%
- ``ops``        BENCH_OPS_r*.json      overhead_frac must stay < 0.02
                                        absolute (the exporter+watchdog
                                        budget, not a relative drift)
- ``slo``        SLO_r*.json            knee_rps >= the knee_bar recorded
                                        in the artifact, reqtrace overhead
                                        < 0.02 absolute, bitwise identity
                                        and per-row ok must hold
- ``resilience`` RESILIENCE_r*.json     boolean invariants must stay true
                                        (bitwise_equal/ok) and kv_giveups 0
- ``elastic``    RESILIENCE_r*.json     newest artifact WITH an "elastic"
                                        section: >=1 election, >=1
                                        membership change, final epoch >=2,
                                        ok true, kv_giveups 0
- ``hierarchy``  RESILIENCE_r*.json     newest artifact WITH a "hierarchy"
                                        section: the chaos drill saw >=1
                                        partition, >=1 regraft and >=1
                                        degraded step, ok/bitwise_equal
                                        true, and the hier-vs-flat bench
                                        recorded a speedup > 1 (kv_giveups
                                        are EXPECTED — a partition makes
                                        the retry plane give up by design)
- ``integrity``  RESILIENCE_r*.json     newest artifact WITH an "integrity"
                                        section: the poisoned-contributor
                                        drill (tools/poison_drill.py) saw
                                        >=1 quarantine, >=1 probation
                                        readmission and >=1 wire digest
                                        failure, zero crashes, the
                                        screen-off control diverged, the
                                        screened run's final loss matched
                                        the clean baseline, and the digest+
                                        screen overhead stayed < 2%
- ``zero_wire``  BENCH_ZERO_r*.json     zero_wire_win_* rows: per-row ok,
                                        bitwise_identical (sharded final
                                        params == replicated, exactly),
                                        per-replica publish bytes <= 0.75x
                                        the full-pytree publish, optimizer
                                        state <= 1/N + 0.15 per replica
                                        (bars travel in the artifact; no
                                        prior round needed)
- ``kvrep``      RESILIENCE_r*.json     newest artifact WITH a "kvrep"
                                        section: the coordination-plane
                                        drill (tools/kvrep_drill.py) saw a
                                        KV backend actually SIGKILLed AND
                                        wiped, every client rejoined and
                                        anti-entropy-resynced it back to
                                        key-by-key tag equality, training
                                        finished with zero giveups, serving
                                        availability held 1.00 with zero
                                        5xx, the resume recurrence stayed
                                        bitwise, and the wire-bench
                                        replication overhead stayed < 5%

Rows are matched by their "config" name — a config present in the baseline
but missing from the candidate is a failure (silently dropping a bench row
is how regressions hide), while new configs pass with a note.

    python -m ps_pytorch_tpu_torch.tools.regress wire /tmp/new_wire.json
    python -m ps_pytorch_tpu_torch.tools.regress all --out /tmp/regress.json

``all`` mode self-checks each family's newest committed artifact against
its previous round (skipping families with fewer than two rounds) — the
mode that generates the committed REGRESS_r*.json and the report row.
"""

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional

# (metric, direction, relative tolerance). Direction "lower"/"higher" is
# which way is BETTER; a move past tol in the other way is a regression.
FAMILIES: Dict[str, dict] = {
    "wire": {
        "pattern": "BENCH_WIRE_r[0-9]*.json",
        "metrics": [("publish_s", "lower", 0.20),
                    ("read_s", "lower", 0.20),
                    ("total_s", "lower", 0.20)],
    },
    "wire_codec": {
        # Same artifact series as wire, but gating the homomorphic grad-
        # codec rows (bench_suite wire_codec_* + derived wire_codec_win_*):
        # every win row must be ok, topk@0.01 must cut wire bytes >= 2x vs
        # the blosc decode-then-average baseline, and the int8lat
        # compressed-domain average must be bitwise-identical to the
        # oracle. No prior round needed — the bars travel in the rows.
        "pattern": "BENCH_WIRE_r[0-9]*.json",
        "metrics": [],              # invariant check, see _check_wire_codec
        "min_ratio": [("wire_codec_win_topk_24mb", "wire_ratio", 2.0)],
        "bitwise_rows": ["wire_codec_win_int8lat_24mb"],
    },
    "serve": {
        "pattern": "BENCH_SERVE_r[0-9]*.json",
        "metrics": [("tokens_per_sec", "higher", 0.25),
                    ("ttft_p99_ms", "lower", 0.25),
                    ("latency_p99_ms", "lower", 0.25)],
    },
    "suite": {
        "pattern": "BENCH_SUITE_r[0-9]*.json",
        "metrics": [("images_per_sec", "higher", 0.20)],
    },
    "ops": {
        "pattern": "BENCH_OPS_r[0-9]*.json",
        "metrics": [],              # absolute budget check, see _check_ops
        "absolute": [("overhead_frac", 0.02)],
    },
    "slo": {
        # Goodput-under-SLO artifact (bench_suite slo_sweep +
        # serve_reqtrace_overhead rows). The knee bar travels IN the
        # artifact (knee_bar = lowest offered rate of the ladder that
        # produced it) so the gate needs no prior round: an engine that
        # can't meet its own loose SLO at the gentlest rung regressed.
        "pattern": "SLO_r[0-9]*.json",
        "metrics": [],              # invariant check, see _check_slo
        "absolute": [("overhead_frac", 0.02)],
    },
    "resilience": {
        "pattern": "RESILIENCE_r[0-9]*.json",
        "metrics": [],              # invariant check, see _check_resilience
        "bools": ["bitwise_equal", "ok"],
        "zero_counters": ["kv_giveups"],
    },
    "elastic": {
        # Same artifact series as resilience, but gating the elastic
        # control-plane drill: the newest RESILIENCE_r*.json carrying an
        # "elastic" section must show at least one real election and one
        # membership change (a drill where nobody died proved nothing),
        # with the run still ok and the retry plane never giving up.
        "pattern": "RESILIENCE_r[0-9]*.json",
        "metrics": [],              # invariant check, see _check_elastic
        "bools": ["bitwise_equal", "ok"],
        "zero_counters": ["kv_giveups"],
        "min_elastic": [("elections", 1), ("membership_changes", 1),
                        ("final_epoch", 2)],
    },
    "hierarchy": {
        # Same artifact series again, gating the hierarchical-sync chaos
        # drill (tools/hierarchy_drill.py): the newest RESILIENCE_r*.json
        # carrying a "hierarchy" section must show the full partition ->
        # degrade -> heal -> re-graft arc actually happened, the resumed
        # continuation stayed bitwise-reproducible, and the tiered
        # topology still beats the flat star on the recorded bench.
        # kv_giveups is deliberately NOT zero-gated here: giving up after
        # bounded retries inside a partition window IS the degraded-mode
        # contract.
        "pattern": "RESILIENCE_r[0-9]*.json",
        "metrics": [],              # invariant check, see _check_hierarchy
        "bools": ["bitwise_equal", "ok"],
        "min_hierarchy": [("partitions", 1), ("regrafts", 1),
                          ("degraded_steps", 1)],
    },
    "router": {
        # Same artifact series, gating the fleet-serving drill
        # (tools/router_drill.py): the newest RESILIENCE_r*.json carrying
        # a "router" section must show a replica actually SIGKILLed under
        # open-loop load with zero client-visible 5xx and availability at
        # or above the floor recorded in the artifact, a rolling reload
        # across >= 3 replicas with zero failed requests and the served
        # model_step advanced everywhere, and hedged dispatch beating
        # no-hedge p99 on the jittered-backend bench.
        "pattern": "RESILIENCE_r[0-9]*.json",
        "metrics": [],              # invariant check, see _check_router
        "bools": ["bitwise_equal", "ok"],
    },
    "integrity": {
        # Same artifact series, gating the gradient-integrity drill
        # (tools/poison_drill.py): the newest RESILIENCE_r*.json carrying
        # an "integrity" section must show the poisoned contributor was
        # actually quarantined and later readmitted on probation, the wire
        # digests caught >=1 bit-flipped chunk, nobody crashed (every
        # reject demotes to "absent this round"), the no-screen control
        # diverged (proof the screen is load-bearing), and the per-step
        # digest+screen cost stayed under the 2% budget.
        "pattern": "RESILIENCE_r[0-9]*.json",
        "metrics": [],              # invariant check, see _check_integrity
        "bools": ["bitwise_equal", "ok"],
        "min_integrity": [("quarantines", 1), ("readmissions", 1),
                          ("screen_rejects", 3),
                          ("wire_integrity_failures", 1)],
        "absolute": [("overhead_frac", 0.02)],
    },
    "zero_wire": {
        # ZeRO-over-the-wire artifact (bench_suite zero_wire_* rows +
        # derived zero_wire_win_*): every win row must be ok AND bitwise-
        # identical to the 1shard replicated baseline, per-replica publish
        # bytes must stay <= 0.75x the full-pytree publish, and the
        # per-replica optimizer state must stay ~1/N. The bars travel in
        # the rows, so the gate needs no prior round.
        "pattern": "BENCH_ZERO_r[0-9]*.json",
        "metrics": [],              # invariant check, see _check_zero_wire
        "max_ratio": [("wire_out_ratio", 0.75)],
    },
    "kvrep": {
        # Same artifact series, gating the coordination-plane drill
        # (tools/kvrep_drill.py): the newest RESILIENCE_r*.json carrying a
        # "kvrep" section must show a KV backend actually SIGKILLed and
        # wiped with the quorum masking it end to end — training completed
        # every version with zero retry giveups and the reborn backend
        # resynced to key-by-key tag equality, fleet serving held
        # availability 1.00 with zero client 5xx through the wipe, the
        # restart-mid-outage recurrence stayed bitwise, and the wire-bench
        # replication overhead stayed under the 5% budget.
        "pattern": "RESILIENCE_r[0-9]*.json",
        "metrics": [],              # invariant check, see _check_kvrep
        "bools": ["bitwise_equal", "ok"],
        "min_kvrep": [("backend_kills", 1), ("backend_wipes", 1),
                      ("rejoins", 1), ("resyncs", 1)],
        "absolute": [("overhead_frac", 0.05)],
    },
}


def _round_of(path: str) -> int:
    m = re.search(r"_r0*(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else -1


def _committed(family: str, repo: str) -> List[str]:
    """Committed artifact paths of a family, oldest round first."""
    paths = glob.glob(os.path.join(repo, FAMILIES[family]["pattern"]))
    return sorted(paths, key=lambda p: (_round_of(p), p))


def load_artifact(path: str):
    """Whole-JSON dict or JSON-lines list (same contract as report._load),
    but malformed artifacts raise — a gate must not pass on garbage."""
    with open(path) as f:
        text = f.read().strip()
    try:
        return json.loads(text)
    except ValueError:
        rows = [json.loads(line) for line in text.splitlines() if line]
        if not rows or not all(isinstance(r, dict) for r in rows):
            raise ValueError(f"unparseable artifact: {path}")
        return rows


def _as_rows(doc) -> List[dict]:
    return [doc] if isinstance(doc, dict) else list(doc)


def _by_config(rows) -> Dict[str, dict]:
    if isinstance(rows, dict):
        rows = [rows]
    return {r["config"]: r for r in rows if "config" in r}


def _check_metric(base: float, cand: float, direction: str,
                  tol: float) -> dict:
    """ratio is candidate/baseline; ok when the bad-direction move stays
    within tol (a zero/negative baseline can't be ratioed — pass, noted)."""
    if not base or base <= 0:
        return {"base": base, "cand": cand, "ratio": None, "ok": True,
                "note": "baseline not positive; skipped"}
    ratio = cand / base
    ok = (ratio <= 1.0 + tol) if direction == "lower" else \
         (ratio >= 1.0 - tol)
    return {"base": base, "cand": cand, "ratio": round(ratio, 4), "ok": ok}


def compare(family: str, baseline, candidate) -> dict:
    """One family's gate: {"family", "ok", "configs": {...}} with a per-
    config, per-metric breakdown. Raises KeyError on unknown family."""
    spec = FAMILIES[family]
    if family == "resilience":
        return _check_resilience(spec, candidate)
    if family == "elastic":
        return _check_elastic(spec, candidate)
    if family == "hierarchy":
        return _check_hierarchy(spec, candidate)
    if family == "router":
        return _check_router(spec, candidate)
    if family == "integrity":
        return _check_integrity(spec, candidate)
    if family == "kvrep":
        return _check_kvrep(spec, candidate)
    if family == "ops":
        return _check_ops(spec, candidate)
    if family == "slo":
        return _check_slo(spec, candidate)
    if family == "wire_codec":
        return _check_wire_codec(spec, candidate)
    if family == "zero_wire":
        return _check_zero_wire(spec, candidate)
    base_rows, cand_rows = _by_config(baseline), _by_config(candidate)
    configs: Dict[str, dict] = {}
    ok = True
    for name, brow in sorted(base_rows.items()):
        crow = cand_rows.get(name)
        if crow is None:
            configs[name] = {"ok": False, "note": "config missing from "
                                                  "candidate"}
            ok = False
            continue
        checks = {}
        for metric, direction, tol in spec["metrics"]:
            if metric not in brow or metric not in crow:
                continue
            checks[metric] = _check_metric(float(brow[metric]),
                                           float(crow[metric]),
                                           direction, tol)
            ok = ok and checks[metric]["ok"]
        configs[name] = {"ok": all(c["ok"] for c in checks.values()),
                         "metrics": checks}
    for name in sorted(set(cand_rows) - set(base_rows)):
        configs[name] = {"ok": True, "note": "new config (no baseline)"}
    return {"family": family, "ok": ok, "configs": configs}


def _check_ops(spec: dict, candidate) -> dict:
    configs: Dict[str, dict] = {}
    ok = True
    for name, row in sorted(_by_config(candidate).items()):
        checks = {}
        for metric, budget in spec["absolute"]:
            val = float(row.get(metric, float("inf")))
            checks[metric] = {"cand": val, "budget": budget,
                              "ok": val < budget}
            ok = ok and checks[metric]["ok"]
        configs[name] = {"ok": all(c["ok"] for c in checks.values()),
                         "metrics": checks}
    if not configs:
        ok = False
        configs["_empty"] = {"ok": False, "note": "no ops rows"}
    return {"family": "ops", "ok": ok, "configs": configs}


def _check_slo(spec: dict, candidate) -> dict:
    configs: Dict[str, dict] = {}
    ok = True
    rows = _by_config(candidate)
    sweep = rows.get("slo_sweep")
    if sweep is None or "error" in sweep:
        configs["slo_sweep"] = {"ok": False, "note": "no slo_sweep row"}
        ok = False
    else:
        knee = sweep.get("knee_rps")
        bar = float(sweep.get("knee_bar") or 0.0)
        checks = {
            "knee_rps": {"cand": knee, "floor": bar,
                         "ok": knee is not None and float(knee) >= bar},
            "ok": {"cand": sweep.get("ok"), "ok": sweep.get("ok") is True},
        }
        configs["slo_sweep"] = {"ok": all(c["ok"] for c in checks.values()),
                                "metrics": checks}
        ok = ok and configs["slo_sweep"]["ok"]
    ovh = rows.get("serve_reqtrace_overhead")
    if ovh is None or "error" in ovh:
        configs["serve_reqtrace_overhead"] = {
            "ok": False, "note": "no serve_reqtrace_overhead row"}
        ok = False
    else:
        checks = {}
        for metric, budget in spec["absolute"]:
            val = float(ovh.get(metric, float("inf")))
            checks[metric] = {"cand": val, "budget": budget,
                              "ok": val < budget}
        checks["bitwise_identical"] = {
            "cand": ovh.get("bitwise_identical"),
            "ok": ovh.get("bitwise_identical") is True}
        configs["serve_reqtrace_overhead"] = {
            "ok": all(c["ok"] for c in checks.values()), "metrics": checks}
        ok = ok and configs["serve_reqtrace_overhead"]["ok"]
    return {"family": "slo", "ok": ok, "configs": configs}


def _check_wire_codec(spec: dict, candidate) -> dict:
    """Gate the homomorphic-codec win rows: every wire_codec_win_* row's
    own ok bit, the topk wire-bytes floor, and int8lat bitwise identity."""
    rows = _by_config(candidate)
    win_rows = {n: r for n, r in rows.items()
                if n.startswith("wire_codec_win_")}
    configs: Dict[str, dict] = {}
    ok = True
    if not win_rows:
        return {"family": "wire_codec", "ok": False,
                "configs": {"_empty": {"ok": False,
                                       "note": "no wire_codec_win_* rows"}}}
    for name, row in sorted(win_rows.items()):
        checks = {"ok": {"cand": row.get("ok"), "ok": row.get("ok") is True}}
        configs[name] = {"ok": checks["ok"]["ok"], "metrics": checks}
        ok = ok and configs[name]["ok"]
    for name, metric, floor in spec["min_ratio"]:
        row = rows.get(name)
        val = float(row.get(metric, 0.0)) if row else 0.0
        check = {"cand": val, "floor": floor, "ok": val >= floor}
        configs.setdefault(name, {"ok": True, "metrics": {}})
        configs[name]["metrics"][metric] = check
        configs[name]["ok"] = configs[name]["ok"] and check["ok"]
        ok = ok and check["ok"]
    for name in spec["bitwise_rows"]:
        row = rows.get(name)
        cand = row.get("bitwise_identical") if row else None
        check = {"cand": cand, "ok": cand is True}
        configs.setdefault(name, {"ok": True, "metrics": {}})
        configs[name]["metrics"]["bitwise_identical"] = check
        configs[name]["ok"] = configs[name]["ok"] and check["ok"]
        ok = ok and check["ok"]
    return {"family": "wire_codec", "ok": ok, "configs": configs}


def _check_zero_wire(spec: dict, candidate) -> dict:
    """Gate the ZeRO-over-the-wire win rows: each row's own ok bit, the
    bitwise sharded==replicated flag, the per-replica wire-byte ceiling,
    and the ~1/N optimizer-memory ceiling (N travels in the row)."""
    rows = _by_config(candidate)
    win_rows = {n: r for n, r in rows.items()
                if n.startswith("zero_wire_win_")}
    configs: Dict[str, dict] = {}
    ok = True
    if not win_rows:
        return {"family": "zero_wire", "ok": False,
                "configs": {"_empty": {"ok": False,
                                       "note": "no zero_wire_win_* rows"}}}
    for name, row in sorted(win_rows.items()):
        n = max(int(row.get("shards", 0)), 1)
        checks = {
            "ok": {"cand": row.get("ok"), "ok": row.get("ok") is True},
            "bitwise_identical": {"cand": row.get("bitwise_identical"),
                                  "ok": row.get("bitwise_identical") is True},
            "opt_state_ratio": {"cand": row.get("opt_state_ratio"),
                                "ceiling": round(1.0 / n + 0.15, 3),
                                "ok": float(row.get("opt_state_ratio", 9.9))
                                <= 1.0 / n + 0.15},
        }
        for metric, ceiling in spec["max_ratio"]:
            checks[metric] = {"cand": row.get(metric), "ceiling": ceiling,
                              "ok": float(row.get(metric, 9.9)) <= ceiling}
        configs[name] = {"ok": all(c["ok"] for c in checks.values()),
                         "metrics": checks}
        ok = ok and configs[name]["ok"]
    return {"family": "zero_wire", "ok": ok, "configs": configs}


def _check_resilience(spec: dict, candidate) -> dict:
    doc = candidate if isinstance(candidate, dict) else \
        (candidate[0] if candidate else {})
    checks: Dict[str, dict] = {}
    ok = True
    for key in spec["bools"]:
        if key in doc:
            checks[key] = {"cand": doc[key], "ok": bool(doc[key])}
            ok = ok and checks[key]["ok"]
    counters = doc.get("counters", {})
    for key in spec["zero_counters"]:
        if key in counters:
            checks[key] = {"cand": counters[key],
                           "ok": counters[key] == 0}
            ok = ok and checks[key]["ok"]
    if not checks:
        ok = False
        checks["_empty"] = {"ok": False, "note": "no invariants found"}
    return {"family": "resilience", "ok": ok,
            "configs": {"invariants": {"ok": ok, "metrics": checks}}}


def _check_elastic(spec: dict, candidate) -> dict:
    doc = candidate if isinstance(candidate, dict) else \
        (candidate[0] if candidate else {})
    checks: Dict[str, dict] = {}
    ok = True
    elastic = doc.get("elastic")
    if not isinstance(elastic, dict):
        return {"family": "elastic", "ok": False,
                "configs": {"invariants": {"ok": False, "metrics": {
                    "_elastic": {"ok": False,
                                 "note": "artifact has no elastic "
                                         "section"}}}}}
    for key in spec["bools"]:
        if key in doc:
            checks[key] = {"cand": doc[key], "ok": bool(doc[key])}
            ok = ok and checks[key]["ok"]
    counters = doc.get("counters", {})
    for key in spec["zero_counters"]:
        if key in counters:
            checks[key] = {"cand": counters[key], "ok": counters[key] == 0}
            ok = ok and checks[key]["ok"]
    for key, floor in spec["min_elastic"]:
        val = int(elastic.get(key, 0))
        checks[key] = {"cand": val, "floor": floor, "ok": val >= floor}
        ok = ok and checks[key]["ok"]
    return {"family": "elastic", "ok": ok,
            "configs": {"invariants": {"ok": ok, "metrics": checks}}}


def _check_hierarchy(spec: dict, candidate) -> dict:
    doc = candidate if isinstance(candidate, dict) else \
        (candidate[0] if candidate else {})
    checks: Dict[str, dict] = {}
    ok = True
    hier = doc.get("hierarchy")
    if not isinstance(hier, dict):
        return {"family": "hierarchy", "ok": False,
                "configs": {"invariants": {"ok": False, "metrics": {
                    "_hierarchy": {"ok": False,
                                   "note": "artifact has no hierarchy "
                                           "section"}}}}}
    for key in spec["bools"]:
        if key in doc:
            checks[key] = {"cand": doc[key], "ok": bool(doc[key])}
            ok = ok and checks[key]["ok"]
    for key, floor in spec["min_hierarchy"]:
        val = int(hier.get(key, 0))
        checks[key] = {"cand": val, "floor": floor, "ok": val >= floor}
        ok = ok and checks[key]["ok"]
    bench = hier.get("bench", {})
    speedup = float(bench.get("speedup", 0.0))
    checks["bench_speedup"] = {"cand": speedup, "floor": 1.0,
                               "ok": speedup > 1.0}
    ok = ok and checks["bench_speedup"]["ok"]
    return {"family": "hierarchy", "ok": ok,
            "configs": {"invariants": {"ok": ok, "metrics": checks}}}


def _check_router(spec: dict, candidate) -> dict:
    doc = candidate if isinstance(candidate, dict) else \
        (candidate[0] if candidate else {})
    checks: Dict[str, dict] = {}
    ok = True
    router = doc.get("router")
    if not isinstance(router, dict):
        return {"family": "router", "ok": False,
                "configs": {"invariants": {"ok": False, "metrics": {
                    "_router": {"ok": False,
                                "note": "artifact has no router "
                                        "section"}}}}}
    for key in spec["bools"]:
        if key in doc:
            checks[key] = {"cand": doc[key], "ok": bool(doc[key])}
            ok = ok and checks[key]["ok"]
    # kill phase: a replica really died under load, clients never saw it
    kill = router.get("kill", {})
    floor = float(kill.get("availability_floor", 0.99))
    avail = kill.get("availability")
    checks["kill_availability"] = {
        "cand": avail, "floor": floor,
        "ok": avail is not None and float(avail) >= floor}
    checks["replica_kills"] = {
        "cand": int(kill.get("replica_kills", 0)), "floor": 1,
        "ok": int(kill.get("replica_kills", 0)) >= 1}
    checks["kill_zero_5xx"] = {
        "cand": int(kill.get("failed_5xx", -1)),
        "ok": int(kill.get("failed_5xx", -1)) == 0}
    # rolling reload: zero failed requests, every replica on the new step
    reload_ = router.get("reload", {})
    checks["reload_zero_failed"] = {
        "cand": int(reload_.get("failed_5xx", -1)),
        "ok": (int(reload_.get("failed_5xx", -1)) == 0
               and int(reload_.get("requests", 0)) > 0)}
    checks["replicas_rolled"] = {
        "cand": int(reload_.get("replicas_rolled", 0)), "floor": 3,
        "ok": int(reload_.get("replicas_rolled", 0)) >= 3}
    checks["model_step_advanced"] = {
        "cand": bool(reload_.get("model_step_advanced", False)),
        "ok": bool(reload_.get("model_step_advanced", False))}
    # hedging: backup requests must lower routed p99 on the jittered bench
    hedge = router.get("hedge", {})
    ratio = hedge.get("p99_ratio")
    checks["hedge_p99_ratio"] = {
        "cand": ratio, "ceiling": 1.0,
        "ok": ratio is not None and float(ratio) < 1.0}
    checks["hedges_fired"] = {
        "cand": int(hedge.get("hedges", 0)), "floor": 1,
        "ok": int(hedge.get("hedges", 0)) >= 1}
    for c in checks.values():
        ok = ok and c["ok"]
    return {"family": "router", "ok": ok,
            "configs": {"invariants": {"ok": ok, "metrics": checks}}}


def _check_integrity(spec: dict, candidate) -> dict:
    doc = candidate if isinstance(candidate, dict) else \
        (candidate[0] if candidate else {})
    checks: Dict[str, dict] = {}
    ok = True
    integ = doc.get("integrity")
    if not isinstance(integ, dict):
        return {"family": "integrity", "ok": False,
                "configs": {"invariants": {"ok": False, "metrics": {
                    "_integrity": {"ok": False,
                                   "note": "artifact has no integrity "
                                           "section"}}}}}
    for key in spec["bools"]:
        if key in doc:
            checks[key] = {"cand": doc[key], "ok": bool(doc[key])}
            ok = ok and checks[key]["ok"]
    for key, floor in spec["min_integrity"]:
        val = int(integ.get(key, 0))
        checks[key] = {"cand": val, "floor": floor, "ok": val >= floor}
        ok = ok and checks[key]["ok"]
    # Every digest failure / screen reject demotes; nobody may crash.
    crashes = int(integ.get("crashes", -1))
    checks["crashes"] = {"cand": crashes, "ok": crashes == 0}
    ok = ok and checks["crashes"]["ok"]
    # The no-screen control run must diverge — otherwise the drill's
    # poison was too weak to prove the screen did anything.
    diverged = bool(integ.get("control_diverged", False))
    checks["control_diverged"] = {"cand": diverged, "ok": diverged}
    ok = ok and checks["control_diverged"]["ok"]
    for metric, budget in spec["absolute"]:
        val = float(integ.get(metric, float("inf")))
        checks[metric] = {"cand": val, "budget": budget, "ok": val < budget}
        ok = ok and checks[metric]["ok"]
    return {"family": "integrity", "ok": ok,
            "configs": {"invariants": {"ok": ok, "metrics": checks}}}


def _check_kvrep(spec: dict, candidate) -> dict:
    doc = candidate if isinstance(candidate, dict) else \
        (candidate[0] if candidate else {})
    checks: Dict[str, dict] = {}
    ok = True
    kvrep = doc.get("kvrep")
    if not isinstance(kvrep, dict):
        return {"family": "kvrep", "ok": False,
                "configs": {"invariants": {"ok": False, "metrics": {
                    "_kvrep": {"ok": False,
                               "note": "artifact has no kvrep section"}}}}}
    for key in spec["bools"]:
        if key in doc:
            checks[key] = {"cand": doc[key], "ok": bool(doc[key])}
            ok = ok and checks[key]["ok"]
    for key, floor in spec["min_kvrep"]:
        val = int(kvrep.get(key, 0))
        checks[key] = {"cand": val, "floor": floor, "ok": val >= floor}
        ok = ok and checks[key]["ok"]
    # Training over the quorum: every version, zero giveups, and the
    # reborn backend back to key-by-key tag equality.
    train = kvrep.get("train", {})
    giveups = int(train.get("giveups", -1))
    checks["train_giveups"] = {"cand": giveups, "ok": giveups == 0}
    ok = ok and checks["train_giveups"]["ok"]
    teq = bool(train.get("resync_tag_equal", False))
    checks["train_resync_tag_equal"] = {"cand": teq, "ok": teq}
    ok = ok and teq
    # Serving through the wipe: availability 1.00, zero client 5xx.
    serve = kvrep.get("serve", {})
    avail = float(serve.get("availability", 0.0))
    floor = float(serve.get("availability_floor", 1.0))
    checks["serve_availability"] = {"cand": avail, "floor": floor,
                                    "ok": avail >= floor}
    ok = ok and checks["serve_availability"]["ok"]
    fxx = int(serve.get("failed_5xx", -1))
    checks["serve_failed_5xx"] = {"cand": fxx, "ok": fxx == 0}
    ok = ok and checks["serve_failed_5xx"]["ok"]
    for metric, budget in spec["absolute"]:
        val = float(kvrep.get("overhead", {}).get(metric, float("inf")))
        checks[metric] = {"cand": val, "budget": budget, "ok": val < budget}
        ok = ok and checks[metric]["ok"]
    return {"family": "kvrep", "ok": ok,
            "configs": {"invariants": {"ok": ok, "metrics": checks}}}


def chip_devices(doc) -> set:
    """The ``(platform, device_kind, devices)`` of an artifact's chip rows
    (rows with a ``platform`` other than ``"host"``): a row over four
    ranks is never judged against one over one."""
    return {(r.get("platform"), r.get("device_kind"), r.get("devices"))
            for r in _as_rows(doc)
            if isinstance(r, dict) and r.get("platform") not in (None,
                                                                 "host")}


def run_gate(family: str, candidate_path: str, repo: str = ".",
             baseline_path: str = "") -> dict:
    """Gate one candidate artifact against the newest committed baseline
    (or an explicit one). The candidate file itself is excluded from the
    baseline search so gating an already-committed artifact compares
    against its predecessor. A candidate with chip rows takes only a
    baseline whose chip rows are on the same devices."""
    candidate = load_artifact(candidate_path)
    devices = chip_devices(candidate)
    baseline = None
    if family not in ("resilience", "ops", "slo", "wire_codec", "zero_wire",
                      "hierarchy", "router", "integrity", "kvrep"):
        if baseline_path:
            prior = [baseline_path]
        else:
            cand_real = os.path.realpath(candidate_path)
            prior = [p for p in _committed(family, repo)
                     if os.path.realpath(p) != cand_real]
        if devices:
            prior = [p for p in prior
                     if chip_devices(load_artifact(p)) == devices]
        if not prior:
            return {"family": family, "ok": True, "configs": {},
                    "note": "no committed baseline; gate passes"}
        baseline_path = prior[-1]
        baseline = load_artifact(baseline_path)
    out = compare(family, baseline, candidate)
    out["candidate"] = os.path.basename(candidate_path)
    out["baseline"] = os.path.basename(baseline_path) if baseline_path \
        else None
    return out


def run_all(repo: str = ".") -> dict:
    """Self-check every family's newest committed artifact against its
    previous round. Families with <2 rounds are skipped (noted, not
    failed); resilience/ops validate their single newest artifact."""
    families: Dict[str, dict] = {}
    ok = True
    for family in FAMILIES:
        paths = _committed(family, repo)
        if not paths:
            families[family] = {"family": family, "ok": True,
                                "note": "no committed artifacts; skipped"}
            continue
        if family in ("elastic", "hierarchy", "router", "integrity",
                      "kvrep"):
            # Gate the newest artifact that actually ran this drill
            # (older RESILIENCE rounds predate the subsystem).
            with_section = [p for p in paths if isinstance(
                load_artifact(p), dict) and family in load_artifact(p)]
            if not with_section:
                families[family] = {"family": family, "ok": True,
                                    "note": f"no artifact with a {family} "
                                            "section; skipped"}
                continue
            families[family] = run_gate(family, with_section[-1], repo=repo)
        elif family == "wire_codec":
            # Gate the newest wire artifact that carries codec win rows
            # (older BENCH_WIRE rounds predate the homomorphic family).
            with_rows = [p for p in paths
                         if any(str(r.get("config", "")).startswith(
                             "wire_codec_win_")
                             for r in _as_rows(load_artifact(p)))]
            if not with_rows:
                families[family] = {"family": family, "ok": True,
                                    "note": "no artifact with "
                                            "wire_codec_win_* rows; skipped"}
                continue
            families[family] = run_gate(family, with_rows[-1], repo=repo)
        elif family in ("resilience", "ops", "slo", "zero_wire"):
            families[family] = run_gate(family, paths[-1], repo=repo)
        elif len(paths) < 2:
            families[family] = {"family": family, "ok": True,
                                "note": "only one round; skipped"}
        else:
            families[family] = run_gate(family, paths[-1], repo=repo,
                                        baseline_path=paths[-2])
        ok = ok and families[family]["ok"]
    return {"kind": "regress", "ok": ok, "families": families}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("family", choices=sorted(FAMILIES) + ["all"])
    p.add_argument("candidate", nargs="?", default="",
                   help="fresh artifact to gate (omitted in 'all' mode)")
    p.add_argument("--repo", default=".",
                   help="repo root holding the committed baselines")
    p.add_argument("--baseline", default="",
                   help="explicit baseline artifact (default: newest "
                        "committed round)")
    p.add_argument("--out", default="",
                   help="also write the verdict JSON here (REGRESS_rN.json)")
    args = p.parse_args(argv)

    try:
        if args.family == "all":
            verdict = run_all(repo=args.repo)
        else:
            if not args.candidate:
                p.error(f"family {args.family!r} needs a candidate artifact")
            verdict = run_gate(args.family, args.candidate, repo=args.repo,
                               baseline_path=args.baseline)
    except (OSError, ValueError) as e:
        p.error(str(e))
    if args.out:
        tmp = f"{args.out}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(verdict, f, indent=1)
        os.replace(tmp, args.out)
    print(json.dumps(verdict, indent=1))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
