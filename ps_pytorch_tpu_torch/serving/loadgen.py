"""Synthetic load generation + latency accounting for the serving engine:
the JAX package's ``serving/loadgen.py``.

Two drive modes, per the usual serving-bench taxonomy:

- **closed loop** (``run_closed_loop``): all requests present at t0, the
  engine drains them as fast as slots allow — measures aggregate decode
  THROUGHPUT (tokens/sec) and is deterministic (same seeds, same tokens at
  every slot count).
- **open loop** (``run_open_loop``): Poisson arrivals submitted through an
  ``AdmissionQueue`` while a ``serve_loop`` thread drains it — measures
  LATENCY under load including queueing (TTFT/p50/p99) and exercises
  backpressure/shedding. Wall-clock heavy, so its soak test is ``slow``.

``summarize`` turns resolved requests into the stats dict both modes
report. ``run_slo_sweep`` stacks open-loop rungs into a rising-offered-load
ladder judged against an ``--slo-spec`` and reports the knee +
goodput-under-SLO.
"""

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ps_pytorch_tpu_torch.serving.engine import (Request, ServingEngine,
                                                 serve_loop)
from ps_pytorch_tpu_torch.serving.queue import AdmissionQueue
from ps_pytorch_tpu_torch.serving.reqtrace import record_terminal
from ps_pytorch_tpu_torch.telemetry.slo import check_slo, parse_slo_spec


def make_requests(n: int, *, prompt_len: int, n_new: int, vocab: int,
                  seed: int = 0, temperature: float = 0.8,
                  top_k: int = 40) -> List[Request]:
    """n deterministic requests (prompts drawn from ``seed``; request i
    samples with seed ``seed + i`` so replays are bit-reproducible)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = rng.integers(0, vocab, size=prompt_len).astype(np.int32)
        reqs.append(Request(prompt=prompt, n_new=n_new,
                            temperature=temperature, top_k=top_k,
                            seed=seed + i, rid=f"lg-{i}"))
    return reqs


# Below this many completed requests, tail percentiles are suppressed —
# np.percentile would happily interpolate a "p99" out of 3 samples, and an
# SLO bound on that number would be noise dressed as a verdict.
MIN_PERCENTILE_SAMPLES = 5


def summarize(requests: List[Request], wall_s: float,
              min_samples: int = MIN_PERCENTILE_SAMPLES) -> Dict:
    """Latency/throughput stats over RESOLVED requests. Only ``done``
    requests contribute latency percentiles (``None`` below
    ``min_samples`` of them); shed/rejected are counted.
    ``availability`` is ``completed / (requests - rejected)`` — rejection
    is backpressure the caller observed immediately, not a request the
    engine accepted and then failed, so it doesn't burn availability."""
    done = [r for r in requests if r.state == "done"]
    out = {
        "requests": len(requests),
        "completed": len(done),
        "shed": sum(r.state == "shed" for r in requests),
        "rejected": sum(r.state == "rejected" for r in requests),
        "failed": sum(r.state == "failed" for r in requests),
        "wall_s": float(wall_s),
        "tokens": int(sum(len(r.tokens) for r in done)),
    }
    out["tokens_per_sec"] = out["tokens"] / wall_s if wall_s > 0 else 0.0
    eligible = out["requests"] - out["rejected"]
    out["availability"] = (out["completed"] / eligible if eligible > 0
                           else None)
    pctls = {"ttft_p50_ms": None, "ttft_p99_ms": None,
             "latency_p50_ms": None, "latency_p99_ms": None,
             "queue_wait_p99_ms": None}
    if len(done) >= max(1, min_samples):
        ttft = np.array([r.t_first - r.t_submit for r in done])
        lat = np.array([r.t_done - r.t_submit for r in done])
        pctls.update(
            ttft_p50_ms=float(np.percentile(ttft, 50) * 1e3),
            ttft_p99_ms=float(np.percentile(ttft, 99) * 1e3),
            latency_p50_ms=float(np.percentile(lat, 50) * 1e3),
            latency_p99_ms=float(np.percentile(lat, 99) * 1e3),
        )
        admitted = [r for r in done if r.t_admit]
        if len(admitted) >= max(1, min_samples):
            qw = np.array([r.t_admit - r.t_submit for r in admitted])
            pctls["queue_wait_p99_ms"] = float(np.percentile(qw, 99) * 1e3)
    out.update(pctls)
    return out


def run_closed_loop(engine: ServingEngine, requests: List[Request]) -> Dict:
    """Drain ``requests`` through the engine inline (no threads, no queue):
    the deterministic throughput measurement."""
    t0 = engine.clock()
    for r in requests:
        r.t_submit = t0
    engine.run_to_completion(requests)
    return summarize(requests, engine.clock() - t0)


def run_open_loop(engine: ServingEngine, requests: List[Request], *,
                  rate_rps: float, max_queue: int = 64,
                  deadline_s: Optional[float] = None,
                  arrival_seed: int = 0, timeout_s: float = 120.0) -> Dict:
    """Submit ``requests`` at Poisson-spaced arrivals (``rate_rps``) into an
    AdmissionQueue drained by a ``serve_loop`` thread; returns ``summarize``
    stats over the whole set once every request resolves."""
    queue = AdmissionQueue(max_queue, clock=engine.clock,
                           registry=engine.registry,
                           reqtrace=engine.reqtrace, slo=engine.slo)
    stop = threading.Event()
    loop = threading.Thread(
        target=serve_loop, args=(engine, queue),
        kwargs=dict(reload_s=0.0, stop=stop, clock=engine.clock),
        daemon=True)
    loop.start()
    rng = np.random.default_rng(arrival_seed)
    gaps = rng.exponential(1.0 / rate_rps, size=len(requests))
    t0 = engine.clock()
    try:
        for req, gap in zip(requests, gaps):
            time.sleep(float(gap))
            req.t_submit = engine.clock()
            if deadline_s is not None:
                req.deadline_t = req.t_submit + deadline_s
            queue.submit(req)
        for req in requests:
            if not req.wait(timeout_s):
                # First-wins CAS: the serve loop may resolve concurrently;
                # only the winner records the terminal sample.
                if req._resolve("failed", "loadgen timeout"):
                    record_terminal(req, reqtrace=engine.reqtrace,
                                    slo=engine.slo, now=engine.clock())
    finally:
        stop.set()
        loop.join(timeout=10.0)
    return summarize(requests, engine.clock() - t0)


def http_post_generate(url: str, body: Dict,
                       timeout_s: float = 30.0) -> tuple:
    """POST one /v1/generate body to ``url``; returns (status, response).
    Status 0 means the connection itself failed — client-visible
    unavailability, the thing the router exists to prevent."""
    import json
    import urllib.error
    import urllib.request
    data = json.dumps(body).encode("utf-8")
    req = urllib.request.Request(
        url + "/v1/generate", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            payload = json.loads(e.read() or b"{}")
        except ValueError:
            payload = {}
        return e.code, payload
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        return 0, {"error": str(e)}


def run_http_open_loop(url: str, n: int, *, rate_rps: float,
                       prompt_len: int = 8, n_new: int = 16,
                       vocab: int = 256, seed: int = 0,
                       deadline_s: float = 30.0,
                       timeout_s: float = 60.0) -> Dict:
    """Open-loop Poisson load over HTTP — the fleet drill's client.

    Unlike ``run_open_loop`` (in-process, one engine) this drives a real
    listener — a replica or the router — with one thread per in-flight
    request, so arrivals stay open-loop: a slow or dead backend does NOT
    slow the arrival process, it grows the in-flight set (exactly the
    regime where failover and hedging matter). Request ``i`` samples with
    seed ``seed + i``, so replays are bit-reproducible end to end.

    Returns client-side stats: per-status counts, strict availability
    (completed / sent), and latency percentiles over completed requests.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    prompts = [rng.integers(0, vocab, size=prompt_len).tolist()
               for _ in range(n)]
    results: List[Optional[tuple]] = [None] * n
    lat = [0.0] * n

    def fire(i: int) -> None:
        body = {"tokens": prompts[i], "n_new": n_new, "seed": seed + i,
                "deadline_s": deadline_s}
        t0 = time.monotonic()
        results[i] = http_post_generate(url, body, timeout_s=timeout_s)
        lat[i] = time.monotonic() - t0

    threads = []
    t_start = time.monotonic()
    for i in range(n):
        time.sleep(float(gaps[i]))
        th = threading.Thread(target=fire, args=(i,), daemon=True,
                              name=f"lg-http-{i}")
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=timeout_s + 10.0)
    wall = time.monotonic() - t_start
    status_counts: Dict[str, int] = {}
    for r in results:
        code = "none" if r is None else str(r[0])
        status_counts[code] = status_counts.get(code, 0) + 1
    done = [i for i, r in enumerate(results)
            if r is not None and r[0] == 200]
    failed_5xx = sum(v for k, v in status_counts.items()
                     if k in ("none", "0") or k.startswith("5"))
    out = {
        "requests": n,
        "completed": len(done),
        "failed_5xx": int(failed_5xx),
        "status_counts": status_counts,
        "wall_s": float(wall),
        "offered_rps": float(rate_rps),
        "availability": len(done) / n if n else None,
        "latency_p50_ms": None, "latency_p99_ms": None,
    }
    if len(done) >= MIN_PERCENTILE_SAMPLES:
        ls = np.array([lat[i] for i in done])
        out["latency_p50_ms"] = float(np.percentile(ls, 50) * 1e3)
        out["latency_p99_ms"] = float(np.percentile(ls, 99) * 1e3)
    return out


def run_slo_sweep(engine: ServingEngine, slo_spec: str, *,
                  rates: Sequence[float], n_req: int = 24,
                  prompt_len: int = 32, n_new: int = 32,
                  deadline_s: Optional[float] = None, max_queue: int = 64,
                  seed: int = 0, timeout_s: float = 120.0) -> Dict:
    """The SLO harness: a rising-offered-load Poisson ladder that finds the
    KNEE — the max arrival rate still meeting every objective in
    ``slo_spec`` — and reports goodput-under-SLO (tokens/sec at the knee
    rung) as the headline.

    Each rung runs ``run_open_loop`` at one offered rate over fresh
    deterministic requests (rung r uses sampling seeds ``seed + 1000*r``,
    so rungs never share a key chain) and is judged offline by
    ``telemetry.slo.check_slo`` over its ``summarize`` stats — the rung IS
    the window. The knee is the highest compliant rate; a rung that can't
    prove compliance (percentiles suppressed for lack of samples, or any
    objective missed) doesn't count. ``ok`` is False when NO rung complied
    — the SLO is unachievable at every offered rate tried, which is a
    finding, not a crash."""
    objectives = parse_slo_spec(slo_spec)
    if not objectives:
        raise ValueError(f"slo_spec {slo_spec!r} has no objectives")
    rates = sorted(float(r) for r in rates)
    if not rates or rates[0] <= 0:
        raise ValueError(f"rates must be positive (got {rates})")
    ladder = []
    for rung, rate in enumerate(rates):
        reqs = make_requests(n_req, prompt_len=prompt_len, n_new=n_new,
                             vocab=engine.vocab, seed=seed + 1000 * rung)
        stats = run_open_loop(engine, reqs, rate_rps=rate,
                              max_queue=max_queue, deadline_s=deadline_s,
                              arrival_seed=seed + 1000 * rung,
                              timeout_s=timeout_s)
        verdict = check_slo(stats, objectives)
        ladder.append({"rate_rps": rate, **stats, "slo": verdict})
    knee = None
    for rung in ladder:
        if rung["slo"]["compliant"]:
            knee = rung
    return {
        "slo_spec": slo_spec,
        "objectives": [o.to_dict() for o in objectives],
        "n_req_per_rung": int(n_req),
        "ladder": ladder,
        "knee_rps": None if knee is None else knee["rate_rps"],
        "goodput_under_slo_tps": (None if knee is None
                                  else knee["tokens_per_sec"]),
        "ok": knee is not None,
    }
