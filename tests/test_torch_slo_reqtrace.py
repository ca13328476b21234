"""The port's request-scoped serving observability against the JAX
package's, on the CPU: ``tests/test_slo_reqtrace.py``'s cases on
``ps_pytorch_tpu_torch/telemetry/slo.py`` and ``serving/reqtrace.py``.

Each case runs the same inputs on the same manual clock through both
packages' modules and holds the port's outputs equal to the JAX module's:
``parse_slo_spec`` (objectives and error messages), ``WindowPercentile``,
``SLOTracker.evaluate`` through its ok -> page -> recovery transitions,
the trace ring's keep decisions (tail sampling by ``_hash_frac``),
``chrome_events`` (which the JAX package's ``analyze stitch`` joins) and
``format_requests_table``. On a real engine run with the whole plane
attached the tokens stay ``generate``'s and the phases partition the
latency exactly; the queue's shed-on-submit and reap, ``summarize`` and
the SLO sweep, and the /slo and /debug/requests routes complete it.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ps_pytorch_tpu.models.transformer import TransformerLM as JaxLM
from ps_pytorch_tpu.serving import engine as jax_engine
from ps_pytorch_tpu.serving import reqtrace as jax_reqtrace
from ps_pytorch_tpu.telemetry import health as jax_health
from ps_pytorch_tpu.telemetry import registry as jax_registry
from ps_pytorch_tpu.telemetry import slo as jax_slo
from ps_pytorch_tpu_torch import config
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.generate import generate
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.resilience.faults import ManualClock
from ps_pytorch_tpu_torch.serving import engine as port_engine
from ps_pytorch_tpu_torch.serving import reqtrace as port_reqtrace
from ps_pytorch_tpu_torch.serving.engine import Request, ServingEngine
from ps_pytorch_tpu_torch.serving.loadgen import (
    make_requests, run_closed_loop, run_slo_sweep, summarize,
)
from ps_pytorch_tpu_torch.serving.queue import AdmissionQueue
from ps_pytorch_tpu_torch.serving.reqtrace import (
    RequestTraceLog, _hash_frac, corr_id, format_requests_table,
    trace_from_request,
)
from ps_pytorch_tpu_torch.telemetry import health as port_health
from ps_pytorch_tpu_torch.telemetry import registry as port_registry
from ps_pytorch_tpu_torch.telemetry import slo as port_slo
from ps_pytorch_tpu_torch.telemetry.registry import (
    Registry, declare_serving_metrics,
)
from ps_pytorch_tpu_torch.telemetry.slo import (
    SLOTracker, WindowPercentile, check_slo, parse_slo_spec,
)
from test_torch_train import two_torch_threads  # noqa: F401

V, D, L, H, S = 61, 32, 2, 2, 96
# (slo, reqtrace, engine, registry, health) of each package.
PORT = (port_slo, port_reqtrace, port_engine, port_registry, port_health)
JAX = (jax_slo, jax_reqtrace, jax_engine, jax_registry, jax_health)


@pytest.fixture(scope="module")
def model():
    jm = JaxLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H,
               max_seq_len=S)
    params = jax.device_get(jm.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
        positions=jnp.arange(8))["params"])
    m = TransformerLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H,
                      max_seq_len=S)
    m.load_state_dict(convert.from_jax(params))
    return m


def _both(fn):
    """fn(package modules) on each package -> (port's, JAX's)."""
    return fn(PORT), fn(JAX)


# ---- telemetry/slo.py: the --slo-spec grammar ----

_SPECS = ["ttft_p99<100ms; latency_p99<2s;availability>=99.5",
          "queue_wait_p50<=2500us", "latency_p90<1.5s;ttft_p99.9<250ms",
          "availability>99", ""]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_slo_spec_equals_jax(spec):
    mine, theirs = _both(lambda m: [
        (o.to_dict(), o.budget_frac) for o in m[0].parse_slo_spec(spec)])
    assert mine == theirs


def test_parse_slo_spec_full():
    objs = parse_slo_spec(_SPECS[0])
    assert [o.name for o in objs] == ["ttft_p99", "latency_p99",
                                      "availability"]
    assert objs[0].threshold == pytest.approx(0.1)     # ms -> s
    assert objs[1].threshold == pytest.approx(2.0)
    assert objs[2].threshold == 99.5 and objs[2].percentile is None
    assert objs[0].budget_frac == pytest.approx(0.01)
    assert objs[2].budget_frac == pytest.approx(0.005)
    (o,) = parse_slo_spec("queue_wait_p50<=2500us")
    assert o.check(2.5e-3) is True and o.check(2.6e-3) is False
    assert o.check(None) is None


@pytest.mark.parametrize("bad", [
    "p99<100ms", "loss_p99<1s", "ttft_p0<1s", "ttft_p99<0ms",
    "ttft_p99>100ms", "availability>=0", "availability>=101",
    "ttft_p99<1s;ttft_p99<2s", "garbage"])
def test_parse_slo_spec_rejects_like_jax(bad):
    msgs = []
    for mod in (port_slo, jax_slo):
        with pytest.raises(ValueError) as e:
            mod.parse_slo_spec(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_config_validates_slo_knobs():
    cfg = config.TrainConfig(slo_spec="ttft_p99<100ms", reqtrace_keep=8,
                             reqtrace_sample=0.5)
    assert cfg.slo_spec == "ttft_p99<100ms"
    with pytest.raises(ValueError, match="SLO|slo"):
        config.TrainConfig(slo_spec="bogus_p99<1s")
    with pytest.raises(ValueError, match="reqtrace"):
        config.TrainConfig(reqtrace_keep=-1)
    with pytest.raises(ValueError, match="reqtrace"):
        config.TrainConfig(reqtrace_sample=1.5)


# ---- telemetry/slo.py: WindowPercentile ----

def _window_run(m):
    clk = ManualClock()
    w = m[0].WindowPercentile(10.0, clock=clk.time)
    for i in range(10):
        w.observe(float(i), now=float(i))
    out = [w.count(now=9.0), w.percentile(50.0, now=9.0),
           w.percentile(99.0, now=9.0, min_n=20), w.frac_over(6.5, now=9.0),
           w.count(now=15.1), w.frac_over(100.0, now=30.0)]
    small = m[0].WindowPercentile(1e9, clock=clk.time, max_samples=64)
    for i in range(1000):
        small.observe(float(i), now=0.0)
    return out + [small.count(now=0.0), small.percentile(90.0, now=0.0)]


def test_window_percentile_equals_jax():
    mine, theirs = _both(_window_run)
    assert mine == theirs
    assert mine[:6] == [10, pytest.approx(4.5), None, pytest.approx(0.3),
                        4, None]
    assert mine[6] == 64
    with pytest.raises(ValueError):
        WindowPercentile(0.0)


# ---- telemetry/slo.py: burn-rate state machine ----

def _tracker_run(m):
    clk = ManualClock()
    registry = m[3].declare_serving_metrics(m[3].Registry())
    t = m[0].SLOTracker("ttft_p99<100ms;availability>=99", clock=clk.time,
                        fast_window_s=60.0, slow_window_s=300.0,
                        min_samples=10, registry=registry)
    evs = []
    t.observe_request(ttft_s=0.01, latency_s=0.02, now=0.0)
    evs.append(t.evaluate(now=0.0))
    for i in range(20):
        t.observe_request(ttft_s=0.01, latency_s=0.02, now=1.0 + i)
    evs.append(t.evaluate(now=21.0))
    for i in range(20):
        t.observe_request(ttft_s=0.5, latency_s=0.6, now=22.0 + i)
    evs.append(t.evaluate(now=42.0))
    for i in range(30):
        t.observe_request(ttft_s=0.01, latency_s=0.02, now=120.0 + i)
    evs.append(t.evaluate(now=160.0))
    t.observe_request(outcome="rejected", now=161.0)
    t.observe_request(outcome="shed", now=162.0)
    evs.append(t.evaluate(now=163.0))
    snap = registry.snapshot()
    return evs, t.violations, {k: snap[k] for k in (
        "slo_compliance", "slo_burn_rate", "slo_violations")}


def test_slo_tracker_evaluate_equals_jax():
    mine, theirs = _both(_tracker_run)
    assert json.dumps(mine, sort_keys=True) == json.dumps(theirs,
                                                          sort_keys=True)
    evs = mine[0]
    assert evs[0]["state"] == "ok"
    assert evs[0]["objectives"][0]["compliant"] is None     # < min_samples
    assert evs[1]["state"] == "ok" and evs[1]["compliance"] == 1.0
    assert evs[2]["state"] == "page" and evs[2]["burn_rate"] > 2.0
    assert mine[1] >= 20
    rec = evs[3]["objectives"][0]
    assert rec["burn_fast"] == pytest.approx(0.0) and rec["burn_slow"] > 0
    assert rec["state"] == "ok"


def test_slo_tracker_availability_and_rejected():
    clk = ManualClock()
    t = SLOTracker("ttft_p99<100ms;availability>=99", clock=clk.time,
                   fast_window_s=60.0, slow_window_s=300.0, min_samples=10)
    for i in range(18):
        t.observe_request(outcome="done", ttft_s=0.01, latency_s=0.02,
                          now=float(i))
    t.observe_request(outcome="rejected", now=18.0)
    t.observe_request(outcome="shed", now=19.0)
    t.observe_request(outcome="shed", now=20.0)
    ev = t.evaluate(now=21.0)
    avail = next(r for r in ev["objectives"]
                 if r["metric"] == "availability")
    assert avail["value"] == pytest.approx(90.0)
    assert avail["compliant"] is False
    assert avail["samples_slow"] == 20


def test_slo_tracker_registry_gauges_idempotent_with_serving_contract():
    clk = ManualClock()
    registry = declare_serving_metrics(Registry())
    t = SLOTracker("ttft_p99<100ms", clock=clk.time, registry=registry,
                   min_samples=5)
    t2 = SLOTracker("ttft_p99<100ms", registry=Registry())
    assert t2.observed == 0
    for i in range(10):
        t.observe_request(ttft_s=0.5, latency_s=0.5, now=float(i))
    t.evaluate(now=10.0)
    snap = registry.snapshot()
    assert snap["slo_compliance"] == 0.0
    assert snap["slo_burn_rate"] > 2.0
    assert snap["slo_violations"] == 10


def test_check_slo_equals_jax():
    cases = [{"latency_p99_ms": 150.0, "availability": 1.0},
             {"latency_p99_ms": None, "availability": 1.0},
             {"latency_p99_ms": 150.0, "availability": 0.98},
             {"latency_p99_ms": 2500.0, "availability": 1.0}]
    mine, theirs = _both(lambda m: [m[0].check_slo(
        c, m[0].parse_slo_spec("latency_p99<2s;availability>=99"))
        for c in cases])
    assert mine == theirs
    assert [v["compliant"] for v in mine] == [True, False, False, False]


# ---- serving/reqtrace.py: phase partition + tail sampling ----

def _req(m, rid, state="done", t=(1.0, 1.0, 2.0, 3.0, 5.0, 6.0), tokens=3):
    """A request of package ``m`` with an explicit (submit, enqueue,
    admit, first, last, done) timeline."""
    r = m[2].Request(prompt=np.ones(4, np.int32), n_new=8, rid=rid)
    r.state = state
    r.t_submit, r.t_enqueue, r.t_admit, r.t_first, r.t_last, r.t_done = t
    r.tokens = list(range(tokens))
    r.tick_t = [3.0, 4.0, 5.0][:tokens]
    return r


def _partitions(m):
    out = []
    for args, now in (((m, "a"), None),
                      ((m, "b", "shed", (1.0, 1.0, 0.0, 0.0, 0.0, 0.0), 0),
                       4.0),
                      ((m, "c", "failed", (1.0, 1.0, 2.0, 0.0, 0.0, 6.0), 0),
                       None)):
        out.append(m[1].trace_from_request(_req(*args), now=now).to_dict())
    return out


def test_trace_phase_partition_equals_jax():
    mine, theirs = _both(_partitions)
    assert mine == theirs
    done = trace_from_request(_req(PORT, "a"))
    assert done.queue_wait_s == pytest.approx(1.0)
    assert done.prefill_s == pytest.approx(1.0)
    assert done.decode_s == pytest.approx(2.0)
    assert done.stream_out_s == pytest.approx(1.0)
    assert done.latency_s == pytest.approx(5.0)
    for row in mine:
        assert (row["queue_wait_s"] + row["prefill_s"] + row["decode_s"]
                + row["stream_out_s"]) == pytest.approx(row["latency_s"])
    assert mine[1]["outcome"] == "shed" and mine[1]["t_done"] == 4.0
    assert mine[1]["queue_wait_s"] == pytest.approx(3.0)


def _ring(m, sample=0.25):
    log = m[1].RequestTraceLog(64, sample=sample, min_window=10)
    for i in range(40):
        log.offer_request(_req(m, f"r{i}", t=(0.0, 0.0, 0.1, 0.2, 0.3, 0.4)))
    log.offer_request(_req(m, "slowpoke", t=(0.0, 0.0, 1.0, 2.0, 90.0,
                                             91.0)))
    for state in ("shed", "rejected", "failed"):
        log.offer_request(_req(m, f"x-{state}", state=state, tokens=0),
                          now=50.0)
    return log


def test_ring_keep_decisions_equal_jax():
    mine, theirs = _both(lambda m: (
        [(t.rid, t.kept) for t in _ring(m).traces()], _ring(m).stats()))
    assert mine == theirs
    kept = dict(mine[0])
    for state in ("shed", "rejected", "failed"):
        assert kept[f"x-{state}"] == "outcome"
    assert kept["slowpoke"] == "slow"
    for rid, why in kept.items():
        if why == "sampled":
            assert _hash_frac(rid) < 0.25
    st = mine[1]
    assert st["offered"] == 44
    assert st["kept"] == len(kept) and st["dropped"] == 44 - len(kept)
    assert st["by_outcome"]["done"] == 41
    assert [_hash_frac(f"r{i}") for i in range(40)] == \
        [jax_reqtrace._hash_frac(f"r{i}") for i in range(40)]


def test_ring_bounded_and_validates():
    log = RequestTraceLog(4, sample=1.0)
    for i in range(10):
        log.offer_request(_req(PORT, f"r{i}"))
    assert len(log.traces()) == 4          # oldest evicted
    assert log.stats()["offered"] == 10
    for kw in (dict(keep=0), dict(keep=4, sample=1.5),
               dict(keep=4, slow_frac=0.0)):
        msgs = []
        for mod in (port_reqtrace, jax_reqtrace):
            with pytest.raises(ValueError) as e:
                mod.RequestTraceLog(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_chrome_events_and_table_equal_jax():
    def run(m):
        log = m[1].RequestTraceLog(8, sample=1.0)
        log.offer_request(_req(m, "abc"))
        log.offer_request(_req(m, "def", state="shed",
                               t=(1.0, 1.0, 0.0, 0.0, 0.0, 0.0), tokens=0),
                          now=2.5)
        return (log.chrome_events(pid=3),
                m[1].format_requests_table(log.snapshot()), log.snapshot())
    mine, theirs = _both(run)
    assert mine == theirs
    evs = [e for e in mine[0] if e["args"]["corr"] == "req/abc"]
    assert evs[0]["name"] == "request"
    assert {e["name"] for e in evs[1:]} == {
        "req_queue_wait", "req_prefill", "req_decode", "req_stream_out"}
    assert all(e["pid"] == 3 and e["ph"] == "X" for e in evs)
    assert corr_id("abc") == "req/abc"
    assert evs[0]["ts"] == pytest.approx(1e6)
    assert evs[0]["dur"] == pytest.approx(5e6)
    lines = mine[1].splitlines()
    assert lines[0].split()[:2] == ["rid", "outcome"]
    assert "abc" in lines[2] and "done" in lines[2]


def test_jax_stitch_joins_the_port_request_spans():
    """The JAX package's ``analyze stitch`` joins the port's request
    spans to the port engine's ``serve_admit`` / ``serve_decode`` spans."""
    from ps_pytorch_tpu.tools.analyze import stitch_chrome_traces
    from ps_pytorch_tpu_torch.telemetry.trace import Tracer, set_default_tracer
    model = TransformerLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H,
                          max_seq_len=S)
    log = RequestTraceLog(8, sample=1.0)
    eng = ServingEngine(model, slots=2, reqtrace=log)
    tracer = Tracer(pid=1)
    prev = set_default_tracer(tracer)
    try:
        eng.run_to_completion([Request(prompt=np.ones(3, np.int32), n_new=3,
                                       rid="abc")])
    finally:
        set_default_tracer(prev)
    doc = {"traceEvents": log.chrome_events(pid=0)
           + tracer.chrome_events()}
    merged, n_flows = stitch_chrome_traces([doc])
    assert merged["metadata"]["request_flows"] == n_flows == 3  # admit + 2


# ---- E2E: traced engine keeps parity, monotone lifecycle, exact phases --

def test_engine_with_full_plane_parity_and_invariants(model):
    registry = declare_serving_metrics(Registry())
    reqtrace = RequestTraceLog(64, sample=1.0)
    slo = SLOTracker("ttft_p99<60s;latency_p99<120s;availability>=99",
                     registry=registry, min_samples=3)
    eng = ServingEngine(model, slots=2, registry=registry, reqtrace=reqtrace,
                        slo=slo)
    specs = [dict(n_new=7, temperature=0.8, top_k=7, seed=3, plen=5),
             dict(n_new=1, temperature=1.3, top_k=5, seed=9, plen=3),
             dict(n_new=10, temperature=0.0, top_k=0, seed=4, plen=8)]
    rng = np.random.default_rng(0)
    reqs, refs = [], []
    for i, s in enumerate(specs):
        prompt = rng.integers(0, V, size=s["plen"]).astype(np.int32)
        reqs.append(Request(prompt=prompt, n_new=s["n_new"],
                            temperature=s["temperature"], top_k=s["top_k"],
                            seed=s["seed"], rid=f"e{i}"))
        refs.append(generate(model, prompt[None], n_new=s["n_new"],
                             temperature=s["temperature"], top_k=s["top_k"],
                             seed=s["seed"])[0, s["plen"]:].tolist())
    run_closed_loop(eng, reqs)
    for req, ref in zip(reqs, refs):
        assert req.state == "done" and req.tokens == ref
    traces = {t.rid: t for t in reqtrace.traces()}
    assert len(traces) == len(reqs)
    for req in reqs:
        tr = traces[req.rid]
        stamps = [t for t in (tr.t_submit, tr.t_enqueue, tr.t_admit,
                              tr.t_first, tr.t_last, tr.t_done) if t]
        assert stamps == sorted(stamps) and len(stamps) >= 5
        assert (tr.queue_wait_s + tr.prefill_s + tr.decode_s
                + tr.stream_out_s) == pytest.approx(tr.latency_s, abs=1e-9)
        assert len(tr.ticks) == tr.n_tokens == len(req.tokens)
        assert tr.ticks == sorted(tr.ticks)
    ev = slo.evaluate()
    assert ev["observed"] == len(reqs) and ev["state"] == "ok"
    assert registry.snapshot()["slo_compliance"] == 1.0
    assert registry.hist_summary("serve_queue_wait_s")["count"] == len(reqs)


# ---- queue: shed on submit / reap ----

def _qreq(rid, deadline_t=None):
    r = Request(prompt=np.ones(4, np.int32), n_new=4, rid=rid)
    r.t_submit = 0.0
    r.deadline_t = deadline_t
    return r


def test_queue_submit_reaps_expired_and_frees_depth():
    clk = ManualClock()
    reqtrace = RequestTraceLog(16, sample=1.0)
    q = AdmissionQueue(2, clock=clk.time, reqtrace=reqtrace)
    a, b = _qreq("a", deadline_t=5.0), _qreq("b", deadline_t=5.0)
    assert q.submit(a) and q.submit(b)
    clk.advance(10.0)
    c = _qreq("c")
    assert q.submit(c) is True
    assert a.state == "shed" and b.state == "shed"
    assert c.state == "queued" and q.depth() == 1
    assert q.shed_deadline == 2 and q.rejected_full == 0
    kept = {t.rid: t.outcome for t in reqtrace.traces()}
    assert kept == {"a": "shed", "b": "shed"}


def test_queue_reap_resolves_without_take():
    clk = ManualClock()
    q = AdmissionQueue(4, clock=clk.time)
    a = _qreq("a", deadline_t=1.0)
    b = _qreq("b")
    assert q.submit(a) and q.submit(b)
    clk.advance(2.0)
    assert q.reap() == 1
    assert a.state == "shed" and a.wait(timeout=0)
    assert b.state == "queued" and q.depth() == 1
    assert q.take() is b


def test_queue_reject_records_terminal():
    clk = ManualClock()
    reqtrace = RequestTraceLog(16, sample=1.0)
    q = AdmissionQueue(1, clock=clk.time, reqtrace=reqtrace)
    assert q.submit(_qreq("a"))
    r = _qreq("b")
    assert q.submit(r) is False
    assert r.state == "rejected"
    assert [t.outcome for t in reqtrace.traces()] == ["rejected"]


# ---- loadgen: summarize hardening + the SLO sweep ----

def _done_req(i, ttft=0.01, lat=0.05):
    r = Request(prompt=np.ones(4, np.int32), n_new=4, rid=f"d{i}")
    r.state = "done"
    r.tokens = [1, 2, 3]
    r.t_submit, r.t_admit = 10.0 * i, 10.0 * i + 0.001
    r.t_first, r.t_done = 10.0 * i + ttft, 10.0 * i + lat
    return r


def test_summarize_suppresses_percentiles_below_min_samples():
    stats = summarize([_done_req(i) for i in range(3)], wall_s=1.0)
    assert stats["completed"] == 3
    for k in ("ttft_p50_ms", "ttft_p99_ms", "latency_p50_ms",
              "latency_p99_ms", "queue_wait_p99_ms"):
        assert k in stats and stats[k] is None
    stats = summarize([_done_req(i) for i in range(5)], wall_s=1.0)
    assert stats["ttft_p99_ms"] == pytest.approx(10.0, rel=0.01)
    assert stats["queue_wait_p99_ms"] == pytest.approx(1.0, rel=0.01)


def test_summarize_availability():
    reqs = [_done_req(i) for i in range(8)]
    shed = Request(prompt=np.ones(4, np.int32), n_new=4, rid="s")
    shed.state, shed.t_submit = "shed", 0.0
    rej = Request(prompt=np.ones(4, np.int32), n_new=4, rid="j")
    rej.state, rej.t_submit = "rejected", 0.0
    stats = summarize(reqs + [shed, rej], wall_s=1.0)
    assert stats["availability"] == pytest.approx(8 / 9)
    assert summarize([rej], wall_s=1.0)["availability"] is None


def test_run_slo_sweep_finds_knee(model):
    eng = ServingEngine(model, slots=2)
    run_closed_loop(eng, make_requests(2, prompt_len=4, n_new=2, vocab=V,
                                       seed=777))
    sweep = run_slo_sweep(eng, "latency_p99<60s;availability>=99",
                          rates=(40.0, 80.0), n_req=5, prompt_len=4,
                          n_new=3, seed=5, timeout_s=60.0)
    assert [r["rate_rps"] for r in sweep["ladder"]] == [40.0, 80.0]
    for rung in sweep["ladder"]:
        assert rung["completed"] == 5
        assert rung["slo"]["compliant"] is True
    assert sweep["knee_rps"] == 80.0 and sweep["ok"] is True
    assert sweep["goodput_under_slo_tps"] == pytest.approx(
        sweep["ladder"][-1]["tokens_per_sec"])
    with pytest.raises(ValueError):
        run_slo_sweep(eng, "latency_p99<60s", rates=())
    with pytest.raises(ValueError):
        run_slo_sweep(eng, "", rates=(1.0,))


def test_slo_sweep_overload_rung_breaks(model):
    """A tight deadline and a tiny queue shed requests at an overloaded
    rung, which reads non-compliant (the knee is real, not vacuous)."""
    eng = ServingEngine(model, slots=1)
    sweep = run_slo_sweep(eng, "availability>=99;latency_p99<60s",
                          rates=(2000.0,), n_req=12, prompt_len=8,
                          n_new=12, deadline_s=0.001, max_queue=2,
                          seed=11, timeout_s=60.0)
    top = sweep["ladder"][-1]
    assert top["shed"] + top["rejected"] > 0
    assert top["slo"]["compliant"] is False and sweep["ok"] is False


# ---- server: /slo + /debug/requests routes ----

def test_http_slo_and_debug_requests(model):
    from ps_pytorch_tpu_torch.serving.server import ServingFrontend

    registry = declare_serving_metrics(Registry())
    reqtrace = RequestTraceLog(32, sample=1.0)
    slo = SLOTracker("ttft_p99<60s;availability>=99", registry=registry,
                     min_samples=1)
    eng = ServingEngine(model, slots=2, registry=registry, reqtrace=reqtrace,
                        slo=slo)
    with ServingFrontend(eng, port=0, max_queue=4) as fe:
        url = f"http://127.0.0.1:{fe.port}"
        body = json.dumps({"tokens": [1, 2, 3], "n_new": 3,
                           "temperature": 0.0}).encode()
        req = urllib.request.Request(
            f"{url}/v1/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
        with urllib.request.urlopen(f"{url}/slo", timeout=10) as resp:
            ev = json.loads(resp.read())
        assert ev["state"] == "ok" and ev["observed"] >= 1
        assert {r["name"] for r in ev["objectives"]} == {"ttft_p99",
                                                         "availability"}
        with urllib.request.urlopen(f"{url}/debug/requests",
                                    timeout=10) as resp:
            dbg = json.loads(resp.read())
        assert dbg["stats"]["kept"] >= 1
        assert dbg["requests"][0]["outcome"] == "done"
        assert dbg["requests"][0]["n_tokens"] == 3
        with urllib.request.urlopen(f"{url}/debug/requests?text=1",
                                    timeout=10) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            assert "outcome" in resp.read().decode()
        with urllib.request.urlopen(f"{url}/metrics", timeout=10) as resp:
            text = resp.read().decode()
        for name in ("serve_queue_wait_s_bucket", "slo_compliance",
                     "slo_burn_rate", "slo_violations_total"):
            assert name in text
    eng2 = ServingEngine(model, slots=1)
    with ServingFrontend(eng2, port=0, max_queue=4) as fe:
        url = f"http://127.0.0.1:{fe.port}"
        for route in ("/slo", "/debug/requests"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{url}{route}", timeout=10)
            assert ei.value.code == 404


# ---- telemetry/health.py: the steptime watchdog on slo's window ----

def _steptime_run(m):
    clk = ManualClock()
    h = m[4].HealthMonitor("steptime:warn,p99_s=0.5,min_n=5,window_s=60",
                           clock=clk.time)
    trips = []
    for phase, (n, st) in enumerate(((10, 0.1), (10, 1.0), (70, 0.1),
                                     (10, 1.0))):
        for i in range(n):
            clk.advance(1.0)
            trips += [(phase, e.step, e.threshold) for e in h.observe_step(
                len(trips) * 1000 + phase * 100 + i + 1, loss=1.0,
                step_time=st, now=clk.now) if e.detector == "steptime"]
    return trips


def test_health_steptime_rising_edge_latch_equals_jax():
    assert port_health.WindowPercentile is port_slo.WindowPercentile
    mine, theirs = _both(_steptime_run)
    assert mine == theirs
    assert [p for p, _, _ in mine] == [1, 3]      # one trip an excursion
    assert mine[0][2] == pytest.approx(0.5)
