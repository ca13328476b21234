"""The port's ops plane (ps_pytorch_tpu_torch/telemetry/ and
runtime/ops_plane.py) against the JAX package's, on the CPU: the tracer,
the STEP line and JSONL keys of a LeNet run in each package, the
Prometheus text, the health grammar and detectors, the flight dump and the
cross-process timeline read by the JAX readers, and the port's Trainer
with the exporter, the watchdogs and an injected peak for ``mfu``."""

import datetime
import json
import math
import re
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ps_pytorch_tpu import telemetry as jax_tel
from ps_pytorch_tpu.config import TrainConfig as JaxTrainConfig
from ps_pytorch_tpu.runtime import metrics as jax_metrics
from ps_pytorch_tpu_torch import config, telemetry
from ps_pytorch_tpu_torch.runtime import Trainer
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.coordinator import DistributedKV, KVStore
from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer
from test_torch_train import two_torch_threads  # noqa: F401

FIELDS = ("trace_file", "timeline_file", "metrics_port", "health_spec",
          "flight_file", "profile_dir", "profile_steps")
OPS_VALUES = dict(trace_file="t.json", timeline_file="tl.jsonl",
                  metrics_port=9100, health_spec="nonfinite:halt",
                  flight_file="f.json", profile_dir="prof",
                  profile_steps="3-4")


@pytest.fixture(autouse=True)
def no_default_tracer():
    """A trainer installs its tracer until train() ends; put back none."""
    yield
    telemetry.set_default_tracer(None)
    jax_tel.set_default_tracer(None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _lenet(tmp_path, **kw) -> dict:
    base = dict(dataset="synthetic_mnist", network="LeNet", batch_size=64,
                lr=0.01, momentum=0.9, max_steps=3, epochs=0, eval_freq=0,
                train_dir=str(tmp_path / "ckpt"), compute_dtype="float32",
                log_every=1, seed=3, resume=False)
    base.update(kw)
    return base


# ---- tracer ----

def test_span_nesting_summary_and_chrome_json(tmp_path):
    tr = telemetry.Tracer(pid=3, process_name="hostA")
    with tr.span("outer", step=1):
        with tr.span("inner", step=1, bytes=5):
            pass
    with tr.span("outer", step=2):
        pass
    inner, outer = tr.spans()[:2]
    assert [e["name"] for e in tr.spans()] == ["inner", "outer", "outer"]
    assert outer["t0"] <= inner["t0"] and \
        outer["t0"] + outer["dur"] >= inner["t0"] + inner["dur"]
    assert set(tr.step_summary(1)) == {"outer", "inner"}
    assert set(tr.step_summary(2)) == {"outer"} and tr.step_summary(9) == {}
    assert tr.totals()["outer"]["count"] == 2
    doc = json.loads(open(tr.write_chrome_trace(
        str(tmp_path / "t.json"))).read())
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert meta[0]["args"]["name"] == "hostA" and len(spans) == 3
    assert spans[0]["args"] == {"bytes": 5, "step": 1}
    assert all(e["pid"] == 3 and e["cat"] == "host" for e in spans)


def test_ambient_span_records_only_with_a_default_tracer():
    with telemetry.span("x") as sargs:
        assert sargs is None
    tr = telemetry.Tracer()
    prev = telemetry.set_default_tracer(tr)
    try:
        with telemetry.span("checkpoint_write", step=4) as sargs:
            sargs["n"] = 1
    finally:
        telemetry.set_default_tracer(prev)
    assert tr.spans()[0]["args"] == {"n": 1} and tr.step_summary(4)


# ---- STEP line and JSONL keys: the same LeNet run in each package ----

def _keys(path):
    recs = [json.loads(line) for line in open(path)]
    return recs, [(sorted(r), sorted(r["phases"])) for r in recs]


def test_step_lines_and_jsonl_keys_match_jax_trainer(tmp_path, capsys):
    from ps_pytorch_tpu.runtime import Trainer as JaxTrainer

    JaxTrainer(JaxTrainConfig(**_lenet(
        tmp_path / "jax", data_axis=8,
        metrics_file=str(tmp_path / "jax.jsonl")))).train()
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("STEP")]
    ours = []
    Trainer(config.TrainConfig(**_lenet(
        tmp_path / "port", metrics_file=str(tmp_path / "port.jsonl"))),
        device="cpu", printer=ours.append).train()
    ours = [ln for ln in ours if ln.startswith("STEP")]
    shape = re.compile(r"[-\d.]+(e-?\d+)?")
    assert [shape.sub("#", ln) for ln in ours] == \
        [shape.sub("#", ln) for ln in jax_lines]
    assert all(jax_metrics.parse_line(ln)["mfu"] is None for ln in ours)
    port_recs, port_keys = _keys(tmp_path / "port.jsonl")
    _, jax_keys = _keys(tmp_path / "jax.jsonl")
    assert port_keys == jax_keys and len(port_keys) == 3
    assert set(port_recs[0]["phases"]) == {
        "data_wait", "coordinator_mask", "host_dispatch", "device_sync",
        "metrics_sync"}


# ---- prometheus ----

def _fill(mod):
    r = mod.Registry()
    mod.declare_training_metrics(r)
    r.counter("steps.done", unit="steps", help="completed\nsteps")
    r.histogram("lat_s", unit="s", help="latency", buckets=(0.1, 0.5, 1.0))
    r.inc("train_steps", 3)
    r.inc("steps.done", 2)
    r.set("train_loss", 0.25)
    r.set("device_mem_peak_bytes", 123456789)
    for v in (0.05, 0.3, 0.7, 2.0):
        r.observe("lat_s", v)
        r.observe("train_step_latency_s", v / 10)
    return r


def test_render_is_byte_equal_to_jax_and_jax_parses_it():
    from ps_pytorch_tpu.telemetry import registry as jax_registry

    ours = telemetry.render_prometheus(_fill(telemetry))
    assert ours == jax_tel.render_prometheus(_fill(jax_registry))
    samples = jax_tel.parse_exposition(ours)
    assert samples == telemetry.parse_exposition(ours)
    assert samples["train_steps_total"] == 3
    assert samples['lat_s_bucket{le="+Inf"}'] == 4
    assert samples["steps_done_total"] == 2
    for bad in ("no-value-line", "9bad_name 1"):
        with pytest.raises(ValueError):
            telemetry.parse_exposition(bad)
    r = telemetry.Registry()
    r.gauge("a.b")
    r.gauge("a/b")
    with pytest.raises(ValueError, match="collision"):
        telemetry.render_prometheus(r)
    assert telemetry.sanitize_name("0abc") == jax_tel.sanitize_name("0abc")


def test_exporter_serves_metrics_and_healthz():
    r = _fill(telemetry)
    calls, health = [], {"ok": True}
    with telemetry.MetricsExporter(r, health_fn=lambda: health,
                                   collect=[lambda: calls.append(1)]) as ex:
        url = f"http://127.0.0.1:{ex.port}"
        with urllib.request.urlopen(f"{url}/metrics", timeout=10) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            text = resp.read().decode()
        assert calls and jax_tel.parse_exposition(text)[
            "train_steps_total"] == 3
        health["ok"] = False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{url}/healthz", timeout=10)
        assert ei.value.code == 503


# ---- health ----

@pytest.mark.parametrize("spec", [
    "nonfinite:skip;spike:halt,factor=5;stall,min_s=2", "",
    "nonfinite:halt;spike:warn,factor=10;stall:warn",
    "divergence:halt,warmup=5,factor=1.5,decay=0.0",
    "steptime:warn,p99_s=0.5,min_n=3",
])
def test_health_spec_parses_like_jax(spec):
    assert telemetry.parse_health_spec(spec) == jax_tel.parse_health_spec(spec)


@pytest.mark.parametrize("bad", [
    "gradnorm:halt", "spike:explode", "spike,windowz=3", "spike;spike",
    "spike:skip", "spike,factor=abc", "steptime:warn",
])
def test_health_spec_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        jax_tel.parse_health_spec(bad)
    with pytest.raises(ValueError):
        telemetry.parse_health_spec(bad)
    with pytest.raises(ValueError):
        config.TrainConfig(eval_freq=0, health_spec=bad)


def _events(evs) -> list:
    """The events without their wall-clock stamp, as JSON (NaN compares
    equal to NaN there)."""
    return [json.dumps({k: v for k, v in e.to_dict().items() if k != "t"})
            for e in evs]


SEQUENCES = {
    "nonfinite": ("nonfinite:halt", [dict(loss=1.0, grad_norm=1.0),
                                     dict(loss=float("nan"), grad_norm=1.0),
                                     dict(loss=1.0, nonfinite=1.0)]),
    "spike": ("spike:warn,warmup=5,factor=10",
              [dict(grad_norm=1.0)] * 6 + [dict(grad_norm=50.0),
                                           dict(grad_norm=float("nan")),
                                           dict(grad_norm=1.0)]),
    "divergence": ("divergence:halt,warmup=5,factor=1.5,decay=0.0",
                   [dict(loss=v) for v in (5.0, 4.0, 3.0, 2.0, 1.0, 2.0)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_detector_events_match_jax(name):
    spec, seq = SEQUENCES[name]
    got = []
    for mod in (telemetry, jax_tel):
        h = mod.HealthMonitor(spec, registry=mod.Registry())
        evs = [ev for i, kw in enumerate(seq)
               for ev in h.observe_step(i + 1, **kw)]
        got.append((_events(evs), h.should_halt,
                    h.registry.snapshot()["health_ok"]))
    assert got[0] == got[1] and got[0][0]


def test_stall_and_steptime_match_jax_on_a_fake_clock():
    got = []
    for mod in (telemetry, jax_tel):
        t = [0.0]
        h = mod.HealthMonitor("stall:warn,factor=10,min_s=5,window=8;"
                              "steptime:warn,p99_s=0.5,min_n=3",
                              clock=lambda: t[0])
        evs = []
        for i, dt in enumerate((0.1, 0.1, 0.1, 0.1, 0.1, 0.9, 0.9, 0.1)):
            t[0] += dt
            evs += h.observe_step(i + 1, step_time=dt)
        t[0] += 4.0
        evs.append(h.check_stall())
        t[0] += 2.0
        evs.append(h.check_stall())
        got.append((_events([e for e in evs if e is not None]),
                    h.status()["detectors"]))
    assert got[0] == got[1]
    assert [json.loads(e)["detector"] for e in got[0][0]] == \
        ["steptime", "stall"]


# ---- flight recorder and timeline through the JAX readers ----

def test_flight_dump_is_read_by_jax(tmp_path):
    tr = telemetry.Tracer()
    with tr.span("host_dispatch", step=1):
        pass
    rec = telemetry.FlightRecorder(str(tmp_path / "fr.json"), capacity=4,
                                   tracer=tr, registry=_fill(telemetry),
                                   snapshot_every=2)
    for i in range(6):
        rec.record_step(i + 1, loss=float(i))
    rec.record_event("exception", {"type": "RuntimeError"})
    rec.record_health(telemetry.HealthEvent("nonfinite", "halt", 6,
                                            float("nan"), float("nan"),
                                            "nan"))
    doc = jax_tel.load_flight(rec.dump("watchdog:nonfinite",
                                       extra={"note": 1}))
    assert doc["reason"] == "watchdog:nonfinite"
    assert [s["step"] for s in doc["steps"]] == [3, 4, 5, 6]
    assert doc["health_events"][0]["detector"] == "nonfinite"
    assert doc["spans"][0]["name"] == "host_dispatch"
    assert doc["final_metrics"]["train_steps"] == 3 and doc["extra"]


def test_two_process_timeline_is_read_by_jax(tmp_path):
    kv = KVStore()
    lead, follow = (telemetry.TelemetryAggregator(kv, pid, 2, window=3)
                    for pid in (0, 1))
    path = str(tmp_path / "run.timeline")
    lead.open_timeline(path)
    for step in range(1, 6):
        for agg in (lead, follow):
            agg.publish_step(step, {"step_time": 0.1 * (agg.pid + 1),
                                    "phases": {"data_wait": 0.01}})
        lead.drain_to_file()
    lead.close(final_step=5, timeout_s=1.0)
    rows = jax_tel.read_timeline(path)
    assert [(r["step"], r["process"]) for r in rows] == \
        [(s, p) for s in range(1, 6) for p in (0, 1)]
    assert rows == telemetry.read_timeline(path)
    assert kv.get("run/tel/1/1") is None        # beyond the window


def test_timeline_over_a_tcpstore_never_blocks_on_a_missing_step(tmp_path):
    store = torch.distributed.TCPStore("127.0.0.1", _free_port(), 1, True,
                                       timeout=datetime.timedelta(seconds=30))
    agg = telemetry.TelemetryAggregator(DistributedKV(store), 0, 2)
    agg.open_timeline(str(tmp_path / "tl"))
    agg.publish_step(1, {"step_time": 0.1})
    assert agg.fetch(1, 1) is None and agg.last_published(1) == 0
    agg.close(final_step=1, timeout_s=0.2, poll_s=0.05)  # process 1 never came
    assert [r["process"] for r in jax_tel.read_timeline(
        str(tmp_path / "tl"))] == [0]


# ---- the Trainer on the CPU ----

def test_trainer_exports_metrics_over_http(tmp_path):
    tr = Trainer(config.TrainConfig(**_lenet(
        tmp_path, metrics_port=_free_port(), health_spec="nonfinite:warn")),
        device="cpu", printer=lambda line: None)
    url = f"http://127.0.0.1:{tr.ops.exporter.port}"
    with urllib.request.urlopen(f"{url}/healthz", timeout=10) as resp:
        body = json.loads(resp.read())
    assert body["ok"] is True and body["process_index"] == 0 \
        and body["leader"] is True
    with urllib.request.urlopen(f"{url}/metrics", timeout=10) as resp:
        assert jax_tel.parse_exposition(
            resp.read().decode())["train_steps_total"] == 0
    tr.train()
    assert tr.ops.exporter._httpd is None          # stopped with the run
    after = jax_tel.parse_exposition(
        telemetry.render_prometheus(tr.ops.registry))
    assert after["train_steps_total"] == 3 and after["train_step"] == 3
    assert after["train_step_latency_s_count"] == 3
    assert after["health_ok"] == 1 and after["host_rss_bytes"] > 0
    assert after["device_mem_peak_bytes"] == 0     # the CPU has no stats


def _nan_mask_at(trainer, bad_step: int):
    """The JAX grad_nan fault, by hand: the coordinator's mask is NaN at
    ``bad_step``, so loss, gradients and grad norm are NaN there."""
    decide = trainer.coordinator.participation_mask

    def mask(step, *a, **kw):
        m = np.asarray(decide(step, *a, **kw), np.float32)
        return m * np.nan if step == bad_step else m
    trainer.coordinator.participation_mask = mask


def _params(trainer):
    return {k: v.detach().clone() for k, v in
            trainer.model.named_parameters()}


def test_nonfinite_halt_checkpoints_and_dumps(tmp_path):
    lines = []
    tr = Trainer(config.TrainConfig(**_lenet(
        tmp_path, max_steps=6,
        health_spec="nonfinite:halt;spike:warn")), device="cpu",
        printer=lines.append)
    _nan_mask_at(tr, 3)
    tr.train()
    assert ckpt.committed_steps(tr.cfg.train_dir) == [3]
    assert [ln.split()[1] for ln in lines if ln.startswith("STEP")] == \
        ["1", "2"]
    assert any(ln.startswith("HEALTH nonfinite (halt): non-finite") and
               "at step 3" in ln for ln in lines)
    assert any(ln.startswith("HEALTH halt at step 3") for ln in lines)
    doc = jax_tel.load_flight(str(tmp_path / "ckpt" / "flightrec.json"))
    assert doc["reason"] == "watchdog:nonfinite"
    assert doc["health_events"][-1]["step"] == 3
    assert doc["extra"]["halt"]["detector"] == "nonfinite"


def test_nonfinite_skip_keeps_the_parameters_bitwise(tmp_path):
    tr = Trainer(config.TrainConfig(**_lenet(
        tmp_path, max_steps=5, health_spec="nonfinite:skip")), device="cpu",
        printer=lambda line: None)
    assert tr.step_fn.skip_nonfinite
    _nan_mask_at(tr, 3)
    after, step = [], tr.step_fn

    def spy(*args, **kw):
        out = step(*args, **kw)
        after.append(_params(tr))
        return out
    spy.comm_s = 0.0
    tr.step_fn = spy
    tr.train()
    assert len(after) == 5
    assert all(torch.equal(after[1][k], v) for k, v in after[2].items())
    for prev, cur in ((after[2], after[3]), (after[3], after[4])):
        assert any(not torch.equal(prev[k], v) for k, v in cur.items())
    assert all(torch.isfinite(v).all() for v in after[4].values())
    assert tr.ops.health.trips["nonfinite"] == 1
    assert not tr.ops.health.should_halt


def test_mfu_is_count_over_step_time_and_peak(tmp_path):
    m = tmp_path / "m.jsonl"
    lines = []
    tr = Trainer(config.TrainConfig(**_lenet(tmp_path, metrics_file=str(m))),
                 device="cpu", printer=lines.append)
    tr.ops.peak_per_chip = 1e12                   # injected: the CPU has none
    tr.train()
    assert tr.ops.flops_per_step == 64 * 68_728_000 // 4
    for rec in map(json.loads, open(m)):
        assert rec["mfu"] == round(tr.ops.flops_per_step
                                   / (rec["step_time"] * 1e12), 6)
    assert all(jax_metrics.parse_line(ln)["mfu"] is not None
               for ln in lines if ln.startswith("STEP"))


def test_trace_profile_and_timeline_files(tmp_path):
    cfg = config.TrainConfig(**_lenet(
        tmp_path, max_steps=4, eval_freq=4,
        trace_file=str(tmp_path / "t.json"),
        timeline_file=str(tmp_path / "tl.jsonl"),
        profile_dir=str(tmp_path / "prof"), profile_steps="2-3"))
    tr = Trainer(cfg, device="cpu", printer=lambda line: None)
    tr.train()
    assert telemetry.get_default_tracer() is None
    doc = json.load(open(tmp_path / "t.json"))
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"data_wait", "host_dispatch", "device_sync", "metrics_sync",
            "checkpoint", "checkpoint_write", "coordinator_mask"} <= names
    rows = jax_tel.read_timeline(str(tmp_path / "tl.jsonl"))
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all(r["process"] == 0 and "phases" in r for r in rows)
    prof = json.load(open(tr.ops.profile_files[0]))
    assert tr.ops.profile_files[0].endswith("trace_p0_steps2-3.json")
    assert any(e.get("name", "").startswith("aten::") for e in
               prof["traceEvents"])


def test_crash_dumps_the_flight_recorder(tmp_path):
    tr = Trainer(config.TrainConfig(**_lenet(
        tmp_path, flight_file=str(tmp_path / "f.json"))), device="cpu",
        printer=lambda line: None)

    def boom(*a, **kw):
        raise RuntimeError("loader died")
    tr.train_loader.next_batch = boom
    with pytest.raises(RuntimeError, match="loader died"):
        tr.train()
    doc = jax_tel.load_flight(str(tmp_path / "f.json"))
    assert doc["reason"] == "crash:RuntimeError"
    assert doc["events"][-1]["kind"] == "exception"


def test_lm_trainer_ops_plane(tmp_path):
    m = tmp_path / "lm.jsonl"
    lines = []
    tr = LMTrainer(config.TrainConfig(
        lm_vocab=64, lm_d_model=32, lm_layers=1, lm_heads=2, lm_seq_len=64,
        lm_corpus_tokens=4096, batch_size=8, max_steps=3, eval_freq=0,
        lr=0.01, train_dir=str(tmp_path / "ckpt"), metrics_file=str(m),
        trace_file=str(tmp_path / "t.json"), lm_attention="flash",
        health_spec="nonfinite:halt", resume=False, seed=0), device="cpu",
        printer=lines.append)
    tr.ops.peak_per_chip = 1e12
    tr.train()
    want = config.TrainConfig(network="TransformerLM", eval_freq=0,
                              lm_vocab=64, lm_d_model=32, lm_layers=1,
                              lm_heads=2, lm_seq_len=64, batch_size=8)
    from ps_pytorch_tpu_torch.utils.flops import training_flops
    assert tr.ops.flops_per_step == training_flops(want)
    recs = [json.loads(line) for line in open(m)]
    assert [sorted(r["phases"]) for r in recs] == \
        [["data_wait", "host_dispatch", "metrics_sync"]] * 3
    assert all(r["tokens_per_sec"] > 0 and r["mfu"] == round(
        tr.ops.flops_per_step / (r["step_time"] * 1e12), 6) for r in recs)
    assert not any(ln.startswith("HEALTH") for ln in lines)


def test_lm_halt_dumps_without_a_checkpoint(tmp_path):
    """The halt dumps the flight recorder and commits the step it halts
    at, as the JAX LM trainer does."""
    lines = []
    tr = LMTrainer(config.TrainConfig(
        lm_vocab=64, lm_d_model=32, lm_layers=1, lm_heads=2, lm_seq_len=64,
        lm_corpus_tokens=4096, batch_size=8, max_steps=4, eval_freq=0,
        lr=0.01, train_dir=str(tmp_path / "ckpt"), resume=False,
        health_spec="nonfinite:halt"), device="cpu", printer=lines.append)
    step = tr.step_fn

    def nan_at_2(tokens):
        out = step(tokens)
        nan_at_2.opt_state = step.opt_state     # what the checkpoint saves
        return ({"loss": out["loss"] * math.nan}
                if len(tr.step_times) == 1 else out)
    tr.step_fn = nan_at_2
    tr.train()
    assert len(tr.step_times) == 2
    assert any(ln.startswith("HEALTH halt at step 2") for ln in lines)
    assert jax_tel.load_flight(str(tmp_path / "ckpt" / "flightrec.json"))[
        "reason"] == "watchdog:nonfinite"
    assert ckpt.committed_steps(tr.cfg.train_dir) == [2]


def test_two_ranks_write_the_timeline_and_rank_suffixed_files(tmp_path):
    """Two gloo ranks through the launcher: the timeline defaults to
    ``<metrics_file>.timeline`` (rank 0 merges both ranks' rows over the
    TCPStore), rank 1 writes ``t.json.p1`` and ``m.jsonl.p1``, and each
    rank's exporter binds ``metrics_port + rank``."""
    from ps_pytorch_tpu_torch.tools import launch

    run_dir = tmp_path / "run"
    fields = _lenet(tmp_path, metrics_file=str(tmp_path / "m.jsonl"),
                    trace_file=str(tmp_path / "t.json"),
                    metrics_port=_free_port(), health_spec="nonfinite:warn")
    flags = [arg for k, v in fields.items()
             for arg in (f"--{k.replace('_', '-')}", str(v))]
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")       # ranks share the test's cores
    try:
        rc = launch.main(["launch", "--run-dir", str(run_dir), "--simulate",
                          "2", "--port", str(_free_port()), "--wait",
                          "--timeout", "120", "--grace", "1", "--",
                          "--device", "cpu", *flags])
    finally:
        mp.undo()
        launch.main(["kill", "--run-dir", str(run_dir), "--grace", "1"])
    logs = [(run_dir / f"proc_{r}.log").read_text() for r in range(2)]
    assert rc == 0, "\n\n".join(log[-3000:] for log in logs)
    rows = jax_tel.read_timeline(str(tmp_path / "m.jsonl.timeline"))
    assert [(r["step"], r["process"]) for r in rows] == \
        [(s, p) for s in (1, 2, 3) for p in (0, 1)]
    assert all({"step_time", "data_time", "phases"} <= set(r) for r in rows)
    for suffix in ("", ".p1"):
        doc = json.load(open(f"{tmp_path}/t.json{suffix}"))
        pids = {e["pid"] for e in doc["traceEvents"]}
        assert pids == {1 if suffix else 0}
        assert len(open(f"{tmp_path}/m.jsonl{suffix}").readlines()) == 3


# ---- config ----

@pytest.mark.parametrize("field", FIELDS)
def test_ops_fields_run_in_sync_and_raise_in_async(field):
    kw = {field: OPS_VALUES[field]}
    assert getattr(config.TrainConfig(eval_freq=0, **kw), field) == kw[field]
    with pytest.raises(ValueError, match="ROADMAP.md"):
        config.TrainConfig(eval_freq=0, mode="async", **kw)


@pytest.mark.parametrize("kw", [
    dict(health_spec="bogus:halt"), dict(metrics_port=-1),
    dict(profile_steps="3-x"), dict(profile_steps="5-3"),
    dict(profile_steps="0"),
])
def test_malformed_ops_fields_raise(kw):
    with pytest.raises(ValueError):
        config.TrainConfig(eval_freq=0, **kw)
