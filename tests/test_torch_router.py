"""The port's fleet serving plane (``ps_pytorch_tpu_torch/serving/router.py``
and friends) against the JAX package's, on the CPU:
``tests/test_router.py``'s cases on the port's modules.

The control-plane pieces (FileKV, FleetRegistrar, FleetView) run on
in-process KVs with a ManualClock. The Router's failover, hedging and
rolling reload run against real in-process port ServingFrontends on real
sockets. Across packages: the registrars write the same keys and record
bytes, so a JAX FleetView reads the port's replicas in one FileKV
directory and the port's FleetView reads the JAX ones. A ``replica_kill``
replica (``python -m ps_pytorch_tpu_torch.serve --device cpu`` as a
subprocess) SIGKILLs itself and the router fails over with every request
done.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ps_pytorch_tpu.models.transformer import TransformerLM as JaxLM
from ps_pytorch_tpu.resilience import faults as jax_faults
from ps_pytorch_tpu.runtime import coordinator as jax_coordinator
from ps_pytorch_tpu.serving import router as jax_router
from ps_pytorch_tpu_torch import config
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.resilience import faults as port_faults
from ps_pytorch_tpu_torch.resilience.faults import FaultInjector, ManualClock
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime import lm_eval
from ps_pytorch_tpu_torch.runtime.coordinator import FileKV, KVStore
from ps_pytorch_tpu_torch.serving.engine import Request, ServingEngine
from ps_pytorch_tpu_torch.serving.reload import CheckpointWatcher
from ps_pytorch_tpu_torch.serving.router import (
    FleetRegistrar, FleetView, Router,
)
from ps_pytorch_tpu_torch.serving.server import ServingFrontend
from ps_pytorch_tpu_torch.telemetry.registry import (
    Registry, declare_router_metrics, declare_serving_metrics,
)
from test_torch_train import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
V, D, L, H, S = 61, 32, 2, 2, 96


@pytest.fixture(scope="module")
def params():
    model = JaxLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H,
                  max_seq_len=S)
    return jax.device_get(model.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
        positions=jnp.arange(8))["params"])


def _model(params):
    m = TransformerLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H,
                      max_seq_len=S)
    m.load_state_dict(convert.from_jax(params))
    return m


def _engine(params, slots, **kw):
    return ServingEngine(_model(params), slots=slots, **kw)


def _post(url, body, timeout=60):
    req = urllib.request.Request(
        f"{url}/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---- FileKV ----

def test_filekv_roundtrip_and_keys(tmp_path):
    kv = FileKV(str(tmp_path / "kv"))
    assert kv.get("missing") is None
    assert kv.get("missing", "dflt") == "dflt"
    kv.set("serve/f/replica/0", "a")
    kv.set("serve/f/replica/1", "b")
    kv.set("serve/f/hb/0", "c")
    assert kv.get("serve/f/replica/0") == "a"
    assert kv.keys("serve/f/replica/") == ["serve/f/replica/0",
                                           "serve/f/replica/1"]
    kv.set("serve/f/replica/0", "a2")
    assert kv.get("serve/f/replica/0") == "a2"
    kv.delete("serve/f/replica/0")
    kv.delete("serve/f/replica/0")          # idempotent
    assert kv.get("serve/f/replica/0") is None
    assert kv.keys("serve/f/replica/") == ["serve/f/replica/1"]


def test_filekv_shared_across_instances_and_packages(tmp_path):
    a = FileKV(str(tmp_path / "kv"))
    b = jax_coordinator.FileKV(str(tmp_path / "kv"))
    a.set("k/with/slashes and spaces", "v")
    assert b.get("k/with/slashes and spaces") == "v"
    assert b.keys("k/") == ["k/with/slashes and spaces"]
    b.set("k/other", "w")
    assert a.keys("k/") == ["k/other", "k/with/slashes and spaces"]


# ---- replica_kill fault ----

def test_replica_kill_spec_parse_and_validate():
    inj = FaultInjector("replica_kill:served=20,r=1", process_index=1)
    assert inj.faults == jax_faults.FaultInjector(
        "replica_kill:served=20,r=1", process_index=1).faults
    assert inj.faults[0]["served"] == 20 and inj.faults[0]["r"] == 1
    assert FaultInjector("replica_kill:served=5").faults[0]["r"] == 0
    for bad, needle in (("replica_kill:r=0", "served"),
                        ("replica_nuke:served=5", "unknown fault kind")):
        msgs = []
        for mod in (port_faults, jax_faults):
            with pytest.raises(ValueError, match=needle) as e:
                mod.FaultInjector(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("mod", [port_faults, jax_faults],
                         ids=["port", "jax"])
def test_replica_kill_gates_and_fires_once(monkeypatch, mod, capsys):
    kills = []
    monkeypatch.setattr(mod.os, "kill",
                        lambda pid, sig: kills.append((pid, sig)))
    other = mod.FaultInjector("replica_kill:served=3,r=1", process_index=0)
    other.maybe_kill_replica(100)
    assert kills == [] and other.counters["replica_kills"] == 0
    inj = mod.FaultInjector("replica_kill:served=3,r=1", process_index=1)
    inj.maybe_kill_replica(2)
    assert kills == []
    inj.maybe_kill_replica(3)
    inj.maybe_kill_replica(50)
    assert len(kills) == 1 and inj.counters["replica_kills"] == 1
    assert capsys.readouterr().out == \
        "FAULT replica_kill: SIGKILL replica 1 after 3 served\n"


# ---- FleetRegistrar ----

def test_registrar_record_lease_and_incarnation():
    clock, kv = ManualClock(), KVStore()
    reg = FleetRegistrar(kv, "f", 2, clock=clock.time)
    rec = reg.register(url="http://127.0.0.1:9", model_step=5)
    assert rec["incarnation"] == 0 and rec["state"] == "ready"
    stored = json.loads(kv.get("serve/f/replica/2"))
    assert stored["url"] == "http://127.0.0.1:9"
    assert stored["model_step"] == 5
    step, _ = json.loads(kv.get("serve/f/hb/2"))
    assert step == 5
    reg.set_state("draining")
    assert json.loads(kv.get("serve/f/replica/2"))["state"] == "draining"
    reg2 = FleetRegistrar(kv, "f", 2, clock=clock.time)
    assert reg2.register(url="http://127.0.0.1:9")["incarnation"] == 1
    reg2.deregister()
    assert kv.get("serve/f/replica/2") is None
    assert kv.get("serve/f/hb/2") is None


def test_registrar_beat_is_throttled():
    clock, kv = ManualClock(), KVStore()
    reg = FleetRegistrar(kv, "f", 0, lease_interval_s=1.0, clock=clock.time)
    reg.register(url="u")
    assert not reg.beat(1)
    clock.advance(1.5)
    assert reg.beat(2)


def _register_script(mod, kv_dir, clock):
    """Two replicas' lifecycle through package ``mod``'s registrar on a
    FileKV directory: every key and file byte after each step."""
    kv = (FileKV if mod is None else jax_coordinator.FileKV)(kv_dir)
    reg_cls = FleetRegistrar if mod is None else mod.FleetRegistrar
    r0 = reg_cls(kv, "v", 0, clock=clock.time)
    r1 = reg_cls(kv, "v", 1, clock=clock.time)
    dumps = []

    def dump():
        dumps.append({name: open(os.path.join(kv_dir, name), "rb").read()
                      for name in sorted(os.listdir(kv_dir))})

    r0.register(url="http://127.0.0.1:7001", model_step=3)
    r1.register(url="http://127.0.0.1:7002", model_step=3, state="starting")
    dump()
    clock.advance(2.0)
    r1.set_state("ready", model_step=4)
    r0.beat(3)
    dump()
    reg_cls(kv, "v", 0, clock=clock.time).register(url="http://h:7003")
    dump()
    r1.deregister()
    dump()
    return dumps


def test_registrar_record_bytes_equal_jax(tmp_path):
    mine = _register_script(None, str(tmp_path / "a"), ManualClock(5.0))
    theirs = _register_script(jax_router, str(tmp_path / "b"),
                              ManualClock(5.0))
    assert mine == theirs
    assert any(name.startswith("serve") for name in mine[0])


def test_fleetviews_read_each_others_replicas(tmp_path):
    """One FileKV directory, one replica registered by each package: the
    port's FleetView and the JAX one see the same two ready backends."""
    clock = ManualClock(100.0)
    kv_dir = str(tmp_path / "kv")
    FleetRegistrar(FileKV(kv_dir), "v", 0, clock=clock.time).register(
        url="http://127.0.0.1:7001", model_step=2)
    jax_router.FleetRegistrar(jax_coordinator.FileKV(kv_dir), "v", 1,
                              clock=clock.time).register(
        url="http://127.0.0.1:7002", model_step=2)
    views = [FleetView(FileKV(kv_dir), "v", clock=clock.time, probe=False),
             jax_router.FleetView(jax_coordinator.FileKV(kv_dir), "v",
                                  clock=clock.time, probe=False)]
    seen = [sorted((b.id, b.url, b.state, b.model_step, b.incarnation)
                   for b in v.poll()) for v in views]
    assert seen[0] == seen[1] and [s[0] for s in seen[0]] == [0, 1]
    clock.advance(10.0)                    # both leases go stale
    assert [v.poll() for v in views] == [[], []]


# ---- FleetView ----

def _view(kv, clock, **kw):
    kw.setdefault("probe", False)
    return FleetView(kv, "f", lease_timeout_s=3.0, clock=clock.time, **kw)


def test_fleetview_gates_on_state_and_lease():
    clock, kv = ManualClock(), KVStore()
    r0 = FleetRegistrar(kv, "f", 0, clock=clock.time)
    r1 = FleetRegistrar(kv, "f", 1, clock=clock.time)
    r0.register(url="http://h:1")
    r1.register(url="http://h:2", state="starting")
    view = _view(kv, clock)
    assert [b.id for b in view.poll()] == [0]
    r1.set_state("ready")
    assert {b.id for b in view.poll()} == {0, 1}
    clock.advance(10.0)
    r0.beat(0)
    assert [b.id for b in view.poll()] == [0]
    dead = next(b for b in view.backends() if b.id == 1)
    assert not dead.lease_fresh and dead.state == "ready"
    r0.set_state("draining")
    assert view.poll() == []


def test_fleetview_preserves_identity_until_incarnation_bump():
    clock, kv = ManualClock(), KVStore()
    FleetRegistrar(kv, "f", 0, clock=clock.time).register(url="http://h:1")
    view = _view(kv, clock)
    b1 = view.poll()[0]
    b1.outstanding = 7
    assert view.poll()[0] is b1 and b1.outstanding == 7
    FleetRegistrar(kv, "f", 0, clock=clock.time).register(url="http://h:1")
    b2 = view.poll()[0]
    assert b2 is not b1 and b2.outstanding == 0 and b2.incarnation == 1


def test_fleetview_eject_counts_once():
    clock, kv = ManualClock(), KVStore()
    FleetRegistrar(kv, "f", 0, clock=clock.time).register(url="http://h:1")
    view = _view(kv, clock)
    b = view.poll()[0]
    view.eject(b)
    view.eject(b)
    assert view.ejections == 1 and not b.ready


# ---- Router over real in-process replicas ----

def _fleet(params, n, kv, registry=None):
    fes = []
    for rid in range(n):
        fe = ServingFrontend(_engine(params, 2), port=0, max_queue=8,
                             registrar=FleetRegistrar(kv, "f", rid))
        fe.start()
        fes.append(fe)
    return fes


def test_router_routes_and_balances(params, tmp_path):
    kv = FileKV(str(tmp_path / "kv"))
    fes = _fleet(params, 2, kv)
    view = FleetView(kv, "f", lease_timeout_s=30.0)
    registry = declare_router_metrics(Registry())
    router = Router(view, retries=2, backoff_s=0.01, registry=registry)
    try:
        assert len(view.poll()) == 2
        body = {"tokens": [1, 2, 3], "n_new": 5, "seed": 4,
                "temperature": 0.7, "top_k": 5}
        outs = [router.route(body) for _ in range(4)]
        assert all(code == 200 for code, _ in outs)
        toks = [o["tokens"] for _, o in outs]
        assert all(t == toks[0] for t in toks)
        assert {fe.engine.served > 0 for fe in fes} == {True}
        assert router.counters["requests"] == 4
        assert router.counters["failed"] == 0
        assert registry.snapshot()["router_requests"] == 4
    finally:
        for fe in fes:
            fe.stop()


def test_router_fails_over_dead_backend(params, tmp_path):
    kv = FileKV(str(tmp_path / "kv"))
    fes = _fleet(params, 1, kv)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    FleetRegistrar(kv, "f", 1).register(url=f"http://127.0.0.1:{dead_port}")
    view = FleetView(kv, "f", lease_timeout_s=30.0, probe=False)
    router = Router(view, retries=3, backoff_s=0.01)
    try:
        view.poll()
        body = {"tokens": [1, 2, 3], "n_new": 4, "seed": 0}
        for _ in range(4):
            code, out = router.route(body)
            assert code == 200, out
        assert router.counters["failed"] == 0
        assert router.counters["retries"] >= 1
        assert view.ejections >= 1
    finally:
        fes[0].stop()


def test_router_hedge_beats_straggler(params, tmp_path):
    kv = FileKV(str(tmp_path / "kv"))
    fes = _fleet(params, 1, kv)
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    held = []

    def _hold():
        try:
            while True:
                conn, _ = lsock.accept()
                held.append(conn)
        except OSError:
            pass

    threading.Thread(target=_hold, daemon=True).start()
    FleetRegistrar(kv, "f", 1).register(
        url=f"http://127.0.0.1:{lsock.getsockname()[1]}")
    view = FleetView(kv, "f", lease_timeout_s=30.0, probe=False)
    router = Router(view, retries=1, backoff_s=0.01, hedge_s=0.05,
                    request_timeout_s=20.0)
    try:
        view.poll()
        real = next(b for b in view.backends() if b.id == 0)
        straggler = next(b for b in view.backends() if b.id == 1)
        real.outstanding = 1
        code, out = router.route({"tokens": [1, 2, 3], "n_new": 4,
                                  "seed": 0})
        real.outstanding = 0
        assert code == 200
        assert router.counters["hedges"] >= 1
        assert router.counters["hedge_wins"] >= 1
        assert router.counters["hedge_cancelled"] >= 1
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and straggler.outstanding:
            time.sleep(0.01)
        assert straggler.outstanding == 0
    finally:
        lsock.close()
        for c in held:
            c.close()
        fes[0].stop()


def test_router_503_when_no_backends(tmp_path):
    view = FleetView(FileKV(str(tmp_path / "kv")), "f")
    router = Router(view, retries=1, backoff_s=0.01)
    code, out = router.route({"tokens": [1], "n_new": 1})
    assert code == 503 and "no ready backends" in out["error"]
    assert router.counters["failed"] == 1


def test_router_does_not_retry_client_errors(params, tmp_path):
    kv = FileKV(str(tmp_path / "kv"))
    fes = _fleet(params, 2, kv)
    view = FleetView(kv, "f", lease_timeout_s=30.0)
    router = Router(view, retries=3, backoff_s=0.01)
    try:
        view.poll()
        code, out = router.route({"tokens": [1, 2], "n_new": 0})
        assert code == 400
        assert router.counters["retries"] == 0
    finally:
        for fe in fes:
            fe.stop()


def test_router_http_front_end(params, tmp_path):
    """The router's own listener: /v1/generate forwards, /healthz lists
    the backends, /metrics renders the router counters."""
    kv = FileKV(str(tmp_path / "kv"))
    fes = _fleet(params, 1, kv)
    view = FleetView(kv, "f", lease_timeout_s=30.0)
    router = Router(view, retries=1, backoff_s=0.01,
                    registry=declare_router_metrics(Registry()), port=0)
    router.start()
    try:
        url = f"http://127.0.0.1:{router.port}"
        code, out = _post(url, {"tokens": [1, 2, 3], "n_new": 3,
                                "temperature": 0.0})
        assert code == 200 and len(out["tokens"]) == 3
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert [b["id"] for b in health["backends"]] == [0]
        with urllib.request.urlopen(f"{url}/metrics", timeout=10) as r:
            assert "router_requests_total 1" in r.read().decode()
    finally:
        router.stop()
        fes[0].stop()


# ---- replica readiness / drain / reload plane ----

def test_readyz_and_drain_resume(params):
    with ServingFrontend(_engine(params, 2), port=0, max_queue=4) as fe:
        url = f"http://127.0.0.1:{fe.port}"
        with urllib.request.urlopen(f"{url}/readyz", timeout=10) as r:
            body = json.loads(r.read())
            assert r.status == 200 and body["ready"] and \
                body["state"] == "ready"
        req = urllib.request.Request(f"{url}/admin/drain", data=b"")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["state"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{url}/readyz", timeout=10)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["state"] == "draining"
        code, out = _post(url, {"tokens": [1, 2], "n_new": 2})
        assert code == 503
        req = urllib.request.Request(f"{url}/admin/resume", data=b"")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["state"] == "ready"
        code, out = _post(url, {"tokens": [1, 2], "n_new": 2})
        assert code == 200


def test_drain_shed_is_retryable_503(params):
    eng = _engine(params, 1)
    fe = ServingFrontend(eng, port=0, max_queue=8)
    fe.start()
    url = f"http://127.0.0.1:{fe.port}"
    results = []

    def _go():
        results.append(_post(url, {"tokens": [1, 2, 3], "n_new": 60,
                                   "seed": 1}))

    threads = [threading.Thread(target=_go) for _ in range(4)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and fe.queue.depth() < 2:
        time.sleep(0.001)
    fe.drain()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    codes = sorted(c for c, _ in results)
    assert set(codes) <= {200, 503}
    assert 503 in codes
    fe.stop()


def test_frontend_stop_resolves_queued_and_inflight(params):
    eng = _engine(params, 1)
    fe = ServingFrontend(eng, port=0, max_queue=8)
    fe.start()
    url = f"http://127.0.0.1:{fe.port}"
    results = []

    def _go():
        try:
            results.append(_post(url, {"tokens": [1, 2, 3], "n_new": 80,
                                       "seed": 1}, timeout=30))
        except (urllib.error.URLError, ConnectionError, OSError):
            results.append((0, {}))

    threads = [threading.Thread(target=_go) for _ in range(5)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and \
            (eng.active_count == 0 or fe.queue.depth() < 2):
        time.sleep(0.001)
    fe.stop(drain_timeout_s=20.0)
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 5
    assert fe.state == "dead"
    assert eng.active_count == 0 and fe.queue.depth() == 0
    assert all(c in (0, 200, 503) for c, _ in results)


def _lm_cfg(train_dir):
    return config.TrainConfig(network="TransformerLM", lm_vocab=V,
                              lm_d_model=D, lm_layers=L, lm_heads=H,
                              lm_seq_len=S, train_dir=str(train_dir))


def _template(cfg):
    staging, _ = lm_eval.build_lm_oracle(cfg)
    return staging, lm_eval.build_lm_template(cfg, staging)


def _save(cfg, step, params, corrupt=None):
    m = _model(params)
    tree = convert.state_to_jax(m, lm_eval.build_lm_template(cfg, m), step)
    path = ckpt.save_checkpoint(cfg.train_dir, step, tree,
                                config_json=cfg.to_json())
    if corrupt:
        port_faults.corrupt_file(os.path.join(path, "state.msgpack"),
                                 corrupt)
    return path


def test_rolling_reload_advances_model_step(params, tmp_path):
    cfg = _lm_cfg(tmp_path / "ckpt")
    _save(cfg, 1, params)
    kv = FileKV(str(tmp_path / "kv"))
    fes = []
    for rid in range(2):
        watcher = CheckpointWatcher(cfg.train_dir, _template(cfg),
                                    start_step=1)
        fe = ServingFrontend(
            _engine(params, 2, model_step=1), watcher=watcher, port=0,
            max_queue=8, registrar=FleetRegistrar(kv, "f", rid))
        fe.start()
        fes.append(fe)
    view = FleetView(kv, "f", lease_timeout_s=30.0)
    router = Router(view, retries=2, backoff_s=0.01)
    try:
        assert len(view.poll()) == 2
        _save(cfg, 2, params)
        results = router.roll_reload(settle_timeout_s=20.0)
        assert [r["ok"] for r in results] == [True, True]
        assert [r["reloaded"] for r in results] == [True, True]
        assert all(fe.engine.model_step == 2 for fe in fes)
        assert all(fe.state == "ready" for fe in fes)
        code, _ = router.route({"tokens": [1, 2], "n_new": 2})
        assert code == 200 and router.counters["failed"] == 0
    finally:
        for fe in fes:
            fe.stop()


# ---- terminal-resolution CAS ----

def test_request_resolve_first_wins():
    req = Request(prompt=np.ones(3, np.int32), n_new=2)
    assert req._resolve("done")
    assert not req._resolve("failed", "late")
    assert req.state == "done" and not req.error
    assert req.wait(0.1)


def test_lost_race_counted(params):
    registry = declare_serving_metrics(Registry())
    eng = _engine(params, 1, registry=registry)
    req = Request(prompt=np.ones(3, np.int32), n_new=2)
    eng.admit(req)
    assert req._resolve("failed", "server wait timeout")
    while eng.active_count:
        eng.step()
    assert req.state == "failed"
    assert registry.snapshot()["serve_resolve_races"] == 1
    assert eng.served == 0


# ---- body-size bound ----

def _raw_http(port, raw: bytes) -> int:
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(raw)
        data = s.recv(1024)
    return int(data.split(b" ", 2)[1])


def test_body_size_bound_and_oversize_counter(params):
    registry = declare_serving_metrics(Registry())
    eng = _engine(params, 1, registry=registry)
    with ServingFrontend(eng, port=0, max_queue=4,
                         max_body_bytes=256) as fe:
        url = f"http://127.0.0.1:{fe.port}"
        code, out = _post(url, {"tokens": [1] * 500, "n_new": 1})
        assert code == 413 and "body" in out["error"]
        assert registry.snapshot()["serve_rejected_oversize"] == 1
        assert _raw_http(fe.port, b"POST /v1/generate HTTP/1.1\r\n"
                                  b"Host: x\r\n\r\n") == 400
        assert _raw_http(fe.port, b"POST /v1/generate HTTP/1.1\r\n"
                                  b"Host: x\r\nContent-Length: ha\r\n\r\n") \
            == 400
        code, out = _post(url, {"tokens": [1, 2], "n_new": 2})
        assert code == 200
        assert fe.stats()["served"] == 1


# ---- corrupt-skip accounting ----

def test_skipped_corrupt_counted_once_per_step(params, tmp_path):
    cfg = _lm_cfg(tmp_path)
    _save(cfg, 2, params, corrupt="truncate")
    watcher = CheckpointWatcher(cfg.train_dir, _template(cfg), start_step=1)
    for _ in range(5):
        assert watcher.poll() is None
    assert watcher.skipped_corrupt == 1
    _save(cfg, 3, params, corrupt="truncate")
    for _ in range(3):
        assert watcher.poll() is None
    assert watcher.skipped_corrupt == 2
    assert watcher.reloads == 0


# ---- replica_kill: a real replica process SIGKILLs itself ----

def _replica(train_dir, kv_dir, rid, fault=""):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    args = [sys.executable, "-m", "ps_pytorch_tpu_torch.serve",
            "--device", "cpu", "--train-dir", train_dir, "--serve-port", "0",
            "--serve-slots", "2", "--serve-kv-dir", kv_dir,
            "--serve-fleet", "f", "--serve-replica-id", str(rid)]
    if fault:
        args += ["--fault-spec", fault]
    return subprocess.Popen(args, cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_replica_kill_is_failed_over_with_every_request_done(params,
                                                             tmp_path):
    cfg = _lm_cfg(tmp_path / "td")
    _save(cfg, 3, params)
    kv_dir = str(tmp_path / "kv")
    procs = [_replica(cfg.train_dir, kv_dir, 0),
             _replica(cfg.train_dir, kv_dir, 1, "replica_kill:served=3,r=1")]
    try:
        firsts = [json.loads(p.stdout.readline()) for p in procs]
        assert [f["replica_id"] for f in firsts] == [0, 1]
        view = FleetView(FileKV(kv_dir), "f", lease_timeout_s=30.0)
        router = Router(view, retries=3, backoff_s=0.01)
        assert len(view.poll()) == 2
        outs = [router.route({"tokens": [1, 2, 3], "n_new": 4,
                              "temperature": 0.0}) for _ in range(12)]
        assert [code for code, _ in outs] == [200] * 12
        assert all(o["tokens"] == outs[0][1]["tokens"] for _, o in outs)
        assert procs[1].wait(timeout=30) == -9
        assert "FAULT replica_kill: SIGKILL replica 1 after 3 served" \
            in procs[1].stdout.read()
        assert router.counters["retries"] >= 1
        assert router.counters["failed"] == 0
        killed = next(b for b in view.backends() if b.id == 1)
        assert not killed.ready and view.ejections >= 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        assert procs[0].wait(timeout=60) == 0
