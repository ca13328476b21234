"""The port's quorum-replicated KV (``runtime/kvrep.py``) and ``FileKV``
against the JAX package, on the CPU.

- A JAX ``ReplicatedKV`` and a port ``ReplicatedKV`` over the same
  ``dir:`` backends: each reads what the other wrote, the envelopes are
  equal byte for byte, and the same script of operations (backend kill
  and wipe included) leaves both packages' backends with the same files
  and the same counters.
- The JAX package's cases (``tests/test_kvrep.py``: envelopes, quorums,
  read repair, ejection, probation, resync, the per-backend faults, the
  retry plane over the quorum, the HTTP backend and its ``python -m``
  entry, the spec grammar, the config checks, FileKV's fsync order and
  its clean failure), ported.
- The synchronous Trainer, two gloo ranks with ``--elastic
  --elastic-leader 1`` over three backends (two directories and an HTTP
  server) that lose one backend for two steps and have another wiped:
  its parameters equal, bitwise, those of the same run on the static
  control plane, and the JAX ``make_train_step`` fed its masks within
  ``tests/test_torch_train.py``'s tolerance.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from conftest import free_port
from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu import resilience as jax_resilience
from ps_pytorch_tpu.runtime import kvrep as jax_kvrep
from ps_pytorch_tpu.runtime.coordinator import FileKV as JaxFileKV
from ps_pytorch_tpu_torch.config import TrainConfig
from ps_pytorch_tpu_torch.resilience import (
    FaultInjector, ManualClock, RetryBudget, RetryingKV, RetryPolicy,
    TransientKVError, is_retryable, parse_fault_spec,
)
from ps_pytorch_tpu_torch.runtime import kvrep
from ps_pytorch_tpu_torch.runtime.coordinator import FileKV, KVStore
from ps_pytorch_tpu_torch.runtime.kvrep import (
    HttpKV, ReplicatedKV, build_replicated_kv, parse_backend_specs,
    peek_tag, serve_kv, unwrap_value, wrap_value,
)
from ps_pytorch_tpu_torch.utils.armor import WireCorrupt
from test_torch_train import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _rkv(n=3, **kw):
    backends = [KVStore() for _ in range(n)]
    kw.setdefault("clock", ManualClock().time)
    return ReplicatedKV(backends, **kw), backends


class _FlakyKV(KVStore):
    """A backend whose every op raises while ``down``: a killed store."""

    def __init__(self):
        super().__init__()
        self.down = False

    def _gate(self):
        if self.down:
            raise TransientKVError("UNAVAILABLE: backend down (test)")

    def set(self, key, value):
        self._gate()
        super().set(key, value)

    def get(self, key, default=None):
        self._gate()
        return super().get(key, default)

    def delete(self, key):
        self._gate()
        super().delete(key)

    def keys(self, prefix=""):
        self._gate()
        return super().keys(prefix)


def _files(root):
    return {name: (Path(root) / name).read_bytes()
            for name in sorted(os.listdir(root))}


# ---- the two packages over the same directories ----

@pytest.mark.parametrize("value", ["v", "", "two\nlines", "@kvr1 7 p9\nx",
                                   "ünïcode"])
@pytest.mark.parametrize("version,writer", [(1, "p0"), (12, "w3")])
def test_envelope_bytes_equal_jax(value, version, writer):
    env = wrap_value(version, writer, value)
    assert env == jax_kvrep.wrap_value(version, writer, value)
    assert unwrap_value(env) == jax_kvrep.unwrap_value(env)
    assert peek_tag(env) == jax_kvrep.peek_tag(env) == (version, writer)
    for raw in (value, None, "@kvr1 notanint p0\nx", "@kvr1 3 p1"):
        assert unwrap_value(raw) == jax_kvrep.unwrap_value(raw)
        assert peek_tag(raw) == jax_kvrep.peek_tag(raw)


def test_each_package_reads_the_others_dir_backends(tmp_path):
    dirs = [str(tmp_path / c) for c in "abc"]
    ours = ReplicatedKV([FileKV(d) for d in dirs], writer="p0",
                        clock=ManualClock().time)
    theirs = jax_kvrep.ReplicatedKV([JaxFileKV(d) for d in dirs],
                                    writer="p1",
                                    clock=jax_resilience.ManualClock().time)
    ours.set("run/elect/lease", json.dumps([1, 0, 5.0]))
    assert theirs.get("run/elect/lease") == json.dumps([1, 0, 5.0])
    theirs.set("run/elect/lease", json.dumps([2, 1, 9.0]))   # bumps past 1
    assert ours.get("run/elect/lease") == json.dumps([2, 1, 9.0])
    ours.set("run/mask/3", "[1.0, 1.0]")
    theirs.delete("run/mask/3")
    assert ours.get("run/mask/3") is None
    for d in dirs:
        raw = FileKV(d).get("run/elect/lease")
        assert raw == wrap_value(2, "p1", json.dumps([2, 1, 9.0]))
    assert ours.keys("run/") == theirs.keys("run/") == ["run/elect/lease"]


def _kill_wipe_script(pkg, root):
    """One script of quorum operations under a kv_backend_kill window on
    backend 2 and a wipe of backend 1, over ``dir:`` backends under
    ``root``; returns what the reads saw, the counters and each backend's
    files."""
    mod = kvrep if pkg == "port" else jax_kvrep
    cfg_cls = TrainConfig if pkg == "port" else jax_config.TrainConfig
    inj_cls = FaultInjector if pkg == "port" else \
        jax_resilience.FaultInjector
    clock = (ManualClock() if pkg == "port"
             else jax_resilience.ManualClock())
    dirs = [f"{root}/{pkg}_{c}" for c in "abc"]
    cfg = cfg_cls(eval_freq=0, seed=3, kv_resync_s=1.0,
                  kv_replicas=",".join(f"dir:{d}" for d in dirs))
    inj = inj_cls("kv_backend_kill:backend=2,step=2,steps=2;"
                  "kv_backend_wipe:backend=1,step=5", process_index=1)
    rkv = mod.build_replicated_kv(cfg, process_index=1, injector=inj,
                                  clock=clock.time)
    got = []
    for step in range(1, 8):
        inj.maybe_crash(step)
        rkv.set(f"run/mask/{step}", f"[{step}]")
        rkv.set("run/step", str(step))
        got.append(rkv.get(f"run/mask/{step - 1}", "none"))
        got.append(rkv.get("run/step"))
        clock.advance(0.6)
    rkv.delete("run/mask/1")
    got.append(rkv.keys("run/"))
    rkv.resync_backend(1)           # the wiped backend, repaired in full
    return got, rkv.snapshot(), inj.snapshot(), [_files(d) for d in dirs]


def test_kill_and_wipe_leave_the_backends_as_jax_does(tmp_path):
    ours = _kill_wipe_script("port", tmp_path)
    theirs = _kill_wipe_script("jax", tmp_path)
    assert ours == theirs
    got, counters, faults, files = ours
    assert counters["kvrep_ejections"] == 1 and counters["kvrep_resyncs"] >= 1
    assert faults["kv_backend_wipes"] == 1 and faults["kv_backend_kills"] == 1
    assert files[0] == files[1] == files[2]     # tag-equal after repair


# ---- envelopes and quorums (tests/test_kvrep.py, ported) ----

def test_envelope_roundtrip_and_unframed():
    env = wrap_value(7, "p3", "hello\nworld")
    tag, val = unwrap_value(env)
    assert tag == (7, "p3") and val == "hello\nworld"
    assert unwrap_value("plain") == ((0, ""), "plain")
    assert unwrap_value(None) == (None, None)
    assert unwrap_value("@kvr1 notanint p0\nx")[0] == (0, "")


def test_set_get_delete_keys_roundtrip():
    rkv, backends = _rkv()
    rkv.set("a/x", "1")
    rkv.set("a/y", "2")
    rkv.set("b/z", "3")
    assert rkv.get("a/x") == "1"
    assert rkv.get("missing", "dflt") == "dflt"
    assert rkv.keys("a/") == ["a/x", "a/y"]
    rkv.delete("a/x")
    assert rkv.get("a/x") is None
    for b in backends:
        tag, val = unwrap_value(b.get("a/y"))
        assert tag == (1, "w0") and val == "2"


@pytest.mark.parametrize("kw", [dict(quorum=1), dict(quorum=4),
                                dict(writer="p 0"), dict(writer="p\n0")])
def test_unsafe_construction_raises(kw):
    with pytest.raises(ValueError):
        _rkv(**kw)
    with pytest.raises(ValueError):
        jax_kvrep.ReplicatedKV([KVStore() for _ in range(3)], **kw)


def test_observed_version_bump_orders_read_modify_write():
    rkv, backends = _rkv(writer="p0")
    for b in backends:
        b.set("lease", wrap_value(7, "p9", "held-by-p9"))
    assert rkv.get("lease") == "held-by-p9"
    rkv.set("lease", "held-by-p0")
    tag, val = unwrap_value(backends[0].get("lease"))
    assert tag == (8, "p0") and val == "held-by-p0"


def test_concurrent_duel_resolves_identically_everywhere():
    rkv, backends = _rkv()
    backends[0].set("k", wrap_value(5, "p1", "from-p1"))
    backends[1].set("k", wrap_value(5, "p2", "from-p2"))
    backends[2].set("k", wrap_value(5, "p2", "from-p2"))
    assert rkv.get("k") == "from-p2"


def test_read_repair_heals_missing_and_stale_copies():
    rkv, backends = _rkv()
    rkv.set("k", "v1")
    backends[2].delete("k")
    backends[1].set("k", wrap_value(0, "", "ancient"))
    assert rkv.get("k") == "v1"
    assert rkv.counters["kvrep_read_repairs"] >= 2
    for b in backends:
        assert unwrap_value(b.get("k")) == ((1, "w0"), "v1")


def test_unframed_find_is_reframed_before_repair():
    rkv, backends = _rkv()
    backends[0].set("legacy", "old-data")
    backends[1].delete("legacy")
    assert rkv.get("legacy") == "old-data"
    rkv.set("legacy", "new-data")
    for b in backends:
        assert unwrap_value(b.get("legacy"))[1] == "new-data"


# ---- health: ejection, probation, rejoin, resync ----

def _flaky_third(**kw):
    clock = ManualClock()
    backends = [KVStore(), KVStore(), _FlakyKV()]
    return ReplicatedKV(backends, clock=clock.time, resync_s=1.0, seed=5,
                        **kw), backends, clock


def test_sub_quorum_outage_is_absorbed_then_backend_ejected():
    rkv, backends, _ = _flaky_third()
    rkv.set("k0", "v0")
    backends[2].down = True
    rkv.set("k1", "v1")
    rkv.set("k2", "v2")
    assert rkv.healthy_count() == 2
    assert rkv.counters["kvrep_ejections"] == 1
    errs = rkv.counters["kvrep_backend_errors"]
    rkv.set("k3", "v3")
    assert rkv.counters["kvrep_backend_errors"] == errs


def test_probation_rejoin_resyncs_to_tag_equality():
    rkv, backends, clock = _flaky_third()
    backends[2].down = True
    rkv.set("a", "1")
    rkv.set("b", "2")
    rkv.set("c", "3")
    rkv.delete("a")
    backends[2].down = False
    clock.advance(1.0)
    rkv.get("c")
    assert rkv.healthy_count() == 3
    assert rkv.counters["kvrep_rejoins"] == rkv.counters["kvrep_resyncs"] \
        == 1
    assert rkv.backend_tags(2) == rkv.backend_tags(0)
    assert unwrap_value(backends[2].get("c"))[1] == "3"


def test_failed_probe_grows_backoff():
    rkv, backends, clock = _flaky_third()
    backends[2].down = True
    rkv.set("a", "1")
    rkv.set("b", "2")
    clock.advance(1.0)
    rkv.get("a")
    assert rkv.counters["kvrep_probes"] == 1
    assert rkv.counters["kvrep_rejoins"] == 0
    clock.advance(0.5)
    rkv.get("a")
    assert rkv.counters["kvrep_probes"] == 1


def test_backoff_jitter_seeded_like_jax():
    """The probation schedule of process k draws from seed + 131 * k, as
    the JAX package's does, so both packages' clients back off alike."""
    cfg = TrainConfig(eval_freq=0, seed=9, kv_replicas="mem:,mem:,mem:")
    jcfg = jax_config.TrainConfig(eval_freq=0, seed=9,
                                  kv_replicas="mem:,mem:,mem:")
    for pid in (0, 2):
        ours = build_replicated_kv(cfg, process_index=pid)
        theirs = jax_kvrep.build_replicated_kv(jcfg, process_index=pid)
        assert [ours._backoff_s(e) for e in range(1, 8)] == \
            [theirs._backoff_s(e) for e in range(1, 8)]


def test_total_outage_raises_transient_unavailable():
    backends = [_FlakyKV(), _FlakyKV(), _FlakyKV()]
    rkv = ReplicatedKV(backends, clock=ManualClock().time)
    for b in backends:
        b.down = True
    with pytest.raises(TransientKVError, match="UNAVAILABLE"):
        rkv.set("k", "v")
    with pytest.raises(TransientKVError):
        rkv.get("k")
    with pytest.raises(TransientKVError):
        rkv.keys("")
    assert rkv.counters["kvrep_quorum_failures"] == 3


def test_resync_deletes_majority_absent_keys():
    rkv, backends, clock = _flaky_third()
    rkv.set("keep", "v")
    backends[2].set("orphan", wrap_value(9, "p9", "sub-quorum junk"))
    backends[2].down = True
    rkv.set("x1", "1")
    rkv.set("x2", "2")
    backends[2].down = False
    clock.advance(1.0)
    rkv.get("keep")
    assert backends[2].get("orphan") is None
    assert rkv.backend_tags(2) == rkv.backend_tags(0)


def test_gauges_and_snapshot_like_jax():
    from ps_pytorch_tpu.telemetry import registry as jax_registry
    from ps_pytorch_tpu_torch import telemetry
    rkv, _ = _rkv()
    assert rkv.gauges() == {"kvrep_backends": 3.0,
                            "kvrep_backends_healthy": 3.0}
    jrkv = jax_kvrep.ReplicatedKV([KVStore() for _ in range(3)])
    assert rkv.snapshot() == jrkv.snapshot()
    assert telemetry.KVREP_COUNTERS == jax_registry.KVREP_COUNTERS
    assert telemetry.KVREP_GAUGES == jax_registry.KVREP_GAUGES
    reg = telemetry.declare_kvrep_metrics(telemetry.Registry())
    assert set(reg.specs()) == set(rkv.snapshot()) | set(rkv.gauges())


# ---- the per-backend fault kinds ----

def _mem_cfg(**kw):
    base = dict(dataset="synthetic_mnist", network="LeNet", batch_size=64,
                lr=0.01, max_steps=4, eval_freq=0, seed=3,
                kv_replicas="mem:,mem:,mem:", kv_resync_s=1.0)
    base.update(kw)
    return TrainConfig(**base)


def test_backend_kill_window_absorbed_inside_quorum():
    clock = ManualClock()
    inj = FaultInjector("kv_backend_kill:backend=1,step=2,steps=2",
                        process_index=0)
    rkv = build_replicated_kv(_mem_cfg(), process_index=0, injector=inj,
                              clock=clock.time)
    rkv.set("k0", "v0")
    inj.maybe_crash(2)
    rkv.set("k1", "v1")
    rkv.set("k2", "v2")
    assert inj.counters["kv_backend_kills"] == 1
    assert inj.counters["kv_backend_drops"] >= 2
    assert rkv.healthy_count() == 2
    assert rkv.get("k1") == "v1"
    inj.maybe_crash(4)
    clock.advance(1.0)
    rkv.get("k0")
    assert rkv.counters["kvrep_rejoins"] == 1
    assert rkv.backend_tags(1) == rkv.backend_tags(0)


def test_backend_wipe_masked_then_repaired():
    clock = ManualClock()
    inj = FaultInjector("kv_backend_wipe:backend=2,step=3",
                        process_index=0)
    rkv = build_replicated_kv(_mem_cfg(), process_index=0, injector=inj,
                              clock=clock.time)
    rkv.set("a", "1")
    rkv.set("b", "2")
    inj.maybe_crash(3)
    assert rkv.get("a") == "1"
    assert inj.counters["kv_backend_wipes"] == 1
    assert rkv.counters["kvrep_read_repairs"] >= 1
    rkv.resync_backend(2)
    assert rkv.backend_tags(2) == rkv.backend_tags(0)


def test_wrap_backend_identity_when_index_not_named():
    inj = FaultInjector("kv_backend_kill:backend=1,step=0", process_index=0)
    kv = KVStore()
    assert inj.wrap_backend(kv, 0) is kv
    assert inj.wrap_backend(kv, 1) is not kv
    assert inj.has_backend_faults
    assert inj.wrap_kv(kv) is kv and not inj.has_kv_faults


@pytest.mark.parametrize("bad", [
    "kv_backend_kill:step=1", "kv_backend_kill:backend=-1,step=1",
    "kv_backend_kill:backend=0", "kv_backend_kill:backend=0,step=1,steps=-2",
    "kv_backend_wipe:backend=0",
])
def test_backend_fault_spec_rejects_like_jax(bad):
    msgs = []
    for parse in (parse_fault_spec, jax_resilience.parse_fault_spec):
        with pytest.raises(ValueError) as e:
            parse(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---- the retry plane outside the quorum ----

def _retrier(rkv, sleep=lambda s: None, budget=10):
    b = RetryBudget(budget)
    return RetryingKV(rkv, policy=RetryPolicy(max_attempts=3, seed=1),
                      budget=b, sleep=sleep), b


def test_retrying_over_replicated_sub_quorum_costs_no_budget():
    backends = [KVStore(), KVStore(), _FlakyKV()]
    rkv = ReplicatedKV(backends, clock=ManualClock().time)
    backends[2].down = True
    retrier, budget = _retrier(rkv)
    retrier.set("k", "v")
    assert retrier.get("k") == "v"
    assert retrier.keys("") == ["k"]
    assert retrier.counters == {"kv_retries": 0, "kv_giveups": 0}
    assert budget.spent == 0


def test_retrying_over_replicated_quorum_loss_charged_per_logical_op():
    backends = [_FlakyKV(), _FlakyKV(), _FlakyKV()]
    rkv = ReplicatedKV(backends, clock=ManualClock().time)
    for b in backends:
        b.down = True
    retrier, budget = _retrier(rkv)
    with pytest.raises(TransientKVError, match="UNAVAILABLE"):
        retrier.set("k", "v")
    assert retrier.counters["kv_retries"] == 2
    assert retrier.counters["kv_giveups"] == 1
    assert budget.spent == 2


def test_retrying_recovers_when_quorum_returns_mid_op():
    backends = [_FlakyKV(), _FlakyKV(), KVStore()]
    rkv = ReplicatedKV(backends, clock=ManualClock().time, eject_after=5)
    backends[0].down = backends[1].down = True
    heal = {"n": 0}

    def sleep(_s):
        heal["n"] += 1
        backends[0].down = False

    retrier, _ = _retrier(rkv, sleep=sleep)
    retrier.set("k", "v")
    assert heal["n"] == 1 and retrier.counters["kv_retries"] == 1
    assert retrier.get("k") == "v"


def test_wire_corrupt_is_fatal_not_retryable():
    assert not is_retryable(WireCorrupt("armor checksum mismatch"))
    assert is_retryable(TransientKVError("UNAVAILABLE: quorum write"))

    class _Corrupting(KVStore):
        def get(self, key, default=None):
            raise WireCorrupt("bad frame")

    retrier = RetryingKV(_Corrupting(), sleep=lambda s: None)
    with pytest.raises(WireCorrupt):
        retrier.get("k")
    assert retrier.counters == {"kv_retries": 0, "kv_giveups": 0}


# ---- the HTTP backend ----

def _serve(n=1):
    srvs = [serve_kv(0) for _ in range(n)]
    threads = [threading.Thread(target=s.serve_forever,
                                kwargs={"poll_interval": 0.05}, daemon=True)
               for s in srvs]
    for t in threads:
        t.start()
    return srvs, threads


def _stop(srvs, threads):
    for s in srvs:
        s.shutdown()
        s.server_close()
    for t in threads:
        t.join(timeout=5)


def test_http_backend_roundtrip_and_kill():
    srvs, threads = _serve()
    port = srvs[0].server_address[1]
    try:
        kv = HttpKV(f"http://127.0.0.1:{port}", timeout_s=2.0)
        kv.set("a/b c", "v1\nline2")
        assert kv.get("a/b c") == "v1\nline2"
        assert kv.get("missing", "d") == "d"
        assert kv.keys("a/") == ["a/b c"]
        # The JAX client reads the port's server, and the other way.
        jkv = jax_kvrep.HttpKV(f"http://127.0.0.1:{port}", timeout_s=2.0)
        assert jkv.get("a/b c") == "v1\nline2"
        jkv.set("a/j", "from-jax")
        assert kv.get("a/j") == "from-jax"
        kv.delete("a/b c")
        assert kv.get("a/b c") is None
    finally:
        _stop(srvs, threads)
    with pytest.raises(TransientKVError, match="UNAVAILABLE"):
        HttpKV(f"http://127.0.0.1:{port}", timeout_s=0.3).get("a")


def test_replicated_over_http_survives_one_dead_server():
    srvs, threads = _serve(3)
    try:
        rkv = ReplicatedKV(
            [HttpKV(f"http://127.0.0.1:{s.server_address[1]}",
                    timeout_s=1.0) for s in srvs],
            clock=ManualClock().time)
        rkv.set("k", "v")
        srvs[1].shutdown()
        srvs[1].server_close()
        assert rkv.get("k") == "v"
        rkv.set("k2", "v2")
        assert rkv.get("k2") == "v2"
    finally:
        _stop([srvs[0], srvs[2]], [threads[0], threads[2]])


def test_kvrep_module_serves_a_backend(tmp_path):
    """``python -m ps_pytorch_tpu_torch.runtime.kvrep`` prints its ready
    line and serves a FileKV root until it is stopped."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ps_pytorch_tpu_torch.runtime.kvrep",
         "--port", str(port), "--root", str(tmp_path / "root")],
        stdout=subprocess.PIPE, text=True, env=env, cwd=str(REPO))
    try:
        line = proc.stdout.readline().strip()
        assert line == (f"KVSERVER ready host=127.0.0.1 port={port} "
                        f"root={tmp_path / 'root'}")
        kv = HttpKV(f"http://127.0.0.1:{port}", timeout_s=5.0)
        kv.set("run/k", "v")
        assert kv.get("run/k") == "v"
        assert FileKV(str(tmp_path / "root")).get("run/k") == "v"
    finally:
        proc.kill()
        proc.wait(timeout=10)


# ---- spec plumbing and config ----

@pytest.mark.parametrize("spec", ["dir:/a, http://h:1,mem:", "", "mem",
                                  "https://h:2,dir:rel"])
def test_parse_backend_specs_like_jax(spec):
    assert parse_backend_specs(spec) == jax_kvrep.parse_backend_specs(spec)


@pytest.mark.parametrize("spec", ["ftp://nope", "/bare/path"])
def test_parse_backend_specs_rejects_like_jax(spec):
    msgs = []
    for parse in (parse_backend_specs, jax_kvrep.parse_backend_specs):
        with pytest.raises(ValueError) as e:
            parse(spec)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_build_replicated_kv_writer_identity(tmp_path):
    cfg = _mem_cfg(kv_replicas=f"dir:{tmp_path}/a,mem:,mem:", kv_quorum=2)
    rkv = build_replicated_kv(cfg, process_index=7)
    assert rkv.writer == "p7" and rkv.quorum == 2 and rkv.n == 3
    assert isinstance(rkv._backends[0].kv, FileKV)
    assert isinstance(rkv._backends[1].kv, KVStore)
    with pytest.raises(ValueError):
        build_replicated_kv(_mem_cfg(kv_replicas=""), process_index=0)


def test_config_rejects_heartbeat_inversions():
    with pytest.raises(ValueError, match="heartbeat_timeout_s"):
        _mem_cfg(heartbeat_interval_s=2.0, heartbeat_timeout_s=2.0)
    with pytest.raises(ValueError, match="leader_lease_s"):
        _mem_cfg(heartbeat_timeout_s=1.0, leader_lease_s=2.0,
                 heartbeat_interval_s=0.5)
    assert _mem_cfg(heartbeat_interval_s=0.5, heartbeat_timeout_s=2.0,
                    leader_lease_s=1.0).heartbeat_timeout_s == 2.0


def test_config_rejects_unsafe_quorum_and_bad_specs():
    with pytest.raises(ValueError, match="kv_quorum"):
        _mem_cfg(kv_quorum=1)
    with pytest.raises(ValueError, match="kv replica spec"):
        _mem_cfg(kv_replicas="mem:,bogus-spec")
    with pytest.raises(ValueError, match="kv_resync_s"):
        _mem_cfg(kv_resync_s=0.0)
    assert _mem_cfg(kv_quorum=3).kv_quorum == 3


# ---- FileKV ----

@pytest.mark.parametrize("cls", [FileKV, JaxFileKV])
def test_filekv_set_fsyncs_data_before_rename_and_dir_after(
        tmp_path, monkeypatch, cls):
    events = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(
        os, "fsync", lambda fd: (events.append("fsync"), real_fsync(fd))[1])
    monkeypatch.setattr(
        os, "replace",
        lambda a, b: (events.append("replace"), real_replace(a, b))[1])
    kv = cls(str(tmp_path / "kv"))
    events.clear()
    kv.set("k", "v")
    assert events == ["fsync", "replace", "fsync"]
    assert kv.get("k") == "v"


def test_filekv_failed_write_leaves_no_tmp_litter(tmp_path, monkeypatch):
    kv = FileKV(str(tmp_path / "kv"))
    kv.set("kept", "1")
    monkeypatch.setattr(os, "replace",
                        lambda a, b: (_ for _ in ()).throw(OSError("disk")))
    with pytest.raises(OSError):
        kv.set("k", "v")
    assert os.listdir(str(tmp_path / "kv")) == ["kept"]


def test_filekv_files_equal_jax(tmp_path):
    """Each package's FileKV writes the same file for the same key, reads
    the other's, and lists the same keys (temporary files never)."""
    ours, theirs = FileKV(str(tmp_path / "a")), JaxFileKV(str(tmp_path / "b"))
    for kv in (ours, theirs):
        for key, value in (("run/elect/lease", "[1, 0, 3.5]"),
                           ("serve/fleet/replica/0", "{\"url\": \"x\"}"),
                           ("k with spaces%2F", "v\n")):
            kv.set(key, value)
        kv.delete("serve/fleet/replica/0")
    (tmp_path / "a" / ".tmp-stale").write_text("junk")
    assert _files(tmp_path / "b") == {
        k: v for k, v in _files(tmp_path / "a").items()
        if not k.startswith(".tmp-")}
    assert ours.keys("") == theirs.keys("") == JaxFileKV(
        str(tmp_path / "a")).keys("")
    assert JaxFileKV(str(tmp_path / "a")).get("run/elect/lease") == \
        ours.get("run/elect/lease") == "[1, 0, 3.5]"


# ---- the synchronous Trainer over the replicated plane, two ranks ----

def test_trainer_runs_over_replicated_kv(tmp_path):
    """One process, the control plane on three in-process backends: the
    run completes and the kvrep counters reach resilience_stats."""
    from ps_pytorch_tpu_torch.runtime.trainer import Trainer
    cfg = _mem_cfg(train_dir=str(tmp_path / "ckpt"), max_steps=3,
                   elastic=True, leader_lease_s=5.0,
                   compute_dtype="float32", momentum=0.9, resume=False)
    t = Trainer(cfg, device="cpu")
    assert t._kvrep is not None and t._kvrep.n == 3
    t.train()
    stats = t.resilience_stats()
    assert stats["kvrep_quorum_failures"] == 0 and stats["leader_epoch"] == 1
    assert (stats["world_size"], stats["membership_changes"]) == (1, 1)
    assert t._kvrep.healthy_count() == 3
    health = t.ops.health_status()
    assert (health["leader"], health["leader_epoch"],
            health["leader_owner"]) == (True, 1, 0)
    reg = t.ops.registry
    assert (reg.get("leader_epoch"), reg.get("world_size"),
            reg.get("membership_changes"), reg.get("elections")) == \
        (1, 1, 1, 0)
    from ps_pytorch_tpu_torch.telemetry import declare_kvrep_metrics
    declare_kvrep_metrics(reg)
    t.ops.pump_kvrep_metrics(t._kvrep)      # the exporter's collect hook
    assert {k: reg.get(k) for k in t._kvrep.snapshot()} == \
        t._kvrep.snapshot()
    assert reg.get("kvrep_backends_healthy") == 3


def test_two_ranks_over_a_wiped_quorum_equal_static_and_jax(tmp_path):
    from test_torch_dist import (
        _args, _assert_ranks_equal, _assert_tree_close, _checkpoint_params,
        _jax_params, _launch, _masks, STEPS,
    )
    srvs, threads = _serve()
    url = f"http://127.0.0.1:{srvs[0].server_address[1]}"
    try:
        logs = _launch(tmp_path, 2, _args(
            tmp_path, 32, "--mode", "kofn", "--num-aggregate", "2",
            "--elastic", "--elastic-leader", "1", "--leader-lease-s", "10",
            "--kv-replicas", f"dir:{tmp_path}/a,dir:{tmp_path}/b,{url}",
            "--kv-resync-s", "0.02", "--fault-spec",
            "kv_backend_kill:backend=2,step=2,steps=2;"
            "kv_backend_wipe:backend=1,step=4"))
    finally:
        _stop(srvs, threads)
    masks = _masks(logs[1], 2)              # process 1 leads
    assert all(m.tolist() == [1, 1] for m in masks)
    assert not any(ln.startswith("MASK") for ln in logs[0].splitlines())
    _assert_ranks_equal(tmp_path, logs)
    for path in (tmp_path / "m.jsonl", tmp_path / "m.jsonl.p1"):
        last = json.loads(path.read_text().splitlines()[-1])
        assert last["kvrep_ejections"] >= 1 and last["kv_giveups"] == 0
        assert last["kv_backend_wipes"] == 1 and last["leader_epoch"] == 1
    meta = json.loads((tmp_path / "td" / f"model_step_{STEPS}" /
                       "meta.json").read_text())
    assert (meta["leader_epoch"], meta["leader_pid"]) == (1, 0)
    elastic_params = _checkpoint_params(tmp_path / "td", STEPS)
    static = tmp_path / "static"
    static.mkdir()
    _launch(static, 2, _args(static, 32, "--mode", "kofn",
                             "--num-aggregate", "2"))
    static_params = _checkpoint_params(static / "td", STEPS)
    flat = [(k, v) for k, v in _flat(elastic_params)]
    assert [k for k, _ in flat] == [k for k, _ in _flat(static_params)]
    for (k, a), (_, b) in zip(flat, _flat(static_params)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), k
    _assert_tree_close(elastic_params, _jax_params(2, 32, masks))


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]
