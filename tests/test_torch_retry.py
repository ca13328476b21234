"""The port's KV retry plane (``ps_pytorch_tpu_torch/resilience``) against
the JAX package's ``resilience/retry.py``, and the two repairs on the
multi-process KV, on the CPU.

- ``is_retryable``, ``call_with_retry`` (jittered backoff, fatal errors
  surface at once, the budget fails fast) and ``RetryingKV`` over a
  seeded flaky store: the same retries, sleeps and counters as the JAX
  package's on the same store.
- The sync Trainer's Coordinator KV goes through ``wrap_kv_with``, as the
  JAX Trainer's does: a ``RetryingKV`` over the process group's
  TCPStore under the launch contract, over the in-process store alone;
  its JSONL grows ``kv_retries`` / ``kv_giveups`` once a retry fired.
- ``DistributedKV.get`` of a key deleted between a lookup and the read
  answers None at once on a real TCPStore, where a check-then-get waits
  out the store's timeout.
"""

import json
import socket
import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu import resilience as jax_resilience
from ps_pytorch_tpu.runtime.coordinator import KVStore as JaxKVStore
from ps_pytorch_tpu_torch import config, resilience
from ps_pytorch_tpu_torch.parallel import dist
from ps_pytorch_tpu_torch.resilience import (
    RetryBudget, RetryingKV, RetryPolicy, call_with_retry, is_retryable,
)
from ps_pytorch_tpu_torch.runtime import Trainer
from ps_pytorch_tpu_torch.runtime.coordinator import DistributedKV, KVStore
from test_torch_train import two_torch_threads  # noqa: F401


class Sleeps:
    """Records the delays instead of sleeping (a fake clock)."""

    def __init__(self):
        self.sleeps = []

    def __call__(self, s):
        self.sleeps.append(s)


class FlakyKV:
    """A store whose operations fail transiently (ConnectionError, before
    any write) with probability ``p`` from a seeded stream."""

    def __init__(self, inner, p=0.3, seed=5):
        self.inner = inner
        self.p = p
        self.rng = np.random.default_rng(seed)
        self.drops = 0

    def _roll(self):
        if self.rng.random() < self.p:
            self.drops += 1
            raise ConnectionError("UNAVAILABLE: injected drop")

    def set(self, key, value):
        self._roll()
        self.inner.set(key, value)

    def get(self, key, default=None):
        self._roll()
        return self.inner.get(key, default)

    def delete(self, key):
        self._roll()
        self.inner.delete(key)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------- the policy --

@pytest.mark.parametrize("exc,want", [
    (ConnectionError("reset"), True), (TimeoutError("deadline"), True),
    (RuntimeError("connection reset by peer"), True),
    (RuntimeError("DEADLINE_EXCEEDED: get"), True),
    (ValueError("bad arg"), False), (KeyError("missing"), False),
    (RuntimeError("NOT_FOUND: key absent"), False),
])
def test_is_retryable_classification_like_jax(exc, want):
    assert is_retryable(exc) is want
    assert jax_resilience.is_retryable(exc) is want


def test_call_with_retry_backoff_fake_clock():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError("UNAVAILABLE")
        return "ok"

    policy = RetryPolicy(max_attempts=5, base_s=0.1, multiplier=2.0,
                         jitter=0.5, seed=42)
    ours, theirs = Sleeps(), Sleeps()
    assert call_with_retry(flaky, policy=policy, sleep=ours) == "ok"
    assert calls["n"] == 3 and len(ours.sleeps) == 2
    for k, d in enumerate(ours.sleeps):
        cap = policy.base_s * policy.multiplier ** k
        assert cap * (1 - policy.jitter) < d <= cap
    calls["n"] = 0
    jax_policy = jax_resilience.RetryPolicy(max_attempts=5, base_s=0.1,
                                            multiplier=2.0, jitter=0.5,
                                            seed=42)
    assert jax_resilience.call_with_retry(flaky, policy=jax_policy,
                                          sleep=theirs) == "ok"
    assert ours.sleeps == theirs.sleeps


def test_call_with_retry_fatal_not_retried():
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        call_with_retry(broken, sleep=Sleeps())
    assert calls["n"] == 1


def test_call_with_retry_gives_up_after_max_attempts():
    calls = {"n": 0}

    def down():
        calls["n"] += 1
        raise TimeoutError("timed out")

    sleeps = Sleeps()
    with pytest.raises(TimeoutError):
        call_with_retry(down, policy=RetryPolicy(max_attempts=3, seed=0),
                        sleep=sleeps)
    assert calls["n"] == 3 and len(sleeps.sleeps) == 2


def test_retry_budget_exhaustion_fails_fast():
    budget = RetryBudget(3)
    sleeps = Sleeps()

    def always_down():
        raise ConnectionError("UNAVAILABLE")

    policy = RetryPolicy(max_attempts=10, base_s=0.01, seed=0)
    with pytest.raises(ConnectionError):
        call_with_retry(always_down, policy=policy, budget=budget,
                        sleep=sleeps)
    assert budget.spent == 3 and len(sleeps.sleeps) == 3
    with pytest.raises(ConnectionError):
        call_with_retry(always_down, policy=policy, budget=budget,
                        sleep=sleeps)
    assert len(sleeps.sleeps) == 3      # exhausted: no further sleep


def test_retrying_kv_absorbs_drops_like_jax():
    """The same seeded drops through each package's RetryingKV: every
    value lands and reads back, with the same retries and sleeps."""
    runs = []
    for mod, store in ((resilience, KVStore()),
                       (jax_resilience, JaxKVStore())):
        sleeps = Sleeps()
        flaky = FlakyKV(store)
        kv = mod.RetryingKV(flaky, mod.RetryPolicy(max_attempts=8,
                                                   base_s=0.001, seed=1),
                            sleep=sleeps)
        for i in range(100):
            kv.set(f"k{i}", str(i))
        for i in range(100):
            assert kv.get(f"k{i}") == str(i)
        kv.delete("k0")
        assert kv.get("k0") is None
        runs.append((kv.snapshot(), sleeps.sleeps, flaky.drops))
    assert runs[0] == runs[1]
    snap, _, drops = runs[0]
    assert snap == {"kv_retries": drops, "kv_giveups": 0} and drops > 0


def test_retrying_kv_counts_a_giveup():
    kv = RetryingKV(FlakyKV(KVStore(), p=1.0),
                    RetryPolicy(max_attempts=3, base_s=0.001, seed=0),
                    sleep=Sleeps())
    with pytest.raises(ConnectionError):
        kv.set("a", "1")
    assert kv.snapshot() == {"kv_retries": 2, "kv_giveups": 1}
    fatal = RetryingKV(_Raises(KeyError("x")), sleep=Sleeps())
    with pytest.raises(KeyError):       # a fatal error is no giveup
        fatal.get("x")
    assert fatal.snapshot() == {"kv_retries": 0, "kv_giveups": 0}


class _Raises:
    def __init__(self, exc):
        self.exc = exc

    def get(self, key, default=None):
        raise self.exc


def test_wrap_kv_identity_when_disabled(tmp_path):
    cfg = config.TrainConfig(kv_retry_attempts=1, dataset="synthetic_mnist")
    base = KVStore()
    kv, injector, retrier = resilience.wrap_kv_with(base, cfg, None)
    assert kv is base and injector is None and retrier is None


def test_wrap_kv_takes_the_policy_from_the_config():
    cfg = config.TrainConfig(dataset="synthetic_mnist", kv_retry_attempts=7,
                             kv_retry_base_s=0.2, kv_retry_budget=9, seed=3)
    base = KVStore()
    kv, _, retrier = resilience.wrap_kv_with(base, cfg, None)
    assert kv is retrier and retrier.inner is base
    assert (retrier.policy.max_attempts, retrier.policy.base_s,
            retrier.policy.seed, retrier.budget.limit) == (7, 0.2, 3, 9)
    # A budget of 0 means unbounded, as in the JAX package.
    _, _, unbounded = resilience.wrap_kv_with(
        base, config.TrainConfig(dataset="synthetic_mnist",
                                 kv_retry_budget=0), None)
    assert unbounded.budget is None


@pytest.mark.parametrize("kw", [
    dict(kv_retry_attempts=0), dict(kv_retry_base_s=-0.1),
    dict(kv_retry_budget=-1), dict(ckpt_keep=-2),
    dict(mode="async", publish_every=9),
])
def test_config_validates_retry_fields_like_jax(kw):
    msgs = []
    for mod in (config, jax_config):
        with pytest.raises(ValueError) as e:
            mod.TrainConfig(dataset="synthetic_mnist", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_retry_fields_round_trip_with_jax():
    kw = dict(dataset="synthetic_mnist", kv_retry_attempts=3,
              kv_retry_base_s=0.01, kv_retry_budget=50)
    ours, theirs = config.TrainConfig(**kw), jax_config.TrainConfig(**kw)
    assert json.loads(ours.to_json())["kv_retry_budget"] == 50
    back = config.TrainConfig.from_json(ours.to_json())
    assert (back.kv_retry_attempts, back.kv_retry_base_s,
            back.kv_retry_budget) == (theirs.kv_retry_attempts,
                                      theirs.kv_retry_base_s,
                                      theirs.kv_retry_budget)


# ------------------------------------------ repair: the sync Trainer's KV --

def _lenet(tmp_path, **kw):
    tmp_path.mkdir(parents=True, exist_ok=True)
    base = dict(dataset="synthetic_mnist", network="LeNet", batch_size=32,
                lr=0.01, momentum=0.9, max_steps=2, epochs=0, eval_freq=0,
                train_dir=str(tmp_path / "td"), compute_dtype="float32",
                log_every=1, seed=3, resume=False,
                metrics_file=str(tmp_path / "m.jsonl"))
    base.update(kw)
    return config.TrainConfig(**base)


def _clear_contract(monkeypatch):
    for name in (dist.ENV_COORD, dist.ENV_NPROC, dist.ENV_PID, "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)


def test_sync_trainer_kv_goes_through_the_retry_plane(tmp_path,
                                                      monkeypatch):
    """Alone over the in-process store, and under the launch contract over
    the group's TCPStore, as the JAX Trainer wraps its KV."""
    _clear_contract(monkeypatch)
    alone = Trainer(_lenet(tmp_path), device="cpu")
    assert isinstance(alone.coordinator.kv, RetryingKV)
    assert type(alone.coordinator.kv.inner) is KVStore
    assert alone.coordinator.kv.policy.max_attempts == 5
    monkeypatch.setenv(dist.ENV_COORD, f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv(dist.ENV_NPROC, "1")
    monkeypatch.setenv(dist.ENV_PID, "0")
    try:
        dist.initialize_from_env("cpu")
        grouped = Trainer(_lenet(tmp_path / "g"), device="cpu")
        kv = grouped.coordinator.kv
        assert isinstance(kv, RetryingKV)
        assert isinstance(kv.inner, DistributedKV)
        assert kv.inner._store is dist.store()
        off = Trainer(_lenet(tmp_path / "o", kv_retry_attempts=1),
                      device="cpu")
        assert isinstance(off.coordinator.kv, DistributedKV)
    finally:
        dist.shutdown()


def _jsonl_keys(path):
    rows = [json.loads(line) for line in open(path)]
    return rows, set().union(*(r.keys() for r in rows))


def test_sync_trainer_jsonl_grows_retry_columns_once_a_retry_fired(
        tmp_path, monkeypatch):
    _clear_contract(monkeypatch)
    clean = Trainer(_lenet(tmp_path / "clean"), device="cpu")
    clean.train()
    _, keys = _jsonl_keys(tmp_path / "clean" / "m.jsonl")
    assert not keys & {"kv_retries", "kv_giveups"}
    flaky = Trainer(_lenet(tmp_path / "flaky"), device="cpu")
    kv = flaky.coordinator.kv
    kv.inner = FlakyKV(kv.inner, p=0.5, seed=2)
    kv._sleep = Sleeps()
    flaky.train()
    rows, keys = _jsonl_keys(tmp_path / "flaky" / "m.jsonl")
    assert {"kv_retries", "kv_giveups"} <= keys
    assert rows[-1]["kv_retries"] == kv.inner.drops > 0
    assert rows[-1]["kv_giveups"] == 0


# ------------------------------------- repair: DistributedKV.get never waits --

class DeletesAfterCheck:
    """A TCPStore whose ``check`` deletes the key after answering: a
    writer's GC landing between a reader's lookup and its read."""

    def __init__(self, store):
        self.store = store

    def check(self, keys):
        found = self.store.check(keys)
        for k in keys:
            self.store.delete_key(k)
        return found

    def __getattr__(self, name):
        return getattr(self.store, name)


@pytest.fixture
def tcp_store():
    """A real TCPStore served here, with a short timeout, so that a read
    that waits for a missing key fails the test in seconds, not minutes."""
    store = torch.distributed.TCPStore(
        "127.0.0.1", _free_port(), 1, is_master=True,
        timeout=timedelta(seconds=3))
    yield store
    del store


def test_distributed_kv_round_trip_and_missing_key(tcp_store):
    kv = DistributedKV(tcp_store)
    t0 = time.monotonic()
    assert kv.get("run/none") is None and kv.get("run/none", "d") == "d"
    kv.set("run/a", "x" * 1000)
    assert kv.get("run/a") == "x" * 1000
    kv.set("run/a", "y")
    assert kv.get("run/a") == "y"
    kv.delete("run/a")
    assert kv.get("run/a") is None
    assert time.monotonic() - t0 < 1.0
    assert not tcp_store.check(["run/none"])   # reading creates no key


def test_distributed_kv_get_of_a_key_deleted_after_check_returns_none(
        tcp_store):
    key = "run/agrad/0/3/0/0"
    kv = DistributedKV(DeletesAfterCheck(tcp_store))
    kv.set(key, "chunk")
    t0 = time.monotonic()
    # A check-then-get loses the key between the two and waits out the
    # store's timeout; one atomic read sees the chunk or its absence.
    assert kv.get(key) in (None, "chunk")
    kv.delete(key)
    assert kv.get(key) is None
    assert time.monotonic() - t0 < 1.0


def test_distributed_kv_reads_race_deletes(tcp_store):
    """Four readers against a writer that sets and deletes: every read is
    the value or None, and nothing waits."""
    kv = DistributedKV(tcp_store)
    bad, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            v = kv.get("run/race")
            if v not in (None, "payload"):
                bad.append(v)

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    t0 = time.monotonic()
    for _ in range(200):
        kv.set("run/race", "payload")
        kv.delete("run/race")
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads) and not bad
    assert time.monotonic() - t0 < 10
