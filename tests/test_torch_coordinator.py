"""The port's Coordinator against the JAX package's, on the CPU.

Each case of ``tests/test_runtime.py``'s Coordinator tests runs the same
calls through both packages: the masks (and the errors raised) must be
equal, and the two in-process KV stores must hold the same keys with
byte-equal values. Then the follower's mask wait, and ``DistributedKV``
over a real ``TCPStore`` shared by two processes.
"""

import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import pytest
import torch.distributed as tdist

from conftest import free_port
from ps_pytorch_tpu.runtime import coordinator as jax_coordinator
from ps_pytorch_tpu_torch.runtime import coordinator
from test_torch_train import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _mask(c, step, **kw):
    try:
        return ("mask", c.participation_mask(step, **kw).tolist())
    except (TimeoutError, ValueError) as e:
        return ("raises", type(e).__name__)


def _sync_and_step_control(mod):
    c = mod.Coordinator(4, mode="sync")
    c.announce_step(9)
    return [c.current_step(), c.wait_for_step(after=8), _mask(c, 9)], [c.kv]


def _kofn_fastest_k(mod):
    c = mod.Coordinator(4, mode="kofn", num_aggregate=2)
    for r, d in enumerate([0.5, 0.1, 0.9, 0.2]):
        c.report_duration(r, 1, d)
    return [_mask(c, 2)], [c.kv]


def _kofn_host_granular(mod):
    out, kvs = [], []
    for k, durations in ((2, [0.9, 0.9, 0.1, 0.1]), (3, [0.5] * 4),
                         (3, [0.9, 0.9, 0.1, 0.1])):
        c = mod.Coordinator(4, mode="kofn", num_aggregate=k)
        for r, d in enumerate(durations):
            c.report_duration(r, 1, d)
        out.append(_mask(c, 2))
        kvs.append(c.kv)
    return out, kvs


def _deadline_and_kill(mod):
    c = mod.Coordinator(3, mode="kofn", num_aggregate=3, kill_threshold=1.0)
    for r, d in enumerate([0.5, 2.0, 0.7]):
        c.report_duration(r, 1, d)
    out = [_mask(c, 2)]
    c.kill(2)
    out += [c.is_killed(2), _mask(c, 3)]
    c.report_duration(0, 2, 5.0)          # all out: the never-wedge fallback
    out.append(_mask(c, 4))
    return out, [c.kv]


def _mask_gc_window(mod):
    c = mod.Coordinator(2, mode="sync", mask_gc_window=50)
    out = [_mask(c, step) for step in range(1, 61)]
    follower = mod.Coordinator(2, mode="sync", kv=c.kv, leader=False)
    out += [_mask(follower, 11, timeout_s=1.0),
            _mask(follower, 9, timeout_s=0.1)]
    return out, [c.kv]


def _validates(mod):
    out = []
    for kw in (dict(mode="kofn", num_aggregate=0),
               dict(mode="kofn", num_aggregate=5), dict(mode="warp")):
        try:
            mod.Coordinator(4, **kw)
            out.append("built")
        except ValueError:
            out.append("ValueError")
    return out, []


CASES = {"sync_and_step_control": _sync_and_step_control,
         "kofn_fastest_k": _kofn_fastest_k,
         "kofn_host_granular": _kofn_host_granular,
         "deadline_and_kill": _deadline_and_kill,
         "mask_gc_window": _mask_gc_window,
         "validates": _validates}


@pytest.mark.parametrize("case", sorted(CASES))
def test_coordinator_matches_jax(case):
    ours, our_kvs = CASES[case](coordinator)
    theirs, their_kvs = CASES[case](jax_coordinator)
    assert ours == theirs
    assert len(our_kvs) == len(their_kvs)
    for a, b in zip(our_kvs, their_kvs):
        assert a.keys() == b.keys()
        for k in a.keys():
            assert a.get(k).encode() == b.get(k).encode(), k


def test_expected_masks():
    """The values both packages agree on are the reference's."""
    got, _ = _kofn_host_granular(coordinator)
    assert [m for _, m in got] == [[0, 0, 1, 1], [1, 1, 1, 0], [1, 0, 1, 1]]
    got, _ = _deadline_and_kill(coordinator)
    assert got[0] == ("mask", [1, 0, 1]) and got[2] == ("mask", [1, 0, 0])
    assert got[3][1][2] == 0 and sum(got[3][1]) >= 1


class FlakyKV:
    def __init__(self, inner, failures, error=ConnectionError):
        self.inner, self.failures, self.error = inner, failures, error

    def get(self, key, default=None):
        if "/mask/" in key and self.failures > 0:
            self.failures -= 1
            raise self.error("coordination service hiccup")
        return self.inner.get(key, default)

    def set(self, key, value):
        self.inner.set(key, value)

    def delete(self, key):
        self.inner.delete(key)


def test_follower_receives_the_leaders_mask_and_retries_transient_errors():
    leader = coordinator.Coordinator(3, mode="kofn", num_aggregate=2)
    for r, d in enumerate([0.3, 0.1, 0.2]):
        leader.report_duration(r, 1, d)
    published = leader.participation_mask(2)
    follower = coordinator.Coordinator(3, mode="kofn", num_aggregate=2,
                                       kv=FlakyKV(leader.kv, 3),
                                       leader=False)
    got = follower.participation_mask(2, timeout_s=5.0)
    assert got.tolist() == published.tolist() == [0, 1, 1]
    assert follower.stats["mask_wait_errors"] == 3
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        follower.participation_mask(99, timeout_s=0.2)
    assert time.monotonic() - t0 < 2.0
    broken = coordinator.Coordinator(3, mode="sync",
                                     kv=FlakyKV(leader.kv, 1, ValueError),
                                     leader=False)
    with pytest.raises(ValueError, match="hiccup"):
        broken.participation_mask(2, timeout_s=1.0)


@pytest.mark.parametrize("kw", [
    dict(election=object()), dict(membership=object()),
    dict(liveness_factory=object()),
    dict(lease_interval_s=1.0), dict(lease_timeout_s=3.0),
    dict(clock=time.time)])
def test_unported_planes_raise(kw):
    """The planes the Coordinator once refused are ported: each argument
    is taken and kept as the JAX Coordinator keeps it."""
    ours = coordinator.Coordinator(2, **kw)
    theirs = jax_coordinator.Coordinator(2, **kw)
    for attr in ("election", "membership", "_liveness_factory",
                 "lease_interval_s", "lease_timeout_s"):
        assert getattr(ours, attr) is getattr(theirs, attr) or \
            getattr(ours, attr) == getattr(theirs, attr), attr
    if "clock" in kw:
        assert ours.clock is kw["clock"]


_FOLLOWER = r"""
import json, sys, time
from datetime import timedelta
import torch.distributed as tdist
from ps_pytorch_tpu_torch.runtime.coordinator import Coordinator, DistributedKV

store = tdist.TCPStore("127.0.0.1", int(sys.argv[1]), 2, is_master=False,
                       timeout=timedelta(seconds=20))
kv = DistributedKV(store)
co = Coordinator(2, mode="kofn", num_aggregate=1, kv=kv, leader=False)
out = {"masks": [co.participation_mask(s, timeout_s=20).tolist()
                 for s in (1, 2, 3)],
       "overwritten": kv.get("t/k"), "missing": kv.get("t/none", "dflt"),
       "deleted": kv.get("t/gone", "dflt")}
try:
    kv.keys()
except NotImplementedError:
    out["keys"] = "raises"
print(json.dumps(out), flush=True)
kv.set("t/follower_done", "1")
time.sleep(2.0)                  # the leader closes the store meanwhile
try:
    kv.get("t/k")
    out = "no error"
except Exception as e:
    out = type(e).__name__
print(json.dumps({"dead": out}), flush=True)
"""


def test_distributed_kv_over_a_tcp_store_in_two_processes():
    """Process 0 (here) serves the store and leads; process 1 follows.
    Set overwrites, get gives its default only for a missing key, delete
    removes, the follower reads the leader's masks, ``keys()`` raises,
    and a store that went away raises instead of giving the default."""
    port = free_port()
    follower = subprocess.Popen(
        [sys.executable, "-c", _FOLLOWER, str(port)], stdout=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        store = tdist.TCPStore("127.0.0.1", port, 2, is_master=True,
                               timeout=timedelta(seconds=20))
        kv = coordinator.DistributedKV(store)
        kv.set("t/k", "v1")
        kv.set("t/k", "v2")
        kv.set("t/gone", "x")
        kv.delete("t/gone")
        leader = coordinator.Coordinator(2, mode="kofn", num_aggregate=1,
                                         kv=kv)
        masks = [leader.participation_mask(1).tolist()]
        leader.report_duration(0, 1, 0.5)
        leader.report_duration(1, 1, 0.1)
        masks += [leader.participation_mask(s).tolist() for s in (2, 3)]
        assert masks == [[1, 0], [0, 1], [0, 1]]
        assert store.get("run/dur/0") == json.dumps([1, 0.5]).encode()
        assert store.get("run/mask/2") == json.dumps([0.0, 1.0]).encode()
        store.wait(["t/follower_done"])
        first = json.loads(follower.stdout.readline())
        assert first == {"masks": masks, "overwritten": "v2",
                         "missing": "dflt", "deleted": "dflt",
                         "keys": "raises"}
        del kv, leader, store                # the server goes away
        second = json.loads(follower.stdout.readline())
        assert second["dead"] != "no error"
        assert follower.wait(timeout=30) == 0
    finally:
        follower.kill()
        follower.wait(timeout=10)
