"""The port's sharded wire update (``ps_pytorch_tpu_torch/parallel/
zero_wire.py``, ``--shard-wire``) against the JAX package's, on the CPU.

- ``bench_suite.bench_zero``'s inputs (24 leaves of 1 MiB, SGD lr 0.05
  momentum 0.9, 5 rounds) at 1, 2 and 4 shards reproduce BENCH_ZERO_r18:
  its params sha256, its largest owner's wire bytes and optimizer-state
  bytes.
- The cases of ``tests/test_zero_wire.py`` on the port, each held against
  the JAX updater on the same inputs: shard plans, sharded == replicated
  bitwise for the SGD and Adam option matrix at 1/2/4/5 shards, the codec
  on, K-of-N with a straggler, handoff/adopt mid-run, ``state_dict``
  restores, the elastic primitive on the armoured codec, and the config's
  refusals with the JAX messages.
- Across packages over one ``dir:`` FileKV: each reads the other's shard
  publish, adopts the other's handoff, and resumes the other's ``"zero"``
  checkpoint, bitwise.
- The trainers: MultiSliceTrainer and AsyncTrainer checkpoint and resume
  the sharded state; a resumed in-process run (its loaders positioned as
  the uninterrupted run's) ends bitwise where the uninterrupted one ends.
- The TCPStore KV takes a ResNet-18 shard (~19 MB) in parts.
- Two processes on ``--shard-wire`` through the launcher, then a resumed
  launch.
"""

import base64
import hashlib
import io
import json
import re
import shutil
from contextlib import redirect_stdout
from datetime import timedelta
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import free_port
from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.parallel import zero_wire as jax_zw
from ps_pytorch_tpu.parallel.async_dp import (
    StaleGradientAggregator as JaxAggregator,
)
from ps_pytorch_tpu.runtime.coordinator import FileKV as JaxFileKV
from ps_pytorch_tpu.runtime.coordinator import KVStore as JaxKVStore
from ps_pytorch_tpu.runtime.multislice import (
    MultiSliceTrainer as JaxMultiSlice,
)
from ps_pytorch_tpu_torch import config, telemetry
from ps_pytorch_tpu_torch.elastic.rebalance import (
    ShardedKVUpdate, _decode, _encode,
)
from ps_pytorch_tpu_torch.parallel import zero_wire
from ps_pytorch_tpu_torch.parallel.async_dp import (
    StaleGradientAggregator, tree_flatten,
)
from ps_pytorch_tpu_torch.parallel.zero_wire import (
    ZeroWireUpdater, decode_array, encode_array, plan_wire_shards,
)
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime import coordinator
from ps_pytorch_tpu_torch.runtime.async_trainer import AsyncTrainer
from ps_pytorch_tpu_torch.runtime.coordinator import (
    DistributedKV, FileKV, KVStore,
)
from ps_pytorch_tpu_torch.runtime.multislice import MultiSliceTrainer
from ps_pytorch_tpu_torch.tools import launch
from test_torch_train import two_torch_threads  # noqa: F401

BENCH_SHA = "ce8875b84688cfb7cac024a3f425a2e15ef2e5b3291a87dbeb6f23a69df5f9e3"


@pytest.fixture(autouse=True)
def no_default_tracer():
    yield
    telemetry.set_default_tracer(None)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((37, 5)).astype(np.float32),
            "b": rng.standard_normal((128,)).astype(np.float32),
            "c": {"w": rng.standard_normal((64, 7)).astype(np.float32),
                  "bias": rng.standard_normal((7,)).astype(np.float32),
                  "s": np.float32(0.3)}}


def _grads(n, seed=1):
    rng = np.random.default_rng(seed)
    leaves, treedef = tree_flatten(_tree())
    return [zero_wire.tree_unflatten(treedef, [
        rng.standard_normal(np.shape(a)).astype(np.float32) for a in leaves])
        for _ in range(n)]


def _leaves(tree) -> list:
    return [np.asarray(a) for a in tree_flatten(tree)[0]]


def _assert_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def _run_sharded(n_shards, grads, optimizer, mod=zero_wire, kv=None,
                 workers=0, **kw):
    """n_shards single-owner members over one KV; each member assembles
    the same full tree every round (publish ALL before assembling)."""
    kv = kv if kv is not None else (KVStore() if mod is zero_wire
                                    else JaxKVStore())
    members = list(range(n_shards))
    ups = [mod.ZeroWireUpdater(inner=None, kv=kv, run_id="t", params=_tree(),
                               optimizer=optimizer, members=members, me=m,
                               n_shards=n_shards, workers=workers, **kw)
           for m in members]
    out = None
    for step, g in enumerate(grads):
        for u in ups:
            u.apply_and_publish(g, version=step + 1)
        trees = [u.assemble_round() for u in ups]
        out = trees[0]
        for t in trees[1:]:
            _assert_equal(out, t)
    return out, ups, kv


# ---- BENCH_ZERO_r18 reproduced ----

@pytest.mark.parametrize("n_shards,out_mb,opt_mb", [
    (1, 157.286, 25.166), (2, 85.197, 13.631), (4, 45.875, 7.34)])
def test_bench_zero_inputs_reproduce_bench_zero_r18(n_shards, out_mb,
                                                    opt_mb):
    rng = np.random.default_rng(0)
    per_leaf = 1024 * 1024 // 4
    tree = {f"l{i:04d}": rng.normal(size=(per_leaf,)).astype(np.float32)
            / 4.0 for i in range(24)}
    kv, members = KVStore(), list(range(n_shards))
    ups = [ZeroWireUpdater(inner=None, kv=kv, run_id="bench/zw", params=tree,
                           optimizer="sgd", members=members, me=m,
                           n_shards=n_shards, workers=4, lr=0.05,
                           momentum=0.9) for m in members]
    grng = np.random.default_rng(1)
    for rnd in range(5):
        g = {k: grng.normal(size=v.shape).astype(np.float32) / 8.0
             for k, v in tree.items()}
        for u in ups:
            u.apply_and_publish(g, version=rnd + 1)
        full = [u.assemble_round() for u in ups][0]
    h = hashlib.sha256()
    for k in sorted(full):
        h.update(np.ascontiguousarray(full[k], np.float32).tobytes())
    assert h.hexdigest() == BENCH_SHA
    assert round(max(u.wire_stats()["zw_bytes_out"] for u in ups) / 1e6,
                 3) == out_mb
    assert round(max(u.opt_state_nbytes() for u in ups) / 1e6, 3) == opt_mb


# ---- shard plans ----

@pytest.mark.parametrize("n", (1, 2, 3, 4, 5, 7))
def test_plan_wire_shards_like_jax(n):
    leaves = _leaves(_tree())
    bounds = plan_wire_shards(leaves, n)
    assert bounds == jax_zw.plan_wire_shards(leaves, n)
    assert len(bounds) == n
    assert bounds[0][0] == 0 and bounds[-1][1] == len(leaves)
    for (lo, hi), (lo2, hi2) in zip(bounds, bounds[1:]):
        assert lo <= hi == lo2 <= hi2
    # Tensors plan like their numpy values (nbytes without a transfer).
    assert plan_wire_shards([torch.as_tensor(l) for l in leaves], n) == \
        bounds


def test_plan_wire_shards_edges_like_jax():
    from ps_pytorch_tpu_torch.parallel.buckets import plan_buckets
    rng = np.random.default_rng(3)
    leaves = [rng.standard_normal((256,)).astype(np.float32)
              for _ in range(32)]
    bucket_bytes = 4 * 256 * 4
    edges = {b.start for b in plan_buckets(leaves, bucket_bytes)} \
        | {len(leaves)}
    for n in (2, 3, 4):
        got = plan_wire_shards(leaves, n, bucket_bytes)
        assert got == jax_zw.plan_wire_shards(leaves, n, bucket_bytes)
        assert all(lo in edges and hi in edges for lo, hi in got)
    two = [np.zeros(4, np.float32), np.zeros(4, np.float32)]
    assert plan_wire_shards(two, 5) == jax_zw.plan_wire_shards(two, 5)
    assert sum(hi - lo for lo, hi in plan_wire_shards(two, 5)) == 2
    eight = [np.zeros(1000, np.float32) for _ in range(8)]
    assert all(hi > lo for lo, hi in plan_wire_shards(eight, 4, 4 << 20))
    with pytest.raises(ValueError):
        plan_wire_shards(eight, 0)


# ---- sharded == replicated == the JAX package, bitwise ----

@pytest.mark.parametrize("optimizer,kw", [
    ("sgd", dict(lr=0.05, momentum=0.0)),
    ("sgd", dict(lr=0.05, momentum=0.9)),
    ("sgd", dict(lr=0.05, momentum=0.9, nesterov=True)),
    ("sgd", dict(lr=0.05, momentum=0.9, weight_decay=1e-4)),
    ("adam", dict(lr=0.001)),
    ("adam", dict(lr=0.001, amsgrad=True, weight_decay=1e-3)),
])
def test_sharded_equals_replicated_and_jax_bitwise(optimizer, kw):
    grads = _grads(6)
    ref, _, _ = _run_sharded(1, grads, optimizer, **kw)
    jax_ref, _, _ = _run_sharded(1, grads, optimizer, mod=jax_zw, **kw)
    _assert_equal(ref, jax_ref)
    for n in (2, 4, 5):
        got, ups, kv = _run_sharded(n, grads, optimizer,
                                    workers=2 if n == 4 else 0, **kw)
        _assert_equal(ref, got)
        total = sum(u.opt_state_nbytes() for u in ups)
        assert all(u.opt_state_nbytes() <= total for u in ups)
        reader = ZeroWireUpdater(inner=None, kv=kv, run_id="t",
                                 params=_tree(), optimizer=optimizer,
                                 members=list(range(n)), me=None,
                                 n_shards=n, **kw)
        version, tree = reader.fetch(-1)
        assert version == len(grads)
        _assert_equal(ref, tree)
        assert reader.fetch(len(grads)) is None


def test_codec_on_and_kofn_straggler_sharded_equal_replicated():
    """topk pooled in the compressed domain, then K-of-N with a stale
    straggler: the pool (delegated untouched) picks the same contributors
    as the JAX pool, and the sharded update equals the replicated one and
    the JAX updater's."""
    def topk_avgs(agg_cls):
        agg = agg_cls(2, compress=True, codec="topk", topk_frac=0.25)
        outs = []
        for step in range(4):
            for sid, gseed in ((0, 10 + step), (1, 20 + step)):
                agg.submit(sid, step, _grads(1, seed=gseed)[0])
            avg, pool = agg.collect(step)
            assert len(pool["used"]) == 2
            agg.consume(pool["used"])
            outs.append(avg)
        return outs

    def kofn_avgs(agg_cls):
        agg = agg_cls(2, staleness_limit=4, num_aggregate=1)
        outs = []
        for step in range(5):
            agg.submit(0, step, _grads(1, seed=30 + step)[0])
            if step == 0:
                agg.submit(1, 0, _grads(1, seed=99)[0])
            avg, pool = agg.collect(step)
            agg.consume(pool["used"])
            agg.drop_older_than(step)
            outs.append((avg, pool["used"]))
        return outs

    for avgs, jax_avgs in (
            (topk_avgs(StaleGradientAggregator), topk_avgs(JaxAggregator)),
            ([a for a, _ in kofn_avgs(StaleGradientAggregator)],
             [a for a, _ in kofn_avgs(JaxAggregator)])):
        rep = ZeroWireUpdater(inner=None, kv=KVStore(), run_id="r",
                              params=_tree(), members=[0], me=0, n_shards=1,
                              lr=0.05, momentum=0.9)
        jrep = jax_zw.ZeroWireUpdater(inner=None, kv=JaxKVStore(),
                                      run_id="r", params=_tree(),
                                      members=[0], me=0, n_shards=1,
                                      lr=0.05, momentum=0.9)
        kv = KVStore()
        shd = [ZeroWireUpdater(inner=None, kv=kv, run_id="s", params=_tree(),
                               members=[0, 1, 2, 3], me=m, n_shards=4,
                               lr=0.05, momentum=0.9) for m in range(4)]
        for v, (avg, javg) in enumerate(zip(avgs, jax_avgs)):
            ref = rep.update_from(avg, version=v + 1)
            _assert_equal(ref, jrep.update_from(javg, version=v + 1))
            for u in shd:
                u.apply_and_publish(avg, version=v + 1)
            _assert_equal(ref, [u.assemble_round() for u in shd][0])
    assert [u for _, u in kofn_avgs(StaleGradientAggregator)] == \
        [u for _, u in kofn_avgs(JaxAggregator)]


def test_handoff_adopt_mid_run_across_packages(tmp_path):
    """A fleet of four over one dir: FileKV, members 0 and 2 the JAX
    package's updaters and 1 and 3 the port's: each round every member
    assembles the others' shards; then 4 -> 2 members mid-run, the port's
    members handing their params and moments to the JAX members through
    the KV (values moved, never recomputed). The continued run equals the
    never-resharded replicated run bitwise."""
    grads = _grads(6)
    root = str(tmp_path / "kv")
    ups = [(jax_zw if m % 2 == 0 else zero_wire).ZeroWireUpdater(
        inner=None, kv=JaxFileKV(root) if m % 2 == 0 else FileKV(root),
        run_id="h", params=_tree(), members=[0, 1, 2, 3], me=m, n_shards=4,
        lr=0.05, momentum=0.9) for m in range(4)]
    for step, g in enumerate(grads[:3]):
        for u in ups:
            u.apply_and_publish(g, version=step + 1)
        trees = [u.assemble_round() for u in ups]
        for t in trees[1:]:
            _assert_equal(trees[0], t)
    for u in ups:
        assert u.handoff([0, 2])
    for u in ups:
        assert u.adopt([0, 2])
    assert all(u.counters["rebalances"] == 1 for u in ups)
    assert ups[1].opt_state_nbytes() == ups[3].opt_state_nbytes() == 0
    assert ups[1].owned_shards() == []
    live = [ups[0], ups[2]]
    for step, g in enumerate(grads[3:]):
        for u in live:
            u.apply_and_publish(g, version=10 + step)
        trees = [u.assemble_round() for u in live]
        _assert_equal(trees[0], trees[1])
    ref, _, _ = _run_sharded(1, grads, "sgd", lr=0.05, momentum=0.9)
    _assert_equal(ref, trees[0])
    assert not ups[0].set_members(ups[0].members)


def test_readers_assemble_the_other_packages_publish(tmp_path):
    """One dir: FileKV: a JAX reader-mode updater assembles the port's
    publish, a port reader the JAX package's; the keys and the pointer
    are the same bytes."""
    grads = _grads(3)
    for writer_mod, reader_mod, kv_cls, rd_cls, sub in (
            (zero_wire, jax_zw, FileKV, JaxFileKV, "p2j"),
            (jax_zw, zero_wire, JaxFileKV, FileKV, "j2p")):
        root = str(tmp_path / sub)
        ref, _, _ = _run_sharded(3, grads, "adam", mod=writer_mod,
                                 kv=kv_cls(root), lr=1e-3)
        reader = reader_mod.ZeroWireUpdater(
            inner=None, kv=rd_cls(root), run_id="t", params=_tree(),
            optimizer="adam", members=[0, 1, 2], me=None, n_shards=3,
            lr=1e-3)
        version, tree = reader.fetch(-1)
        assert version == 3
        _assert_equal(ref, tree)
    keys = sorted(FileKV(str(tmp_path / "p2j")).keys("t/zw"))
    assert keys == sorted(FileKV(str(tmp_path / "j2p")).keys("t/zw"))
    assert "t/zw/1/p/0/2" in keys and "t/zw/ver" in keys
    for k in keys:
        assert FileKV(str(tmp_path / "p2j")).get(k) == \
            FileKV(str(tmp_path / "j2p")).get(k), k


@pytest.mark.parametrize("optimizer,kw", [
    ("sgd", dict(lr=0.05, momentum=0.9)), ("adam", dict(lr=0.001))])
def test_state_dict_restores_bit_for_bit_across_packages(optimizer, kw):
    """Interrupt and restore at the updater: a fresh updater of either
    package, fed the saved params and state_dict, continues exactly like
    the uninterrupted one."""
    grads = _grads(8)
    u = ZeroWireUpdater(inner=None, kv=KVStore(), run_id="c", params=_tree(),
                        optimizer=optimizer, members=[0], me=0, n_shards=4,
                        **kw)
    for step, g in enumerate(grads[:4]):
        mid = u.update_from(g, version=step + 1)
    saved = u.state_dict()
    assert sorted(saved) == ["epoch", "optimizer", "shards", "step"]
    for step, g in enumerate(grads[4:]):
        ref = u.update_from(g, version=5 + step)
    for mod, kv in ((zero_wire, KVStore()), (jax_zw, JaxKVStore())):
        u2 = mod.ZeroWireUpdater(inner=None, kv=kv, run_id="c2", params=mid,
                                 optimizer=optimizer, members=[0], me=0,
                                 n_shards=4, **kw)
        u2.load_state_dict(saved, params=mid)
        for step, g in enumerate(grads[4:]):
            got = u2.update_from(g, version=5 + step)
        _assert_equal(ref, got)
    other = "adam" if optimizer == "sgd" else "sgd"
    with pytest.raises(ValueError, match="checkpoint is for"):
        ZeroWireUpdater(inner=None, kv=KVStore(), run_id="x", params=mid,
                        optimizer=other, lr=1e-3).load_state_dict(saved)


def test_rebalance_uses_armored_base85_and_counts_bytes():
    a = np.arange(1000, dtype=np.float32)
    text = _encode(a)
    assert text == base64.b85encode(a.tobytes()).decode("ascii")
    assert text == encode_array(a) == jax_zw.encode_array(a)
    np.testing.assert_array_equal(_decode(text, np.float32), a)
    np.testing.assert_array_equal(decode_array(text, np.float32), a)
    kv, members = KVStore(), [0, 1]
    ups = [ShardedKVUpdate(kv, "rb", 1000, members, m, lr=0.05, momentum=0.9)
           for m in members]
    p0 = np.random.default_rng(5).standard_normal(1000).astype(np.float32)
    g = np.random.default_rng(6).standard_normal(1000).astype(np.float32)
    for u in ups:
        u.init(p0)
    for u in ups:
        u.publish(g)
    full = [u.assemble() for u in ups][0]
    np.testing.assert_array_equal(
        full, ShardedKVUpdate.replicated_reference(p0, [g], 0.05, 0.9))
    np.testing.assert_array_equal(full, jax_zw.ShardedKVUpdate
                                  .replicated_reference(p0, [g], 0.05, 0.9))
    assert all(u.wire_stats()["shard_bytes_out"] > 0 for u in ups)
    assert all(u.wire_stats()["shard_bytes_in"] > 0 for u in ups)


# ---- the config ----

@pytest.mark.parametrize("kw", [
    dict(shard_update=True), dict(mode="sync"),
    dict(sync_topology="hier", compress_grad=True, grad_codec="int8lat"),
    dict(compress_grad=True, grad_codec="int8"), dict(lr_schedule="cosine"),
])
def test_shard_wire_config_rejections_like_jax(kw):
    msgs = []
    for mod in (config, jax_config):
        with pytest.raises(ValueError) as e:
            mod.TrainConfig(**dict(dict(mode="async", shard_wire=True,
                                        eval_freq=0), **kw))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_shard_wire_config_compositions(monkeypatch):
    config.TrainConfig(mode="async", shard_wire=True)
    config.TrainConfig(mode="async", shard_wire=True, compress_grad=True,
                       grad_codec="topk", ef=True)
    config.TrainConfig(mode="async", shard_wire=True, compress_grad=True,
                       grad_codec="blosc", fused_optimizer=True)
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "2")
    assert config.TrainConfig(mode="async", shard_wire=True).shard_wire


# ---- the trainers ----

def _cfg(train_dir, **kw):
    base = dict(dataset="synthetic_mnist", network="LeNet", batch_size=64,
                lr=0.05, momentum=0.9, compute_dtype="float32",
                mode="async", max_steps=4, eval_freq=4, log_every=100,
                train_dir=str(train_dir), shard_wire=True, resume=True)
    base.update(kw)
    return config.TrainConfig(**base)


def _quiet(fn):
    with redirect_stdout(io.StringIO()):
        return fn()


def test_multislice_resume_restores_exactly_and_continues_bitwise(tmp_path):
    """Checkpoint at 2 of 4 ticks: the resumed trainer holds the saved
    parameters and sharded state bitwise, and, its loaders positioned as
    the uninterrupted run's (a resume starts them over, as in the JAX
    trainer), ends at 4 bitwise where the uninterrupted run ends."""
    full = MultiSliceTrainer(_cfg(tmp_path / "full", eval_freq=0),
                             n_slices=2, device="cpu")
    _quiet(full.train)
    first = MultiSliceTrainer(_cfg(tmp_path / "r", max_steps=2,
                                   eval_freq=2), n_slices=2, device="cpu")
    _quiet(first.train)
    saved, p_mid = first.aggregator.state_dict(), first._wire_tree(
        first.params)
    second = MultiSliceTrainer(_cfg(tmp_path / "r", eval_freq=2),
                               n_slices=2, device="cpu")
    assert _quiet(second.maybe_resume) and second.step == 2
    _assert_equal(p_mid, second._wire_tree(second.params))
    restored = second.aggregator.state_dict()
    assert restored["step"] == saved["step"] == 2
    for k, fields in saved["shards"].items():
        for f, arr in fields.items():
            np.testing.assert_array_equal(arr, restored["shards"][k][f])
    for loader in second.train_loaders:
        loader.fast_forward(2)
    second.cfg.resume = False
    _quiet(second.train)
    assert second.step == 4
    _assert_equal(full._wire_tree(full.params),
                  second._wire_tree(second.params))
    extra = ckpt.load_extra_state(str(tmp_path / "r"), 4)
    assert extra["zero"]["step"] == 4 and \
        sorted(extra["zero"]["shards"]) == ["0", "1"]


def test_zero_checkpoints_resume_across_packages(tmp_path):
    """The port's MultiSliceTrainer checkpoint resumes in the JAX trainer
    and the JAX trainer's in the port's, with the same sharded state."""
    def jax_trainer(train_dir, **kw):
        return JaxMultiSlice(jax_config.TrainConfig(**json.loads(
            _cfg(train_dir, **kw).to_json())), n_slices=2,
            devices=jax.devices()[:2])

    port = MultiSliceTrainer(_cfg(tmp_path / "p", max_steps=2, eval_freq=2),
                             n_slices=2, device="cpu")
    _quiet(port.train)
    jtr = jax_trainer(tmp_path / "j", max_steps=2, eval_freq=2)
    _quiet(jtr.train)
    pairs = ((port, jax_trainer(tmp_path / "p", max_steps=8)),
             (jtr, MultiSliceTrainer(_cfg(tmp_path / "j", max_steps=8),
                                     n_slices=2, device="cpu")))
    for saved, resumed in pairs:
        assert _quiet(resumed.maybe_resume) and resumed.step == 2
        a, b = saved.aggregator.state_dict(), resumed.aggregator.state_dict()
        assert a["step"] == b["step"] == 2
        assert sorted(a["shards"]) == sorted(b["shards"]) == ["0", "1"]
        for k, fields in a["shards"].items():
            for f, arr in fields.items():
                np.testing.assert_array_equal(arr, b["shards"][k][f])


def test_async_trainer_shard_wire_runs_and_resumes_bitwise(tmp_path,
                                                           monkeypatch):
    """The leader owns every shard, publishes the parameters a shard a
    key (its channel's payload holds the BatchNorm statistics only),
    checkpoints the sharded state, and a resumed run is bitwise the
    uninterrupted one."""
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "2")
    kw = dict(batch_size=128, max_steps=6, eval_freq=3, resume=False,
              fused_optimizer=True)
    cfg = _cfg(tmp_path, **kw)
    cfg_resume = _cfg(tmp_path, **dict(kw, resume=True))
    monkeypatch.delenv("PS_TPU_NUM_PROCESSES")
    t = AsyncTrainer(cfg, kv=KVStore(), device="cpu",
                     printer=lambda line: None)
    assert set(t.transport.param_ch.treedef) == {"bs0"}
    _quiet(t.train)
    assert t.version == t.applied == 6
    assert t.aggregator.wire_stats()["zw_bytes_out"] > 0
    assert t.aggregator.n_shards == 2 and t.aggregator.owned_shards() == \
        [0, 1]
    assert np.isfinite(t.evaluate(max_batches=1)["loss"])
    end = {k: v.detach().clone() for k, v in t.params.items()}
    extra = ckpt.load_extra_state(cfg.train_dir, 6)
    assert extra["zero"]["step"] == 6
    shutil.rmtree(ckpt.checkpoint_path(cfg.train_dir, 6))
    t2 = AsyncTrainer(cfg_resume, kv=KVStore(), device="cpu",
                      printer=lambda line: None)
    out = io.StringIO()
    with redirect_stdout(out):
        t2.train()
    assert "RESUME from" in out.getvalue() and "at step 3" in out.getvalue()
    for k, v in t2.params.items():
        assert torch.equal(v, end[k]), k


# ---- the TCPStore takes a shard in parts ----

def test_distributed_kv_stores_large_values_in_parts(monkeypatch):
    store = torch.distributed.TCPStore("127.0.0.1", free_port(), 1, True,
                                       timeout=timedelta(seconds=30))
    kv = DistributedKV(store)
    shard = encode_array(np.random.default_rng(0).standard_normal(
        3_724_654).astype(np.float32))     # a ResNet-18 shard of three
    assert len(shard) > 8 << 20 > coordinator.PART_CHARS
    kv.set("zw-42/zw/1/p/0/3", shard)
    assert kv.get("zw-42/zw/1/p/0/3") == shard
    monkeypatch.setattr(coordinator, "PART_CHARS", 10)
    kv.set("k", "x" * 25)
    parts = list(kv._parts["k"])
    assert len(parts) == 3 and kv.get("k") == "x" * 25
    kv.set("k", "short")                  # the old parts go
    assert kv.get("k") == "short" and kv.get(parts[0]) is None
    kv.set("k", "y" * 25)
    store.delete_key(kv._parts["k"][1])   # a torn read: absent
    assert kv.get("k", "gone") == "gone"
    kv.delete("k")
    assert kv.get("k") is None and "k" not in kv._parts
    kv.delete("zw-42/zw/1/p/0/3")
    assert kv.get("zw-42/zw/1/p/0/3") is None


# ---- two processes through the launcher, then a resumed launch ----

def test_two_processes_shard_wire_and_resume(tmp_path, monkeypatch):
    td = tmp_path / "td"
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    def run(name, max_steps, resume):
        run_dir = tmp_path / name
        out = io.StringIO()
        try:
            with redirect_stdout(out):
                rc = launch.main([
                    "launch", "--run-dir", str(run_dir), "--simulate", "2",
                    "--port", str(free_port()), "--wait", "--timeout",
                    "180", "--", "--device", "cpu", "--mode", "async",
                    "--network", "LeNet", "--dataset", "synthetic_mnist",
                    "--batch-size", "128", "--compute-dtype", "float32",
                    "--lr", "0.05", "--eval-freq", "4", "--log-every",
                    "2", "--staleness-limit", "8", "--shard-wire", "true",
                    "--train-dir", str(td), "--max-steps", str(max_steps),
                    "--resume", resume])
        finally:
            launch.main(["kill", "--run-dir", str(run_dir), "--grace", "1"])
        logs = [Path(run_dir, f"proc_{r}.log").read_text() for r in range(2)]
        detail = out.getvalue() + "\n\n".join(l[-2000:] for l in logs)
        assert rc == 0, detail
        finals = [re.findall(r"^FINAL .*$", log, re.M) for log in logs]
        assert len(finals[0]) == 1 and finals[0] == finals[1], detail
        return logs, detail

    logs, detail = run("run1", 8, "false")
    assert ckpt.committed_steps(str(td)) == [4, 8], detail
    zero = ckpt.load_extra_state(str(td), 8)["zero"]
    assert zero["step"] == 8 and sorted(zero["shards"]) == ["0", "1"]
    logs, detail = run("run2", 12, "true")
    assert re.search(r"^RESUME from \S+model_step_8 at step 8$", logs[0],
                     re.M), detail
    assert ckpt.committed_steps(str(td))[-1] == 12, detail
    assert ckpt.load_extra_state(str(td), 12)["zero"]["step"] == 12
