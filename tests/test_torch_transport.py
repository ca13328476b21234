"""The port's KV wire (``ps_pytorch_tpu_torch/parallel/transport.py``)
against the JAX package's ``parallel/transport.py``, on the CPU.

The port's versions of ``tests/test_transport.py`` (round trip and meta,
structure check, the GC's reader window, base85 on the wire, chunking and
its exact multiple, 0-d and empty leaves, bucketed equal to blocking, the
legacy format at bucket size 0, the parameter channel and ``done``, the
byte counters); corruption (a chunk that fails its digest, torn meta JSON)
reading as None and counted; and across packages: the same tree published
by each package's channel into its own in-process store gives the same
keys and the same value bytes (sha256), for raw and blosc at bucket size 0
and above, and each package reads the other's payload back. The int8
wire: one gradient tree through the port's AsyncTrainer encoder (its
layout change on the device, one quantize launch) and through the JAX
trainer's encoder with the same (JAX) noise gives the same ``v`` and ``s``
leaf by leaf and the same chunk bytes.
"""

import base64
import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu import compression as jax_compression
from ps_pytorch_tpu.ops import quantize as jax_quantize
from ps_pytorch_tpu.parallel import transport as jax_transport
from ps_pytorch_tpu.runtime.coordinator import KVStore as JaxKVStore
from ps_pytorch_tpu_torch import compression
from ps_pytorch_tpu_torch.config import TrainConfig
from ps_pytorch_tpu_torch.models.convert import leaf_layout, nest
from ps_pytorch_tpu_torch.parallel import transport
from ps_pytorch_tpu_torch.parallel.async_dp import tree_flatten
from ps_pytorch_tpu_torch.parallel.transport import (
    KVGradientTransport, KVPytreeChannel, _CHUNK,
)
from ps_pytorch_tpu_torch.runtime.async_trainer import AsyncTrainer
from ps_pytorch_tpu_torch.runtime.coordinator import KVStore
from ps_pytorch_tpu_torch.telemetry import set_default_tracer
from test_torch_train import two_torch_threads  # noqa: F401


def _tree(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(17, 9)).astype(np.float32) * scale,
            "b": rng.normal(size=(9,)).astype(np.float32) * scale}


def _tensors(tree):
    """The tree with each leaf a CPU tensor (0-d leaves included)."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _payload(kv):
    """All chunk key/values on a store (meta and pointer excluded)."""
    return {k: v for k, v in kv._d.items()
            if not (k.endswith("/meta") or k.endswith("/ver"))}


# ------------------------------------------------ the JAX package's cases --

def test_channel_roundtrip_and_meta():
    kv = KVStore()
    ch = KVPytreeChannel(kv, "t/ch", _tree())
    t = _tree(1)
    ch.publish(3, t, meta={"step": 7})
    ver, got, meta = ch.read()
    assert ver == 3 and meta["step"] == 7
    for k in t:
        np.testing.assert_array_equal(got[k], t[k])


def test_channel_rejects_wrong_structure():
    ch = KVPytreeChannel(KVStore(), "t/ch", _tree())
    with pytest.raises(ValueError, match="structure"):
        ch.publish(1, {"only_w": np.zeros(3, np.float32)})


def test_channel_gc_keeps_reader_window():
    kv = KVStore()
    ch = KVPytreeChannel(kv, "t/ch", _tree())
    for v in range(5):
        ch.publish(v, _tree(v))
    assert ch.read(4) is not None and ch.read(3) is not None
    assert ch.read(2) is None and ch.read(0) is None
    assert kv.get("t/ch/0/0/0") is None     # no orphaned payload keys


def test_wire_is_compressed_base85():
    kv = KVStore()
    t = {"w": np.zeros((256, 256), np.float32)}
    ch = KVPytreeChannel(kv, "t/ch", t)
    ch.publish(1, t)
    raw = base64.b85decode(kv.get("t/ch/1/0/0").encode("ascii"))
    assert len(raw) < t["w"].nbytes / 10
    np.testing.assert_array_equal(compression.g_decompress(raw), t["w"])


def test_chunking_large_leaf():
    kv = KVStore()
    t = {"w": np.random.default_rng(0).normal(size=(400, 400))
         .astype(np.float32)}
    ch = KVPytreeChannel(kv, "t/ch", t)
    ch.publish(1, t)
    n_chunks = json.loads(kv.get("t/ch/1/meta"))["chunks"][0]
    assert n_chunks >= 2
    assert all(len(kv.get(f"t/ch/1/0/{c}")) <= _CHUNK
               for c in range(n_chunks))
    np.testing.assert_array_equal(ch.read()[1]["w"], t["w"])


def test_transport_poll_latest_wins_and_staleness_meta():
    kv = KVStore()
    tpl = _tree()
    tr_w = KVGradientTransport(kv, 2, tpl, tpl, run_id="r")
    tr_ps = KVGradientTransport(kv, 2, tpl, tpl, run_id="r")
    tr_w.submit_grads(0, seq=1, step=0, grads=_tree(1))
    tr_w.submit_grads(0, seq=2, step=1, grads=_tree(2))
    tr_w.submit_grads(1, seq=1, step=0, grads=_tree(3))
    got = tr_ps.poll_new_grads()
    assert sorted((s, step) for s, step, _ in got) == [(0, 1), (1, 0)]
    assert tr_ps.poll_new_grads() == []
    tr_w.submit_grads(1, seq=2, step=2, grads=_tree(4))
    assert [(s, step) for s, step, _ in tr_ps.poll_new_grads()] == [(1, 2)]


def test_wire_stats_count_armoured_bytes():
    kv = KVStore()
    tpl = _tree()
    writer = KVGradientTransport(kv, 1, tpl, tpl, run_id="r")
    reader = KVGradientTransport(kv, 1, tpl, tpl, run_id="r")
    assert writer.wire_stats() == {"wire_bytes_out": 0, "wire_bytes_in": 0,
                                   "wire_raw_bytes_out": 0,
                                   "param_publishes": 0,
                                   "last_param_publish_bytes": 0,
                                   "wire_read_errors": 0,
                                   "wire_integrity_failures": 0}
    writer.submit_grads(0, seq=1, step=0, grads=_tree(1))
    writer.publish_params(1, _tree(2))
    st = writer.wire_stats()
    assert st["wire_raw_bytes_out"] == 2 * sum(
        a.nbytes for a in _tree(0).values())
    assert st["param_publishes"] == 1
    assert 0 < st["last_param_publish_bytes"] <= st["wire_bytes_out"]
    reader.poll_new_grads()
    reader.fetch_params()
    assert reader.wire_stats()["wire_bytes_in"] == st["wire_bytes_out"] > 0
    raw = sum(a.nbytes for a in _tree(1).values())
    assert st["last_param_publish_bytes"] < raw * 1.4 + 4096


def test_chunk_boundary_exact_multiple(monkeypatch):
    monkeypatch.setattr(transport, "_CHUNK", 5)
    t = {"w": np.arange(600, dtype=np.float32)}
    kv = KVStore()
    ch = KVPytreeChannel(kv, "t/ch", t, codec="raw")
    ch.publish(1, t)
    n = json.loads(kv.get("t/ch/1/meta"))["chunks"][0]
    assert all(len(kv.get(f"t/ch/1/0/{c}")) == 5 for c in range(n))
    assert kv.get(f"t/ch/1/0/{n}") is None
    np.testing.assert_array_equal(ch.read()[1]["w"], t["w"])
    assert ch.bytes_out == ch.bytes_in == n * 5


@pytest.mark.parametrize("codec", ["raw", "blosc"])
def test_zero_d_and_empty_leaf_roundtrip(codec):
    t = {"s": np.float32(3.5), "e": np.zeros((0, 4), np.float32),
         "w": np.ones((3,), np.float32)}
    ch = KVPytreeChannel(KVStore(), "t/ch", t, codec=codec)
    ch.publish(1, t)
    _, got, _ = ch.read()
    assert np.asarray(got["s"]).item() == 3.5 and got["s"].shape == ()
    assert got["e"].shape == (0, 4) and got["e"].dtype == np.float32
    np.testing.assert_array_equal(got["w"], t["w"])


def _bucket_tree(codec, rng):
    if codec == "int8":
        return {f"l{i}": {"v": rng.integers(-127, 128, (n,), dtype=np.int8),
                          "s": rng.normal(size=(max(n // 256, 1),))
                          .astype(np.float32)}
                for i, n in enumerate([3000, 64, 9000, 1, 700])}
    return {f"l{i}": rng.normal(size=(n,)).astype(np.float32)
            for i, n in enumerate([700, 3, 1500, 1, 400, 4096])}


@pytest.mark.parametrize("as_tensors", [False, True])
@pytest.mark.parametrize("codec", ["raw", "blosc", "int8"])
@pytest.mark.parametrize("bucket_kb,workers", [(2, 0), (2, 2), (8, 4)])
def test_bucketed_wire_bitwise_identical_to_blocking(codec, bucket_kb,
                                                     workers, as_tensors):
    """Bucketing and threads are only a schedule: chunk keys and bytes,
    the "chunks" meta and the byte totals match the blocking wire, for
    numpy leaves and for tensors."""
    t = _bucket_tree(codec, np.random.default_rng(7))
    chan_codec = "blosc" if codec == "int8" else codec
    src = _tensors(t) if as_tensors else t
    kv_a, kv_b = KVStore(), KVStore()
    ch_a = KVPytreeChannel(kv_a, "t/ch", t, codec=chan_codec)
    ch_b = KVPytreeChannel(kv_b, "t/ch", t, codec=chan_codec,
                           bucket_bytes=bucket_kb * 1024, workers=workers)
    ch_a.publish(1, src)
    ch_b.publish(1, src)
    meta_a = json.loads(kv_a.get("t/ch/1/meta"))
    meta_b = json.loads(kv_b.get("t/ch/1/meta"))
    assert meta_a["chunks"] == meta_b["chunks"] and meta_a["crc"] == \
        meta_b["crc"]
    assert "buckets" not in meta_a
    assert sum(meta_b["buckets"]) == ch_b.n_leaves
    assert _payload(kv_a) == _payload(kv_b)
    assert (ch_a.bytes_out == ch_b.bytes_out
            == sum(len(v) for v in _payload(kv_a).values()))
    assert sum(ch_b.last_publish_bucket_bytes) == ch_b.last_publish_bytes
    rd = KVPytreeChannel(kv_b, "t/ch", t, codec=chan_codec,
                         bucket_bytes=bucket_kb * 1024, workers=workers)
    ver, got, _ = rd.read()
    assert ver == 1
    for a, b in zip(tree_flatten(t)[0], tree_flatten(got)[0]):
        np.testing.assert_array_equal(a, b)
    assert rd.bytes_in == ch_b.bytes_out
    for ch in (ch_a, ch_b, rd):
        ch.close()


def test_bucket_mb_zero_is_exact_legacy_format():
    t = _tree()
    kv_a, kv_b = KVStore(), KVStore()
    KVPytreeChannel(kv_a, "t/ch", t).publish(1, t, meta={"step": 4})
    KVPytreeChannel(kv_b, "t/ch", t, bucket_bytes=0,
                    workers=4).publish(1, t, meta={"step": 4})
    assert kv_a._d == kv_b._d


def test_transport_param_channel_and_done():
    kv = KVStore()
    tpl = _tree()
    tr = KVGradientTransport(kv, 1, tpl, tpl, run_id="r")
    assert tr.fetch_params() is None and tr.done() is None
    tr.publish_params(5, _tree(9))
    ver, params = tr.fetch_params()
    assert ver == 5
    np.testing.assert_array_equal(params["w"], _tree(9)["w"])
    tr.set_done(5)
    assert tr.done() == 5


# ------------------------------------------------------------ corruption --

@pytest.mark.parametrize("workers", [0, 2])
def test_corrupt_chunk_reads_as_none_and_counts(workers):
    kv = KVStore()
    t = {"w": np.random.default_rng(1).normal(size=(300, 300))
         .astype(np.float32), "b": np.ones(5, np.float32)}
    ch = KVPytreeChannel(kv, "t/ch", t, bucket_bytes=1024, workers=workers)
    ch.publish(1, t)
    key = "t/ch/1/1/1"                  # leaf "w" (sorted second), chunk 1
    text = kv.get(key)
    kv.set(key, text[:100] + ("0" if text[100] != "0" else "1") + text[101:])
    rd = KVPytreeChannel(kv, "t/ch", t, workers=workers)
    assert rd.read() is None
    assert rd.integrity_failures == 1 and rd.read_errors == 0
    kv.set(key, text)                   # healed: reads again
    np.testing.assert_array_equal(rd.read()[1]["w"], t["w"])


def test_torn_meta_reads_as_none_and_counts():
    kv = KVStore()
    ch = KVPytreeChannel(kv, "t/ch", _tree())
    ch.publish(2, _tree(1))
    kv.set("t/ch/2/meta", kv.get("t/ch/2/meta")[:-9])
    assert ch.read() is None
    assert ch.integrity_failures == 1
    kv.set("t/ch/2/meta", json.dumps({"nochunks": 1}))
    assert ch.read() is None and ch.integrity_failures == 2


def test_meta_without_digests_reads_unverified():
    """A writer that stamps no CRC (older JAX payloads) still reads."""
    kv = KVStore()
    ch = KVPytreeChannel(kv, "t/ch", _tree())
    ch.publish(1, _tree(3))
    meta = json.loads(kv.get("t/ch/1/meta"))
    del meta["crc"]
    kv.set("t/ch/1/meta", json.dumps(meta))
    np.testing.assert_array_equal(ch.read()[1]["w"], _tree(3)["w"])


# ------------------------------------------------------- across packages --

def _mixed_tree():
    """f32, bf16-derived f32, int8 and 0-d leaves in nested dicts."""
    rng = np.random.default_rng(11)
    bf16 = np.asarray(jnp.asarray(rng.normal(size=(70, 33)), jnp.bfloat16)
                      .astype(jnp.float32))
    return {"conv": {"kernel": rng.normal(size=(3, 3, 8, 16))
                     .astype(np.float32),
                     "bias": rng.normal(size=(16,)).astype(np.float32)},
            "bf16": bf16, "scalar": np.float32(-1.25),
            "q": {"v": rng.integers(-127, 128, (64, 128), dtype=np.int8),
                  "s": rng.random((2, 1), dtype=np.float32)},
            "big": rng.normal(size=(90_000,)).astype(np.float32)}


def _sha(kv_dict):
    return {k: hashlib.sha256(v.encode("ascii")).hexdigest()
            for k, v in kv_dict.items()}


@pytest.mark.parametrize("bucket_bytes", [0, 16 * 1024])
@pytest.mark.parametrize("codec", ["raw", "blosc"])
def test_both_packages_write_the_same_bytes_and_read_each_other(
        codec, bucket_bytes):
    assert compression.have_native() == jax_compression.have_native()
    t = _mixed_tree()
    jkv, pkv = JaxKVStore(), KVStore()
    jax_ch = jax_transport.KVPytreeChannel(
        jkv, "async-42/agrad/1", t, codec=codec, bucket_bytes=bucket_bytes,
        workers=2)
    port_ch = KVPytreeChannel(pkv, "async-42/agrad/1", t, codec=codec,
                              bucket_bytes=bucket_bytes, workers=2)
    jax_ch.publish(7, t, meta={"step": 5})
    port_ch.publish(7, _tensors(t), meta={"step": 5})
    assert sorted(jkv._d) == sorted(pkv._d)
    assert _sha(jkv._d) == _sha(pkv._d)
    # Each package reads the other's store.
    _, from_jax, meta = KVPytreeChannel(jkv, "async-42/agrad/1", t,
                                        workers=2).read()
    _, from_port, jmeta = jax_transport.KVPytreeChannel(
        pkv, "async-42/agrad/1", t, workers=2).read()
    assert meta["step"] == jmeta["step"] == 5
    for want, a, b in zip(tree_flatten(t)[0], tree_flatten(from_jax)[0],
                          jax.tree.leaves(from_port)):
        for got in (a, np.asarray(b)):
            assert got.dtype == want.dtype and got.shape == np.shape(want)
            np.testing.assert_array_equal(got, want)
    port_ch.close()


def _jax_noise(cfg, n):
    """The JAX AsyncTrainer's int8 noise (``async_trainer.py:599-603``,
    ``quantize.py:_quantize_full``) as ``noise_fn`` of the port's."""
    def noise_fn(pid, seq, i, shape):
        key = jax.random.fold_in(
            jax.random.key(cfg.seed * 31 + seq * n + pid), i)
        return torch.from_numpy(np.array(
            jax.random.uniform(key, shape, jnp.float32)))
    return noise_fn


@pytest.mark.parametrize("bucket_mb", [0.0, 0.25])
def test_int8_wire_equals_the_jax_packages_with_its_noise(tmp_path,
                                                          bucket_mb):
    cfg = TrainConfig(dataset="synthetic_mnist", network="LeNet",
                      batch_size=32, compute_dtype="float32", mode="async",
                      compress_grad=True, grad_codec="int8", eval_freq=0,
                      wire_bucket_mb=bucket_mb, resume=False,
                      train_dir=str(tmp_path / "td"))
    trainer = AsyncTrainer(cfg, kv=KVStore(), device="cpu",
                           noise_fn=_jax_noise(cfg, 1))
    set_default_tracer(None)
    rng = np.random.default_rng(5)
    grads = {n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)
                                 * 1e-2) for n, p in trainer.params.items()}
    trainer._seq = 3
    wire = trainer._encode_grads(grads)
    trainer.transport.submit_grads(0, 3, 2, wire)
    # The JAX trainer's encode (async_trainer.py:598-613) of the same
    # gradients in its layout.
    key = jax.random.key(cfg.seed * 31 + 3 * 1 + 0)
    jax_leaves = []
    for i, name in enumerate(trainer.names):
        qt = jax_quantize.quantize_int8(
            jnp.asarray(leaf_layout(name, grads[name].numpy(), True)),
            jax.random.fold_in(key, i))
        jax_leaves.append({"v": np.asarray(qt.values),
                           "s": np.asarray(qt.scales)})
    ours = tree_flatten(wire, is_leaf=lambda x: "v" in x)[0]
    for a, b in zip(ours, jax_leaves):
        np.testing.assert_array_equal(a["v"].numpy(), b["v"])
        np.testing.assert_array_equal(a["s"].numpy(), b["s"])
    jkv = JaxKVStore()
    jax_tree = nest(trainer._paths, jax_leaves)
    jax_transport.KVGradientTransport(
        jkv, 1, jax_tree, jax_tree, run_id=f"async-{cfg.seed}",
        codec="blosc", bucket_bytes=int(bucket_mb * (1 << 20)),
        workers=cfg.wire_workers).submit_grads(0, 3, 2, jax_tree)
    port_kv = trainer._kv.inner
    assert _sha(_payload(jkv)) == _sha(_payload(port_kv))
    assert sorted(jkv._d) == sorted(port_kv._d)
    trainer.transport.close()
