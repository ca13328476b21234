"""The port's stale-gradient aggregator and async configuration against the
JAX package, on the CPU.

``parallel/async_dp.py``'s ``StaleGradientAggregator`` is held against the
JAX aggregator on the same numpy gradients: who is used, who is dropped,
the weights and the averaged tree, BITWISE, for no codec, blosc, int8 (the
JAX run's own rounding noise injected into the port), int8lat, topk and
randk, under a staleness drop, decay and K-of-N; pre-encoded submissions
and the error-feedback state likewise, down to the bytes of an
``extra_state.msgpack``. The async fields of the config
validate with the JAX package's messages, and what is not ported still
raises. The trainer is held against JAX's by test_torch_multislice.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.parallel import async_dp as jax_async
from ps_pytorch_tpu.resilience.faults import corrupt_file
from ps_pytorch_tpu.runtime import checkpoint as jax_ckpt
from ps_pytorch_tpu_torch import config
from ps_pytorch_tpu_torch.parallel import async_dp
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from test_torch_train import two_torch_threads  # noqa: F401


# --------------------------------------------------------- aggregator --

SHAPES = {"conv": {"kernel": (5, 5, 1, 6), "bias": (6,)},
          "fc": {"kernel": (300, 40), "bias": (40,)},
          "scale": ()}


def _grads(seed):
    """A nested gradient tree of numpy leaves (a 0-d leaf included)."""
    rng = np.random.default_rng(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return np.asarray(rng.normal(size=node) * 0.1, np.float32)

    return make(SHAPES)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    return [np.asarray(l.detach().numpy() if isinstance(l, torch.Tensor)
                       else l) for l in async_dp.tree_flatten(tree)[0]]


def _jax_int8_noise(slice_id, step, leaf_index, shape):
    """The noise the JAX aggregator draws for this leaf
    (``async_dp.py:_quantize_leaves`` + ``quantize.py:_quantize_full``)."""
    key = jax.random.fold_in(
        jax.random.key(hash((slice_id, step)) & 0x7FFFFFFF), leaf_index)
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32)))


CODECS = {
    "none": dict(compress=False),
    "blosc": dict(compress=True, codec="blosc"),
    "int8": dict(compress=True, codec="int8"),
    "int8lat": dict(compress=True, codec="int8lat"),
    "topk": dict(compress=True, codec="topk", topk_frac=0.05),
    "randk": dict(compress=True, codec="randk", topk_frac=0.05),
}
# name -> (aggregator settings, [(slice, step)] submitted, collect step)
SCENARIOS = {
    "all_fresh": (dict(), [(0, 5), (1, 5), (2, 5)], 5),
    "stale_dropped": (dict(staleness_limit=2), [(0, 5), (1, 2), (2, 4)], 5),
    "future_dropped": (dict(), [(0, 6), (1, 5), (2, 4)], 5),
    "decay": (dict(staleness_decay=0.5), [(0, 5), (1, 3), (2, 4)], 5),
    "k_of_n": (dict(num_aggregate=2), [(0, 4), (1, 5), (2, 4)], 5),
    "k_of_n_decay": (dict(num_aggregate=2, staleness_decay=0.7,
                          staleness_limit=3), [(0, 1), (1, 3), (2, 4)], 5),
    "none_fresh": (dict(staleness_limit=0), [(0, 1), (1, 2)], 5),
}


def _pair(codec, settings, **extra):
    kw = dict(CODECS[codec], wire_bucket_bytes=4096, wire_workers=2,
              **settings, **extra)
    ours = async_dp.StaleGradientAggregator(
        3, noise_fn=_jax_int8_noise if codec == "int8" else None, **kw)
    return ours, jax_async.StaleGradientAggregator(3, **kw)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_aggregator_collect_matches_jax(codec, scenario):
    settings, submits, now = SCENARIOS[scenario]
    ours, theirs = _pair(codec, settings)
    for sid, step in submits:
        g = _grads(100 * sid + step)
        ours.submit(sid, step, _to_torch(g))
        theirs.submit(sid, step, g)
    assert ours.pending() == theirs.pending()
    assert ours.wire_bytes() == theirs.wire_bytes()
    got, info = ours.collect(now)
    want, jinfo = theirs.collect(now)
    assert info == jinfo
    if want is None:
        assert got is None
    else:
        assert list(got) == list(want)              # sorted keys
        for a, b in zip(_leaves(got), jax.tree.leaves(want)):
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            assert a.tobytes() == b.tobytes()       # bitwise
    ours.consume(info["used"])
    theirs.consume(jinfo["used"])
    assert ours.pending() == theirs.pending()
    assert ours.drop_older_than(now) == theirs.drop_older_than(now)
    assert ours.pending() == theirs.pending()


def test_latest_submission_wins_and_slice_id_is_checked():
    ours, theirs = _pair("none", {})
    for agg, conv in ((ours, _to_torch), (theirs, lambda t: t)):
        agg.submit(1, 3, conv(_grads(1)))
        agg.submit(1, 4, conv(_grads(2)))
        with pytest.raises(ValueError, match="out of range"):
            agg.submit(3, 4, conv(_grads(2)))
    assert ours.pending() == theirs.pending() == {1: 4}
    got, _ = ours.collect(4)
    for a, b in zip(_leaves(got), _leaves(_grads(2))):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("bad", [
    dict(n_slices=0), dict(n_slices=2, num_aggregate=3),
    dict(n_slices=2, codec="zip"), dict(n_slices=2, topk_frac=0.0),
    dict(n_slices=2, error_feedback=True, codec="int8"),
])
def test_aggregator_validates_like_jax(bad):
    msgs = []
    for cls in (async_dp.StaleGradientAggregator,
                jax_async.StaleGradientAggregator):
        with pytest.raises(ValueError) as e:
            cls(**bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_integrity_screen_is_refused():
    """A contribution the attached screen refuses (a NaN leaf) is absent
    from the average and named in ``info["rejected"]``, as in the JAX
    package; without a screen the info has no such key."""
    from ps_pytorch_tpu.resilience.integrity import GradIntegrity as JaxGI
    from ps_pytorch_tpu_torch.resilience.integrity import GradIntegrity
    ours = async_dp.StaleGradientAggregator(2, integrity=GradIntegrity())
    theirs = jax_async.StaleGradientAggregator(2, integrity=JaxGI())
    bad = _grads(5)
    bad["fc"]["bias"][3] = np.nan
    for sid, g in ((0, _grads(4)), (1, bad)):
        ours.submit(sid, 0, _to_torch(g))
        theirs.submit(sid, 0, g)
    (a, ia), (b, ib) = ours.collect(0), theirs.collect(0)
    assert ia["used"] == ib["used"] == [0]
    assert ia["rejected"] == ib["rejected"]
    assert ia["rejected"][1].endswith(": non-finite gradient values")
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert "rejected" not in async_dp.StaleGradientAggregator(2).collect(
        0)[1]


@pytest.mark.parametrize("codec", ["int8lat", "topk"])
def test_submit_encoded_and_ef_state_match_jax(codec):
    """Pre-encoded payload trees pool and collect like the JAX package's;
    error-feedback state after two submissions is bitwise equal and loads
    across the packages."""
    ours, theirs = _pair(codec, {}, error_feedback=True, ef_clip=0.5)
    for step in (1, 2):
        for sid in (0, 2):
            g = _grads(10 * sid + step)
            ours.submit(sid, step, _to_torch(g))
            theirs.submit(sid, step, g)
    sa, sb = ours.ef_state_dict(), theirs.ef_state_dict()
    assert sorted(sa) == sorted(sb) == ["0", "2"]
    for sid in sa:
        assert sorted(sa[sid]) == sorted(sb[sid])
        for i in sa[sid]:
            assert sa[sid][i].tobytes() == sb[sid][i].tobytes()
    fresh_a, fresh_b = _pair(codec, {}, error_feedback=True, ef_clip=0.5)
    fresh_a.load_ef_state(sb)
    fresh_b.load_ef_state(sa)
    g = _grads(77)
    fresh_a.submit(0, 3, _to_torch(g))
    fresh_b.submit(0, 3, g)
    # The pooled payload trees, handed over pre-encoded.
    enc_a, enc_b = _pair(codec, {})
    for agg, src in ((enc_a, fresh_a), (enc_b, fresh_b)):
        step, payloads, treedef = src._pool[0]
        tree = (async_dp.tree_unflatten(treedef, payloads)
                if agg is enc_a else jax.tree.unflatten(treedef, payloads))
        agg.submit_encoded(1, step, tree)
    got, info = enc_a.collect(3)
    want, jinfo = enc_b.collect(3)
    assert info == jinfo and info["used"] == [1]
    for a, b in zip(_leaves(got), jax.tree.leaves(want)):
        assert a.tobytes() == np.asarray(b).tobytes()
    with pytest.raises(ValueError, match="homomorphic"):
        _pair("blosc", {})[0].submit_encoded(0, 1, {})


def test_tree_flatten_order_is_jax_order():
    tree = {"b": {"y": 1, "x": 2}, "a": {"k": 3}, "c": 6, "b_": 7, "b.x": 8}
    leaves, treedef = async_dp.tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree) == [3, 2, 1, 8, 7, 6]
    assert async_dp.tree_unflatten(treedef, leaves) == tree
    assert list(async_dp.tree_unflatten(treedef, leaves)) == sorted(tree)
    assert async_dp.noise_key(1, 2) == async_dp.noise_key(1, 2) == (1, 2) \
        != async_dp.noise_key(1, 3)


def _files(path):
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


def test_extra_state_bytes_equal_jax_and_load_both_ways(tmp_path):
    """An EF ``extra_state.msgpack`` from the same aggregator state is
    byte-equal in the two packages, lies in the manifest, and loads in the
    other package."""
    ours, theirs = _pair("int8lat", {}, error_feedback=True)
    for sid in (0, 1):
        g = _grads(sid)
        ours.submit(sid, 1, _to_torch(g))
        theirs.submit(sid, 1, g)
    ckpt.save_checkpoint(str(tmp_path / "port"), 2, {"step": np.asarray(2, np.int32)},
                         extra_state={"ef": ours.ef_state_dict()})
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 2, {"step": np.asarray(2, np.int32)},
                             extra_state={"ef": theirs.ef_state_dict()})
    a = _files(ckpt.checkpoint_path(str(tmp_path / "port"), 2))
    b = _files(ckpt.checkpoint_path(str(tmp_path / "jax"), 2))
    assert a["extra_state.msgpack"] == b["extra_state.msgpack"]
    assert a["state.msgpack"] == b["state.msgpack"]
    assert "extra_state.msgpack" in json.loads(a["manifest.json"])["files"]
    from_jax = ckpt.load_extra_state(str(tmp_path / "jax"), 2)
    from_port = jax_ckpt.load_extra_state(str(tmp_path / "port"), 2)
    for sid in ("0", "1"):
        for i, r in ours.ef_state_dict()[sid].items():
            assert from_jax["ef"][sid][i].tobytes() == r.tobytes()
            assert np.asarray(from_port["ef"][sid][i]).tobytes() == r.tobytes()
    assert ckpt.load_extra_state(str(tmp_path / "port"), 3) is None
    corrupt_file(os.path.join(ckpt.checkpoint_path(str(tmp_path / "port"), 2),
                              "extra_state.msgpack"))
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_extra_state(str(tmp_path / "port"), 2)


# ------------------------------------------------------------- config --

def _kw(**over):
    base = dict(dataset="synthetic_mnist", network="LeNet", batch_size=64,
                lr=0.05, momentum=0.9, compute_dtype="float32", mode="async",
                max_steps=10, eval_freq=0, log_every=100)
    base.update(over)
    return base


@pytest.mark.parametrize("kw", [
    dict(mode="async", network="TransformerLM", eval_freq=0),
    dict(mode="async", publish_every=2), dict(mode="sync", sync_group_size=2),
    dict(mode="async", sync_topology="hier", compress_grad=True,
         grad_codec="int8lat", leader_lease_s=3.0),
    dict(mode="async", grad_integrity=False), dict(num_aggregate=1),
    dict(staleness_limit=2), dict(grad_codec="int8"),
])
def test_config_still_refuses(kw):
    with pytest.raises(ValueError, match="ROADMAP.md"):
        config.TrainConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(grad_codec="zip"), dict(grad_topk_frac=0.0),
    dict(mode="async", ef=True, grad_codec="int8"),
    dict(wire_bucket_mb=-1.0), dict(wire_workers=-1), dict(ef_clip=-0.5),
])
def test_config_validates_async_fields_like_jax(kw):
    msgs = []
    for mod in (config, jax_config):
        with pytest.raises(ValueError) as e:
            mod.TrainConfig(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_async_config_round_trips_with_jax():
    kw = _kw(compress_grad=True, grad_codec="topk", grad_topk_frac=0.1,
             ef=True, ef_clip=1.0, async_slices=3, fetch_every=2,
             staleness_limit=2, staleness_decay=0.5, num_aggregate=2,
             wire_bucket_mb=1.0, wire_workers=2, codec_level=5)
    ours, theirs = config.TrainConfig(**kw), jax_config.TrainConfig(**kw)
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())
    assert config.TrainConfig.from_json(theirs.to_json()) == ours
