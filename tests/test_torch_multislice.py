"""The port's asynchronous multi-slice trainer against the JAX package, on
the CPU.

``runtime/multislice.py``'s ``MultiSliceTrainer`` is held against the JAX
trainer (LeNet on ``synthetic_mnist``, batch 64, 2 slices of one CPU device
each, and of two) from converted weights: losses and canonical parameters
within 1e-4 (f32 sums run in another order in the two packages; the
tolerance of the synchronous step's tests), the schedule's ``used`` lists
identical. Compressed checkpoints and ``extra_state.msgpack`` are
byte-equal and load both ways, a ResNet's with each device's BatchNorm
statistics; a resumed trainer restores the saved parameters bitwise and
walks back past a corrupt newest checkpoint; the entry point prints the
reference's lines.

Every trainer of a package draws the same synthetic sets, so each is made
once for the module (``_arrays_made_once``) and handed read-only to all.
"""

import io
import json
import os
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.optim.sgd import SGDState as JaxSGDState
from ps_pytorch_tpu.resilience.faults import corrupt_file
from ps_pytorch_tpu.runtime import checkpoint as jax_ckpt
from ps_pytorch_tpu.runtime import evaluator as jax_evaluator
from ps_pytorch_tpu.runtime import metrics as jax_metrics
from ps_pytorch_tpu.runtime import multislice as jax_multislice
from ps_pytorch_tpu_torch import config, evaluate, train
from ps_pytorch_tpu_torch.data import datasets as port_datasets
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.ops import quantize as tq
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.multislice import MultiSliceTrainer
from ps_pytorch_tpu_torch.runtime.trainer import Trainer
from test_torch_train import two_torch_threads  # noqa: F401

TOL = 1e-4      # f32 sums in another order in the two packages


@pytest.fixture(scope="module", autouse=True)
def _arrays_made_once():
    """Each package's ``load_arrays``, memoized for the module: the
    synthetic sets are a function of their arguments, and drawing them
    anew took more time than the trainers' ticks. The arrays are
    read-only, so a loader that wrote into one would raise."""
    import ps_pytorch_tpu.data.datasets as jax_datasets
    import ps_pytorch_tpu_torch.data.datasets as port_datasets
    from ps_pytorch_tpu_torch.runtime import multislice

    patch = pytest.MonkeyPatch()
    for owners, load in (((jax_datasets,), jax_datasets.load_arrays),
                         ((port_datasets, multislice),
                          port_datasets.load_arrays)):
        made = {}

        def once(*args, _load=load, _made=made, **kw):
            key = (args, tuple(sorted(kw.items())))
            if key not in _made:
                arrays = _load(*args, **kw)
                for a in arrays:
                    a.flags.writeable = False
                _made[key] = arrays
            return _made[key]

        for owner in owners:
            patch.setattr(owner, "load_arrays", once)
    yield
    patch.undo()


# ------------------------------------------------------------ trainer --

def _kw(**over):
    base = dict(dataset="synthetic_mnist", network="LeNet", batch_size=64,
                lr=0.05, momentum=0.9, compute_dtype="float32", mode="async",
                max_steps=10, eval_freq=0, log_every=100)
    base.update(over)
    return base


def _pair_of_trainers(tmp_path, slice_periods=None, fetch_every=1, per=1,
                      **over):
    """A JAX trainer over 2 slices of ``per`` CPU devices each and the
    port's, from the JAX trainer's weights."""
    kw = _kw(train_dir=str(tmp_path / "none"), **over)
    jt = jax_multislice.MultiSliceTrainer(
        jax_config.TrainConfig(**kw), n_slices=2,
        slice_periods=slice_periods, fetch_every=fetch_every,
        devices=jax.devices()[:2 * per])
    pt = MultiSliceTrainer(config.TrainConfig(**kw), n_slices=2,
                           slice_periods=slice_periods,
                           fetch_every=fetch_every, devices=["cpu"] * 2 * per,
                           device="cpu", printer=lambda line: None)
    pt.load_jax(serialization.to_state_dict(
        jax.device_get(jt._as_train_state())),
        [jax.device_get(bs) for bs in jt._bs])
    return jt, pt


def _assert_params_close(pt, jt, tol=TOL):
    got = convert.to_jax(pt.model.state_dict())[0]
    want = jax.device_get(jt.params)
    for mod in want:
        for leaf in want[mod]:
            np.testing.assert_allclose(got[mod][leaf], want[mod][leaf],
                                       rtol=tol, atol=tol,
                                       err_msg=f"{mod}.{leaf}")


def _ticks_match(tmp_path, codec, fused, per):
    """4 ticks: losses, accuracies and canonical params at 1e-4, the
    lossless codec included."""
    over = dict(fused_optimizer=fused)
    if codec == "blosc":
        over.update(compress_grad=True, grad_codec="blosc")
    jt, pt = _pair_of_trainers(tmp_path, per=per, **over)
    assert pt.per == per and len(jt.meshes[0].devices.flat) == per
    for (a, b) in zip(pt.train_loaders, jt.train_loaders):
        assert a.host_id == b.host_id and a.local_batch == b.local_batch
    for _ in range(4):
        ji, pi = jt.tick(), pt.tick()
        assert pi["computed"] == ji["computed"] == [0, 1]
        assert pi["used"] == ji["used"]
        np.testing.assert_allclose(pi["loss"], ji["loss"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(pi["acc"], ji["acc"], rtol=TOL, atol=TOL)
        _assert_params_close(pt, jt)
    assert (pt.step, pt.applied, pt.dropped_stale) == \
        (jt.step, jt.applied, jt.dropped_stale) == (4, 4, 0)
    r, jr = pt.evaluate(max_batches=1), jt.evaluate(max_batches=1)
    np.testing.assert_allclose(r["loss"], jr["loss"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("codec", ["none", "blosc"])
@pytest.mark.parametrize("fused", [False, True])
def test_multislice_ticks_match_jax(tmp_path, codec, fused):
    _ticks_match(tmp_path, codec, fused, per=1)


def test_slices_of_two_devices_tick_like_jax(tmp_path):
    """Each slice's batch split over its two devices and its gradient
    averaged over them, as the JAX slice's ``psum / n``."""
    _ticks_match(tmp_path, "none", True, per=2)


def _schedule_matches(tmp_path, periods, fetch, limit, per):
    jt, pt = _pair_of_trainers(tmp_path, slice_periods=periods,
                               fetch_every=fetch, staleness_limit=limit,
                               per=per)
    used = []
    for _ in range(8):
        ji, pi = jt.tick(), pt.tick()
        assert (pi["computed"], pi["used"]) == (ji["computed"], ji["used"])
        assert pt._slice_version == jt._slice_version
        used.append(pi["used"])
    assert (pt.applied, pt.dropped_stale) == (jt.applied, jt.dropped_stale)
    if periods == [1, 2] and limit == 4:
        assert sum(0 in u for u in used) == 8
        assert sum(1 in u for u in used) >= 3 and pt.dropped_stale == 0
    if limit == 0:
        assert pt.dropped_stale > 0 and pt.applied > 0
    _assert_params_close(pt, jt, tol=5 * TOL)      # 8 ticks


@pytest.mark.parametrize("periods,fetch,limit", [
    ([1, 2], 2, 4),         # the slow slice's stale gradients are used
    ([2, 1], 1, 4),         # ticks where only slice 1 contributes
    ([1, 1], 4, 0),         # stale submissions dropped
])
def test_multislice_schedule_matches_jax(tmp_path, periods, fetch, limit):
    _schedule_matches(tmp_path, periods, fetch, limit, per=1)


def test_slices_of_two_devices_follow_the_jax_schedule(tmp_path):
    """The slow slice's stale gradients, on slices of two devices."""
    _schedule_matches(tmp_path, [1, 2], 2, 4, per=2)


def test_slices_draw_the_jax_loaders_batches(tmp_path):
    """Slice s of n draws the same bytes as the JAX trainer's loader s."""
    jt, pt = _pair_of_trainers(tmp_path)
    for a, b in zip(pt.train_loaders, jt.train_loaders):
        assert set(a._epoch_order(0)).isdisjoint(
            pt.train_loaders[1 - a.host_id]._epoch_order(0))
        for _ in range(2):
            (xa, ya), (xb, yb) = a.next_batch(), b.next_batch()
            assert xa.tobytes() == xb.tobytes() and ya.tobytes() == yb.tobytes()


def test_int8_ticks_quantize_every_leaf_and_train(tmp_path):
    """The int8 codec through the trainer on the CPU (plain version): the
    pool holds QuantizedTensors on submit, the average stays a tensor, and
    the loss moves like the uncompressed run's (one quantum of noise)."""
    kw = _kw(train_dir=str(tmp_path), compress_grad=True, grad_codec="int8",
             num_aggregate=1)
    pt = MultiSliceTrainer(config.TrainConfig(**kw), n_slices=2,
                           device="cpu", printer=lambda line: None)
    ref = MultiSliceTrainer(config.TrainConfig(**_kw(
        train_dir=str(tmp_path), num_aggregate=1)), n_slices=2, device="cpu",
        printer=lambda line: None)
    for _ in range(3):
        a, b = pt.tick(), ref.tick()
        assert a["used"] == b["used"] == [0]
        assert abs(a["loss"] - b["loss"]) < 0.05
    pooled = pt.aggregator._pool[1][1]          # K-of-N left slice 1 pooled
    assert all(isinstance(q, tq.QuantizedTensor) for q in pooled)
    n_params = sum(p.numel() for p in pt.params.values())
    want = sum(tq.padded_rows(p.numel()) * 128 + 4 * tq.padded_rows(
        p.numel()) // 32 for p in pt.params.values())
    assert pt.aggregator.wire_bytes() == want < 4 * n_params
    assert tq.quantize_int8.launches == 0


def test_resnet_slices_keep_their_own_batchnorm_statistics(tmp_path,
                                                          monkeypatch):
    """ResNet-18 at batch 4 over 2 slices of 2 devices: each device moves
    its own statistics, evaluate() reads slice 0's first device's, the
    checkpoint carries slice 0's [2, ...] stack byte-equal to the JAX
    trainer's checkpoint of the same state, and a JAX trainer's
    per-slice statistics load device by device. The synthetic CIFAR set
    holds 64 images a split: one tick draws 4, the evaluation 8."""
    monkeypatch.setitem(port_datasets.DATASET_SHAPES, "synthetic_cifar10",
                        (32, 32, 3, 10, 64))
    kw = _kw(network="ResNet18", dataset="synthetic_cifar10", batch_size=4,
             test_batch_size=8, train_dir=str(tmp_path / "port"), lr=0.01,
             fused_optimizer=True, conv_impl="pallas")
    pt = MultiSliceTrainer(config.TrainConfig(**kw), n_slices=2,
                           devices=["cpu"] * 4, device="cpu",
                           printer=lambda line: None)
    info = pt.tick()
    assert info["used"] == [0, 1] and np.isfinite(info["loss"])
    means = [[m.state_dict()["bn1.running_mean"] for m in reps]
             for reps in pt.replicas]
    s0 = means[0][0]
    flat = [m for reps in means for m in reps]
    for i in range(4):
        for j in range(i):
            assert not torch.equal(flat[i], flat[j])
    for name, p in pt.params.items():           # slices fetch at next tick
        assert not torch.equal(
            p, dict(pt.replicas[0][0].named_parameters())[name])
    r = pt.evaluate(max_batches=1)
    assert r["count"] == 8 and np.isfinite(r["loss"])
    assert torch.equal(pt.model.state_dict()["bn1.running_mean"], s0)
    # The checkpoint: slice 0's two devices' statistics, as the JAX
    # trainer writes the same state.
    pt._checkpoint()
    tree, _, _ = ckpt.load_checkpoint(kw["train_dir"], 1)
    np.testing.assert_array_equal(
        tree["batch_stats"]["bn1"]["mean"],
        np.stack([m.numpy() for m in means[0]]))
    # The JAX trainer's own _checkpoint on the same state (a trainer that
    # only writes: its model and loaders are never used, so none is built).
    jt = object.__new__(jax_multislice.MultiSliceTrainer)
    jt.cfg = jax_config.TrainConfig(**dict(kw,
                                            train_dir=str(tmp_path / "jax")))
    jt.step, jt.params, jt._bs = 1, tree["params"], [tree["batch_stats"]]
    jt.opt_state = JaxSGDState(**tree["opt_state"])
    jt._checkpoint()
    a = _files(ckpt.checkpoint_path(kw["train_dir"], 1))
    b = _files(jax_ckpt.checkpoint_path(str(tmp_path / "jax"), 1))
    assert list(a) == list(b)
    assert a["state.msgpack"] == b["state.msgpack"]
    assert a["meta.json"] == b["meta.json"]
    # A JAX trainer's per-slice [2, ...] statistics, device by device.
    stats = [convert._map(lambda a, k=k: a + k, tree["batch_stats"])
             for k in (0.0, 2.0)]
    tree = dict(tree, step=np.asarray(3, np.int32))
    pt.load_jax(tree, stats)
    assert pt.step == 3
    for k, reps in enumerate(pt.replicas):
        for r, m in enumerate(reps):
            assert torch.equal(m.state_dict()["bn1.running_mean"],
                               means[0][r] + 2 * k)
            for name, p in m.named_parameters():
                assert torch.equal(p, pt.params[name])


def test_trainer_refuses_what_it_cannot_do(tmp_path):
    cfg = config.TrainConfig(**_kw(train_dir=str(tmp_path)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MultiSliceTrainer(cfg)                  # no silent CPU run
    with pytest.raises(ValueError, match="divisible"):
        MultiSliceTrainer(cfg, n_slices=2, devices=["cpu"] * 3, device="cpu")
    with pytest.raises(ValueError, match="divisible by the 3 devices"):
        MultiSliceTrainer(cfg, n_slices=2, devices=["cpu"] * 6, device="cpu")
    assert MultiSliceTrainer(cfg, n_slices=2, devices=["cpu"] * 4,
                             device="cpu", printer=lambda line: None).per == 2
    with pytest.raises(ValueError, match="period"):
        MultiSliceTrainer(cfg, n_slices=2, slice_periods=[1], device="cpu")
    with pytest.raises(ValueError, match="MultiSliceTrainer"):
        Trainer(cfg, device="cpu")


# -------------------------------------------------------- checkpoints --

def _files(path):
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


@pytest.mark.parametrize("compress", [False, True])
def test_checkpoint_bytes_equal_jax(tmp_path, compress):
    """The same state through both trainers' ``_checkpoint``: every file
    but config.json's train_dir byte-equal, compressed or not, and each
    package loads the other's."""
    over = dict(eval_freq=3, compress_grad=compress, codec_level=5)
    jt, pt = _pair_of_trainers(tmp_path, **over)
    jt.cfg = jt.cfg.replace(train_dir=str(tmp_path / "jax"))
    pt.cfg = config.TrainConfig.from_json(jt.cfg.to_json())
    pt.cfg.train_dir = str(tmp_path / "port")
    jt.step = pt.step = 7
    jt._checkpoint()
    pt._checkpoint()
    a = _files(ckpt.checkpoint_path(str(tmp_path / "port"), 7))
    b = _files(jax_ckpt.checkpoint_path(str(tmp_path / "jax"), 7))
    assert list(a) == list(b) == ["config.json", "manifest.json",
                                  "meta.json", "state.msgpack"]
    assert a["state.msgpack"] == b["state.msgpack"]
    assert a["meta.json"] == b["meta.json"]
    assert json.loads(a["meta.json"]) == {"step": 7, "compressed": compress}
    if compress:
        assert a["state.msgpack"][:4] == b"PSC1"
    # Each package restores the other's.
    state, meta, _ = jax_ckpt.load_checkpoint(
        str(tmp_path / "port"), 7, jax.device_get(jt._as_train_state()))
    assert meta["step"] == 7 and int(state.step) == 7
    tree, meta, _ = ckpt.load_checkpoint(str(tmp_path / "jax"), 7)
    assert int(tree["step"]) == 7 and meta["compressed"] == compress
    fresh = MultiSliceTrainer(pt.cfg, n_slices=2, device="cpu",
                              printer=lambda line: None)
    fresh._restore(tree)
    for k, v in pt.model.state_dict().items():
        assert torch.equal(v, fresh.model.state_dict()[k])


def test_ef_checkpoint_crosses_packages_in_the_jax_layout(tmp_path):
    """A port trainer's EF residuals are stored in the JAX package's
    parameter layouts: the JAX trainer resumes from the port's checkpoint
    and the port from the JAX trainer's, residuals within 1e-4 of each
    other after the same tick."""
    over = dict(eval_freq=1, compress_grad=True, grad_codec="int8lat",
                ef=True, max_steps=1)
    jt, pt = _pair_of_trainers(tmp_path, **over)
    jt.cfg = jt.cfg.replace(train_dir=str(tmp_path / "jax"))
    pt.cfg.train_dir = str(tmp_path / "port")
    jt.tick(), pt.tick()
    jt._checkpoint(), pt._checkpoint()
    ef_p = ckpt.load_extra_state(str(tmp_path / "port"), 1)["ef"]
    ef_j = ckpt.load_extra_state(str(tmp_path / "jax"), 1)["ef"]
    assert sorted(ef_p) == sorted(ef_j) == ["0", "1"]
    for sid in ef_j:
        assert sorted(ef_p[sid]) == sorted(ef_j[sid])
        for i in ef_j[sid]:
            assert ef_p[sid][i].shape == ef_j[sid][i].shape
            # One lattice step where a rounding fell the other way.
            np.testing.assert_allclose(ef_p[sid][i], ef_j[sid][i], atol=2e-3)
    # Each trainer resumes from the other's directory.
    kw = _kw(**over)
    j2 = jax_multislice.MultiSliceTrainer(
        jax_config.TrainConfig(**dict(kw, train_dir=str(tmp_path / "port"))),
        n_slices=2, devices=jax.devices()[:2])
    assert j2.maybe_resume() and j2.step == 1
    p2 = MultiSliceTrainer(
        config.TrainConfig(**dict(kw, train_dir=str(tmp_path / "jax"))),
        n_slices=2, device="cpu", printer=lambda line: None)
    assert p2.maybe_resume() and p2.step == 1
    names = sorted(p2.params)
    got = p2.aggregator.ef_state_dict()
    for sid in ef_j:
        for i, r in ef_j[sid].items():
            want = convert.leaf_layout(names[int(i)], r, to_jax=False)
            assert got[sid][i].shape == tuple(p2.params[names[int(i)]].shape)
            assert got[sid][i].tobytes() == np.ascontiguousarray(
                want).tobytes()
    j2.tick(), p2.tick()                # the loaded residuals fit the grads


def test_async_resume_restores_and_matches_the_jax_resume(tmp_path, capsys):
    """Checkpoints at 3 and 6, compressed; a second trainer resumes at 6
    with the saved canonical parameters bitwise and trains on to 8. As in
    the JAX trainer the loaders start over on resume, so the resumed run
    is held against the JAX trainer resumed from the same checkpoint
    (1e-4), not against an uninterrupted run."""
    kw = _kw(max_steps=6, eval_freq=3, train_dir=str(tmp_path / "td"),
             compress_grad=True, grad_codec="blosc", log_every=1)
    lines = []
    pt = MultiSliceTrainer(config.TrainConfig(**kw), n_slices=2,
                           device="cpu", printer=lines.append)
    pt.train()
    assert ckpt.committed_steps(kw["train_dir"]) == [3, 6]
    assert [jax_metrics.parse_line(ln)["step"] for ln in lines] == \
        list(range(1, 7))
    saved = {k: v.clone() for k, v in pt.model.state_dict().items()}
    kw8 = dict(kw, max_steps=8)
    p2 = MultiSliceTrainer(config.TrainConfig(**kw8), n_slices=2,
                           device="cpu", printer=lambda line: None)
    assert p2.maybe_resume() and p2.step == 6
    assert "RESUME from" in capsys.readouterr().out
    for k, v in p2.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for reps in p2.replicas:
        for name, p in reps[0].named_parameters():
            assert torch.equal(p, p2.params[name])
    assert p2._slice_version == [6, 6]
    assert p2.opt_state.step == pt.opt_state.step == 6
    j2 = jax_multislice.MultiSliceTrainer(
        jax_config.TrainConfig(**kw8), n_slices=2, devices=jax.devices()[:2])
    assert j2.maybe_resume() and j2.step == 6
    for _ in range(2):
        ji, pi = j2.tick(), p2.tick()
        assert pi["used"] == ji["used"]
        np.testing.assert_allclose(pi["loss"], ji["loss"], rtol=TOL, atol=TOL)
    assert p2.step == 8
    _assert_params_close(p2, j2)


def test_async_resume_falls_back_past_corrupt_checkpoint(tmp_path, capsys):
    kw = _kw(max_steps=6, eval_freq=3, train_dir=str(tmp_path))
    MultiSliceTrainer(config.TrainConfig(**kw), n_slices=2, device="cpu",
                      printer=lambda line: None).train()
    newest = tmp_path / "model_step_6"
    victim = max((p for p in newest.iterdir() if "manifest" not in p.name),
                 key=lambda p: p.stat().st_size)
    assert corrupt_file(str(victim))
    assert not ckpt.verify_checkpoint(str(tmp_path), 6)
    assert ckpt.verify_checkpoint(str(tmp_path), 3)
    t = MultiSliceTrainer(config.TrainConfig(**dict(kw, max_steps=9)),
                          n_slices=2, device="cpu",
                          printer=lambda line: None)
    assert t.maybe_resume() and t.step == 3
    assert "failed verification" in capsys.readouterr().out
    empty = MultiSliceTrainer(config.TrainConfig(**dict(
        kw, train_dir=str(tmp_path / "empty"))), n_slices=2, device="cpu",
        printer=lambda line: None)
    assert not empty.maybe_resume() and empty.step == 0


def test_sync_trainer_writes_compressed_checkpoints_like_jax(tmp_path):
    """``--compress-grad`` on the synchronous Trainer compresses its
    checkpoints, as in the JAX trainer; the JAX package reads them."""
    cfg = config.TrainConfig(network="LeNet", dataset="synthetic_mnist",
                             batch_size=32, compute_dtype="float32",
                             max_steps=2, eval_freq=2, compress_grad=True,
                             train_dir=str(tmp_path))
    tr = Trainer(cfg, device="cpu", printer=lambda line: None)
    tr.train()
    path = ckpt.checkpoint_path(str(tmp_path), 2)
    assert json.load(open(os.path.join(path, "meta.json")))["compressed"]
    assert open(os.path.join(path, "state.msgpack"), "rb").read(4) == b"PSC1"
    tree, _, _ = ckpt.load_checkpoint(str(tmp_path), 2)
    raw = serialization.msgpack_restore(jax_compression_blob(path))
    assert int(raw["step"]) == int(tree["step"]) == 2


def jax_compression_blob(path):
    from ps_pytorch_tpu.compression import w_decompress
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        return w_decompress(f.read()).tobytes()


# -------------------------------------------------------- entry point --

def _run_main(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(argv)
    assert rc == 0
    return out.getvalue()


ASYNC_ARGS = ["--mode", "async", "--async-slices", "2", "--network", "LeNet",
              "--dataset", "synthetic_mnist", "--batch-size", "64",
              "--test-batch-size", "2000", "--compute-dtype", "float32",
              "--fused-optimizer", "--compress-grad", "--grad-codec", "int8",
              "--lr", "0.05", "--momentum", "0.9"]


def test_async_entry_point_prints_the_reference_lines(tmp_path, monkeypatch):
    """``python -m ps_pytorch_tpu_torch.train --mode async`` on the CPU:
    CONFIG, SLICES, STEP lines the JAX parser reads, FINAL, the async
    extras in the JSONL, a compressed checkpoint that both evaluators
    score alike."""
    td = str(tmp_path / "td")
    out = _run_main(train.main, [
        *ASYNC_ARGS, "--max-steps", "4", "--eval-freq", "4", "--train-dir",
        td, "--metrics-file", str(tmp_path / "m.jsonl"), "--device", "cpu"])
    lines = out.splitlines()
    assert lines[0].startswith("CONFIG ") and lines[1] == "SLICES 2 x 1 devices"
    steps = [jax_metrics.parse_line(ln) for ln in lines
             if ln.startswith("STEP")]
    assert [s["step"] for s in steps] == [1, 2, 3, 4]
    assert all(s["participating"] == 2 and np.isfinite(s["loss"])
               for s in steps)
    assert lines[-1].startswith("FINAL loss ")
    recs = [json.loads(ln) for ln in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["applied"] for r in recs] == [1, 2, 3, 4]
    assert all(r["dropped_stale"] == 0 and r["pool_wire_bytes"] == 0
               for r in recs)          # used contributions are consumed
    assert json.load(open(os.path.join(td, "model_step_4", "meta.json"))
                     )["compressed"] is True
    ours = _run_main(evaluate.main, ["--train-dir", td, "--once", "4",
                                     "--device", "cpu"]).strip()
    theirs = []
    jax_evaluator.Evaluator(td, printer=theirs.append).evaluate_step(4)
    assert ours.startswith("EVAL step 4 loss ")
    a, b = ours.split(), theirs[0].split()
    assert a[:3] == b[:3]
    np.testing.assert_allclose([float(a[4]), float(a[6]), float(a[8])],
                               [float(b[4]), float(b[6]), float(b[8])],
                               rtol=TOL, atol=TOL)
    # Several processes train one slice a process, started by the port's
    # launcher with its contract: torchrun's variable alone is refused.
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="WORLD_SIZE=2.*tools.launch"):
        train.main([*ASYNC_ARGS, "--max-steps", "1", "--eval-freq", "0",
                    "--train-dir", td, "--device", "cpu"])


def test_async_entry_point_spreads_slices_over_every_card(monkeypatch):
    """One process takes every visible card when their count divides
    into the slices, as the JAX entry takes every local device; one card
    is shared by every slice; another count raises the JAX message."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for n, want in ((4, [f"cuda:{i}" for i in range(4)]), (1, None)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n: n)
        assert train._slice_devices("cuda", 2) == want
    assert train._slice_devices("cuda:1", 2) is None
    assert train._slice_devices("cpu", 2) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="^3 devices not divisible by 2 "
                       "slices$"):
        train._slice_devices("cuda", 2)
    with pytest.raises(ValueError, match="3 devices not divisible by 2"):
        jax_multislice.MultiSliceTrainer(
            jax_config.TrainConfig(**_kw()), n_slices=2,
            devices=jax.devices()[:3])


def test_async_entry_point_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        with redirect_stdout(io.StringIO()):
            train.main([*ASYNC_ARGS, "--max-steps", "1", "--eval-freq", "0",
                        "--train-dir", str(tmp_path)])
