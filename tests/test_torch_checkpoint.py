"""The port's checkpoints against the JAX package's, on the CPU.

A training state goes into the same bytes as ``flax.serialization.to_bytes``
for every optimizer structure (plain SGD with and without momentum, the
fused SGD, Adam, AMSGrad) and for a ResNet's BatchNorm replica axis. Each
package loads what the other wrote; the manifest catches a flipped byte and
resume walks back past it; ``ckpt_keep`` prunes; and a resumed run is
bitwise the uninterrupted one, for SGD and for Adam.
"""

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.models import build_model as jax_build_model
from ps_pytorch_tpu.models import lenet as jax_lenet
from ps_pytorch_tpu.models import resnet as jax_resnet
from ps_pytorch_tpu.ops.fused_adam import FusedAdam as JaxFusedAdam
from ps_pytorch_tpu.ops.fused_sgd import FusedSGD as JaxFusedSGD
from ps_pytorch_tpu.optim import adam as jax_adam
from ps_pytorch_tpu.optim import sgd as jax_sgd
from ps_pytorch_tpu.parallel import create_train_state, make_mesh
from ps_pytorch_tpu.runtime import checkpoint as jax_ckpt
from ps_pytorch_tpu.runtime import evaluator as jax_evaluator
from ps_pytorch_tpu.runtime import metrics as jax_metrics
from ps_pytorch_tpu_torch import config
from ps_pytorch_tpu_torch.models import convert, lenet, resnet
from ps_pytorch_tpu_torch.ops.fused_adam import FusedAdam
from ps_pytorch_tpu_torch.ops.fused_sgd import FusedSGD
from ps_pytorch_tpu_torch.optim import SGD, Adam
from ps_pytorch_tpu_torch.runtime import Evaluator
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime import msgpack_io
from ps_pytorch_tpu_torch.runtime.trainer import Trainer
from test_torch_train import two_torch_threads  # noqa: F401

# name -> (JAX transform, port optimizer), both from the same settings.
OPTIMIZERS = {
    "sgd0": (lambda: jax_sgd(lr=0.1, momentum=0.0),
             lambda: SGD(0.1, momentum=0.0)),
    "sgd": (lambda: jax_sgd(lr=0.1, momentum=0.9),
            lambda: SGD(0.1, momentum=0.9)),
    "fused_sgd": (lambda: JaxFusedSGD(lr=0.1, momentum=0.9),
                  lambda: FusedSGD(0.1, momentum=0.9)),
    "adam": (lambda: jax_adam(lr=1e-3), lambda: Adam(1e-3)),
    "amsgrad": (lambda: jax_adam(lr=1e-3, amsgrad=True),
                lambda: Adam(1e-3, amsgrad=True)),
    "fused_adam": (lambda: JaxFusedAdam(lr=1e-3, weight_decay=5e-4),
                   lambda: FusedAdam(1e-3, weight_decay=5e-4)),
}
MODELS = {
    "LeNet": (jax_lenet.LeNet, lambda: lenet.LeNet(), (28, 28, 1)),
    "ResNet": (lambda: jax_resnet.ResNet(jax_resnet.BasicBlock, (1, 1, 1, 1)),
               lambda: resnet.ResNet(resnet.BasicBlock, (1, 1, 1, 1)),
               (32, 32, 3)),
}


def _port_state(model_name, opt_name, seed=0):
    """A port model and optimizer state with every tensor filled from a
    numpy generator (moments included), at step 3."""
    model = MODELS[model_name][1]()
    opt = OPTIMIZERS[opt_name][1]()
    opt_state = opt.init(dict(model.named_parameters()))
    rng = np.random.default_rng(seed)
    tensors = list(model.state_dict().values())
    for field in ("momentum", "exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
        tensors += list((getattr(opt_state, field, ()) or {}).values())
    with torch.no_grad():
        for t in tensors:
            t.copy_(torch.from_numpy(
                rng.random(t.shape, dtype=np.float32)))
    return model, opt_state._replace(step=3)


def _jax_template(model_name, opt_name, n_data=1):
    jmodel, _, shape = MODELS[model_name]
    return create_train_state(jmodel(), OPTIMIZERS[opt_name][0](),
                              make_mesh(data=n_data), (1,) + shape,
                              jax.random.key(0))


def _assert_trees_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


CASES = [("LeNet", "sgd0"), ("LeNet", "sgd"), ("LeNet", "fused_sgd"),
         ("LeNet", "adam"), ("LeNet", "amsgrad"), ("ResNet", "fused_adam")]


@pytest.mark.parametrize("model_name,opt_name", CASES)
def test_state_bytes_equal_flax(model_name, opt_name):
    """The port's bytes are flax's for the same TrainState (the JAX
    template filled with the port's values), and the decoder reads flax's
    bytes back to the same tree."""
    model, opt_state = _port_state(model_name, opt_name)
    tree = convert.state_to_jax(model, opt_state, 7)
    template = _jax_template(model_name, opt_name)
    jstate = serialization.from_state_dict(template, tree)
    want = serialization.to_bytes(jax.device_get(jstate))
    assert msgpack_io.packb(tree) == want
    _assert_trees_equal(msgpack_io.unpackb(want),
                        serialization.msgpack_restore(want))


def test_msgpack_subset_and_refusals():
    """Every header width of the subset round-trips through flax's own
    msgpack; what lies outside the subset raises."""
    import msgpack
    tree = {"n": [0, 127, 128, 255, 256, 65536, 2 ** 32, -1, -33, -129,
                  -40000, -2 ** 31 - 1],
            "s": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000],
            "b": [b"", b"x" * 300, b"y" * 70000], "none": None,
            "m": {str(i): i for i in range(20)}, "l": list(range(20))}
    data = msgpack_io.packb(tree)
    assert data == msgpack.packb(tree, use_bin_type=True)
    assert msgpack_io.unpackb(data) == tree
    for arr in (np.zeros((), np.int32), np.arange(3, dtype=np.float32),
                np.ones((2, 70), np.float32), np.int32(5), np.float32(2.5)):
        blob = msgpack_io.packb({"a": arr})
        assert blob == serialization.msgpack_serialize({"a": arr})
        back = msgpack_io.unpackb(blob)["a"]
        assert type(back) is type(serialization.msgpack_restore(blob)["a"])
        np.testing.assert_array_equal(back, arr)
    for bad in ({1: 2}, {"x": True}, {"x": 1.5}, {"x": object()}):
        with pytest.raises(ValueError):
            msgpack_io.packb(bad)
    with pytest.raises(ValueError, match="ext type"):
        msgpack_io.unpackb(msgpack.packb(msgpack.ExtType(2, b"ab")))
    with pytest.raises(ValueError, match="trailing"):
        msgpack_io.unpackb(msgpack_io.packb(1) + b"\x00")


@pytest.mark.parametrize("opt_name", ["fused_sgd", "adam"])
def test_jax_loads_a_port_checkpoint(tmp_path, opt_name):
    model, opt_state = _port_state("LeNet", opt_name, seed=1)
    cfg = config.TrainConfig(dataset="Digits", optimizer=(
        "adam" if opt_name == "adam" else "sgd"))
    ckpt.save_checkpoint(str(tmp_path), 5,
                         convert.state_to_jax(model, opt_state, 5),
                         config_json=cfg.to_json())
    state, meta, config_json = jax_ckpt.load_checkpoint(
        str(tmp_path), 5, _jax_template("LeNet", opt_name))
    assert meta == {"step": 5, "compressed": False}
    assert json.loads(config_json) == json.loads(cfg.to_json())
    assert int(state.step) == 5 and int(state.opt_state.step) == 3
    params, _ = convert.to_jax(model.state_dict())
    _assert_trees_equal(convert._sorted(params), jax.device_get(state.params))
    first = "momentum" if opt_name == "fused_sgd" else "exp_avg"
    _assert_trees_equal(convert._moments_to_jax(getattr(opt_state, first)),
                        jax.device_get(getattr(state.opt_state, first)))


@pytest.mark.parametrize("opt_name", ["sgd", "amsgrad"])
def test_port_loads_a_jax_checkpoint(tmp_path, opt_name):
    """A JAX checkpoint of a ResNet on an 8-replica mesh (BatchNorm
    statistics [8, C], each replica its own) restores into the port's
    model and optimizer; the statistics are replica 0's."""
    jstate = _jax_template("ResNet", opt_name, n_data=8)
    rng = np.random.default_rng(2)
    host = jax.tree.map(lambda a: rng.random(a.shape).astype(a.dtype)
                        if a.ndim else a, jax.device_get(jstate))
    jax_ckpt.save_checkpoint(str(tmp_path), 4, host, config_json="{}")
    model, opt_state = _port_state("ResNet", opt_name)
    opt_state = opt_state._replace(step=0)
    tree, meta, _ = ckpt.load_checkpoint(str(tmp_path), 4)
    opt_state, step = convert.state_from_jax(tree, model, opt_state)
    assert step == 0 and opt_state.step == 0 and meta["step"] == 4
    params, stats = convert.to_jax(model.state_dict())
    _assert_trees_equal(convert._sorted(params), host.params)
    _assert_trees_equal(convert._sorted(stats), jax.tree.map(
        lambda a: a[0], host.batch_stats))
    first = "momentum" if opt_name == "sgd" else "max_exp_avg_sq"
    _assert_trees_equal(convert._moments_to_jax(getattr(opt_state, first)),
                        getattr(host.opt_state, first))


def test_restore_refuses_a_state_that_does_not_fit():
    model, opt_state = _port_state("LeNet", "sgd")
    tree = convert.state_to_jax(model, opt_state, 1)
    adam_state = Adam(1e-3).init(dict(model.named_parameters()))
    with pytest.raises(ValueError, match="optimizer state"):
        convert.state_from_jax(tree, model, adam_state)
    other, _ = _port_state("ResNet", "sgd")
    before = {k: v.clone() for k, v in other.state_dict().items()}
    with pytest.raises(ValueError, match="model"):
        convert.state_from_jax(tree, other)
    for k, v in other.state_dict().items():      # nothing was copied
        assert torch.equal(v, before[k])


def test_compressed_and_extra_state_refused(tmp_path):
    """Once refused, now written: a compressed state and an extra state
    read back as they went in, and flax reads the extra state's bytes."""
    state = {"step": np.asarray(1, np.int32),
             "params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    extra = {"ef": {"1": {"0": np.ones(3, np.float32)}, "0": {}}}
    path = ckpt.save_checkpoint(str(tmp_path), 1, state, compress=True,
                                extra_state=extra)
    tree, meta, _ = ckpt.load_checkpoint(str(tmp_path), 1)
    assert meta == {"step": 1, "compressed": True}
    _assert_trees_equal(tree, state)
    back = ckpt.load_extra_state(str(tmp_path), 1)
    assert list(back["ef"]) == ["0", "1"]
    np.testing.assert_array_equal(back["ef"]["1"]["0"], extra["ef"]["1"]["0"])
    with open(os.path.join(path, "extra_state.msgpack"), "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    np.testing.assert_array_equal(raw["ef"]["1"]["0"], extra["ef"]["1"]["0"])
    assert jax_ckpt.load_extra_state(str(tmp_path), 1).keys() == back.keys()


# ---------------------------------------------------------- integrity --

def _cfg(td, **kw):
    base = dict(network="LeNet", dataset="Digits", batch_size=32,
                test_batch_size=360, lr=0.05, momentum=0.9,
                compute_dtype="float32", epochs=0, max_steps=4, eval_freq=2,
                train_dir=str(td), log_every=1)
    base.update(kw)
    return config.TrainConfig(**base)


def _run(cfg):
    lines = []
    tr = Trainer(cfg, device="cpu", printer=lines.append)
    tr.train()
    return tr, [jax_metrics.parse_line(ln) for ln in lines]


def test_manifest_fallback_and_pruning(tmp_path, capsys):
    td = tmp_path / "td"
    _run(_cfg(td, max_steps=5, eval_freq=1, ckpt_keep=2))
    assert ckpt.committed_steps(str(td)) == [4, 5]
    path = ckpt.checkpoint_path(str(td), 5)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert sorted(manifest["files"]) == ["config.json", "meta.json",
                                         "state.msgpack"]
    for name, digest in manifest["files"].items():
        with open(os.path.join(path, name), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == digest
    assert ckpt.latest_valid_step(str(td)) == 5 == ckpt.latest_step(str(td))
    assert ckpt.wait_for_step(str(td), 5, poll_s=0.01)
    assert not ckpt.wait_for_step(str(td), 6, poll_s=0.01, timeout_s=0.03)
    blob = os.path.join(path, "state.msgpack")
    with open(blob, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    assert not ckpt.verify_checkpoint(str(td), 5)
    assert ckpt.latest_valid_step(str(td)) == 4
    assert ckpt.latest_step(str(td)) == 5          # committed, not valid
    assert jax_ckpt.latest_valid_step(str(td)) == 4
    tr = Trainer(_cfg(td, max_steps=5), device="cpu", printer=lambda _: None)
    out = capsys.readouterr().out
    assert "[ckpt] step 5 failed verification; falling back" in out
    assert f"RESUME from {ckpt.checkpoint_path(str(td), 4)} at step 4" in out
    assert tr.start_step == 4
    # A state that restores at no step raises instead of training anew.
    with pytest.raises(ValueError, match="optimizer state"):
        Trainer(_cfg(td, optimizer="adam"), device="cpu")


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_resume_is_bitwise(tmp_path, optimizer):
    """LeNet on Digits: 2 steps, then a new Trainer that resumes from
    model_step_2 for 2 more, against 4 uninterrupted steps: equal losses,
    and bitwise-equal parameters and optimizer state."""
    kw = dict(optimizer=optimizer, fused_optimizer=True,
              lr=0.05 if optimizer == "sgd" else 1e-3)
    whole, whole_steps = _run(_cfg(tmp_path / "a", **kw))
    _run(_cfg(tmp_path / "b", max_steps=2, **kw))
    resumed, resumed_steps = _run(_cfg(tmp_path / "b", **kw))
    assert resumed.start_step == 2
    assert [r["step"] for r in resumed_steps] == [3, 4]
    assert [r["loss"] for r in resumed_steps] == \
        [r["loss"] for r in whole_steps[2:]]
    want = convert.state_to_jax(whole.model, whole.step_fn.opt_state, 4)
    got = convert.state_to_jax(resumed.model, resumed.step_fn.opt_state, 4)
    _assert_trees_equal(got, want)
    assert msgpack_io.packb(got) == msgpack_io.packb(want)
    # The last checkpoint is step 4 in both runs, byte for byte.
    for name in ("state.msgpack", "meta.json"):
        a, b = (open(os.path.join(ckpt.checkpoint_path(str(d), 4), name),
                     "rb").read() for d in (tmp_path / "a", tmp_path / "b"))
        assert a == b


# ---------------------------------------------------------------- VGG --

def _tiny_cifar100(root, n_train=32, n_test=20):
    """CIFAR-100's python pickles (``cifar-100-python/{train,test}``) with
    a few seeded images, so that VGG11 trains and is scored fast."""
    import pickle
    base = root / "cifar-100-python"
    base.mkdir(parents=True)
    rng = np.random.default_rng(4)
    for name, n in (("train", n_train), ("test", n_test)):
        with open(base / name, "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         "fine_labels": rng.integers(0, 100, n).tolist()}, f)
    return str(root)


def _vgg_cfg(td, data_dir, **kw):
    base = dict(network="VGG11", dataset="Cifar100", data_dir=data_dir,
                batch_size=8, test_batch_size=20, lr=0.05, momentum=0.9,
                weight_decay=5e-4, compute_dtype="float32",
                fused_optimizer=True, epochs=0, max_steps=4, eval_freq=2,
                train_dir=str(td), log_every=1)
    base.update(kw)
    return config.TrainConfig(**base)


def _both_evaluators(td, step):
    """Both packages' evaluators on step ``step``, the port's in a thread
    beside the JAX one's build and compile."""
    with ThreadPoolExecutor(1) as pool:
        got = pool.submit(Evaluator(td, device="cpu",
                                    printer=lambda _: None).evaluate_step,
                          step)
        want = jax_evaluator.Evaluator(td, printer=lambda _: None
                                       ).evaluate_step(step)
        return got.result(), want


@pytest.fixture(scope="module")
def vgg_two_steps(tmp_path_factory):
    """The small CIFAR-100 and the port's VGG11 run of 2 steps (a
    checkpoint at 2), which both VGG tests start from: (data dir, train
    dir). A test that writes copies the train dir first."""
    root = tmp_path_factory.mktemp("vgg")
    data_dir = _tiny_cifar100(root / "data")
    td = root / "two_steps"
    _run(_vgg_cfg(td, data_dir, max_steps=2))
    return data_dir, td


def test_vgg_checkpoints_score_alike_in_both_evaluators(tmp_path,
                                                        vgg_two_steps):
    """VGG11 (BatchNorm, biased convs, 100 classes) on a small CIFAR-100:
    the port's checkpoint after 2 steps, and a JAX checkpoint of a seeded
    flax init, each scored by the JAX ``evaluate.py --once`` path and the
    port's evaluator to the same loss, Prec@1 and Prec@5."""
    data_dir, two_steps = vgg_two_steps
    td = str(two_steps)
    cfg = _vgg_cfg(td, data_dir, max_steps=2)
    jtd = str(tmp_path / "jax")
    state = create_train_state(jax_build_model("VGG11", 100),
                               jax_sgd(lr=0.05, momentum=0.9),
                               make_mesh(data=1), (1, 32, 32, 3),
                               jax.random.key(3))
    jcfg = jax_config.TrainConfig(**{**json.loads(cfg.to_json()),
                                     "train_dir": jtd})
    jax_ckpt.save_checkpoint(jtd, 3, state, config_json=jcfg.to_json())
    for path, step in ((td, 2), (jtd, 3)):
        got, want = _both_evaluators(path, step)
        assert got["step"] == want["step"] == step
        for k in ("loss", "prec1", "prec5"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_vgg_resume_with_dropout_is_bitwise(tmp_path, vgg_two_steps):
    """VGG11 with its two Dropout layers: 2 steps, then a resumed Trainer
    for 2 more, against 4 uninterrupted steps. The masks are drawn from
    (seed * 100003 + step, replica), so the resumed run draws the same
    ones: equal losses, bitwise parameters, momentum and checkpoint."""
    data_dir, two_steps = vgg_two_steps
    whole, whole_steps = _run(_vgg_cfg(tmp_path / "a", data_dir))
    shutil.copytree(two_steps, tmp_path / "b")
    resumed, resumed_steps = _run(_vgg_cfg(tmp_path / "b", data_dir))
    assert resumed.start_step == 2
    assert [r["loss"] for r in resumed_steps] == \
        [r["loss"] for r in whole_steps[2:]]
    want = convert.state_to_jax(whole.model, whole.step_fn.opt_state, 4)
    got = convert.state_to_jax(resumed.model, resumed.step_fn.opt_state, 4)
    _assert_trees_equal(got, want)
    for name in ("state.msgpack", "meta.json"):
        a, b = (open(os.path.join(ckpt.checkpoint_path(str(d), 4), name),
                     "rb").read() for d in (tmp_path / "a", tmp_path / "b"))
        assert a == b
    assert whole.model.Dropout_0.generator is whole.step_fn.dropout.generator
