"""The port's training slice against the JAX package, on the CPU.

Config, loader, metrics and the data-parallel train step of
``ps_pytorch_tpu_torch`` are held against their JAX counterparts on the
same numpy inputs: one and two whole train steps (LeNet, and a ResNet with
one BasicBlock a stage through the conv kernel's module and the fused SGD)
against ``make_train_step`` on a 1-device mesh; the masked gradient mean
over a 2-process gloo group against a 2-device mesh; loader batches byte
for byte; STEP lines through the JAX parser. The port itself never imports
JAX, which a subprocess checks.
"""

import ast
import dataclasses
import io
import json
import os
import shutil
import socket
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.data import augment as jax_augment
from ps_pytorch_tpu.data import datasets as jax_datasets
from ps_pytorch_tpu.data import vision_io as jax_vision_io
from ps_pytorch_tpu.models import lenet as jax_lenet
from ps_pytorch_tpu.models import resnet as jax_resnet
from ps_pytorch_tpu.ops.fused_adam import FusedAdam as JaxFusedAdam
from ps_pytorch_tpu.ops.fused_sgd import FusedSGD as JaxFusedSGD
from ps_pytorch_tpu.optim import adam as jax_adam
from ps_pytorch_tpu.optim import sgd as jax_sgd
from ps_pytorch_tpu.parallel import (
    create_train_state, make_mesh, make_train_step as jax_make_train_step,
)
from ps_pytorch_tpu.runtime import metrics as jax_metrics
from ps_pytorch_tpu_torch import config, train
from ps_pytorch_tpu_torch.data import augment, datasets, vision_io
from ps_pytorch_tpu_torch.models import convert, lenet, resnet
from ps_pytorch_tpu_torch.ops.fused_adam import FusedAdam
from ps_pytorch_tpu_torch.ops.fused_sgd import FusedSGD
from ps_pytorch_tpu_torch.optim import SGD, Adam, build_optimizer
from ps_pytorch_tpu_torch.parallel import make_eval_step, make_train_step
from ps_pytorch_tpu_torch.runtime import metrics
from ps_pytorch_tpu_torch.runtime.trainer import Trainer, resolve_device

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "ps_pytorch_tpu_torch"
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for a file's tests (this file's, and those
    that import this fixture): the suite runs six test processes on the
    host's cores at once, and torch's default of a thread a core made
    their parallel regions contend, ~10x slower than alone."""
    held = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(held)


# ------------------------------------------------------------- config --

def test_config_fields_and_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(config.TrainConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jax_config.TrainConfig)}
    assert ours == theirs


def test_config_json_round_trips_with_jax():
    kw = dict(network="ResNet18", dataset="synthetic_cifar10", eval_freq=0,
              conv_impl="pallas", fused_optimizer=True, momentum=0.9,
              weight_decay=5e-4, batch_size=256)
    ours, theirs = config.TrainConfig(**kw), jax_config.TrainConfig(**kw)
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())
    assert config.TrainConfig.from_json(theirs.to_json()) == ours
    assert jax_config.TrainConfig.from_json(ours.to_json()) == theirs


@pytest.mark.parametrize("field,value", [
    ("leader_lease_s", 1.0), ("sync_topology", "hier"), ("shard_update", True),
    ("fault_spec", "kv_drop:p=0.1"), ("health_spec", "nonfinite:halt"),
    ("elastic", True), ("kv_replicas", "dir:/a,dir:/b,dir:/c"),
    ("sync_group_size", 2), ("sync_batchnorm", True), ("loader_workers", 4),
])
def test_unported_fields_raise(field, value):
    kw = {"eval_freq": 0, field: value}
    if field in config.OPS_FIELDS + config.SYNC_ONLY_FIELDS \
            + config.CONTROL_FIELDS:
        # The ops plane runs in sync, kofn and the LM, the step's options
        # in sync and kofn, the control plane in sync, kofn and async
        # across processes; --mode async in one process still refuses
        # them (ROADMAP.md).
        kw["mode"] = "async"
    if field == "elastic":
        kw["leader_lease_s"] = 1.0          # else the JAX check refuses
    if field == "sync_topology":
        # The hierarchical topology runs under --mode async only; the
        # JAX check refuses it without a homomorphic codec first.
        kw.update(compress_grad=True, grad_codec="int8lat")
    if field == "loader_workers":
        # The pool feeds every CNN trainer; the LM's loader has none.
        kw["network"] = "TransformerLM"
    with pytest.raises(ValueError, match="ROADMAP.md"):
        config.TrainConfig(**kw)


def test_default_flags_and_adam_are_ported():
    """The JAX defaults (checkpoint every 50 steps, resume) and Adam's
    fields now run; so does an LM that checkpoints."""
    cfg = config.config_from_args([])
    assert (cfg.eval_freq, cfg.resume) == (50, True)
    cfg = config.TrainConfig(optimizer="adam", adam_beta1=0.8,
                             adam_beta2=0.99, adam_eps=1e-6, amsgrad=True,
                             fused_optimizer=True, ckpt_keep=2)
    opt = build_optimizer(cfg)
    assert isinstance(opt, FusedAdam)
    assert (opt.b1, opt.b2, opt.eps, opt.amsgrad) == (0.8, 0.99, 1e-6, True)
    assert type(build_optimizer(dataclasses.replace(
        cfg, fused_optimizer=False))) is Adam
    assert config.TrainConfig(network="TransformerLM",
                              eval_freq=10).eval_freq == 10


def test_config_validates_like_jax():
    for bad in (dict(mode="turbo"), dict(conv_impl="winograd"),
                dict(nesterov=True, momentum=0.0),
                dict(lr_schedule="linear")):
        with pytest.raises(ValueError):
            config.TrainConfig(eval_freq=0, **bad)
        with pytest.raises(ValueError):
            jax_config.TrainConfig(eval_freq=0, **bad)
    assert config.TrainConfig(eval_freq=0,
                              dataset="synthetic_cifar100").num_classes == 100


def test_cli_flags():
    cfg = config.config_from_args(
        ["--eval-freq", "0", "--fused-optimizer", "--conv-impl", "pallas",
         "--weight-decay", "5e-4", "--resume", "false"])
    assert cfg.fused_optimizer is True and cfg.resume is False
    assert cfg.conv_impl == "pallas" and cfg.weight_decay == 5e-4
    assert config.config_from_args(
        ["--eval-freq", "0", "--fused-optimizer", "false"]
    ).fused_optimizer is False


# --------------------------------------------------------------- data --

def _batches(loader, n):
    return [loader.next_batch() for _ in range(n)]


@pytest.mark.parametrize("device_normalize", [True, False])
@pytest.mark.parametrize("dataset", ["synthetic_cifar10", "synthetic_mnist"])
def test_loader_batches_match_jax_bytes(dataset, device_normalize):
    """Same seed -> the same bytes as the JAX loader, train (shuffle, pad,
    crop, flip) across an epoch boundary, and test."""
    h, w, c = datasets.sample_shape(dataset)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(100, h, w, c), dtype=np.uint8)
    if dataset == "synthetic_mnist":
        x = (x / 255.0).astype(np.float32)
    y = rng.integers(0, 10, 100).astype(np.int32)
    for train_split in (True, False):
        kw = dict(dataset=dataset, train=train_split, seed=7,
                  device_normalize=device_normalize)
        if not train_split:
            kw.update(shuffle=False, drop_last=False)
        ours = _batches(datasets.DataLoader(x, y, 32, **kw), 5)
        theirs = _batches(jax_datasets.DataLoader(x, y, 32, **kw), 5)
        for (a, ay), (b, by) in zip(ours, theirs):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
            np.testing.assert_array_equal(ay, by)


@pytest.mark.parametrize("workers", [4, 0])
@pytest.mark.parametrize("dataset", ["synthetic_cifar10", "synthetic_mnist",
                                     "synthetic_imagenet_rrc"])
def test_loader_pool_matches_jax_bytes(dataset, workers):
    """``--loader-workers 4`` and ``0`` (one a CPU): the pool's batches
    (each from ``default_rng((seed, epoch, host, 7, b))``, the RRC sets'
    from counters) equal the JAX pool's byte for byte, across an epoch
    boundary, after a fast-forward, and on a second host."""
    h, w, c = datasets.sample_shape(dataset)
    if dataset == "synthetic_imagenet_rrc":
        h = w = 256
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, size=(40, h, w, c), dtype=np.uint8)
    if dataset == "synthetic_mnist":
        x = (x / 255.0).astype(np.float32)
    y = rng.integers(0, 10, 40).astype(np.int32)
    for host, skip in ((0, 0), (1, 3)):
        kw = dict(dataset=dataset, train=True, seed=7, host_id=host,
                  num_hosts=2, device_normalize=True, workers=workers)
        ours = datasets.DataLoader(x, y, 8, **kw)
        theirs = jax_datasets.DataLoader(x, y, 8, **kw)
        assert ours.workers == theirs.workers > 1
        ours.fast_forward(skip)
        theirs.fast_forward(skip)
        for _ in range(4):              # 2 batches an epoch a host
            (a, ay), (b, by) = ours.next_batch(), theirs.next_batch()
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
            np.testing.assert_array_equal(ay, by)


def test_loader_pool_raises_a_workers_error_and_stops():
    x = np.zeros((16, 28, 28, 1), np.float32)
    loader = datasets.DataLoader(x, np.zeros(16, np.int32), 4,
                                 dataset="synthetic_mnist", workers=3)

    def broken(*args):
        raise RuntimeError("assembly failed")

    loader._assemble = broken
    with pytest.raises(RuntimeError, match="assembly failed"):
        list(loader.epoch(0))
    with pytest.raises(ValueError, match="loader_workers"):
        config.TrainConfig(loader_workers=-1)


@pytest.mark.parametrize("dataset", ["synthetic_cifar10", "synthetic_mnist"])
def test_synthetic_sets_match_jax(dataset):
    a = datasets.load_arrays(dataset, train=False, seed=3)
    b = jax_datasets.load_arrays(dataset, train=False, seed=3)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def test_norm_constants_match_jax():
    for ds in ("MNIST", "Digits", "Cifar10", "Cifar100", "synthetic_cifar10",
               "synthetic_mnist"):
        ours, theirs = (augment.device_norm_constants(ds),
                        jax_augment.device_norm_constants(ds))
        if theirs is None:
            assert ours is None
            continue
        for u, v in zip(ours, theirs):
            assert u.tobytes() == v.tobytes()
    cfg = config.TrainConfig(eval_freq=0, dataset="synthetic_cifar10",
                             device_normalize=False)
    assert augment.input_norm_for(cfg) is None


def test_digits_match_jax_bytes():
    """The shipped Digits file gives the JAX package's splits (which read
    scikit-learn's copy) byte for byte, and the loaders the same batches,
    also after a fast-forward across an epoch boundary."""
    for train_split in (True, False):
        ours = vision_io.load_digits28(train_split)
        theirs = jax_vision_io.load_digits28(train_split)
        for u, v in zip(ours, theirs):
            assert u.dtype == v.dtype and u.shape == v.shape
            assert u.tobytes() == v.tobytes()
    cfg = config.TrainConfig(dataset="Digits", batch_size=128,
                             test_batch_size=100, seed=3)
    assert cfg.num_classes == 10
    for ours, theirs in zip(datasets.prepare_data(cfg),
                            jax_datasets.prepare_data(cfg)):
        for (a, ay), (b, by) in zip(_batches(ours, 3), _batches(theirs, 3)):
            assert a.tobytes() == b.tobytes() and ay.tobytes() == by.tobytes()
    ours, theirs = (mod.prepare_data(cfg)[0] for mod in (datasets,
                                                          jax_datasets))
    ours.fast_forward(13)               # 11 batches an epoch
    theirs.fast_forward(13)
    for (a, ay), (b, by) in zip(_batches(ours, 2), _batches(theirs, 2)):
        assert a.tobytes() == b.tobytes() and ay.tobytes() == by.tobytes()


def test_loader_rejects_bad_geometry():
    x, y = np.zeros((10, 4, 4, 1), np.uint8), np.zeros(10, np.int32)
    with pytest.raises(ValueError, match="divisible"):
        datasets.DataLoader(x, y, 7, num_hosts=2)
    with pytest.raises(ValueError, match="smaller"):
        datasets.DataLoader(x, y, 16)


# ------------------------------------------------------------ metrics --

@pytest.mark.parametrize("kw", [
    dict(step=1, epoch=0, loss=2.302585, acc=0.125, participating=1.0,
         step_time=0.0659, data_time=0.0001),
    dict(step=12, epoch=3, loss=float("inf"), acc=1.0, participating=2.0,
         step_time=1.5, data_time=0.25, mfu=None, examples_per_sec=3884.2,
         data_stall_frac=0.001),
])
def test_step_lines_match_jax(kw):
    line = metrics.format_line(**kw)
    assert line == jax_metrics.format_line(**kw)
    assert jax_metrics.parse_line(line) == metrics.parse_line(line)
    assert jax_metrics.parse_line(line)["step"] == kw["step"]


def test_jsonl_schema_matches_jax(tmp_path):
    recs = []
    for mod, name in ((metrics, "ours"), (jax_metrics, "theirs")):
        path = tmp_path / f"{name}.jsonl"
        with mod.MetricsLogger(str(path), printer=lambda _: None) as log:
            log.log_step(1, 0, loss=1.0, acc=0.5, participating=1.0,
                         step_time=0.1, data_time=0.01,
                         **metrics.derive_step_record(step_time_s=0.1,
                                                      data_time_s=0.01,
                                                      examples=64))
        rec = json.loads(path.read_text())
        rec.pop("ts")
        recs.append(rec)
    assert recs[0] == recs[1]
    assert set(metrics.JSONL_BASE_KEYS) == set(jax_metrics.JSONL_BASE_KEYS)


# --------------------------------------------------------- train step --

def _flax_state(model, tx, shape, mesh):
    return create_train_state(model, tx, mesh, (1,) + shape,
                              jax.random.key(0))


def _port_momentum(step):
    return convert.to_jax(step.opt_state.momentum)[0]


def _assert_tree_close(a, b, tol=TOL):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_close(a[k], b[k], tol)
        else:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                       rtol=tol, atol=tol, err_msg=k)


def _slice_inputs(name, n, seed):
    rng = np.random.default_rng(seed)
    if name == "LeNet":
        x = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
        norm = None
    else:       # raw uint8, normalized on the device
        x = rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)
        norm = augment.device_norm_constants("synthetic_cifar10")
    return x, rng.integers(0, 10, n).astype(np.int32), norm


# (JAX model, port model, sample shape, seeds of the two steps' batches).
# A ReLU input within rounding distance of zero takes the other side of
# the kink in one of the two packages and changes that element's gradient
# wholesale (about one step in five at these sizes); the seeds are ones
# whose batches put no ReLU input there.
STEP_CASES = {
    "LeNet": (jax_lenet.LeNet(), lambda: lenet.LeNet(), (28, 28, 1),
              (10, 11)),
    "ResNet": (jax_resnet.ResNet(jax_resnet.BasicBlock, (1, 1, 1, 1)),
               lambda: resnet.ResNet(resnet.BasicBlock, (1, 1, 1, 1),
                                     conv_impl="pallas"), (32, 32, 3),
               (18, 19)),
}


@pytest.mark.parametrize("name", ["LeNet", "ResNet"])
def test_train_steps_match_jax(name):
    """One and two steps of the slice, f32: LeNet with the fused SGD, and
    ResNet(BasicBlock, (1,1,1,1)) through the conv kernel's module
    (``pallas``), the fused SGD and on-device normalization of uint8
    batches, against JAX's ``make_train_step`` on a 1-device mesh (XLA
    convs, the Pallas fused SGD in interpret mode). Loss, grad norm,
    params, momentum and BN statistics agree at 1e-4."""
    jmodel, tmodel, shape, seeds = STEP_CASES[name]
    mesh = make_mesh(data=1)
    kw = dict(momentum=0.9, weight_decay=5e-4)
    norm = _slice_inputs(name, 1, 0)[2]
    jtx = JaxFusedSGD(lr=0.05, **kw)
    state = _flax_state(jmodel, jtx, shape, mesh)
    jstep = jax_make_train_step(jmodel, jtx, mesh, state, donate=False,
                                input_norm=norm)
    model = tmodel()
    stats = jax.tree.map(lambda a: np.asarray(a)[0], state.batch_stats)
    model.load_state_dict(convert.from_jax(jax.device_get(state.params),
                                           stats))
    step = make_train_step(model, FusedSGD(lr=0.05, **kw), input_norm=norm)
    for k, seed in enumerate(seeds):
        x, y, _ = _slice_inputs(name, 4, seed)
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(y),
                          jnp.ones(1, jnp.float32), jax.random.key(k))
        tm = step(x, y, np.ones(1, np.float32))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
        assert float(tm["participating"]) == 1.0
        params, got_stats = convert.to_jax(model.state_dict())
        _assert_tree_close(params, jax.device_get(state.params))
        _assert_tree_close(_port_momentum(step),
                           jax.device_get(state.opt_state.momentum))
        _assert_tree_close(got_stats, jax.tree.map(
            lambda a: np.asarray(a)[0], state.batch_stats))
    assert step.opt_state.step == 2


@pytest.mark.parametrize("fused", [False, True])
def test_adam_train_steps_match_jax(fused):
    """Two LeNet steps with Adam (weight decay) against JAX's
    ``make_train_step`` on a 1-device mesh with the JAX Adam (the fused
    one in interpret mode): loss, params and moments at 1e-4."""
    mesh = make_mesh(data=1)
    kw = dict(weight_decay=5e-4)
    jtx = (JaxFusedAdam(lr=1e-3, interpret=True, **kw) if fused
           else jax_adam(lr=1e-3, **kw))
    state = _flax_state(jax_lenet.LeNet(), jtx, (28, 28, 1), mesh)
    jstep = jax_make_train_step(jax_lenet.LeNet(), jtx, mesh, state,
                                donate=False)
    model = lenet.LeNet()
    model.load_state_dict(convert.from_jax(jax.device_get(state.params)))
    step = make_train_step(model, (FusedAdam if fused else Adam)(1e-3, **kw))
    for k, seed in enumerate((10, 11)):
        x, y, _ = _slice_inputs("LeNet", 4, seed)
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(y),
                          jnp.ones(1, jnp.float32), jax.random.key(k))
        tm = step(x, y, np.ones(1, np.float32))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL, atol=TOL)
        _assert_tree_close(convert.to_jax(model.state_dict())[0],
                           jax.device_get(state.params))
        for field in ("exp_avg", "exp_avg_sq"):
            _assert_tree_close(
                convert.to_jax(getattr(step.opt_state, field))[0],
                jax.device_get(getattr(state.opt_state, field)))
    assert step.opt_state.step == 2


def _lenet_step(opt=None, **kw):
    model = lenet.LeNet()
    return model, make_train_step(model, opt or SGD(0.1, momentum=0.9), **kw)


def test_all_zero_mask_is_a_noop():
    """mask == 0 leaves params, momentum and the step count untouched."""
    for opt in (SGD(0.1, momentum=0.9), FusedSGD(0.1, momentum=0.9)):
        model, step = _lenet_step(opt)
        x, y, _ = _slice_inputs("LeNet", 4, 0)
        step(x, y, np.ones(1, np.float32))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        mom = {k: v.clone() for k, v in step.opt_state.momentum.items()}
        m = step(x, y, np.zeros(1, np.float32))
        assert float(m["participating"]) == 0.0 and float(m["loss"]) == 0.0
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), k
        for k, v in step.opt_state.momentum.items():
            assert torch.equal(v, mom[k]), k
        assert step.opt_state.step == 1


def test_skip_nonfinite_leaves_params_alone():
    model, step = _lenet_step(skip_nonfinite=True)
    x, y, _ = _slice_inputs("LeNet", 4, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = step(np.full_like(x, np.nan), y, np.ones(1, np.float32))
    assert float(m["nonfinite"]) == 1.0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    m = step(x, y, np.ones(1, np.float32))
    assert float(m["nonfinite"]) == 0.0 and step.opt_state.step == 1


def test_mask_shape_is_checked():
    _, step = _lenet_step()
    x, y, _ = _slice_inputs("LeNet", 4, 0)
    with pytest.raises(ValueError, match="mask"):
        step(x, y, np.ones(2, np.float32))


def test_eval_step_counts():
    model, _ = _lenet_step()
    x, y, _ = _slice_inputs("LeNet", 32, 5)
    m = make_eval_step(model)(x, y)
    assert int(m["count"]) == 32
    assert 0 <= int(m["top1"]) <= int(m["top5"]) <= 32
    assert np.isfinite(float(m["sum_loss"]))


_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from ps_pytorch_tpu_torch.models import lenet
from ps_pytorch_tpu_torch.optim import SGD
from ps_pytorch_tpu_torch.parallel import make_train_step

port, rank, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
d = torch.load(path)
model = lenet.LeNet()
model.load_state_dict(d["state"])
step = make_train_step(model, SGD(0.1, momentum=0.9),
                       group=dist.group.WORLD)
out = {}
x, y = d["x"].numpy(), d["y"].numpy()
for i, mask in enumerate(d["masks"]):
    lo = 2 * rank
    m = step(x[lo:lo + 2], y[lo:lo + 2], mask.numpy())
    out[i] = {"loss": float(m["loss"]), "state": {
        k: v.clone() for k, v in model.state_dict().items()}}
torch.save(out, f"{path}.{rank}")
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_masked_mean_over_two_processes_matches_jax(tmp_path):
    """Two gloo processes, two examples each: the all_reduced masked mean
    sum(g*m)/max(sum(m),1) against a 2-device JAX mesh, for a full mask
    and then one replica masked out."""
    mesh = make_mesh(data=2)
    jmodel, jtx = jax_lenet.LeNet(), jax_sgd(lr=0.1, momentum=0.9)
    state = _flax_state(jmodel, jtx, (28, 28, 1), mesh)
    jstep = jax_make_train_step(jmodel, jtx, mesh, state, donate=False)
    x, y, _ = _slice_inputs("LeNet", 4, 3)
    masks = [np.ones(2, np.float32), np.array([1.0, 0.0], np.float32)]
    path = tmp_path / "inputs.pt"
    torch.save({"state": convert.from_jax(jax.device_get(state.params)),
                "x": torch.from_numpy(x), "y": torch.from_numpy(y),
                "masks": [torch.from_numpy(m) for m in masks]}, path)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(port),
                               str(r), str(path)], env=env)
             for r in range(2)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    got = [torch.load(f"{path}.{r}") for r in range(2)]
    for i, mask in enumerate(masks):
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(mask), jax.random.key(i))
        want = jax.device_get(state.params)
        for r in range(2):
            np.testing.assert_allclose(got[r][i]["loss"], float(jm["loss"]),
                                       rtol=TOL, atol=TOL)
            _assert_tree_close(convert.to_jax(got[r][i]["state"])[0], want)


# ------------------------------------------------------------ trainer --

def test_train_entry_point_on_cpu(tmp_path):
    """``python -m ps_pytorch_tpu_torch.train`` with --device cpu: CONFIG,
    STEP lines the JAX parser reads, and FINAL."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = train.main([
            "--network", "LeNet", "--dataset", "synthetic_mnist",
            "--batch-size", "32", "--test-batch-size", "2000",
            "--max-steps", "3", "--eval-freq", "0", "--lr", "0.05",
            "--momentum", "0.9", "--compute-dtype", "float32",
            "--fused-optimizer", "--train-dir", str(tmp_path / "td"),
            "--metrics-file", str(tmp_path / "m.jsonl"), "--device", "cpu"])
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("CONFIG ")
    steps = [jax_metrics.parse_line(ln) for ln in lines if ln.startswith(
        "STEP")]
    assert [s["step"] for s in steps] == [1, 2, 3]
    assert all(np.isfinite(s["loss"]) and s["mfu"] is None for s in steps)
    assert lines[-1].startswith("FINAL loss ")
    recs = [json.loads(ln) for ln in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]


def test_donate_and_loader_workers_run_on_the_cli(tmp_path):
    """``--donate false`` changes nothing in the port's step (it updates
    in place, where the JAX step donates its buffers); ``--loader-workers
    4`` trains on the pool's batches. Both configs round-trip with the JAX
    package's."""
    args = ["--network", "LeNet", "--dataset", "synthetic_mnist",
            "--batch-size", "32", "--test-batch-size", "2000",
            "--max-steps", "3", "--eval-freq", "0", "--momentum", "0.9",
            "--compute-dtype", "float32", "--device", "cpu"]
    finals = []
    for extra in (["--donate", "true"], ["--donate", "false"],
                  ["--loader-workers", "4"]):
        out = io.StringIO()
        with redirect_stdout(out):
            trainer, _ = train.run([*args, *extra, "--train-dir",
                                    str(tmp_path / extra[1])])
        cfg = trainer.cfg
        assert jax_config.TrainConfig.from_json(cfg.to_json()).to_json() \
            == cfg.to_json()
        finals.append([ln for ln in out.getvalue().splitlines()
                       if ln.startswith("FINAL")])
    assert finals[0] == finals[1] and len(finals[0]) == 1
    assert len(finals[2]) == 1


def test_trainer_refuses_what_it_cannot_do(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
    # K-of-N in one process: K can be at most the world of 1.
    with pytest.raises(ValueError, match="num_aggregate <= 1"):
        Trainer(config.TrainConfig(mode="kofn", num_aggregate=2,
                                   dataset="Digits",
                                   train_dir=str(tmp_path / "td")),
                device="cpu")


# ----------------------------------------------------------- isolation --

def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    """No module of the port, nor chip_smoke.py, imports jax, flax, optax,
    msgpack or the JAX package; importing every module leaves them out of
    sys.modules."""
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "msgpack",
                               "ps_pytorch_tpu"), f"{f}: imports {name}"
    mods = sorted(
        "ps_pytorch_tpu_torch." + ".".join(
            f.relative_to(PKG).with_suffix("").parts).removesuffix(
                ".__init__")
        for f in PKG.rglob("*.py")
        if f.name not in ("_sgd_triton.py", "_adam_triton.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m.rstrip('.'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'msgpack', 'ps_pytorch_tpu')]\n"
            "print(len(bad), bad[:5])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split()[0] == "0", out.stdout


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where there
    is no CUDA device, and where the port is not beside it."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    dirs = [tmp_path] if torch.cuda.is_available() else [REPO, tmp_path]
    for cwd in dirs:
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
