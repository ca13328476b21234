"""float16 through the port against the JAX package, on the CPU.

``--compute-dtype float16 --conv-impl pallas`` runs in the JAX package: its
Pallas conv sums f16 products in f32 and rounds once, and the models keep
f32 parameters and BatchNorm. The port's conv kernel takes f16 on the card
(``csrc/conv3x3.cu``); on the CPU its plain version computes the same
function, which these tests hold against the JAX package:

- two SGD steps of a small ResNet (one BasicBlock a stage) with every
  stride-1 3x3 through the conv module in f16, against the JAX step with
  the f16 Pallas conv in interpret mode, from the same weights;
- f16 checkpoints of each package scored by both evaluators;
- an f16 run resumed bitwise;
- the LM with ``compute_dtype="float16"`` and flash: both packages' LM
  trainers compute in f32 whatever the field says, so its steps are the
  f32 ones bit for bit.
"""

import pickle
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.models import resnet as jax_resnet
from ps_pytorch_tpu.ops.fused_sgd import FusedSGD as JaxFusedSGD
from ps_pytorch_tpu.parallel import (
    create_train_state, make_mesh, make_train_step as jax_make_train_step,
)
from ps_pytorch_tpu.runtime import checkpoint as jax_ckpt
from ps_pytorch_tpu.runtime import evaluator as jax_evaluator
from ps_pytorch_tpu_torch import config
from ps_pytorch_tpu_torch.data import augment
from ps_pytorch_tpu_torch.models import convert, resnet
from ps_pytorch_tpu_torch.ops.fused_sgd import FusedSGD
from ps_pytorch_tpu_torch.parallel import make_train_step
from ps_pytorch_tpu_torch.runtime import Evaluator, msgpack_io
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer
from ps_pytorch_tpu_torch.runtime.trainer import Trainer
from test_torch_train import two_torch_threads  # noqa: F401

# Losses: the packages round to f16 at other places (the conv's output is
# rounded once on both sides, but the BatchNorm, ReLU and the residual adds
# around it round where each framework casts), so one f16 rounding (~5e-4)
# compounds over the blocks; 1e-2 as the bf16 card checks.
LOSS_RTOL = 1e-2
# Parameters after two steps (f32 on both sides, lr 0.05): the activation
# gradients of the deeper blocks fall below f16's smallest normal (6.1e-5),
# where each package's own rounding points move them by whole subnormal
# steps, so f16 is ~3e-3 from the same steps in f32 and the two packages'
# f16 steps ~1.5e-3 from each other. 2e-3 absolute holds the packages
# together, and the test also checks that they are closer to each other
# than f16 is to f32 (f32 steps agree at 1e-4, tests/test_torch_train.py).
PARAM_TOL = 2e-3


def _flat(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", np.asarray(v)


def _max_diff(a, b):
    b = dict(_flat(b))
    return max(float(np.abs(v - b[k]).max()) for k, v in _flat(a))


def _assert_tree_close(a, b, tol, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_close(a[k], b[k], tol, f"{path}/{k}")
        else:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{path}/{k}")


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, n).astype(np.int32))


def test_f16_pallas_resnet_steps_match_jax():
    """ResNet(BasicBlock, (1, 1, 1, 1)) in f16 with ``pallas`` convs, the
    fused SGD (momentum 0.9, weight decay 5e-4) and on-device normalization
    of uint8 batches: two steps of the port's CPU path against JAX's
    ``make_train_step`` on a 1-device mesh with the f16 Pallas conv in
    interpret mode, from the JAX init carried by ``models/convert.py``; the
    same steps of the port in f32 measure f16's own error. Batches of seeds
    18 and 19 put no ReLU input within an f16 rounding of zero in either
    package."""
    mesh = make_mesh(data=1)
    kw = dict(momentum=0.9, weight_decay=5e-4)
    norm = augment.device_norm_constants("synthetic_cifar10")
    jmodel = jax_resnet.ResNet(jax_resnet.BasicBlock, (1, 1, 1, 1),
                               dtype=jnp.float16, conv_impl="pallas")
    jtx = JaxFusedSGD(lr=0.05, **kw)
    state = create_train_state(jmodel, jtx, mesh, (1, 32, 32, 3),
                               jax.random.key(0))
    jstep = jax_make_train_step(jmodel, jtx, mesh, state, donate=False,
                                input_norm=norm)
    stats = jax.tree.map(lambda a: np.asarray(a)[0], state.batch_stats)
    steps = {}
    for dtype in (torch.float16, torch.float32):
        model = resnet.ResNet(resnet.BasicBlock, (1, 1, 1, 1), dtype=dtype,
                              conv_impl="pallas")
        model.load_state_dict(convert.from_jax(jax.device_get(state.params),
                                               stats))
        steps[dtype] = (model, make_train_step(
            model, FusedSGD(lr=0.05, **kw), input_norm=norm))
    model, step = steps[torch.float16]
    model32, step32 = steps[torch.float32]
    batches = [_batch(4, seed) for seed in (18, 19)]

    def port_steps():
        """The port's two steps in both types, each step's state kept:
        they run in a thread while the JAX steps compile and run."""
        out = []
        for x, y in batches:
            tm = step(x, y, np.ones(1, np.float32))
            step32(x, y, np.ones(1, np.float32))
            out.append((float(tm["loss"]), {
                k: v.detach().clone()
                for k, v in model.state_dict().items()},
                all(p.dtype == torch.float32 for p in model.parameters()),
                convert.to_jax({k: v.detach().clone() for k, v in
                                model32.state_dict().items()})[0]))
        return out

    with ThreadPoolExecutor(1) as pool:
        ported = pool.submit(port_steps)
        jax_steps = []
        for k, (x, y) in enumerate(batches):
            state, jm = jstep(state, jnp.asarray(x), jnp.asarray(y),
                              jnp.ones(1, jnp.float32), jax.random.key(k))
            jax_steps.append((state, float(jm["loss"])))
        ported = ported.result()
    for (loss, sd, f32_params, f32), (state, jloss) in zip(ported,
                                                            jax_steps):
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        params, got_stats = convert.to_jax(sd)
        assert f32_params
        want = jax.device_get(state.params)
        _assert_tree_close(params, want, PARAM_TOL)
        assert _max_diff(params, want) < _max_diff(f32, want)
        _assert_tree_close(got_stats, jax.tree.map(
            lambda a: np.asarray(a)[0], state.batch_stats), PARAM_TOL)
    assert step.opt_state.step == 2


def _tiny_cifar10(root, per_batch=4, n_test=8):
    """CIFAR-10's python pickles (``cifar-10-batches-py``) with a few
    seeded images, so that ResNet-18 trains and is scored fast."""
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    rng = np.random.default_rng(5)
    names = [(f"data_batch_{i}", per_batch) for i in range(1, 6)]
    for name, n in names + [("test_batch", n_test)]:
        with open(base / name, "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         "labels": rng.integers(0, 10, n).tolist()}, f)
    return str(root)


def _cfg(td, data_dir, **kw):
    base = dict(network="ResNet18", dataset="Cifar10", data_dir=data_dir,
                batch_size=2, test_batch_size=8, lr=0.01, momentum=0.9,
                weight_decay=5e-4, compute_dtype="float16",
                conv_impl="pallas", fused_optimizer=True, epochs=0,
                max_steps=2, eval_freq=1, train_dir=str(td), log_every=1)
    base.update(kw)
    return config.TrainConfig(**base)


def _train(cfg):
    lines = []
    tr = Trainer(cfg, device="cpu", printer=lines.append)
    tr.train()
    return tr, [ln for ln in lines if ln.startswith("STEP")]


@pytest.fixture(scope="module")
def f16_run(tmp_path_factory):
    """Two uninterrupted f16 ResNet-18 steps on a small CIFAR-10 with a
    checkpoint after each: (data dir, train dir, trainer, STEP lines)."""
    root = tmp_path_factory.mktemp("f16")
    data_dir = _tiny_cifar10(root / "data")
    whole, steps = _train(_cfg(root / "whole", data_dir))
    return data_dir, str(root / "whole"), whole, steps


def test_f16_checkpoints_score_alike_in_both_evaluators(f16_run, tmp_path):
    """ResNet-18, f16, ``pallas``: the port's checkpoint after 2 steps and
    a checkpoint the JAX package writes from its own f16 pallas model's
    seeded flax init (the JAX evaluator's template), each scored by the
    port's evaluator and the JAX one; the EVAL lines agree field by field
    at 1e-4. lr 0.01 keeps the port's logits where an f16 rounding is
    below 1e-4 of the loss."""
    _, whole_dir, _, _ = f16_run
    td = str(tmp_path / "td")
    src = ckpt.checkpoint_path(whole_dir, 2)
    shutil.copytree(src, ckpt.checkpoint_path(td, 2))
    with open(f"{src}/config.json") as f:
        config_json = f.read()
    lines = {"port": [], "jax": []}
    ours = Evaluator(td, device="cpu", printer=lines["port"].append)
    theirs = jax_evaluator.Evaluator(td, printer=lines["jax"].append)
    with ThreadPoolExecutor(1) as pool:    # the port's beside the JAX's
        for step in (2, 3):
            if step == 3:  # the same config: both evaluators build once
                jax_ckpt.save_checkpoint(td, 3, theirs.template,
                                         config_json=config_json)
            done = pool.submit(ours.evaluate_step, step)
            theirs.evaluate_step(step)
            done.result()
    for line, jline, step in zip(lines["port"], lines["jax"], (2, 3)):
        got, want = line.split(), jline.split()
        assert got[:3] == want[:3] == ["EVAL", "step", str(step)]
        assert got[3::2] == want[3::2] == ["loss", "prec1", "prec5"]
        for a, b in zip(got[4::2], want[4::2]):
            assert np.isfinite(float(a))
            np.testing.assert_allclose(float(a), float(b), rtol=1e-4,
                                       atol=1e-4)


def test_f16_resume_is_bitwise(f16_run, tmp_path):
    """ResNet-18, f16, ``pallas``: a Trainer resumed from the step-1
    checkpoint of the uninterrupted run for one more step, against that
    run's step 2: equal STEP losses, bitwise f32 parameters, momentum and
    BatchNorm statistics, and the same step-2 checkpoint bytes (f32
    parameters in the JAX layout, whatever the compute type)."""
    data_dir, whole_dir, whole, whole_steps = f16_run
    shutil.copytree(ckpt.checkpoint_path(whole_dir, 1),
                    ckpt.checkpoint_path(str(tmp_path / "b"), 1))
    resumed, resumed_steps = _train(_cfg(tmp_path / "b", data_dir))
    assert resumed.start_step == 1
    loss = lambda line: line.split(" loss ")[1].split()[0]
    assert [loss(ln) for ln in resumed_steps] == \
        [loss(ln) for ln in whole_steps[1:]]
    want = convert.state_to_jax(whole.model, whole.step_fn.opt_state, 2)
    got = convert.state_to_jax(resumed.model, resumed.step_fn.opt_state, 2)
    assert msgpack_io.packb(got) == msgpack_io.packb(want)
    for d in (whole_dir, str(tmp_path / "b")):
        with open(f"{ckpt.checkpoint_path(d, 2)}/state.msgpack", "rb") as f:
            assert f.read() == msgpack_io.packb(want)
    assert all(p.dtype == torch.float32 for p in resumed.model.parameters())


@pytest.mark.parametrize("network", ["TransformerLM", "MoETransformerLM"])
def test_f16_lm_config_trains_as_f32(tmp_path, network):
    """``compute_dtype="float16"`` with flash is accepted by both packages'
    configs, and the port's LM step with it is the f32 one bit for bit:
    neither LM trainer reads the field."""
    kw = dict(network=network, lm_attention="flash", lm_vocab=61,
              lm_d_model=32, lm_layers=1, lm_heads=4, lm_seq_len=16,
              batch_size=4, lm_corpus_tokens=4000, lr=0.1, momentum=0.9,
              max_steps=2, eval_freq=0, resume=False)
    if network == "MoETransformerLM":
        kw.update(lm_experts=2)
    jax_config.TrainConfig(compute_dtype="float16", **kw)
    runs = {}
    for dtype in ("float32", "float16"):
        cfg = config.TrainConfig(compute_dtype=dtype,
                                 train_dir=str(tmp_path / dtype), **kw)
        lines = []
        tr = LMTrainer(cfg, device="cpu", printer=lines.append)
        tr.train()
        runs[dtype] = ([ln.split(" loss ")[1].split()[0] for ln in lines
                        if ln.startswith("STEP")], tr.model.state_dict())
    (l32, s32), (l16, s16) = runs["float32"], runs["float16"]
    assert len(l32) == 2 and l16 == l32
    assert set(s16) == set(s32)
    assert all(s16[k].dtype == torch.float32 and torch.equal(s16[k], s32[k])
               for k in s32)
