"""The port's ImageNet geometry against the JAX package, on the CPU: the
ImageNet-stem ResNets (7x7/2 conv, 3x3/2 max pool, global mean) at f32
1e-4, and the random-resized-crop input path bit for bit: the rectangles,
the integer resize, the center crop, the native kernel against its numpy
version, the synthetic 256 px store and the loader's train and eval
batches. Then ResNet18_ImageNet on a small synthetic_imagenet_rrc store
through ``train.main`` and ``evaluate.main``.
"""

import functools
import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from ps_pytorch_tpu.data import augment as jax_augment
from ps_pytorch_tpu.data import datasets as jax_datasets
from ps_pytorch_tpu.data import vision_io as jax_vision_io
from ps_pytorch_tpu.models import resnet as jax_resnet
from ps_pytorch_tpu_torch import config, evaluate, train
from ps_pytorch_tpu_torch.data import augment, datasets, vision_io
from ps_pytorch_tpu_torch.models import build_model, convert, resnet
from ps_pytorch_tpu_torch.models.layers import Conv3x3
from test_torch_train import two_torch_threads  # noqa: F401

TOL = 1e-4
RRC = "synthetic_imagenet_rrc"


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tree_close(a, b, tol=TOL):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _tree_close(a[k], b[k], tol)
        else:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                       rtol=tol, atol=tol, err_msg=k)


@functools.lru_cache(maxsize=None)
def _flax_stem_resnet():
    """One Bottleneck a stage with the ImageNet stem at 64 px: flax
    weights, train-mode logits and updated statistics, eval-mode logits."""
    fm = jax_resnet.ResNet(jax_resnet.Bottleneck, (1, 1, 1, 1),
                           num_classes=10, imagenet_stem=True)
    v = jax.jit(lambda k: fm.init(k, jnp.zeros((1, 64, 64, 3)),
                                  train=False))(jax.random.key(0))
    x = _x((2, 64, 64, 3))
    train_out, mut = jax.jit(lambda v, a: fm.apply(
        v, a, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    new_stats = jax.device_get(mut["batch_stats"])
    evaluated = jax.jit(lambda v, a: fm.apply(v, a, train=False))(
        {"params": v["params"], "batch_stats": new_stats}, jnp.asarray(x))
    return (jax.device_get(v["params"]), jax.device_get(v["batch_stats"]),
            x, np.asarray(train_out), new_stats, np.asarray(evaluated))


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_imagenet_stem_resnet_matches_flax(conv_impl):
    params, stats, x, want_train, new_stats, want_eval = _flax_stem_resnet()
    pm = resnet.ResNet(resnet.Bottleneck, (1, 1, 1, 1), 10,
                       conv_impl=conv_impl, imagenet_stem=True)
    pm.load_state_dict(convert.from_jax(params, stats), strict=True)
    pm.train()
    got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want_train, rtol=TOL,
                               atol=TOL)
    _tree_close(convert.to_jax(pm.state_dict())[1], new_stats)
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want_eval, rtol=TOL, atol=TOL)


def test_stem_pool_pads_with_minus_infinity():
    """The stem's 3x3/2 max pool pads with -inf, as flax does: a padded
    cell never wins, even over negative values."""
    x = -torch.rand(1, 4, 9, 9) - 1.0
    got = torch.nn.functional.max_pool2d(x, 3, 2, 1)
    want = jax.lax.reduce_window(
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()), -jnp.inf, jax.lax.max,
        (1, 3, 3, 1), (1, 2, 2, 1), ((0, 0), (1, 1), (1, 1), (0, 0)))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), tuple(v.shape)


@pytest.mark.parametrize("name", ["ResNet18_ImageNet", "ResNet50_ImageNet"])
def test_imagenet_resnets_follow_flax(name):
    """The flax parameter and statistic paths and shapes (1000 classes by
    default) for every conv_impl; under pallas the 13 stride-1 3x3s past
    the stem are Conv3x3 (ResNet-50: 3 at 56, 3 at 28, 5 at 14, 2 at 7)."""
    jm = getattr(jax_resnet, name)()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    want = dict(_paths({"params": shapes["params"],
                        "stats": shapes["batch_stats"]}))
    assert want["params.linear.kernel"][1] == 1000
    for conv_impl in ("xla", "pallas", "pallas_im2col"):
        m = build_model(name, 1000, conv_impl=conv_impl)
        params, stats = convert.to_jax(m.state_dict())
        assert dict(_paths({"params": params, "stats": stats})) == want
    m = build_model(name, 1000, conv_impl="pallas")
    convs = [x for x in m.modules() if isinstance(x, Conv3x3)]
    widths = [c.weight.shape[0] for c in convs]
    assert widths == ([64] * 3 + [128] * 3 + [256] * 5 + [512] * 2
                      if name == "ResNet50_ImageNet" else
                      [64] * 4 + [128] * 3 + [256] * 3 + [512] * 3)


# ------------------------------------------------------------- the RRC --

def test_rrc_params_and_tables_are_bitwise_jax():
    """The counter-based uniforms, the rectangles and flips (the attempt
    loop and the fallback), and the axis tables, bit for bit."""
    counters = np.arange(0, 4000, 7, dtype=np.uint64) * np.uint64(977)
    np.testing.assert_array_equal(
        augment._counter_uniforms(5, counters, 41),
        jax_augment._counter_uniforms(5, counters, 41))
    for (h, w), ratio in (((256, 256), (3 / 4, 4 / 3)),
                          ((300, 200), (3 / 4, 4 / 3)),
                          ((40, 200), (3 / 4, 4 / 3)),     # fallback: wide
                          ((200, 40), (3 / 4, 4 / 3)),     # fallback: tall
                          ((64, 64), (1.0, 1.0))):
        for seed in (0, 42):
            got = augment.rrc_params(seed, counters, h, w, ratio=ratio)
            want = jax_augment.rrc_params(seed, counters, h, w, ratio=ratio)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for crop, out in ((1, 224), (37, 224), (224, 224), (256, 224),
                      (5, 3)):
        for a, b in zip(augment._rrc_axis_tables(crop, out),
                        jax_augment._rrc_axis_tables(crop, out)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _rrc_inputs(seed=0, n=6, h=70, w=90, b=10):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    sel = rng.integers(0, n, b)
    params = augment.rrc_params(seed, np.arange(b, dtype=np.uint64), h, w)
    return src, sel, params


def test_rrc_numpy_and_center_crop_are_bitwise_jax():
    src, sel, params = _rrc_inputs()
    for oh, ow in ((56, 48), (224, 224)):
        got = augment._rrc_numpy(src, sel, *params, oh, ow,
                                 np.empty((len(sel), oh, ow, 3), np.uint8))
        want = jax_augment._rrc_numpy(src, sel, *params, oh, ow,
                                      np.empty((len(sel), oh, ow, 3),
                                               np.uint8))
        assert got.tobytes() == want.tobytes()
    x = np.random.default_rng(1).integers(0, 256, (3, 256, 250, 3),
                                          dtype=np.uint8)
    for oh, ow in ((224, 224), (256, 250), (17, 30)):
        assert augment.center_crop(x, oh, ow).tobytes() == \
            jax_augment.center_crop(x, oh, ow).tobytes()


def test_native_rrc_is_bitwise_its_numpy_version():
    """``rrc_batch`` through the kernel compiled into the port's build/
    directory equals ``_rrc_numpy``, flips and edge rectangles included."""
    if augment.rrc_backend() != "native":
        pytest.skip("no C++ compiler (g++) on this host: the native RRC "
                    "kernel cannot be built, the numpy version runs")
    src, sel, params = _rrc_inputs(seed=3, n=8, h=256, w=256, b=24)
    for oh, ow in ((224, 224), (31, 17)):
        got = augment.rrc_batch(src, sel, *params, oh, ow)
        want = augment._rrc_numpy(src, sel, *params, oh, ow,
                                  np.empty((len(sel), oh, ow, 3), np.uint8))
        assert got.tobytes() == want.tobytes()
    assert augment._load_native_loader()._name.startswith(
        str(augment.BUILD / "libpsloader-"))


@pytest.mark.parametrize("device_normalize", [True, False])
def test_rrc_loader_batches_are_bitwise_jax(device_normalize):
    """The synthetic_imagenet_rrc loader over a small 256 px store: one
    epoch and into the next of train batches (RRC from counters epoch * N +
    sample) and the eval batches (center crop 224), byte for byte against
    the JAX single-worker loader for the same seed."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (10, 256, 256, 3), dtype=np.uint8)
    y = rng.integers(0, 1000, 10).astype(np.int32)
    for train_split, n in ((True, 6), (False, 3)):
        kw = dict(dataset=RRC, train=train_split, seed=7,
                  device_normalize=device_normalize)
        if not train_split:
            kw.update(shuffle=False, drop_last=False)
        ours = datasets.DataLoader(x, y, 4, **kw)
        theirs = jax_datasets.DataLoader(x, y, 4, **kw)
        for _ in range(n):
            (a, ay), (b, by) = ours.next_batch(), theirs.next_batch()
            assert a.shape[1:] == (224, 224, 3)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes() and ay.tobytes() == by.tobytes()


@pytest.mark.parametrize("dataset", [RRC, "synthetic_imagenet"])
def test_synthetic_imagenet_sets_match_jax(dataset, monkeypatch):
    """The storage (256 px uint8 for the RRC set, 224 px float for the
    other), the labels and the test split of max(n // 6, min(1000, n)),
    byte for byte, at a train size cut to 12 in both packages."""
    shape = datasets.DATASET_SHAPES[dataset][:4] + (12,)
    assert jax_datasets.DATASET_SHAPES[dataset] == \
        datasets.DATASET_SHAPES[dataset]
    monkeypatch.setitem(datasets.DATASET_SHAPES, dataset, shape)
    monkeypatch.setitem(jax_datasets.DATASET_SHAPES, dataset, shape)
    for train_split in (True, False):
        a = datasets.load_arrays(dataset, train=train_split, seed=3)
        b = jax_datasets.load_arrays(dataset, train=train_split, seed=3)
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.shape == v.shape
            assert u.tobytes() == v.tobytes()
        assert len(a[0]) == 12
        if dataset == RRC:
            assert a[0].dtype == np.uint8 and a[0].shape[1:] == (256, 256, 3)
        else:
            assert a[0].dtype == np.float32 and a[0].shape[1:] == (224, 224,
                                                                   3)


def test_norm_constants_and_shapes_match_jax():
    for ds in ("SVHN", "synthetic_imagenet", RRC, "ImageNet"):
        ours, theirs = (augment.norm_constants_for(ds),
                        jax_augment.norm_constants_for(ds))
        if theirs is None:
            assert ours is None
            continue
        for u, v in zip(ours, theirs):
            assert np.asarray(u).tobytes() == np.asarray(v).tobytes()
    assert augment.CROP_STACKS["SVHN"] == jax_augment.CROP_STACKS["SVHN"]
    assert augment.RRC_STACKS == jax_augment.RRC_STACKS
    assert datasets._STORAGE_HW == jax_datasets._STORAGE_HW
    for ds in ("SVHN", "synthetic_imagenet", RRC):
        assert datasets.DATASET_SHAPES[ds] == jax_datasets.DATASET_SHAPES[ds]
    assert config.TrainConfig(dataset=RRC).num_classes == 1000
    assert config.TrainConfig(dataset="synthetic_cifar100").num_classes == 100


def test_svhn_parser_matches_jax(tmp_path):
    """A small file in SVHN's .mat layout (HWCN images, label 10 for the
    digit 0), read by both parsers."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (32, 32, 3, 5), dtype=np.uint8)
    y = np.array([[10], [1], [3], [10], [9]], np.uint8)
    for split in ("train", "test"):
        scipy.io.savemat(tmp_path / f"{split}_32x32.mat", {"X": x, "y": y})
    for train_split in (True, False):
        got = vision_io.load_svhn(str(tmp_path), train_split)
        want = jax_vision_io.load_svhn(str(tmp_path), train_split)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert list(got[1]) == [0, 1, 3, 0, 9]


def test_train_and_evaluate_entry_points_on_a_small_rrc_store(
        tmp_path, monkeypatch):
    """ResNet18_ImageNet on synthetic_imagenet_rrc cut to 8 images a
    split: ``train.main`` (RRC batches, 224 px, uint8 normalized in the
    step, the conv kernel's module) writes model_step_2, and
    ``evaluate.main --once 2`` scores it on the center-cropped test split
    to the trainer's own final evaluation."""
    shape = datasets.DATASET_SHAPES[RRC][:4] + (8,)
    monkeypatch.setitem(datasets.DATASET_SHAPES, RRC, shape)
    td = str(tmp_path / "td")
    out = io.StringIO()
    with redirect_stdout(out):
        train.main(["--network", "ResNet18_ImageNet", "--dataset", RRC,
                    "--batch-size", "4", "--test-batch-size", "8",
                    "--max-steps", "2", "--eval-freq", "2",
                    "--compute-dtype", "float32", "--conv-impl", "pallas",
                    "--fused-optimizer", "--momentum", "0.9",
                    "--train-dir", td, "--device", "cpu"])
        evaluate.main(["--train-dir", td, "--once", "2", "--device", "cpu"])
    text = out.getvalue()
    assert [int(s) for s in re.findall(r"^STEP (\d+) ", text, re.M)] == [1, 2]
    final = re.search(r"^FINAL loss (\S+) prec1 (\S+) prec5 (\S+)$", text,
                      re.M).groups()
    ev = re.search(r"^EVAL step 2 loss (\S+) prec1 (\S+) prec5 (\S+)$", text,
                   re.M).groups()
    assert all(np.isfinite(float(v)) for v in final)
    np.testing.assert_allclose([float(v) for v in ev],
                               [float(v) for v in final], rtol=1e-5)
