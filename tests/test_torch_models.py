"""The port's models (ps_pytorch_tpu_torch/models) against the flax models.

Weights are drawn by flax, carried across with ``models/convert.py`` and
run through both packages on the same numpy inputs: logits in train and
eval mode and the updated BatchNorm statistics agree at f32 1e-4. The JAX
side runs its convs through XLA (the Pallas conv is held equal to XLA by
the JAX package's own tests, and to the port's conv by test_torch_ops.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.models import lenet as jax_lenet
from ps_pytorch_tpu.models import resnet as jax_resnet
from ps_pytorch_tpu_torch.models import build_model, convert, lenet, resnet
from ps_pytorch_tpu_torch.models.layers import Conv3x3
from test_torch_train import two_torch_threads  # noqa: F401

TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _flax_resnet(block):
    """Flax weights of the one-block-a-stage ResNet, its train-mode logits
    and updated statistics on a fixed batch, and its eval-mode logits on
    those statistics: made once, shared by the tests of this file."""
    fm = jax_resnet.ResNet(RESNETS[block][0], (1, 1, 1, 1), num_classes=10)
    params, stats = _flax(fm, (1, 32, 32, 3))
    x = _x((2, 32, 32, 3))
    train, mut = jax.jit(lambda v, a: fm.apply(
        v, a, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    new_stats = jax.device_get(mut["batch_stats"])
    evaluated = jax.jit(lambda v, a: fm.apply(v, a, train=False))(
        {"params": params, "batch_stats": new_stats}, jnp.asarray(x))
    return (params, stats, x, np.asarray(train), new_stats,
            np.asarray(evaluated))


def _flax(model, shape, seed=0):
    v = jax.jit(lambda k: model.init(k, jnp.zeros(shape), train=False))(
        jax.random.key(seed))
    return jax.device_get(v["params"]), jax.device_get(v.get("batch_stats",
                                                             {}))


def _port(model, params, stats):
    model.load_state_dict(convert.from_jax(params, stats), strict=True)
    return model


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tree_close(a, b, tol=TOL):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_close(a[k], b[k], tol)
        else:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                       rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_lenet_logits_match_flax(train):
    fm = jax_lenet.LeNet(num_classes=10)
    params, _ = _flax(fm, (1, 28, 28, 1))
    pm = _port(lenet.LeNet(10), params, {})
    pm.train(train)
    x = _x((3, 28, 28, 1))
    want = fm.apply({"params": params}, jnp.asarray(x), train=train)
    got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


RESNETS = {
    "basic": (jax_resnet.BasicBlock, resnet.BasicBlock),
    "bottleneck": (jax_resnet.Bottleneck, resnet.Bottleneck),
}


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_resnet_matches_flax(block, conv_impl):
    """One block a stage at full width: train-mode logits and the updated
    batch_stats, then eval-mode logits on those statistics."""
    params, stats, x, want_train, new_stats, want_eval = _flax_resnet(block)
    pm = _port(resnet.ResNet(RESNETS[block][1], (1, 1, 1, 1), 10,
                             conv_impl=conv_impl), params, stats)
    pm.train()
    got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want_train, rtol=TOL,
                               atol=TOL)
    _, got_stats = convert.to_jax(pm.state_dict())
    _tree_close(got_stats, new_stats)
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want_eval, rtol=TOL, atol=TOL)


def test_convert_round_trip_and_replica_axis():
    """from_jax -> to_jax is the identity on the flax trees, and a
    training state's [n_data, C] batch_stats give replica 0's."""
    params, stats = _flax_resnet("basic")[:2]
    p2, s2 = convert.to_jax(convert.from_jax(params, stats))
    _tree_close(p2, params, tol=0)
    _tree_close(s2, stats, tol=0)
    stacked = jax.tree.map(
        lambda a: np.stack([a, a + 1.0, a + 2.0]), stats)
    sd = convert.from_jax(params, stacked)
    np.testing.assert_array_equal(sd["bn1.running_mean"].numpy(),
                                  stats["bn1"]["mean"])
    with pytest.raises(ValueError, match="unknown"):
        convert.from_jax({"fc": {"weird": np.zeros(3)}})


def test_resnet18_state_dict_names_follow_flax():
    """The port's ResNet18 has exactly the flax parameter and statistic
    paths, for both conv_impls (interchangeable state_dicts)."""
    fm = jax_resnet.ResNet18()
    shapes = jax.eval_shape(
        lambda: fm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                        train=False))

    def paths(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from paths(v, prefix + (k,))
            else:
                yield prefix + (k,), tuple(v.shape)

    want = {".".join(p): s for p, s in paths(
        {"params": shapes["params"], "stats": shapes["batch_stats"]})}
    for conv_impl in ("xla", "pallas", "pallas_im2col"):
        params, stats = convert.to_jax(
            build_model("ResNet18", conv_impl=conv_impl).state_dict())
        got = {".".join(p): s for p, s in paths(
            {"params": params, "stats": stats})}
        assert got == want


def test_build_model_routes_stride1_3x3s_to_the_kernel():
    """ResNet-18 has 13 stride-1 3x3 convs: under pallas they are Conv3x3
    modules, everything else stays F.conv2d."""
    count = lambda m: sum(isinstance(x, Conv3x3) for x in m.modules())
    assert count(build_model("ResNet18", conv_impl="xla")) == 0
    assert count(build_model("ResNet18", conv_impl="pallas")) == 13
    m = build_model("ResNet18", conv_impl="pallas_im2col")
    assert {x.variant for x in m.modules() if isinstance(x, Conv3x3)} == {
        "im2col"}
    assert count(build_model("ResNet50", conv_impl="pallas")) == 13
    assert count(build_model("LeNet", conv_impl="pallas")) == 0
    with pytest.raises(ValueError, match="AlexNet"):
        build_model("AlexNet")


def test_activations_stay_channels_last():
    """The conv kernel's NHWC view of every activation is free: each
    Conv3x3 receives a channels_last tensor."""
    m = build_model("ResNet18", conv_impl="pallas")
    seen = []
    for mod in m.modules():
        if isinstance(mod, Conv3x3):
            mod.register_forward_hook(lambda mod, inp, out: seen.append(
                inp[0].is_contiguous(memory_format=torch.channels_last)
                and out.is_contiguous(memory_format=torch.channels_last)))
    m.eval()
    with torch.no_grad():
        m(torch.from_numpy(_x((2, 32, 32, 3))))
    assert seen == [True] * 13


def test_bf16_compute_keeps_f32_params_and_logits():
    m = build_model("ResNet18", compute_dtype="bfloat16", conv_impl="pallas")
    assert all(p.dtype == torch.float32 for p in m.parameters())
    m.eval()
    with torch.no_grad():
        out = m(torch.from_numpy(_x((2, 32, 32, 3))))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_seeded_init_is_reproducible():
    a = build_model("LeNet", seed=3).state_dict()
    b = build_model("LeNet", seed=3).state_dict()
    c = build_model("LeNet", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc1.weight"], c["fc1.weight"])
