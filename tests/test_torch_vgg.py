"""The port's VGG (ps_pytorch_tpu_torch/models/vgg.py) and its Dropout
against the flax VGG, on the CPU.

Weights are drawn by flax, carried across with ``models/convert.py`` and run
through both packages on the same numpy inputs at f32: train-mode and
eval-mode logits and the updated BatchNorm statistics agree at 1e-4, as do
the parameters after one data-parallel train step. Dropout draws threefry
bits in JAX and torch's Philox in the port, so the masks differ by design:
every train-mode comparison injects the same numpy masks on both sides
(``flax.linen.intercept_methods`` around ``nn.Dropout.__call__`` in JAX,
``Dropout.mask_fn`` in the port).

Max-pool ties cannot move a gradient here: every pool reads a ReLU output,
so the only likely ties are among exact zeros, and the gradient through
any of them dies in the ReLU (zero slope at and below zero in both
packages); ties among positive f32 values of continuous random inputs do
not occur.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.models import model_names as jax_model_names
from ps_pytorch_tpu.models import vgg as jax_vgg
from ps_pytorch_tpu.ops.fused_sgd import FusedSGD as JaxFusedSGD
from ps_pytorch_tpu.parallel import (
    create_train_state, make_mesh, make_train_step as jax_make_train_step,
)
from ps_pytorch_tpu_torch.models import build_model, convert, model_names
from ps_pytorch_tpu_torch.models import vgg
from ps_pytorch_tpu_torch.models.layers import Conv2d, Conv3x3, Dropout
from ps_pytorch_tpu_torch.ops.conv3x3 import conv3x3
from ps_pytorch_tpu_torch.ops.fused_sgd import FusedSGD
from ps_pytorch_tpu_torch.parallel import make_train_step
from test_torch_train import two_torch_threads  # noqa: F401

TOL = 1e-4
# A narrow VGG with the A cfg's five pools, and one whose last map is 8x8
# (flatten order NHWC matters there).
NARROW = (8, "M", 16, "M", 16, "M", 16, "M", 16, "M")
NARROW_8X8 = (8, "M", 16, "M", 16)
CASES = {
    "narrow_bn": (NARROW, True),
    "narrow_plain": (NARROW, False),
    "narrow_8x8_bn": (NARROW_8X8, True),
    "vgg11_bn": (jax_vgg.CFG["A"], True),
}


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _masks(features: int, batch: int, seed: int) -> dict:
    """Keep masks of the two Dropout layers, by their flax names."""
    rng = np.random.default_rng(seed)
    return {"Dropout_0": rng.random((batch, features)) < 0.5,
            "Dropout_1": rng.random((batch, 512)) < 0.5}


def _intercept(masks: dict):
    """Replaces each train-mode ``nn.Dropout.__call__`` with flax's
    arithmetic on the given keep mask."""
    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dropout) and context.method_name == "__call__" \
                and not mod.deterministic:
            x = args[0]
            keep = jnp.asarray(masks[mod.name])
            return jax.lax.select(keep, x / (1.0 - mod.rate),
                                  jnp.zeros_like(x))
        return next_fun(*args, **kwargs)
    return nn.intercept_methods(interceptor)


def _inject(pm, masks: dict) -> None:
    for name, keep in masks.items():
        getattr(pm, name).mask_fn = (
            lambda x, keep=keep: torch.from_numpy(keep))


def _features(cfg) -> int:
    pools = sum(v == "M" for v in cfg)
    return [v for v in cfg if v != "M"][-1] * (32 >> pools) ** 2


@functools.lru_cache(maxsize=None)
def _flax_case(name, conv_impl="xla"):
    """Flax weights of a VGG, its train-mode logits (injected masks) and
    updated statistics on a fixed batch, and its eval-mode logits on those
    statistics: made once, shared by the tests of this file."""
    cfg, bn = CASES[name]
    fm = jax_vgg.VGG(cfg, bn, 10, conv_impl=conv_impl)
    v = jax.jit(lambda k: fm.init(k, jnp.zeros((1, 32, 32, 3)),
                                  train=False))(jax.random.key(0))
    params = jax.device_get(v["params"])
    stats = jax.device_get(v.get("batch_stats", {}))
    x = _x((2, 32, 32, 3))
    masks = _masks(_features(cfg), 2, seed=5)
    with _intercept(masks):
        train, mut = fm.apply(v, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    new_stats = jax.device_get(mut.get("batch_stats", {}))
    evaluated = fm.apply({"params": params, "batch_stats": new_stats},
                         jnp.asarray(x), train=False)
    return (params, stats, x, masks, np.asarray(train), new_stats,
            np.asarray(evaluated))


def _port(name, params, stats, conv_impl="xla"):
    cfg, bn = CASES[name]
    pm = vgg.VGG(cfg, bn, 10, conv_impl=conv_impl)
    pm.load_state_dict(convert.from_jax(params, stats), strict=True)
    return pm


def _tree_close(a, b, tol=TOL):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _tree_close(a[k], b[k], tol)
        else:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                       rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_vgg_matches_flax(name, conv_impl):
    """Train-mode logits (masks injected) and the updated BatchNorm
    statistics, then eval-mode logits on those statistics; BN and
    ``_plain``, narrow and VGG11 at full width, through ``F.conv2d`` and
    through the conv kernel's module."""
    params, stats, x, masks, want_train, new_stats, want_eval = \
        _flax_case(name)
    pm = _port(name, params, stats, conv_impl)
    _inject(pm, masks)
    pm.train()
    got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.detach().numpy(), want_train, rtol=TOL,
                               atol=TOL)
    _, got_stats = convert.to_jax(pm.state_dict())
    _tree_close(got_stats, new_stats)
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want_eval, rtol=TOL, atol=TOL)


def test_vgg_matches_flax_pallas():
    """The JAX side through its Pallas conv (interpret mode on the CPU, as
    tests/test_pallas_conv.py runs it) against the port's kernel module."""
    want = _flax_case("narrow_bn", conv_impl="pallas")
    params, stats, x, masks, want_train, new_stats, want_eval = want
    pm = _port("narrow_bn", params, stats, "pallas")
    _inject(pm, masks)
    pm.train()
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               want_train, rtol=TOL, atol=TOL)
    _tree_close(convert.to_jax(pm.state_dict())[1], new_stats)
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want_eval, rtol=TOL, atol=TOL)


def test_dp_step_with_dropout_matches_jax():
    """One data-parallel train step of the narrow BN VGG with Dropout
    (fused SGD with momentum and weight decay, uint8 batches normalized on
    the device), the masks injected on both sides: loss, grad norm,
    updated parameters, momentum and statistics at 1e-4 against JAX's
    ``make_train_step`` on a 1-device mesh."""
    cfg = NARROW
    jm = jax_vgg.VGG(cfg, True, 10)
    mesh = make_mesh(data=1)
    kw = dict(momentum=0.9, weight_decay=5e-4)
    jtx = JaxFusedSGD(lr=0.05, **kw)
    state = create_train_state(jm, jtx, mesh, (1, 32, 32, 3),
                               jax.random.key(0))
    norm = (np.full(3, 1 / 64.0, np.float32), np.full(3, 2.0, np.float32))
    jstep = jax_make_train_step(jm, jtx, mesh, state, donate=False,
                                input_norm=norm)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 4).astype(np.int32)
    masks = _masks(_features(cfg), 4, seed=8)
    model = vgg.VGG(cfg, True, 10)
    model.load_state_dict(convert.from_jax(
        jax.device_get(state.params),
        jax.tree.map(lambda a: np.asarray(a)[0], state.batch_stats)))
    _inject(model, masks)
    step = make_train_step(model, FusedSGD(lr=0.05, **kw), input_norm=norm)
    with _intercept(masks):
        state, jmet = jstep(state, jnp.asarray(x), jnp.asarray(y),
                            jnp.ones(1, jnp.float32), jax.random.key(3))
    tm = step(x, y, np.ones(1, np.float32), key=3)
    np.testing.assert_allclose(float(tm["loss"]), float(jmet["loss"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=TOL)
    params, stats = convert.to_jax(model.state_dict())
    _tree_close(params, jax.device_get(state.params))
    _tree_close(convert.to_jax(step.opt_state.momentum)[0],
                jax.device_get(state.opt_state.momentum))
    _tree_close(stats, jax.tree.map(lambda a: np.asarray(a)[0],
                                    state.batch_stats))


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), tuple(v.shape)


@pytest.mark.parametrize("name", ["VGG11", "VGG16_plain", "VGG19"])
def test_state_dict_names_follow_flax(name):
    """Exactly the flax parameter and statistic paths and shapes, for
    every conv_impl (interchangeable state_dicts; biased convs)."""
    from ps_pytorch_tpu.models import build_model as jax_build_model
    shapes = jax.eval_shape(lambda: jax_build_model(name, 100).init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    want = dict(_paths({"params": shapes["params"],
                        "stats": shapes.get("batch_stats", {})}))
    for conv_impl in ("xla", "pallas", "pallas_im2col"):
        params, stats = convert.to_jax(
            build_model(name, 100, conv_impl=conv_impl).state_dict())
        assert dict(_paths({"params": params, "stats": stats})) == want


def test_registry_is_the_jax_registry():
    """Every name of the JAX registry builds in the port, "VGG11" with
    BatchNorm and "VGG11_plain" without."""
    assert model_names() == jax_model_names()
    bn = lambda m: any(k.startswith("BatchNorm_") for k in m.state_dict())
    assert bn(build_model("VGG11")) and not bn(build_model("VGG11_plain"))


def test_stride1_convs_past_the_input_take_the_kernel():
    """Under pallas, VGG11's 7 convs with at least 8 input channels are
    Conv3x3 modules with a bias; the 3-channel input conv stays
    F.conv2d. Under xla none is."""
    m = build_model("VGG11", conv_impl="pallas")
    kinds = [type(getattr(m, f"Conv_{k}")) for k in range(8)]
    assert kinds == [Conv2d] + [Conv3x3] * 7
    assert all(getattr(m, f"Conv_{k}").bias is not None for k in range(8))
    assert not any(isinstance(x, Conv3x3)
                   for x in build_model("VGG13", conv_impl="xla").modules())
    assert sum(isinstance(x, Conv3x3) for x in build_model(
        "VGG19_plain", conv_impl="pallas_im2col").modules()) == 15


def test_conv3x3_bias_is_added_after_the_kernel_in_the_compute_type():
    """bf16: the kernel's output rounded once, then ``+ bias.to(bf16)``
    rounded again, as ``PallasConv3x3`` adds it."""
    conv = Conv3x3(16, 24, torch.bfloat16, bias=True,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.bias.copy_(torch.linspace(-1, 1, 24))
    x = torch.from_numpy(_x((2, 16, 5, 5))).to(memory_format=torch.channels_last)
    got = conv(x)
    w = conv.weight.bfloat16().permute(2, 3, 1, 0).contiguous()
    core = conv3x3(x.bfloat16().permute(0, 2, 3, 1).contiguous(), w)
    want = (core + conv.bias.bfloat16()).permute(0, 3, 1, 2)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_conv3x3_bias_is_added_after_the_kernel_in_float16():
    """The f16 twin: the kernel's output rounded once to f16, then ``+
    bias.to(f16)`` rounded again; the conv's own sums are f32, so the f16
    output agrees with the f32 conv plus bias to one rounding of each."""
    conv = Conv3x3(16, 24, torch.float16, bias=True,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.bias.copy_(torch.linspace(-1, 1, 24))
    x = torch.from_numpy(_x((2, 16, 5, 5))).to(memory_format=torch.channels_last)
    got = conv(x)
    w = conv.weight.half().permute(2, 3, 1, 0).contiguous()
    core = conv3x3(x.half().permute(0, 2, 3, 1).contiguous(), w)
    want = (core + conv.bias.half()).permute(0, 3, 1, 2)
    assert got.dtype == torch.float16
    assert torch.equal(got, want)
    exact = conv3x3(x.half().permute(0, 2, 3, 1).contiguous().float(),
                    w.float()) + conv.bias.half().float()
    torch.testing.assert_close(got.float(), exact.permute(0, 3, 1, 2),
                               rtol=2e-3, atol=2e-3)


def test_conv_init_is_he_fan_out():
    """flax's ``variance_scaling(2.0, "fan_out", "normal")``: an
    untruncated normal of std sqrt(2 / (9 Co)); biases zero."""
    m = build_model("VGG11_plain", seed=1)
    w = m.Conv_7.weight.detach()                 # [512, 512, 3, 3]
    std = (2.0 / (9 * 512)) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.01
    assert w.abs().max().item() > 3 * std        # not truncated at 2 std
    assert torch.count_nonzero(m.Conv_7.bias) == 0
    ref = jax.nn.initializers.variance_scaling(2.0, "fan_out", "normal")(
        jax.random.key(0), (3, 3, 512, 512))
    assert abs(float(jnp.std(ref)) / std - 1) < 0.01


def test_dropout_arithmetic_and_draws():
    """Keep where the uniform draw is below 1 - rate, ``x / keep_prob``
    there and 0 elsewhere; the identity in eval mode; the same draws from
    the same seed; a train-mode call without a generator or a mask_fn
    raises, as does a mask of the wrong shape."""
    x = torch.from_numpy(_x((64, 32)))
    d = Dropout(0.25)
    with pytest.raises(RuntimeError, match="generator"):
        d(x)
    d.generator = torch.Generator().manual_seed(4)
    got = d(x)
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(4))
    want = torch.where(u < 0.75, x / 0.75, torch.zeros_like(x))
    assert torch.equal(got, want)
    d.eval()
    assert d(x) is x
    d.train()
    d.mask_fn = lambda t: torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="shape"):
        d(x)
    assert torch.equal(Dropout(0.0)(x), x)


def test_train_step_seeds_dropout_from_key_and_replica():
    """The step seeds the model's one Dropout generator from (key,
    replica): the same key gives the same step, another key other masks;
    a model with Dropout and no key raises; a model without Dropout holds
    no generator."""
    def run(key):
        model = vgg.VGG(NARROW, True, 10,
                        generator=torch.Generator().manual_seed(0))
        step = make_train_step(model, FusedSGD(lr=0.1, momentum=0.9))
        rng = np.random.default_rng(0)
        x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, 4).astype(np.int32)
        step(x, y, np.ones(1, np.float32), key=key)
        return step, model.state_dict()

    (step, a), (_, b), (_, c) = run(11), run(11), run(12)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Dense_0.weight"], c["Dense_0.weight"])
    assert step.model.Dropout_0.generator is step.dropout.generator
    with pytest.raises(ValueError, match="key"):
        step(np.zeros((2, 32, 32, 3), np.float32), np.zeros(2, np.int32),
             np.ones(1, np.float32))
    assert make_train_step(build_model("ResNet18"),
                           FusedSGD(lr=0.1)).dropout.generator is None


def test_async_slices_seed_dropout_from_key_and_slice():
    """``--mode async``: a slice's gradient seeds its Dropout from (key,
    slice index). The same key and slice give the same gradient, another
    slice other masks."""
    from ps_pytorch_tpu_torch.runtime.multislice import make_slice_grad_fn

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)

    def grad(index, key):
        model = vgg.VGG(NARROW, True, 10,
                        generator=torch.Generator().manual_seed(0))
        return make_slice_grad_fn(model, index=index)(x, y, key=key)[0]

    a, b, c = grad(0, 5), grad(0, 5), grad(1, 5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Dense_0.weight"], c["Dense_0.weight"])
