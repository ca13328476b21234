"""The port's kernels (ps_pytorch_tpu_torch/ops) against the JAX package.

On the CPU every wrapper runs its plain PyTorch version, and these tests
hold that version against the JAX functions it replaces: the Pallas conv in
interpret mode, its custom VJP, the Pallas fused SGD and Adam and the optax
SGD and Adam.
Inputs are made with numpy from a seed and handed to both packages.

The hand-written kernels themselves are held against their plain versions
on the card by tests/test_torch_kernels.py.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ps_pytorch_tpu.ops import fused_adam as jax_fused_adam
from ps_pytorch_tpu.ops import fused_sgd as jax_fused_sgd
from ps_pytorch_tpu.ops import pallas_conv as jax_conv
from ps_pytorch_tpu.optim import adam as jax_adam
from ps_pytorch_tpu.optim import schedules as jax_schedules
from ps_pytorch_tpu.optim import sgd as jax_sgd
from ps_pytorch_tpu_torch.ops import _backend, _build
from ps_pytorch_tpu_torch.ops import conv3x3 as conv
from ps_pytorch_tpu_torch.ops import fused_adam, fused_sgd
from ps_pytorch_tpu_torch.optim import SGD, Adam, schedules
from test_torch_train import two_torch_threads  # noqa: F401

# float16: both sides sum in f32 and round once, so they differ by at most
# one f16 rounding of sums that agree to f32 order (2e-3 holds ~2 ulp of f16
# at the outputs' magnitude, ~1).
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-3}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}


def _conv_inputs(seed, n=2, hw=8, c=16, co=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, hw, hw, c)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c, co)) / np.sqrt(9 * c)).astype(np.float32)
    return x, w


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TORCH[dtype])


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JNP[dtype])


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


# ------------------------------------------------------------ conv3x3 --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("variant", ["taps9", "im2col"])
@pytest.mark.parametrize("kind", ["forward", "input_grad"])
def test_conv3x3_matches_jax(kind, variant, dtype):
    """N=2, 8x8, C=16 -> 8: the port's conv3x3 / conv3x3_input_grad on the
    CPU against the Pallas kernel in interpret mode."""
    x, w = _conv_inputs(0)
    if kind == "forward":
        got = conv.conv3x3(_t(x, dtype), _t(w, dtype), variant)
        want = jax_conv.conv3x3(_j(x, dtype), _j(w, dtype), variant=variant,
                                interpret=True)
    else:
        g = np.random.default_rng(1).normal(size=(2, 8, 8, 8)).astype(
            np.float32)
        got = conv.conv3x3_input_grad(_t(g, dtype), _t(w, dtype), variant)
        want = jax_conv.conv3x3_input_grad(_j(g, dtype), _j(w, dtype),
                                           variant=variant, interpret=True)
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_conv3x3_function_grads_match_jax_vjp():
    """Conv3x3Function's dx (the kernel on the flipped weight) and dW (9
    tap contractions) against the custom VJP of ``conv3x3_op``."""
    x, w = _conv_inputs(2)
    g = np.random.default_rng(3).normal(size=(2, 8, 8, 8)).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    out = conv.Conv3x3Function.apply(xt, wt, "taps9")
    out.backward(_t(g))
    want_out, vjp = jax.vjp(lambda a, b: jax_conv.conv3x3_op(a, b, "taps9"),
                            _j(x), _j(w))
    dx, dw = vjp(_j(g))
    np.testing.assert_allclose(_np(out), _np(want_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(xt.grad), _np(dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(wt.grad), _np(dw), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", [
    dict(x=(2, 8, 8, 16), w=(3, 3, 8, 8)),     # C mismatch
    dict(x=(2, 8, 8, 16), w=(5, 5, 16, 8)),    # not 3x3
    dict(x=(8, 8, 16), w=(3, 3, 16, 8)),       # not 4-D
])
def test_conv3x3_rejects_bad_shapes(bad):
    with pytest.raises(ValueError):
        conv.conv3x3(torch.zeros(bad["x"]), torch.zeros(bad["w"]))


def test_conv3x3_rejects_unknown_variant_and_mixed_dtypes():
    x, w = torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 8)
    with pytest.raises(ValueError, match="variant"):
        conv.conv3x3(x, w, "winograd")
    with pytest.raises(ValueError, match="bfloat16"):
        conv.conv3x3(x, w.bfloat16())


@pytest.mark.parametrize("dtype,c,co,pointers,want", [
    (torch.bfloat16, 64, 64, (0, 256, 4096), "tc"),
    (torch.bfloat16, 24, 72, (16, 48, 80), "tc"),      # ragged C and Co
    (torch.bfloat16, 8, 8, (), "tc"),
    (torch.float32, 64, 64, (0, 256, 4096), "tc"),     # f32 as 3xTF32
    (torch.float32, 24, 72, (16, 48, 80), "tc"),       # ragged C and Co
    (torch.float32, 3, 64, (0, 256, 4096), "simt"),    # the CIFAR stem
    (torch.float32, 12, 16, (0, 0, 0), "simt"),        # C % 8
    (torch.float32, 16, 12, (0, 0, 0), "simt"),        # Co % 8
    (torch.float32, 64, 64, (4, 256, 4096), "simt"),   # x off 16 bytes
    (torch.float32, 64, 64, (0, 8, 4096), "simt"),     # w off 16 bytes
    (torch.float32, 64, 64, (0, 256, 4100), "simt"),   # out off 16 bytes
    (torch.bfloat16, 12, 16, (0, 0, 0), "simt"),       # C % 8
    (torch.bfloat16, 16, 12, (0, 0, 0), "simt"),       # Co % 8
    (torch.bfloat16, 64, 64, (2, 256, 4096), "simt"),  # x off 16 bytes
    (torch.bfloat16, 64, 64, (0, 8, 4096), "simt"),    # w off 16 bytes
    (torch.bfloat16, 64, 64, (0, 256, 4104), "simt"),  # out off 16 bytes
    (torch.float16, 64, 64, (0, 256, 4096), "tc"),     # f16 as bf16
    (torch.float16, 24, 72, (16, 48, 80), "tc"),
    (torch.float16, 12, 16, (0, 0, 0), "simt"),        # C % 8
    (torch.float16, 16, 12, (0, 0, 0), "simt"),        # Co % 8
    (torch.float16, 64, 64, (2, 256, 4096), "simt"),   # x off 16 bytes
    (torch.float16, 64, 64, (0, 256, 4104), "simt"),   # out off 16 bytes
])
def test_conv3x3_route_by_dtype_channels_and_alignment(dtype, c, co,
                                                       pointers, want):
    """The kernel a CUDA call takes is decided from dtype, C, Co and the
    pointers' alignment before the launch."""
    assert conv.route(dtype, c, co, *pointers) == want


# The f32 tensor-core kernel's arithmetic (csrc/conv3x3.cu,
# conv3x3_tf32_kernel), which has no CPU mode: 3xTF32, emulated in numpy.

def _truncate_tf32(x):
    """The top 19 bits of f32 x (TF32): what the tensor cores read of it,
    and the kernel's hi (a mask)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _round_tf32(x):
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def _toward_zero(x):
    """f64 x to f32, truncated toward zero."""
    f = x.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(x),
                    np.nextafter(f, np.float32(0)), f)


def _taps(xp, h, wd, t):
    """Tap t's shifted pixels of the padded xp, [N*H*W, C]."""
    return xp[:, t // 3:t // 3 + h, t % 3:t % 3 + wd, :] \
        .reshape(-1, xp.shape[-1])


def _conv_3xtf32(x, w, chunk=16):
    """The conv in the kernel's order: per chunk of ``chunk`` input
    channels, 9 taps x k8 steps; each step issues lo_a hi_b, hi_a lo_b and
    hi_a hi_b (hi truncated, lo = x - hi truncated again as it is read),
    and each of these adds its 8 products to the tensor cores' accumulator
    as one sum truncated toward zero (modelled as the exact sum, then
    truncated); the chunk's first product overwrites it. After each chunk
    the accumulator is added to an f32 running sum, rounded to nearest.
    ``chunk=None`` keeps one accumulator over all of K instead."""
    n, h, wd, c = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    terms = []
    for t in range(9):
        a, b = _taps(xp, h, wd, t), w[t // 3, t % 3]
        ah, bh = _truncate_tf32(a), _truncate_tf32(b)
        al, bl = _truncate_tf32(a - ah), _truncate_tf32(b - bh)
        terms.append((((al, bh), (ah, bl), (ah, bh))))
    total = np.zeros((n * h * wd, w.shape[-1]), np.float32)
    chunk = chunk or c
    for c0 in range(0, c, chunk):
        acc = np.zeros(total.shape, np.float32)
        for t in range(9):
            for k in range(c0, min(c0 + chunk, c), 8):
                for a, b in terms[t]:
                    acc = _toward_zero(
                        acc.astype(np.float64)
                        + a[:, k:k + 8].astype(np.float64)
                        @ b[k:k + 8].astype(np.float64))
        total += acc
    return total.reshape(n, h, wd, -1)


def _conv_tf32(x, w):
    """The conv as 9 tap products of one TF32 product each (the operands
    rounded to TF32), summed in f32."""
    n, h, wd, _ = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros((n * h * wd, w.shape[-1]), np.float32)
    for t in range(9):
        out += np.matmul(_round_tf32(_taps(xp, h, wd, t)),
                         _round_tf32(w[t // 3, t % 3]))
    return out.reshape(n, h, wd, -1)


def _conv_operands(kind, shape, co, seed=5):
    """The kernel's operands for ``kind`` (x and w, or the cotangent and
    the flipped, channel-swapped w) and the JAX function's output, in
    interpret mode, at the JAX tests' scale (w * 0.1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, shape[-1], co)) * 0.1).astype(np.float32)
    if kind == "forward":
        return x, w, _np(jax_conv.conv3x3(_j(x), _j(w), interpret=True))
    g = rng.normal(size=shape[:3] + (co,)).astype(np.float32)
    want = jax_conv.conv3x3_input_grad(_j(g), _j(w), interpret=True)
    return g, np.flip(w, (0, 1)).swapaxes(2, 3), _np(want)


@pytest.mark.parametrize("kind", ["forward", "input_grad"])
@pytest.mark.parametrize("shape,co", [((2, 8, 8, 16), 16),
                                      ((3, 8, 8, 24), 40),  # ragged C, Co
                                      ((2, 32, 32, 64), 64)])
def test_conv3x3_3xtf32_arithmetic_matches_jax(kind, shape, co):
    """The f32 tensor-core kernel's 3xTF32 arithmetic, emulated in its
    order, against the JAX ``conv3x3`` / ``conv3x3_input_grad`` in
    interpret mode at the JAX package's f32 tolerance (1e-5,
    tests/test_pallas_conv.py), at its tests' shapes and scale, the
    deepest of them (2, 32, 32, 64) -> 64 included (four 16-channel
    chunks a tap); one TF32 product misses that tolerance."""
    inp, w_eff, want = _conv_operands(kind, shape, co)
    np.testing.assert_allclose(_conv_3xtf32(inp, w_eff), want, rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(_conv_tf32(inp, w_eff), want, rtol=1e-5,
                           atol=1e-5)


def test_conv3x3_3xtf32_chunked_sums_hold_at_resnet_depth():
    """At ResNet-18's deepest geometry (4x4, C = Co = 512, K = 4608) the
    kernel's per-chunk accumulator keeps the emulated conv within the
    tolerance the card tests hold the kernel to (1e-4,
    tests/test_torch_kernels.py) of the JAX conv, where one truncating
    accumulator over all of K drifts toward zero past it. The JAX
    package's own 1e-5 is held at its tests' depth, above: at this depth
    the chunks' truncated sums do not keep within it on every output."""
    inp, w_eff, want = _conv_operands("forward", (1, 4, 4, 512), 512)
    np.testing.assert_allclose(_conv_3xtf32(inp, w_eff), want, rtol=1e-4,
                               atol=1e-4)
    assert not np.allclose(_conv_3xtf32(inp, w_eff, chunk=None), want,
                           rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ backend --

def test_backend_routes_by_device_only():
    cpu = torch.zeros(2)
    assert _backend.use_kernel(cpu, cpu) is False
    with pytest.raises(ValueError, match="meta"):
        _backend.use_kernel(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        _backend.use_kernel(cpu, torch.zeros(2, device="meta"))


def test_build_targets_are_keyed_by_source(tmp_path, monkeypatch):
    """One library per csrc/*.cu, its name carrying a hash of the source
    and the flags; a changed source gives another library."""
    assert _build.sources() == ["conv3x3", "flash_attention", "quantize"]
    first = _build.target("conv3x3")
    assert first.parent == _build.BUILD and first.suffix == ".so"
    src = tmp_path / "conv3x3.cu"
    src.write_text((_build.CSRC / "conv3x3.cu").read_text() + "\n// edit\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.target("conv3x3") != first


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler -> a clear error, never a silent CPU path."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


# ---------------------------------------------------------- fused SGD --

SGD_CASES = [(0.0, False, 0.0), (5e-4, False, 0.0), (5e-4, True, 0.0),
             (5e-4, False, 0.1)]


def _sgd_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(130, 7)).astype(np.float32),
            "b": rng.normal(size=(11,)).astype(np.float32)}


@pytest.mark.parametrize("which", ["fused", "plain"])
@pytest.mark.parametrize("wd,nesterov,damp", SGD_CASES)
def test_sgd_matches_jax(which, wd, nesterov, damp):
    """3 steps of the port's FusedSGD (its plain version on the CPU) and
    of its functional SGD against the JAX FusedSGD (interpret mode) and
    the optax SGD, with weight decay, Nesterov and dampening."""
    kw = dict(momentum=0.9, dampening=damp, weight_decay=wd,
              nesterov=nesterov)
    p0 = _sgd_tree(0)
    if which == "fused":
        ref = jax_fused_sgd.FusedSGD(lr=0.05, interpret=True, **kw)
        opt = fused_sgd.FusedSGD(lr=0.05, **kw)
    else:
        ref = jax_sgd(lr=0.05, **kw)
        opt = SGD(lr=0.05, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = ref.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = opt.init(tp)
    rng = np.random.default_rng(1)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p0.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        if which == "fused":
            jp, js = ref.apply(jp, js, jg)
        else:
            upd, js = ref.update(jg, js, jp)
            jp = optax.apply_updates(jp, upd)
        ts = opt.apply(tp, ts, {k: torch.from_numpy(v) for k, v in g.items()})
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(ts.momentum[k].numpy(),
                                       np.asarray(js.momentum[k]),
                                       rtol=1e-6, atol=1e-6)
    assert ts.step == 3


def test_fused_sgd_keeps_params_as_views_of_one_buffer():
    """init lays the parameters into one flat buffer (the module note);
    apply updates in place and refuses parameters that moved."""
    params = {k: torch.from_numpy(v) for k, v in _sgd_tree(0).items()}
    opt = fused_sgd.FusedSGD(lr=0.1, momentum=0.0)
    state = opt.init(params)
    flat_p, flat_b = state.flat
    assert flat_p.numel() == 130 * 7 + 11 == flat_b.numel()
    assert params["b"].data_ptr() == flat_p.data_ptr() + 130 * 7 * 4
    # Momentum buffers exist at momentum 0, as in the JAX version.
    assert set(state.momentum) == {"w", "b"}
    before = params["w"].clone()
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    opt.apply(params, state, grads)
    torch.testing.assert_close(params["w"], before - 0.1)
    with pytest.raises(ValueError, match="FusedSGD.init"):
        opt.apply({k: v.clone() for k, v in params.items()}, state, grads)


def test_fused_sgd_update_checks_buffers():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="sizes"):
        fused_sgd.fused_sgd_update(p, torch.zeros(8), torch.zeros(7), 0.1,
                                   True, momentum=0.9, dampening=0.0,
                                   weight_decay=0.0, nesterov=False)
    with pytest.raises(ValueError, match="float32"):
        fused_sgd.fused_sgd_update(p.double(), p, p, 0.1, True,
                                   momentum=0.9, dampening=0.0,
                                   weight_decay=0.0, nesterov=False)


def test_nesterov_needs_momentum_and_no_dampening():
    for cls in (fused_sgd.FusedSGD, SGD):
        with pytest.raises(ValueError, match="Nesterov"):
            cls(0.1, momentum=0.0, nesterov=True)
        with pytest.raises(ValueError, match="Nesterov"):
            cls(0.1, momentum=0.9, dampening=0.1, nesterov=True)


# --------------------------------------------------------------- adam --

# (weight decay, AMSGrad, step schedule): the JAX package's three fused-Adam
# cases and one with an lr that steps down after 2 updates.
ADAM_CASES = [(0.0, False, False), (5e-4, False, False), (5e-4, True, False),
              (5e-4, False, True)]


@pytest.mark.parametrize("which", ["fused", "plain"])
@pytest.mark.parametrize("wd,amsgrad,scheduled", ADAM_CASES)
def test_adam_matches_jax(which, wd, amsgrad, scheduled):
    """4 steps of the port's FusedAdam (its plain version on the CPU) and
    of its functional Adam against the JAX FusedAdam (interpret mode) and
    the optax Adam: parameters and every moment at rtol 1e-6, atol 1e-7."""
    lr = (1e-2, jax_schedules.step_decay(1e-2, 2, 0.1),
          schedules.step_decay(1e-2, 2, 0.1)) if scheduled else (1e-2,) * 3
    kw = dict(weight_decay=wd, amsgrad=amsgrad)
    if which == "fused":
        ref = jax_fused_adam.FusedAdam(lr=lr[1], interpret=True, **kw)
        opt = fused_adam.FusedAdam(lr=lr[2], **kw)
    else:
        ref = jax_adam(lr=lr[1], **kw)
        opt = Adam(lr=lr[2], **kw)
    p0 = _sgd_tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = ref.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = opt.init(tp)
    rng = np.random.default_rng(1)
    fields = ("exp_avg", "exp_avg_sq") + (("max_exp_avg_sq",) if amsgrad
                                          else ())
    for _ in range(4):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p0.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        if which == "fused":
            jp, js = ref.apply(jp, js, jg)
        else:
            upd, js = ref.update(jg, js, jp)
            jp = optax.apply_updates(jp, upd)
        ts = opt.apply(tp, ts, {k: torch.from_numpy(v) for k, v in g.items()})
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            for field in fields:
                np.testing.assert_allclose(
                    getattr(ts, field)[k].numpy(),
                    np.asarray(getattr(js, field)[k]), rtol=1e-6, atol=1e-7)
    assert ts.step == 4 == int(js.step)
    if not amsgrad:
        assert ts.max_exp_avg_sq == ()


def test_adam_step_size_is_float32_like_jax():
    opt = Adam(1e-3)
    for t in (1, 2, 10, 1000):
        want = 1e-3 * jnp.sqrt(1 - 0.999 ** jnp.float32(t)) \
            / (1 - 0.9 ** jnp.float32(t))
        got = opt.step_size(opt.init({})._replace(step=t - 1))
        np.testing.assert_allclose(got, float(want), rtol=1e-7)


def test_fused_adam_keeps_params_and_moments_in_flat_buffers():
    params = {k: torch.from_numpy(v) for k, v in _sgd_tree(0).items()}
    opt = fused_adam.FusedAdam(lr=0.1, amsgrad=True)
    state = opt.init(params)
    flat_p, flat_m, flat_v, flat_vh = state.flat
    assert flat_p.numel() == 130 * 7 + 11 == flat_vh.numel()
    assert params["b"].data_ptr() == flat_p.data_ptr() + 130 * 7 * 4
    assert state.exp_avg["b"].data_ptr() == flat_m.data_ptr() + 130 * 7 * 4
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    before = fused_adam.fused_adam_update.launches
    state = opt.apply(params, state, grads)
    assert fused_adam.fused_adam_update.launches == before   # CPU: plain
    assert state.step == 1 and float(flat_m[0]) == pytest.approx(0.1)
    with pytest.raises(ValueError, match="FusedAdam.init"):
        opt.apply({k: v.clone() for k, v in params.items()}, state, grads)
    with pytest.raises(ValueError, match="sizes"):
        fused_adam.fused_adam_update(flat_p, flat_m, flat_v, flat_vh[:-1],
                                     flat_p, 0.1, b1=0.9, b2=0.999, eps=1e-8,
                                     weight_decay=0.0)


def test_importing_the_ops_needs_no_triton():
    """Triton is imported by the launching function only: the package
    imports where there is none."""
    code = ("import sys, ps_pytorch_tpu_torch.ops.fused_sgd, "
            "ps_pytorch_tpu_torch.ops.fused_adam, "
            "ps_pytorch_tpu_torch.ops.conv3x3; "
            "print('triton' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"
