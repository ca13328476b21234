"""The port's flash attention (ps_pytorch_tpu_torch/ops/flash_attention.py)
against the JAX package's, on the CPU.

The same numpy inputs go through the JAX ``flash_attention`` (Pallas
kernels in interpret mode) and ``full_attention``, and through the port's
``flash_attention``, which on CPU tensors runs the plain versions of its
three CUDA kernels through the autograd Function. Tolerances are the JAX
package's own (tests/test_flash_attention.py): forward 2e-5, gradients
5e-4, bf16 forward 2e-2. Each plain version is also held against the JAX
kernel call it replaces (``_fwd_call``, ``_bwd_call``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.parallel.ring import full_attention as jax_full
from ps_pytorch_tpu_torch.ops import flash_attention as fa
from ps_pytorch_tpu_torch.parallel.ring import full_attention
from test_torch_train import two_torch_threads  # noqa: F401

# The module, not the function the package's ops/__init__ exports by the
# same name.
jax_fa = importlib.import_module("ps_pytorch_tpu.ops.flash_attention")

FWD_TOL, GRAD_TOL, BF16_TOL = 2e-5, 5e-4, 2e-2


def _qkv(b=2, h=2, s=128, d=32, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(n)]


def _jax_flash(q, k, v, causal, bq=64, bkv=64):
    return jax_fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                  block_kv=bkv, interpret=True)


def _port(q, k, v, causal, dtype=torch.float32, **kw):
    return fa.flash_attention(*(torch.from_numpy(t).to(dtype)
                                for t in (q, k, v)), causal=causal, **kw)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("blocks", [(64, 64), (128, 64), (256, 256)])
def test_forward_matches_jax(causal, blocks):
    """Causal and full; even blocks, uneven blocks (partly masked diagonal
    tiles on the JAX side) and one block for the whole sequence."""
    q, k, v = _qkv()
    bq, bkv = blocks
    got = _port(q, k, v, causal, block_q=bq, block_kv=bkv).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(got, _jax_flash(jq, jk, jv, causal, bq, bkv),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got, jax_full(jq, jk, jv, causal=causal),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax(causal):
    q, k, v, w = _qkv(s=128, n=4, seed=1)

    def jax_loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v) * jnp.asarray(w))

    want = jax.grad(jax_loss(lambda q, k, v: _jax_flash(q, k, v, causal)),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    oracle = jax.grad(jax_loss(lambda q, k, v: jax_full(q, k, v,
                                                        causal=causal)),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    (fa.flash_attention(*ts, causal=causal) * torch.from_numpy(w)).sum() \
        .backward()
    for t, a, b, name in zip(ts, want, oracle, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), a, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")
        np.testing.assert_allclose(t.grad.numpy(), b, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name} full")


def test_bf16_forward_close():
    q, k, v = _qkv()
    got = _port(q, k, v, True, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want_bf16 = _jax_flash(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                           True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want_bf16, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(),
                               jax_full(*map(jnp.asarray, (q, k, v)),
                                        causal=True),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_versions_match_jax_kernel_calls(causal):
    """The three plain versions against the JAX calls of the three Pallas
    kernels (interpret mode), one [BH, S, D] slab at a time."""
    q, k, v, do = (t.reshape(4, 128, 32) for t in _qkv(n=4, seed=2))
    scale = 32 ** -0.5
    jo, jlse = jax_fa._fwd_call(*map(jnp.asarray, (q, k, v)), causal, scale,
                                64, 32, True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_reference(tq, tk, tv, causal, scale)
    np.testing.assert_allclose(o.numpy(), jo, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=FWD_TOL, atol=FWD_TOL)
    jdq, jdk, jdv = jax_fa._bwd_call(*map(jnp.asarray, (q, k, v)), jo, jlse,
                                     jnp.asarray(do), causal, scale, 64, 32,
                                     True)
    delta = (tdo * o).sum(-1, keepdim=True)
    dq = fa.flash_dq(tq, tk, tv, tdo, lse, delta, causal, scale)
    dk, dv = fa.flash_dkv(tq, tk, tv, tdo, lse, delta, causal, scale)
    for got, want, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


F16_TOL = 2e-3   # both sides sum in f32 and round once to f16


@pytest.mark.parametrize("causal", [False, True])
def test_f16_plain_versions_match_jax_kernel_calls(causal):
    """The three plain versions in f16 against the JAX calls of the three
    Pallas kernels in f16 (interpret mode): the same f16 inputs, the
    outputs in f16 on both sides; the backward of both from the JAX
    forward's o and lse."""
    q, k, v, do = (t.reshape(4, 128, 32).astype(np.float16)
                   for t in _qkv(n=4, seed=3))
    scale = 32 ** -0.5
    jo, jlse = jax_fa._fwd_call(*map(jnp.asarray, (q, k, v)), causal, scale,
                                64, 32, True)
    assert jo.dtype == jnp.float16
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_reference(tq, tk, tv, causal, scale)
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32),
                               rtol=F16_TOL, atol=F16_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=F16_TOL, atol=F16_TOL)
    jdq, jdk, jdv = jax_fa._bwd_call(*map(jnp.asarray, (q, k, v)), jo, jlse,
                                     jnp.asarray(do), causal, scale, 64, 32,
                                     True)
    to = torch.from_numpy(np.array(jo))
    tlse = torch.from_numpy(np.array(jlse))
    delta = (tdo.float() * to.float()).sum(-1, keepdim=True)
    dq = fa.flash_dq(tq, tk, tv, tdo, tlse, delta, causal, scale)
    dk, dv = fa.flash_dkv(tq, tk, tv, tdo, tlse, delta, causal, scale)
    for got, want, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        assert got.dtype == torch.float16 and want.dtype == jnp.float16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=F16_TOL, atol=F16_TOL, err_msg=name)


def test_f16_flash_attention_and_its_gradient_match_jax():
    """The op as a user calls it, ``flash_attention(q, k, v)`` on f16
    [1, 2, 128, 64]: f16 out and f16 gradients on both sides."""
    q, k, v, w = (t.astype(np.float16) for t in _qkv(b=1, h=2, s=128, d=64,
                                                     n=4, seed=4))
    want_o, vjp = jax.vjp(lambda a, b, c: _jax_flash(a, b, c, True),
                          *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(w))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention(*ts, causal=True)
    o.backward(torch.from_numpy(w))
    assert o.dtype == torch.float16
    np.testing.assert_allclose(o.detach().float().numpy(),
                               np.asarray(want_o, np.float32),
                               rtol=F16_TOL, atol=F16_TOL)
    for t, g, name in zip(ts, want, "qkv"):
        assert t.grad.dtype == torch.float16 and g.dtype == jnp.float16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(g, np.float32), rtol=F16_TOL,
                                   atol=F16_TOL, err_msg=f"d{name}")


def test_odd_seq_goes_to_full_attention():
    """S with no power-of-two block >= 8 takes full_attention, as in the
    JAX package; neither plain kernel version runs."""
    q, k, v = _qkv(s=36, d=64)
    before = fa.flash_fwd.launches
    got = _port(q, k, v, True).numpy()
    want = jax_fa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                  interpret=True)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(
        full_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
        .numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    assert fa.flash_fwd.launches == before


def test_pick_block_matches_jax():
    for s in list(range(1, 300)) + [1000, 1024, 2048, 4096, 8192]:
        for req in (8, 64, 128, 256):
            assert fa._pick_block(s, min(req, s)) == \
                jax_fa._pick_block(s, min(req, s)), (s, req)


def test_full_attention_matches_jax():
    q, k, v = _qkv(s=48)
    for causal in (False, True):
        np.testing.assert_allclose(
            full_attention(*map(torch.from_numpy, (q, k, v)),
                           causal=causal, scale=0.3).numpy(),
            jax_full(*map(jnp.asarray, (q, k, v)), causal=causal, scale=0.3),
            rtol=FWD_TOL, atol=FWD_TOL)


def test_cpu_wrappers_count_no_launches_and_check_shapes():
    q, k, v = (torch.from_numpy(t.reshape(4, 128, 32)) for t in _qkv())
    before = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    fa.flash_fwd(q, k, v, True, 0.2)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == before
    wide = torch.zeros(1, 8, 136)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(wide, wide, wide, True, 0.1)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q[..., :12], k[..., :12], v[..., :12], True, 0.1)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k[:2], v, True, 0.1)
    lse = torch.zeros(4, 128, 1)
    for bad in (torch.zeros(4, 128), torch.zeros(4, 64, 1),
                torch.zeros(4, 128, 1, dtype=torch.float64)):
        with pytest.raises(ValueError, match="lse and delta"):
            fa.flash_dq(q, k, v, q, bad, lse, True, 0.1)
        with pytest.raises(ValueError, match="lse and delta"):
            fa.flash_dkv(q, k, v, q, lse, bad, True, 0.1)


# -------------------------------------- the backward kernels' arithmetic --

def _tf32(x):
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does: 10 mantissa bits,
    to nearest, ties away from zero, on the float's bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def _truncate_tf32(x):
    """The top 19 bits of f32 x: what the tensor cores read of it."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """hi: x truncated to TF32; lo: the rest, truncated again as the tensor
    cores read it."""
    hi = _truncate_tf32(x)
    return hi, _truncate_tf32(x - hi)


def _mm_3xtf32(a, b):
    """a @ b as the f32 route of the dq and dk/dv kernels computes it on the
    tensor cores: both operands split into TF32 hi + lo, the products of
    TF32 values exact in f32, summed in f32 with the small terms first."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    acc = np.matmul(al, bh)
    acc += np.matmul(ah, bl)
    acc += np.matmul(ah, bh)
    return acc


def _mm_tf32(a, b):
    """One TF32 product of the operands rounded to TF32."""
    return np.matmul(_tf32(a), _tf32(b))


def _emulated_backward(mm, q, k, v, do, lse, delta, causal, scale):
    """dq, dk, dv through the five products of the tensor-core kernels,
    scaled as they scale: s = (q k^T) scale, dq = (ds k) scale,
    dk = (ds^T q) scale."""
    s = mm(q, k.transpose(0, 2, 1)) * np.float32(scale)
    if causal:
        n = s.shape[-1]
        s = np.where(np.arange(n)[None, :] > np.arange(n)[:, None],
                     np.float32(fa.NEG_INF), s)
    p = np.exp(s - lse).astype(np.float32)
    ds = p * (mm(do, v.transpose(0, 2, 1)) - delta)
    dq = mm(ds, k) * np.float32(scale)
    dk = mm(ds.transpose(0, 2, 1), q) * np.float32(scale)
    dv = mm(p.transpose(0, 2, 1), do)
    return dq, dk, dv


@pytest.mark.parametrize("bh,s,d,causal,block", [
    (4, 256, 64, True, 64),
    (2, 200, 40, False, 8),
])
def test_3xtf32_backward_matches_jax_and_one_tf32_product_does_not(
        bh, s, d, causal, block):
    """The f32 route's arithmetic (3xTF32) holds dq, dk and dv to the JAX
    ``_bwd_call`` (Pallas in interpret mode) at the reference's 5e-4; one
    TF32 product errs at least 10x more, which is why the kernels split."""
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal((bh, s, d)).astype(np.float32)
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = jax_fa._fwd_call(*map(jnp.asarray, (q, k, v)), causal, scale,
                              block, block, True)
    o, lse = np.asarray(o), np.asarray(lse)
    delta = (do * o).sum(-1, keepdims=True, dtype=np.float32)
    want = jax_fa._bwd_call(*map(jnp.asarray, (q, k, v, o, lse, do)), causal,
                            scale, block, block, True)
    three = _emulated_backward(_mm_3xtf32, q, k, v, do, lse, delta, causal,
                               scale)
    one = _emulated_backward(_mm_tf32, q, k, v, do, lse, delta, causal,
                             scale)
    exact = _emulated_backward(
        lambda a, b: np.matmul(a.astype(np.float64), b.astype(np.float64)),
        *(t.astype(np.float64) for t in (q, k, v, do, lse, delta)), causal,
        scale)
    for got, jax_out, ref, bad, name in zip(three, want, exact, one,
                                            ("dq", "dk", "dv")):
        np.testing.assert_allclose(got, jax_out, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)
        err3 = np.abs(got - ref).max()
        err1 = np.abs(bad - ref).max()
        assert err1 >= 10 * err3, (name, err1, err3)


# ----------------------------------------- the forward kernel's arithmetic --

def _emulated_forward(mm, q, k, v, causal, scale, tile=64):
    """o and lse as the forward kernel computes them: per 64-key tile the
    scores ``mm(q, k^T)`` times scale log2(e) (masked to -1e30), the running
    max m in log2 units, the running sum l and the accumulator rescaled by
    2^(m_old - m_new) before ``mm(p, v)`` is added; at the end o = acc times
    1 / max(l, 1e-30) and lse = m ln 2 + log(max(l, 1e-30))."""
    f32 = q.dtype
    bh, s, d = q.shape
    scale2 = f32.type(scale) * f32.type(1.4426950408889634)
    neg = f32.type(fa.NEG_INF)
    m = np.full((bh, s, 1), neg, f32)
    l = np.zeros((bh, s, 1), f32)
    acc = np.zeros((bh, s, d), f32)
    rows = np.arange(s)[:, None]
    for k0 in range(0, s, tile):
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        st = (mm(q, kt.transpose(0, 2, 1)) * scale2).astype(f32)
        if causal:
            cols = np.arange(k0, k0 + kt.shape[1])[None, :]
            st = np.where(cols > rows, neg, st)
        m_new = np.maximum(m, st.max(-1, keepdims=True))
        alpha = np.exp2(m - m_new)
        p = np.exp2(st - m_new)
        l = l * alpha + p.sum(-1, keepdims=True, dtype=f32)
        acc = (acc * alpha + mm(p, vt)).astype(f32)
        m = m_new
    lc = np.maximum(l, f32.type(1e-30))
    return acc * (1 / lc), m * f32.type(0.6931471805599453) + np.log(lc)


@pytest.mark.parametrize("bh,s,d,causal,block", [
    (4, 256, 64, True, 64),
    (2, 200, 40, False, 8),
])
def test_3xtf32_forward_matches_jax_and_one_tf32_product_does_not(
        bh, s, d, causal, block):
    """The forward kernel's f32 arithmetic (3xTF32 on q k^T and p v, the
    online softmax over 64-key tiles) holds o and lse to the JAX
    ``_fwd_call`` (Pallas in interpret mode) at the reference's 2e-5. One
    TF32 product misses 2e-5 and errs at least 10x more against f64, which
    is why the forward splits too."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32)
               for _ in range(3))
    scale = d ** -0.5
    jo, jlse = (np.asarray(t) for t in jax_fa._fwd_call(
        *map(jnp.asarray, (q, k, v)), causal, scale, block, block, True))
    three = _emulated_forward(_mm_3xtf32, q, k, v, causal, scale)
    one = _emulated_forward(_mm_tf32, q, k, v, causal, scale)
    exact = _emulated_forward(
        lambda a, b: np.matmul(a.astype(np.float64), b.astype(np.float64)),
        *(t.astype(np.float64) for t in (q, k, v)), causal, scale)
    misses = []
    for i, (want, name) in enumerate(((jo, "o"), (jlse, "lse"))):
        np.testing.assert_allclose(three[i], want, rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=name)
        misses.append(np.abs(one[i] - want).max())
        err3 = np.abs(three[i] - exact[i]).max()
        err1 = np.abs(one[i] - exact[i]).max()
        assert err1 >= 10 * err3, (name, err1, err3)
    # One TF32 product misses the reference's tolerance on o.
    assert misses[0] > FWD_TOL, misses


def test_every_flash_kernel_takes_the_tensor_cores():
    assert {name: fa.route(name) for name in ("fwd", "dq", "dkv")} == \
        {"fwd": "tc", "dq": "tc", "dkv": "tc"}
