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
