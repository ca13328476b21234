"""The port's hand-written kernels against their plain PyTorch versions, on
the card. Every test skips without a CUDA device: the kernels have no CPU
mode (their plain versions are held against the JAX package by
test_torch_ops.py).

This file imports neither JAX nor the JAX package, so it also runs on a
machine with the card and no JAX. From the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import pytest
import torch

from ps_pytorch_tpu_torch.ops import conv3x3 as conv
from ps_pytorch_tpu_torch.ops import flash_attention as fa
from ps_pytorch_tpu_torch.ops import fused_adam, fused_sgd
from ps_pytorch_tpu_torch.ops import quantize as tq
from ps_pytorch_tpu_torch.optim.adam import adam_step_size

# Kernel against plain version, both on the card: f32 sums in another
# order (1e-4), bf16 outputs rounded once from f32 (2e-2, about one ulp at
# outputs of 2-4), f16 likewise (5e-3, about 2.5 ulp at 2); the SGD and
# Adam updates are the same arithmetic (1e-6; Adam's atol 1e-7, the JAX
# package's own).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}
SGD_TOL = 1e-6
# The quantize kernel is its plain version bit for bit (values and scales).
# Flash kernels against their plain versions: the JAX package's own
# tolerances (forward 2e-5 and gradients 5e-4 in f32; bf16 outputs rounded
# once from f32, 2e-2); f16 1e-2 (p and ds rounded to f16 on the tiles).
FLASH_TOL = {torch.float32: (2e-5, 5e-4), torch.bfloat16: (2e-2, 2e-2),
             torch.float16: (1e-2, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _conv_inputs(dev, n, h, w, c, co, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, h, w, c, device=dev, generator=gen)
    wt = torch.randn(3, 3, c, co, device=dev, generator=gen) / (9 * c) ** 0.5
    return x.to(dtype), wt.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "input_grad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [
    (3, 8, 8, 16, 8),        # Co of 8, below one channel tile
    (2, 32, 32, 64, 64),     # ResNet-18's four stride-1 geometries
    (2, 16, 16, 128, 128),
    (2, 8, 8, 256, 256),
    (2, 4, 4, 512, 512),
    (4, 4, 4, 512, 512),
    (256, 32, 32, 64, 64),   # the first stage at the main path's batch
    (2, 5, 70, 24, 72),      # W above one 64-column tile, ragged C and Co
    (3, 5, 70, 24, 72),      # M not a multiple of the 128-pixel tile
    (5, 4, 4, 64, 64),       # 80 pixels: one ragged tile
    (2, 6, 6, 12, 16),       # C % 8 != 0: bf16 takes the SIMT kernel
    (4, 8192, 1, 8, 136),    # W = 1: the 256 x 128 tile would not fit
    (128, 128, 2, 16, 136),  # W = 2 on the 256 x 128 tile
    (33, 33, 31, 8, 56),     # ragged rows and columns on the 256 x 64 tile
    (2, 16, 16, 64, 128),    # VGG11's channel ladder (C != Co; the input
    (2, 8, 8, 128, 256),     # gradient runs Co -> C) down to its 2x2 stage
    (2, 4, 4, 256, 512),
    (3, 2, 2, 512, 512),
    (2, 56, 56, 64, 64),     # ResNet-50's stride-1 geometries at 224 px:
    (2, 28, 28, 128, 128),   # widths that leave part of the 256-pixel
    (3, 14, 14, 256, 256),   # tile's rows empty (TH * TW < BM)
    (5, 7, 7, 512, 512),
])
def test_conv3x3_kernel_matches_plain(cuda, shape, dtype, kind):
    """Forward and input gradient against the plain version; every type
    with C and Co multiples of 8 goes through the tensor cores (f32 as
    3xTF32), everything else through the SIMT kernel."""
    n, h, wd, c, co = shape
    x, w = _conv_inputs(cuda, *shape, dtype)
    fn, w_eff, c_out = conv.conv3x3, w, co
    if kind == "input_grad":        # x is the cotangent [N,H,W,Co]
        x = _conv_inputs(cuda, n, h, wd, co, c, dtype, seed=1)[0]
        fn, c_out = conv.conv3x3_input_grad, c
        w_eff = torch.flip(w, (0, 1)).transpose(2, 3).contiguous()
    before, tc_before = conv.conv3x3.launches, conv.conv3x3.tc_launches
    got = fn(x, w)
    assert conv.conv3x3.launches == before + 1
    tensor_cores = c % 8 == 0 and co % 8 == 0
    assert conv.conv3x3.tc_launches == tc_before + tensor_cores
    assert got.dtype == dtype and got.shape == (n, h, wd, c_out)
    want = conv.conv3x3_reference(x, w_eff)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
def test_conv3x3_function_grads_on_card_match_cpu(cuda):
    """Conv3x3Function on the card (kernel forward and input gradient)
    against the same function on the CPU (plain versions)."""
    x, w = _conv_inputs(cuda, 2, 16, 16, 32, 48, torch.float32, seed=1)
    g = torch.randn(2, 16, 16, 48, device=cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xi = x.detach().to(dev).requires_grad_(True)
        wi = w.detach().to(dev).requires_grad_(True)
        conv.Conv3x3Function.apply(xi, wi, "taps9").backward(g.to(dev))
        grads.append((xi.grad.cpu(), wi.grad.cpu()))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    x, w = _conv_inputs(cuda, 1, 4, 4, 8, 8, torch.float32)
    with pytest.raises(TypeError):
        conv.conv3x3(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        conv.conv3x3(x.transpose(1, 2), w)
    with pytest.raises(ValueError):
        conv.conv3x3(x, w.cpu())
    # A view one element (4 bytes in f32, 2 in bf16 and f16) off a 16-byte
    # boundary: route picks SIMT, which computes it, and the tensor-core
    # kernel, named, refuses it rather than running elsewhere.
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        xb, wb = x.to(dtype), w.to(dtype)
        odd = torch.empty(xb.numel() + 1, dtype=dtype, device=cuda)[1:]
        odd = odd.view(xb.shape).copy_(xb)
        assert conv.route(odd.dtype, 8, 8, odd.data_ptr(), wb.data_ptr()) \
            == "simt"
        tc_before = conv.conv3x3.tc_launches
        torch.testing.assert_close(conv.conv3x3(odd, wb).float(),
                                   conv.conv3x3_reference(odd, wb).float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        assert conv.conv3x3.tc_launches == tc_before
        with pytest.raises(RuntimeError, match="tc kernel launch failed"):
            conv._launch(odd, wb, "tc")
    # A weight view one element off 16 bytes: route reads the layout the
    # kernel gets, so f32 (whose tensor-core kernel reads a K-major copy)
    # takes the tensor cores and bf16 (which reads w as it is) takes SIMT.
    for dtype, tensor_cores in ((torch.float32, True),
                                (torch.bfloat16, False)):
        xb, wb = x.to(dtype), w.to(dtype)
        flat = torch.empty(wb.numel() + 1, dtype=dtype, device=cuda)
        odd_w = flat[1:].view(wb.shape).copy_(wb)
        assert odd_w.data_ptr() % 16 == odd_w.element_size()
        tc_before = conv.conv3x3.tc_launches
        torch.testing.assert_close(conv.conv3x3(xb, odd_w).float(),
                                   conv.conv3x3_reference(xb, wb).float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        assert conv.conv3x3.tc_launches == tc_before + tensor_cores


@pytest.mark.cuda
@pytest.mark.parametrize("wd,nesterov,damp", [
    (0.0, False, 0.0), (5e-4, False, 0.0), (5e-4, True, 0.0),
    (5e-4, False, 0.1)])
def test_fused_sgd_kernel_matches_plain(cuda, wd, nesterov, damp):
    kw = dict(momentum=0.9, dampening=damp, weight_decay=wd,
              nesterov=nesterov)
    gen = torch.Generator(device=cuda).manual_seed(1)
    p = torch.randn(100_003, device=cuda, generator=gen)
    b = torch.zeros_like(p)
    p_ref, b_ref = p.clone(), b.clone()
    before = fused_sgd.fused_sgd_update.launches
    for k in range(3):
        g = torch.randn(p.numel(), device=cuda, generator=gen)
        fused_sgd.fused_sgd_update(p, b, g, 0.05, k == 0, **kw)
        fused_sgd.fused_sgd_reference(p_ref, b_ref, g, 0.05, k == 0, **kw)
    assert fused_sgd.fused_sgd_update.launches == before + 3
    torch.testing.assert_close(p, p_ref, rtol=SGD_TOL, atol=SGD_TOL)
    torch.testing.assert_close(b, b_ref, rtol=SGD_TOL, atol=SGD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 100_003])
@pytest.mark.parametrize("wd,amsgrad", [(0.0, False), (5e-4, False),
                                        (5e-4, True)])
def test_fused_adam_kernel_matches_plain(cuda, n, wd, amsgrad):
    """3 steps on n elements: one, less than a block, and a ragged last
    block."""
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
    gen = torch.Generator(device=cuda).manual_seed(2)
    p = torch.randn(n, device=cuda, generator=gen)
    bufs = [torch.zeros_like(p) for _ in range(3 if amsgrad else 2)]
    ref = [p.clone()] + [b.clone() for b in bufs]
    before = fused_adam.fused_adam_update.launches
    for t in range(1, 4):
        g = torch.randn(n, device=cuda, generator=gen)
        ss = adam_step_size(1e-3, 0.9, 0.999, t)
        fused_adam.fused_adam_update(p, *bufs[:2], bufs[2] if amsgrad
                                     else None, g, ss, **kw)
        fused_adam.fused_adam_reference(ref[0], *ref[1:3], ref[3] if amsgrad
                                        else None, g, ss, **kw)
    assert fused_adam.fused_adam_update.launches == before + 3
    for got, want in zip([p] + bufs, ref):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 3])
def test_fused_kernels_on_the_sharded_updates_slices(cuda, world):
    """Each rank's 1-D slice of a padded flat buffer, as the ZeRO-1 step
    updates it in place (slices of 4 * chunk bytes at offsets that are not
    all 16-byte multiples): both kernels match their plain versions and
    leave the padded tail zero. As in the step (``parallel/zero.py``), the
    gradient and the momentum are zero past the tree's n elements."""
    n = 100_003
    chunk = -(-n // world)
    gen = torch.Generator(device=cuda).manual_seed(world)
    flat = torch.zeros(chunk * world, device=cuda)
    flat[:n] = torch.randn(n, device=cuda, generator=gen)
    for rank in range(world):
        p = flat[rank * chunk:(rank + 1) * chunk]
        g = torch.randn(chunk, device=cuda, generator=gen)
        b = torch.randn(chunk, device=cuda, generator=gen)
        tail = max(n - rank * chunk, 0)     # the slice's padding from here
        g[tail:], b[tail:] = 0.0, 0.0
        p_ref, b_ref = p.clone(), b.clone()
        fused_sgd.fused_sgd_update(p, b, g, 0.05, False, momentum=0.9,
                                   dampening=0.0, weight_decay=5e-4,
                                   nesterov=False)
        fused_sgd.fused_sgd_reference(p_ref, b_ref, g, 0.05, False, 0.9, 0.0,
                                      5e-4, False)
        torch.testing.assert_close(p, p_ref, rtol=SGD_TOL, atol=SGD_TOL)
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        ref = [p.clone(), m.clone(), v.clone()]
        ss = adam_step_size(1e-3, 0.9, 0.999, 1)
        kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
        fused_adam.fused_adam_update(p, m, v, None, g, ss, **kw)
        fused_adam.fused_adam_reference(*ref, None, g, ss, **kw)
        for got, want in zip((p, m, v), ref):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert not flat[n:].any()


def _flash_inputs(dev, bh, s, d, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(bh, s, d, device=dev, generator=gen).to(dtype)
            for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,d", [
    (4, 128, 16),        # the CPU tests' head dim, two whole tiles
    (3, 256, 64),        # the LM's head dim
    (2, 200, 64),        # S not a multiple of the 64-row tile
    (2, 72, 40),         # ragged S and a head dim that is not a power of 2
    (2, 200, 128),       # the widest head dim: 32-query tiles in dk/dv
    (1, 96, 72),         # a head dim padded to 128, its depth to 72 / 80
])
def test_flash_kernels_match_plain(cuda, bh, s, d, causal, dtype):
    q, k, v, do = _flash_inputs(cuda, bh, s, d, dtype)
    scale = d ** -0.5
    fwd_tol, grad_tol = FLASH_TOL[dtype]
    before = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    tc_before = (fa.flash_fwd.tc_launches, fa.flash_dq.tc_launches,
                 fa.flash_dkv.tc_launches)
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.shape == (bh, s, 1)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=fwd_tol,
                               atol=fwd_tol)
    torch.testing.assert_close(lse, lse_ref, rtol=2e-5, atol=2e-5)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal, scale)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal, scale)
    want = (fa.flash_dq_reference(q, k, v, do, lse_ref, delta, causal, scale),
            *fa.flash_dkv_reference(q, k, v, do, lse_ref, delta, causal,
                                    scale))
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), ref.float(), rtol=grad_tol,
                                   atol=grad_tol)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 1 for n in before)
    # The forward, dq and dk/dv took the tensor-core kernels.
    assert (fa.flash_fwd.tc_launches, fa.flash_dq.tc_launches,
            fa.flash_dkv.tc_launches) == tuple(n + 1 for n in tc_before)


@pytest.mark.cuda
def test_flash_backward_takes_views_off_16_byte_boundaries(cuda):
    """The tensor-core kernels (the forward too) copy 16-byte rows: an
    input that starts 4 bytes into its storage is copied once by the
    wrapper, and the result is the plain version's."""
    bh, s, d = 2, 96, 32
    flat = [torch.randn(bh * s * d + 1, device=cuda) for _ in range(4)]
    q, k, v, do = (t[1:].view(bh, s, d) for t in flat)
    assert q.data_ptr() % 16 != 0
    o, lse = fa.flash_attention_reference(q, k, v, True, d ** -0.5)
    for got, ref in zip(fa.flash_fwd(q, k, v, True, d ** -0.5), (o, lse)):
        torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)
    delta = (do * o).sum(-1, keepdim=True)
    args = (q, k, v, do, lse, delta, True, d ** -0.5)
    torch.testing.assert_close(fa.flash_dq(*args),
                               fa.flash_dq_reference(*args),
                               rtol=5e-4, atol=5e-4)
    for got, ref in zip(fa.flash_dkv(*args), fa.flash_dkv_reference(*args)):
        torch.testing.assert_close(got, ref, rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
def test_flash_attention_grads_on_card_match_cpu(cuda):
    """flash_attention through autograd on the card (three kernels) against
    the same call on the CPU (plain versions)."""
    q, k, v, g = (t.reshape(2, 2, 192, 32)
                  for t in _flash_inputs(cuda, 4, 192, 32, torch.float32, 3))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        qi, ki, vi = (t.detach().to(dev).requires_grad_(True)
                      for t in (q, k, v))
        o = fa.flash_attention(qi, ki, vi, causal=True)
        o.backward(g.to(dev))
        outs.append([t.detach().cpu() for t in (o, qi.grad, ki.grad,
                                                vi.grad)])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
def test_flash_wrappers_raise_on_what_they_do_not_take(cuda):
    q, k, v, _ = _flash_inputs(cuda, 2, 64, 16, torch.float32)
    with pytest.raises(TypeError):
        fa.flash_fwd(q.double(), k.double(), v.double(), True, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(0, 1), k.transpose(0, 1),
                     v.transpose(0, 1), True, 0.25)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k.cpu(), v, True, 0.25)
    wide = torch.zeros(1, 8, 136, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(wide, wide, wide, True, 0.1)


def _quantize_both(x, seed=0):
    gen = torch.Generator(device=x.device).manual_seed(seed)
    noise = torch.rand((tq.padded_rows(x.numel()), tq.LANES), device=x.device,
                       generator=gen)
    qt = tq.quantize_int8(x, noise)
    values, scales = tq.quantize_int8_reference(tq.pad_to_blocks(x), noise)
    torch.cuda.synchronize()
    return qt, values, scales


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 10, 4095, 4096, 4097, 100_003, 2_359_296])
def test_quantize_kernel_is_bitwise_its_plain_version(cuda, n, dtype):
    """One element, a bias, around one block, a ragged size and ResNet-18's
    largest leaf: int8 values and f32 scales bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = (torch.randn(n, device=cuda, generator=gen) * 0.03).to(dtype)
    before = tq.quantize_int8.launches
    qt, values, scales = _quantize_both(x)
    assert tq.quantize_int8.launches == before + 1
    assert qt.values.dtype == torch.int8 and qt.shape == (n,)
    assert tuple(qt.values.shape) == (tq.padded_rows(n), tq.LANES)
    assert torch.equal(qt.values, values)
    assert torch.equal(qt.scales, scales)
    back = tq.dequantize_int8(qt)
    quantum = qt.scales.repeat_interleave(tq.BLOCK)[:n]
    assert bool(((back - x.float()).abs() <= quantum * (1 + 1e-6)).all())


@pytest.mark.cuda
def test_quantize_kernel_edge_blocks_and_views(cuda):
    """An all-zero block (scale 1e-30, zeros), a block with one huge
    value, subnormal inputs, a 0-d leaf, and a view at an address that is
    not 16-byte aligned (the scalar load path)."""
    x = torch.randn(3 * tq.BLOCK + 5, device=cuda) * 1e-3
    x[:tq.BLOCK] = 0.0
    x[tq.BLOCK + 17] = 3e38
    x[2 * tq.BLOCK:2 * tq.BLOCK + 100] = 1e-42
    cases = [x, torch.tensor(2.5, device=cuda), x[1:], x[3:4100].bfloat16()[1:],
             x.reshape(-1, 1)[:, 0], x[::2]]
    for leaf in cases:
        qt, values, scales = _quantize_both(leaf, seed=1)
        assert torch.equal(qt.values, values)
        assert torch.equal(qt.scales, scales)
    qt, _, _ = _quantize_both(x)
    assert 0.0 < float(qt.scales[0]) < 1.1e-30
    assert not qt.values[:tq.BLOCK_ROWS].any()
    assert int(qt.values.reshape(-1)[tq.BLOCK + 17]) == 127


@pytest.mark.cuda
def test_quantize_kernel_from_worker_threads_and_raises(cuda):
    """Launches from pool threads (the bucketed wire) give the main
    thread's result; a CPU noise tensor for a CUDA leaf raises."""
    from concurrent.futures import ThreadPoolExecutor
    leaves = [torch.randn(n, device=cuda) for n in (10, 5000, 70_000, 3)]
    want = [_quantize_both(l, seed=i)[0] for i, l in enumerate(leaves)]
    before = tq.quantize_int8.launches
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda a: _quantize_both(a[1], seed=a[0])[0],
                            enumerate(leaves)))
    assert tq.quantize_int8.launches == before + len(leaves)
    for a, b in zip(got, want):
        assert torch.equal(a.values, b.values)
        assert torch.equal(a.scales, b.scales)
    with pytest.raises(ValueError):
        tq.quantize_int8(leaves[0], torch.rand(32, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("injected", [False, True])
def test_quantize_tree_kernel_is_bitwise_its_plain_version(cuda, injected):
    """A tree of f32, bf16 and cast leaves, a 0-d one, an all-zero one and
    a view off its alignment, in ONE launch: values and scales bitwise the
    plain version's, with the noise drawn in the kernel (Philox) and with
    the caller's noise."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    big = torch.randn(3 * tq.BLOCK + 5, device=cuda, generator=gen) * 1e-3
    big[tq.BLOCK + 17] = 3e38
    leaves = [torch.randn(n, device=cuda, generator=gen) * 0.03
              for n in (1, 10, 4095, 4096, 4097, 100_003)]
    leaves += [big, big[1:], torch.zeros(3, 5000, device=cuda),
               torch.tensor(2.5, device=cuda),
               (torch.randn(70, 3, device=cuda, generator=gen)).bfloat16(),
               torch.randn(33, device=cuda, generator=gen).double()]
    noise = [torch.rand((tq.padded_rows(x.numel()), tq.LANES), device=cuda,
                        generator=gen) for x in leaves] if injected else None
    before = tq.quantize_int8.launches
    got = tq.quantize_tree(leaves, (3, 41), noise)
    assert tq.quantize_int8.launches == before + 1
    want = tq.quantize_tree_reference(leaves, (3, 41), noise)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.values, b.values)
        assert torch.equal(a.scales, b.scales)
        assert (a.shape, a.size) == (b.shape, b.size)
    # The card draws the CPU's noise.
    cpu = tq.quantize_tree([x.cpu() for x in leaves], (3, 41),
                           None if noise is None else [u.cpu() for u in noise])
    for a, b in zip(got, cpu):
        assert torch.equal(a.values.cpu(), b.values)
        assert torch.equal(a.scales.cpu(), b.scales)
