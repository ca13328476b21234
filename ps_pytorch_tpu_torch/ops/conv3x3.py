"""3x3 stride-1 SAME convolution: the hand-written CUDA kernels of
``csrc/conv3x3.cu`` and their plain PyTorch version.

Replaces the JAX package's ``ops/pallas_conv.py:_conv_kernel`` and keeps its
public layout: ``conv3x3(x[N,H,W,C], w[3,3,C,Co])`` in NHWC/HWIO, f32
accumulation, one rounding into the input's type. The input gradient is
the same kernel on ``flip(w,(0,1)).swapaxes(2,3)``; the weight gradient is
9 tap contractions in torch ops, as ``pallas_conv.py:_conv_op_bwd`` leaves
it to XLA. ``Conv3x3Function`` ties the three together for autograd.

Bound on an H100 at batch 256: each ResNet-18 stride-1 3x3 is about 19.3
GFLOP, 0.020 ms a launch at 989 TFLOP/s in bf16 or f16 (0.51 ms for a
step's 26; the 32x32x64 one also moves about 67 MB, 0.020 ms at 3.35
TB/s); in f32 0.2885 ms at the 67 TFLOP/s of f32 FMA and 0.1171 ms as
3xTF32 on the tensor cores (three TF32 products at 495 TFLOP/s each).

Three kernels, picked by ``route`` before the launch:

- ``"tc"``: C and Co multiples of 8 and 16-byte aligned pointers (every
  ResNet or VGG stride-1 3x3 past a 3-channel input). An implicit GEMM on
  the tensor cores (M pixels, N = Co, K = 9C tap-major) through Hopper's
  ``wgmma``, f32 sums in registers: a block of BM pixels (TW = min(W, 64)
  columns x BM / TW rows of the batch stacked as one tall image) and BN
  channels copies each chunk of its halo and of the 9 weight slices into
  shared memory through a 2-stage ``cp.async`` ring; every tap's pixel
  fragments are ``ldmatrix`` loads from that one halo (a tap in the
  padding reads a row of zeros), and the tensor cores read the weights
  from shared memory. bf16 and f16 take one product a step, from a table
  by geometry (BM 128 or 256, BN 64 or 128, 32-channel chunks). f32 takes
  three TF32 products a step (3xTF32: each operand split into its top 19
  bits and the rest, ``lo_a hi_b + hi_a lo_b + hi_a hi_b``), which keeps
  the f32 tolerances; its tile is BM x 64 with 16-channel chunks, and it
  reads the weight K-major, ``[3,3,Co,C]``, the only layout TF32
  ``wgmma`` takes (``_launch`` lays it out; for the input gradient it is
  the flip alone). ``conv3x3.tc_launches`` counts these launches.
- ``"simt"``: every other shape (the CIFAR stem's C = 3, ragged channels,
  a view off 16 bytes): exact f32 FMA on the CUDA cores.

A launch that fails raises; it is never retried on the other kernel or on
the plain version. The source's header has the design in full.

``variant`` is accepted for the JAX signature: ``taps9`` and ``im2col`` are
two MXU schedules of the TPU kernel, and both run the same kernel here.
"""

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ps_pytorch_tpu_torch.ops import _build
from ps_pytorch_tpu_torch.ops._backend import use_kernel

VARIANTS = ("taps9", "im2col")


def _configure(lib: ctypes.CDLL) -> None:
    for fn in (lib.psk_conv3x3_f32, lib.psk_conv3x3_f32_simt,
               lib.psk_conv3x3_bf16, lib.psk_conv3x3_bf16_simt,
               lib.psk_conv3x3_f16, lib.psk_conv3x3_f16_simt):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _check(x: torch.Tensor, w: torch.Tensor, variant: str) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[-1]:
        raise ValueError(f"need x [N,H,W,C] and w [3,3,C,Co]; got "
                         f"{tuple(x.shape)} / {tuple(w.shape)}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if x.dtype != w.dtype:
        raise ValueError(f"x is {x.dtype} but w is {w.dtype}")


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: 9 shifted matmuls in f32 (the ``taps9``
    schedule), cast once to the input's type."""
    n, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    out = torch.zeros((n, h, wd, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            out += torch.matmul(xp[:, dy:dy + h, dx:dx + wd, :], wf[dy, dx])
    return out.to(x.dtype)


def route(dtype: torch.dtype, c: int, co: int, *pointers: int) -> str:
    """The kernel a CUDA call takes: ``"tc"`` (tensor cores) for f32, bf16
    or f16 with C and Co multiples of 8 and every pointer 16-byte aligned,
    else ``"simt"``."""
    if dtype in (torch.float32, torch.bfloat16, torch.float16) \
            and c % 8 == 0 and co % 8 == 0 \
            and all(p % 16 == 0 for p in pointers):
        return "tc"
    return "simt"


def _launch(x: torch.Tensor, w: torch.Tensor,
            kernel: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel ``route`` picks (``kernel`` names one, for timing
    the two side by side). ``w`` is [3,3,C,Co] in any strides: it is laid
    out as the kernel reads it, HWIO, or [3,3,Co,C] for the f32
    tensor-core kernel (no copy where ``w`` is a transposed view of that,
    as the input gradient's is), and ``route`` reads the pointer of that
    layout."""
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"conv3x3 kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3x3 kernel needs contiguous NHWC x")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    lib = _build.load("conv3x3", _configure)
    n, h, wd, c = x.shape
    co = w.shape[-1]
    out = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    if kernel != "simt":
        w_tc = (w.transpose(2, 3) if x.dtype == torch.float32 else w) \
            .contiguous()
        kernel = kernel or route(x.dtype, c, co, x.data_ptr(),
                                 w_tc.data_ptr(), out.data_ptr())
    w = w_tc if kernel == "tc" else w.contiguous()
    fn = {(torch.float32, "simt"): lib.psk_conv3x3_f32_simt,
          (torch.float32, "tc"): lib.psk_conv3x3_f32,
          (torch.bfloat16, "simt"): lib.psk_conv3x3_bf16_simt,
          (torch.bfloat16, "tc"): lib.psk_conv3x3_bf16,
          (torch.float16, "simt"): lib.psk_conv3x3_f16_simt,
          (torch.float16, "tc"): lib.psk_conv3x3_f16}.get((x.dtype, kernel))
    if fn is None:
        raise ValueError(f"no {kernel!r} conv3x3 kernel for {x.dtype}")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, c, co,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 {kernel} kernel launch failed: CUDA "
                           f"error {err}")
    conv3x3.launches += 1
    if kernel == "tc":
        conv3x3.tc_launches += 1
    return out


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            variant: str = "taps9") -> torch.Tensor:
    """NHWC 3x3 stride-1 SAME conv: x [N,H,W,C] @ w [3,3,C,Co] ->
    [N,H,W,Co]. CUDA tensors run the kernel, CPU tensors the plain
    version. ``conv3x3.launches`` counts kernel launches,
    ``conv3x3.tc_launches`` those of the tensor-core kernel."""
    _check(x, w, variant)
    if use_kernel(x, w):
        return _launch(x, w)
    return conv3x3_reference(x, w)


conv3x3.launches = 0
conv3x3.tc_launches = 0


def conv3x3_input_grad(g: torch.Tensor, w: torch.Tensor,
                       variant: str = "taps9") -> torch.Tensor:
    """Gradient w.r.t. the conv input: a 3x3 SAME conv of the cotangent
    with spatially flipped, channel-transposed weights."""
    return conv3x3(g, torch.flip(w, (0, 1)).transpose(2, 3), variant)


def conv3x3_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW[dy,dx,c,co] = sum_{n,h,w} xpad[n,h+dy,w+dx,c] g[n,h,w,co]: 9 tap
    contractions in the inputs' type, accumulated in f32 by the matmul,
    as the JAX op's ``preferred_element_type=f32`` then cast."""
    n, h, wd, c = x.shape
    co = g.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    g2 = g.reshape(-1, co)
    taps = [torch.matmul(xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, c).t(),
                         g2)
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, c, co)


class Conv3x3Function(torch.autograd.Function):
    """Differentiable conv3x3: kernel forward, kernel input gradient,
    torch-op weight gradient (``pallas_conv.py:conv3x3_op``)."""

    @staticmethod
    def forward(ctx, x, w, variant="taps9"):
        ctx.save_for_backward(x, w)
        ctx.variant = variant
        return conv3x3(x, w, variant)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_input_grad(g, w, ctx.variant)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_weight_grad(x, g)
        return dx, dw, None
