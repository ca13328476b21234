"""Int8 block quantization with stochastic rounding: the hand-written CUDA
kernel ``csrc/quantize.cu`` and its plain PyTorch version.

Replaces the JAX package's ``ops/quantize.py`` (``_quant_kernel`` behind
``_quantize_padded`` and ``quantize_int8``) and keeps its names and its wire
form: before a gradient crosses a slow boundary (the hop between slices of
the asynchronous trainer) it is shrunk 4x on the device. A leaf of any
shape is flattened, cast to f32 and zero-padded to a multiple of
``BLOCK`` = 32 x 128 = 4096 elements; every block gets one f32 scale
``max(max|x| * (1/127), 1e-30)`` and its elements become
``clip(floor(x / scale + u), -127, 127)`` in int8, with ``u`` uniform noise
in [0, 1). Stochastic rounding keeps the quantizer unbiased
(``E[q * scale] = x``), which is what averaging gradients needs. ``values``
keep the padded ``[R, 128]`` shape and ``scales`` ``[R / 32, 1]``, so
``quantized_nbytes`` is the reference's wire size.

The noise is an input, as in the reference: the caller passes it, or a
``torch.Generator`` on the tensor's device to draw it from. The scale is a
multiply by the f32 constant 1/127, which is what XLA makes of
``amax / 127.0`` under ``jit``: with it the plain version is bitwise the
reference (values and scales) on the same ``x`` and noise, and the kernel
is bitwise its plain version.

Bound on an H100: bytes, 9 B an element (4 B ``x``, 4 B noise, 1 B out)
plus 4 B a block of scales; the design is in the source's header.
``dequantize_int8`` is a plain multiply in the reference too.
"""

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ps_pytorch_tpu_torch.ops import _build
from ps_pytorch_tpu_torch.ops._backend import use_kernel

LANES = 128
BLOCK_ROWS = 32
BLOCK = BLOCK_ROWS * LANES
# float32(1) / float32(127): the constant XLA multiplies by.
INV_127 = float(np.float32(1.0) / np.float32(127.0))
# The bucketed wire launches from several threads; the count must not lose
# an increment.
_count_lock = threading.Lock()


class QuantizedTensor(NamedTuple):
    values: torch.Tensor        # int8 [R, 128], R = ceil(size/BLOCK)*BLOCK_ROWS
    scales: torch.Tensor        # float32 [R / BLOCK_ROWS, 1]
    shape: Tuple[int, ...]      # original shape
    size: int                   # original element count


def padded_rows(size: int) -> int:
    """Rows of the padded ``[R, 128]`` form of ``size`` elements."""
    return -(-max(size, 1) // BLOCK) * BLOCK_ROWS


def pad_to_blocks(x: torch.Tensor) -> torch.Tensor:
    """Flatten, cast to f32 and zero-pad to whole blocks -> ``[R, 128]``."""
    flat = x.reshape(-1).float()
    rows = padded_rows(flat.numel())
    return torch.nn.functional.pad(
        flat, (0, rows * LANES - flat.numel())).reshape(rows, LANES)


def quantize_int8_reference(x2d: torch.Tensor, noise: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on the padded form: f32 ``x2d`` and ``noise``
    ``[R, 128]`` -> (int8 values ``[R, 128]``, f32 scales ``[R/32, 1]``)."""
    nblk = x2d.shape[0] // BLOCK_ROWS
    blocks = x2d.reshape(nblk, BLOCK)
    inv = torch.tensor(INV_127, dtype=torch.float32, device=x2d.device)
    scales = torch.clamp_min(blocks.abs().amax(dim=1) * inv, 1e-30)
    q = torch.floor(blocks / scales[:, None] + noise.reshape(nblk, BLOCK))
    values = q.clamp(-127, 127).to(torch.int8).reshape(x2d.shape)
    return values, scales.reshape(nblk, 1)


def _configure(lib: ctypes.CDLL) -> None:
    for fn in (lib.psk_quantize_f32, lib.psk_quantize_bf16):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _launch(x: torch.Tensor, noise: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a CUDA tensor of any shape; f32 and bf16 are read as
    they are, any other type is cast to f32 first. Launches on the current
    stream of ``x``'s device, from whatever thread calls."""
    if noise.device != x.device:
        raise ValueError(f"x on {x.device} but noise on {noise.device}")
    flat = x.reshape(-1)
    if flat.dtype not in (torch.float32, torch.bfloat16):
        flat = flat.float()
    flat = flat.contiguous()
    lib = _build.load("quantize", _configure)
    rows = noise.shape[0]
    nblk = rows // BLOCK_ROWS
    values = torch.empty((rows, LANES), dtype=torch.int8, device=x.device)
    scales = torch.empty((nblk, 1), dtype=torch.float32, device=x.device)
    fn = lib.psk_quantize_bf16 if flat.dtype == torch.bfloat16 \
        else lib.psk_quantize_f32
    with torch.cuda.device(x.device):
        err = fn(flat.data_ptr(), noise.data_ptr(), values.data_ptr(),
                 scales.data_ptr(), flat.numel(), nblk,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err}")
    with _count_lock:
        quantize_int8.launches += 1
    return values, scales


def quantize_int8(x: torch.Tensor, noise: Optional[torch.Tensor] = None, *,
                  generator: Optional[torch.Generator] = None
                  ) -> QuantizedTensor:
    """Float tensor (any shape) -> int8 values and one scale per 4096
    elements. ``noise`` is f32 ``[R, 128]`` (``R = padded_rows(size)``) on
    ``x``'s device; without it the noise is drawn from ``generator`` there.
    CUDA tensors run the kernel, CPU tensors the plain version.
    ``quantize_int8.launches`` counts kernel launches."""
    shape = tuple(x.shape)
    size = int(np.prod(shape)) if shape else 1
    if size < 1:
        raise ValueError(f"cannot quantize an empty tensor of shape {shape}")
    rows = padded_rows(size)
    if noise is None:
        noise = torch.rand((rows, LANES), dtype=torch.float32,
                           device=x.device, generator=generator)
    if tuple(noise.shape) != (rows, LANES) or noise.dtype != torch.float32 \
            or not noise.is_contiguous():
        raise ValueError(f"noise must be contiguous float32 [{rows}, "
                         f"{LANES}], got {noise.dtype} {tuple(noise.shape)}")
    if use_kernel(x, noise):
        values, scales = _launch(x, noise)
    else:
        values, scales = quantize_int8_reference(pad_to_blocks(x), noise)
    return QuantizedTensor(values=values, scales=scales, shape=shape,
                           size=size)


quantize_int8.launches = 0


def dequantize_int8(qt: QuantizedTensor) -> torch.Tensor:
    """The inverse: one multiply by the block's scale, in f32."""
    nblk = qt.scales.shape[0]
    flat = (qt.values.reshape(nblk, BLOCK).float() * qt.scales).reshape(-1)
    return flat[:qt.size].reshape(qt.shape)


def quantized_nbytes(qt: QuantizedTensor) -> int:
    """Wire size of the compressed form."""
    return qt.values.numel() * 1 + qt.scales.numel() * 4
