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

``quantize_tree`` quantizes a whole gradient tree in one launch: one int8
values buffer and one f32 scales buffer for all its blocks, each leaf's
``QuantizedTensor`` holding its own rows of both. The noise is either the
caller's, one f32 ``[R, 128]`` tensor a leaf, as the reference takes it, or
drawn inside the kernel by Philox4x32-10 from a key (the aggregator's
slice id and step) and a counter (the element's group of four, the leaf's
index in the tree): ``u = (bits >> 8) * 2^-24``. ``philox_uniform`` is the
plain version of those draws, in int64 tensor ops whose partial products
stay below 2^49, so the CPU and the card draw the same noise.
``quantize_int8`` (one leaf, the reference's function) goes through the
same kernel; without noise it draws ``torch.rand`` from ``generator``.

The scale is a multiply by the f32 constant 1/127, which is what XLA makes
of ``amax / 127.0`` under ``jit``: with it the plain version is bitwise the
reference (values and scales) on the same ``x`` and noise, and the kernel
is bitwise its plain version.

Bound on an H100: bytes, 5 B an element with the noise drawn in the kernel
(4 B ``x``, 1 B out) plus 4 B a block of scales, 9 B with the caller's
noise; the design is in the source's header. ``dequantize_int8`` is a
plain multiply in the reference too.
"""

import ctypes
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ps_pytorch_tpu_torch.ops import _build
from ps_pytorch_tpu_torch.ops._backend import use_kernel

LANES = 128
BLOCK_ROWS = 32
BLOCK = BLOCK_ROWS * LANES
# float32(1) / float32(127): the constant XLA multiplies by.
INV_127 = float(np.float32(1.0) / np.float32(127.0))
# Launches may come from several threads; the count must not lose an
# increment.
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


# Philox4x32-10 (Salmon et al., SC 2011): multipliers and key increments.
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product of the constant ``a``
    and the 32-bit words in int64 ``b``: b is split into 16-bit halves, so
    no partial product reaches 2^49 and int64 never overflows."""
    p_lo = a * (b & 0xFFFF)
    mid = (p_lo >> 16) + a * (b >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32(counter, key: Tuple[int, int]) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 over int64 tensors of 32-bit words: ``counter`` four
    tensors (c0, c1, c2, c3), ``key`` two ints; returns the four output
    words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _U32, key[1] & _U32
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & _U32, (k1 + PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniform(key: Tuple[int, int], index: int, n: int,
                   device=None) -> torch.Tensor:
    """The kernel's noise for elements [0, n) of leaf ``index``: f32 in
    [0, 1); element e takes word e % 4 of the counter (e // 4, index, 0,
    0)."""
    c0 = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    zero = torch.zeros_like(c0)
    words = philox4x32((c0, zero + (index & _U32), zero, zero), key)
    bits = torch.stack(words, dim=1).reshape(-1)[:n]
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def _leaf_size(x: torch.Tensor) -> int:
    size = x.numel()                    # 1 for a 0-d tensor
    if size < 1:
        raise ValueError(f"cannot quantize an empty tensor of shape "
                         f"{tuple(x.shape)}")
    return size


def _check_noise(u: torch.Tensor, rows: int) -> None:
    if tuple(u.shape) != (rows, LANES) or u.dtype != torch.float32 \
            or not u.is_contiguous():
        raise ValueError(f"noise must be contiguous float32 [{rows}, "
                         f"{LANES}], got {u.dtype} {tuple(u.shape)}")


def quantize_tree_reference(leaves: Sequence[torch.Tensor],
                            key: Tuple[int, int] = (0, 0),
                            noise: Optional[Sequence[torch.Tensor]] = None
                            ) -> List[QuantizedTensor]:
    """The plain version of ``quantize_tree``, leaf by leaf on the leaves'
    device: the noise of leaf i is ``noise[i]``, or
    ``philox_uniform(key, i, ...)``."""
    out = []
    for i, x in enumerate(leaves):
        size, rows = _leaf_size(x), padded_rows(x.numel())
        u = noise[i] if noise is not None else philox_uniform(
            key, i, rows * LANES, x.device).reshape(rows, LANES)
        values, scales = quantize_int8_reference(pad_to_blocks(x), u)
        out.append(QuantizedTensor(values, scales, tuple(x.shape), size))
    return out


def _configure(lib: ctypes.CDLL) -> None:
    lib.psk_quantize_tree.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    lib.psk_quantize_tree.restype = ctypes.c_int


class _Plan(NamedTuple):
    """One launch over a tree: the leaf table and block-to-leaf map on the
    card, and what keeps the addresses in it alive."""
    table: torch.Tensor         # int64 [6 L + blocks]
    blocks: List[int]           # blocks of each leaf
    shapes: List[Tuple[int, ...]]
    sizes: List[int]
    keep: list                  # flattened or cast leaves, and noise


def _plan(leaves: Sequence[torch.Tensor],
          noise: Optional[Sequence[torch.Tensor]]) -> _Plan:
    """The table of csrc/quantize.cu (six int64 words a leaf: address,
    count, noise address or 0, first block, index, bf16) and its block map,
    built on the host and copied to the leaves' device in one transfer
    from pinned memory, which does not wait for the stream. f32 and bf16
    leaves are read as they are; any other type is cast to f32 first."""
    device = leaves[0].device
    flats = []
    for x in leaves:
        if x.device != device:
            raise ValueError(f"one launch takes leaves on one device, got "
                             f"{device} and {x.device}")
        flat = x.reshape(-1)
        if flat.dtype not in (torch.float32, torch.bfloat16):
            flat = flat.float()
        flats.append(flat.contiguous())
    if noise is not None:               # the kernel loads it 16 B at a time
        noise = [u if u.data_ptr() % 16 == 0 else u.clone() for u in noise]
    sizes = [f.numel() for f in flats]
    blocks = [-(-n // BLOCK) for n in sizes]
    table = np.zeros((len(flats), 6), np.int64)
    table[:, 0] = [f.data_ptr() for f in flats]
    table[:, 1] = sizes
    if noise is not None:
        table[:, 2] = [u.data_ptr() for u in noise]
    table[1:, 3] = np.cumsum(blocks[:-1])
    table[:, 4] = np.arange(len(flats))
    table[:, 5] = [f.dtype == torch.bfloat16 for f in flats]
    host = np.concatenate([table.reshape(-1), np.repeat(table[:, 4], blocks)])
    on_card = torch.from_numpy(host).pin_memory().to(device,
                                                     non_blocking=True)
    return _Plan(on_card, blocks, [tuple(x.shape) for x in leaves], sizes,
                 flats + (noise or []))


def _launch(plan: _Plan, key: Tuple[int, int]) -> List[QuantizedTensor]:
    """One launch of the kernel on the current stream of the leaves'
    device, from whatever thread calls; raises if the launch fails."""
    device = plan.table.device
    nblk = sum(plan.blocks)
    values = torch.empty((nblk * BLOCK_ROWS, LANES), dtype=torch.int8,
                         device=device)
    scales = torch.empty((nblk, 1), dtype=torch.float32, device=device)
    lib = _build.load("quantize", _configure)
    with torch.cuda.device(device):
        err = lib.psk_quantize_tree(
            plan.table.data_ptr(), len(plan.blocks), values.data_ptr(),
            scales.data_ptr(), nblk, key[0] & _U32, key[1] & _U32,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err}")
    with _count_lock:
        quantize_int8.launches += 1
    return [QuantizedTensor(*parts) for parts in zip(
        values.split([b * BLOCK_ROWS for b in plan.blocks]),
        scales.split(plan.blocks), plan.shapes, plan.sizes)]


def quantize_tree(leaves: Sequence[torch.Tensor],
                  key: Tuple[int, int] = (0, 0),
                  noise: Optional[Sequence[torch.Tensor]] = None
                  ) -> List[QuantizedTensor]:
    """Every leaf (float tensors of any shape, on one device) to int8 values
    and one scale per 4096 elements. ``noise``: one contiguous f32
    ``[padded_rows(size), 128]`` tensor a leaf, on the leaves' device;
    without it the noise of leaf i is Philox's under ``key`` and index i.
    CUDA tensors run the kernel, all leaves in one launch
    (``quantize_int8.launches`` counts it); CPU tensors the plain
    version."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("quantize_tree needs at least one leaf")
    for x in leaves:
        _leaf_size(x)
    if noise is not None:
        noise = list(noise)
        if len(noise) != len(leaves):
            raise ValueError(f"{len(noise)} noise tensors for {len(leaves)} "
                             "leaves")
        for x, u in zip(leaves, noise):
            _check_noise(u, padded_rows(x.numel()))
    if use_kernel(*leaves, *(noise or ())):
        return _launch(_plan(leaves, noise), key)
    return quantize_tree_reference(leaves, key, noise)


def quantize_int8(x: torch.Tensor, noise: Optional[torch.Tensor] = None, *,
                  generator: Optional[torch.Generator] = None
                  ) -> QuantizedTensor:
    """One float tensor (any shape) -> int8 values and one scale per 4096
    elements, through ``quantize_tree``. ``noise`` is f32 ``[R, 128]``
    (``R = padded_rows(size)``) on ``x``'s device; without it the noise is
    drawn from ``generator`` there. ``quantize_int8.launches`` counts the
    kernel's launches, whichever function made them."""
    rows = padded_rows(_leaf_size(x))
    if noise is None:
        noise = torch.rand((rows, LANES), dtype=torch.float32,
                           device=x.device, generator=generator)
    return quantize_tree([x], noise=[noise])[0]


quantize_int8.launches = 0


def dequantize_int8(qt: QuantizedTensor) -> torch.Tensor:
    """The inverse: one multiply by the block's scale, in f32."""
    nblk = qt.scales.shape[0]
    flat = (qt.values.reshape(nblk, BLOCK).float() * qt.scales).reshape(-1)
    return flat[:qt.size].reshape(qt.shape)


def quantized_nbytes(qt: QuantizedTensor) -> int:
    """Wire size of the compressed form."""
    return qt.values.numel() * 1 + qt.scales.numel() * 4
