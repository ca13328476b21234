"""Flash attention: the hand-written CUDA kernels ``csrc/flash_attention.cu``
(forward, dq, dk/dv) and their plain PyTorch versions.

Replaces the JAX package's ``ops/flash_attention.py`` (``_fwd_kernel``,
``_dq_kernel``, ``_dkv_kernel``) and keeps its public function:
``flash_attention(q, k, v, *, causal, scale, block_q, block_kv)`` over
``[B, H, S, D]``, default scale ``D**-0.5``. ``FlashAttentionFunction`` ties
the kernels together for autograd as the JAX custom VJP does: the forward
saves ``(q, k, v, o, lse)``; the backward computes ``delta = rowsum(dO*O)``
in f32 with torch ops, then runs the dq kernel, then the dk/dv kernel.

``block_q`` / ``block_kv`` only choose the route, as in the JAX package:
when S has no power-of-two divisor of at least 8 (``_pick_block``), the call
goes to ``parallel/ring.py:full_attention``, which is the JAX package's own
semantics, not a device fallback. Every other S runs the kernels, whose
tile is 64 rows whatever the blocks say; a ragged last tile is masked.

``route`` names the kernel a launch takes, before the launch: all three
run on the tensor cores (``"tc"``) at every shape the wrappers take, f32 as
3xTF32 (each operand split into two TF32 parts, three products), bf16 and
f16 as one product of their type. The forward keeps its online softmax in registers and
feeds p to ``p v`` from the accumulator. ``flash_fwd.tc_launches``,
``flash_dq.tc_launches`` and ``flash_dkv.tc_launches`` count the
tensor-core launches. A launch that fails raises; nothing retries it on
another kernel or on the plain version.

Bound on an H100 at the LM's full width (``[8, 8, 2048, 64]`` f32, causal):
34.4, 51.5 and 68.7 GFLOP for forward, dq and dk/dv, 0.51, 0.77 and 1.03 ms
at the 67 TFLOP/s f32 peak; 0.21, 0.31 and 0.42 ms as 3xTF32 at 495
TFLOP/s (three TF32 products an f32 one). The kernels' design is in the
source's header.
"""

import ctypes
from typing import Optional, Tuple

import torch

from ps_pytorch_tpu_torch.ops import _build
from ps_pytorch_tpu_torch.ops._backend import use_kernel

NEG_INF = -1e30          # the finite mask value of the Pallas kernels
MAX_HEAD_DIM = 128
# The kernel of each launch: all three on the tensor cores.
ROUTES = {"fwd": "tc", "dq": "tc", "dkv": "tc"}


def _pick_block(s: int, requested: int) -> int:
    """Largest power-of-two block <= requested that divides ``s`` (min 8);
    0 when there is none (the caller goes to ``full_attention``)."""
    b = 1
    while b * 2 <= min(requested, s):
        b *= 2
    while b >= 8:
        if s % b == 0:
            return b
        b //= 2
    return 0


# ------------------------------------------------------ plain versions --

def _scores(q3, k3, causal: bool, scale: float) -> torch.Tensor:
    """Masked f32 scores ``(q*scale) k^T`` [BH, S, S], -1e30 above the
    diagonal when causal."""
    s = torch.matmul(q3.float() * scale, k3.float().transpose(1, 2))
    if causal:
        n = s.shape[-1]
        pos = torch.arange(n, device=s.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    return s


def flash_attention_reference(q3, k3, v3, causal: bool, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [BH,S,D] in the input type, lse [BH,S,1] f32): softmax over the
    masked scores, ``p`` cast to the value type for ``p v`` as the Pallas
    kernel does."""
    s = _scores(q3, k3, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v3.dtype).float(), v3.float()) / l
    return o.to(q3.dtype), m + torch.log(l)


def _p_ds(q3, k3, v3, do3, lse, delta, causal, scale):
    p = torch.exp(_scores(q3, k3, causal, scale) - lse)
    dp = torch.matmul(do3.float(), v3.float().transpose(1, 2))
    return p, p * (dp - delta)


def flash_dq_reference(q3, k3, v3, do3, lse, delta, causal: bool,
                       scale: float) -> torch.Tensor:
    """dq = (p (dO v^T - delta)) k * scale with p = exp(s - lse)."""
    _, ds = _p_ds(q3, k3, v3, do3, lse, delta, causal, scale)
    return (torch.matmul(ds, k3.float()) * scale).to(q3.dtype)


def flash_dkv_reference(q3, k3, v3, do3, lse, delta, causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk = ds^T (q*scale), dv = p^T dO."""
    p, ds = _p_ds(q3, k3, v3, do3, lse, delta, causal, scale)
    dk = torch.matmul(ds.transpose(1, 2), q3.float() * scale)
    dv = torch.matmul(p.transpose(1, 2), do3.float())
    return dk.to(k3.dtype), dv.to(v3.dtype)


# ------------------------------------------------------------ kernels --

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# The kernels' entry-point suffix by input type.
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}


def _configure(lib: ctypes.CDLL) -> None:
    # BH, S, D, causal, scale, stream
    tail = [_INT, _INT, _INT, _INT, ctypes.c_float, _PTR]
    for suffix in _SUFFIX.values():
        getattr(lib, f"psk_flash_fwd_{suffix}").argtypes = [_PTR] * 5 + tail
        getattr(lib, f"psk_flash_dq_{suffix}").argtypes = [_PTR] * 7 + tail
        getattr(lib, f"psk_flash_dkv_{suffix}").argtypes = [_PTR] * 8 + tail
        for name in ("fwd", "dq", "dkv"):
            getattr(lib, f"psk_flash_{name}_{suffix}").restype = ctypes.c_int


def _check(q3: torch.Tensor, *others: torch.Tensor, rows=()) -> None:
    """q3 and ``others`` [BH, S, D] of one type and shape; ``rows`` (lse,
    delta) [BH, S, 1] float32."""
    if q3.dim() != 3:
        raise ValueError(f"need [BH, S, D] tensors, got {tuple(q3.shape)}")
    d = q3.shape[-1]
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head dim {d}: the kernels take a multiple of 8 up "
                         f"to {MAX_HEAD_DIM}")
    for t in others:
        if t.shape != q3.shape or t.dtype != q3.dtype:
            raise ValueError(f"q is {q3.dtype}{tuple(q3.shape)} but another "
                             f"input is {t.dtype}{tuple(t.shape)}")
    for t in rows:
        if t.shape != q3.shape[:2] + (1,) or t.dtype != torch.float32:
            raise ValueError(f"lse and delta must be float32 "
                             f"{tuple(q3.shape[:2]) + (1,)}, got "
                             f"{t.dtype}{tuple(t.shape)}")


def route(name: str) -> str:
    """The kernel a CUDA call of ``flash_<name>`` launches: ``"tc"`` (the
    tensor cores) for the forward, dq and dk/dv alike."""
    return ROUTES[name]


def _launch(name: str, tensors, outs, causal: bool, scale: float) -> str:
    """Launch ``psk_flash_<name>`` on the current stream over contiguous
    device tensors; raises on any type, layout or launch error. Returns the
    route it took."""
    q3 = tensors[0]
    if q3.dtype not in _SUFFIX:
        raise TypeError(f"flash kernels take float32, bfloat16 or float16, "
                        f"got {q3.dtype}")
    if q3.shape[0] > 65535:
        raise ValueError(f"B*H = {q3.shape[0]} above the grid's 65535")
    for t in (*tensors, *outs):
        if not t.is_contiguous():
            raise ValueError("flash kernels need contiguous tensors")
        if t.device != q3.device:
            raise ValueError(f"tensors on {q3.device} and {t.device}")
    kernel = route(name)
    # The tensor-core kernels copy 16-byte rows with cp.async: a view that
    # starts off a 16-byte boundary is copied once (the outputs are the
    # wrapper's own allocations).
    tensors = [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]
    lib = _build.load("flash_attention", _configure)
    fn = getattr(lib, f"psk_flash_{name}_{_SUFFIX[q3.dtype]}")
    bh, s, d = q3.shape
    with torch.cuda.device(q3.device):
        err = fn(*(t.data_ptr() for t in (*tensors, *outs)), bh, s, d,
                 int(causal), float(scale),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash {name} {kernel} kernel launch failed: "
                           f"CUDA error {err}")
    return kernel


def flash_fwd(q3, k3, v3, causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward over [BH,S,D]: (o, lse [BH,S,1] f32). CUDA tensors run the
    tensor-core kernel (``flash_fwd.launches`` and
    ``flash_fwd.tc_launches`` count it), CPU tensors the plain version."""
    _check(q3, k3, v3)
    if not use_kernel(q3, k3, v3):
        return flash_attention_reference(q3, k3, v3, causal, scale)
    o = torch.empty_like(q3)
    lse = torch.empty(q3.shape[:2] + (1,), dtype=torch.float32,
                      device=q3.device)
    if _launch("fwd", (q3, k3, v3), (o, lse), causal, scale) == "tc":
        flash_fwd.tc_launches += 1
    flash_fwd.launches += 1
    return o, lse


def flash_dq(q3, k3, v3, do3, lse, delta, causal: bool, scale: float
             ) -> torch.Tensor:
    """dq over [BH,S,D] from the forward's lse and delta [BH,S,1] f32.
    CUDA tensors run the tensor-core kernel (``flash_dq.launches`` and
    ``flash_dq.tc_launches`` count it), CPU tensors the plain version."""
    _check(q3, k3, v3, do3, rows=(lse, delta))
    if not use_kernel(q3, k3, v3, do3, lse, delta):
        return flash_dq_reference(q3, k3, v3, do3, lse, delta, causal, scale)
    dq = torch.empty_like(q3)
    if _launch("dq", (q3, k3, v3, do3, lse, delta), (dq,), causal,
               scale) == "tc":
        flash_dq.tc_launches += 1
    flash_dq.launches += 1
    return dq


def flash_dkv(q3, k3, v3, do3, lse, delta, causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) over [BH,S,D]; counted as ``flash_dq`` is."""
    _check(q3, k3, v3, do3, rows=(lse, delta))
    if not use_kernel(q3, k3, v3, do3, lse, delta):
        return flash_dkv_reference(q3, k3, v3, do3, lse, delta, causal,
                                   scale)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    if _launch("dkv", (q3, k3, v3, do3, lse, delta), (dk, dv), causal,
               scale) == "tc":
        flash_dkv.tc_launches += 1
    flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0
flash_fwd.tc_launches = 0
flash_dq.tc_launches = 0
flash_dkv.tc_launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable attention over [BH,S,D] (the JAX ``_flash`` custom
    VJP): forward kernel, then dq and dk/dv kernels in the backward."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal: bool, scale: float):
        o, lse = flash_fwd(q3, k3, v3, causal, scale)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        dq = flash_dq(q3, k3, v3, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_dkv(q3, k3, v3, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 256, block_kv: int = 256) -> torch.Tensor:
    """Attention over [B, H, S, D] without the [S, S] matrix; the same
    output as ``full_attention``."""
    b, h, s, d = q.shape
    if not _pick_block(s, min(block_q, s)) or \
            not _pick_block(s, min(block_kv, s)):
        from ps_pytorch_tpu_torch.parallel.ring import full_attention
        return full_attention(q, k, v, causal=causal, scale=scale)
    if scale is None:
        scale = float(d) ** -0.5
    q3, k3, v3 = (t.reshape(b * h, s, d).contiguous() for t in (q, k, v))
    o3 = FlashAttentionFunction.apply(q3, k3, v3, causal, float(scale))
    return o3.reshape(b, h, s, d)
