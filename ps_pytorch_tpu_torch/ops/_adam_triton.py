"""The Triton kernel of ``ops/fused_adam.py``. Imported only by the wrapper
when it launches on a CUDA tensor: importing this module needs ``triton``.
"""

import triton
import triton.language as tl


@triton.jit(do_not_specialize=["step_size"])
def adam_kernel(p_ptr, m_ptr, v_ptr, vh_ptr, g_ptr, n, step_size,
                B1: tl.constexpr, B2: tl.constexpr, EPS: tl.constexpr,
                WEIGHT_DECAY: tl.constexpr, AMSGRAD: tl.constexpr,
                BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    p = tl.load(p_ptr + offs, mask=mask)
    g = tl.load(g_ptr + offs, mask=mask)
    if WEIGHT_DECAY != 0.0:
        g = g + WEIGHT_DECAY * p
    m = B1 * tl.load(m_ptr + offs, mask=mask) + (1.0 - B1) * g
    v = B2 * tl.load(v_ptr + offs, mask=mask) + (1.0 - B2) * g * g
    if AMSGRAD:
        v_hat = tl.maximum(tl.load(vh_ptr + offs, mask=mask), v)
        tl.store(vh_ptr + offs, v_hat, mask=mask)
    else:
        v_hat = v
    # IEEE square root and division: plain sqrt and / lower to the
    # approximate instructions.
    update = tl.div_rn(step_size * m, tl.sqrt_rn(v_hat) + EPS)
    tl.store(p_ptr + offs, p - update, mask=mask)
    tl.store(m_ptr + offs, m, mask=mask)
    tl.store(v_ptr + offs, v, mask=mask)


def launch(p, m, v, vh, g, step_size: float, b1: float, b2: float,
           eps: float, weight_decay: float, block: int) -> None:
    n = p.numel()
    # Without AMSGrad, vh_ptr is never read: m stands in for it.
    adam_kernel[(triton.cdiv(n, block),)](
        p, m, v, m if vh is None else vh, g, n, float(step_size),
        B1=float(b1), B2=float(b2), EPS=float(eps),
        WEIGHT_DECAY=float(weight_decay), AMSGRAD=vh is not None,
        BLOCK=block, num_warps=4, enable_fp_fusion=False)
