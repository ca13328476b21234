"""Attention across the sequence: the JAX package's ``parallel/ring.py``.

``full_attention`` materialises the [S, S] scores. It serves
``--lm-attention full|auto`` on one device and the route of
``flash_attention`` for a sequence length with no power-of-two block.

``ring_attention`` (``ring.py:45-122``) is blockwise attention over the
ranks of one grid axis (``parallel/mesh.py``), each holding a contiguous
shard of the sequence: rank i holds tokens ``[i*S_local, (i+1)*S_local)``.
The local K/V shard travels the ring in ``n - 1`` hops (rank i sends to
i+1), one ``[2, B, H, S_local, D]`` message a hop, posted before the block
it overlaps is computed, and each block is merged into an online softmax,
so no rank holds the [S, S] scores. The JAX
package's guards are kept exactly: ``m_safe`` for a row with no unmasked
key in a block, the ``isfinite`` guards of ``merge``, causal masking by
global positions, the skip of a strictly-future source block (``src >
idx``), and the final ``l_safe`` division. The hop runs on every rank at
every step, a skipped block's included.

The backward is written out, as the transpose of the JAX scan: the forward
keeps the K/V block of every hop, and the gradients of each block's K/V
travel back along the ring (rank i to i-1) in ``n - 1`` hops, each rank
adding its own block's part before passing the sum on. The score
probabilities are recomputed from the saved row logsumexp. Every rank runs
every hop in the same order, forward and backward, so no rank waits on a
hop another skips.
"""

from typing import Optional

import torch

from ps_pytorch_tpu_torch.parallel.collectives import shift_start


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """softmax((q*scale) k^T, -inf above the diagonal when causal) v over
    [B, H, S, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        ok = (torch.arange(sq, device=s.device)[:, None]
              >= torch.arange(sk, device=s.device)[None, :])
        s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _block_attn(q, k, v, mask_bias):
    """One block: (row max, row sum of exp, unnormalised p v), with a
    fully masked row's max taken as 0 so its p is exp(-inf) = 0."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) + mask_bias
    m = s.amax(-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    return m, p.sum(-1), torch.einsum("bhqk,bhkd->bhqd", p, v)


def _merge(m_run, l_run, o_run, m_blk, l_blk, o_blk):
    """The online-softmax update; a side whose max is -inf weighs 0."""
    m_new = torch.maximum(m_run, m_blk)
    zero = torch.zeros_like(m_new)
    a = torch.where(torch.isfinite(m_run), torch.exp(m_run - m_new), zero)
    b = torch.where(torch.isfinite(m_blk), torch.exp(m_blk - m_new), zero)
    return (m_new, a * l_run + b * l_blk,
            a[..., None] * o_run + b[..., None] * o_blk)


class _Geometry:
    """Positions and masks of one rank's ring."""

    def __init__(self, q, axis, causal: bool):
        self.n, self.idx, self.causal = axis.size, axis.index, causal
        self.s_local = q.shape[2]
        self.dtype, self.device = q.dtype, q.device
        self.q_pos = self.idx * self.s_local + torch.arange(
            self.s_local, device=q.device)

    def source(self, t: int) -> int:
        """The rank whose K/V this rank holds at hop ``t``."""
        return (self.idx - t) % self.n

    def skipped(self, src: int) -> bool:
        return self.causal and src > self.idx

    def mask_bias(self, src: int) -> torch.Tensor:
        s = self.s_local
        if not self.causal:
            return torch.zeros((1, 1, s, s), dtype=self.dtype,
                               device=self.device)
        kv_pos = src * s + torch.arange(s, device=self.device)
        ok = self.q_pos[:, None] >= kv_pos[None, :]
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return torch.where(ok, zero, float("-inf"))[None, None]


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale):
        geo = _Geometry(q, axis, causal)
        qs = q * scale
        neg_inf = torch.full(q.shape[:3], float("-inf"), dtype=q.dtype,
                             device=q.device)

        def block_or_skip(kv, t):
            src = geo.source(t)
            if geo.skipped(src):
                return (neg_inf, torch.zeros_like(neg_inf),
                        torch.zeros_like(q))
            return _block_attn(qs, kv[0], kv[1], geo.mask_bias(src))

        kv = torch.stack([k, v])
        kvs = [kv]
        run = (neg_inf, torch.zeros_like(neg_inf), torch.zeros_like(q))
        for t in range(geo.n - 1):
            # The hop is posted first, and the block computed while it
            # is in flight.
            hop = shift_start(kv, axis, 1)
            run = _merge(*run, *block_or_skip(kv, t))
            kv = hop()
            kvs.append(kv)
        m_f, l_f, o_f = _merge(*run, *block_or_skip(kv, geo.n - 1))
        l_safe = torch.where(l_f == 0, torch.ones_like(l_f), l_f)
        out = o_f / l_safe[..., None]
        # The row logsumexp for the backward; a row that saw no key (its
        # output 0) gets +inf, so its recomputed p is 0.
        m_safe = torch.where(torch.isfinite(m_f), m_f, torch.zeros_like(m_f))
        lse = torch.where(l_f == 0, torch.full_like(l_f, float("inf")),
                          m_safe + torch.log(l_safe))
        ctx.save_for_backward(qs, out, lse, *kvs)
        ctx.axis, ctx.causal, ctx.scale = axis, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qs, out, lse, *kvs = ctx.saved_tensors
        geo = _Geometry(qs, ctx.axis, ctx.causal)
        dout = dout.contiguous()
        delta = (dout * out).sum(-1, keepdim=True)
        dqs = torch.zeros_like(qs)
        g_kv = None
        for t in range(geo.n - 1, -1, -1):
            # The transpose of the forward hop kv_{t+1} = shift(kv_t, +1):
            # the gradient of the blocks from hop t+1 on goes back one
            # rank, in flight while this hop's block is differentiated.
            hop = None if g_kv is None else shift_start(g_kv, ctx.axis, -1)
            kv = kvs[t]
            src = geo.source(t)
            d_kv = torch.zeros_like(kv)
            if not geo.skipped(src):
                k, v = kv[0], kv[1]
                s = torch.einsum("bhqd,bhkd->bhqk", qs, k) \
                    + geo.mask_bias(src)
                p = torch.exp(s - lse[..., None])
                dp = torch.einsum("bhqd,bhkd->bhqk", dout, v)
                ds = p * (dp - delta)
                dqs += torch.einsum("bhqk,bhkd->bhqd", ds, k)
                d_kv[0] = torch.einsum("bhqk,bhqd->bhkd", ds, qs)
                d_kv[1] = torch.einsum("bhqk,bhqd->bhkd", p, dout)
            g_kv = d_kv if hop is None else d_kv + hop()
        return dqs * ctx.scale, g_kv[0], g_kv[1], None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis, *, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise ring attention over grid axis ``axis``: q, k, v are this
    rank's [B, H, S_local, D] shards; returns the local queries' output.
    ``causal`` masks by global positions."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, axis, causal, scale)
