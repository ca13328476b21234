"""Attention that materialises the [S, S] scores: the JAX package's
``parallel/ring.py:full_attention``. It serves ``--lm-attention full|auto``
on one device and the route of ``flash_attention`` for a sequence length
with no power-of-two block. ``ring_attention`` (the sequence sharded over
devices) waits for ``torch.distributed`` (ROADMAP.md).
"""

from typing import Optional

import torch


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
