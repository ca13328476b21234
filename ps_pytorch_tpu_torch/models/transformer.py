"""Decoder-only transformer LM: the JAX package's ``models/transformer.py``
(``Block`` and ``TransformerLM``) for training on one device.

Submodule and parameter names follow the flax tree, so ``models/convert.py``
maps weights mechanically: ``tok_embed`` and ``pos_embed`` (``embedding``),
``block_{i}`` with ``LayerNorm_0``, ``Dense_0..5`` and ``LayerNorm_1``,
``ln_f`` and ``lm_head``. Three flax defaults differ from PyTorch's and are
kept here:

- ``nn.gelu`` is the tanh approximation;
- ``LayerNorm`` uses eps 1e-6 and the variance ``mean(x^2) - mean(x)^2``;
- the q/k/v/out projections (``Dense_0..3``) and ``lm_head`` have no bias,
  the MLP's ``Dense_4`` and ``Dense_5`` do.

Parameters and activations are f32 (the LM trainer passes no dtype), and
logits come out in f32. ``attention_impl`` is ``full`` (materialises
[S, S]) or ``flash`` (the hand-written kernels, ``ops/flash_attention.py``).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ps_pytorch_tpu_torch.models.layers import Linear, lecun_normal_
from ps_pytorch_tpu_torch.ops.flash_attention import flash_attention
from ps_pytorch_tpu_torch.parallel.ring import full_attention

ATTENTION_IMPLS = ("full", "flash")


class Embed(nn.Module):
    """``flax.linen.Embed``: an ``embedding`` [num, features] table, drawn
    like flax's default (truncated normal, variance 1/features)."""

    def __init__(self, num: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))
        lecun_normal_(self.embedding, features, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` over the last axis: eps 1e-6, variance
    ``mean(x^2) - mean(x)^2`` clipped at 0, ``(x - mean) * (scale *
    rsqrt(var + eps)) + bias``."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class Block(nn.Module):
    """Pre-LN block: causal self-attention, then a 4x GELU MLP."""

    def __init__(self, n_heads: int, d_model: int,
                 attention_impl: str = "full",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {attention_impl!r} is not "
                             f"ported (ROADMAP.md); choose from "
                             f"{ATTENTION_IMPLS}")
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"{n_heads} heads")
        d, f32 = d_model, torch.float32
        self.n_heads, self.attention_impl = n_heads, attention_impl
        self.LayerNorm_0 = LayerNorm(d)
        self.Dense_0 = Linear(d, d, f32, generator, bias=False)     # q
        self.Dense_1 = Linear(d, d, f32, generator, bias=False)     # k
        self.Dense_2 = Linear(d, d, f32, generator, bias=False)     # v
        self.Dense_3 = Linear(d, d, f32, generator, bias=False)     # out
        self.LayerNorm_1 = LayerNorm(d)
        self.Dense_4 = Linear(d, 4 * d, f32, generator)
        self.Dense_5 = Linear(4 * d, d, f32, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.n_heads
        y = self.LayerNorm_0(x)

        def to_heads(t):
            return t.reshape(b, s, h, d // h).transpose(1, 2)

        q, k, v = (to_heads(f(y)) for f in (self.Dense_0, self.Dense_1,
                                            self.Dense_2))
        attend = flash_attention if self.attention_impl == "flash" \
            else full_attention
        o = attend(q, k, v, causal=True)
        x = x + self.Dense_3(o.transpose(1, 2).reshape(b, s, d))
        y = F.gelu(self.Dense_4(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_5(y)


class TransformerLM(nn.Module):
    def __init__(self, vocab_size: int = 256, n_layers: int = 2,
                 n_heads: int = 4, d_model: int = 128,
                 max_seq_len: int = 2048, attention_impl: str = "full",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size, self.n_layers = vocab_size, n_layers
        self.attention_impl = attention_impl
        self.tok_embed = Embed(vocab_size, d_model, generator)
        self.pos_embed = Embed(max_seq_len, d_model, generator)
        for i in range(n_layers):
            self.add_module(f"block_{i}", Block(n_heads, d_model,
                                                attention_impl, generator))
        self.ln_f = LayerNorm(d_model)
        self.lm_head = Linear(d_model, vocab_size, torch.float32, generator,
                              bias=False)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] int -> logits [B, S, vocab] f32; ``positions``
        [S] defaults to 0..S-1."""
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.tok_embed(tokens) + self.pos_embed(positions)[None]
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x)
        return self.lm_head(self.ln_f(x)).float()

