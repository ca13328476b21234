"""Decoder-only transformer LM: the JAX package's ``models/transformer.py``
(``Block``, ``TransformerLM``, ``cached_attention`` and
``migrate_packed_qkv``).

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
[S, S]), ``flash`` (the hand-written kernels, ``ops/flash_attention.py``)
or ``ring`` (the sequence sharded over the ranks of ``axis``, a grid axis
of ``parallel/mesh.py``: ``parallel/ring.py:ring_attention``, the JAX
``attention_impl="ring"`` bound to its ``axis_name``).

``remat`` recomputes each block's interior in the backward
(``torch.utils.checkpoint``, the JAX ``nn.remat(Block)``): the backward
keeps the block boundaries only, and under ``flash`` the recompute
launches the forward kernel again; under ``ring`` the recompute runs the
block's hops again, on every rank, to the end of the block (early stop
off: a rank whose skipped blocks need fewer saved tensors would otherwise
stop before a hop its neighbour waits on). Decoding passes a ``DecodeCache``: a
fixed-length k/v cache a block (``cached_attention``), plain torch as the
JAX decode path is ``jnp`` outside any Pallas kernel. Neither changes the
parameters, so any checkpoint trains with remat and decodes as it is.
"""

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ps_pytorch_tpu_torch.models.layers import Linear, lecun_normal_
from ps_pytorch_tpu_torch.ops.flash_attention import flash_attention
from ps_pytorch_tpu_torch.parallel.ring import full_attention, ring_attention

ATTENTION_IMPLS = ("full", "flash", "ring")


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


class KVCache:
    """One block's cache: ``k``, ``v`` [B, heads, length, head dim] and
    ``idx``, the number of slots written (the JAX ``"cache"`` collection's
    ``k``, ``v`` and ``idx``).

    ``idx`` is an int, one offset for every row (``generate``), or a [B]
    int64 tensor on the cache's device, an offset a row: the JAX serving
    engine's ``vmap`` over one-row caches, where each slot sits at its own
    position (``serving/engine.py``)."""

    def __init__(self, b: int, heads: int, length: int, head_dim: int,
                 dtype: torch.dtype, device):
        shape = (b, heads, length, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.idx = 0


class DecodeCache:
    """A ``KVCache`` for each block of a ``TransformerLM`` or a
    ``models/moe.py:MoETransformerLM`` (its blocks hold the same
    ``Dense_0`` q projection and ``n_heads``), ``length`` slots long (the
    prompt plus the tokens to generate). ``set_offsets(idx)`` puts every
    block in the per-row form."""

    def __init__(self, model: nn.Module, batch: int, length: int):
        p = model.tok_embed.embedding
        blocks = [getattr(model, f"block_{i}") for i in range(model.n_layers)]
        self.length = length
        self.blocks: List[KVCache] = [
            KVCache(batch, b.n_heads, length, b.Dense_0.weight.shape[0]
                    // b.n_heads, p.dtype, p.device) for b in blocks]

    def set_offsets(self, idx: torch.Tensor) -> None:
        """Row b of every block writes next at ``idx[b]`` ([B] int64)."""
        for block in self.blocks:
            block.idx = idx


@torch.no_grad()
def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache: KVCache) -> torch.Tensor:
    """Causal attention over a running k/v cache (the JAX
    ``cached_attention``): q/k/v [B, h, S, hd] with any S >= 1 are written
    at the cache's offset i; query t sees slots <= i + t. S = 1 is a
    sampling step, S > 1 a prefill in one pass. The numerics are
    ``full_attention``'s: ``q * scale``, -inf above the mask, softmax.

    With a [B] tensor offset, row b writes at ``idx[b]`` and its query t
    sees slots <= idx[b] + t; the caller keeps ``idx[b] + S`` within the
    cache (the check would wait for the card)."""
    b, h, s, hd = q.shape
    i, length = cache.idx, cache.k.shape[2]
    if isinstance(i, torch.Tensor):
        return _rowwise_cached_attention(q, k, v, cache)
    if i + s > length:
        raise ValueError(f"cache of {length} slots holds {i}; {s} more "
                         "do not fit")
    cache.k[:, :, i:i + s] = k
    cache.v[:, :, i:i + s] = v
    cache.idx = i + s
    att = torch.einsum("bhqd,bhkd->bhqk", q * hd ** -0.5, cache.k)
    q_pos = i + torch.arange(s, device=q.device)
    ok = torch.arange(length, device=q.device)[None, :] <= q_pos[:, None]
    att = att.masked_fill(~ok[None, None], float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(att, dim=-1),
                        cache.v)


def _rowwise_cached_attention(q, k, v, cache: KVCache) -> torch.Tensor:
    b, h, s, hd = q.shape
    length = cache.k.shape[2]
    pos = cache.idx[:, None] + torch.arange(s, device=q.device)    # [B, S]
    rows = torch.arange(b, device=q.device)[:, None]
    # [B, S] advanced indices around the head slice: the value is
    # [B, S, h, hd].
    cache.k[rows, :, pos] = k.transpose(1, 2)
    cache.v[rows, :, pos] = v.transpose(1, 2)
    cache.idx = cache.idx + s
    att = torch.einsum("bhqd,bhkd->bhqk", q * hd ** -0.5, cache.k)
    ok = torch.arange(length, device=q.device)[None, None, :] \
        <= pos[:, :, None]                                         # [B, S, L]
    att = att.masked_fill(~ok[:, None], float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(att, dim=-1),
                        cache.v)


class Block(nn.Module):
    """Pre-LN block: causal self-attention, then a 4x GELU MLP."""

    def __init__(self, n_heads: int, d_model: int,
                 attention_impl: str = "full",
                 generator: Optional[torch.Generator] = None, axis=None):
        super().__init__()
        init_attention(self, n_heads, d_model, attention_impl, generator,
                       axis)
        d, f32 = d_model, torch.float32
        self.Dense_4 = Linear(d, 4 * d, f32, generator)
        self.Dense_5 = Linear(4 * d, d, f32, generator)

    def forward(self, x: torch.Tensor,
                cache: Optional[KVCache] = None) -> torch.Tensor:
        x = self_attention(self, x, cache)
        y = F.gelu(self.Dense_4(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_5(y)


def init_attention(blk: nn.Module, n_heads: int, d_model: int,
                   attention_impl: str,
                   generator: Optional[torch.Generator], axis) -> None:
    """The attention half's modules and settings of a pre-LN block
    (``Block`` or ``models/moe.py:MoEBlock``): ``LayerNorm_0``, the q, k,
    v and out projections ``Dense_0..3`` (no bias) and ``LayerNorm_1``."""
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl {attention_impl!r} is not "
                         f"ported (ROADMAP.md); choose from "
                         f"{ATTENTION_IMPLS}")
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by "
                         f"{n_heads} heads")
    if attention_impl == "ring" and axis is None:
        raise ValueError("attention_impl='ring' needs the grid axis "
                         "the sequence is sharded over")
    d, f32 = d_model, torch.float32
    blk.n_heads, blk.attention_impl, blk.axis = n_heads, attention_impl, axis
    blk.LayerNorm_0 = LayerNorm(d)
    blk.Dense_0 = Linear(d, d, f32, generator, bias=False)      # q
    blk.Dense_1 = Linear(d, d, f32, generator, bias=False)      # k
    blk.Dense_2 = Linear(d, d, f32, generator, bias=False)      # v
    blk.Dense_3 = Linear(d, d, f32, generator, bias=False)      # out
    blk.LayerNorm_1 = LayerNorm(d)


def self_attention(blk: nn.Module, x: torch.Tensor,
                   cache: Optional[KVCache] = None) -> torch.Tensor:
    """The attention half of a pre-LN block (``Block`` or
    ``models/moe.py:MoEBlock``, which share its names): ``x`` plus the
    out-projection of causal attention over ``LayerNorm_0(x)``, through the
    cache, the ring or the block's ``attention_impl``."""
    b, s, d = x.shape
    h = blk.n_heads
    y = blk.LayerNorm_0(x)

    def to_heads(t):
        return t.reshape(b, s, h, d // h).transpose(1, 2)

    q, k, v = (to_heads(f(y)) for f in (blk.Dense_0, blk.Dense_1,
                                        blk.Dense_2))
    if cache is not None:
        o = cached_attention(q, k, v, cache)
    elif blk.attention_impl == "ring":
        o = ring_attention(q, k, v, blk.axis, causal=True)
    else:
        attend = flash_attention if blk.attention_impl == "flash" \
            else full_attention
        o = attend(q, k, v, causal=True)
    return x + blk.Dense_3(o.transpose(1, 2).reshape(b, s, d))


class TransformerLM(nn.Module):
    def __init__(self, vocab_size: int = 256, n_layers: int = 2,
                 n_heads: int = 4, d_model: int = 128,
                 max_seq_len: int = 2048, attention_impl: str = "full",
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False, axis=None):
        super().__init__()
        self.vocab_size, self.n_layers = vocab_size, n_layers
        self.attention_impl, self.remat = attention_impl, remat
        self.tok_embed = Embed(vocab_size, d_model, generator)
        self.pos_embed = Embed(max_seq_len, d_model, generator)
        for i in range(n_layers):
            self.add_module(f"block_{i}", Block(n_heads, d_model,
                                                attention_impl, generator,
                                                axis))
        self.ln_f = LayerNorm(d_model)
        self.lm_head = Linear(d_model, vocab_size, torch.float32, generator,
                              bias=False)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[DecodeCache] = None) -> torch.Tensor:
        """tokens [B, S] int -> logits [B, S, vocab] f32; ``positions``
        [S] (every row's) or [B, S] (a row's own, with a per-row cache)
        defaults to 0..S-1. With ``cache`` the tokens continue the cached
        prefix (their positions must too)."""
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        pos = self.pos_embed(positions)
        x = self.tok_embed(tokens) + (pos if positions.dim() == 2
                                      else pos[None])
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i in range(self.n_layers):
            block = getattr(self, f"block_{i}")
            if remat and self.attention_impl == "ring":
                with set_checkpoint_early_stop(False):
                    x = checkpoint(block, x, use_reentrant=False)
            elif remat:
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x, cache.blocks[i] if cache is not None else None)
        return self.lm_head(self.ln_f(x)).float()


def migrate_packed_qkv(tree):
    """A tree of a checkpoint written before the q/k/v projections were
    split (one packed ``Dense(3d)`` a block, ``Dense_0..3``) -> (the tree
    in the current layout, the number of nodes rewritten); the JAX
    package's ``migrate_packed_qkv``, on nested dicts of numpy arrays.

    The packed [d, 3d] kernel is split column-wise into the q, k and v
    [d, d] kernels (the packed layout was their concatenation, so the
    split is exact) and ``Dense_1..3`` move to ``Dense_3..5``. Momentum
    trees mirror the parameters and migrate the same way. 0 nodes
    rewritten: nothing legacy was found."""
    n_changed = 0

    def walk(node):
        nonlocal n_changed
        if not isinstance(node, dict):
            return node
        node = {k: walk(v) for k, v in node.items()}
        d0 = node.get("Dense_0")
        dense_keys = {k for k in node if k.startswith("Dense_")}
        if (isinstance(d0, dict)
                and dense_keys == {"Dense_0", "Dense_1", "Dense_2", "Dense_3"}
                and getattr(d0.get("kernel"), "ndim", 0) == 2
                and d0["kernel"].shape[1] == 3 * d0["kernel"].shape[0]):
            kern = d0["kernel"]
            d = kern.shape[0]
            out = dict(node)
            out["Dense_0"] = {**d0, "kernel": kern[:, :d]}
            out["Dense_1"] = {**d0, "kernel": kern[:, d:2 * d]}
            out["Dense_2"] = {**d0, "kernel": kern[:, 2 * d:]}
            out["Dense_3"] = node["Dense_1"]
            out["Dense_4"] = node["Dense_2"]
            out["Dense_5"] = node["Dense_3"]
            n_changed += 1
            return out
        return node

    return walk(tree), n_changed

