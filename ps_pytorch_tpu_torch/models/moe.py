"""Mixture-of-Experts transformer LM: the JAX package's ``models/moe.py``
(``MoEMLP`` ``:46-175``, ``MoEBlock`` ``:178-232``, ``MoETransformerLM``
``:235-281``), switch top-1 or GShard top-2 routing.

Submodule and parameter names follow the flax tree, so
``models/convert.py`` maps weights mechanically: ``block_{i}`` holds
``LayerNorm_0``, ``Dense_0..3`` (q, k, v, out; no bias), ``LayerNorm_1``
and ``moe``, which holds ``router`` (a bias-free Linear, [E, D] in the
torch layout) and the stacked expert parameters ``experts_w1`` [E, D, H],
``experts_b1`` [E, H], ``experts_w2`` [E, H, D] and ``experts_b2`` [E, D]
in the flax layout. flax's ``lecun_normal`` on the stacked [E, D, H]
kernel counts E as receptive field: the experts are drawn with fan-in
E * D (E * H for ``experts_w2``), as there.

Routing, as the JAX ``MoEMLP``:

- the router's softmax is f32; top-1 takes each token's argmax expert and
  keeps its raw probability as the gate, top-2 its two best experts with
  the gates renormalised over the pair. Ties go to the lower expert index,
  as ``jax.lax.top_k`` breaks them;
- capacity accounting runs per contiguous group of ``T / n_groups``
  tokens: ``capacity = max(ceil(top_k * tokens_a_group / E *
  capacity_factor), 1)``. First choices claim slots before second choices;
  each choice's slot is its place among the tokens of its group that chose
  the same expert at that rank, after the slots the earlier ranks asked
  for, dropped ones included. An assignment past the capacity is dropped,
  and a token whose assignments all drop gets zero MLP output;
- the load-balance loss is ``E * mean over groups of sum_e(fraction of
  first choices on e * mean probability of e)``, from the choices before
  any drop.

Dispatch is in PyTorch's idiom, not the JAX one-hot einsums (their [G, T,
E, C] f32 tensors are 16,384 x 8 x 2,560 x 4 B each at the LM's full width
in one group): each assignment's
slot is computed, the slot buffer [G, E, C, D] is gathered from the
tokens (a slot holds its token exactly, as the einsum's one term times
1.0 plus zeros does) and the outputs are gathered back and weighted by
their gates (equal to the einsum to rounding). No step depends on the
data's values for its shape, so every rank of an expert-parallel step
runs the same collectives.

Under expert parallelism (``parallel/ep.py``) the module holds E / n
experts and ``axis`` is the grid axis they are sharded over: each rank is
one dispatch group, and one ``all_to_all`` sends its slots to the ranks
that hold their experts, another brings the outputs back. Decoding (a
``DecodeCache``) dispatches each token as its own group, so decode never
drops an assignment and batch rows decode independently.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ps_pytorch_tpu_torch.models.layers import Linear, lecun_normal_
from ps_pytorch_tpu_torch.models.transformer import (
    DecodeCache, Embed, KVCache, LayerNorm, init_attention, self_attention,
)
from ps_pytorch_tpu_torch.parallel.collectives import all_to_all

def capacity(top_k: int, group_tokens: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert holds in a group (``moe.py:87``)."""
    return max(math.ceil(top_k * group_tokens / n_experts * capacity_factor),
               1)


def route(probs: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs [T, E] -> (expert ids [T, k], gates [T, k]): the ``top_k``
    best experts, ties to the lower index; the gates renormalised over
    the pair for top-2, the raw probability for top-1."""
    first = probs.argmax(-1)
    if top_k == 1:
        idx = first[:, None]
    else:
        rest = probs.detach().scatter(1, first[:, None], float("-inf"))
        idx = torch.stack([first, rest.argmax(-1)], dim=1)
    gates = probs.gather(1, idx)
    if top_k > 1:
        gates = gates / gates.sum(-1, keepdim=True)
    return idx, gates


def dispatch_slots(idx: torch.Tensor, n_groups: int, n_experts: int,
                   cap: int) -> torch.Tensor:
    """Expert ids [T, k] -> each assignment's row of the flat slot buffer
    [G * E * cap] ([T, k]; ``G * E * cap`` for a dropped one): group g,
    expert e, slot c at ``(g * E + e) * cap + c``, first choices queued
    before second choices, counts including drops (``moe.py:117-125``)."""
    t, k = idx.shape
    tg = t // n_groups
    onehot = F.one_hot(idx, n_experts).view(n_groups, tg, k, n_experts)
    before = torch.zeros(n_groups, 1, n_experts, dtype=torch.long,
                         device=idx.device)
    group = torch.arange(n_groups, device=idx.device)[:, None]
    dump = n_groups * n_experts * cap
    rows = []
    for r in range(k):
        oh = onehot[:, :, r]                                   # [G, TG, E]
        ahead = oh.cumsum(1) - oh + before
        e = idx[:, r].view(n_groups, tg)
        pos = ahead.gather(2, e[..., None])[..., 0]            # [G, TG]
        row = (group * n_experts + e) * cap + pos
        rows.append(torch.where(pos < cap, row, dump).reshape(t))
        before = before + oh.sum(1, keepdim=True)
    return torch.stack(rows, dim=1)


def logits_of(out) -> torch.Tensor:
    """A forward's logits, of either LM: the MoE LM returns (logits,
    aux)."""
    return out[0] if isinstance(out, tuple) else out


class MoEMLP(nn.Module):
    def __init__(self, n_experts: int, d_model: int, d_hidden: int,
                 capacity_factor: float = 1.25, n_groups: int = 1,
                 top_k: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {top_k}")
        e, d, h = n_experts, d_model, d_hidden
        self.n_experts, self.d_model, self.top_k = e, d, top_k
        self.capacity_factor, self.n_groups = capacity_factor, n_groups
        # The grid axis the experts are sharded over (parallel/ep.py).
        self.axis = None
        self.router = Linear(d, e, torch.float32, generator, bias=False)
        self.experts_w1 = nn.Parameter(torch.empty(e, d, h))
        lecun_normal_(self.experts_w1, e * d, generator)
        self.experts_b1 = nn.Parameter(torch.zeros(e, h))
        self.experts_w2 = nn.Parameter(torch.empty(e, h, d))
        lecun_normal_(self.experts_w2, e * h, generator)
        self.experts_b2 = nn.Parameter(torch.zeros(e, d))

    def ffn(self, xin: torch.Tensor) -> torch.Tensor:
        """[E_held, N, D] slots -> their experts' outputs."""
        h = torch.bmm(xin, self.experts_w1) + self.experts_b1[:, None]
        h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, self.experts_w2) + self.experts_b2[:, None]

    def forward(self, x: torch.Tensor, n_groups: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, S, D] -> (y [B, S, D], the load-balance loss, 0-d f32).
        ``n_groups`` overrides the module's (decode: one a token)."""
        b, s, d = x.shape
        e = self.n_experts
        g = self.n_groups if n_groups is None else n_groups
        sharded = self.axis is not None and self.axis.size > 1
        tokens = x.reshape(-1, d)
        t = tokens.shape[0]
        if sharded and g != 1:
            raise ValueError("under expert parallelism each device is one "
                             "dispatch group: use n_groups=1")
        if t % g:
            raise ValueError(f"{t} tokens not divisible into {g} groups")
        if d != self.d_model:
            raise ValueError(f"input feature dim {d} != d_model "
                             f"{self.d_model}")
        tg = t // g
        cap = capacity(self.top_k, tg, e, self.capacity_factor)
        probs = torch.softmax(self.router(tokens).float(), dim=-1)  # [T, E]
        idx, gates = route(probs, self.top_k)
        rows = dispatch_slots(idx, g, e, cap)                       # [T, k]
        n_slots = g * e * cap
        # The token each slot holds (T: none, a zero row); the dropped
        # assignments all land on the extra row n_slots, cut off after.
        src = torch.full((n_slots + 1,), t, dtype=torch.long,
                         device=x.device)
        ids = torch.arange(t, device=x.device)[:, None].expand_as(rows)
        src.scatter_(0, rows.reshape(-1), ids.reshape(-1))
        padded = torch.cat([tokens, tokens.new_zeros(1, d)])
        expert_in = padded[src[:n_slots]].view(g, e, cap, d)
        if sharded:
            held = self.experts_w1.shape[0]
            n = self.axis.size
            if held * n != e:
                raise ValueError(f"n_local_experts={held} x {n} devices != "
                                 f"{e} experts")
            out = all_to_all(expert_in[0], self.axis, 0, 1)  # [E/n, n*C, D]
            out = all_to_all(self.ffn(out), self.axis, 1, 0)  # [E, C, D]
        else:
            xin = expert_in.transpose(0, 1).reshape(e, g * cap, d)
            out = self.ffn(xin).view(e, g, cap, d).transpose(0, 1)
        out = torch.cat([out.reshape(n_slots, d).float(),
                         out.new_zeros(1, d, dtype=torch.float32)])
        y = (gates[:, 0, None] * out[rows[:, 0]])
        for r in range(1, self.top_k):
            y = y + gates[:, r, None] * out[rows[:, r]]
        y = y.view(b, s, d).to(x.dtype)
        first = F.one_hot(idx[:, 0], e).float().view(g, tg, e)
        frac_tokens = first.mean(1)
        frac_probs = probs.view(g, tg, e).mean(1)
        aux = e * (frac_tokens * frac_probs).sum(-1).mean()
        return y, aux


class MoEBlock(nn.Module):
    """The dense ``Block`` with the MLP swapped for ``MoEMLP``."""

    def __init__(self, n_heads: int, d_model: int, n_experts: int,
                 capacity_factor: float = 1.25, n_groups: int = 1,
                 top_k: int = 1, attention_impl: str = "full",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # The sequence is never sharded here: "full" or "flash" ("ring"
        # raises for want of an axis).
        init_attention(self, n_heads, d_model, attention_impl, generator,
                       None)
        self.moe = MoEMLP(n_experts, d_model, 4 * d_model, capacity_factor,
                          n_groups, top_k, generator)

    def forward(self, x: torch.Tensor, cache: Optional[KVCache] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, _ = x.shape
        x = self_attention(self, x, cache)
        m, aux = self.moe(self.LayerNorm_1(x),
                          n_groups=b * s if cache is not None else None)
        return x + m, aux


class MoETransformerLM(nn.Module):
    """Decoder-only LM with an MoE MLP in every block: ``forward`` returns
    (logits [B, S, V] f32, the summed load-balance losses). ``remat``
    recomputes each block in the backward; with the experts sharded the
    recompute runs the block's all-to-alls again on every rank, to the
    end of the block (checkpoint early stop off)."""

    def __init__(self, vocab_size: int = 256, n_layers: int = 2,
                 n_heads: int = 4, d_model: int = 128, n_experts: int = 8,
                 capacity_factor: float = 1.25, n_groups: int = 1,
                 max_seq_len: int = 2048, top_k: int = 1,
                 attention_impl: str = "full", remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size, self.n_layers = vocab_size, n_layers
        self.n_experts, self.top_k = n_experts, top_k
        self.attention_impl, self.remat = attention_impl, remat
        self.tok_embed = Embed(vocab_size, d_model, generator)
        self.pos_embed = Embed(max_seq_len, d_model, generator)
        for i in range(n_layers):
            self.add_module(f"block_{i}", MoEBlock(
                n_heads, d_model, n_experts, capacity_factor, n_groups,
                top_k, attention_impl, generator))
        self.ln_f = LayerNorm(d_model)
        self.lm_head = Linear(d_model, vocab_size, torch.float32, generator,
                              bias=False)

    def moe_layers(self):
        return [getattr(self, f"block_{i}").moe for i in range(self.n_layers)]

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[DecodeCache] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, S] int -> (logits [B, S, vocab] f32, aux); as
        ``TransformerLM.forward`` for ``positions`` and ``cache``."""
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        pos = self.pos_embed(positions)
        x = self.tok_embed(tokens) + (pos if positions.dim() == 2
                                      else pos[None])
        remat = self.remat and cache is None and torch.is_grad_enabled()
        sharded = any(m.axis is not None and m.axis.size > 1
                      for m in self.moe_layers())
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.n_layers):
            block = getattr(self, f"block_{i}")
            if remat and sharded:
                with set_checkpoint_early_stop(False):
                    x, aux = checkpoint(block, x, use_reentrant=False)
            elif remat:
                x, aux = checkpoint(block, x, use_reentrant=False)
            else:
                x, aux = block(x, cache.blocks[i] if cache is not None
                               else None)
            aux_total = aux_total + aux
        return self.lm_head(self.ln_f(x)).float(), aux_total
