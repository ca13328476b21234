"""Tensor parallelism for the TransformerLM: the JAX package's
``parallel/tp.py`` (``tp_param_specs`` ``:46-63``, ``_opt_state_specs``
``:66-95``, ``make_tp_train_step`` ``:140-188``), with its collectives
placed by hand as Megatron's pairs where GSPMD places them in the JAX
package.

Layout over the ``model`` axis of the grid (``parallel/mesh.py``), in the
torch layout (``Linear.weight`` is [out, in]; ``models/convert.py:
tp_shard_dim``):

- q/k/v (``Dense_0..2``): column-parallel, rows of the weight sharded;
  when ``n_heads`` divides by the axis a rank's heads are whole, else its
  columns straddle heads and attention runs on the gathered heads
  (``_gather_columns``);
- the attention out-projection (``Dense_3``): row-parallel, its output a
  partial sum all-reduced over ``model``;
- the MLP up-projection (``Dense_4``): column-parallel, with its bias;
- the MLP down-projection (``Dense_5``): row-parallel, its bias added once,
  after the all-reduce;
- ``lm_head``: column-parallel, so the logits are sharded over the vocab;
- the embeddings, LayerNorms and the down-projection's bias: replicated.

A column-parallel layer takes its input through ``copy_to`` (the input's
gradient all-reduced over ``model`` backward) and a row-parallel one gives
its output through ``reduce_from`` (all-reduced forward). So every
replicated tensor, and every replicated parameter's gradient, is whole on
each rank of ``model``: those gradients are reduced over ``data`` only,
with the shards'. The SGD momentum of a sharded parameter is built from
the shard, so it is sharded the same way (``_opt_state_specs``).

The loss is the JAX step's, ``logits[:, :-1]`` against ``tokens[:, 1:]``,
mean over the global batch, computed as a vocab-parallel cross-entropy:
an all-reduce of the row max and one of the sum of exps with the target
logit, each over ``model``; the full-vocab logits never cross ranks. The
batch is sharded over ``data`` (``P("data", None)``); a rank
differentiates its local loss sum, the gradients are summed over
``data`` and divided by the global token count.

What the JAX package refuses is refused here: flash under tp
(``runtime/lm_trainer.py``) and ring (``make_tp_train_step``) with its
messages, and a ``d_model`` or vocabulary that does not divide by the axis (GSPMD cannot
lay ``P(None, 'model')`` over it: ``create_tp_train_state`` raises). A
head count that does not divide runs, as there: GSPMD reshards inside
attention, and so does ``_block`` here. Each rank all-gathers the q/k/v
column shards into every head (``_gather_columns``), runs full causal
attention over all heads, and feeds its own columns of the output to the
row-parallel ``Dense_3``. The gather's backward sums the full-width
gradient over the model ranks and keeps this rank's columns: rank r's
``dq``, ``dk``, ``dv`` hold only what flows through its columns of the
output, so a head that straddles two ranks gets part of its gradient on
each.
"""

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ps_pytorch_tpu_torch.models.convert import (
    tp_shard, tp_shard_dim, unshard,
)
from ps_pytorch_tpu_torch.parallel.collectives import (
    all_gather_host, all_reduce_, all_reduce_flat_, copy_to, reduce_from,
)
from ps_pytorch_tpu_torch.parallel.ring import full_attention


def check_divisible(n_heads: int, d_model: int, vocab: int,
                    size: int) -> None:
    """Refuse the splits the JAX ``create_tp_train_state`` refuses:
    ``d_model`` (so ``4 * d_model``) or ``vocab`` not divisible by the
    model axis. Any head count is taken."""
    bad = [f"{name}={value}" for name, value in (
        ("lm_d_model", d_model), ("lm_vocab", vocab)) if value % size]
    if bad:
        raise ValueError(
            f"lm_parallelism='tp' over {size} model ranks needs "
            f"{', '.join(bad)} divisible by {size}: the column and row "
            "shards split that dimension evenly, and the JAX package "
            "refuses it too (its P(None, 'model') sharding needs the "
            "dimension divisible by the axis)")


def shard_model_(model: nn.Module, axis) -> nn.Module:
    """Replace each sharded parameter of a full ``TransformerLM`` by this
    rank's part of it, in place. The model then runs only through
    ``tp_logits``."""
    blk = model.block_0
    check_divisible(blk.n_heads, blk.Dense_0.weight.shape[1],
                    model.vocab_size, axis.size)
    for name, p in list(model.named_parameters()):
        if tp_shard_dim(name) is None:
            continue
        owner_name, leaf = name.rsplit(".", 1)
        owner = model.get_submodule(owner_name)
        part = tp_shard(name, p.detach(), axis.index, axis.size)
        setattr(owner, leaf, nn.Parameter(part.clone()))
    model.tp_axis = axis
    return model


class _GatherColumns(torch.autograd.Function):
    """[..., n / m] on each of the ``m`` ranks of ``axis`` -> [..., n],
    the ranks' columns in axis order, as one all-reduce of the
    zero-padded tensor (gloo reduces a CUDA tensor but gathers only host
    ones). Backward: the full-width gradient summed over the ranks, then
    this rank's columns."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.width = axis, x.shape[-1]
        full = x.new_zeros(*x.shape[:-1], x.shape[-1] * axis.size)
        full.narrow(-1, axis.index * ctx.width, ctx.width).copy_(x)
        return all_reduce_(full, axis)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.axis)
        return g.narrow(-1, ctx.axis.index * ctx.width,
                        ctx.width).contiguous(), None


def _gather_columns(x: torch.Tensor, axis) -> torch.Tensor:
    return x if axis.size == 1 else _GatherColumns.apply(x, axis)


def _block(blk, x, axis):
    """One pre-LN block with its q/k/v and MLP columns sharded."""
    b, s, d = x.shape
    hd = d // blk.n_heads
    # Whole heads a rank when the axis divides them; else this rank's
    # columns straddle heads, and attention runs on the gathered ones.
    whole = blk.n_heads % axis.size == 0
    y = copy_to(blk.LayerNorm_0(x), axis)
    q, k, v = (f(y) if whole else _gather_columns(f(y), axis)
               for f in (blk.Dense_0, blk.Dense_1, blk.Dense_2))
    heads = q.shape[-1] // hd
    q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2) for t in (q, k, v))
    o = full_attention(q, k, v, causal=True)
    o = o.transpose(1, 2).reshape(b, s, heads * hd)
    if not whole:
        width = d // axis.size
        o = o.narrow(-1, axis.index * width, width)
    x = x + reduce_from(blk.Dense_3(o), axis)
    y = copy_to(blk.LayerNorm_1(x), axis)
    y = F.gelu(blk.Dense_4(y), approximate="tanh")
    return x + (reduce_from(F.linear(y, blk.Dense_5.weight), axis)
                + blk.Dense_5.bias)


def tp_logits(model: nn.Module, tokens: torch.Tensor,
              remat: bool = False) -> torch.Tensor:
    """tokens [B, S] -> this rank's vocab shard of the logits [B, S,
    vocab / model], f32."""
    axis = model.tp_axis
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = model.tok_embed(tokens) + model.pos_embed(positions)[None]
    for i in range(model.n_layers):
        blk = getattr(model, f"block_{i}")
        if remat and torch.is_grad_enabled():
            # Early stop off: the recompute runs the block's all-reduces
            # to its end on every rank.
            with set_checkpoint_early_stop(False):
                x = checkpoint(_block, blk, x, axis, use_reentrant=False)
        else:
            x = _block(blk, x, axis)
    y = copy_to(model.ln_f(x), axis)
    return F.linear(y, model.lm_head.weight).float()


class _VocabParallelCE(torch.autograd.Function):
    """Per-row cross-entropy of logits sharded over the vocab: rows [N,
    V / m] on each rank of ``axis``, vocab offset ``start``; targets [N]
    global ids. The backward is local: softmax minus the one-hot."""

    @staticmethod
    def forward(ctx, logits, targets, axis, start):
        m = logits.detach().amax(-1)
        all_reduce_(m, axis, torch.distributed.ReduceOp.MAX)
        shifted = logits - m[:, None]
        e = torch.exp(shifted)
        local = targets - start
        inside = (local >= 0) & (local < logits.shape[-1])
        idx = local.clamp(0, logits.shape[-1] - 1)
        target_logit = shifted.gather(1, idx[:, None]).squeeze(1) \
            * inside.to(logits.dtype)
        sums = all_reduce_(torch.stack([e.sum(-1), target_logit]), axis)
        ctx.save_for_backward(e / sums[0][:, None], idx, inside)
        return torch.log(sums[0]) - sums[1]

    @staticmethod
    def backward(ctx, g):
        softmax, idx, inside = ctx.saved_tensors
        grad = softmax.scatter_add(1, idx[:, None],
                                   -inside.to(softmax.dtype)[:, None])
        return grad * g[:, None], None, None, None


def vocab_parallel_loss_sum(logits_local: torch.Tensor,
                            tokens: torch.Tensor, axis) -> torch.Tensor:
    """Sum over rows and positions of the next-token cross-entropy of
    ``logits[:, :-1]`` against ``tokens[:, 1:]``."""
    v_local = logits_local.shape[-1]
    rows = logits_local[:, :-1].reshape(-1, v_local)
    per = _VocabParallelCE.apply(rows, tokens[:, 1:].reshape(-1), axis,
                                 axis.index * v_local)
    return per.sum()


def batch_shard(tokens: np.ndarray, axis) -> np.ndarray:
    """This rank's rows of a [B, S] batch sharded over ``data``
    (``P("data", None)``)."""
    b = tokens.shape[0] // axis.size
    return tokens[axis.index * b:(axis.index + 1) * b]


class TPTrainStep:
    """``step(tokens) -> {"loss"}`` over this rank's [B_local, S] rows;
    ``model`` is sharded by ``shard_model_``, ``opt_state`` mirrors it."""

    def __init__(self, model: nn.Module, opt, grid, remat: bool = False):
        if model.attention_impl != "full":
            raise ValueError("TP step requires attention_impl='full' "
                             "(ring attention shards sequence, not heads)")
        self.model, self.opt, self.grid, self.remat = model, opt, grid, remat
        self.device = next(model.parameters()).device
        self.params: Dict[str, nn.Parameter] = dict(model.named_parameters())
        self.opt_state = opt.init(self.params)

    def __call__(self, tokens) -> Dict[str, torch.Tensor]:
        tokens = torch.as_tensor(np.asarray(tokens)).to(self.device).long()
        self.model.train()
        for p in self.params.values():
            p.grad = None
        loss_sum = vocab_parallel_loss_sum(
            tp_logits(self.model, tokens, self.remat), tokens,
            self.grid.model)
        loss_sum.backward()
        b, s = tokens.shape
        total = float(b * self.grid.data.size * (s - 1))
        with torch.no_grad():
            all_reduce_flat_([p.grad for p in self.params.values()],
                             self.grid.data, total)
            loss = all_reduce_(loss_sum.detach().clone(), self.grid.data)
            self.opt_state = self.opt.apply(
                self.params, self.opt_state,
                {k: p.grad for k, p in self.params.items()})
        return {"loss": loss / total}


def gather_full(tensors: Dict[str, torch.Tensor], axis,
                shard_dim: Callable = tp_shard_dim
                ) -> Dict[str, torch.Tensor]:
    """Name -> this rank's part (parameters, or a mirror of them such as
    the momentum) -> name -> the whole tensor on the host, on every rank
    of ``axis`` (each takes part); ``shard_dim(name)`` is the dimension a
    tensor is sharded along (tensor parallelism's by default). The parts
    go as one flat buffer a dtype, one gather each
    (``all_gather_host``: on the card under NCCL)."""
    sharded = {name: dim for name in tensors
               if axis.size > 1 and (dim := shard_dim(name)) is not None}
    parts: Dict[str, list] = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for name in sharded:
        by_dtype.setdefault(tensors[name].dtype, []).append(name)
    for names in by_dtype.values():
        flat = torch.cat([tensors[n].detach().reshape(-1) for n in names])
        for got in all_gather_host(flat, axis):
            offset = 0
            for n in names:
                t = tensors[n]
                parts.setdefault(n, []).append(
                    got[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()
    return {name: unshard(parts[name], sharded[name]) if name in sharded
            else t.detach().cpu().clone() for name, t in tensors.items()}


def full_state(model: nn.Module, opt_state, grid) -> tuple:
    """(the whole parameters, the whole momentum or ()) on the host of
    every rank of the model row: the checkpoint's and the oracle's."""
    params = gather_full(dict(model.named_parameters()), grid.model)
    mom = opt_state.momentum
    return params, (gather_full(mom, grid.model) if mom else ())
