"""The GPipe pipeline for the TransformerLM: the JAX package's
``parallel/pp.py`` (``stack_stage_params`` / ``unstack_stage_params``
``:50-81``, the edges ``:92-107``, ``_apply_stage`` ``:110-124``,
``make_pp_train_step`` ``:193-320``).

The blocks are split into ``S`` equal stages along the ``model`` axis of
the grid (``parallel/mesh.py``); rank ``(d, s)`` holds stage ``s``
(``PipelineStage``: blocks ``s*per .. s*per+per-1`` under their global
names) and the edges, the embeddings, ``ln_f`` and ``lm_head``, which
every stage holds and updates alike, as the JAX package replicates them.
The batch is sharded over ``data`` and every stage of a data row takes the
same rows: stage 0 embeds them, the last stage needs their targets.

The step runs the GPipe schedule of ``M`` microbatches over ``S`` stages:
at tick ``t`` stage ``s`` works on microbatch ``t - s``; a bubble tick
computes nothing. A stage's output goes to the next stage by one send /
receive hop; when every microbatch has gone forward, the backward runs the
microbatches in reverse, and each stage sends the gradient of each
microbatch's input back to the stage before it. The loss is a local sum,
nonzero on the last stage only (no collective inside it, as in the JAX
step); the block gradients are summed over ``data``, the edge gradients
over ``model`` and ``data`` (a stage that does not touch an edge gives
zeros), and everything is divided by the global token count.
``--remat`` recomputes each block in the backward; with ``--lm-attention
flash`` each stage's blocks run the hand-written flash kernels, ``per x M``
forward launches a step (doubled under remat) and ``per x M`` dq and dk/dv
launches.

A checkpoint holds the JAX layout: ``blocks`` stacked [n_stages,
layers_per_stage, ...] beside the edges, the momentum mirrored
(``stack_state_tree``).
"""

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ps_pytorch_tpu_torch.parallel.collectives import (
    all_gather_host, all_reduce_, all_reduce_flat_, recv, send,
)

EDGES = ("tok_embed", "pos_embed", "ln_f", "lm_head")


def _map_leaves(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_leaves(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def stack_stage_params(params: dict, n_stages: int) -> dict:
    """TransformerLM tree (nested dicts of arrays) -> the pp tree:
    ``blocks`` with every leaf stacked [n_stages, layers_per_stage, ...],
    the other entries untouched."""
    n_layers = len([k for k in params if k.startswith("block_")])
    if n_layers == 0 or n_layers % n_stages:
        raise ValueError(f"{n_layers} blocks not divisible into "
                         f"{n_stages} stages")
    per = n_layers // n_stages
    blocks = [params[f"block_{i}"] for i in range(n_layers)]
    stacked = _map_leaves(
        lambda *leaves: np.stack([np.asarray(a) for a in leaves]).reshape(
            (n_stages, per) + np.shape(leaves[0])), *blocks)
    out = {k: v for k, v in params.items() if not k.startswith("block_")}
    out["blocks"] = stacked
    return out


def unstack_stage_params(pp_params: dict) -> dict:
    """Inverse of ``stack_stage_params``."""
    stacked = pp_params["blocks"]
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    n_stages, per = np.shape(leaf)[:2]
    out = {k: v for k, v in pp_params.items() if k != "blocks"}
    for s in range(n_stages):
        for layer in range(per):
            out[f"block_{s * per + layer}"] = _map_leaves(
                lambda a: np.asarray(a)[s, layer], stacked)
    return out


def _moment_fields(opt_state: dict):
    return [k for k, v in opt_state.items() if isinstance(v, dict) and v]


def stack_state_tree(tree: dict, n_stages: int) -> dict:
    """A TrainState dict in the plain layout -> the pp layout: the params
    and every moment tree of the optimizer state stacked."""
    opt = dict(tree["opt_state"])
    for field in _moment_fields(opt):
        opt[field] = stack_stage_params(opt[field], n_stages)
    return dict(tree, params=stack_stage_params(tree["params"], n_stages),
                opt_state=opt)


def plain_state_tree(tree: dict) -> dict:
    """A TrainState dict in either layout -> the plain TransformerLM
    layout (a pp checkpoint's blocks unstacked, its moments too)."""
    if "blocks" not in tree.get("params", {}):
        return tree
    opt = dict(tree.get("opt_state", {}))
    for field in _moment_fields(opt):
        if "blocks" in opt[field]:
            opt[field] = unstack_stage_params(opt[field])
    return dict(tree, params=unstack_stage_params(tree["params"]),
                opt_state=opt)


class PipelineStage(nn.Module):
    """Stage ``stage`` of ``n_stages`` of a ``TransformerLM``: the model's
    own edge modules and its blocks of this stage, sharing their
    parameters with the model they came from."""

    def __init__(self, model: nn.Module, stage: int, n_stages: int):
        super().__init__()
        if model.n_layers % n_stages:
            raise ValueError(f"{model.n_layers} blocks not divisible into "
                             f"{n_stages} stages")
        per = model.n_layers // n_stages
        self.stage, self.n_stages, self.per = stage, n_stages, per
        self.attention_impl = model.attention_impl
        self.remat = model.remat
        for name in EDGES:
            self.add_module(name, getattr(model, name))
        self.block_ids = list(range(stage * per, (stage + 1) * per))
        for i in self.block_ids:
            self.add_module(f"block_{i}", getattr(model, f"block_{i}"))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        return self.tok_embed(tokens) + self.pos_embed(positions)[None]

    def blocks(self, x: torch.Tensor) -> torch.Tensor:
        for i in self.block_ids:
            block = getattr(self, f"block_{i}")
            x = checkpoint(block, x, use_reentrant=False) \
                if self.remat and torch.is_grad_enabled() else block(x)
        return x

    def head_loss_sum(self, y: torch.Tensor,
                      tokens: torch.Tensor) -> torch.Tensor:
        logits = self.lm_head(self.ln_f(y)).float()
        v = logits.shape[-1]
        return F.cross_entropy(logits[:, :-1].reshape(-1, v),
                               tokens[:, 1:].reshape(-1), reduction="sum")


def check_stage(stage: PipelineStage, n_stages: int) -> None:
    """The JAX step's refusals for a stage and a grid."""
    if stage.attention_impl not in ("full", "flash"):
        raise ValueError("PP step requires attention_impl='full'|'flash'")
    if stage.n_stages != n_stages:
        raise ValueError(
            f"state was stacked for {stage.n_stages} stages but the mesh's "
            f"'model' axis has {n_stages} — rebuild the state with "
            f"n_stages={n_stages}")


class PPTrainStep:
    """``step(tokens) -> {"loss"}`` over the [B_local, S] rows of this
    rank's data row; ``stage`` is this rank's ``PipelineStage``."""

    def __init__(self, stage: PipelineStage, opt, grid,
                 num_microbatches: int):
        check_stage(stage, grid.model.size)
        self.stage, self.opt, self.grid = stage, opt, grid
        self.m = num_microbatches
        self.device = next(stage.parameters()).device
        self.params: Dict[str, nn.Parameter] = dict(stage.named_parameters())
        self.opt_state = opt.init(self.params)

    def __call__(self, tokens) -> Dict[str, torch.Tensor]:
        tokens = torch.as_tensor(np.asarray(tokens)).to(self.device).long()
        b, seq = tokens.shape
        M, st = self.m, self.stage
        if b % M:
            raise ValueError(f"local batch {b} not divisible into "
                             f"{M} microbatches")
        s_idx, n_stages = self.grid.model.index, self.grid.model.size
        last = s_idx == n_stages - 1
        micro = tokens.reshape(M, b // M, seq)
        axis = self.grid.model
        st.train()
        for p in self.params.values():
            p.grad = None
        like = None
        inputs: List[torch.Tensor] = [None] * M
        outputs: List[torch.Tensor] = [None] * M
        pending = []
        loss_sum = torch.zeros((), device=self.device)
        for t in range(M + n_stages - 1):            # forward ticks
            j = t - s_idx
            if not 0 <= j < M:
                continue                             # a bubble tick
            if s_idx == 0:
                x = st.embed(micro[j])
            else:
                if like is None:
                    like = torch.empty(b // M, seq, st.ln_f.weight.shape[0],
                                       device=self.device)
                x = recv(like, axis, s_idx - 1).requires_grad_()
            y = st.blocks(x)
            inputs[j] = x
            if last:
                outputs[j] = st.head_loss_sum(y, micro[j])
                loss_sum = loss_sum + outputs[j].detach()
            else:
                outputs[j] = y
                pending.append(send(y, axis, s_idx + 1))
        for handle in pending:
            handle.wait()
        pending = []
        for j in reversed(range(M)):                 # backward
            if last:
                outputs[j].backward()
            else:
                outputs[j].backward(recv(outputs[j], axis, s_idx + 1))
            if s_idx > 0:
                pending.append(send(inputs[j].grad, axis, s_idx - 1))
            inputs[j] = outputs[j] = None
        for handle in pending:
            handle.wait()
        total = float(b * self.grid.data.size * (seq - 1))
        with torch.no_grad():
            for p in self.params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            blocks = [p.grad for k, p in self.params.items()
                      if k.startswith("block_")]
            edges = [p.grad for k, p in self.params.items()
                     if not k.startswith("block_")]
            all_reduce_flat_(blocks, self.grid.data, total)
            all_reduce_flat_(edges, self.grid.world, total)
            loss = all_reduce_(loss_sum, self.grid.world)
            self.opt_state = self.opt.apply(
                self.params, self.opt_state,
                {k: p.grad for k, p in self.params.items()})
        return {"loss": loss / total}


def gather_stages(tensors: Dict[str, torch.Tensor], stage: PipelineStage,
                  axis) -> Dict[str, torch.Tensor]:
    """Name -> this stage's tensor (parameters, or a mirror of them such as
    the momentum) -> name -> tensor for the whole model, on the host of
    every rank of ``axis`` (each takes part): the stages' blocks gathered,
    the edges this stage's (every stage holds the same)."""
    out = {k: t.detach().cpu().clone() for k, t in tensors.items()
           if not k.startswith("block_")}
    mine = [(k, t) for k, t in tensors.items() if k.startswith("block_")]
    flat = torch.cat([t.detach().reshape(-1) for _, t in mine])
    per = stage.per
    for s, got in enumerate(all_gather_host(flat, axis)):
        offset = 0
        for k, t in mine:
            i, rest = k.split(".", 1)
            glob = int(i[len("block_"):]) - stage.stage * per + s * per
            n = t.numel()
            out[f"block_{glob}.{rest}"] = got[offset:offset + n].view(
                t.shape).clone()
            offset += n
    return out


def full_state(stage: PipelineStage, opt_state, grid) -> tuple:
    """(the whole model's parameters, its momentum or ()) on the host of
    every rank of the model row."""
    params = gather_stages(dict(stage.named_parameters()), stage, grid.model)
    mom = opt_state.momentum
    return params, (gather_stages(mom, stage, grid.model) if mom else ())
