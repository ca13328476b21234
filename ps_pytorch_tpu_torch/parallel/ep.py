"""Expert parallelism for the MoE LM: the JAX package's ``parallel/ep.py``
(``ep_param_specs`` ``:40-46``, ``make_ep_train_step`` ``:88-141``).

The stacked experts of ``models/moe.py:MoETransformerLM`` are sharded
along their leading [n_experts] axis over one axis of the rank grid
(``parallel/mesh.py``), the DeepSpeed-MoE layout where the expert group
is the data group: every rank holds its rows of the batch and E / n
experts. Each rank is one dispatch group; inside each MoE layer one
``all_to_all`` sends the slots of every expert to the rank that holds it
and another brings the outputs back (``parallel/collectives.py``).
Everything else (router, attention, embeddings) is replicated.

The step differentiates the LOCAL loss, the cross-entropy sum plus
``aux_coef * aux * count`` (``aux_coef`` 0.01, as the LM trainer passes
none), with no collective inside it. An expert's gradient is then whole on
its rank, since the all-to-all's backward brought every visiting token's
contribution: it is divided by the global token count and not reduced.
The replicated gradients are summed over the axis in one flat buffer and
divided by the same count; then SGD. The loss reported is the summed
cross-entropy over the global count, ``aux`` the mean over ranks (one
all-reduce of both). The SGD momentum of an expert is built from the
shard, so it is sharded the same way. Every rank runs both all-to-alls
of every layer at the fixed [E, C, D] shape whatever its routing, and
``remat`` recomputes with checkpoint early stop off, so no rank waits on a
collective another rank skips.
"""

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ps_pytorch_tpu_torch.models.convert import ep_shard, ep_shard_dim
from ps_pytorch_tpu_torch.parallel.collectives import (
    all_reduce_, all_reduce_flat_,
)
from ps_pytorch_tpu_torch.parallel.tp import gather_full

AUX_COEF = 0.01


def is_expert(name: str) -> bool:
    return ep_shard_dim(name) is not None


def shard_model_(model: nn.Module, axis) -> nn.Module:
    """Replace each MoE layer's experts of a whole ``MoETransformerLM`` by
    this rank's slice of them, in place, and bind the layers to
    ``axis``."""
    if model.n_experts % axis.size:
        raise ValueError(f"{model.n_experts} experts not divisible over "
                         f"{axis.size} devices")
    for mlp in model.moe_layers():
        for name, p in list(mlp.named_parameters(recurse=False)):
            if is_expert(name):
                part = ep_shard(name, p.detach(), axis.index, axis.size)
                setattr(mlp, name, nn.Parameter(part.clone()))
        mlp.axis = axis
    return model


class EPTrainStep:
    """``step(tokens) -> {"loss", "aux"}`` over this rank's [B_local, S]
    rows; ``model`` is sharded by ``shard_model_`` over ``axis``,
    ``opt_state`` mirrors it."""

    def __init__(self, model: nn.Module, opt, axis,
                 aux_coef: float = AUX_COEF):
        self.model, self.opt, self.axis = model, opt, axis
        self.aux_coef = aux_coef
        self.device = next(model.parameters()).device
        self.params: Dict[str, nn.Parameter] = dict(model.named_parameters())
        self.opt_state = opt.init(self.params)
        self.replicated = [p for k, p in self.params.items()
                           if not is_expert(k)]

    def __call__(self, tokens) -> Dict[str, torch.Tensor]:
        tokens = torch.as_tensor(np.asarray(tokens)).to(self.device).long()
        self.model.train()
        for p in self.params.values():
            p.grad = None
        logits, aux = self.model(tokens)
        per = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                              tokens[:, 1:].reshape(-1), reduction="none")
        ce_sum = per.sum()
        (ce_sum + self.aux_coef * aux * per.numel()).backward()
        total = float(per.numel() * self.axis.size)
        with torch.no_grad():
            for k, p in self.params.items():
                if is_expert(k):
                    p.grad.div_(total)
            all_reduce_flat_([p.grad for p in self.replicated], self.axis,
                             total)
            sums = all_reduce_(torch.stack([ce_sum.detach(), aux.detach()]),
                               self.axis)
            self.opt_state = self.opt.apply(
                self.params, self.opt_state,
                {k: p.grad for k, p in self.params.items()})
        return {"loss": sums[0] / total, "aux": sums[1] / self.axis.size}


def full_state(model: nn.Module, opt_state, axis) -> tuple:
    """(the whole parameters, the whole momentum or ()) on the host of
    every rank of ``axis``: the checkpoint's and the evaluation's."""
    params = gather_full(dict(model.named_parameters()), axis, ep_shard_dim)
    mom = opt_state.momentum
    return params, (gather_full(mom, axis, ep_shard_dim) if mom else ())
