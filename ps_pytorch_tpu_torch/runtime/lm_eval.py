"""The LM evaluation oracle: the JAX package's ``runtime/lm_eval.py``.

One definition of a checkpointed LM's held-out next-token loss, shared by
the standalone evaluator (``EVAL_LM``) and ``generate.py``: the
``TransformerLM`` of the checkpoint's geometry, its loss ``logits[:, :-1]``
against ``tokens[:, 1:]``, and the perplexity clamp. The JAX oracle runs
full attention; the evaluator and the trainer's tp / pp evaluation score
through flash where the kernels take the head dim (``scoring_attention``),
the same function without the [B, H, S, S] scores (2.15 GB a layer at
S 8192); ``generate.py`` and serving keep full attention.
The checkpoint's config is self-describing (``network``, the LM fields).
A pipeline-parallel checkpoint (``lm_parallelism="pp"``) stores its
blocks stage-stacked; ``restore_lm`` unstacks them, and the momentum,
into the plain model (``parallel/pp.py:plain_state_tree``, the JAX
``unstack_stage_params`` of ``lm_eval.py:55-62, 97-99``). A tensor-parallel
checkpoint is written whole. An MoE checkpoint (``network``
``MoETransformerLM``, written by ep) builds the MoE model with the
config's ``lm_moe_top_k`` (the gates and second choices change the
forward, not the parameters' shapes), one capacity group and full
attention, as the JAX oracle; its loss is the logits', not the
load-balance term's. The trainer's own ep evaluation asks for one group a
rank and its attention kernel (``LMTrainer.evaluate``).
"""

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ps_pytorch_tpu_torch.models.convert import state_from_jax
from ps_pytorch_tpu_torch.models.moe import MoETransformerLM, logits_of
from ps_pytorch_tpu_torch.models.transformer import (
    TransformerLM, migrate_packed_qkv,
)
from ps_pytorch_tpu_torch.ops.flash_attention import MAX_HEAD_DIM
from ps_pytorch_tpu_torch.optim import SGD, build_schedule
from ps_pytorch_tpu_torch.optim.sgd import SGDState
from ps_pytorch_tpu_torch.parallel.pp import plain_state_tree


def perplexity(loss: float) -> float:
    """``exp(min(loss, 30))`` in f32, as the JAX package's ``jnp.exp``."""
    return float(np.exp(np.float32(min(loss, 30.0))))


def lm_geometry(cfg) -> dict:
    return dict(vocab_size=cfg.lm_vocab, d_model=cfg.lm_d_model,
                n_layers=cfg.lm_layers, n_heads=cfg.lm_heads,
                max_seq_len=cfg.lm_seq_len)


def scoring_attention(cfg) -> str:
    """The attention a checkpoint's loss is scored through: for the dense
    LM the port's flash op (the hand-written kernels on CUDA, their plain
    version on the CPU), which holds no [S, S] scores, wherever the
    kernels take the head dim (a multiple of 8 up to ``MAX_HEAD_DIM``);
    else, and for the MoE LM, full attention. Chosen by shape, never by
    catching a failure."""
    head_dim = cfg.lm_d_model // cfg.lm_heads
    if cfg.network == "MoETransformerLM" or head_dim % 8 \
            or head_dim > MAX_HEAD_DIM:
        return "full"
    return "flash"


def _refuse_unresolved(cfg) -> None:
    if cfg.lm_parallelism == "pp" and cfg.lm_model_axis <= 0:
        raise ValueError(
            "pp checkpoint config has unresolved lm_model_axis=0 "
            "(written before stage counts were recorded) — evaluate "
            "in-trainer or pass the stage count explicitly")


def build_lm_oracle(cfg, device="cpu", n_groups: int = 1,
                    attention_impl: str = "full"
                    ) -> Tuple[torch.nn.Module, Callable[[np.ndarray], float]]:
    """-> (the model of the checkpoint's geometry on ``device``: the
    ``TransformerLM``, or the ``MoETransformerLM`` of ``lm_experts`` and
    ``lm_moe_top_k`` in ``n_groups`` capacity groups; full attention
    unless told otherwise; and ``loss_fn(tokens [B, S]) -> mean next-token
    loss``). Put a checkpoint into the model with ``restore_lm``: its
    weights are drawn on ``device`` and only stand in until then (on the
    host, the MoE LM's 177M draws take seconds)."""
    _refuse_unresolved(cfg)
    with torch.device(device):
        if cfg.network == "MoETransformerLM":
            model = MoETransformerLM(n_experts=cfg.lm_experts,
                                     top_k=cfg.lm_moe_top_k,
                                     n_groups=n_groups,
                                     attention_impl=attention_impl,
                                     **lm_geometry(cfg))
        else:
            model = TransformerLM(attention_impl=attention_impl,
                                  **lm_geometry(cfg))
    model.eval()

    @torch.no_grad()
    def loss_fn(tokens) -> float:
        t = torch.as_tensor(np.asarray(tokens)).to(device).long()
        logits = logits_of(model(t))
        return float(F.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]),
            t[:, 1:].reshape(-1)))

    return model, loss_fn


def build_lm_template(cfg, model: torch.nn.Module) -> SGDState:
    """The optimizer state ``LMTrainer`` builds for ``model`` (plain SGD
    with the run's momentum): with the model, the training state a
    checkpoint's tree must fit, as the JAX template ``TrainState``."""
    _refuse_unresolved(cfg)
    opt = SGD(lr=build_schedule(cfg), momentum=cfg.momentum,
              weight_decay=cfg.weight_decay, nesterov=cfg.nesterov)
    return opt.init(dict(model.named_parameters()))


def restore_lm(tree: dict, model, opt_state: Optional[SGDState] = None,
               step: Optional[int] = None,
               local=None) -> Tuple[Optional[SGDState], int]:
    """``state_from_jax`` of an LM checkpoint's tree (a pp tree
    unstacked first) into ``model``, a ``TransformerLM`` or a rank's part
    of one (``local``: ``state_from_jax``'s); a tree in the layout before
    the q/k/v split that does not fit is migrated (``migrate_packed_qkv``)
    and put in again, as the JAX ``load_checkpoint(..., migrate=...)``
    does."""
    tree = plain_state_tree(tree)
    try:
        return state_from_jax(tree, model, opt_state, local=local)
    except (ValueError, KeyError):
        migrated, n_changed = migrate_packed_qkv(tree)
        if not n_changed:
            raise
        out = state_from_jax(migrated, model, opt_state, local=local)
        at = "" if step is None else f" at step {step}"
        print(f"[ckpt] migrated legacy checkpoint layout{at} "
              f"({n_changed} tree nodes rewritten)")
        return out
