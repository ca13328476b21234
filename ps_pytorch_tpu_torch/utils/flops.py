"""The model's work a training step: the counterpart of the JAX package's
``utils/flops.py``, and the numerator of ``mfu``.

``training_flops`` counts the matmul and conv FLOPs of one forward, the
cross-entropy and the backward with respect to the parameters, at the
global batch, by the JAX package's rules (``flops.py:31-56``):

- a matmul of [m, k] by [k, n] costs 2*m*k*n (its batch dims multiply);
- a conv costs 2 * prod(out) * Cin_per_group * taps / prod(lhs_dilation),
  applied to each of the three convs XLA emits: the forward, the weight
  gradient (the same count) and the input gradient. XLA's input gradient
  is a conv over the cotangent dilated by the stride, whose output is the
  input's shape: 2 * prod(input) * Co * taps / prod(stride). For a VALID
  conv that counts the taps over the padded cotangent (LeNet's 5x5 conv2:
  7.2 MFLOP an image where the useful work is 3.2);
- the first layer has no input gradient: the images take none;
- elementwise ops, reductions, pooling, BatchNorm, Dropout and the
  optimizer count nothing;
- the MoE LM (``models/moe.py``) gathers its tokens into the experts'
  slots and gathers the outputs back, which counts nothing here; the JAX
  ``MoEMLP`` computes both as one-hot einsums (``moe.py:126, 166``),
  ``2 * T * E * C * D`` each, the dispatch once forward and once backward
  and the combine once forward and twice backward: ``10 * T * E * C * D``
  a layer, added to the count. At the LM's full width with 8 experts
  this is most of the step's count (by this module: 13.7 of 19.9 TFLOP
  at global batch 8 x 2048 in one capacity group, 6.9 of 13.0 in two, as
  ep on two ranks dispatches it), work the port's step does not do.

The count is of the model's work, not of the kernels that run: the model
is built with the library route (``conv_impl="xla"``, full attention for
the LM) on the ``meta`` device, so nothing executes, no memory is taken,
and the number is the same whatever route the run takes. The JAX package
counts through a Pallas kernel's program once instead of once a grid
program, which understates its ``--conv-impl pallas`` and flash counts;
the port holds every route to the JAX xla / full-attention count.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten


def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


class FlopCounter(TorchDispatchMode):
    """Adds up the FLOPs of the matmuls and convs that run inside it
    (forward and backward), by the JAX package's rules. Every other op
    counts nothing."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = func.overloadpacket
        if op is _aten.mm:
            a, b = args[0], args[1]
            self.flops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        elif op is _aten.addmm:
            a, b = args[1], args[2]
            self.flops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        elif op is _aten.bmm:
            a, b = args[0], args[1]
            self.flops += 2 * _prod(a.shape) * b.shape[2]
        elif op is _aten.convolution:
            # weight [Co, Cin / groups, kh, kw]
            self.flops += 2 * _prod(out.shape) * _prod(args[1].shape[1:])
        elif op is _aten.convolution_backward:
            grad_out, x, w = args[0], args[1], args[2]
            stride, groups, mask = args[4], args[9], args[10]
            if mask[0]:
                self.flops += (2 * _prod(x.shape) * (w.shape[0] // groups)
                               * _prod(w.shape[2:]) // _prod(stride))
            if mask[1]:
                self.flops += 2 * _prod(grad_out.shape) * _prod(w.shape[1:])
        return out


def _count(fn) -> int:
    with FlopCounter() as counter:
        fn()
    return counter.flops


def cnn_training_flops(network: str, batch: int,
                       sample_shape: Tuple[int, int, int],
                       num_classes: int) -> int:
    """FLOPs of one forward + cross-entropy + backward of ``network`` on
    ``batch`` images of ``sample_shape`` (H, W, C)."""
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.models.layers import Dropout

    with torch.device("meta"):
        model = build_model(network, num_classes, "float32", "xla")
        x = torch.zeros((batch,) + tuple(sample_shape))
        y = torch.zeros(batch, dtype=torch.long)
    for m in model.modules():
        if isinstance(m, Dropout):      # keeps all: a mask counts nothing
            m.mask_fn = lambda t: torch.ones_like(t, dtype=torch.bool)
    model.train()
    return _count(lambda: F.cross_entropy(model(x), y).backward())


def lm_training_flops(*, vocab: int, d_model: int, layers: int, heads: int,
                      seq_len: int, batch: int) -> int:
    """FLOPs of one forward + next-token loss + backward of the
    TransformerLM with full attention on a [batch, seq_len] batch."""
    from ps_pytorch_tpu_torch.models.transformer import TransformerLM
    from ps_pytorch_tpu_torch.parallel.sp import nexttoken_loss

    with torch.device("meta"):
        model = TransformerLM(vocab_size=vocab, n_layers=layers,
                              n_heads=heads, d_model=d_model,
                              max_seq_len=seq_len, attention_impl="full")
        tokens = torch.zeros((batch, seq_len), dtype=torch.long)
    model.train()
    return _count(lambda: nexttoken_loss(model, tokens)[0].backward())


def moe_lm_training_flops(*, vocab: int, d_model: int, layers: int,
                          heads: int, seq_len: int, batch: int,
                          experts: int, top_k: int, groups: int = 1) -> int:
    """FLOPs of one forward + next-token loss (with the load-balance
    term) + backward of the MoETransformerLM with full attention on a
    [batch, seq_len] batch dispatched in ``groups`` capacity groups, the
    JAX one-hot dispatch and combine einsums included."""
    from ps_pytorch_tpu_torch.models.moe import MoETransformerLM, capacity

    with torch.device("meta"):
        model = MoETransformerLM(vocab_size=vocab, n_layers=layers,
                                 n_heads=heads, d_model=d_model,
                                 n_experts=experts, top_k=top_k,
                                 n_groups=groups, max_seq_len=seq_len,
                                 attention_impl="full")
        tokens = torch.zeros((batch, seq_len), dtype=torch.long)
    model.train()

    def step():
        logits, aux = model(tokens)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, vocab),
                               tokens[:, 1:].reshape(-1))
        (loss + 0.01 * aux).backward()

    t = batch * seq_len
    cap = capacity(top_k, t // groups, experts, 1.25)
    return _count(step) + layers * 10 * t * experts * cap * d_model


def training_flops(cfg, batch: Optional[int] = None, groups: int = 1) -> int:
    """FLOPs of one training step of ``cfg`` (a ``TrainConfig``) at the
    global batch ``batch`` (default ``cfg.batch_size``), on the xla /
    full-attention route whatever ``cfg.conv_impl`` and
    ``cfg.lm_attention`` say; an MoE LM dispatched in ``groups`` capacity
    groups (one a rank under ep)."""
    from ps_pytorch_tpu_torch.config import LM_NETWORKS
    from ps_pytorch_tpu_torch.data.datasets import sample_shape

    batch = cfg.batch_size if batch is None else batch
    if cfg.network == "MoETransformerLM":
        return moe_lm_training_flops(
            vocab=cfg.lm_vocab, d_model=cfg.lm_d_model, layers=cfg.lm_layers,
            heads=cfg.lm_heads, seq_len=cfg.lm_seq_len, batch=batch,
            experts=cfg.lm_experts, top_k=cfg.lm_moe_top_k, groups=groups)
    if cfg.network in LM_NETWORKS:
        return lm_training_flops(vocab=cfg.lm_vocab, d_model=cfg.lm_d_model,
                                 layers=cfg.lm_layers, heads=cfg.lm_heads,
                                 seq_len=cfg.lm_seq_len, batch=batch)
    return cnn_training_flops(cfg.network, batch, sample_shape(cfg.dataset),
                              cfg.num_classes)


# Peak dense bf16 FLOP/s of one card, by a substring of
# ``torch.cuda.get_device_name`` (matched case-insensitively). NVIDIA's
# H100 data sheet, SXM part at its 700 W limit: 989 TFLOP/s bf16 dense
# (without sparsity). "H100 80GB HBM3" is the name the SXM part reports.
_PEAK_BF16 = (
    ("h100 80gb hbm3", 989e12),
    ("h100 sxm", 989e12),
)


def peak_flops_bf16(device_name: str) -> Optional[float]:
    """Peak bf16 FLOP/s of the card named ``device_name``; None for an
    unknown name or the CPU, so that ``mfu`` reads as null rather than a
    fiction."""
    name = (device_name or "").lower()
    for sub, peak in _PEAK_BF16:
        if sub in name:
            return peak
    return None
