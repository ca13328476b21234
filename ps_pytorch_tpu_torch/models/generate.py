"""Autoregressive generation for the TransformerLM and the
MoETransformerLM: the JAX package's ``models/generate.py``.

One prefill of the whole prompt fills a fixed-length k/v cache a block
(``models/transformer.py:DecodeCache``), then one token a step, each step
one forward of one token over the cache. Plain torch, as the JAX decode
path is ``jnp`` outside any Pallas kernel.

    from ps_pytorch_tpu_torch.models.generate import generate
    out = generate(model, prompt, n_new=64, temperature=0.8, top_k=40,
                   seed=0)

``prompt``: int [B, S0]; returns int64 [B, S0 + n_new] on the model's
device. Any training checkpoint decodes as it is. An MoE model
dispatches each token as its own capacity group (``models/moe.py``), so
no assignment drops and batch rows decode independently. Greedy decoding
(``temperature=0``) is the JAX package's token for token; sampling draws
from a ``torch.Generator`` seeded by ``seed``, not from threefry, so its
tokens are the port's own (ROADMAP.md, "RNG").
"""

import numpy as np
import torch

from ps_pytorch_tpu_torch.models.moe import logits_of
from ps_pytorch_tpu_torch.models.transformer import DecodeCache


def _sample(logits: torch.Tensor, generator: torch.Generator,
            temperature: float, top_k: int) -> torch.Tensor:
    """logits [B, V] -> tokens [B]; temperature 0 is greedy. ``top_k``
    past V is no truncation."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    top_k = min(top_k, logits.shape[-1])
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


@torch.no_grad()
def generate(model, prompt, *, n_new: int, temperature: float = 1.0,
             top_k: int = 0, seed: int = 0) -> torch.Tensor:
    """Generate ``n_new`` tokens after ``prompt`` with a k/v cache.

    The cache and the positions stop at the model's positional table
    (``max_seq_len``, the checkpoint's ``--lm-seq-len``): a prompt and
    ``n_new`` longer than it raise, as do an empty prompt, ``n_new < 1``
    and ``top_k < 0``."""
    device = model.tok_embed.embedding.device
    prompt = torch.as_tensor(np.asarray(prompt)).to(device).long()
    b, s0 = prompt.shape
    if s0 == 0:
        raise ValueError("prompt must be non-empty (the first sampled "
                         "token is conditioned on its last logits)")
    if n_new < 1:
        raise ValueError(f"n_new={n_new} (must be >= 1)")
    if top_k < 0:
        raise ValueError(f"top_k={top_k} (must be >= 0; 0 = no truncation)")
    total = s0 + n_new
    max_seq_len = model.pos_embed.embedding.shape[0]
    if total > max_seq_len:
        raise ValueError(f"prompt ({s0}) + n_new ({n_new}) exceeds "
                         f"max_seq_len ({max_seq_len}) — the positional "
                         f"table and cache are that long")
    training = model.training
    model.eval()
    try:
        cache = DecodeCache(model, b, total)
        logits = logits_of(model(prompt, cache=cache, positions=torch.arange(
            s0, device=device)))[:, -1]
        generator = torch.Generator(device=device).manual_seed(seed)
        out = [prompt]
        for pos in range(s0, total):
            tok = _sample(logits, generator, temperature, top_k)
            out.append(tok[:, None])
            if pos + 1 < total:     # the last token's logits are not used
                logits = logits_of(model(
                    tok[:, None], positions=torch.tensor([pos], device=device),
                    cache=cache))[:, 0]
    finally:
        model.train(training)
    return torch.cat(out, dim=1)
