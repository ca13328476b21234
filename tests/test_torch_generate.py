"""The port's k/v-cache generation against the JAX package, on the CPU:
``tests/test_generate.py``'s dense cases, plus the JAX ``generate`` itself.

The decode path must reproduce the training forward: greedy tokens equal
the argmax of the full forward recomputed over each prefix, and the JAX
package's greedy tokens on the same flax weights; a prompt fed in two
chunks gives the full forward's logits at 2e-5 (the offset causal mask);
batch rows decode independently; sampling is seeded (torch's generator,
so its tokens are the port's own); a ``top_k`` past V is no truncation;
overflow and bad arguments raise; and the CLI decodes a checkpoint as the
root ``generate.py`` does.
"""

import io
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import generate as jax_generate_cli  # noqa: E402  the root generate.py
from ps_pytorch_tpu.models.generate import generate as jax_generate
from ps_pytorch_tpu.models.transformer import TransformerLM as JaxLM
from ps_pytorch_tpu_torch import config
from ps_pytorch_tpu_torch import generate as generate_cli
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.generate import generate
from ps_pytorch_tpu_torch.models.transformer import (
    DecodeCache, TransformerLM,
)
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer
from test_torch_train import two_torch_threads  # noqa: F401

GEO = dict(vocab=61, d_model=32, n_layers=2, n_heads=4)


def _params(max_seq_len=64, seed=0):
    m = JaxLM(vocab_size=GEO["vocab"], d_model=GEO["d_model"],
              n_layers=GEO["n_layers"], n_heads=GEO["n_heads"],
              max_seq_len=max_seq_len)
    return jax.device_get(m.init(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32),
        positions=jnp.arange(8))["params"])


def _model(max_seq_len=64, seed=0) -> TransformerLM:
    model = TransformerLM(vocab_size=GEO["vocab"], d_model=GEO["d_model"],
                          n_layers=GEO["n_layers"], n_heads=GEO["n_heads"],
                          max_seq_len=max_seq_len)
    model.load_state_dict(convert.from_jax(_params(max_seq_len, seed)))
    return model


def _prompt(seed, shape):
    return np.random.default_rng(seed).integers(0, GEO["vocab"], shape)


@torch.no_grad()
def _greedy_via_full_forward(model, prompt, n_new):
    """Oracle: the training forward over the whole prefix for every new
    token; argmax of the last position."""
    toks = torch.as_tensor(prompt).long()
    for _ in range(n_new):
        nxt = model(toks)[:, -1].argmax(-1)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    return toks


def test_greedy_decode_matches_full_forward():
    model, prompt = _model(), _prompt(1, (2, 9))
    out = generate(model, prompt, n_new=7, temperature=0.0)
    assert out.shape == (2, 16)
    assert torch.equal(out, _greedy_via_full_forward(model, prompt, 7))


def test_greedy_decode_matches_jax_token_for_token():
    prompt = _prompt(3, (2, 5))
    want = jax_generate(_params(), jnp.asarray(prompt, jnp.int32), n_new=20,
                        max_seq_len=64, temperature=0.0, **GEO)
    got = generate(_model(), prompt, n_new=20, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batch_rows_decode_independently():
    model, p = _model(), _prompt(2, (2, 6))
    both = generate(model, p, n_new=5, temperature=0.0)
    for i in range(2):
        solo = generate(model, p[i:i + 1], n_new=5, temperature=0.0)
        assert torch.equal(both[i], solo[0])


def test_sampling_seeded_and_shaped():
    model, prompt = _model(), np.zeros((1, 4), np.int64)
    kw = dict(n_new=12, temperature=0.9, top_k=8)
    a = generate(model, prompt, seed=3, **kw)
    b = generate(model, prompt, seed=3, **kw)
    c = generate(model, prompt, seed=4, **kw)
    assert a.shape == (1, 16) and a.dtype == torch.int64
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0 <= int(a.min()) and int(a.max()) < GEO["vocab"]


def test_chunked_prefill_matches_full_forward():
    """Two chunks (S=5 at offset 0, S=4 at offset 5) through the cache
    give the training forward's logits at every position: query t at
    offset i sees slots <= i + t."""
    model = _model()
    toks = torch.as_tensor(_prompt(7, (2, 9))).long()
    cache = DecodeCache(model, 2, 9)
    with torch.no_grad():
        out1 = model(toks[:, :5], positions=torch.arange(5), cache=cache)
        out2 = model(toks[:, 5:], positions=torch.arange(5, 9), cache=cache)
        full = model(toks)
    assert cache.blocks[0].idx == 9
    np.testing.assert_allclose(torch.cat([out1, out2], 1).numpy(),
                               full.numpy(), rtol=2e-5, atol=2e-5)


def test_top_k_past_vocab_is_no_truncation():
    model, prompt = _model(), np.zeros((1, 4), np.int64)
    kw = dict(n_new=6, temperature=0.9, seed=5)
    big = generate(model, prompt, top_k=GEO["vocab"] + 39, **kw)
    exact = generate(model, prompt, top_k=GEO["vocab"], **kw)
    assert torch.equal(big, exact)


@pytest.mark.parametrize("kw,match", [
    (dict(prompt=np.zeros((1, 10), np.int64), n_new=10), "exceeds"),
    (dict(prompt=np.zeros((1, 0), np.int64), n_new=2), "non-empty"),
    (dict(prompt=np.zeros((1, 3), np.int64), n_new=0), "n_new"),
    (dict(prompt=np.zeros((1, 3), np.int64), n_new=2, top_k=-1), "top_k"),
])
def test_overflow_and_bad_arguments_rejected(kw, match):
    prompt = kw.pop("prompt")
    with pytest.raises(ValueError, match=match):
        generate(_model(max_seq_len=16), prompt, temperature=0.0, **kw)


def test_cli_decodes_a_checkpoint_like_the_jax_cli(tmp_path):
    """``python -m ps_pytorch_tpu_torch.generate --device cpu`` on a
    port checkpoint: the JSON line, then the greedy text, both equal to
    the root ``generate.py``'s on the same checkpoint."""
    td = str(tmp_path / "td")
    LMTrainer(config.TrainConfig(
        lm_vocab=256, lm_d_model=32, lm_layers=2, lm_heads=4, lm_seq_len=32,
        batch_size=4, lm_corpus_tokens=4000, lr=0.1, momentum=0.9,
        max_steps=2, eval_freq=2, resume=False, train_dir=td),
        device="cpu", printer=lambda line: None).train()
    assert ckpt.committed_steps(td) == [2]
    argv = ["--train-dir", td, "--prompt", "def ", "--n-new", "12",
            "--temperature", "0"]
    outs = []
    for main, extra in ((generate_cli.main, ["--device", "cpu"]),
                        (jax_generate_cli.main, [])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(argv + extra) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].splitlines()[0] == \
        '{"step": 2, "prompt_bytes": 4, "generated_bytes": 12}'
    with pytest.raises(SystemExit):
        generate_cli.main(["--train-dir", td, "--prompt", "x" * 30,
                           "--n-new", "8", "--device", "cpu"])
