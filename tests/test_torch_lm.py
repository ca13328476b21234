"""The port's LM training slice against the JAX package, on the CPU.

Token streams and batches byte for byte; ``TransformerLM`` logits from the
same flax weights (carried by ``models/convert.py``) at 1e-5, with full and
flash attention; two SGD steps (losses and every parameter at 1e-4) and the
eval loss against ``create_lm_train_state`` + ``make_sp_train_step`` /
``make_sp_eval_fn`` over a ONE-device mesh (``tests/conftest.py`` gives 8 CPU
devices, over which the JAX LM shards the sequence and refuses flash). The
JAX flash path runs its Pallas kernels in interpret mode.
"""

import dataclasses
import functools
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.data import text as jax_text
from ps_pytorch_tpu.models import transformer as jax_transformer
from ps_pytorch_tpu.optim import build_schedule as jax_build_schedule
from ps_pytorch_tpu.optim.sgd import sgd as jax_sgd
from ps_pytorch_tpu.parallel import sp as jax_sp
from ps_pytorch_tpu.runtime import metrics as jax_metrics
from ps_pytorch_tpu_torch import config, train_lm
from ps_pytorch_tpu_torch.data import text
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.optim import SGD, build_schedule
from ps_pytorch_tpu_torch.parallel.sp import LMTrainStep, make_lm_eval_fn
from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer
from test_torch_train import two_torch_threads  # noqa: F401

# A small LM: head dim 16, one 64-row tile of the sequence.
LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, max_seq_len=64)
B, S = 2, 64
LOGIT_TOL, STEP_TOL = 1e-5, 1e-4


def _cfg(mod, **kw):
    base = dict(eval_freq=0, batch_size=B, lr=0.1, momentum=0.9,
                weight_decay=1e-4, lm_vocab=LM["vocab_size"],
                lm_d_model=LM["d_model"], lm_layers=LM["n_layers"],
                lm_heads=LM["n_heads"], lm_seq_len=S,
                lm_corpus_tokens=4000, resume=False)
    base.update(kw)
    return mod.TrainConfig(**base)


def _tokens(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, LM["vocab_size"], (B, S)).astype(np.int32)
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _flax_params(seed=0):
    m = jax_transformer.TransformerLM(**LM)
    v = m.init(jax.random.key(seed), jnp.zeros((1, S), jnp.int32))
    return jax.device_get(v["params"])


def _port(impl, params):
    model = TransformerLM(attention_impl=impl, **LM)
    model.load_state_dict(convert.from_jax(params), strict=True)
    return model


def _assert_tree_close(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], tol)
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=tol,
                                       atol=tol, err_msg=k)


# --------------------------------------------------------------- data --

def test_token_streams_and_batches_match_jax_bytes():
    for vocab, seed in ((256, 0), (32000, 42)):
        a = text.synthetic_tokens(5000, vocab, seed)
        assert a.tobytes() == jax_text.synthetic_tokens(5000, vocab,
                                                        seed).tobytes()
    cfg, jcfg = _cfg(config), _cfg(jax_config)
    ours, theirs = text.lm_streams(cfg), jax_text.lm_streams(jcfg)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    la = text.TokenLoader(ours[0], 4, 32, seed=7)
    lb = jax_text.TokenLoader(theirs[0], 4, 32, seed=7)
    for _ in range(2 * len(la) + 3):           # across epoch boundaries
        assert la.next_batch().tobytes() == lb.next_batch().tobytes()
    va = text.TokenLoader(ours[1], 2, 32, shuffle=False)
    vb = jax_text.TokenLoader(theirs[1], 2, 32, shuffle=False)
    assert [x.tobytes() for x in va.epoch(0)] == \
        [x.tobytes() for x in vb.epoch(0)]


def test_tokens_from_file_match_jax(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(range(256)) * 9)
    assert text.tokens_from_file(str(path), 256, 1000).tobytes() == \
        jax_text.tokens_from_file(str(path), 256, 1000).tobytes()
    with pytest.raises(ValueError, match="vocab"):
        text.tokens_from_file(str(path), 64)


# -------------------------------------------------------------- model --

@pytest.mark.parametrize("impl", ["full", "flash"])
def test_logits_match_flax(impl):
    params = _flax_params()
    tok = _tokens(3)[0]
    want = jax_transformer.TransformerLM(attention_impl=impl, **LM).apply(
        {"params": params}, jnp.asarray(tok))
    got = _port(impl, params)(torch.from_numpy(tok).long())
    assert got.dtype == torch.float32 and got.shape == (B, S, LM["vocab_size"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_convert_round_trips_the_lm_tree():
    params = _flax_params()
    back, stats = convert.to_jax(convert.from_jax(params))
    assert stats == {}
    _assert_tree_close(back, params, 0.0)
    names = set(_port("full", params).state_dict())
    assert {"tok_embed.embedding", "pos_embed.embedding", "ln_f.weight",
            "lm_head.weight", "block_0.Dense_4.bias",
            "block_1.LayerNorm_1.weight"} <= names
    assert "block_0.Dense_0.bias" not in names


def test_port_init_has_the_flax_tree_shapes():
    params = _flax_params()
    sd = TransformerLM(**LM, generator=torch.Generator().manual_seed(0)) \
        .state_dict()
    want = convert.from_jax(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


# --------------------------------------------------------------- step --

def _jax_step_and_eval(impl, params, batches, evals):
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jcfg = _cfg(jax_config)
    model = jax_transformer.TransformerLM(attention_impl=impl,
                                          axis_name="data", **LM)
    tx = jax_sgd(lr=jax_build_schedule(jcfg), momentum=jcfg.momentum,
                 weight_decay=jcfg.weight_decay, nesterov=jcfg.nesterov)
    state = jax_sp.create_lm_train_state(model, tx, mesh, (B, S))
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          opt_state=tx.init(jax.tree.map(jnp.asarray,
                                                         params)))
    step = jax_sp.make_sp_train_step(model, tx, mesh, donate=False)
    eval_fn = jax_sp.make_sp_eval_fn(model, mesh)
    losses, trees = [], []
    for tok in batches:
        state, m = step(state, jnp.asarray(tok))
        losses.append(float(m["loss"]))
        trees.append(jax.device_get(state.params))
    return losses, trees, [float(eval_fn(state.params, jnp.asarray(t)))
                           for t in evals]


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_two_sgd_steps_and_eval_match_jax(impl):
    params = _flax_params()
    batches, evals = _tokens(5), _tokens(6)
    want_losses, want_trees, want_eval = _jax_step_and_eval(
        impl, params, batches, evals)
    model = _port(impl, params)
    cfg = _cfg(config)
    step = LMTrainStep(model, SGD(build_schedule(cfg), momentum=cfg.momentum,
                                  weight_decay=cfg.weight_decay))
    eval_fn = make_lm_eval_fn(model)
    for tok, loss, tree in zip(batches, want_losses, want_trees):
        np.testing.assert_allclose(float(step(tok)["loss"]), loss,
                                   rtol=STEP_TOL, atol=STEP_TOL)
        _assert_tree_close(convert.to_jax(model.state_dict())[0], tree,
                           STEP_TOL)
    np.testing.assert_allclose([float(eval_fn(t)) for t in evals], want_eval,
                               rtol=STEP_TOL, atol=STEP_TOL)
    assert step.opt_state.step == 2


# ------------------------------------------------------------ metrics --

def test_step_record_adds_tokens_per_sec():
    from ps_pytorch_tpu_torch.runtime.metrics import derive_step_record
    rec = derive_step_record(step_time_s=0.5, data_time_s=0.1, examples=8,
                             tokens=8 * 2048)
    assert rec["tokens_per_sec"] == 32768.0
    assert rec["examples_per_sec"] == 16.0 and rec["mfu"] is None
    assert "tokens_per_sec" not in derive_step_record(
        step_time_s=0.5, data_time_s=0.1, examples=8)


# ------------------------------------------------------------ trainer --

def test_train_lm_entry_point_on_cpu(tmp_path):
    """``python -m ps_pytorch_tpu_torch.train_lm --device cpu`` with flash:
    CONFIG, the LM line, STEP lines the JAX parser reads, falling loss on
    the learnable synthetic stream, and FINAL."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = train_lm.main([
            "--lm-attention", "flash", "--lm-d-model", "32", "--lm-layers",
            "2", "--lm-heads", "2", "--lm-vocab", "64", "--lm-seq-len", "64",
            "--batch-size", "4", "--lr", "0.3", "--momentum", "0.9",
            "--max-steps", "6", "--eval-freq", "0", "--resume", "false",
            "--lm-corpus-tokens", "20000", "--train-dir",
            str(tmp_path / "td"), "--metrics-file", str(tmp_path / "m.jsonl"),
            "--device", "cpu"])
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("CONFIG ")
    assert json.loads(lines[0][len("CONFIG "):])["lm_attention"] == "flash"
    assert lines[1].startswith("LM mesh devices=1 parallelism=sp "
                               "attention=flash seq_len=64")
    steps = [jax_metrics.parse_line(ln) for ln in lines
             if ln.startswith("STEP")]
    assert [s["step"] for s in steps] == list(range(1, 7))
    assert all(s["acc"] == 0.0 and s["participating"] == 1.0 for s in steps)
    assert steps[-1]["loss"] < steps[0]["loss"]
    final = lines[-1].split()
    assert final[:2] == ["FINAL", "lm_loss"] and final[3] == "perplexity"
    assert np.isfinite(float(final[2])) and np.isfinite(float(final[4]))
    recs = [json.loads(ln) for ln in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert all(r["tokens_per_sec"] > 0 for r in recs)


def test_auto_attention_resolves_to_full_on_one_device():
    tr = LMTrainer(_cfg(config, lm_attention="auto"), device="cpu")
    assert tr.model.attention_impl == "full"
    result = tr.evaluate(max_batches=1)
    assert result["batches"] == 1 and np.isfinite(result["perplexity"])


# Fields the LM trainer runs: remat, checkpoints, tp and pp with their
# model axis and microbatches, ep with its experts and top-k; every one of
# them builds the config the JAX package builds.
LM_RUNS = {"remat", "eval_freq", "lm_parallelism", "lm_model_axis",
           "lm_microbatches", "lm_experts", "lm_moe_top_k"}


@pytest.mark.parametrize("field,value", [
    ("lm_parallelism", "tp"), ("lm_parallelism", "pp"),
    ("lm_parallelism", "ep"), ("remat", True), ("lm_model_axis", 2),
    ("lm_microbatches", 8), ("lm_experts", 4), ("lm_moe_top_k", 2),
    ("eval_freq", 10),
])
def test_unported_lm_fields_raise(field, value):
    kw = {"eval_freq": 0, "network": "TransformerLM", field: value}
    assert field in LM_RUNS
    cfg = config.TrainConfig(**kw)
    assert getattr(cfg, field) == value
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_config.TrainConfig(**kw))


def test_lm_config_validates_like_jax():
    for bad in (dict(lm_attention="turbo"), dict(lm_parallelism="dp")):
        with pytest.raises(ValueError):
            config.TrainConfig(eval_freq=0, **bad)
        with pytest.raises(ValueError):
            jax_config.TrainConfig(eval_freq=0, **bad)
    ours = dataclasses.asdict(_cfg(config, lm_attention="flash"))
    assert ours == dataclasses.asdict(_cfg(jax_config, lm_attention="flash"))


def test_lm_trainer_refuses_what_it_cannot_do(tmp_path):
    """No CUDA, no silent CPU run; a train_dir with a checkpoint is
    resumed, not refused."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LMTrainer(_cfg(config))
    td = str(tmp_path / "td")
    first = LMTrainer(_cfg(config, train_dir=td, max_steps=1, eval_freq=1),
                      device="cpu", printer=lambda line: None)
    first.train()
    lines = []
    again = LMTrainer(_cfg(config, train_dir=td, resume=True, max_steps=1),
                      device="cpu", printer=lines.append)
    again.train()
    assert again.start_step == 1 and "RESUME lm at step 1" in lines
    assert again.step_times == []
