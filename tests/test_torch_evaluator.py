"""The port's polling evaluator against the JAX package's, on the CPU.

Both evaluators score the same checkpoint, one written by the port's
trainer and one by the JAX package, to the same loss, Prec@1 and Prec@5 and
the same ``EVAL`` line. The poll picks up every committed step, and the
entry point runs with ``--device cpu``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.models import lenet as jax_lenet
from ps_pytorch_tpu.optim import sgd as jax_sgd
from ps_pytorch_tpu.parallel import create_train_state, make_mesh
from ps_pytorch_tpu.runtime import checkpoint as jax_ckpt
from ps_pytorch_tpu.runtime import evaluator as jax_evaluator
from ps_pytorch_tpu_torch import config, evaluate
from ps_pytorch_tpu_torch.models import convert, lenet
from ps_pytorch_tpu_torch.optim import SGD
from ps_pytorch_tpu_torch.runtime import Evaluator, Trainer
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime import evaluator

REPO = Path(__file__).resolve().parent.parent
KW = dict(network="LeNet", dataset="Digits", batch_size=32,
          test_batch_size=100, lr=0.05, momentum=0.9,
          compute_dtype="float32", epochs=0, max_steps=5, eval_freq=5)


def _both(train_dir, step):
    """(port result, port line, JAX result, JAX line) for one step."""
    ours, theirs = [], []
    got = Evaluator(train_dir, device="cpu",
                    printer=ours.append).evaluate_step(step)
    want = jax_evaluator.Evaluator(
        train_dir, printer=theirs.append).evaluate_step(step)
    return got, ours[0], want, theirs[0]


def _assert_lines_agree(line, jline, rtol=1e-5, atol=1e-5):
    """Two ``NAME key value key value ...`` lines: the same tag and keys,
    and each printed value within ``rtol`` / ``atol`` plus one unit in
    its last printed place (two values that agree at 1e-5 can still
    round to different last digits)."""
    ours, theirs = line.split(), jline.split()
    assert ours[:1] + ours[1::2] == theirs[:1] + theirs[1::2]
    for a, b in zip(ours[2::2], theirs[2::2]):
        places = len(b.partition(".")[2])
        np.testing.assert_allclose(float(a), float(b), rtol=rtol,
                                   atol=atol + 10.0 ** -places)


def _assert_agree(got, line, want, jline):
    assert got["step"] == want["step"]
    for k in ("loss", "prec1", "prec5"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    _assert_lines_agree(line, jline)
    assert line == evaluator.EVAL_LINE.format(**got)


def test_eval_line_is_the_jax_format():
    assert evaluator.EVAL_LINE == jax_evaluator.EVAL_LINE


def test_evaluators_agree_on_a_port_checkpoint(tmp_path):
    """A short LeNet run on Digits through the port's trainer."""
    td = str(tmp_path / "td")
    Trainer(config.TrainConfig(train_dir=td, **KW), device="cpu",
            printer=lambda _: None).train()
    _assert_agree(*_both(td, 5))


def test_evaluators_agree_on_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote: LeNet from a seeded JAX init,
    its weights scaled so that the logits are not near zero."""
    td = str(tmp_path / "td")
    jcfg = jax_config.TrainConfig(train_dir=td, **KW)
    state = create_train_state(jax_lenet.LeNet(),
                               jax_sgd(lr=0.05, momentum=0.9),
                               make_mesh(data=1), (1, 28, 28, 1),
                               jax.random.key(3))
    state = state.replace(params=jax.tree.map(lambda p: p * 1.5,
                                              state.params))
    jax_ckpt.save_checkpoint(td, 3, state, config_json=jcfg.to_json())
    _assert_agree(*_both(td, 3))


def _save_lenet_steps(td, steps):
    model = lenet.LeNet()
    opt_state = SGD(0.1, momentum=0.9).init(dict(model.named_parameters()))
    cfg = config.TrainConfig(train_dir=td, **KW)
    for step in steps:
        ckpt.save_checkpoint(td, step,
                             convert.state_to_jax(model, opt_state, step),
                             config_json=cfg.to_json())


def test_run_polls_every_committed_step(tmp_path):
    td = str(tmp_path / "td")
    _save_lenet_steps(td, (1, 2, 4))
    lines = []
    ev = Evaluator(td, poll_s=0.01, device="cpu", printer=lines.append)
    results = ev.run(stop_after=4)
    assert [r["step"] for r in results] == [1, 2, 4]
    assert [ln.split()[:3] for ln in lines] == [
        ["EVAL", "step", str(k)] for k in (1, 2, 4)]
    empty = Evaluator(str(tmp_path / "none"), poll_s=0.01, device="cpu")
    assert empty.run(idle_timeout_s=0.05) == []


def test_evaluate_entry_point_on_cpu(tmp_path):
    td = str(tmp_path / "td")
    _save_lenet_steps(td, (2,))
    out = subprocess.run(
        [sys.executable, "-m", "ps_pytorch_tpu_torch.evaluate",
         "--train-dir", td, "--device", "cpu", "--once", "2"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("EVAL step 2 loss ")
    assert evaluate.main(["--train-dir", td, "--device", "cpu",
                          "--stop-after", "2", "--poll-s", "0.01"]) == 0


def test_evaluator_refuses_what_it_cannot_do(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Evaluator(str(tmp_path))
    # LM checkpoints are scored (tests/test_torch_lm_ckpt.py), MoE ones
    # too (test_evaluators_agree_on_an_moe_checkpoint); the JAX
    # evaluator's sequence-sharded branch across processes is not ported.
    td = str(tmp_path / "lm")
    path = ckpt.checkpoint_path(td, 1)
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(config.TrainConfig(network="MoETransformerLM",
                                   eval_freq=0).to_json())
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        Evaluator(td, device="cpu").evaluate_step(1)


def test_evaluators_agree_on_an_moe_checkpoint(tmp_path):
    """An ep checkpoint of the port's LM trainer (one rank, top-2): both
    evaluators print the same EVAL_LM line."""
    from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer
    td = str(tmp_path / "moe")
    cfg = config.TrainConfig(
        lm_parallelism="ep", lm_experts=4, lm_moe_top_k=2, batch_size=4,
        lr=0.1, momentum=0.9, max_steps=2, eval_freq=2, log_every=10,
        lm_seq_len=32, lm_d_model=32, lm_layers=2, lm_heads=2, lm_vocab=256,
        lm_corpus_tokens=4000, train_dir=td)
    LMTrainer(cfg, device="cpu", printer=lambda line: None).train()
    got, line, want, jline = _both(td, 2)
    assert line.startswith("EVAL_LM step 2 loss ")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                               atol=1e-4)
    _assert_lines_agree(line, jline, rtol=1e-4, atol=1e-4)
