"""The port's polling evaluator against the JAX package's, on the CPU.

Both evaluators score the same checkpoint, one written by the port's
trainer and one by the JAX package, to the same loss, Prec@1 and Prec@5 and
the same ``EVAL`` line. The poll picks up every committed step, and the
entry point runs with ``--device cpu``. An LM checkpoint is scored through
the flash oracle where the kernels take the head dim; launched over two
gloo ranks, an ``sp`` checkpoint goes through the ring over them (held
against the JAX evaluator's ring branch over two CPU devices) and a
``tp`` one through the oracle on each rank, every rank printing EVAL_LM.
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
from conftest import free_port
from ps_pytorch_tpu_torch import config, evaluate
from ps_pytorch_tpu_torch.models import convert, lenet
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.optim import SGD
from ps_pytorch_tpu_torch.runtime import Evaluator, Trainer
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime import evaluator, lm_eval
from ps_pytorch_tpu_torch.tools import launch
from test_torch_train import two_torch_threads  # noqa: F401

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
    """No silent CPU run, and a launch of several processes needs the
    whole env contract; an LM checkpoint under a launch of several
    processes is scored, not refused (the MoE oracle keeps full
    attention)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Evaluator(str(tmp_path))
    td = str(tmp_path / "lm")
    path = ckpt.checkpoint_path(td, 1)
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(config.TrainConfig(network="MoETransformerLM", lm_experts=2,
                                   eval_freq=0).to_json())
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="without PS_TPU_COORDINATOR.*"
                       "tools.launch launch"):
        evaluate.main(["--train-dir", td, "--once", "1", "--device", "cpu"])
    ev = Evaluator(td, device="cpu")
    with open(os.path.join(path, "config.json")) as f:
        ev._build(f.read())
    assert type(ev.model).__name__ == "MoETransformerLM"
    assert ev.model.attention_impl == "full"


LM_KW = dict(network="TransformerLM", lm_vocab=64, lm_d_model=32,
             lm_layers=2, lm_heads=2, lm_seq_len=64, batch_size=4,
             lm_corpus_tokens=4000, lr=0.1, momentum=0.9, eval_freq=0)


def _save_lm(td, step, **over):
    """A seeded TransformerLM checkpoint with the port's layout and the
    config ``over`` sets (an sp or a tp run's)."""
    cfg = config.TrainConfig(train_dir=td, **dict(LM_KW, **over))
    model = TransformerLM(generator=torch.Generator().manual_seed(5),
                          **lm_eval.lm_geometry(cfg))
    state = convert.state_to_jax(model, lm_eval.build_lm_template(cfg, model),
                                 step)
    ckpt.save_checkpoint(td, step, state, config_json=cfg.to_json())


def _jax_line(td, step, devices, monkeypatch):
    """The JAX evaluator's EVAL_LM line over ``devices`` CPU devices (its
    ring branch for an sp checkpoint when there are several)."""
    chosen = jax.devices()[:devices]
    with monkeypatch.context() as m:
        m.setattr(jax, "devices", lambda *a, **k: chosen)
        lines = []
        jax_evaluator.Evaluator(td, printer=lines.append).evaluate_step(step)
    return lines[0]


def test_scoring_attention_is_flash_where_the_kernels_take_the_head_dim():
    def cfg(**kw):
        return config.TrainConfig(**dict(LM_KW, **kw))
    assert lm_eval.scoring_attention(cfg()) == "flash"              # 16
    assert lm_eval.scoring_attention(cfg(lm_d_model=36,
                                         lm_heads=3)) == "full"    # 12
    assert lm_eval.scoring_attention(cfg(lm_d_model=272,
                                         lm_heads=2)) == "full"    # 136
    assert lm_eval.scoring_attention(cfg(network="MoETransformerLM",
                                         lm_experts=2)) == "full"


def test_flash_oracle_prints_the_jax_eval_lm(tmp_path, monkeypatch):
    """One process: the oracle scores through flash (head dim 16), the
    JAX evaluator's full-attention line by field at 1e-4."""
    td = str(tmp_path / "td")
    _save_lm(td, 2)
    lines = []
    ev = Evaluator(td, device="cpu", printer=lines.append)
    ev.evaluate_step(2)
    assert ev.model.attention_impl == "flash"
    _assert_lines_agree(lines[0], _jax_line(td, 2, 1, monkeypatch),
                        rtol=1e-4, atol=1e-4)


_RING_WORKER = r"""
import sys
from ps_pytorch_tpu_torch import evaluate
from ps_pytorch_tpu_torch.parallel import collectives
evaluate.main(["--train-dir", sys.argv[1], "--once", "2", "--device", "cpu"])
print(f"COLLECTIVES {collectives.stats['calls']}", flush=True)
print("FINAL ok", flush=True)
"""


def _launch(tmp_path, name, entry, argv):
    """Two gloo ranks of ``entry`` through the port's launcher; each
    rank's log."""
    run = tmp_path / name
    rc = launch.main(["launch", "--run-dir", str(run), "--simulate", "2",
                      "--port", str(free_port()), "--entry", entry,
                      "--cwd", str(REPO), "--wait", "--timeout", "150",
                      "--", *argv])
    logs = [(run / f"proc_{r}.log").read_text() for r in range(2)]
    assert rc == 0, "\n\n".join(log[-3000:] for log in logs)
    return logs


def _eval_lm_line(log: str) -> str:
    return next(ln for ln in log.splitlines() if ln.startswith("EVAL_LM"))


def test_checkpoints_scored_across_two_ranks(tmp_path, monkeypatch):
    """An sp checkpoint launched over two ranks goes through the ring over
    them (collectives on both ranks), a tp one through the oracle on each
    rank (the entry point itself under the launcher); each rank prints
    the JAX evaluator's line by field at 1e-4, the sp one its ring
    branch's over two devices."""
    sp, tp = str(tmp_path / "sp"), str(tmp_path / "tp")
    _save_lm(sp, 2)
    _save_lm(tp, 2, lm_parallelism="tp", lm_model_axis=2)
    (tmp_path / "worker.py").write_text(_RING_WORKER)
    ring_logs = _launch(tmp_path, "ring", str(tmp_path / "worker.py"), [sp])
    tp_logs = _launch(tmp_path, "tp", "ps_pytorch_tpu_torch.evaluate",
                      ["--train-dir", tp, "--once", "2", "--device", "cpu"])
    want_sp = _jax_line(sp, 2, 2, monkeypatch)
    want_tp = _jax_line(tp, 2, 2, monkeypatch)
    for log in ring_logs:
        assert int(log.split("COLLECTIVES ")[1].split()[0]) > 0
        _assert_lines_agree(_eval_lm_line(log), want_sp, rtol=1e-4,
                            atol=1e-4)
    for log in tp_logs:
        _assert_lines_agree(_eval_lm_line(log), want_tp, rtol=1e-4,
                            atol=1e-4)
    assert _eval_lm_line(tp_logs[0]) == _eval_lm_line(tp_logs[1])


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
