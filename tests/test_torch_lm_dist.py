"""``python -m ps_pytorch_tpu_torch.train_lm`` across two gloo ranks on the
CPU, through the port's launcher (``tools.launch --simulate 2``), in each
of sp (ring attention), tp and pp, against the JAX package's readers.

- Every rank prints ``DIST process r/2``, the ``LM mesh devices=2`` line of
  its mode and the same FINAL line; the three modes train the same model
  from the same seed on the same batches, so their FINAL losses agree
  within the LM step tolerance (1e-4, ``tests/test_torch_lm.py``).
- Exactly one checkpoint is committed, written by rank 0 alone.
- The JAX evaluator scores the port's sp, tp and pp checkpoints (pp's in the
  stage-stacked layout), the EVAL_LM fields equal to the port evaluator's
  at 1e-4 (``tests/test_torch_lm_ckpt.py``'s ``STEP_TOL``).
- A same-mode resume (tp and pp, two ranks) restores the step-3
  checkpoint on both ranks and trains on to step 5.
- A JAX pp checkpoint (``tests/test_generate.py:190-203``'s case) is
  scored by the port's evaluator, EVAL_LM by field against the JAX
  evaluator's, and decoded by the port's ``generate.py`` to the root
  ``generate.py``'s output, line for line.
"""

import io
import json
import re
import shutil
import sys
import threading
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest

from conftest import free_port
from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.runtime import evaluator as jax_evaluator
from ps_pytorch_tpu.runtime.lm_trainer import LMTrainer as JaxLMTrainer
from ps_pytorch_tpu_torch import generate as generate_cli
from ps_pytorch_tpu_torch.runtime import Evaluator
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.tools import launch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import generate as jax_generate_cli  # noqa: E402  the root generate.py
from test_torch_train import two_torch_threads  # noqa: F401

STEP_TOL = 1e-4
LM_ARGS = ["--lm-vocab", "256", "--lm-d-model", "32", "--lm-layers", "2",
           "--lm-heads", "2", "--lm-seq-len", "32", "--batch-size", "4",
           "--lm-corpus-tokens", "4000", "--lr", "0.1", "--momentum", "0.9",
           "--log-every", "1"]
MODES = {"sp": ["--lm-parallelism", "sp"],
         "tp": ["--lm-parallelism", "tp", "--lm-model-axis", "2",
                "--lm-attention", "full"],
         "pp": ["--lm-parallelism", "pp", "--lm-model-axis", "2",
                "--lm-microbatches", "2", "--lm-attention", "flash",
                "--remat"]}
ATTENTION = {"sp": "ring", "tp": "full", "pp": "flash"}
# train_lm.main in each rank, the checkpoints it writes counted.
_WORKER = r"""
import json, sys
from ps_pytorch_tpu_torch import train_lm
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt

saves = []
save_checkpoint = ckpt.save_checkpoint
def counted(train_dir, step, *args, **kw):
    saves.append(step)
    return save_checkpoint(train_dir, step, *args, **kw)
ckpt.save_checkpoint = counted
train_lm.main(sys.argv[1:])
print("SAVES " + json.dumps(saves), flush=True)
"""


def _launch_all(root: Path, runs: dict) -> dict:
    """Launch each run (name -> train_lm argv) as two ranks, all at once;
    name -> each rank's log."""
    worker = root / "worker.py"
    worker.write_text(_WORKER)
    rcs = {}

    def one(name, argv):
        rcs[name] = launch.main([
            "launch", "--run-dir", str(root / f"run_{name}"), "--simulate",
            "2", "--port", str(free_port()), "--entry", str(worker),
            "--wait", "--timeout", "120", "--grace", "1", "--",
            "--device", "cpu", *argv])

    threads = [threading.Thread(target=one, args=item)
               for item in runs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    logs = {name: [(root / f"run_{name}" / f"proc_{r}.log").read_text()
                   for r in range(2)] for name in runs}
    for name, rc in rcs.items():
        assert rc == 0, "\n\n".join(log[-3000:] for log in logs[name])
    return logs


def _final(log: str) -> str:
    found = re.findall(r"^FINAL .*$", log, re.M)
    assert len(found) == 1, log[-2000:]
    return found[0]


def _saves(log: str) -> list:
    return json.loads(re.findall(r"^SAVES (.*)$", log, re.M)[0])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_dist")
    with redirect_stdout(io.StringIO()):
        first = _launch_all(root, {
            mode: LM_ARGS + flags + ["--max-steps", "3", "--eval-freq", "3",
                                     "--train-dir", str(root / mode)]
            for mode, flags in MODES.items()})
        # Each resume from its own copy of the step-3 train dir.
        for mode in ("tp", "pp"):
            shutil.copytree(root / mode, root / f"{mode}_resume")
        resumed = _launch_all(root, {
            f"{mode}_resume": LM_ARGS + MODES[mode] + [
                "--max-steps", "5", "--eval-freq", "5",
                "--train-dir", str(root / f"{mode}_resume")]
            for mode in ("tp", "pp")})
    return root, first, resumed


@pytest.mark.parametrize("mode", list(MODES))
def test_every_rank_prints_the_same_final_and_rank0_alone_writes(
        trained, mode):
    root, first, _ = trained
    logs = first[mode]
    for r, log in enumerate(logs):
        assert f"DIST process {r}/2" in log
        assert (f"LM mesh devices=2 parallelism={mode} "
                f"attention={ATTENTION[mode]}") in log
    assert _final(logs[0]) == _final(logs[1])
    assert [_saves(log) for log in logs] == [[3], []]
    assert ckpt.committed_steps(str(root / mode)) == [3]


def test_the_three_modes_train_the_same_model(trained):
    _, first, _ = trained
    losses = [float(_final(first[m][0]).split()[2]) for m in MODES]
    np.testing.assert_allclose(losses, losses[0], rtol=STEP_TOL,
                               atol=STEP_TOL)


def _eval_both(td: str, step: int):
    ours, theirs = [], []
    got = Evaluator(td, device="cpu", printer=ours.append).evaluate_step(
        step)
    want = jax_evaluator.Evaluator(td, printer=theirs.append).evaluate_step(
        step)
    for line in (ours[0], theirs[0]):
        fields = line.split()
        assert fields[:1] + fields[1::2] == \
            ["EVAL_LM", "step", "loss", "perplexity"]
    assert got["step"] == want["step"] == step
    for k in ("loss", "perplexity"):
        np.testing.assert_allclose(got[k], want[k], rtol=STEP_TOL,
                                   atol=STEP_TOL)
    return got


@pytest.mark.parametrize("mode", list(MODES))
def test_the_jax_evaluator_scores_the_ports_checkpoint(trained, mode):
    root, _, _ = trained
    got = _eval_both(str(root / mode), 3)
    assert np.isfinite(got["loss"])


@pytest.mark.parametrize("mode", ["tp", "pp"])
def test_a_same_mode_resume(trained, mode):
    root, _, resumed = trained
    logs = resumed[f"{mode}_resume"]
    for log in logs:
        assert "RESUME lm at step 3" in log
        steps = [int(s) for s in re.findall(r"^STEP (\d+) ", log, re.M)]
        assert steps == [4, 5]
    assert _final(logs[0]) == _final(logs[1])
    assert [_saves(log) for log in logs] == [[5], []]
    assert ckpt.committed_steps(str(root / f"{mode}_resume")) == [3, 5]


def test_a_jax_pp_checkpoint_is_scored_and_decoded(tmp_path, monkeypatch):
    devices = jax.devices()[:2]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)
    td = str(tmp_path / "pp")
    cfg = jax_config.TrainConfig(
        batch_size=4, lr=0.1, momentum=0.9, max_steps=2, eval_freq=2,
        log_every=10, lm_seq_len=32, lm_d_model=32, lm_layers=2,
        lm_heads=2, lm_vocab=256, lm_corpus_tokens=4000,
        lm_parallelism="pp", lm_model_axis=2, lm_microbatches=2,
        train_dir=td)
    with redirect_stdout(io.StringIO()):
        JaxLMTrainer(cfg).train()
    _eval_both(td, 2)
    argv = ["--train-dir", td, "--prompt", "ab", "--n-new", "8",
            "--temperature", "0"]
    outs = []
    for main, extra in ((generate_cli.main, ["--device", "cpu"]),
                        (jax_generate_cli.main, [])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(argv + extra) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
