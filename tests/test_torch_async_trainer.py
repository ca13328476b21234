"""The port's AsyncTrainer (``ps_pytorch_tpu_torch/runtime/async_trainer.py``)
against the JAX package's, on the CPU (LeNet, ``synthetic_mnist``, f32,
the plain versions of the kernels).

- Alone over an in-process store, for each wire codec (raw, blosc, int8,
  int8lat with error feedback): the leader reaches ``version == applied
  == max_steps``, commits ``model_step_<k>``, and its JSONL rows carry the
  JAX AsyncTrainer's fields.
- Fed the JAX trainer's initial parameters, the port's parameters agree
  with the JAX AsyncTrainer's after 3 versions at 1e-4 (raw and blosc).
- A resumed run is bitwise the uninterrupted one.
- The JAX evaluator scores the port's async checkpoint to the same Prec@1.
- Two processes through the port's launcher (``--mode async --device
  cpu``), then a launch resumed from their checkpoint: both print the same
  FINAL line, only process 0 commits checkpoints, both put bytes on the
  wire and write the wire spans, and the port's evaluator in one process
  scores the checkpoint of the two.
"""

import io
import json
import re
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from conftest import free_port
from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu import telemetry as jax_tel
from ps_pytorch_tpu.runtime import evaluator as jax_evaluator
from ps_pytorch_tpu.runtime.async_trainer import AsyncTrainer as JaxTrainer
from ps_pytorch_tpu_torch import config, evaluate, telemetry
from ps_pytorch_tpu_torch.models.convert import to_jax
from ps_pytorch_tpu_torch.parallel.async_dp import tree_flatten
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.async_trainer import AsyncTrainer
from ps_pytorch_tpu_torch.runtime.coordinator import KVStore
from ps_pytorch_tpu_torch.tools import launch
from test_torch_train import two_torch_threads  # noqa: F401

TOL = 1e-4          # the train step's tolerance against the JAX package
CODECS = {"raw": {}, "blosc": dict(compress_grad=True),
          "int8": dict(compress_grad=True, grad_codec="int8"),
          "int8lat_ef": dict(compress_grad=True, grad_codec="int8lat",
                             ef=True)}


@pytest.fixture(autouse=True)
def no_default_tracer():
    """A trainer installs its tracer until train() ends; put back none."""
    yield
    telemetry.set_default_tracer(None)
    jax_tel.set_default_tracer(None)


def _kw(tmp_path, codec="raw", **over):
    base = dict(dataset="synthetic_mnist", network="LeNet", batch_size=64,
                lr=0.05, momentum=0.9, compute_dtype="float32", mode="async",
                max_steps=3, eval_freq=0, resume=False, log_every=1,
                train_dir=str(tmp_path / "td"), **CODECS[codec])
    base.update(over)
    return base


def _plain(tree):
    """A (frozen) dict of arrays -> nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _params(trainer) -> list:
    """The port trainer's parameters as JAX-layout leaves in wire order."""
    return tree_flatten(to_jax(trainer.model.state_dict())[0])[0]


def _rows(path):
    return [json.loads(line) for line in open(path)]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX AsyncTrainer alone, 3 versions, per codec (on demand):
    initial and final params, and its JSONL rows."""
    runs = {}

    def run(codec):
        if codec not in runs:
            tmp = tmp_path_factory.mktemp(f"jax_{codec}")
            cfg = jax_config.TrainConfig(**_kw(
                tmp, codec, metrics_file=str(tmp / "m.jsonl")))
            trainer = JaxTrainer(cfg)
            init = _plain(jax.device_get(trainer.params))
            with redirect_stdout(io.StringIO()):
                trainer.train()
            runs[codec] = (init, _plain(jax.device_get(trainer.params)),
                           _rows(tmp / "m.jsonl"))
            jax_tel.set_default_tracer(None)
        return runs[codec]

    return run


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_alone_each_codec_trains_checkpoints_and_logs_like_jax(
        codec, tmp_path, jax_runs):
    cfg = config.TrainConfig(**_kw(tmp_path, codec, eval_freq=3,
                                   metrics_file=str(tmp_path / "m.jsonl")))
    trainer = AsyncTrainer(cfg, kv=KVStore(), device="cpu",
                           printer=lambda line: None)
    trainer.train()
    assert trainer.version == trainer.applied == cfg.max_steps
    assert ckpt.committed_steps(cfg.train_dir) == [3]
    assert (ckpt.load_extra_state(cfg.train_dir, 3) is not None) == cfg.ef
    rows = _rows(tmp_path / "m.jsonl")
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert [r["applied"] for r in rows] == [1, 2, 3]
    assert all(r["participating"] == 1.0 and r["dropped_stale"] == 0 and
               r["wire_bytes_out"] > 0 and r["wire_bytes_in"] > 0
               for r in rows)
    assert set(rows[0]) == set(jax_runs("raw")[2][0])
    result = trainer.evaluate(max_batches=1)
    assert np.isfinite(result["loss"]) and result["count"] == 1000
    trainer.leave()


@pytest.mark.parametrize("codec", ["raw", "blosc"])
def test_matches_the_jax_async_trainer_after_three_versions(
        codec, tmp_path, jax_runs):
    init, theirs, jax_rows = jax_runs(codec)
    trainer = AsyncTrainer(
        config.TrainConfig(**_kw(tmp_path, codec,
                                 metrics_file=str(tmp_path / "m.jsonl"))),
        kv=KVStore(), device="cpu", printer=lambda line: None)
    trainer._load_params(init)
    trainer.train()
    assert trainer.version == 3
    for a, b in zip(_params(trainer), tree_flatten(theirs)[0]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    # Each tick moved the same armoured bytes: both packages' channels
    # frame the same trees (blosc's sizes follow the values' last bits).
    for ours, jax_row in zip(_rows(tmp_path / "m.jsonl"), jax_rows):
        for key in ("wire_bytes_out", "wire_bytes_in"):
            assert abs(ours[key] - jax_row[key]) <= \
                (0 if codec == "raw" else 0.01 * ours[key])


@pytest.mark.parametrize("codec", ["int8", "int8lat_ef"])
def test_a_resumed_run_is_bitwise_the_uninterrupted_one(codec, tmp_path):
    def run(td, steps, resume):
        cfg = config.TrainConfig(**_kw(tmp_path, codec, max_steps=steps,
                                       eval_freq=2, train_dir=str(td),
                                       resume=resume))
        out = io.StringIO()
        with redirect_stdout(out):
            trainer = AsyncTrainer(cfg, kv=KVStore(), device="cpu")
            trainer.train()
        return trainer, out.getvalue()

    whole, _ = run(tmp_path / "whole", 4, False)
    run(tmp_path / "split", 2, False)
    resumed, log = run(tmp_path / "split", 4, True)
    assert f"RESUME from {tmp_path / 'split'}/model_step_2 at step 2" in log
    assert resumed.version == 4 and resumed.applied == 2
    for a, b in zip(_params(whole), _params(resumed)):
        np.testing.assert_array_equal(a, b)
    if codec == "int8lat_ef":
        ef_a, ef_b = whole._ef.state_dict(), resumed._ef.state_dict()
        assert set(ef_a) == set(ef_b) and ef_a
        for k in ef_a:
            np.testing.assert_array_equal(ef_a[k], ef_b[k])


def test_the_jax_evaluator_scores_the_ports_async_checkpoint(tmp_path):
    cfg = config.TrainConfig(**_kw(tmp_path, "blosc", eval_freq=3))
    with redirect_stdout(io.StringIO()):
        AsyncTrainer(cfg, kv=KVStore(), device="cpu").train()
    out = io.StringIO()
    with redirect_stdout(out):
        evaluate.main(["--train-dir", cfg.train_dir, "--once", "3",
                       "--device", "cpu"])
    ours = out.getvalue().strip().splitlines()[-1].split()
    theirs = []
    jax_evaluator.Evaluator(cfg.train_dir,
                            printer=theirs.append).evaluate_step(3)
    theirs = theirs[0].split()
    assert ours[:3] == theirs[:3] == ["EVAL", "step", "3"]
    assert ours[6] == theirs[6]                         # Prec@1
    np.testing.assert_allclose([float(ours[4]), float(ours[8])],
                               [float(theirs[4]), float(theirs[8])],
                               rtol=TOL, atol=TOL)


# ------------------------------------------------------ two processes --

_WORKER = r"""
import json
import sys
import time

from ps_pytorch_tpu_torch import train
from ps_pytorch_tpu_torch.runtime import async_trainer

saves = []
save = async_trainer.ckpt.save_checkpoint


def counted(train_dir, step, *args, **kw):
    saves.append(step)
    return save(train_dir, step, *args, **kw)


async_trainer.ckpt.save_checkpoint = counted

# The leader ticks to --max-steps as soon as it has published, so a
# follower that starts late under load would contribute nothing. Process 1
# marks its first submission on the group's store, and process 0 waits for
# the mark before its first apply (the trainers themselves have no such
# barrier, as in the JAX package).
submit = async_trainer.AsyncTrainer._compute_and_submit
apply = async_trainer.AsyncTrainer._leader_apply


def marked_submit(self, version_used):
    out = submit(self, version_used)
    if self.pid == 1:
        self._kv.set(f"{self.run_id}/test/joined", "1")
    return out


def gated_apply(self):
    if not getattr(self, "_follower_joined", False):
        deadline = time.monotonic() + 120.0
        while self._kv.get(f"{self.run_id}/test/joined") is None:
            if time.monotonic() > deadline:
                raise TimeoutError("process 1 made no submission in 120 s")
            time.sleep(0.05)
        self._follower_joined = True
    return apply(self)


async_trainer.AsyncTrainer._compute_and_submit = marked_submit
async_trainer.AsyncTrainer._leader_apply = gated_apply
trainer, result = train.run(sys.argv[1:])
print("RESULT " + json.dumps({
    "pid": trainer.pid, "saves": saves, "version": trainer.version,
    "applied": trainer.applied, "own_steps": trainer.own_steps}),
    flush=True)
"""


def _launch(tmp_path, run, steps, resume):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    run_dir = tmp_path / run
    args = ["--device", "cpu", "--mode", "async", "--network", "LeNet",
            "--dataset", "synthetic_mnist", "--batch-size", "64",
            "--compute-dtype", "float32", "--lr", "0.05", "--momentum",
            "0.9", "--compress-grad", "--grad-codec", "int8",
            "--staleness-limit", "8", "--max-steps", str(steps),
            "--eval-freq", "2", "--resume", resume, "--test-batch-size",
            "2000", "--train-dir", str(tmp_path / "td"), "--metrics-file",
            str(tmp_path / f"{run}.jsonl"), "--trace-file",
            str(tmp_path / f"{run}.trace.json"), "--publish-every", "2"]
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")       # ranks share the test's cores
    try:
        rc = launch.main(["launch", "--run-dir", str(run_dir), "--simulate",
                          "2", "--port", str(free_port()), "--entry",
                          str(worker), "--wait", "--timeout", "150",
                          "--grace", "1", "--", *args])
    finally:
        mp.undo()
        launch.main(["kill", "--run-dir", str(run_dir), "--grace", "1"])
    logs = [(run_dir / f"proc_{r}.log").read_text() for r in range(2)]
    assert rc == 0, "\n\n".join(log[-3000:] for log in logs)
    results = [json.loads(log.split("RESULT ", 1)[1].splitlines()[0])
               for log in logs]
    finals = [re.findall(r"^FINAL .*$", log, re.M) for log in logs]
    return logs, results, finals


def test_two_processes_train_resume_and_agree(tmp_path):
    logs, results, finals = _launch(tmp_path, "first", 4, "false")
    for log in logs:
        assert "ASYNC process-slices 2 x 1 devices" in log
    assert len(finals[0]) == 1 and finals[0] == finals[1]
    assert [r["pid"] for r in results] == [0, 1]
    assert results[0]["version"] == results[0]["applied"] == 4
    assert [r["saves"] for r in results] == [[2, 4], []]
    assert results[1]["own_steps"] >= 1
    for name in ("first.jsonl", "first.jsonl.p1"):
        rows = _rows(tmp_path / name)
        assert rows and rows[-1]["wire_bytes_out"] > 0
    assert ckpt.committed_steps(str(tmp_path / "td")) == [2, 4]

    logs, results, finals = _launch(tmp_path, "resumed", 6, "true")
    assert f"RESUME from {tmp_path / 'td'}/model_step_4 at step 4" in logs[0]
    assert "RESUME" not in logs[1]
    assert len(finals[0]) == 1 and finals[0] == finals[1]
    assert results[0]["version"] == 6 and results[0]["applied"] == 2
    assert [r["saves"] for r in results] == [[6], []]
    assert ckpt.committed_steps(str(tmp_path / "td")) == [2, 4, 6]
    for name in ("resumed.jsonl", "resumed.jsonl.p1"):
        assert _rows(tmp_path / name)[-1]["wire_bytes_out"] > 0
    # The wire spans, one trace a process.
    for name in ("resumed.trace.json", "resumed.trace.json.p1"):
        events = json.load(open(tmp_path / name))["traceEvents"]
        assert {"wire_publish", "wire_read"} <= {e["name"] for e in events}
    # This process is one launch of one: the port's evaluator reads the
    # checkpoint of a two-process run all the same.
    out = io.StringIO()
    with redirect_stdout(out):
        evaluate.main(["--train-dir", str(tmp_path / "td"), "--once", "6",
                       "--device", "cpu"])
    assert out.getvalue().split()[:3] == ["EVAL", "step", "6"]
