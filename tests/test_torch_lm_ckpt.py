"""The port's LM checkpoint lifecycle against the JAX package, on the CPU.

A tiny LM (vocab 61, d 32, 2 layers, 4 heads, S 16): each package loads the
other's LM checkpoint, plain and under ``--compress-grad``; the port's
``state.msgpack`` is byte-equal to the JAX one for the same state; a port
run resumed from a checkpoint equals a JAX run resumed from it (neither
fast-forwards its token loader); ``ckpt_corrupt`` walks back,
``replica_crash`` raises at its step, another geometry raises the JAX
message; per-block remat gives the loss and gradients of no remat,
bitwise; both evaluators print the same ``EVAL_LM`` fields and values on
either package's checkpoint; a checkpoint in the layout before the q/k/v
split migrates as in the JAX package.

The JAX side runs on one device (``jax.devices`` cut to the first):
``tests/conftest.py`` gives 8 CPU devices, over which the JAX LM trainer
and evaluator would shard the sequence.
"""

import shutil

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.models import transformer as jax_transformer
from ps_pytorch_tpu.runtime import checkpoint as jax_ckpt
from ps_pytorch_tpu.runtime import evaluator as jax_evaluator
from ps_pytorch_tpu.runtime import lm_eval as jax_lm_eval
from ps_pytorch_tpu.runtime import lm_trainer as jax_lm_trainer
from ps_pytorch_tpu.runtime import metrics as jax_metrics
from ps_pytorch_tpu_torch import config, evaluate
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models import transformer
from ps_pytorch_tpu_torch.resilience import InjectedCrash
from ps_pytorch_tpu_torch.runtime import Evaluator
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime import evaluator, lm_eval, msgpack_io
from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer
from ps_pytorch_tpu_torch.parallel.sp import nexttoken_loss
from test_torch_train import two_torch_threads  # noqa: F401

STEP_TOL = 1e-4             # tests/test_torch_lm.py's
KW = dict(lm_vocab=61, lm_d_model=32, lm_layers=2, lm_heads=4,
          lm_seq_len=16, batch_size=4, lm_corpus_tokens=4000, lr=0.1,
          momentum=0.9, weight_decay=1e-4, max_steps=2, eval_freq=2,
          resume=False)


def _cfg(mod, train_dir, **kw):
    return mod.TrainConfig(**dict(KW, train_dir=str(train_dir), **kw))


@pytest.fixture
def one_device(monkeypatch):
    devices = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)


def _quiet(_line):
    pass


def _port_train(td, **kw) -> LMTrainer:
    tr = LMTrainer(_cfg(config, td, **kw), device="cpu", printer=_quiet)
    tr.train()
    return tr


def _jax_train(td, **kw):
    tr = jax_lm_trainer.LMTrainer(_cfg(jax_config, td, **kw))
    tr.train()
    return tr


def _flat(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_close(got, want, tol, what=""):
    a, b = dict(_flat(got)), dict(_flat(want))
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol,
                                   err_msg=f"{what}{k}")


def _port_tree(tr: LMTrainer) -> dict:
    return convert.state_to_jax(tr.model, tr.step_fn.opt_state,
                                tr.step_fn.opt_state.step)


def _jax_tree(state) -> dict:
    return serialization.to_state_dict(jax.device_get(state))


# ---------------------------------------------------------- the files --

@pytest.mark.parametrize("compress", [False, True], ids=["plain", "blosc"])
def test_jax_loads_the_port_lm_checkpoint(tmp_path, compress, one_device):
    td = tmp_path / "td"
    tr = _port_train(td, compress_grad=compress)
    with open(ckpt.checkpoint_path(str(td), 2) + "/meta.json") as f:
        assert f'"compressed": {str(compress).lower()}' in f.read()
    jcfg = _cfg(jax_config, td, network="TransformerLM")
    state, meta, _ = jax_ckpt.load_checkpoint(
        str(td), 2, jax_lm_eval.build_lm_template(jcfg))
    assert meta["step"] == 2 and int(state.step) == 2
    _assert_close(_jax_tree(state), _port_tree(tr), 0.0)
    # The JAX trainer resumes from it.
    jtr = jax_lm_trainer.LMTrainer(_cfg(jax_config, td, resume=True))
    jtr.maybe_resume()
    assert jtr.start_step == 2


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "blosc"])
def test_port_loads_the_jax_lm_checkpoint(tmp_path, compress, one_device):
    td = tmp_path / "td"
    jtr = _jax_train(td, compress_grad=compress)
    lines = []
    tr = LMTrainer(_cfg(config, td, resume=True), device="cpu",
                   printer=lines.append)
    assert tr.maybe_resume() and lines == ["RESUME lm at step 2"]
    assert tr.start_step == 2 and tr.step_fn.opt_state.step == 2
    _assert_close(_port_tree(tr), _jax_tree(jtr.state), 0.0)


def test_port_lm_checkpoint_bytes_equal_jax(tmp_path, one_device):
    """The same state (the JAX trainer's after two steps, put into the
    port's model) saved by each package into the same train_dir: the same
    state.msgpack and config.json bytes."""
    td = tmp_path / "td"
    jtr = _jax_train(td)
    path = ckpt.checkpoint_path(str(td), 2)
    want = {}
    for name in ("state.msgpack", "config.json"):
        with open(f"{path}/{name}", "rb") as f:
            want[name] = f.read()
    tr = LMTrainer(_cfg(config, td), device="cpu", printer=_quiet)
    tr.step_fn.opt_state, step = convert.state_from_jax(
        _jax_tree(jtr.state), tr.model, tr.step_fn.opt_state)
    assert step == 2
    tr.checkpoint(step)                 # over the JAX one
    for name, blob in want.items():
        with open(f"{path}/{name}", "rb") as f:
            assert f.read() == blob, name
    assert msgpack_io.packb(_port_tree(tr)) == serialization.to_bytes(
        jax.device_get(jtr.state))


# ------------------------------------------------------------ resume --

def _losses(text: str) -> list:
    return [jax_metrics.parse_line(ln)["loss"] for ln in text.splitlines()
            if ln.startswith("STEP")]


def test_resumed_port_run_equals_resumed_jax_run(tmp_path, one_device,
                                                 capsys):
    """One JAX checkpoint at step 2, resumed to step 4 by each package:
    the losses of steps 3-4 and the step-4 state within STEP_TOL. Neither
    trainer fast-forwards its loader, so both draw batches 1-2 again."""
    _jax_train(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    capsys.readouterr()
    lines = []
    tr = LMTrainer(_cfg(config, tmp_path / "port", resume=True, max_steps=4),
                   device="cpu", printer=lines.append)
    tr.train()
    _jax_train(tmp_path / "jax", resume=True, max_steps=4)
    jax_out = capsys.readouterr().out
    assert "RESUME lm at step 2" in lines and "RESUME lm at step 2" in jax_out
    assert ckpt.committed_steps(str(tmp_path / "port")) == [2, 4]
    ours = ckpt.load_checkpoint(str(tmp_path / "port"), 4)[0]
    theirs = jax_ckpt.load_checkpoint(
        str(tmp_path / "jax"), 4, jax_lm_eval.build_lm_template(
            _cfg(jax_config, tmp_path / "jax", network="TransformerLM")))[0]
    _assert_close(ours, _jax_tree(theirs), STEP_TOL)
    got, want = _losses("\n".join(lines)), _losses(jax_out)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)
    # Not fast-forwarded: step 3 trains on the stream's first batch, the
    # one an uninterrupted run's step 1 takes.
    fresh = LMTrainer(_cfg(config, tmp_path / "fresh"), device="cpu",
                      printer=_quiet)
    assert tr.train_loader._cursor == fresh.train_loader._cursor + \
        2 * KW["batch_size"]


def test_ckpt_corrupt_walks_back(tmp_path, capsys):
    td = tmp_path / "td"
    tr = _port_train(td, max_steps=4, fault_spec="ckpt_corrupt:step=4")
    assert tr.injector.snapshot()["ckpt_corruptions"] == 1
    assert ckpt.committed_steps(str(td)) == [2, 4]
    assert not ckpt.verify_checkpoint(str(td), 4)
    lines = []
    again = LMTrainer(_cfg(config, td, resume=True, max_steps=6),
                      device="cpu", printer=lines.append)
    again.train()
    assert "[ckpt] step 4 failed verification" in capsys.readouterr().out
    assert "RESUME lm at step 2" in lines
    assert [ln.split()[1] for ln in lines if ln.startswith("STEP")] == \
        ["3", "4", "5", "6"]
    assert ckpt.committed_steps(str(td)) == [2, 4, 6]
    assert ckpt.verify_checkpoint(str(td), 4)       # rewritten


def test_replica_crash_raises_at_its_step(tmp_path):
    tr = LMTrainer(_cfg(config, tmp_path / "td", max_steps=5, eval_freq=0,
                        fault_spec="replica_crash:r=0,step=3"),
                   device="cpu", printer=_quiet)
    with pytest.raises(InjectedCrash, match="step 3"):
        tr.train()
    assert len(tr.step_times) == 2
    assert tr.injector.snapshot()["crashes"] == 1


def test_geometry_mismatch_raises_the_jax_message(tmp_path, one_device):
    td = tmp_path / "td"
    _port_train(td)
    with pytest.raises(ValueError) as ours:
        LMTrainer(_cfg(config, td, resume=True, lm_d_model=64),
                  device="cpu", printer=_quiet).train()
    with pytest.raises(ValueError) as theirs:
        _jax_train(td, resume=True, lm_d_model=64)
    assert "written with lm_d_model=32 but this run uses 64" in \
        str(ours.value)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kind", ["fault", "field"])
def test_lm_config_refuses_what_the_lm_does_not_run(kind):
    kw = ({"fault_spec": "kv_drop:p=0.1"} if kind == "fault"
          else {"heartbeat_interval_s": 1.0})
    with pytest.raises(ValueError, match="ROADMAP.md"):
        config.TrainConfig(network="TransformerLM", **kw)
    assert config.TrainConfig(
        network="TransformerLM",
        fault_spec="replica_crash:r=0,step=3;ckpt_corrupt:step=2").remat \
        is False


# ------------------------------------------------------------- remat --

@pytest.mark.parametrize("impl", ["full", "flash"])
def test_remat_matches_no_remat_bitwise(impl):
    """The recompute runs the same CPU ops on the same inputs: the loss
    and every gradient are bitwise those without remat."""
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, KW["lm_vocab"], (4, 16))).long()
    out = []
    for remat in (False, True):
        model = transformer.TransformerLM(
            vocab_size=61, n_layers=2, n_heads=4, d_model=32,
            max_seq_len=16, attention_impl=impl, remat=remat,
            generator=torch.Generator().manual_seed(0))
        loss, _ = nexttoken_loss(model, tokens)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    model.named_parameters()}))
    (loss0, g0), (loss1, g1) = out
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


# ---------------------------------------------------------- EVAL_LM --

def _eval_lines(td, step):
    ours, theirs = [], []
    got = Evaluator(str(td), device="cpu",
                    printer=ours.append).evaluate_step(step)
    want = jax_evaluator.Evaluator(
        str(td), printer=theirs.append).evaluate_step(step)
    return got, ours[0], want, theirs[0]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_evaluators_print_the_same_eval_lm(tmp_path, writer, one_device):
    td = tmp_path / "td"
    (_port_train if writer == "port" else _jax_train)(td)
    got, line, want, jline = _eval_lines(td, 2)
    assert evaluator.EVAL_LM_LINE == jax_evaluator.EVAL_LM_LINE
    ours, theirs = line.split(), jline.split()
    assert ours[:1] + ours[1::2] == theirs[:1] + theirs[1::2] == \
        ["EVAL_LM", "step", "loss", "perplexity"]
    assert got["step"] == want["step"] == 2
    for k in ("loss", "perplexity"):
        np.testing.assert_allclose(got[k], want[k], rtol=STEP_TOL,
                                   atol=STEP_TOL)
    assert got["perplexity"] == lm_eval.perplexity(got["loss"])
    assert line == evaluator.EVAL_LM_LINE.format(**got)


def test_evaluate_entry_point_scores_an_lm_checkpoint(tmp_path, capsys):
    td = tmp_path / "td"
    _port_train(td)
    capsys.readouterr()
    assert evaluate.main(["--train-dir", str(td), "--once", "2",
                          "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("EVAL_LM step 2 loss ")
    loss, ppl = float(line.split()[4]), float(line.split()[6])
    assert np.isfinite(loss) and abs(ppl - np.exp(loss)) < 1e-3 * ppl


# ----------------------------------------------------------- migrate --

def _pack_qkv(tree):
    """The layout before the q/k/v split: Dense_0..2 packed into one
    [d, 3d] kernel, Dense_3..5 renumbered to Dense_1..3."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "Dense_5" in v:
            v = dict(v)
            q, kk, vv = (v.pop(f"Dense_{i}")["kernel"] for i in range(3))
            v["Dense_0"] = {"kernel": np.concatenate([q, kk, vv], axis=1)}
            for i in range(3, 6):
                v[f"Dense_{i - 2}"] = v.pop(f"Dense_{i}")
            out[k] = v
        elif isinstance(v, dict):
            out[k] = _pack_qkv(v)
        else:
            out[k] = v
    return out


def test_legacy_packed_qkv_checkpoint_migrates(tmp_path, capsys):
    td = tmp_path / "td"
    tr = _port_train(td)
    tree = _port_tree(tr)
    legacy = dict(tree, params=_pack_qkv(tree["params"]),
                  opt_state=dict(tree["opt_state"], momentum=_pack_qkv(
                      tree["opt_state"]["momentum"])))
    migrated, n = transformer.migrate_packed_qkv(legacy)
    jmigrated, jn = jax_transformer.migrate_packed_qkv(legacy)
    assert n == jn == 4                 # two blocks, params and momentum
    _assert_close(migrated, jmigrated, 0.0)
    _assert_close(migrated, tree, 0.0)
    assert transformer.migrate_packed_qkv(tree)[1] == 0
    cfg = _cfg(config, td, network="TransformerLM")
    ckpt.save_checkpoint(str(td), 3, legacy, config_json=cfg.to_json())
    capsys.readouterr()
    lines = []
    again = LMTrainer(_cfg(config, td, resume=True, max_steps=3),
                      device="cpu", printer=lines.append)
    assert again.maybe_resume() and again.start_step == 3
    assert "[ckpt] migrated legacy checkpoint layout at step 3 " \
        "(4 tree nodes rewritten)" in capsys.readouterr().out
    _assert_close(_port_tree(again)["params"], tree["params"], 0.0)
