"""The port's expert-parallel MoE LM across gloo ranks on the CPU, against
the JAX package.

One launch of four ranks (``tests/test_torch_ring.py:launch_ranks``) runs
``parallel/ep.EPTrainStep`` over all four ranks and over two ranks (each
model row of a 2 x 2 grid, as ``tests/test_torch_tp.py`` does), top-1 and
top-2, with and without ``--remat``, three SGD steps each, on the same
flax weights and batches as the JAX oracle of ``tests/test_ep.py:114-158``
(``MoETransformerLM(n_groups=n)``, one device): losses at 2e-5, the
gathered parameters at rtol 5e-4 / atol 5e-5; the replicated parameters
bitwise equal on every rank; ``--remat`` changing no bit; the bytes a
rank hands gloo the shapes' count; and ``all_to_all``'s backward the
reverse all-to-all.

A second launch runs ``python -m ps_pytorch_tpu_torch.train_lm
--lm-parallelism ep`` on two ranks (``tools.launch --simulate 2``): the
same FINAL on both, one checkpoint by rank 0, scored by the JAX evaluator
(EVAL_LM by field at 1e-4), then a same-mode resume. A JAX ep checkpoint
(experts sharded over two CPU devices) is scored by the port's evaluator
and decoded by the port's ``generate.py``, line for line with the root
``generate.py``. The JAX refusals are the port's.
"""

import io
import json
import re
import sys
import threading
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import free_port
from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.models import moe as jax_moe
from ps_pytorch_tpu.optim.sgd import sgd as jax_sgd
from ps_pytorch_tpu.parallel.ep import make_ep_train_step
from ps_pytorch_tpu.parallel.mesh import make_mesh
from ps_pytorch_tpu.runtime import evaluator as jax_evaluator
from ps_pytorch_tpu.runtime.lm_trainer import LMTrainer as JaxLMTrainer
from ps_pytorch_tpu_torch import config
from ps_pytorch_tpu_torch import generate as generate_cli
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.moe import MoETransformerLM, capacity
from ps_pytorch_tpu_torch.parallel import ep
from ps_pytorch_tpu_torch.parallel.mesh import Axis
from ps_pytorch_tpu_torch.runtime import Evaluator
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.tools import launch
from test_torch_moe import LM, OPT, _jax_oracle_steps
from test_torch_ring import launch_ranks

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import generate as jax_generate_cli  # noqa: E402  the root generate.py
from test_torch_train import two_torch_threads  # noqa: F401

B, S = 8, LM["max_seq_len"]
LOSS_TOL, PARAM_RTOL, PARAM_ATOL, STEP_TOL = 2e-5, 5e-4, 5e-5, 1e-4
GAP = 1e-4
STEPS = 3
RUNS = [(n, k) for n in (2, 4) for k in (1, 2)]

_WORKER = r"""
import pickle, sys
import numpy as np
import torch
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.moe import MoETransformerLM
from ps_pytorch_tpu_torch.optim import SGD
from ps_pytorch_tpu_torch.parallel import collectives, dist, ep, tp
from ps_pytorch_tpu_torch.parallel.mesh import make_grid

torch.set_num_threads(1)
dist.initialize_from_env("cpu")
with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
axes = {4: make_grid(data=4, model=1).data,
        2: make_grid(data=2, model=2).model}
gap = [np.inf]

def see(mod, args, out, k):
    p = -np.sort(-torch.softmax(out.detach().float(), -1).numpy(), -1)
    gaps = [p[:, 0] - p[:, 1]] + ([p[:, 1] - p[:, 2]] if k == 2 else [])
    gap[0] = min(gap[0], float(np.min(gaps)))

out = {}
for n, axis in axes.items():
    for k in (1, 2):
        for remat in (False, True):
            model = MoETransformerLM(**inp["lm"], top_k=k, remat=remat)
            model.load_state_dict(convert.from_jax(inp["params"]))
            for mlp in model.moe_layers():
                mlp.router.register_forward_hook(
                    lambda m, a, o, k=k: see(m, a, o, k))
            ep.shard_model_(model, axis)
            step = ep.EPTrainStep(model, SGD(**inp["opt"]), axis)
            before = collectives.stats["bytes_sent"]
            recs = [step(tp.batch_shard(t, axis)) for t in inp["batches"]]
            sent = collectives.stats["bytes_sent"] - before
            params, mom = ep.full_state(model, step.opt_state, axis)
            out[n, k, remat] = dict(
                losses=[float(r["loss"]) for r in recs],
                aux=[float(r["aux"]) for r in recs], sent=sent,
                params={k_: v.numpy() for k_, v in params.items()},
                mom={k_: v.numpy() for k_, v in mom.items()},
                held={k_: tuple(p.shape)
                      for k_, p in model.named_parameters()},
                mom_held={k_: tuple(m.shape)
                          for k_, m in step.opt_state.momentum.items()})
out["gap"] = gap[0]
# all_to_all over the four ranks and its backward.
axis = axes[4]
x = (torch.arange(8 * 3 * 2, dtype=torch.float32).view(8, 3, 2)
     + 100 * dist.rank()).requires_grad_()
y = collectives.all_to_all(x, axis, 0, 1)
g = torch.tensor(np.random.default_rng(dist.rank()).normal(
    size=tuple(y.shape)).astype(np.float32))
y.backward(g)
out["a2a"] = (y.detach().numpy(), g.numpy(), x.grad.numpy())
with open(f"{sys.argv[2]}/rank{dist.rank()}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.shutdown()
print("FINAL ok", flush=True)
"""

# train_lm.main twice in one process group: 3 steps and a checkpoint,
# then the resume to step 5; the checkpoints each writes counted.
_TRAIN = r"""
import json, sys
from ps_pytorch_tpu_torch import train_lm
from ps_pytorch_tpu_torch.parallel import dist
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt

saves = []
save_checkpoint = ckpt.save_checkpoint
def counted(train_dir, step, *args, **kw):
    saves.append(step)
    return save_checkpoint(train_dir, step, *args, **kw)
ckpt.save_checkpoint = counted
argv = sys.argv[1:]
cut = argv.index("--then")
shutdown = dist.shutdown
dist.shutdown = lambda: None
train_lm.main(argv[:cut])
print("SAVES " + json.dumps(saves), flush=True)
print("RESUMING", flush=True)
saves.clear()
dist.shutdown = shutdown
train_lm.main(argv[cut + 1:])
print("SAVES " + json.dumps(saves), flush=True)
"""
TRAIN_ARGS = ["--device", "cpu", "--lm-parallelism", "ep", "--lm-experts",
              "4", "--lm-moe-top-k", "2", "--lm-attention", "flash",
              "--lm-vocab", "256", "--lm-d-model", "32", "--lm-layers", "2",
              "--lm-heads", "2", "--lm-seq-len", "32", "--batch-size", "4",
              "--lm-corpus-tokens", "4000", "--lr", "0.1", "--momentum",
              "0.9", "--log-every", "1"]


def _params():
    m = MoETransformerLM(**LM, generator=torch.Generator().manual_seed(16))
    return convert.to_jax(m.state_dict())[0]


def _jax_ep_checkpoint(root: Path) -> str:
    """The JAX LMTrainer's ep run, its experts sharded over two CPU
    devices: a checkpoint at step 2."""
    td = str(root / "td")
    cfg = jax_config.TrainConfig(
        batch_size=4, lr=0.1, momentum=0.9, max_steps=2, eval_freq=2,
        log_every=10, lm_seq_len=32, lm_d_model=32, lm_layers=2,
        lm_heads=2, lm_vocab=256, lm_corpus_tokens=4000,
        lm_parallelism="ep", lm_experts=4, lm_moe_top_k=2, train_dir=td)
    devices = jax.devices()[:2]
    with pytest.MonkeyPatch.context() as mp, \
            redirect_stdout(io.StringIO()):
        mp.setattr(jax, "devices", lambda *a, **k: devices)
        JaxLMTrainer(cfg).train()
    return td


def _launch_train(root: Path):
    worker = root / "train.py"
    worker.write_text(_TRAIN)
    td = str(root / "td")
    argv = [*TRAIN_ARGS, "--max-steps", "3", "--eval-freq", "3",
            "--train-dir", td, "--then", *TRAIN_ARGS, "--max-steps", "5",
            "--eval-freq", "5", "--train-dir", td]
    rc = []

    def run():
        rc.append(launch.main([
            "launch", "--run-dir", str(root / "run"), "--simulate", "2",
            "--port", str(free_port()), "--entry", str(worker), "--wait",
            "--timeout", "150", "--grace", "1", "--", *argv]))

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        thread.join()
        logs = [(root / "run" / f"proc_{r}.log").read_text()
                for r in range(2)]
        assert rc == [0], "\n\n".join(log[-3000:] for log in logs)
        return td, logs

    return wait


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = _params()
    tok = np.random.default_rng(5)
    batches = [tok.integers(0, LM["vocab_size"], (B, S)).astype(np.int32)
               for _ in range(STEPS)]
    root = tmp_path_factory.mktemp("ep")
    wait_steps = launch_ranks(root, 4, _WORKER, dict(
        lm=LM, params=params, opt=OPT, batches=batches))
    wait_train = _launch_train(tmp_path_factory.mktemp("ep_train"))
    want = {(n, k): _jax_oracle_steps(params, batches, k, n)
            for n, k in RUNS}
    jax_td = _jax_ep_checkpoint(tmp_path_factory.mktemp("jax_ep"))
    return wait_steps(), want, wait_train(), jax_td


def _close(got: dict, want_tree: dict):
    want = convert.from_jax(want_tree)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k].numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("n,top_k", RUNS)
def test_ep_step_matches_the_jax_oracle(runs, n, top_k):
    ranks, want = runs[:2]
    w_losses, w_params, w_mom = want[n, top_k]
    for out in ranks:
        assert out["gap"] >= GAP
        rec = out[n, top_k, False]
        np.testing.assert_allclose(rec["losses"], w_losses, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        assert all(np.isfinite(rec["aux"]))
        _close(rec["params"], w_params)
        _close(rec["mom"], w_mom)


@pytest.mark.parametrize("n", [2, 4])
def test_replicated_params_agree_bitwise_and_remat_changes_nothing(runs, n):
    ranks = runs[0]
    for k in (1, 2):
        base = ranks[0][n, k, False]
        for out in ranks:
            for remat in (False, True):
                rec = out[n, k, remat]
                assert rec["losses"] == base["losses"]
                assert rec["aux"] == base["aux"]
                for name in rec["params"]:
                    np.testing.assert_array_equal(rec["params"][name],
                                                  base["params"][name])
                    np.testing.assert_array_equal(rec["mom"][name],
                                                  base["mom"][name])
                for name, shape in rec["held"].items():
                    whole = rec["params"][name].shape
                    assert rec["mom_held"][name] == shape
                    assert shape == ((whole[0] // n,) + whole[1:]
                                     if ep.is_expert(name) else whole)


@pytest.mark.parametrize("n,top_k", RUNS)
def test_bytes_a_rank_hands_gloo_are_the_shapes_count(runs, n, top_k):
    """Per layer, two all-to-alls of [E, C, D] forward and their two
    backward (a third pair under remat), the replicated gradients in one
    buffer, and the loss and aux sums."""
    ranks = runs[0]
    e, d, layers = LM["n_experts"], LM["d_model"], LM["n_layers"]
    cap = capacity(top_k, B // n * S, e, 1.25)
    params = sum(v.size for v in ranks[0][n, top_k, False]["params"].values())
    experts = sum(v.size for name, v in
                  ranks[0][n, top_k, False]["params"].items()
                  if ep.is_expert(name))
    for remat, a2a in ((False, 4), (True, 6)):
        want = STEPS * (layers * a2a * e * cap * d * 4
                        + (params - experts) * 4 + 8)
        for out in ranks:
            assert out[n, top_k, remat]["sent"] == want


def test_all_to_all_backward_is_the_reverse_all_to_all(runs):
    ranks = runs[0]
    n = len(ranks)
    xs = [np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2) + 100 * r
          for r in range(n)]
    for i, out in enumerate(ranks):
        y, _, grad = out["a2a"]
        np.testing.assert_array_equal(y, np.concatenate(
            [x[2 * i:2 * i + 2] for x in xs], axis=1))
        np.testing.assert_array_equal(grad, np.concatenate(
            [ranks[j]["a2a"][1][:, 3 * i:3 * i + 3] for j in range(n)],
            axis=0))


def _final(log: str) -> list:
    return re.findall(r"^FINAL .*$", log, re.M)


def _saves(log: str) -> list:
    return [json.loads(s) for s in re.findall(r"^SAVES (.*)$", log, re.M)]


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


def test_train_lm_ep_under_the_launcher(runs):
    td, logs = runs[2]
    for r, log in enumerate(logs):
        assert f"DIST process {r}/2" in log
        assert "LM mesh devices=2 parallelism=ep attention=flash" in log
        first, resumed = log.split("RESUMING")
        assert re.findall(r"^STEP (\d+) ", first, re.M) == ["1", "2", "3"]
        assert "RESUME lm at step 3" in resumed
        assert re.findall(r"^STEP (\d+) ", resumed, re.M) == ["4", "5"]
    assert _final(logs[0]) == _final(logs[1]) and len(_final(logs[0])) == 2
    assert [_saves(log) for log in logs] == [[[3], [5]], [[], []]]
    assert ckpt.committed_steps(td) == [3, 5]
    with open(f"{ckpt.checkpoint_path(td, 3)}/config.json") as f:
        saved = json.load(f)
    assert saved["network"] == "MoETransformerLM"
    assert saved["lm_experts"] == 4 and saved["lm_moe_top_k"] == 2
    assert np.isfinite(_eval_both(td, 3)["loss"])


def test_a_jax_ep_checkpoint_is_scored_and_decoded(runs):
    td = runs[3]
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


def test_the_jax_refusals_are_the_ports():
    msgs = []
    for cls in (config.TrainConfig, jax_config.TrainConfig):
        with pytest.raises(ValueError) as e:
            cls(eval_freq=0, lm_parallelism="ep", lm_moe_top_k=3)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    mesh = make_mesh(data=3, model=1, devices=jax.devices()[:3])
    with pytest.raises(ValueError) as e:
        make_ep_train_step(jax_moe.MoETransformerLM(**LM, ep_axis="data"),
                           jax_sgd(**OPT), mesh, None)
    three = Axis("data", [0, 1, 2], 0, None)
    with pytest.raises(ValueError, match=re.escape(str(e.value))):
        ep.shard_model_(MoETransformerLM(**LM), three)
    with pytest.raises(ValueError, match="under expert parallelism each "
                       "device is one dispatch group"):
        model = MoETransformerLM(**LM, n_groups=2)
        ep.shard_model_(model, Axis("data", [0, 1], 0, None))
        model(torch.zeros(2, S, dtype=torch.long))
