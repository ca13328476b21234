"""The port's multi-process slice end to end on the CPU: ``tools.launch
launch --simulate N`` running ``train`` with ``--device cpu`` over gloo,
against the JAX package.

- K-of-N with an injected straggler on process 0 (the leader, which the
  duration-free tiebreak would keep): its published masks end with it
  dropped; only process 0 writes checkpoints; process 1 writes
  ``m.jsonl.p1``; every rank prints the same FINAL line and ends with the
  same parameters, bitwise.
- Against the JAX package: the masks that process 0 published (its MASK
  lines) replayed through the JAX ``make_train_step`` on an N-device mesh,
  from the port's initial weights, on the concatenation of the JAX
  loader's N shards: process 0's last checkpoint equals the JAX parameters
  within ``TOL``. Sync mode equals the same JAX run with all-ones masks.
- ZeRO-1 (``--shard-update``) checkpoints: one the port's two ranks
  wrote is resumed by the JAX ZeRO trainer on two CPU devices, and one the
  JAX ZeRO trainer wrote is resumed by the port's ranks, each rank taking
  its slice of the JAX layout ``[world, chunk]``.
- BatchNorm and resume: ``test_torch_dist_state.py``, with this file's
  launcher.

Every launch has a time limit and kills its fleet when it ends.
"""

import json
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from conftest import free_port
from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.data import augment as jax_augment
from ps_pytorch_tpu.data import datasets as jax_datasets
from ps_pytorch_tpu.models import build_model as jax_build_model
from ps_pytorch_tpu.optim import build_optimizer as jax_build_optimizer
from ps_pytorch_tpu.parallel import (
    create_train_state, make_mesh, make_train_step as jax_make_train_step,
)
from ps_pytorch_tpu.runtime.trainer import Trainer as JaxTrainer
from ps_pytorch_tpu_torch.models import build_model, convert
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.tools import launch

TOL = 1e-4          # tests/test_torch_train.py's
STEPS = 6
# Runs train.run in each rank: counts the checkpoints this process writes,
# optionally swaps in the small BatchNorm network and data set, and keeps
# the rank's final state and evaluation.
_WORKER = r"""
import json, os, sys
import torch
from ps_pytorch_tpu_torch import train
from ps_pytorch_tpu_torch.data import datasets
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime import trainer as trainer_mod

saves = []
save_checkpoint = ckpt.save_checkpoint
def counted(train_dir, step, *args, **kw):
    saves.append(step)
    return save_checkpoint(train_dir, step, *args, **kw)
ckpt.save_checkpoint = counted
if os.environ.get("BN_SAMPLES"):
    from ps_pytorch_tpu_torch.models.resnet import BasicBlock, ResNet
    datasets.DATASET_SHAPES["synthetic_cifar10"] = (
        32, 32, 3, 10, int(os.environ["BN_SAMPLES"]))
    trainer_mod.build_model = lambda name, n, dtype, impl, seed: ResNet(
        BasicBlock, (1, 1, 1, 1), n, generator=torch.Generator().manual_seed(
            seed))
trainer, result = train.run(sys.argv[1:])
torch.save({k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()},
           f"{os.environ['OUT_DIR']}/state_{trainer.rank}.pt")
opt = trainer.step_fn.opt_state
torch.save({f: {k: v.detach().clone() for k, v in (getattr(opt, f) or {}).items()}
            for f in ("momentum", "exp_avg", "exp_avg_sq") if hasattr(opt, f)},
           f"{os.environ['OUT_DIR']}/opt_{trainer.rank}.pt")
print("RESULT " + json.dumps({"saves": saves, "eval": result}), flush=True)
"""


def _launch(tmp_path, n, train_args, env=None, run="run"):
    """Run a fleet of n ranks to its end; returns each rank's log."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    run_dir = tmp_path / run
    mp = pytest.MonkeyPatch()
    mp.setenv("OUT_DIR", str(tmp_path))
    mp.setenv("OMP_NUM_THREADS", "2")       # ranks share the test's cores
    for k, v in (env or {}).items():
        mp.setenv(k, v)
    try:
        rc = launch.main(["launch", "--run-dir", str(run_dir), "--simulate",
                          str(n), "--port", str(free_port()), "--entry",
                          str(worker), "--wait", "--timeout", "120",
                          "--grace", "1", "--", "--device", "cpu",
                          *train_args])
    finally:
        mp.undo()
        launch.main(["kill", "--run-dir", str(run_dir), "--grace", "1"])
    logs = [(run_dir / f"proc_{r}.log").read_text() for r in range(n)]
    assert rc == 0, "\n\n".join(log[-3000:] for log in logs)
    return logs


def _result(log):
    return json.loads(log.split("RESULT ", 1)[1].splitlines()[0])


def _args(tmp_path, batch, *extra):
    return ["--network", "LeNet", "--dataset", "synthetic_mnist",
            "--batch-size", str(batch), "--compute-dtype", "float32",
            "--lr", "0.05", "--momentum", "0.9", "--max-steps", str(STEPS),
            "--eval-freq", "3", "--resume", "false", "--log-every", "1",
            "--test-batch-size", "2000", "--train-dir", str(tmp_path / "td"),
            "--metrics-file", str(tmp_path / "m.jsonl"), *extra]


def _masks(leader_log, n):
    """Each step's mask, from the MASK lines (printed when it changes)."""
    changes = {int(s): json.loads(m) for s, m in re.findall(
        r"^MASK step (\d+) (\[.*\])$", leader_log, re.M)}
    masks, cur = [], None
    for step in range(1, STEPS + 1):
        cur = changes.get(step, cur)
        masks.append(np.asarray(cur, np.float32))
    assert all(len(m) == n for m in masks)
    return masks


def _jax_replay(n, batch, seed=42):
    """The JAX make_train_step on an n-device mesh from the port's initial
    LeNet weights, fed the JAX loader's n shards side by side. Returns
    ``replay(masks)``: the parameters after one step a mask. The step is
    compiled here (one step on throwaway inputs), so that a thread can
    build it while the port's ranks run."""
    kw = dict(network="LeNet", dataset="synthetic_mnist", batch_size=batch,
              compute_dtype="float32", lr=0.05, momentum=0.9, eval_freq=0,
              seed=seed)
    jcfg = jax_config.TrainConfig(**kw)
    mesh = make_mesh(data=n)
    model = jax_build_model("LeNet", 10, "float32")
    tx = jax_build_optimizer(jcfg)
    state = create_train_state(model, tx, mesh, (1, 28, 28, 1),
                               jax.random.key(0))
    params = convert.to_jax(build_model("LeNet", seed=seed).state_dict())[0]
    replicated = NamedSharding(mesh, P())
    params = jax.device_put(params, replicated)
    state = state.replace(params=params,
                          opt_state=jax.device_put(tx.init(params),
                                                   replicated))
    input_norm = jax_augment.input_norm_for(jcfg)
    step = jax_make_train_step(model, tx, mesh, state, donate=False,
                               input_norm=input_norm)
    x, y = jax_datasets.load_arrays("synthetic_mnist", seed=seed)
    loaders = [jax_datasets.DataLoader(
        x, y, batch, "synthetic_mnist", seed=seed, host_id=r, num_hosts=n,
        device_normalize=input_norm is not None) for r in range(n)]

    def batches():
        parts = [loader.next_batch() for loader in loaders]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    first = batches()
    step(state, *first, np.ones(n, np.float32), jax.random.key(0))

    def replay(masks):
        st = state
        for k, mask in enumerate(masks):
            xb, yb = first if k == 0 else batches()
            st, _ = step(st, xb, yb, mask, jax.random.key(k))
        return jax.device_get(st.params)

    return replay


def _jax_params(n, batch, masks, seed=42):
    """The JAX parameters after one step a mask (``_jax_replay``)."""
    return _jax_replay(n, batch, seed)(masks)


def _launch_beside_jax(n, batch, masks_of, launch):
    """``launch()``, while the JAX replay compiles in a thread; then (its
    logs, the masks ``masks_of(logs)``, the JAX parameters after them)."""
    with ThreadPoolExecutor(1) as pool:
        replay = pool.submit(_jax_replay, n, batch)
        logs = launch()
        masks = masks_of(logs)
        return logs, masks, replay.result()(masks)


def _checkpoint_params(train_dir, step):
    got = {}
    ckpt.load_checkpoint(str(train_dir), step,
                         lambda tree: got.update(tree))
    return got["params"]


def _assert_tree_close(a, b):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_close(a[k], b[k])
        else:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)


def _assert_ranks_equal(tmp_path, logs):
    finals = [re.findall(r"^FINAL .*$", log, re.M) for log in logs]
    assert all(len(f) == 1 for f in finals) and len(set(
        f[0] for f in finals)) == 1, finals
    states = [torch.load(tmp_path / f"state_{r}.pt")
              for r in range(len(logs))]
    for other in states[1:]:
        for k, v in states[0].items():
            if "running" not in k:      # BatchNorm statistics are local
                assert torch.equal(v, other[k]), k


@pytest.mark.parametrize("n,k", [(2, 1), (3, 2)])
def test_kofn_drops_the_straggling_leader_and_matches_jax(tmp_path, n, k):
    batch = 16 * n
    logs, masks, theirs = _launch_beside_jax(
        n, batch, lambda logs: _masks(logs[0], n), lambda: _launch(
            tmp_path, n, _args(
                tmp_path, batch, "--mode", "kofn", "--num-aggregate",
                str(k), "--inject-step-delay", "0.3",
                "--inject-delay-process", "0")))
    assert all(f"MESH data={n} model=1 devices={n} backend=gloo device=cpu"
               in log for log in logs)
    assert masks[0].tolist() == [1] * k + [0] * (n - k)   # no durations yet
    assert masks[-1].tolist() == [0] + [1] * (n - 1)      # process 0 out
    assert not any(line.startswith("MASK") for log in logs[1:]
                   for line in log.splitlines())
    steps = [json.loads(ln) for ln in
             (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in steps] == list(range(1, STEPS + 1))
    assert all(r["participating"] == k for r in steps)
    for r in range(1, n):
        assert len((tmp_path / f"m.jsonl.p{r}").read_text().splitlines()) \
            == STEPS
    assert [_result(log)["saves"] for log in logs] == \
        [[3, STEPS]] + [[]] * (n - 1)
    assert ckpt.committed_steps(str(tmp_path / "td")) == [3, STEPS]
    _assert_ranks_equal(tmp_path, logs)
    _assert_tree_close(_checkpoint_params(tmp_path / "td", STEPS), theirs)


def test_sync_matches_jax_with_all_ones_masks(tmp_path):
    logs, masks, theirs = _launch_beside_jax(
        2, 32, lambda logs: _masks(logs[0], 2),
        lambda: _launch(tmp_path, 2, _args(tmp_path, 32)))
    assert all(m.tolist() == [1, 1] for m in masks)
    _assert_ranks_equal(tmp_path, logs)
    _assert_tree_close(_checkpoint_params(tmp_path / "td", STEPS), theirs)


# ---- the ZeRO-1 checkpoint across the two packages ----

def _mesh(n):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(n, 1),
                             ("data", "model"))


def _zero_cfg(train_dir, **kw):
    base = dict(network="LeNet", dataset="synthetic_mnist", batch_size=32,
                compute_dtype="float32", lr=0.05, momentum=0.9,
                fused_optimizer=True, shard_update=True, max_steps=2,
                eval_freq=2, train_dir=str(train_dir), seed=3)
    base.update(kw)
    return base


def _flags(kw):
    out = []
    for k, v in kw.items():
        out += ["--" + k.replace("_", "-"), str(v).lower()
                if isinstance(v, bool) else str(v)]
    return out


def _tree(train_dir, step):
    got = {}
    ckpt.load_checkpoint(str(train_dir), step, got.update)
    return got


def _assert_tree_equal(a, b):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


def _jax_flat(port_flat):
    """LeNet's parameter-shaped vector in the port's flat order
    (``named_parameters``, its layouts) -> the JAX flat order
    (``ravel_pytree`` of the flax tree)."""
    named, off = {}, 0
    for name, p in build_model("LeNet").named_parameters():
        named[name] = torch.from_numpy(
            port_flat[off:off + p.numel()].reshape(p.shape))
        off += p.numel()
    tree = convert.to_jax(named)[0]
    return np.concatenate([np.asarray(leaf).reshape(-1)
                           for leaf in jax.tree.leaves(tree)])


def test_port_zero_checkpoint_resumed_by_jax(tmp_path):
    kw = _zero_cfg(tmp_path / "td")
    _launch(tmp_path, 2, _flags({**kw, "resume": False}))
    ours = _tree(tmp_path / "td", 2)
    # The ranks' slices, joined in the port's order, are the checkpoint's
    # [2, chunk] in the JAX order.
    slices = [torch.load(tmp_path / f"opt_{r}.pt")["momentum"]["shard"]
              for r in range(2)]
    stored = ours["opt_state"]["momentum"]
    size = sum(p.numel() for p in build_model("LeNet").parameters())
    assert stored.shape == (2, -(-size // 2))
    np.testing.assert_array_equal(
        stored.reshape(-1)[:size],
        _jax_flat(torch.cat(slices).numpy()[:size]))
    trainer = JaxTrainer(jax_config.TrainConfig(**kw, resume=True),
                         mesh=_mesh(2))
    assert trainer.start_step == 2
    state = jax.device_get(trainer.state)
    _assert_tree_equal(ours["params"], state.params)
    np.testing.assert_array_equal(stored,
                                  np.asarray(state.opt_state.momentum))


def test_jax_zero_checkpoint_resumed_by_the_port(tmp_path):
    kw = _zero_cfg(tmp_path / "td")
    JaxTrainer(jax_config.TrainConfig(**kw, resume=False),
               mesh=_mesh(2)).train()
    theirs = _tree(tmp_path / "td", 2)
    # Resumed at its last step: every rank restores and trains no further.
    logs = _launch(tmp_path, 2, _flags({**kw, "resume": True}),
                   run="resumed")
    for log in logs:
        assert f"RESUME from {tmp_path / 'td'}/model_step_2 at step 2" in log
    slices = []
    for r in range(2):
        state = torch.load(tmp_path / f"state_{r}.pt")
        _assert_tree_equal(convert.to_jax(state)[0], theirs["params"])
        slices.append(torch.load(tmp_path / f"opt_{r}.pt")
                      ["momentum"]["shard"])
    size = sum(p.numel() for p in build_model("LeNet").parameters())
    np.testing.assert_array_equal(
        _jax_flat(torch.cat(slices).numpy()[:size]),
        np.asarray(theirs["opt_state"]["momentum"]).reshape(-1)[:size])
