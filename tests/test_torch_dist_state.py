"""Training state across processes on the CPU, two gloo ranks through
``tools.launch`` (with ``test_torch_dist.py``'s launcher):

- BatchNorm: each rank evaluates with replica 0's statistics (broadcast
  from process 0), so rank 1's ``evaluate()`` equals rank 0's, and both
  equal the evaluator on process 0's checkpoint, which holds every
  replica's statistics in rank order.
- Resume: every rank restores the newest checkpoint (its own replica's
  BatchNorm statistics) and fast-forwards its own shard, so a run resumed
  at step 2 ends bitwise where an uninterrupted one does.
"""

import numpy as np
import torch

from ps_pytorch_tpu_torch.data import datasets
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.resnet import BasicBlock, ResNet
from ps_pytorch_tpu_torch.optim import SGD
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime import evaluator as evaluator_mod
from test_torch_dist import _launch, _result
from test_torch_train import two_torch_threads  # noqa: F401

# The smallest BatchNorm network the port's tests train (one BasicBlock a
# stage), on a cut synthetic CIFAR-10 so that a CPU evaluates it quickly.
BN_SAMPLES = 300
# The end-to-end step options' run: lr 0.01, because at this file's 0.05
# the two packages' parameters after two steps differ by up to 2.6e-4 on
# this network whether or not any option is on (the replicated step with
# no option gives the same gap): the gradients' rounding differences near
# the ReLU kinks, times the learning rate.
E2E_BATCH, E2E_LR, E2E_SEED = 8, 0.01, 42


def _bn_args(train_dir, steps, resume="false"):
    """ResNet18 in the flags; the worker builds the small network."""
    return ["--network", "ResNet18", "--dataset", "synthetic_cifar10",
            "--batch-size", "8", "--compute-dtype", "float32", "--lr", "0.05",
            "--momentum", "0.9", "--max-steps", str(steps), "--eval-freq",
            "2", "--resume", resume, "--test-batch-size", "100",
            "--train-dir", str(train_dir)]


def test_batchnorm_evaluation_uses_replica_zeros_statistics(
        tmp_path, monkeypatch):
    logs = _launch(tmp_path, 2, _bn_args(tmp_path / "td", 2),
                   env={"BN_SAMPLES": str(BN_SAMPLES)})
    results = [_result(log) for log in logs]
    assert results[0]["eval"] == results[1]["eval"]
    states = [torch.load(tmp_path / f"state_{r}.pt") for r in range(2)]
    name = "bn1.running_mean"           # each replica its own statistics
    assert not torch.equal(states[0][name], states[1][name])
    # The checkpoint holds both replicas' statistics, in rank order.
    tree = {}
    ckpt.load_checkpoint(str(tmp_path / "td"), 2, tree.update)
    stats = tree["batch_stats"]["bn1"]["mean"]
    assert stats.shape[0] == 2
    for r in range(2):
        np.testing.assert_array_equal(stats[r], states[r][name].numpy())
    # The evaluator on process 0's checkpoint (same network and data set).
    monkeypatch.setitem(datasets.DATASET_SHAPES, "synthetic_cifar10",
                        (32, 32, 3, 10, BN_SAMPLES))
    monkeypatch.setattr(
        evaluator_mod, "build_model",
        lambda name, n, dtype, impl: ResNet(BasicBlock, (1, 1, 1, 1), n))
    got = evaluator_mod.Evaluator(str(tmp_path / "td"), device="cpu",
                                  printer=lambda line: None).evaluate_step(2)
    for key in ("loss", "prec1", "prec5"):
        np.testing.assert_allclose(got[key], results[0]["eval"][key],
                                   rtol=1e-6, atol=0)


def test_resume_restores_each_replica_and_its_shard(tmp_path):
    env = {"BN_SAMPLES": str(BN_SAMPLES)}
    _launch(tmp_path, 2, _bn_args(tmp_path / "td", 2), env, run="first")
    logs = _launch(tmp_path, 2, _bn_args(tmp_path / "td", 4, "true"), env,
                   run="resumed")
    for log in logs:
        assert f"RESUME from {tmp_path / 'td'}/model_step_2 at step 2" in log
        assert [ln.split()[1] for ln in log.splitlines()
                if ln.startswith("STEP")] == ["3", "4"]
    resumed = [torch.load(tmp_path / f"state_{r}.pt") for r in range(2)]
    _launch(tmp_path, 2, _bn_args(tmp_path / "whole", 4), env, run="whole")
    whole = [torch.load(tmp_path / f"state_{r}.pt") for r in range(2)]
    for r in range(2):
        for k, v in whole[r].items():
            assert torch.equal(resumed[r][k], v), (r, k)
    a, b = {}, {}
    ckpt.load_checkpoint(str(tmp_path / "td"), 4, a.update)
    ckpt.load_checkpoint(str(tmp_path / "whole"), 4, b.update)
    for (_, x), (_, y) in zip(sorted(_leaves(a)), sorted(_leaves(b))):
        np.testing.assert_array_equal(x, y)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_checkpoint_replica_axis_round_trips():
    """state_to_jax stacks each replica's statistics; state_from_jax gives
    a replica its own, and replica 0's when the checkpoint holds fewer."""
    model = ResNet(BasicBlock, (1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(0))
    opt_state = SGD(0.1, momentum=0.9).init(dict(model.named_parameters()))
    replicas = [{k: torch.full_like(v, float(r + 1))
                 for k, v in model.named_buffers()} for r in range(2)]
    tree = convert.state_to_jax(model, opt_state, 3, replicas)
    assert tree["batch_stats"]["bn1"]["mean"].shape == (2, 64)
    for replica, want in ((0, 1.0), (1, 2.0), (5, 1.0)):
        convert.state_from_jax(tree, model, replica=replica)
        assert all(bool((b == want).all()) for _, b in model.named_buffers())
    own = convert.state_to_jax(model, opt_state, 3)
    assert own["batch_stats"]["bn1"]["var"].shape == (1, 64)



def test_sync_batchnorm_remat_zero_and_the_pool_match_jax(tmp_path,
                                                          monkeypatch):
    """``train`` with ``--shard-update --sync-batchnorm --remat
    --loader-workers 2 --heartbeat-interval-s 0.5`` on two ranks: every
    rank ends with the same parameters and the same (synced) statistics,
    which the checkpoint holds on both replica rows, and both equal the
    JAX ``make_zero_train_step(sync_batchnorm=True, remat=True)`` on a
    two-device mesh from the port's initial weights, fed the JAX
    loader's two shards from its pool of 2 workers (TOL 1e-4)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ps_pytorch_tpu import config as jax_config
    from ps_pytorch_tpu.data import augment as jax_augment
    from ps_pytorch_tpu.data import datasets as jax_datasets
    from ps_pytorch_tpu.models import resnet as jax_resnet
    from ps_pytorch_tpu.optim import build_optimizer as jax_build_optimizer
    from ps_pytorch_tpu.parallel.zero import (
        create_zero_train_state, make_zero_train_step,
    )
    from test_torch_dist import TOL

    steps, batch, lr, seed = 2, E2E_BATCH, E2E_LR, E2E_SEED
    args = _bn_args(tmp_path / "td", steps) + [
        "--shard-update", "--sync-batchnorm", "--remat", "--loader-workers",
        "2", "--heartbeat-interval-s", "0.5", "--seed", str(seed),
        "--batch-size", str(batch), "--lr", str(lr)]
    _launch(tmp_path, 2, args, {"BN_SAMPLES": str(BN_SAMPLES)})
    states = [torch.load(tmp_path / f"state_{r}.pt") for r in range(2)]
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k
    tree = {}
    ckpt.load_checkpoint(str(tmp_path / "td"), steps, tree.update)
    for _, rows in _leaves(tree["batch_stats"]):
        np.testing.assert_array_equal(rows[0], rows[1])

    # The JAX step on the same weights and the JAX pool's shards.
    monkeypatch.setitem(jax_datasets.DATASET_SHAPES, "synthetic_cifar10",
                        (32, 32, 3, 10, BN_SAMPLES))
    jcfg = jax_config.TrainConfig(
        network="ResNet18", dataset="synthetic_cifar10", batch_size=batch,
        compute_dtype="float32", lr=lr, momentum=0.9, eval_freq=0,
        seed=seed)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    model = jax_resnet.ResNet(jax_resnet.BasicBlock, (1, 1, 1, 1), 10)
    tx = jax_build_optimizer(jcfg)
    state = create_zero_train_state(model, tx, mesh, (1, 32, 32, 3),
                                    jax.random.key(0))
    init = ResNet(BasicBlock, (1, 1, 1, 1), 10,
                  generator=torch.Generator().manual_seed(seed))
    params = convert.to_jax(init.state_dict())[0]
    state = state.replace(params=jax.device_put(params,
                                                NamedSharding(mesh, P())))
    input_norm = jax_augment.input_norm_for(jcfg)
    step = make_zero_train_step(model, tx, mesh, state, sync_batchnorm=True,
                                remat=True, donate=False,
                                input_norm=input_norm)
    x, y = jax_datasets.load_arrays("synthetic_cifar10", seed=seed)
    loaders = [jax_datasets.DataLoader(
        x, y, batch, "synthetic_cifar10", seed=seed, host_id=r, num_hosts=2,
        device_normalize=input_norm is not None, workers=2)
        for r in range(2)]
    for k in range(steps):
        parts = [loader.next_batch() for loader in loaders]
        state, _ = step(state, np.concatenate([p[0] for p in parts]),
                        np.concatenate([p[1] for p in parts]),
                        np.ones(2, np.float32), jax.random.key(k))
    state = jax.device_get(state)
    ours = dict(_leaves(tree["params"]))
    for name, want in _leaves(state.params):
        np.testing.assert_allclose(ours[name], want, rtol=TOL, atol=TOL,
                                   err_msg=name)
    ours = dict(_leaves(tree["batch_stats"]))
    for name, want in _leaves(state.batch_stats):
        np.testing.assert_allclose(ours[name], want, rtol=TOL, atol=TOL,
                                   err_msg=name)
