"""The port's launch contract on the CPU: the env contract against the JAX
launcher's, the launcher's fleet control (``status``, ``wait``, ``kill``)
on a simulated fleet, the backend rule, the refusals, a world-1 process
group through the real ``initialize_from_env``, and a loader shard against
the JAX loader's bytes.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

from conftest import free_port
from ps_pytorch_tpu.data import datasets as jax_datasets
from ps_pytorch_tpu.tools import launch as jax_launch
from ps_pytorch_tpu_torch import train
from ps_pytorch_tpu_torch.data import datasets
from ps_pytorch_tpu_torch.models import lenet
from ps_pytorch_tpu_torch.optim import SGD
from ps_pytorch_tpu_torch.parallel import dist, make_train_step
from ps_pytorch_tpu_torch.runtime import trainer as trainer_mod
from ps_pytorch_tpu_torch.tools import launch
from test_torch_train import two_torch_threads  # noqa: F401

CONTRACT = (dist.ENV_COORD, dist.ENV_NPROC, dist.ENV_PID)


def test_env_contract_equals_the_jax_launchers():
    assert CONTRACT == ("PS_TPU_COORDINATOR", "PS_TPU_NUM_PROCESSES",
                        "PS_TPU_PROCESS_ID")
    for rank, n in ((0, 1), (1, 3), (2, 3)):
        ours = launch._env_for(rank, n, "10.0.0.7:12355")
        theirs = jax_launch._env_for(rank, n, "10.0.0.7:12355", "", 1)
        assert {k: ours[k] for k in CONTRACT} == \
            {k: theirs[k] for k in CONTRACT}
        assert ours["PYTHONPATH"].split(os.pathsep)[0] == str(launch.REPO)


def test_hostfile_parsing(tmp_path):
    path = tmp_path / "hosts"
    path.write_text("# fleet\nhost-a slots=1\n\n  host-b  # second\n")
    assert launch._read_hostfile(str(path)) == \
        jax_launch._read_hostfile(str(path)) == ["host-a", "host-b"]
    path.write_text("# nobody\n")
    with pytest.raises(ValueError, match="no hosts"):
        launch._read_hostfile(str(path))


def _launch(tmp_path, script, n=2, *extra):
    entry = tmp_path / "entry.py"
    entry.write_text(script)
    run_dir = tmp_path / "run"
    rc = launch.main(["launch", "--run-dir", str(run_dir), "--simulate",
                      str(n), "--port", str(free_port()), "--entry",
                      str(entry), *extra, "--", "arg1"])
    return rc, run_dir


_ENTRY = r"""
import os, sys, time
rank = int(os.environ["PS_TPU_PROCESS_ID"])
print("RANK", rank, "OF", os.environ["PS_TPU_NUM_PROCESSES"], sys.argv[1:])
import ps_pytorch_tpu_torch           # the repository is on PYTHONPATH
if rank == int(os.environ.get("CRASH_RANK", "-1")):
    sys.exit(3)
time.sleep(float(os.environ.get("SLEEP_S", "0")))
print("FINAL done")
"""


def test_launch_wait_status_and_logs(tmp_path, capsys):
    rc, run_dir = _launch(tmp_path, _ENTRY, 3, "--wait", "--timeout", "60")
    assert rc == 0 and "DONE ok=True" in capsys.readouterr().out
    for r in range(3):
        log = (run_dir / f"proc_{r}.log").read_text()
        assert f"RANK {r} OF 3 ['arg1']" in log and "FINAL done" in log
    meta = launch._load_procs(str(run_dir))
    assert meta["n"] == 3 and [p["rank"] for p in meta["procs"]] == [0, 1, 2]
    assert launch.main(["status", "--run-dir", str(run_dir)]) == 1
    assert "STATUS 0/3 alive" in capsys.readouterr().out


def test_wait_ends_the_fleet_when_a_rank_dies(tmp_path, monkeypatch, capsys):
    """Rank 1 exits without FINAL while rank 0 would wait 60 s: wait
    kills rank 0 at once and fails."""
    monkeypatch.setenv("CRASH_RANK", "1")
    monkeypatch.setenv("SLEEP_S", "60")
    t0 = time.monotonic()
    rc, run_dir = _launch(tmp_path, _ENTRY, 2, "--wait", "--timeout", "50",
                          "--grace", "1")
    assert rc == 1 and time.monotonic() - t0 < 30
    assert "DONE ok=False" in capsys.readouterr().out
    meta = launch._load_procs(str(run_dir))
    assert not any(launch._alive(p["pid"]) for p in meta["procs"])


_LEADER_KILL = r"""
import os, sys, time
from ps_pytorch_tpu_torch.resilience import FaultInjector
rank = int(os.environ["PS_TPU_PROCESS_ID"])
if rank == 1:
    if os.environ.get("AFTER"):
        print("FAULT leader_kill: SIGKILL process 1 (leader) at step 3")
        print(os.environ["AFTER"], flush=True)
        os.kill(os.getpid(), 9)
    FaultInjector("leader_kill:step=3", process_index=1).maybe_kill_leader(
        3, is_leader=True)
time.sleep(float(os.environ["SLEEP_S"]))
print("FINAL done")
"""


@pytest.mark.parametrize("after", ["", "a line after the fault"])
def test_wait_lets_a_fleet_outlive_an_intended_leader_kill(
        tmp_path, monkeypatch, capsys, after):
    """A rank whose log ends at the fault plane's FAULT leader_kill line
    died on purpose: wait lets the others finish (and reports 1, one log
    lacking FINAL). Any other death without FINAL still ends the fleet."""
    monkeypatch.setenv("SLEEP_S", "3" if not after else "60")
    monkeypatch.setenv("AFTER", after)
    t0 = time.monotonic()
    rc, run_dir = _launch(tmp_path, _LEADER_KILL, 2, "--wait", "--timeout",
                          "50", "--grace", "1")
    out = capsys.readouterr()
    assert rc == 1 and "DONE ok=False" in out.out
    log0 = (run_dir / "proc_0.log").read_text()
    last1 = (run_dir / "proc_1.log").read_text().strip().splitlines()[-1]
    if after:
        assert last1 == after and "killing fleet" in out.err
        assert "FINAL" not in log0 and time.monotonic() - t0 < 30
    else:
        assert last1 == ("FAULT leader_kill: SIGKILL process 1 (leader) "
                         "at step 3")
        assert "killing fleet" not in out.err and "FINAL done" in log0


def test_status_kill_and_wait_timeout(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SLEEP_S", "60")
    rc, run_dir = _launch(tmp_path, _ENTRY, 2)
    assert rc == 0
    assert launch.main(["status", "--run-dir", str(run_dir)]) == 0
    assert "STATUS 2/2 alive" in capsys.readouterr().out
    assert launch.main(["wait", "--run-dir", str(run_dir), "--timeout",
                        "0.5", "--grace", "1"]) == 2
    meta = launch._load_procs(str(run_dir))
    assert not any(launch._alive(p["pid"]) for p in meta["procs"])
    rc, run_dir = _launch(tmp_path, _ENTRY, 2)
    assert launch.main(["kill", "--run-dir", str(run_dir), "--grace",
                        "1"]) == 0
    assert "KILLED" in capsys.readouterr().out
    meta = launch._load_procs(str(run_dir))
    assert not any(launch._alive(p["pid"]) for p in meta["procs"])


def test_entry_is_a_module_or_a_script():
    assert launch._command(launch.DEFAULT_ENTRY, ["--x"]) == \
        [sys.executable, "-m", "ps_pytorch_tpu_torch.train", "--x"]
    assert launch._command("chip_smoke.py", ["--rank"]) == \
        [sys.executable, "chip_smoke.py", "--rank"]


def test_devices_per_host_other_than_one_raises(tmp_path):
    with pytest.raises(ValueError, match="one process a replica"):
        launch.main(["launch", "--run-dir", str(tmp_path / "run"),
                     "--simulate", "2", "--devices-per-host", "2"])
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("device_type,ranks_on_host,cards,want", [
    ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"), ("cuda", 2, 8, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo"),
    ("cpu", 1, 0, "gloo"), ("cpu", 4, 0, "gloo")])
def test_backend_rule(device_type, ranks_on_host, cards, want):
    assert dist.choose_backend(device_type, ranks_on_host, cards) == want


def test_backend_rule_refuses_other_devices():
    with pytest.raises(ValueError, match="mps"):
        dist.choose_backend("mps", 1, 1)


def _clear_env(monkeypatch):
    for name in CONTRACT + ("WORLD_SIZE",):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("env,match", [
    ({"PS_TPU_NUM_PROCESSES": "2"}, "without PS_TPU_COORDINATOR"),
    ({"WORLD_SIZE": "2"}, "tools.launch"),
    ({"PS_TPU_COORDINATOR": "127.0.0.1:1", "PS_TPU_NUM_PROCESSES": "2"},
     "without PS_TPU_PROCESS_ID"),
    ({"PS_TPU_COORDINATOR": "127.0.0.1:1", "PS_TPU_NUM_PROCESSES": "2",
      "PS_TPU_PROCESS_ID": "2"}, "0 <= rank < world")])
def test_a_partial_contract_raises(env, match, monkeypatch):
    _clear_env(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        dist.initialize_from_env("cpu")
    assert not torch.distributed.is_initialized()


def test_no_contract_is_one_process(monkeypatch):
    _clear_env(monkeypatch)
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "1")
    assert dist.initialize_from_env("cpu") is None
    assert (dist.rank(), dist.world(), dist.backend(), dist.group()) == \
        (0, 1, "none", None)
    assert dist.local_data_shard() == (0, 1)


def test_gloo_peer_wait_is_the_host_clock_around_each_collective(
        monkeypatch):
    """On gloo ``comm_s`` stays the host clock around each collective (a
    fake clock a quarter second a read: the step's two all-reduces, loss
    pair and gradient, read it twice each); no CUDA event is taken."""
    from ps_pytorch_tpu_torch.parallel import dp

    _clear_env(monkeypatch)
    monkeypatch.setenv("PS_TPU_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("PS_TPU_PROCESS_ID", "0")
    try:
        dist.initialize_from_env("cpu")
        model = lenet.LeNet(generator=torch.Generator().manual_seed(1))
        step = make_train_step(model, SGD(0.1, momentum=0.9),
                               group=dist.group())
        rng = np.random.default_rng(0)
        x = rng.normal(size=(4, 28, 28, 1)).astype(np.float32)
        y = rng.integers(0, 10, 4).astype(np.int32)
        reads = iter(0.25 * i for i in range(100))
        monkeypatch.setattr(dp.time, "monotonic", lambda: next(reads))
        step(x, y, np.ones(1, np.float32))
        assert not step._on_stream and step._comm_events == []
        assert step.comm_s == 0.5
        step(x, y, np.ones(1, np.float32))      # reset at every call
        assert step.comm_s == 0.5
    finally:
        monkeypatch.undo()
        dist.shutdown()


def test_world_one_group_through_the_contract(monkeypatch):
    """A one-rank launch joins a real group (gloo on the CPU); a second
    call returns the same store; the step all-reduces at world 1 and
    equals the step without a group."""
    _clear_env(monkeypatch)
    monkeypatch.setenv("PS_TPU_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("PS_TPU_PROCESS_ID", "0")
    try:
        store = dist.initialize_from_env("cpu")
        assert store is not None and dist.initialize_from_env("cpu") is store
        assert (dist.backend(), dist.world(), dist.is_multiprocess()) == \
            ("gloo", 1, False)
        assert dist.local_device("cpu") == torch.device("cpu")
        rng = np.random.default_rng(0)
        x = rng.normal(size=(4, 28, 28, 1)).astype(np.float32)
        y = rng.integers(0, 10, 4).astype(np.int32)
        states = []
        for group in (dist.group(), None):
            model = lenet.LeNet(generator=torch.Generator().manual_seed(1))
            step = make_train_step(model, SGD(0.1, momentum=0.9),
                                   group=group)
            for _ in range(2):
                step(x, y, np.ones(1, np.float32))
            states.append(model.state_dict())
            assert (step.comm_s > 0) == (group is not None)
        for k in states[0]:
            assert torch.equal(states[0][k], states[1][k]), k
    finally:
        dist.shutdown()
    assert not torch.distributed.is_initialized() and dist.store() is None


def test_train_leaves_the_group_on_error(monkeypatch):
    """train.main joins the world-1 group before any model is built and
    leaves it on the way out, also when the trainer raises."""
    _clear_env(monkeypatch)
    monkeypatch.setenv("PS_TPU_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("PS_TPU_PROCESS_ID", "0")
    joined = []

    def broken(self, *args, **kw):
        joined.append(torch.distributed.is_initialized())
        raise RuntimeError("broken trainer")

    monkeypatch.setattr(trainer_mod.Trainer, "__init__", broken)
    with pytest.raises(RuntimeError, match="broken trainer"):
        train.main(["--network", "LeNet", "--dataset", "synthetic_mnist",
                    "--eval-freq", "0", "--device", "cpu"])
    assert joined == [True] and not torch.distributed.is_initialized()


@pytest.mark.parametrize("dataset", ["synthetic_mnist", "synthetic_cifar10"])
def test_loader_shard_matches_jax_bytes(dataset):
    """Shard host_id=1 of 2 (and 0 of 2), the train split across an epoch
    boundary: the same bytes as the JAX loader's."""
    h, w, c = datasets.sample_shape(dataset)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(90, h, w, c), dtype=np.uint8)
    y = rng.integers(0, 10, 90).astype(np.int32)
    for host_id in (1, 0):
        kw = dict(dataset=dataset, train=True, seed=7, host_id=host_id,
                  num_hosts=2, device_normalize=True)
        ours = datasets.DataLoader(x, y, 16, **kw)
        theirs = jax_datasets.DataLoader(x, y, 16, **kw)
        for _ in range(7):
            (a, ay), (b, by) = ours.next_batch(), theirs.next_batch()
            assert a.shape == (8, h, w, c) and a.tobytes() == b.tobytes()
            np.testing.assert_array_equal(ay, by)
