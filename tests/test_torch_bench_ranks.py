"""The port's bench rows over the ranks of a launch, on the CPU: two gloo
ranks with ``--device cpu`` against the JAX suite over a 2-device CPU mesh.

- **The train-step rows.** Each rank of a launch runs the LeNet row of
  ``bench_suite.bench_throughput`` (f32, a small per-rank batch) from the
  JAX ``_build``'s init, converted with ``models/convert.py``: K-of-N at
  ``num_aggregate=1`` (mask ``[1, 0]``), sync (``[1, 1]``) and ZeRO-1
  (``shard_update``). After the row's warm-up and timed steps every
  rank's parameters equal the JAX ``_build(..., n_devices=2)`` state
  after the same steps, at ``TOL``; each rank's inputs are the JAX global
  batch's rows for its device.
- **The LM rows** at a small geometry: the ring row over the two ranks
  and the ep row over them reach the one-rank row's losses from the same
  init (the MoE's oracle in two dispatch groups, one a rank) at the LM
  parity tolerance of ``tests/test_torch_ring.py`` / ``test_torch_ep.py``.
- **The rows as a user gets them.** ``python -m
  ps_pytorch_tpu_torch.bench_suite --device cpu --ranks 2`` prints each
  spanning row once (rank 0 writes it) with ``devices`` 2, ``global_batch``
  2 x per and ``backend`` ``gloo``; ``lenet_mnist_single`` and a pinned
  attention row record ``devices`` 1.

Every launch has a time limit and kills its fleet when it ends.
"""

import functools
import json
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest

import bench_suite as jax_suite
from conftest import free_port
from ps_pytorch_tpu_torch import bench_suite
from ps_pytorch_tpu_torch.models import convert, moe
from ps_pytorch_tpu_torch.tools import launch
from test_torch_train import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4                       # tests/test_torch_train.py's
LM_LOSS_TOL = 2e-5               # test_torch_ring.py's and test_torch_ep.py's
PER = 16                         # images a rank
STEPS = 1                        # timed steps, after the row's 3 warm-up
ROWS = {"lenet_kofn": dict(mode="kofn", num_aggregate=1),
        "lenet_sync": {},
        "lenet_zero1": dict(shard_update=True)}
LM = dict(batch=4, seq_len=16, d_model=32, n_layers=2, n_heads=2, vocab=64)
MOE = dict(LM, n_experts=4)

# A rank of the launch: the LeNet rows from the given init, the LM rows;
# each row's inputs, mask, final parameters and step losses kept.
_WORKER = r"""
import pickle, sys
import torch
from ps_pytorch_tpu_torch import bench_suite, models
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.parallel import dist

torch.set_num_threads(1)
with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
init, seen = {}, {}
build = models.build_model

def build_model(name, *args, **kw):
    model = build(name, *args, **kw)
    model.load_state_dict(convert.from_jax(init["params"]))
    return model

time_steps = bench_suite.time_steps

def kept(state, step_fn, x, y, mask, **kw):
    out = time_steps(state, step_fn, x, y, mask, **kw)
    seen.update(x=x.numpy().copy(), y=y.numpy().copy(), mask=list(mask),
                params=convert.to_jax(state.state_dict())[0])
    return out

timed_steps = bench_suite._timed_steps

def lm_kept(step, tokens, steps, dev):
    losses = []

    def recorded(t):
        m = step(t)
        losses.append(float(m["loss"]))
        return m

    out = timed_steps(recorded, tokens, steps, dev)
    seen.update(losses=losses)
    return out

models.build_model = build_model
bench_suite.time_steps = kept
bench_suite._timed_steps = lm_kept
bench_suite.DEVICE = "cpu"
try:
    dist.initialize_from_env("cpu")
    bench_suite.DEVICES = dist.world()
    out = {}
    for name, kw in inp["rows"].items():
        init["params"] = inp["params"][name]
        row = bench_suite.bench_throughput(name, "LeNet", "synthetic_mnist",
                                           inp["per"], inp["steps"],
                                           dtype="float32", **kw)
        out[name] = dict(seen, row=row)
    out["lm"] = dict(row=bench_suite.bench_transformer_lm(
        "lm", inp["steps"], **inp["lm"]), losses=seen["losses"])
    out["moe"] = dict(row=bench_suite.bench_moe_lm(
        "moe", inp["steps"], **inp["moe"]), losses=seen["losses"])
    with open(f"{sys.argv[2]}/rank{dist.rank()}.pkl", "wb") as f:
        pickle.dump(out, f)
finally:
    dist.shutdown()
print("FINAL ok", flush=True)
"""


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_builds():
    """Each LeNet row of the JAX ``_build`` over two devices, and its
    init."""
    builds = {}
    for name, kw in ROWS.items():
        built = jax_suite._build("LeNet", "synthetic_mnist", 2 * PER,
                                 n_devices=2, dtype="float32", **kw)
        builds[name] = (built, jax.device_get(built[0].params))
    return builds


def _jax_rows(builds):
    """Each row's global batch, mask and parameters after the suite's 3
    warm-up and ``STEPS`` timed steps (``time_steps``' loop)."""
    got = {}
    for name, ((state, step_fn, x, y, mask), _) in builds.items():
        for i in [*range(3), *(100 + j for j in range(STEPS))]:
            state, _ = step_fn(state, x, y, mask, jax.random.key(i))
        got[name] = dict(x=np.asarray(x), y=np.asarray(y),
                         mask=np.asarray(mask).tolist(),
                         params=_flat(jax.device_get(state.params)))
    return got


def _one_rank_lm(monkeypatch):
    """The one-rank rows' losses (the MoE in two dispatch groups) and
    rows, in this process."""
    seen = {}
    timed = bench_suite._timed_steps

    def lm_kept(step, tokens, steps, dev):
        losses = []

        def recorded(t):
            m = step(t)
            losses.append(float(m["loss"]))
            return m

        out = timed(recorded, tokens, steps, dev)
        seen["losses"] = losses
        return out

    monkeypatch.setattr(bench_suite, "_timed_steps", lm_kept)
    lm = bench_suite.bench_transformer_lm("lm", STEPS, **LM)
    lm_losses = seen["losses"]
    monkeypatch.setattr(moe, "MoETransformerLM", functools.partial(
        moe.MoETransformerLM, n_groups=2))
    moe_row = bench_suite.bench_moe_lm("moe", STEPS, **MOE)
    return dict(lm=(lm, lm_losses), moe=(moe_row, seen["losses"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_ranks")
    builds = _jax_builds()
    inp = {"rows": ROWS, "per": PER, "steps": STEPS, "lm": LM, "moe": MOE,
           "params": {name: init for name, (_, init) in builds.items()}}
    (root / "inp.pkl").write_bytes(pickle.dumps(inp))
    (root / "worker.py").write_text(_WORKER)
    run_dir = root / "run"
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    # The JAX steps compile and run while the ranks do.
    with ThreadPoolExecutor(1) as pool:
        jax_rows = pool.submit(_jax_rows, builds)
        try:
            rc = launch.main([
                "launch", "--run-dir", str(run_dir), "--simulate", "2",
                "--port", str(free_port()), "--entry",
                str(root / "worker.py"), "--wait", "--timeout", "120",
                "--grace", "1", "--", str(root / "inp.pkl"), str(root)])
        finally:
            mp.undo()
            launch.main(["kill", "--run-dir", str(run_dir), "--grace", "1"])
        jax_done = jax_rows.result()
    logs = [(run_dir / f"proc_{r}.log").read_text() for r in range(2)]
    assert rc == 0, "\n\n".join(log[-3000:] for log in logs)
    ranks = [pickle.loads((root / f"rank{r}.pkl").read_bytes())
             for r in range(2)]
    mp = pytest.MonkeyPatch()
    mp.setattr(bench_suite, "DEVICE", "cpu")
    try:
        alone = _one_rank_lm(mp)
    finally:
        mp.undo()
    return dict(jax=jax_done, ranks=ranks, alone=alone)


@pytest.mark.parametrize("name", list(ROWS))
def test_lenet_rows_over_two_ranks_equal_the_jax_two_device_step(runs,
                                                                  name):
    want = runs["jax"][name]
    for rank, got in enumerate(r[name] for r in runs["ranks"]):
        params = _flat(got["params"])
        assert set(params) == set(want["params"])
        for k, v in want["params"].items():
            np.testing.assert_allclose(params[k], v, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} rank {rank} {k}")
        assert got["mask"] == want["mask"] == (
            [1.0, 0.0] if name == "lenet_kofn" else [1.0, 1.0])


@pytest.mark.parametrize("name", list(ROWS))
def test_each_rank_holds_its_shard_of_the_jax_global_batch(runs, name):
    want = runs["jax"][name]
    for rank, got in enumerate(r[name] for r in runs["ranks"]):
        rows = slice(rank * PER, (rank + 1) * PER)
        np.testing.assert_array_equal(got["x"], want["x"][rows])
        np.testing.assert_array_equal(got["y"], want["y"][rows])


@pytest.mark.parametrize("name", list(ROWS))
def test_a_rank_row_records_the_world_and_every_rank(runs, name):
    rows = [r[name]["row"] for r in runs["ranks"]]
    row = rows[0]
    assert (row["devices"], row["global_batch"], row["backend"]) == \
        (2, 2 * PER, "gloo")
    assert row["mask"] == ([1, 0] if name == "lenet_kofn" else [1, 1])
    assert len(set(row["rank_params_sha256"])) == 1
    assert row["rank_launches"] == [{}, {}]     # plain versions on the CPU
    # The slowest rank's seconds: one value on every rank.
    assert rows[0]["sec_per_step"] == rows[1]["sec_per_step"]


@pytest.mark.parametrize("kind", ["lm", "moe"])
def test_lm_rows_over_two_ranks_reach_the_one_rank_losses(runs, kind):
    alone_row, alone_losses = runs["alone"][kind]
    assert alone_row["devices"] == 1 and alone_row["backend"] == "none"
    for r in runs["ranks"]:
        got = r[kind]
        assert (got["row"]["devices"], got["row"]["backend"]) == (2, "gloo")
        np.testing.assert_allclose(got["losses"], alone_losses,
                                   rtol=LM_LOSS_TOL, atol=LM_LOSS_TOL)
    if kind == "lm":
        assert runs["ranks"][0][kind]["row"]["attention"] == "ring"
        assert alone_row["attention"] == "full"
        assert len(set(runs["ranks"][0][kind]["row"][
            "rank_params_sha256"])) == 1
    else:
        assert runs["ranks"][0][kind]["row"]["n_experts"] == 4


def test_the_cli_prints_each_spanning_row_once(monkeypatch):
    proc = subprocess.run(
        [sys.executable, "-m", "ps_pytorch_tpu_torch.bench_suite", "--device",
         "cpu", "--ranks", "2", "--steps", "1", "--configs",
         "lenet_mnist_dp,lenet_mnist_single"], capture_output=True,
        text=True, cwd=REPO, timeout=180,
        env={**__import__("os").environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert [r["config"] for r in rows] == ["lenet_mnist_dp",
                                           "lenet_mnist_single"]
    dp, single = rows
    assert "error" not in dp and "error" not in single
    assert (dp["devices"], dp["global_batch"], dp["backend"], dp["mask"]) == \
        (2, 2048, "gloo", [1, 1])
    assert len(set(dp["rank_params_sha256"])) == 1
    assert (single["devices"], single["global_batch"], single["backend"]) \
        == (1, 128, "none")
    # A pinned attention row keeps one device in a world of two.
    monkeypatch.setattr(bench_suite, "DEVICE", "cpu")
    monkeypatch.setattr(bench_suite, "DEVICES", 2)
    pinned = bench_suite.bench_transformer_lm("pinned", 1, attention="flash",
                                              **LM)
    assert (pinned["devices"], pinned["backend"], pinned["attention"]) == \
        (1, "none", "flash")
