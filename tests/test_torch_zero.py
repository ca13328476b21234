"""The port's step options across gloo ranks on the CPU against the JAX
package: ZeRO-1 (``parallel/zero.py``), cross-replica BatchNorm statistics
and recomputation (``parallel/dp.py``).

The same seeded weights and batches go through the port's
``make_train_step`` in 2 and 3 gloo processes (one launch each, every case
in it) and through the JAX ``make_zero_train_step`` / ``make_train_step``
on a mesh of the first 2 or 3 CPU devices, rank r's batch as the JAX
replica r's shard:

- ZeRO against the JAX ZeRO step, plain and fused SGD and Adam: rtol 1e-5 /
  atol 1e-6 (``tests/test_zero.py``'s tolerance for two gradient routes);
  the sharded optimizer state in the JAX layout ``[world, chunk]``. Torch's
  and XLA's LeNet gradients differ by a few ulps, which momentum carries
  to ~1.7e-6 in a handful of elements, the same with and without the fused
  kernel.
- Each fused optimizer's ZeRO run against the same optimizer unfused in
  the port: rtol 1e-6 / atol 1e-6, parameters and optimizer state.
- ZeRO against the port's replicated step: bitwise at two ranks (a sum of
  two is exact either way), 1e-6 at three.
- ``sync_batchnorm`` and ``remat`` on a narrow VGG with BatchNorm and
  Dropout (the same keep masks injected in both packages, one set a
  replica) at the train step's 1e-4, with masks [1, 1], [1, 0] and the
  all-zero mask: the parameters do not move and the synced statistics are
  zeroed (``0 / 1``, as in the JAX package).
- Remat on one process draws the same Dropout masks as without it.

The Adam cases use ``adam_eps=1e-4``: Adam's first update is
``lr * g / (|g| + eps)``, whose sensitivity to the gradient's rounding is
up to ``lr / eps``; at the default 1e-8 torch's and XLA's roundings of a
near-zero gradient element (about 1e-9 apart) move that element's update
by more than the tolerance, whatever the sharding. The ZeRO checkpoint
across the two packages: ``tests/test_torch_dist.py``.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from conftest import free_port
from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.models import build_model as jax_build_model
from ps_pytorch_tpu.models import vgg as jax_vgg
from ps_pytorch_tpu.optim import build_optimizer as jax_build_optimizer
from ps_pytorch_tpu.parallel import create_train_state
from ps_pytorch_tpu.parallel import make_train_step as jax_make_train_step
from ps_pytorch_tpu.parallel.zero import (
    create_zero_train_state, make_zero_train_step,
)
from ps_pytorch_tpu_torch.models import build_model, convert, vgg
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.config import TrainConfig
from ps_pytorch_tpu_torch.parallel import make_train_step
from test_torch_train import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
STEPS = 3
LOCAL = 4                   # examples a replica a step
NARROW = (8, "M", 16, "M", 16, "M", 16, "M", 16, "M")
OPTIMIZERS = {
    "sgd": dict(lr=0.05, momentum=0.9, weight_decay=5e-4),
    "fused_sgd": dict(lr=0.05, momentum=0.9, weight_decay=5e-4,
                      fused_optimizer=True),
    "adam": dict(optimizer="adam", lr=1e-3, weight_decay=1e-4,
                 adam_eps=1e-4),
    "fused_adam": dict(optimizer="adam", lr=1e-3, amsgrad=True,
                       adam_eps=1e-4, fused_optimizer=True),
}
# Each fused optimizer's twin: the same arithmetic through the plain
# PyTorch update.
UNFUSED = {name: {k: v for k, v in OPTIMIZERS[name].items()
                  if k != "fused_optimizer"}
           for name in ("fused_sgd", "fused_adam")}
VGG_MASKS = ([1, 1], [1, 0], [0, 0])

# One rank: every case of the pickle for this world size, through the
# port's make_train_step over a gloo group.
_WORKER = r"""
import pickle, sys
import numpy as np, torch, torch.distributed as dist
rank, world, port, src, dst = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from ps_pytorch_tpu_torch.config import TrainConfig
from ps_pytorch_tpu_torch.models import build_model, convert, vgg
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import make_train_step
cases = pickle.load(open(src, "rb"))
out = {}
for name, c in cases.items():
    if c["net"] == "vgg":
        model = vgg.VGG(c["cfg"], True, 10)
    else:
        model = build_model("LeNet")
    model.load_state_dict(convert.from_jax(c["params"], c["stats"]))
    for layer, keep in c["keep"][rank].items():
        getattr(model, layer).mask_fn = (
            lambda x, keep=keep: torch.from_numpy(keep))
    step = make_train_step(
        model, build_optimizer(TrainConfig(eval_freq=0, **c["opt"])),
        group=dist.group.WORLD, **c["flags"])
    hist = []
    for k, mask in enumerate(c["masks"]):
        m = step(c["x"][k][rank], c["y"][k][rank], mask, key=k)
        params, stats = convert.to_jax(
            {k: v.clone() for k, v in model.state_dict().items()})
        hist.append({"params": params, "stats": stats,
                     "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
    rec = {"hist": hist}
    if c["flags"].get("shard_update"):
        rec["opt"] = step.gather_opt_state()
        rec["scatter"] = step.scatter
    out[name] = rec
pickle.dump(out, open(f"{dst}/rank{rank}.pkl", "wb"))
dist.destroy_process_group()
"""


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(n, 1), ("data", "model"))


def _lenet_case(n, opt, zero, seed=3, opts=None):
    rng = np.random.default_rng(seed)
    params = convert.to_jax(build_model("LeNet", seed=seed).state_dict())[0]
    return {"net": "lenet", "params": params, "stats": None,
            "keep": [{}] * n, "opt": (opts or OPTIMIZERS)[opt],
            "flags": {"shard_update": zero},
            "masks": [[1.0] * n] * STEPS,
            "x": rng.normal(size=(STEPS, n, LOCAL, 28, 28, 1)).astype(
                np.float32),
            "y": rng.integers(0, 10, (STEPS, n, LOCAL)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _vgg_init():
    fm = jax_vgg.VGG(NARROW, True, 10)
    v = jax.jit(lambda k: fm.init(k, jnp.zeros((1, 32, 32, 3)),
                                  train=False))(jax.random.key(0))
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def _vgg_case(n, zero, seed=5):
    rng = np.random.default_rng(seed)
    params, stats = _vgg_init()
    keep = [{"Dropout_0": rng.random((LOCAL, 16)) < 0.5,
             "Dropout_1": rng.random((LOCAL, 512)) < 0.5}
            for _ in range(n)]
    return {"net": "vgg", "cfg": NARROW, "params": params, "stats": stats,
            "keep": keep, "opt": OPTIMIZERS["sgd"],
            "flags": {"shard_update": zero, "sync_batchnorm": True,
                      "remat": True},
            "masks": [[float(v) for v in m] for m in VGG_MASKS],
            "x": rng.normal(size=(STEPS, n, LOCAL, 32, 32, 3)).astype(
                np.float32),
            "y": rng.integers(0, 10, (STEPS, n, LOCAL)).astype(np.int32)}


def _cases(n):
    cases = {}
    names = OPTIMIZERS if n == 2 else ("fused_sgd",)
    for opt in names:
        cases[f"lenet_{opt}_zero"] = _lenet_case(n, opt, True)
    cases["lenet_fused_sgd_repl"] = _lenet_case(n, "fused_sgd", False)
    if n == 2:
        for opt in UNFUSED:
            cases[f"lenet_{opt}_zero_unfused"] = _lenet_case(
                n, opt, True, opts=UNFUSED)
        cases["vgg_zero"] = _vgg_case(n, True)
        cases["vgg_repl"] = _vgg_case(n, False)
    return cases


@functools.lru_cache(maxsize=None)
def _port_run(n):
    """Every case of ``_cases(n)`` through n gloo ranks: {case: [rank
    record]}. One launch a world size, shared by this file's tests."""
    work = Path(tempfile.mkdtemp(prefix=f"zero_port_{n}_"))
    src = work / "cases.pkl"
    with open(src, "wb") as f:
        pickle.dump(_cases(n), f)
    worker = work / "worker.py"
    worker.write_text(_WORKER)
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=f"{REPO}{os.pathsep}"
               f"{os.environ.get('PYTHONPATH', '')}")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(n), port, str(src),
         str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    # The JAX runs this file's tests hold these ranks against compile and
    # run in threads while the ranks train (``_jax_run`` keeps them).
    with ThreadPoolExecutor(len(_JAX_RUNS[n])) as pool:
        jax_runs = [pool.submit(_jax_run, n, name) for name in _JAX_RUNS[n]]
        try:
            for p in procs:
                logs.append(p.communicate(timeout=120)[0])
        finally:
            for p in procs:
                p.kill()
        for run in jax_runs:
            run.result()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    recs = [pickle.load(open(work / f"rank{r}.pkl", "rb")) for r in range(n)]
    return {name: [rec[name] for rec in recs] for name in recs[0]}


def _intercept(keeps):
    """flax Dropout -> flax's arithmetic on replica r's keep mask."""
    stacked = {name: np.stack([k[name] for k in keeps]) for name in keeps[0]}

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dropout) and context.method_name == \
                "__call__" and not mod.deterministic:
            keep = jnp.asarray(stacked[mod.name])[
                jax.lax.axis_index("data")]
            x = args[0]
            return jax.lax.select(keep, x / (1.0 - mod.rate),
                                  jnp.zeros_like(x))
        return next_fun(*args, **kwargs)
    return nn.intercept_methods(interceptor)


# The JAX runs of each world size's cases that the tests below read.
_JAX_RUNS = {2: tuple(f"lenet_{opt}_zero" for opt in OPTIMIZERS)
             + ("vgg_zero", "vgg_repl"),
             3: ("lenet_fused_sgd_zero",)}


@functools.lru_cache(maxsize=None)
def _jax_run(n, name):
    """Case ``name`` of ``_cases(n)`` through the JAX step on n CPU
    devices: the state after each step (params, batch_stats [n, ...],
    opt_state)."""
    c = _cases(n)[name]
    mesh = _mesh(n)
    jcfg = jax_config.TrainConfig(eval_freq=0, **c["opt"])
    tx = jax_build_optimizer(jcfg)
    if c["net"] == "vgg":
        model, sample = jax_vgg.VGG(c["cfg"], True, 10), (1, 32, 32, 3)
    else:
        model, sample = jax_build_model("LeNet", 10, "float32"), (1, 28, 28, 1)
    flags = dict(c["flags"])
    zero = flags.pop("shard_update")
    make_state, make_step = ((create_zero_train_state, make_zero_train_step)
                             if zero else
                             (create_train_state, jax_make_train_step))
    state = make_state(model, tx, mesh, sample, jax.random.key(0))
    replicated = NamedSharding(mesh, P())
    params = jax.device_put(c["params"], replicated)
    state = state.replace(params=params)
    if not zero:
        state = state.replace(opt_state=jax.device_put(tx.init(params),
                                                       replicated))
    step = make_step(model, tx, mesh, state, donate=False, **flags)
    hist = []
    keeps = c["keep"] if c["net"] == "vgg" else None
    for k, mask in enumerate(c["masks"]):
        x = np.concatenate(list(c["x"][k]))
        y = np.concatenate(list(c["y"][k]))
        if keeps:
            with _intercept(keeps):
                state, m = step(state, x, y, np.asarray(mask, np.float32),
                                jax.random.key(k))
        else:
            state, m = step(state, x, y, np.asarray(mask, np.float32),
                            jax.random.key(k))
        hist.append(jax.device_get(state))
    return hist


def _close(a, b, rtol, atol, what=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (what, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], rtol, atol, f"{what}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=what)


def _equal(a, b, what=""):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_zero_matches_jax_zero(opt):
    name = f"lenet_{opt}_zero"
    ranks = _port_run(2)[name]
    tol = 1e-5
    jhist = _jax_run(2, name)
    for k in range(STEPS):
        for r in ranks[1:]:             # every rank holds the same model
            _equal(ranks[0]["hist"][k]["params"], r["hist"][k]["params"])
        _close(ranks[0]["hist"][k]["params"], jhist[k].params, tol, 1e-6,
               f"step {k + 1}")
    # The sharded optimizer state, in the JAX layout [world, chunk].
    ours, theirs = ranks[0]["opt"], jhist[-1].opt_state
    assert ranks[0]["scatter"] == "reduce_scatter_tensor"
    assert int(ours["step"]) == int(theirs.step) == STEPS
    for field, got in ours.items():
        if field == "step":
            continue
        want = getattr(theirs, field)
        if isinstance(got, dict):
            assert got == {} and want == ()
        else:
            assert got.shape == np.shape(want) == (2, -(-got.size // 2))
            _close(got, want, tol, 1e-6, field)


@pytest.mark.parametrize("opt", sorted(UNFUSED))
def test_fused_zero_matches_the_unfused_zero(opt):
    """The fused kernel's arithmetic against the plain update on the same
    gradients: the tight bound that the cross-package test cannot hold."""
    run = _port_run(2)
    fused, plain = run[f"lenet_{opt}_zero"], run[f"lenet_{opt}_zero_unfused"]
    for k in range(STEPS):
        _close(fused[0]["hist"][k]["params"], plain[0]["hist"][k]["params"],
               1e-6, 1e-6, f"step {k + 1}")
    assert set(fused[0]["opt"]) == set(plain[0]["opt"])
    assert int(fused[0]["opt"]["step"]) == int(plain[0]["opt"]["step"])
    for field, got in fused[0]["opt"].items():
        if field != "step":
            _close(got, plain[0]["opt"][field], 1e-6, 1e-6, field)


@pytest.mark.parametrize("n", [2, 3])
def test_zero_matches_the_replicated_step(n):
    run = _port_run(n)
    zero, repl = run["lenet_fused_sgd_zero"], run["lenet_fused_sgd_repl"]
    for k in range(STEPS):
        a, b = zero[0]["hist"][k]["params"], repl[0]["hist"][k]["params"]
        if n == 2:
            _equal(a, b, f"step {k + 1}")
        else:       # three partial sums in another order
            _close(a, b, 1e-6, 1e-6, f"step {k + 1}")
    if n == 3:
        jhist = _jax_run(3, "lenet_fused_sgd_zero")
        _close(zero[0]["hist"][-1]["params"], jhist[-1].params, 1e-6, 1e-6)


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero"])
def test_sync_batchnorm_and_remat_match_jax(zero):
    name = "vgg_zero" if zero else "vgg_repl"
    ranks = _port_run(2)[name]
    jhist = _jax_run(2, name)
    for k in range(STEPS):
        _close(ranks[0]["hist"][k]["params"], jhist[k].params, 1e-4, 1e-4,
               f"step {k + 1} params")
        for r, rank in enumerate(ranks):
            # Synced: every replica holds the same statistics, JAX's row r.
            _equal(rank["hist"][k]["stats"], ranks[0]["hist"][k]["stats"])
            _close(rank["hist"][k]["stats"],
                   jax.tree.map(lambda a: a[r], jhist[k].batch_stats),
                   1e-4, 1e-4, f"step {k + 1} stats {r}")


def test_masked_replica_and_all_zero_mask():
    """Mask [1, 0] at step 2: the synced statistics are replica 0's
    alone; the all-zero mask at step 3 leaves the parameters and zeroes
    the synced statistics, in both packages."""
    ranks = _port_run(2)["vgg_zero"]
    hist = ranks[0]["hist"]
    _equal(hist[2]["params"], hist[1]["params"])
    for leaf in jax.tree.leaves(hist[2]["stats"]):
        assert not np.any(leaf)
    jhist = _jax_run(2, "vgg_zero")
    for leaf in jax.tree.leaves(jhist[2].batch_stats):
        assert not np.any(np.asarray(leaf))
    # ZeRO and the replicated step agree bitwise at two ranks.
    repl = _port_run(2)["vgg_repl"]
    for k in range(STEPS):
        _equal(hist[k]["params"], repl[0]["hist"][k]["params"])
        _equal(hist[k]["stats"], repl[0]["hist"][k]["stats"])


def _dropout_vgg_run(remat: bool):
    torch.manual_seed(0)
    model = vgg.VGG(NARROW, True, 10)
    params, stats = _vgg_init()
    model.load_state_dict(convert.from_jax(params, stats))
    step = make_train_step(
        model, build_optimizer(TrainConfig(eval_freq=0, **OPTIMIZERS["sgd"])),
        remat=remat)
    rng = np.random.default_rng(9)
    for k in range(STEPS):
        step(rng.normal(size=(LOCAL, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, LOCAL), [1.0], key=1000 + k)
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_remat_draws_the_same_dropout_masks():
    """One process: remat recomputes the forward in the backward, and the
    recompute draws the masks the forward drew (the generator is put
    back), so the run equals the one without remat bitwise; the running
    statistics are the first forward's."""
    plain, remat = _dropout_vgg_run(False), _dropout_vgg_run(True)
    assert set(plain) == set(remat)
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k
