"""The port's ring attention and sequence-parallel LM step across gloo
ranks on the CPU, against the JAX package.

One launch of four ranks (``tools.launch --simulate 4``, ``--device cpu``)
runs every case; the JAX side runs in this process on a mesh of as many
CPU devices as the case has ranks (``tests/conftest.py`` gives eight), on
the same inputs, made from a seed with numpy, and the same flax weights
(``models/convert.py``).

- ``ring_attention`` over 2 ranks (the ``data`` axis of a 2 x 2 grid, each
  model column its own ring) and over 4, causal and not: the forward and
  the gradients of ``sum(out**2)`` against the JAX ``ring_attention`` and
  ``full_attention``, at ``tests/test_ring_attention.py``'s tolerances
  (2e-5, gradients 5e-5).
- ``collectives.permute``: its backward is the reverse permute.
- The sp step over 4 ranks (ring attention, the boundary token by one
  permute) against the JAX ``make_sp_train_step`` on a 4-device mesh: two
  SGD steps' losses at 2e-5 and the parameters at rtol 2e-4 / atol 2e-5
  (``tests/test_tp.py:112-115``), the eval through the sharded forward
  against ``make_sp_eval_fn`` at 2e-5; with ``--remat`` (the ring's hops
  recomputed) the same step to the bit.
"""

import pickle
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from conftest import free_port
from ps_pytorch_tpu.models import transformer as jax_transformer
from ps_pytorch_tpu.optim.sgd import sgd as jax_sgd
from ps_pytorch_tpu.parallel import ring as jax_ring
from ps_pytorch_tpu.parallel import sp as jax_sp
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.tools import launch
from test_torch_train import two_torch_threads  # noqa: F401

B, H, S, D = 2, 4, 64, 16
LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, max_seq_len=S)
RING_TOL, RING_GRAD_TOL = 2e-5, 5e-5
LOSS_TOL, PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-4, 2e-5
OPT = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)

_WORKER = r"""
import pickle, sys
import torch
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.optim import SGD
from ps_pytorch_tpu_torch.parallel import dist
from ps_pytorch_tpu_torch.parallel.collectives import permute
from ps_pytorch_tpu_torch.parallel.mesh import make_grid
from ps_pytorch_tpu_torch.parallel.ring import ring_attention
from ps_pytorch_tpu_torch.parallel.sp import (
    LMTrainStep, make_lm_eval_fn, sequence_shard)

torch.set_num_threads(1)
dist.initialize_from_env("cpu")
with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
rings = {2: make_grid(data=2, model=2).data, 4: make_grid(data=4).data}
out = {}
for n, axis in rings.items():
    s = inp["qkv"][0].shape[2] // n
    for causal in (False, True):
        qkv = [torch.tensor(a[:, :, axis.index * s:(axis.index + 1) * s],
                            requires_grad=True) for a in inp["qkv"]]
        o = ring_attention(*qkv, axis, causal=causal)
        (o ** 2).sum().backward()
        out["ring", n, causal] = (axis.index, o.detach().numpy(),
                                  [t.grad.numpy() for t in qkv])
axis = rings[4]
x = torch.full((3,), float(axis.index), requires_grad=True)
y = permute(x, axis, 1)
(y * (axis.index + 10)).sum().backward()
out["permute"] = (y.detach().numpy(), x.grad.numpy())
for remat in (False, True):
    model = TransformerLM(attention_impl="ring", axis=axis, remat=remat,
                          **inp["lm"])
    model.load_state_dict(convert.from_jax(inp["params"]))
    step = LMTrainStep(model, SGD(**inp["opt"]), axis)
    eval_fn = make_lm_eval_fn(model, axis)
    losses = [float(step(sequence_shard(t, axis))["loss"])
              for t in inp["batches"]]
    evals = [float(eval_fn(sequence_shard(t, axis))) for t in inp["evals"]]
    out["sp", remat] = (losses, evals, {
        k: v.detach().numpy().copy() for k, v in model.state_dict().items()})
with open(f"{sys.argv[2]}/rank{dist.rank()}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.shutdown()
print("FINAL ok", flush=True)
"""


def launch_ranks(root, n, worker_src, inputs):
    """Start ``n`` gloo ranks of ``worker_src`` on ``inputs`` through the
    port's launcher, in a thread; returns a function that waits for them
    and gives each rank's pickled result."""
    (root / "worker.py").write_text(worker_src)
    with open(root / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    run_dir = root / "run"
    rc = []

    def run():
        rc.append(launch.main([
            "launch", "--run-dir", str(run_dir), "--simulate", str(n),
            "--port", str(free_port()), "--entry", str(root / "worker.py"),
            "--wait", "--timeout", "150", "--grace", "1", "--",
            str(root / "in.pkl"), str(root)]))

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        thread.join()
        logs = [(run_dir / f"proc_{r}.log").read_text() for r in range(n)]
        assert rc == [0], "\n\n".join(log[-3000:] for log in logs)
        out = []
        for r in range(n):
            with open(root / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out

    return wait


def _flax_params():
    m = jax_transformer.TransformerLM(**LM)
    v = m.init(jax.random.key(0), jnp.zeros((1, S), jnp.int32))
    return jax.device_get(v["params"])


def _jax_ring(q, k, v, n, causal):
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    spec = P(None, None, "data", None)
    fwd = jax_ring.make_ring_attention(mesh, causal=causal)(q, k, v)

    def loss(q, k, v):
        out = jax.shard_map(
            partial(jax_ring.ring_attention, axis_name="data", causal=causal),
            mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False)(q, k, v)
        return jnp.sum(out ** 2)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(fwd), [np.asarray(g) for g in grads]


def _jax_full(q, k, v, causal):
    fwd = jax_ring.full_attention(q, k, v, causal=causal)
    grads = jax.grad(lambda *a: jnp.sum(jax_ring.full_attention(
        *a, causal=causal) ** 2), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(fwd), [np.asarray(g) for g in grads]


def _jax_sp(params, batches, evals):
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    model = jax_transformer.TransformerLM(attention_impl="ring",
                                          axis_name="data", **LM)
    tx = jax_sgd(**OPT)
    state = jax_sp.create_lm_train_state(model, tx, mesh, (B, S))
    p = jax.tree.map(jnp.asarray, params)
    state = state.replace(params=p, opt_state=tx.init(p))
    step = jax_sp.make_sp_train_step(model, tx, mesh, donate=False)
    eval_fn = jax_sp.make_sp_eval_fn(model, mesh)
    losses = []
    for tok in batches:
        state, m = step(state, jnp.asarray(tok))
        losses.append(float(m["loss"]))
    return losses, [float(eval_fn(state.params, jnp.asarray(t)))
                    for t in evals], jax.device_get(state.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    qkv = [rng.normal(size=(B, H, S, D)).astype(np.float32)
           for _ in range(3)]
    params = _flax_params()
    tok = np.random.default_rng(1)
    batches = [tok.integers(0, 64, (B, S)).astype(np.int32)
               for _ in range(2)]
    evals = [tok.integers(0, 64, (B, S)).astype(np.int32)]
    wait = launch_ranks(tmp_path_factory.mktemp("ring"), 4, _WORKER, dict(
        qkv=qkv, lm=LM, params=params, opt=OPT, batches=batches,
        evals=evals))
    want = {}
    for causal in (False, True):
        want["full", causal] = _jax_full(*qkv, causal)
        for n in (2, 4):
            want["ring", n, causal] = _jax_ring(*qkv, n, causal)
    want["sp"] = _jax_sp(params, batches, evals)
    return wait(), want


def _assemble(ranks, key, n):
    """The ranks' shards of one case, in sequence order (rank r of the
    2-rank case sits at data index r // 2)."""
    shards = {}
    for out in ranks:
        idx, o, grads = out[key]
        shards[idx] = (o, grads)
    o = np.concatenate([shards[i][0] for i in range(n)], axis=2)
    grads = [np.concatenate([shards[i][1][j] for i in range(n)], axis=2)
             for j in range(3)]
    return o, grads


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax_ring_and_full(runs, n, causal):
    ranks, want = runs
    o, grads = _assemble(ranks, ("ring", n, causal), n)
    for ref in ("ring", "full"):
        w_o, w_grads = want[(ref, n, causal) if ref == "ring"
                            else (ref, causal)]
        np.testing.assert_allclose(o, w_o, rtol=RING_TOL, atol=RING_TOL)
        for g, w in zip(grads, w_grads):
            np.testing.assert_allclose(g, w, rtol=RING_GRAD_TOL,
                                       atol=RING_GRAD_TOL)


def test_the_two_rank_rings_agree(runs):
    """Each model column of the 2 x 2 grid (ranks 0, 2 and ranks 1, 3)
    runs its own 2-rank ring: the two rings give the same bits."""
    ranks, _ = runs
    for causal in (False, True):
        for r in (0, 2):
            a, b = ranks[r]["ring", 2, causal], ranks[r + 1]["ring", 2,
                                                             causal]
            assert a[0] == b[0] == r // 2
            for x, y in zip([a[1], *a[2]], [b[1], *b[2]]):
                np.testing.assert_array_equal(x, y)


def test_permute_backward_is_the_reverse_permute(runs):
    """Rank i sends to i+1 (``ppermute`` with shift 1); the gradient of
    what rank i+1 received comes back to rank i."""
    ranks, _ = runs
    for i, out in enumerate(ranks):
        y, grad = out["permute"]
        np.testing.assert_array_equal(y, np.full(3, (i - 1) % 4))
        np.testing.assert_array_equal(grad, np.full(3, (i + 1) % 4 + 10))


def test_sp_step_over_four_ranks_matches_jax(runs):
    ranks, want = runs
    w_losses, w_evals, w_params = want["sp"]
    w_sd = convert.from_jax(w_params)
    for out in ranks:
        losses, evals, sd = out["sp", False]
        np.testing.assert_allclose(losses, w_losses, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(evals, w_evals, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        assert set(sd) == set(w_sd)
        for k in sd:
            np.testing.assert_allclose(sd[k], w_sd[k].numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=k)


def test_sp_ranks_stay_equal_and_remat_changes_nothing(runs):
    ranks, _ = runs
    base = ranks[0]["sp", False]
    for out in ranks:
        for remat in (False, True):
            losses, evals, sd = out["sp", remat]
            assert losses == base[0] and evals == base[1]
            for k in sd:
                np.testing.assert_array_equal(sd[k], base[2][k], err_msg=k)
