"""The port's GPipe pipeline across gloo ranks on the CPU, against the JAX
package's ``parallel/pp.py``.

- ``stack_stage_params`` / ``unstack_stage_params`` bitwise the JAX
  functions, and the convert maps of a stage-stacked tree.
- One launch of four ranks (``tests/test_torch_ring.py:launch_ranks``) runs
  the pp step at (data, stages, microbatches) = (1, 2, 2) in each model
  row of a 2 x 2 grid, (2, 2, 2) on it and (1, 4, 4) on a 1 x 4 grid,
  three SGD steps each, against ``make_pp_train_step`` on as many CPU
  devices with the same flax weights (each stage's from the JAX stacked
  tree by ``convert.pp_stage_from_jax``) and batches: losses at 2e-5, the
  gathered parameters at rtol 2e-4 / atol 2e-5
  (``tests/test_pp.py:99-103``). The microbatch count changes only the
  schedule (M = 2, 4, 8 at 1 x 4: loss rtol 1e-5, parameters rtol 1e-4 /
  atol 1e-6, ``tests/test_pp.py:124-126``); ``--remat`` changes no bit;
  and (1, 2, 2) with ``--lm-attention flash`` on the CPU's plain flash
  against the JAX pp step with its flash kernels in interpret mode, at
  the step tolerances.
- The refusals, with the JAX messages: ring attention, a state stacked for
  another stage count, a local batch the microbatches do not divide.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.models import transformer as jax_transformer
from ps_pytorch_tpu.optim.sgd import sgd as jax_sgd
from ps_pytorch_tpu.parallel import pp as jax_pp
from ps_pytorch_tpu.parallel.mesh import make_mesh
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.optim import SGD
from ps_pytorch_tpu_torch.parallel import pp
from ps_pytorch_tpu_torch.parallel.mesh import Axis, RankGrid
from test_torch_ring import launch_ranks

B, S = 8, 32
LM = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=2, max_seq_len=S)
LOSS_TOL, PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-4, 2e-5
MICRO_LOSS_RTOL, MICRO_RTOL, MICRO_ATOL = 1e-5, 1e-4, 1e-6
OPT = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
STEPS = 3
# (data, stages, microbatches, attention) of each pipeline run.
RUNS = [(1, 2, 2, "full"), (2, 2, 2, "full"), (1, 4, 4, "full"),
        (1, 2, 2, "flash")]

_WORKER = r"""
import pickle, sys, types
import torch
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.optim import SGD
from ps_pytorch_tpu_torch.parallel import dist, pp
from ps_pytorch_tpu_torch.parallel.mesh import Axis, make_grid

torch.set_num_threads(1)
dist.initialize_from_env("cpu")
with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
g22, g14 = make_grid(data=2, model=2), make_grid(data=1, model=4)
alone = Axis("data", [dist.rank()], 0, None)
grids = {(2, 2): g22, (1, 4): g14, (1, 2): types.SimpleNamespace(
    data=alone, model=g22.model, world=g22.model)}


def run(data, stages, micro, impl, remat, batches):
    grid = grids[data, stages]
    model = TransformerLM(attention_impl=impl, remat=remat, **inp["lm"])
    stage = pp.PipelineStage(model, grid.model.index, stages)
    stage.load_state_dict(convert.pp_stage_from_jax(
        inp["stacked"][stages], grid.model.index))
    step = pp.PPTrainStep(stage, SGD(**inp["opt"]), grid, micro)
    b = batches[0].shape[0] // grid.data.size
    losses = [float(step(t[grid.data.index * b:(grid.data.index + 1) * b])
                    ["loss"]) for t in batches]
    params, _ = pp.full_state(stage, step.opt_state, grid)
    return losses, {k: v.numpy() for k, v in params.items()}


out = {}
for data, stages, micro, impl in inp["runs"]:
    for remat in (False, True):
        out[data, stages, micro, impl, remat] = run(
            data, stages, micro, impl, remat, inp["batches"])
for micro in (2, 4, 8):
    out["micro", micro] = run(1, 4, micro, "full", False, inp["batches"][:1])
with open(f"{sys.argv[2]}/rank{dist.rank()}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.shutdown()
print("FINAL ok", flush=True)
"""


def _flax_params():
    m = jax_transformer.TransformerLM(**LM)
    v = m.init(jax.random.key(0), jnp.zeros((1, S), jnp.int32))
    return jax.device_get(v["params"])


def _jax_pp(params, batches, data, stages, micro, impl):
    mesh = make_mesh(data=data, model=stages,
                     devices=jax.devices()[:data * stages])
    model = jax_transformer.TransformerLM(attention_impl=impl, **LM)
    tx = jax_sgd(**OPT)
    state = jax_pp.create_pp_train_state(model, tx, mesh, stages, (B, S))
    p = jax.tree.map(jnp.asarray, jax_pp.stack_stage_params(params, stages))
    state = state.replace(params=p, opt_state=tx.init(p))
    step = jax_pp.make_pp_train_step(model, tx, mesh, state,
                                     num_microbatches=micro, donate=False)
    losses = []
    for tok in batches:
        state, m = step(state, jnp.asarray(tok))
        losses.append(float(m["loss"]))
    return losses, jax_pp.unstack_stage_params(jax.device_get(state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = _flax_params()
    tok = np.random.default_rng(3)
    batches = [tok.integers(0, 64, (B, S)).astype(np.int32)
               for _ in range(STEPS)]
    stacked = {s: jax.device_get(jax_pp.stack_stage_params(params, s))
               for s in (2, 4)}
    wait = launch_ranks(tmp_path_factory.mktemp("pp"), 4, _WORKER, dict(
        lm=LM, stacked=stacked, opt=OPT, batches=batches, runs=RUNS))
    # The JAX steps compile in threads of their own while the ranks run:
    # XLA's compiler leaves the interpreter lock.
    with ThreadPoolExecutor(len(RUNS)) as pool:
        want = dict(zip(RUNS, pool.map(
            lambda run: _jax_pp(params, batches, *run), RUNS)))
    return wait(), want


def _params_close(got: dict, want: dict, rtol, atol):
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("run", RUNS, ids=lambda r: "-".join(map(str, r)))
def test_pp_step_matches_jax(runs, run):
    ranks, want = runs
    w_losses, w_tree = want[run]
    w_params = {k: v.numpy() for k, v in convert.from_jax(w_tree).items()}
    for out in ranks:
        losses, params = out[run + (False,)]
        np.testing.assert_allclose(losses, w_losses, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        _params_close(params, w_params, PARAM_RTOL, PARAM_ATOL)


def test_remat_changes_no_bit_and_ranks_agree(runs):
    ranks, _ = runs
    for run in RUNS:
        base = ranks[0][run + (False,)]
        for out in ranks:
            for remat in (False, True):
                losses, params = out[run + (remat,)]
                assert losses == base[0], (run, remat)
                for k in params:
                    np.testing.assert_array_equal(params[k], base[1][k])


def test_microbatch_count_is_schedule_only(runs):
    ranks, _ = runs
    for out in ranks:
        base = out["micro", 2]
        for micro in (4, 8):
            losses, params = out["micro", micro]
            np.testing.assert_allclose(losses, base[0], rtol=MICRO_LOSS_RTOL)
            _params_close(params, base[1], MICRO_RTOL, MICRO_ATOL)


def test_stack_unstack_bitwise_the_jax_functions():
    params = _flax_params()
    for stages in (1, 2, 4):
        got = pp.stack_stage_params(params, stages)
        want = jax.device_get(jax_pp.stack_stage_params(params, stages))
        jax.tree.map(np.testing.assert_array_equal, got, want)
        back = pp.unstack_stage_params(got)
        jax.tree.map(np.testing.assert_array_equal, back,
                     jax.device_get(jax_pp.unstack_stage_params(want)))
        jax.tree.map(np.testing.assert_array_equal, back, params)
    for mod in (pp, jax_pp):
        with pytest.raises(ValueError, match="4 blocks not divisible into "
                                             "3 stages"):
            mod.stack_stage_params(params, 3)


def test_convert_maps_a_stacked_tree_to_stages_and_back():
    params = _flax_params()
    stacked = jax.device_get(jax_pp.stack_stage_params(params, 2))
    full = convert.from_jax(params)
    stages = [convert.pp_stage_from_jax(stacked, s) for s in range(2)]
    assert {k.split(".")[0] for k in stages[1]} == {
        "block_2", "block_3", *pp.EDGES}
    for sd in stages:
        for k, t in sd.items():
            assert torch.equal(t, full[k]), k
    back = convert.pp_stages_to_jax(stages)
    jax.tree.map(np.testing.assert_array_equal, back, stacked)


def _stage(impl="full", stages=2, axis=None):
    model = TransformerLM(attention_impl=impl, axis=axis, **LM)
    return pp.PipelineStage(model, 0, stages)


def test_pp_refuses_what_jax_refuses():
    mesh = make_mesh(data=1, model=4, devices=jax.devices()[:4])
    model = jax_transformer.TransformerLM(**LM)
    tx = jax_sgd(**OPT)
    state = jax_pp.create_pp_train_state(
        model, tx, make_mesh(data=1, model=2, devices=jax.devices()[:2]), 2,
        (B, S))
    mismatch = "state was stacked for 2 stages but the mesh's 'model' axis " \
        "has 4"
    with pytest.raises(ValueError, match=mismatch):
        jax_pp.make_pp_train_step(model, tx, mesh, state,
                                  num_microbatches=2)
    with pytest.raises(ValueError, match=mismatch):
        pp.PPTrainStep(_stage(), SGD(**OPT), RankGrid(1, 4, 0), 2)
    ring = "PP step requires attention_impl='full'|'flash'"
    with pytest.raises(ValueError, match=ring):
        jax_pp.make_pp_train_step(
            jax_transformer.TransformerLM(attention_impl="ring", **LM), tx,
            mesh, state, num_microbatches=2)
    alone = Axis("data", [0], 0, None)
    with pytest.raises(ValueError, match=ring):
        pp.PPTrainStep(_stage("ring", axis=alone), SGD(**OPT),
                       RankGrid(1, 2, 0), 2)
    batch = "local batch 6 not divisible into 4 microbatches"
    one = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    state1 = jax_pp.create_pp_train_state(model, tx, one, 1, (6, S))
    step = jax_pp.make_pp_train_step(model, tx, one, state1,
                                     num_microbatches=4, donate=False)
    with pytest.raises(ValueError, match=batch):
        step(state1, jnp.zeros((6, S), jnp.int32))
    port = pp.PPTrainStep(_stage(stages=1), SGD(**OPT),
                          RankGrid(1, 1, 0), 4)
    with pytest.raises(ValueError, match=batch):
        port(np.zeros((6, S), np.int64))
