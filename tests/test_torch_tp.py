"""The port's tensor-parallel LM step across gloo ranks on the CPU, against
the JAX package's ``make_tp_train_step``.

One launch of four ranks (``tests/test_torch_ring.py:launch_ranks``) runs
the step at (data, model) = (2, 2), and at (1, 2) in each model row of the
same 2 x 2 grid (a data axis of one rank), and with head counts the model
axis does not divide: 6 heads over (1, 4) and 3 heads over (2, 2),
where each rank's q/k/v columns straddle heads; the JAX side runs here on
a mesh of as many CPU devices, on the same flax weights (each rank's
shards by ``convert.tp_shard_from_jax``) and batches. Three
SGD steps: losses at 2e-5, the parameters and the momentum, gathered,
at rtol 2e-4 / atol 2e-5 (``tests/test_tp.py:112-115``); every rank's
momentum shard has its parameter's shard shape; ``--remat`` changes no
bit. The shard layout is held against ``tp_param_specs``, the refusals
against the JAX messages, and the splits the port takes against those
``create_tp_train_state`` takes.
"""

import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.models import transformer as jax_transformer
from ps_pytorch_tpu.optim.sgd import sgd as jax_sgd
from ps_pytorch_tpu.parallel import tp as jax_tp
from ps_pytorch_tpu.parallel.mesh import make_mesh
from ps_pytorch_tpu.runtime.lm_trainer import LMTrainer as JaxLMTrainer
from ps_pytorch_tpu_torch import config
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.optim import SGD
from ps_pytorch_tpu_torch.parallel import dist, tp
from ps_pytorch_tpu_torch.parallel.mesh import Axis, RankGrid, make_grid
from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer
from test_torch_ring import launch_ranks

B, S = 8, 32
LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=S)
# Head counts the model axis does not divide, with the (data, model) grid
# each runs on.
ODD = {"heads6": (dict(LM, d_model=48, n_heads=6), (1, 4)),
       "heads3": (dict(LM, d_model=48, n_heads=3), (2, 2))}
LOSS_TOL, PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-4, 2e-5
OPT = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
STEPS = 3

_WORKER = r"""
import pickle, sys, types
import torch
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.optim import SGD
from ps_pytorch_tpu_torch.parallel import dist, tp
from ps_pytorch_tpu_torch.parallel.mesh import Axis, make_grid

torch.set_num_threads(1)
dist.initialize_from_env("cpu")
with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)


def block_whole_heads(blk, x, axis):
    # _block as it was before heads that straddle ranks were taken: the
    # path for heads the axis divides must stay bitwise this.
    import torch.nn.functional as F
    from ps_pytorch_tpu_torch.parallel.collectives import copy_to, reduce_from
    from ps_pytorch_tpu_torch.parallel.ring import full_attention
    b, s, d = x.shape
    hd = d // blk.n_heads
    heads = blk.Dense_0.weight.shape[0] // hd

    def to_heads(t):
        return t.reshape(b, s, heads, hd).transpose(1, 2)

    y = copy_to(blk.LayerNorm_0(x), axis)
    q, k, v = (to_heads(f(y)) for f in (blk.Dense_0, blk.Dense_1,
                                        blk.Dense_2))
    o = full_attention(q, k, v, causal=True)
    o = o.transpose(1, 2).reshape(b, s, heads * hd)
    x = x + reduce_from(blk.Dense_3(o), axis)
    y = copy_to(blk.LayerNorm_1(x), axis)
    y = F.gelu(blk.Dense_4(y), approximate="tanh")
    return x + (reduce_from(F.linear(y, blk.Dense_5.weight), axis)
                + blk.Dense_5.bias)


g22 = make_grid(data=2, model=2)
g14 = make_grid(data=1, model=4)
alone = Axis("data", [dist.rank()], 0, None)
grids = {(2, 2): g22, (1, 4): g14, (1, 2): types.SimpleNamespace(
    data=alone, model=g22.model, world=g22.model)}
out = {}
for case, lm, params, shape in inp["runs"]:
    grid = grids[shape]
    for remat in (False, True):
        model = tp.shard_model_(TransformerLM(**lm), grid.model)
        model.load_state_dict(convert.tp_shard_from_jax(
            params, grid.model.index, grid.model.size))
        step = tp.TPTrainStep(model, SGD(**inp["opt"]), grid, remat=remat)
        losses = [float(step(tp.batch_shard(t, grid.data))["loss"])
                  for t in inp["batches"]]
        params_, mom = tp.full_state(model, step.opt_state, grid)
        shapes = {k: (tuple(p.shape), tuple(step.opt_state.momentum[k].shape))
                  for k, p in model.named_parameters()}
        out[case, shape, remat] = (
            losses, {k: v.numpy() for k, v in params_.items()},
            {k: v.numpy() for k, v in mom.items()}, shapes)
        if case == "even" and not remat:
            tok = torch.as_tensor(tp.batch_shard(inp["batches"][0],
                                                 grid.data)).long()
            with torch.no_grad():
                got = tp.tp_logits(model, tok)
                current = tp._block
                tp._block = block_whole_heads
                try:
                    before = tp.tp_logits(model, tok)
                finally:
                    tp._block = current
            out["bitwise", shape] = bool(torch.equal(got, before))
with open(f"{sys.argv[2]}/rank{dist.rank()}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.shutdown()
print("FINAL ok", flush=True)
"""


def _flax_params(lm=LM):
    m = jax_transformer.TransformerLM(**lm)
    v = m.init(jax.random.key(0), jnp.zeros((1, S), jnp.int32))
    return jax.device_get(v["params"])


def _jax_tp(params, batches, data, model=2, lm=LM):
    mesh = make_mesh(data=data, model=model,
                     devices=jax.devices()[:model * data])
    net = jax_transformer.TransformerLM(**lm)
    tx = jax_sgd(**OPT)
    state = jax_tp.create_tp_train_state(net, tx, mesh, (B, S))
    p = jax.tree.map(jnp.asarray, params)
    state = state.replace(params=p, opt_state=tx.init(p))
    step = jax_tp.make_tp_train_step(net, tx, mesh, state, donate=False)
    losses = []
    with mesh:
        for tok in batches:
            state, m = step(state, jnp.asarray(tok))
            losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params), \
        jax.device_get(state.opt_state.momentum)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = _flax_params()
    odd = {case: _flax_params(lm) for case, (lm, _) in ODD.items()}
    tok = np.random.default_rng(3)
    batches = [tok.integers(0, 64, (B, S)).astype(np.int32)
               for _ in range(STEPS)]
    plan = [("even", LM, params, (2, 2)), ("even", LM, params, (1, 2))] + [
        (case, lm, odd[case], shape) for case, (lm, shape) in ODD.items()]
    wait = launch_ranks(tmp_path_factory.mktemp("tp"), 4, _WORKER, dict(
        runs=plan, opt=OPT, batches=batches))
    # The JAX steps compile in threads of their own while the ranks run:
    # XLA's compiler leaves the interpreter lock.
    jobs = {("even", data): (params, batches, data) for data in (1, 2)}
    jobs.update({(case, data): (odd[case], batches, data, model, lm)
                 for case, (lm, (data, model)) in ODD.items()})
    with ThreadPoolExecutor(len(jobs)) as pool:
        want = dict(zip(jobs, pool.map(lambda a: _jax_tp(*a),
                                       jobs.values())))
    return wait(), want


def _close(got: dict, want_tree: dict):
    want = convert.from_jax(want_tree)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k].numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("data", [1, 2])
def test_tp_step_matches_jax(runs, data):
    ranks, want = runs
    w_losses, w_params, w_mom = want["even", data]
    for out in ranks:
        losses, params, mom, _ = out["even", (data, 2), False]
        np.testing.assert_allclose(losses, w_losses, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        _close(params, w_params)
        _close(mom, w_mom)


@pytest.mark.parametrize("case", sorted(ODD))
def test_tp_step_with_heads_the_axis_does_not_divide_matches_jax(runs, case):
    """Each rank's q/k/v columns straddle heads; the step gathers them,
    attends over every head and sums the straddled heads' gradients over
    the ranks: the JAX step's losses, parameters and momentum, with and
    without remat (which changes no bit)."""
    ranks, want = runs
    lm, shape = ODD[case]
    w_losses, w_params, w_mom = want[case, shape[0]]
    base = ranks[0][case, shape, False]
    for out in ranks:
        for remat in (False, True):
            losses, params, mom, shapes = out[case, shape, remat]
            assert losses == base[0]
            np.testing.assert_allclose(losses, w_losses, rtol=LOSS_TOL,
                                       atol=LOSS_TOL)
            for k in params:
                np.testing.assert_array_equal(params[k], base[1][k])
                np.testing.assert_array_equal(mom[k], base[2][k])
            _close(params, w_params)
            _close(mom, w_mom)
            for name, (p_shape, m_shape) in shapes.items():
                assert p_shape == m_shape, name
    assert lm["n_heads"] % shape[1]


def test_tp_momentum_mirrors_each_shard_and_remat_changes_nothing(runs):
    """... and with heads the axis divides, the block is bitwise the one
    from before straddled heads were taken."""
    ranks, _ = runs
    assert all(out["bitwise", shape] for out in ranks
               for shape in ((1, 2), (2, 2)))
    for shape in ((1, 2), (2, 2)):
        base = ranks[0]["even", shape, False]
        for r, out in enumerate(ranks):
            for remat in (False, True):
                losses, params, mom, shapes = out["even", shape, remat]
                assert losses == base[0]
                for k in params:
                    np.testing.assert_array_equal(params[k], base[1][k])
                    np.testing.assert_array_equal(mom[k], base[2][k])
            for name, (p_shape, m_shape) in shapes.items():
                assert p_shape == m_shape, name
                dim = tp.tp_shard_dim(name)
                full = params[name].shape
                assert p_shape == tuple(
                    n // 2 if i == dim else n for i, n in enumerate(full))


def test_shard_layout_is_the_jax_specs():
    """Each flax kernel sharded P(None, 'model') (column) is the torch
    weight's dim 0, P('model', None) (row) its dim 1; a bias P('model')
    its dim 0; P() replicated."""
    params = _flax_params()
    specs = jax_tp.tp_param_specs(params)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    seen = 0
    for path, spec in flat:
        keys = [p.key for p in path]
        leaf = keys[-1]
        torch_name = ".".join(keys[:-1]) + "." + (
            "weight" if leaf in ("kernel", "scale") else leaf)
        want = {P(): None, P(None, "model"): 0, P("model", None): 1,
                P("model"): 0}[spec]
        assert tp.tp_shard_dim(torch_name) == want, (torch_name, spec)
        seen += want is not None
    assert seen == LM["n_layers"] * 7 + 1


def test_tp_shard_from_jax_round_trips():
    params = _flax_params()
    shards = [convert.tp_shard_from_jax(params, i, 2) for i in range(2)]
    assert shards[0]["block_0.Dense_0.weight"].shape == (16, 32)
    back = convert.tp_shards_to_jax(shards)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_tp_refuses_what_jax_refuses():
    kw = dict(lm_parallelism="tp", lm_attention="flash", lm_vocab=64,
              lm_d_model=32, lm_layers=2, lm_heads=4, lm_seq_len=S,
              batch_size=B, lm_corpus_tokens=4000, eval_freq=0,
              resume=False)
    msg = "lm_attention='flash' is not supported under tp"
    with pytest.raises(ValueError, match=msg):
        JaxLMTrainer(jax_config.TrainConfig(**kw))
    with pytest.raises(ValueError, match=msg):
        LMTrainer(config.TrainConfig(**kw), device="cpu")
    ring = "TP step requires attention_impl='full'"
    mesh = make_mesh(data=1, model=2, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match=ring):
        jax_tp.make_tp_train_step(
            jax_transformer.TransformerLM(attention_impl="ring", **LM),
            jax_sgd(**OPT), mesh, None)
    alone = Axis("data", [0], 0, None)
    model = TransformerLM(attention_impl="ring", axis=alone, **LM)
    with pytest.raises(ValueError, match=ring):
        tp.TPTrainStep(model, SGD(**OPT), RankGrid(1, 2, 0))


def test_tp_refuses_a_split_it_cannot_shard_evenly():
    """Heads the axis does not divide are taken; a d_model or vocabulary
    it does not divide is refused, naming the field."""
    tp.shard_model_(TransformerLM(**dict(LM, n_heads=2)),
                    RankGrid(1, 4, 0).model)
    with pytest.raises(ValueError, match="lm_d_model=36 divisible by 8.*"
                       "JAX package refuses it too"):
        tp.shard_model_(TransformerLM(**dict(LM, d_model=36)),
                        RankGrid(1, 8, 0).model)
    with pytest.raises(ValueError, match="lm_vocab=50 divisible by 4"):
        tp.shard_model_(TransformerLM(**dict(LM, vocab_size=50)),
                        RankGrid(1, 4, 0).model)


# (heads, d_model, vocab, model axis): the JAX package takes the first
# five (heads that the axis does not divide included) and refuses the rest
# (vocab or d_model not divisible).
SPLITS = [(6, 48, 64, 4), (12, 96, 64, 8), (4, 40, 64, 8), (3, 48, 50, 2),
          (4, 32, 64, 4), (4, 48, 50, 4), (4, 48, 255, 4), (4, 36, 64, 8),
          (3, 6, 64, 4), (6, 30, 64, 4)]


@pytest.mark.parametrize("heads,d_model,vocab,axis", SPLITS)
def test_tp_takes_exactly_the_splits_jax_takes(heads, d_model, vocab, axis):
    """``create_tp_train_state`` on ``axis`` CPU devices against
    ``shard_model_`` over an axis of that size: both take a split or both
    refuse it."""
    lm = dict(vocab_size=vocab, d_model=d_model, n_layers=1, n_heads=heads,
              max_seq_len=8)
    mesh = make_mesh(data=1, model=axis, devices=jax.devices()[:axis])
    try:
        jax_tp.create_tp_train_state(jax_transformer.TransformerLM(**lm),
                                     jax_sgd(lr=0.1), mesh, (2, 8))
        jax_takes = True
    except ValueError as e:
        assert "divisible" in str(e)
        jax_takes = False
    try:
        tp.shard_model_(TransformerLM(**lm), RankGrid(1, axis, 0).model)
        port_takes = True
    except ValueError as e:
        assert "JAX package refuses it too" in str(e)
        port_takes = False
    assert port_takes == jax_takes
    assert jax_takes == (d_model % axis == 0 and vocab % axis == 0)


@pytest.mark.parametrize("data,model", [(0, 3), (3, 2), (0, 2), (2, 1)])
def test_rank_grid_is_the_jax_mesh_layout(monkeypatch, data, model):
    """On 4 ranks: the JAX ``make_mesh`` errors for a grid that does not
    fit, and each rank's coordinates and axes where the JAX device order
    puts it (``reshape(data, model)``, row-major)."""
    monkeypatch.setattr(dist, "world", lambda: 4)
    try:
        mesh = make_mesh(data=data, model=model, devices=jax.devices()[:4])
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            make_grid(data, model)
        return
    if mesh.devices.size < 4:
        with pytest.raises(ValueError, match="launch data x model ranks"):
            make_grid(data, model)
        return
    ids = [[d.id for d in row] for row in mesh.devices]
    for rank in range(4):
        monkeypatch.setattr(dist, "rank", lambda r=rank: r)
        grid = make_grid(data, model)
        d_idx, m_idx = grid.coords
        assert ids[d_idx][m_idx] == rank
        assert grid.model.ranks == ids[d_idx]
        assert grid.data.ranks == [row[m_idx] for row in ids]
        assert grid.local_data_shard() == (d_idx, len(ids))
