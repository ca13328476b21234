"""The port's MoE LM (``models/moe.py``) against the JAX package's
``models/moe.py`` on the CPU, one process, on the same numpy inputs and
the same flax weights carried by ``models/convert.py``.

- ``MoEMLP`` at top-1 and top-2, in one and in two capacity groups: the
  output and the load-balance loss at 1e-5, the gradients of the input
  and of every parameter; the slot buffer bitwise the JAX one-hot einsum
  (``moe.py:102-126``); rank priority at capacity 1 and the drops to the
  residual (``tests/test_ep.py:33-111``); the JAX refusals.
- ``MoETransformerLM``: flash against full (``tests/test_flash_attention.py
  :102-115``), and both against the JAX forward at 1e-5.
- Three SGD steps of the MoE LM in two capacity groups against the JAX
  oracle step of ``tests/test_ep.py:114-158``, and of ``EPTrainStep`` on
  an axis of one rank against the JAX ep step on one device (top-2; the
  ranks' cases are ``tests/test_torch_ep.py``'s): losses at 1e-4 (the LM
  ``STEP_TOL``), parameters at rtol 5e-4 / atol 5e-5.
- The experts' init fan-in (flax counts the expert axis as receptive
  field), the convert round trip and the ep shards.
- Greedy decode against the JAX ``generate`` and the full forward's
  argmax, and batch rows decoding independently at the default capacity
  (``tests/test_generate.py:123-175``).
- The MoE FLOP count against the JAX count of the same step.

Every routing test asserts that its batches keep a gap of at least 1e-4
between the probabilities the routing compares, so that a choice that
flipped between the packages would show as a flip, not as rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ps_pytorch_tpu.models import moe as jax_moe
from ps_pytorch_tpu.models.generate import generate as jax_generate
from ps_pytorch_tpu.optim.sgd import sgd as jax_sgd
from ps_pytorch_tpu.parallel.dp import TrainState
from ps_pytorch_tpu.parallel.ep import make_ep_train_step
from ps_pytorch_tpu.parallel.mesh import make_mesh
from ps_pytorch_tpu.utils import flops as jax_flops
from ps_pytorch_tpu_torch import config
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.generate import generate
from ps_pytorch_tpu_torch.models.moe import (
    MoEMLP, MoETransformerLM, capacity, dispatch_slots, route,
)
from ps_pytorch_tpu_torch.optim import SGD
from ps_pytorch_tpu_torch.parallel import ep
from ps_pytorch_tpu_torch.parallel.mesh import Axis
from ps_pytorch_tpu_torch.utils import flops
from test_torch_train import two_torch_threads  # noqa: F401

FWD_TOL, STEP_TOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 5e-4, 5e-5
GAP = 1e-4
MLP = dict(n_experts=4, d_model=16, d_hidden=32)
LM = dict(vocab_size=64, n_layers=2, n_heads=4, d_model=32, n_experts=4,
          max_seq_len=16)
B, S = 4, 16
OPT = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)


def _gap(probs: np.ndarray, top_k: int) -> float:
    """The smallest gap between the probabilities routing compares: the
    best against the second best, and for top-2 the second against the
    third."""
    p = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    gaps = [p[:, 0] - p[:, 1]] + ([p[:, 1] - p[:, 2]] if top_k == 2 else [])
    return float(np.min(gaps))


def _mlp_inputs(seed, shape=(2, 8, 16)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mlp_params(seed, n_experts=4, d_model=16, d_hidden=32):
    """A flax MoEMLP tree drawn with numpy (biases nonzero, so that their
    paths are held too)."""
    rng = np.random.default_rng(seed)
    e, d, h = n_experts, d_model, d_hidden

    def draw(*shape, fan):
        return (rng.normal(size=shape) / np.sqrt(fan)).astype(np.float32)

    return {"router": {"kernel": draw(d, e, fan=d)},
            "experts_w1": draw(e, d, h, fan=d),
            "experts_b1": draw(e, h, fan=h),
            "experts_w2": draw(e, h, d, fan=h),
            "experts_b2": draw(e, d, fan=d)}


def _jax_mlp(top_k, groups=1, cf=1.25, **kw):
    mlp = jax_moe.MoEMLP(**dict(MLP, **kw), capacity_factor=cf,
                         top_k=top_k, n_groups=groups)
    return jax.jit(lambda p, x: mlp.apply({"params": p}, x)), mlp


def _port_mlp(params, top_k, groups=1, cf=1.25, **kw):
    m = MoEMLP(**dict(MLP, **kw), capacity_factor=cf, n_groups=groups,
               top_k=top_k)
    m.load_state_dict(convert.from_jax(params))
    return m


def _router_probs(params, x):
    t = np.asarray(x, np.float32).reshape(-1, x.shape[-1])
    return np.asarray(jax.nn.softmax(
        jnp.asarray(t) @ params["router"]["kernel"], axis=-1))


@pytest.mark.parametrize("top_k,groups", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_moe_mlp_matches_jax_forward_and_gradients(top_k, groups):
    _, mlp = _jax_mlp(top_k, groups)
    params, x = _mlp_params(1), _mlp_inputs(2)
    assert _gap(_router_probs(params, x), top_k) >= GAP
    w = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def jax_obj(p, xx):
        y, aux = mlp.apply({"params": p}, xx)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    m = _port_mlp(params, top_k, groups)
    tx = torch.tensor(x, requires_grad=True)
    ty, taux = m(tx)
    ((ty * torch.tensor(w)).sum() + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(taux.item(), float(aux), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                               rtol=1e-4, atol=FWD_TOL)
    want = convert.from_jax(jax.device_get(gp))
    for name, p in m.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=FWD_TOL,
            err_msg=name)


def _jax_dispatch(top_idx, groups, e, cap):
    """``moe.py:102-126``'s one-hot dispatch tensor [G, TG, E, C], as the
    JAX module computes it."""
    t, k = top_idx.shape
    tg = t // groups
    counts = jnp.zeros((groups, 1, e), jnp.float32)
    disp = jnp.zeros((groups, tg, e, cap), jnp.float32)
    for r in range(k):
        oh_g = jax.nn.one_hot(top_idx[:, r], e,
                              dtype=jnp.float32).reshape(groups, tg, e)
        pos = jnp.cumsum(oh_g, axis=1) - oh_g + counts
        pos_tok = jnp.sum(pos * oh_g, axis=-1)
        keep = pos_tok < cap
        slot = jax.nn.one_hot(pos_tok.astype(jnp.int32), cap,
                              dtype=jnp.float32)
        disp = disp + (oh_g * keep[..., None])[..., None] \
            * slot[:, :, None, :]
        counts = counts + jnp.sum(oh_g, axis=1, keepdims=True)
    return disp


@pytest.mark.parametrize("top_k,groups,cf", [(1, 1, 1.25), (2, 2, 1.25),
                                             (2, 1, 0.5), (1, 2, 0.25)])
def test_slot_buffer_is_the_jax_one_hot_einsum_bitwise(top_k, groups, cf):
    """The gathered [G, E, C, D] buffer equals ``einsum("gtec,gtd->gecd",
    disp, x)`` bit for bit, drops included."""
    x = torch.tensor(_mlp_inputs(3, (32, 16)))
    probs = torch.softmax(x @ torch.tensor(np.random.default_rng(7).normal(
        size=(16, 4)).astype(np.float32)), -1)
    assert _gap(probs.numpy(), top_k) >= GAP
    idx, _ = route(probs, top_k)
    want_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), top_k)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    cap = capacity(top_k, 32 // groups, 4, cf)
    rows = dispatch_slots(idx, groups, 4, cap)
    disp = _jax_dispatch(jnp.asarray(idx.numpy()), groups, 4, cap)
    want = jnp.einsum("gtec,gtd->gecd", disp,
                      jnp.asarray(x.numpy()).reshape(groups, -1, 16))
    n_slots = groups * 4 * cap
    src = torch.full((n_slots + 1,), 32, dtype=torch.long)
    src.scatter_(0, rows.reshape(-1),
                 torch.arange(32)[:, None].expand_as(rows).reshape(-1))
    got = torch.cat([x, x.new_zeros(1, 16)])[src[:n_slots]]
    np.testing.assert_array_equal(got.view(groups, 4, cap, 16).numpy(),
                                  np.asarray(want))


def test_ties_go_to_the_lower_expert_as_jax_top_k():
    probs = torch.tensor([[0.3, 0.3, 0.2, 0.2], [0.1, 0.3, 0.3, 0.3],
                          [0.25, 0.25, 0.25, 0.25]])
    for k in (1, 2):
        idx, _ = route(probs, k)
        np.testing.assert_array_equal(
            idx.numpy(), np.asarray(jax.lax.top_k(
                jnp.asarray(probs.numpy()), k)[1]))


def test_first_choices_claim_capacity_first():
    """Capacity 1 an expert: top-1 and top-2 each equal JAX, and a token's
    second choice never evicts another's first (``tests/test_ep.py:
    72-91``)."""
    kw = dict(n_experts=2, d_model=8, d_hidden=16)
    params, x = _mlp_params(6, **kw), _mlp_inputs(7, (1, 8, 8))
    assert _gap(_router_probs(params, x), 1) >= GAP
    ys = {}
    for k in (1, 2):
        want, _ = _jax_mlp(k, cf=2.0 / 8.0, **kw)[0](params, x)
        got, _ = _port_mlp(params, k, cf=2.0 / 8.0, **kw)(torch.tensor(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        ys[k] = got.detach().numpy().reshape(-1, 8)
    nz1, nz2 = (np.any(ys[k] != 0.0, axis=-1) for k in (1, 2))
    assert nz1.sum() == 2 and np.all(nz2[nz1])


def test_capacity_drops_to_the_residual():
    kw = dict(n_experts=2, d_model=8, d_hidden=16)
    params, x = _mlp_params(3, **kw), _mlp_inputs(2, (1, 8, 8))
    assert _gap(_router_probs(params, x), 1) >= GAP
    want, want_aux = _jax_mlp(1, cf=2.0 / 8.0, **kw)[0](params, x)
    got, aux = _port_mlp(params, 1, cf=2.0 / 8.0, **kw)(torch.tensor(x))
    got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=FWD_TOL)
    zero_rows = np.all(got.reshape(-1, 8) == 0.0, axis=-1)
    assert zero_rows.sum() == 8 - 2
    np.testing.assert_array_equal(zero_rows, np.all(
        np.asarray(want).reshape(-1, 8) == 0.0, axis=-1))


def test_refusals_are_the_jax_ones():
    with pytest.raises(ValueError, match="top_k must be 1 or 2, got 3"):
        MoEMLP(**MLP, top_k=3)
    x = torch.zeros(1, 6, 16)
    with pytest.raises(ValueError, match="6 tokens not divisible into 4"):
        MoEMLP(**MLP, n_groups=4)(x)
    with pytest.raises(ValueError, match="input feature dim 8"):
        MoEMLP(**MLP)(torch.zeros(1, 4, 8))


# ---- the LM ----

def _lm_params(seed=0, **kw):
    """A flax MoETransformerLM tree: the port's seeded init, carried
    across by ``convert.to_jax``."""
    m = MoETransformerLM(**dict(LM, **kw),
                         generator=torch.Generator().manual_seed(seed))
    return convert.to_jax(m.state_dict())[0]


def _port_lm(params, top_k=1, **kw) -> MoETransformerLM:
    m = MoETransformerLM(**dict(LM, **kw), top_k=top_k)
    m.load_state_dict(convert.from_jax(params))
    return m


class _Gaps:
    """The smallest routing gap of every MoE layer's forward."""

    def __init__(self, model, top_k):
        self.min = np.inf
        for mlp in model.moe_layers():
            mlp.router.register_forward_hook(
                lambda mod, inp, out: self._see(out, top_k))

    def _see(self, out, top_k):
        probs = torch.softmax(out.detach().float(), -1).numpy()
        self.min = min(self.min, _gap(probs, top_k))


def _tokens(seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, LM["vocab_size"], shape).astype(np.int32)


def test_moe_lm_flash_matches_full_and_jax():
    params = _lm_params()
    tok = _tokens(4)
    jm = jax_moe.MoETransformerLM(**LM, top_k=2)
    want, want_aux = jax.jit(lambda p, t: jm.apply({"params": p}, t))(
        params, tok)
    outs = {}
    for impl in ("full", "flash"):
        m = _port_lm(params, 2, attention_impl=impl)
        gaps = _Gaps(m, 2)
        with torch.no_grad():
            outs[impl] = m(torch.tensor(tok).long())
        assert gaps.min >= GAP
        np.testing.assert_allclose(outs[impl][0].numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(float(outs[impl][1]), float(want_aux),
                                   rtol=FWD_TOL)
    np.testing.assert_allclose(outs["flash"][0].numpy(),
                               outs["full"][0].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(outs["flash"][1]),
                               float(outs["full"][1]), rtol=1e-5, atol=1e-6)


def _jax_oracle_steps(params, batches, top_k, groups):
    """``tests/test_ep.py:126-149``'s reference step: the unsharded MoE LM
    in ``groups`` capacity groups, mean CE + 0.01 aux, SGD."""
    model = jax_moe.MoETransformerLM(**LM, top_k=top_k, n_groups=groups)
    tx = jax_sgd(**OPT)
    p = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=p,
                       opt_state=tx.init(p), batch_stats={})

    @jax.jit
    def step(state, tokens):
        def loss_fn(params):
            logits, aux = model.apply({"params": params}, tokens)
            per = optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1], tokens[:, 1:])
            return per.mean() + 0.01 * aux, per.mean()
        (_, ce), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        return state.replace(step=state.step + 1,
                             params=optax.apply_updates(state.params,
                                                        updates),
                             opt_state=new_opt), ce

    losses = []
    for tok in batches:
        state, ce = step(state, jnp.asarray(tok))
        losses.append(float(ce))
    return losses, jax.device_get(state.params), \
        jax.device_get(state.opt_state.momentum)


def _jax_ep_steps(params, batches, top_k):
    """The JAX ep step on a mesh of one device."""
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    model = jax_moe.MoETransformerLM(**LM, top_k=top_k, ep_axis="data")
    tx = jax_sgd(**OPT)
    p = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=p,
                       opt_state=tx.init(p), batch_stats={})
    step = make_ep_train_step(model, tx, mesh, state, donate=False)
    losses = []
    with mesh:
        for tok in batches:
            state, m = step(state, jnp.asarray(tok))
            losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params)


def _close_params(got: dict, want_tree: dict):
    want = convert.from_jax(want_tree)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("top_k", [1, 2])
def test_three_sgd_steps_in_two_groups_match_the_jax_oracle(top_k):
    params = _lm_params(seed=2)
    batches = [_tokens(10 + i) for i in range(3)]
    want_losses, want, _ = _jax_oracle_steps(params, batches, top_k, 2)
    model = _port_lm(params, top_k, n_groups=2)
    gaps = _Gaps(model, top_k)
    opt = SGD(**OPT)
    named = dict(model.named_parameters())
    state = opt.init(named)
    losses = []
    for tok in batches:
        t = torch.tensor(tok).long()
        for p in named.values():
            p.grad = None
        logits, aux = model(t)
        ce = F.cross_entropy(logits[:, :-1].reshape(-1, LM["vocab_size"]),
                             t[:, 1:].reshape(-1))
        (ce + 0.01 * aux).backward()
        with torch.no_grad():
            state = opt.apply(named, state,
                              {k: p.grad for k, p in named.items()})
        losses.append(float(ce))
    assert gaps.min >= GAP
    np.testing.assert_allclose(losses, want_losses, rtol=STEP_TOL,
                               atol=STEP_TOL)
    _close_params(dict(model.named_parameters()), want)


@pytest.mark.parametrize("top_k", [2])
def test_ep_step_on_one_rank_matches_the_jax_ep_step(top_k):
    params = _lm_params(seed=5)
    batches = [_tokens(20 + i) for i in range(3)]
    want_losses, want = _jax_ep_steps(params, batches, top_k)
    alone = Axis("data", [0], 0, None)
    model = ep.shard_model_(_port_lm(params, top_k), alone)
    gaps = _Gaps(model, top_k)
    step = ep.EPTrainStep(model, SGD(**OPT), alone)
    losses = [float(step(tok)["loss"]) for tok in batches]
    assert gaps.min >= GAP
    np.testing.assert_allclose(losses, want_losses, rtol=STEP_TOL,
                               atol=STEP_TOL)
    params_now, mom = ep.full_state(model, step.opt_state, alone)
    _close_params(params_now, want)
    assert set(mom) == set(params_now)


def test_expert_init_counts_the_expert_axis_as_fan_in():
    """flax's lecun_normal on [E, D, H] has fan-in E * D: std
    1/sqrt(4096) = 0.015625 for [8, 512, 2048], not 1/sqrt(512); and the
    port draws what flax draws (held at [8, 64, 256])."""
    m = MoEMLP(8, 512, 2048, generator=torch.Generator().manual_seed(0))
    for name, fan_in in (("experts_w1", 8 * 512), ("experts_w2", 8 * 2048)):
        got = float(getattr(m, name).detach().std())
        assert abs(got - fan_in ** -0.5) < 0.01 * fan_in ** -0.5, name
    small = MoEMLP(8, 64, 256, generator=torch.Generator().manual_seed(0))
    params = jax.device_get(jax.jit(jax_moe.MoEMLP(8, 64, 256).init)(
        jax.random.key(0), jnp.zeros((1, 8, 64)))["params"])
    for name in ("experts_w1", "experts_w2"):
        got = float(getattr(small, name).detach().std())
        want = float(np.std(params[name]))
        assert abs(got - want) < 0.01 * want, name
    for name in ("experts_b1", "experts_b2"):
        assert float(getattr(m, name).abs().max()) == 0.0
        assert float(np.abs(params[name]).max()) == 0.0


def test_convert_round_trips_the_moe_tree_and_its_ep_shards():
    params = _lm_params()
    sd = convert.from_jax(params)
    moe = params["block_0"]["moe"]
    assert sd["block_0.moe.experts_w1"].shape == moe["experts_w1"].shape
    np.testing.assert_array_equal(sd["block_0.moe.router.weight"].numpy(),
                                  moe["router"]["kernel"].T)
    back, _ = convert.to_jax(_port_lm(params, 2).state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, params)
    assert convert.jax_path("block_1.moe.experts_b2", 2) == (
        "block_1", "moe", "experts_b2")
    shards = [convert.ep_shard_from_jax(params, i, 2) for i in range(2)]
    assert shards[1]["block_0.moe.experts_w2"].shape == (2, 128, 32)
    np.testing.assert_array_equal(shards[1]["block_0.moe.experts_b1"],
                                  moe["experts_b1"][2:])
    np.testing.assert_array_equal(shards[0]["tok_embed.embedding"],
                                  params["tok_embed"]["embedding"])
    jax.tree.map(np.testing.assert_array_equal,
                 convert.ep_shards_to_jax(shards), params)


def test_moe_greedy_decode_matches_jax_and_the_full_forward():
    """``tests/test_generate.py:123-153``: capacity factor 8, so that the
    batched forward drops nothing and decode equals it."""
    geo = dict(vocab_size=37, d_model=32, n_layers=2, n_heads=4,
               n_experts=4, top_k=2, max_seq_len=32, capacity_factor=8.0)
    m = MoETransformerLM(**geo, generator=torch.Generator().manual_seed(5))
    params = convert.to_jax(m.state_dict())[0]
    prompt = np.random.default_rng(6).integers(0, 37, (2, 5))
    gaps = _Gaps(m, 2)
    got = generate(m, prompt, n_new=6, temperature=0.0).numpy()
    assert gaps.min >= GAP
    toks = prompt
    with torch.no_grad():
        for _ in range(6):
            logits, _ = m(torch.tensor(toks).long())
            nxt = logits[:, -1].argmax(-1).numpy()
            toks = np.concatenate([toks, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(got, toks)
    want = jax_generate(params, jnp.asarray(prompt, jnp.int32), n_new=6,
                        vocab=37, d_model=32, n_layers=2, n_heads=4,
                        max_seq_len=32, temperature=0.0, n_experts=4,
                        moe_top_k=2, moe_capacity_factor=8.0)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_moe_batch_rows_decode_independently_at_the_default_capacity():
    geo = dict(vocab_size=37, d_model=32, n_layers=2, n_heads=4,
               n_experts=4, top_k=1, max_seq_len=32)
    m = MoETransformerLM(**geo, generator=torch.Generator().manual_seed(8))
    params = convert.to_jax(m.state_dict())[0]
    p = np.random.default_rng(9).integers(0, 37, (3, 5))
    gaps = _Gaps(m, 1)
    both = generate(m, p, n_new=6, temperature=0.0).numpy()
    assert gaps.min >= GAP
    for i in range(3):
        solo = generate(m, p[i:i + 1], n_new=6, temperature=0.0).numpy()
        np.testing.assert_array_equal(both[i], solo[0])
    want = jax_generate(params, jnp.asarray(p, jnp.int32), n_new=6,
                        vocab=37, d_model=32, n_layers=2, n_heads=4,
                        max_seq_len=32, temperature=0.0, n_experts=4,
                        moe_top_k=1)
    np.testing.assert_array_equal(both, np.asarray(want))


@pytest.mark.parametrize("top_k,groups", [(1, 1), (2, 2)])
def test_moe_flop_count_is_the_jax_count(top_k, groups):
    """The JAX count traces the one-hot dispatch and combine einsums; the
    port adds them to its own count of the rest."""
    model = jax_moe.MoETransformerLM(**LM, top_k=top_k, n_groups=groups)
    tok = jnp.zeros((B, S), jnp.int32)
    params = jax.eval_shape(model.init, jax.random.key(0), tok)["params"]

    def loss(p, t):
        logits, aux = model.apply({"params": p}, t)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], t[:, 1:]).mean() + 0.01 * aux

    want = jax_flops.forward_flops(jax.value_and_grad(loss), params, tok)
    cfg = config.TrainConfig(
        network="MoETransformerLM", lm_parallelism="ep", eval_freq=0,
        batch_size=B, lm_vocab=LM["vocab_size"], lm_d_model=LM["d_model"],
        lm_layers=LM["n_layers"], lm_heads=LM["n_heads"], lm_seq_len=S,
        lm_experts=LM["n_experts"], lm_moe_top_k=top_k)
    assert flops.training_flops(cfg, groups=groups) == want
    dense = config.TrainConfig(**dict(
        cfg.__dict__, network="TransformerLM", lm_parallelism="sp"))
    assert flops.training_flops(dense) < want
