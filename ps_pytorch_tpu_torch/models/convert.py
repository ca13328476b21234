"""Weights across the two packages: flax trees <-> torch ``state_dict``.

The port's module names are the flax names, so the map is mechanical:

- conv ``kernel`` HWIO <-> ``weight`` OIHW;
- Dense ``kernel`` [in,out] <-> Linear ``weight`` [out,in];
- BatchNorm and LayerNorm ``scale``/``bias`` <-> ``weight``/``bias``;
- Embed ``embedding`` <-> ``embedding`` (the port's ``Embed`` keeps the
  flax name, so a 2-D ``weight`` is always a Dense kernel);
- the MoE experts' raw parameters ``experts_w1/b1/w2/b2``
  (``models/moe.py``) cross as they are, in the flax layout [E, D, H] /
  [E, H] / [E, H, D] / [E, D];
- ``batch_stats`` ``mean``/``var`` <-> ``running_mean``/``running_var``.

Trees are nested dicts of numpy arrays (``jax.device_get`` of the flax
variables). A training state's ``batch_stats`` carry a leading replica
axis ``[n_data]`` (``parallel/dp.py``); ``from_jax`` takes one replica's,
replica 0's unless told otherwise.

``state_to_jax``/``state_from_jax`` carry a whole training state across:
the JAX ``TrainState`` (``parallel/dp.py:36-40``) as the dict that flax
serializes, with ``opt_state`` in the JAX optimizers' structures.

The LM's sharded layouts, for a params tree or a momentum tree alike (the
momentum mirrors the parameters):

- tensor parallelism (``parallel/tp.py``): ``tp_shard_from_jax`` maps a
  JAX TransformerLM tree to one rank's column and row shards,
  ``tp_shards_to_jax`` every rank's shards back to the tree;
- the pipeline (``parallel/pp.py``): ``pp_stage_from_jax`` maps the JAX
  stage-stacked tree (``blocks`` [n_stages, layers_per_stage, ...]) to one
  stage's blocks and the edges, ``pp_stages_to_jax`` every stage's state
  back to the stacked tree;
- expert parallelism (``parallel/ep.py``): ``ep_shard_from_jax`` maps a
  JAX MoETransformerLM tree to one rank's state dict, the ``experts_*``
  leaves sliced along their expert axis, ``ep_shards_to_jax`` every
  rank's back to the tree (the JAX ``ep_param_specs``).
"""

import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ps_pytorch_tpu_torch.optim.adam import AdamState

# The stacked expert parameters of ``models/moe.py`` (the JAX
# ``ep.py:_EXPERT_KEY``).
EXPERTS = "experts_"


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def from_jax(params, batch_stats=None,
             replica: int = 0) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) -> torch state_dict. Statistics
    with a replica axis give replica ``replica``'s, or replica 0's when
    they hold fewer replicas (a checkpoint of a smaller world)."""
    sd = {}
    for path, a in _walk(params):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel" and a.ndim == 4:
            sd[f"{mod}.weight"] = a.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and a.ndim == 2:
            sd[f"{mod}.weight"] = a.T
        elif leaf == "scale":
            sd[f"{mod}.weight"] = a
        elif leaf in ("bias", "embedding") or leaf.startswith(EXPERTS):
            sd[".".join(path)] = a
        else:
            raise ValueError(f"unknown param {'/'.join(path)} {a.shape}")
    for path, a in _walk(batch_stats or {}):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if a.ndim == 2:             # [n_data, C]
            a = a[replica if replica < len(a) else 0]
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise ValueError(f"unknown batch stat {'/'.join(path)}")
        sd[f"{mod}.{names[leaf]}"] = a
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def to_jax(state_dict) -> Tuple[dict, dict]:
    """torch state_dict -> (flax params, flax batch_stats) as nested dicts
    of numpy arrays (batch_stats without a replica axis)."""
    params, stats = {}, {}

    def put(tree, key, leaf, value):
        node = tree
        for part in key.split(".") if key else ():
            node = node.setdefault(part, {})
        node[leaf] = value

    for name, t in state_dict.items():
        a = t.detach().cpu().float().numpy()
        mod, _, leaf = name.rpartition(".")
        if leaf == "weight" and a.ndim == 4:
            put(params, mod, "kernel", a.transpose(2, 3, 1, 0))
        elif leaf == "weight" and a.ndim == 2:
            put(params, mod, "kernel", a.T)
        elif leaf == "weight":
            put(params, mod, "scale", a)
        elif leaf in ("bias", "embedding") or leaf.startswith(EXPERTS):
            put(params, mod, leaf, a)
        elif leaf == "running_mean":
            put(stats, mod, "mean", a)
        elif leaf == "running_var":
            put(stats, mod, "var", a)
        else:
            raise ValueError(f"unknown state_dict entry {name}")
    return params, stats


def leaf_layout(name: str, a, to_jax: bool):
    """One parameter-shaped array (a gradient, an error-feedback residual)
    of the port's parameter ``name`` between the two layouts: conv OIHW <->
    HWIO, Linear [out,in] <-> [in,out], everything else as it is. A numpy
    array gives a numpy view, a tensor a tensor view on its own device
    (``.contiguous()`` lays it out)."""
    if name.endswith(".weight") and a.ndim == 4:
        order = (2, 3, 1, 0) if to_jax else (3, 2, 0, 1)
        return a.permute(*order) if isinstance(a, torch.Tensor) \
            else a.transpose(order)
    if name.endswith(".weight") and a.ndim == 2:
        return a.T
    return a


def jax_path(name: str, ndim: int) -> Tuple[str, ...]:
    """The flax path of the port's parameter ``name`` (of ``ndim``
    dimensions): ``Conv_0.weight`` -> ``("Conv_0", "kernel")``."""
    mod, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    elif leaf not in ("bias", "embedding") and not leaf.startswith(EXPERTS):
        raise ValueError(f"unknown param {name}")
    return tuple(mod.split(".")) + (leaf,)


def nest(paths, leaves) -> dict:
    """A nested dict holding ``leaves`` at ``paths`` (tuples of keys)."""
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


def _sorted(tree: dict) -> dict:
    """Every dict of the tree with sorted keys, as ``jax.device_get``
    leaves them before the JAX package serializes a state."""
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _moments_to_jax(moments) -> dict:
    """name -> tensor (or ``()``: no buffers) -> a flax params-shaped
    tree ({} for none)."""
    return _sorted(to_jax(moments)[0]) if moments else {}


def opt_fields(opt_state) -> tuple:
    """The JAX optimizer state's fields, in their declared order:
    ``AdamState(step, exp_avg, exp_avg_sq, max_exp_avg_sq)`` and
    ``SGDState(step, momentum)``."""
    if isinstance(opt_state, AdamState):
        return ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")
    return ("momentum",)


def _stack(trees: list) -> dict:
    """Trees of one structure -> one tree, each leaf stacked on a new
    leading axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else np.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def state_to_jax(model, opt_state, step: int,
                 replica_buffers: Optional[list] = None,
                 opt_tree: Optional[dict] = None) -> dict:
    """The port's training state -> the JAX ``TrainState`` as the dict
    flax serializes: ``step`` int32 0-d, ``params``, ``opt_state`` and
    ``batch_stats`` with a replica axis, fields in declared order and
    every other dict sorted. The replica axis holds the model's own
    statistics, or each replica's from ``replica_buffers`` (one dict of
    BatchNorm buffers a replica, in replica order). The port's ``flat``
    buffers are not written (the moments are views of them).
    ``opt_tree`` replaces the optimizer state as it is given (the sharded
    update's layout, ``parallel/zero.py:gather_opt_state``). ``model``
    may be a state dict, which has no buffers (the gathered LM)."""
    held = isinstance(model, dict)
    params, stats = to_jax(model if held else model.state_dict())
    opt = opt_tree
    if opt is None:
        opt = {"step": np.asarray(opt_state.step, np.int32)}
        for field in opt_fields(opt_state):
            opt[field] = _moments_to_jax(getattr(opt_state, field))
    stats = _stack([to_jax(b)[1] for b in replica_buffers or [
        {} if held else dict(model.named_buffers())]])
    return {"step": np.asarray(step, np.int32), "params": _sorted(params),
            "opt_state": opt, "batch_stats": _sorted(stats)}


def _check_fits(got: Dict[str, torch.Tensor], own: Dict[str, torch.Tensor],
                what: str) -> None:
    if set(got) != set(own):
        raise ValueError(f"{what}: the checkpoint holds {sorted(got)}, the "
                         f"model {sorted(own)}")
    for k, t in got.items():
        if t.shape != own[k].shape:
            raise ValueError(f"{what} {k}: checkpoint {tuple(t.shape)}, "
                             f"model {tuple(own[k].shape)}")


def state_from_jax(tree: dict, model: torch.nn.Module, opt_state=None,
                   replica: int = 0,
                   local: Optional[Callable] = None
                   ) -> Tuple[Optional[tuple], int]:
    """A JAX ``TrainState`` dict (``state_to_jax``'s layout, or one the
    JAX package wrote: replica ``replica``'s BatchNorm statistics are
    taken, as ``from_jax`` picks them) -> the
    model's parameters and buffers and, given ``opt_state``, its moments,
    all copied INTO the existing storage (the fused optimizers hold the
    parameters as views of their flat buffer). Everything is checked
    before anything is copied. Returns (the optimizer state with the
    stored step, or None; the stored training step). ``local(name,
    tensor)`` gives this rank's part of a whole tensor, or None for a
    tensor the rank does not hold (a tp shard, a pp stage)."""
    own = model.state_dict()

    def part(sd):
        if local is None:
            return sd
        out = {k: local(k, v) for k, v in sd.items()}
        return {k: v for k, v in out.items() if v is not None}

    sd = part(from_jax(tree["params"], tree.get("batch_stats"), replica))
    _check_fits(sd, own, "model")
    pairs = [(own[k], sd[k]) for k in sd]
    if opt_state is not None:
        stored = tree["opt_state"]
        fields = opt_fields(opt_state)
        if set(stored) != {"step", *fields}:
            raise ValueError(f"the checkpoint's optimizer state has "
                             f"{sorted(stored)}, this optimizer "
                             f"{sorted(('step',) + fields)}")
        for field in fields:
            if not isinstance(stored[field], dict):
                raise ValueError(
                    f"{field}: the checkpoint holds the sharded update's "
                    "layout (ZeRO-1, [world, chunk]); resume it with "
                    "--shard-update")
            mine = getattr(opt_state, field) or {}
            got = part(from_jax(stored[field])) if stored[field] else {}
            _check_fits(got, mine, field)
            pairs += [(mine[k], got[k]) for k in got]
        opt_state = opt_state._replace(step=int(stored["step"]))
    with torch.no_grad():
        for dst, src in pairs:
            dst.copy_(src)
    return opt_state, int(tree["step"])


# ---- the LM's sharded layouts ----

# The parameters tensor parallelism shards, and the dimension of the torch
# tensor it shards (the JAX ``tp.py:_KERNEL_RULES`` in the [out, in]
# layout): column-parallel kernels and bias along out, row-parallel
# kernels along in.
_TP_RULES = ((re.compile(r"Dense_[012]\.weight$"), 0),
             (re.compile(r"Dense_3\.weight$"), 1),
             (re.compile(r"Dense_4\.weight$"), 0),
             (re.compile(r"Dense_5\.weight$"), 1),
             (re.compile(r"lm_head\.weight$"), 0),
             (re.compile(r"Dense_4\.bias$"), 0))


def tp_shard_dim(name: str) -> Optional[int]:
    """The dimension of the port's parameter ``name`` that tensor
    parallelism shards, or None for a replicated one."""
    for pat, dim in _TP_RULES:
        if pat.search(name):
            return dim
    return None


def shard(full: torch.Tensor, dim: Optional[int], index: int,
          size: int) -> torch.Tensor:
    """Rank ``index`` of ``size``'s part of ``full`` sharded along ``dim``
    (a view; ``full`` itself when ``dim`` is None: replicated)."""
    if dim is None:
        return full
    chunk = full.shape[dim] // size
    return full.narrow(dim, index * chunk, chunk)


def unshard(parts: List[torch.Tensor], dim: Optional[int]) -> torch.Tensor:
    """The whole tensor from every rank's part along ``dim``, in rank
    order (rank 0's when replicated)."""
    return parts[0] if dim is None else torch.cat(parts, dim=dim)


def tp_shard(name: str, full: torch.Tensor, index: int,
             size: int) -> torch.Tensor:
    """Rank ``index`` of ``size``'s part of the whole tensor of parameter
    ``name`` under tensor parallelism."""
    return shard(full, tp_shard_dim(name), index, size)


def tp_shard_from_jax(params: dict, index: int,
                      size: int) -> Dict[str, torch.Tensor]:
    """A JAX TransformerLM tree -> rank ``index`` of ``size``'s state dict
    of column and row shards."""
    return {name: tp_shard(name, t, index, size).clone()
            for name, t in from_jax(params).items()}


def tp_shards_to_jax(shards: List[Dict[str, torch.Tensor]]) -> dict:
    """Every rank's shard state dict, in rank order -> the JAX tree."""
    full = {name: unshard([s[name] for s in shards], tp_shard_dim(name))
            for name in shards[0]}
    return _sorted(to_jax(full)[0])


def _pp_stage_names(names, stage: int, n_stages: int, n_layers: int):
    per = n_layers // n_stages
    mine = {f"block_{i}" for i in range(stage * per, (stage + 1) * per)}
    return [k for k in names
            if not k.startswith("block_") or k.split(".")[0] in mine]


def pp_stage_from_jax(pp_params: dict, stage: int
                      ) -> Dict[str, torch.Tensor]:
    """A JAX stage-stacked tree -> stage ``stage``'s state dict: its
    blocks under their global names (``block_{i}``) and the edges
    (``tok_embed``, ``pos_embed``, ``ln_f``, ``lm_head``)."""
    from ps_pytorch_tpu_torch.parallel.pp import unstack_stage_params
    n_stages = next(_walk(pp_params["blocks"]))[1].shape[0]
    plain = unstack_stage_params(pp_params)
    n_layers = sum(k.startswith("block_") for k in plain)
    sd = from_jax(plain)
    return {k: sd[k] for k in _pp_stage_names(sd, stage, n_stages, n_layers)}


def pp_stages_to_jax(stages: List[Dict[str, torch.Tensor]]) -> dict:
    """Every stage's state dict, in stage order -> the JAX stage-stacked
    tree (the edges from stage 0)."""
    from ps_pytorch_tpu_torch.parallel.pp import stack_stage_params
    full = dict(stages[0])
    for sd in stages[1:]:
        full.update({k: v for k, v in sd.items() if k.startswith("block_")})
    return stack_stage_params(_sorted(to_jax(full)[0]), len(stages))


def ep_shard_dim(name: str) -> Optional[int]:
    """The dimension of the port's parameter ``name`` that expert
    parallelism shards: the expert axis of an ``experts_*`` leaf, None for
    a replicated one."""
    return 0 if name.rpartition(".")[2].startswith(EXPERTS) else None


def ep_shard(name: str, full: torch.Tensor, index: int,
             size: int) -> torch.Tensor:
    """Rank ``index`` of ``size``'s part of the whole tensor of parameter
    ``name`` under expert parallelism."""
    return shard(full, ep_shard_dim(name), index, size)


def ep_shard_from_jax(params: dict, index: int,
                      size: int) -> Dict[str, torch.Tensor]:
    """A JAX MoETransformerLM tree (or its momentum) -> rank ``index`` of
    ``size``'s state dict."""
    return {name: ep_shard(name, t, index, size).clone()
            for name, t in from_jax(params).items()}


def ep_shards_to_jax(shards: List[Dict[str, torch.Tensor]]) -> dict:
    """Every rank's state dict, in rank order -> the JAX tree, the experts
    stacked whole."""
    full = {name: unshard([s[name] for s in shards], ep_shard_dim(name))
            for name in shards[0]}
    return _sorted(to_jax(full)[0])
