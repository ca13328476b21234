"""Weights across the two packages: flax trees <-> torch ``state_dict``.

The port's module names are the flax names, so the map is mechanical:

- conv ``kernel`` HWIO <-> ``weight`` OIHW;
- Dense ``kernel`` [in,out] <-> Linear ``weight`` [out,in];
- BatchNorm and LayerNorm ``scale``/``bias`` <-> ``weight``/``bias``;
- Embed ``embedding`` <-> ``embedding`` (the port's ``Embed`` keeps the
  flax name, so a 2-D ``weight`` is always a Dense kernel);
- ``batch_stats`` ``mean``/``var`` <-> ``running_mean``/``running_var``.

Trees are nested dicts of numpy arrays (``jax.device_get`` of the flax
variables). A training state's ``batch_stats`` carry a leading replica
axis ``[n_data]`` (``parallel/dp.py``); ``from_jax`` takes replica 0.
"""

from typing import Dict, Tuple

import numpy as np
import torch


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def from_jax(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) -> torch state_dict."""
    sd = {}
    for path, a in _walk(params):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel" and a.ndim == 4:
            sd[f"{mod}.weight"] = a.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and a.ndim == 2:
            sd[f"{mod}.weight"] = a.T
        elif leaf == "scale":
            sd[f"{mod}.weight"] = a
        elif leaf in ("bias", "embedding"):
            sd[f"{mod}.{leaf}"] = a
        else:
            raise ValueError(f"unknown param {'/'.join(path)} {a.shape}")
    for path, a in _walk(batch_stats or {}):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if a.ndim == 2:             # [n_data, C]: replica 0's statistics
            a = a[0]
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
        for part in key.split("."):
            node = node.setdefault(part, {})
        node[leaf] = value

    for name, t in state_dict.items():
        a = t.detach().cpu().float().numpy()
        mod, leaf = name.rsplit(".", 1)
        if leaf == "weight" and a.ndim == 4:
            put(params, mod, "kernel", a.transpose(2, 3, 1, 0))
        elif leaf == "weight" and a.ndim == 2:
            put(params, mod, "kernel", a.T)
        elif leaf == "weight":
            put(params, mod, "scale", a)
        elif leaf in ("bias", "embedding"):
            put(params, mod, leaf, a)
        elif leaf == "running_mean":
            put(stats, mod, "mean", a)
        elif leaf == "running_var":
            put(stats, mod, "var", a)
        else:
            raise ValueError(f"unknown state_dict entry {name}")
    return params, stats
