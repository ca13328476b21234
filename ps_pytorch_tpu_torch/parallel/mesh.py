"""The rank grid of the port: the JAX package's ``parallel/mesh.py``
(``make_mesh`` ``:19-37``, ``local_data_shard`` ``:40-43``) over the
ranks of a ``torch.distributed`` group.

One JAX device of the LM mesh is one rank here: one process on
``cuda:{rank % cards}`` (``parallel/dist.py``). The grid is ``(data,
model)``, row-major as the JAX ``reshape(data, model)`` lays the device
order out, so rank ``r`` sits at ``(r // model, r % model)``. Each axis
is an ``Axis``: the ranks along it through this rank, this rank's index
among them and their ``dist.new_group``. Every rank creates every group,
in the same order (the data groups, then the model groups), as
``new_group`` requires. In a single process every axis has one rank and
no group, and the collectives over it return their input.
"""

from typing import List, Optional, Tuple

import torch.distributed as tdist

from ps_pytorch_tpu_torch.parallel import dist


class Axis:
    """The ranks along one axis of the grid through this rank."""

    def __init__(self, name: str, ranks: List[int], index: int,
                 group: Optional[tdist.ProcessGroup]):
        self.name, self.ranks, self.index, self.group = \
            name, list(ranks), index, group
        self.size = len(self.ranks)


class RankGrid:
    """A ``(data, model)`` grid over ``world`` ranks, seen from ``rank``:
    ``coords`` = (data index, model index), and the ``data`` and ``model``
    axes through this rank."""

    def __init__(self, data: int, model: int, rank: int,
                 groups: Optional[dict] = None):
        self.rank = rank
        self.coords = (rank // model, rank % model)
        d_idx, m_idx = self.coords
        groups = groups or {}
        data_ranks = [m_idx + model * i for i in range(data)]
        model_ranks = [d_idx * model + j for j in range(model)]
        self.data = Axis("data", data_ranks, d_idx,
                         groups.get(("data", m_idx)))
        self.model = Axis("model", model_ranks, m_idx,
                          groups.get(("model", d_idx)))
        self.world = Axis("world", list(range(data * model)), rank,
                          groups.get("world"))

    def local_data_shard(self) -> Tuple[int, int]:
        """(this rank's place along ``data``, the data axis's size): the
        slice of a batch sharded over ``data`` that this rank holds."""
        return self.data.index, self.data.size


def make_grid(data: int = 0, model: int = 1) -> RankGrid:
    """The ``(data, model)`` grid over the process group, seen from this
    rank. ``data=0`` means ``world // model``; the JAX package's errors for
    a grid that does not fit. Every rank must call this, in the same order
    relative to other group creation."""
    n, r = dist.world(), dist.rank()
    if data == 0:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    need = data * model
    if need > n:
        raise ValueError(f"mesh {data}x{model} needs {need} devices, have {n}")
    if need < n:
        # The JAX mesh leaves the devices past data x model out; a rank
        # out of the grid would hold no part of the step.
        raise ValueError(f"mesh {data}x{model} places {need} of {n} ranks; "
                         "launch data x model ranks")
    groups = None
    if tdist.is_initialized() and n > 1:
        groups = {}
        for m in range(model):
            groups[("data", m)] = tdist.new_group(
                [m + model * i for i in range(data)])
        for d in range(data):
            groups[("model", d)] = tdist.new_group(
                [d * model + j for j in range(model)])
        groups["world"] = tdist.group.WORLD
    return RankGrid(data, model, r, groups)
