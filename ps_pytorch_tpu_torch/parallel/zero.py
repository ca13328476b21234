"""Cross-replica sharded weight update (ZeRO-1): the JAX package's
``parallel/zero.py`` (``create_zero_train_state`` ``:49-75``,
``make_zero_train_step`` ``:87-163``) over ``torch.distributed``.

Each replica keeps the whole model but the optimizer state of one slice
of the flat parameter vector only, so its optimizer memory drops by the
group's size. A step:

- forward and backward into the flat gradient, times the replica's mask
  entry ``m``, padded with zeros to ``chunk * world`` where
  ``chunk = ceil(size / world)``;
- reduce-scatter: replica r receives the summed slice
  ``[r * chunk, (r + 1) * chunk)``, divided by ``denom = max(sum(m), 1)``;
- the global gradient norm ``sqrt(all_reduce(dot(gshard, gshard)))`` (the
  padding is zeros);
- the optimizer on this replica's slice of the flat parameters, in place:
  with ``--fused-optimizer`` the hand-written fused SGD / Adam kernels on
  a 1-D slice, else the plain optimizer;
- all-gather of the updated slices back into the flat parameter buffer,
  which the model's parameters are views of.

An all-zero mask, and under ``skip_nonfinite`` a non-finite norm, leave
parameters and optimizer state untouched (``zero.py:131-137``); every
replica takes that decision on the same reduced values.

Checkpoints keep the JAX layout of ``create_zero_train_state``: each
optimizer moment an array ``[world, chunk]`` over the JAX flat order
(``ravel_pytree``: the leaves sorted by flax path, conv kernels HWIO,
dense kernels [in, out]), the step counter a scalar. The port slices its
own flat order (``named_parameters``, its own layouts), so a replica's
slice holds other parameters than the JAX replica's; the layout is
converted on the host when the state is written and read.
``gather_opt_state`` assembles it on every process (a collective) and
``restore_opt_state`` copies this replica's slice back into the
optimizer's buffers.

The reduce-scatter is ``dist.reduce_scatter_tensor`` on every (backend,
device) pair the port's groups run (:data:`REDUCE_SCATTER`: NCCL, and gloo
on CPU and on CUDA tensors, which torch 2.11 on the H100 has); the step
checks its group's pair once, when it is built (``scatter_route``).
"""

import numpy as np
import torch
import torch.distributed as dist

from ps_pytorch_tpu_torch.models.convert import (
    jax_path, leaf_layout, opt_fields,
)
from ps_pytorch_tpu_torch.parallel.dp import TrainStep

# (backend, device type) pairs whose reduce-scatter the step uses: every
# pair parallel/dist.py:choose_backend gives.
REDUCE_SCATTER = frozenset({("nccl", "cuda"), ("gloo", "cpu"),
                            ("gloo", "cuda")})


def scatter_route(backend: str, device_type: str) -> str:
    """The collective that reduce-scatters the gradient for a group of
    ``backend`` on ``device_type`` tensors; raises for a pair the port
    does not run."""
    if (backend, device_type) not in REDUCE_SCATTER:
        raise ValueError(f"the sharded update has no reduce-scatter for "
                         f"{backend} on {device_type} tensors")
    return "reduce_scatter_tensor"


class ZeroTrainStep(TrainStep):
    """``parallel/dp.py:TrainStep`` with the update sharded over the
    group. ``chunk`` is the slice length; ``shard`` this replica's slice
    of the flat parameters (a view); ``opt_state`` the optimizer's state
    over the slice alone."""

    def _init_state(self):
        self.chunk = -(-self.size // self.world)
        padded = self.chunk * self.world
        ref = next(iter(self.params.values()))
        # The parameters become views of one padded flat buffer, the
        # all-gather's output; the tail past ``size`` stays zero.
        self.flat_p = torch.zeros(padded, dtype=torch.float32,
                                  device=ref.device)
        off = 0
        with torch.no_grad():
            for name, p in self.params.items():
                if p.dtype != torch.float32:
                    raise ValueError(f"{name}: the sharded update takes "
                                     "float32 parameters")
                view = self.flat_p[off:off + p.numel()].view_as(p)
                view.copy_(p)
                p.data = view
                off += p.numel()
        lo = self.rank * self.chunk
        self.shard = self.flat_p[lo:lo + self.chunk]
        # The reduced slice of the gradient; a view that tiles its own
        # buffer, so the fused optimizers read it without a copy.
        self._gshard_base = torch.zeros(self.chunk, dtype=torch.float32,
                                        device=ref.device)
        self.gshard = self._gshard_base[:]
        self.scatter = (scatter_route(dist.get_backend(self.group),
                                      ref.device.type)
                        if self.group is not None else "none")
        return self.opt.init({"shard": self.shard})

    def _grad_size(self) -> int:
        return self.chunk * self.world

    def _reduce_and_update(self, m: float, msum: float,
                           denom: float) -> torch.Tensor:
        if self.group is not None:
            self._timed(dist.reduce_scatter_tensor, self._gshard_base,
                        self.flat_grad)
        else:
            self._gshard_base.copy_(self.flat_grad)
        self._gshard_base.div_(denom)
        sq = torch.dot(self.gshard, self.gshard).reshape(1)
        self._all_reduce(sq)
        gnorm = sq[0].sqrt()
        if self._stepped(msum, gnorm):
            self.opt_state = self.opt.apply(
                {"shard": self.shard}, self.opt_state,
                {"shard": self.gshard})
            if self.group is not None:
                # In place: this replica's slice is its own input.
                self._timed(dist.all_gather_into_tensor, self.flat_p,
                            self.shard)
        return gnorm

    # ---- the JAX layout of the sharded optimizer state ----
    def _leaves(self):
        """(name, port shape, offset in the port's flat order) of every
        parameter, in the JAX flat order: ``ravel_pytree`` of the flax
        tree, the leaves sorted by their flax path, each raveled in its
        JAX layout (HWIO, [in, out])."""
        out, off = [], 0
        for name, p in self.params.items():
            out.append((jax_path(name, p.dim()), name, tuple(p.shape), off))
            off += p.numel()
        return [leaf[1:] for leaf in sorted(out)]

    def _to_jax_flat(self, flat: np.ndarray) -> np.ndarray:
        """A moment over the whole model in the port's flat order ->
        the JAX flat order, padded to ``world * chunk``."""
        parts = [leaf_layout(name, flat[off:off + int(np.prod(shape))]
                             .reshape(shape), True).reshape(-1)
                 for name, shape, off in self._leaves()]
        out = np.zeros(self.world * self.chunk, np.float32)
        out[:self.size] = np.concatenate(parts)
        return out

    def _from_jax_flat(self, flat: np.ndarray) -> np.ndarray:
        """The inverse of ``_to_jax_flat``."""
        out = np.zeros(self.world * self.chunk, np.float32)
        pos = 0
        for name, shape, off in self._leaves():
            n = int(np.prod(shape))
            jax_shape = leaf_layout(name, np.empty(shape), True).shape
            out[off:off + n] = leaf_layout(
                name, flat[pos:pos + n].reshape(jax_shape), False
            ).reshape(-1)
            pos += n
        return out

    def gather_opt_state(self) -> dict:
        """The optimizer state as ``create_zero_train_state`` lays it out:
        ``{"step": int32, field: float32 [world, chunk] or {}}``, row r
        the slice r of the JAX flat order, on every process (a
        collective: all of them call it)."""
        out = {"step": np.asarray(self.opt_state.step, np.int32)}
        for field in opt_fields(self.opt_state):
            moment = getattr(self.opt_state, field)
            if not moment:
                out[field] = {}
                continue
            own = moment["shard"]
            rows = torch.empty(self.world * self.chunk, dtype=own.dtype,
                               device=own.device)
            if self.group is not None:
                dist.all_gather_into_tensor(rows, own.contiguous(),
                                            group=self.group)
            else:
                rows.copy_(own)
            out[field] = self._to_jax_flat(rows.cpu().numpy()).reshape(
                self.world, self.chunk)
        return out

    def restore_opt_state(self, stored: dict) -> None:
        """Copy this replica's slice of a ``gather_opt_state`` tree (or one
        the JAX ZeRO trainer wrote) into the optimizer's buffers, and its
        step; everything is checked before anything is copied."""
        fields = opt_fields(self.opt_state)
        if set(stored) != {"step", *fields}:
            raise ValueError(f"the checkpoint's optimizer state has "
                             f"{sorted(stored)}, this optimizer "
                             f"{sorted(('step',) + fields)}")
        pairs = []
        lo = self.rank * self.chunk
        for field in fields:
            moment = getattr(self.opt_state, field) or {}
            got = stored[field]
            if isinstance(got, dict) and not got and not moment:
                continue
            want = (self.world, self.chunk)
            if isinstance(got, dict) or np.shape(got) != want:
                raise ValueError(
                    f"{field}: the checkpoint holds "
                    f"{'a tree' if isinstance(got, dict) else np.shape(got)}"
                    f", the sharded update over {self.world} replicas "
                    f"{want}: resume with the --shard-update and world "
                    "size that wrote it")
            flat = self._from_jax_flat(
                np.asarray(got, np.float32).reshape(-1))
            pairs.append((moment["shard"], flat[lo:lo + self.chunk]))
        with torch.no_grad():
            for dst, row in pairs:
                dst.copy_(torch.from_numpy(row))
        self.opt_state = self.opt_state._replace(step=int(stored["step"]))


def opt_state_bytes(opt_state) -> int:
    """Bytes of optimizer moments a replica holds (a ``TrainStep``'s whole
    tree, a ``ZeroTrainStep``'s slice)."""
    return sum(t.numel() * t.element_size()
               for field in opt_fields(opt_state)
               for t in (getattr(opt_state, field) or {}).values())

