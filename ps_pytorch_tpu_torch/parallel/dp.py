"""The data-parallel train step, the JAX package's ``parallel/dp.py``
(``make_train_step`` ``:174-245``, ``make_eval_step`` ``:248-272``), and
the reduction of eval batches (its ``runtime/evaluator.py:accumulate_eval``).

One process per replica. Each replica runs forward and backward on its
local batch; gradients are averaged over the participating replicas with a
masked mean ``sum(g*m)/max(sum(m),1)``, one ``all_reduce`` of one flat
gradient buffer whenever a process group is given (at world 1 too, so a
one-rank launch runs the same collective path). BatchNorm
statistics stay local to each replica, as in the reference, unless
``sync_batchnorm`` averages them after the update; ``remat`` recomputes
the forward in the backward; ``shard_update`` shards the update
(ZeRO-1, ``parallel/zero.py``). An all-zero
mask leaves parameters and optimizer state untouched (``:217-226``), and
``skip_nonfinite`` does the same for a step whose gradient norm is not
finite.

The parameters' ``.grad`` are views of that flat buffer, so backward
writes the gradients where the reduction and the fused optimizer read them.

A model with Dropout (VGG) draws its masks from one device generator that
the step seeds from the step's ``key`` and the replica index before the
forward, the counterpart of the JAX step's ``fold_in(rng,
axis_index("data"))`` (``:201``): the draws depend only on (key, replica),
so a resumed run draws what an uninterrupted one draws. They are torch's
Philox, not threefry: the two packages' masks differ by design.
"""

import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _tensor(a, device) -> torch.Tensor:
    """A host array, or a tensor already on ``device``, -> the tensor on
    ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device, non_blocking=True)


def _input(x, device, input_norm) -> torch.Tensor:
    """Host batch (or one already on the device) -> device tensor; raw
    uint8 is normalized on the device (``x * scale - shift``,
    dp.py:97-103)."""
    x = _tensor(x, device)
    if input_norm is not None:
        scale = torch.as_tensor(input_norm[0], device=device)
        shift = torch.as_tensor(input_norm[1], device=device)
        x = x.float() * scale - shift
    return x


class DropoutDraws:
    """The model's Dropout layers share one ``torch.Generator`` on
    ``device``; ``seed(key, index)`` seeds it before a forward. A model
    without Dropout holds no generator and pays nothing."""

    def __init__(self, model: torch.nn.Module, device: torch.device):
        from ps_pytorch_tpu_torch.models.layers import Dropout
        layers = [m for m in model.modules() if isinstance(m, Dropout)]
        self.generator = torch.Generator(device=device) if layers else None
        for m in layers:
            m.generator = self.generator

    def seed(self, key: Optional[int], index: int) -> None:
        """Seed the draws of replica (or slice) ``index`` at the step's
        ``key`` (``cfg.seed * 100003 + step``)."""
        if self.generator is None:
            return
        if key is None:
            raise ValueError("the model has Dropout: the step needs its key "
                             "(cfg.seed * 100003 + step)")
        self.generator.manual_seed((key * 1_000_003 + index) % (1 << 63))


class TrainStep:
    """``step(x, y, mask, key=None) -> metrics``: x the local [B,H,W,C]
    batch, y its labels, mask the [world] participation vector, key the
    step's Dropout key (needed only by a model with Dropout). Metrics are 0-d device
    tensors (loss, accuracy, participating, grad_norm, nonfinite): reading
    one waits for the device. ``comm_s`` is the time the last call spent
    in its collectives, waiting for the other replicas included: on gloo
    the host clock around each call (gloo returns once the reduction,
    through host memory, is done); on NCCL, which returns before the
    reduction ends, the stream's time from a CUDA event before each
    collective to one after it, read after the step's outputs were (the
    events are done by then, so reading them waits for nothing).

    ``sync_batchnorm``: after the update, every replica's new running
    statistics become the masked mean over the replicas,
    ``sum(bs * m) / max(sum(m), 1)`` in one all-reduce (the JAX step's
    ``psum(a * m) / denom``, ``dp.py:227-230``); the forward's batch
    statistics stay local. An all-zero mask zeroes them (``0 / 1``), as
    in the JAX package.

    ``remat``: the forward runs under ``torch.utils.checkpoint`` and is
    recomputed in the backward (``jax.checkpoint(loss_fn)``, ``:195-197``).
    The recompute draws the same Dropout masks (the draws' generator is
    put back to its state before the forward) and leaves the BatchNorm
    running statistics as the first forward wrote them."""

    def __init__(self, model: torch.nn.Module, opt, *,
                 group: Optional[dist.ProcessGroup] = None, input_norm=None,
                 skip_nonfinite: bool = False, sync_batchnorm: bool = False,
                 remat: bool = False):
        self.model, self.opt = model, opt
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self.input_norm = input_norm
        self.skip_nonfinite = skip_nonfinite
        self.sync_batchnorm = sync_batchnorm
        self.remat = remat
        self.device = _device_of(model)
        # Collectives on the card's stream are timed by CUDA events.
        self._on_stream = (group is not None and self.device.type == "cuda"
                           and dist.get_backend(group) == "nccl")
        self._comm_host = 0.0
        self._comm_events: list = []
        self.dropout = DropoutDraws(model, self.device)
        self.params: Dict[str, torch.nn.Parameter] = dict(
            model.named_parameters())
        self.buffers = [b for _, b in model.named_buffers()]
        self.size = sum(p.numel() for p in self.params.values())
        self.opt_state = self._init_state()
        self.flat_grad = torch.zeros(self._grad_size(), dtype=torch.float32,
                                     device=self.device)
        self.grads, off = {}, 0
        for name, p in self.params.items():
            self.grads[name] = self.flat_grad[off:off + p.numel()].view_as(p)
            off += p.numel()

    def _init_state(self):
        return self.opt.init(self.params)

    def _grad_size(self) -> int:
        return self.size

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.remat:
            return self.model(x)
        gen = self.dropout.generator
        held = gen.get_state() if gen is not None else None

        def forward(x):
            # checkpoint restores only the default generators: the
            # recompute puts the Dropout draws' own generator back.
            if held is not None:
                gen.set_state(held)
            return self.model(x)

        return checkpoint(forward, x, use_reentrant=False)

    def _timed(self, collective, *args) -> None:
        """Run a collective over the group, its time into ``comm_s``."""
        if self._on_stream:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            collective(*args, group=self.group)
            end.record()
            self._comm_events.append((start, end))
            return
        t0 = time.monotonic()
        collective(*args, group=self.group)
        self._comm_host += time.monotonic() - t0

    @property
    def comm_s(self) -> float:
        """Seconds the last call spent in its collectives."""
        return self._comm_host + sum(
            start.elapsed_time(end) for start, end in self._comm_events) / 1e3

    def _all_reduce(self, t: torch.Tensor) -> None:
        if self.group is not None:          # even at world 1
            self._timed(dist.all_reduce, t)

    def __call__(self, x, y, mask,
                 key: Optional[int] = None) -> Dict[str, torch.Tensor]:
        mask = np.asarray(mask, np.float32)
        if mask.shape != (self.world,):
            raise ValueError(f"mask of shape {mask.shape} for {self.world} "
                             "replicas")
        m, msum = float(mask[self.rank]), float(mask.sum())
        denom = max(msum, 1.0)
        x = _input(x, self.device, self.input_norm)
        y = _tensor(y, self.device)
        self.model.train()
        self._comm_host, self._comm_events = 0.0, []
        self.flat_grad.zero_()
        for name, p in self.params.items():
            p.grad = self.grads[name]
        self.dropout.seed(key, self.rank)
        logits = self._forward(x)
        loss = F.cross_entropy(logits, y.long())
        if self.remat:
            # The recompute in the backward writes the running statistics
            # again: keep the first forward's.
            written = [b.clone() for b in self.buffers]
        loss.backward()
        if self.remat:
            with torch.no_grad():
                for b, w in zip(self.buffers, written):
                    b.copy_(w)
        for name, p in self.params.items():
            if p.grad is None or p.grad.data_ptr() != \
                    self.grads[name].data_ptr():
                raise RuntimeError(f"backward did not accumulate {name}'s "
                                   "gradient into the flat buffer")
        with torch.no_grad():
            acc = (logits.argmax(-1) == y).float().mean()
            stats = torch.stack([loss.detach(), acc]) * m
            self.flat_grad.mul_(m)
            self._all_reduce(stats)
            stats = stats / denom
            gnorm = self._reduce_and_update(m, msum, denom)
            if self.sync_batchnorm and self.buffers:
                self._sync_buffers(m, denom)
            return {
                "loss": stats[0], "accuracy": stats[1],
                "participating": torch.tensor(msum),
                "grad_norm": gnorm,
                "nonfinite": 1.0 - torch.isfinite(gnorm + stats[0]).float(),
            }

    def _stepped(self, msum: float, gnorm: torch.Tensor) -> bool:
        """An all-zero mask is a no-op (``:217-226``); ``skip_nonfinite``
        also skips a step whose gradient norm is not finite."""
        stepped = msum > 0
        if stepped and self.skip_nonfinite:
            stepped = bool(torch.isfinite(gnorm))
        return stepped

    def _reduce_and_update(self, m: float, msum: float,
                           denom: float) -> torch.Tensor:
        """The masked gradient (already times ``m``) -> its masked mean
        over the group -> the update; returns the global gradient norm."""
        self._all_reduce(self.flat_grad)
        self.flat_grad.div_(denom)
        # dot, not linalg.vector_norm: the CPU's f32 vector_norm over
        # millions of elements is off by ~1e-4 relative.
        gnorm = torch.dot(self.flat_grad, self.flat_grad).sqrt()
        if self._stepped(msum, gnorm):
            self.opt_state = self.opt.apply(self.params, self.opt_state,
                                            self.grads)
        return gnorm

    def _sync_buffers(self, m: float, denom: float) -> None:
        """The replicas' running statistics -> their masked mean."""
        flat = torch.cat([b.reshape(-1) for b in self.buffers]) * m
        self._all_reduce(flat)
        flat.div_(denom)
        for b, t in zip(self.buffers,
                        flat.split([b.numel() for b in self.buffers])):
            b.copy_(t.view_as(b))


def make_train_step(model: torch.nn.Module, opt, *,
                    group: Optional[dist.ProcessGroup] = None,
                    input_norm=None, skip_nonfinite: bool = False,
                    sync_batchnorm: bool = False, remat: bool = False,
                    shard_update: bool = False) -> TrainStep:
    """Build the step. ``opt.init`` runs here (FusedSGD lays the
    parameters out in its flat buffer); the step keeps the optimizer state
    as ``step.opt_state``. ``shard_update`` builds the ZeRO-1 step
    (``parallel/zero.py``): the same arguments, the update sharded over
    the group."""
    kind = TrainStep
    if shard_update:
        from ps_pytorch_tpu_torch.parallel.zero import ZeroTrainStep
        kind = ZeroTrainStep
    return kind(model, opt, group=group, input_norm=input_norm,
                skip_nonfinite=skip_nonfinite,
                sync_batchnorm=sync_batchnorm, remat=remat)


def make_eval_step(model: torch.nn.Module, input_norm=None) -> Callable:
    """(x, y) -> dict(sum_loss, top1, top5, count), the model in eval mode
    (running statistics)."""
    device = _device_of(model)

    @torch.no_grad()
    def eval_step(x, y):
        model.eval()
        logits = model(_input(x, device, input_norm))
        y = torch.as_tensor(np.asarray(y)).to(device).long()
        loss = F.cross_entropy(logits, y, reduction="sum")
        k = min(5, logits.shape[-1])
        top5 = (logits.topk(k, -1).indices == y[:, None]).any(-1).sum()
        return {"sum_loss": loss, "top1": (logits.argmax(-1) == y).sum(),
                "top5": top5, "count": y.shape[0]}

    return eval_step


def accumulate_eval(eval_fn: Callable, batches: Iterable,
                    max_batches: Optional[int] = None) -> dict:
    """Run ``eval_fn(x, y)`` over ``batches`` (the first ``max_batches``)
    -> loss, prec1, prec5 and count over all examples."""
    tot = {"sum_loss": 0.0, "top1": 0, "top5": 0, "count": 0}
    for i, (x, y) in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        m = eval_fn(x, y)
        tot["sum_loss"] += float(m["sum_loss"])
        for k in ("top1", "top5", "count"):
            tot[k] += int(m[k])
    n = max(tot["count"], 1)
    return {"loss": tot["sum_loss"] / n, "prec1": tot["top1"] / n,
            "prec5": tot["top5"] / n, "count": tot["count"]}
