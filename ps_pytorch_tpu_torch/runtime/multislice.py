"""Multi-slice asynchronous (stale-gradient) training: the JAX package's
``runtime/multislice.py``.

Asynchrony lives BETWEEN slices: each slice computes a gradient against the
parameter version it last fetched (possibly stale), ships it to the
aggregator tagged with that version's step (``parallel/async_dp.py``), and
the canonical parameters advance from whatever fresh-enough contributions
exist: parameter-server semantics with the "master" reduced to an optimizer
over a gradient pool.

Slices and their devices. The JAX trainer splits its devices into
``n_slices`` groups of ``per``; so does this one: ``devices`` (every slice
on the one selected device when not given) holds ``n_slices * per``
devices, and slice ``s`` holds one replica of the model on each of
``devices[s * per:(s + 1) * per]`` (several may name one card). A slice's
batch is split into ``per`` contiguous row blocks, one a replica (the
JAX ``P("data")``); each replica keeps its own BatchNorm statistics (the
JAX ``[per, ...]`` stack); the gradients, loss and accuracy are averaged
over the replicas (the JAX ``psum / n``) and the slice submits that one
gradient. A slice has its own last-fetched parameters and its own shard
of the data (``host_id=s`` of ``n_slices`` over a shared-seed shuffle).
"Fetch" is a copy from the canonical parameters into every replica. The
canonical parameters and the optimizer state stay on the device for the
whole run; with ``--fused-optimizer`` they live in the fused optimizer's
flat buffer. A gradient visits the host only when a host codec is
configured (blosc, int8lat, topk, randk); the ``int8`` codec quantizes,
dequantizes and averages on the device.

Scheduling model (deterministic, testable): slice i advances every
``slice_periods[i]`` global ticks and re-fetches canonical params every
``fetch_every`` of its own steps, so a slow slice submits gradients
computed on stale weights and exercises the drop/decay paths without
wall-clock nondeterminism.

As in the reference, a resumed run restores the canonical parameters, the
optimizer state and slice 0's BatchNorm statistics (a replica's each);
the loaders start over and the other slices keep fresh statistics.
``evaluate()`` reads slice 0's first replica's statistics, and the
checkpoint's ``batch_stats`` carry slice 0's ``[per, ...]`` stack, as the
JAX trainer's do.

``--shard-wire`` (``parallel/zero_wire.py``) puts the sharded host-side
update in place of the optimizer, as the JAX trainer does in one process:
a single owner of ``max(n_slices, 2)`` shards over an in-memory
``KVStore``, on the JAX-layout tree (the pooled average is laid out so
before the update and back after it); the checkpoint carries its state as
``extra_state["zero"]``. This trainer builds no integrity screen, as in
the JAX package.

``--sync-topology hier`` puts ``parallel/hierarchy.py``'s
``HierarchicalAggregator`` in place of the pool: members route to group
aggregators that re-encode once a hop, the root pools the group
aggregates. Its error feedback (the members' with ``--ef``, the hops'
always) rides every checkpoint as ``extra_state["ef"]``, in the JAX
layouts.
"""

import copy
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ps_pytorch_tpu_torch.config import TrainConfig
from ps_pytorch_tpu_torch.data.augment import input_norm_for
from ps_pytorch_tpu_torch.data.datasets import DataLoader, load_arrays
from ps_pytorch_tpu_torch.models import build_model
from ps_pytorch_tpu_torch.models.convert import (
    from_jax, jax_path, leaf_layout, nest, state_from_jax, state_to_jax,
)
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel.async_dp import (
    StaleGradientAggregator, tree_flatten,
)
from ps_pytorch_tpu_torch.parallel.dp import (
    DropoutDraws, _input, accumulate_eval, make_eval_step,
)
from ps_pytorch_tpu_torch.parallel.hierarchy import HierarchicalAggregator
from ps_pytorch_tpu_torch.parallel.zero_wire import updater_from_config
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.coordinator import KVStore
from ps_pytorch_tpu_torch.runtime.metrics import MetricsLogger
from ps_pytorch_tpu_torch.runtime.trainer import (
    resolve_device, set_reference_numerics,
)


def make_slice_grad_fn(models, input_norm=None, index: int = 0) -> Callable:
    """``fn(x, y, key=None) -> (grads, metrics)`` of slice ``index`` over
    its replicas ``models`` (one a device, or a single model): the batch
    split into ``len(models)`` contiguous row blocks, each replica's
    forward and backward on its block in train mode (its BatchNorm
    statistics move; its Dropout draws seeded from the tick's ``key`` and
    its place ``index * len(models) + r``, as ``parallel/dp.py`` seeds a
    replica's); ``grads`` a fresh ``name -> tensor`` dict, ``metrics`` the
    0-d loss and accuracy, each the mean over the replicas, on the first
    replica's device."""
    if isinstance(models, torch.nn.Module):
        models = [models]
    per = len(models)
    replicas = []
    for r, model in enumerate(models):
        params = dict(model.named_parameters())
        device = next(iter(params.values())).device
        replicas.append((model, params, device, DropoutDraws(model, device),
                         index * per + r))

    def one(replica, x, y, key):
        model, params, device, dropout, place = replica
        x = _input(x, device, input_norm)
        y = torch.as_tensor(np.asarray(y)).to(device, non_blocking=True)
        model.train()
        for p in params.values():
            p.grad = None
        dropout.seed(key, place)
        logits = model(x)
        loss = F.cross_entropy(logits, y.long())
        loss.backward()
        with torch.no_grad():
            acc = (logits.argmax(-1) == y).float().mean()
        grads = {name: p.grad for name, p in params.items()}
        for p in params.values():
            p.grad = None
        return grads, {"loss": loss.detach(), "accuracy": acc}

    def grad_fn(x, y, key=None):
        if per == 1:
            return one(replicas[0], x, y, key)
        rows = len(x) // per
        outs = [one(rep, x[r * rows:(r + 1) * rows],
                    y[r * rows:(r + 1) * rows], key)
                for r, rep in enumerate(replicas)]
        device = replicas[0][2]
        with torch.no_grad():
            grads = {name: sum(g[name].to(device) for g, _ in outs) / per
                     for name in outs[0][0]}
            metrics = {k: sum(m[k].to(device) for _, m in outs) / per
                       for k in ("loss", "accuracy")}
        return grads, metrics

    return grad_fn


class MultiSliceTrainer:
    """PS-style asynchronous training over ``n_slices`` slices."""

    def __init__(self, cfg: TrainConfig, n_slices: int = 2,
                 slice_periods: Optional[Sequence[int]] = None,
                 fetch_every: int = 1, devices: Optional[List] = None,
                 device: Optional[str] = None, printer=print,
                 noise_fn: Optional[Callable] = None):
        set_reference_numerics()
        self.device = resolve_device(device)
        if devices is None:
            devices = [self.device] * n_slices
        devices = [torch.device(d) for d in devices]
        if len(devices) % n_slices:
            raise ValueError(f"{len(devices)} devices not divisible by "
                             f"{n_slices} slices")
        self.per = per = len(devices) // n_slices
        if cfg.batch_size % per:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible "
                             f"by the {per} devices of a slice")
        self.cfg = cfg
        self.n_slices = n_slices
        self.slice_periods = list(slice_periods or [1] * n_slices)
        if len(self.slice_periods) != n_slices:
            raise ValueError("need one period per slice")
        self.fetch_every = max(fetch_every, 1)

        # Canonical parameters and optimizer state: on the device for the
        # whole run. Its BatchNorm buffers only carry slice 0's statistics
        # into evaluate().
        self.model = build_model(cfg.network, cfg.num_classes,
                                 cfg.compute_dtype, cfg.conv_impl,
                                 seed=cfg.seed).to(self.device)
        # Each slice's replicas, one a device: copies of the canonical
        # model, made before the fused optimizer takes its parameters
        # into its flat buffer.
        self.replicas = [[copy.deepcopy(self.model).to(dev)
                          for dev in devices[s * per:(s + 1) * per]]
                         for s in range(n_slices)]
        self.opt = build_optimizer(cfg)
        self.params: Dict[str, torch.nn.Parameter] = dict(
            self.model.named_parameters())
        self.opt_state = self.opt.init(self.params)

        if cfg.sync_topology == "hier":
            # Two tiers behind the same surface (parallel/hierarchy.py):
            # submit, collect, consume, GC and EF keep their meaning, so
            # tick() does not know the topology. num_aggregate counts
            # groups there, clamped to their number.
            self.aggregator = HierarchicalAggregator(
                n_slices, group_size=cfg.sync_group_size,
                staleness_limit=cfg.staleness_limit,
                staleness_decay=cfg.staleness_decay,
                num_aggregate=cfg.num_aggregate, codec=cfg.grad_codec,
                topk_frac=cfg.grad_topk_frac, error_feedback=cfg.ef,
                ef_clip=cfg.ef_clip, intra_every=cfg.sync_intra_every,
                inter_every=cfg.sync_inter_every)
        else:
            self.aggregator = StaleGradientAggregator(
                n_slices, staleness_limit=cfg.staleness_limit,
                staleness_decay=cfg.staleness_decay,
                num_aggregate=cfg.num_aggregate, compress=cfg.compress_grad,
                codec=cfg.grad_codec, codec_level=cfg.codec_level,
                wire_bucket_bytes=int(cfg.wire_bucket_mb * (1 << 20)),
                wire_workers=cfg.wire_workers, topk_frac=cfg.grad_topk_frac,
                error_feedback=cfg.ef, ef_clip=cfg.ef_clip,
                noise_fn=noise_fn)
        if cfg.shard_wire:
            # The same pool, decision for decision; the canonical update
            # becomes the sharded host-side one, published a shard a key
            # and assembled back. One owner, as in the JAX trainer.
            self.aggregator = updater_from_config(
                cfg, inner=self.aggregator, kv=KVStore(),
                run_id=f"zw-{cfg.seed}", params=self._wire_tree(self.params),
                members=[0], me=0, n_shards=max(n_slices, 2))
        self._input_norm = input_norm_for(cfg)
        self.grad_fns = [make_slice_grad_fn(reps, self._input_norm, s)
                         for s, reps in enumerate(self.replicas)]
        self.eval_fn = make_eval_step(self.model, self._input_norm)
        # Each slice's last-fetched version step and its own step count.
        self._slice_version = [0] * n_slices
        self._slice_steps = [0] * n_slices

        # Disjoint-by-construction per-slice data: slice s is "host" s of
        # n_slices over a shared-seed shuffle, and still draws
        # cfg.batch_size per step (hence the n_slices-scaled loader batch).
        dev_norm = self._input_norm is not None
        xtr, ytr = load_arrays(cfg.dataset, cfg.data_dir, train=True,
                               seed=cfg.seed)
        self.train_loaders = [
            DataLoader(xtr, ytr, cfg.batch_size * n_slices, cfg.dataset,
                       train=True, seed=cfg.seed, host_id=s,
                       num_hosts=n_slices, device_normalize=dev_norm)
            for s in range(n_slices)]
        xte, yte = load_arrays(cfg.dataset, cfg.data_dir, train=False,
                               seed=cfg.seed)
        self.test_loader = DataLoader(xte, yte, cfg.test_batch_size,
                                      cfg.dataset, train=False, shuffle=False,
                                      seed=cfg.seed, drop_last=False,
                                      device_normalize=dev_norm)
        self.metrics = MetricsLogger(cfg.metrics_file, cfg.log_every,
                                     printer=printer)
        self.step = 0          # canonical (master) step
        self.applied = 0       # updates actually applied
        self.dropped_stale = 0

    @torch.no_grad()
    def _fetch(self, s: int) -> None:
        """Slice ``s``'s replicas take the canonical parameters (not the
        BatchNorm statistics, which stay their own): the weight-distribution
        hop."""
        for model in self.replicas[s]:
            own = dict(model.named_parameters())
            for name, p in self.params.items():
                own[name].copy_(p)

    def tick(self) -> dict:
        """One global tick: scheduled slices compute and submit; the
        canonical params advance from the pool. Returns tick metrics."""
        self.step += 1
        info = {"computed": [], "loss": None, "acc": None}
        losses, accs = [], []
        for s in range(self.n_slices):
            if (self.step - 1) % self.slice_periods[s]:
                continue
            if self._slice_steps[s] % self.fetch_every == 0:
                self._fetch(s)
                self._slice_version[s] = self.step - 1
            self._slice_steps[s] += 1
            x, y = self.train_loaders[s].next_batch()
            grads, m = self.grad_fns[s](
                x, y, key=self.cfg.seed * 100003 + self.step)
            self.aggregator.submit(s, self._slice_version[s], grads)
            info["computed"].append(s)
            losses.append(float(m["loss"]))
            accs.append(float(m["accuracy"]))
        if losses:
            info["loss"] = sum(losses) / len(losses)
            info["acc"] = sum(accs) / len(accs)
        avg, pool = self.aggregator.collect(self.step - 1)
        if avg is not None and pool["used"]:
            # The pooled average lies where the first fresh contributor's
            # gradient lay (or on the host, after a host codec).
            grads = {name: torch.as_tensor(g).to(self.device)
                     for name, g in avg.items()}
            if self.cfg.shard_wire:
                self._load_wire_tree(self.aggregator.update_from(
                    self._wire_tree(grads), version=self.step))
            else:
                with torch.no_grad():
                    self.opt_state = self.opt.apply(self.params,
                                                    self.opt_state, grads)
            self.applied += 1
            self.aggregator.consume(pool["used"])
        # GC every tick (collect only reports; unremoved entries would be
        # counted again next tick and retain dead gradients).
        self.dropped_stale += self.aggregator.drop_older_than(self.step - 1)
        info["used"] = pool["used"]
        return info

    def _wire_tree(self, tensors: Dict[str, torch.Tensor]) -> dict:
        """Parameter-shaped tensors as the JAX-layout flax tree, the tree
        the sharded updater runs on."""
        names = sorted(self.params)
        return nest([jax_path(n, self.params[n].dim()) for n in names],
                    [leaf_layout(n, tensors[n].detach(), True)
                     for n in names])

    @torch.no_grad()
    def _load_wire_tree(self, tree: dict) -> None:
        """A JAX-layout tree (numpy) into the canonical parameters."""
        for name, a in zip(sorted(self.params), tree_flatten(tree)[0]):
            self.params[name].copy_(leaf_layout(
                name, torch.as_tensor(np.ascontiguousarray(a)), False))

    @torch.no_grad()
    def _take_slice0_stats(self) -> None:
        """Slice 0's first replica's BatchNorm statistics into the
        canonical model, which evaluate() reads (the JAX ``_bs[0][0]``)."""
        own = dict(self.model.named_buffers())
        for name, b in self.replicas[0][0].named_buffers():
            own[name].copy_(b)

    def _load_stats(self, s: int, stats: Optional[dict]) -> None:
        """A JAX batch_stats tree into slice ``s``'s replicas: replica r
        takes entry r of a ``[per, ...]`` stack (entry 0 when the stack
        is shorter), or the tree as it is without one."""
        for r, model in enumerate(self.replicas[s]):
            model.load_state_dict(from_jax({}, stats, replica=r),
                                  strict=False)

    def evaluate(self, max_batches: Optional[int] = None) -> dict:
        """Top-1/top-5/loss on the canonical params with slice 0's
        BatchNorm statistics."""
        self._take_slice0_stats()
        return accumulate_eval(self.eval_fn, self.test_loader.epoch(0),
                               max_batches)

    # ---- state across the two packages ----
    def load_jax(self, tree: dict,
                 slice_batch_stats: Optional[Sequence[dict]] = None) -> None:
        """A JAX ``MultiSliceTrainer``'s state into this one: ``tree`` is
        its ``TrainState`` as the dict flax serializes (canonical params,
        optimizer state, slice 0's statistics), ``slice_batch_stats`` the
        per-slice BatchNorm statistics (``_bs``, numpy, each with its
        ``[per, ...]`` axis). Every slice takes the canonical parameters
        and each replica its own statistics."""
        self._restore(tree)
        self.step = int(tree["step"])
        stats = slice_batch_stats or [tree.get("batch_stats")] * self.n_slices
        for s in range(self.n_slices):
            self._fetch(s)
            self._load_stats(s, stats[s])

    def _ef_layout(self, state: dict, to_jax: bool) -> dict:
        """The aggregator's EF state between the port's parameter layouts
        and the JAX package's. Flat: slice -> leaf index -> residual;
        under hier, ``{"members": {slice: {i: r}}, "g<gid>": {i: r}}``,
        the members' and each group hop's residuals, both over the
        gradient's leaves. Leaf i is the i-th parameter by sorted name in
        both packages."""
        names = sorted(self.params)

        def leaves(d):
            return {i: leaf_layout(names[int(i)], np.asarray(r), to_jax)
                    for i, r in d.items()}

        def slices(d):
            return {sid: leaves(v) for sid, v in d.items()}

        if "members" in state or any(k.startswith("g") for k in state):
            return {k: slices(v) if k == "members" else leaves(v)
                    for k, v in state.items()}
        return slices(state)

    # ---- checkpoint/resume (same contract and format as the Trainer) ----
    def _checkpoint(self) -> str:
        # EF residuals are sender state: without them a resumed lossy-codec
        # run re-sends error the accumulator had already banked. They are
        # stored in the JAX package's layouts, under hier always (its hop
        # EF is on without --ef), as the JAX trainer does.
        extra = {"ef": self._ef_layout(self.aggregator.ef_state_dict(),
                                       to_jax=True)} \
            if (self.cfg.ef or self.cfg.sync_topology == "hier") else None
        if self.cfg.shard_wire:
            # The sharded optimizer state (each shard's fields and the
            # step): without it a resumed run restarts the moments.
            extra = dict(extra or {})
            extra["zero"] = self.aggregator.state_dict()
        return ckpt.save_checkpoint(
            self.cfg.train_dir, self.step,
            state_to_jax(self.model, self.opt_state, self.step,
                         replica_buffers=[dict(m.named_buffers())
                                          for m in self.replicas[0]]),
            config_json=self.cfg.to_json(), compress=self.cfg.compress_grad,
            codec_level=self.cfg.codec_level, extra_state=extra)

    def _restore(self, tree: dict) -> None:
        self.opt_state, _ = state_from_jax(tree, self.model, self.opt_state)
        self._restored_stats = tree.get("batch_stats")

    def maybe_resume(self) -> bool:
        """Restore canonical params and optimizer state (and slice 0's
        BatchNorm statistics, a replica's each; other slices keep fresh
        ones), from the
        newest checkpoint that verifies: a corrupt newest one is skipped."""
        if ckpt.latest_step(self.cfg.train_dir) is None:
            return False
        got = ckpt.load_latest_valid(self.cfg.train_dir, self._restore)
        if got is None:
            return False
        _, meta, _, step = got
        self._load_stats(0, self._restored_stats)
        self.step = int(meta["step"])
        for s in range(self.n_slices):
            self._fetch(s)
        self._slice_version = [self.step] * self.n_slices
        extra = ckpt.load_extra_state(self.cfg.train_dir, step)
        if extra and "ef" in extra:
            self.aggregator.load_ef_state(
                self._ef_layout(extra["ef"], to_jax=False))
        if self.cfg.shard_wire and extra and "zero" in extra:
            # Re-anchor the owned shards on the restored parameters, then
            # restore the sharded moments and step.
            self.aggregator.load_state_dict(
                extra["zero"], params=self._wire_tree(self.params))
        print(f"RESUME from {ckpt.checkpoint_path(self.cfg.train_dir, step)} "
              f"at step {self.step}")
        return True

    def train(self, max_steps: Optional[int] = None):
        cfg = self.cfg
        if cfg.resume:
            self.maybe_resume()
        last = max_steps or cfg.max_steps
        try:
            while self.step < last:
                t0 = time.monotonic()
                info = self.tick()
                t_step = time.monotonic() - t0
                if info["loss"] is not None \
                        and self.step % cfg.log_every == 0:
                    self.metrics.log_step(
                        self.step, 0, loss=info["loss"], acc=info["acc"],
                        participating=float(len(info["used"])),
                        step_time=t_step, data_time=0.0,
                        applied=self.applied,
                        dropped_stale=self.dropped_stale,
                        pool_wire_bytes=self.aggregator.wire_bytes())
                if cfg.eval_freq > 0 and self.step % cfg.eval_freq == 0:
                    self._checkpoint()
            if cfg.eval_freq > 0 and self.step % cfg.eval_freq != 0:
                self._checkpoint()
        finally:
            self.metrics.close()
        return self.params
