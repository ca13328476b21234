"""ZeRO over the wire: the JAX package's ``parallel/zero_wire.py``, the
weight update sharded across replicas on the KV plane (``--shard-wire``).

- Each replica owns a contiguous run of the flat-leaf space, its shard
  boundaries snapped to ``parallel/buckets.py`` bucket edges
  (``plan_wire_shards``), so the wire unit and the shard unit agree.
- Gradients pool exactly as before: ``ZeroWireUpdater`` hands submit,
  collect, K-of-N, staleness, the integrity screen and the codecs
  untouched to an inner ``parallel/async_dp.StaleGradientAggregator``, so
  contributor selection is the replicated path's, decision for decision.
- The optimizer runs per shard, on the host: a replica applies the
  reference SGD or Adam recurrence (numpy float32, the JAX package's
  operations in its order, ``_HostSGD`` / ``_HostAdam``) to the leaves it
  owns only, holds optimizer state for those leaves only (~1/N of it a
  replica), and publishes the updated parameters a shard a KV key.
- Readers assemble the full tree from the newest consistent set of shard
  versions, on a worker pool, so shard k decodes while shard k+1 syncs.

Elementwise updates on disjoint leaf runs are the same floating-point
operations as on the whole tree, so the sharded run equals the replicated
one (the same machinery at ``n_shards=1``) bitwise at every shard count,
with codecs on or off, and across handoff/adopt resharding. It is not the
fused kernel's update: that is what keeps sharded == replicated == the JAX
package bitwise.

Trees and bytes. A tree is a dict (nested or flat) of leaves, flattened
with sorted keys (``async_dp.tree_flatten``, the order ``jax.tree.flatten``
gives), each leaf numpy or a tensor in the JAX layout (flax paths sorted,
conv kernels HWIO, dense kernels [in,out]): the trainers hand the wire
tree, not the port's parameters. The keys (``{run}/zw/{epoch}/p/{k}/{round}``,
``{run}/zw/ver``), the pointer's JSON and the armoured shard bytes
(``utils/armor.py``) are the JAX package's byte for byte, so either
package assembles the other's publish, and the ``state_dict()`` a
checkpoint carries as ``extra_state["zero"]`` resumes in either.

This module also owns the elastic flat-array primitive,
``ShardedKVUpdate`` (with ``plan_shards`` / ``reslice``), which
``elastic/rebalance.py`` re-exports.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import (
    Any, Callable, Dict, List, Optional, Sequence, Tuple,
)

import numpy as np

from ps_pytorch_tpu_torch.parallel.async_dp import (
    tree_flatten, tree_unflatten,
)
from ps_pytorch_tpu_torch.parallel.buckets import (
    Bucket, leaf_nbytes, plan_buckets,
)
from ps_pytorch_tpu_torch.telemetry.trace import span as _span
from ps_pytorch_tpu_torch.utils.armor import b85decode, b85encode

__all__ = [
    "ShardPlan", "plan_shards", "reslice", "ShardedKVUpdate",
    "plan_wire_shards", "encode_array", "decode_array", "ZeroWireUpdater",
    "updater_from_config",
]


# ---------------------------------------------------------------------------
# Armored shard codec — the one encode/decode every ZeRO-over-KV path uses.
# ---------------------------------------------------------------------------

def _host_f32(leaf: Any) -> np.ndarray:
    """A leaf (numpy, a scalar or a tensor on any device) as host float32."""
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf, np.float32)


def encode_array(a: np.ndarray) -> str:
    """Array bytes -> armored base85 text (vectorized, bit-pinned to the
    stdlib alphabet; utils/armor.py). Lossless: raw little-endian bytes,
    no text round-trip of the values."""
    return b85encode(np.ascontiguousarray(a).tobytes()).decode("ascii")


def decode_array(s: str, dtype) -> np.ndarray:
    """Inverse of :func:`encode_array` (flat array; caller reshapes)."""
    return np.frombuffer(b85decode(s), dtype=dtype).copy()


# ---------------------------------------------------------------------------
# Flat-vector shard plans (the JAX package's zero.py chunking made
# explicit), shared by the elastic path and the wire path;
# elastic/rebalance.py re-exports these names.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardPlan:
    """Contiguous equal-chunk partition of a flat vector of ``size``
    elements over ``n`` shards (zero.py's scheme, made explicit)."""
    size: int
    n: int
    chunk: int
    bounds: Tuple[Tuple[int, int], ...]  # [start, stop) in UNPADDED coords

    @property
    def padded(self) -> int:
        return self.chunk * self.n

    def shard_of(self, index: int) -> Tuple[int, int]:
        return self.bounds[index]


def plan_shards(size: int, n: int) -> ShardPlan:
    """chunk = ceil(size/n); shard k owns [k*chunk, min((k+1)*chunk, size)).
    Trailing shards may be empty when n is large — valid, they just carry
    no state (zero.py's padding slots)."""
    if size <= 0 or n <= 0:
        raise ValueError(f"plan_shards needs size>0, n>0 (got {size}, {n})")
    chunk = -(-size // n)
    bounds = tuple((min(k * chunk, size), min((k + 1) * chunk, size))
                   for k in range(n))
    return ShardPlan(size=size, n=n, chunk=chunk, bounds=bounds)


def reslice(old_plan: ShardPlan, new_plan: ShardPlan,
            shards: List[np.ndarray]) -> List[np.ndarray]:
    """Re-cut ``shards`` (one array per old shard, unpadded lengths) at the
    new plan's bounds. Concatenation + slicing only: the values are moved,
    never recomputed, so the full vector is invariant bit-for-bit."""
    if old_plan.size != new_plan.size:
        raise ValueError(f"plans disagree on size: {old_plan.size} vs "
                         f"{new_plan.size}")
    full = np.concatenate([np.asarray(s) for s in shards]) if shards \
        else np.zeros(0)
    if full.size != old_plan.size:
        raise ValueError(f"shards hold {full.size} elements, plan says "
                         f"{old_plan.size}")
    return [full[lo:hi] for lo, hi in new_plan.bounds]


# ---------------------------------------------------------------------------
# Leaf-space shard plan for the wire updater: contiguous runs of flat-order
# LEAVES whose boundaries coincide with bucket edges. Leaves are never
# split, so every shard round-trips through the same per-leaf codecs and
# checkpoints as the full tree.
# ---------------------------------------------------------------------------

def plan_wire_shards(leaves: Sequence[Any], n_shards: int,
                     bucket_bytes: int = 0) -> List[Tuple[int, int]]:
    """Partition ``leaves`` (flat order) into ``n_shards`` contiguous runs,
    byte-balanced, with every boundary snapped to a
    :func:`~ps_pytorch_tpu_torch.parallel.buckets.plan_buckets` bucket
    edge.

    Deterministic in (leaves, n_shards, bucket_bytes). Shard k's boundary
    is the first bucket edge at or past ``total_bytes * k / n_shards``;
    trailing shards may be empty when n_shards exceeds the bucket count
    (plan_shards' padding-slot semantics). ``bucket_bytes <= 0`` makes
    every leaf its own bucket edge (pure byte balancing)."""
    if n_shards <= 0:
        raise ValueError(f"plan_wire_shards needs n_shards>0 (got {n_shards})")
    leaves = list(leaves)
    if not leaves:
        return [(0, 0)] * n_shards
    buckets = plan_buckets(leaves, bucket_bytes) if bucket_bytes > 0 else []
    if len(buckets) < n_shards:
        # Too few bucket edges to cut n_shards non-empty runs (small model
        # or huge bucket target): fall back to leaf-granular edges — every
        # leaf boundary is trivially also a bucket edge of SOME finer
        # bucketing, and byte balance beats degenerate empty shards.
        buckets = [Bucket(i, i, i + 1, leaf_nbytes(l))
                   for i, l in enumerate(leaves)]
    cum = np.cumsum([b.nbytes for b in buckets], dtype=np.int64)
    total = int(cum[-1])
    edges = [0]
    for k in range(1, n_shards):
        j = int(np.searchsorted(cum, total * k / n_shards))
        edge = buckets[j].start if j < len(buckets) else buckets[-1].stop
        edges.append(max(edge, edges[-1]))
    edges.append(buckets[-1].stop)
    return [(edges[k], edges[k + 1]) for k in range(n_shards)]


# ---------------------------------------------------------------------------
# Reference-exact host-side optimizers. float32 elementwise: the JAX
# package's host recurrences, the SAME numpy operations in the SAME order
# (its optim/sgd.py and optim/adam.py arithmetic). Sharding only changes
# WHICH elements a replica touches, never the arithmetic, so sharded ==
# replicated bit-for-bit by construction. numpy, not torch: Adam's
# per-round scalar is float32 ``**`` in numpy, and SGD multiplies by
# ``-lr`` and never divides; a torch copy would change bits.
# ---------------------------------------------------------------------------

class _HostSGD:
    """optim/sgd.py's recurrence on numpy float32:
        d = g + wd*p
        step 0:  buf = d
        step>0:  buf = mu*buf + (1-damp)*d
        nesterov: d = d + mu*buf ; else d = buf
        p <- p + (-lr)*d
    """

    def __init__(self, lr: float, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and "
                             "zero dampening")
        self.neg_lr = np.float32(-lr)
        self.mu = np.float32(momentum)
        self.damp1 = np.float32(1.0 - dampening)
        self.wd = np.float32(weight_decay)
        self.has_momentum = momentum != 0
        self.has_wd = weight_decay != 0
        self.nesterov = bool(nesterov)
        self.fields = ("buf",) if self.has_momentum else ()

    def init_leaf(self, p: np.ndarray) -> Dict[str, np.ndarray]:
        return {"buf": np.zeros_like(p)} if self.has_momentum else {}

    def round_scalar(self, step: int):
        return None

    def update_leaf(self, p: np.ndarray, g: np.ndarray,
                    st: Dict[str, np.ndarray], step: int,
                    scalar=None) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        d = g + self.wd * p if self.has_wd else g
        if self.has_momentum:
            buf = d.copy() if step == 0 else self.mu * st["buf"] + self.damp1 * d
            used = d + self.mu * buf if self.nesterov else buf
            return p + self.neg_lr * used, {"buf": buf}
        return p + self.neg_lr * d, {}


class _HostAdam:
    """optim/adam.py's recurrence on numpy float32 (eps OUTSIDE the sqrt,
    torch-style; bias correction folded into a per-round float32 scalar
    shared by every shard):
        t = step+1 ; g += wd*p
        m = b1*m + (1-b1)*g ; v = b2*v + (1-b2)*g*g
        vhat = max(vhat, v) if amsgrad
        p <- p + (-step_size)*m / (sqrt(v_) + eps)
    """

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 amsgrad: bool = False):
        self.lr = np.float32(lr)
        self.b1 = np.float32(b1)
        self.b2 = np.float32(b2)
        self.b1c = np.float32(1.0 - b1)
        self.b2c = np.float32(1.0 - b2)
        self.eps = np.float32(eps)
        self.wd = np.float32(weight_decay)
        self.has_wd = weight_decay != 0
        self.amsgrad = bool(amsgrad)
        self.fields = ("m", "v", "vhat") if amsgrad else ("m", "v")

    def init_leaf(self, p: np.ndarray) -> Dict[str, np.ndarray]:
        st = {"m": np.zeros_like(p), "v": np.zeros_like(p)}
        if self.amsgrad:
            st["vhat"] = np.zeros_like(p)
        return st

    def round_scalar(self, step: int) -> np.float32:
        tf = np.float32(step + 1)
        return self.lr * np.sqrt(np.float32(1) - self.b2 ** tf) \
            / (np.float32(1) - self.b1 ** tf)

    def update_leaf(self, p: np.ndarray, g: np.ndarray,
                    st: Dict[str, np.ndarray], step: int,
                    scalar: np.float32 = None
                    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        if self.has_wd:
            g = g + self.wd * p
        m = self.b1 * st["m"] + self.b1c * g
        v = self.b2 * st["v"] + self.b2c * g * g
        out = {"m": m, "v": v}
        if self.amsgrad:
            vhat = np.maximum(st["vhat"], v)
            out["vhat"] = vhat
            denom_src = vhat
        else:
            denom_src = v
        ss = scalar if scalar is not None else self.round_scalar(step)
        return p + (-ss) * m / (np.sqrt(denom_src) + self.eps), out


def updater_from_config(cfg, inner, kv, run_id: str, params,
                        members: Sequence[int] = (0,),
                        me: Optional[int] = 0,
                        n_shards: int = 0) -> "ZeroWireUpdater":
    """Build the --shard-wire updater from a TrainConfig (the one place
    cfg -> host-optimizer kwargs is mapped, so both trainers agree)."""
    return ZeroWireUpdater(
        inner=inner, kv=kv, run_id=run_id, params=params,
        optimizer=cfg.optimizer, members=members, me=me, n_shards=n_shards,
        bucket_bytes=int(cfg.wire_bucket_mb * (1 << 20)),
        workers=cfg.wire_workers,
        lr=cfg.lr, momentum=cfg.momentum, nesterov=cfg.nesterov,
        weight_decay=cfg.weight_decay, adam_beta1=cfg.adam_beta1,
        adam_beta2=cfg.adam_beta2, adam_eps=cfg.adam_eps,
        amsgrad=getattr(cfg, "amsgrad", False))


def _make_host_optimizer(optimizer: str, **kw):
    if optimizer == "sgd":
        return _HostSGD(kw["lr"], momentum=kw.get("momentum", 0.0),
                        dampening=kw.get("dampening", 0.0),
                        weight_decay=kw.get("weight_decay", 0.0),
                        nesterov=kw.get("nesterov", False))
    if optimizer == "adam":
        return _HostAdam(kw["lr"], b1=kw.get("adam_beta1", 0.9),
                         b2=kw.get("adam_beta2", 0.999),
                         eps=kw.get("adam_eps", 1e-8),
                         weight_decay=kw.get("weight_decay", 0.0),
                         amsgrad=kw.get("amsgrad", False))
    raise ValueError(f"shard-wire host optimizer: unknown {optimizer!r} "
                     "(sgd | adam)")


# ---------------------------------------------------------------------------
# The tentpole: sharded-update aggregator with the StaleGradientAggregator
# surface.
# ---------------------------------------------------------------------------

class ZeroWireUpdater:
    """Drop-in aggregator (``--shard-wire``) that replaces the whole-tree
    optimizer (the fused kernel or the plain update on the device) with a
    sharded host-side update over the KV.

    Pool surface (submit / submit_encoded / collect / consume /
    drop_older_than / pending / wire_bytes / ef_state_dict / load_ef_state)
    delegates UNCHANGED to ``inner`` — contributor selection (staleness,
    K-of-N, integrity screening, homomorphic collect) is decision-identical
    to the replicated path. What changes is what happens to the collected
    average: :meth:`update_from` applies the reference-exact host optimizer
    to the shards this replica owns, publishes each updated shard under its
    own KV key (pipelined: shard k encodes/puts on the worker pool while
    shard k+1 is still updating), and assembles the full tree from the
    newest round (shard k decodes while shard k+1 still syncs).

    Ownership: ``n_shards`` bucket-edge-snapped leaf runs are distributed
    over ``members`` with the SAME contiguous plan machinery the elastic
    rebalancer uses (:func:`plan_shards` over shard indices), so
    :meth:`handoff` / :meth:`adopt` reshard on membership change exactly
    like :class:`ShardedKVUpdate` — epoch-bumped, values moved (armored
    bytes), never recomputed. ``me=None`` is reader mode (owns nothing,
    :meth:`fetch` assembles the newest published version).
    """

    def __init__(self, inner: Any, kv: Any, run_id: str, params: Any,
                 optimizer: str = "sgd", members: Sequence[int] = (0,),
                 me: Optional[int] = 0, n_shards: int = 0,
                 bucket_bytes: int = 0, workers: int = 0,
                 timeout_s: float = 30.0,
                 sleep: Optional[Callable[[float], None]] = None,
                 poll_s: float = 0.002, **opt_kw):
        self.inner = inner
        self.kv = kv
        self.run_id = run_id
        leaves, self.treedef = tree_flatten(params)
        self._shapes = [tuple(np.shape(l)) for l in leaves]
        self._sizes = [int(np.prod(s, dtype=np.int64)) if s else 1
                       for s in self._shapes]
        self.n_leaves = len(leaves)
        self.members = sorted(int(m) for m in members)
        self.me = me if me is None else int(me)
        self.n_shards = int(n_shards) or len(self.members)
        host = [_host_f32(l) for l in leaves]
        self.shard_bounds = plan_wire_shards(host, self.n_shards,
                                             bucket_bytes)
        self._opt = _make_host_optimizer(optimizer, **opt_kw)
        self.optimizer = optimizer
        self.timeout_s = float(timeout_s)
        self.sleep = sleep or time.sleep
        self.poll_s = float(poll_s)
        self.epoch = 1
        self.round = 0
        self.step = 0           # optimizer step (SGDState/AdamState.step)
        self.workers = int(workers)
        self._pool = None
        self._lock = threading.Lock()
        # Owned leaves only: params + optimizer state, keyed by global
        # flat-leaf index. ~1/N of the tree per member — the ZeRO-1 claim.
        self._params: Dict[int, np.ndarray] = {}
        self._state: Dict[int, Dict[str, np.ndarray]] = {}
        self._install_owned(host)
        self.counters: Dict[str, int] = {
            "rounds": 0, "rebalances": 0, "bytes_out": 0, "bytes_in": 0}

    # ---- ownership ----
    def _owner_plan(self) -> ShardPlan:
        return plan_shards(self.n_shards, len(self.members))

    def owned_shards(self) -> List[int]:
        if self.me is None or self.me not in self.members:
            return []
        lo, hi = self._owner_plan().shard_of(self.members.index(self.me))
        return list(range(lo, hi))

    def owner_of(self, shard: int) -> int:
        plan = self._owner_plan()
        for j, (lo, hi) in enumerate(plan.bounds):
            if lo <= shard < hi:
                return self.members[j]
        raise ValueError(f"shard {shard} outside plan of {self.n_shards}")

    def _install_owned(self, host: List[np.ndarray]) -> None:
        self._params.clear()
        self._state.clear()
        for k in self.owned_shards():
            lo, hi = self.shard_bounds[k]
            for i in range(lo, hi):
                self._params[i] = host[i].copy()
                self._state[i] = self._opt.init_leaf(host[i])

    def reset_params(self, params: Any) -> None:
        """Re-anchor owned param leaves from a full tree (resume path:
        canonical params come back from the checkpoint; optimizer state
        comes back via :meth:`load_state_dict`)."""
        leaves = tree_flatten(params)[0]
        for i in list(self._params):
            self._params[i] = _host_f32(leaves[i]).copy()

    # ---- pool surface (decision-identical delegation) ----
    def submit(self, *a, **kw):
        return self.inner.submit(*a, **kw)

    def submit_encoded(self, *a, **kw):
        return self.inner.submit_encoded(*a, **kw)

    def collect(self, current_step: int):
        return self.inner.collect(current_step)

    def consume(self, slice_ids) -> None:
        self.inner.consume(slice_ids)

    def drop_older_than(self, current_step: int) -> int:
        return self.inner.drop_older_than(current_step)

    def pending(self) -> Dict[int, int]:
        return self.inner.pending()

    def wire_bytes(self) -> int:
        return self.inner.wire_bytes()

    def ef_state_dict(self) -> Dict[str, Any]:
        return self.inner.ef_state_dict()

    def load_ef_state(self, state) -> None:
        self.inner.load_ef_state(state)

    # ---- keys ----
    def _key(self, kind: str, shard: int, rnd: Optional[int] = None,
             epoch: Optional[int] = None) -> str:
        e = self.epoch if epoch is None else epoch
        base = f"{self.run_id}/zw/{e}/{kind}/{shard}"
        return base if rnd is None else f"{base}/{rnd}"

    def _ver_key(self) -> str:
        return f"{self.run_id}/zw/ver"

    def _await(self, key: str) -> str:
        waited = 0.0
        while True:
            v = self.kv.get(key)
            if v is not None:
                return v
            if waited > self.timeout_s:
                raise TimeoutError(f"shard key {key} never published")
            self.sleep(self.poll_s)
            waited += self.poll_s

    def _wire_pool(self):
        if self.workers > 1 and self.n_shards > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers, thread_name_prefix="zw-wire")
            return self._pool
        return None

    # ---- publish / assemble ----
    def _shard_buf(self, k: int) -> np.ndarray:
        lo, hi = self.shard_bounds[k]
        if lo == hi:
            return np.zeros(0, np.float32)
        return np.concatenate([self._params[i].ravel()
                               for i in range(lo, hi)])

    def _put_shard(self, k: int, rnd: int) -> int:
        with _span("zw_put", shard=k, round=rnd) as sargs:
            text = encode_array(self._shard_buf(k))
            self.kv.set(self._key("p", k, rnd), text)
            if rnd > 1:
                # Keep current + previous round (readers mid-assembly);
                # GC everything older.
                self.kv.delete(self._key("p", k, rnd - 2))
            if sargs is not None:
                sargs["bytes"] = len(text)
        with self._lock:
            self.counters["bytes_out"] += len(text)
        return len(text)

    def _get_shard(self, k: int, rnd: int, epoch: Optional[int] = None,
                   out: Optional[List] = None) -> List[np.ndarray]:
        with _span("zw_get", shard=k, round=rnd) as sargs:
            text = self._await(self._key("p", k, rnd, epoch))
            flat = decode_array(text, np.float32)
            if sargs is not None:
                sargs["bytes"] = len(text)
        with self._lock:
            self.counters["bytes_in"] += len(text)
        lo, hi = self.shard_bounds[k]
        pieces = []
        off = 0
        for i in range(lo, hi):
            n = self._sizes[i]
            pieces.append(flat[off:off + n].reshape(self._shapes[i]))
            off += n
        if off != flat.size:
            raise ValueError(f"shard {k} payload holds {flat.size} elements,"
                             f" plan says {off}")
        if out is not None:
            for i, a in zip(range(lo, hi), pieces):
                out[i] = a
        return pieces

    def _write_pointer(self, version: int, rnd: int) -> None:
        self.kv.set(self._ver_key(), json.dumps(
            {"epoch": self.epoch, "round": rnd, "version": int(version),
             "step": self.step}))

    def _is_pointer_writer(self) -> bool:
        # The owner of shard 0 commits the round pointer (in single-owner
        # trainer mode that is simply the leader).
        return bool(self.owned_shards()) and self.owned_shards()[0] == 0

    def update_from(self, avg_tree: Any, version: Optional[int] = None) -> Any:
        """Apply this round's sharded update from the collected average
        gradient and return the ASSEMBLED full parameter tree (numpy
        float32 leaves, caller re-places on device). Owned shards update
        host-side and publish; foreign shards are read back from their
        owners' publishes for the same round.

        Safe when every member runs concurrently (or one member owns all
        shards); a single thread interleaving several members must call
        :meth:`apply_and_publish` for ALL before :meth:`assemble_round`
        for ANY — the same discipline as the collective this mirrors."""
        self.apply_and_publish(avg_tree, version)
        return self.assemble_round()

    def apply_and_publish(self, avg_tree: Any,
                          version: Optional[int] = None) -> None:
        """The publish half: sharded optimizer update on owned leaves +
        per-shard pipelined publishes + round pointer."""
        g_leaves = tree_flatten(avg_tree)[0]
        if len(g_leaves) != self.n_leaves:
            raise ValueError(f"gradient tree has {len(g_leaves)} leaves, "
                             f"params have {self.n_leaves}")
        grads = {i: _host_f32(g_leaves[i]).reshape(self._shapes[i])
                 for i in self._params}
        scalar = self._opt.round_scalar(self.step)
        rnd = self.round
        pool = self._wire_pool()
        futures = []
        with _span("zw_publish", round=rnd) as pargs:
            put_bytes = 0
            for k in self.owned_shards():
                lo, hi = self.shard_bounds[k]
                with _span("zw_update", shard=k, round=rnd):
                    for i in range(lo, hi):
                        p, st = self._opt.update_leaf(
                            self._params[i], grads[i], self._state[i],
                            self.step, scalar)
                        self._params[i] = p
                        self._state[i] = st
                # Pipelined per-shard publish: encode+put of shard k rides
                # the pool while shard k+1 is still updating.
                if pool is not None:
                    futures.append(pool.submit(self._put_shard, k, rnd))
                else:
                    put_bytes += self._put_shard(k, rnd)
            put_bytes += sum(f.result() for f in futures)
            if pargs is not None:
                pargs["bytes"] = put_bytes
        self.step += 1
        if self._is_pointer_writer():
            self._write_pointer(self.step if version is None else version,
                                rnd)

    def assemble_round(self) -> Any:
        """The assemble half: gather every shard of the current round and
        advance it."""
        return self._assemble(self.round)

    def publish_full(self, version: int) -> None:
        """Publish every owned shard from the CURRENT params (no update) —
        the initial/final/post-resume canonical publish."""
        rnd = self.round
        for k in self.owned_shards():
            self._put_shard(k, rnd)
        if self._is_pointer_writer():
            self._write_pointer(version, rnd)
        self.round += 1

    def _assemble(self, rnd: int) -> Any:
        out: List[Optional[np.ndarray]] = [None] * self.n_leaves
        owned = set(self.owned_shards())
        for k in owned:
            lo, hi = self.shard_bounds[k]
            for i in range(lo, hi):
                out[i] = self._params[i]
        pool = self._wire_pool()
        with _span("zw_assemble", round=rnd):
            foreign = [k for k in range(self.n_shards)
                       if k not in owned
                       and self.shard_bounds[k][0] != self.shard_bounds[k][1]]
            if pool is not None:
                futs = [pool.submit(self._get_shard, k, rnd, None, out)
                        for k in foreign]
                for f in futs:
                    f.result()
            else:
                for k in foreign:
                    self._get_shard(k, rnd, None, out)
        self.round = rnd + 1
        self.counters["rounds"] += 1
        return tree_unflatten(self.treedef, out)

    # ---- reader mode (followers / evaluators) ----
    def fetch(self, min_version: int = -1
              ) -> Optional[Tuple[int, Any]]:
        """Assemble the newest consistent set of shard versions from the
        round pointer. Returns (version, params tree) or None when nothing
        newer than ``min_version`` is published. Retries through a pointer
        advance (a shard GC'd mid-read means a newer round exists)."""
        for _ in range(4):
            raw = self.kv.get(self._ver_key())
            if raw is None:
                return None
            meta = json.loads(raw)
            if int(meta["version"]) <= min_version:
                return None
            rnd, epoch = int(meta["round"]), int(meta["epoch"])
            out: List[Optional[np.ndarray]] = [None] * self.n_leaves
            pool = self._wire_pool()
            try:
                with _span("zw_assemble", round=rnd):
                    live = [k for k in range(self.n_shards)
                            if self.shard_bounds[k][0]
                            != self.shard_bounds[k][1]]
                    if pool is not None:
                        futs = [pool.submit(self._get_shard, k, rnd, epoch,
                                            out) for k in live]
                        for f in futs:
                            f.result()
                    else:
                        for k in live:
                            self._get_shard(k, rnd, epoch, out)
            except TimeoutError:
                continue    # round GC'd under us: a newer pointer exists
            return int(meta["version"]), tree_unflatten(self.treedef, out)
        raise TimeoutError("zero-wire fetch: pointer kept advancing past "
                           "every readable round")

    # ---- elastic reshard (handoff / adopt, rebalance.py discipline) ----
    def handoff(self, members: Sequence[int]) -> bool:
        """Every CURRENT owner publishes its shards' params + optimizer
        state under the NEXT epoch. False when membership is unchanged."""
        new = sorted(int(m) for m in members)
        if new == self.members:
            return False
        nxt = self.epoch + 1
        for k in self.owned_shards():
            lo, hi = self.shard_bounds[k]
            if lo == hi:
                continue
            payloads = {"p": self._shard_buf(k)}
            for f in self._opt.fields:
                payloads[f] = np.concatenate(
                    [self._state[i][f].ravel() for i in range(lo, hi)])
            for name, buf in payloads.items():
                text = encode_array(buf)
                self.kv.set(self._key(f"h/{name}", k, None, nxt), text)
                with self._lock:
                    self.counters["bytes_out"] += len(text)
            self.kv.set(self._key("h/meta", k, None, nxt),
                        json.dumps({"step": self.step}))
        return True

    def adopt(self, members: Sequence[int]) -> bool:
        """Take ownership under the new member set: newly owned shards'
        params + optimizer state are read from the handoff keys (values
        moved, never recomputed — bitwise-neutral). A leaver goes dormant;
        a joiner only adopts."""
        new = sorted(int(m) for m in members)
        if new == self.members:
            return False
        nxt = self.epoch + 1
        old_owned = set(self.owned_shards())
        self.members = new
        self.epoch = nxt
        if self.me is None or self.me not in new:
            self._params.clear()
            self._state.clear()
            self.round = 0
            self.counters["rebalances"] += 1
            return True
        now_owned = set(self.owned_shards())
        for k in sorted(now_owned - old_owned):
            lo, hi = self.shard_bounds[k]
            if lo == hi:
                continue
            bufs = {}
            for name in ("p",) + tuple(self._opt.fields):
                text = self._await(self._key(f"h/{name}", k, None, nxt))
                bufs[name] = decode_array(text, np.float32)
                with self._lock:
                    self.counters["bytes_in"] += len(text)
            meta = json.loads(self._await(self._key("h/meta", k, None, nxt)))
            self.step = max(self.step, int(meta["step"]))
            off = 0
            for i in range(lo, hi):
                n = self._sizes[i]
                self._params[i] = bufs["p"][off:off + n].reshape(
                    self._shapes[i]).copy()
                self._state[i] = {
                    f: bufs[f][off:off + n].reshape(self._shapes[i]).copy()
                    for f in self._opt.fields}
                off += n
        for k in sorted(old_owned - now_owned):
            lo, hi = self.shard_bounds[k]
            for i in range(lo, hi):
                self._params.pop(i, None)
                self._state.pop(i, None)
        self.round = 0
        self.counters["rebalances"] += 1
        return True

    def set_members(self, members: Sequence[int]) -> bool:
        """handoff + adopt; same collective discipline as the flat-vector
        primitive (all members handoff before any adopts when one thread
        drives several)."""
        if not self.handoff(members):
            return False
        return self.adopt(members)

    # ---- checkpoint surface (extra_state; bit-for-bit resume) ----
    def state_dict(self) -> Dict[str, Any]:
        """Owned shards' OPTIMIZER state (+ step), concatenated per shard
        per field — ~1/N of the full optimizer state per member. Params
        ride the regular checkpoint; :meth:`load_state_dict` re-anchors
        them via :meth:`reset_params`."""
        shards: Dict[str, Dict[str, np.ndarray]] = {}
        for k in self.owned_shards():
            lo, hi = self.shard_bounds[k]
            if lo == hi:
                continue
            shards[str(k)] = {
                f: np.concatenate([self._state[i][f].ravel()
                                   for i in range(lo, hi)])
                for f in self._opt.fields}
        return {"step": int(self.step), "epoch": int(self.epoch),
                "optimizer": self.optimizer, "shards": shards}

    def load_state_dict(self, state: Dict[str, Any],
                        params: Optional[Any] = None) -> None:
        if params is not None:
            self.reset_params(params)
        if state.get("optimizer", self.optimizer) != self.optimizer:
            raise ValueError(
                f"sharded optimizer-state checkpoint is for "
                f"{state.get('optimizer')!r}, run uses {self.optimizer!r}")
        self.step = int(state["step"])
        for key, fields in (state.get("shards") or {}).items():
            k = int(key)
            lo, hi = self.shard_bounds[k]
            off = 0
            for i in range(lo, hi):
                if i not in self._state:
                    break   # shard moved to another owner since the save
                n = self._sizes[i]
                self._state[i] = {
                    f: np.asarray(fields[f][off:off + n], np.float32)
                    .reshape(self._shapes[i]).copy()
                    for f in self._opt.fields}
                off += n

    # ---- accounting ----
    def opt_state_nbytes(self) -> int:
        """Measured per-replica optimizer-state bytes (~1/N of the tree
        times the per-element state factor)."""
        return sum(int(a.nbytes) for st in self._state.values()
                   for a in st.values())

    def param_state_nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self._params.values())

    def wire_stats(self) -> Dict[str, int]:
        with self._lock:
            return {"zw_bytes_out": self.counters["bytes_out"],
                    "zw_bytes_in": self.counters["bytes_in"]}

    def snapshot(self) -> Dict[str, int]:
        out = dict(self.counters)
        out["epoch"] = self.epoch
        out["n_shards"] = self.n_shards
        out["n_members"] = len(self.members)
        out["owned_shards"] = len(self.owned_shards())
        return out

    def describe(self) -> str:
        sizes = [sum(self._sizes[i] for i in range(lo, hi)) * 4
                 for lo, hi in self.shard_bounds]
        return (f"zero-wire {self.n_shards} shards over "
                f"{len(self.members)} members, shard bytes {sizes}")


# ---------------------------------------------------------------------------
# The elastic flat-vector primitive (moved from elastic/rebalance.py; that
# module re-exports it), on the armoured base85 shard codec with wire byte
# accounting.
# ---------------------------------------------------------------------------

class ShardedKVUpdate:
    """Host-side elastic ZeRO-1 update over the coordination KV.

    Every member holds: its shard of the float32 parameter vector and the
    matching momentum slice. Per round, each member applies the
    reference-exact SGD recurrence to its slice of the (already averaged)
    full gradient and publishes the updated slice; everyone assembles the
    full vector from the published slices. ``set_members`` redistributes
    params + momentum through the KV when the member set changes —
    publish-old-shards / assemble / re-cut — bumping the plan epoch so
    slices from different plans can never be mixed.

    Keys: ``{run}/shard/{epoch}/p/{k}/{round}`` (params) and a one-shot
    ``{run}/shard/{epoch}/m/{k}`` (momentum, written at redistribution
    time only — steady-state rounds ship params only, exactly the
    all-gather half of the ring).
    """

    def __init__(self, kv, run_id: str, size: int, members: List[int],
                 me: int, lr: float, momentum: float = 0.0,
                 timeout_s: float = 30.0,
                 sleep: Optional[Callable[[float], None]] = None,
                 poll_s: float = 0.002):
        self.kv = kv
        self.run_id = run_id
        self.size = int(size)
        self.me = int(me)
        self.lr = np.float32(lr)
        self.momentum = np.float32(momentum)
        self.timeout_s = float(timeout_s)
        self.sleep = sleep or time.sleep
        self.poll_s = float(poll_s)
        self.epoch = 1
        self.members = sorted(int(m) for m in members)
        self.plan = plan_shards(self.size, len(self.members))
        self.round = 0
        self._params: Optional[np.ndarray] = None  # my slice, float32
        self._mom: Optional[np.ndarray] = None
        self.counters: Dict[str, int] = {
            "rebalances": 0, "rounds": 0, "bytes_out": 0, "bytes_in": 0}

    # ---- identity ----
    @property
    def shard_index(self) -> int:
        return self.members.index(self.me)

    def _span(self) -> Tuple[int, int]:
        return self.plan.shard_of(self.shard_index)

    # ---- lifecycle ----
    def init(self, flat_params: np.ndarray) -> None:
        """Everyone starts from the same full float32 vector (the
        checkpoint / broadcast params) and keeps only its slice."""
        flat = np.asarray(flat_params, np.float32)
        if flat.size != self.size:
            raise ValueError(f"params size {flat.size} != plan {self.size}")
        lo, hi = self._span()
        self._params = flat[lo:hi].copy()
        self._mom = np.zeros(hi - lo, np.float32)

    def _key(self, kind: str, shard: int, rnd: Optional[int] = None,
             epoch: Optional[int] = None) -> str:
        e = self.epoch if epoch is None else epoch
        base = f"{self.run_id}/shard/{e}/{kind}/{shard}"
        return base if rnd is None else f"{base}/{rnd}"

    def _await(self, key: str) -> str:
        waited = 0.0
        while True:
            v = self.kv.get(key)
            if v is not None:
                return v
            if waited > self.timeout_s:
                raise TimeoutError(f"shard key {key} never published")
            self.sleep(self.poll_s)
            waited += self.poll_s

    def _put(self, key: str, a: np.ndarray) -> None:
        text = encode_array(a)
        self.kv.set(key, text)
        self.counters["bytes_out"] += len(text)

    def _read(self, key: str) -> np.ndarray:
        text = self._await(key)
        self.counters["bytes_in"] += len(text)
        return decode_array(text, np.float32)

    # ---- the update round (publish / assemble halves of the gather) ----
    def publish(self, grad: np.ndarray) -> None:
        """Apply this member's slice of the update and publish it.
        ``grad`` is the full averaged gradient (each member already has
        it — the data-parallel reduce happened upstream).

        SGD recurrence (reference optim/sgd.py, elementwise):
            m <- momentum * m + g ; p <- p - lr * m
        """
        if self._params is None:
            raise RuntimeError("call init() before publish()")
        g = np.asarray(grad, np.float32)
        lo, hi = self._span()
        gs = g[lo:hi]
        if self.momentum > 0:
            self._mom = self.momentum * self._mom + gs
            upd = self._mom
        else:
            upd = gs
        self._params = self._params - self.lr * upd
        self._put(self._key("p", self.shard_index, self.round), self._params)

    def assemble(self) -> np.ndarray:
        """Block until every shard of the current round is published and
        return the full updated parameter vector (the all-gather half)."""
        full = np.empty(self.size, np.float32)
        for k, (slo, shi) in enumerate(self.plan.bounds):
            if slo == shi:
                continue
            if k == self.shard_index:
                full[slo:shi] = self._params
            else:
                full[slo:shi] = self._read(self._key("p", k, self.round))
        # GC the previous round's slice (bounded KV footprint).
        if self.round > 0:
            self.kv.delete(self._key("p", self.shard_index, self.round - 1))
        self.round += 1
        self.counters["rounds"] += 1
        return full

    def step(self, grad: np.ndarray) -> np.ndarray:
        """publish + assemble. Safe when every member runs concurrently
        (multi-process); a single thread interleaving several
        members must publish ALL before assembling ANY or the await
        deadlocks — the same constraint as the collective it mirrors."""
        self.publish(grad)
        return self.assemble()

    # ---- rebalance (handoff / adopt halves of the redistribution) ----
    def handoff(self, members: List[int]) -> bool:
        """First half of a rebalance: every CURRENT member publishes its
        params + momentum shard under the NEXT epoch. Returns False when
        the member set is unchanged (no rebalance needed)."""
        new = sorted(int(m) for m in members)
        if new == self.members:
            return False
        if self.me in self.members and self._params is not None:
            k = self.members.index(self.me)
            next_epoch = self.epoch + 1
            self._put(self._key("p", k, None, next_epoch), self._params)
            self._put(self._key("m", k, None, next_epoch), self._mom)
        return True

    def adopt(self, members: List[int]) -> bool:
        """Second half: assemble the full params + momentum from the old
        plan's handoff keys and keep the slice the NEW plan assigns this
        member. A leaver (not in the new set) goes dormant; a joiner (not
        in the old set) only assembles. Bitwise-neutral: values are moved,
        never recomputed (:func:`reslice` semantics over the KV)."""
        new = sorted(int(m) for m in members)
        if new == self.members:
            return False
        old_plan = self.plan
        next_epoch = self.epoch + 1
        if self.me not in new:
            self.members, self.epoch = new, next_epoch
            self.plan = plan_shards(self.size, len(new))
            self._params = self._mom = None
            self.counters["rebalances"] += 1
            return True
        fullp = np.empty(self.size, np.float32)
        fullm = np.empty(self.size, np.float32)
        for k, (slo, shi) in enumerate(old_plan.bounds):
            if slo == shi:
                continue
            fullp[slo:shi] = self._read(self._key("p", k, None, next_epoch))
            fullm[slo:shi] = self._read(self._key("m", k, None, next_epoch))
        self.members, self.epoch = new, next_epoch
        self.plan = plan_shards(self.size, len(new))
        lo, hi = self._span()
        self._params = fullp[lo:hi].copy()
        self._mom = fullm[lo:hi].copy()
        self.round = 0
        self.counters["rebalances"] += 1
        return True

    def set_members(self, members: List[int]) -> bool:
        """handoff + adopt. Members must run this collectively with the
        same argument — concurrently across processes, or handoff-all
        then adopt-all when a single thread drives several members (the
        same discipline as publish/assemble)."""
        if not self.handoff(members):
            return False
        return self.adopt(members)

    # ---- reference (exactness oracle) ----
    @staticmethod
    def replicated_reference(flat_params: np.ndarray, grads: List[np.ndarray],
                             lr: float, momentum: float = 0.0) -> np.ndarray:
        """The same recurrence on the FULL vector — what every replica
        would do without sharding. The exactness guard asserts the sharded
        path equals this bitwise at every round and across rebalances."""
        p = np.asarray(flat_params, np.float32).copy()
        m = np.zeros_like(p)
        lr32, mu32 = np.float32(lr), np.float32(momentum)
        for g in grads:
            g = np.asarray(g, np.float32)
            if mu32 > 0:
                m = mu32 * m + g
                upd = m
            else:
                upd = g
            p = p - lr32 * upd
        return p

    def wire_stats(self) -> Dict[str, int]:
        return {"shard_bytes_out": self.counters["bytes_out"],
                "shard_bytes_in": self.counters["bytes_in"]}

    def snapshot(self) -> Dict[str, int]:
        out = dict(self.counters)
        out["epoch"] = self.epoch
        out["n_shards"] = len(self.members)
        return out
