"""Cross-slice asynchronous / stale-gradient aggregation: the JAX package's
``parallel/async_dp.py``.

Each slice computes a gradient against the parameter version it last
fetched and ships it to this aggregator tagged with that version's step.
The aggregator forms the update gradient from the freshest contributions:

- contributions older than ``staleness_limit`` steps are dropped;
- optional exponential down-weighting ``staleness_decay**staleness``;
- optional K-of-N: only the freshest ``num_aggregate`` contributions count
  (``--num-aggregate``), the backup-worker cutoff across slices;
- optional codec compression of the hop (``--compress-grad``): gradients
  are pooled compressed exactly as they would travel, and decompressed at
  aggregation time;
- an optional integrity screen (``integrity=``, a
  ``resilience.integrity.GradIntegrity``), run on the fresh contributions
  before the K-of-N cutoff: a rejected or quarantined contributor is
  absent this round.

Codecs. ``int8`` quantizes the whole tree on its device in one launch of
the hand-written kernel (``ops/quantize.py:quantize_tree``) and dequantizes
and averages there: nothing crosses to the host. ``blosc`` (lossless bytes,
``compression/``) and the homomorphic family ``int8lat``/``topk``/``randk``
(``compression/codecs.py``) are host codecs: the leaves come to the host to
be encoded and the average comes back as numpy. Without a codec the leaves
are pooled as submitted and the average stays on their device.

Trees. A gradient tree is a dict (nested or flat) of leaves; it is
flattened with sorted keys, the order ``jax.tree.flatten`` gives, so a leaf
has the same global index in both packages.
"""

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ps_pytorch_tpu_torch.compression import g_compress, g_decompress
from ps_pytorch_tpu_torch.compression.codecs import (
    EF_GRAD_CODECS, GRAD_CODECS, HOMOMORPHIC_GRAD_CODECS, ErrorFeedback,
    encode_leaves, get_grad_codec, is_payload, payload_nbytes, require_codec,
)
from ps_pytorch_tpu_torch.ops.quantize import (
    LANES, QuantizedTensor, dequantize_int8, padded_rows, quantize_tree,
    quantized_nbytes,
)
from ps_pytorch_tpu_torch.parallel.buckets import plan_buckets, stream_buckets

_LEAF = object()


def tree_flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
                 ) -> Tuple[List[Any], Any]:
    """-> (leaves, treedef): dicts are walked with sorted keys; anything
    else, and any node ``is_leaf`` accepts, is a leaf."""
    leaves: List[Any] = []

    def walk(node):
        if is_leaf is not None and is_leaf(node):
            leaves.append(node)
            return _LEAF
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        return {k: build(v) for k, v in node.items()}

    return build(treedef)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def noise_key(slice_id: int, step: int) -> Tuple[int, int]:
    """The Philox key of a contribution's rounding noise (the int8 codec):
    the words (slice_id, step) mod 2^32. The counter holds the leaf's index
    in the tree, so a leaf's noise depends on the contribution and its
    index, and on nothing else: not on bucket size or worker count."""
    return int(slice_id) & 0xFFFFFFFF, int(step) & 0xFFFFFFFF


class StaleGradientAggregator:
    def __init__(self, n_slices: int, staleness_limit: int = 4,
                 staleness_decay: float = 0.0, num_aggregate: int = 0,
                 compress: bool = False, codec_level: int = 3,
                 codec: str = "blosc", wire_bucket_bytes: int = 0,
                 wire_workers: int = 0, topk_frac: float = 0.01,
                 error_feedback: bool = False, ef_clip: float = 0.0,
                 integrity: Any = None,
                 noise_fn: Optional[Callable] = None):
        if n_slices < 1:
            raise ValueError("need at least one slice")
        if num_aggregate > n_slices:
            raise ValueError(f"num_aggregate {num_aggregate} > n_slices "
                             f"{n_slices}")
        require_codec("grad_codec", codec, GRAD_CODECS)
        if not 0.0 < topk_frac <= 1.0:
            raise ValueError(f"topk_frac={topk_frac} (must be in (0, 1])")
        if error_feedback and codec not in EF_GRAD_CODECS:
            raise ValueError(f"error_feedback requires a lossy grad codec "
                             f"({' | '.join(EF_GRAD_CODECS)}), got {codec!r}")
        self.n = n_slices
        self.limit = staleness_limit
        self.decay = staleness_decay
        self.k = num_aggregate
        self.compress = compress
        self.codec_level = codec_level
        self.codec = codec
        self._homomorphic = codec in HOMOMORPHIC_GRAD_CODECS
        self.topk_frac = float(topk_frac)
        self.error_feedback = bool(error_feedback)
        self.ef_clip = float(ef_clip)
        # Sender-side EF residuals, one accumulator per slice.
        self._ef: Dict[int, ErrorFeedback] = {}
        # Overlapped leg (--wire-bucket-mb/--wire-workers): the encode of
        # bucket k runs on a worker thread while the caller hands out
        # bucket k+1 (parallel/buckets.py). 0 = blocking whole-tree encode;
        # the encoded leaves are identical either way.
        self.wire_bucket_bytes = int(wire_bucket_bytes)
        self.wire_workers = int(wire_workers)
        self._executor: Optional[ThreadPoolExecutor] = None
        # ``noise_fn(slice_id, step, leaf_index, shape) -> f32 tensor`` of
        # the int8 codec's rounding noise; None draws it inside the kernel
        # (Philox under ``noise_key``).
        self.noise_fn = noise_fn
        # Layers 2 and 3 of resilience/integrity.py (a GradIntegrity, or
        # None: no screen, bitwise the unscreened pool): collect() screens
        # every fresh contribution BEFORE the K-of-N cutoff; validator and
        # outlier rejects and quarantined contributors are demoted to
        # "absent this round" and consumed, so one bad payload is one
        # strike, not a strike a collect.
        self.integrity = integrity
        # slice_id -> (step, leaves or encoded leaves, treedef)
        self._pool: Dict[int, Tuple[int, List[Any], Any]] = {}

    def submit(self, slice_id: int, step: int, grads: Any) -> None:
        """Latest-wins per slice (a newer local gradient supersedes an
        unsent older one)."""
        if not (0 <= slice_id < self.n):
            raise ValueError(f"slice_id {slice_id} out of range")
        leaves, treedef = tree_flatten(grads)
        if self.compress and self._homomorphic:
            leaves = self._encode_homomorphic(leaves, slice_id, step)
        elif self.compress and self.codec == "int8":
            leaves = self._quantize_leaves(leaves, slice_id, step)
        elif self.compress:
            leaves = self._compress_leaves(leaves)
        # No codec: pool leaves as submitted. Device tensors STAY on their
        # device (collect's arithmetic then runs there and the averaged
        # gradient never visits the host).
        self._pool[slice_id] = (step, leaves, treedef)

    def _bucket_pool(self, n_buckets: int) -> Optional[ThreadPoolExecutor]:
        if self.wire_workers > 1 and n_buckets > 1:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.wire_workers,
                    thread_name_prefix="agg-wire")
            return self._executor
        return None

    def _compress_leaves(self, leaves: List[Any]) -> List[bytes]:
        """Lossless bytes per leaf, bucket by bucket: the leaves of bucket
        k come to the host and are compressed on a worker thread."""
        buckets = plan_buckets(leaves, self.wire_bucket_bytes)
        out = stream_buckets(
            leaves, buckets,
            lambda b, block: [g_compress(_to_numpy(l),
                                         level=self.codec_level)
                              for l in block],
            self._bucket_pool(len(buckets)))
        return [c for block in out for c in block]

    def _quantize_leaves(self, leaves: List[Any], slice_id: int,
                         step: int) -> List[QuantizedTensor]:
        """int8 on the leaves' device, the whole tree in one launch. The
        bucket plan schedules the host codecs' encodes; this codec has no
        host leg to overlap, and its payload is the same at every bucket
        size and worker count: leaf i's noise is keyed by the contribution
        and i."""
        leaves = [l if isinstance(l, torch.Tensor) else torch.as_tensor(
            np.asarray(l)) for l in leaves]
        noise = None
        if self.noise_fn is not None:
            noise = [self.noise_fn(slice_id, step, i,
                                   (padded_rows(l.numel()), LANES)).to(
                                       l.device) for i, l in enumerate(leaves)]
        return quantize_tree(leaves, noise_key(slice_id, step), noise)

    def submit_encoded(self, slice_id: int, step: int, tree: Any) -> None:
        """Pool a contribution that is ALREADY codec-encoded (a sender that
        ran encode and EF itself). Payload dicts are the flatten unit, so
        collect() sees one payload per original gradient leaf."""
        if not (0 <= slice_id < self.n):
            raise ValueError(f"slice_id {slice_id} out of range")
        if not (self.compress and self._homomorphic):
            raise ValueError("submit_encoded requires a homomorphic codec")
        leaves, treedef = tree_flatten(tree, is_leaf=is_payload)
        self._pool[slice_id] = (step, leaves, treedef)

    def _encode_homomorphic(self, leaves: List[Any], slice_id: int,
                            step: int) -> List[Any]:
        """Homomorphic-family encode on the same per-bucket schedule:
        encode + EF-update for bucket k run on worker threads. Leaf
        identity is the global flat index, so payloads are bitwise the same
        at every bucket size and worker count."""
        ef = None
        if self.error_feedback:
            ef = self._ef.get(slice_id)
            if ef is None:
                ef = self._ef[slice_id] = ErrorFeedback(clip=self.ef_clip)
        pool = self._bucket_pool(len(leaves)) if self.wire_bucket_bytes \
            else None
        return encode_leaves(self.codec, leaves, slice_id=slice_id,
                             step=step, frac=self.topk_frac, ef=ef,
                             bucket_bytes=self.wire_bucket_bytes, pool=pool)

    # ---- error-feedback checkpoint surface (runtime/checkpoint.py extra
    #      state; bit-for-bit resume for lossy codecs) ----
    def ef_state_dict(self) -> Dict[str, Any]:
        return {str(sid): ef.state_dict() for sid, ef in self._ef.items()}

    def load_ef_state(self, state: Dict[str, Any]) -> None:
        self._ef = {}
        for sid, d in (state or {}).items():
            ef = ErrorFeedback(clip=self.ef_clip)
            ef.load_state_dict(d)
            self._ef[int(sid)] = ef

    def pending(self) -> Dict[int, int]:
        """{slice_id: step} of every pooled contribution, without consuming
        anything."""
        return {sid: step for sid, (step, _, _) in self._pool.items()}

    def wire_bytes(self) -> int:
        """Bytes currently pooled (what crossed, or would cross, the hop
        between slices)."""
        total = 0
        for _, leaves, _ in self._pool.values():
            for l in leaves:
                if isinstance(l, QuantizedTensor):
                    total += quantized_nbytes(l)
                elif isinstance(l, (bytes, bytearray)):
                    total += len(l)
                elif isinstance(l, dict):
                    total += payload_nbytes(l)
                elif isinstance(l, torch.Tensor):
                    total += l.numel() * l.element_size()
                else:
                    total += l.nbytes
        return total

    def collect(self, current_step: int) -> Tuple[Optional[Any], dict]:
        """-> (weighted-average gradient tree or None, info).

        info: {"used": [slice ids], "dropped_stale": [...], "weights": {...}}
        (+ "rejected": {slice id: reason} when an integrity screen is
        attached).
        """
        fresh = []
        dropped = []
        for sid, (step, leaves, treedef) in self._pool.items():
            staleness = current_step - step
            if staleness < 0 or staleness > self.limit:
                dropped.append(sid)
                continue
            fresh.append((staleness, sid, leaves, treedef))
        rejected: Dict[int, str] = {}
        if self.integrity is not None and fresh:
            # Screen BEFORE the K-of-N cutoff, so a rejected contribution
            # cannot take a backup worker's place, then consume the
            # rejects (demoted to "absent this round").
            admitted, rejected = self.integrity.screen(
                [(sid, leaves) for _, sid, leaves, _ in fresh],
                step=current_step)
            if rejected:
                ok = set(admitted)
                fresh = [t for t in fresh if t[1] in ok]
                for sid in rejected:
                    self._pool.pop(sid, None)
        # K freshest (stalest dropped first); ties -> lower slice id.
        fresh.sort(key=lambda t: (t[0], t[1]))
        if self.k > 0:
            fresh = fresh[:self.k]
        if not fresh:
            info = {"used": [], "dropped_stale": dropped, "weights": {}}
            if self.integrity is not None:
                info["rejected"] = rejected
            return None, info
        if self.compress and self._homomorphic:
            # Compressed-domain aggregation: the K-of-N cutoff already
            # happened above, so this is the SINGLE decode point.
            avg, info = self._collect_homomorphic(fresh, dropped)
            if self.integrity is not None:
                info["rejected"] = rejected
            return avg, info
        weights = {}
        acc = None
        wsum = 0.0
        treedef_out = fresh[0][3]
        for staleness, sid, leaves, treedef in fresh:
            w = self.decay ** staleness if self.decay > 0 else 1.0
            weights[sid] = w
            if self.compress and self.codec == "int8":
                leaves = [dequantize_int8(l) for l in leaves]
            elif self.compress:
                leaves = [g_decompress(l) for l in leaves]
            # Functional accumulation, the same for numpy leaves and for
            # tensors. A slice on another device joins the accumulator's:
            # that transfer is the hop between slices, device to device.
            if acc is None:
                acc = [w * _f32(l) for l in leaves]
            else:
                acc = [a + w * _f32(_like(l, a)) for a, l in zip(acc, leaves)]
            wsum += w
        avg = [a / wsum for a in acc]
        info = {"used": [sid for _, sid, _, _ in fresh],
                "dropped_stale": dropped, "weights": weights}
        if self.integrity is not None:
            info["rejected"] = rejected
        return tree_unflatten(treedef_out, avg), info

    def _collect_homomorphic(self, fresh, dropped) -> Tuple[Any, dict]:
        """Sum payloads in the COMPRESSED domain (integer lattice
        accumulate for int8lat, sparse index-merge for topk/randk) and
        decode once at the end: no float32 tree per contributor is ever
        built."""
        codec = get_grad_codec(self.codec)
        treedef_out = fresh[0][3]
        shapes = [codec.payload_shape(p) for p in fresh[0][2]]
        states = [codec.sum_init() for _ in fresh[0][2]]
        weights = {}
        wsum = 0.0
        for staleness, sid, payloads, _ in fresh:
            w = self.decay ** staleness if self.decay > 0 else 1.0
            weights[sid] = w
            for st, p in zip(states, payloads):
                codec.sum_add(st, p, w)
            wsum += w
        avg = [codec.sum_finish(st, wsum, shape)
               for st, shape in zip(states, shapes)]
        info = {"used": [sid for _, sid, _, _ in fresh],
                "dropped_stale": dropped, "weights": weights}
        return tree_unflatten(treedef_out, avg), info

    def consume(self, slice_ids) -> None:
        """Remove applied contributions (a gradient counts once)."""
        for sid in slice_ids:
            self._pool.pop(sid, None)

    def drop_older_than(self, current_step: int) -> int:
        """GC the pool (contributions that can never be used again).
        Returns how many were removed: the authoritative dropped-stale
        count (collect() reports but does not remove, so its list would
        double-count across ticks)."""
        dead = [sid for sid, (step, _, _) in self._pool.items()
                if current_step - step > self.limit]
        for sid in dead:
            del self._pool[sid]
        return len(dead)


def _f32(leaf: Any) -> Any:
    return leaf.float() if isinstance(leaf, torch.Tensor) \
        else leaf.astype(np.float32)


def _like(leaf: Any, ref: Any) -> Any:
    """``leaf`` on ``ref``'s device (numpy and co-located tensors as they
    are)."""
    if isinstance(leaf, torch.Tensor) and isinstance(ref, torch.Tensor) \
            and leaf.device != ref.device:
        return leaf.to(ref.device)
    return leaf
