"""Homomorphic gradient codecs with error feedback: the JAX package's
``compression/codecs.py``, pure numpy, payload for payload.

The codecs keep contributions in the compressed domain through the sum:

- ``int8lat``  shared-scale int8 lattice. The scale is a power of two
               (``2**e`` with ``absmax/2**e <= 127``), so a dequantized
               value ``v * 2**e`` is exact in float32 and partial sums of
               same-exponent lattices are exact dyadics: the leader's
               integer accumulate is bitwise decode-then-average.
               Contributions are grouped by ``(weight, exponent)`` and
               summed in int32; one ``ldexp`` per group decodes the pool.
- ``topk``     magnitude top-k per leaf (``frac`` of entries). The leader
               scatter-adds (index, value) pairs into one dense
               accumulator, never a dense tree per contributor.
- ``randk``    random-k: a seeded index subset that is a function of
               (slice, step, leaf); same merge as topk.

Every codec carries a residual :class:`ErrorFeedback` accumulator across
steps on the sender: the encoder compresses ``grad + residual`` and keeps
``residual' = (grad + residual) - decode(payload)``, so what one step drops
the next step re-sends. EF state is plain numpy and goes into a checkpoint
as ``extra_state`` (``runtime/checkpoint.py``).

This module also owns the codec registries and the one unknown-codec error
that the config, the channel and the aggregator raise, and the channel leaf
codecs of the multi-process wire (``parallel/transport.py``): ``raw``, the
self-describing npy framing behind ``NPYRAW0:``, and ``blosc``, the
``PSC1`` container of ``compression.g_compress``, byte for byte the JAX
package's.
"""

import io
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Registries + the one shared validation error
# ---------------------------------------------------------------------------

#: Channel (transport framing) codecs: how one leaf becomes wire bytes.
CHANNEL_CODECS = ("blosc", "raw")
#: Gradient codecs accepted by --grad-codec / StaleGradientAggregator.
GRAD_CODECS = ("blosc", "int8", "int8lat", "topk", "randk")
#: The homomorphic family: payloads the leader sums WITHOUT decoding.
HOMOMORPHIC_GRAD_CODECS = ("int8lat", "topk", "randk")
#: Lossy codecs eligible for --ef error-feedback residuals.
EF_GRAD_CODECS = ("int8lat", "topk", "randk")


def codec_error(kind: str, got: str, allowed: Sequence[str]) -> ValueError:
    """The ONE unknown-codec message every validation site raises: a
    config typo reads identically from config.py and the aggregator."""
    return ValueError(f"unknown {kind} {got!r} ({' | '.join(allowed)})")


def require_codec(kind: str, got: str, allowed: Sequence[str]) -> str:
    if got not in allowed:
        raise codec_error(kind, got, allowed)
    return got


# ---------------------------------------------------------------------------
# Channel leaf codecs (the KVPytreeChannel framing registry)
# ---------------------------------------------------------------------------

_RAW_MAGIC = b"NPYRAW0:"


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy array: a tensor (on any device) is copied to
    the host in C order (npy framing would mark a transposed view as
    Fortran order), anything else goes through ``np.asarray``."""
    if hasattr(leaf, "detach"):
        return leaf.detach().contiguous().cpu().numpy()
    return np.asarray(leaf)


def _encode_leaf_raw(leaf: Any, level: int) -> bytes:
    # --compress-grad off: self-describing uncompressed npy framing.
    buf = io.BytesIO()
    np.save(buf, _host(leaf), allow_pickle=False)
    return _RAW_MAGIC + buf.getvalue()


def _encode_leaf_blosc(leaf: Any, level: int) -> bytes:
    from ps_pytorch_tpu_torch.compression import g_compress
    return g_compress(_host(leaf), level=level)


CHANNEL_LEAF_ENCODERS = {"raw": _encode_leaf_raw, "blosc": _encode_leaf_blosc}


def encode_channel_leaf(leaf: Any, level: int, codec: str) -> bytes:
    """Registry-dispatched leaf framing for the KV wire."""
    enc = CHANNEL_LEAF_ENCODERS.get(codec)
    if enc is None:
        raise codec_error("channel codec", codec, CHANNEL_CODECS)
    return enc(leaf, level)


def decode_channel_leaf(raw: bytes) -> np.ndarray:
    """Self-describing: the framing is recognised from the bytes, so mixed
    readers and writers cannot misread a payload."""
    if raw.startswith(_RAW_MAGIC):
        return np.load(io.BytesIO(raw[len(_RAW_MAGIC):]), allow_pickle=False)
    from ps_pytorch_tpu_torch.compression import g_decompress
    return g_decompress(raw)


# ---------------------------------------------------------------------------
# Homomorphic gradient codecs
# ---------------------------------------------------------------------------

def _leaf_f32(x: Any) -> np.ndarray:
    # A torch tensor comes to the host here, on the thread that encodes it.
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    # NOT ascontiguousarray: that would promote 0-d leaves to shape (1,)
    # and break tree-structure round-trips for scalar params.
    return np.asarray(x, dtype=np.float32)


def payload_nbytes(payload: Dict[str, np.ndarray]) -> int:
    """Wire size of one encoded leaf (sum of the payload arrays)."""
    return int(sum(int(v.nbytes) for v in payload.values()))


def is_payload(x: Any) -> bool:
    """True for an encoded-leaf dict (what rides the channel as a subtree);
    used as the ``is_leaf`` predicate when flattening pre-encoded trees."""
    return isinstance(x, dict) and "v" in x and ("e" in x or "i" in x)


class Int8LatticeCodec:
    """Shared-scale int8 lattice: ``x ~ v * 2**e`` with one power-of-two
    exponent per leaf, round-to-nearest-even values in [-127, 127]."""

    name = "int8lat"
    _ZERO_EXP = np.int16(-32768)   # sentinel: all-zero / empty leaf

    def encode(self, x: Any, *, slice_id: int = 0, step: int = 0,
               leaf_index: int = 0, frac: float = 0.0) -> Dict[str, np.ndarray]:
        x = _leaf_f32(x)
        absmax = float(np.max(np.abs(x))) if x.size else 0.0
        if not (absmax > 0.0) or not math.isfinite(absmax):
            return {"v": np.zeros(x.shape, np.int8),
                    "e": np.asarray(self._ZERO_EXP)}
        # absmax = m * 2**ex, m in [0.5, 1)  ->  absmax / 2**(ex-7) < 128,
        # i.e. the smallest power-of-two scale with |v| <= 127 after the
        # clip (rint can land exactly on 128 when m -> 1).
        _, ex = math.frexp(absmax)
        e = ex - 7
        # np.asarray: clip/rint on a 0-d input return numpy SCALARS, which
        # would break np.add(..., out=) in sum_add and the channel framing.
        v = np.asarray(np.clip(np.rint(np.ldexp(x, -e)), -127, 127)) \
            .astype(np.int8)
        return {"v": v, "e": np.asarray(np.int16(e))}

    def decode(self, payload: Dict[str, np.ndarray]) -> np.ndarray:
        e = int(payload["e"])
        v = np.asarray(payload["v"], np.float32)
        if e == int(self._ZERO_EXP):
            return v          # zeros, already float32
        return np.asarray(np.ldexp(v, e), np.float32)

    def payload_shape(self, payload: Dict[str, np.ndarray]) -> Tuple[int, ...]:
        return tuple(payload["v"].shape)

    # -- compressed-domain sum: int32 accumulators grouped by (weight, e) --
    def sum_init(self) -> dict:
        return {"groups": {}, "order": []}    # (w, e) -> int32 acc

    def sum_add(self, state: dict, payload: Dict[str, np.ndarray],
                weight: float) -> None:
        e = int(payload["e"])
        if e == int(self._ZERO_EXP):
            return                            # adds exact zero
        key = (float(weight), e)
        acc = state["groups"].get(key)
        if acc is None:
            state["groups"][key] = np.asarray(payload["v"], np.int32)
            state["order"].append(key)
        else:
            np.add(acc, payload["v"], out=acc)

    def sum_finish(self, state: dict, wsum: float,
                   shape: Tuple[int, ...]) -> np.ndarray:
        total: Optional[np.ndarray] = None
        for (w, e) in state["order"]:
            term = np.ldexp(state["groups"][(w, e)].astype(np.float32), e)
            if w != 1.0:
                term = np.float32(w) * term
            total = term if total is None else total + term
        if total is None:
            total = np.zeros(shape, np.float32)
        # np.asarray: ufuncs collapse 0-d arrays to scalars; the average
        # must come back with the leaf's ndarray shape.
        return np.asarray(total / np.float32(wsum), np.float32)


class TopKCodec:
    """Magnitude top-k sparsification: ``ceil(frac * n)`` largest-|x|
    entries as (sorted flat index, float32 value) pairs."""

    name = "topk"

    def _k(self, n: int, frac: float) -> int:
        return min(n, max(1, int(math.ceil(frac * n)))) if n else 0

    def _select(self, flat: np.ndarray, k: int, *, slice_id: int,
                step: int, leaf_index: int) -> np.ndarray:
        if k >= flat.size:
            return np.arange(flat.size, dtype=np.int32)
        idx = np.argpartition(np.abs(flat), flat.size - k)[flat.size - k:]
        return np.sort(idx).astype(np.int32)

    def encode(self, x: Any, *, slice_id: int = 0, step: int = 0,
               leaf_index: int = 0, frac: float = 0.01) -> Dict[str, np.ndarray]:
        x = _leaf_f32(x)
        flat = x.reshape(-1)
        k = self._k(flat.size, frac)
        idx = (self._select(flat, k, slice_id=slice_id, step=step,
                            leaf_index=leaf_index)
               if k else np.zeros(0, np.int32))
        return {"i": idx, "v": flat[idx],
                "s": np.asarray(x.shape, np.int64)}

    def decode(self, payload: Dict[str, np.ndarray]) -> np.ndarray:
        shape = tuple(int(d) for d in payload["s"])
        dense = np.zeros(int(np.prod(shape, dtype=np.int64)), np.float32)
        dense[payload["i"]] = payload["v"]
        return dense.reshape(shape)

    def payload_shape(self, payload: Dict[str, np.ndarray]) -> Tuple[int, ...]:
        return tuple(int(d) for d in payload["s"])

    # -- compressed-domain sum: sparse index-merge into ONE dense acc --
    def sum_init(self) -> dict:
        return {"acc": None, "shape": None}

    def sum_add(self, state: dict, payload: Dict[str, np.ndarray],
                weight: float) -> None:
        if state["acc"] is None:
            state["shape"] = tuple(int(d) for d in payload["s"])
            n = int(np.prod(state["shape"], dtype=np.int64))
            state["acc"] = np.zeros(n, np.float32)
        vals = payload["v"] if weight == 1.0 \
            else np.float32(weight) * payload["v"]
        # Indices within one payload are unique by construction, so fancy
        # indexing += is the fast correct scatter (np.add.at not needed).
        state["acc"][payload["i"]] += vals

    def sum_finish(self, state: dict, wsum: float,
                   shape: Tuple[int, ...]) -> np.ndarray:
        if state["acc"] is None:
            return np.zeros(shape, np.float32)
        return (state["acc"] / np.float32(wsum)).reshape(state["shape"])


class RandKCodec(TopKCodec):
    """Random-k: same payload/merge as topk, but the index subset is drawn
    by a (slice, step, leaf)-seeded RNG — deterministic for a given
    contribution (the bitwise schedule-invariance pin needs no cross-step
    state), unbiased across steps."""

    name = "randk"

    def _select(self, flat: np.ndarray, k: int, *, slice_id: int,
                step: int, leaf_index: int) -> np.ndarray:
        if k >= flat.size:
            return np.arange(flat.size, dtype=np.int32)
        seed = (hash((int(slice_id), int(step), int(leaf_index)))
                & 0xFFFFFFFF)
        rng = np.random.default_rng(seed)
        idx = rng.choice(flat.size, size=k, replace=False)
        return np.sort(idx).astype(np.int32)


GRAD_CODEC_REGISTRY = {c.name: c for c in
                       (Int8LatticeCodec(), TopKCodec(), RandKCodec())}


def get_grad_codec(name: str):
    codec = GRAD_CODEC_REGISTRY.get(name)
    if codec is None:
        raise codec_error("grad_codec", name, HOMOMORPHIC_GRAD_CODECS)
    return codec


# ---------------------------------------------------------------------------
# Error feedback
# ---------------------------------------------------------------------------

class ErrorFeedback:
    """Per-sender residual accumulator, one slot per flat leaf index.

    ``compensate`` adds the carried residual before encode; ``update``
    stores what the codec dropped. State is plain numpy keyed by leaf
    index — serializable through runtime/checkpoint.py extra state for
    bit-for-bit --auto-resume.

    ``clip`` (--ef-clip) caps the per-leaf residual L2 norm. Without it
    a poisoned contribution is absorbed into the sender's residual and
    re-emitted over later steps; clamping the carried residual bounds what
    any one step can carry over to a clip-sized perturbation. Honest codec
    residuals sit far below any sane clip."""

    def __init__(self, clip: float = 0.0):
        self._r: Dict[int, np.ndarray] = {}
        self.clip = float(clip)

    def compensate(self, leaf_index: int, x: np.ndarray) -> np.ndarray:
        r = self._r.get(leaf_index)
        return x if r is None else x + r

    def update(self, leaf_index: int, compensated: np.ndarray,
               decoded: np.ndarray) -> None:
        r = compensated - decoded
        if self.clip > 0.0:
            norm = float(np.linalg.norm(r.astype(np.float64)))
            if norm > self.clip:
                r = (r * np.float32(self.clip / norm)).astype(r.dtype)
        self._r[leaf_index] = r

    def residual_nbytes(self) -> int:
        return sum(int(r.nbytes) for r in self._r.values())

    # -- checkpoint surface (flax-msgpack-friendly: str keys, ndarrays) --
    def state_dict(self) -> Dict[str, np.ndarray]:
        return {str(i): r for i, r in self._r.items()}

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        self._r = {int(i): np.asarray(r, np.float32)
                   for i, r in (state or {}).items()}


# ---------------------------------------------------------------------------
# Bucketed encode schedule (sender side)
# ---------------------------------------------------------------------------

def encode_leaves(codec_name: str, leaves: Sequence[Any], *, slice_id: int,
                  step: int, frac: float = 0.01,
                  ef: Optional[ErrorFeedback] = None, bucket_bytes: int = 0,
                  pool: Optional[Any] = None) -> List[Dict[str, np.ndarray]]:
    """Encode a flat leaf list on the per-bucket streaming schedule
    (parallel/buckets.py): bucket k's device sync happens on the calling
    thread, then encode + EF-update run on ``pool`` while bucket k+1 is
    still landing — the same overlap the blosc/int8 wires get. Leaf
    identity is the GLOBAL flat index (``b.start + j``), so payloads are
    bitwise-identical at every bucket size / worker count."""
    from ps_pytorch_tpu_torch.parallel.buckets import (
        plan_buckets, stream_buckets,
    )
    codec = get_grad_codec(codec_name)
    buckets = plan_buckets(list(leaves), bucket_bytes)

    def encode_bucket(b, block):
        out = []
        for j, leaf in enumerate(block):
            i = b.start + j
            x = _leaf_f32(leaf)
            if ef is not None:
                x = ef.compensate(i, x)
            payload = codec.encode(x, slice_id=slice_id, step=step,
                                   leaf_index=i, frac=frac)
            if ef is not None:
                ef.update(i, x, codec.decode(payload))
            out.append(payload)
        return out

    blocks = stream_buckets(list(leaves), buckets, encode_bucket, pool)
    return [p for block in blocks for p in block]


# ---------------------------------------------------------------------------
# Reference (oracle) aggregation — what the homomorphic sum must equal
# ---------------------------------------------------------------------------

def decode_then_average(codec_name: str,
                        contributions: Sequence[Tuple[float, Sequence[dict]]]
                        ) -> List[np.ndarray]:
    """Today's leader semantics, per leaf: decode every contribution to
    float32 and weighted-average in contribution order. The compressed-
    domain sum is pinned bitwise against THIS (int8lat) / numerically
    against it (sparse codecs share the exact same adds per position)."""
    codec = get_grad_codec(codec_name)
    acc: Optional[List[np.ndarray]] = None
    wsum = 0.0
    for w, payloads in contributions:
        decoded = [codec.decode(p) for p in payloads]
        if acc is None:
            acc = [np.float32(w) * d if w != 1.0 else d for d in decoded]
        else:
            acc = [a + (np.float32(w) * d if w != 1.0 else d)
                   for a, d in zip(acc, decoded)]
        wsum += w
    assert acc is not None, "no contributions"
    return [a / np.float32(wsum) for a in acc]
