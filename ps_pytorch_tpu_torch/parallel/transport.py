"""Cross-process gradient and parameter transport over the KV: the JAX
package's ``parallel/transport.py``, the wire of asynchronous training
across processes (``runtime/async_trainer.py``).

The reference shipped gradients between machines as per-layer MPI sends
with step-encoded tags (``resnet_split.py:25-42``) into a master's pool
(``sync_replicas_master_nn.py:156-186``). Here each contribution crosses
the process boundary as codec-compressed bytes (``--compress-grad``)
through the KV the control plane rides: the process group's TCPStore
(``runtime/coordinator.py:DistributedKV``) across processes, an
in-process dict alone. The step token travels as explicit metadata.

Wire discipline (all keys under ``<run>/``), byte for byte the JAX
package's, so that either package reads the other's payloads:

- ``agrad/<slice>/ver``            latest sequence number a slice published
- ``agrad/<slice>/<seq>/meta``     json {"step", "chunks": [per-leaf counts],
                                   "corr", "crc", ["buckets"]}
- ``agrad/<slice>/<seq>/<l>/<c>``  base85 chunk c of encoded leaf l
- ``aparams/ver``                  canonical parameter version (= PS step)
- ``aparams/<ver>/...``            the same chunked layout for the weights

A tree is flattened with sorted keys (``jax.tree.flatten``'s order), so
leaf l is the same leaf in both packages. Payload keys land before the
``ver`` pointer moves, and a publisher deletes its own version - 2 (no
reader is still on it: readers read the pointer's current target), so
reads need no lock. Values are ASCII text, hence base85 armour (25% over
the raw bytes); 256 KiB chunks keep each value small. Channels count the
armoured bytes they move (``bytes_out``, ``bytes_in``).

Leaves may be numpy arrays or tensors on any device. A tensor comes to the
host where its leaf is encoded, so a CUDA leaf is encoded after its own
values are ready and nowhere earlier.

Overlapped schedule (``bucket_bytes > 0``): the leaves are cut into
contiguous size-targeted buckets (``parallel/buckets.py``), and bucket k
is copied to the host, encoded and put on a worker thread while the
caller hands out bucket k+1: each bucket's copy waits on a CUDA event
recorded behind its own values, never on the whole card. The payload is
bitwise the blocking wire's: same chunk keys, same chunk bytes, same
``"chunks"`` meta; bucketing only adds a ``"buckets"`` meta entry
(per-bucket leaf counts) that readers use to fetch and decode buckets
concurrently. The pointer moves only after every bucket has committed.
``bucket_bytes == 0`` is the legacy single-payload path.

Wire integrity (``resilience/integrity.py``): every chunk carries a CRC
token in the version meta (``"crc"``, per-leaf lists aligned with
``"chunks"``), and readers verify each chunk before decode. A mismatch, a
decode error from corrupt armour, or torn meta JSON demotes the whole read
to None ("absent this round", like a concurrent GC) and counts in
``integrity_failures``; it never crashes the reader, because the staleness
machinery upstream already absorbs absence. Metas without ``"crc"`` read
unverified.
"""

import json
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import numpy as np

from ps_pytorch_tpu_torch.compression.codecs import (
    CHANNEL_CODECS, decode_channel_leaf, encode_channel_leaf, require_codec,
)
from ps_pytorch_tpu_torch.parallel.async_dp import tree_flatten, tree_unflatten
from ps_pytorch_tpu_torch.parallel.buckets import (
    bucket_counts, leaf_nbytes, plan_buckets, stream_buckets,
)
from ps_pytorch_tpu_torch.resilience.integrity import (
    verify_digest, wire_digest,
)
from ps_pytorch_tpu_torch.resilience.retry import is_retryable
from ps_pytorch_tpu_torch.telemetry.trace import span as _span
from ps_pytorch_tpu_torch.utils.armor import WireCorrupt, b85decode, b85encode

_CHUNK = 1 << 18  # 256 KiB of base85 text per KV value (what bytes_out counts)


def _encode_leaf(leaf, level: int, codec: str) -> List[str]:
    """Armoured chunks of one leaf, framed by the channel-codec registry
    (``compression/codecs.py``)."""
    raw = encode_channel_leaf(leaf, level, codec)
    b85 = b85encode(raw).decode("ascii")
    return [b85[i:i + _CHUNK] for i in range(0, len(b85), _CHUNK)] or [""]


def _decode_leaf(chunks: List[str]) -> np.ndarray:
    # Self-describing framing: the registry recognises the codec from the
    # bytes, so no codec name travels with the payload.
    return decode_channel_leaf(b85decode("".join(chunks)))


class KVPytreeChannel:
    """One single-writer slot publishing versioned trees over a KV.

    ``codec``: a name of the channel-codec registry, ``blosc`` (the native
    lossless ``PSC1`` container, the reference's ``--compress-grad`` wire)
    or ``raw`` (uncompressed npy framing). Decoding is self-describing
    either way.

    ``bucket_bytes`` / ``workers``: the overlapped schedule (module
    docstring). 0 workers or 0 bucket_bytes give the same bytes in the
    blocking order.
    """

    def __init__(self, kv, prefix: str, template: Any, level: int = 3,
                 codec: str = "blosc", bucket_bytes: int = 0,
                 workers: int = 0):
        require_codec("channel codec", codec, CHANNEL_CODECS)
        self.kv = kv
        self.prefix = prefix
        self.level = level
        self.codec = codec
        self.bucket_bytes = int(bucket_bytes)
        self.workers = int(workers)
        leaves, self.treedef = tree_flatten(template)
        self.n_leaves = len(leaves)
        self.bytes_out = 0          # armoured bytes written (cumulative)
        self.bytes_in = 0           # armoured bytes read (cumulative)
        self.bytes_raw_out = 0      # pre-codec payload bytes (cumulative)
        self.last_publish_bytes = 0
        self.last_publish_raw_bytes = 0
        self.last_publish_bucket_bytes: List[int] = []  # armoured, per bucket
        self.publishes = 0
        self.read_errors = 0        # transient read failures tolerated
        self.publish_errors = 0     # transient publish failures absorbed
        self.integrity_failures = 0  # digest/decode/meta corruption demotions
        self._pool: Optional[ThreadPoolExecutor] = None

    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=max(self.workers, 1),
                thread_name_prefix=f"wire:{self.prefix}")
        return self._pool

    def close(self) -> None:
        """Stop the worker threads, if any started."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # ---- writer side ----
    def publish(self, version: int, tree: Any,
                meta: Optional[dict] = None) -> None:
        # corr travels in the publish span's args and in the wire meta: the
        # reader copies it into its wire_read span, which joins the two
        # sides of a merged Chrome trace.
        corr = f"{self.prefix}@{version}"
        with _span("wire_publish", channel=self.prefix, version=version,
                   corr=corr) as sargs:
            leaves, treedef = tree_flatten(tree)
            if treedef != self.treedef:
                raise ValueError("published tree structure != channel template")
            if self.bucket_bytes > 0:
                chunk_counts, extra = self._put_bucketed(version, leaves)
            else:
                chunk_counts, extra = self._put_serial(version, leaves)
            if sargs is not None:
                sargs["bytes"] = self.last_publish_bytes
                sargs["bytes_raw"] = self.last_publish_raw_bytes
            self.publishes += 1
            self.kv.set(f"{self.prefix}/{version}/meta",
                        json.dumps({**(meta or {}), "chunks": chunk_counts,
                                    "corr": corr, **extra}))
            # The pointer moves only after the payload is fully visible.
            self.kv.set(f"{self.prefix}/ver", str(version))
            self._gc(version - 2)

    def try_publish(self, version: int, tree: Any,
                    meta: Optional[dict] = None) -> bool:
        """Publish, absorbing transient store errors as a False return
        (counted in ``publish_errors``). Structural errors still raise."""
        try:
            self.publish(version, tree, meta)
            return True
        except Exception as e:
            if not is_retryable(e):
                raise
            self.publish_errors += 1
            return False

    def _put_serial(self, version: int, leaves: List[Any]):
        """Blocking wire: leaf-at-a-time encode and put."""
        chunk_counts = []
        crc: List[List[str]] = []
        nbytes = raw_bytes = 0
        for l_idx, leaf in enumerate(leaves):
            chunks = _encode_leaf(leaf, self.level, self.codec)
            chunk_counts.append(len(chunks))
            crc.append([wire_digest(c) for c in chunks])
            nbytes += sum(len(c) for c in chunks)
            raw_bytes += leaf_nbytes(leaf)
            for c_idx, c in enumerate(chunks):
                self.kv.set(f"{self.prefix}/{version}/{l_idx}/{c_idx}", c)
        self.bytes_out += nbytes
        self.bytes_raw_out += raw_bytes
        self.last_publish_bytes = nbytes
        self.last_publish_raw_bytes = raw_bytes
        self.last_publish_bucket_bytes = [nbytes]
        return chunk_counts, {"crc": crc}

    def _put_bucketed(self, version: int, leaves: List[Any]):
        """Overlapped wire: per-bucket copy, then pooled encode and put.
        The chunk keys and bytes of ``_put_serial``; only the schedule
        differs."""
        bks = plan_buckets(leaves, self.bucket_bytes)
        pool = self._executor() if (self.workers > 1 and len(bks) > 1) else None

        def encode_put(b, block):
            bcorr = f"{self.prefix}@{version}/b{b.index}"
            with _span("wire_encode", channel=self.prefix, bucket=b.index,
                       leaves=len(block), bytes_raw=b.nbytes) as eargs:
                texts = [_encode_leaf(l, self.level, self.codec)
                         for l in block]
                nbytes = sum(len(c) for chunks in texts for c in chunks)
                if eargs is not None:
                    eargs["bytes"] = nbytes
            with _span("wire_put", channel=self.prefix, bucket=b.index,
                       bytes=nbytes, bytes_raw=b.nbytes, corr=bcorr):
                for off, chunks in enumerate(texts):
                    l_idx = b.start + off
                    for c_idx, c in enumerate(chunks):
                        self.kv.set(f"{self.prefix}/{version}/{l_idx}/{c_idx}",
                                    c)
            crc = [[wire_digest(c) for c in chunks] for chunks in texts]
            return [len(chunks) for chunks in texts], nbytes, b.nbytes, crc

        results = stream_buckets(leaves, bks, encode_put, pool)
        chunk_counts = [n for counts, _, _, _ in results for n in counts]
        crc = [d for _, _, _, digests in results for d in digests]
        per_bucket = [nb for _, nb, _, _ in results]
        raw_bytes = sum(rb for _, _, rb, _ in results)
        self.bytes_out += sum(per_bucket)
        self.bytes_raw_out += raw_bytes
        self.last_publish_bytes = sum(per_bucket)
        self.last_publish_raw_bytes = raw_bytes
        self.last_publish_bucket_bytes = per_bucket
        return chunk_counts, {"buckets": bucket_counts(bks), "crc": crc}

    def _gc(self, version: int) -> None:
        if version < 0:
            return
        meta = self.kv.get(f"{self.prefix}/{version}/meta")
        if meta is None:
            return
        counts = json.loads(meta)["chunks"]
        for l_idx, n in enumerate(counts):
            for c_idx in range(n):
                self.kv.delete(f"{self.prefix}/{version}/{l_idx}/{c_idx}")
        self.kv.delete(f"{self.prefix}/{version}/meta")

    # ---- reader side ----
    #
    # Readers poll: a transient failure on the read leg (a retry budget
    # exhausted on a flaky store) is "nothing this poll", counted in
    # read_errors and retried naturally on the next poll. Writes stay
    # strict: a lost publish must surface.
    def latest_version(self) -> Optional[int]:
        try:
            v = self.kv.get(f"{self.prefix}/ver")
        except Exception as e:
            if not is_retryable(e):
                raise
            self.read_errors += 1
            return None
        return None if v is None else int(v)

    def read(self, version: Optional[int] = None
             ) -> Optional[Tuple[int, Any, dict]]:
        """-> (version, tree of numpy leaves, meta), or None if nothing is
        published, the version was already GC'd, a chunk failed its digest,
        or the store failed transiently this poll."""
        with _span("wire_read", channel=self.prefix) as sargs:
            try:
                got = self._read(version)
            except Exception as e:
                if not is_retryable(e):
                    raise
                self.read_errors += 1
                return None
            if got is not None and sargs is not None:
                # The writer's correlation id joins this read to its
                # publish in a merged Chrome trace.
                v, _, meta = got
                sargs["version"] = v
                if "corr" in meta:
                    sargs["corr"] = meta["corr"]
            return got

    def _read(self, version: Optional[int]
              ) -> Optional[Tuple[int, Any, dict]]:
        if version is None:
            version = self.latest_version()
            if version is None:
                return None
        meta_s = self.kv.get(f"{self.prefix}/{version}/meta")
        if meta_s is None:
            return None
        try:
            meta = json.loads(meta_s)
            counts = meta["chunks"]
        except (ValueError, TypeError, KeyError):
            # Torn or corrupt meta demotes like a failed digest.
            self.integrity_failures += 1
            return None
        crc = meta.get("crc")
        bucket_leaf_counts = meta.get("buckets")
        if (self.workers > 1 and bucket_leaf_counts is not None
                and len(bucket_leaf_counts) > 1):
            leaves = self._fetch_bucketed(version, counts, bucket_leaf_counts,
                                          crc)
        else:
            leaves = self._fetch_serial(version, counts, crc)
        if leaves is None:
            return None
        return version, tree_unflatten(self.treedef, leaves), meta

    def _checked_decode(self, l_idx: int, chunks: List[str],
                        crc: Optional[List[List[str]]]):
        """Digest-verify and decode one leaf's chunks; None on any
        integrity failure (counted). ``crc`` is None for writers that stamp
        no digests: their chunks decode unverified."""
        if crc is not None:
            try:
                tokens = crc[l_idx]
                ok = (len(tokens) == len(chunks) and
                      all(verify_digest(c, t)
                          for c, t in zip(chunks, tokens)))
            except (TypeError, IndexError):
                ok = False              # corrupt token table
            if not ok:
                self.integrity_failures += 1
                return None
        try:
            return _decode_leaf(chunks)
        except (WireCorrupt, ValueError):
            self.integrity_failures += 1
            return None

    def _get_chunks(self, version: int, l_idx: int,
                    n: int) -> Optional[List[str]]:
        chunks = [self.kv.get(f"{self.prefix}/{version}/{l_idx}/{c_idx}")
                  for c_idx in range(n)]
        return None if any(c is None for c in chunks) else chunks

    def _fetch_serial(self, version: int, counts: List[int],
                      crc: Optional[List[List[str]]] = None):
        leaves = []
        for l_idx, n in enumerate(counts):
            chunks = self._get_chunks(version, l_idx, n)
            if chunks is None:
                return None  # concurrently GC'd (the reader was very stale)
            self.bytes_in += sum(len(c) for c in chunks)
            leaf = self._checked_decode(l_idx, chunks, crc)
            if leaf is None:
                return None
            leaves.append(leaf)
        return leaves

    def _fetch_bucketed(self, version: int, counts: List[int],
                        bucket_leaf_counts: List[int],
                        crc: Optional[List[List[str]]] = None):
        """Concurrent per-bucket get and decode along the writer's bucket
        plan (shipped in meta). Any missing chunk voids the read, as in
        the serial path."""
        pool = self._executor()

        def get_decode(b_idx: int, start: int, n_leaves: int):
            with _span("wire_decode", channel=self.prefix, bucket=b_idx,
                       leaves=n_leaves,
                       corr=f"{self.prefix}@{version}/b{b_idx}"):
                leaves, nbytes = [], 0
                for l_idx in range(start, start + n_leaves):
                    chunks = self._get_chunks(version, l_idx, counts[l_idx])
                    if chunks is None:
                        return None
                    nbytes += sum(len(c) for c in chunks)
                    leaf = self._checked_decode(l_idx, chunks, crc)
                    if leaf is None:
                        return None
                    leaves.append(leaf)
                return leaves, nbytes

        futures, start = [], 0
        for b_idx, n_leaves in enumerate(bucket_leaf_counts):
            futures.append(pool.submit(get_decode, b_idx, start, n_leaves))
            start += n_leaves
        results = [f.result() for f in futures]
        if any(r is None for r in results):
            return None
        self.bytes_in += sum(nb for _, nb in results)
        return [l for block, _ in results for l in block]


class KVGradientTransport:
    """The async wire: N slice channels (gradients, each written by its
    slice) and one parameter channel (written by the PS leader)."""

    def __init__(self, kv, n_slices: int, grad_template: Any,
                 param_template: Any, run_id: str = "run", level: int = 3,
                 codec: str = "blosc", bucket_bytes: int = 0,
                 workers: int = 0):
        self.grad_ch = [KVPytreeChannel(kv, f"{run_id}/agrad/{s}",
                                        grad_template, level, codec,
                                        bucket_bytes=bucket_bytes,
                                        workers=workers)
                        for s in range(n_slices)]
        self.param_ch = KVPytreeChannel(kv, f"{run_id}/aparams",
                                        param_template, level, codec,
                                        bucket_bytes=bucket_bytes,
                                        workers=workers)
        self.n_slices = n_slices
        self._last_seen = [0] * n_slices
        self.kv = kv
        self.run_id = run_id

    def close(self) -> None:
        for ch in self.grad_ch + [self.param_ch]:
            ch.close()

    # ---- slice (worker) side ----
    def submit_grads(self, slice_id: int, seq: int, step: int,
                     grads: Any) -> None:
        """Publish slice ``slice_id``'s gradient computed against parameter
        version ``step`` (the staleness token)."""
        self.grad_ch[slice_id].publish(seq, grads, meta={"step": step})

    def fetch_params(self) -> Optional[Tuple[int, Any]]:
        got = self.param_ch.read()
        return None if got is None else (got[0], got[1])

    # ---- PS (leader) side ----
    def publish_params(self, version: int, params: Any) -> None:
        self.param_ch.publish(version, params)

    def poll_new_grads(self) -> List[Tuple[int, int, Any]]:
        """-> [(slice_id, step, grads)] contributions newer than the last
        poll (latest wins per slice, like the reference master's
        per-worker receive buffers)."""
        out = []
        for s, ch in enumerate(self.grad_ch):
            v = ch.latest_version()
            if v is None or v <= self._last_seen[s]:
                continue
            got = ch.read(v)
            if got is None:
                continue
            _, grads, meta = got
            self._last_seen[s] = v
            out.append((s, int(meta["step"]), grads))
        return out

    def wire_stats(self) -> dict:
        """Cumulative armoured bytes over all channels: the traffic this
        process wrote and read."""
        chans = self.grad_ch + [self.param_ch]
        return {
            "wire_bytes_out": sum(c.bytes_out for c in chans),
            "wire_bytes_in": sum(c.bytes_in for c in chans),
            "wire_raw_bytes_out": sum(c.bytes_raw_out for c in chans),
            "param_publishes": self.param_ch.publishes,
            "last_param_publish_bytes": self.param_ch.last_publish_bytes,
            "wire_read_errors": sum(c.read_errors for c in chans),
            "wire_integrity_failures": sum(c.integrity_failures
                                           for c in chans),
        }

    # ---- run control ----
    def set_done(self, final_step: int) -> None:
        self.kv.set(f"{self.run_id}/adone", str(final_step))

    def done(self) -> Optional[int]:
        v = self.kv.get(f"{self.run_id}/adone")
        return None if v is None else int(v)
