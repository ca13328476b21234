"""Size-targeted bucketing of flat gradient leaves: the JAX package's
``parallel/buckets.py``, the schedule unit of the overlapped gradient wire.

Raw leaf granularity is the wrong wire unit: bias vectors would pay
per-message overhead, big conv kernels would serialize. Buckets re-cut the
flat-leaf sequence into ~``bucket_bytes`` contiguous spans (the DDP
gradient-bucketing idiom), preserving flat order so each bucket is exactly
``leaves[start:stop]``.

Bucketing is purely an execution schedule: what each leaf encodes to is the
same at every bucket size and worker count. Only the ORDER gains structure,
which lets bucket k be encoded on a worker thread while the caller hands
out bucket k+1.

Where the reference blocks the host until a bucket's device values are
ready (``block_until_ready``), the port records a CUDA event behind them on
the stream that produces them and makes the stream of the thread that runs
``fn`` wait for it: the work on the bucket is ordered after its values
whatever stream or thread it runs on, and the host never stalls. CPU
tensors and numpy arrays need no wait.
"""

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class Bucket:
    """A contiguous span of flat-order leaves: ``leaves[start:stop]``."""
    index: int
    start: int
    stop: int
    nbytes: int   # sum of member leaves' uncompressed sizes


def leaf_nbytes(leaf: Any) -> int:
    """Uncompressed byte size of a leaf without a device transfer."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    nb = getattr(leaf, "nbytes", None)
    if nb is not None:
        return int(nb)
    return np.asarray(leaf).nbytes


def plan_buckets(leaves: Sequence[Any], bucket_bytes: int) -> List[Bucket]:
    """Greedy contiguous partition of `leaves` into ~bucket_bytes buckets.

    Deterministic in flat-leaf order: a bucket closes once adding the next
    leaf would push it past the target (a single over-target leaf still
    gets its own bucket: leaves are never split). ``bucket_bytes <= 0``
    yields one bucket spanning everything (the blocking schedule).
    """
    if not leaves:
        return []
    sizes = [leaf_nbytes(l) for l in leaves]
    if bucket_bytes <= 0:
        return [Bucket(0, 0, len(leaves), sum(sizes))]
    buckets: List[Bucket] = []
    start, acc = 0, 0
    for i, nb in enumerate(sizes):
        if i > start and acc + nb > bucket_bytes:
            buckets.append(Bucket(len(buckets), start, i, acc))
            start, acc = i, 0
        acc += nb
    buckets.append(Bucket(len(buckets), start, len(sizes), acc))
    return buckets


def bucket_counts(buckets: Sequence[Bucket]) -> List[int]:
    """Per-bucket leaf counts: the compact form shipped in wire meta."""
    return [b.stop - b.start for b in buckets]


def _record(devices) -> list:
    """(device, event) for each CUDA device, the event recorded on the
    calling thread's current stream there."""
    events = []
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append((dev, ev))
    return events


def _wait(events) -> None:
    """Make the calling thread's current streams wait for ``events``."""
    for dev, ev in events:
        torch.cuda.current_stream(dev).wait_event(ev)


def _after(ready, fn, b, block):
    """On the thread that runs ``fn``: wait for the bucket's values, run,
    and record where the results will be ready."""
    _wait(ready)
    out = fn(b, block)
    return out, _record(dev for dev, _ in ready)


def stream_buckets(leaves: Sequence[Any], buckets: Sequence[Bucket],
                   fn: Callable[[Bucket, List[Any]], Any],
                   pool: Optional[Any] = None) -> List[Any]:
    """Run ``fn(bucket, leaves[start:stop])`` per bucket, ordered after the
    bucket's device values (see the module note). With an executor `pool`,
    fn runs on worker threads while the caller moves on to the NEXT bucket,
    and the caller's stream is ordered after each worker's results. Without
    a pool this is a plain serial map on the caller's stream (same results,
    blocking schedule).

    Returns fn results in bucket order; the first worker exception
    re-raises here, after all submissions.
    """
    if pool is None:
        return [fn(b, list(leaves[b.start:b.stop])) for b in buckets]
    futures = []
    for b in buckets:
        block = list(leaves[b.start:b.stop])
        devices = {l.device for l in block
                   if isinstance(l, torch.Tensor) and l.is_cuda}
        futures.append(pool.submit(_after, _record(devices), fn, b, block))
    out = []
    for f in futures:
        result, done = f.result()
        _wait(done)
        out.append(result)
    return out
