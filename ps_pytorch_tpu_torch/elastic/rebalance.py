"""ZeRO shard-plan rebalancing on membership change: the JAX package's
``elastic/rebalance.py``, a re-export.

The flat-vector primitives (``ShardPlan``, ``plan_shards``, ``reslice``,
``ShardedKVUpdate``) live in ``parallel/zero_wire.py``, so the elastic path
and the ``--shard-wire`` updater share one ZeRO-over-KV implementation:
one shard codec (the armoured base85 of ``utils/armor.py``), one plan
machinery, one wire-byte accounting. This module keeps the JAX package's
import surface, ``_encode`` / ``_decode`` included.
"""

from ps_pytorch_tpu_torch.parallel.zero_wire import (  # noqa: F401
    ShardPlan,
    ShardedKVUpdate,
    plan_shards,
    reslice,
)
from ps_pytorch_tpu_torch.parallel.zero_wire import (  # noqa: F401
    decode_array as _decode,
    encode_array as _encode,
)

__all__ = ["ShardPlan", "plan_shards", "reslice", "ShardedKVUpdate"]
