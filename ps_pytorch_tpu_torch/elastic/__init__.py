"""The elastic control plane of the port, copies of the JAX package's
``elastic/``: leadership becomes a lease any process can take over, and
the worker set an epoch'd view the leader folds into the mask.

- ``election.py``    lease-based leader election: compare-and-claim on an
                     epoch-numbered lease key, tie-break by the lowest
                     process index, epoch fencing of a deposed leader.
- ``membership.py``  the epoch'd membership registry on
                     ``resilience/heartbeat.py``: processes announce join
                     and leave, the leader folds admissions and evictions
                     into the participation mask at step boundaries.
- ``rebalance.py``   the ZeRO shard plan over the KV and its rebalance on
                     membership change, re-exported from
                     ``parallel/zero_wire.py`` as in the JAX package.

The modules need only a duck-typed KV (set / get / delete) and an
optional shared clock: a ``ManualClock`` and the in-process ``KVStore``
in tests, the process group's ``DistributedKV`` or a ``ReplicatedKV``
(``runtime/kvrep.py``) across processes. ``election.py`` and
``membership.py`` are stdlib and numpy only.
"""

from ps_pytorch_tpu_torch.elastic.election import (  # noqa: F401
    Deposed, ElectionFailed, LeaderElection, group_election,
)
from ps_pytorch_tpu_torch.elastic.membership import (  # noqa: F401
    MemberAnnouncer, MembershipRegistry, read_view,
)
