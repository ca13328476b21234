"""Multi-process wiring of the port: the JAX package's ``parallel/dist.py``
env contract over ``torch.distributed``, one process per replica.

The launcher (``ps_pytorch_tpu_torch.tools.launch``) exports three
variables to each process, the same three the JAX launcher exports, and
they can be set by hand:

- ``PS_TPU_COORDINATOR``: host:port of process 0;
- ``PS_TPU_NUM_PROCESSES``: the world size;
- ``PS_TPU_PROCESS_ID``: this process's rank.

:func:`initialize_from_env` builds one ``torch.distributed.TCPStore`` on
the coordinator's address (process 0 serves it) and the default process
group on that store. The same store is the Coordinator's KV
(``runtime/coordinator.py:DistributedKV``), with its keys on the raw store:
``init_process_group`` puts its own keys under a prefix of its own.

The backend is fixed once, before ``init_process_group``, by
:func:`choose_backend`: NCCL for CUDA when no two ranks of a host share a
card, gloo on the CPU, and gloo when ranks share a card (NCCL refuses two
ranks on one device; gloo reduces CUDA tensors through host memory). It is
never switched after a failure. Rank r runs on ``cuda:{r % cards}``.

The JAX helpers that assemble global arrays (``globalize_*``,
``all_replicated``) have no counterpart: each rank holds its own local
batch and a full copy of the parameters.
"""

import json
import os
import socket
from collections import Counter
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

ENV_COORD = "PS_TPU_COORDINATOR"    # host:port of process 0
ENV_NPROC = "PS_TPU_NUM_PROCESSES"
ENV_PID = "PS_TPU_PROCESS_ID"
LAUNCHER = "python -m ps_pytorch_tpu_torch.tools.launch"
STORE_TIMEOUT = timedelta(seconds=300)
_PLACEMENT_KEY = "ps_tpu_dist/placement"

# The raw store under this process's default group, once initialized.
_store: Optional[dist.Store] = None


def _contract() -> Optional[Tuple[str, int, int, int]]:
    """(host, port, world, rank) from the env contract, or None for a
    single process. Raises for an environment that asks for several
    processes without the whole contract."""
    coord = os.environ.get(ENV_COORD, "")
    n = int(os.environ.get(ENV_NPROC, "1") or "1")
    if not coord:
        if n > 1:
            raise ValueError(
                f"{ENV_NPROC}={n} without {ENV_COORD}: a launch of several "
                f"processes needs the coordinator's host:port (start the "
                f"ranks with {LAUNCHER} launch)")
        world_size = int(os.environ.get("WORLD_SIZE", "1") or "1")
        if world_size > 1:
            raise ValueError(
                f"WORLD_SIZE={world_size} without the {ENV_COORD} / "
                f"{ENV_NPROC} / {ENV_PID} contract: the port does not read "
                f"torchrun's variables; start the ranks with {LAUNCHER} "
                "launch")
        return None
    if ENV_PID not in os.environ:
        raise ValueError(f"{ENV_COORD}={coord} without {ENV_PID}")
    host, _, port = coord.rpartition(":")
    rank = int(os.environ[ENV_PID])
    if not host or not 0 <= rank < n:
        raise ValueError(f"{ENV_COORD}={coord!r} {ENV_NPROC}={n} "
                         f"{ENV_PID}={rank}: expected host:port and "
                         "0 <= rank < world")
    return host, int(port), n, rank


def choose_backend(device_type: str, ranks_on_host: int, cards: int) -> str:
    """The backend for ranks on ``device_type``, with at most
    ``ranks_on_host`` ranks on any one host of ``cards`` cards each."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"no backend for device type {device_type!r}")
    return "nccl" if ranks_on_host <= cards else "gloo"


def initialize_from_env(device: str = "cuda") -> Optional[dist.Store]:
    """Join the process group that the env contract describes, with
    ``device`` ("cuda" or "cpu") as every rank's device type. Returns the
    raw TCPStore, or None for a single process (no contract). Safe to call
    twice: the second call returns the same store."""
    global _store
    contract = _contract()
    if contract is None:
        return None
    if dist.is_initialized():
        return _store
    host, port, n, rank = contract
    device_type = torch.device(device).type
    cards = 0
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to "
                               "run the ranks on the CPU")
        cards = torch.cuda.device_count()
        torch.cuda.set_device(rank % cards)
    store = dist.TCPStore(host, port, n, is_master=rank == 0,
                          timeout=STORE_TIMEOUT)
    # Every rank publishes (host, cards) and reads everyone's, so every
    # rank picks the same backend.
    store.set(f"{_PLACEMENT_KEY}/{rank}",
              json.dumps([socket.gethostname(), cards]))
    keys = [f"{_PLACEMENT_KEY}/{r}" for r in range(n)]
    store.wait(keys)
    placed = [json.loads(store.get(k)) for k in keys]
    backend = choose_backend(device_type,
                             max(Counter(h for h, _ in placed).values()),
                             min(c for _, c in placed))
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", rank % cards)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            **kw)
    _store = store
    return store


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    global _store
    if dist.is_initialized():
        dist.destroy_process_group()
    _store = None


def store() -> Optional[dist.Store]:
    return _store


def group() -> Optional[dist.ProcessGroup]:
    """The default group when this process joined one, else None."""
    return dist.group.WORLD if dist.is_initialized() else None


def backend() -> str:
    return dist.get_backend() if dist.is_initialized() else "none"


def is_multiprocess() -> bool:
    return world() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_data_shard() -> Tuple[int, int]:
    """(host_id, num_hosts) for ``prepare_data``: one shard a rank."""
    return rank(), world()


def local_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda`` without an index is
    ``cuda:{rank % cards}`` in a process group; anything else as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", rank() % torch.cuda.device_count())
    return dev
