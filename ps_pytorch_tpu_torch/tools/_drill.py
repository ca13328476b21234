"""What the port's chaos drills share: a fleet of drill workers through
the port's launcher, their logs, a free port, the refusal to write a JAX
drill's committed artifact, and for the serving drills the tiny LM
checkpoint and the ``serve`` replica process."""

import os
import pathlib
import socket
import subprocess
import sys
import time
from typing import List

REPO = pathlib.Path(__file__).resolve().parents[2]


def require_device(device: str) -> None:
    """Raise where ``device`` is ``cuda`` and there is no card: a drill
    never carries on on the CPU unless asked to."""
    if device == "cuda":
        from ps_pytorch_tpu_torch.runtime.trainer import resolve_device
        resolve_device("cuda")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(run_dir: pathlib.Path, n: int, entry: str, worker_args,
           timeout: float = 420.0) -> int:
    """``n`` processes of ``python -m <entry> <worker_args>`` through
    ``tools/launch.py --simulate n``, waited for; the launcher's exit
    code."""
    from ps_pytorch_tpu_torch.tools import launch as launch_mod
    return launch_mod.main([
        "launch", "--run-dir", str(run_dir), "--simulate", str(n),
        "--devices-per-host", "1", "--port", str(free_port()), "--entry",
        entry, "--cwd", str(REPO), "--wait", "--timeout", str(timeout),
        "--", *worker_args])


def logs(run_dir: pathlib.Path, n: int) -> List[str]:
    out = []
    for i in range(n):
        p = pathlib.Path(run_dir) / f"proc_{i}.log"
        out.append(p.read_text() if p.exists() else "")
    return out


def dump(logs_: List[str], tail: int = 3000) -> str:
    return "\n\n".join(f"== proc_{i} ==\n{t[-tail:]}"
                       for i, t in enumerate(logs_))


def artifact_path(out: str, base: pathlib.Path, default: str,
                  jax_artifact: str) -> pathlib.Path:
    """``--out`` (default ``<base>/<default>``), refused where it names
    the JAX drill's committed artifact."""
    path = pathlib.Path(out or base / default)
    if path.name == jax_artifact:
        raise ValueError(f"{path.name} is the JAX drill's artifact; write "
                         "this drill's elsewhere")
    return path


# ------------------------------------------- serving drills' fleet of LMs

# The JAX package's tests/test_serving.py geometry: vocab, d_model,
# layers, heads, sequence length.
V, D, L, H, S = 61, 32, 2, 2, 96


def lm_cfg(train_dir: str):
    from ps_pytorch_tpu_torch.config import TrainConfig
    return TrainConfig(network="TransformerLM", lm_vocab=V, lm_d_model=D,
                       lm_layers=L, lm_heads=H, lm_seq_len=S,
                       train_dir=train_dir)


def write_lm_checkpoint(train_dir: str, step: int, seed: int) -> str:
    """Commit a tiny TransformerLM checkpoint in the JAX layout with its
    ``config.json``, through the port's checkpoint code; another seed
    gives other weights, so a reload shows."""
    import torch

    from ps_pytorch_tpu_torch.models import convert
    from ps_pytorch_tpu_torch.models.transformer import TransformerLM
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.runtime.lm_eval import build_lm_template

    cfg = lm_cfg(train_dir)
    model = TransformerLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H,
                          max_seq_len=S,
                          generator=torch.Generator().manual_seed(seed))
    tree = convert.state_to_jax(model, build_lm_template(cfg, model), step)
    return ckpt.save_checkpoint(train_dir, step, tree,
                                config_json=cfg.to_json())


class Replica:
    """One ``python -m ps_pytorch_tpu_torch.serve`` process, its log, and
    its fleet identity (``registry``: ``--serve-kv-dir DIR`` or
    ``--kv-replicas SPECS``)."""

    def __init__(self, rid: int, base: pathlib.Path, train_dir: str,
                 device: str, fleet: str, registry: List[str],
                 fault_spec: str = ""):
        self.rid = rid
        self.train_dir = train_dir
        self.device = device
        self.fleet = fleet
        self.registry = list(registry)
        self.fault_spec = fault_spec
        self.log_path = pathlib.Path(base) / f"replica_{rid}.log"
        self.proc = None

    def start(self) -> None:
        cmd = [sys.executable, "-m", "ps_pytorch_tpu_torch.serve",
               "--device", self.device, "--train-dir", self.train_dir,
               "--serve-port", "0", "--serve-host", "127.0.0.1",
               "--serve-slots", "4", "--serve-max-queue", "64",
               "--serve-reload-s", "0", *self.registry,
               "--serve-fleet", self.fleet,
               "--serve-replica-id", str(self.rid),
               "--serve-deadline-s", "20"]
        if self.fault_spec:
            cmd += ["--fault-spec", self.fault_spec]
        # The replicas share the host's cores with the drill and each
        # other: two threads each.
        env = dict(os.environ, OMP_NUM_THREADS="2")
        log = open(self.log_path, "ab")
        self.proc = subprocess.Popen(cmd, stdout=log, stderr=log,
                                     cwd=str(REPO), env=env)

    def log(self) -> str:
        return self.log_path.read_text() if self.log_path.exists() else ""

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)


def wait_ready(view, n: int, timeout_s: float = 120.0) -> list:
    """Block until ``n`` backends are health-gated ready (a replica's
    start includes its warm-up)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        ready = view.poll()
        if len(ready) >= n:
            return ready
        time.sleep(0.25)
    raise TimeoutError(f"only {len(view.poll())} of {n} replicas ready")
