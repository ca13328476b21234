"""Per-step metrics, schema v2: a copy of the JAX package's
``runtime/metrics.py`` that prints byte-identical STEP lines and writes the
same JSONL keys, so the JAX package's tools parse the port's logs. The
trainers add ``phases`` (the step's span totals, ``telemetry/trace.py``)
and, on a CUDA device, ``device_mem_peak_bytes`` and ``device_mem_bytes``
to each record, as the JAX trainers do.

    STEP <step> epoch <e> loss <l> acc <a> participating <p>
         step_time <s> data_time <d> [mfu <m|n/a> ips <i> stall <f>]
"""

import json
import re
import time
from typing import IO, Optional

# The derived fields (mfu, goodput, stall, device memory) are the
# registry's, as in the JAX package.
from ps_pytorch_tpu_torch.telemetry.registry import (  # noqa: F401
    derive_step_record,
)

SCHEMA_VERSION = 2

V1_LINE_KEYS = ("step", "epoch", "loss", "acc", "participating",
                "step_time", "data_time")
V2_LINE_KEYS = V1_LINE_KEYS + ("mfu", "examples_per_sec", "data_stall_frac")
JSONL_BASE_KEYS = ("schema_version", "ts") + V2_LINE_KEYS

_LINE = ("STEP {step} epoch {epoch} loss {loss:.6f} acc {acc:.4f} "
         "participating {participating:g} step_time {step_time:.4f} "
         "data_time {data_time:.4f}")
_LINE_RE = re.compile(
    r"STEP (?P<step>\d+) epoch (?P<epoch>\d+) loss (?P<loss>[-\d.naninf]+) "
    r"acc (?P<acc>[-\d.naninf]+) participating (?P<participating>[-\d.]+) "
    r"step_time (?P<step_time>[\d.]+) data_time (?P<data_time>[\d.]+)")
_V2_RE = re.compile(
    r" mfu (?P<mfu>[-\d.einaf]+|n/a) ips (?P<examples_per_sec>[-\d.einaf]+)"
    r" stall (?P<data_stall_frac>[-\d.einaf]+)")


def format_line(step: int, epoch: int, loss: float, acc: float,
                participating: float, step_time: float, data_time: float,
                mfu: Optional[float] = None,
                examples_per_sec: Optional[float] = None,
                data_stall_frac: Optional[float] = None) -> str:
    line = _LINE.format(step=step, epoch=epoch, loss=loss, acc=acc,
                        participating=participating, step_time=step_time,
                        data_time=data_time)
    if mfu is not None or examples_per_sec is not None \
            or data_stall_frac is not None:
        line += (f" mfu {'n/a' if mfu is None else format(mfu, '.4f')}"
                 f" ips {0.0 if examples_per_sec is None else examples_per_sec:.1f}"
                 f" stall {0.0 if data_stall_frac is None else data_stall_frac:.3f}")
    return line


def parse_line(line: str) -> Optional[dict]:
    m = _LINE_RE.search(line)
    if not m:
        return None
    d = m.groupdict()
    rec = {"step": int(d["step"]), "epoch": int(d["epoch"]),
           "loss": float(d["loss"]), "acc": float(d["acc"]),
           "participating": float(d["participating"]),
           "step_time": float(d["step_time"]),
           "data_time": float(d["data_time"])}
    m2 = _V2_RE.search(line, m.end())
    if m2:
        rec["mfu"] = None if m2["mfu"] == "n/a" else float(m2["mfu"])
        rec["examples_per_sec"] = float(m2["examples_per_sec"])
        rec["data_stall_frac"] = float(m2["data_stall_frac"])
    return rec


class MetricsLogger:
    """Per-step sink: the stdout STEP line and an optional JSONL file.

    With more than one process, process i > 0 writes ``{jsonl_path}.p{i}``
    so that processes never interleave writes in one file; process 0 keeps
    the bare path (the JAX package's ``runtime/metrics.py:106-114``)."""

    def __init__(self, jsonl_path: str = "", log_every: int = 1,
                 printer=print, process_index: int = 0,
                 num_processes: int = 1):
        self.log_every = max(log_every, 1)
        self.printer = printer
        if jsonl_path and num_processes > 1 and process_index > 0:
            jsonl_path = f"{jsonl_path}.p{process_index}"
        self.jsonl_path = jsonl_path
        self._fh: Optional[IO] = open(jsonl_path, "a") if jsonl_path else None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def log_step(self, step: int, epoch: int, *, loss: float, acc: float,
                 participating: float, step_time: float, data_time: float,
                 mfu: Optional[float] = None,
                 examples_per_sec: Optional[float] = None,
                 data_stall_frac: Optional[float] = None,
                 **extra) -> None:
        if step % self.log_every == 0:
            self.printer(format_line(step, epoch, loss, acc, participating,
                                     step_time, data_time, mfu=mfu,
                                     examples_per_sec=examples_per_sec,
                                     data_stall_frac=data_stall_frac))
        if self._fh is not None:
            rec = {"schema_version": SCHEMA_VERSION, "ts": time.time(),
                   "step": step, "epoch": epoch,
                   "loss": loss, "acc": acc, "participating": participating,
                   "step_time": step_time, "data_time": data_time,
                   "mfu": mfu, "examples_per_sec": examples_per_sec,
                   "data_stall_frac": data_stall_frac, **extra}
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
