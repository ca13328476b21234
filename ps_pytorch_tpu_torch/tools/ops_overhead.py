"""What the ops plane costs a train step on the card: the same run with
and without it, in turns, in one process; one JSON digest line.

    python -m ps_pytorch_tpu_torch.tools.ops_overhead [--steps 20] \
        [--rounds 2] -- --network ResNet18 --dataset synthetic_cifar10 \
        --batch-size 256 --compute-dtype bfloat16 --conv-impl pallas \
        --fused-optimizer --momentum 0.9 --weight-decay 5e-4

Each round runs ``train.run`` once a variant, in this order:

- ``plain``: the given flags;
- ``ops``: plus ``--metrics-file``, ``--trace-file``, ``--flight-file``,
  ``--health-spec`` and ``--metrics-port`` (the exporter listening, no
  scraper);
- ``scraped``: ``ops`` with a thread reading /metrics and /healthz every
  50 ms while the steps run;
- ``profiled``: ``ops`` with ``--profile-dir`` over steps 3-4.

The step time of a variant is the median of the trainer's step times from
step 3 on (the first two compile and tune; ``profiled`` from step 6, after
its window and the trace's export). The digest also carries the host time
of one ``device_memory_record`` call (the allocator's counters, read every
step and every scrape) and the card's name and power limit. Without a CUDA
device it fails.
"""

import argparse
import contextlib
import io
import json
import socket
import statistics
import sys
import tempfile
import threading
import time
import urllib.request

import torch

from ps_pytorch_tpu_torch.telemetry import device_memory_record
from ps_pytorch_tpu_torch.tools.profile_capture import card_line

VARIANTS = ("plain", "ops", "scraped", "profiled")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _scrape(port: int, done: threading.Event, counts: list) -> None:
    url = f"http://127.0.0.1:{port}"
    while not done.is_set():
        try:
            for route in ("/metrics", "/healthz"):
                with urllib.request.urlopen(url + route, timeout=5) as resp:
                    resp.read()
            counts.append(1)
        except OSError:         # not listening yet, or stopped
            pass
        done.wait(0.05)


def run_variant(variant: str, train_args: list, steps: int) -> dict:
    from ps_pytorch_tpu_torch import train

    root = tempfile.mkdtemp(prefix=f"ops_overhead_{variant}_")
    argv = [*train_args, "--max-steps", str(steps), "--eval-freq", "0",
            "--resume", "false", "--train-dir", f"{root}/td",
            "--device", "cuda"]
    port = _free_port()
    if variant != "plain":
        argv += ["--metrics-file", f"{root}/m.jsonl", "--trace-file",
                 f"{root}/t.json", "--flight-file", f"{root}/f.json",
                 "--health-spec",
                 "nonfinite:halt;spike:warn,factor=10;stall:warn",
                 "--metrics-port", str(port)]
    if variant == "profiled":
        argv += ["--profile-dir", f"{root}/prof", "--profile-steps", "3-4"]
    done, scrapes = threading.Event(), []
    scraper = threading.Thread(target=_scrape, args=(port, done, scrapes),
                               daemon=True)
    if variant == "scraped":
        scraper.start()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            trainer, _ = train.run(argv)
    finally:
        done.set()
        if scraper.is_alive():
            scraper.join(timeout=10)
    first = 6 if variant == "profiled" else 3
    times = trainer.step_times[first - 1:]
    return {"median_s": statistics.median(times), "min_s": min(times),
            "max_s": max(times), "n": len(times), "scrapes": len(scrapes)}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    split = argv.index("--") if "--" in argv else len(argv)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv[:split])
    train_args = argv[split + 1:]
    if not torch.cuda.is_available():
        print("ops_overhead needs a CUDA device", file=sys.stderr)
        return 1
    rounds = []
    for _ in range(args.rounds):
        rounds.append({v: run_variant(v, train_args, args.steps)
                       for v in VARIANTS})
    device = torch.device("cuda")
    device_memory_record(device)
    t0 = time.perf_counter()
    for _ in range(1000):
        device_memory_record(device)
    mem_us = (time.perf_counter() - t0) * 1e3
    medians = {v: [r[v]["median_s"] for r in rounds] for v in VARIANTS}
    print(json.dumps({
        "card": card_line(), "train_args": train_args, "steps": args.steps,
        "rounds": rounds, "median_s": medians,
        "ratio_to_plain": {v: [m / p for m, p in zip(medians[v],
                                                     medians["plain"])]
                           for v in VARIANTS},
        "device_memory_record_us": mem_us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
