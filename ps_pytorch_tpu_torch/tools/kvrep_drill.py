#!/usr/bin/env python
"""Chaos drill of the quorum-replicated coordination plane: the JAX
package's ``tools/kvrep_drill.py`` (its phases, printed lines and
artifact) on the port's ``runtime/kvrep.py``. The KV itself is the victim.

- **train**: three ``python -m ps_pytorch_tpu_torch.runtime.kvrep``
  backend processes; three elastic async training processes (the port's
  ``tools/launch.py --simulate 3``) run their whole coordination plane
  (election, lease, membership, the gradient wire) over the quorum
  (``--kv-replicas``, three HTTP backends, quorum 2). The drill SIGKILLs
  backend 1 mid-run and restarts it empty on the same port (the restart
  is the wipe). The run must complete every version with zero retry
  give-ups; the clients eject, probe, rejoin and resync the reborn
  backend, which ends tag-equal key by key.
- **serve**: three ``python -m ps_pytorch_tpu_torch.serve`` replicas
  register and beat through ``--kv-replicas`` over three ``FileKV``
  directories; the router's ``FleetView`` reads the same quorum. Under
  open-loop load the drill wipes one directory: availability stays 1.00
  with zero 5xx, the fleet view never loses a replica, and the wiped
  directory is repopulated.
- **bitwise** (in one process): a momentum-SGD recurrence whose state
  lives only in the replicated KV, with ``kv_backend_kill`` (a window)
  and ``kv_backend_wipe`` armed on one backend and a client restart
  mid-sequence that resumes from a quorum read, ends bitwise on the
  numpy oracle.

The JAX drill's fourth phase, the replication-overhead bench, needs
``bench_suite.py``, which is not ported yet (ROADMAP.md): ``--phase
overhead`` raises, and the artifact's ``kvrep.overhead`` is empty (the
JAX gate's 5% budget then fails it; it needs that bench).

The JAX defaults are kept: 24 versions, the kill once a step >= 2 is
logged, a 4 s window. They were sized so that the kill, the probation,
the rejoin and the resync all land inside the run on a mesh that makes
~2 versions a second; the port's LeNet makes them faster, so the run is
shorter in seconds, and the backend must be back and resynced within it:
the resync probation (``--resync-s``, 2 s) is kept short for that.

    python -m ps_pytorch_tpu_torch.tools.kvrep_drill --device cpu \\
        --out /tmp/kvrep_drill.json

The artifact is this drill's own (``--out``, by default inside the run
directory); the JAX drill's ``RESILIENCE_r17.json`` is never written.
"""

import argparse
import base64
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

from ps_pytorch_tpu_torch.tools import _drill

ARTIFACT_NOT_WRITTEN = "RESILIENCE_r17.json"
ENTRY = "ps_pytorch_tpu_torch.tools.kvrep_drill"
FLEET = "drill"


# ---------------------------------------------------------------- workers

def train_args(args) -> list:
    """The train flags of one process of the train phase (the JAX
    drill's config): elastic async LeNet, its whole coordination plane on
    the quorum KV."""
    return [
        "--device", args.device, "--dataset", "synthetic_mnist",
        "--network", "LeNet", "--batch-size", "128", "--lr", "0.05",
        "--momentum", "0.9", "--compute-dtype", "float32", "--mode",
        "async", "--max-steps", str(args.max_steps), "--eval-freq", "4",
        "--train-dir", args.train_dir, "--resume", "false", "--log-every",
        "2", "--elastic", "--elastic-leader", "1", "--leader-lease-s",
        "3.0", "--heartbeat-interval-s", "3.0", "--kv-retry-attempts", "3",
        "--kv-replicas", args.kv_replicas, "--kv-quorum", "2",
        "--kv-resync-s", str(args.resync_s)]


def _worker_train(args) -> None:
    """One training process: ``train.run`` (FINAL, and the exit handshake
    held on the replicated KV itself, so the reborn backend sees the
    final keys too), then one KVREPSTATS line."""
    from ps_pytorch_tpu_torch import train

    t, _ = train.run(train_args(args))
    stats = dict(t._kvrep.snapshot())
    stats["kvrep_backends_healthy"] = t._kvrep.healthy_count()
    stats["version"] = t.version
    if t._retrier is not None:
        stats.update(t._retrier.snapshot())
    print(f"KVREPSTATS pid {t.pid} {json.dumps(stats)}", flush=True)


# ----------------------------------------------------------------- drill

_SPARE = ("import os, sys, time\n"
          "from ps_pytorch_tpu_torch.runtime import kvrep\n"
          "while not os.path.exists(sys.argv[1]):\n"
          "    time.sleep(0.02)\n"
          "sys.exit(kvrep.main(['--port', sys.argv[2]]))\n")


class KVBackend:
    """One ``python -m ps_pytorch_tpu_torch.runtime.kvrep`` server process,
    killable on its own and restartable empty on the same port."""

    def __init__(self, idx: int, port: int, base: pathlib.Path):
        self.idx = idx
        self.port = port
        self.log_path = base / f"kv_backend_{idx}.log"
        self.proc = None
        self._spare = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> None:
        log = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ps_pytorch_tpu_torch.runtime.kvrep",
             "--port", str(self.port)],
            stdout=log, stderr=log, cwd=str(_drill.REPO))

    def spare(self) -> pathlib.Path:
        """A replacement process with its imports done (the package's
        import takes seconds, and longer beside the trainers on a busy
        host), waiting for the returned flag file to bind the port: the
        restart after a kill is then as quick as a bare server's."""
        flag = self.log_path.with_suffix(".go")
        log = open(self.log_path, "ab")
        self._spare = subprocess.Popen(
            [sys.executable, "-c", _SPARE, str(flag), str(self.port)],
            stdout=log, stderr=log, cwd=str(_drill.REPO))
        return flag

    def restart(self, flag: pathlib.Path) -> None:
        """Hand the port to the spare: empty, the same port (the wipe)."""
        flag.touch()
        self.proc = self._spare

    def wait_ready(self, timeout_s: float = 20.0) -> None:
        import urllib.request
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(self.url + "/healthz",
                                            timeout=1.0) as r:
                    if r.status == 200:
                        return
            except Exception:
                time.sleep(0.1)
        raise TimeoutError(f"kv backend {self.idx} not ready on {self.url}")

    def sigkill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGKILL)
            self.proc.wait(timeout=10)

    def stop(self) -> None:
        for proc in (self.proc, self._spare):
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()


def parse_train(logs, rc: int, evidence: dict, tag_equal: bool,
                keys_compared: int, resynced_after: bool,
                max_steps: int) -> dict:
    """The train phase's evidence: the KVREPSTATS lines and FINALs of the
    three logs, the drill's kill and wipe, the tag comparison."""
    finals = [i for i, t in enumerate(logs) if "FINAL" in t]
    stats = {}
    for t in logs:
        for m in re.finditer(r"KVREPSTATS pid (\d+) (\{.*\})", t):
            stats[int(m.group(1))] = json.loads(m.group(2))

    def total(key):
        return sum(s.get(key, 0) for s in stats.values())

    versions = [s["version"] for s in stats.values() if "version" in s]
    giveups, rejoins, resyncs = (total("kv_giveups"), total("kvrep_rejoins"),
                                 total("kvrep_resyncs"))
    ok = (rc == 0 and len(finals) == 3 and evidence["killed"]
          and evidence["wiped"] and giveups == 0 and rejoins >= 1
          and resyncs >= 1 and tag_equal
          and max(versions, default=0) >= max_steps)
    return {"ok": ok, "rc": rc, "procs": 3, "backends": 3,
            "finals": len(finals), "max_version": max(versions, default=0),
            "giveups": giveups, "ejections": total("kvrep_ejections"),
            "rejoins": rejoins, "resyncs": resyncs,
            "healthy_at_exit": [s.get("kvrep_backends_healthy", 0)
                                for s in stats.values()],
            "kills": int(evidence["killed"]),
            "wipes": int(evidence["wiped"]),
            "kill_at_s": evidence["kill_at_s"],
            "resync_tag_equal": tag_equal, "keys_compared": keys_compared,
            "driver_resync": resynced_after}


def _phase_train(args, base: pathlib.Path) -> dict:
    """A backend SIGKILLed and restarted empty (the wipe) under live
    training."""
    from ps_pytorch_tpu_torch.runtime.kvrep import HttpKV, ReplicatedKV

    run_dir = base / "train"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    backends = [KVBackend(i, _drill.free_port(), run_dir) for i in range(3)]
    for b in backends:
        b.start()
    for b in backends:
        b.wait_ready()
    specs = ",".join(b.url for b in backends)
    victim = backends[1]
    evidence = {"killed": False, "wiped": False, "kill_at_s": -1.0}

    def _killer():
        # Once training is under way (a STEP >= 2 line in any log), with
        # a fallback for a slow start.
        flag = victim.spare()
        t0 = time.monotonic()
        deadline = t0 + 60.0
        while time.monotonic() < deadline:
            m = re.findall(r"STEP\s+(\d+)",
                           "\n".join(_drill.logs(run_dir, 3)))
            if any(int(x) >= 2 for x in m):
                break
            time.sleep(0.25)
        victim.sigkill()
        evidence["killed"] = True
        evidence["kill_at_s"] = round(time.monotonic() - t0, 2)
        time.sleep(args.kill_window_s)
        victim.restart(flag)    # same port, empty store: the wipe
        victim.wait_ready()
        evidence["wiped"] = True

    killer = threading.Thread(target=_killer, daemon=True)
    killer.start()
    try:
        rc = _drill.launch(run_dir, 3, ENTRY, [
            "--phase", "worker", "--device", args.device, "--train-dir",
            str(run_dir / "ckpt"), "--max-steps", str(args.max_steps),
            "--kv-replicas", specs, "--resync-s", str(args.resync_s)])
        killer.join(timeout=90.0)
        logs = _drill.logs(run_dir, 3)
        # Key-by-key tag equality: the reborn backend against an
        # untouched one.
        rkv = ReplicatedKV([HttpKV(b.url) for b in backends],
                           writer="drill")
        tag_equal, resynced_after, tags0 = False, False, {}
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            tags0 = rkv.backend_tags(0)
            if tags0 and tags0 == rkv.backend_tags(1):
                tag_equal = True
                break
            time.sleep(0.5)
        if not tag_equal:
            # The clients resynced during the run (counted); a last
            # pass of the drill mops up keys written in the exit race,
            # and the artifact says it was used.
            rkv.resync_backend(1)
            resynced_after = True
            tags0 = rkv.backend_tags(0)
            tag_equal = bool(tags0) and tags0 == rkv.backend_tags(1)
    finally:
        for b in backends:
            b.stop()
    out = parse_train(logs, rc, evidence, tag_equal, len(tags0),
                      resynced_after, args.max_steps)
    print(f"PHASE train ok={out['ok']} finals={out['finals']} giveups="
          f"{out['giveups']} rejoins={out['rejoins']} resyncs="
          f"{out['resyncs']} tag_equal={tag_equal} keys={len(tags0)}",
          flush=True)
    if not out["ok"]:
        print(_drill.dump(logs, 2500))
    return out


def _phase_serve(args, base: pathlib.Path) -> dict:
    """A backend wiped under live fleet serving: neither the router's
    fleet view nor the clients may notice."""
    from ps_pytorch_tpu_torch.runtime.coordinator import FileKV
    from ps_pytorch_tpu_torch.runtime.kvrep import ReplicatedKV
    from ps_pytorch_tpu_torch.serving.loadgen import run_http_open_loop
    from ps_pytorch_tpu_torch.serving.router import FleetView, Router
    from ps_pytorch_tpu_torch.telemetry.registry import (
        Registry, declare_router_metrics,
    )

    run_dir = base / "serve"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    train_dir = str(run_dir / "ckpt")
    _drill.write_lm_checkpoint(train_dir, 1, seed=0)
    kv_dirs = [run_dir / f"kv{i}" for i in range(3)]
    specs = ",".join(f"dir:{d}" for d in kv_dirs)

    replicas = [_drill.Replica(r, run_dir, train_dir, args.device, FLEET,
                               ["--kv-replicas", specs]) for r in range(3)]
    for rep in replicas:
        rep.start()
    rkv = ReplicatedKV([FileKV(str(d)) for d in kv_dirs], writer="drill")
    # Three replicas under load can starve their lease-beat threads for
    # seconds on a small host; the /readyz probe stays the liveness gate,
    # the lease gate is sized for that starvation, not for the network.
    view = FleetView(rkv, FLEET, lease_timeout_s=15.0, probe_timeout_s=2.0)
    router = Router(view, registry=declare_router_metrics(Registry()),
                    retries=3, backoff_s=0.05, hedge_s=0.0,
                    request_timeout_s=30.0, refresh_s=0.25)
    out = {"ok": False, "wipes": 0}
    try:
        router.start()
        _drill.wait_ready(view, 3)
        print(f"FLEET ready: 3 replicas behind {router.port} "
              f"(quorum KV over {specs})", flush=True)

        min_view = {"n": 3}
        sampling = {"on": True}

        def _sample():
            while sampling["on"]:
                min_view["n"] = min(min_view["n"], len(view.poll()))
                time.sleep(0.15)

        load_out = {}

        def _bg_load():
            load_out.update(run_http_open_loop(
                f"http://127.0.0.1:{router.port}", args.serve_requests,
                rate_rps=args.serve_rps, prompt_len=6, n_new=8,
                vocab=_drill.V, seed=500, deadline_s=15.0, timeout_s=40.0))

        sampler = threading.Thread(target=_sample, daemon=True)
        loader = threading.Thread(target=_bg_load, daemon=True)
        sampler.start()
        loader.start()
        time.sleep(1.0)          # load in flight before the wipe
        wiped_files = 0
        for f in kv_dirs[1].iterdir():
            if f.is_file():
                f.unlink()
                wiped_files += 1
        print(f"WIPE kv backend 1: {wiped_files} keys deleted mid-load",
              flush=True)
        loader.join(timeout=120.0)
        sampling["on"] = False
        sampler.join(timeout=5.0)

        # Lease beats fan out to every backend and quorum reads repair
        # the rest: the wiped directory fills within a few beats.
        repop_kv = FileKV(str(kv_dirs[1]))
        repop = 0
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            view.poll()
            repop = len(repop_kv.keys(f"serve/{FLEET}/"))
            if repop > 0:
                break
            time.sleep(0.5)
        out = serve_section(load_out, args.serve_requests, min_view["n"],
                            wiped_files, repop,
                            rkv.counters["kvrep_read_repairs"])
        print(f"PHASE serve ok={out['ok']} availability="
              f"{out['availability']} 5xx={out['failed_5xx']} min_view="
              f"{min_view['n']} repopulated={repop}", flush=True)
        if not out["ok"]:
            for rep in replicas:
                print(f"== replica_{rep.rid} ==\n{rep.log()[-2000:]}")
    finally:
        try:
            router.stop()
        except Exception:
            pass
        for rep in replicas:
            rep.stop()
    return out


def serve_section(load: dict, requests: int, min_view: int,
                  wiped_files: int, repop: int, read_repairs: int) -> dict:
    availability = load.get("availability")
    ok = (availability == 1.0 and load.get("failed_5xx", -1) == 0
          and load.get("requests", 0) >= requests
          and min_view == 3 and wiped_files > 0 and repop > 0)
    return {"ok": ok, "availability": availability,
            "availability_floor": 1.0,
            "failed_5xx": load.get("failed_5xx", -1),
            "requests": load.get("requests", 0),
            "completed": load.get("completed", 0),
            "status_counts": load.get("status_counts", {}),
            "latency_p99_ms": load.get("latency_p99_ms"),
            "min_fleet_view": min_view, "wiped_backend": 1,
            "wiped_keys": wiped_files, "repopulated_keys": repop,
            "read_repairs": read_repairs, "wipes": 1}


def _phase_bitwise() -> dict:
    """Kill-window and wipe faults on one backend, a client restart
    mid-sequence, the final state bitwise the numpy oracle."""
    import numpy as np

    from ps_pytorch_tpu_torch.resilience.faults import (
        FaultInjector, ManualClock,
    )
    from ps_pytorch_tpu_torch.runtime.coordinator import KVStore
    from ps_pytorch_tpu_torch.runtime.kvrep import ReplicatedKV

    spec = ("kv_backend_kill:backend=2,step=3,steps=4;"
            "kv_backend_wipe:backend=2,step=9")
    inj = FaultInjector(spec, process_index=0)
    stores = [KVStore() for _ in range(3)]
    wrapped = [inj.wrap_backend(kv, i) for i, kv in enumerate(stores)]
    clk = ManualClock()

    def client(writer: str) -> ReplicatedKV:
        return ReplicatedKV(wrapped, quorum=2, writer=writer,
                            clock=clk.time, resync_s=1.0, seed=7)

    lr, mu, size = np.float32(0.05), np.float32(0.9), 193
    rng = np.random.default_rng(23)
    p0 = rng.standard_normal(size).astype(np.float32)
    grads = [rng.standard_normal(size).astype(np.float32)
             for _ in range(12)]

    def enc(p, m, v: int) -> str:
        return f"{v}:" + base64.b64encode(
            np.concatenate([p, m]).tobytes()).decode("ascii")

    def dec(raw: str):
        v, _, b64 = raw.partition(":")
        flat = np.frombuffer(base64.b64decode(b64), dtype=np.float32)
        return flat[:size].copy(), flat[size:].copy(), int(v)

    rkv = client("c0")
    p, m = p0.copy(), np.zeros(size, np.float32)
    rkv.set("bw/state", enc(p, m, 0))
    resumed_at = -1
    for step, g in enumerate(grads):
        inj.maybe_crash(step)
        if step == 6:
            # A client restart mid-outage: a fresh client (empty health
            # state, empty version cache) must recover the exact state
            # from a quorum read while backend 2 is still dark.
            rkv = client("c1")
            p, m, v = dec(rkv.get("bw/state"))
            assert v == step, (v, step)
            resumed_at = step
        m = mu * m + g
        p = p - lr * m
        rkv.set("bw/state", enc(p, m, step + 1))
        clk.advance(0.7)
    snap = rkv.snapshot()

    # The oracle: the same recurrence with no KV near it.
    op, om = p0.copy(), np.zeros(size, np.float32)
    for g in grads:
        om = mu * om + g
        op = op - lr * om
    reader = client("c2")
    rp, rm, rv = dec(reader.get("bw/state"))
    bitwise = (bool(np.array_equal(rp, op)) and bool(np.array_equal(rm, om))
               and rv == len(grads))

    # The wipe at step 9 is masked by quorum reads; one anti-entropy
    # pass brings backend 2 back to key-by-key tag equality.
    reader.resync_backend(2)
    tags0 = reader.backend_tags(0)
    tag_equal = bool(tags0) and tags0 == reader.backend_tags(2)
    counters = inj.snapshot()
    ok = (bitwise and tag_equal and resumed_at == 6
          and counters.get("kv_backend_kills", 0) >= 1
          and counters.get("kv_backend_wipes", 0) >= 1
          and snap.get("kvrep_rejoins", 0) >= 1
          and snap.get("kvrep_resyncs", 0) >= 1)
    out = {"ok": ok, "bitwise_equal": bitwise, "resumed_at_step": resumed_at,
           "steps": len(grads), "resync_tag_equal": tag_equal,
           "kills": counters.get("kv_backend_kills", 0),
           "wipes": counters.get("kv_backend_wipes", 0),
           "drops": counters.get("kv_backend_drops", 0),
           "rejoins": snap.get("kvrep_rejoins", 0),
           "resyncs": snap.get("kvrep_resyncs", 0),
           "read_repairs": snap.get("kvrep_read_repairs", 0),
           "ejections": snap.get("kvrep_ejections", 0)}
    print(f"PHASE bitwise ok={ok} bitwise_equal={bitwise} "
          f"kills={out['kills']} wipes={out['wipes']} "
          f"rejoins={out['rejoins']} tag_equal={tag_equal}", flush=True)
    return out


def _phase_overhead() -> dict:
    raise NotImplementedError(
        "the kvrep drill's overhead phase (bench_suite."
        "bench_kvrep_overhead) is not ported yet (ROADMAP.md)")


def build_artifact(args, train: dict, serve: dict, bitwise: dict,
                   overhead=None) -> dict:
    """The JAX drill's artifact (the regress ``kvrep`` family's contract).
    ``overhead``: the replication-overhead row, None until the bench phase
    is ported."""
    ok = bool(train["ok"] and serve["ok"] and bitwise["ok"]
              and overhead is not None and overhead["ok"])
    kills = int(train["kills"] + bitwise["kills"])
    wipes = int(train["wipes"] + serve["wipes"] + bitwise["wipes"])
    return {
        "round": 17,
        "platform": args.device,
        "scenario": "kv_backend_kill_wipe_quorum: elastic_train + "
                    "fleet_serve + bitwise_resume + replication_overhead",
        "processes": 3,
        "backends": 3,
        "ok": ok,
        "bitwise_equal": bool(bitwise["bitwise_equal"]),
        "counters": {"kv_giveups": int(train["giveups"]),
                     "kv_backend_kills": kills,
                     "kv_backend_wipes": wipes},
        "kvrep": {
            "backend_kills": kills,
            "backend_wipes": wipes,
            "rejoins": int(train["rejoins"] + bitwise["rejoins"]),
            "resyncs": int(train["resyncs"] + bitwise["resyncs"]),
            "train": train,
            "serve": serve,
            "bitwise": bitwise,
            "overhead": overhead or {},   # empty: the gate's budget fails
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", default="all",
                    choices=("all", "overhead", "worker"),
                    help="all, the overhead bench (not ported yet), or "
                         "one training process (worker, started by the "
                         "launcher)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--train-dir", default="")
    ap.add_argument("--kv-replicas", default="")
    ap.add_argument("--resync-s", type=float, default=2.0)
    ap.add_argument("--max-steps", type=int, default=24)
    ap.add_argument("--kill-window-s", type=float, default=4.0)
    # The serve phase proves wipe-masking, not throughput: the open loop
    # stays well under the fleet's capacity on a small host.
    ap.add_argument("--serve-requests", type=int, default=60)
    ap.add_argument("--serve-rps", type=float, default=8.0)
    ap.add_argument("--run-dir", default="",
                    help="logs and train dirs (default: a new temporary "
                         "directory)")
    ap.add_argument("--out", default="",
                    help="the artifact (default: <run-dir>/"
                         "kvrep_drill.json)")
    args = ap.parse_args(argv)

    if args.phase == "worker":
        _worker_train(args)
        return 0
    if args.phase == "overhead":
        _phase_overhead()
    _drill.require_device(args.device)
    base = pathlib.Path(args.run_dir or tempfile.mkdtemp(
        prefix="kvrep_drill_"))
    base.mkdir(parents=True, exist_ok=True)
    out = _drill.artifact_path(args.out, base, "kvrep_drill.json",
                               ARTIFACT_NOT_WRITTEN)
    train = _phase_train(args, base)
    serve = _phase_serve(args, base)
    bitwise = _phase_bitwise()
    print("PHASE overhead skipped: bench_suite is not ported yet")
    art = build_artifact(args, train, serve, bitwise)
    out.write_text(json.dumps(art, indent=1))
    # The drill's own phases decide the exit code; the artifact's ok
    # waits for the overhead bench.
    ok = all(p["ok"] for p in (train, serve, bitwise))
    print(f"WROTE {out} ok={art['ok']} phases_ok={ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
