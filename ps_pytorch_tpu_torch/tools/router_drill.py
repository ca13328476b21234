#!/usr/bin/env python
"""Fleet-serving chaos drill of the router: the JAX package's
``tools/router_drill.py`` (its phases, printed lines and artifact) over
real ``python -m ps_pytorch_tpu_torch.serve`` processes on real sockets,
discovered through a directory-backed KV (``FileKV``), behind the port's
``Router``. Three phases, one router:

- **kill**: three replicas serve a tiny LM checkpoint behind the router;
  the victim arms ``replica_kill:served=N`` (``--fault-spec``) and
  SIGKILLs itself under Poisson load. The router must absorb the death
  (stale lease, ejection on connection errors, failover retries) with
  zero client-visible 5xx and availability at or above the floor.
- **reload**: the victim restarts (same replica id, next incarnation), a
  step-2 checkpoint is committed, and ``Router.roll_reload`` drains,
  reloads and resumes each replica in turn under open-loop load: zero
  failed requests, and every replica's ``/healthz`` shows ``model_step``
  2.
- **hedge**: one replica is pulsed with SIGSTOP / SIGCONT (a stalled
  backend, no synthetic sleeps) while the same load runs twice, hedging
  off, then on. Hedged dispatch must lower the routed p99.

Bitwise evidence: the same seeded request routed repeatedly (landing on
different replicas) returns identical tokens.

The artifact carries the JAX regress ``router`` family's contract.
``--device`` (default ``cuda``) goes to every replica: on one card the
three replicas share it.

    python -m ps_pytorch_tpu_torch.tools.router_drill --device cpu \\
        --out /tmp/router_drill.json

The artifact is this drill's own (``--out``, by default inside the run
directory); the JAX drill's ``RESILIENCE_r15.json`` is never written.
"""

import argparse
import json
import os
import pathlib
import shutil
import signal
import sys
import tempfile
import threading
import time
import urllib.request

from ps_pytorch_tpu_torch.tools import _drill

ARTIFACT_NOT_WRITTEN = "RESILIENCE_r15.json"
FLEET = "drill"
AVAILABILITY_FLOOR = 0.99


def _healthz(url: str) -> dict:
    with urllib.request.urlopen(url + "/healthz", timeout=5.0) as r:
        return json.loads(r.read())


def _bitwise_probe(router_url: str, tries: int = 4) -> bool:
    """The same seeded request routed ``tries`` times (round-robin
    spreads it over the replicas) decodes the same tokens."""
    from ps_pytorch_tpu_torch.serving.loadgen import http_post_generate
    body = {"tokens": [3, 1, 4, 1, 5], "n_new": 12, "seed": 42,
            "temperature": 0.8, "top_k": 7, "deadline_s": 15}
    outs = []
    for _ in range(tries):
        code, resp = http_post_generate(router_url, body, timeout_s=30.0)
        if code != 200:
            return False
        outs.append(resp.get("tokens"))
    return all(t == outs[0] for t in outs) and outs[0] is not None


# ------------------------------------------------------------- evidence

def kill_section(stats: dict, killed: bool, victim: int, victim_rc,
                 retries: int) -> dict:
    ok = (killed and stats["failed_5xx"] == 0
          and stats["availability"] is not None
          and stats["availability"] >= AVAILABILITY_FLOOR)
    return {"ok": ok, "replica_kills": int(killed), "victim": victim,
            "victim_rc": victim_rc, "availability": stats["availability"],
            "availability_floor": AVAILABILITY_FLOOR,
            "failed_5xx": stats["failed_5xx"],
            "requests": stats["requests"], "completed": stats["completed"],
            "status_counts": stats["status_counts"], "retries": retries,
            "latency_p99_ms": stats["latency_p99_ms"]}


def reload_section(load: dict, roll: list, steps: dict, n: int) -> dict:
    advanced = len(steps) == n and all(s == 2 for s in steps.values())
    rolled = sum(r.get("ok", False) for r in roll)
    ok = (load.get("failed_5xx", -1) == 0 and load.get("requests", 0) > 0
          and rolled == n and advanced)
    return {"ok": ok, "replicas_rolled": rolled,
            "model_step_advanced": advanced, "steps_after": steps,
            "from_step": 1, "to_step": 2,
            "requests": load.get("requests", 0),
            "completed": load.get("completed", 0),
            "failed_5xx": load.get("failed_5xx", -1),
            "status_counts": load.get("status_counts", {}),
            "results": roll}


def hedge_section(no_hedge: dict, hedged: dict, hedges: int,
                  counters: dict, hedge_s: float) -> dict:
    p99_no, p99_yes = no_hedge["latency_p99_ms"], hedged["latency_p99_ms"]
    ratio = (p99_yes / p99_no
             if p99_no and p99_yes and p99_no > 0 else None)
    ok = (ratio is not None and ratio < 1.0 and hedges >= 1
          and hedged["failed_5xx"] == 0)
    return {"ok": ok, "hedge_s": hedge_s, "p99_no_hedge_ms": p99_no,
            "p99_hedge_ms": p99_yes,
            "p99_ratio": None if ratio is None else round(ratio, 4),
            "hedges": hedges, "hedge_wins": counters["hedge_wins"],
            "hedge_cancelled": counters["hedge_cancelled"],
            "no_hedge_availability": no_hedge["availability"],
            "hedge_availability": hedged["availability"]}


def new_artifact(device: str, n: int) -> dict:
    return {"round": 15, "platform": device,
            "scenario": "router_replica_kill_failover + rolling_reload + "
                        "hedged_tail_latency",
            "processes": n, "ok": False, "bitwise_equal": False,
            "counters": {"kv_giveups": 0, "replica_kills": 0},
            "router": {"replicas": n}}


def finish_artifact(art: dict, bitwise: bool, kill: dict, reload_: dict,
                    hedge: dict, router_counters: dict,
                    ejections: int) -> dict:
    art["bitwise_equal"] = bitwise
    art["counters"]["replica_kills"] = kill["replica_kills"]
    art["router"].update(kill=kill, reload=reload_, hedge=hedge)
    art["counters"].update(
        {f"router_{k}": v for k, v in router_counters.items()})
    art["counters"]["backend_ejections"] = ejections
    art["ok"] = bool(bitwise and kill["ok"] and reload_["ok"]
                     and hedge["ok"])
    return art


# ----------------------------------------------------------------- drill

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="")
    ap.add_argument("--run-dir", default="")
    ap.add_argument("--replicas", type=int, default=3)
    # The victim dies after serving this many requests: far enough in
    # that it holds work in flight when the SIGKILL lands.
    ap.add_argument("--kill-served", type=int, default=8)
    ap.add_argument("--kill-requests", type=int, default=90)
    ap.add_argument("--kill-rps", type=float, default=18.0)
    ap.add_argument("--reload-requests", type=int, default=90)
    ap.add_argument("--reload-rps", type=float, default=12.0)
    ap.add_argument("--hedge-requests", type=int, default=60)
    ap.add_argument("--hedge-rps", type=float, default=10.0)
    ap.add_argument("--hedge-s", type=float, default=0.15)
    args = ap.parse_args(argv)
    _drill.require_device(args.device)

    from ps_pytorch_tpu_torch.runtime.coordinator import FileKV
    from ps_pytorch_tpu_torch.serving.loadgen import run_http_open_loop
    from ps_pytorch_tpu_torch.serving.router import FleetView, Router
    from ps_pytorch_tpu_torch.telemetry.registry import (
        Registry, declare_router_metrics,
    )

    base = pathlib.Path(args.run_dir or tempfile.mkdtemp(
        prefix="router_drill_"))
    out = _drill.artifact_path(args.out, base, "router_drill.json",
                               ARTIFACT_NOT_WRITTEN)
    shutil.rmtree(base / "ckpt", ignore_errors=True)
    shutil.rmtree(base / "kv", ignore_errors=True)
    base.mkdir(parents=True, exist_ok=True)
    train_dir, kv_dir = str(base / "ckpt"), str(base / "kv")
    _drill.write_lm_checkpoint(train_dir, 1, seed=0)

    n = args.replicas
    victim_id = n - 1
    registry_flags = ["--serve-kv-dir", kv_dir]
    replicas = {}
    for rid in range(n):
        fault = (f"replica_kill:served={args.kill_served},r={victim_id}"
                 if rid == victim_id else "")
        rep = _drill.Replica(rid, base, train_dir, args.device, FLEET,
                             registry_flags, fault_spec=fault)
        rep.start()
        replicas[rid] = rep

    view = FleetView(FileKV(kv_dir), FLEET, lease_timeout_s=3.0,
                     probe_timeout_s=0.5)
    router = Router(view, registry=declare_router_metrics(Registry()),
                    retries=3, backoff_s=0.05, hedge_s=0.0,
                    request_timeout_s=30.0, refresh_s=0.25)
    art = new_artifact(args.device, n)
    url = None

    def load(n_req, rps, seed):
        return run_http_open_loop(url, n_req, rate_rps=rps, prompt_len=6,
                                  n_new=8, vocab=_drill.V, seed=seed,
                                  deadline_s=15.0, timeout_s=40.0)

    try:
        router.start()
        url = f"http://127.0.0.1:{router.port}"
        _drill.wait_ready(view, n)
        print(f"FLEET ready: {n} replicas behind {router.port}", flush=True)

        bitwise = _bitwise_probe(url)
        print(f"BITWISE cross-replica determinism: {bitwise}", flush=True)

        # -- kill: SIGKILL a replica under open-loop load ----------------
        stats_kill = load(args.kill_requests, args.kill_rps, 100)
        time.sleep(0.5)
        victim = replicas[victim_id]
        victim_rc = victim.proc.poll()
        killed = (victim_rc == -signal.SIGKILL
                  or "FAULT replica_kill" in victim.log())
        kill = kill_section(stats_kill, killed, victim_id, victim_rc,
                            router.counters["retries"])
        print(f"PHASE kill ok={kill['ok']} killed={killed} "
              f"availability={stats_kill['availability']:.4f} "
              f"5xx={stats_kill['failed_5xx']} "
              f"retries={router.counters['retries']}", flush=True)

        # -- reload: restart the victim, commit step 2, roll the fleet --
        restarted = _drill.Replica(victim_id, base, train_dir, args.device,
                                   FLEET, registry_flags)
        restarted.start()
        replicas[victim_id] = restarted
        _drill.wait_ready(view, n)
        _drill.write_lm_checkpoint(train_dir, 2, seed=1)
        load_out = {}
        bg = threading.Thread(target=lambda: load_out.update(
            load(args.reload_requests, args.reload_rps, 200)), daemon=True)
        bg.start()
        time.sleep(0.5)          # load in flight before the roll starts
        roll = router.roll_reload(settle_timeout_s=30.0)
        bg.join(timeout=120.0)
        steps = {b.id: _healthz(b.url).get("model_step")
                 for b in view.poll()}
        reload_ = reload_section(load_out, roll, steps, n)
        print(f"PHASE reload ok={reload_['ok']} rolled={roll} "
              f"steps={steps} load_5xx={load_out.get('failed_5xx')}",
              flush=True)

        # -- hedge: p99 with and without hedging, a pulsing straggler ---
        stall = {"stop": False}
        straggler = replicas[0].proc

        def _pulse():
            while not stall["stop"]:
                if straggler.poll() is not None:
                    return
                os.kill(straggler.pid, signal.SIGSTOP)
                time.sleep(0.4)
                os.kill(straggler.pid, signal.SIGCONT)
                time.sleep(0.6)

        pulser = threading.Thread(target=_pulse, daemon=True)
        pulser.start()
        try:
            router.hedge_s = 0.0
            no_hedge = load(args.hedge_requests, args.hedge_rps, 300)
            hedges_before = router.counters["hedges"]
            router.hedge_s = args.hedge_s
            hedged = load(args.hedge_requests, args.hedge_rps, 300)
        finally:
            stall["stop"] = True
            pulser.join(timeout=5.0)
            if straggler.poll() is None:
                os.kill(straggler.pid, signal.SIGCONT)
        hedge = hedge_section(no_hedge, hedged,
                              router.counters["hedges"] - hedges_before,
                              router.counters, args.hedge_s)
        print(f"PHASE hedge ok={hedge['ok']} p99 "
              f"{hedge['p99_no_hedge_ms']}ms -> {hedge['p99_hedge_ms']}ms "
              f"ratio={hedge['p99_ratio']} hedges={hedge['hedges']}",
              flush=True)
        finish_artifact(art, bitwise, kill, reload_, hedge,
                        dict(router.counters), view.ejections)
    finally:
        try:
            router.stop()
        except Exception:
            pass
        for rep in replicas.values():
            rep.stop()
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(art, indent=1))
    print(f"WROTE {out} ok={art['ok']}")
    if not art["ok"]:
        for rid, rep in replicas.items():
            print(f"== replica_{rid} ==\n{rep.log()[-2000:]}")
    return 0 if art["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
