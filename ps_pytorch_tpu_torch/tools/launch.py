#!/usr/bin/env python
"""Launcher and fleet control of the port: the JAX package's
``tools/launch.py`` for one process a replica.

- ``launch``: start one trainer process a replica, wired together by the
  env contract of ``parallel/dist.py`` (``PS_TPU_COORDINATOR``,
  ``PS_TPU_NUM_PROCESSES``, ``PS_TPU_PROCESS_ID``). There is no extra
  master rank: process 0 serves the TCPStore and leads the Coordinator.
- ``status``: liveness and the last line of each process's log.
- ``wait``: block until every process exits (``--timeout`` kills the
  fleet); ok when every log holds a FINAL line (an EVAL or EVAL_LM line
  for the evaluator's entry, ``ps_pytorch_tpu_torch.evaluate``, which
  prints no FINAL). A process that exits
  without one ends the wait at once and kills the rest, which would
  otherwise wait for it in a collective or for a mask, unless its log
  ends at the fault plane's ``FAULT leader_kill`` line: that death was
  asked for (``--fault-spec leader_kill:...``), and the survivors elect a
  new leader and run on.
- ``kill``: SIGTERM, then SIGKILL after ``--grace`` seconds.

:func:`run_fleet` is the same launch and wait for a tool that starts
ranks of its own (``bench``, ``bench_suite``): a temporary run dir, a
free port, the logs returned.

Host modes:

- ``--simulate N``: N local processes (ranks that share a card all-reduce
  through gloo, ``parallel/dist.py:choose_backend``).
- ``--hostfile FILE``: one host per line; process i is started on host i
  over ``ssh`` and echoes its own pid (``REMOTE_PID``) before ``exec``, so
  ``kill`` signals the trainer, not the local ssh client.

The entry is a module run with ``python -m`` (default: the port's
``train``) or a ``.py`` script, with the repository on ``PYTHONPATH``;
arguments after ``--`` go to it. Run artifacts land in ``--run-dir``:
``proc_<i>.log`` and ``procs.json``.

    python -m ps_pytorch_tpu_torch.tools.launch launch --simulate 2 \\
        --wait -- --device cpu --network LeNet --dataset synthetic_mnist \\
        --mode kofn --num-aggregate 1 --max-steps 20
"""

import argparse
import contextlib
import json
import os
import shlex
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Tuple

from ps_pytorch_tpu_torch.parallel import dist
from ps_pytorch_tpu_torch.resilience.faults import LEADER_KILL_LINE

PROCS_FILE = "procs.json"
REPO = Path(__file__).resolve().parents[2]
DEFAULT_ENTRY = "ps_pytorch_tpu_torch.train"


def free_port() -> int:
    """A TCP port free on this host now, for a local coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_fleet(entry: str, n: int, argv: List[str],
              timeout_s: float) -> Tuple[int, List[str]]:
    """``n`` local processes of ``entry`` with ``argv``, launched and
    waited for (the fleet killed at ``timeout_s``, or as soon as one
    exits without its FINAL line); -> (the wait's exit code, each
    process's log). The launcher's own lines go to stderr."""
    run_dir = tempfile.mkdtemp(prefix="fleet_")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            rc = main(["launch", "--run-dir", run_dir, "--simulate", str(n),
                       "--port", str(free_port()), "--entry", entry,
                       "--cwd", str(REPO), "--wait", "--timeout",
                       str(timeout_s), "--grace", "5", "--", *argv])
        logs = [Path(run_dir, f"proc_{r}.log").read_text(errors="replace")
                for r in range(n)]
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    return rc, logs


def _read_hostfile(path: str) -> List[str]:
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                hosts.append(line.split()[0])
    if not hosts:
        raise ValueError(f"hostfile {path} lists no hosts")
    return hosts


def _contract_env(rank: int, n: int, coordinator: str) -> dict:
    return {dist.ENV_COORD: coordinator, dist.ENV_NPROC: str(n),
            dist.ENV_PID: str(rank)}


def _env_for(rank: int, n: int, coordinator: str) -> dict:
    """This environment plus the contract, the repository first on
    ``PYTHONPATH``, and unbuffered output (a log ends where its process
    stopped)."""
    env = dict(os.environ, **_contract_env(rank, n, coordinator))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    env["PYTHONUNBUFFERED"] = "1"
    return env


def _command(entry: str, train_argv: List[str]) -> List[str]:
    if entry.endswith(".py"):
        return [sys.executable, entry, *train_argv]
    return [sys.executable, "-m", entry, *train_argv]


def cmd_launch(args, train_argv: List[str]) -> int:
    if args.devices_per_host != 1:
        raise ValueError(f"--devices-per-host {args.devices_per_host}: the "
                         "port runs one process a replica, each on one "
                         "device; launch one process a device instead")
    os.makedirs(args.run_dir, exist_ok=True)
    if args.hostfile:
        hosts: Optional[List[str]] = _read_hostfile(args.hostfile)
        n = len(hosts)
        coordinator = f"{hosts[0]}:{args.port}"
    else:
        hosts = None
        n = args.simulate
        coordinator = f"127.0.0.1:{args.port}"
    cmd = _command(args.entry, train_argv)
    records = []
    for rank in range(n):
        log_path = os.path.join(args.run_dir, f"proc_{rank}.log")
        if hosts is None:
            with open(log_path, "w") as log:
                # The child keeps its own descriptor; the parent's closes.
                p = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                     env=_env_for(rank, n, coordinator),
                                     cwd=args.cwd or None)
            records.append({"rank": rank, "host": "local", "pid": p.pid,
                            "log": log_path, "entry": args.entry})
        else:
            # Export the contract inline; `echo REMOTE_PID $$` + `exec`
            # publishes the remote trainer's own pid into the local log.
            env = dict(_contract_env(rank, n, coordinator),
                       PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
            env_args = " ".join(f"{k}={shlex.quote(v)}"
                                for k, v in env.items())
            remote = (f"cd {shlex.quote(args.cwd or '.')} && "
                      f"echo REMOTE_PID $$ && exec env {env_args} "
                      + " ".join(shlex.quote(a) for a in cmd))
            with open(log_path, "w") as log:
                p = subprocess.Popen(["ssh", "-o", "BatchMode=yes",
                                      hosts[rank], remote],
                                     stdout=log, stderr=subprocess.STDOUT)
            records.append({"rank": rank, "host": hosts[rank], "pid": p.pid,
                            "log": log_path, "entry": args.entry})
    with open(os.path.join(args.run_dir, PROCS_FILE), "w") as f:
        json.dump({"coordinator": coordinator, "n": n,
                   "hostfile": args.hostfile, "procs": records}, f, indent=1)
    print(f"LAUNCHED {n} processes (coordinator {coordinator}) -> "
          f"{args.run_dir}", flush=True)
    if args.wait:
        return cmd_wait(args)
    return 0


def _load_procs(run_dir: str) -> dict:
    with open(os.path.join(run_dir, PROCS_FILE)) as f:
        return json.load(f)


def _alive(pid: int) -> bool:
    # Reap this pid if it is our exited child (else it lingers as a
    # zombie that os.kill(pid, 0) reports alive); never waitpid(-1), which
    # would take other children's exit statuses.
    try:
        os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        pass
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    try:  # a zombie that another parent has not reaped counts as dead
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(") ", 1)[1].split()[0]
        return state != "Z"
    except (OSError, IndexError):
        return True


def _last_progress_line(log: str, width: Optional[int] = 120) -> str:
    try:
        with open(log, "rb") as f:
            tail = f.read()[-4096:].decode(errors="replace").splitlines()
        for line in reversed(tail):
            if line.strip():
                line = line.strip()
                return line[-width:] if width else line
    except OSError:
        pass
    return "<no output>"


def _has_final(record: dict) -> bool:
    """True when the process's log holds its entry's closing line: FINAL,
    or the evaluator's EVAL / EVAL_LM line."""
    entry = record.get("entry", DEFAULT_ENTRY)
    done = ("EVAL",) if entry.endswith("evaluate") else ("FINAL",)
    try:
        with open(record["log"], errors="replace") as f:
            return any(line.startswith(done) for line in f)
    except OSError:
        return False


def _killed_by_fault(path: str) -> bool:
    """True when the log's last line is the fault plane's ``FAULT
    leader_kill`` line: the process SIGKILLed itself on purpose."""
    return _last_progress_line(path, width=None).startswith(
        LEADER_KILL_LINE)


def cmd_status(args) -> int:
    meta = _load_procs(args.run_dir)
    n_alive = 0
    for r in meta["procs"]:
        alive = _alive(r["pid"])
        n_alive += alive
        print(f"rank {r['rank']} host {r['host']} pid {r['pid']} "
              f"{'ALIVE' if alive else 'EXITED'}  "
              f"{_last_progress_line(r['log'])}")
    print(f"STATUS {n_alive}/{meta['n']} alive")
    return 0 if n_alive == meta["n"] else 1


def cmd_wait(args) -> int:
    """Block until every process exits. 0 when every log holds a FINAL
    line; 1 when one does not (the rest of the fleet is killed as soon as
    such a process exits, unless its log ends at the ``FAULT leader_kill``
    line); 2 at ``--timeout`` (the fleet is killed)."""
    meta = _load_procs(args.run_dir)
    deadline = time.monotonic() + args.timeout if args.timeout else None
    while True:
        alive = [_alive(r["pid"]) for r in meta["procs"]]
        failed = [r["rank"] for r, a in zip(meta["procs"], alive)
                  if not a and not _has_final(r)
                  and not _killed_by_fault(r["log"])]
        if failed and any(alive):
            print(f"WAIT rank {failed} exited without FINAL; killing fleet",
                  file=sys.stderr, flush=True)
            cmd_kill(args)
            break
        if not any(alive):
            break
        if deadline and time.monotonic() > deadline:
            print("WAIT timeout; killing fleet", file=sys.stderr, flush=True)
            cmd_kill(args)
            return 2
        time.sleep(0.2)
    ok = all(_has_final(r) for r in meta["procs"])
    print(f"DONE ok={ok}", flush=True)
    return 0 if ok else 1


def _remote_pid(record: dict) -> Optional[int]:
    """The remote trainer's own pid, from the 'REMOTE_PID <n>' line its
    launch wrapper echoed into the local log."""
    try:
        with open(record["log"]) as f:
            for line in f:
                if line.startswith("REMOTE_PID "):
                    return int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    return None


def cmd_kill(args) -> int:
    meta = _load_procs(args.run_dir)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        any_alive = False
        for r in meta["procs"]:
            # r["pid"] is the liveness proxy either way: over ssh it is the
            # local client, which exits when the remote command does.
            if not _alive(r["pid"]):
                continue
            any_alive = True
            if r["host"] != "local":
                rpid = _remote_pid(r)
                if rpid is not None:
                    cmd = f"kill -{int(sig)} {rpid}"
                else:
                    cmd = (f"pkill -{int(sig)} -f "
                           f"{shlex.quote(r.get('entry', DEFAULT_ENTRY))}")
                subprocess.run(["ssh", "-o", "BatchMode=yes", r["host"], cmd],
                               capture_output=True)
            else:
                try:
                    os.kill(r["pid"], sig)
                except ProcessLookupError:
                    pass
        if not any_alive:
            break
        deadline = time.monotonic() + args.grace
        while time.monotonic() < deadline and any(
                _alive(r["pid"]) for r in meta["procs"]):
            time.sleep(0.1)
    print("KILLED", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pl = sub.add_parser("launch", help="start a multi-process training job")
    pl.add_argument("--run-dir", default="./launch_run")
    pl.add_argument("--hostfile", default="",
                    help="one host per line; default: simulate locally")
    pl.add_argument("--simulate", type=int, default=2,
                    help="local process count when no hostfile is given")
    pl.add_argument("--devices-per-host", type=int, default=1,
                    help="must be 1: one process a replica")
    pl.add_argument("--port", type=int, default=12355)
    pl.add_argument("--entry", default=DEFAULT_ENTRY,
                    help="module (run with -m) or .py script")
    pl.add_argument("--cwd", default="")
    pl.add_argument("--wait", action="store_true")
    pl.add_argument("--timeout", type=float, default=0.0)
    pl.add_argument("--grace", type=float, default=3.0)

    for name in ("status", "wait", "kill"):
        ps = sub.add_parser(name)
        ps.add_argument("--run-dir", default="./launch_run")
        ps.add_argument("--timeout", type=float, default=0.0)
        ps.add_argument("--grace", type=float, default=3.0)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--" in argv:
        i = argv.index("--")
        argv, train_argv = argv[:i], argv[i + 1:]
    else:
        train_argv = []
    args = build_parser().parse_args(argv)
    if args.cmd == "launch":
        return cmd_launch(args, train_argv)
    return {"status": cmd_status, "wait": cmd_wait,
            "kill": cmd_kill}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
