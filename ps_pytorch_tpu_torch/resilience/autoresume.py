"""Crash auto-resume + preemption handling: the JAX package's
``resilience/autoresume.py``.

Two recovery paths:

- :class:`PreemptionGuard` — a SIGTERM/SIGINT flag the step loop polls.
  Preemption (by most cluster schedulers) delivers SIGTERM with a
  grace window; the handler only sets a flag, and the trainer writes an
  EMERGENCY checkpoint at the next step boundary — signal handlers must
  not serialize state.
- :func:`run_with_auto_resume` — the trainer-level restart loop: build a
  trainer, train; on a crash (injected or real), rebuild it — the
  constructor's resume path restores from the latest VALID checkpoint
  (runtime/checkpoint.latest_valid_step) — and continue, up to
  ``max_restarts`` times. The factory should thread ONE FaultInjector
  through every rebuild so once-only injected faults stay fired.
"""

import signal
import threading
from typing import Callable, Tuple, Type

from ps_pytorch_tpu_torch.resilience.faults import InjectedCrash


class PreemptionGuard:
    """Flag-setting signal handler, installable only from the main thread
    (signal.signal raises elsewhere — install() degrades to inert then,
    and trigger() still works for tests/manual drills)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.triggered = False
        self._prev = {}

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev.clear()

    def _handle(self, signum, frame) -> None:
        self.triggered = True

    def trigger(self) -> None:
        self.triggered = True


def run_with_auto_resume(make_trainer: Callable[[], object],
                         max_restarts: int = 2,
                         exceptions: Tuple[Type[BaseException], ...]
                         = (InjectedCrash,)):
    """Train to completion across crashes. Returns the final ``train()``
    result. ``exceptions`` bounds what counts as recoverable — by default
    only injected crashes; pass ``(InjectedCrash, RuntimeError)`` etc. to
    also ride out real ones. Exceeding ``max_restarts`` re-raises.
"""
    restarts = 0
    while True:
        trainer = make_trainer()
        try:
            return trainer.train()
        except exceptions as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            print(f"CRASH {type(e).__name__}: {e} — auto-resume "
                  f"{restarts}/{max_restarts} from latest valid checkpoint")
