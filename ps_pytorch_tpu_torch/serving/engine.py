"""Slot-based continuous-batching decode engine: the JAX package's
``serving/engine.py`` in PyTorch's idiom.

Requests of different lengths arrive at different times and each wants
its tokens as soon as possible. The engine owns N decode *slots*, one row
a slot of a stacked fixed-length k/v cache (``DecodeCache`` [slots, heads,
cache_len, head dim] a block, on the model's device), and every tick runs
ONE batched forward of ``[slots, 1]`` tokens, each row at its own
position (the cache's per-row form, ``models/transformer.py``). Requests
are admitted into free slots and evicted the moment their last token is
sampled, so short and long requests interleave.

A request's tokens are the port's ``models/generate.generate`` tokens for
the same prompt and seed, whatever the slot count and admission order:

- admission prefills exactly the prompt's length into a fresh one-row
  cache (``generate``'s one-shot prefill) and samples the first token
  from its last logits, then copies the row into the slot;
- every token is one ``_sample(logits[i:i+1], generator, temperature,
  top_k)`` call on the request's own ``torch.Generator`` seeded by its
  seed: the call shape and generator draws of ``generate`` for one row;
- a finished request is evicted before the forward whose logits
  ``generate`` discards.

The tick multiplies ``[slots, d]`` where ``generate`` multiplies ``[1,
d]``, and its cache is ``cache_len`` long where ``generate``'s is the
prompt plus ``n_new``: a row's logits may differ from ``generate``'s in
the last bits, as in the JAX package. The tokens are held equal.

Sampling draws from torch's generator, not threefry: greedy streams are
the JAX engine's token for token, sampled ones the port's own.

Threads: grad mode is per thread, so ``admit``, ``step`` and the weight
swap enter ``torch.no_grad()`` themselves. ``serve_loop``'s thread owns
every call on the card; ``set_params`` from another thread (the HTTP
``/admin/reload``) hands the new weights to that thread and waits until
it has copied them in between two ticks.
"""

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ps_pytorch_tpu_torch.models.generate import _sample
from ps_pytorch_tpu_torch.models.transformer import (
    DecodeCache, TransformerLM,
)
from ps_pytorch_tpu_torch.serving.reqtrace import corr_id, record_terminal
from ps_pytorch_tpu_torch.telemetry.trace import span as _span


@dataclass
class Request:
    """One generation request moving through admission → decode → done.

    ``prompt`` is int32 token ids (the byte-level LM's bytes); sampling
    params mirror ``generate()``. ``deadline_t`` is an ABSOLUTE clock value
    (queue.py sheds requests whose deadline passes before admission).
    The lifecycle fills ``tokens`` / ``state`` / the timestamps; ``wait``
    blocks a server thread until the engine resolves the request."""

    prompt: np.ndarray
    n_new: int
    temperature: float = 0.8
    top_k: int = 40
    seed: int = 0
    rid: str = ""
    deadline_t: Optional[float] = None

    # -- lifecycle (engine/queue-owned) --
    tokens: List[int] = field(default_factory=list)
    state: str = "new"       # new|queued|active|done|shed|rejected|failed
    error: str = ""
    model_step: Optional[int] = None   # checkpoint step that admitted it
    t_submit: float = 0.0
    t_enqueue: float = 0.0   # entered the admission queue
    t_admit: float = 0.0
    t_first: float = 0.0     # first token available (TTFT reference point)
    t_last: float = 0.0      # last token sampled
    t_done: float = 0.0
    tick_t: List[float] = field(default_factory=list)  # per-token sample times

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        self._event = threading.Event()
        self._resolve_lock = threading.Lock()
        # per-request sampling generator (engine-owned; generate()'s own)
        self._gen: Optional[torch.Generator] = None

    def _resolve(self, state: str, error: str = "") -> bool:
        """Terminal resolution, first-wins. The engine loop, the admission
        queue's shedder, and an HTTP wait-timeout can all race to resolve
        the same request; only the first caller may record the terminal
        reqtrace/SLO sample, so losers get False and must not record."""
        with self._resolve_lock:
            if self._event.is_set():
                return False
            self.state = state
            self.error = error
            self._event.set()
            return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request resolves (done/shed/rejected/failed)."""
        return self._event.wait(timeout)


class ServingEngine:
    """N fixed-length decode slots + one batched single-token forward.

    ``model`` is a ``TransformerLM`` holding the served weights, on the
    device the engine decodes on (its attention is ``full``: decoding
    never reaches the flash kernels). ``cache_len`` bounds
    prompt+generation per request (defaults to ``max_seq_len``, the
    positional table's length). ``registry`` is an optional telemetry
    Registry with the serving metrics declared
    (telemetry/registry.declare_serving_metrics); ``reqtrace`` an optional
    serving.reqtrace.RequestTraceLog and ``slo`` an optional
    telemetry.slo.SLOTracker — both are fed one record per terminal
    request, host-side only, never touching the sampling generators."""

    def __init__(self, model: TransformerLM, *, slots: int,
                 cache_len: int = 0, model_step: Optional[int] = None,
                 registry=None, reqtrace=None, slo=None,
                 clock: Callable[[], float] = time.monotonic):
        if slots < 1:
            raise ValueError(f"slots={slots} (need >= 1)")
        max_seq_len = model.pos_embed.embedding.shape[0]
        cache_len = int(cache_len) or int(max_seq_len)
        if cache_len > max_seq_len:
            raise ValueError(f"cache_len {cache_len} > max_seq_len "
                             f"{max_seq_len} (the positional table bounds "
                             f"decodable length)")
        self.model = model
        self.device = model.tok_embed.embedding.device
        self.slots = int(slots)
        self.vocab = int(model.vocab_size)
        self.cache_len = cache_len
        self.model_step = model_step
        self.registry = registry
        self.reqtrace = reqtrace
        self.slo = slo
        self.clock = clock
        self._lock = threading.Lock()   # guards the weights swap vs a tick
        # The stacked slot cache. Zeros are fine: a slot's row is fully
        # overwritten by its admission prefill before any tick reads it.
        self._cache = DecodeCache(model, self.slots, cache_len)

        # Host-side slot state (the scheduler; numpy, no device chatter)
        self._slot_req: List[Optional[Request]] = [None] * self.slots
        self._tok = np.zeros(self.slots, np.int64)
        self._pos = np.zeros(self.slots, np.int64)
        self.ticks = 0
        self.served = 0
        self.tokens_out = 0
        # Weights handed over by another thread, and the thread that owns
        # the card while serve_loop runs.
        self._pending: Optional[tuple] = None
        self._handed = self._swapped = 0
        self._applied = threading.Condition(self._lock)
        self._loop_thread: Optional[threading.Thread] = None

    # ---- capacity ----
    @property
    def active_count(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def free_slots(self) -> int:
        return self.slots - self.active_count

    def active_requests(self) -> List[Request]:
        return [r for r in self._slot_req if r is not None]

    @property
    def cache_bytes(self) -> int:
        """Device bytes of the stacked slot cache (k and v, every block)."""
        return sum(t.numel() * t.element_size() for b in self._cache.blocks
                   for t in (b.k, b.v))

    # ---- sampling (generate()'s _sample on the request's generator) ----
    def _draw(self, req: Request, logits_row: torch.Tensor) -> torch.Tensor:
        """The next token of ``req`` from its [1, V] logits row, as a [1]
        tensor on the device (read back by the caller)."""
        return _sample(logits_row, req._gen, req.temperature, req.top_k)

    def _record(self, req: Request, tok: int) -> None:
        now = self.clock()
        if not req.tokens:
            req.t_first = now
        req.t_last = now
        req.tick_t.append(now)
        req.tokens.append(tok)
        self.tokens_out += 1
        if self.registry is not None:
            self.registry.inc("serve_tokens")

    def _lost_race(self) -> None:
        """Count a terminal resolution that lost the first-wins CAS."""
        if self.registry is not None:
            try:
                self.registry.inc("serve_resolve_races")
            except KeyError:
                pass   # registry predates the race counter

    def _complete(self, req: Request) -> None:
        req.t_done = self.clock()
        if not req._resolve("done"):
            self._lost_race()
            return
        self.served += 1
        if self.registry is not None:
            self.registry.inc("serve_requests")
            if req.t_submit:
                self.registry.observe("serve_request_latency_s",
                                      req.t_done - req.t_submit)
                if req.t_first:
                    self.registry.observe("serve_ttft_s",
                                          req.t_first - req.t_submit)
        record_terminal(req, reqtrace=self.reqtrace, slo=self.slo,
                        now=req.t_done)

    def _fail(self, req: Request, error: str) -> None:
        """Resolve an unadmittable request as failed and record it."""
        if not req._resolve("failed", error):
            self._lost_race()
            return
        record_terminal(req, reqtrace=self.reqtrace, slo=self.slo,
                        now=self.clock())

    # ---- admission ----
    def validate(self, req: Request) -> None:
        """Request validation with friendly errors: mirrors generate()'s
        bounds plus the engine's."""
        s0 = len(req.prompt)
        if s0 == 0:
            raise ValueError("prompt must be non-empty")
        if req.n_new < 1:
            raise ValueError(f"n_new={req.n_new} (must be >= 1)")
        if req.top_k < 0:
            raise ValueError(f"top_k={req.top_k} (must be >= 0; "
                             "0 = no truncation)")
        if req.temperature < 0:
            raise ValueError(f"temperature={req.temperature} (must be >= 0; "
                             "0 = greedy)")
        if s0 and int(req.prompt.max()) >= self.vocab:
            raise ValueError(f"prompt token {int(req.prompt.max())} out of "
                             f"vocabulary ({self.vocab})")
        if s0 and int(req.prompt.min()) < 0:
            raise ValueError("prompt tokens must be >= 0")
        if s0 + req.n_new > self.cache_len:
            raise ValueError(f"prompt ({s0}) + n_new ({req.n_new}) exceeds "
                             f"the engine cache length ({self.cache_len})")

    @torch.no_grad()
    def admit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot (False when all slots busy).

        Raises ValueError for an invalid request (the caller resolves it as
        failed). The first token is sampled HERE from the prefill's last
        logits — exactly generate()'s first token — so TTFT is one prefill
        away from admission, and an ``n_new == 1`` request never occupies
        a slot at all."""
        self.validate(req)
        try:
            i = self._slot_req.index(None)
        except ValueError:
            return False
        self._apply_pending()
        with _span("serve_admit", slot=i, prompt_len=len(req.prompt),
                   n_new=req.n_new, rid=req.rid,
                   corr=corr_id(req.rid)), self._lock:
            req.t_admit = self.clock()
            if self.registry is not None and req.t_submit:
                try:
                    self.registry.observe("serve_queue_wait_s",
                                          req.t_admit - req.t_submit)
                except KeyError:
                    pass   # registry predates the queue-wait histogram
            req.state = "active"
            req.model_step = self.model_step
            s0 = len(req.prompt)
            one = DecodeCache(self.model, 1, self.cache_len)
            prompt = torch.as_tensor(req.prompt[None]).to(self.device).long()
            logits = self.model(prompt, positions=torch.arange(
                s0, device=self.device), cache=one)[:, -1]
            req._gen = torch.Generator(device=self.device).manual_seed(
                req.seed)
            tok = int(self._draw(req, logits)[0])
            self._record(req, tok)
            if req.n_new == 1:
                self._complete(req)
                return True
            for slot, row in zip(self._cache.blocks, one.blocks):
                slot.k[i].copy_(row.k[0])
                slot.v[i].copy_(row.v[0])
            self._slot_req[i] = req
            self._tok[i] = tok
            self._pos[i] = s0
        if self.registry is not None:
            self.registry.set("serve_active_slots", self.active_count)
        return True

    # ---- the tick ----
    @torch.no_grad()
    def step(self) -> List[Tuple[Request, int]]:
        """One engine tick: a single batched decode over all slots, then a
        per-active-slot sample. Returns [(request, token)] emissions;
        requests whose last token was just sampled are evicted (their slot
        is free for the NEXT admit — generate()'s discarded final forward
        is simply never run for them).

        Inactive slots decode token 0 at position 0 within their own row
        (its next admission overwrites the row); their logits are
        dropped."""
        self._apply_pending()
        live = [(i, r) for i, r in enumerate(self._slot_req) if r is not None]
        if not live:
            return []
        emissions: List[Tuple[Request, int]] = []
        with _span("serve_decode", active=len(live)) as sargs, self._lock:
            if sargs is not None:
                # every rid in this tick, for request<->engine stitching
                sargs["rids"] = [r.rid for _, r in live]
            tok = torch.as_tensor(self._tok[:, None]).to(self.device)
            pos = torch.as_tensor(self._pos[:, None]).to(self.device)
            self._cache.set_offsets(pos[:, 0])
            logits = self.model(tok, positions=pos, cache=self._cache)[:, 0]
            self.ticks += 1
            drawn = torch.cat([self._draw(req, logits[i:i + 1])
                               for i, req in live]).tolist()
            for (i, req), t in zip(live, drawn):
                self._record(req, t)
                emissions.append((req, t))
                if len(req.tokens) >= req.n_new:
                    self._slot_req[i] = None
                    self._tok[i] = self._pos[i] = 0
                    self._complete(req)
                else:
                    self._tok[i] = t
                    self._pos[i] += 1
        if self.registry is not None:
            self.registry.set("serve_active_slots", self.active_count)
        return emissions

    # ---- hot reload (serving/reload.py) ----
    def set_params(self, params: Mapping[str, torch.Tensor],
                   step: Optional[int] = None,
                   timeout_s: float = 120.0) -> None:
        """Swap the served checkpoint between ticks: ``params`` (a
        ``state_dict`` of the model's names and shapes, on any device) is
        copied INTO the model's tensors, so nothing is reallocated.
        In-flight requests keep their caches and finish under the new
        weights (their already-sampled tokens are history).

        Called on the thread that drives the engine (or with no
        ``serve_loop`` running), the copy happens now; from another
        thread, that thread copies it before its next admit or tick and
        this call waits for that."""
        own = self.model.state_dict()
        if set(params) != set(own):
            raise ValueError(f"the new weights hold {sorted(params)}, the "
                             f"model {sorted(own)}")
        for name, t in params.items():
            if tuple(t.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: new weights {tuple(t.shape)}, "
                                 f"model {tuple(own[name].shape)}")
        with self._lock:
            self._handed += 1
            ticket = self._handed
            self._pending = (params, step, ticket)
            loop = self._loop_thread
        if loop is not None and loop is not threading.current_thread() \
                and loop.is_alive():
            with self._lock:
                if not self._applied.wait_for(
                        lambda: self._swapped >= ticket, timeout_s):
                    raise TimeoutError(f"the serving loop did not take the "
                                       f"new weights in {timeout_s} s")
        else:
            self._apply_pending()

    @torch.no_grad()
    def _apply_pending(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        params, step, ticket = pending
        with _span("serve_reload", step=step), self._lock:
            for name, dst in self.model.state_dict().items():
                dst.copy_(params[name])
            if step is not None:
                self.model_step = step
            self._swapped = ticket
            self._applied.notify_all()
        if self.registry is not None:
            self.registry.inc("serve_reloads")
            if step is not None:
                self.registry.set("serve_model_step", step)

    # ---- convenience (tests / loadgen) ----
    def run_to_completion(self, requests: List[Request],
                          max_ticks: int = 100_000) -> None:
        """Drive admit+step inline until every request resolves (closed
        loop, no threads). Requests are admitted in order as slots free."""
        pending = list(requests)
        for r in pending:
            if not r.t_submit:
                r.t_submit = self.clock()
        ticks = 0
        while pending or self.active_count:
            while pending and self.free_slots:
                req = pending.pop(0)
                try:
                    self.admit(req)
                except ValueError as e:
                    self._fail(req, str(e))
            if self.active_count:
                self.step()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("run_to_completion exceeded max_ticks")


def serve_loop(engine: ServingEngine, queue, *, watcher=None,
               reload_s: float = 10.0, stop: Optional[threading.Event] = None,
               idle_wait_s: float = 0.02,
               clock: Callable[[], float] = time.monotonic,
               health=None, injector=None, registrar=None) -> None:
    """The serving drive loop (one thread): admit from the queue while slots
    are free, tick the engine while anything is active, and poll the
    checkpoint watcher every ``reload_s`` — weights swap BETWEEN ticks, so
    a reload never lands mid-decode. Runs until ``stop`` is set. This
    thread makes every call on the card while it runs.

    ``health`` (a telemetry ``HealthMonitor``) is beaten once per loop
    iteration so its stall detector watches THIS thread — a hung tick or
    a deadlocked admission path shows up in ``/healthz``.

    ``injector`` (a resilience ``FaultInjector``) gets a
    ``maybe_kill_replica`` call per iteration — the replica_kill drill's
    hook. ``registrar`` (a serving ``FleetRegistrar``) is beaten per
    iteration so the fleet lease stays fresh exactly while THIS thread is
    alive — a wedged loop goes stale in the router's view."""
    engine._loop_thread = threading.current_thread()
    try:
        _drive(engine, queue, watcher, reload_s, stop, idle_wait_s, clock,
               health, injector, registrar)
    finally:
        # Weights handed over after the last tick land before the caller
        # that handed them is released.
        engine._loop_thread = None
        engine._apply_pending()


def _drive(engine, queue, watcher, reload_s, stop, idle_wait_s, clock,
           health, injector, registrar) -> None:
    last_reload = clock()
    while stop is None or not stop.is_set():
        if health is not None:
            health.beat()
        if registrar is not None:
            registrar.beat(engine.model_step or 0)
        if injector is not None:
            injector.maybe_kill_replica(engine.served)
        engine._apply_pending()
        admitted = False
        while engine.free_slots > 0:
            req = queue.take()
            if req is None:
                break
            try:
                if engine.admit(req):
                    admitted = True
            except ValueError as e:
                engine._fail(req, str(e))
        if engine.active_count:
            engine.step()
        elif not admitted:
            # idle: resolve any expired waiters NOW (they would otherwise
            # sit un-shed until the next take), then block briefly on the
            # queue instead of spinning
            reap = getattr(queue, "reap", None)
            if reap is not None:
                reap()
            queue.wait_nonempty(idle_wait_s)
        if (watcher is not None and reload_s > 0
                and clock() - last_reload >= reload_s):
            last_reload = clock()
            got = watcher.poll()
            if got is not None:
                engine.set_params(got.params, step=got.step)
        if engine.registry is not None:
            engine.registry.set("serve_queue_depth", queue.depth())
