"""The live ops plane of a trainer: what the JAX package's ``Trainer``
(``runtime/trainer.py:67-76, 208-276, 471-516, 537-548, 584-655,
700-724``) and ``LMTrainer`` (``runtime/lm_trainer.py:184-265,
371-440``) each build inline, gathered once for the port's two trainers.

One ``OpsPlane`` a trainer, built before the train step (the
``nonfinite:skip`` watchdog decides the step's gate):

- a ``Registry`` with the training metrics, and the ``HealthMonitor`` of
  ``--health-spec``;
- a ``Tracer(pid=rank)`` installed as the ambient default until
  ``close`` (the checkpoint and coordinator spans land on it), written as
  a Chrome trace to ``--trace-file`` (``<path>.p<rank>`` on rank > 0);
- the ``FlightRecorder``, armed by ``--flight-file``, or at
  ``<train_dir>/flightrec.json`` when a health spec or an exporter is
  on; rank i > 0 writes ``<path>.p<i>``;
- the ``MetricsExporter`` on ``--metrics-port`` + rank, its memory
  gauges, the resilience counters when a fault or retry plane is on
  (``resilience``: the live snapshot) and the replicated KV's counters
  and gauges (``kvrep``), refreshed on every scrape;
- the cross-process timeline (``--timeline-file``, by default
  ``<metrics_file>.timeline`` when several processes run), published
  over the Coordinator's KV and merged by rank 0;
- the ``torch.profiler`` window of ``--profile-dir`` / ``--profile-steps``:
  one Chrome trace a process, with the card's kernels;
- the MFU inputs: the model's FLOPs a step at the global batch
  (``utils/flops.py``, counted once at the first step), the card's peak
  and the number of cards (the world size).

Everything here reads host values: the step loop hands over the scalars
it has already copied from the card, so the plane adds no device sync.
"""

import os
from typing import Callable, Optional

import torch

from ps_pytorch_tpu_torch.config import parse_profile_steps
from ps_pytorch_tpu_torch.telemetry import (
    FlightRecorder, HealthMonitor, MetricsExporter, Registry,
    TelemetryAggregator, Tracer, aggregate_peak_flops,
    declare_kvrep_metrics, declare_resilience_metrics,
    declare_training_metrics, derive_step_record, device_memory_record, host_rss_bytes,
    set_default_tracer, step_flops_of,
)


def _rank_path(path: str, rank: int) -> str:
    return f"{path}.p{rank}" if rank > 0 else path


class OpsPlane:
    def __init__(self, cfg, *, device: torch.device, rank: int, world: int,
                 kv=None, run_id: str = "run",
                 health_extra: Optional[Callable[[], dict]] = None,
                 resilience: Optional[Callable[[], dict]] = None,
                 kvrep=None, printer=print):
        self.cfg, self.device = cfg, torch.device(device)
        self.rank, self.world = rank, world
        self.printer = printer
        self._health_extra = health_extra or dict
        self.registry = declare_training_metrics(Registry())
        self.health: Optional[HealthMonitor] = (
            HealthMonitor(cfg.health_spec, registry=self.registry)
            if cfg.health_spec else None)
        self.tracer = Tracer(pid=rank)
        flight = cfg.flight_file or (
            os.path.join(cfg.train_dir, "flightrec.json")
            if cfg.health_spec or cfg.metrics_port > 0 else "")
        self.flightrec: Optional[FlightRecorder] = (
            FlightRecorder(_rank_path(flight, rank), tracer=self.tracer,
                           registry=self.registry) if flight else None)
        # MFU: the count is taken at the first step; the peak is None off
        # CUDA and for a card the peak table does not know.
        self.flops_per_step: Optional[int] = None
        self.peak_per_chip = aggregate_peak_flops(self.device)
        self.n_chips = world
        timeline = cfg.timeline_file or (
            f"{cfg.metrics_file}.timeline"
            if world > 1 and cfg.metrics_file else "")
        self.timeline: Optional[TelemetryAggregator] = None
        if timeline:
            self.timeline = TelemetryAggregator(kv, rank, world,
                                                run_id=run_id)
            if rank == 0:
                self.timeline.open_timeline(timeline)
        self._window = (parse_profile_steps(cfg.profile_steps)
                        if cfg.profile_dir else None)
        self._profiler = None
        self.profile_files: list = []
        self.exporter: Optional[MetricsExporter] = None
        if cfg.metrics_port > 0:
            collect = [self.update_memory_gauges]
            if resilience is not None:
                # The fault and retry counters reach the scrape endpoint
                # too: each render refreshes them from the live snapshots.
                declare_resilience_metrics(self.registry)
                collect.append(lambda: self._pump(resilience()))
            if kvrep is not None:
                # The replicated KV's health on the same endpoint: quorum
                # failures, ejections, rejoins, healthy backends.
                declare_kvrep_metrics(self.registry)
                collect.append(lambda: self.pump_kvrep_metrics(kvrep))
            self.exporter = MetricsExporter(
                self.registry, port=cfg.metrics_port + rank,
                health_fn=self.health_status, collect=collect).start()
        self._mem: dict = {}
        # Last: a port already taken raises above with nothing installed.
        self._prev_tracer = set_default_tracer(self.tracer)

    @property
    def skip_nonfinite(self) -> bool:
        return self.health is not None and self.health.skip_nonfinite

    @property
    def should_halt(self) -> bool:
        return self.health is not None and self.health.should_halt

    def health_status(self) -> dict:
        """The /healthz body: the watchdogs' state (the stall detector is
        evaluated here, on the exporter's thread) and who answers."""
        body = (self.health.status() if self.health is not None
                else {"ok": True})
        body["process_index"] = self.rank
        body.update(self._health_extra())
        return body

    def _pump(self, snapshot: dict) -> None:
        """Counters up to a snapshot's values (registry counters only
        rise; the snapshots are the source of truth)."""
        for name, value in snapshot.items():
            try:
                delta = value - self.registry.get(name)
            except KeyError:
                continue            # a snapshot key with no declared metric
            if delta > 0:
                self.registry.inc(name, delta)

    def pump_kvrep_metrics(self, kvrep) -> None:
        """``kvrep_*`` counters up to a ``ReplicatedKV``'s snapshot and
        its health gauges set (the JAX trainer's
        ``_pump_kvrep_metrics``)."""
        self._pump(kvrep.snapshot())
        for name, value in kvrep.gauges().items():
            try:
                self.registry.set(name, value)
            except KeyError:
                continue            # a gauge with no declared metric

    # ---- the step loop's calls ----
    def count_flops(self) -> None:
        """The model's FLOPs a step at the global batch, once, before the
        first step is timed (an MoE LM in one capacity group a rank, as
        ep dispatches it)."""
        if self.flops_per_step is None:
            self.flops_per_step = step_flops_of(self.cfg, groups=self.world)

    def profile_step(self, step: int) -> None:
        """Start the torch.profiler window at its first step, stop it
        after its last; by window membership, so a resumed run that starts
        inside the window still traces."""
        if self._window is None:
            return
        lo, hi = self._window
        if self._profiler is None and lo <= step <= hi:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
        elif self._profiler is not None and step > hi:
            self._stop_profile()
            self._window = None

    def _stop_profile(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)     # the window's kernels
        self._profiler.stop()
        lo, hi = self._window
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir,
                            f"trace_p{self.rank}_steps{lo}-{hi}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        self.profile_files.append(path)

    def update_memory_gauges(self) -> dict:
        """Device and host memory into the registry; the step loop calls
        it and so does every scrape. Returns the device fields."""
        mem = device_memory_record(self.device)
        if mem:
            self.registry.set("device_mem_peak_bytes",
                              mem["device_mem_peak_bytes"])
            self.registry.set("device_mem_bytes", mem["device_mem_bytes"])
        self.registry.set("host_rss_bytes", host_rss_bytes())
        return mem

    def ops_step(self, step: int, *, examples: int, loss=None,
                 grad_norm=None, nonfinite=None, step_time=None,
                 data_time=None) -> None:
        """One step's bookkeeping from host values: the registry, memory,
        the flight recorder and the watchdogs (a HEALTH line a trip)."""
        r = self.registry
        r.inc("train_steps")
        r.set("train_step", step)
        if loss is not None:
            r.set("train_loss", loss)
        if grad_norm is not None:
            r.set("train_grad_norm", grad_norm)
        if step_time is not None and step_time > 0:
            r.set("train_step_time_s", step_time)
            r.observe("train_step_latency_s", step_time)
            r.set("train_examples_per_sec", examples / step_time)
        if data_time is not None:
            r.set("train_data_time_s", data_time)
        self._mem = self.update_memory_gauges()
        if self.flightrec is not None:
            self.flightrec.record_step(step, loss=loss, grad_norm=grad_norm,
                                       step_time=step_time,
                                       data_time=data_time)
        if self.health is None:
            return
        for ev in self.health.observe_step(
                step, loss=loss, grad_norm=grad_norm, nonfinite=nonfinite,
                step_time=step_time):
            if self.flightrec is not None:
                self.flightrec.record_health(ev)
            self.printer(f"HEALTH {ev.detector} ({ev.action}): "
                         f"{ev.message}")

    def derived(self, *, step_time: float, data_time: float, examples: int,
                tokens: Optional[int] = None) -> dict:
        """The JSONL / STEP line's derived fields of the step just
        observed, with its memory fields."""
        rec = derive_step_record(
            step_time_s=step_time, data_time_s=data_time, examples=examples,
            tokens=tokens, flops_per_step=self.flops_per_step,
            peak_flops_per_chip=self.peak_per_chip, n_chips=self.n_chips,
            with_memory=False)
        rec.update(self._mem)
        return rec

    def publish_step(self, step: int, step_time: float, data_time: float,
                     resilience: Optional[dict] = None) -> None:
        """This process's timeline row (with the resilience counters when
        a plane is on); rank 0 merges what has landed."""
        if self.timeline is None:
            return
        rec = {"step_time": round(step_time, 6),
               "data_time": round(data_time, 6),
               "phases": self.tracer.step_summary(step)}
        if resilience:
            rec["resilience"] = resilience
        self.timeline.publish_step(step, rec)
        self.timeline.drain_to_file()

    def halt(self, step: int, checkpoint: Callable[[int], object]) -> None:
        """The halt action: commit a checkpoint (``checkpoint(step)``),
        dump the flight recorder with reason ``watchdog:<detector>``,
        print the HEALTH halt line."""
        ev = self.health.halt_event
        with self.tracer.span("checkpoint", step=step):
            checkpoint(step)
        if self.flightrec is not None:
            self.flightrec.dump(f"watchdog:{ev.detector}",
                                extra={"halt": ev.to_dict()})
        self.printer(f"HEALTH halt at step {step}: {ev.message}")

    def crash(self, e: BaseException) -> None:
        """Dump the flight recorder while an exception is in flight."""
        if self.flightrec is not None:
            self.flightrec.record_event(
                "exception", {"type": type(e).__name__, "message": str(e)})
            self.flightrec.dump(f"crash:{type(e).__name__}")

    def close(self, final_step: int) -> None:
        """Stop the exporter and the profiler, write the Chrome trace,
        close the timeline and put back the previous default tracer."""
        try:
            if self.exporter is not None:
                self.exporter.stop()
            if self._profiler is not None:
                self._stop_profile()
            if self.cfg.trace_file:
                self.tracer.write_chrome_trace(
                    _rank_path(self.cfg.trace_file, self.rank))
            if self.timeline is not None:
                self.timeline.close(
                    final_step=final_step if self.rank == 0 else None)
        finally:
            set_default_tracer(self._prev_tracer)
