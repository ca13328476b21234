"""Prometheus text exposition of the telemetry Registry, and the
``--metrics-port`` exporter: a copy of the JAX package's
``telemetry/prometheus.py``.

- :func:`render` turns a Registry into exposition text (version 0.0.4):
  counters as ``<name>_total``, gauges bare, histograms as the
  ``_bucket`` / ``_sum`` / ``_count`` triple with cumulative ascending
  ``le`` labels ending in ``+Inf``. Names are sanitized to
  ``[a-zA-Z_:][a-zA-Z0-9_:]*``; two names that sanitize alike raise.
- :class:`MetricsExporter` serves ``GET /metrics`` and a JSON
  ``GET /healthz`` from a daemon ``ThreadingHTTPServer``. ``port=0``
  binds an ephemeral port; read ``.port`` after ``start()``. Its threads
  read the registry's host floats and the collect hooks' results only,
  never a tensor.
"""

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

from ps_pytorch_tpu_torch.telemetry.registry import Registry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_NAME_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Map an arbitrary registry metric name onto the Prometheus name
    charset: invalid characters become ``_``, and a leading digit gets a
    ``_`` prefix. Idempotent on already-valid names."""
    out = _NAME_BAD_CHARS.sub("_", str(name))
    if not out or not _NAME_OK.match(out):
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    """Sample-value formatting: integral floats print as integers (what the
    exposition format examples do), everything else as repr floats."""
    f = float(v)
    if f != f:          # NaN
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def render(registry: Registry,
           extra_lines: Optional[List[str]] = None) -> str:
    """Registry -> Prometheus exposition text (every declared metric, all
    three kinds). Raises ValueError when two declared names collide after
    sanitization — a collision would silently interleave two series under
    one name, which Prometheus ingests without complaint and ops then
    debugs for a day."""
    specs = registry.specs()
    snap = registry.snapshot()
    exposed: Dict[str, str] = {}      # exposition name -> registry name
    lines: List[str] = []
    for name in sorted(specs):
        spec = specs[name]
        base = sanitize_name(name)
        if spec.kind == "counter" and not base.endswith("_total"):
            base += "_total"
        prior = exposed.get(base)
        if prior is not None:
            raise ValueError(
                f"metric name collision: {name!r} and {prior!r} both expose "
                f"as {base!r}")
        exposed[base] = name
        help_ = spec.help or name
        if spec.unit:
            help_ = f"{help_} [{spec.unit}]"
        lines.append(f"# HELP {base} {_escape_help(help_)}")
        if spec.kind == "histogram":
            lines.append(f"# TYPE {base} histogram")
            summ = snap[name]
            # Per-bucket -> cumulative; the internal counts list has one
            # trailing +Inf bucket beyond the declared bounds.
            counts = registry.hist_counts(name)
            cum = 0
            for bound, c in zip(spec.buckets, counts):
                cum += c
                lines.append(f'{base}_bucket{{le="{_fmt(bound)}"}} {cum}')
            cum += counts[len(spec.buckets)]
            lines.append(f'{base}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{base}_sum {_fmt(summ['sum'])}")
            lines.append(f"{base}_count {summ['count']}")
        else:
            lines.append(f"# TYPE {base} "
                         f"{'counter' if spec.kind == 'counter' else 'gauge'}")
            lines.append(f"{base} {_fmt(snap[name])}")
    lines.extend(extra_lines or [])
    return "\n".join(lines) + "\n"


def parse_exposition(text: str) -> Dict[str, float]:
    """Minimal exposition parser: {"name{labels}": value} for every sample
    line. Used by tests and the regression tooling; raises on lines that are
    neither comments nor valid samples, so malformed output can't pass."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        if not series:
            raise ValueError(f"malformed exposition line: {line!r}")
        name = series.split("{", 1)[0]
        if not _NAME_OK.match(name):
            raise ValueError(f"invalid metric name {name!r} in {line!r}")
        out[series] = float(value)
    return out


class MetricsExporter:
    """The ``--metrics-port`` endpoint: a daemon HTTP thread serving the
    live registry as ``GET /metrics`` and a JSON ``GET /healthz``.

    ``health_fn`` supplies the /healthz body (e.g. HealthMonitor.status);
    when it reports ``{"ok": False}`` the route answers 503 so dumb HTTP
    probes (k8s livenessProbe, a router's health check) need no JSON
    parsing. ``collect`` hooks run before each render — for gauges whose
    truth lives outside the step loop (queue depths, memory watermarks).
    """

    def __init__(self, registry: Registry, host: str = "127.0.0.1",
                 port: int = 0,
                 health_fn: Optional[Callable[[], dict]] = None,
                 collect: Optional[List[Callable[[], None]]] = None):
        self.registry = registry
        self.health_fn = health_fn
        self.collect = list(collect or [])
        self._host, self._port = host, int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    # ---- request bodies (also callable without HTTP, e.g. from tests) ----
    def metrics_text(self) -> str:
        for hook in self.collect:
            try:
                hook()
            except Exception:
                pass    # a broken hook must not take /metrics down with it
        return render(self.registry)

    def health_body(self) -> dict:
        if self.health_fn is None:
            return {"ok": True}
        try:
            return dict(self.health_fn())
        except Exception as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    # ---- lifecycle ----
    def start(self) -> "MetricsExporter":
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    try:
                        text = exporter.metrics_text()
                    except Exception as e:
                        self._reply(500, f"# render error: {e}\n".encode(),
                                    CONTENT_TYPE)
                        return
                    self._reply(200, text.encode("utf-8"), CONTENT_TYPE)
                elif self.path == "/healthz":
                    body = exporter.health_body()
                    code = 200 if body.get("ok", True) else 503
                    self._reply(code, json.dumps(body).encode("utf-8"),
                                "application/json")
                else:
                    self._reply(404, b'{"error": "no route"}',
                                "application/json")

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs=dict(poll_interval=0.05),
            daemon=True, name="metrics-exporter")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
