"""Metrics exposition: Prometheus text format, JSON snapshot, HTTP server.

Three ways out of the process for :mod:`repro_torch.obs.metrics` state
(port of ``repro.obs.exposition``):

  * :func:`prometheus_text` — the Prometheus text exposition format
    (``# TYPE`` headers, ``name{label="v"} value`` samples, histograms as
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``).
    Dotted metric names map to underscores (``plan_cache.hits`` ->
    ``plan_cache_hits``); the dotted form stays canonical everywhere else.
  * :func:`dump_metrics` — write a file; ``.json`` suffix gets the JSON
    snapshot, anything else the Prometheus text.
  * :func:`start_metrics_server` — a stdlib ``http.server`` on a daemon
    thread serving ``/metrics`` (Prometheus text) and ``/metrics.json``
    (JSON snapshot), for scraping a live server
    (``launch.serve --metrics-port``).

All three read through :meth:`MetricsRegistry.collect`, so collector-fed
sources (plan cache, KV pool) are pulled fresh at exposition time.
"""

from __future__ import annotations

import json
import re
import threading

from .metrics import REGISTRY

__all__ = [
    "prometheus_text",
    "parse_prometheus_text",
    "dump_metrics",
    "start_metrics_server",
]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_labels(labels: tuple, extra: tuple = ()) -> str:
    items = tuple(labels) + tuple(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


def _prom_num(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def prometheus_text(registry=None) -> str:
    """The registry's series in Prometheus text exposition format."""
    registry = REGISTRY if registry is None else registry
    lines, typed = [], set()
    for name, labels, kind, value in registry.collect():
        pname = _prom_name(name)
        if kind == "histogram":
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for edge, n in zip(value["edges"], value["counts"]):
                cum += n
                lines.append(
                    f"{pname}_bucket"
                    f"{_prom_labels(labels, (('le', _prom_num(edge)),))}"
                    f" {cum}")
            lines.append(
                f"{pname}_bucket{_prom_labels(labels, (('le', '+Inf'),))}"
                f" {value['count']}")
            lines.append(
                f"{pname}_sum{_prom_labels(labels)} {_prom_num(value['sum'])}")
            lines.append(
                f"{pname}_count{_prom_labels(labels)} {value['count']}")
        else:
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} {kind}")
            lines.append(
                f"{pname}{_prom_labels(labels)} {_prom_num(value)}")
    return "\n".join(lines) + ("\n" if lines else "")


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"           # metric name
    r"(\{[^}]*\})?"                          # optional label set
    r"\s+(NaN|[+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+|\+?Inf))$"
)


def parse_prometheus_text(text: str) -> dict:
    """Strict parse of the text exposition; raises ValueError on any line
    that is neither a comment nor a valid sample.  Returns
    ``{series_string: float}``."""
    out: dict = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i}: not a valid prometheus sample: "
                             f"{line!r}")
        name, labels, num = m.groups()
        out[name + (labels or "")] = float(num)
    return out


def dump_metrics(path, registry=None) -> None:
    """Write the registry to ``path``: ``*.json`` -> JSON snapshot,
    anything else -> Prometheus text."""
    registry = REGISTRY if registry is None else registry
    if str(path).endswith(".json"):
        with open(path, "w") as f:
            json.dump(registry.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")
    else:
        with open(path, "w") as f:
            f.write(prometheus_text(registry))


def start_metrics_server(port: int, registry=None, host: str = "127.0.0.1"):
    """Serve ``/metrics`` + ``/metrics.json`` on a daemon thread.

    Returns the ``http.server.HTTPServer`` (its ``server_port`` reports
    the bound port — pass ``port=0`` for an ephemeral one; call
    ``shutdown()`` to stop).
    """
    import http.server

    registry = REGISTRY if registry is None else registry

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            if self.path.split("?")[0] == "/metrics":
                body = prometheus_text(registry).encode()
                ctype = "text/plain; version=0.0.4"
            elif self.path.split("?")[0] == "/metrics.json":
                body = json.dumps(registry.snapshot(),
                                  sort_keys=True).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence per-request stderr lines
            pass

    server = http.server.HTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name=f"obs-metrics:{server.server_port}")
    thread.start()
    return server
