"""Prometheus text exposition for metrics snapshots, plus a stdlib
``http.server`` thread to serve it.  A copy of the JAX package's
``obs/export.py``.

``prometheus_text`` renders a ``ServingMetrics.snapshot()`` dict — any
schema version ``from_snapshot`` accepts — into the Prometheus text
format: counters as ``<prefix>_<name>_total``, gauges and peaks as
gauges, and each ``latency`` log2 histogram as a native Prometheus
histogram with *cumulative* ``le`` buckets (upper bound = the log2
bucket's inclusive upper bound, plus the mandatory ``+Inf``).

``MetricsServer`` is the ``launch/serve.py --metrics-port`` backend: a
daemon-threaded ``ThreadingHTTPServer`` answering ``GET /metrics``
with whatever the render callable returns at scrape time.  Zero
third-party dependencies, per the repo rule.
"""
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List

from .hist import LogHistogram, bucket_upper


def _line(out: List[str], name: str, value, labels: str = "") -> None:
    out.append(f"{name}{labels} {value}")


def prometheus_text(snapshot: Dict, *, prefix: str = "argus") -> str:
    """Render a metrics snapshot in Prometheus text exposition format."""
    out: List[str] = []
    kind = snapshot.get("kind", "unknown")
    lab = f'{{engine="{kind}"}}'

    out.append(f"# TYPE {prefix}_capacity gauge")
    _line(out, f"{prefix}_capacity", snapshot.get("capacity", 0), lab)

    for name, value in sorted(snapshot.get("counters", {}).items()):
        m = f"{prefix}_{name}_total"
        out.append(f"# TYPE {m} counter")
        _line(out, m, value, lab)
    for group, suffix in (("gauges", ""), ("peaks", "_peak")):
        for name, value in sorted(snapshot.get(group, {}).items()):
            m = f"{prefix}_{name}{suffix}"
            out.append(f"# TYPE {m} gauge")
            _line(out, m, value, lab)

    for name, payload in sorted(snapshot.get("latency", {}).items()):
        h = LogHistogram.from_dict(payload)
        m = f"{prefix}_{name}"
        out.append(f"# TYPE {m} histogram")
        cum = 0
        for i, c in enumerate(h.counts):
            if not c:
                continue
            cum += c
            _line(out, f"{m}_bucket",
                  cum, f'{{engine="{kind}",le="{bucket_upper(i)}"}}')
        _line(out, f"{m}_bucket", cum, f'{{engine="{kind}",le="+Inf"}}')
        _line(out, f"{m}_sum", h.total, lab)
        _line(out, f"{m}_count", cum, lab)
    return "\n".join(out) + "\n"


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - http.server API
        if self.path.rstrip("/") not in ("", "/metrics"):
            self.send_error(404)
            return
        body = self.server.render().encode()  # type: ignore[attr-defined]
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr noise
        pass


class MetricsServer:
    """Serve ``render()`` at ``/metrics`` from a daemon thread."""

    def __init__(self, render: Callable[[], str], *, port: int = 0,
                 host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.render = render  # type: ignore[attr-defined]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-server", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
