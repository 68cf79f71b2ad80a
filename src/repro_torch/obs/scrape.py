"""HTTP scrape endpoint for the live metrics registry.

The port's copy of ``repro.obs.scrape``, pure Python: the same events, series
and bytes as the reference's for the same inputs.

Serves a :class:`~repro_torch.obs.metrics.MetricsRegistry` over localhost HTTP
for the duration of a run:

  * ``GET /metrics`` — Prometheus text exposition
    (:meth:`MetricsRegistry.prometheus`), the format every scraper
    understands;
  * ``GET /metrics.json`` — the registry's canonical JSON snapshot
    (:meth:`MetricsRegistry.to_json`), for ad-hoc ``curl | jq``.

The server runs on a daemon thread (one ``ThreadingHTTPServer``), so a
serving run never blocks on a slow scraper and exits without waiting for
open connections. Gauges read their callbacks at scrape time — a scrape
mid-run observes the runtime's *live* state, which is exactly the point:
the snapshot files (``--metrics-out``) are for replay-stable artifacts,
this endpoint is for watching a run happen.

Scrapes are read-only against runtime objects mutated by the main
thread; values may be mid-update-torn across series (a scrape is not a
transaction), the standard Prometheus contract.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def merge_prom_texts(texts) -> str:
    """Concatenate Prometheus text expositions into one scrape body.

    ``# HELP`` / ``# TYPE`` header lines are deduplicated by metric name
    (first exposition wins) — a federated scrape merges the controller's
    registry with follower registries that expose the same series under
    different ``worker`` labels, and repeating the headers per process
    would be invalid exposition.
    """
    lines = []
    seen = set()
    for text in texts:
        for line in text.splitlines():
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                parts = line.split(" ", 3)
                key = (parts[1], parts[2])
                if key in seen:
                    continue
                seen.add(key)
            if line:
                lines.append(line)
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Daemon-threaded HTTP server over one metrics registry.

    ``port=0`` binds an ephemeral port; :meth:`start` returns the port
    actually bound. ``deterministic=False`` by default — the endpoint
    reports live values including wall-clock-derived ones; pass True to
    serve the replay-stable view instead.
    """

    def __init__(self, registry, *, port: int = 0,
                 host: str = "127.0.0.1", deterministic: bool = False):
        if registry is None:
            raise ValueError("MetricsServer needs a MetricsRegistry")
        self.registry = registry
        self.host = host
        self.port = int(port)
        self.deterministic = deterministic
        self.scrapes = 0
        # Federated view: wid -> that follower's latest Prometheus text,
        # refreshed by the serving loop at sync boundaries (the scrape
        # thread only READS this cache — it must never issue transport
        # RPCs itself, the socket protocol is single-threaded lockstep).
        self.fleet = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def update_fleet(self, wid: int, prom_text: str) -> None:
        """Cache one follower's scraped registry for /metrics merging."""
        if prom_text:
            self.fleet[int(wid)] = prom_text

    def render(self) -> str:
        """The merged exposition /metrics serves: own registry first,
        then each cached follower exposition in ascending wid order."""
        own = self.registry.prometheus(deterministic=self.deterministic)
        if not self.fleet:
            return own
        return merge_prom_texts(
            [own] + [self.fleet[w] for w in sorted(self.fleet)])

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                          # noqa: N802
                path = self.path.split("?", 1)[0]
                if path in ("/metrics", "/"):
                    body = server.render().encode()
                    ctype = PROM_CONTENT_TYPE
                elif path == "/metrics.json":
                    body = server.registry.to_json(
                        deterministic=server.deterministic).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                server.scrapes += 1
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *fmt_args):
                pass                   # scrapes are not run output

        return Handler

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        if self._httpd is not None:
            return self.port
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._handler_class())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"metrics-server-{self.port}", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def __enter__(self) -> "MetricsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
