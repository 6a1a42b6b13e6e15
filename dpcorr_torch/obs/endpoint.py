"""Mini observability endpoint for processes without a front end of their
own: the stream service's ``--obs-port`` and a federation party.

Counterpart of ``dpcorr/obs/endpoint.py``: a tiny threaded HTTP server
bound to ``--obs-port`` serving exactly the scrape routes a serve
instance carries, off whatever metrics registry and stats callable the
host process hands it. It imports no torch.

Routes (byte-compatible with the serve front end's):

- ``GET /metrics`` — Prometheus text exposition of the registry.
- ``GET /stats``  — the host's JSON snapshot (``stats_fn()``).
- ``GET /healthz`` — liveness.
- ``POST /obs/trigger`` — validate the reason against the recorder's
  append-only registry and dump THIS process's flight recorder.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dpcorr_torch.obs import recorder as obs_recorder
from dpcorr_torch.obs.metrics import CONTENT_TYPE, Registry


def make_obs_server(registry: Registry, stats_fn=None,
                    host: str = "127.0.0.1", port: int = 0):
    """Build (not start) the endpoint; returns the
    ``ThreadingHTTPServer`` (``.server_address[1]`` is the bound port —
    pass ``port=0`` for an ephemeral one)."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            blob = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def _send_text(self, code: int, text: str,
                       content_type: str) -> None:
            blob = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):  # noqa: N802 (stdlib handler casing)
            if self.path == "/stats":
                try:
                    doc = dict(stats_fn()) if stats_fn is not None else {}
                except Exception as e:
                    self._send(500, {"error":
                                     f"{type(e).__name__}: {e}"})
                    return
                self._send(200, doc)
            elif self.path == "/metrics":
                self._send_text(200, registry.render(), CONTENT_TYPE)
            elif self.path == "/healthz":
                self._send(200, {"ok": True})
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/obs/trigger":
                self._send(404, {"error": f"no route {self.path}"})
                return
            self._send(*obs_recorder.http_trigger(self))

        def log_message(self, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)


def start_obs_server(registry: Registry, stats_fn=None,
                     host: str = "127.0.0.1", port: int = 0):
    """Start the endpoint on a daemon thread; returns
    ``(server, bound_port)``. The caller announces the port (the party
    banner) and calls ``server.shutdown()`` on exit — or doesn't: the
    daemon thread dies with the process, which is the right lifetime
    for a scrape surface."""
    server = make_obs_server(registry, stats_fn, host=host, port=port)
    thread = threading.Thread(target=server.serve_forever,
                              name="obs-endpoint", daemon=True)
    thread.start()
    return server, server.server_address[1]
