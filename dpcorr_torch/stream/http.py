"""HTTP front end for one :class:`~dpcorr_torch.stream.service.StreamService`.

Counterpart of ``dpcorr/stream/http.py``, with its routes, bodies and
status codes.

Same conventions as the serve stack's front end (serve/server.py):
JSON bodies, typed refusals with distinct status codes (400 invalid /
late, 429 overload with ``Retry-After``, 500 with the exception type),
Prometheus ``/metrics`` off the same registry as ``/stats``, and the
fleet's ``POST /obs/trigger`` hook validated against the recorder's
append-only reason registry.

Routes:

- ``POST /ingest`` — ``{"batch_id", "ts", "rows": [[x, y], ...]}``;
  the 200 ack carries the WAL seq and any windows this batch's
  watermark advance released. Empty ``rows`` is the watermark
  heartbeat / flush form.
- ``GET /releases?since=N`` — journal entries with
  ``release_seq > N`` (the polling subscribe feed).
- ``GET /stats``, ``GET /metrics``, ``GET /healthz``.
- ``POST /obs/trigger`` — arm/dump the flight recorder remotely.
"""

from __future__ import annotations

import json
from urllib.parse import parse_qs, urlparse

from dpcorr_torch.obs import recorder as obs_recorder
from dpcorr_torch.obs.metrics import CONTENT_TYPE as _PROM_CONTENT_TYPE
from dpcorr_torch.stream.service import StreamOverloadedError, StreamService
from dpcorr_torch.stream.windows import LateRecordError

__all__ = ["make_stream_http_server"]


def make_stream_http_server(service: StreamService,
                            host: str = "127.0.0.1", port: int = 8324):
    """Build (not start) the threaded HTTP front end; the caller owns
    ``serve_forever`` / ``shutdown`` so tests can run it on a thread."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict,
                  headers: tuple = ()) -> None:
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            for name, value in headers:
                self.send_header(name, value)
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

        @staticmethod
        def _retry_after(e) -> tuple:
            ra = getattr(e, "retry_after_s", None)
            if ra is None:
                return ()
            secs = max(1, int(ra) + (1 if ra % 1 else 0))
            return (("Retry-After", str(secs)),)

        def do_GET(self):  # noqa: N802 (stdlib handler casing)
            url = urlparse(self.path)
            if url.path == "/stats":
                self._send(200, service.stats())
            elif url.path == "/metrics":
                self._send_text(200, service.render_metrics(),
                                _PROM_CONTENT_TYPE)
            elif url.path == "/healthz":
                self._send(200, {"ok": True})
            elif url.path == "/releases":
                try:
                    since = int(parse_qs(url.query).get(
                        "since", ["0"])[0])
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                    return
                self._send(200, {"releases": service.releases(since)})
            else:
                self._send(404, {"error": f"no route {url.path}"})

        def do_POST(self):  # noqa: N802
            if self.path == "/obs/trigger":
                self._send(*obs_recorder.http_trigger(self))
                return
            if self.path != "/ingest":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length))
                batch_id = str(body["batch_id"])
                ts = float(body["ts"])
                rows = body.get("rows") or []
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._send(400, {"error": f"invalid ingest body: {e}"})
                return
            try:
                ack = service.ingest(batch_id, ts, rows)
            except StreamOverloadedError as e:
                self._send(429, {"error": str(e), "refused": "overload"},
                           headers=self._retry_after(e))
            except LateRecordError as e:
                self._send(400, {"error": str(e), "refused": "late",
                                 "watermark": e.watermark})
            except (TypeError, ValueError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
            else:
                self._send(200, ack)

        def log_message(self, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)
