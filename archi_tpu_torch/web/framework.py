"""Micro web framework on the stdlib (no Flask in this image).

Copy of ``archi_tpu/web/framework.py``.

The reference's service layer is Flask apps (``src/interfaces/*``).  This is
a small WSGI framework with the pieces those apps need: path-parameter
routing, JSON request/response helpers, SSE streaming responses, auth
middleware hooks, and a threaded server — all stdlib
(``wsgiref``/``http.server``-free; we implement WSGI directly over
``ThreadingHTTPServer`` for robust streaming).
"""

from __future__ import annotations

import json
import logging
import re
import threading
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterable, Optional


class Request:
    def __init__(self, method: str, path: str, query: dict, headers: dict,
                 body: bytes, path_params: Optional[dict] = None):
        self.method = method
        self.path = path
        self.query = query
        self.headers = {k.lower(): v for k, v in headers.items()}
        self.body = body
        self.path_params = path_params or {}
        self.context: dict[str, Any] = {}  # set by middleware (auth etc.)

    def json(self) -> Any:
        if not self.body:
            return {}
        return json.loads(self.body.decode("utf-8"))

    def form(self) -> dict[str, str]:
        """application/x-www-form-urlencoded body → {field: first value}
        (server-rendered pages, e.g. the grader web UI)."""
        if not self.body:
            return {}
        parsed = urllib.parse.parse_qs(
            self.body.decode("utf-8"), keep_blank_values=True)
        return {k: v[0] for k, v in parsed.items()}

    def param(self, name: str, default: Optional[str] = None) -> Optional[str]:
        if name in self.path_params:
            return self.path_params[name]
        vals = self.query.get(name)
        return vals[0] if vals else default


class Response:
    def __init__(self, body: bytes | str = b"", status: int = 200,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[dict] = None):
        self.body = body.encode() if isinstance(body, str) else body
        self.status = status
        self.headers = {"Content-Type": content_type, **(headers or {})}
        self.stream: Optional[Iterable[bytes]] = None


def json_response(data: Any, status: int = 200) -> Response:
    return Response(json.dumps(data, default=str), status,
                    "application/json")


def error_response(message: str, status: int = 400) -> Response:
    return json_response({"error": message}, status)


def sse_response(events: Iterable[dict | str]) -> Response:
    """Server-sent-events stream: each item becomes a ``data:`` frame
    (reference streaming endpoints, ``chat_app/app.py:3525``)."""
    def gen():
        try:
            for ev in events:
                data = ev if isinstance(ev, str) \
                    else json.dumps(ev, default=str)
                yield f"data: {data}\n\n".encode()
        except Exception as e:  # surface mid-stream failures to the client
            logging.getLogger("archi_tpu_torch.web").error(
                "stream error:\n%s", traceback.format_exc())
            err = json.dumps({"type": "error",
                              "error": f"{type(e).__name__}: {e}"})
            yield f"data: {err}\n\n".encode()
        yield b"data: [DONE]\n\n"

    resp = Response(status=200, content_type="text/event-stream",
                    headers={"Cache-Control": "no-cache",
                             "X-Accel-Buffering": "no"})
    resp.stream = gen()
    return resp


class Router:
    def __init__(self):
        self._routes: list[tuple[str, re.Pattern, Callable]] = []
        self.middleware: list[Callable[[Request], Optional[Response]]] = []

    def route(self, method: str, pattern: str):
        """Patterns use <name> path params: /api/trace/<trace_id>."""
        regex = re.compile(
            "^" + re.sub(r"<([a-zA-Z_]+)>", r"(?P<\1>[^/]+)", pattern) + "$"
        )

        def deco(fn):
            self._routes.append((method.upper(), regex, fn))
            return fn

        return deco

    def get(self, pattern):
        return self.route("GET", pattern)

    def post(self, pattern):
        return self.route("POST", pattern)

    def put(self, pattern):
        return self.route("PUT", pattern)

    def delete(self, pattern):
        return self.route("DELETE", pattern)

    def dispatch(self, request: Request) -> Response:
        for mw in self.middleware:
            early = mw(request)
            if early is not None:
                return early
        path_matched = False
        for method, regex, fn in self._routes:
            m = regex.match(request.path)
            if not m:
                continue
            path_matched = True
            if method != request.method:
                continue
            request.path_params = m.groupdict()
            try:
                result = fn(request)
            except PermissionError as e:
                return error_response(str(e), 403)
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                return error_response(f"{type(e).__name__}: {e}", 400)
            except Exception as e:
                # full traceback to the server log, type+message to clients
                logging.getLogger("archi_tpu_torch.web").error(
                    "unhandled error on %s %s:\n%s", request.method,
                    request.path, traceback.format_exc(),
                )
                return error_response(f"{type(e).__name__}: {e}", 500)
            if isinstance(result, Response):
                return result
            return json_response(result)
        if path_matched:
            return error_response("method not allowed", 405)
        return error_response("not found", 404)


class App:
    def __init__(self, name: str = "app"):
        self.name = name
        self.router = Router()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # route decorators proxy to the router
    def get(self, p):
        return self.router.get(p)

    def post(self, p):
        return self.router.post(p)

    def put(self, p):
        return self.router.put(p)

    def delete(self, p):
        return self.router.delete(p)

    def use(self, middleware: Callable[[Request], Optional[Response]]):
        self.router.middleware.append(middleware)

    # ------------------------------------------------------------- serving
    def _make_handler(self):
        router = self.router

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _handle(self):
                parsed = urllib.parse.urlparse(self.path)
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                request = Request(
                    method=self.command,
                    path=parsed.path,
                    query=urllib.parse.parse_qs(parsed.query),
                    headers=dict(self.headers.items()),
                    body=body,
                )
                resp = router.dispatch(request)
                if resp.stream is not None:
                    self.send_response(resp.status)
                    for k, v in resp.headers.items():
                        self.send_header(k, v)
                    self.send_header("Connection", "close")
                    self.end_headers()
                    try:
                        for chunk in resp.stream:
                            self.wfile.write(chunk)
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                    self.close_connection = True
                else:
                    self.send_response(resp.status)
                    for k, v in resp.headers.items():
                        self.send_header(k, v)
                    self.send_header("Content-Length", str(len(resp.body)))
                    self.end_headers()
                    self.wfile.write(resp.body)

            do_GET = do_POST = do_PUT = do_DELETE = _handle

            def log_message(self, *args):
                pass

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              *, background: bool = False) -> int:
        # socketserver's default listen backlog is 5: a burst of
        # concurrent clients (the serving benchmarks open 256 sockets at
        # once; production front-ends reconnect in thundering herds) gets
        # connection resets before a single request is read.  Deepen the
        # accept queue to the ThreadingHTTPServer's real concurrency.
        srv_cls = type("DeepBacklogHTTPServer", (ThreadingHTTPServer,),
                       {"request_queue_size": 512})
        self._server = srv_cls((host, port), self._make_handler())
        actual_port = self._server.server_address[1]
        if background:
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True,
                name=f"{self.name}-server",
            )
            self._thread.start()
        else:
            self._server.serve_forever()
        return actual_port

    def shutdown(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server = None
