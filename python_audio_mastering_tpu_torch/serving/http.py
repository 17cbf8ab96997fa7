"""A tiny dependency-free WSGI micro-framework.

Counterpart of ``python_audio_mastering_tpu.serving.http`` (pure Python;
the port keeps its own copy because importing the JAX package imports
jax).  The reference's API layer is Flask; this is the minimal router and
JSON layer the worker's push endpoint builds on.  Apps built with it run
under any WSGI server (``wsgiref`` for development and tests, gunicorn in
deployment).
"""

from __future__ import annotations

import json
import re
import traceback
from typing import Callable
from urllib.parse import parse_qs

__all__ = ["App", "Request", "json_response", "text_response"]


class Request:
    def __init__(self, environ):
        self.environ = environ
        self.method = environ["REQUEST_METHOD"].upper()
        self.path = environ.get("PATH_INFO", "/")
        self.query = {k: v[0] for k, v in
                      parse_qs(environ.get("QUERY_STRING", "")).items()}
        self.headers = {k[5:].replace("_", "-").lower(): v
                        for k, v in environ.items() if k.startswith("HTTP_")}
        if environ.get("CONTENT_TYPE"):
            self.headers["content-type"] = environ["CONTENT_TYPE"]
        self._body = None

    @property
    def body(self) -> bytes:
        if self._body is None:
            try:
                length = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                length = 0
            self._body = self.environ["wsgi.input"].read(length) if length else b""
        return self._body

    def get_json(self):
        if not self.body:
            return None
        try:
            return json.loads(self.body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None


def json_response(payload, status=200):
    body = json.dumps(payload).encode("utf-8")
    return status, [("Content-Type", "application/json"),
                    ("Content-Length", str(len(body)))], body


def text_response(text, status=200, content_type="text/plain"):
    body = text if isinstance(text, bytes) else text.encode("utf-8")
    return status, [("Content-Type", content_type),
                    ("Content-Length", str(len(body)))], body


_STATUS_TEXT = {200: "OK", 204: "No Content", 400: "Bad Request",
                403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
                500: "Internal Server Error"}


class App:
    """Route decorator + WSGI callable.  Path params: ``/blob/<name>``."""

    def __init__(self, name="app"):
        self.name = name
        self._routes = []  # (method, regex, handler)

    def route(self, path, methods=("GET",)):
        pattern = re.sub(r"<([a-zA-Z_]+)>", r"(?P<\1>[^/]+)", path)
        # allow a final wildcard segment to contain slashes: <path:name>
        pattern = re.sub(r"<path:([a-zA-Z_]+)>", r"(?P<\1>.+)", path) \
            if "<path:" in path else pattern
        regex = re.compile("^" + pattern + "$")

        def deco(fn: Callable):
            for m in methods:
                self._routes.append((m.upper(), regex, fn))
            return fn

        return deco

    def __call__(self, environ, start_response):
        req = Request(environ)
        allowed = set()
        for method, regex, fn in self._routes:
            m = regex.match(req.path)
            if not m:
                continue
            allowed.add(method)
            if method != req.method:
                continue
            try:
                status, headers, body = fn(req, **m.groupdict())
            except Exception as e:  # mirror the reference's catch-all 500s
                traceback.print_exc()
                status, headers, body = json_response(
                    {"error": f"Internal server error: {e}"}, 500)
            break
        else:
            if allowed:
                status, headers, body = json_response({"error": "method not allowed"}, 405)
            else:
                status, headers, body = json_response({"error": "not found"}, 404)
        headers = headers + [("Access-Control-Allow-Origin", "*")]
        start_response(f"{status} {_STATUS_TEXT.get(status, 'OK')}", headers)
        return [body]
