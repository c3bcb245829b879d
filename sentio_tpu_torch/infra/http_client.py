"""A JSON-over-HTTP client on the standard library (the machine with the
card has no ``httpx``): what the OpenAI-compatible provider and the eval
baseline's model hops need of ``httpx.Client``.

:class:`HttpClient` keeps **one persistent HTTP/1.1 connection per calling
thread** to its base URL, as an ``httpx.Client`` pools them, so a call pays
no TCP handshake once its thread has connected; a connection the server
closed while idle is reopened once. ``connections_opened`` counts the
connections it made.
"""

from __future__ import annotations

import http.client
import json
import threading
from typing import Any, Iterator, Optional
from urllib.parse import urlsplit

__all__ = ["HttpClient", "HttpResponse", "HTTPStatusError"]


class HTTPStatusError(Exception):
    """A 4xx or 5xx answer; ``response`` is the :class:`HttpResponse`."""

    def __init__(self, message: str, response: "HttpResponse") -> None:
        super().__init__(message)
        self.response = response


class HttpResponse:
    def __init__(self, status_code: int, body: bytes, url: str) -> None:
        self.status_code = status_code
        self.content = body
        self.url = url

    def json(self) -> Any:
        return json.loads(self.content)

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise HTTPStatusError(f"HTTP {self.status_code} for {self.url}", self)


class HttpClient:
    """JSON POSTs to ``base_url`` + a path, each thread on its own
    keep-alive connection."""

    def __init__(self, base_url: str, timeout: float = 30.0,
                 headers: Optional[dict] = None) -> None:
        self.base_url = base_url.rstrip("/")
        parts = urlsplit(self.base_url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"unsupported URL {base_url!r}")
        self._conn_cls = (http.client.HTTPSConnection if parts.scheme == "https"
                          else http.client.HTTPConnection)
        self._netloc = parts.netloc
        self._prefix = parts.path
        self.timeout = timeout
        self.headers = {"Content-Type": "application/json", **(headers or {})}
        self._local = threading.local()
        self._lock = threading.Lock()
        self._conns: list[http.client.HTTPConnection] = []
        self.connections_opened = 0
        self.is_closed = False

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._conn_cls(self._netloc, timeout=self.timeout)
            with self._lock:
                if self.is_closed:
                    raise RuntimeError("HttpClient is closed")
                self._conns.append(conn)
                self.connections_opened += 1
            self._local.conn = conn
        return conn

    def _drop(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            self._local.conn = None

    def _send(self, path: str, payload: Any) -> http.client.HTTPResponse:
        body = json.dumps(payload).encode()
        for attempt in range(2):
            conn = self._conn()
            try:
                conn.request("POST", self._prefix + path, body=body, headers=self.headers)
                return conn.getresponse()
            except (http.client.RemoteDisconnected, ConnectionResetError, BrokenPipeError,
                    http.client.CannotSendRequest):
                # the server closed the idle keep-alive connection: once more
                # on a fresh one
                self._drop()
                if attempt:
                    raise
            except Exception:
                self._drop()
                raise
        raise AssertionError("unreachable")

    def post(self, path: str, json_body: Any) -> HttpResponse:
        resp = self._send(path, json_body)
        try:
            data = resp.read()
        except Exception:
            self._drop()
            raise
        if resp.will_close:
            self._drop()
        return HttpResponse(resp.status, data, self.base_url + path)

    def stream_lines(self, path: str, json_body: Any) -> Iterator[str]:
        """POST and yield the response body's lines as they arrive (SSE);
        raises :class:`HTTPStatusError` first on a 4xx or 5xx."""
        resp = self._send(path, json_body)
        done = False
        try:
            if resp.status >= 400:
                raise HTTPStatusError(f"HTTP {resp.status} for {self.base_url + path}",
                                      HttpResponse(resp.status, resp.read(),
                                                   self.base_url + path))
            while True:
                line = resp.readline()
                if not line:
                    break
                yield line.decode("utf-8").rstrip("\r\n")
            done = True
        finally:
            if not done or resp.will_close:
                # a body left unread leaves the connection unusable
                self._drop()

    def close(self) -> None:
        with self._lock:
            self.is_closed = True
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.close()
