"""The Redis L2 cache over a minimal RESP2 client — the counterpart of
``sentio_tpu/infra/redis_cache.py``, with no redis package: the cache needs
five commands (``AUTH``, ``SELECT``, ``PING``, ``GET``, ``SET … PX``,
``DEL``), a few dozen lines of RESP2 framing.

JAX's client is asyncio; the port's server runs on threads, so this client
is one blocking socket under a lock, with JAX's 2.0 s timeout on the
connect and on every read and write. The bytes on the wire are JAX's
(:func:`_encode_command`), so does the handshake (``AUTH`` when the URL
has a password, ``SELECT`` when it names a database other than 0; a failed
handshake drops the connection, so no later command runs unauthenticated
or on the wrong database).

Values are JSON, never pickle. Every public method keeps the
:class:`~sentio_tpu_torch.infra.caching.L2Cache` contract: a server that
is down, a timeout or a corrupt value reads as a miss and never raises; a
dead connection is dropped and the next call dials again, so the cache
comes back after a restart of the server.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
from typing import Any, Optional
from urllib.parse import urlparse

logger = logging.getLogger(__name__)

_CRLF = b"\r\n"


class RESPError(Exception):
    pass


def _encode_command(*args: str | bytes) -> bytes:
    """RESP2 array-of-bulk-strings encoding."""
    out = [b"*%d" % len(args), _CRLF]
    for arg in args:
        data = arg if isinstance(arg, bytes) else str(arg).encode()
        out += [b"$%d" % len(data), _CRLF, data, _CRLF]
    return b"".join(out)


def _read_reply(reader) -> Any:
    """One reply from a binary file object over the socket."""
    line = reader.readline()
    if not line.endswith(_CRLF):
        raise ConnectionError("redis connection closed mid-reply")
    line = line[:-2]
    kind, rest = line[:1], line[1:]
    if kind == b"+":  # simple string
        return rest.decode()
    if kind == b"-":  # error
        raise RESPError(rest.decode())
    if kind == b":":  # integer
        return int(rest)
    if kind == b"$":  # bulk string
        n = int(rest)
        if n == -1:
            return None
        data = reader.read(n + 2)
        if len(data) != n + 2:
            raise ConnectionError("redis connection closed mid-reply")
        return data[:-2]
    if kind == b"*":  # array
        n = int(rest)
        if n == -1:
            return None
        return [_read_reply(reader) for _ in range(n)]
    raise RESPError(f"unknown RESP type byte {kind!r}")


class RedisL2Cache:
    """An L2 cache speaking RESP2 to a Redis-compatible server over one
    connection, its commands serialized by a lock (the cache manager issues
    single-key operations at a low rate)."""

    def __init__(self, url: str = "redis://localhost:6379/0", key_prefix: str = "sentio:",
                 timeout_s: float = 2.0) -> None:
        parsed = urlparse(url)
        if parsed.scheme not in ("redis", ""):
            raise ValueError(f"unsupported redis url scheme {parsed.scheme!r}")
        self.host = parsed.hostname or "localhost"
        self.port = parsed.port or 6379
        self.password = parsed.password or ""
        try:
            self.db = int((parsed.path or "/0").lstrip("/") or 0)
        except ValueError:
            self.db = 0
        self.key_prefix = key_prefix
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._reader = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ connection

    def _connect(self) -> None:
        sock = socket.create_connection((self.host, self.port), timeout=self.timeout_s)
        sock.settimeout(self.timeout_s)
        self._sock, self._reader = sock, sock.makefile("rb")
        try:
            if self.password:
                self._command_locked("AUTH", self.password)
            if self.db:
                self._command_locked("SELECT", str(self.db))
        except BaseException:
            # a failed handshake must not leave a half-initialized
            # connection installed
            self._drop_connection()
            raise

    def _drop_connection(self) -> None:
        for closable in (self._reader, self._sock):
            if closable is not None:
                try:
                    closable.close()
                except OSError:  # closing an already-dead socket
                    pass
        self._sock = self._reader = None

    def _command_locked(self, *args: str | bytes) -> Any:
        assert self._sock is not None and self._reader is not None
        self._sock.sendall(_encode_command(*args))
        return _read_reply(self._reader)

    def _command(self, *args: str | bytes) -> Any:
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                return self._command_locked(*args)
            except OSError:
                # dead connection (timeouts included): the next call redials
                self._drop_connection()
                raise
            except RESPError as exc:
                # an auth or protocol desync means the session state is
                # wrong, not only this command: redial
                if str(exc).upper().startswith(("NOAUTH", "WRONGPASS", "LOADING",
                                                "MASTERDOWN")):
                    self._drop_connection()
                raise

    # ----------------------------------------------------------- L2 surface

    def _k(self, key: str) -> str:
        return self.key_prefix + key

    def get(self, key: str) -> Optional[Any]:
        try:
            raw = self._command("GET", self._k(key))
        except Exception as exc:  # noqa: BLE001 — contract: errors are misses
            logger.debug("redis get failed: %s", exc)
            return None
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except (ValueError, TypeError):
            return None

    def set(self, key: str, value: Any, ttl_s: float) -> None:
        try:
            payload = json.dumps(value, default=str)
        except (TypeError, ValueError):
            return
        px = max(int(ttl_s * 1000), 1)
        try:
            self._command("SET", self._k(key), payload, "PX", str(px))
        except Exception as exc:  # noqa: BLE001 — contract: a failed write is dropped
            logger.debug("redis set failed: %s", exc)

    def delete(self, key: str) -> None:
        try:
            self._command("DEL", self._k(key))
        except Exception as exc:  # noqa: BLE001 — contract: a failed delete is dropped
            logger.debug("redis del failed: %s", exc)

    def ping(self) -> bool:
        try:
            return self._command("PING") == "PONG"
        except Exception:  # noqa: BLE001 — any failure means "not reachable"
            return False

    def close(self) -> None:
        with self._lock:
            self._drop_connection()
