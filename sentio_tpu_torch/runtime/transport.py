"""Worker RPC transports — a copy of ``sentio_tpu/runtime/transport.py``:
the framing layer under the process and socket replica tier
(``runtime/worker.py``).

* :class:`PipeTransport` — the spawn pipe (``REPLICA_MODE=process``). A dead
  peer is a broken pipe or EOF, at once.
* :class:`SocketTransport` — length-prefixed pickle frames over TCP
  (``REPLICA_MODE=socket`` and ``REPLICA_WORKERS=host:port,...``). Every
  frame carries a header (magic, protocol version, **incarnation epoch**,
  length) and every blocking step a deadline: a partial frame must complete
  within ``frame_timeout_s`` and a send that makes no progress for as long
  raises :class:`TransportClosed` (the broken-write liveness signal); an
  oversized frame raises :class:`FrameTooLarge` on both sides; a bad header
  or an undecodable payload raises :class:`FrameProtocolError` and the
  connection is dropped, never resynchronized.

The epoch is the worker registry's incarnation stamp (``runtime/replica.py``
``WorkerRegistry``): the router bumps a slot's epoch at every
(re)registration, and its dispatcher drops frames of an older epoch, so a
worker that reconnects after a partition can neither resurrect a dead
ticket nor deliver a stream chunk twice.

Handshake (versioned, authenticated): the connecting side's first frame is
``(0, "hello", {token, slot, proto, pid})``; the accepting side checks the
shared token (constant-time compare) and the protocol version and answers
``(0, "hello_ack", {epoch})``, or ``(0, "hello_reject", {reason})`` and
drops the connection. Workers dial the router's registry listener; the
router dials ``REPLICA_WORKERS`` listeners (``worker_serve``), and then its
hello carries the epoch it assigned.

Frames carry host values only — ints, floats, strings, lists, dicts, numpy
arrays and the service's result dataclasses; no tensor crosses a frame.
Fault points: the socket paths hit ``transport.recv`` / ``transport.send``
and the per-peer ``transport.recv.<scope>`` / ``transport.send.<scope>``
(router side ``r<slot>``, worker side ``worker``) through
:func:`faults.hit_frame`: drop the next N frames, delay them, or stall the
reads (the half-open partition).
"""

from __future__ import annotations

import hmac
import pickle
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Optional

from sentio_tpu_torch.infra import faults

__all__ = [
    "PROTOCOL_VERSION",
    "TransportError",
    "TransportClosed",
    "FrameTooLarge",
    "FrameProtocolError",
    "PipeTransport",
    "SocketTransport",
    "ClockSync",
    "send_hello",
    "expect_hello",
    "dial",
    "DEFAULT_MAX_FRAME_BYTES",
    "DEFAULT_FRAME_TIMEOUT_S",
]

PROTOCOL_VERSION = 1

# frame header: magic | version | incarnation epoch | payload length
_MAGIC = b"SNTP"
_HEADER = struct.Struct("!4sBII")

DEFAULT_MAX_FRAME_BYTES = 32 * 1024 * 1024
DEFAULT_FRAME_TIMEOUT_S = 30.0

# fixed socket timeout: every blocking socket op wakes at this cadence to
# re-check its own deadline (set ONCE at construction — mutating the shared
# socket timeout from concurrent send/recv threads would race)
_POLL_S = 0.2


class TransportError(RuntimeError):
    """Base for transport-layer failures. Not a SentioError: these never
    cross the wire; the worker shim (``runtime/worker.py``) maps them to the
    typed ReplicaUnavailable callers already handle."""


class TransportClosed(TransportError):
    """The peer is gone or the link is unusable: EOF, broken pipe, reset,
    a mid-frame read that starved past its deadline, or a write the peer
    stopped draining. Terminal for the connection."""


class FrameTooLarge(TransportError):
    """A frame exceeded ``max_frame_bytes`` — refused on the sending side
    before any byte is written, and on the receiving side before any
    payload is buffered (a hostile or broken peer cannot balloon router
    memory). Terminal for the connection on the receive side (the bytes
    are already in flight and cannot be skipped trustworthily)."""


class FrameProtocolError(TransportError):
    """Bad magic, unsupported protocol version, or an undecodable payload.
    The connection is dropped: framing integrity is gone."""


class PipeTransport:
    """The spawn pipe behind the transport seam. Pickle round-trips are the
    Connection's own (through ``torch.multiprocessing``'s reductions); the
    epoch is fixed: the pipe is the process."""

    def __init__(self, conn, epoch: int = 0) -> None:
        self._conn = conn
        self.epoch = epoch
        # Connection.send is not thread-safe (a >16KB frame goes out as
        # separate header+body writes, and partial writes loop): concurrent
        # sender threads would interleave bytes and desync the pipe, making
        # a healthy peer look dead
        self._send_lock = threading.Lock()

    def send(self, frame: tuple) -> None:
        try:
            with self._send_lock:
                self._conn.send(frame)
        except (BrokenPipeError, EOFError, OSError) as exc:
            raise TransportClosed(f"pipe send failed: {exc}") from exc

    def recv(self, timeout_s: Optional[float] = None):
        """→ ``(frame, epoch)``, or ``None`` when ``timeout_s`` elapses
        with no frame available (the caller's poll tick)."""
        try:
            if timeout_s is not None and not self._conn.poll(timeout_s):
                return None
            frame = self._conn.recv()
        except (EOFError, BrokenPipeError, OSError) as exc:
            raise TransportClosed(f"pipe closed: {exc}") from exc
        except pickle.UnpicklingError as exc:
            raise FrameProtocolError(f"undecodable pipe frame: {exc}") from exc
        return frame, self.epoch

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass

    def fileno(self) -> int:
        return self._conn.fileno()


class SocketTransport:
    """Length-prefixed pickle frames over one TCP connection.

    Threading: many senders (``_send_lock`` serializes writes — a frame
    interleaved with another's bytes desyncs the stream), ONE receiver
    (the dispatcher thread; the recv path keeps partial-frame state and is
    not reentrant)."""

    def __init__(
        self,
        sock: socket.socket,
        epoch: int = 0,
        max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
        frame_timeout_s: float = DEFAULT_FRAME_TIMEOUT_S,
        fault_scope: str = "",
    ) -> None:
        self._sock = sock
        self.epoch = epoch
        self.max_frame_bytes = int(max_frame_bytes)
        self.frame_timeout_s = float(frame_timeout_s)
        self.fault_scope = fault_scope
        self._send_lock = threading.Lock()
        self._closed = threading.Event()
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # e.g. a unix socketpair in tests
        sock.settimeout(_POLL_S)

    # ------------------------------------------------------------- internals

    def _fault_points(self, op: str) -> tuple:
        if self.fault_scope:
            return (f"transport.{op}", f"transport.{op}.{self.fault_scope}")
        return (f"transport.{op}",)

    def _hit(self, op: str) -> bool:
        """True when an armed network-fault rule says to DROP this frame;
        stalls/delays/errors fire inside (half-open partitions arm a stall
        at the recv point — reads wedge while the send path stays live)."""
        drop = False
        for point in self._fault_points(op):
            drop = faults.hit_frame(point) or drop
        return drop

    def _send_bytes(self, data: bytes) -> None:
        """Write all of ``data``, bounded by PROGRESS: the deadline resets
        every time bytes move, so a slow-but-draining peer is fine and
        only a peer that stopped reading entirely (kernel buffer full, no
        progress for a whole frame timeout) breaks the write typed."""
        view = memoryview(data)
        deadline = time.perf_counter() + self.frame_timeout_s
        while view:
            if self._closed.is_set():
                raise TransportClosed("transport closed during send")
            try:
                n = self._sock.send(view)
            except socket.timeout:
                if time.perf_counter() > deadline:
                    # bounded buffering: the peer stopped reading and the
                    # kernel buffer filled — the broken-write death signal
                    raise TransportClosed(
                        f"send made no progress for {self.frame_timeout_s:.0f}s "
                        "(peer not reading)"
                    ) from None
                continue
            except OSError as exc:
                raise TransportClosed(f"send failed: {exc}") from exc
            if n == 0:
                raise TransportClosed("send returned 0 bytes")
            view = view[n:]
            deadline = time.perf_counter() + self.frame_timeout_s

    def _recv_exact(self, n: int, deadline: Optional[float],
                    idle_timeout_s: Optional[float]):
        """Read exactly ``n`` bytes. With ``deadline=None`` the FIRST byte
        may wait up to ``idle_timeout_s`` (None = forever) and returns
        ``None`` on idle expiry; once any byte has arrived, the remainder
        must land before the (started) frame deadline."""
        chunks: list[bytes] = []
        got = 0
        idle_start = time.perf_counter()
        while got < n:
            if self._closed.is_set():
                raise TransportClosed("transport closed during recv")
            try:
                chunk = self._sock.recv(n - got)
            except socket.timeout:
                now = time.perf_counter()
                if got == 0 and deadline is None:
                    if (idle_timeout_s is not None
                            and now - idle_start >= idle_timeout_s):
                        return None
                    continue
                if deadline is None:
                    deadline = idle_start + self.frame_timeout_s
                if now > deadline:
                    raise TransportClosed(
                        f"partial frame stalled past {self.frame_timeout_s:.0f}s"
                    ) from None
                continue
            except OSError as exc:
                raise TransportClosed(f"recv failed: {exc}") from exc
            if not chunk:
                raise TransportClosed("peer closed the connection")
            if got == 0 and deadline is None:
                # first byte of a frame: the rest must complete in time
                deadline = time.perf_counter() + self.frame_timeout_s
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    # --------------------------------------------------------------- surface

    def send(self, frame: tuple) -> None:
        payload = pickle.dumps(frame, protocol=pickle.HIGHEST_PROTOCOL)
        if len(payload) > self.max_frame_bytes:
            raise FrameTooLarge(
                f"frame of {len(payload)} bytes exceeds the "
                f"{self.max_frame_bytes}-byte cap"
            )
        if self._hit("send"):
            return  # injected network fault: this frame is dropped on the wire
        header = _HEADER.pack(_MAGIC, PROTOCOL_VERSION,
                              self.epoch & 0xFFFFFFFF, len(payload))
        # the progress deadline starts INSIDE the lock: time spent queued
        # behind another sender must not count against this frame
        with self._send_lock:
            self._send_bytes(header + payload)

    def recv(self, timeout_s: Optional[float] = None):
        """→ ``(frame, epoch)``; ``None`` when ``timeout_s`` elapses before
        any frame STARTS (a started frame always completes or raises)."""
        while True:
            header = self._recv_exact(_HEADER.size, None, timeout_s)
            if header is None:
                return None
            magic, version, epoch, length = _HEADER.unpack(header)
            if magic != _MAGIC:
                raise FrameProtocolError(
                    f"bad frame magic {magic!r} — peer is not speaking this "
                    "protocol"
                )
            if version != PROTOCOL_VERSION:
                raise FrameProtocolError(
                    f"peer speaks protocol v{version}, this side v"
                    f"{PROTOCOL_VERSION}"
                )
            if length > self.max_frame_bytes:
                raise FrameTooLarge(
                    f"incoming frame of {length} bytes exceeds the "
                    f"{self.max_frame_bytes}-byte cap"
                )
            body_deadline = time.perf_counter() + self.frame_timeout_s
            payload = self._recv_exact(length, body_deadline, None)
            try:
                frame = pickle.loads(payload)
            except Exception as exc:  # noqa: BLE001 — any decode failure is protocol death
                raise FrameProtocolError(
                    f"undecodable frame payload: {exc}") from exc
            if self._hit("recv"):
                continue  # injected network fault: frame dropped before dispatch
            return frame, epoch

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def fileno(self) -> int:
        return self._sock.fileno()


class ClockSync:
    """NTP-style clock-offset estimator over the worker ping loop.

    Router and worker each run their own ``perf_counter`` — unrelated
    origins, so a worker's flight timestamps are meaningless on the
    router's timeline until an offset is known. Each ping/pong exchange
    yields one sample (NTP's four-timestamp exchange collapsed to three:
    the worker turns the pong around immediately, so its receive and
    transmit stamps coincide):

    * ``t_tx``  — router clock when the ping left
    * ``t_peer`` — worker clock when the pong was stamped
    * ``t_rx``  — router clock when the pong landed

    ``offset = t_peer − (t_tx + rtt/2)`` under the symmetric-path
    assumption; the error is bounded by ``rtt/2`` regardless of asymmetry,
    so :meth:`estimate` returns the MINIMUM-RTT sample over a sliding
    window (Cristian's algorithm / NTP clock-filter shape: the fastest
    exchange had the least queueing and the tightest bound) and reports
    ``uncertainty_s = rtt/2`` alongside it. Fleet Chrome traces re-base
    worker timestamps by the offset and stamp the bound on the lane name —
    causality within ±uncertainty is readable, beyond it is not claimed.

    Thread-safe: the ping thread adds samples, trace exporters read."""

    def __init__(self, window: int = 64) -> None:
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=window)  # guarded-by: _lock
        self._total = 0  # guarded-by: _lock

    def add_sample(self, t_tx: float, t_rx: float, t_peer: float) -> None:
        """Record one ping/pong exchange (router clocks ``t_tx``/``t_rx``,
        worker clock ``t_peer``). A negative apparent RTT (clock jitter)
        is clamped — the sample still carries offset information."""
        rtt = max(float(t_rx) - float(t_tx), 0.0)
        offset = float(t_peer) - (float(t_tx) + rtt / 2.0)
        with self._lock:
            self._samples.append((rtt, offset))
            self._total += 1

    def estimate(self) -> Optional[dict]:
        """Best current estimate: the min-RTT sample in the window —
        ``{"offset_s", "rtt_s", "uncertainty_s", "samples"}`` (offset is
        worker-clock minus router-clock), or None before any sample."""
        with self._lock:
            if not self._samples:
                return None
            rtt, offset = min(self._samples)
            total = self._total
        return {"offset_s": offset, "rtt_s": rtt,
                "uncertainty_s": rtt / 2.0, "samples": total}


# --------------------------------------------------------------------------
# handshake

def send_hello(transport: SocketTransport, token: str, slot: int,
               pid: int, epoch: Optional[int] = None,
               timeout_s: float = 10.0) -> dict:
    """Connecting side: identify + authenticate, await the ack.

    Two directions share this shape: a WORKER registering against the
    router's registry listener sends no epoch and receives its grant in
    the ack; a ROUTER dialing an advertised remote worker
    (``REPLICA_WORKERS``) already owns the epoch counter and sends the
    epoch it assigned, which the ack echoes. Either way the granted epoch
    is stamped onto the transport (every subsequent frame carries it) and
    the full ack payload is returned."""
    hello = {"token": token, "slot": int(slot),
             "proto": PROTOCOL_VERSION, "pid": int(pid)}
    if epoch is not None:
        hello["epoch"] = int(epoch)
    transport.send((0, "hello", hello))
    got = transport.recv(timeout_s=timeout_s)
    if got is None:
        raise TransportClosed(f"no hello ack within {timeout_s:.0f}s")
    frame, _epoch = got
    _req, kind, payload = frame
    if kind == "hello_reject":
        raise FrameProtocolError(
            f"registration rejected: {payload.get('reason', 'unknown')}")
    if kind != "hello_ack":
        raise FrameProtocolError(f"expected hello_ack, got {kind!r}")
    transport.epoch = int(payload.get("epoch", epoch or 0))
    return payload


def expect_hello(transport: SocketTransport, token: str,
                 timeout_s: float = 10.0, on_reject=None) -> dict:
    """Accepting side: read + validate the peer's hello. Raises
    :class:`FrameProtocolError` (after sending a reject frame, best-effort)
    on a bad token or version — the caller drops the connection. Returns
    the hello payload; the caller assigns the epoch and sends the ack.
    ``on_reject(reason)`` runs before the reject frame goes out, so what it
    counts is current by the time the peer reads the reject."""
    got = transport.recv(timeout_s=timeout_s)
    if got is None:
        raise TransportClosed(f"no hello within {timeout_s:.0f}s")
    frame, _epoch = got
    try:
        _req, kind, payload = frame
    except (TypeError, ValueError) as exc:
        raise FrameProtocolError(f"malformed hello frame: {frame!r}") from exc
    reason = ""
    if kind != "hello" or not isinstance(payload, dict):
        reason = "first frame was not a hello"
    else:
        try:
            proto_ok = int(payload.get("proto", -1)) == PROTOCOL_VERSION
        except (TypeError, ValueError):
            proto_ok = False
        if not proto_ok:
            reason = (f"protocol v{payload.get('proto')!r} unsupported "
                      f"(this side v{PROTOCOL_VERSION})")
        else:
            # compare as BYTES: compare_digest raises TypeError on
            # non-ASCII str input, and a hostile hello must never crash
            # the accept loop with an untyped error
            sent = str(payload.get("token", "")).encode("utf-8", "replace")
            if not hmac.compare_digest(sent, token.encode("utf-8",
                                                          "replace")):
                reason = "bad auth token"
    if reason:
        if on_reject is not None:
            on_reject(reason)
        try:
            transport.send((0, "hello_reject", {"reason": reason}))
        except TransportError:
            pass
        raise FrameProtocolError(f"registration rejected: {reason}")
    return payload


def dial(
    addr: tuple,
    connect_timeout_s: float = 10.0,
    max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
    frame_timeout_s: float = DEFAULT_FRAME_TIMEOUT_S,
    fault_scope: str = "",
) -> SocketTransport:
    """Open a TCP connection and wrap it. Connect errors raise
    :class:`TransportClosed` (retryable by the caller's backoff loop)."""
    try:
        sock = socket.create_connection(
            (addr[0], int(addr[1])), timeout=connect_timeout_s)
    except OSError as exc:
        raise TransportClosed(f"connect to {addr} failed: {exc}") from exc
    return SocketTransport(
        sock, max_frame_bytes=max_frame_bytes,
        frame_timeout_s=frame_timeout_s, fault_scope=fault_scope,
    )
