"""The port's worker transport (``runtime/transport.py``) and worker
registry (``runtime/replica.py::WorkerRegistry``) against the JAX
package's: frames round-trip with their epoch, a frame's header bytes are
JAX's for the same (epoch, length), and each package decodes the other's
frames; a truncated, oversized, corrupt, wrong-magic or wrong-version frame
raises the typed error, bounded in time; the network faults through
``faults.hit_frame`` (drop the next N frames, a send-side drop, the
half-open partition); the handshake: monotonic epochs, a bad token or
version refused, hostile hellos, supersede by epoch, an unknown slot
refused and an elastic join (``slot=-1``) granted a slot. Fault points are named
through constants, so JAX's fault-point inventory does not count them."""

import multiprocessing
import pickle
import random
import socket
import struct
import threading
import time

import pytest

from sentio_tpu.runtime import transport as jtransport
from sentio_tpu_torch.infra import faults
from sentio_tpu_torch.infra.exceptions import ReplicaUnavailable
from sentio_tpu_torch.infra.metrics import get_metrics
from sentio_tpu_torch.runtime.replica import WorkerRegistry
from sentio_tpu_torch.runtime.transport import (
    _HEADER,
    _MAGIC,
    PROTOCOL_VERSION,
    FrameProtocolError,
    FrameTooLarge,
    PipeTransport,
    SocketTransport,
    TransportClosed,
    dial,
    send_hello,
)

JOIN_S = 10.0
RECV_R0 = "transport.recv." + "r0"
RECV_R1 = "transport.recv." + "r1"
SEND_W = "transport.send." + "w"


def _pair(**kw):
    a, b = socket.socketpair()
    return SocketTransport(a, **kw), b


def _tpair(**kw):
    a, b = socket.socketpair()
    return SocketTransport(a, **kw), SocketTransport(b, **kw)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def test_roundtrip_keeps_frames_and_epoch():
    tx, rx = _tpair()
    tx.epoch = 7
    rng = random.Random(0)
    frames = [(0, "ok", None), (1, "tok", ("piece", [1, 2, 3])),
              (2, "status", {"backlog": 0, "nested": {"x": [None, 1.5]}}),
              (3, "blob", bytes(rng.randrange(256) for _ in range(70_000))),
              (4, "text", "ü" * 5000)]
    for frame in frames:
        tx.send(frame)
        assert rx.recv(timeout_s=5) == (frame, 7)
    tx.close(), rx.close()


@pytest.mark.parametrize("epoch,payload", [(0, (0, "ok", None)), (3, (5, "tok", ("a", [1]))),
                                           (2 ** 32 + 5, (9, "status", {"x": 1.5}))])
def test_header_bytes_are_jaxs_and_frames_cross_decode(epoch, payload):
    """Our frame's bytes are JAX's frame's bytes (header: magic, version,
    epoch mod 2^32, length), and each package reads the other's frame."""
    assert (_HEADER.format, _MAGIC, PROTOCOL_VERSION) == \
        (jtransport._HEADER.format, jtransport._MAGIC, jtransport.PROTOCOL_VERSION)
    got = {}
    for name, cls in (("ours", SocketTransport), ("theirs", jtransport.SocketTransport)):
        a, b = socket.socketpair()
        t = cls(a)
        t.epoch = epoch
        t.send(payload)
        body = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        raw = b.recv(_HEADER.size + len(body), socket.MSG_WAITALL)
        got[name] = raw
        t.close(), b.close()
    assert got["ours"] == got["theirs"]
    assert got["ours"][:_HEADER.size] == jtransport._HEADER.pack(
        jtransport._MAGIC, jtransport.PROTOCOL_VERSION, epoch & 0xFFFFFFFF,
        len(got["ours"]) - _HEADER.size)
    for tx_cls, rx_cls in ((SocketTransport, jtransport.SocketTransport),
                           (jtransport.SocketTransport, SocketTransport)):
        a, b = socket.socketpair()
        tx, rx = tx_cls(a), rx_cls(b)
        tx.epoch = epoch
        tx.send(payload)
        assert rx.recv(timeout_s=5) == (payload, epoch & 0xFFFFFFFF)
        tx.close(), rx.close()


def test_recv_timeout_returns_none():
    tx, rx = _tpair()
    t0 = time.perf_counter()
    assert rx.recv(timeout_s=0.3) is None
    assert time.perf_counter() - t0 < 2.0
    tx.close(), rx.close()


@pytest.mark.parametrize("cut", ["header", "payload"])
def test_truncated_frame_raises_within_the_frame_timeout(cut):
    t, peer = _pair(frame_timeout_s=0.5)
    payload = pickle.dumps((1, "ok", "x" * 100))
    header = _HEADER.pack(_MAGIC, PROTOCOL_VERSION, 0, len(payload))
    peer.sendall(header[:2] if cut == "header" else header + payload[: len(payload) // 2])
    t0 = time.perf_counter()
    with pytest.raises(TransportClosed):
        t.recv(timeout_s=5)
    assert time.perf_counter() - t0 < 5.0
    t.close(), peer.close()


def test_oversized_frame_refused_on_both_sides():
    t, peer = _pair(max_frame_bytes=1024)
    with pytest.raises(FrameTooLarge):
        t.send((1, "blob", b"x" * 4096))
    peer.sendall(_HEADER.pack(_MAGIC, PROTOCOL_VERSION, 0, 1 << 20))
    with pytest.raises(FrameTooLarge):
        t.recv(timeout_s=5)
    t.close(), peer.close()


@pytest.mark.parametrize("magic,version,body", [
    (_MAGIC, PROTOCOL_VERSION, b"\x80\x05garbage-not-a-pickle"),
    (b"HTTP", PROTOCOL_VERSION, None),
    (_MAGIC, PROTOCOL_VERSION + 9, None),
], ids=["corrupt", "wrong_magic", "wrong_version"])
def test_bad_frames_raise_the_protocol_error_as_jax(magic, version, body):
    body = body if body is not None else pickle.dumps((0, "ok", None))
    raw = struct.pack("!4sBII", magic, version, 0, len(body)) + body
    for cls, err in ((SocketTransport, FrameProtocolError),
                     (jtransport.SocketTransport, jtransport.FrameProtocolError)):
        a, peer = socket.socketpair()
        t = cls(a)
        peer.sendall(raw)
        with pytest.raises(err):
            t.recv(timeout_s=5)
        t.close(), peer.close()


def test_random_garbage_is_always_typed_and_bounded():
    rng = random.Random(1234)
    for trial in range(8):
        t, peer = _pair(frame_timeout_s=0.3, max_frame_bytes=1 << 16)
        peer.sendall(bytes(rng.randrange(256) for _ in range(rng.randrange(1, 200))))
        peer.close()
        t0 = time.perf_counter()
        try:
            while t.recv(timeout_s=1.0) is not None:
                pass
        except (TransportClosed, FrameProtocolError, FrameTooLarge):
            pass
        assert time.perf_counter() - t0 < 10.0, f"trial {trial} hung"
        t.close()


def test_peer_close_is_transport_closed():
    t, peer = _pair()
    peer.close()
    with pytest.raises(TransportClosed):
        t.recv(timeout_s=5)
    t.close()


def test_broken_write_raises_within_the_frame_timeout():
    a, b = socket.socketpair()
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
    b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    t = SocketTransport(a, frame_timeout_s=0.5)
    t0 = time.perf_counter()
    with pytest.raises(TransportClosed):
        for _ in range(64):  # nobody reads b
            t.send((1, "blob", b"x" * 65_536))
    assert time.perf_counter() - t0 < 30.0
    t.close(), b.close()


def test_pipe_transport_surface():
    c1, c2 = multiprocessing.Pipe()
    tx, rx = PipeTransport(c1, epoch=3), PipeTransport(c2, epoch=3)
    assert rx.recv(timeout_s=0.1) is None
    tx.send((5, "ok", {"a": 1}))
    assert rx.recv(timeout_s=5) == ((5, "ok", {"a": 1}), 3)
    tx.close()
    with pytest.raises(TransportClosed):
        rx.recv(timeout_s=5)
    rx.close()


# ---------------------------------------------------------- network faults


def test_drop_the_next_n_frames():
    tx, rx = _tpair()
    rx.fault_scope = "r0"
    with faults.inject(RECV_R0, drop=True, times=2) as rule:
        for i in range(4):
            tx.send((i, "tok", i))
        assert [rx.recv(timeout_s=5)[0][0] for _ in range(2)] == [2, 3]
        assert rule.fired == 2
    tx.close(), rx.close()


def test_send_side_drop():
    tx, rx = _tpair()
    tx.fault_scope = "w"
    with faults.inject(SEND_W, drop=True, times=1):
        tx.send((0, "tok", "lost"))
        tx.send((1, "tok", "kept"))
    assert rx.recv(timeout_s=5)[0] == (1, "tok", "kept")
    tx.close(), rx.close()


def test_half_open_partition_stalls_reads_while_writes_land():
    a, b = _tpair()
    a.fault_scope = "r1"
    release = threading.Event()
    got = {}

    def reader():
        got["frame"] = a.recv(timeout_s=30)

    with faults.inject(RECV_R1, stall_event=release, stall_s=30.0, times=1):
        b.send((1, "tok", "wedged"))
        th = threading.Thread(target=reader, name="test-partition-reader", daemon=True)
        th.start()
        time.sleep(0.3)
        assert th.is_alive()
        a.send((2, "ok", "write side alive"))
        assert b.recv(timeout_s=5)[0] == (2, "ok", "write side alive")
        release.set()
        th.join(timeout=JOIN_S)
        assert not th.is_alive()
        assert got["frame"][0] == (1, "tok", "wedged")
    a.close(), b.close()


# ------------------------------------------------------------- handshake


def test_registration_grants_monotonic_epochs():
    reg = WorkerRegistry("secret", slots=2)
    try:
        t1 = dial(reg.address)
        ack1 = send_hello(t1, "secret", 1, 42)
        rt1, hello, e1 = reg.await_registration(1, 5.0)
        assert ack1["epoch"] == e1 == 1 and hello["pid"] == 42
        t2 = dial(reg.address)
        ack2 = send_hello(t2, "secret", 1, 43)
        rt2, _h, e2 = reg.await_registration(1, 5.0)
        assert ack2["epoch"] == e2 == 2 and reg.current_epoch(1) == 2
        assert (rt1.epoch, rt2.epoch) == (1, 2)
        assert get_metrics().worker_incarnation.values()[("1",)] == 2.0
        for t in (t1, t2, rt1, rt2):
            t.close()
    finally:
        reg.close()


def test_a_jax_worker_registers_with_the_port_registry():
    """The wire protocol is JAX's: JAX's ``dial`` + ``send_hello`` register
    with the port's registry and the port's with JAX's."""
    from sentio_tpu.runtime.replica import WorkerRegistry as JWorkerRegistry

    ours, theirs = WorkerRegistry("secret", slots=1), JWorkerRegistry("secret", slots=1)
    try:
        t = jtransport.dial(ours.address)
        assert jtransport.send_hello(t, "secret", 0, 5)["epoch"] == 1
        rt, _h, _e = ours.await_registration(0, 5.0)
        t2 = dial(theirs.address)
        assert send_hello(t2, "secret", 0, 6)["epoch"] == 1
        rt2, _h, _e = theirs.await_registration(0, 5.0)
        for x in (t, rt, t2, rt2):
            x.close()
    finally:
        ours.close()
        theirs.close()


def test_bad_token_and_bad_version_are_refused():
    reg = WorkerRegistry("secret", slots=1)
    try:
        t = dial(reg.address)
        with pytest.raises(FrameProtocolError, match="token"):
            send_hello(t, "WRONG", 0, 1)
        t.close()
        t2 = dial(reg.address)
        t2.send((0, "hello", {"token": "secret", "slot": 0, "proto": PROTOCOL_VERSION + 1,
                              "pid": 1}))
        got = t2.recv(timeout_s=5)
        assert got is not None and got[0][1] == "hello_reject"
        assert "protocol" in got[0][2]["reason"]
        t2.close()
        stats = reg.stats()
        assert (stats["rejections"], stats["registrations"]) == (2, 0)
    finally:
        reg.close()


def test_hostile_hellos_never_crash_the_acceptor():
    reg = WorkerRegistry("secret", slots=1)
    try:
        for payload in ({"token": "sécrét-ünicode", "slot": 0, "proto": PROTOCOL_VERSION,
                         "pid": 1},
                        {"token": "secret", "slot": 0, "proto": "banana", "pid": 1},
                        {"token": None, "slot": 0, "proto": PROTOCOL_VERSION, "pid": 1}):
            t = dial(reg.address)
            t.send((0, "hello", payload))
            got = t.recv(timeout_s=5)
            assert got is not None and got[0][1] == "hello_reject", got
            t.close()
        t = dial(reg.address)
        send_hello(t, "secret", 0, 7)
        rt, _h, epoch = reg.await_registration(0, 5.0)
        assert epoch == 1
        t.close(), rt.close()
    finally:
        reg.close()


def test_racing_registrations_keep_the_highest_epoch():
    reg = WorkerRegistry("secret", slots=1)
    try:
        t1 = dial(reg.address)
        send_hello(t1, "secret", 0, 1)
        t2 = dial(reg.address)
        send_hello(t2, "secret", 0, 2)
        deadline = time.perf_counter() + 5
        while reg.current_epoch(0) < 2 and time.perf_counter() < deadline:
            time.sleep(0.02)
        rt, hello, epoch = reg.await_registration(0, 5.0)
        assert epoch == 2 and hello["pid"] == 2
        t1.close(), t2.close(), rt.close()
    finally:
        reg.close()


def test_unknown_slots_are_refused():
    reg = WorkerRegistry("secret", slots=1)
    try:
        t = dial(reg.address)
        with pytest.raises(FrameProtocolError, match="unknown slot 5"):
            send_hello(t, "secret", 5, 1)
        t.close()
        assert reg.stats()["registrations"] == 0 and reg.current_epoch(0) == 0
    finally:
        reg.close()


def test_an_elastic_join_is_granted_a_slot():
    """``slot=-1`` joins: the ack names a new slot at epoch 1, the join is
    queued for the supervisor and the registration awaits there (the
    elastic registry against JAX's: tests/test_torch_elastic.py)."""
    reg = WorkerRegistry("secret", slots=1)
    try:
        t = dial(reg.address)
        ack = send_hello(t, "secret", -1, 1)
        assert (ack["slot"], ack["epoch"]) == (1, 1) and t.epoch == 1
        deadline = time.perf_counter() + 5
        while reg.stats()["registrations"] < 1 and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert reg.drain_joins() == [1] and reg.stats()["slots"] == 2
        rt, hello, epoch = reg.await_registration(1, 5.0)
        assert (hello["pid"], epoch, reg.current_epoch(0)) == (1, 1, 0)
        t.close(), rt.close()
    finally:
        reg.close()


def test_await_registration_times_out_typed():
    reg = WorkerRegistry("secret", slots=1)
    try:
        with pytest.raises(ReplicaUnavailable, match="no worker registered"):
            reg.await_registration(0, timeout_s=0.3)
    finally:
        reg.close()


def test_stale_frames_are_counted():
    reg = WorkerRegistry("secret", slots=1)
    try:
        before = get_metrics().worker_stale_frames.values().get(("0",), 0.0)
        reg.note_stale_frame(0)
        reg.note_stale_frame(0)
        assert reg.stale_frames(0) == 2 and reg.stats()["stale_frames"] == [2]
        assert get_metrics().worker_stale_frames.values()[("0",)] == before + 2
    finally:
        reg.close()


def test_an_empty_token_is_refused():
    with pytest.raises(ValueError, match="auth token"):
        WorkerRegistry("", slots=1)
