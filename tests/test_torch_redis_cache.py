"""The port's Redis L2 cache (``infra/redis_cache.py``, a blocking RESP2
client) and cache tiers (``infra/caching.py``) against JAX's asyncio client
and manager, both talking to JAX's test ``FakeRedis`` on loopback (its loop
on a thread of its own).

* ``_encode_command`` bytes are equal on a table of commands;
* both clients send the same commands for the same calls (the ``AUTH`` /
  ``SELECT`` handshake included) and read the same values; a failed
  handshake drops the connection in both; a server that is down, a
  corrupt value and a restarted server read as misses, and the port's
  client dials again after the restart;
* the manager's tiered get promotes an L2 hit to L1 as JAX's ``aget``
  does, and serves L1 with no Redis; the strategies and the L1 surface
  match JAX's on one script."""

import asyncio
import json
import threading

import pytest
from test_redis_cache import FakeRedis

from sentio_tpu.config import CacheConfig as JCacheConfig
from sentio_tpu.infra import caching as jcaching
from sentio_tpu.infra import redis_cache as jredis
from sentio_tpu_torch.config import CacheConfig
from sentio_tpu_torch.infra import caching as tcaching
from sentio_tpu_torch.infra import redis_cache as tredis

TIMEOUT_S = 30.0


class LoopThread:
    """An asyncio loop on a thread: the fake server lives there, and JAX's
    client's coroutines are run there."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="fake-redis-loop",
                                       daemon=True)
        self.thread.start()

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(TIMEOUT_S)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=TIMEOUT_S)
        self.loop.close()


@pytest.fixture
def redis():
    lt = LoopThread()
    srv = FakeRedis()
    lt.run(srv.start())
    try:
        yield srv, lt
    finally:
        lt.run(srv.stop())
        lt.close()


@pytest.mark.parametrize("args", [("GET", "k"), ("SET", "sentio:q", '{"a": 1}', "PX", "10000"),
                                  ("PING",), ("DEL", b"\x00bin\xff"), ("AUTH", "pässword"),
                                  ("SELECT", "3"), ("SET", "", "")],
                         ids=lambda a: a[0])
def test_encode_command_matches_jax(args):
    assert tredis._encode_command(*args) == jredis._encode_command(*args)


def _port_flow(cache):
    out = [cache.ping()]
    cache.set("q1", {"answer": 42, "list": [1, "x"]}, ttl_s=10.0)
    out.append(cache.get("q1"))
    cache.set("q2", "plain", ttl_s=0.0001)
    out.append(cache.get("q2"))
    cache.delete("q1")
    out += [cache.get("q1"), cache.get("never")]
    return out


async def _jax_flow(cache):
    out = [await cache.ping()]
    await cache.set("q1", {"answer": 42, "list": [1, "x"]}, ttl_s=10.0)
    out.append(await cache.get("q1"))
    await cache.set("q2", "plain", ttl_s=0.0001)
    out.append(await cache.get("q2"))
    await cache.delete("q1")
    out += [await cache.get("q1"), await cache.get("never")]
    return out


@pytest.mark.parametrize("url_tail", ["/0", "/5", "/0?x=1"], ids=["db0", "db5", "query"])
@pytest.mark.parametrize("password", ["", "hunter2"])
def test_round_trip_and_commands_match_jax(redis, url_tail, password):
    srv, lt = redis
    auth = f":{password}@" if password else ""
    url = f"redis://{auth}127.0.0.1:{srv.port}{url_tail}"
    port_cache = tredis.RedisL2Cache(url=url)
    got = _port_flow(port_cache)
    port_cache.close()
    port_commands, srv.commands[:] = list(srv.commands), []
    jax_cache = jredis.RedisL2Cache(url=url)
    want = lt.run(_jax_flow(jax_cache))
    lt.run(jax_cache.close())
    assert got == want == [True, {"answer": 42, "list": [1, "x"]}, "plain", None, None]
    assert port_commands == srv.commands
    handshake = [b"AUTH"] * bool(password) + [b"SELECT"] * (url_tail == "/5")
    assert [c[0] for c in port_commands[:len(handshake) + 1]] == handshake + [b"PING"]
    sets = [c for c in port_commands if c[0] == b"SET"]
    assert sets[0][1] == b"sentio:q1" and sets[0][3:] == [b"PX", b"10000"]
    assert sets[1][4] == b"1"  # a TTL under a millisecond is sent as 1 ms


class RefusingRedis(FakeRedis):
    def _dispatch(self, args):
        if args[0].upper() == b"AUTH":
            return b"-WRONGPASS invalid username-password pair\r\n"
        return super()._dispatch(args)


def test_failed_handshake_drops_the_connection_as_jax():
    lt = LoopThread()
    srv = RefusingRedis()
    lt.run(srv.start())
    try:
        url = f"redis://:bad@127.0.0.1:{srv.port}/2"
        port_cache, jax_cache = tredis.RedisL2Cache(url=url), jredis.RedisL2Cache(url=url)
        assert port_cache.get("k") is None and port_cache._sock is None
        assert lt.run(jax_cache.get("k")) is None and jax_cache._writer is None
        # no command after the refused AUTH ran on the connection, in either
        assert [c[0] for c in srv.commands] == [b"AUTH", b"AUTH"]
        assert port_cache.ping() is False and lt.run(jax_cache.ping()) is False
    finally:
        lt.run(srv.stop())
        lt.close()


def test_down_server_reads_as_a_miss_as_jax():
    url = "redis://127.0.0.1:1/0"
    port_cache = tredis.RedisL2Cache(url=url, timeout_s=0.3)
    jax_cache = jredis.RedisL2Cache(url=url, timeout_s=0.3)

    async def jax_flow():
        out = [await jax_cache.get("k")]
        await jax_cache.set("k", "v", 5.0)
        await jax_cache.delete("k")
        return out + [await jax_cache.ping()]

    port_cache.set("k", "v", 5.0)
    port_cache.delete("k")
    assert [port_cache.get("k"), port_cache.ping()] == asyncio.run(jax_flow()) == [None, False]


def test_corrupt_json_is_a_miss_as_jax(redis):
    srv, lt = redis
    url = f"redis://127.0.0.1:{srv.port}/0"
    srv.store[b"sentio:bad"] = b"{not json"
    srv.store[b"sentio:good"] = json.dumps([1, 2]).encode()
    port_cache, jax_cache = tredis.RedisL2Cache(url=url), jredis.RedisL2Cache(url=url)
    assert [port_cache.get("bad"), port_cache.get("good")] == \
        [lt.run(jax_cache.get("bad")), lt.run(jax_cache.get("good"))] == [None, [1, 2]]
    port_cache.close()
    lt.run(jax_cache.close())


def test_port_client_reconnects_after_a_restart(redis):
    srv, lt = redis
    cache = tredis.RedisL2Cache(url=f"redis://127.0.0.1:{srv.port}/0")
    cache.set("a", 1, 5.0)
    assert cache.get("a") == 1
    lt.run(srv.stop())
    assert cache.get("a") is None  # degraded, no raise
    assert cache._sock is None  # the dead connection was dropped
    srv2 = FakeRedis()
    lt.run(srv2.start())
    try:
        cache.port = srv2.port  # the same client, a new endpoint
        assert cache.ping() is True
        cache.set("b", {"x": 1}, 5.0)
        assert cache.get("b") == {"x": 1} and srv2.store[b"sentio:b"] == b'{"x": 1}'
    finally:
        cache.close()
        lt.run(srv2.stop())
        lt.run(srv.start())  # the fixture stops it again


# ------------------------------------------------------------------ the manager


def test_tiered_get_promotes_an_l2_hit_as_jax(redis):
    srv, lt = redis
    url = f"redis://127.0.0.1:{srv.port}/0"
    srv.store[b"sentio:warm"] = json.dumps({"from": "l2"}).encode()
    mgr = tcaching.CacheManager(CacheConfig(backend="multi_tier", redis_url=url))
    jmgr = jcaching.CacheManager(JCacheConfig(backend="multi_tier", redis_url=url))
    assert mgr.tiered_get("warm") == lt.run(jmgr.aget("warm")) == {"from": "l2"}
    assert mgr.l1.get("warm") == jmgr.l1.get("warm") == {"from": "l2"}  # promoted
    assert mgr.tiered_get("cold") is None and lt.run(jmgr.aget("cold")) is None
    mgr.tiered_set("written", [1, 2], ttl_s=30.0)
    assert srv.store[b"sentio:written"] == b"[1, 2]"
    mgr.l1.clear()
    assert mgr.tiered_get("written") == [1, 2] and mgr.l1.get("written") == [1, 2]
    assert mgr.stats() == {**jmgr.stats(), "l1": mgr.l1.stats()}
    mgr.close()
    lt.run(jmgr.l2.close())


def test_multi_tier_with_no_redis_still_serves_l1_as_jax():
    cfg = dict(backend="multi_tier", redis_url="redis://127.0.0.1:1/0")
    mgr, jmgr = tcaching.CacheManager(CacheConfig(**cfg)), jcaching.CacheManager(
        JCacheConfig(**cfg))
    mgr.l2.timeout_s = jmgr.l2.timeout_s = 0.3
    mgr.set("k", "v")
    jmgr.set("k", "v")
    assert mgr.get("k") == jmgr.get("k") == "v"
    mgr.tiered_set("k2", "v2")

    async def jax_flow():
        await jmgr.aset("k2", "v2")
        return [await jmgr.aget("k2"), await jmgr.aget("nope")]

    assert [mgr.tiered_get("k2"), mgr.tiered_get("nope")] == asyncio.run(jax_flow())


@pytest.mark.parametrize("strategy", ["ttl", "size", "adaptive"])
def test_strategies_match_jax(strategy):
    def make(mod):
        return {"ttl": lambda: mod.TTLStrategy(120.0),
                "size": lambda: mod.SizeAwareStrategy(max_bytes=16, ttl_s=50.0),
                "adaptive": lambda: mod.AdaptiveStrategy(100.0)}[strategy]()

    script = [("query:a", "x"), ("query:b", None), ("emb:c", "y" * 40), ("query:a", {"k": 1})]

    def run(mod, config):
        mgr = mod.CacheManager(config(max_entries=3, default_ttl_s=7.0), strategy=make(mod))
        out = []
        for key, value in script:
            mgr.set(key, value)
            out.append((mgr.get(key), mgr.get("query:missing"),
                        mgr.strategy.should_cache(key, value), mgr.strategy.ttl_for(key, value)))
        return out, mgr.l1.stats()

    assert run(tcaching, CacheConfig) == run(jcaching, JCacheConfig)


def test_memory_cache_surface_matches_jax(monkeypatch):
    clock = {"t": 100.0}
    monkeypatch.setattr("time.perf_counter", lambda: clock["t"])

    def run(mod):
        cache = mod.MemoryCache(max_entries=4, default_ttl_s=10.0)
        for i, key in enumerate(["query:a", "query:b", "emb:c", "emb:d", "query:e"]):
            cache.set(key, i, ttl_s=5.0 if key.startswith("emb") else None)
        out = [cache.get("query:a"), cache.get("emb:c"), cache.delete("emb:d"),
               cache.delete("nope")]
        clock["t"] += 6.0
        out += [cache.cleanup_expired(), cache.clear("query:*"), cache.stats()]
        cache.set("x", 1)
        out += [cache.clear(), cache.stats()]
        clock["t"] = 100.0
        return out

    assert run(tcaching) == run(jcaching)
