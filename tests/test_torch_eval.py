"""The port's eval harness (``sentio_tpu_torch/eval``) against the JAX
package's (``sentio_tpu/eval``) on the same inputs.

* ``build_bundle`` gives equal documents, queries and ``n_facts`` for
  three seeds; the gate files equal JAX's.
* ``run_queries`` rows equal JAX's on a deterministic fake (errors
  included), one caller and several, apart from timings.
* The loopback mock server answers as JAX's (hash embeddings, the default
  ranking, the canned chat), and ``measure_baseline`` gives JAX's recall
  and HTTP calls over one persistent connection.
* The port's ``OpenAIProvider`` passes the cases of JAX's
  ``TestOpenAIProvider`` (``tests/test_eval.py``) against the port's mock
  server, and answers as JAX's provider does against JAX's.
* ``run_eval(scale="tiny")``: ``sparse_api`` recall equals JAX's, ``dense``
  recall too when both load ``artifacts/encoder-ck``, the payload's keys
  match, and both committed quality gates pass at JAX's ``GATE_ARGS``
  (``tests/test_eval.py``).

Every join has a timeout."""

import json
import threading
from pathlib import Path

import numpy as np
import pytest

from sentio_tpu.eval import baseline as jbaseline
from sentio_tpu.eval import dataset as jdataset
from sentio_tpu.eval import harness as jharness
from sentio_tpu.eval.runner import run_eval as jrun_eval
from sentio_tpu_torch import __main__ as cli
from sentio_tpu_torch.eval import baseline as tbaseline
from sentio_tpu_torch.eval import dataset as tdataset
from sentio_tpu_torch.eval import harness as tharness
from sentio_tpu_torch.eval.runner import run_eval
from sentio_tpu_torch.infra import http_client
from sentio_tpu_torch.ops.generator import OpenAIProvider

REPO = Path(__file__).resolve().parents[1]
CHECKPOINT = REPO / "artifacts" / "encoder-ck"
TIMEOUT_S = 120.0
# tests/test_eval.py's GATE_ARGS (both gates)
GATE_ARGS = dict(scale="tiny", n_docs=48, n_queries=4, concurrency=2, new_tokens=8,
                 verifier_tokens=4, skip_baseline=True, configs={"full_paged"}, device="cpu")


# ----------------------------------------------------------- dataset, gates


@pytest.mark.parametrize("seed", [0, 7, 13])
def test_build_bundle_matches_jax(seed):
    got, ref = tdataset.build_bundle(seed=seed), jdataset.build_bundle(seed=seed)
    assert [(d.id, d.text, d.metadata) for d in got.documents] == \
        [(d.id, d.text, d.metadata) for d in ref.documents]
    assert got.queries == ref.queries and got.n_facts == ref.n_facts and got.seed == seed


@pytest.mark.parametrize("name", ["quant_gate.json", "verify_gate.json"])
def test_gate_files_equal_jax(name):
    ours = json.loads((REPO / "sentio_tpu_torch" / "eval" / name).read_text())
    assert ours == json.loads((REPO / "sentio_tpu" / "eval" / name).read_text())


# ------------------------------------------------------------------ harness


def _fake(question):
    """Deterministic: raises on one question, else ids from its words."""
    if "explode" in question:
        raise RuntimeError("boom")
    words = question.split()
    return [type("D", (), {"id": w})() for w in words] + ["plain-id"], "answer"


QUERIES = [("alpha beta gamma", "beta"), ("delta", "zeta"), ("explode now", "x"),
           ("eta theta", "plain-id"), ("iota", "iota")] * 3


@pytest.mark.parametrize("concurrent", [1, 3])
def test_run_queries_matches_jax(concurrent):
    got = tharness.run_queries("fake", _fake, QUERIES, concurrent=concurrent).row()
    ref = jharness.run_queries("fake", _fake, QUERIES, concurrent=concurrent).row()
    timing = ("p50_ms", "p95_ms", "qps")
    assert {k: v for k, v in got.items() if k not in timing} == \
        {k: v for k, v in ref.items() if k not in timing}
    assert got["errors"] == 3 and got.keys() == ref.keys()


def test_recall_and_percentile_match_jax():
    for ids, gold, k in ((["a", "b"], "b", 10), (["a", "b"], "b", 1), ([], "a", 10)):
        assert tharness.recall_at_k(ids, gold, k) == jharness.recall_at_k(ids, gold, k)
    for vals in ([], [3.0], [1.0, 2.0, 5.0, 9.0]):
        for q in (0.0, 0.5, 0.95, 1.0):
            assert tharness._percentile(vals, q) == jharness._percentile(vals, q)


# ----------------------------------------------------- mock server, baseline


@pytest.fixture(scope="module")
def mock_server():
    server = tbaseline.MockModelServer(dim=64).start()
    yield server
    server.stop()


@pytest.fixture(scope="module")
def jax_mock_server():
    server = jbaseline.MockModelServer(dim=64).start()
    yield server
    server.stop()


def test_hash_embeddings_match_jax():
    from sentio_tpu.config import EmbedderConfig as JEmbedderConfig
    from sentio_tpu.ops.embedder import HashEmbedder

    texts = ["The Aurora compiler", "aurora   compiler the", "", "noise 12"]
    ref = HashEmbedder(JEmbedderConfig(provider="hash", dim=64, cache_size=0))._embed_batch(texts)
    np.testing.assert_array_equal(tbaseline.hash_embed(texts, 64), ref)


def test_mock_server_answers_as_jax(mock_server, jax_mock_server):
    bodies = [("/v1/embeddings", {"input": ["a b", "c"]}),
              ("/v1/rerank", {"query": "q", "documents": ["x", "y", "z"], "top_n": 2}),
              ("/v1/chat/completions", {"messages": [{"role": "user", "content": "[1] a\nb"}]}),
              ("/v1/chat/completions",
               {"messages": [{"role": "user", "content": 'audit "verdict" now'}]})]
    port = http_client.HttpClient(mock_server.base_url)
    ref = http_client.HttpClient(jax_mock_server.base_url)
    try:
        for path, body in bodies:
            got, want = port.post(path, body), ref.post(path, body)
            assert got.status_code == want.status_code == 200
            assert got.json() == want.json(), path
        assert port.post("/v1/nothing", {}).status_code == 404
        assert port.connections_opened == 1  # one keep-alive connection
    finally:
        port.close()
        ref.close()


def test_baseline_matches_jax():
    bundle = jdataset.build_bundle(n_docs=48, n_queries=4)
    ref = jbaseline.measure_baseline(bundle.documents, bundle.queries, dim=64)
    docs = tdataset.build_bundle(n_docs=48, n_queries=4).documents
    got = tbaseline.measure_baseline(docs, bundle.queries, dim=64)
    assert got.recall_at_10 == ref.recall_at_10 and got.n_queries == ref.n_queries == 4
    assert got.extras["http_calls"] == ref.extras["http_calls"]
    assert got.extras["http_calls"]["chat"] >= 4 and got.p50_ms > 0
    assert got.extras["http_connections"] == 1  # persistent, as httpx.Client pools it


# ----------------------------------------------------- OpenAIProvider cases


def test_provider_chat_roundtrip(mock_server, jax_mock_server):
    from sentio_tpu.ops.generator import OpenAIProvider as JOpenAIProvider

    provider = OpenAIProvider(base_url=mock_server.base_url + "/v1")
    out = provider.chat("[1] Source: a.md\nhello", max_new_tokens=16, temperature=0.0)
    assert isinstance(out, str) and out
    ref = JOpenAIProvider(base_url=jax_mock_server.base_url + "/v1")
    assert out == ref.chat("[1] Source: a.md\nhello", max_new_tokens=16, temperature=0.0)
    provider.close()
    ref.close()


def test_provider_stream_falls_back_to_chat(mock_server):
    # the mock server has no SSE: stream must still yield the text
    provider = OpenAIProvider(base_url=mock_server.base_url + "/v1")
    chunks = list(provider.stream("question?", max_new_tokens=16, temperature=0.0))
    assert "".join(chunks) == provider.chat("question?", max_new_tokens=16, temperature=0.0)
    provider.close()


def test_provider_from_config():
    from sentio_tpu_torch.config import GeneratorConfig

    provider = OpenAIProvider.from_config(GeneratorConfig(api_base="http://x/v1", api_model="m"))
    assert (provider.name, provider.base_url, provider.model) == ("openai", "http://x/v1", "m")


def test_provider_retries_then_raises():
    provider = OpenAIProvider(base_url="http://127.0.0.1:9/v1", max_retries=1, timeout_s=0.2)
    with pytest.raises(RuntimeError, match="after 2 attempts"):
        provider.chat("x", max_new_tokens=4, temperature=0.0)


def test_provider_api_v1_404_fallback_switches_base(mock_server):
    provider = OpenAIProvider(base_url=mock_server.base_url + "/api/v1")
    out = provider.chat("[1] Source: a.md\nhello", max_new_tokens=8, temperature=0.0)
    assert isinstance(out, str) and out
    assert provider.base_url == mock_server.base_url + "/v1"
    assert provider.chat("again?", max_new_tokens=8, temperature=0.0)
    provider.close()


def test_provider_usage_tracked_per_call(mock_server):
    provider = OpenAIProvider(base_url=mock_server.base_url + "/v1")
    provider.chat("count my tokens please", max_new_tokens=8, temperature=0.0)
    usage = provider.last_usage
    assert usage["prompt_tokens"] >= 1 and usage["completion_tokens"] >= 1
    provider.close()


def test_provider_switch_base_concurrent_threads_no_flap_no_leak(mock_server, monkeypatch):
    """Racing 404 fallbacks from 8 threads converge on one switch, every
    call succeeds, and every client ever built is closed."""
    created = []
    real = http_client.HttpClient

    class Tracking(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            created.append(self)

    monkeypatch.setattr("sentio_tpu_torch.ops.generator.HttpClient", Tracking)
    provider = OpenAIProvider(base_url=mock_server.base_url + "/api/v1")
    n = 8
    start = threading.Barrier(n)
    errors = []

    def worker(i):
        try:
            start.wait(timeout=10)
            assert provider.chat(f"[1] Source: a.md\nquestion {i}?", max_new_tokens=4,
                                 temperature=0.0)
        except Exception as exc:  # noqa: BLE001 — collected for the assert
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,), name=f"provider-{i}")
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert provider.base_url == mock_server.base_url + "/v1"
    assert provider.chat("settled?", max_new_tokens=4, temperature=0.0)
    provider.close()
    assert provider._client_cached is None and provider._retired_clients == []
    assert created and all(c.is_closed for c in created)


# --------------------------------------------------------------- run_eval


@pytest.fixture(scope="module")
def retrieval_payloads():
    args = dict(scale="tiny", n_docs=64, n_queries=6, new_tokens=4, skip_baseline=True,
                configs={"sparse_api", "dense"}, encoder_checkpoint=str(CHECKPOINT))
    return run_eval(**args, device="cpu"), jrun_eval(**args)


def test_run_eval_retrieval_recall_matches_jax(retrieval_payloads):
    got, ref = retrieval_payloads
    rows = {r["config"]: r for r in got["rows"]}
    ref_rows = {r["config"]: r for r in ref["rows"]}
    assert set(rows) == set(ref_rows) == {"1-bm25+api-llm", "2-dense-tpu"}
    for name in rows:
        assert rows[name]["recall@10"] == ref_rows[name]["recall@10"], name
        assert rows[name]["n"] == 6 and rows[name]["p50_ms"] > 0
    assert rows["1-bm25+api-llm"]["recall@10"] >= 0.5
    assert rows["2-dense-tpu"]["recall@10"] >= 0.5  # the trained encoder


def test_run_eval_payload_keys_match_jax(retrieval_payloads):
    got, ref = retrieval_payloads
    assert got.keys() == ref.keys()
    for key in ("bundle", "models"):
        assert got[key] == ref[key]
    assert got["platform"].keys() == ref["platform"].keys()
    assert got["platform"]["backend"] == "cpu"
    assert [r.keys() for r in got["rows"]] == [r.keys() for r in ref["rows"]]


def test_run_eval_full_graph_and_baseline(capsys):
    """``batched`` on the paged service (decode ticks live), the baseline,
    and the north star, through the CLI as a user runs it."""
    assert cli.main(["eval", "--scale", "tiny", "--docs", "48", "--queries", "3",
                     "--concurrency", "2", "--new-tokens", "4", "--configs",
                     "full_paged,batched", "--device", "cpu"]) == 0
    payload = json.loads(capsys.readouterr().out)
    rows = {r["config"]: r for r in payload["rows"]}
    assert rows["5-batched-dp"]["decode_ticks"] > 0 and not rows["5-batched-dp"].get("errors")
    assert rows["4-full-graph-paged"]["answer_chars_mean"] > 0
    assert payload["baseline"]["http_calls"]["chat"] >= 3
    assert set(payload["north_star"]) == {"target_speedup", "measured_p50_speedup",
                                          "recall_delta"}


def _gate(name):
    return json.loads((REPO / "sentio_tpu_torch" / "eval" / name).read_text())


def test_int8_quality_gate():
    """tests/test_eval.py::TestQuantQualityGate on the port."""
    gate = _gate("quant_gate.json")
    bf16 = run_eval(**GATE_ARGS)
    int8 = run_eval(**GATE_ARGS, kv_quant="int8")
    (bf_row,), (i8_row,) = bf16["rows"], int8["rows"]
    assert int8["kv_quant"] == "int8"
    assert i8_row.get("errors", 0) <= gate["errors_max"], i8_row
    assert bf_row["recall@10"] - i8_row["recall@10"] <= gate["recall_at_10_max_drop"]
    assert bf_row.get("answer_chars_mean", 0.0) > 0
    assert i8_row.get("answer_chars_mean", 0.0) >= \
        gate["answer_chars_min_ratio"] * bf_row["answer_chars_mean"]


def test_verify_quality_gate():
    """tests/test_eval.py::TestVerifyGate on the port."""
    gate = _gate("verify_gate.json")
    sync = run_eval(**GATE_ARGS, verify_mode="sync")
    gated = run_eval(**GATE_ARGS, verify_mode="gated")
    (sync_row,), (gated_row,) = sync["rows"], gated["rows"]
    assert gated["verify_mode"] == "gated"
    assert gated_row.get("errors", 0) <= gate["errors_max"], gated_row
    sync_v, gated_v = sync_row.get("verdicts") or {}, gated_row.get("verdicts") or {}
    common = set(sync_v) & set(gated_v)
    assert sync_v and gated_v and common
    agree = sum(1 for q in common if gated_v[q] == sync_v[q]
                or (gated_v[q] == "skipped_confident" and sync_v[q] == "pass"))
    assert agree / len(common) >= gate["min_verdict_agreement"]
    assert gated_row.get("verify_skip_rate", 0.0) <= gate["max_skip_rate"]
