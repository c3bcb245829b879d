// Native BM25 scoring core — the host-side hot loop of sparse retrieval.
//
// The port's own copy of sentio_tpu/native/bm25.cpp (same C ABI, same
// arithmetic). It scores a CSR postings index built by
// sentio_tpu_torch/ops/bm25.py, which owns tokenization and vocab so Python
// and native scores agree bit-for-bit on the same inputs. Host code: it
// runs on the CPU beside the dense leg on the GPU.
//
// The index arrays are BORROWED from numpy (zero-copy): the Python wrapper
// keeps them alive for the handle's lifetime. C ABI throughout — consumed
// via ctypes, no pybind11.
//
// Scoring math (mirrors BM25Index.scores):
//   contrib = idf[t] * (tf * (k1 + 1) / (tf + norm[doc]) + delta)
// accumulated over query-term occurrences; norm[d] = k1*(1-b+b*dl/avgdl)
// is precomputed Python-side.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

struct SBm25 {
  int32_t n_docs;
  int32_t n_terms;
  const int64_t* term_offsets;  // [n_terms + 1]
  const int32_t* post_docs;     // [nnz]
  const float* post_tfs;        // [nnz]
  const float* idf;             // [n_terms]
  const float* norm;            // [n_docs]
  float k1;
  float delta;
};

void* sbm25_create(int32_t n_docs, int32_t n_terms, const int64_t* term_offsets,
                   const int32_t* post_docs, const float* post_tfs,
                   const float* idf, const float* norm, float k1, float delta) {
  auto* h = new SBm25();
  h->n_docs = n_docs;
  h->n_terms = n_terms;
  h->term_offsets = term_offsets;
  h->post_docs = post_docs;
  h->post_tfs = post_tfs;
  h->idf = idf;
  h->norm = norm;
  h->k1 = k1;
  h->delta = delta;
  return h;
}

void sbm25_destroy(void* handle) { delete static_cast<SBm25*>(handle); }

// Accumulate scores for one query (term ids WITH repeats, matching the
// Python np.add.at semantics) into a zeroed [n_docs] accumulator, recording
// touched docs. The handle is READ-ONLY here — all scratch is caller-owned,
// so any number of threads may score against one handle concurrently.
static void score_into(const SBm25* h, const int32_t* qids, int32_t n_q,
                       float* acc, std::vector<int32_t>* touched) {
  const float k1p1 = h->k1 + 1.0f;
  for (int32_t qi = 0; qi < n_q; ++qi) {
    const int32_t t = qids[qi];
    if (t < 0 || t >= h->n_terms) continue;
    const int64_t start = h->term_offsets[t];
    const int64_t end = h->term_offsets[t + 1];
    const float idf_t = h->idf[t];
    for (int64_t p = start; p < end; ++p) {
      const int32_t d = h->post_docs[p];
      const float tf = h->post_tfs[p];
      const float contrib = idf_t * (tf * k1p1 / (tf + h->norm[d]) + h->delta);
      if (touched != nullptr && acc[d] == 0.0f) touched->push_back(d);
      acc[d] += contrib;
    }
  }
}

// Dense score vector over the whole corpus (parity/fusion path). ``out`` is
// the accumulator itself — no handle scratch, no lock needed.
void sbm25_scores(void* handle, const int32_t* qids, int32_t n_q, float* out) {
  const auto* h = static_cast<const SBm25*>(handle);
  std::memset(out, 0, sizeof(float) * static_cast<size_t>(h->n_docs));
  score_into(h, qids, n_q, out, nullptr);
}

// Top-k by score (descending, ties broken by ascending doc id for
// determinism). Only docs with score > 0 are returned. Returns the count
// written into out_idx/out_scores (<= top_k). Scratch is a thread_local
// accumulator cleared via the touched list after each query — short
// queries never pay an O(n_docs) memset, and per-thread scratch keeps
// concurrent searches against one handle lock-free.
int32_t sbm25_search(void* handle, const int32_t* qids, int32_t n_q,
                     int32_t top_k, int32_t* out_idx, float* out_scores) {
  const auto* h = static_cast<const SBm25*>(handle);
  thread_local std::vector<float> acc;
  const auto need = static_cast<size_t>(h->n_docs);
  if (acc.size() < need) {
    acc.resize(need, 0.0f);
  } else if (acc.size() > 4 * need && acc.size() > (1u << 20)) {
    // corpus shrank a lot (rebuild/handle swap): release the excess rather
    // than pinning peak-corpus scratch per thread forever
    std::vector<float>(need, 0.0f).swap(acc);
  }
  std::vector<int32_t> docs;
  docs.reserve(1024);
  score_into(h, qids, n_q, acc.data(), &docs);

  // ``docs`` may hold duplicates (a zero contrib leaves acc at 0, so the
  // same doc can be pushed again); drop exact duplicates. Top-k selection
  // happens IN PLACE but never truncates — the full list doubles as the
  // touched set that restores acc's all-zero invariant at the end. (No
  // exception guard: the only caller is ctypes, where a C++ exception
  // escaping the C ABI terminates the process anyway.)
  std::sort(docs.begin(), docs.end());
  docs.erase(std::unique(docs.begin(), docs.end()), docs.end());

  const auto cmp = [&acc](int32_t a, int32_t b) {
    const float sa = acc[a], sb = acc[b];
    if (sa != sb) return sa > sb;
    return a < b;
  };
  const size_t k = std::min(static_cast<size_t>(top_k), docs.size());
  if (k > 0 && k < docs.size()) {
    std::nth_element(docs.begin(), docs.begin() + static_cast<int64_t>(k) - 1,
                     docs.end(), cmp);
  }
  std::sort(docs.begin(), docs.begin() + static_cast<int64_t>(k), cmp);

  int32_t written = 0;
  for (size_t i = 0; i < k; ++i) {
    const int32_t d = docs[i];
    if (acc[d] <= 0.0f) break;
    out_idx[written] = d;
    out_scores[written] = acc[d];
    ++written;
  }
  // restore the all-zero invariant for the next query on this thread
  for (const int32_t d : docs) acc[d] = 0.0f;
  return written;
}

int32_t sbm25_version() { return 1; }

}  // extern "C"
