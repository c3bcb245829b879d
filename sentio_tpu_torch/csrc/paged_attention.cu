// Paged decode attention for Hopper (sm_90a), bf16 page pool, split over
// the pages of each row (flash-decoding), scores and values on the tensor
// cores.
//
// Replaces sentio_tpu/kernels/paged_attention.py::_paged_kernel (the Pallas
// kernel behind paged_attention / make_paged_attn_impl). Same function: one
// new token per row attends over the row's own scattered pages, online
// softmax in fp32, GQA folded (the rep query heads of a kv group share every
// K/V read), P rounded to bf16 before P V (the TPU kernel's
// p.astype(v.dtype)), pages past the row's length never read, keys masked
// to pos <= lens[b] (the new token's KV is already written at index
// lens[b]), and a row with nothing to attend (l == 0) writes 0.
//
// What bounds it on the H100 SXM (published peaks, 700 W): the K/V bytes
// the rows own, B * (lens + 1) * Hkv * D * 2 B * 2 (K and V), at ~1 FLOP
// per byte — memory, 3.35 TB/s. A 128-token page of one kv head is 64 KB,
// so a decode step reads a few MB to a few hundred MB: microseconds of HBM
// time. Walking a row's pages in order in one block, as the TPU kernel's
// sequential grid axis does, would put a long row on one SM: a launch would
// take the longest row's page count times one page's latency, with most SMs
// idle.
//
// The design, two kernels launched by one entry point:
//   1. paged_decode_kernel, grid (B, Hkv, n_spans), 128 threads. A span is
//      kPagesPerSpan consecutive pages of one row (n_spans =
//      ceil(NB / kPagesPerSpan), known without reading lens); a block
//      whose span starts past its row's last page exits at once, so a long
//      row spreads over many SMs and idle rows cost one early exit each.
//      kPagesPerSpan is SENTIO_PAGES_PER_SPAN, which the wrapper's build
//      defines from its PAGES_PER_SPAN (kernels/paged_attention.py): two
//      pages, chosen from 1, 2 and 4 by timing each build at a chat's
//      decode shape and a full serving batch (chip_smoke.py's sweep). A
//      block holds one page buffer and loads its span's pages one after
//      another into it, so three blocks share an SM and one block's loads
//      overlap another's math. A page is copied into shared
//      memory with cp.async 16-byte copies; only the valid rows are read,
//      never the tail past the current token, and the rows up to the next
//      multiple of 32 are zero-filled.
//      Warp w takes tokens 32w .. 32w + 31 of the page and runs both
//      products as mma.sync m16n8k16 (bf16 in, fp32 sums): the rep query
//      heads are the 16 rows of A (rows past rep are zero; A is built once
//      from q), K and V rows come in by ldmatrix (V transposed by it), and
//      the scores stay in registers, where the softmax runs with two quad
//      shuffles a row. Each warp keeps its own (m, l, acc); the four merge
//      in shared memory and the block writes its unnormalised partial (m,
//      l, acc[rep][D]) in fp32 to scratch.
//   2. paged_combine_kernel, grid (B * H), merges a row's live spans in
//      span order (no atomics: the same output every run) by the
//      log-sum-exp rule and writes bf16 out; a row with one span goes
//      through the same merge, a row with none writes 0.
// Reads: q [B, H, D], the owned K/V pages [P, page, Hkv, D], page_table
// [B, NB] int32, lens [B] int32. Writes: out [B, H, D]; scratch of at
// least B * H * n_spans * (D + 2) floats, allocated by the caller. The
// tensor-core helpers, the span merge and the combine's body live in
// paged_common.cuh, shared with the int8 kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cuda_common.cuh"
#include "paged_common.cuh"

#ifndef SENTIO_PAGES_PER_SPAN
#error "build with -DSENTIO_PAGES_PER_SPAN=<pages a block takes>"
#endif

namespace {

using sentio::cp_async16;
using sentio::cp_async_commit;
using sentio::cp_async_wait;
using sentio::exp2_approx;
using sentio::ldmatrix_x4;
using sentio::ldmatrix_x4_trans;
using sentio::live_pages;
using sentio::mma_16816;
using sentio::smem_addr;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;   // tokens a warp takes per page (4 mma columns of 8)
constexpr int kMaxRep = 8;   // query heads per kv head: the 8 live rows of A
constexpr int kVec = 8;      // bf16 per 16-byte copy and per ldmatrix row
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPagesPerSpan = SENTIO_PAGES_PER_SPAN;
static_assert(kPagesPerSpan >= 1, "a span holds at least one page");

// A page buffer holds rows_per_page(page) rows of K then as many of V, each
// row D + kVec bf16 (the padding puts the 8 rows an ldmatrix reads on
// distinct banks).
__host__ __device__ inline int rows_per_page(int page) {
  return (page + kChunk - 1) / kChunk * kChunk;
}

__host__ __device__ inline size_t buffer_bytes(int D, int page) {
  return 2 * (size_t)rows_per_page(page) * (D + kVec) * 2;
}

// The page buffer, or (after the last page) the warps' states for the
// merge: [kWarps][rep] m, l and [kWarps][rep][D] acc.
__host__ __device__ inline size_t smem_bytes(int rep, int D, int page) {
  const size_t merge = sizeof(float) * (size_t)kWarps * rep * (D + 2);
  const size_t pages = buffer_bytes(D, page);
  return pages > merge ? pages : merge;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lens,
                    float* __restrict__ part_acc,  // [B * H][n_spans][D]
                    float* __restrict__ part_ml,   // [B * H][n_spans][2]
                    int H, int Hkv, int page, int NB, int P, float sm_scale) {
  sentio::count_launch(0);
  constexpr int kp = D + kVec;  // row pitch in bf16
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int span = blockIdx.z;
  const int n_spans = gridDim.z;
  const int cur = lens[b];  // the new token sits at absolute index cur
  const int n_pages = live_pages(cur, page, NB);
  const int p_begin = span * kPagesPerSpan;
  if (p_begin >= n_pages) return;  // the combine never reads this span
  const int p_end = min(p_begin + kPagesPerSpan, n_pages);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t smem0 = smem_addr(smem_raw);
  const int rows = rows_per_page(page);
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;  // fragment row: query head gr of the group
  const int t = lane & 3;    // fragment columns 2t, 2t + 1 of each 8
  const size_t tok_stride = (size_t)Hkv * D;  // between tokens of a page

  // tokens of page i this row may read (0 for an id outside the pool)
  auto valid_tokens = [&](int i) -> int {
    const int pid = page_table[b * NB + i];
    return (pid < 0 || pid >= P) ? 0 : min(page, cur + 1 - i * page);
  };
  // start the copies of page i's valid K and V rows into the buffer, and
  // zero-fill the rows after them up to the next multiple of kChunk
  auto issue = [&](int i) {
    const int n_valid = valid_tokens(i);
    const int n_rows = min(rows, (n_valid + kChunk - 1) / kChunk * kChunk);
    const size_t page_off =
        (size_t)(n_valid > 0 ? page_table[b * NB + i] : 0) * page * tok_stride + (size_t)g * D;
    const uint32_t k_dst = smem0;
    const uint32_t v_dst = k_dst + rows * kp * 2;
    for (int c = tid; c < n_rows * (D / kVec); c += kThreads) {
      const int r = c / (D / kVec);
      const int x = (c - r * (D / kVec)) * kVec;
      const bool ok = r < n_valid;
      const size_t src = ok ? page_off + (size_t)r * tok_stride + x : 0;
      cp_async16(k_dst + (r * kp + x) * 2, k_pages + src, ok ? 16 : 0);
      cp_async16(v_dst + (r * kp + x) * 2, v_pages + src, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  issue(p_begin);

  // A fragments of q: row gr (a query head of this group) at columns
  // 16ks + 2t (a0) and 16ks + 8 + 2t (a2); heads past rep are zero rows
  uint32_t qa[D / 16][2];
  const __nv_bfloat16* q_row = q + ((size_t)b * H + (size_t)g * rep + gr) * D;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qa[ks][0] = gr < rep ? *reinterpret_cast<const uint32_t*>(q_row + 16 * ks + 2 * t) : 0u;
    qa[ks][1] = gr < rep ? *reinterpret_cast<const uint32_t*>(q_row + 16 * ks + 8 + 2 * t) : 0u;
  }
  const float scale = sm_scale * kLog2e;  // scores in log2 units: exp2 below
  float m = -INFINITY, l = 0.f;           // row gr: m quad-uniform, l this lane's share
  float acc[D / 8][4];                    // P V: columns 8n + 2t, 8n + 2t + 1 (and rows gr + 8)
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ldmatrix row addresses of this lane (row lane % 8 of matrix lane / 8)
  const uint32_t k_lane = ((lane & 7) * kp + 8 * (lane >> 3)) * 2;
  const uint32_t v_lane = ((8 * ((lane >> 3) & 1) + (lane & 7)) * kp + 8 * (lane >> 4)) * 2;

  for (int i = p_begin; i < p_end; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // page i is visible to every warp

    const int n_valid = valid_tokens(i);
    const uint32_t kb = smem0;
    const uint32_t vb = kb + rows * kp * 2;
    for (int base = warp * kChunk; base < n_valid; base += kWarps * kChunk) {
      // S[16 x 32] = Q K^T over this warp's 32 tokens: 4 column blocks of 8
      float s[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        const uint32_t k_rows = kb + (base + 8 * nt) * kp * 2 + k_lane;
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(k_rows + kk * 64, b0, b1, b2, b3);
          mma_16816(s[nt], qa[2 * kk][0], qa[2 * kk][1], b0, b1);
          mma_16816(s[nt], qa[2 * kk + 1][0], qa[2 * kk + 1][1], b2, b3);
        }
      }
      // online softmax of row gr over the 32 tokens: 8 here, the rest in
      // the quad; the chunk's first token is valid, so m stays finite
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (base + 8 * nt + 2 * t + e < n_valid) mx = fmaxf(mx, s[nt][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx * scale);
      const float alpha = exp2_approx(m - m_new);
      m = m_new;
      float p[4][2];
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = base + 8 * nt + 2 * t + e < n_valid;
          p[nt][e] = ok ? exp2_approx(fmaf(s[nt][e], scale, -m_new)) : 0.f;
          sum += p[nt][e];
        }
      l = l * alpha + sum;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha;

      // acc += P V: P as bf16 A fragments (tokens 16kc .. 16kc + 15 are the
      // S column blocks 2kc and 2kc + 1), V rows transposed by ldmatrix
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        const uint32_t pa0 = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
        const uint32_t pa2 = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
        const uint32_t v_rows = vb + (base + 16 * kc) * kp * 2 + v_lane;
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(v_rows + n2 * 32, b0, b1, b2, b3);
          mma_16816(acc[2 * n2], pa0, pa2, b0, b1);
          mma_16816(acc[2 * n2 + 1], pa0, pa2, b2, b3);
        }
      }
    }
    if (i + 1 < p_end) {
      __syncthreads();  // every warp is done with the buffer
      issue(i + 1);
    }
  }

  // merge the four warps' states, then write this span's partial
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* mw_s = reinterpret_cast<float*>(smem_raw);  // [kWarps][rep]
  float* lw_s = mw_s + kWarps * rep;                 // [kWarps][rep]
  float* aw_s = lw_s + kWarps * rep;                 // [kWarps][rep][D]
  __syncthreads();  // the page buffers become the merge area
  if (gr < rep) {
    if (t == 0) {
      mw_s[warp * rep + gr] = m;
      lw_s[warp * rep + gr] = l;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(aw_s + (warp * rep + gr) * D + 8 * n + 2 * t) =
          make_float2(acc[n][0], acc[n][1]);
    }
  }
  __syncthreads();
  const size_t q_row0 = (size_t)b * H + (size_t)g * rep;
  sentio::write_span_partial<kWarps, kThreads>(mw_s, lw_s, aw_s, rep, D, q_row0, n_spans,
                                               span, part_acc, part_ml);
}

__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml,
                     const int* __restrict__ lens,
                     __nv_bfloat16* __restrict__ out,
                     int H, int D, int page, int NB, int n_spans) {
  sentio::count_launch(1);
  sentio::combine_spans<kPagesPerSpan, kThreads>(part_acc, part_ml, lens, out, H, D, page, NB,
                                                 n_spans);
}

template <int D>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* page_table,
           const void* lens, void* out, float* part_acc, float* part_ml, int B, int H,
           int Hkv, int page, int NB, int P, int n_spans, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D, page);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t smem_allowed = 48 * 1024;  // raised once, to the largest asked
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  paged_decode_kernel<D><<<dim3(B, Hkv, n_spans), kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)page_table, (const int*)lens,
      part_acc, part_ml, H, Hkv, page, NB, P, sm_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_combine_kernel<<<B * H, kThreads, 0, stream>>>(
      part_acc, part_ml, (const int*)lens, (__nv_bfloat16*)out, H, D, page, NB, n_spans);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_bf16(const void* q, const void* k_pages,
                                    const void* v_pages, const void* page_table,
                                    const void* lens, void* out, void* scratch,
                                    int B, int H, int Hkv, int D, int page,
                                    int NB, int P, float sm_scale, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxRep || page <= 0 || NB <= 0 || P <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_spans = (NB + kPagesPerSpan - 1) / kPagesPerSpan;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc + (size_t)B * H * n_spans * D;
  cudaStream_t s = (cudaStream_t)stream;
#define SENTIO_PAGED_ARGS q, k_pages, v_pages, page_table, lens, out, part_acc, part_ml, B, H, \
                          Hkv, page, NB, P, n_spans, sm_scale, s
  switch (D) {
    case 32: return launch<32>(SENTIO_PAGED_ARGS);
    case 64: return launch<64>(SENTIO_PAGED_ARGS);
    case 128: return launch<128>(SENTIO_PAGED_ARGS);
    case 256: return launch<256>(SENTIO_PAGED_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SENTIO_PAGED_ARGS
}

extern "C" const char* sentio_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
