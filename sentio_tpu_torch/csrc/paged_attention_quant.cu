// Paged decode attention for Hopper (sm_90a), int8 page pool with f16
// per-vector scales (the KV_QUANT=int8 pool), split over the pages of each
// row (flash-decoding), scores and values on the tensor cores.
//
// Replaces sentio_tpu/kernels/paged_attention.py::_paged_kernel_quant (the
// Pallas kernel behind paged_attention_quant / make_paged_attn_impl for an
// int8 pool). Same function as the bf16 kernel in paged_attention.cu, over
// codes and scales, the scales folded where the TPU kernel folds them:
//   score  s[r][t] = (q_r . Kq_t) * ks_t * sm_scale   (dot over raw codes)
//   value  acc[r] += (p[r][t] * vs_t) * Vq_t
// One new token per row attends over the row's own scattered pages, fp32
// online softmax, keys at positions <= lens[b] (the new token's K/V is
// already written at index lens[b]), pages past lens[b] / page never read,
// GQA folded, and a row with nothing to attend (l == 0) writes 0.
//
// Arithmetic. Codes lie in [-127, 127] (-128 only in unowned garbage), and
// every such integer is exact in bf16; q is bf16. So q . Kq on bf16
// mma.sync with fp32 sums is the TPU kernel's f32 dot up to summation
// order. The one change: p * vs_t, which the TPU kernel keeps in fp32,
// enters P V as two bf16 terms, hi (its upper 16 bits) and lo (the upper
// 16 bits of the remainder), each in its own mma, so it loses less than
// 2^-14 of itself. One bf16 term (the rounding the bf16 kernel applies to
// P) lost up to 2^-8: on a row of one key, whose output is that key's
// value, it doubled the bf16 output's rounding error (mean 1.5e-3 against
// the 2e-3 limit at a chat's decode shape). The second product costs
// little: the kernel waits on memory. tests/test_torch_kernels.py emulates
// the split.
//
// What bounds it on the H100 SXM (published peaks, 700 W): the bytes the
// rows own, sum(lens + 1) * Hkv * (D + 2) * 2 (codes plus f16 scales, K and
// V) at ~2 FLOP per byte: memory, 3.35 TB/s, about half the bf16 pool's
// bytes. A 128-token page of one kv head is 32 KB of codes.
//
// The design, two kernels launched by one entry point (the bf16 kernel's,
// whose shared pieces are in paged_common.cuh):
//   1. paged_decode_int8_kernel, grid (B, Hkv, n_spans), 128 threads. A
//      span is kPagesPerSpan consecutive pages of one row (n_spans =
//      ceil(NB / kPagesPerSpan)); a block whose span starts past its row's
//      last page exits at once. kPagesPerSpan is SENTIO_PAGES_PER_SPAN,
//      which the wrapper's build defines from its PAGES_PER_SPAN_QUANT
//      (kernels/paged_attention.py), chosen from 1, 2 and 4 by
//      chip_smoke.py's sweep. A block holds one page buffer and loads its
//      span's pages one after another into it. A page's valid K and V code
//      rows of this kv head are copied with cp.async 16-byte copies, never
//      the tail past the current token; the rows after them up to the next
//      multiple of 32 are zero-filled. The valid tokens' scales (2 bytes,
//      strided by Hkv) are loaded one a thread and staged as fp32, K's
//      premultiplied by sm_scale * log2(e); the padded rows' scales are
//      written as 0, and the softmax selects them out besides, so a NaN
//      scale past the row's length never meets the arithmetic.
//      Warp w takes tokens 32w .. 32w + 31 of the page. Both products are
//      mma.sync m16n8k16 (bf16 in, fp32 sums), the rep query heads the 16
//      rows of A (rows past rep zero), codes converted to bf16 in registers
//      (the float 2^23 + code + 128 built by byte_perm, minus the offset;
//      the exact float's upper half is its bf16, packed by byte_perm):
//      - S = Q K^T: ldmatrix on int8 rows gives a lane 4 consecutive codes
//        of one token, d = 4t .. 4t + 3 of a 16-wide group, so the k index
//        of the product runs over d permuted within each group (2t, 2t + 1,
//        2t + 8, 2t + 9 <-> 4t .. 4t + 3); q's A fragment is read in the
//        same order (one 8-byte load), and the dot does not care. The
//        scores stay in registers, are scaled by ks column by column, and
//        the softmax runs with two quad shuffles a row.
//      - acc += (P * vs) V: P is folded with vs in fp32 and split into the
//        hi and lo A fragments. ldmatrix.trans on the int8 V rows (as 16-bit
//        pairs) gives a lane the codes of tokens 2t, 2t + 1 at columns 2g,
//        2g + 1; byte_perm splits them into the B fragments of an "even"
//        (d = 2g) and an "odd" (d = 2g + 1) column block. So no bf16 copy
//        of V is staged (that tile would take ~64 KB more shared memory a
//        block at page 128, D 128), and the accumulator holds d permuted
//        within each 16 (a lane: 4t .. 4t + 3), unpermuted when written.
//      Each warp keeps its own (m, l, acc); the four merge in shared memory
//      and the block writes its unnormalised partial (m, l, acc[rep][D]) in
//      fp32 to scratch.
//   2. paged_combine_int8_kernel, grid (B * H), merges a row's live spans
//      in span order (no atomics: the same output every run) and writes
//      bf16 out; a row with none writes 0.
// Reads: q [B, H, D] bf16, the owned codes [P, page, Hkv, D] int8 and
// scales [P, page, Hkv] f16, page_table [B, NB] int32, lens [B] int32.
// Writes: out [B, H, D] bf16; scratch of at least B * H * n_spans * (D + 2)
// floats, allocated by the caller.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
constexpr int kVec = 16;     // int8 codes per 16-byte copy and per ldmatrix row
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPagesPerSpan = SENTIO_PAGES_PER_SPAN;
static_assert(kPagesPerSpan >= 1, "a span holds at least one page");

__host__ __device__ inline int rows_per_page(int page) {
  return (page + kChunk - 1) / kChunk * kChunk;
}

// A page buffer holds rows_per_page(page) rows of K codes then as many of
// V codes, each row D + kVec bytes (the padding puts the 8 rows an ldmatrix
// reads on distinct banks), then the rows' K and V scales as fp32.
__host__ __device__ inline size_t buffer_bytes(int D, int page) {
  const size_t rows = rows_per_page(page);
  return 2 * rows * (D + kVec) + 2 * rows * sizeof(float);
}

// The page buffer, or (after the last page) the warps' states for the
// merge: [kWarps][rep] m, l and [kWarps][rep][D] acc.
__host__ __device__ inline size_t smem_bytes(int rep, int D, int page) {
  const size_t merge = sizeof(float) * (size_t)kWarps * rep * (D + 2);
  const size_t pages = buffer_bytes(D, page);
  return pages > merge ? pages : merge;
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// The four int8 codes of a 32-bit word as exact floats: byte k, offset by
// 128, becomes the low byte of the float 2^23 + (code + 128).
__device__ __forceinline__ void codes_to_float(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | k)) - 8388736.f;
  }
}

// The bf16 pair (lo, hi) of two floats' upper 16 bits: exact for a float
// whose low half is 0 (an integer of at most 8 significant bits), else
// truncated toward zero.
__device__ __forceinline__ uint32_t pack_upper(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// The remainder of a float past its upper 16 bits (exact in fp32).
__device__ __forceinline__ float lower_part(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// S fragment of 8 tokens over one 16-wide d group: the word holds codes
// d = 4t .. 4t + 3 of token g, b0 the product's k = 2t, 2t + 1, b1 2t + 8,
// 2t + 9.
__device__ __forceinline__ void score_step(float (&s)[4], const uint32_t (&qa)[2], uint32_t w) {
  float f[4];
  codes_to_float(w, f);
  mma_16816(s, qa[0], qa[1], pack_upper(f[0], f[1]), pack_upper(f[2], f[3]));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_int8_kernel(const __nv_bfloat16* __restrict__ q,
                         const int8_t* __restrict__ k_q,
                         const __half* __restrict__ k_s,
                         const int8_t* __restrict__ v_q,
                         const __half* __restrict__ v_s,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lens,
                         float* __restrict__ part_acc,  // [B * H][n_spans][D]
                         float* __restrict__ part_ml,   // [B * H][n_spans][2]
                         int H, int Hkv, int page, int NB, int P, float sm_scale) {
  sentio::count_launch(0);
  constexpr int kp = D + kVec;  // row pitch in bytes
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
  float* ks_s = reinterpret_cast<float*>(smem_raw + 2 * (size_t)rows * kp);  // [rows]
  float* vs_s = ks_s + rows;                                                 // [rows]
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;  // fragment row: query head gr of the group
  const int t = lane & 3;    // fragment columns 2t, 2t + 1 of each 8
  const size_t tok_stride = (size_t)Hkv * D;  // codes between tokens of a page
  const float scale = sm_scale * kLog2e;      // scores in log2 units: exp2 below

  // tokens of page i this row may read (0 for an id outside the pool)
  auto valid_tokens = [&](int i) -> int {
    const int pid = page_table[b * NB + i];
    return (pid < 0 || pid >= P) ? 0 : min(page, cur + 1 - i * page);
  };
  // start the copies of page i's valid K and V code rows into the buffer
  // (zero-filling the rows after them up to the next multiple of kChunk),
  // and stage the valid tokens' scales (0 for the padded rows)
  auto issue = [&](int i) {
    const int n_valid = valid_tokens(i);
    const int n_rows = min(rows, (n_valid + kChunk - 1) / kChunk * kChunk);
    const size_t pid = n_valid > 0 ? (size_t)page_table[b * NB + i] : 0;
    const size_t page_off = pid * page * tok_stride + (size_t)g * D;
    const uint32_t k_dst = smem0;
    const uint32_t v_dst = k_dst + rows * kp;
    for (int c = tid; c < n_rows * (D / kVec); c += kThreads) {
      const int r = c / (D / kVec);
      const int x = (c - r * (D / kVec)) * kVec;
      const bool ok = r < n_valid;
      const size_t src = ok ? page_off + (size_t)r * tok_stride + x : 0;
      cp_async16(k_dst + r * kp + x, k_q + src, ok ? 16 : 0);
      cp_async16(v_dst + r * kp + x, v_q + src, ok ? 16 : 0);
    }
    cp_async_commit();
    for (int r = tid; r < n_rows; r += kThreads) {
      const size_t si = (pid * page + r) * Hkv + g;
      const bool ok = r < n_valid;
      ks_s[r] = ok ? __half2float(k_s[si]) * scale : 0.f;
      vs_s[r] = ok ? __half2float(v_s[si]) : 0.f;
    }
  };

  issue(p_begin);

  // A fragments of q: row gr (a query head of this group); for d group ks,
  // a0 = q[16ks + 4t], q[16ks + 4t + 1] and a2 = q[16ks + 4t + 2], q[16ks +
  // 4t + 3] (the permuted k order of score_step); heads past rep are zero
  uint32_t qa[D / 16][2];
  const __nv_bfloat16* q_row = q + ((size_t)b * H + (size_t)g * rep + gr) * D;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint2 v = gr < rep ? *reinterpret_cast<const uint2*>(q_row + 16 * ks + 4 * t)
                             : make_uint2(0u, 0u);
    qa[ks][0] = v.x;
    qa[ks][1] = v.y;
  }
  float m = -INFINITY, l = 0.f;  // row gr: m quad-uniform, l this lane's share
  // P V: column block n = 2c + parity of d group c holds d = 16c + 4t +
  // parity (e = 0) and 16c + 4t + 2 + parity (e = 1), rows gr (and gr + 8)
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ldmatrix row addresses of this lane (row lane % 8 of matrix lane / 8):
  // K, 8 tokens by four 16-byte groups; V, tokens 0-7 and 8-15 by two
  const uint32_t k_lane = (lane & 7) * kp + kVec * (lane >> 3);
  const uint32_t v_lane = (8 * ((lane >> 3) & 1) + (lane & 7)) * kp + kVec * (lane >> 4);

  for (int i = p_begin; i < p_end; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // page i and its scales are visible to every warp

    const int n_valid = valid_tokens(i);
    const uint32_t kb = smem0;
    const uint32_t vb = kb + rows * kp;
    for (int base = warp * kChunk; base < n_valid; base += kWarps * kChunk) {
      // S[16 x 32] = Q K^T over this warp's 32 tokens: 4 column blocks of 8
      float s[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        const uint32_t k_rows = kb + (base + 8 * nt) * kp + k_lane;
#pragma unroll
        for (int kk = 0; kk < D / 64; ++kk) {
          uint32_t w0, w1, w2, w3;
          ldmatrix_x4(k_rows + kk * 64, w0, w1, w2, w3);
          score_step(s[nt], qa[4 * kk], w0);
          score_step(s[nt], qa[4 * kk + 1], w1);
          score_step(s[nt], qa[4 * kk + 2], w2);
          score_step(s[nt], qa[4 * kk + 3], w3);
        }
        if constexpr (D % 64 != 0) {  // the last 32 codes of a row
          uint32_t w0, w1;
          ldmatrix_x2(k_rows + (D / 64) * 64, w0, w1);
          score_step(s[nt], qa[D / 16 - 2], w0);
          score_step(s[nt], qa[D / 16 - 1], w1);
        }
        // column scale ks * sm_scale * log2(e) of tokens 8nt + 2t, + 1
        const float2 ksc = *reinterpret_cast<const float2*>(ks_s + base + 8 * nt + 2 * t);
        s[nt][0] *= ksc.x;
        s[nt][1] *= ksc.y;
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
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2_approx(m - m_new);
      m = m_new;
      float pv[4][2];  // p * vs_t, 0 past the valid tokens (a select)
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 vsc = *reinterpret_cast<const float2*>(vs_s + base + 8 * nt + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = base + 8 * nt + 2 * t + e < n_valid;
          const float p = ok ? exp2_approx(s[nt][e] - m_new) : 0.f;
          sum += p;
          pv[nt][e] = ok ? p * (e ? vsc.y : vsc.x) : 0.f;
        }
      }
      l = l * alpha + sum;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha;

      // acc += (P vs) V: P vs as hi and lo bf16 A fragments (tokens 16kc ..
      // 16kc + 15 are the S column blocks 2kc and 2kc + 1); per 32 d, one
      // transposed ldmatrix gives the V codes of 16 tokens for four column
      // blocks, each taken by a hi and a lo product
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        const uint32_t pa0 = pack_upper(pv[2 * kc][0], pv[2 * kc][1]);
        const uint32_t pa2 = pack_upper(pv[2 * kc + 1][0], pv[2 * kc + 1][1]);
        const uint32_t pl0 = pack_upper(lower_part(pv[2 * kc][0]), lower_part(pv[2 * kc][1]));
        const uint32_t pl2 =
            pack_upper(lower_part(pv[2 * kc + 1][0]), lower_part(pv[2 * kc + 1][1]));
        const uint32_t v_rows = vb + (base + 16 * kc) * kp + v_lane;
#pragma unroll
        for (int n2 = 0; n2 < D / 32; ++n2) {
          uint32_t w[4];  // tokens 0-7 / 8-15 of d group 2n2, then of 2n2 + 1
          ldmatrix_x4_trans(v_rows + n2 * 32, w[0], w[1], w[2], w[3]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // codes of tokens 0-7 (f0) and 8-15 (f8) of the 16, each
            // (2t, d 2g), (2t, 2g + 1), (2t + 1, 2g), (2t + 1, 2g + 1)
            float f0[4], f8[4];
            codes_to_float(w[2 * h], f0);
            codes_to_float(w[2 * h + 1], f8);
            const int c = 2 * n2 + h;
            const uint32_t even0 = pack_upper(f0[0], f0[2]), even1 = pack_upper(f8[0], f8[2]);
            const uint32_t odd0 = pack_upper(f0[1], f0[3]), odd1 = pack_upper(f8[1], f8[3]);
            mma_16816(acc[2 * c], pa0, pa2, even0, even1);
            mma_16816(acc[2 * c], pl0, pl2, even0, even1);
            mma_16816(acc[2 * c + 1], pa0, pa2, odd0, odd1);
            mma_16816(acc[2 * c + 1], pl0, pl2, odd0, odd1);
          }
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
  __syncthreads();  // the page buffer becomes the merge area
  if (gr < rep) {
    if (t == 0) {
      mw_s[warp * rep + gr] = m;
      lw_s[warp * rep + gr] = l;
    }
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {  // d = 16c + 4t .. 16c + 4t + 3
      *reinterpret_cast<float4*>(aw_s + (warp * rep + gr) * D + 16 * c + 4 * t) =
          make_float4(acc[2 * c][0], acc[2 * c + 1][0], acc[2 * c][1], acc[2 * c + 1][1]);
    }
  }
  __syncthreads();
  const size_t q_row0 = (size_t)b * H + (size_t)g * rep;
  sentio::write_span_partial<kWarps, kThreads>(mw_s, lw_s, aw_s, rep, D, q_row0, n_spans,
                                               span, part_acc, part_ml);
}

__global__ void __launch_bounds__(kThreads)
paged_combine_int8_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ lens,
                          __nv_bfloat16* __restrict__ out,
                          int H, int D, int page, int NB, int n_spans) {
  sentio::count_launch(1);
  sentio::combine_spans<kPagesPerSpan, kThreads>(part_acc, part_ml, lens, out, H, D, page, NB,
                                                 n_spans);
}

// Raise the kernel's dynamic shared memory limit to smem bytes once (to the
// largest asked).
template <int D>
cudaError_t allow_smem(size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_int8_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  return cudaSuccess;
}

template <int D>
int launch(const void* q, const void* k_q, const void* k_s, const void* v_q, const void* v_s,
           const void* page_table, const void* lens, void* out, float* part_acc,
           float* part_ml, int B, int H, int Hkv, int page, int NB, int P, int n_spans,
           float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D, page);
  cudaError_t e = allow_smem<D>(smem);
  if (e != cudaSuccess) return (int)e;
  paged_decode_int8_kernel<D><<<dim3(B, Hkv, n_spans), kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k_q, (const __half*)k_s, (const int8_t*)v_q,
      (const __half*)v_s, (const int*)page_table, (const int*)lens, part_acc, part_ml, H, Hkv,
      page, NB, P, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_combine_int8_kernel<<<B * H, kThreads, 0, stream>>>(
      part_acc, part_ml, (const int*)lens, (__nv_bfloat16*)out, H, D, page, NB, n_spans);
  return (int)cudaGetLastError();
}

template <int D>
int occupancy(int rep, int page, int* blocks) {
  const size_t smem = smem_bytes(rep, D, page);
  cudaError_t e = allow_smem<D>(smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, paged_decode_int8_kernel<D>, kThreads, smem);
}

}  // namespace

extern "C" int paged_attention_int8(const void* q, const void* k_q, const void* k_s,
                                    const void* v_q, const void* v_s,
                                    const void* page_table, const void* lens, void* out,
                                    void* scratch, int B, int H, int Hkv, int D, int page,
                                    int NB, int P, float sm_scale, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxRep || page <= 0 || NB <= 0 || P <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_spans = (NB + kPagesPerSpan - 1) / kPagesPerSpan;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc + (size_t)B * H * n_spans * D;
  cudaStream_t s = (cudaStream_t)stream;
#define SENTIO_PAGED_ARGS q, k_q, k_s, v_q, v_s, page_table, lens, out, part_acc, part_ml, B, H, \
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

// Blocks of the split kernel one SM holds at once (registers and shared
// memory both counted by the CUDA runtime), into *blocks.
extern "C" int paged_attention_int8_occupancy(int rep, int D, int page, int* blocks) {
  switch (D) {
    case 32: return occupancy<32>(rep, page, blocks);
    case 64: return occupancy<64>(rep, page, blocks);
    case 128: return occupancy<128>(rep, page, blocks);
    case 256: return occupancy<256>(rep, page, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* sentio_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
