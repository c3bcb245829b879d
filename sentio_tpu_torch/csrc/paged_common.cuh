// Pieces shared by the two paged-decode kernels (paged_attention.cu, bf16
// pages, and paged_attention_quant.cu, int8 pages): the warp-level
// tensor-core helpers (ldmatrix x4, plain and transposed; mma.sync m16n8k16
// with the rep query heads as the live rows of A), a row's live page
// count, the block's merge of its warps' softmax states into one span
// partial, and the combine pass that merges a row's span partials in span
// order.
//
// Partials live in scratch the caller allocates: part_acc [B * H][n_spans][D]
// and, after it, part_ml [B * H][n_spans][2] (m in log2 units, l), fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cuda_common.cuh"

namespace sentio {

// Pages of a row whose current token sits at index cur (a row with cur < 0
// has none).
__device__ __forceinline__ int live_pages(int cur, int page, int NB) {
  return cur < 0 ? 0 : min(cur / page + 1, NB);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// d[4] += A[16 x 16] * B[16 x 8]; A rows 8..15 are zero here, so a[1] and
// a[3] are 0 and d[2], d[3] (rows g + 8) are never read.
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a2,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// After the warps of a block have left their states in shared memory
// (mw_s, lw_s [kWarps][rep], aw_s [kWarps][rep][D], synchronised), merge
// them by the log-sum-exp rule and write the span's partial for query heads
// q_row0 .. q_row0 + rep - 1.
template <int kWarps, int kThreads>
__device__ __forceinline__ void write_span_partial(const float* mw_s, const float* lw_s,
                                                   const float* aw_s, int rep, int D,
                                                   size_t q_row0, int n_spans, int span,
                                                   float* __restrict__ part_acc,
                                                   float* __restrict__ part_ml) {
  for (int idx = threadIdx.x; idx < rep * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw_s[w * rep + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = mw_s[w * rep + r];
      const float wgt = mw == -INFINITY ? 0.f : exp2_approx(mw - mx);
      lsum += wgt * lw_s[w * rep + r];
      a += wgt * aw_s[(w * rep + r) * D + d];
    }
    const size_t slot = (q_row0 + r) * n_spans + span;
    part_acc[slot * D + d] = a;
    if (d == 0) {
      part_ml[slot * 2] = mx;
      part_ml[slot * 2 + 1] = lsum;
    }
  }
}

// The combine pass of one (row, query head), blockIdx.x = b * H + h: merge
// the row's live spans in span order (no atomics: the same output every
// run) by the log-sum-exp rule and write bf16 out; a row with one span goes
// through the same merge, a row with none writes 0.
template <int kPagesPerSpan, int kThreads>
__device__ __forceinline__ void combine_spans(const float* __restrict__ part_acc,
                                              const float* __restrict__ part_ml,
                                              const int* __restrict__ lens,
                                              __nv_bfloat16* __restrict__ out,
                                              int H, int D, int page, int NB, int n_spans) {
  const int bh = blockIdx.x;
  const int n_pages = live_pages(lens[bh / H], page, NB);
  const int live = (n_pages + kPagesPerSpan - 1) / kPagesPerSpan;
  const float* ml = part_ml + (size_t)bh * n_spans * 2;
  const float* pa = part_acc + (size_t)bh * n_spans * D;
  float mx = -INFINITY;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < live; ++s) {
      const float ms = ml[2 * s];
      const float wgt = ms == -INFINITY ? 0.f : exp2_approx(ms - mx);
      lsum += wgt * ml[2 * s + 1];
      a += wgt * pa[(size_t)s * D + d];
    }
    out[(size_t)bh * D + d] = __float2bfloat16(lsum == 0.f ? 0.f : a / lsum);
  }
}

}  // namespace sentio
