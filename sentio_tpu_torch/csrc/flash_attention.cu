// Blockwise online-softmax attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces sentio_tpu/kernels/flash_attention.py::_flash_kernel (the Pallas
// kernel behind flash_attention, encoder_attn_fn and flash_attn_fn). Same
// function: q [B, T, H, D], k/v [B, S, H, D] (kv heads already expanded),
// per-row key lengths kv_lens [B] masking k_pos >= kv_lens[b], an optional
// causal mask k_pos <= q_pos, fp32 online softmax, and 0 for a query row
// with nothing to attend (l == 0) — including every row of a kv_lens == 0
// batch entry. The TPU kernel padded head_dim to 128 for its MXU; nothing
// here needs that.
//
// Launch geometry: grid (B * H, ceil(T / 64)), 256 threads. One block per
// (b*h, 64-row q tile) loops over 64-key tiles in order:
//   1. K and V tiles are staged in shared memory as fp32 (rows past the
//      last attendable key are zero-filled, so padding never leaks);
//   2. S = Q K^T: each thread owns a 4 x 4 register tile of scores;
//   3. masked online-softmax update, one warp per 8 query rows;
//   4. O = O * alpha + P V: each thread owns 4 rows x D/16 output columns.
// Tiles past min(kv_lens[b], S) (and, when causal, past the tile's last
// query row) are never loaded: the loop ends where the row's keys end.
// Reads: q, k, v once per (q tile, k tile) pair, kv_lens. Writes: out.
//
// Bound on the H100: the encoder shapes (T <= 512, D 32 or 64) do
// 4 * T * S * D operations per head over 2 * (T + S) * D * 2 bytes — above
// the ridge, so the tensor-core rate (989 TFLOP/s bf16) bounds it. This
// first version runs the products on the CUDA cores in fp32 (67 TFLOP/s
// peak), so it sits well above that bound; wgmma tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -FLT_MAX;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (D + 1)      // Q tile, padded row
         + (size_t)kBK * (D + 1)    // K tile, padded row
         + (size_t)kBK * D          // V tile
         + (size_t)kBQ * (kBK + 1)  // scores / probabilities
         + 3 * kBQ;                 // m, l, alpha
}

// Stage rows [row0, row0 + rows) of one (b, h) slice into fp32 shared memory
// with row pitch `pitch`; rows at or past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const __nv_bfloat16* __restrict__ src,
                                          size_t row_stride, int row0, int rows,
                                          int limit) {
  constexpr int kPairs = D / 2;
  for (int i = threadIdx.x; i < rows * kPairs; i += kThreads) {
    const int r = i / kPairs;
    const int c = (i - r * kPairs) * 2;
    float2 f = make_float2(0.f, 0.f);
    if (row0 + r < limit) {
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          src + (size_t)(row0 + r) * row_stride + c));
    }
    dst[r * pitch + c] = f.x;
    dst[r * pitch + c + 1] = f.y;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ kv_lens,
                 __nv_bfloat16* __restrict__ out,
                 int T, int S, int H, float sm_scale, int causal) {
  constexpr int kDP = D + 1;
  constexpr int kPP = kBK + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * kDP;
  float* Vs = Ks + kBK * kDP;
  float* Ps = Vs + kBK * D;
  float* ms = Ps + kBQ * kPP;
  float* ls = ms + kBQ;
  float* as = ls + kBQ;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;   // rows ty*4 .. ty*4+3
  const int tx = tid & 15;   // cols tx + 16*j
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const size_t row_stride = (size_t)H * D;
  const __nv_bfloat16* qb = q + ((size_t)b * T * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * S * H + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * S * H + h) * D;
  __nv_bfloat16* ob = out + ((size_t)b * T * H + h) * D;

  int kv_len = min(kv_lens[b], S);
  if (kv_len < 0) kv_len = 0;
  const int k_end = causal ? min(kv_len, q0 + kBQ) : kv_len;

  load_tile<D>(Qs, kDP, qb, row_stride, q0, kBQ, T);
  if (tid < kBQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    load_tile<D>(Ks, kDP, kb, row_stride, k0, kBK, k_end);
    load_tile<D>(Vs, D, vb, row_stride, k0, kBK, k_end);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * kDP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * kDP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool valid = k_pos < kv_len && (!causal || k_pos <= q_pos);
        Ps[(ty * 4 + i) * kPP + tx + 16 * j] = valid ? sc[i][j] * sm_scale : kNegInf;
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      const float s0 = Ps[r * kPP + lane];
      const float s1 = Ps[r * kPP + lane + 32];
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const bool live = m_new > kNegInf * 0.5f;
      const float p0 = live ? expf(s0 - m_new) : 0.f;
      const float p1 = live ? expf(s1 - m_new) : 0.f;
      Ps[r * kPP + lane] = p0;
      Ps[r * kPP + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = live ? expf(m_prev - m_new) : 1.f;
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + sum;
        as[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = as[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kPP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
    __syncthreads();  // the next tile overwrites Ks, Vs and Ps
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + ty * 4 + i;
    if (q_pos < T) {
      const float l = ls[ty * 4 + i];
      const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        ob[(size_t)q_pos * row_stride + tx + 16 * c] = __float2bfloat16(acc[i][c] * inv);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_lens,
           void* out, int B, int T, int S, int H, float sm_scale, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B * H, (T + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int*)kv_lens, (__nv_bfloat16*)out, T, S, H, sm_scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* kv_lens, void* out, int B, int T,
                                    int S, int H, int D, float sm_scale,
                                    int causal, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(q, k, v, kv_lens, out, B, T, S, H, sm_scale, causal, s);
    case 32: return launch<32>(q, k, v, kv_lens, out, B, T, S, H, sm_scale, causal, s);
    case 64: return launch<64>(q, k, v, kv_lens, out, B, T, S, H, sm_scale, causal, s);
    case 128: return launch<128>(q, k, v, kv_lens, out, B, T, S, H, sm_scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* sentio_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
