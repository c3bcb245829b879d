// Paged decode attention for Hopper (sm_90a), int8 page pool with f16
// per-vector scales (the KV_QUANT=int8 pool).
//
// Replaces sentio_tpu/kernels/paged_attention.py::_paged_kernel_quant (the
// Pallas kernel behind paged_attention_quant / make_paged_attn_impl for an
// int8 pool). Same function as the bf16 kernel in paged_attention.cu, over
// codes and scales that are dequantized in registers:
//   score  s[r][t] = (q_r . Kq_t) * ks_t * sm_scale   (dot over raw codes)
//   value  acc[r] += (p[r][t] * vs_t) * Vq_t          (p kept in fp32)
// One new token per row attends over the row's own scattered pages, keys
// at positions <= lens[b] (the new token's K/V is already written at index
// lens[b]), pages past lens[b] / page never read, GQA folded, and a row
// with nothing to attend (l == 0) writes 0. The scale of a token past the
// row's length is never read, so a NaN there cannot reach the output.
//
// Launch geometry: grid (B, Hkv), 128 threads, as paged_attention.cu. The
// block reads page_table[b, i] itself and walks pages 0 .. lens[b] / page in
// order, carrying (m, l, acc) in fp32. Per page:
//   1. the page's int8 K and V rows of this kv head (each D contiguous
//      bytes; at D = 128 a row is 8 loads of 16 codes) are staged in shared
//      memory, 8 K and 8 V 16-byte loads in flight per thread, and each
//      valid token's two f16 scales (strided by Hkv within the page) are
//      staged as fp32;
//   2. scores: thread t owns token t, converts its K codes to float 16 at
//      a time and takes (q . k_t) * ks_t * sm_scale for all rep heads;
//   3. softmax update: one warp per head row; the page's probabilities are
//      folded with the value scales (p * vs_t) where they are stored;
//   4. acc update: thread d owns output column d (for every rep head) and
//      sums (p * vs)[r][t] * Vq[t][d] over the staged V codes.
// Reads: q [B, H, D] bf16, the owned codes [P, page, Hkv, D] int8 and
// scales [P, page, Hkv] f16, page_table [B, NB] int32, lens [B] int32.
// Writes: out [B, H, D] bf16.
//
// Bound on the H100: the bytes the rows own, sum(lens + 1) * Hkv * (D + 2)
// * 2 (codes plus scales, K and V) — about half the bf16 pool's bytes; the
// arithmetic is ~2 FLOP per byte. Like the bf16 kernel this design is
// latency-bound, not bandwidth-bound: one 4-warp block per (row, kv head)
// walks a whole row on one SM, a page's loads are not overlapped with the
// previous page's math (no cp.async / TMA double buffering), and B * Hkv
// blocks (64 at the serving batch) leave most of the 132 SMs idle. Split-K
// over the pages of a long row is the known next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;            // query heads per kv head
constexpr int kMaxColsPerThread = 2;  // D <= 256
constexpr int kVec = 16;              // int8 codes per 16-byte load
constexpr int kBatch = 8;             // 16-byte loads in flight per thread
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

// Shared memory, in order: K codes [page][D + kVec] int8 (padded so 16-byte
// reads of consecutive rows fall on different banks), V codes [page][D]
// int8, then fp32 K scales [page], V scales [page], q [rep][D], scores
// [rep][page], m, l, alpha [rep]. D % 16 == 0 keeps every part 16-byte
// aligned.
__host__ __device__ inline size_t smem_bytes(int rep, int D, int page) {
  return (size_t)page * (D + kVec) + (size_t)page * D +
         sizeof(float) * (2 * (size_t)page + (size_t)rep * D + (size_t)rep * page + 3 * rep);
}

__global__ void __launch_bounds__(kThreads)
paged_decode_int8_kernel(const __nv_bfloat16* __restrict__ q,
                         const int8_t* __restrict__ k_q,
                         const __half* __restrict__ k_s,
                         const int8_t* __restrict__ v_q,
                         const __half* __restrict__ v_s,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lens,
                         __nv_bfloat16* __restrict__ out,
                         int H, int Hkv, int D, int page, int NB, int P,
                         float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rep = H / Hkv;
  const int kp = D + kVec;  // K row pitch in bytes
  int8_t* kq_s = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* vq_s = kq_s + (size_t)page * kp;
  float* ks_s = reinterpret_cast<float*>(vq_s + (size_t)page * D);  // [page]
  float* vs_s = ks_s + page;       // [page]
  float* q_s = vs_s + page;        // [rep][D]
  float* s_s = q_s + rep * D;      // [rep][page] scores, then p * vs
  float* m_s = s_s + rep * page;   // [rep] running max
  float* l_s = m_s + rep;          // [rep] running normalizer
  float* a_s = l_s + rep;          // [rep] this page's rescale factor

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cur = lens[b];  // the new token sits at absolute index cur

  const size_t q_row0 = (size_t)b * H + (size_t)g * rep;
  for (int i = tid; i < rep * D; i += kThreads) {
    q_s[i] = __bfloat162float(q[q_row0 * D + i]);
  }
  if (tid < rep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxRep][kMaxColsPerThread];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int j = 0; j < kMaxColsPerThread; ++j) acc[r][j] = 0.f;

  const size_t tok_stride = (size_t)Hkv * D;  // codes between tokens of a page
  const int vecs = D / kVec;                  // 16-byte chunks per row
  const int n_pages = cur < 0 ? 0 : min(cur / page + 1, NB);
  for (int i = 0; i < n_pages; ++i) {
    const int pid = page_table[b * NB + i];
    if (pid < 0 || pid >= P) continue;  // never read outside the pool
    const int n_valid = min(page, cur + 1 - i * page);
    const size_t page_off = (size_t)pid * page * tok_stride + (size_t)g * D;

    // 1. stage the valid K and V code rows (consecutive threads read
    //    consecutive 16-byte chunks of a row) and the valid tokens' scales.
    //    Each thread issues kBatch K and kBatch V loads before it stores any.
    const int n_chunks = n_valid * vecs;
    for (int c0 = tid; c0 < n_chunks; c0 += kThreads * kBatch) {
      int4 kr[kBatch], vr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u * kThreads;
        if (c < n_chunks) {
          const int t = c / vecs;
          const size_t src = page_off + (size_t)t * tok_stride + (c - t * vecs) * kVec;
          kr[u] = *reinterpret_cast<const int4*>(k_q + src);
          vr[u] = *reinterpret_cast<const int4*>(v_q + src);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u * kThreads;
        if (c < n_chunks) {
          const int t = c / vecs;
          const int x = (c - t * vecs) * kVec;
          *reinterpret_cast<int4*>(kq_s + t * kp + x) = kr[u];
          *reinterpret_cast<int4*>(vq_s + t * D + x) = vr[u];
        }
      }
    }
    for (int t = tid; t < n_valid; t += kThreads) {
      const size_t si = ((size_t)pid * page + t) * Hkv + g;
      ks_s[t] = __half2float(k_s[si]);
      vs_s[t] = __half2float(v_s[si]);
    }
    __syncthreads();

    // 2. scores s[r][t] = (q_r . kq_t) * ks_t * sm_scale, one token per thread
    for (int t = tid; t < n_valid; t += kThreads) {
      float part[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) part[r] = 0.f;
      const int8_t* krow = kq_s + t * kp;
      for (int x = 0; x < D; x += kVec) {
        const int4 raw = *reinterpret_cast<const int4*>(krow + x);
        const int8_t* codes = reinterpret_cast<const int8_t*>(&raw);
        float kf[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = static_cast<float>(codes[e]);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            const float* qr = q_s + r * D + x;
#pragma unroll
            for (int e = 0; e < kVec; ++e) part[r] += qr[e] * kf[e];
          }
        }
      }
      const float ks = ks_s[t];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) s_s[r * page + t] = part[r] * ks * sm_scale;
      }
    }
    __syncthreads();

    // 3. online-softmax update, one warp per head row; l sums p, and the
    //    stored weight is p * vs_t for the value step
    for (int r = warp; r < rep; r += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < n_valid; t += 32) mx = fmaxf(mx, s_s[r * page + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const bool live = m_new > kNegInf * 0.5f;
      float sum = 0.f;
      for (int t = lane; t < n_valid; t += 32) {
        const float p = live ? expf(s_s[r * page + t] - m_new) : 0.f;
        s_s[r * page + t] = p * vs_s[t];
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = live ? expf(m_prev - m_new) : 1.f;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // 4. acc[r][d] = acc[r][d] * alpha[r] + sum_t (p * vs)[r][t] * vq[t][d]
#pragma unroll
    for (int j = 0; j < kMaxColsPerThread; ++j) {
      const int d = tid + j * kThreads;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) acc[r][j] *= a_s[r];
        }
#pragma unroll 4
        for (int t = 0; t < n_valid; ++t) {
          const float vv = static_cast<float>(vq_s[t * D + d]);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r < rep) acc[r][j] += s_s[r * page + t] * vv;
          }
        }
      }
    }
    __syncthreads();  // the next page overwrites the staged codes, scales and s_s
  }

#pragma unroll
  for (int j = 0; j < kMaxColsPerThread; ++j) {
    const int d = tid + j * kThreads;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          const float l = l_s[r];
          out[(q_row0 + r) * D + d] = __float2bfloat16(acc[r][j] / (l == 0.f ? 1.f : l));
        }
      }
    }
  }
}

}  // namespace

extern "C" int paged_attention_int8(const void* q, const void* k_q, const void* k_s,
                                    const void* v_q, const void* v_s,
                                    const void* page_table, const void* lens, void* out,
                                    int B, int H, int Hkv, int D, int page, int NB, int P,
                                    float sm_scale, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxRep || D % kVec != 0 ||
      D > kThreads * kMaxColsPerThread || page <= 0 || NB <= 0 || P <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(H / Hkv, D, page);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, Hkv);
  paged_decode_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k_q, (const __half*)k_s,
      (const int8_t*)v_q, (const __half*)v_s, (const int*)page_table, (const int*)lens,
      (__nv_bfloat16*)out, H, Hkv, D, page, NB, P, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* sentio_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
