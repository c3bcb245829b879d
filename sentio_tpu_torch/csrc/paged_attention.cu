// Paged decode attention for Hopper (sm_90a), bf16 page pool.
//
// Replaces sentio_tpu/kernels/paged_attention.py::_paged_kernel (the Pallas
// kernel behind paged_attention / make_paged_attn_impl). Same function: one
// new token per row attends over the row's own scattered pages, online
// softmax in fp32, GQA folded (the rep query heads of a kv group share every
// K/V read), pages past the row's length never read, keys masked to
// pos <= lens[b] (the new token's KV is already written at index lens[b]),
// and a row with nothing to attend (l == 0) writes 0.
//
// Launch geometry: grid (B, Hkv), 128 threads. One block per (row, kv head)
// handles that group's rep query heads. The block reads page_table[b, i]
// itself (the TPU kernel had it by scalar prefetch) and walks pages
// 0 .. lens[b] / page in order, carrying (m, l, acc) in fp32. Per page:
//   1. the page's K and V rows of this kv head (each D contiguous bf16) are
//      staged in shared memory with 16-byte loads, 8 K and 8 V loads in
//      flight per thread (rows past the current token are not read);
//   2. scores: thread t owns token t and takes q . k_t for all rep heads
//      from shared memory (q is read as a broadcast);
//   3. softmax update: one warp per head row, over this page's tokens;
//   4. acc update: thread d owns output column d (for every rep head) and
//      sums p[r][t] * v[t][d] over the staged V rows.
// Reads: q [B, H, D], the owned K/V pages [P, page, Hkv, D], page_table
// [B, NB] int32, lens [B] int32. Writes: out [B, H, D].
//
// Bound on the H100: the K/V bytes the rows own, B * (lens + 1) * Hkv * D *
// 2 B * 2 (K and V) — about 67 MB per layer at 2K-token rows, ~20 us at
// 3.35 TB/s; the arithmetic is ~1 FLOP per byte. The design reads each
// owned K/V byte exactly once and nothing past lens. What it does not do
// yet: overlap one page's loads with the previous page's math (cp.async /
// TMA double buffering), or split a long row over several blocks — so a
// row's time grows with its length on one SM, and B * Hkv blocks (64 at the
// serving batch) leave most of the 132 SMs idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;            // query heads per kv head
constexpr int kMaxColsPerThread = 2;  // D <= 256
constexpr int kVec = 8;               // bf16 per 16-byte load
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

// Shared memory, in order: K rows [page][D + kVec] bf16 (padded so 16-byte
// reads of consecutive rows fall on different banks), V rows [page][D]
// bf16, then fp32 q [rep][D], scores [rep][page], m, l, alpha [rep].
__host__ __device__ inline size_t smem_bytes(int rep, int D, int page) {
  return (size_t)page * (D + kVec) * 2 + (size_t)page * D * 2 +
         sizeof(float) * ((size_t)rep * D + (size_t)rep * page + 3 * rep);
}

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lens,
                    __nv_bfloat16* __restrict__ out,
                    int H, int Hkv, int D, int page, int NB, int P,
                    float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rep = H / Hkv;
  const int kp = D + kVec;  // K row pitch in bf16
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + (size_t)page * kp;
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)page * D);  // [rep][D]
  float* s_s = q_s + rep * D;      // [rep][page] scores, then probabilities
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

  const size_t tok_stride = (size_t)Hkv * D;  // between tokens of a page
  const int vecs = D / kVec;                  // 16-byte chunks per row
  const int n_pages = cur < 0 ? 0 : min(cur / page + 1, NB);
  for (int i = 0; i < n_pages; ++i) {
    const int pid = page_table[b * NB + i];
    if (pid < 0 || pid >= P) continue;  // never read outside the pool
    const int n_valid = min(page, cur + 1 - i * page);
    const size_t page_off = (size_t)pid * page * tok_stride + (size_t)g * D;

    // 1. stage the valid K and V rows (consecutive threads read consecutive
    //    16-byte chunks of a row: each row is one contiguous D * 2 bytes).
    //    Each thread issues kBatch K and kBatch V loads before it stores
    //    any, so a page costs a few HBM round trips, not one per chunk.
    const int n_chunks = n_valid * vecs;
    for (int c0 = tid; c0 < n_chunks; c0 += kThreads * kBatch) {
      uint4 kr[kBatch], vr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u * kThreads;
        if (c < n_chunks) {
          const int t = c / vecs;
          const size_t src = page_off + (size_t)t * tok_stride + (c - t * vecs) * kVec;
          kr[u] = *reinterpret_cast<const uint4*>(k_pages + src);
          vr[u] = *reinterpret_cast<const uint4*>(v_pages + src);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u * kThreads;
        if (c < n_chunks) {
          const int t = c / vecs;
          const int x = (c - t * vecs) * kVec;
          *reinterpret_cast<uint4*>(k_s + t * kp + x) = kr[u];
          *reinterpret_cast<uint4*>(v_s + t * D + x) = vr[u];
        }
      }
    }
    __syncthreads();

    // 2. scores s[r][t] = (q_r . k_t) * sm_scale, one token per thread
    for (int t = tid; t < n_valid; t += kThreads) {
      float part[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) part[r] = 0.f;
      const __nv_bfloat16* krow = k_s + t * kp;
      for (int x = 0; x < D; x += kVec) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + x);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float kf[kVec];
#pragma unroll
        for (int e = 0; e < kVec / 2; ++e) {
          const float2 f = __bfloat1622float2(k2[e]);
          kf[2 * e] = f.x;
          kf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            const float* qr = q_s + r * D + x;
#pragma unroll
            for (int e = 0; e < kVec; ++e) part[r] += qr[e] * kf[e];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) s_s[r * page + t] = part[r] * sm_scale;
      }
    }
    __syncthreads();

    // 3. online-softmax update, one warp per head row
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
        s_s[r * page + t] = p;
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

    // 4. acc[r][d] = acc[r][d] * alpha[r] + sum_t p[r][t] * v[t][d]
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
          const float vv = __bfloat162float(v_s[t * D + d]);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r < rep) acc[r][j] += s_s[r * page + t] * vv;
          }
        }
      }
    }
    __syncthreads();  // the next page overwrites k_s, v_s and s_s
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

extern "C" int paged_attention_bf16(const void* q, const void* k_pages,
                                    const void* v_pages, const void* page_table,
                                    const void* lens, void* out, int B, int H,
                                    int Hkv, int D, int page, int NB, int P,
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
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, Hkv);
  paged_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)page_table, (const int*)lens,
      (__nv_bfloat16*)out, H, Hkv, D, page, NB, P, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* sentio_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
