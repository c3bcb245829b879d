// Blockwise online-softmax attention for Hopper (sm_90a) on the tensor
// cores, bf16 in and out.
//
// Replaces sentio_tpu/kernels/flash_attention.py::_flash_kernel (the Pallas
// kernel behind flash_attention, encoder_attn_fn and flash_attn_fn). Same
// function: q [B, T, H, D], k/v [B, S, H, D] (kv heads already expanded),
// D in {16, 32, 64, 128}, per-row key lengths kv_lens [B] masking k_pos >=
// kv_lens[b], an optional causal mask k_pos <= q_pos, fp32 online softmax
// with P rounded to bf16 before P V (as the TPU kernel's p.astype(v.dtype))
// and the normaliser l summed over the unrounded p, and 0 for a query row
// with nothing to attend (l == 0) — including every row of a kv_lens == 0
// batch entry.
//
// What bounds it on the H100 SXM (published peaks, 700 W): at the encoder
// shapes (T <= 512, D 32 or 64) a head does 4 * T * S * D operations over
// ~4 * T * D * 2 bytes, ~T / 2 operations a byte, so at D 64 the bf16
// tensor cores (989 TFLOP/s) and HBM (3.35 TB/s) bound it about equally,
// and the softmax's T * S exponentials (16 a clock per SM) come close
// behind. On the CUDA cores in fp32 (67 TFLOP/s) the products alone would
// take 15x as long, so:
//
// Launch geometry: a 1-D grid of B * H * ceil(T / 128) blocks, query tile
// fastest, so the query tiles of one (b, h) run together and its K and V
// come from HBM once and from L2 after. 256 threads: two warpgroups, each
// owning 64 query rows (wgmma's M) of the block's 128, loop over key tiles
// (128 keys at D <= 64, 64 at D 128):
//   - Q (loaded once) and a two-stage ring of K and V tiles stay bf16 in
//     shared memory, shared by both warpgroups and copied with cp.async
//     16-byte copies: tile i + 1's copy is in flight while tile i computes,
//     one __syncthreads per tile. Rows past T, and keys past kv_lens, are
//     zero-filled (never read from HBM).
//   - Each tile is stored as 64-column panels with 128-byte rows (64-byte
//     rows at D 32, 32-byte at D 16) in the matching wgmma swizzle, so the
//     descriptors read it without bank conflicts and no transpose is copied.
//   - S = Q K^T: D / 16 wgmma m64nBKk16, A and B K-major from shared memory.
//   - Masking, the row max and the row sums run on the accumulator
//     fragments in registers (each row lives in one quad of lanes: two
//     shuffles); S and P never touch shared memory.
//   - O += P V: BK / 16 wgmma m64nDk16 with P from registers as bf16 (the
//     S fragment is already the A-operand layout) and V from shared memory,
//     MN-major, transposed by the instruction.
//   - At most 128 registers a thread, so two blocks (four warpgroups) share
//     an SM and one's softmax runs while another's products do.
// The key loop ends at each row's kv_len; when causal, at the block's last
// query row (and at T, whatever S is), and a warpgroup skips the tiles
// wholly past its own rows.
// Reads: q once; k and v once per (b, h) from HBM; kv_lens. Writes: out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cuda_common.cuh"
#include "wgmma.cuh"

namespace {

using namespace sentio;

constexpr int kWarpGroups = 2;            // warpgroups per block
constexpr int kBQ = 64 * kWarpGroups;     // query rows per block
constexpr int kThreads = 128 * kWarpGroups;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of a tile of ROWS rows by D bf16 columns: panels of
// PW columns, each [ROWS][W bytes], the 16-byte chunks of row r XORed with
// (r * W / 128) mod (W / 16) — the wgmma swizzle of a W-byte row.
template <int D, int ROWS>
struct Tile {
  static constexpr int PW = D < 64 ? D : 64;  // panel width in elements
  static constexpr int W = PW * 2;            // panel row in bytes
  static constexpr int kChunks = W / 16;      // 16-byte chunks per panel row
  static constexpr int kPanelBytes = ROWS * W;
  static constexpr int kBytes = ROWS * D * 2;
  static constexpr uint64_t kSwizzle = W == 128 ? kSwizzle128B
                                       : W == 64 ? kSwizzle64B
                                                 : kSwizzle32B;

  // byte offset of the 16-byte chunk c (columns 8c .. 8c + 7) of row r
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const int panel = c / kChunks;
    const int cc = c - panel * kChunks;
    return panel * kPanelBytes + r * W + ((cc ^ ((r * W / 128) & (kChunks - 1))) << 4);
  }

  // K-major operand (Q as A, K as B of S = Q K^T) whose first row is at
  // `base`, 8-row aligned: columns 16k .. 16k + 15
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int k) {
    const int col = 16 * k;
    return gmma_desc(base + (col / PW) * kPanelBytes + (col % PW) * 2, 16, 8 * W, kSwizzle);
  }

  // MN-major operand (V as B of P V): rows 16k .. 16k + 15, all D columns;
  // the leading offset steps between panels, the stride between 8-row groups
  static __device__ __forceinline__ uint64_t mn_major(uint32_t base, int k) {
    return gmma_desc(base + 16 * k * W, kPanelBytes, 8 * W, kSwizzle);
  }
};

// Copy rows [row0, row0 + ROWS) of one (b, h) slice into a tile; rows at or
// past `limit` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                          size_t row_stride, int row0, int limit) {
  constexpr int kRowChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks;
    const int c = i - r * kRowChunks;
    const bool ok = row0 + r < limit;
    const __nv_bfloat16* p = ok ? src + (size_t)(row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + Tile<D, ROWS>::offset(r, c), p, ok ? 16 : 0);
  }
}

template <int BK>
__device__ __forceinline__ void qk_mma(float (&s)[BK / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (BK == 64) wgmma_ss_m64n64k16(s, a, b, acc);
  if constexpr (BK == 128) wgmma_ss_m64n128k16(s, a, b, acc);
}

template <int D>
__device__ __forceinline__ void pv_mma(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 16) wgmma_rs_m64n16k16(o, a, b, 1);
  if constexpr (D == 32) wgmma_rs_m64n32k16(o, a, b, 1);
  if constexpr (D == 64) wgmma_rs_m64n64k16(o, a, b, 1);
  if constexpr (D == 128) wgmma_rs_m64n128k16(o, a, b, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// keys per tile: 128 while two blocks' tiles and registers fit an SM, else 64
template <int D>
__host__ __device__ constexpr int key_tile() { return D <= 64 ? 128 : 64; }

template <int D>
constexpr size_t smem_bytes() {  // Q, 2 x K, 2 x V, alignment
  return (size_t)kBQ * D * 2 + 4 * (size_t)key_tile<D>() * D * 2 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ kv_lens,
                 __nv_bfloat16* __restrict__ out,
                 int T, int S, int H, float sm_scale, int causal) {
  sentio::count_launch(0);
  constexpr int BK = key_tile<D>();
  using QTile = Tile<D, kBQ>;
  using KTile = Tile<D, BK>;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on a 1024-byte boundary (the 128-byte pattern's)
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q_s = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t k_s = q_s + QTile::kBytes;      // stages at k_s, k_s + kBytes
  const uint32_t v_s = k_s + 2 * KTile::kBytes;  // stages at v_s, v_s + kBytes

  const int n_qt = (T + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (blockIdx.x - bh * n_qt) * kBQ;
  const int wg = threadIdx.x >> 7;  // this warpgroup's 64 rows: q0 + 64 wg ..
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;  // accumulator rows g and g + 8 of the warp's 16
  const int t = lane & 3;   // accumulator columns 8j + 2t, 8j + 2t + 1

  const size_t row_stride = (size_t)H * D;
  const __nv_bfloat16* qb = q + ((size_t)b * T * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * S * H + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * S * H + h) * D;
  __nv_bfloat16* ob = out + ((size_t)b * T * H + h) * D;

  const int kv_len = max(0, min(kv_lens[b], S));
  // causal: no row of this block attends a key past its last row, nor any
  // key at or past T (a prefill over a cache window passes S > T, and the
  // window's tail is unwritten); keys past k_end are zero-filled, not read
  const int k_end = causal ? min(kv_len, min(q0 + kBQ, T)) : kv_len;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile<D, kBQ>(q_s, qb, row_stride, q0, T);
  if (n_tiles > 0) {
    load_tile<D, BK>(k_s, kb, row_stride, 0, k_end);
    load_tile<D, BK>(v_s, vb, row_stride, 0, k_end);
  }
  cp_async_commit();

  const int wg_row0 = q0 + 64 * wg;
  const uint32_t q_wg = q_s + 64 * wg * QTile::W;  // this warpgroup's A rows
  const int row0 = wg_row0 + 16 * warp + g;        // this thread's two rows
  const int row1 = row0 + 8;
  const float scale = sm_scale * kLog2e;  // scores in log2 units: exp2 below
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // row maxima, quad-uniform
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile it is visible; stage ^ 1 is free again
    if (it + 1 < n_tiles) {
      const uint32_t next = (stage ^ 1) * KTile::kBytes;
      load_tile<D, BK>(k_s + next, kb, row_stride, (it + 1) * BK, k_end);
      load_tile<D, BK>(v_s + next, vb, row_stride, (it + 1) * BK, k_end);
    }
    cp_async_commit();
    const int k0 = it * BK;
    // causal: a tile wholly past this warpgroup's last row adds nothing
    if (causal && k0 > wg_row0 + 63) continue;
    const uint32_t k_tile = k_s + stage * KTile::kBytes;
    const uint32_t v_tile = v_s + stage * KTile::kBytes;

    // S = Q K^T
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qk_mma<BK>(s, QTile::k_major(q_wg, kk), KTile::k_major(k_tile, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // mask keys past kv_len and, when causal, past each row
    if (k0 + BK > kv_len || (causal && k0 + BK - 1 > wg_row0)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        const int row = (i & 2) ? row1 : row0;
        if (col >= kv_len || (causal && col > row)) s[i] = -INFINITY;
      }
    }

    // online softmax on the fragments: rows row0 (i & 2 == 0) and row1
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0 * scale);
    const float mn1 = fmaxf(m1, mx1 * scale);
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;  // a row with no key yet
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = exp2_approx(m0 - base0);
    const float alpha1 = exp2_approx(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = exp2_approx(fmaf(s[i], scale, (i & 2) ? -base1 : -base0));
      s[i] = p;
      if (i & 2) sum1 += p;
      else sum0 += p;
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? alpha1 : alpha0;

    // O += P V, P as bf16 A fragments: keys 16kc .. 16kc + 15 are the S
    // column blocks 2kc and 2kc + 1
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kc][e] = pack_bf16(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) pv_mma<D>(o, pa[kc], KTile::mn_major(v_tile, kc));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = 8 * c + 2 * t;
    if (row0 < T) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * row_stride + col) =
          __floats2bfloat162_rn(o[4 * c] * inv0, o[4 * c + 1] * inv0);
    }
    if (row1 < T) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * row_stride + col) =
          __floats2bfloat162_rn(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_lens,
           void* out, int B, int T, int S, int H, float sm_scale, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  static bool smem_allowed = smem <= 48 * 1024;  // raised once per D
  if (!smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = true;
  }
  const long long blocks = (long long)B * H * ((T + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
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
