// B15: Kx8 codebook dequant-matmul over the untiled codes layout, any OUT.
//
// Replaces the TPU kernel aqlm_tpu/ops/kernels.py: fused_onehot_matmul
// (_fused_call, pallas_call at :159), the codes-mode path of every projection
// whose out_features is not a multiple of 128 (Falcon-7B's q/k/v/o/fc2). The
// layer index of the stacked form is a pointer offset applied by the caller.
//
//   y[b, o] = X(X(sum_i x[b, i] * bf16(sum_k cb[k, codes[k, i/8, o], i%8])) * X(scales[o]))
//
// with X() the rounding to the activations' dtype: the codebook vectors are
// summed in f32 and rounded to bf16 (exact in the TPU's one-hot form), the
// product accumulates in f32 and is rounded before the scale
// (kernels.py:93-143, 178-193).
//
// What bounds it on an H100: the codes, K bytes per 8 weights, read once
// (Falcon-7B q/o: 5.16 MB, ~1.5 us at 3.35 TB/s; fc2 20.7 MB) for a few rows;
// at prefill widths the GEMM's 2*T*OUT*IN operations on the bf16 tensor cores.
//
// Design. Hopper has a fast shared-memory gather, so the TPU's one-hot MXU
// trick is not carried over: the block's codebooks (K x S x 8 bf16, 8 KB for
// 2x8) sit in shared memory and each code gathers its 16-byte row.
// - GEMV form (1-8 rows, the decode buckets): a block owns 256 output columns
//   (four per thread, 64 threads per input lane) and four input lanes that
//   take every fourth input group of the block's share. Neighbouring threads
//   read neighbouring OUT bytes of one (k, ig) code row, the natural
//   coalescing of [K, IG, OUT] (a word per thread when OUT % 4 == 0, else
//   bytes). The input groups are split over several blocks so that k/v (64
//   columns, one block) and B=1 still fill the card; the lanes meet in shared
//   memory and the blocks in f32 partial sums, which the last block of a
//   column block to finish (an atomic ticket) adds in a fixed order.
// - GEMM form (more rows, the prefill buckets): K2's shape over the untiled
//   codes. A 256-thread block owns 128 tokens x 128 columns and walks the
//   input in 64-wide slabs; the activations arrive by cp.async, double
//   buffered; the codes of the next slab are loaded into registers while the
//   tensor cores work (WMMA 16x16x16 bf16, f32 accumulate); each slab's W^T
//   [64 x 128] is dequantized into shared memory as bf16. Columns past OUT
//   and input groups past IG are masked (zero weights, zero activations).
//   Split slabs meet in partial sums as in the GEMV form.
// wgmma, TMA and reuse of a dequantized slab across token tiles are later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int G = 8;
constexpr int THREADS = 256;

// the output epilogue: round to the activations' dtype, then scale in it
__device__ __forceinline__ void store_scaled(__nv_bfloat16* p, float acc, float scale) {
  const float y = __bfloat162float(__float2bfloat16(acc));
  const float s = __bfloat162float(__float2bfloat16(scale));
  *p = __float2bfloat16(y * s);
}
__device__ __forceinline__ void store_scaled(float* p, float acc, float scale) { *p = acc * scale; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ------------------------------------------------------------------ GEMV form

constexpr int GV_V = 4;                      // columns per thread
constexpr int GV_CT = 64;                    // column threads per input lane
constexpr int GV_COLS = GV_CT * GV_V;        // columns per block
constexpr int GV_LANES = THREADS / GV_CT;    // input lanes per block

template <typename XT, int B>
__global__ void __launch_bounds__(THREADS)
onehot_gemv_kernel(const XT* __restrict__ x,               // [B, IN]
                   const uint8_t* __restrict__ codes,      // [K, IG, OUT] of one layer
                   const __nv_bfloat16* __restrict__ cb,   // [K, S, G] of one layer
                   const float* __restrict__ scales,       // [OUT] of one layer
                   XT* __restrict__ out,                   // [B, OUT]
                   float* __restrict__ partials,           // [splits, B, OUTP] when split
                   int* __restrict__ tickets,              // [ceil(OUT / GV_COLS)] zeroed
                   int IG, int OUT, int K, int S, int word_codes, int groups_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* s_cb = reinterpret_cast<uint4*>(smem);                                // [K * S]
  float* s_red = reinterpret_cast<float*>(smem + (size_t)K * S * 16);         // [LANES-1][B][COLS]
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int ct = tid % GV_CT, lane_ig = tid / GV_CT;
  const int col0 = blockIdx.x * GV_COLS;
  const int col = col0 + ct * GV_V;
  const int in_features = IG * G;
  const int out_pad = (OUT + 127) / 128 * 128;
  const int g_begin = blockIdx.y * groups_per_split;
  const int g_end = min(IG, g_begin + groups_per_split);

  for (int i = tid; i < K * S; i += THREADS) s_cb[i] = reinterpret_cast<const uint4*>(cb)[i];
  __syncthreads();

  float acc[B][GV_V];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int j = 0; j < GV_V; ++j) acc[b][j] = 0.f;

  if (col < OUT) {
    for (int ig = g_begin + lane_ig; ig < g_end; ig += GV_LANES) {
      float w[GV_V][G];
#pragma unroll
      for (int j = 0; j < GV_V; ++j)
#pragma unroll
        for (int e = 0; e < G; ++e) w[j][e] = 0.f;
      for (int k = 0; k < K; ++k) {
        const uint8_t* row = codes + ((size_t)k * IG + ig) * OUT + col;
        uint32_t c4 = 0;
        if (word_codes) {  // OUT % 4 == 0: the four columns are all inside, one aligned word
          c4 = __ldg(reinterpret_cast<const unsigned int*>(row));
        } else {
#pragma unroll
          for (int j = 0; j < GV_V; ++j)
            if (col + j < OUT) c4 |= (uint32_t)__ldg(row + j) << (8 * j);
        }
#pragma unroll
        for (int j = 0; j < GV_V; ++j) {
          float f[G];
          aqlm::bf16x8_to_float(s_cb[k * S + ((c4 >> (8 * j)) & 0xff)], f);
#pragma unroll
          for (int e = 0; e < G; ++e) w[j][e] += f[e];
        }
      }
#pragma unroll
      for (int j = 0; j < GV_V; ++j)
#pragma unroll
        for (int e = 0; e < G; ++e) w[j][e] = round_bf16(w[j][e]);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        float xv[G];
        aqlm::load8(x + (size_t)b * in_features + ig * G, xv);
#pragma unroll
        for (int j = 0; j < GV_V; ++j)
#pragma unroll
          for (int e = 0; e < G; ++e) acc[b][j] = fmaf(xv[e], w[j][e], acc[b][j]);
      }
    }
  }

  // the input lanes meet in shared memory, in a fixed order
  if (lane_ig > 0) {
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int j = 0; j < GV_V; ++j)
        s_red[((lane_ig - 1) * B + b) * GV_COLS + ct * GV_V + j] = acc[b][j];
  }
  __syncthreads();
  if (lane_ig == 0) {
#pragma unroll
    for (int l = 0; l < GV_LANES - 1; ++l)
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int j = 0; j < GV_V; ++j) acc[b][j] += s_red[(l * B + b) * GV_COLS + ct * GV_V + j];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int j = 0; j < GV_V; ++j) {
        const int o = col + j;
        if (o >= OUT) continue;
        if (gridDim.y == 1)
          store_scaled(out + (size_t)b * OUT + o, acc[b][j], scales[o]);
        else
          partials[((size_t)blockIdx.y * B + b) * out_pad + o] = acc[b][j];
      }
  }
  if (gridDim.y == 1) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < B * GV_COLS; i += THREADS) {
    const int b = i / GV_COLS, o = col0 + i % GV_COLS;
    if (o >= OUT) continue;
    float s = 0.f;
    for (int sp = 0; sp < (int)gridDim.y; ++sp)
      s += __ldcg(partials + ((size_t)sp * B + b) * out_pad + o);
    store_scaled(out + (size_t)b * OUT + o, s, scales[o]);
  }
}

template <typename XT, int B>
cudaError_t launch_gemv(const void* x, const void* codes, const void* cb, const void* scales,
                        void* out, void* partials, void* tickets, int splits, int IG, int OUT,
                        int K, int S, int word_codes, cudaStream_t st) {
  const size_t smem = (size_t)K * S * 16 + (size_t)(GV_LANES - 1) * B * GV_COLS * 4;
  static size_t smem_set = 0;  // above 48 KB only after opting in, once per size
  if (smem != smem_set) {
    cudaError_t e = cudaFuncSetAttribute(onehot_gemv_kernel<XT, B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int per_split = (IG + splits - 1) / splits;
  const dim3 grid((OUT + GV_COLS - 1) / GV_COLS, (IG + per_split - 1) / per_split);
  onehot_gemv_kernel<XT, B><<<grid, THREADS, smem, st>>>(
      (const XT*)x, (const uint8_t*)codes, (const __nv_bfloat16*)cb, (const float*)scales,
      (XT*)out, (float*)partials, (int*)tickets, IG, OUT, K, S, word_codes, per_split);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_gemv_typed(int B, const void* x, const void* codes, const void* cb,
                              const void* scales, void* out, void* partials, void* tickets,
                              int splits, int IG, int OUT, int K, int S, int word_codes,
                              cudaStream_t st) {
#define AQLM_ONEHOT_CASE(NB)                                                                    \
  case NB:                                                                                      \
    return launch_gemv<XT, NB>(x, codes, cb, scales, out, partials, tickets, splits, IG, OUT, K, \
                               S, word_codes, st);
  switch (B) {
    AQLM_ONEHOT_CASE(1) AQLM_ONEHOT_CASE(2) AQLM_ONEHOT_CASE(3) AQLM_ONEHOT_CASE(4)
    AQLM_ONEHOT_CASE(5) AQLM_ONEHOT_CASE(6) AQLM_ONEHOT_CASE(7) AQLM_ONEHOT_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef AQLM_ONEHOT_CASE
}

// ------------------------------------------------------------------ GEMM form

constexpr int BM = 128;  // tokens per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // inputs per slab (8 groups of 8)
constexpr int XLD = BK + 8;
constexpr int WLD = BN + 8;
constexpr int ITEMS = (BK / G) * BN / THREADS;  // (group, column) items per thread per slab

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem_src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct GemmSmem {  // byte offsets in the dynamic shared memory
  size_t cb, x[2], w, epi, flag, total;
  __host__ __device__ GemmSmem(int K, int S) {
    cb = 0;
    size_t o = ((size_t)K * S * 16 + 127) / 128 * 128;  // WMMA tiles need 32-byte aligned rows
    for (int i = 0; i < 2; ++i) {
      x[i] = o;
      o += (size_t)BM * XLD * 2;
    }
    w = o;
    o += (size_t)BK * WLD * 2;
    epi = o;
    o += (size_t)(THREADS / 32) * 16 * 16 * 4;
    flag = o;
    total = o + 16;
  }
};

__global__ void __launch_bounds__(THREADS)
onehot_gemm_kernel(const __nv_bfloat16* __restrict__ x,   // [T, IN]
                   const uint8_t* __restrict__ codes,     // [K, IG, OUT] of one layer
                   const __nv_bfloat16* __restrict__ cb,  // [K, S, G] of one layer
                   const float* __restrict__ scales,      // [OUT] of one layer
                   __nv_bfloat16* __restrict__ out,       // [T, OUT]
                   float* __restrict__ partials,          // [splits, Tpad, OUTP] when split
                   int* __restrict__ tickets,             // [row tiles * col tiles] zeroed
                   int T, int IG, int OUT, int K, int S, int slabs_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GemmSmem L(K, S);
  uint4* s_cb = reinterpret_cast<uint4*>(smem + L.cb);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  int& s_last = *reinterpret_cast<int*>(smem + L.flag);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int in_features = IG * G;
  const int out_pad = (OUT + BN - 1) / BN * BN;
  const int n_slabs = (IG + BK / G - 1) / (BK / G);
  const int s_begin = blockIdx.z * slabs_per_split;
  const int s_end = min(n_slabs, s_begin + slabs_per_split);

  auto load_x = [&](int s, int stage) {
    __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem + L.x[stage]);
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = i % (BK / 8);
      const bool valid = row0 + r < T && s * (BK / G) + c < IG;
      const __nv_bfloat16* src =
          x + (valid ? (size_t)(row0 + r) * in_features + (size_t)(s * BK + c * 8) : 0);
      cp_async16(sx + r * XLD + c * 8, src, valid);
    }
    cp_async_commit();
  };
  // this thread's (group, column) items of slab s: K code bytes each, 0 where masked
  uint8_t cv[ITEMS][8];
  auto load_codes = [&](int s) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = tid + it * THREADS;
      const int ig = s * (BK / G) + i / BN, o = col0 + i % BN;
      const bool ok = ig < IG && o < OUT;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        cv[it][k] = (ok && k < K) ? __ldg(codes + ((size_t)k * IG + ig) * OUT + o) : 0;
    }
  };

  load_x(s_begin, 0);
  load_codes(s_begin);
  for (int i = tid; i < K * S; i += THREADS) s_cb[i] = reinterpret_cast<const uint4*>(cb)[i];

  const int wm = warp / 4, wn = warp % 4;  // warp's 64 x 32 sub-tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  int stage = 0;
  for (int s = s_begin; s < s_end; ++s, stage ^= 1) {
    if (s + 1 < s_end) {
      load_x(s + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slab s's activations (and the codebooks) visible to all
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = tid + it * THREADS;
      const int gl = i / BN, c = i % BN;
      float w[G];
#pragma unroll
      for (int e = 0; e < G; ++e) w[e] = 0.f;
      const bool ok = s * (BK / G) + gl < IG && col0 + c < OUT;
      if (ok) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {  // unrolled: cv stays in registers
          if (k >= K) break;
          float f[G];
          aqlm::bf16x8_to_float(s_cb[k * S + cv[it][k]], f);
#pragma unroll
          for (int e = 0; e < G; ++e) w[e] += f[e];
        }
      }
#pragma unroll
      for (int e = 0; e < G; ++e) s_w[(gl * G + e) * WLD + c] = __float2bfloat16(w[e]);
    }
    if (s + 1 < s_end) load_codes(s + 1);  // in flight while the tensor cores work
    __syncthreads();
    const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(smem + L.x[stage]);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], sx + (wm * 64 + i * 16) * XLD + kk, XLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], s_w + kk * WLD + wn * 32 + j * 16, WLD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // stage and W^T slab free for reuse
  }

  if (gridDim.z > 1) {
    // split slabs: park the f32 partial tile, the last block sums
    const int t_pad = gridDim.y * BM;
    float* part = partials + ((size_t)blockIdx.z * t_pad + row0 + wm * 64) * out_pad + col0 +
                  wn * 32;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(part + (size_t)i * 16 * out_pad + j * 16, acc[i][j], out_pad,
                                wmma::mem_row_major);
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(tickets + blockIdx.y * gridDim.x + blockIdx.x, 1) == (int)gridDim.z - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      if (row0 + r >= T || col0 + c >= OUT) continue;
      float v = 0.f;
      for (int z = 0; z < (int)gridDim.z; ++z)
        v += __ldcg(partials + ((size_t)z * t_pad + row0 + r) * out_pad + col0 + c);
      store_scaled(out + (size_t)(row0 + r) * OUT + col0 + c, v, scales[col0 + c]);
    }
    return;
  }

  // epilogue: each warp stages one 16x16 fragment at a time, rounds, scales
  float* epi = reinterpret_cast<float*>(smem + L.epi) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(epi, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        const int row = row0 + wm * 64 + i * 16 + r;
        const int o = col0 + wn * 32 + j * 16 + c;
        if (row < T && o < OUT) store_scaled(out + (size_t)row * OUT + o, epi[e], scales[o]);
      }
      __syncwarp();
    }
  }
}

cudaError_t launch_gemm(const void* x, const void* codes, const void* cb, const void* scales,
                        void* out, void* partials, void* tickets, int T, int splits, int IG,
                        int OUT, int K, int S, cudaStream_t st) {
  const GemmSmem L(K, S);
  static size_t smem_set = 0;
  if (L.total != smem_set) {
    cudaError_t e = cudaFuncSetAttribute(onehot_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return e;
    smem_set = L.total;
  }
  const int n_slabs = (IG + BK / G - 1) / (BK / G);
  const int per_split = (n_slabs + splits - 1) / splits;
  const dim3 grid((OUT + BN - 1) / BN, (T + BM - 1) / BM, (n_slabs + per_split - 1) / per_split);
  onehot_gemm_kernel<<<grid, THREADS, L.total, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)codes, (const __nv_bfloat16*)cb,
      (const float*)scales, (__nv_bfloat16*)out, (float*)partials, (int*)tickets, T, IG, OUT, K,
      S, per_split);
  return cudaGetLastError();
}

}  // namespace

// x_bf16 selects bf16 (1) or f32 (0) activations and output; B <= 8 runs the
// GEMV form (either dtype), larger B the GEMM form (bf16 only). splits > 1
// splits the input over that many blocks per output block; partials
// ([splits, B or ceil(B/128)*128, ceil(OUT/128)*128] f32) and tickets
// (zeroed int32, one per output block: ceil(OUT/256) for the GEMV form,
// ceil(B/128) * ceil(OUT/128) for the GEMM form) are then required.
// word_codes (OUT % 4 == 0 and 4-byte aligned codes) lets the GEMV form read
// four codes as one word.
extern "C" int onehot_matmul_launch(const void* x, const void* codes, const void* cb,
                                    const void* scales, void* out, void* partials, void* tickets,
                                    int x_bf16, int B, int splits, int IG, int OUT, int K, int S,
                                    int word_codes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 8) {
    if (x_bf16)
      return launch_gemv_typed<__nv_bfloat16>(B, x, codes, cb, scales, out, partials, tickets,
                                              splits, IG, OUT, K, S, word_codes, st);
    return launch_gemv_typed<float>(B, x, codes, cb, scales, out, partials, tickets, splits, IG,
                                    OUT, K, S, word_codes, st);
  }
  if (!x_bf16) return cudaErrorInvalidValue;
  return launch_gemm(x, codes, cb, scales, out, partials, tickets, B, splits, IG, OUT, K, S, st);
}
