// W8A16 matmul: y[t, o] = bf16( w_scale[o] * sum_i x[t, i] * w8[o, i] ).
//
// Replaces the TPU kernels of aqlm_tpu/ops/int8_matmul.py: int8_matmul
// (_call, pallas_call at :85; the int8 lm_head) and int8_matmul_indexed
// (_call_indexed, :231; every projection of the stacked layers). One kernel
// source covers both: the layer index is a pointer offset applied by the
// caller. The TPU kernel streams int8 tiles into VMEM and widens them to bf16
// in registers so that each weight byte leaves HBM once; the same aim holds
// here. The bias is added outside, after the cast, as the JAX wrapper does.
//
// Layout: w8 [OUT, ld] int8 row-major (ld = IN_pad, aqlm_tpu's padding,
// 11008 -> 11264); the kernel reads only the first in_features columns of a
// row, so x [T, in_features] bf16 is never padded. w_scale [OUT] f32.
//
// Two paths, chosen by the row count:
//
// - Decode, T <= 8: bound by bytes. Each weight byte is used T times, far
//   below the ~295 operations per byte where the tensor cores would bound it
//   (Llama-2-7B fused gate_up at T = 4: 90 MB, ~27 us at 3.35 TB/s). A warp
//   owns 2 output rows (4 were slower at T <= 4, faster only at T = 8); each
//   lane reads 16 weights of a row with one 16-byte load, neighbouring lanes
//   neighbouring bytes, and the next 1024-column chunk's loads are issued
//   before the current chunk computes. The weights are widened to f32
//   exactly (a byte-permute into a float's mantissa and one subtraction) and
//   multiplied against the activation rows, staged in shared memory as f32
//   in 1024-column chunks (swizzled so that the lanes' 16-byte reads do not
//   collide on banks).
//   Narrow projections (OUT = 4096) cannot fill 132 SMs by rows alone, so the
//   columns are split over blocks: each split writes f32 partial sums and the
//   last block of a row group to finish (an atomic ticket) adds them in a
//   fixed order, so the result does not change from run to run.
// - Prefill, T > 8: bound by operations (2*T*OUT*IN on the bf16 tensor cores;
//   Llama-2-7B at T = 1024: ~414 GFLOP per layer, ~0.42 ms at 989 TFLOP/s).
//   A 256-thread block owns a 128-token x 128-row output tile and walks the
//   contraction in 64-wide slabs: the x and int8 W slabs arrive by cp.async,
//   double buffered; the W slab is widened to bf16 in shared memory (exact:
//   |w8| <= 127) and eight warps run WMMA 16x16x16 bf16 products into f32
//   fragments (64 x 32 each); registers are capped so that two blocks share
//   an SM and one's widening overlaps the other's products (a version with
//   one barrier per slab instead of three was no faster). The scale and the
//   cast run in the epilogue.
//   Where the output tiles alone would not fill the card twice, the
//   contraction is split over blocks, reduced as on the decode path. A
//   wgmma/TMA pipeline with warp specialisation is later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

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

// Four int8 packed in a word -> four exact floats: with u = s + 128 (the sign
// bit flipped), the float with bits 0x4B0000uu is 2^23 + u.
__device__ __forceinline__ void s8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

__device__ __forceinline__ void s8x16_to_float(const uint4& v, float* f) {
  s8x4_to_float(v.x, f);
  s8x4_to_float(v.y, f + 4);
  s8x4_to_float(v.z, f + 8);
  s8x4_to_float(v.w, f + 12);
}

// ---------------------------------------------------------------------------
// decode: T <= 8
// ---------------------------------------------------------------------------

constexpr int GV_WARPS = 8;
constexpr int GV_THREADS = GV_WARPS * 32;
constexpr int GV_R = 2;                    // output rows per warp
constexpr int GV_ROWS = GV_WARPS * GV_R;   // output rows per block
constexpr int GV_CHUNK = 1024;             // columns of x staged per pass
constexpr int GV_STEP = 512;               // columns one warp load covers: 32 lanes x 16
constexpr int GV_STEPS = GV_CHUNK / GV_STEP;

// float4 q of a staged x row lives at q ^ ((q >> 3) & 3): the eight lanes of
// a 16-byte shared-memory phase then fall on eight different bank groups
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 3) & 3); }

template <int B>
__global__ void __launch_bounds__(GV_THREADS)
int8_gemv_kernel(const __nv_bfloat16* __restrict__ x,  // [B, in_features]
                 const int8_t* __restrict__ w8,         // [OUT, ld] of one layer
                 const float* __restrict__ w_scale,     // [OUT]
                 __nv_bfloat16* __restrict__ out,       // [B, OUT]
                 float* __restrict__ partials,          // [splits, B, OUT] when split
                 int* __restrict__ tickets,             // [gridDim.x] zeroed, when split
                 int out_features, int in_features, int ld, int cols_per_split) {
  __shared__ __align__(16) float s_x[B][GV_CHUNK];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * GV_ROWS + warp * GV_R;
  const int k_begin = blockIdx.y * cols_per_split;
  const int k_end = min(in_features, k_begin + cols_per_split);

  const int8_t* wrow[GV_R];
  bool rvalid[GV_R];
#pragma unroll
  for (int r = 0; r < GV_R; ++r) {
    rvalid[r] = row0 + r < out_features;
    wrow[r] = w8 + (size_t)(rvalid[r] ? row0 + r : 0) * ld;
  }
  float acc[B][GV_R];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int r = 0; r < GV_R; ++r) acc[b][r] = 0.f;

  // a lane's 16 weights of each row and step of the chunk at c0 (zeros past the end)
  auto load_w = [&](uint4 (&dst)[GV_STEPS][GV_R], int c0) {
    const int n = k_end - c0;
#pragma unroll
    for (int s = 0; s < GV_STEPS; ++s) {
      const int c = s * GV_STEP + lane * 16;
#pragma unroll
      for (int r = 0; r < GV_R; ++r)
        dst[s][r] = (c < n && rvalid[r])
                        ? __ldcs(reinterpret_cast<const uint4*>(wrow[r] + c0 + c))
                        : make_uint4(0, 0, 0, 0);
    }
  };

  uint4 wv[GV_STEPS][GV_R];
  load_w(wv, k_begin);
  for (int c0 = k_begin; c0 < k_end; c0 += GV_CHUNK) {
    const int n = min(GV_CHUNK, k_end - c0);  // a multiple of 16
    __syncthreads();  // the previous chunk's readers are done with s_x
    for (int i = tid; i < B * (GV_CHUNK / 8); i += GV_THREADS) {
      const int b = i / (GV_CHUNK / 8), c8 = i % (GV_CHUNK / 8);
      float f[8];
      if (c8 * 8 < n) {
        aqlm::load8(x + (size_t)b * in_features + c0 + c8 * 8, f);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.f;
      }
      float4* row = reinterpret_cast<float4*>(s_x[b]);
      row[swz(2 * c8)] = make_float4(f[0], f[1], f[2], f[3]);
      row[swz(2 * c8 + 1)] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
    // the next chunk's weights are in flight while this one computes
    uint4 wnext[GV_STEPS][GV_R];
    load_w(wnext, c0 + GV_CHUNK);
#pragma unroll
    for (int s = 0; s < GV_STEPS; ++s) {
      const int c = s * GV_STEP + lane * 16;
      if (c >= n) break;
      float wf[GV_R][16];
#pragma unroll
      for (int r = 0; r < GV_R; ++r) s8x16_to_float(wv[s][r], wf[r]);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float4* row = reinterpret_cast<const float4*>(s_x[b]);
        float xv[16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v = row[swz(c / 4 + j)];
          xv[4 * j] = v.x;
          xv[4 * j + 1] = v.y;
          xv[4 * j + 2] = v.z;
          xv[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < GV_R; ++r)
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[b][r] = fmaf(xv[e], wf[r][e], acc[b][r]);
      }
    }
#pragma unroll
    for (int s = 0; s < GV_STEPS; ++s)
#pragma unroll
      for (int r = 0; r < GV_R; ++r) wv[s][r] = wnext[s][r];
  }

  // every lane ends with the warp's full sums; lane b * GV_R + r owns (b, r)
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int r = 0; r < GV_R; ++r) {
      float v = acc[b][r];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[b][r] = v;
    }

  if (gridDim.y == 1) {
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int r = 0; r < GV_R; ++r)
        if (lane == b * GV_R + r && rvalid[r])
          out[(size_t)b * out_features + row0 + r] =
              __float2bfloat16(acc[b][r] * w_scale[row0 + r]);
    return;
  }

#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int r = 0; r < GV_R; ++r)
      if (lane == b * GV_R + r && rvalid[r])
        partials[((size_t)blockIdx.y * B + b) * out_features + row0 + r] = acc[b][r];
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < B * GV_ROWS; i += GV_THREADS) {
    const int b = i / GV_ROWS, row = blockIdx.x * GV_ROWS + i % GV_ROWS;
    if (row >= out_features) continue;
    float s = 0.f;
    for (int sp = 0; sp < (int)gridDim.y; ++sp)
      s += __ldcg(partials + ((size_t)sp * B + b) * out_features + row);
    out[(size_t)b * out_features + row] = __float2bfloat16(s * w_scale[row]);
  }
}

template <int B>
cudaError_t gemv_launch(const void* x, const void* w8, const void* w_scale, void* out,
                        void* partials, void* tickets, int splits, int cols_per_split,
                        int out_features, int in_features, int ld, cudaStream_t stream) {
  const dim3 grid((out_features + GV_ROWS - 1) / GV_ROWS, splits);
  int8_gemv_kernel<B><<<grid, GV_THREADS, 0, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w8, (const float*)w_scale, (__nv_bfloat16*)out,
      (float*)partials, (int*)tickets, out_features, in_features, ld, cols_per_split);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// prefill: T > 8
// ---------------------------------------------------------------------------

constexpr int BM = 128;  // tokens per block
constexpr int BN = 128;  // output rows per block
constexpr int BK = 64;   // contraction columns per slab
constexpr int GT = 256;  // threads per block
constexpr int XLD = BK + 8;  // padded shared row (bf16 elements) of the x slab
constexpr int WLD = BK + 8;  // padded shared row (bf16 elements) of the widened W slab

struct GemmSmem {  // byte offsets in the dynamic shared memory
  size_t x[2], w8[2], w, epi, flag, total;
  __host__ __device__ GemmSmem() {
    size_t o = 0;
    for (int i = 0; i < 2; ++i) {
      x[i] = o;
      o += (size_t)BM * XLD * 2;
    }
    for (int i = 0; i < 2; ++i) {
      w8[i] = o;
      o += (size_t)BN * BK;
    }
    w = o;
    o += (size_t)BN * WLD * 2;
    epi = o;
    o += (size_t)(GT / 32) * 16 * 16 * 4;
    flag = o;
    total = o + 16;
  }
};

__global__ void __launch_bounds__(GT, 2)
int8_gemm_kernel(const __nv_bfloat16* __restrict__ x,  // [T, in_features]
                 const int8_t* __restrict__ w8,         // [OUT, ld] of one layer
                 const float* __restrict__ w_scale,     // [OUT]
                 __nv_bfloat16* __restrict__ out,       // [T, OUT]
                 float* __restrict__ partials,          // [splits, Tpad, OUT] when split
                 int* __restrict__ tickets,             // [row tiles * col tiles] zeroed
                 int T, int out_features, int in_features, int ld, int cols_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GemmSmem L;
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  int& s_last = *reinterpret_cast<int*>(smem + L.flag);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * BN;  // first output row of W (output column of y)
  const int row0 = blockIdx.y * BM;  // first token
  const int k_begin = blockIdx.z * cols_per_split;
  const int k_end = min(in_features, k_begin + cols_per_split);
  const int n_slabs = (k_end - k_begin + BK - 1) / BK;

  auto load_slab = [&](int s, int stage) {
    const int k0 = k_begin + s * BK;
    __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem + L.x[stage]);
    for (int i = tid; i < BM * (BK / 8); i += GT) {
      const int r = i / (BK / 8), c = i % (BK / 8);
      const bool valid = row0 + r < T && k0 + c * 8 < k_end;
      const __nv_bfloat16* src = valid ? x + (size_t)(row0 + r) * in_features + k0 + c * 8 : x;
      cp_async16(sx + r * XLD + c * 8, src, valid);
    }
    int8_t* sw = reinterpret_cast<int8_t*>(smem + L.w8[stage]);
    for (int i = tid; i < BN * (BK / 16); i += GT) {
      const int r = i / (BK / 16), c = i % (BK / 16);
      const bool valid = col0 + r < out_features && k0 + c * 16 < k_end;
      const int8_t* src = valid ? w8 + (size_t)(col0 + r) * ld + k0 + c * 16 : w8;
      cp_async16(sw + r * BK + c * 16, src, valid);
    }
    cp_async_commit();
  };

  const int wm = warp / 4, wn = warp % 4;  // warp's 64 x 32 sub-tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (n_slabs > 0) load_slab(0, 0);
  int stage = 0;
  for (int s = 0; s < n_slabs; ++s, stage ^= 1) {
    if (s + 1 < n_slabs) {
      load_slab(s + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slab s visible to all
    {  // widen W: each thread 32 int8 (half a row) -> 32 bf16
      const int r = tid / 2, h = tid % 2;
      const uint4* src = reinterpret_cast<const uint4*>(smem + L.w8[stage] + r * BK + h * 32);
      uint32_t* dst = reinterpret_cast<uint32_t*>(s_w + r * WLD + h * 32);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float f[16];
        s8x16_to_float(src[q], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
          dst[q * 8 + e] = *reinterpret_cast<const uint32_t*>(&p);
        }
      }
    }
    __syncthreads();
    const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(smem + L.x[stage]);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], sx + (wm * 64 + i * 16) * XLD + kk, XLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], s_w + (wn * 32 + j * 16) * WLD + kk, WLD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // stage and widened slab free for reuse
  }

  float* epi = reinterpret_cast<float*>(smem + L.epi) + warp * 256;
  if (gridDim.z > 1) {
    // split contraction: park the f32 partial tile, the last block sums
    const int t_pad = gridDim.y * BM;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(epi, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int o = col0 + wn * 32 + j * 16 + e % 16;
          const int row = row0 + wm * 64 + i * 16 + e / 16;
          if (o < out_features)
            partials[((size_t)blockIdx.z * t_pad + row) * out_features + o] = epi[e];
        }
        __syncwarp();
      }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(tickets + blockIdx.y * gridDim.x + blockIdx.x, 1) == (int)gridDim.z - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int e = tid; e < BM * BN; e += GT) {
      const int r = e / BN, o = col0 + e % BN;
      if (row0 + r >= T || o >= out_features) continue;
      float v = 0.f;
      for (int z = 0; z < (int)gridDim.z; ++z)
        v += __ldcg(partials + ((size_t)z * t_pad + row0 + r) * out_features + o);
      out[(size_t)(row0 + r) * out_features + o] = __float2bfloat16(v * w_scale[o]);
    }
    return;
  }

  // epilogue: each warp stages one 16x16 fragment at a time, scales, casts
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(epi, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = row0 + wm * 64 + i * 16 + e / 16;
        const int o = col0 + wn * 32 + j * 16 + e % 16;
        if (row < T && o < out_features)
          out[(size_t)row * out_features + o] = __float2bfloat16(epi[e] * w_scale[o]);
      }
      __syncwarp();
    }
}

cudaError_t gemm_launch(const void* x, const void* w8, const void* w_scale, void* out,
                        void* partials, void* tickets, int T, int splits, int cols_per_split,
                        int out_features, int in_features, int ld, cudaStream_t stream) {
  const GemmSmem L;
  static size_t smem_set = 0;
  if (L.total != smem_set) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return e;
    smem_set = L.total;
  }
  const dim3 grid((out_features + BN - 1) / BN, (T + BM - 1) / BM, splits);
  int8_gemm_kernel<<<grid, GT, L.total, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w8, (const float*)w_scale, (__nv_bfloat16*)out,
      (float*)partials, (int*)tickets, T, out_features, in_features, ld, cols_per_split);
  return cudaGetLastError();
}

}  // namespace

// T <= 8 runs the decode path, more rows the prefill path. splits > 1 splits
// the contraction into runs of cols_per_split columns (a multiple of 1024 on
// the decode path, of 64 on the prefill path); partials and tickets are then
// required: decode [splits, T, OUT] f32 and [ceil(OUT/32)] int32, prefill
// [splits, ceil(T/128)*128, OUT] f32 and [ceil(T/128) * ceil(OUT/128)] int32,
// tickets zeroed.
extern "C" int int8_matmul_launch(const void* x, const void* w8, const void* w_scale, void* out,
                                  void* partials, void* tickets, int T, int splits,
                                  int cols_per_split, int out_features, int in_features, int ld,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T > 8)
    return gemm_launch(x, w8, w_scale, out, partials, tickets, T, splits, cols_per_split,
                       out_features, in_features, ld, st);
#define AQLM_INT8_CASE(NB)                                                                   \
  case NB:                                                                                   \
    return gemv_launch<NB>(x, w8, w_scale, out, partials, tickets, splits, cols_per_split,  \
                           out_features, in_features, ld, st);
  switch (T) {
    AQLM_INT8_CASE(1) AQLM_INT8_CASE(2) AQLM_INT8_CASE(3) AQLM_INT8_CASE(4)
    AQLM_INT8_CASE(5) AQLM_INT8_CASE(6) AQLM_INT8_CASE(7) AQLM_INT8_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef AQLM_INT8_CASE
}
