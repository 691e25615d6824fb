// W8A16 matmul: y[t, o] = bf16( w_scale[o] * sum_i x[t, i] * w8[o, i] ).
//
// Replaces the TPU kernels of aqlm_tpu/ops/int8_matmul.py: int8_matmul
// (_call, pallas_call at :85; the int8 lm_head), int8_matmul_indexed
// (_call_indexed, :231; every projection of the stacked layers) and the
// all-expert MoE forms int8_moe_matmul (_call_moe, :294) and
// int8_moe_matmul_indexed (_call_moe_indexed, :371; Mixtral's expert
// projections). One kernel source covers all four: the layer index is a
// pointer offset applied by the caller, and the expert is one more grid axis
// (E = 1 for a single matrix). The TPU kernel streams int8 tiles into VMEM and widens them to bf16
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
//
// All experts (MoE): w8 [E, OUT, ld], w_scale [E, OUT], out [E, T, OUT]; x is
// [T, in_features] shared by every expert (gate and up) or [E, T,
// in_features], one slab per expert (down). One launch covers every expert:
// the expert is the decode grid's z axis and is folded with the splits into
// the prefill grid's z axis; each block offsets its pointers by its expert,
// and split partial sums and tickets are per expert, so the last-block
// reduction never mixes experts. Mixtral-8x7B decode at T = 4 reads 470 MB
// of gate weights (0.14 ms at 3.35 TB/s): the same byte-bound GEMV, with
// E times the blocks. The expert axis is a template flag (MOE): a single
// matrix runs the kernels compiled without it, so its registers and code stay
// those of the one-matrix kernel (compiled in, the offsets took the T = 1
// GEMV from 64 registers to 94 and its split-K launches 11-13% slower).
//
// The activation backward (B10, int8_matmul_transposed: _call_t, pallas_call
// at :153; the backward of every int8 projection, aqlm_tpu/ops/runtime.py:305)
// is a kernel of its own below, so the forward instances keep their
// registers: dx[t, i] = bf16( sum_o bf16(g[t, o] * w_scale[o]) * w8[o, i] ).
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

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

template <int B, bool MOE>
__global__ void __launch_bounds__(GV_THREADS)
int8_gemv_kernel(const __nv_bfloat16* __restrict__ x,  // [B, in_features], or [E, B, ...]
                 const int8_t* __restrict__ w8,         // [E, OUT, ld] of one layer
                 const float* __restrict__ w_scale,     // [E, OUT]
                 __nv_bfloat16* __restrict__ out,       // [E, B, OUT]
                 float* __restrict__ partials,          // [E, splits, B, OUT] when split
                 int* __restrict__ tickets,             // [E, gridDim.x] zeroed, when split
                 int out_features, int in_features, int ld, int cols_per_split,
                 int x_per_expert) {
  __shared__ __align__(16) float s_x[B][GV_CHUNK];
  __shared__ int s_last;

  if (MOE) {  // the expert (blockIdx.z) is a pointer offset
    const size_t ex = blockIdx.z;
    x += x_per_expert ? ex * B * in_features : 0;
    w8 += ex * out_features * ld;
    w_scale += ex * out_features;
    out += ex * B * out_features;
    if (gridDim.y > 1) {
      partials += ex * gridDim.y * B * out_features;
      tickets += ex * gridDim.x;
    }
  }

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

template <int B, bool MOE>
cudaError_t gemv_launch(const void* x, const void* w8, const void* w_scale, void* out,
                        void* partials, void* tickets, int experts, int x_per_expert, int splits,
                        int cols_per_split, int out_features, int in_features, int ld,
                        cudaStream_t stream) {
  const dim3 grid((out_features + GV_ROWS - 1) / GV_ROWS, splits, experts);
  int8_gemv_kernel<B, MOE><<<grid, GV_THREADS, 0, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w8, (const float*)w_scale, (__nv_bfloat16*)out,
      (float*)partials, (int*)tickets, out_features, in_features, ld, cols_per_split,
      x_per_expert);
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

template <bool MOE>
__global__ void __launch_bounds__(GT, 2)
int8_gemm_kernel(const __nv_bfloat16* __restrict__ x,  // [T, in_features], or [E, T, ...]
                 const int8_t* __restrict__ w8,         // [E, OUT, ld] of one layer
                 const float* __restrict__ w_scale,     // [E, OUT]
                 __nv_bfloat16* __restrict__ out,       // [E, T, OUT]
                 float* __restrict__ partials,          // [E, splits, Tpad, OUT] when split
                 int* __restrict__ tickets,             // [E, row tiles * col tiles] zeroed
                 int T, int out_features, int in_features, int ld, int cols_per_split,
                 int splits, int x_per_expert) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GemmSmem L;
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  int& s_last = *reinterpret_cast<int*>(smem + L.flag);

  // z = expert * splits + split with MOE, the split alone without
  const int n_splits = MOE ? splits : (int)gridDim.z;
  const int split = MOE ? (int)blockIdx.z % splits : (int)blockIdx.z;
  if (MOE) {  // the expert is a pointer offset
    const size_t ex = blockIdx.z / splits;
    x += x_per_expert ? ex * T * in_features : 0;
    w8 += ex * out_features * ld;
    w_scale += ex * out_features;
    out += ex * T * out_features;
    if (splits > 1) {
      partials += ex * splits * gridDim.y * BM * out_features;
      tickets += ex * gridDim.y * gridDim.x;
    }
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * BN;  // first output row of W (output column of y)
  const int row0 = blockIdx.y * BM;  // first token
  const int k_begin = split * cols_per_split;
  const int k_end = min(in_features, k_begin + cols_per_split);
  const int n_slabs = (k_end - k_begin + BK - 1) / BK;

  auto load_slab = [&](int s, int stage) {
    const int k0 = k_begin + s * BK;
    __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem + L.x[stage]);
    for (int i = tid; i < BM * (BK / 8); i += GT) {
      const int r = i / (BK / 8), c = i % (BK / 8);
      const bool valid = row0 + r < T && k0 + c * 8 < k_end;
      const __nv_bfloat16* src = valid ? x + (size_t)(row0 + r) * in_features + k0 + c * 8 : x;
      aqlm::cp_async16(sx + r * XLD + c * 8, src, valid);
    }
    int8_t* sw = reinterpret_cast<int8_t*>(smem + L.w8[stage]);
    for (int i = tid; i < BN * (BK / 16); i += GT) {
      const int r = i / (BK / 16), c = i % (BK / 16);
      const bool valid = col0 + r < out_features && k0 + c * 16 < k_end;
      const int8_t* src = valid ? w8 + (size_t)(col0 + r) * ld + k0 + c * 16 : w8;
      aqlm::cp_async16(sw + r * BK + c * 16, src, valid);
    }
    aqlm::cp_async_commit();
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
      aqlm::cp_async_wait<1>();
    } else {
      aqlm::cp_async_wait<0>();
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
  if (n_splits > 1) {
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
            partials[((size_t)split * t_pad + row) * out_features + o] = epi[e];
        }
        __syncwarp();
      }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(tickets + blockIdx.y * gridDim.x + blockIdx.x, 1) == n_splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int e = tid; e < BM * BN; e += GT) {
      const int r = e / BN, o = col0 + e % BN;
      if (row0 + r >= T || o >= out_features) continue;
      float v = 0.f;
      for (int z = 0; z < n_splits; ++z)
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

template <bool MOE>
cudaError_t gemm_launch(const void* x, const void* w8, const void* w_scale, void* out,
                        void* partials, void* tickets, int experts, int x_per_expert, int T,
                        int splits, int cols_per_split, int out_features, int in_features,
                        int ld, cudaStream_t stream) {
  const GemmSmem L;
  static size_t smem_set = 0;  // one per instantiation
  if (L.total != smem_set) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemm_kernel<MOE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return e;
    smem_set = L.total;
  }
  const dim3 grid((out_features + BN - 1) / BN, (T + BM - 1) / BM, splits * experts);
  int8_gemm_kernel<MOE><<<grid, GT, L.total, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w8, (const float*)w_scale, (__nv_bfloat16*)out,
      (float*)partials, (int*)tickets, T, out_features, in_features, ld, cols_per_split, splits,
      x_per_expert);
  return cudaGetLastError();
}

template <bool MOE>
int dispatch(const void* x, const void* w8, const void* w_scale, void* out, void* partials,
             void* tickets, int experts, int x_per_expert, int T, int splits, int cols_per_split,
             int out_features, int in_features, int ld, cudaStream_t st) {
  if (T > 8)
    return gemm_launch<MOE>(x, w8, w_scale, out, partials, tickets, experts, x_per_expert, T,
                            splits, cols_per_split, out_features, in_features, ld, st);
#define AQLM_INT8_CASE(NB)                                                                    \
  case NB:                                                                                    \
    return gemv_launch<NB, MOE>(x, w8, w_scale, out, partials, tickets, experts, x_per_expert, \
                                splits, cols_per_split, out_features, in_features, ld, st);
  switch (T) {
    AQLM_INT8_CASE(1) AQLM_INT8_CASE(2) AQLM_INT8_CASE(3) AQLM_INT8_CASE(4)
    AQLM_INT8_CASE(5) AQLM_INT8_CASE(6) AQLM_INT8_CASE(7) AQLM_INT8_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef AQLM_INT8_CASE
}

// ---------------------------------------------------------------------------
// backward (B10): dx = bf16(g * w_scale) @ w8
// ---------------------------------------------------------------------------
//
// The contraction runs over OUT, w8's row index, so a [64 x 128] tile of w8
// (64 output rows, 128 input columns) is read along its rows, contiguous in
// memory, and widened into shared memory as a row-major B operand, where the
// forward reads the same bytes as a column-major one. What bounds it: 2*T*OUT*
// IN_pad operations on the bf16 tensor cores (Llama-2-7B's gate at T = 1024:
// 92 GFLOP, 0.093 ms at 989 TFLOP/s); w8 is read once per 128-token tile.
//
// Design: a 256-thread block owns 128 tokens x 128 input columns and walks
// OUT in 64-row slabs. The w8 slab arrives by cp.async, double buffered; the
// gradient slab is loaded into registers one slab ahead (bf16 or f32),
// multiplied by the scales in f32 and rounded to bf16 as the TPU wrapper
// rounds it (aqlm_tpu/ops/int8_matmul.py:176), then stored to shared memory.
// Eight warps run WMMA 16x16x16 bf16 products into f32 fragments (64 x 32
// each); the epilogue casts to bf16. Ragged T, IN_pad (a multiple of 16) and
// OUT (of 8) are masked. No split of the contraction: at T = 1024 the output
// tiles alone fill the card (256 blocks at IN 4096, 704 at 11264).

constexpr int TBM = 128;          // tokens per block
constexpr int TBN = 128;          // input columns per block
constexpr int TBK = 64;           // output rows (the contraction) per slab
constexpr int TGLD = TBK + 8;     // padded shared row (bf16) of the scaled-gradient slab
constexpr int TWLD = TBN + 8;     // padded shared row (bf16) of the widened W slab
constexpr int T_GROUPS = TBM * TBK / 8 / GT;  // 8-wide gradient groups per thread (4)

struct GemmTSmem {  // byte offsets in the dynamic shared memory
  size_t g, w8[2], w, epi, total;
  __host__ __device__ GemmTSmem() {
    size_t o = 0;
    g = o;
    o += (size_t)TBM * TGLD * 2;
    for (int i = 0; i < 2; ++i) {
      w8[i] = o;
      o += (size_t)TBK * TBN;
    }
    w = o;
    o += (size_t)TBK * TWLD * 2;
    epi = o;
    o += (size_t)(GT / 32) * 16 * 16 * 4;
    total = o;
  }
};

template <typename GT_T>
__global__ void __launch_bounds__(GT, 2)
int8_gemm_t_kernel(const GT_T* __restrict__ g,          // [T, OUT]
                   const int8_t* __restrict__ w8,       // [OUT, ld]
                   const float* __restrict__ w_scale,   // [OUT]
                   __nv_bfloat16* __restrict__ out,     // [T, ld]
                   int T, int out_features, int ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GemmTSmem L;
  __nv_bfloat16* s_g = reinterpret_cast<__nv_bfloat16*>(smem + L.g);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + L.w);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * TBN;  // first input column (of dx)
  const int row0 = blockIdx.y * TBM;  // first token
  const int n_slabs = (out_features + TBK - 1) / TBK;
  const int c8 = tid % 8;             // the thread's 8-wide column group of a gradient slab

  auto load_w = [&](int s, int stage) {
    const int o0 = s * TBK;
    int8_t* sw = reinterpret_cast<int8_t*>(smem + L.w8[stage]);
    for (int i = tid; i < TBK * (TBN / 16); i += GT) {
      const int r = i / (TBN / 16), c = i % (TBN / 16);
      const bool valid = o0 + r < out_features && col0 + c * 16 < ld;
      const int8_t* src = valid ? w8 + (size_t)(o0 + r) * ld + col0 + c * 16 : w8;
      aqlm::cp_async16(sw + r * TBN + c * 16, src, valid);
    }
    aqlm::cp_async_commit();
  };
  // the thread's gradient groups of slab s, scaled in f32 and rounded to bf16
  // pairs as they arrive (zeros past the edges)
  uint32_t gv[T_GROUPS][4];
  auto load_g = [&](int s) {
    const int o = s * TBK + c8 * 8;
    const bool cvalid = o < out_features;  // OUT % 8 == 0: a group is all in or all out
    float sc[8];
    if (cvalid) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(w_scale + o));
      const float4 b = __ldg(reinterpret_cast<const float4*>(w_scale + o) + 1);
      sc[0] = a.x; sc[1] = a.y; sc[2] = a.z; sc[3] = a.w;
      sc[4] = b.x; sc[5] = b.y; sc[6] = b.z; sc[7] = b.w;
    }
#pragma unroll
    for (int q = 0; q < T_GROUPS; ++q) {
      const int row = row0 + tid / 8 + q * (GT / 8);
      float f[8];
      if (cvalid && row < T) {
        aqlm::load8(g + (size_t)row * out_features + o, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] *= sc[j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
        gv[q][e] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
  };
  auto store_g = [&]() {
#pragma unroll
    for (int q = 0; q < T_GROUPS; ++q)
      *reinterpret_cast<uint4*>(s_g + (tid / 8 + q * (GT / 8)) * TGLD + c8 * 8) =
          make_uint4(gv[q][0], gv[q][1], gv[q][2], gv[q][3]);
  };

  const int wm = warp / 4, wn = warp % 4;  // warp's 64 x 32 sub-tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (n_slabs > 0) {
    load_w(0, 0);
    load_g(0);
  }
  for (int s = 0; s < n_slabs; ++s) {
    const int stage = s & 1;
    store_g();  // s_g is free: the barrier after the previous slab's products
    if (s + 1 < n_slabs) {
      load_w(s + 1, stage ^ 1);
      aqlm::cp_async_wait<1>();
    } else {
      aqlm::cp_async_wait<0>();
    }
    __syncthreads();  // gradient slab and w8 slab s visible to all
    {  // widen W: each thread 32 int8 of a row -> 32 bf16
      const int r = tid / 4, h = tid % 4;
      const uint4* src = reinterpret_cast<const uint4*>(smem + L.w8[stage] + r * TBN + h * 32);
      uint32_t* dst = reinterpret_cast<uint32_t*>(s_w + r * TWLD + h * 32);
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
    if (s + 1 < n_slabs) load_g(s + 1);  // in flight over the products
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], s_g + (wm * 64 + i * 16) * TGLD + kk, TGLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], s_w + kk * TWLD + wn * 32 + j * 16, TWLD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // s_g, s_w and the stage free for reuse
  }

  // epilogue: each warp stages one 16x16 fragment at a time and casts
  float* epi = reinterpret_cast<float*>(smem + L.epi) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(epi, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = row0 + wm * 64 + i * 16 + e / 16;
        const int col = col0 + wn * 32 + j * 16 + e % 16;
        if (row < T && col < ld) out[(size_t)row * ld + col] = __float2bfloat16(epi[e]);
      }
      __syncwarp();
    }
}

template <typename GT_T>
cudaError_t gemm_t_launch(const void* g, const void* w8, const void* w_scale, void* out, int T,
                          int out_features, int ld, cudaStream_t stream) {
  const GemmTSmem L;
  static size_t smem_set = 0;  // one per instantiation
  if (L.total != smem_set) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemm_t_kernel<GT_T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return e;
    smem_set = L.total;
  }
  const dim3 grid((ld + TBN - 1) / TBN, (T + TBM - 1) / TBM);
  int8_gemm_t_kernel<GT_T><<<grid, GT, L.total, stream>>>(
      (const GT_T*)g, (const int8_t*)w8, (const float*)w_scale, (__nv_bfloat16*)out, T,
      out_features, ld);
  return cudaGetLastError();
}

}  // namespace

// T <= 8 runs the decode path, more rows the prefill path. w8 [E, OUT, ld],
// w_scale [E, OUT], out [E, T, OUT]; x [T, in_features] shared by the
// experts (x_per_expert = 0) or [E, T, in_features]; E = 1 for one matrix.
// splits > 1 splits the contraction into runs of cols_per_split columns (a
// multiple of 1024 on the decode path, of 64 on the prefill path); partials
// and tickets are then required: decode [E, splits, T, OUT] f32 and
// [E, ceil(OUT/16)] int32, prefill [E, splits, ceil(T/128)*128, OUT] f32 and
// [E, ceil(T/128) * ceil(OUT/128)] int32, tickets zeroed.
extern "C" int int8_matmul_launch(const void* x, const void* w8, const void* w_scale, void* out,
                                  void* partials, void* tickets, int experts, int x_per_expert,
                                  int T, int splits, int cols_per_split, int out_features,
                                  int in_features, int ld, void* stream) {
  if (experts < 1 || splits < 1) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (experts > 1)
    return dispatch<true>(x, w8, w_scale, out, partials, tickets, experts, x_per_expert, T,
                          splits, cols_per_split, out_features, in_features, ld, st);
  // one matrix (or one expert) needs no offsets: the kernels compiled without them
  return dispatch<false>(x, w8, w_scale, out, partials, tickets, 1, 0, T, splits, cols_per_split,
                         out_features, in_features, ld, st);
}

// The activation backward: g [T, OUT] bf16 (g_f32 = 0) or f32, w8 [OUT, ld]
// int8, w_scale [OUT] f32 -> out [T, ld] bf16. OUT a multiple of 8, ld of 16.
extern "C" int int8_matmul_t_launch(const void* g, const void* w8, const void* w_scale, void* out,
                                    int g_f32, int T, int out_features, int ld, void* stream) {
  if (T < 1 || out_features % 8 || ld % 16) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (g_f32) return gemm_t_launch<float>(g, w8, w_scale, out, T, out_features, ld, st);
  return gemm_t_launch<__nv_bfloat16>(g, w8, w_scale, out, T, out_features, ld, st);
}
