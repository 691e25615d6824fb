// W4A16 matmul: y[t, o] = bf16( sum_g s[g, o] * sum_{i in g} x[t, i] * (q[o, i] - 8) ).
//
// Replaces the TPU kernels of aqlm_tpu/ops/int4_matmul.py: int4_matmul_indexed
// (_call_indexed, pallas_call at :253; every projection of the stacked
// layers), int4_matmul (_call, :178) and the all-expert MoE forms
// int4_moe_matmul_indexed (_call_moe_indexed, :365; Mixtral's expert
// projections) and int4_moe_matmul (_call_moe, :295). One kernel source
// covers all four: the layer index is a pointer offset applied by the
// caller, and the expert is one more grid axis (E = 1 for a single matrix).
// The TPU kernel
// streams packed bytes into VMEM, unpacks both nibbles in registers, runs one
// MXU dot per 128-column group and folds the zero point and the group scale
// into the accumulator update, so each weight byte leaves HBM once; the same
// aim holds here. The bias is added outside, after the cast, as the JAX
// wrapper does.
//
// Layout (aqlm_tpu's): w4 [OUT, ldb] uint8, ldb = IN_pad / 2 (11008 pads to
// 11264), block-local packing: in 128-byte block i of a row, byte j holds
// column 256i + j in its low nibble (group 2i) and column 256i + 128 + j in
// its high nibble (group 2i + 1); q = w/s + 8 in [0, 15], padding q = 8.
// gscale [IN_pad / 128, OUT] f32 (transposed: a group's scales for
// neighbouring rows are neighbours). The kernel reads only the first
// in_features columns of x [T, in_features] bf16, which is never padded; the
// padding columns of w4 are read but meet zeros.
//
// Two paths, chosen by the row count:
//
// - Decode, T <= 8: bound by bytes (Llama-2-7B fused gate_up at T = 4:
//   45 MB of packed weights and 2.8 MB of scales, ~14 us at 3.35 TB/s). On
//   the CUDA cores the widening (about 2.4 operations a weight) and T FMAs a
//   weight make a GEMV issue-bound near T = 4 (a first version ran at 27% of
//   the byte bound there), so the product runs on the tensor cores instead,
//   transposed: W is the 16-row operand of mma.sync m16n8k16 and the
//   activation rows, padded to 8, the other. A block owns 16 output rows;
//   its 8 warps take interleaved 128-byte packing blocks of the contraction
//   and add their sums in shared memory in a fixed order. A thread loads 64
//   bytes of each packing block (two 16-byte loads per row, neighbouring
//   threads neighbouring bytes, the warp's next block and its group scales
//   in flight while this one computes) and widens each 4-byte word straight
//   into its A fragment: the low nibbles for group 2i, the high nibbles for
//   group 2i + 1, each group an f32 fragment added in with its scale. The
//   widening is exact (bf16 q - 8) and nothing is rounded with the scale,
//   as on the prefill path. Activations come from
//   global memory through L1 (8-byte loads; the same x serves every block).
//   Narrow projections (OUT = 4096) cannot fill 132 SMs by rows alone, so
//   the columns are also split over blocks: each split writes f32 partial
//   sums and the last block of a row group to finish (an atomic ticket) adds
//   them in a fixed order, so the result does not change from run to run.
// - Prefill, T > 8: bound by operations (2*T*OUT*IN on the bf16 tensor
//   cores; Llama-2-7B at T = 1024: ~414 GFLOP per layer, ~0.42 ms at 989
//   TFLOP/s). A 256-thread block owns a 64-token x 128-row output tile and
//   walks the contraction one 128-byte packing block (two groups) at a time:
//   the x slab, the packed W slab and the two groups' scales arrive by
//   cp.async, double buffered. Each group is one run of eight mma.sync
//   m16n8k16 bf16 products into a per-group f32 fragment, which is then
//   added into the accumulator times the group scale of its output column
//   (mma.sync's fragment layout says which column each element holds). The
//   nibbles are widened in registers straight into the B fragments as
//   bf16 (q - 8), which is exact; the weights are never rounded with their
//   scale. On both paths the contraction order within each 16-column step is
//   permuted (column 4t + e of the step is mma index 2t + (e & 1) +
//   8 (e >> 1)), the same for x and W, so a thread's four weights of a row
//   are one 32-bit word of four packed bytes and its four activations one
//   64-bit load.
//   Where the output tiles alone would not fill the card twice, the
//   contraction is split over blocks, reduced as on the decode path. A
//   wgmma/TMA pipeline with warp specialisation is later work.
//
// All experts (MoE): w4 [E, OUT, ldb], gscale [E, 2 * ldb / 128, OUT], out
// [E, T, OUT]; x is [T, in_features] shared by every expert (gate and up)
// or [E, T, in_features], one slab per expert (down), never padded. One
// launch covers every expert: the expert is the decode grid's z axis and is
// folded with the splits into the prefill grid's z axis; each block offsets
// its pointers by its expert, and split partial sums and tickets are per
// expert, so the last-block reduction never mixes experts. Mixtral-8x7B
// decode at T = 4 reads 235 MB of gate nibbles and 14.7 MB of scales
// (~0.075 ms at 3.35 TB/s): the same tensor-core GEMV with E times the
// blocks. The expert axis is a template flag (MOE): a single matrix runs
// the kernels compiled without it, so their registers and code stay those
// of the one-matrix kernels.
#include "common.cuh"

namespace {

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem_src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem_src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four nibbles (one per byte, 0..15) -> two bf16x2 words (q - 8) of bytes
// (0, 1) and (2, 3): bf16 with bits 0x43qq is 128 + q; subtracting 136 is exact.
__device__ __forceinline__ void nib4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t p0 = __byte_perm(w, 0x43434343u, 0x4140), p1 = __byte_perm(w, 0x43434343u, 0x4342);
  __nv_bfloat162 v0 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p0), off);
  __nv_bfloat162 v1 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p1), off);
  lo = *reinterpret_cast<uint32_t*>(&v0);
  hi = *reinterpret_cast<uint32_t*>(&v1);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// decode: T <= 8
// ---------------------------------------------------------------------------

constexpr int GV_WARPS = 8;
constexpr int GV_THREADS = GV_WARPS * 32;
constexpr int GV_ROWS = 16;  // output rows per block: one m16 tile, its contraction split over the warps

// y^T = W x^T on the tensor cores: W is the 16-row A operand, the (at most 8)
// activation rows the 8-column B operand. Warp w takes packing blocks
// p = w, w + 8, ... of the block's column range; a thread holds bytes
// 16 tig .. 16 tig + 15 and 64 + 16 tig .. of rows gid and gid + 8 of each.
// One of its 4-byte words gives its A values of one 16-column step (its
// columns j0 .. j0 + 3 stand for mma k 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9)
// and its B values are x[gid][j0 .. j0 + 3], one 8-byte load.
template <bool MOE>
__global__ void __launch_bounds__(GV_THREADS)
int4_gemv_kernel(const __nv_bfloat16* __restrict__ x,  // [T, in_features], or [E, T, ...]
                 const uint8_t* __restrict__ w4,        // [E, OUT, ldb] of one layer
                 const float* __restrict__ gscale,      // [E, 2 * ldb / 128, OUT]
                 __nv_bfloat16* __restrict__ out,       // [E, T, OUT]
                 float* __restrict__ partials,          // [E, splits, T, OUT] when split
                 int* __restrict__ tickets,             // [E, gridDim.x] zeroed, when split
                 int T, int out_features, int in_features, int ldb, int cols_per_split,
                 int x_per_expert) {
  __shared__ float s_red[GV_WARPS][GV_ROWS][8];
  __shared__ int s_last;

  if (MOE) {  // the expert (blockIdx.z) is a pointer offset
    const size_t ex = blockIdx.z;
    x += x_per_expert ? ex * T * in_features : 0;
    w4 += ex * out_features * ldb;
    gscale += ex * (2 * ldb / 128) * out_features;
    out += ex * T * out_features;
    if (gridDim.y > 1) {
      partials += ex * gridDim.y * T * out_features;
      tickets += ex * gridDim.x;
    }
  }

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int row_base = blockIdx.x * GV_ROWS;
  const int k_begin = blockIdx.y * cols_per_split;
  const int k_end = min(in_features, k_begin + cols_per_split);
  const int p_end = (k_end + 255) / 256;  // packing blocks [k_begin / 256, p_end)
  const int r0 = row_base + gid, r1 = r0 + 8;
  const bool v0 = r0 < out_features, v1 = r1 < out_features;
  const uint8_t* w0 = w4 + (size_t)(v0 ? r0 : 0) * ldb + 16 * tig;
  const uint8_t* w1 = w4 + (size_t)(v1 ? r1 : 0) * ldb + 16 * tig;
  const bool xrow = gid < T;
  const __nv_bfloat16* xr = x + (size_t)(xrow ? gid : 0) * in_features;

  // a thread's 64 bytes of packing block p and the block's two group scales
  // of its rows (zeros past the end)
  auto load_w = [&](uint4 (&d)[4], float (&sc)[4], int p) {
    const bool in = p < p_end;
    const uint4 z = make_uint4(0, 0, 0, 0);
    const float* sg = gscale + (size_t)(2 * p) * out_features;
    sc[0] = (in && v0) ? __ldg(sg + r0) : 0.f;
    sc[1] = (in && v1) ? __ldg(sg + r1) : 0.f;
    sc[2] = (in && v0) ? __ldg(sg + out_features + r0) : 0.f;
    sc[3] = (in && v1) ? __ldg(sg + out_features + r1) : 0.f;
    d[0] = (in && v0) ? __ldcs(reinterpret_cast<const uint4*>(w0 + 128 * (size_t)p)) : z;
    d[1] = (in && v0) ? __ldcs(reinterpret_cast<const uint4*>(w0 + 128 * (size_t)p + 64)) : z;
    d[2] = (in && v1) ? __ldcs(reinterpret_cast<const uint4*>(w1 + 128 * (size_t)p)) : z;
    d[3] = (in && v1) ? __ldcs(reinterpret_cast<const uint4*>(w1 + 128 * (size_t)p + 64)) : z;
  };

  // element e: row gid + 8 (e >> 1), activation row 2 tig + (e & 1)
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  uint4 wv[4];
  float sv[4];
  int p = k_begin / 256 + warp;
  load_w(wv, sv, p);
  for (; p < p_end; p += GV_WARPS) {
    uint4 wn[4];  // the warp's next packing block is in flight while this one computes
    float sn[4];
    load_w(wn, sn, p + GV_WARPS);
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // group 2p (low nibbles), then 2p + 1 (high)
      const int c_base = 256 * p + 128 * half;
      if (c_base >= k_end) break;  // a group wholly past the end meets zeros
      float g[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int seg = 0; seg < 2; ++seg)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int c = c_base + seg * 64 + 16 * tig + 4 * s;
          const uint2 xv = (xrow && c < k_end) ? __ldg(reinterpret_cast<const uint2*>(xr + c))
                                               : make_uint2(0, 0);
          uint32_t u0 = word_of(wv[seg], s), u1 = word_of(wv[2 + seg], s);
          u0 = (half ? u0 >> 4 : u0) & 0x0F0F0F0Fu;
          u1 = (half ? u1 >> 4 : u1) & 0x0F0F0F0Fu;
          uint32_t a[4];
          nib4_to_bf16x2(u0, a[0], a[2]);
          nib4_to_bf16x2(u1, a[1], a[3]);
          mma_bf16_16816(g, a, xv.x, xv.y);
        }
      const float s0 = sv[2 * half], s1 = sv[2 * half + 1];
      acc[0] = fmaf(g[0], s0, acc[0]);
      acc[1] = fmaf(g[1], s0, acc[1]);
      acc[2] = fmaf(g[2], s1, acc[2]);
      acc[3] = fmaf(g[3], s1, acc[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wv[i] = wn[i];
      sv[i] = sn[i];
    }
  }

  // the warps' sums meet in shared memory and are added in warp order
#pragma unroll
  for (int e = 0; e < 4; ++e) s_red[warp][gid + 8 * (e >> 1)][2 * tig + (e & 1)] = acc[e];
  __syncthreads();
  const int rr = tid / 8 % GV_ROWS, bb = tid % 8, row = row_base + rr;
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < GV_WARPS; ++w) v += s_red[w][rr][bb];
  const bool mine = tid < GV_ROWS * 8 && bb < T && row < out_features;

  if (gridDim.y == 1) {
    if (mine) out[(size_t)bb * out_features + row] = __float2bfloat16(v);
    return;
  }
  if (mine) partials[((size_t)blockIdx.y * T + bb) * out_features + row] = v;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!s_last || !mine) return;
  __threadfence();
  float sum = 0.f;
  for (int sp = 0; sp < (int)gridDim.y; ++sp)
    sum += __ldcg(partials + ((size_t)sp * T + bb) * out_features + row);
  out[(size_t)bb * out_features + row] = __float2bfloat16(sum);
}

// ---------------------------------------------------------------------------
// prefill: T > 8
// ---------------------------------------------------------------------------

constexpr int BM = 64;    // tokens per block
constexpr int BN = 128;   // output rows per block
constexpr int BK = 256;   // contraction columns per step: one packing block, two groups
constexpr int GT = 256;   // threads per block: 8 warps, 2 (tokens) x 4 (rows), 32 x 32 each
constexpr int XLD = BK + 16;        // padded shared row (bf16) of the x slab: 544 bytes
constexpr int WLD = BK / 2 + 16;    // padded shared row (bytes) of the packed W slab

struct GemmSmem {  // byte offsets in the dynamic shared memory
  size_t x[2], w[2], s[2], flag, total;
  __host__ __device__ GemmSmem() {
    size_t o = 0;
    for (int i = 0; i < 2; ++i) {
      x[i] = o;
      o += (size_t)BM * XLD * 2;
      w[i] = o;
      o += (size_t)BN * WLD;
      s[i] = o;
      o += (size_t)2 * BN * 4;
    }
    flag = o;
    total = o + 16;
  }
};

template <bool MOE>
__global__ void __launch_bounds__(GT, 2)
int4_gemm_kernel(const __nv_bfloat16* __restrict__ x,  // [T, in_features], or [E, T, ...]
                 const uint8_t* __restrict__ w4,        // [E, OUT, ldb] of one layer
                 const float* __restrict__ gscale,      // [E, 2 * ldb / 128, OUT]
                 __nv_bfloat16* __restrict__ out,       // [E, T, OUT]
                 float* __restrict__ partials,          // [E, splits, Tpad, OUT] when split
                 int* __restrict__ tickets,             // [E, row tiles * col tiles] zeroed
                 int T, int out_features, int in_features, int ldb, int cols_per_split,
                 int splits, int x_per_expert) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GemmSmem L;
  int& s_last = *reinterpret_cast<int*>(smem + L.flag);

  // z = expert * splits + split with MOE, the split alone without
  const int n_splits = MOE ? splits : (int)gridDim.z;
  const int split = MOE ? (int)blockIdx.z % splits : (int)blockIdx.z;
  if (MOE) {  // the expert is a pointer offset
    const size_t ex = blockIdx.z / splits;
    x += x_per_expert ? ex * T * in_features : 0;
    w4 += ex * out_features * ldb;
    gscale += ex * (2 * ldb / 128) * out_features;
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
  const int n_steps = (k_end - k_begin + BK - 1) / BK;

  auto load_step = [&](int s, int stage) {
    const int k0 = k_begin + s * BK;
    __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem + L.x[stage]);
    for (int i = tid; i < BM * (BK / 8); i += GT) {
      const int r = i / (BK / 8), c = i % (BK / 8);
      const bool valid = row0 + r < T && k0 + c * 8 < k_end;
      const __nv_bfloat16* src = valid ? x + (size_t)(row0 + r) * in_features + k0 + c * 8 : x;
      cp_async16(sx + r * XLD + c * 8, src, valid);
    }
    uint8_t* sw = smem + L.w[stage];
    for (int i = tid; i < BN * (BK / 32); i += GT) {  // 128 bytes a row: 8 x 16
      const int r = i / (BK / 32), c = i % (BK / 32);
      const bool valid = col0 + r < out_features;
      const uint8_t* src = valid ? w4 + (size_t)(col0 + r) * ldb + k0 / 2 + c * 16 : w4;
      cp_async16(sw + r * WLD + c * 16, src, valid);
    }
    float* ss = reinterpret_cast<float*>(smem + L.s[stage]);
    {  // the two groups' scales of the block's rows: one per thread
      const int g = tid / BN, r = tid % BN;
      const bool valid = col0 + r < out_features;
      const float* src = valid ? gscale + (size_t)(k0 / 128 + g) * out_features + col0 + r : gscale;
      cp_async4(ss + g * BN + r, src, valid);
    }
    cp_async_commit();
  };

  const int wm = warp / 4, wn = warp % 4;  // warp's 32 x 32 sub-tile
  const int gid = lane / 4, tig = lane % 4;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (n_steps > 0) load_step(0, 0);
  int stage = 0;
  for (int s = 0; s < n_steps; ++s, stage ^= 1) {
    if (s + 1 < n_steps) {
      load_step(s + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step s visible to all
    const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(smem + L.x[stage]);
    const uint8_t* sw = smem + L.w[stage];
    const float* ss = reinterpret_cast<const float*>(smem + L.s[stage]);
    const int k0 = k_begin + s * BK;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // group 2i (low nibbles), then 2i + 1 (high)
      if (k0 + half * 128 >= k_end) break;  // a group wholly past the end meets zeros
      float gacc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[i][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {  // 16 columns a step
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* p = sx + (wm * 32 + i * 16 + gid) * XLD + half * 128 + kk * 16 + 4 * tig;
          const uint2 top = *reinterpret_cast<const uint2*>(p);
          const uint2 bot = *reinterpret_cast<const uint2*>(p + 8 * XLD);
          a[i][0] = top.x;  // (row gid, mma k 2t, 2t+1) = columns 4t, 4t+1
          a[i][1] = bot.x;  // (row gid + 8, the same)
          a[i][2] = top.y;  // (row gid, mma k 2t+8, 2t+9) = columns 4t+2, 4t+3
          a[i][3] = bot.y;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(
              sw + (wn * 32 + j * 8 + gid) * WLD + kk * 16 + 4 * tig);
          uint32_t b0, b1;
          nib4_to_bf16x2(half == 0 ? (v & 0x0F0F0F0Fu) : ((v >> 4) & 0x0F0F0F0Fu), b0, b1);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_bf16_16816(gacc[i][j], a[i], b0, b1);
        }
      }
      // fold the group in with its scale: element e holds column 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 sc = *reinterpret_cast<const float2*>(ss + half * BN + wn * 32 + j * 8 + 2 * tig);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][j][0] = fmaf(gacc[i][j][0], sc.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(gacc[i][j][1], sc.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(gacc[i][j][2], sc.x, acc[i][j][2]);
          acc[i][j][3] = fmaf(gacc[i][j][3], sc.y, acc[i][j][3]);
        }
      }
    }
    __syncthreads();  // stage free for reuse
  }

  // element (i, j, e): token row0 + wm*32 + i*16 + gid + 8*(e >> 1),
  // output column col0 + wn*32 + j*8 + 2*tig + (e & 1)
  if (n_splits > 1) {
    // split contraction: park the f32 partial tile, the last block sums
    const int t_pad = gridDim.y * BM;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + wm * 32 + i * 16 + gid + 8 * (e >> 1);
          const int o = col0 + wn * 32 + j * 8 + 2 * tig + (e & 1);
          if (o < out_features)
            partials[((size_t)split * t_pad + row) * out_features + o] = acc[i][j][e];
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
      out[(size_t)(row0 + r) * out_features + o] = __float2bfloat16(v);
    }
    return;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + wm * 32 + i * 16 + gid + 8 * (e >> 1);
        const int o = col0 + wn * 32 + j * 8 + 2 * tig + (e & 1);
        if (row < T && o < out_features)
          out[(size_t)row * out_features + o] = __float2bfloat16(acc[i][j][e]);
      }
}

template <bool MOE>
cudaError_t gemm_launch(const void* x, const void* w4, const void* gscale, void* out,
                        void* partials, void* tickets, int experts, int x_per_expert, int T,
                        int splits, int cols_per_split, int out_features, int in_features,
                        int ldb, cudaStream_t stream) {
  const GemmSmem L;
  static size_t smem_set = 0;  // one per instantiation
  if (L.total != smem_set) {
    cudaError_t e = cudaFuncSetAttribute(int4_gemm_kernel<MOE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return e;
    smem_set = L.total;
  }
  const dim3 grid((out_features + BN - 1) / BN, (T + BM - 1) / BM, splits * experts);
  int4_gemm_kernel<MOE><<<grid, GT, L.total, stream>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)w4, (const float*)gscale, (__nv_bfloat16*)out,
      (float*)partials, (int*)tickets, T, out_features, in_features, ldb, cols_per_split, splits,
      x_per_expert);
  return cudaGetLastError();
}

template <bool MOE>
int dispatch(const void* x, const void* w4, const void* gscale, void* out, void* partials,
             void* tickets, int experts, int x_per_expert, int T, int splits, int cols_per_split,
             int out_features, int in_features, int ldb, cudaStream_t st) {
  if (T > 8)
    return gemm_launch<MOE>(x, w4, gscale, out, partials, tickets, experts, x_per_expert, T,
                            splits, cols_per_split, out_features, in_features, ldb, st);
  if (T < 1) return cudaErrorInvalidValue;
  const dim3 grid((out_features + GV_ROWS - 1) / GV_ROWS, splits, experts);
  int4_gemv_kernel<MOE><<<grid, GV_THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)w4, (const float*)gscale, (__nv_bfloat16*)out,
      (float*)partials, (int*)tickets, T, out_features, in_features, ldb, cols_per_split,
      x_per_expert);
  return cudaGetLastError();
}

}  // namespace

// T <= 8 runs the decode path, more rows the prefill path. w4 [E, OUT, ldb],
// gscale [E, 2 * ldb / 128, OUT], out [E, T, OUT]; x [T, in_features] shared
// by the experts (x_per_expert = 0) or [E, T, in_features]; E = 1 for one
// matrix. ldb is the packed row length (IN_pad / 2, a multiple of 128);
// in_features <= 2 * ldb and a multiple of 16. splits > 1 splits the
// contraction into runs of cols_per_split columns (a multiple of 256);
// partials and tickets are then required: decode [E, splits, T, OUT] f32 and
// [E, ceil(OUT/16)] int32, prefill [E, splits, ceil(T/64)*64, OUT] f32 and
// [E, ceil(T/64) * ceil(OUT/128)] int32, tickets zeroed.
extern "C" int int4_matmul_launch(const void* x, const void* w4, const void* gscale, void* out,
                                  void* partials, void* tickets, int experts, int x_per_expert,
                                  int T, int splits, int cols_per_split, int out_features,
                                  int in_features, int ldb, void* stream) {
  if (experts < 1 || splits < 1) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (experts > 1)
    return dispatch<true>(x, w4, gscale, out, partials, tickets, experts, x_per_expert, T, splits,
                          cols_per_split, out_features, in_features, ldb, st);
  // one matrix (or one expert) needs no offsets: the kernels compiled without them
  return dispatch<false>(x, w4, gscale, out, partials, tickets, 1, 0, T, splits, cols_per_split,
                         out_features, in_features, ldb, st);
}
