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
// Hopper has a fast shared-memory gather, so the TPU's one-hot MXU trick is
// not carried over: a block's codebooks (K x S x 8 bf16, 8 KB for 2x8) sit in
// shared memory and each code gathers its 16-byte row; with one or two
// codebooks the f32 sum rounded to bf16 is one bf16x2 add per pair (as K2).
// Both forms are laid out by the pure kernels.onehot_plan.
//
// GEMV form (1-8 rows, the decode buckets). The first design kept one 4-byte
// code word in flight a thread (~2 KB an SM), re-read x from device memory
// per group and did the products on the CUDA cores. Here a block of nine
// warps owns 128 output columns and a run of input groups:
//   - warp 8, the producer, streams the codes through a ring of 1-8 stages
//     of [K x 32 groups x 128 columns] bytes, one TMA copy a stage (3-D map
//     over [K, IG, OUT], 128-byte swizzle, ragged edges zero-filled), or, where
//     OUT % 16 != 0 (no TMA stride), its lanes' loads into the same swizzled
//     layout; each stage completes on its own mbarrier;
//   - warps 0-7 stage x once (bf16; f32 x as hi + lo bf16 planes) and run
//     the products on the tensor cores: mma.sync m16n8k16 with the
//     dequantized W as the m16 operand (16 output columns) and x as n8 (the
//     rows, padded to 8), f32 sums; each k32 step covers four groups, a
//     thread's eight k slots being one group's eight inputs, so a 16-byte
//     codebook row is two A registers per product, read straight from the
//     gather. A thread's 16 codes of a group are one 16-byte read (the chunk
//     chosen so a quarter warp meets each bank group once through the
//     swizzle); each of the eight warps takes one of a stage's eight k32
//     steps;
//   - the warps meet in shared memory in a fixed order, and the splits of the
//     input groups (k/v: 64 columns, one block) in f32 partial sums that the
//     last block of a column block to finish (an atomic ticket) adds in split
//     order, so the result does not depend on block timing; every consumer
//     thread takes a share of the outputs, the partial sums' loads of all
//     its outputs in flight at once.
//
// GEMM form (more rows, bf16 x): K2's warp-specialised pipeline
// (gather_prefill.cu) over the untiled codes. A block of 384 threads owns a
// BM x 128 output tile (BM 256 past 128 rows, so each weight is dequantized
// ceil(T / 256) times; else 128) and walks the input in 64-wide slabs:
// warp 8 keeps a ring of 3-4 stages (the x tile [BM x 64] by TMA, rows past
// T and inputs past IN zero-filled; the code slab [K x 8 groups x 128
// columns] by its lanes' cp.async, 16 or 4 bytes as OUT's alignment allows,
// else byte loads; columns past OUT and groups past IG read as code 0 and
// meet zero activations or are never stored); warps 9-11 dequantize slab
// s+1 into wgmma's K-major core-matrix layout; warps 0-7 run wgmma
// m64n128k16. The epilogue rounds as above. Splits of the input, for short
// prompts and k/v, meet as in the GEMV form.
#include <cuda.h>  // CUtensorMap
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace aqlm;

constexpr int G = 8;
constexpr int SMEM_LIMIT = 232448;

// the output epilogue: round to the activations' dtype, then scale in it
__device__ __forceinline__ void store_scaled(__nv_bfloat16* p, float acc, float scale) {
  const float y = __bfloat162float(__float2bfloat16(acc));
  const float s = __bfloat162float(__float2bfloat16(scale));
  *p = __float2bfloat16(y * s);
}
__device__ __forceinline__ void store_scaled(float* p, float acc, float scale) { *p = acc * scale; }

// Two bf16 pairs added lane by lane, each sum correctly rounded.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The bf16 weight group of K codes: bf16(sum_k f32(cb[k][code_k])), the
// codes being byte `m` of each of the K 16-byte code words.
template <int M>
__device__ __forceinline__ uint32_t code_byte(const uint4& c) {
  const uint32_t w = M < 4 ? c.x : M < 8 ? c.y : M < 12 ? c.z : c.w;
  return (w >> (8 * (M % 4))) & 0xffu;
}
template <int M>
__device__ __forceinline__ uint4 dequant_group(const uint4* s_cb, const uint4* cw, int K, int S) {
  uint4 v = s_cb[code_byte<M>(cw[0])];
  if (K <= 2) {
    if (K == 2) {
      const uint4 b = s_cb[S + code_byte<M>(cw[1])];
      v.x = add_bf16x2(v.x, b.x);
      v.y = add_bf16x2(v.y, b.y);
      v.z = add_bf16x2(v.z, b.z);
      v.w = add_bf16x2(v.w, b.w);
    }
    return v;
  }
  float f[8];
  bf16x8_to_float(v, f);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    if (k >= K) break;
    float h[8];
    bf16x8_to_float(s_cb[k * S + code_byte<M>(cw[k])], h);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] += h[i];
  }
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                    pack_bf16x2(f[6], f[7]));
}

// D[16 x 8] += A[16 x 16] * B[16 x 8], bf16 in, f32 sums.
__device__ __forceinline__ void mma_16816(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------------ GEMV form

constexpr int V_COLS = 128;  // output columns per block
constexpr int V_GS = 32;     // input groups per ring stage: eight k32 steps
constexpr int V_CONSUMER_WARPS = 8;
constexpr int V_PRODUCER_WARP = V_CONSUMER_WARPS;
constexpr int V_THREADS = (V_CONSUMER_WARPS + 1) * 32;
constexpr int V_STAGE_ROWS = V_GS;  // 128-byte code rows a stage holds per codebook
constexpr int V_MAX_STAGES = 8;

// Byte offsets from the first 1024-aligned byte of the dynamic shared memory
// (the swizzled code stages need it): the ring, the codebooks, x's planes
// (B rows of xg 16-byte groups; f32 x: hi, then lo), the warps' sums, the
// stage barriers, the split flag; 1024 bytes of slack.
// kernels.onehot_plan computes the same total.
struct VLayout {
  int K, S, stages, B, xg, planes;
  __host__ __device__ VLayout(int K_, int S_, int st, int B_, int xg_, int pl)
      : K(K_), S(S_), stages(st), B(B_), xg(xg_), planes(pl) {}
  __host__ __device__ int ring(int s) const { return s * K * V_STAGE_ROWS * V_COLS; }
  __host__ __device__ int cb() const { return ring(stages); }
  __host__ __device__ int x(int p) const { return cb() + K * S * 16 + p * B * xg * 16; }
  __host__ __device__ int red() const { return x(planes); }
  __host__ __device__ int bar() const { return red() + V_CONSUMER_WARPS * 32 * 32 * 4; }
  __host__ __device__ int flag() const { return bar() + 2 * stages * 8; }
  __host__ __device__ int total() const { return flag() + 16 + 1024; }
};

// The 16-column chunk whose codes thread (g = lane / 4) reads: neighbouring
// g differ in bit 2, so a quarter warp's eight reads (g = 2p, 2p + 1; four
// groups t) meet the eight 16-byte bank groups once through the swizzle.
__device__ __forceinline__ int v_chunk(int g) { return ((g & 1) << 2) | (g >> 1); }

template <typename XT>
__global__ void __launch_bounds__(V_THREADS)
onehot_gemv_kernel(const __grid_constant__ CUtensorMap c_map,  // codes [K, IG, OUT] (use_tma)
                   const XT* __restrict__ x,                   // [B, IN]
                   const uint8_t* __restrict__ codes,          // [K, IG, OUT] of one layer
                   const __nv_bfloat16* __restrict__ cb,       // [K, S, G] of one layer
                   const float* __restrict__ scales,           // [OUT] of one layer
                   XT* __restrict__ out,                       // [B, OUT]
                   float* __restrict__ partials,               // [splits, B, OUT] when split
                   int* __restrict__ tickets,                  // [ceil(OUT / 128)] zeroed
                   int B, int IG, int OUT, int K, int S, int groups_per_split, int stages, int xg,
                   int use_tma) {
  constexpr bool F32 = sizeof(XT) == 4;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const VLayout L(K, S, stages, B, xg, F32 ? 2 : 1);
  uint4* s_cb = reinterpret_cast<uint4*>(smem + L.cb());
  float* s_red = reinterpret_cast<float*>(smem + L.red());
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar());
  uint64_t* empty = full + stages;
  int& s_last = *reinterpret_cast<int*>(smem + L.flag());

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * V_COLS;
  const int g_begin = blockIdx.y * groups_per_split;
  const int n_groups = min(IG, g_begin + groups_per_split) - g_begin;
  const int n_local = (n_groups + V_GS - 1) / V_GS;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, V_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == V_PRODUCER_WARP) {
    for (int j = 0; j < n_local; ++j) {
      const int st = j % stages, g0 = g_begin + j * V_GS;
      if (j >= stages) mbar_wait(empty + st, (j / stages - 1) & 1);
      unsigned char* dst = smem + L.ring(st);
      if (use_tma) {
        if (lane == 0) {
          mbar_arrive_expect_tx(full + st, K * V_STAGE_ROWS * V_COLS);
          tma_load_3d(dst, &c_map, col0, g0, 0, full + st);
        }
      } else {
        // OUT % 16 != 0: the same swizzled stage from byte loads, zeros past the edges
        for (int q = lane; q < K * V_STAGE_ROWS * (V_COLS / 4); q += 32) {
          const int R = q / (V_COLS / 4), c = (q % (V_COLS / 4)) * 4;
          const int k = R / V_STAGE_ROWS, ig = g0 + R % V_STAGE_ROWS;
          uint32_t word = 0;
          if (ig < IG) {
            const uint8_t* src = codes + ((size_t)k * IG + ig) * OUT + col0 + c;
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (col0 + c + b < OUT) word |= (uint32_t)__ldg(src + b) << (8 * b);
          }
          *reinterpret_cast<uint32_t*>(dst + R * 128 + (((c >> 4) ^ (R & 7)) << 4) + (c & 15)) = word;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(full + st);
      }
    }
    return;
  }

  // consumers: the codebooks and this block's x, then the products
  constexpr int CT = V_CONSUMER_WARPS * 32;
#pragma unroll 4
  for (int i = tid; i < K * S; i += CT) s_cb[i] = reinterpret_cast<const uint4*>(cb)[i];
  uint4* s_x = reinterpret_cast<uint4*>(smem + L.x(0));
  uint4* s_xlo = reinterpret_cast<uint4*>(smem + L.x(1));
  const int in_features = IG * G;
#pragma unroll 2
  for (int i = tid; i < B * xg; i += CT) {
    const int b = i / xg, gl = i % xg;
    uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi;
    if (gl < n_groups) {
      const XT* src = x + (size_t)b * in_features + (size_t)(g_begin + gl) * G;
      if constexpr (F32) {
        float f[8];
        load8(src, f);
        float h[8], r[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          h[e] = __bfloat162float(__float2bfloat16(f[e]));
          r[e] = f[e] - h[e];
        }
        hi = make_uint4(pack_bf16x2(h[0], h[1]), pack_bf16x2(h[2], h[3]), pack_bf16x2(h[4], h[5]),
                        pack_bf16x2(h[6], h[7]));
        lo = make_uint4(pack_bf16x2(r[0], r[1]), pack_bf16x2(r[2], r[3]), pack_bf16x2(r[4], r[5]),
                        pack_bf16x2(r[6], r[7]));
      } else {
        hi = __ldg(reinterpret_cast<const uint4*>(src));
      }
    }
    s_x[i] = hi;
    if constexpr (F32) s_xlo[i] = lo;
  }
  bar_sync(1, CT);

  const int g = lane >> 2, t = lane & 3, cg = v_chunk(g);
  float acc[8][4];  // [m16 tile][fragment]
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
  for (int j = 0; j < n_local; ++j) {
    const int st = j % stages;
    mbar_wait(full + st, (j / stages) & 1);
    const unsigned char* ring = smem + L.ring(st);
    {
      const int r = warp * 4 + t;  // this thread's group in the stage: warp w takes k32 step w
      uint4 xv = make_uint4(0u, 0u, 0u, 0u), xl = xv;
      if (g < B) {
        xv = s_x[g * xg + j * V_GS + r];
        if constexpr (F32) xl = s_xlo[g * xg + j * V_GS + r];
      }
      uint4 cw[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= K) break;
        const int R = k * V_STAGE_ROWS + r;
        cw[k] = *reinterpret_cast<const uint4*>(ring + R * 128 + ((cg ^ (R & 7)) << 4));
      }
      // column 16 cg + m of the block (m < 8) is row g of tile m, column
      // 16 cg + 8 + m row g + 8; the k32 step's 32 inputs are four groups,
      // thread t's eight k slots group t's eight inputs
#define AQLM_B15_TILE(M)                                                          \
  {                                                                              \
    const uint4 wa = dequant_group<M>(s_cb, cw, K, S);                           \
    const uint4 wb = dequant_group<M + 8>(s_cb, cw, K, S);                       \
    mma_16816(acc[M], wa.x, wb.x, wa.y, wb.y, xv.x, xv.y);                       \
    mma_16816(acc[M], wa.z, wb.z, wa.w, wb.w, xv.z, xv.w);                       \
    if constexpr (F32) {                                                         \
      mma_16816(acc[M], wa.x, wb.x, wa.y, wb.y, xl.x, xl.y);                     \
      mma_16816(acc[M], wa.z, wb.z, wa.w, wb.w, xl.z, xl.w);                     \
    }                                                                            \
  }
      AQLM_B15_TILE(0) AQLM_B15_TILE(1) AQLM_B15_TILE(2) AQLM_B15_TILE(3)
      AQLM_B15_TILE(4) AQLM_B15_TILE(5) AQLM_B15_TILE(6) AQLM_B15_TILE(7)
#undef AQLM_B15_TILE
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
  // the warps meet in shared memory: output (b, c) of the block, c = 16
  // v_chunk(g) + 8 h + m, b = 2 t + p, is fragment 2 h + p of tile m in lane
  // 4 g + t of every warp, summed in warp order
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) s_red[(warp * 32 + m * 4 + i) * 32 + lane] = acc[m][i];
  bar_sync(1, CT);
  const bool split = gridDim.y > 1;
  const int ncols = min(V_COLS, OUT - col0);
  constexpr int PER = V_COLS * 8 / CT;  // outputs a thread at most (B <= 8)
  float v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * CT, b = e / V_COLS, c = e % V_COLS;
    v[k] = 0.f;
    if (b >= B) continue;
    const int cgi = c >> 4, gi = ((cgi & 3) << 1) | (cgi >> 2);  // v_chunk(gi) == cgi
    const float* src = s_red + ((c & 7) * 4 + ((c >> 3) & 1) * 2 + (b & 1)) * 32 + 4 * gi + (b >> 1);
#pragma unroll
    for (int w = 0; w < V_CONSUMER_WARPS; ++w) v[k] += src[w * 32 * 32];
    if (c >= ncols) continue;
    if (split)
      partials[((size_t)blockIdx.y * B + b) * OUT + col0 + c] = v[k];
    else
      store_scaled(out + (size_t)b * OUT + col0 + c, v[k], scales[col0 + c]);
  }
  if (!split) return;
  // the splits of the input groups: the last block of this column block to
  // finish adds the partial sums in split order
  __threadfence();
  bar_sync(1, CT);
  if (tid == 0) s_last = atomicAdd(tickets + blockIdx.x, 1) == (int)gridDim.y - 1;
  bar_sync(1, CT);
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < PER; ++k) v[k] = 0.f;
  for (int z = 0; z < (int)gridDim.y; ++z)
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * CT, b = e / V_COLS, c = e % V_COLS;
      if (b < B && c < ncols) v[k] += __ldcg(partials + ((size_t)z * B + b) * OUT + col0 + c);
    }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * CT, b = e / V_COLS, c = e % V_COLS;
    if (b < B && c < ncols) store_scaled(out + (size_t)b * OUT + col0 + c, v[k], scales[col0 + c]);
  }
}

template <typename XT>
cudaError_t launch_gemv(const void* x, const void* codes, const void* cb, const void* scales,
                        void* out, void* partials, void* tickets, int B, int splits,
                        int groups_per_split, int stages, int xg, int smem, int IG, int OUT, int K,
                        int S, cudaStream_t st) {
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(onehot_gemv_kernel<XT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  CUtensorMap c_map;
  const int use_tma = OUT % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  if (use_tma) {
    const EncodeTiled encode = encoder();
    if (!encode) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)OUT, (cuuint64_t)IG, (cuuint64_t)K};
    const cuuint64_t strides[2] = {(cuuint64_t)OUT, (cuuint64_t)IG * OUT};
    const cuuint32_t box[3] = {V_COLS, V_GS, (cuuint32_t)K}, unit[3] = {1, 1, 1};
    if (encode(&c_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(codes), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  } else {
    memset(&c_map, 0, sizeof(c_map));
  }
  const dim3 grid((OUT + V_COLS - 1) / V_COLS, splits);
  onehot_gemv_kernel<XT><<<grid, V_THREADS, smem, st>>>(
      c_map, (const XT*)x, (const uint8_t*)codes, (const __nv_bfloat16*)cb, (const float*)scales,
      (XT*)out, (float*)partials, (int*)tickets, B, IG, OUT, K, S, groups_per_split, stages, xg,
      use_tma);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ GEMM form

constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // inputs per slab (8 groups of 8)
constexpr int M_THREADS = 384;
constexpr int PRODUCER_WARP = 8;
constexpr int DQ_THREADS = 96;  // warps 9-11
constexpr int CONSUMER_WARPS = 8;
constexpr int W_BYTES = BK * BN * 2;
constexpr int MAX_STAGES = 8;

// K2's layout (gather_prefill.cu) with the code slab as [K][8 groups][128
// columns]; kernels.onehot_plan computes the same total.
struct MLayout {
  int bm, K, S, stages;
  __host__ __device__ MLayout(int bm_, int K_, int S_, int st) : bm(bm_), K(K_), S(S_), stages(st) {}
  __host__ __device__ int x(int s) const { return s * bm * BK * 2; }
  __host__ __device__ int codes(int s) const { return stages * bm * BK * 2 + s * (BK / G) * K * BN; }
  __host__ __device__ int w(int b) const { return codes(stages) + b * W_BYTES; }
  __host__ __device__ int cb() const { return w(2); }
  __host__ __device__ int bar() const { return cb() + K * S * 16; }
  __host__ __device__ int n_bars() const { return 2 * stages + 4; }
  __host__ __device__ int flag() const { return bar() + n_bars() * 8; }
  __host__ __device__ int total() const { return flag() + 16 + 1024; }
};

// MT: 64-row wgmma tiles per consumer warpgroup (BM = 128 * MT). cw: bytes a
// code copy (16 or 4: cp.async; 1: loads and stores).
template <int MT>
__global__ void __launch_bounds__(M_THREADS, 1)
onehot_gemm_kernel(const __grid_constant__ CUtensorMap x_map,  // x [T, IN] bf16
                   const uint8_t* __restrict__ codes,          // [K, IG, OUT] of one layer
                   const __nv_bfloat16* __restrict__ cb,       // [K, S, G] of one layer
                   const float* __restrict__ scales,           // [OUT] of one layer
                   __nv_bfloat16* __restrict__ out,            // [T, OUT]
                   float* __restrict__ partials,               // [splits, Tpad, OUT] when split
                   int* __restrict__ tickets,                  // [row tiles * col tiles] zeroed
                   int T, int IG, int OUT, int K, int S, int splits, int slabs_per_split,
                   int stages, int cw) {
  constexpr int BM = 128 * MT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const MLayout L(BM, K, S, stages);
  uint4* s_cb = reinterpret_cast<uint4*>(smem + L.cb());
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar());
  uint64_t* empty = full + stages;
  uint64_t* wfull = empty + stages;
  uint64_t* wempty = wfull + 2;
  int& s_last = *reinterpret_cast<int*>(smem + L.flag());

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int n_slabs = (IG + BK / G - 1) / (BK / G);
  const int s_begin = blockIdx.z * slabs_per_split;
  const int n_local = min(n_slabs, s_begin + slabs_per_split) - s_begin;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 33);  // the producer's 32 lanes' code copies and its TMA
      mbar_init(empty + i, CONSUMER_WARPS + DQ_THREADS / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(wfull + i, DQ_THREADS / 32);
      mbar_init(wempty + i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < K * S; i += M_THREADS) s_cb[i] = reinterpret_cast<const uint4*>(cb)[i];
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    for (int j = 0; j < n_local; ++j) {
      const int st = j % stages, s = s_begin + j;
      if (j >= stages) mbar_wait(empty + st, (j / stages - 1) & 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(full + st, BM * BK * 2);
        tma_load_2d(smem + L.x(st), &x_map, s * BK, row0, full + st);
      }
      // code row (k, gl) of the slab: 128 bytes at (k * 8 + gl) * 128
      unsigned char* sc = smem + L.codes(st);
      const int per_row = BN / cw;
      for (int q = lane; q < K * (BK / G) * per_row; q += 32) {
        const int r = q / per_row, c = (q % per_row) * cw;
        const int k = r / (BK / G), ig = s * (BK / G) + r % (BK / G);
        const bool valid = ig < IG && col0 + c < OUT;  // cw divides OUT: a copy is all in or out
        const uint8_t* src = codes + (valid ? ((size_t)k * IG + ig) * OUT + col0 + c : 0);
        if (cw == 16) {
          cp_async16(sc + r * BN + c, src, valid);
        } else if (cw == 4) {
          cp_async4(sc + r * BN + c, src, valid);
        } else {
          sc[r * BN + c] = valid ? __ldg(src) : 0;
        }
      }
      if (cw == 1)
        mbar_arrive(full + st);
      else
        mbar_arrive_cp_async(full + st);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives its issuer
  } else if (warp > PRODUCER_WARP) {
    // dequantisers: slab j's W^T into buffer j % 2, entry (group gl, column
    // n) -> one 16-byte row of core matrix (n / 8, gl)
    const int dt = tid - (PRODUCER_WARP + 1) * 32;
    for (int j = 0; j < n_local; ++j) {
      const int st = j % stages, wb = j & 1;
      mbar_wait(full + st, (j / stages) & 1);
      if (j >= 2) mbar_wait(wempty + wb, (j / 2 - 1) & 1);
      const uint8_t* sc = smem + L.codes(st);
      unsigned char* sw = smem + L.w(wb);
      if (K <= 2) {
        constexpr int UNR2 = 6;  // entries in flight per thread
        for (int e0 = dt; e0 < (BK / G) * BN; e0 += UNR2 * DQ_THREADS) {
          uint4 v[UNR2];
#pragma unroll
          for (int u = 0; u < UNR2; ++u) {
            const int en = min(e0 + u * DQ_THREADS, (BK / G) * BN - 1);
            const uint8_t* c = sc + en;  // (gl, n) = (en >> 7, en & 127); codebook k at + k * 8 * 128
            v[u] = s_cb[c[0]];
            if (K == 2) {
              const uint4 b = s_cb[S + c[(BK / G) * BN]];
              v[u].x = add_bf16x2(v[u].x, b.x);
              v[u].y = add_bf16x2(v[u].y, b.y);
              v[u].z = add_bf16x2(v[u].z, b.z);
              v[u].w = add_bf16x2(v[u].w, b.w);
            }
          }
#pragma unroll
          for (int u = 0; u < UNR2; ++u) {
            const int en = e0 + u * DQ_THREADS;
            if (en < (BK / G) * BN)
              *reinterpret_cast<uint4*>(sw + (((en & 127) >> 3) * (BK / 8) + (en >> 7)) * 128 +
                                        (en & 7) * 16) = v[u];
          }
        }
      } else {
        constexpr int UNR = 4;
        for (int e0 = dt; e0 < (BK / G) * BN; e0 += UNR * DQ_THREADS) {
          float w[UNR][G];
#pragma unroll
          for (int u = 0; u < UNR; ++u)
#pragma unroll
            for (int i = 0; i < G; ++i) w[u][i] = 0.f;
          for (int k = 0; k < K; ++k) {
            uint4 v[UNR];
#pragma unroll
            for (int u = 0; u < UNR; ++u) {
              const int en = min(e0 + u * DQ_THREADS, (BK / G) * BN - 1);
              v[u] = s_cb[k * S + sc[k * (BK / G) * BN + en]];
            }
#pragma unroll
            for (int u = 0; u < UNR; ++u) {
              float f[G];
              bf16x8_to_float(v[u], f);
#pragma unroll
              for (int i = 0; i < G; ++i) w[u][i] += f[i];
            }
          }
#pragma unroll
          for (int u = 0; u < UNR; ++u) {
            const int en = e0 + u * DQ_THREADS;
            if (en < (BK / G) * BN) {
              const int gl = en >> 7, n = en & 127;
              const uint4 packed = make_uint4(pack_bf16x2(w[u][0], w[u][1]), pack_bf16x2(w[u][2], w[u][3]),
                                              pack_bf16x2(w[u][4], w[u][5]), pack_bf16x2(w[u][6], w[u][7]));
              *reinterpret_cast<uint4*>(sw + ((n >> 3) * (BK / 8) + gl) * 128 + (n & 7) * 16) = packed;
            }
          }
        }
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(wfull + wb);
        mbar_arrive(empty + st);
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [wg * 64 * MT, (wg + 1) * 64 * MT)
    const int wg = warp >> 2;
    const bool active = row0 + wg * 64 * MT < T;  // a warpgroup of padding rows only waits
    float acc[MT][64];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
    for (int j = 0; j < n_local; ++j) {
      const int st = j % stages, wb = j & 1;
      mbar_wait(full + st, (j / stages) & 1);
      mbar_wait(wfull + wb, (j / 2) & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      if (active) {
        fence_proxy_async();
        wgmma_fence();
        const unsigned char* sx = smem + L.x(st);
        const unsigned char* sw = smem + L.w(wb);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = make_desc(sw + kk * 256);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wgmma_m64n128k16(acc[m], make_desc_sw128(sx + (wg * MT + m) * 64 * BK * 2 + kk * 32), db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // slab j - 1's products are done
      }
      if (j > 0) {
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(empty + (j - 1) % stages);
          mbar_arrive(wempty + ((j - 1) & 1));
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(acc[m]);

    // accumulator (m, 4c + 2h + p) of thread (warp, lane): row 16 (warp % 4)
    // + lane / 4 + 8 h of tile m, column 8 c + 2 (lane % 4) + p
    const int rbase = row0 + wg * 64 * MT + (warp & 3) * 16 + (lane >> 2);
    const int cbase = col0 + (lane & 3) * 2;
    const int t_pad = gridDim.y * BM;
    float* part = splits == 1 ? nullptr : partials + (size_t)blockIdx.z * t_pad * OUT;
    const bool pairs = (OUT & 1) == 0;  // two columns a store stay aligned
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rbase + m * 64 + 8 * h, col = cbase + 8 * c;
          if (row >= T || col >= OUT) continue;
          const float a = acc[m][4 * c + 2 * h], b = acc[m][4 * c + 2 * h + 1];
          const size_t o = (size_t)row * OUT + col;
          if (part) {
            if (pairs) {
              *reinterpret_cast<float2*>(part + o) = make_float2(a, b);
            } else {
              part[o] = a;
              if (col + 1 < OUT) part[o + 1] = b;
            }
          } else if (pairs) {
            const float ya = __bfloat162float(__float2bfloat16(a)), yb = __bfloat162float(__float2bfloat16(b));
            const float sa = __bfloat162float(__float2bfloat16(scales[col]));
            const float sb = __bfloat162float(__float2bfloat16(scales[col + 1]));
            *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(ya * sa, yb * sb);
          } else {
            store_scaled(out + o, a, scales[col]);
            if (col + 1 < OUT) store_scaled(out + o + 1, b, scales[col + 1]);
          }
        }
    if (!part) return;
    // split input dimension: the last block of the tile sums the partials
    // in split order, then rounds as above
    __threadfence();
    bar_sync(1, CONSUMER_WARPS * 32);
    if (tid == 0) s_last = atomicAdd(tickets + blockIdx.y * gridDim.x + blockIdx.x, 1) == splits - 1;
    bar_sync(1, CONSUMER_WARPS * 32);
    if (!s_last) return;
    __threadfence();
    constexpr int PER = 4;  // outputs in flight a thread
    for (int i0 = tid; i0 < BM * BN; i0 += CONSUMER_WARPS * 32 * PER) {
      float v[PER];
      size_t off[PER];
      bool ok[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = i0 + k * CONSUMER_WARPS * 32, row = row0 + i / BN, col = col0 + i % BN;
        ok[k] = i < BM * BN && row < T && col < OUT;
        off[k] = ok[k] ? (size_t)row * OUT + col : 0;
        v[k] = 0.f;
      }
      for (int z = 0; z < splits; ++z)
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (ok[k]) v[k] += __ldcg(partials + (size_t)z * t_pad * OUT + off[k]);
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (ok[k]) store_scaled(out + off[k], v[k], scales[off[k] % OUT]);
    }
  }
}

template <int MT>
cudaError_t launch_gemm(const void* x, const void* codes, const void* cb, const void* scales,
                        void* out, void* partials, void* tickets, int T, int splits, int per_split,
                        int stages, int smem, int IG, int OUT, int K, int S, int cw,
                        cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(onehot_gemm_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  constexpr int BM = 128 * MT;
  const EncodeTiled encode = encoder();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap x_map;
  const cuuint64_t dims[2] = {(cuuint64_t)IG * G, (cuuint64_t)T};
  const cuuint64_t strides[1] = {(cuuint64_t)IG * G * 2};
  const cuuint32_t box[2] = {BK, BM}, unit[2] = {1, 1};
  if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const dim3 grid((OUT + BN - 1) / BN, (T + BM - 1) / BM, splits);
  onehot_gemm_kernel<MT><<<grid, M_THREADS, smem, st>>>(
      x_map, (const uint8_t*)codes, (const __nv_bfloat16*)cb, (const float*)scales,
      (__nv_bfloat16*)out, (float*)partials, (int*)tickets, T, IG, OUT, K, S, splits, per_split,
      stages, cw);
  return cudaGetLastError();
}

}  // namespace

// One launch of B15 as kernels.onehot_plan lays it out. x_bf16 selects bf16
// (1) or f32 (0) activations and output; B <= 8 runs the GEMV form (either
// dtype: `stages` ring stages, `groups_per_split` input groups a block, a
// multiple of 32, `xg` the staged x row in 16-byte groups), larger B the GEMM
// form (bf16 only: bm 128 or 256 rows a block, `stages` ring stages,
// `groups_per_split` / 8 slabs a block). `smem` is checked against the
// form's own layout. splits > 1 splits the input groups over that many
// blocks per output block; partials (GEMV: [splits, B, OUT]; GEMM: [splits,
// ceil(B / bm) * bm, OUT] f32) and zeroed tickets (one per output block:
// ceil(OUT / 128) for the GEMV form, ceil(B / bm) * ceil(OUT / 128) for the
// GEMM form) are then required.
extern "C" int onehot_matmul_launch(const void* x, const void* codes, const void* cb,
                                    const void* scales, void* out, void* partials, void* tickets,
                                    int x_bf16, int B, int bm, int stages, int smem, int splits,
                                    int groups_per_split, int xg, int IG, int OUT, int K, int S,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || K < 1 || K > 8 || S < 1 || S > 256 || IG < 1 || OUT < 1 || splits < 1 ||
      groups_per_split < 1 || smem > SMEM_LIMIT || (splits > 1 && (!partials || !tickets)) ||
      (long long)(splits - 1) * groups_per_split >= IG || (long long)splits * groups_per_split < IG)
    return cudaErrorInvalidValue;
  if (B <= 8) {
    if (bm != 0 || stages < 1 || stages > V_MAX_STAGES || groups_per_split % V_GS ||
        xg < (groups_per_split < IG ? groups_per_split : (IG + V_GS - 1) / V_GS * V_GS) || xg % 8 != 4 ||
        VLayout(K, S, stages, B, xg, x_bf16 ? 1 : 2).total() != smem)
      return cudaErrorInvalidValue;
    if (x_bf16)
      return launch_gemv<__nv_bfloat16>(x, codes, cb, scales, out, partials, tickets, B, splits,
                                        groups_per_split, stages, xg, smem, IG, OUT, K, S, st);
    return launch_gemv<float>(x, codes, cb, scales, out, partials, tickets, B, splits,
                              groups_per_split, stages, xg, smem, IG, OUT, K, S, st);
  }
  if (!x_bf16 || (bm != 128 && bm != 256) || stages < 2 || stages > MAX_STAGES ||
      groups_per_split % (BK / G) || MLayout(bm, K, S, stages).total() != smem)
    return cudaErrorInvalidValue;
  const int cw = (OUT % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0) ? 16
                 : (OUT % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0) ? 4 : 1;
  const int per_split = groups_per_split / (BK / G);
  if (bm == 256)
    return launch_gemm<2>(x, codes, cb, scales, out, partials, tickets, B, splits, per_split, stages,
                          smem, IG, OUT, K, S, cw, st);
  return launch_gemm<1>(x, codes, cb, scales, out, partials, tickets, B, splits, per_split, stages,
                        smem, IG, OUT, K, S, cw, st);
}
