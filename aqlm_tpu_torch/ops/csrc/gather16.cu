// B1: the 1x16 codes matmul, y = (x @ cb[codes]^T) * scales, in two forms.
//
// Replaces aqlm_tpu/ops/gather16.py:gather_matmul_16 (:72), which is XLA on
// the TPU (a wide-row gather of the packed codebook and a one-hot extraction
// feeding the MXU), not a pallas_call. One codebook of 65536 entries of g = 8
// or 16 bf16 (1 or 2 MB) serves a projection; codes are [OUT, IG] uint16
// (stored as int16 with the same bits and read unsigned), two bytes for g
// weights.
//
//   y[b, o] = round_x(scales[o] * sum_ig dot(x[b, ig*g : ig*g+g], cb[codes[o, ig]]))
//
// The codebook entry is the weight itself (one codebook: no sum, exact in
// bf16); the product accumulates in f32; the scale applies to the f32 sum,
// which is rounded once to the activations' type. The bias (added after, in
// that type) stays with the caller. Every launch is laid out by the pure
// gather16.plan, and each launcher refuses a layout its kernel cannot run.
//
// GEMV (at most 8 rows). Bound: HBM bytes, 2 bytes of codes per g weights
// (Llama-2-7B q at g=8: 4.2 MB of codes and 1 MB of codebook, ~1.6 us at
// 3.35 TB/s); but each code also pulls a 16- or 32-byte codebook row from
// L2, and the rate of those row gathers, not the bytes, sets the pace: the
// card serves about 125-130 G random rows a second from a 1 or 2 MB table
// while codes stream (experiments/torch_gather_ceiling.py), whatever the
// loads a lane keeps in flight.
//   - g=8 keeps the first design, which reaches ~76% of that ceiling: one
//     warp per output row, each lane reading 8 codes as one 16-byte load; x
//     staged in shared memory 256 codes at a time (padded per lane so the
//     16-byte reads do not collide); each code's codebook row fetched
//     through L2 (ld.global.cg: a layer's seven codebooks, 7 MB at g=8,
//     stay in the 50 MB L2 while the codes stream past) and used for every
//     row of x (the plan of the reference's Code1x16MatVec,
//     inference_lib/.../cuda_kernel.cu:7-95).
//   - g=16 at 1-4 rows (the first design reached ~42% of the ceiling: one lane issued
//     both halves of each 32-byte row, and each 256-code chunk ended in two
//     block barriers): two neighbouring lanes load the two 16-byte halves
//     of one row in the same instruction, so each gather is one sector
//     request; a lane keeps a rolling buffer of 4 gathers (as its code s is
//     used, code s + 4 is issued in its place; codes two chunks ahead); each
//     warp works on two output rows at once, so each x read serves both; x
//     is staged once per block in shared memory where it fits (padded by one
//     16-byte unit in every 8 x UPL), else read from device memory through
//     L1, so no block barrier runs inside the loop; blocks of 8 warps (up to
//     255 registers a thread: no spill), warp w walking the row pairs
//     blockIdx.x * 8 + w + k * 8 * gridDim.x. It serves 1-4 rows: at 5-8
//     the x reads and FMAs, which lane pairs do not cut, outweigh the
//     gathers, and it ran 6% slower than the first design at 8 rows, which
//     keeps those.
// Sums are f32 (the reference's half-precision partial sums would break the
// f32 contract).
//
// GEMM (more than 8 rows, bf16 activations): a gather pre-pass and a
// TMA + wgmma GEMM. Bound: operations, 2*T*OUT*IN on the bf16 tensor cores.
// The first design gathered each 128-token tile's W^T from L2 again (8
// times per weight at T=1024: 16.8M random 16-byte requests for q) and
// stalled its tensor cores on every gather. Here
//   - gather16_wt_kernel writes the bf16 W [OUT, IN] once, into a transient
//     buffer the wrapper takes from torch's allocator (never kept): one
//     16-byte unit of W a lane, lanes on consecutive units (coalesced code
//     reads and stores; at g=16 a lane pair covers one 32-byte row);
//   - gather16_gemm_kernel multiplies x [T, IN] by it: warp 8, the producer,
//     keeps a ring of 4-6 stages in flight, each the x tile [BM x 64] and
//     the W tile [128 x 64] by TMA (128-byte swizzle, rows past T or OUT
//     zero-filled), on one mbarrier; warps 0-7, two consumer warpgroups, run
//     wgmma m64n128k16 with both operands read through 128B-swizzle
//     descriptors (BM 256 past 128 rows, else 128), one slab's products in
//     flight while the next slab's barrier is awaited; the f32 scale and
//     the single rounding run in the epilogue.
// Each weight is gathered once whatever T (down: 90 MB of scratch). Short
// prompts split the input over blocks (f32 partials, the last block of a
// tile adds them in a fixed order, hopper.cuh's reduce_splits).
#include <cuda.h>  // CUtensorMap

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace aqlm;

constexpr int SMEM_LIMIT = 232448;

// ---------------------------------------------------------------------------
// GEMV
// ---------------------------------------------------------------------------

constexpr int V_WARPS = 16;  // output rows per block, one per warp
constexpr int V_THREADS = V_WARPS * 32;
constexpr int CHUNK = 256;   // codes of a row staged per pass: 8 per lane

// one group of x (g values) from shared memory as floats
template <typename XT, int G>
__device__ __forceinline__ void x_group(const uint4* p, float* f) {
  if constexpr (sizeof(XT) == 2) {
#pragma unroll
    for (int u = 0; u < G / 8; ++u) aqlm::bf16x8_to_float(p[u], f + 8 * u);
  } else {
#pragma unroll
    for (int u = 0; u < G / 4; ++u) {
      const uint4 v = p[u];
      f[4 * u] = __uint_as_float(v.x);
      f[4 * u + 1] = __uint_as_float(v.y);
      f[4 * u + 2] = __uint_as_float(v.z);
      f[4 * u + 3] = __uint_as_float(v.w);
    }
  }
}

template <typename XT, int B, int G>
__global__ void __launch_bounds__(V_THREADS)
gather16_gemv_kernel(const XT* __restrict__ x,           // [B, IN]
                     const uint16_t* __restrict__ codes, // [OUT, IG]
                     const uint4* __restrict__ cb,       // [65536, G] bf16, G/8 uint4 a row
                     const float* __restrict__ scales,   // [OUT]
                     XT* __restrict__ out,               // [B, OUT]
                     int out_features, int ig) {
  constexpr int GU = G * (int)sizeof(XT) / 16;  // uint4 per group of x
  constexpr int LANE_U = 8 * GU + 1;            // a lane's 8 groups, padded by one uint4
  constexpr int CU = G / 8;                     // uint4 per codebook row
  extern __shared__ uint4 s_x[];                // [B][32 lanes][LANE_U]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row = blockIdx.x * V_WARPS + warp;
  const bool active = row < out_features;
  const int in_features = ig * G;
  const uint16_t* crow = codes + (size_t)(active ? row : 0) * ig;

  float acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = 0.f;

  for (int c0 = 0; c0 < ig; c0 += CHUNK) {
    const int n = min(CHUNK, ig - c0);  // a multiple of 8
    __syncthreads();                    // the previous chunk's readers are done
    for (int i = tid; i < B * n * GU; i += V_THREADS) {
      const int b = i / (n * GU), r = i % (n * GU);
      const int j = r / GU, u = r % GU;
      s_x[(b * 32 + j / 8) * LANE_U + (j % 8) * GU + u] =
          reinterpret_cast<const uint4*>(x + (size_t)b * in_features + (size_t)(c0 + j) * G)[u];
    }
    __syncthreads();
    if (active && lane * 8 < n) {
      const uint4 cw = __ldg(reinterpret_cast<const uint4*>(crow + c0 + lane * 8));
      const uint32_t w2[4] = {cw.x, cw.y, cw.z, cw.w};
      uint4 rows[8][CU];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t code = (w2[j / 2] >> (16 * (j % 2))) & 0xffffu;  // unsigned
#pragma unroll
        for (int u = 0; u < CU; ++u) rows[j][u] = __ldcg(cb + (size_t)code * CU + u);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float w[G];
#pragma unroll
        for (int u = 0; u < CU; ++u) aqlm::bf16x8_to_float(rows[j][u], w + 8 * u);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          float xv[G];
          x_group<XT, G>(s_x + (b * 32 + lane) * LANE_U + j * GU, xv);
#pragma unroll
          for (int e = 0; e < G; ++e) acc[b] = fmaf(xv[e], w[e], acc[b]);
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
  if (!active) return;
  const float s = scales[row];
#pragma unroll
  for (int b = 0; b < B; ++b)
    if (lane == b) aqlm::store1(out + (size_t)b * out_features + row, acc[b] * s);
}

template <typename XT, int B, int G>
cudaError_t gemv_b(const void* x, const void* codes, const void* cb, const void* scales, void* out,
                   int out_features, int ig, cudaStream_t st) {
  const size_t smem = (size_t)B * 32 * (8 * (G * sizeof(XT) / 16) + 1) * 16;
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem != smem_set) {
    cudaError_t e = cudaFuncSetAttribute(gather16_gemv_kernel<XT, B, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int blocks = (out_features + V_WARPS - 1) / V_WARPS;
  gather16_gemv_kernel<XT, B, G><<<blocks, V_THREADS, smem, st>>>(
      (const XT*)x, (const uint16_t*)codes, (const uint4*)cb, (const float*)scales, (XT*)out,
      out_features, ig);
  return cudaGetLastError();
}

template <typename XT, int G>
cudaError_t gemv_typed(int B, const void* x, const void* codes, const void* cb, const void* scales,
                       void* out, int out_features, int ig, cudaStream_t st) {
#define AQLM_G16_CASE(NB) \
  case NB:                \
    return gemv_b<XT, NB, G>(x, codes, cb, scales, out, out_features, ig, st);
  switch (B) {
    AQLM_G16_CASE(1) AQLM_G16_CASE(2) AQLM_G16_CASE(3) AQLM_G16_CASE(4)
    AQLM_G16_CASE(5) AQLM_G16_CASE(6) AQLM_G16_CASE(7) AQLM_G16_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef AQLM_G16_CASE
}

// ---------------------------------------------------------------------------
// GEMV at g=16: lane pairs on one 32-byte row
// ---------------------------------------------------------------------------

constexpr int P2_WARPS = 8;  // the g=16 kernel: warps a block, two output rows each at once
constexpr int P2_THREADS = P2_WARPS * 32;

// Where 16-byte unit u of a staged x row lies: one pad unit after every
// `period` units (period 0: not staged, no padding). At bf16 a warp's reads
// then meet each bank group once; f32 x (on no path) meets twice.
__device__ __forceinline__ int x_unit(int u, int period) { return period ? u + u / period : u; }

template <typename XT, int B>
__global__ void __launch_bounds__(P2_THREADS)
gather16_gemv_pair_kernel(const XT* __restrict__ x,           // [B, IN]
                          const uint16_t* __restrict__ codes, // [OUT, IG]
                          const uint4* __restrict__ cb,       // [65536, 16] bf16, 2 uint4 a row
                          const float* __restrict__ scales,   // [OUT]
                          XT* __restrict__ out,               // [B, OUT]
                          int out_features, int ig, int x_staged) {
  constexpr int G = 16, LPC = 2;                 // two lanes a code, 16 bytes of its row each
  constexpr int CH = 8 * 32 / LPC;               // codes of a row per chunk: 8 per lane pair
  constexpr int UPL = 8 * (int)sizeof(XT) / 16;  // 16-byte units of x per 8 activations
  extern __shared__ uint4 s_xs[];                // [B][row_units] when staged

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane / LPC, half = lane % LPC;
  const int in_units = ig * G * (int)sizeof(XT) / 16;
  const int period = x_staged ? 8 * UPL : 0;
  const int row_units = in_units + (period ? in_units / period : 0);
  const uint4* xs = reinterpret_cast<const uint4*>(x);
  if (x_staged) {
    for (int i = tid; i < B * in_units; i += P2_THREADS) {
      const int b = i / in_units, u = i - b * in_units;
      s_xs[b * row_units + x_unit(u, period)] = xs[i];
    }
    __syncthreads();
    xs = s_xs;
  }

  // warp w of block b walks the row pairs q = b * 8 + w + k * 8 * gridDim.x
  // (rows 2q and 2q + 1: each x read serves both); item i of its walk is
  // pair first_pair + (i / n_chunks) * warps_total, chunk i % n_chunks
  constexpr int R = 2;
  const int n_chunks = (ig + CH - 1) / CH;
  const int warps_total = gridDim.x * P2_WARPS;
  const int first_pair = blockIdx.x * P2_WARPS + warp;
  const int n_pairs = (out_features + R - 1) / R;
  const int my_pairs = first_pair < n_pairs ? (n_pairs - 1 - first_pair) / warps_total + 1 : 0;
  const int items = my_pairs * n_chunks;
  auto row_of = [&](int i, int r) { return R * (first_pair + (i / n_chunks) * warps_total) + r; };
  auto valid = [&](int i, int r) {
    return i < items && (i % n_chunks) * CH + lg * 8 < ig && row_of(i, r) < out_features;
  };
  auto code_word = [&](int i, int r) {
    if (!valid(i, r)) return make_uint4(0u, 0u, 0u, 0u);
    return __ldg(reinterpret_cast<const uint4*>(codes + (size_t)row_of(i, r) * ig +
                                                (i % n_chunks) * CH + lg * 8));
  };
  auto row_half = [&](const uint4& cw, int j) {
    const uint32_t w = j < 2 ? cw.x : j < 4 ? cw.y : j < 6 ? cw.z : cw.w;
    const uint32_t code = (w >> (16 * (j % 2))) & 0xffffu;  // unsigned
    return __ldcg(cb + (size_t)code * LPC + half);
  };

  float acc[R][B];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[r][b] = 0.f;
  // a rolling buffer of 4 gathers a row over the lane's codes (8 a chunk):
  // as code s is used, code s + 4 is issued in its place; codes come two
  // chunks ahead. A row past OUT (odd OUT) sums garbage it never stores.
  uint4 buf[R][4], cw_cur[R], cw_next[R];
  bool v_cur[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v_cur[r] = valid(0, r);
    cw_cur[r] = code_word(0, r);
    cw_next[r] = code_word(1, r);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      buf[r][j] = v_cur[r] ? row_half(cw_cur[r], j) : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = 0; i < items; ++i) {
    bool v_nxt[R];
    uint4 cw_after[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v_nxt[r] = valid(i + 1, r);
      cw_after[r] = code_word(i + 2, r);
    }
    const int c = i % n_chunks;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float w[R][8];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        bf16x8_to_float(buf[r][j & 3], w[r]);
        if (j < 4) {
          if (v_cur[r]) buf[r][j] = row_half(cw_cur[r], j + 4);
        } else if (v_nxt[r]) {
          buf[r][j & 3] = row_half(cw_next[r], j - 4);
        }
      }
      if (v_cur[0]) {
        const int u = ((c * CH + lg * 8 + j) * LPC + half) * UPL;
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const uint4* p = xs + b * row_units + x_unit(u, period);
          float xv[8];
          if constexpr (sizeof(XT) == 2) {
            bf16x8_to_float(p[0], xv);
          } else {
            const uint4 a = p[0], d = p[1];
            xv[0] = __uint_as_float(a.x); xv[1] = __uint_as_float(a.y);
            xv[2] = __uint_as_float(a.z); xv[3] = __uint_as_float(a.w);
            xv[4] = __uint_as_float(d.x); xv[5] = __uint_as_float(d.y);
            xv[6] = __uint_as_float(d.z); xv[7] = __uint_as_float(d.w);
          }
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r][b] = fmaf(xv[e], w[r][e], acc[r][b]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cw_cur[r] = cw_next[r];
      cw_next[r] = cw_after[r];
      v_cur[r] = v_nxt[r];
    }
    if (c == n_chunks - 1) {  // the rows' last chunk: the lanes meet, lane b writes row b
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row_of(i, r);
        const float s = row < out_features ? scales[row] : 0.f;
#pragma unroll
        for (int b = 0; b < B; ++b) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) acc[r][b] += __shfl_xor_sync(0xffffffffu, acc[r][b], off);
          if (lane == b && row < out_features) store1(out + (size_t)b * out_features + row, acc[r][b] * s);
          acc[r][b] = 0.f;
        }
      }
    }
  }
}

template <typename XT, int B>
cudaError_t gemv_pair_b(const void* x, const void* codes, const void* cb, const void* scales,
                        void* out, int out_features, int ig, int x_staged, int blocks, int smem,
                        cudaStream_t st) {
  static int smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(gather16_gemv_pair_kernel<XT, B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  gather16_gemv_pair_kernel<XT, B><<<blocks, P2_THREADS, smem, st>>>(
      (const XT*)x, (const uint16_t*)codes, (const uint4*)cb, (const float*)scales, (XT*)out,
      out_features, ig, x_staged);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t gemv_pair_typed(int B, const void* x, const void* codes, const void* cb,
                            const void* scales, void* out, int out_features, int ig, int x_staged,
                            int blocks, int smem, cudaStream_t st) {
#define AQLM_G16_CASE(NB) \
  case NB:                \
    return gemv_pair_b<XT, NB>(x, codes, cb, scales, out, out_features, ig, x_staged, blocks, smem, st);
  switch (B) {
    AQLM_G16_CASE(1) AQLM_G16_CASE(2) AQLM_G16_CASE(3) AQLM_G16_CASE(4)
    default: return cudaErrorInvalidValue;
  }
#undef AQLM_G16_CASE
}

// The shared memory of a GEMV launch (gather16.plan computes the same): the
// first design's x chunk (B x 32 lanes x 8 groups, padded) at g=8 and at
// g=16 past 4 rows, else the lane-pair kernel's staged x (0 when read from
// device memory).
int gemv_smem(int B, int x_bytes, int ig, int g, int x_staged) {
  if (g == 8 || B > 4) return B * 32 * (8 * (g * x_bytes / 16) + 1) * 16;
  if (!x_staged) return 0;
  const int in_units = ig * g * x_bytes / 16, period = 8 * (8 * x_bytes / 16);
  return B * (in_units + in_units / period) * 16;
}

// ---------------------------------------------------------------------------
// GEMM: the gather pre-pass
// ---------------------------------------------------------------------------

constexpr int P_THREADS = 256;
constexpr int P_UNROLL = 8;  // units in flight a thread

template <int G>
__global__ void __launch_bounds__(P_THREADS)
gather16_wt_kernel(const uint16_t* __restrict__ codes,  // [OUT * IG]
                   const uint4* __restrict__ cb,        // [65536, G] bf16
                   uint4* __restrict__ w,               // [OUT * IG * G / 8] (W [OUT, IN] bf16)
                   long long n_units) {
  constexpr int LPC = G / 8;
  const long long step = (long long)gridDim.x * P_THREADS * P_UNROLL;
  for (long long u0 = (long long)blockIdx.x * P_THREADS * P_UNROLL + threadIdx.x; u0 < n_units;
       u0 += step) {
    uint4 v[P_UNROLL];
#pragma unroll
    for (int k = 0; k < P_UNROLL; ++k) {
      const long long u = u0 + (long long)k * P_THREADS;
      if (u < n_units) {
        const uint32_t code = __ldg(codes + u / LPC);
        v[k] = __ldcg(cb + (size_t)code * LPC + (u % LPC));
      }
    }
#pragma unroll
    for (int k = 0; k < P_UNROLL; ++k) {
      const long long u = u0 + (long long)k * P_THREADS;
      if (u < n_units) w[u] = v[k];
    }
  }
}

// ---------------------------------------------------------------------------
// GEMM: x [T, IN] times the gathered W [OUT, IN], TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // inputs per slab
constexpr int M_THREADS = 288;
constexpr int PRODUCER_WARP = 8;
constexpr int CONSUMER_WARPS = 8;
constexpr int MAX_STAGES = 8;

// Byte offsets from the first 1024-aligned byte of the dynamic shared
// memory: per stage the x tile [bm x 64] and the W tile [128 x 64], both
// 128B-swizzled; the stage barriers; the split path's flag; 1024 bytes of
// alignment slack. gather16.plan computes the same total.
struct MLayout {
  int bm, stages;
  __host__ __device__ MLayout(int bm_, int st) : bm(bm_), stages(st) {}
  __host__ __device__ int x(int s) const { return s * (bm + BN) * BK * 2; }
  __host__ __device__ int w(int s) const { return x(s) + bm * BK * 2; }
  __host__ __device__ int bar() const { return x(stages); }
  __host__ __device__ int flag() const { return bar() + 2 * stages * 8; }
  __host__ __device__ int total() const { return flag() + 16 + 1024; }
};

template <int MT>
__global__ void __launch_bounds__(M_THREADS, 1)
gather16_gemm_kernel(const __grid_constant__ CUtensorMap x_map,  // x [T, IN] bf16
                     const __grid_constant__ CUtensorMap w_map,  // W [OUT, IN] bf16
                     const float* __restrict__ scales,           // [OUT]
                     __nv_bfloat16* __restrict__ out,            // [T, OUT]
                     float* __restrict__ partials,               // [splits, Tpad, OUT] when split
                     int* __restrict__ tickets,                  // [row tiles * col tiles] zeroed
                     int T, int out_features, int in_features, int splits, int slabs_per_split,
                     int stages) {
  constexpr int BM = 128 * MT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const MLayout L(BM, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar());
  uint64_t* empty = full + stages;
  int& s_last = *reinterpret_cast<int*>(smem + L.flag());

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int n_slabs = in_features / BK;
  const int s_begin = blockIdx.z * slabs_per_split;
  const int n_local = min(n_slabs, s_begin + slabs_per_split) - s_begin;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      for (int j = 0; j < n_local; ++j) {
        const int st = j % stages, s = s_begin + j;
        if (j >= stages) mbar_wait(empty + st, (j / stages - 1) & 1);
        mbar_arrive_expect_tx(full + st, (BM + BN) * BK * 2);
        tma_load_2d(smem + L.x(st), &x_map, s * BK, row0, full + st);
        tma_load_2d(smem + L.w(st), &w_map, s * BK, col0, full + st);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [wg * 64 * MT, (wg + 1) * 64 * MT)
  const int wg = warp >> 2;
  const bool active = row0 + wg * 64 * MT < T;  // a warpgroup of padding rows only waits
  float acc[MT][64];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
  for (int j = 0; j < n_local; ++j) {
    const int st = j % stages;
    mbar_wait(full + st, (j / stages) & 1);
    __syncwarp();  // converged for the .aligned wgmma instructions
    if (active) {
      wgmma_fence();
      const unsigned char* sx = smem + L.x(st);
      const unsigned char* sw = smem + L.w(st);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = make_desc_sw128(sw + kk * 32);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          wgmma_m64n128k16(acc[m], make_desc_sw128(sx + (wg * MT + m) * 64 * BK * 2 + kk * 32), db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // slab j - 1's products are done
    }
    if (j > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (j - 1) % stages);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_regs(acc[m]);

  // accumulator (m, 4c + 2h + p) of thread (warp, lane): row 16 (warp % 4)
  // + lane / 4 + 8 h of tile m, column 8 c + 2 (lane % 4) + p
  const int rbase = row0 + wg * 64 * MT + (warp & 3) * 16 + (lane >> 2);
  const int cbase = col0 + (lane & 3) * 2;
  const bool pairs = (out_features & 1) == 0;  // two columns a store stay aligned
  const int t_pad = gridDim.y * BM;
  float* part = splits == 1 ? nullptr : partials + (size_t)blockIdx.z * t_pad * out_features;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + m * 64 + 8 * h, col = cbase + 8 * c;
        if (row >= T || col >= out_features) continue;
        const float a = acc[m][4 * c + 2 * h], b = acc[m][4 * c + 2 * h + 1];
        const size_t o = (size_t)row * out_features + col;
        if (part) {
          if (pairs) {
            *reinterpret_cast<float2*>(part + o) = make_float2(a, b);
          } else {
            part[o] = a;
            if (col + 1 < out_features) part[o + 1] = b;
          }
        } else if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(out + o) =
              __floats2bfloat162_rn(a * scales[col], b * scales[col + 1]);
        } else {
          out[o] = __float2bfloat16(a * scales[col]);
          if (col + 1 < out_features) out[o + 1] = __float2bfloat16(b * scales[col + 1]);
        }
      }
  if (!part) return;
  // split input dimension: the last block of the tile to finish sums the
  // partials in split order
  __threadfence();
  bar_sync(1, CONSUMER_WARPS * 32);
  if (tid == 0) s_last = atomicAdd(tickets + blockIdx.y * gridDim.x + blockIdx.x, 1) == splits - 1;
  bar_sync(1, CONSUMER_WARPS * 32);
  if (!s_last) return;
  __threadfence();
  reduce_splits<BM, BN, CONSUMER_WARPS * 32>(partials, (size_t)t_pad * out_features, splits, scales,
                                             out, row0, col0, T, out_features, tid);
}

template <int MT>
cudaError_t gemm_mt(const void* x, const void* w, const void* scales, void* out, void* partials,
                    void* tickets, int T, int out_features, int in_features, int stages, int smem,
                    int splits, int per_split, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(gather16_gemm_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  constexpr int BM = 128 * MT;
  const EncodeTiled encode = encoder();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap x_map, w_map;
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t x_dims[2] = {(cuuint64_t)in_features, (cuuint64_t)T};
  const cuuint64_t w_dims[2] = {(cuuint64_t)in_features, (cuuint64_t)out_features};
  const cuuint64_t strides[1] = {(cuuint64_t)in_features * 2};
  const cuuint32_t x_box[2] = {BK, BM}, w_box[2] = {BK, BN};
  if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), x_dims, strides,
             x_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), w_dims, strides,
             w_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const dim3 grid((out_features + BN - 1) / BN, (T + BM - 1) / BM, splits);
  gather16_gemm_kernel<MT><<<grid, M_THREADS, smem, st>>>(
      x_map, w_map, (const float*)scales, (__nv_bfloat16*)out, (float*)partials, (int*)tickets, T,
      out_features, in_features, splits, per_split, stages);
  return cudaGetLastError();
}

}  // namespace

// GEMV, 1..8 rows, as gather16.plan lays it out: x [B, IN] bf16 (x_bf16 = 1)
// or f32, out [B, OUT] in x's type; codes [OUT, IG] 16-bit, IG a multiple of
// 8; cb [65536, g] bf16; g 8, or 16 past 4 rows: the first design (blocks =
// ceil(OUT / 16)); g 16 at 1-4 rows: the lane-pair kernel (`blocks` blocks,
// x_staged: x in shared memory, else read from device memory); smem is
// checked against the kernel's count.
extern "C" int gather16_gemv_launch(const void* x, const void* codes, const void* cb,
                                    const void* scales, void* out, int x_bf16, int B,
                                    int out_features, int ig, int g, int x_staged, int blocks,
                                    int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((g != 8 && g != 16) || ig % 8 || blocks < 1 || out_features < 1 ||
      smem != gemv_smem(B, x_bf16 ? 2 : 4, ig, g, x_staged) || smem > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  if (g == 8 || B > 4) {
    if (blocks != (out_features + V_WARPS - 1) / V_WARPS) return cudaErrorInvalidValue;
    if (g == 8)
      return x_bf16 ? gemv_typed<__nv_bfloat16, 8>(B, x, codes, cb, scales, out, out_features, ig, st)
                    : gemv_typed<float, 8>(B, x, codes, cb, scales, out, out_features, ig, st);
    return x_bf16 ? gemv_typed<__nv_bfloat16, 16>(B, x, codes, cb, scales, out, out_features, ig, st)
                  : gemv_typed<float, 16>(B, x, codes, cb, scales, out, out_features, ig, st);
  }
  return x_bf16 ? gemv_pair_typed<__nv_bfloat16>(B, x, codes, cb, scales, out, out_features, ig,
                                                 x_staged, blocks, smem, st)
                : gemv_pair_typed<float>(B, x, codes, cb, scales, out, out_features, ig, x_staged,
                                         blocks, smem, st);
}

// The GEMM's pre-pass: w [OUT, IG * g] bf16 = cb[codes] for codes [OUT, IG]
// (n_codes = OUT * IG), over `blocks` blocks.
extern "C" int gather16_wt_launch(const void* codes, const void* cb, void* w, long long n_codes,
                                  int g, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((g != 8 && g != 16) || blocks < 1 || n_codes < 1) return cudaErrorInvalidValue;
  const long long n_units = n_codes * (g / 8);
  if (g == 8)
    gather16_wt_kernel<8><<<blocks, P_THREADS, 0, st>>>((const uint16_t*)codes, (const uint4*)cb,
                                                        (uint4*)w, n_units);
  else
    gather16_wt_kernel<16><<<blocks, P_THREADS, 0, st>>>((const uint16_t*)codes, (const uint4*)cb,
                                                         (uint4*)w, n_units);
  return cudaGetLastError();
}

// The GEMM as gather16.plan lays it out: x [T, IN] bf16 times w [OUT, IN]
// bf16 (the pre-pass's output), out [T, OUT] bf16 = bf16(scales * sum);
// bm (128 or 256) rows a block, `stages` ring stages, `smem` dynamic shared
// bytes (checked against the kernel's layout), `splits` blocks along the
// input of `per_split` 64-wide slabs each (partials [splits, ceil(T / bm) *
// bm, OUT] f32 and zeroed tickets [ceil(T / bm) * ceil(OUT / 128)] int32 when
// splits > 1).
extern "C" int gather16_gemm_launch(const void* x, const void* w, const void* scales, void* out,
                                    void* partials, void* tickets, int T, int out_features,
                                    int in_features, int bm, int stages, int smem, int splits,
                                    int per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((bm != 128 && bm != 256) || stages < 2 || stages > MAX_STAGES || splits < 1 ||
      per_split < 1 || T < 1 || out_features < 1 || in_features % BK)
    return cudaErrorInvalidValue;
  if (MLayout(bm, stages).total() != smem || smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  const int n_slabs = in_features / BK;
  if ((long long)(splits - 1) * per_split >= n_slabs || (long long)splits * per_split < n_slabs ||
      (splits > 1 && (!partials || !tickets)))
    return cudaErrorInvalidValue;
  if (bm == 256)
    return gemm_mt<2>(x, w, scales, out, partials, tickets, T, out_features, in_features, stages,
                      smem, splits, per_split, st);
  return gemm_mt<1>(x, w, scales, out, partials, tickets, T, out_features, in_features, stages, smem,
                    splits, per_split, st);
}
