// B5: the dense W^T [IN, OUT] from tiled Kx8 codes, the weight of the
// codes-mode activation backward (dx = g @ W).
//
//   wt[ig*8 + j, o] = OT( (sum_k f32 cb[k, codes[t, ig*K + k, c], j]) * scales[o] ),
//   o = t * tn + c, the sum taken in codebook order from k = 0.
//
// Replaces the TPU kernel of aqlm_tpu/ops/gather_prefill.py:
// gather_dequant_wt (_call_dequant, pallas_call at :331), which runs K2's
// lane-gather dequant of a [tig*K, tn] codes block into VMEM and writes the
// scaled tile to HBM. It backs QuantizedLinear.dense_weight_t for the tiled
// layout, and so the backward of every tiled codes projection
// (aqlm_tpu/ops/runtime.py:309).
//
// What bounds it on an H100: bytes. It reads 0.25 byte of codes a weight and
// writes 2 (bf16): Llama-2-7B's gate (11008 x 4096) writes 90.2 MB and reads
// 11.3 MB, 0.030 ms at 3.35 TB/s; the arithmetic is K adds a weight.
//
// Design: a stream of whole-line stores, as B13's (calib_dequant.cu). The
// work is cut into units of one input group by 256 output columns; a warp
// takes a unit at a time and a lane 8 of its columns, as runs of 16 bytes of
// output: one run of 8 consecutive columns in bf16, two runs of 4 (128
// columns apart) in f32. Per unit the lane reads, for each codebook, its
// run's code bytes in one load (a warp reads 256 contiguous bytes of a code
// row, the next unit's codes in flight at K <= 4), gathers the 8 x K
// codebook entries (16 bytes, 8 bf16 each) from shared memory, sums them in
// f32 (a run at a time: 64 accumulators in bf16, 32 in f32), scales, and
// stores each of the 8 rows ig*8 + j of its run as one 16-byte word: a
// warp store is 512 contiguous bytes of a row of W^T, whole lines (the
// first design gave a thread one column and stored 2 or 4 bytes a row,
// 64-byte warp stores). Few, full blocks: two of
// 8 warps an SM (gather_prefill.dequant_wt_plan), each staging the
// codebooks ([K, S, 8] bf16, 8 KB at 2x8) once and walking units
// warp-strided, column chunk fastest, so neighbouring warps write
// neighbouring lines of the same rows. Its f32 operations are those of its
// plain version in the same order, so the result is bit-identical.
//
// What held the first design back was not its stores (alone, in its lane
// mapping, they ran at 94-97% of the byte bound) but its code reads: a
// thread's chain of one-byte loads from device memory, a group at a time
// (with its codes in L2 it ran twice as fast at q). What bounds this one
// (experiments/torch_b5_b8_ablate.py): at q (a 32 MB W^T) its stores; at
// gate and down, whose 90 MB W^T outgrows the 50 MB L2, the code reads from
// device memory among the stores (~20%: with the codes in L2 it runs at
// its stores' pace, 14% behind a fill_), whatever the tile width; the
// codebook gathers' bank conflicts cost ~3%.
#include <string.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int G = 8;             // in_group_size: rows of W^T a unit writes
constexpr int WT_THREADS = 256;  // 8 warps
constexpr int WT_BLOCKS_PER_SM = 2;
constexpr int WT_COLS = 256;     // output columns of a unit: 8 a lane

// the code bytes of a run of RUN columns: 64 bits for 8, 32 for 4
template <int RUN>
using RunWord = std::conditional_t<RUN == 8, uint64_t, uint32_t>;

// a lane's code bytes of one run of RUN columns for one codebook, byte i at
// bits 8i: one load where the codes are aligned for it, else RUN byte loads
template <int RUN>
__device__ __forceinline__ RunWord<RUN> load_run(const uint8_t* p, bool aligned) {
  if (aligned) {
    if constexpr (RUN == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      return (uint64_t)v.x | ((uint64_t)v.y << 32);
    } else {
      return __ldg(reinterpret_cast<const unsigned int*>(p));
    }
  }
  RunWord<RUN> w = 0;
#pragma unroll
  for (int i = 0; i < RUN; ++i) w |= (RunWord<RUN>)__ldg(p + i) << (8 * i);
  return w;
}

// one 16-byte word of output: 8 bf16 or 4 f32 (v already scaled)
__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    memcpy(&w[i], &h, 4);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store_run(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename OT, int K>
__global__ void __launch_bounds__(WT_THREADS, WT_BLOCKS_PER_SM)
gather_dequant_wt_kernel(const uint8_t* __restrict__ codes,     // [NT, K*IG, tn]
                         const __nv_bfloat16* __restrict__ cb,  // [K, S, 8]
                         const float* __restrict__ scales,      // [OUT]
                         OT* __restrict__ out,                  // [IG*8, OUT]
                         int out_features, int ig_count, int tn, int S, int n_chunks, int units,
                         bool codes_aligned) {
  constexpr int RUN = 16 / sizeof(OT);  // columns of one 16-byte store
  constexpr int RUNS = G / RUN;         // a lane's runs: 1 (bf16) or 2 (f32)
  constexpr bool kPrefetch = K <= 4;  // the next unit's codes in flight (no spills)
  using Word = RunWord<RUN>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* s_cb = reinterpret_cast<uint4*>(smem);  // entry k*S + s: 8 bf16

  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * (WT_THREADS / 32);
  const size_t tile_codes = (size_t)K * ig_count * tn;

  // the lane's column of run r of unit u (every column of a run lies in one tile)
  auto column = [&](int u, int r) {
    return (u % n_chunks) * WT_COLS + r * (32 * RUN) + lane * RUN;
  };
  auto load_unit = [&](int u, Word (&cw)[RUNS][K]) {
    const int ig = u / n_chunks;
#pragma unroll
    for (int r = 0; r < RUNS; ++r) {
      const int o = column(u, r);
      const int t = o / tn;
      const uint8_t* p = codes + t * tile_codes + (size_t)ig * K * tn + (o - t * tn);
#pragma unroll
      for (int k = 0; k < K; ++k)
        cw[r][k] = o < out_features ? load_run<RUN>(p + (size_t)k * tn, codes_aligned) : 0;
    }
  };

  int u = blockIdx.x * (WT_THREADS / 32) + (threadIdx.x >> 5);
  Word next[RUNS][K];
  if constexpr (kPrefetch) {
    if (u < units) load_unit(u, next);
  }
  for (int i = threadIdx.x; i < K * S; i += WT_THREADS)
    s_cb[i] = __ldg(reinterpret_cast<const uint4*>(cb) + i);
  __syncthreads();

  for (; u < units; u += n_warps) {
    Word cw[RUNS][K];
    if constexpr (kPrefetch) {
#pragma unroll
      for (int r = 0; r < RUNS; ++r)
#pragma unroll
        for (int k = 0; k < K; ++k) cw[r][k] = next[r][k];
      if (u + n_warps < units) load_unit(u + n_warps, next);
    } else {
      load_unit(u, cw);
    }
    const int ig = u / n_chunks;
#pragma unroll
    for (int r = 0; r < RUNS; ++r) {  // a run at a time: RUN x 8 accumulators live
      // acc[i][j]: column o + i, row ig*8 + j (the gathers first: an empty run reads code 0)
      float acc[RUN][G];
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        aqlm::bf16x8_to_float(s_cb[(cw[r][0] >> (8 * i)) & 0xff], acc[i]);
#pragma unroll
        for (int k = 1; k < K; ++k) {
          float f[G];
          aqlm::bf16x8_to_float(s_cb[k * S + ((cw[r][k] >> (8 * i)) & 0xff)], f);
#pragma unroll
          for (int j = 0; j < G; ++j) acc[i][j] += f[j];
        }
      }
      const int o = column(u, r);
      if (o >= out_features) continue;  // the empty half-warp at OUT % 256 == 128
      float sc[RUN];
#pragma unroll
      for (int i = 0; i < RUN; ++i) sc[i] = __ldg(scales + o + i);
      OT* dst = out + (size_t)ig * G * out_features + o;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float v[RUN];
#pragma unroll
        for (int i = 0; i < RUN; ++i) v[i] = acc[i][j] * sc[i];
        store_run(dst + (size_t)j * out_features, v);
      }
    }
  }
}

int sm_count() {
  static int count[64];
  int d = 0;
  cudaGetDevice(&d);
  if (d < 0 || d >= 64) return 132;
  if (!count[d]) cudaDeviceGetAttribute(&count[d], cudaDevAttrMultiProcessorCount, d);
  return count[d];
}

template <typename OT, int K>
cudaError_t launch_typed(const void* codes, const void* cb, const void* scales, void* out, int nt,
                         int kig, int tn, int S, cudaStream_t stream) {
  const int out_features = nt * tn, ig_count = kig / K;
  // geometry of gather_prefill.dequant_wt_plan
  const int n_chunks = (out_features + WT_COLS - 1) / WT_COLS;
  const long long units = (long long)n_chunks * ig_count;
  if (units >= (1ll << 30)) return cudaErrorInvalidValue;  // u + n_warps stays an int
  const int warps = WT_THREADS / 32;
  const long long blocks =
      std::min((units + warps - 1) / warps, (long long)WT_BLOCKS_PER_SM * sm_count());
  const bool aligned = reinterpret_cast<uintptr_t>(codes) % (16 / sizeof(OT)) == 0;
  const size_t smem = (size_t)K * S * 16;  // at most 32 KB (K <= 8, S <= 256)
  gather_dequant_wt_kernel<OT, K><<<(int)blocks, WT_THREADS, smem, stream>>>(
      (const uint8_t*)codes, (const __nv_bfloat16*)cb, (const float*)scales, (OT*)out,
      out_features, ig_count, tn, S, n_chunks, (int)units, aligned);
  return cudaGetLastError();
}

template <typename OT>
cudaError_t launch_k(const void* codes, const void* cb, const void* scales, void* out, int nt,
                     int kig, int tn, int K, int S, cudaStream_t st) {
  switch (K) {
    case 1: return launch_typed<OT, 1>(codes, cb, scales, out, nt, kig, tn, S, st);
    case 2: return launch_typed<OT, 2>(codes, cb, scales, out, nt, kig, tn, S, st);
    case 3: return launch_typed<OT, 3>(codes, cb, scales, out, nt, kig, tn, S, st);
    case 4: return launch_typed<OT, 4>(codes, cb, scales, out, nt, kig, tn, S, st);
    case 5: return launch_typed<OT, 5>(codes, cb, scales, out, nt, kig, tn, S, st);
    case 6: return launch_typed<OT, 6>(codes, cb, scales, out, nt, kig, tn, S, st);
    case 7: return launch_typed<OT, 7>(codes, cb, scales, out, nt, kig, tn, S, st);
    default: return launch_typed<OT, 8>(codes, cb, scales, out, nt, kig, tn, S, st);
  }
}

}  // namespace

// codes [NT, K*IG, tn] uint8 (ig-major rows), cb [K, S, 8] bf16, scales
// [OUT = NT*tn] f32; out [IG*8, OUT], bf16 (out_bf16) or f32. K <= 8, S <= 256,
// tn a multiple of 8 (128 or 512 in the tiled layout).
extern "C" int gather_dequant_wt_launch(const void* codes, const void* cb, const void* scales,
                                        void* out, int out_bf16, int nt, int kig, int tn, int K,
                                        int S, void* stream) {
  if (K < 1 || K > 8 || S < 1 || S > 256 || kig % K || nt < 1 || tn < 8 || tn % 8)
    return cudaErrorInvalidValue;
  if (kig == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16) return launch_k<__nv_bfloat16>(codes, cb, scales, out, nt, kig, tn, K, S, st);
  return launch_k<float>(codes, cb, scales, out, nt, kig, tn, K, S, st);
}
