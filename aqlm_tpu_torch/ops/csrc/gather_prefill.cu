// K2: Kx8 gather-dequant prefill GEMM over the tiled codes layout.
//
// Replaces the TPU kernels of aqlm_tpu/ops/gather_prefill.py:
// gather_prefill_matmul (_call_plain, pallas_call at :285),
// gather_prefill_matmul_indexed (_call_indexed, :416) and
// gather_prefill_matmul_grouped_indexed (_call_grouped, :510), and, with its
// expert grid axis, the prefill rows (> 8) of aqlm_tpu/ops/lut_gemv.py's
// lut_moe_gemv_kx8(_indexed) (:272, :351). The layer index is a pointer
// offset applied by the caller; an optional per-out-tile projection map
// picks each tile's codebooks (fused q/k/v or gate/up).
//
//   y[e, t, o] = scales[e, o] * sum_i x[e, t, i] * bf16(sum_k cb[e, p(o), k, codes[e, (i/8)*K+k, o], i%8])
//
// Numerics follow the TPU kernel: the codebook vectors are summed in f32 and
// rounded to bf16 before the product (gather_prefill.py:113-115); the product
// accumulates in f32; the scale and the cast run in the epilogue.
//
// What bounds it on an H100: at prefill widths it is a GEMM, 2*T*OUT*IN
// operations on the bf16 tensor cores (Llama-2-7B's fused qkv at T=1024:
// 103 GFLOP, 0.104 ms at 989 TFLOP/s); the codes are only 0.25 byte per
// weight. In this design shared memory sets the pace: each wgmma
// m64n128k16 reads 6 KB of operands from it (~75% of its port while the
// tensor cores work), and the dequantisation adds two random 16-byte
// codebook reads per code group (bank conflicts: ~2.5 wavefronts each) and
// a 16-byte store (experiments/torch_k2_ablate.py: without the dequantiser
// the kernel takes ~0.65x the time, without the products ~0.65x).
//
// Design (Hopper, warp-specialised): a block of 384 threads owns a BM x 128
// output tile (BM 256 past 128 rows, else 128) and walks the input dimension
// in 64-wide slabs (8 groups):
//   - warp 8, the producer, keeps a ring of 3-4 stages in flight: the
//     activation tile [BM x 64] by one TMA copy (128-byte swizzle, rows past
//     T zero-filled) and the code slab by the lanes' cp.async, each stage
//     completing on its own mbarrier (expect_tx and cp.async.mbarrier.arrive);
//   - warps 9-11, the dequantisers, turn the codes of slab s+1 into the bf16
//     W^T tile [64 x 128] (codebooks staged once per block) in one of two
//     buffers, written straight into wgmma's K-major core-matrix layout (one
//     16-byte store per code group; with 1 or 2 codebooks the f32 sum
//     rounded to bf16 is one bf16x2 add per pair);
//   - warps 0-7, two consumer warpgroups, run wgmma.mma_async m64n128k16 on
//     slab s (each warpgroup BM/2 rows; activations through a 128B-swizzle
//     descriptor, W^T through an unswizzled one), keeping one slab's
//     products in flight while the next slab's barriers are awaited.
// Per-stage full/empty barriers replace block-wide syncs: nothing waits for
// the whole block inside the loop. At BM 256 each weight is dequantised
// ceil(T / 256) times (4 at T=1024; the old 128-token tile did it 8 times).
// Seven dequantiser warps (512 threads, setmaxnreg) ran 2.5x slower: ptxas
// held every path to 128 registers and the consumers spilled.
//
// Where the output tiles alone would leave the card idle (short prompts,
// narrow projections; the split count comes from the wrapper's planning
// function, gather_prefill.plan), the input dimension is split over blocks:
// each writes f32 partial sums and the last block of an output tile to
// finish (an atomic ticket) adds them in a fixed order.
//
// An expert grid axis (blockIdx.z = expert * splits + split) runs every
// expert of a stacked codes projection in one launch: x shared or one per
// expert, each expert its own codes, codebooks and scales, writing its slice
// of the f32 [E, T, OUT] output. The output type is a template parameter:
// bf16 for the projections, f32 for that all-expert route.
#include <cuda.h>  // CUtensorMap; the encoder is reached through the runtime, no libcuda link

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace aqlm;

constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // inputs per slab (8 groups of 8)
constexpr int G = 8;
constexpr int THREADS = 384;
constexpr int PRODUCER_WARP = 8;
constexpr int DQ_THREADS = 96;  // warps 9-11
constexpr int CONSUMER_WARPS = 8;
constexpr int W_BYTES = BK * BN * 2;
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_STAGES = 8;

// Byte offsets in the dynamic shared memory from its first 1024-aligned
// byte (the 128B-swizzled activation tiles need it; hence the 1024 bytes of
// slack in the total); gather_prefill.plan computes the same total, and a
// launch whose total differs is refused.
struct Layout {
  int bm, K, S, stages;
  __host__ __device__ Layout(int bm_, int K_, int S_, int st) : bm(bm_), K(K_), S(S_), stages(st) {}
  __host__ __device__ int x(int s) const { return s * bm * BK * 2; }
  __host__ __device__ int codes(int s) const { return stages * bm * BK * 2 + s * (BK / G) * K * BN; }
  __host__ __device__ int w(int b) const { return codes(stages) + b * W_BYTES; }
  __host__ __device__ int cb() const { return w(2); }
  __host__ __device__ int bar() const { return cb() + K * S * 16; }
  __host__ __device__ int n_bars() const { return 2 * stages + 4; }
  __host__ __device__ int flag() const { return bar() + n_bars() * 8; }
  __host__ __device__ int total() const { return flag() + 16 + 1024; }
};

// Two bf16 pairs added lane by lane, each sum correctly rounded.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// MT: 64-row wgmma tiles per consumer warpgroup (BM = 128 * MT).
template <typename OT, int MT>
__global__ void __launch_bounds__(THREADS, 1)
gather_prefill_kernel(const __grid_constant__ CUtensorMap x_map,  // x [E or 1, T, IN] bf16
                      const uint8_t* __restrict__ codes,     // [E, NT, K*IG, tn] of one layer
                      const __nv_bfloat16* __restrict__ cb,  // [E, P, K, S, G] of one layer
                      const float* __restrict__ scales,      // [E, OUT] of one layer
                      const int* __restrict__ proj_map,      // [NT] or null
                      OT* __restrict__ out,                  // [E, T, OUT]
                      float* __restrict__ partials,          // [E * splits, Tpad, OUT] when split
                      int* __restrict__ tickets,             // [E, row tiles, col tiles] zeroed
                      int T, int n_tiles, int kig, int tn, int K, int S, int in_features,
                      int splits, int slabs_per_split, int stages, int x_per_expert,
                      long long codes_estride, int cb_estride) {
  constexpr int BM = 128 * MT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Layout L(BM, K, S, stages);
  uint4* s_cb = reinterpret_cast<uint4*>(smem + L.cb());
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar());
  uint64_t* empty = full + stages;
  uint64_t* wfull = empty + stages;
  uint64_t* wempty = wfull + 2;
  int& s_last = *reinterpret_cast<int*>(smem + L.flag());

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int e = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int out_features = n_tiles * tn;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int tile = col0 / tn;
  const int proj = proj_map ? proj_map[tile] : 0;
  const int n_slabs = in_features / BK;
  const int s_begin = sp * slabs_per_split;
  const int n_local = min(n_slabs, s_begin + slabs_per_split) - s_begin;
  scales += (size_t)e * out_features;
  out += (size_t)e * T * out_features;
  const uint8_t* cp = codes + e * codes_estride + (size_t)tile * kig * tn + (col0 - tile * tn);

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
  const uint4* cb_p =
      reinterpret_cast<const uint4*>(cb + (size_t)e * cb_estride) + (size_t)proj * K * S;
  for (int i = tid; i < K * S; i += THREADS) s_cb[i] = cb_p[i];
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    // slab j -> stage j % stages; a stage is refilled once its previous
    // slab's consumers and dequantisers have released it. The activation
    // tile [BM x 64] comes by one TMA copy (rows past T as zeros), the code
    // slab by the lanes' cp.async.
    for (int j = 0; j < n_local; ++j) {
      const int st = j % stages, s = s_begin + j;
      if (j >= stages) mbar_wait(empty + st, (j / stages - 1) & 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(full + st, BM * BK * 2);
        tma_load_3d(smem + L.x(st), &x_map, s * BK, row0, x_per_expert ? e : 0, full + st);
      }
      unsigned char* sc = smem + L.codes(st);
      for (int q = lane; q < (BK / G) * K * (BN / 16); q += 32) {
        const int r = q / (BN / 16), c16 = q % (BN / 16);
        aqlm::cp_async16(sc + r * BN + c16 * 16, cp + (size_t)(s * (BK / G) * K + r) * tn + c16 * 16);
      }
      mbar_arrive_cp_async(full + st);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives its issuer
  } else if (warp > PRODUCER_WARP) {
    // dequantisers: slab j's W^T into buffer j % 2, entry (group gl, column
    // n) -> one 16-byte row of core matrix (n / 8, gl), in the order the
    // codebooks are summed by every other kernel of the port
    const int dt = tid - (PRODUCER_WARP + 1) * 32;
    for (int j = 0; j < n_local; ++j) {
      const int st = j % stages, wb = j & 1;
      mbar_wait(full + st, (j / stages) & 1);
      if (j >= 2) mbar_wait(wempty + wb, (j / 2 - 1) & 1);
      const uint8_t* sc = smem + L.codes(st);
      unsigned char* sw = smem + L.w(wb);
      if (K <= 2) {
        // one or two codebooks: bf16(f32(a) + f32(b)) is the bf16x2 add of a
        // and b (the f32 sum of two bf16 values rounds to bf16 as their
        // correctly rounded bf16 sum), so the vectors add as bf16 pairs
        constexpr int UNR2 = 6;  // entries in flight per thread
        for (int e0 = dt; e0 < (BK / G) * BN; e0 += UNR2 * DQ_THREADS) {
          uint4 v[UNR2];
#pragma unroll
          for (int u = 0; u < UNR2; ++u) {
            const int en = min(e0 + u * DQ_THREADS, (BK / G) * BN - 1);
            const uint8_t* c = sc + (en >> 7) * K * BN + (en & 127);
            v[u] = s_cb[c[0]];
            if (K == 2) {
              const uint4 b = s_cb[S + c[BN]];
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
      constexpr int UNR = 4;  // entries in flight per thread
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
            v[u] = s_cb[k * S + sc[((en >> 7) * K + k) * BN + (en & 127)]];
          }
#pragma unroll
          for (int u = 0; u < UNR; ++u) {
            float f[G];
            aqlm::bf16x8_to_float(v[u], f);
#pragma unroll
            for (int i = 0; i < G; ++i) w[u][i] += f[i];
          }
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int en = e0 + u * DQ_THREADS;
          if (en < (BK / G) * BN) {
            const int gl = en >> 7, n = en & 127;
            uint4 packed;
            packed.x = pack_bf16x2(w[u][0], w[u][1]);
            packed.y = pack_bf16x2(w[u][2], w[u][3]);
            packed.z = pack_bf16x2(w[u][4], w[u][5]);
            packed.w = pack_bf16x2(w[u][6], w[u][7]);
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
    if (splits == 1) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < BN / 8; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = rbase + m * 64 + 8 * h, col = cbase + 8 * c;
            if (row < T)
              store2(out + (size_t)row * out_features + col, acc[m][4 * c + 2 * h] * scales[col],
                     acc[m][4 * c + 2 * h + 1] * scales[col + 1]);
          }
      return;
    }
    // split input dimension: park the f32 partial tile, the last block sums
    const int t_pad = gridDim.y * BM;
    float* part = partials + (size_t)blockIdx.z * t_pad * out_features;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rbase + m * 64 + 8 * h, col = cbase + 8 * c;
          if (row < T)
            store2(part + (size_t)row * out_features + col, acc[m][4 * c + 2 * h],
                   acc[m][4 * c + 2 * h + 1]);
        }
    __threadfence();
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_WARPS * 32) : "memory");
    if (tid == 0)
      s_last = atomicAdd(tickets + ((size_t)e * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x,
                         1) == splits - 1;
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_WARPS * 32) : "memory");
    if (!s_last) return;
    __threadfence();
    const float* p0 = partials + (size_t)e * splits * t_pad * out_features;
    for (int i = tid; i < BM * (BN / 4); i += CONSUMER_WARPS * 32) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const int row = row0 + r, col = col0 + c;
      if (row >= T) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int z = 0; z < splits; ++z) {
        const float4 pz = __ldcg(reinterpret_cast<const float4*>(
            p0 + ((size_t)z * t_pad + row) * out_features + col));
        v.x += pz.x;
        v.y += pz.y;
        v.z += pz.z;
        v.w += pz.w;
      }
      OT* o = out + (size_t)row * out_features + col;
      store2(o, v.x * scales[col], v.y * scales[col + 1]);
      store2(o + 2, v.z * scales[col + 2], v.w * scales[col + 3]);
    }
  }
}

template <typename OT, int MT>
cudaError_t launch_typed(const void* x, const void* codes, const void* cb, const void* scales,
                         const void* proj_map, void* out, void* partials, void* tickets, int T,
                         int splits, int per_split, int stages, int smem, int experts,
                         int n_tiles, int kig, int tn, int K, int S, int in_features,
                         int x_per_expert, long long codes_estride, int cb_estride,
                         cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(gather_prefill_kernel<OT, MT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  constexpr int BM = 128 * MT;
  // x as a 3-D tensor [E or 1][T][IN], boxes of 64 inputs x BM rows, 128B-swizzled
  const EncodeTiled encode = encoder();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap x_map;
  const cuuint64_t dims[3] = {(cuuint64_t)in_features, (cuuint64_t)T,
                              (cuuint64_t)(x_per_expert ? experts : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)in_features * 2, (cuuint64_t)T * in_features * 2};
  const cuuint32_t box[3] = {BK, BM, 1}, unit[3] = {1, 1, 1};
  if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const dim3 grid(n_tiles * tn / BN, (T + BM - 1) / BM, experts * splits);
  gather_prefill_kernel<OT, MT><<<grid, THREADS, smem, stream>>>(
      x_map, (const uint8_t*)codes, (const __nv_bfloat16*)cb, (const float*)scales,
      (const int*)proj_map, (OT*)out, (float*)partials, (int*)tickets, T, n_tiles, kig, tn, K, S,
      in_features, splits, per_split, stages, x_per_expert, codes_estride, cb_estride);
  return cudaGetLastError();
}

}  // namespace

// One launch of K2 as gather_prefill.plan lays it out: bm (128 or 256) rows
// a block, `stages` ring stages, `smem` dynamic shared bytes (checked against
// the kernel's own layout), `splits` blocks along the input dimension of
// `per_split` slabs each (partials [E * splits, ceil(T / bm) * bm, OUT] f32
// and zeroed tickets [E, ceil(T / bm), OUT / 128] int32 when splits > 1),
// `experts` blocks along the expert axis: x is [E, T, IN] when x_per_expert
// (else [T, IN], shared), codes advance codes_estride bytes an expert,
// codebooks cb_estride elements, scales OUT and out T * OUT. out_bf16
// selects a bf16 (1) or f32 (0) output.
extern "C" int gather_prefill_launch(const void* x, const void* codes, const void* cb,
                                     const void* scales, const void* proj_map, void* out,
                                     void* partials, void* tickets, int out_bf16, int bm,
                                     int stages, int smem, int T, int splits, int per_split,
                                     int experts, int n_tiles, int kig, int tn, int K, int S,
                                     int in_features, int x_per_expert,
                                     long long codes_estride, int cb_estride, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((bm != 128 && bm != 256) || stages < 2 || stages > MAX_STAGES || splits < 1 ||
      experts < 1 || K < 1 || K > 8 || S < 1 || S > 256 || in_features % BK || tn % BN)
    return cudaErrorInvalidValue;
  if (Layout(bm, K, S, stages).total() != smem || smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  if ((long long)(splits - 1) * per_split >= in_features / BK) return cudaErrorInvalidValue;
#define AQLM_K2(OT, MT)                                                                          \
  return launch_typed<OT, MT>(x, codes, cb, scales, proj_map, out, partials, tickets, T, splits, \
                              per_split, stages, smem, experts, n_tiles, kig, tn, K, S,          \
                              in_features, x_per_expert, codes_estride, cb_estride, st)
  if (out_bf16) {
    if (bm == 256) AQLM_K2(__nv_bfloat16, 2);
    AQLM_K2(__nv_bfloat16, 1);
  }
  if (bm == 256) AQLM_K2(float, 2);
  AQLM_K2(float, 1);
#undef AQLM_K2
}
