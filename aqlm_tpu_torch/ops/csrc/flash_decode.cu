// K3: fused KV-row write + single-token GQA flash-decode attention over one
// layer of the stacked head-major cache, int8 (with f32 per-row scales) or
// bf16.
//
// Replaces the TPU kernel aqlm_tpu/ops/flash_decode.py:
// flash_decode_write_attention_indexed (_call_idx_wattn, pallas_call at :358).
// The layer index is a pointer offset applied by the caller.
//
// For every (row b, kv head h): write the new key/value row (and its scales)
// at offsets[b], in place; then attend the REP query heads of the group to
// the keys in [max(0, len - window), len), len = offsets[b] + 1, with an
// online softmax (f32 m, l and accumulators) and the same length mask and
// sliding window as the TPU kernel (flash_decode.py:32-38, :65-79).
//
// What bounds it on an H100: the cache bytes of the valid keys, read once:
// 2 * (D + 4) bytes per key per kv head for int8 (2 * 2D for bf16); the
// arithmetic is 4*REP*D FLOP per key. Unlike the TPU grid, which visits every
// tile up to max_len, the kernel reads only keys below the row's length.
//
// Design, simple first: one 256-thread block per (b, h). The block writes the
// new row first and synchronises, so the attention reads it back like any
// other key (global writes before __syncthreads are visible to the block;
// the cache is read with ordinary, not read-only-cache, loads). The eight
// warps take 32-key tiles in turn: each lane scores one key against the REP
// queries held in shared memory, the warp updates its running max and sum
// with shuffles, then the lanes (each owning D/32 output elements) accumulate
// p * v over the tile's keys, eight value rows in flight at a time. The
// eight warps' states merge in shared memory.
//
// More query heads per kv head than the 1/2/4/8 the single-block instances
// hold (Falcon-7B: 71 over one kv head; one block would need 145 KB of
// static accumulators and ~280 registers a thread) run split-KV on the tensor
// cores (flash_decode_split_kernel, then flash_decode_combine_kernel). The
// work there is small (Falcon at B=4 and offsets 0/511/512/1999: ~145 MFLOP,
// ~0.4 MB), so latency and the count of busy SMs bound it, not bytes: the
// keys of a row are cut into splits of 64-256 (gridded with the kv heads and
// rows: 128 blocks at Falcon's shape), each block takes every query head of
// its (b, h) (up to 128, in 16-row mma tiles), so each K/V row is read once
// per row, and the two products run as mma.sync m16n8k16. Every block takes
// the new row at `offset` from k_new/v_new; the split holding it writes it.
// Folded into the single-block template, this path moved those instances'
// registers: it is a kernel of its own.
//
// B6, flash decode without the row write, replaces the TPU kernels
// flash_decode_attention (_call, pallas_call at :152) and
// flash_decode_attention_indexed (_call_idx, :656): the same loops,
// instanced without WRITE (flash_decode_kernel, and the split kernel with
// WRITE off). They take each row's length in place of offset + 1, read every
// key from the cache, and at a length of 0 return what the TPU grid returns
// there, the mean of V over the tiles it visits (key_range). The loops are
// shared __device__ bodies or kernels under a WRITE flag, so K3's
// single-block kernels keep their names, signatures and code.
#include "common.cuh"

namespace {

constexpr int NWARP = 8;
constexpr float NEG = -1e30f;

template <bool QUANT>
struct Storage;
template <>
struct Storage<true> { using T = int8_t; };
template <>
struct Storage<false> { using T = __nv_bfloat16; };

// 16 bytes of a key row -> floats: 16 int8 or 8 bf16.
__device__ __forceinline__ void unpack16(const int8_t* p, float* f) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[i * 4 + j] = (float)(int8_t)((w[i] >> (8 * j)) & 0xff);
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* f) {
  aqlm::bf16x8_to_float(*reinterpret_cast<const uint4*>(p), f);
}

// EPL (2 or 4) consecutive elements of a value row -> floats, one load.
template <int EPL>
__device__ __forceinline__ void load_v(const int8_t* p, float* f) {
  const int w = EPL == 4 ? *reinterpret_cast<const int*>(p)
                         : (int)*reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int e = 0; e < EPL; ++e) f[e] = (float)(int8_t)((w >> (8 * e)) & 0xff);
}
template <int EPL>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* f) {
  if (EPL == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    aqlm::bf16x2_to_float(w.x, f[0], f[1]);
    aqlm::bf16x2_to_float(w.y, f[2], f[3]);
  } else {
    aqlm::bf16x2_to_float(*reinterpret_cast<const uint32_t*>(p), f[0], f[1]);
  }
}

// The key range of a row. WRITE (K3): keys [max(0, len - window), len),
// len = offset + 1. Otherwise (B6) `pos` is the row's length: the same
// range with len = pos, except that a row with no key in it (a length of 0)
// takes what the TPU grid computes there: every key of the tiles it visits
// is masked to the same logit (-1e30), so the result is the mean of V over
// those tiles (ts keys each, n_tiles of the ceil(S / ts) when the window
// skips the rest; flash_decode.py:32-38, :65-79). `uniform` marks that case.
template <bool WRITE>
__device__ __forceinline__ void key_range(int pos, int S, int window, int ts, int n_tiles,
                                          int& kstart, int& kend, bool& uniform) {
  uniform = false;
  if constexpr (WRITE) {
    kend = pos + 1;
    kstart = window > 0 ? max(0, kend - window) : 0;
  } else {
    kend = min(pos, S);
    kstart = window > 0 ? max(0, pos - window) : 0;
    if (kend <= kstart) {
      const int nt_full = (S + ts - 1) / ts;
      const int st = n_tiles < nt_full ? min(max(pos - window, 0) / ts, nt_full - n_tiles) : 0;
      kstart = st * ts;
      kend = min(S, (st + n_tiles) * ts);
      uniform = true;
    }
  }
}

// One (b, h) of single-block flash decode. WRITE (K3) first writes the new
// row at offsets[b]; without it (B6) `offsets` holds the rows' lengths and
// the cache is only read.
template <int D, int REP, bool QUANT, bool WRITE>
__device__ __forceinline__ void
flash_decode_body(const __nv_bfloat16* __restrict__ q,       // [B, Hkv, REP, D]
                  const typename Storage<QUANT>::T* __restrict__ k_new,  // [B, Hkv, D]
                  const typename Storage<QUANT>::T* __restrict__ v_new,
                  const float* __restrict__ ks_new,          // [B, Hkv] (int8 only)
                  const float* __restrict__ vs_new,
                  typename Storage<QUANT>::T* k_cache,       // [B, Hkv, S, D] one layer
                  typename Storage<QUANT>::T* v_cache,
                  float* ks_cache,                           // [B, Hkv, S] one layer
                  float* vs_cache,
                  const int* __restrict__ offsets,           // [B] (lengths without WRITE)
                  __nv_bfloat16* __restrict__ out,           // [B, Hkv, REP, D]
                  int Hkv, int S, int window, float scale, int ts, int n_tiles) {
  using T = typename Storage<QUANT>::T;
  constexpr int EPL = D / 32;
  __shared__ float s_q[REP][D];
  __shared__ float s_m[NWARP][REP], s_l[NWARP][REP];
  __shared__ float s_acc[NWARP][REP][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int bh = b * Hkv + h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int offset = offsets[b];
  if (WRITE && (offset < 0 || offset >= S)) {
    // no row to write inside the cache: touch nothing, and make the row's
    // output NaN so the fault shows instead of corrupting device memory
    for (int i = tid; i < REP * D; i += blockDim.x)
      out[(size_t)bh * REP * D + i] = __float2bfloat16(NAN);
    return;
  }
  int kstart, len;
  bool uniform;
  key_range<WRITE>(offset, S, window, ts, n_tiles, kstart, len, uniform);

  T* kc = k_cache + (size_t)bh * S * D;
  T* vc = v_cache + (size_t)bh * S * D;
  float* ksc = QUANT ? ks_cache + (size_t)bh * S : nullptr;
  float* vsc = QUANT ? vs_cache + (size_t)bh * S : nullptr;

  // 1. write the new row in place
  if constexpr (WRITE) {
    for (int d = tid; d < D; d += blockDim.x) {
      kc[(size_t)offset * D + d] = k_new[(size_t)bh * D + d];
      vc[(size_t)offset * D + d] = v_new[(size_t)bh * D + d];
    }
    if (QUANT && tid == 0) {
      ksc[offset] = ks_new[bh];
      vsc[offset] = vs_new[bh];
    }
  }
  for (int i = tid; i < REP * D; i += blockDim.x)
    s_q[i / D][i % D] = __bfloat162float(q[(size_t)bh * REP * D + i]);
  __syncthreads();

  // 2. online softmax over 32-key tiles, warps taking tiles in turn
  float m[REP], l[REP], acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  for (int t0 = kstart + warp * 32; t0 < len; t0 += NWARP * 32) {
    const int key = t0 + lane;
    const bool valid = key < len;
    float logit[REP];
    float ksc_v = 1.f;
#pragma unroll
    for (int r = 0; r < REP; ++r) logit[r] = 0.f;
    if (valid) {
      const T* kr = kc + (size_t)key * D;
      constexpr int CH = 16 / (int)sizeof(T);  // elements per 16-byte load
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += CH) {
        float f[16];
        unpack16(kr + d0, f);
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
          for (int j = 0; j < CH; ++j) logit[r] = fmaf(s_q[r][d0 + j], f[j], logit[r]);
      }
      if (QUANT) ksc_v = ksc[key];
    }
    float p[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float lg = valid ? (uniform ? 0.f : logit[r] * ksc_v * scale) : -INFINITY;
      float tmax = lg;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[r], tmax);
      const float corr = expf(m[r] - m_new);
      p[r] = valid ? expf(lg - m_new) : 0.f;
      float psum = p[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
    }
    const float vsc_lane = (QUANT && valid) ? vsc[key] : 1.f;
    const int nvalid = min(32, len - t0);
    // value rows in batches of 8 loads in flight (one row at a time waited a
    // full memory latency per key); rows past the length read as zero
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += 8) {
      if (j0 >= nvalid) break;
      float v[8][EPL];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j0 + u < nvalid) {
          load_v<EPL>(vc + (size_t)(t0 + j0 + u) * D + lane * EPL, v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) v[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float vs = __shfl_sync(0xffffffffu, vsc_lane, j0 + u);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float pj = __shfl_sync(0xffffffffu, p[r], j0 + u) * vs;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pj, v[u][e], acc[r][e]);
        }
      }
    }
  }

  // 3. merge the warps' states
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      s_m[warp][r] = m[r];
      s_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[warp][r][lane * EPL + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = tid; i < REP * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) mx = fmaxf(mx, s_m[w][r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float c = expf(s_m[w][r] - mx);
      num += c * s_acc[w][r][d];
      den += c * s_l[w][r];
    }
    out[(size_t)bh * REP * D + i] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

// K3: write the new row, then attend (the body with WRITE).
template <int D, int REP, bool QUANT>
__global__ void __launch_bounds__(NWARP * 32)
flash_decode_write_kernel(const __nv_bfloat16* __restrict__ q,
                          const typename Storage<QUANT>::T* __restrict__ k_new,
                          const typename Storage<QUANT>::T* __restrict__ v_new,
                          const float* __restrict__ ks_new, const float* __restrict__ vs_new,
                          typename Storage<QUANT>::T* k_cache, typename Storage<QUANT>::T* v_cache,
                          float* ks_cache, float* vs_cache, const int* __restrict__ offsets,
                          __nv_bfloat16* __restrict__ out, int Hkv, int S, int window,
                          float scale) {
  flash_decode_body<D, REP, QUANT, true>(q, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                                         ks_cache, vs_cache, offsets, out, Hkv, S, window, scale,
                                         0, 0);
}

// B6: attend over the cache as it is, keys below lengths[b] (the body
// without WRITE).
template <int D, int REP, bool QUANT>
__global__ void __launch_bounds__(NWARP * 32)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    typename Storage<QUANT>::T* k_cache, typename Storage<QUANT>::T* v_cache,
                    float* ks_cache, float* vs_cache, const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int Hkv, int S, int window, float scale,
                    int ts, int n_tiles) {
  flash_decode_body<D, REP, QUANT, false>(q, nullptr, nullptr, nullptr, nullptr, k_cache, v_cache,
                                          ks_cache, vs_cache, lengths, out, Hkv, S, window, scale,
                                          ts, n_tiles);
}

// More query heads per kv head than the single-block instances hold
// (Falcon-7B: 71 over one kv head): split-KV on the tensor cores. Block
// (h, b, z * n_hch + hc) takes keys [z * kps, (z + 1) * kps) of the row's
// range and up to 128 query heads (head chunk hc; eight warps of 16 heads,
// the last tile padded). Its 64-key tiles arrive in shared memory by
// cp.async, two in flight. Each warp scores its 16 heads against a tile with
// mma.sync m16n8k16 (bf16 in, f32 out; an int8 key is exact in bf16, its
// scale multiplies its score column), runs the online softmax in f32, folds
// each key's value scale into p and multiplies p into V
// (converted to a bf16 V^T tile) on the tensor cores, p split into a hi and
// a lo bf16 part (two products) so that it keeps ~16 bits. The split's (m, l,
// acc) go to f32 partials; flash_decode_combine_kernel merges them in split
// order 0, 1, ... (deterministic) and writes bf16.
//
// With WRITE every block takes the key and value at `offset` (and their
// scales) from k_new/v_new, as the TPU kernel does (flash_decode.py:222-234),
// and the split holding `offset` writes the row to the cache (head chunk 0);
// no block reads that cache row. A row whose offset lies outside [0, S)
// writes nothing, and the combine returns NaN for it. Without WRITE (B6) a
// row with no key in range takes the mean of V over the tiles the TPU grid
// visits (key_range), split like any other range.
constexpr int KT = 64;           // keys per tile
constexpr int SPLIT_WARPS = 8;   // at most 128 query heads a block
constexpr int COMBINE_THREADS = 256;

template <int D, bool QUANT>
struct SplitSmem {
  using T = typename Storage<QUANT>::T;
  static constexpr int ROW = D * (int)sizeof(T) + 16;  // padded row: conflict-free fragment reads
  static constexpr int VTLD = KT + 8;                   // padded row of V^T (bf16)
  static constexpr int BUF = 2 * KT * ROW + 2 * KT * 4;  // K, V, key scales, value scales
  static constexpr int VT = 2 * BUF;
  static constexpr int TOTAL = VT + D * VTLD * 2;
};

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Two consecutive key elements as a bf16 pair (int8 is exact in bf16).
__device__ __forceinline__ uint32_t pair_bf16(const int8_t* p) {
  return pack2((float)p[0], (float)p[1]);
}
__device__ __forceinline__ uint32_t pair_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t v) { return __float2bfloat16((float)v); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }

template <int D, bool QUANT, bool WRITE>
__global__ void __launch_bounds__(SPLIT_WARPS * 32)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Hkv, rep, D]
                          const typename Storage<QUANT>::T* __restrict__ k_new,  // [B, Hkv, D]
                          const typename Storage<QUANT>::T* __restrict__ v_new,
                          const float* __restrict__ ks_new,  // [B, Hkv] (int8 only)
                          const float* __restrict__ vs_new,
                          typename Storage<QUANT>::T* k_cache,  // [B, Hkv, S, D] one layer
                          typename Storage<QUANT>::T* v_cache,
                          float* ks_cache,  // [B, Hkv, S] one layer
                          float* vs_cache,
                          const int* __restrict__ offsets,  // [B] (lengths without WRITE)
                          float* __restrict__ part_acc,     // [B, Hkv, splits, rep, D]
                          float* __restrict__ part_ml,      // [B, Hkv, splits, rep, 2]
                          int Hkv, int S, int window, float scale, int rep, int kps, int splits,
                          int ts, int n_tiles) {
  using T = typename Storage<QUANT>::T;
  using L = SplitSmem<D, QUANT>;
  constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(smem + L::VT);

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_hch = (rep + SPLIT_WARPS * 16 - 1) / (SPLIT_WARPS * 16);
  const int z = blockIdx.z / n_hch, hc = blockIdx.z % n_hch;
  const int bh = b * Hkv + h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, nthr = blockDim.x;
  const int g = lane >> 2, qd = lane & 3;  // mma fragment row and column pair
  const int pos = offsets[b];
  if (WRITE && (pos < 0 || pos >= S)) return;
  int kstart, kend;
  bool uniform;
  key_range<WRITE>(pos, S, window, ts, n_tiles, kstart, kend, uniform);
  const int k0 = max(kstart, z * kps), k1 = min(kend, (z + 1) * kps);
  const int h_lo = hc * SPLIT_WARPS * 16, h_hi = min(rep, h_lo + SPLIT_WARPS * 16);
  float* pml = part_ml + ((size_t)bh * splits + z) * rep * 2;
  float* pacc = part_acc + ((size_t)bh * splits + z) * rep * D;
  if (k0 >= k1) {  // no key of the row in this split: an empty partial
    for (int r = h_lo + tid; r < h_hi; r += nthr) {
      pml[2 * r] = NEG;
      pml[2 * r + 1] = 0.f;
    }
    return;
  }

  T* kc = k_cache + (size_t)bh * S * D;
  T* vc = v_cache + (size_t)bh * S * D;
  float* ksc = QUANT ? ks_cache + (size_t)bh * S : nullptr;
  float* vsc = QUANT ? vs_cache + (size_t)bh * S : nullptr;
  const T* kn = WRITE ? k_new + (size_t)bh * D : nullptr;
  const T* vn = WRITE ? v_new + (size_t)bh * D : nullptr;
  if (WRITE && hc == 0 && pos >= k0 && pos < k1) {
    for (int d = tid; d < D; d += nthr) {
      kc[(size_t)pos * D + d] = kn[d];
      vc[(size_t)pos * D + d] = vn[d];
    }
    if (QUANT && tid == 0) {
      ksc[pos] = ks_new[bh];
      vsc[pos] = vs_new[bh];
    }
  }

  const int ntl = (k1 - k0 + KT - 1) / KT;
  auto load_tile = [&](int t, int buf) {
    unsigned char* sk = smem + buf * L::BUF;
    unsigned char* sv = sk + KT * L::ROW;
    float* sks = reinterpret_cast<float*>(sv + KT * L::ROW);
    const int t0 = k0 + t * KT;
    for (int i = tid; i < KT * CPR; i += nthr) {
      const int r = i / CPR, c = i % CPR, key = t0 + r;
      const bool valid = key < k1;
      const bool fresh = WRITE && key == pos;
      const T* ksrc = fresh ? kn : kc + (size_t)(valid ? key : k0) * D;
      const T* vsrc = fresh ? vn : vc + (size_t)(valid ? key : k0) * D;
      aqlm::cp_async16(sk + r * L::ROW + c * 16, reinterpret_cast<const char*>(ksrc) + c * 16, valid);
      aqlm::cp_async16(sv + r * L::ROW + c * 16, reinterpret_cast<const char*>(vsrc) + c * 16, valid);
    }
    if constexpr (QUANT) {
      for (int i = tid; i < KT; i += nthr) {
        const int key = t0 + i;
        const bool valid = key < k1;
        const bool fresh = WRITE && key == pos;
        aqlm::cp_async4(sks + i, fresh ? ks_new + bh : ksc + (valid ? key : k0), valid);
        aqlm::cp_async4(sks + KT + i, fresh ? vs_new + bh : vsc + (valid ? key : k0), valid);
      }
    }
    aqlm::cp_async_commit();
  };
  load_tile(0, 0);
  if (ntl > 1) load_tile(1, 1);

  // this warp's 16 heads as mma A fragments (padding heads zero)
  const int r0 = h_lo + warp * 16;
  const bool has_rows = r0 < h_hi;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + 8 * (i & 1), col = kk * 16 + 2 * qd + 8 * (i >> 1);
      qa[kk][i] = row < h_hi ? *reinterpret_cast<const uint32_t*>(q + ((size_t)bh * rep + row) * D + col)
                             : 0u;
    }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;

  for (int t = 0; t < ntl; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntl) aqlm::cp_async_wait<1>();
    else aqlm::cp_async_wait<0>();
    __syncthreads();  // tile t visible to the block
    const T* sk = reinterpret_cast<const T*>(smem + buf * L::BUF);
    const T* sv = reinterpret_cast<const T*>(smem + buf * L::BUF + KT * L::ROW);
    const float* sks = reinterpret_cast<const float*>(smem + buf * L::BUF + 2 * KT * L::ROW);
    for (int i = tid; i < KT * D; i += nthr) {
      const int key = i % KT, d = i / KT;
      vt[d * L::VTLD + key] = to_bf16(sv[key * (L::ROW / (int)sizeof(T)) + d]);
    }
    __syncthreads();  // V^T ready
    if (has_rows) {
      const int t0 = k0 + t * KT;
      // scores of 16 heads x 64 keys: eight 8-key column tiles
      float s[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
        const T* krow = sk + (j * 8 + g) * (L::ROW / (int)sizeof(T)) + 2 * qd;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_bf16_16816(s[j], qa[kk], pair_bf16(krow + kk * 16), pair_bf16(krow + kk * 16 + 8));
      }
      float tmax[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = j * 8 + 2 * qd + (i & 1);
          const bool valid = t0 + col < k1;
          const float ksv = QUANT ? sks[col] : 1.f;
          s[j][i] = valid ? (uniform ? 0.f : s[j][i] * ksv * scale) : -INFINITY;
          tmax[i >> 1] = fmaxf(tmax[i >> 1], s[j][i]);
        }
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
        tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
        const float m_new = fmaxf(m[hh], tmax[hh]);
        corr[hh] = expf(m[hh] - m_new);
        m[hh] = m_new;
        l[hh] *= corr[hh];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[j][i] *= corr[i >> 1];
      // p = exp(s - m) in f32 into l; p * value scale rounded to bf16 into P V
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        float pv[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 2 * kk + jj;
            const float p = expf(s[j][i] - m[i >> 1]);
            l[i >> 1] += p;
            pv[jj][i] = QUANT ? p * sks[KT + j * 8 + 2 * qd + (i & 1)] : p;
          }
        // p as a bf16 pair hi + lo (hi = bf16(p), lo = bf16(p - hi)): two
        // products keep p to ~16 bits; p alone in bf16 missed one bf16 step
        // of the plain version on the int8 cache
        uint32_t a_hi[4], a_lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x0 = pv[i >> 1][(i & 1) * 2], x1 = pv[i >> 1][(i & 1) * 2 + 1];
          const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
          a_hi[i] = *reinterpret_cast<const uint32_t*>(&h);
          a_lo[i] = pack2(x0 - __low2float(h), x1 - __high2float(h));
        }
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const __nv_bfloat16* vrow = vt + (nd * 8 + g) * L::VTLD + kk * 16 + 2 * qd;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8);
          mma_bf16_16816(o[nd], a_hi, b0, b1);
          mma_bf16_16816(o[nd], a_lo, b0, b1);
        }
      }
    }
    __syncthreads();  // tile t's buffer and V^T free
    if (t + 2 < ntl) load_tile(t + 2, buf);
  }

  if (!has_rows) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = r0 + g + 8 * hh;
    if (row >= h_hi) continue;
    if (qd == 0) {
      pml[2 * row] = m[hh];
      pml[2 * row + 1] = l[hh];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(pacc + (size_t)row * D + nd * 8 + 2 * qd) =
          make_float2(o[nd][2 * hh], o[nd][2 * hh + 1]);
  }
}

// Merge the splits' partials of each (b, h, head, d), split 0 first.
template <int D, bool WRITE>
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                            const int* __restrict__ offsets, __nv_bfloat16* __restrict__ out,
                            int Hkv, int S, int rep, int splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int i = blockIdx.z * COMBINE_THREADS + threadIdx.x;
  if (i >= rep * D) return;
  const int bh = b * Hkv + h, r = i / D;
  __nv_bfloat16* o = out + (size_t)bh * rep * D + i;
  if (WRITE) {
    const int pos = offsets[b];
    if (pos < 0 || pos >= S) {
      *o = __float2bfloat16(NAN);  // no row written: the fault shows
      return;
    }
  }
  const float* ml = part_ml + (size_t)bh * splits * rep * 2 + 2 * r;
  const float* acc = part_acc + (size_t)bh * splits * rep * D + i;
  float mx = NEG;
  for (int zz = 0; zz < splits; ++zz)
    if (ml[(size_t)zz * rep * 2 + 1] > 0.f) mx = fmaxf(mx, ml[(size_t)zz * rep * 2]);
  float num = 0.f, den = 0.f;
  for (int zz = 0; zz < splits; ++zz) {
    const float lz = ml[(size_t)zz * rep * 2 + 1];
    if (lz > 0.f) {
      const float c = expf(ml[(size_t)zz * rep * 2] - mx);
      num += c * acc[(size_t)zz * rep * D];
      den += c * lz;
    }
  }
  *o = __float2bfloat16(num / fmaxf(den, 1e-30f));
}

template <int D, bool QUANT, bool WRITE>
cudaError_t launch_split(const void* q, const void* kn, const void* vn, const void* ksn,
                         const void* vsn, void* kc, void* vc, void* ksc, void* vsc,
                         const void* offsets, void* out, void* part_acc, void* part_ml, int B,
                         int Hkv, int S, int window, float scale, int rep, int kps, int ts,
                         int n_tiles, cudaStream_t st) {
  using T = typename Storage<QUANT>::T;
  constexpr int smem = SplitSmem<D, QUANT>::TOTAL;
  if (kps < KT || kps % KT || !part_acc || !part_ml) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(flash_decode_split_kernel<D, QUANT, WRITE>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
  }
  const int splits = (S + kps - 1) / kps;
  const int n_hch = (rep + SPLIT_WARPS * 16 - 1) / (SPLIT_WARPS * 16);
  const int warps = min(SPLIT_WARPS, (rep + 15) / 16);
  flash_decode_split_kernel<D, QUANT, WRITE><<<dim3(Hkv, B, splits * n_hch), warps * 32, smem, st>>>(
      (const __nv_bfloat16*)q, (const T*)kn, (const T*)vn, (const float*)ksn, (const float*)vsn,
      (T*)kc, (T*)vc, (float*)ksc, (float*)vsc, (const int*)offsets, (float*)part_acc,
      (float*)part_ml, Hkv, S, window, scale, rep, kps, splits, ts, n_tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_decode_combine_kernel<D, WRITE>
      <<<dim3(Hkv, B, (rep * D + COMBINE_THREADS - 1) / COMBINE_THREADS), COMBINE_THREADS, 0, st>>>(
          (const float*)part_acc, (const float*)part_ml, (const int*)offsets,
          (__nv_bfloat16*)out, Hkv, S, rep, splits);
  return cudaGetLastError();
}

template <int D, int REP>
cudaError_t launch_dr(bool quant, const void* q, const void* kn, const void* vn, const void* ksn,
                      const void* vsn, void* kc, void* vc, void* ksc, void* vsc,
                      const void* offsets, void* out, int B, int Hkv, int S, int window,
                      float scale, cudaStream_t st) {
  const dim3 grid(Hkv, B);
  if (quant)
    flash_decode_write_kernel<D, REP, true><<<grid, NWARP * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const int8_t*)kn, (const int8_t*)vn, (const float*)ksn,
        (const float*)vsn, (int8_t*)kc, (int8_t*)vc, (float*)ksc, (float*)vsc,
        (const int*)offsets, (__nv_bfloat16*)out, Hkv, S, window, scale);
  else
    flash_decode_write_kernel<D, REP, false><<<grid, NWARP * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)kn, (const __nv_bfloat16*)vn, nullptr,
        nullptr, (__nv_bfloat16*)kc, (__nv_bfloat16*)vc, nullptr, nullptr, (const int*)offsets,
        (__nv_bfloat16*)out, Hkv, S, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int rep, bool quant, const void* q, const void* kn, const void* vn,
                     const void* ksn, const void* vsn, void* kc, void* vc, void* ksc, void* vsc,
                     const void* offsets, void* out, void* part_acc, void* part_ml, int B,
                     int Hkv, int S, int window, float scale, int kps, cudaStream_t st) {
  switch (rep) {
    case 1: return launch_dr<D, 1>(quant, q, kn, vn, ksn, vsn, kc, vc, ksc, vsc, offsets, out, B, Hkv, S, window, scale, st);
    case 2: return launch_dr<D, 2>(quant, q, kn, vn, ksn, vsn, kc, vc, ksc, vsc, offsets, out, B, Hkv, S, window, scale, st);
    case 4: return launch_dr<D, 4>(quant, q, kn, vn, ksn, vsn, kc, vc, ksc, vsc, offsets, out, B, Hkv, S, window, scale, st);
    case 8: return launch_dr<D, 8>(quant, q, kn, vn, ksn, vsn, kc, vc, ksc, vsc, offsets, out, B, Hkv, S, window, scale, st);
    default:  // any other count: split-KV on the tensor cores
      if (rep < 1) return cudaErrorInvalidValue;
      if (quant)
        return launch_split<D, true, true>(q, kn, vn, ksn, vsn, kc, vc, ksc, vsc, offsets, out,
                                           part_acc, part_ml, B, Hkv, S, window, scale, rep, kps,
                                           0, 0, st);
      return launch_split<D, false, true>(q, kn, vn, nullptr, nullptr, kc, vc, nullptr, nullptr,
                                          offsets, out, part_acc, part_ml, B, Hkv, S, window,
                                          scale, rep, kps, 0, 0, st);
  }
}

// B6: the same instances without the row write.
template <int D, int REP, bool QUANT>
cudaError_t launch_read(const void* q, void* kc, void* vc, void* ksc, void* vsc,
                        const void* lengths, void* out, void* part_acc, void* part_ml, int B,
                        int Hkv, int S, int window, float scale, int ts, int n_tiles, int rep,
                        int kps, cudaStream_t st) {
  using T = typename Storage<QUANT>::T;
  if constexpr (REP == 0) {  // split-KV on the tensor cores
    return launch_split<D, QUANT, false>(q, nullptr, nullptr, nullptr, nullptr, kc, vc, ksc, vsc,
                                         lengths, out, part_acc, part_ml, B, Hkv, S, window,
                                         scale, rep, kps, ts, n_tiles, st);
  } else {
    flash_decode_kernel<D, REP, QUANT><<<dim3(Hkv, B), NWARP * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (T*)kc, (T*)vc, (float*)ksc, (float*)vsc, (const int*)lengths,
        (__nv_bfloat16*)out, Hkv, S, window, scale, ts, n_tiles);
  }
  return cudaGetLastError();
}

template <int D, bool QUANT>
cudaError_t launch_read_d(int rep, const void* q, void* kc, void* vc, void* ksc, void* vsc,
                          const void* lengths, void* out, void* part_acc, void* part_ml, int B,
                          int Hkv, int S, int window, float scale, int ts, int n_tiles, int kps,
                          cudaStream_t st) {
#define AQLM_FD_READ(R)                                                                        \
  launch_read<D, R, QUANT>(q, kc, vc, ksc, vsc, lengths, out, part_acc, part_ml, B, Hkv, S, \
                           window, scale, ts, n_tiles, rep, kps, st)
  switch (rep) {
    case 1: return AQLM_FD_READ(1);
    case 2: return AQLM_FD_READ(2);
    case 4: return AQLM_FD_READ(4);
    case 8: return AQLM_FD_READ(8);
    default:
      if (rep < 1) return cudaErrorInvalidValue;
      return AQLM_FD_READ(0);
  }
#undef AQLM_FD_READ
}

}  // namespace

// window <= 0 means no sliding window. At a head count other than 1/2/4/8
// per kv head the split-KV kernels run: kps keys a split (a multiple of 64),
// partials part_acc [B, Hkv, ceil(S / kps), rep, D] and part_ml [..., rep, 2]
// f32 (the other instances ignore the three).
extern "C" int flash_decode_write_launch(const void* q, const void* k_new, const void* v_new,
                                         const void* ks_new, const void* vs_new, void* k_cache,
                                         void* v_cache, void* ks_cache, void* vs_cache,
                                         const void* offsets, void* out, void* part_acc,
                                         void* part_ml, int B, int Hkv, int S, int D, int rep,
                                         int quant, int window, int kps, float scale,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch_d<128>(rep, quant != 0, q, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                         ks_cache, vs_cache, offsets, out, part_acc, part_ml, B, Hkv, S, window,
                         scale, kps, st);
  if (D == 64)
    return launch_d<64>(rep, quant != 0, q, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                        ks_cache, vs_cache, offsets, out, part_acc, part_ml, B, Hkv, S, window,
                        scale, kps, st);
  return cudaErrorInvalidValue;
}

// B6: flash decode over one layer of the cache as it is, keys below
// lengths[b] (within the window when window > 0); ts and n_tiles are the TPU
// grid's tile length and visited tile count, which decide the result of a
// row with no key in range (see key_range); kps and the partials as above.
extern "C" int flash_decode_launch(const void* q, void* k_cache, void* v_cache, void* ks_cache,
                                   void* vs_cache, const void* lengths, void* out, void* part_acc,
                                   void* part_ml, int B, int Hkv, int S, int D, int rep,
                                   int quant, int window, int ts, int n_tiles, int kps,
                                   float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ts < 1 || n_tiles < 1) return cudaErrorInvalidValue;
#define AQLM_FD_READ_D(DD, Q)                                                                  \
  return launch_read_d<DD, Q>(rep, q, k_cache, v_cache, ks_cache, vs_cache, lengths, out,       \
                              part_acc, part_ml, B, Hkv, S, window, scale, ts, n_tiles, kps, st)
  if (D == 128) {
    if (quant) AQLM_FD_READ_D(128, true);
    AQLM_FD_READ_D(128, false);
  }
  if (D == 64) {
    if (quant) AQLM_FD_READ_D(64, true);
    AQLM_FD_READ_D(64, false);
  }
#undef AQLM_FD_READ_D
  return cudaErrorInvalidValue;
}
