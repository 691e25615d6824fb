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
// static accumulators and ~280 registers a thread) split into chunks of 8
// on a third grid axis, the ragged last chunk masked: (Hkv, B, ceil(rep/8))
// blocks. Several blocks then share one (b, h), so the write-then-sync trick
// no longer makes the new row visible to all of them: every block takes the
// key and value at `offset` (and their scales) from k_new/v_new, in
// register, as the TPU kernel does (flash_decode.py:222-234), and only
// chunk 0 writes the row to the cache; no block reads that cache row. That
// path is a kernel of its own (flash_decode_write_chunked_kernel): folded
// into the single-block template, it moved the instances' registers.
// Splitting one row's keys across blocks (split-KV) is later work.
//
// B6, flash decode without the row write, replaces the TPU kernels
// flash_decode_attention (_call, pallas_call at :152) and
// flash_decode_attention_indexed (_call_idx, :656): the same two loops,
// instanced without WRITE (flash_decode_kernel, flash_decode_chunked_kernel).
// They take each row's length in place of offset + 1, read every key from
// the cache, and at a length of 0 return what the TPU grid returns there,
// the mean of V over the tiles it visits (key_range). The loops are shared
// __device__ bodies under a WRITE flag, so K3's kernels keep their names,
// signatures and code.
#include "common.cuh"

namespace {

constexpr int NWARP = 8;
constexpr int CHUNK_HEADS = 8;  // query heads per block of the chunked kernel
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

// More query heads per kv head than one block holds: chunk blockIdx.z of
// CH heads out of the group's rep, the ragged last chunk masked. The same
// loop as above, except that with WRITE every block takes the new row (and
// its scales) at `offset` from k_new/v_new in register, and only chunk 0
// writes it to the cache: no block reads that cache row.
template <int D, bool QUANT, bool WRITE>
__device__ __forceinline__ void
flash_decode_chunked_body(const __nv_bfloat16* __restrict__ q,  // [B, Hkv, rep, D]
                          const typename Storage<QUANT>::T* __restrict__ k_new,
                          const typename Storage<QUANT>::T* __restrict__ v_new,
                          const float* __restrict__ ks_new,
                          const float* __restrict__ vs_new,
                          typename Storage<QUANT>::T* k_cache,
                          typename Storage<QUANT>::T* v_cache,
                          float* ks_cache,
                          float* vs_cache,
                          const int* __restrict__ offsets,  // [B] (lengths without WRITE)
                          __nv_bfloat16* __restrict__ out,      // [B, Hkv, rep, D]
                          int Hkv, int S, int window, float scale, int rep, int ts, int n_tiles) {
  using T = typename Storage<QUANT>::T;
  constexpr int EPL = D / 32;
  constexpr int CH = CHUNK_HEADS;
  __shared__ float s_q[CH][D];
  __shared__ float s_m[NWARP][CH], s_l[NWARP][CH];
  __shared__ float s_acc[NWARP][CH][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int bh = b * Hkv + h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int offset = offsets[b];
  const int r0 = blockIdx.z * CH;
  const int nrep = min(CH, rep - r0);
  const size_t qo = ((size_t)bh * rep + r0) * D;  // q and out offset of this chunk's first head
  if (WRITE && (offset < 0 || offset >= S)) {
    for (int i = tid; i < nrep * D; i += blockDim.x) out[qo + i] = __float2bfloat16(NAN);
    return;
  }
  int kstart, len;
  bool uniform;
  key_range<WRITE>(offset, S, window, ts, n_tiles, kstart, len, uniform);

  T* kc = k_cache + (size_t)bh * S * D;
  T* vc = v_cache + (size_t)bh * S * D;
  float* ksc = QUANT ? ks_cache + (size_t)bh * S : nullptr;
  float* vsc = QUANT ? vs_cache + (size_t)bh * S : nullptr;
  const T* kn = WRITE ? k_new + (size_t)bh * D : nullptr;
  const T* vn = WRITE ? v_new + (size_t)bh * D : nullptr;

  if (WRITE && blockIdx.z == 0) {
    for (int d = tid; d < D; d += blockDim.x) {
      kc[(size_t)offset * D + d] = kn[d];
      vc[(size_t)offset * D + d] = vn[d];
    }
    if (QUANT && tid == 0) {
      ksc[offset] = ks_new[bh];
      vsc[offset] = vs_new[bh];
    }
  }
  for (int i = tid; i < CH * D; i += blockDim.x)
    s_q[i / D][i % D] = i < nrep * D ? __bfloat162float(q[qo + i]) : 0.f;
  __syncthreads();

  float m[CH], l[CH], acc[CH][EPL];
#pragma unroll
  for (int r = 0; r < CH; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  for (int t0 = kstart + warp * 32; t0 < len; t0 += NWARP * 32) {
    const int key = t0 + lane;
    const bool valid = key < len;
    float logit[CH];
    float ksc_v = 1.f;
#pragma unroll
    for (int r = 0; r < CH; ++r) logit[r] = 0.f;
    if (valid) {
      const T* kr = (WRITE && key == offset) ? kn : kc + (size_t)key * D;
      constexpr int NE = 16 / (int)sizeof(T);  // elements per 16-byte load
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += NE) {
        float f[16];
        unpack16(kr + d0, f);
#pragma unroll
        for (int r = 0; r < CH; ++r)
#pragma unroll
          for (int j = 0; j < NE; ++j) logit[r] = fmaf(s_q[r][d0 + j], f[j], logit[r]);
      }
      if (QUANT) ksc_v = (WRITE && key == offset) ? ks_new[bh] : ksc[key];
    }
    float p[CH];
#pragma unroll
    for (int r = 0; r < CH; ++r) {
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
    const float vsc_lane =
        (QUANT && valid) ? ((WRITE && key == offset) ? vs_new[bh] : vsc[key]) : 1.f;
    const int nvalid = min(32, len - t0);
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += 8) {
      if (j0 >= nvalid) break;
      float v[8][EPL];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int row = t0 + j0 + u;
        if (j0 + u < nvalid) {
          load_v<EPL>(((WRITE && row == offset) ? vn : vc + (size_t)row * D) + lane * EPL, v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) v[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float vs = __shfl_sync(0xffffffffu, vsc_lane, j0 + u);
#pragma unroll
        for (int r = 0; r < CH; ++r) {
          const float pj = __shfl_sync(0xffffffffu, p[r], j0 + u) * vs;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pj, v[u][e], acc[r][e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < CH; ++r) {
    if (lane == 0) {
      s_m[warp][r] = m[r];
      s_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[warp][r][lane * EPL + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = tid; i < nrep * D; i += blockDim.x) {
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
    out[qo + i] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(NWARP * 32)
flash_decode_write_chunked_kernel(const __nv_bfloat16* __restrict__ q,
                                  const typename Storage<QUANT>::T* __restrict__ k_new,
                                  const typename Storage<QUANT>::T* __restrict__ v_new,
                                  const float* __restrict__ ks_new,
                                  const float* __restrict__ vs_new,
                                  typename Storage<QUANT>::T* k_cache,
                                  typename Storage<QUANT>::T* v_cache, float* ks_cache,
                                  float* vs_cache, const int* __restrict__ offsets,
                                  __nv_bfloat16* __restrict__ out, int Hkv, int S, int window,
                                  float scale, int rep) {
  flash_decode_chunked_body<D, QUANT, true>(q, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                                            ks_cache, vs_cache, offsets, out, Hkv, S, window,
                                            scale, rep, 0, 0);
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(NWARP * 32)
flash_decode_chunked_kernel(const __nv_bfloat16* __restrict__ q,
                            typename Storage<QUANT>::T* k_cache,
                            typename Storage<QUANT>::T* v_cache, float* ks_cache,
                            float* vs_cache, const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ out, int Hkv, int S, int window,
                            float scale, int rep, int ts, int n_tiles) {
  flash_decode_chunked_body<D, QUANT, false>(q, nullptr, nullptr, nullptr, nullptr, k_cache,
                                             v_cache, ks_cache, vs_cache, lengths, out, Hkv, S,
                                             window, scale, rep, ts, n_tiles);
}

template <int D>
cudaError_t launch_chunked(int rep, bool quant, const void* q, const void* kn, const void* vn,
                           const void* ksn, const void* vsn, void* kc, void* vc, void* ksc,
                           void* vsc, const void* offsets, void* out, int B, int Hkv, int S,
                           int window, float scale, cudaStream_t st) {
  const dim3 grid(Hkv, B, (rep + CHUNK_HEADS - 1) / CHUNK_HEADS);
  if (quant)
    flash_decode_write_chunked_kernel<D, true><<<grid, NWARP * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const int8_t*)kn, (const int8_t*)vn, (const float*)ksn,
        (const float*)vsn, (int8_t*)kc, (int8_t*)vc, (float*)ksc, (float*)vsc,
        (const int*)offsets, (__nv_bfloat16*)out, Hkv, S, window, scale, rep);
  else
    flash_decode_write_chunked_kernel<D, false><<<grid, NWARP * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)kn, (const __nv_bfloat16*)vn, nullptr,
        nullptr, (__nv_bfloat16*)kc, (__nv_bfloat16*)vc, nullptr, nullptr, (const int*)offsets,
        (__nv_bfloat16*)out, Hkv, S, window, scale, rep);
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
                     const void* offsets, void* out, int B, int Hkv, int S, int window,
                     float scale, cudaStream_t st) {
  switch (rep) {
    case 1: return launch_dr<D, 1>(quant, q, kn, vn, ksn, vsn, kc, vc, ksc, vsc, offsets, out, B, Hkv, S, window, scale, st);
    case 2: return launch_dr<D, 2>(quant, q, kn, vn, ksn, vsn, kc, vc, ksc, vsc, offsets, out, B, Hkv, S, window, scale, st);
    case 4: return launch_dr<D, 4>(quant, q, kn, vn, ksn, vsn, kc, vc, ksc, vsc, offsets, out, B, Hkv, S, window, scale, st);
    case 8: return launch_dr<D, 8>(quant, q, kn, vn, ksn, vsn, kc, vc, ksc, vsc, offsets, out, B, Hkv, S, window, scale, st);
    default:  // any other count: chunks of CHUNK_HEADS query heads
      if (rep < 1) return cudaErrorInvalidValue;
      return launch_chunked<D>(rep, quant, q, kn, vn, ksn, vsn, kc, vc, ksc, vsc, offsets, out, B, Hkv, S, window, scale, st);
  }
}

// B6: the same instances without the row write.
template <int D, int REP, bool QUANT>
cudaError_t launch_read(const void* q, void* kc, void* vc, void* ksc, void* vsc,
                        const void* lengths, void* out, int B, int Hkv, int S, int window,
                        float scale, int ts, int n_tiles, int rep, cudaStream_t st) {
  using T = typename Storage<QUANT>::T;
  if constexpr (REP == 0) {  // chunks of CHUNK_HEADS query heads
    const dim3 grid(Hkv, B, (rep + CHUNK_HEADS - 1) / CHUNK_HEADS);
    flash_decode_chunked_kernel<D, QUANT><<<grid, NWARP * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (T*)kc, (T*)vc, (float*)ksc, (float*)vsc, (const int*)lengths,
        (__nv_bfloat16*)out, Hkv, S, window, scale, rep, ts, n_tiles);
  } else {
    flash_decode_kernel<D, REP, QUANT><<<dim3(Hkv, B), NWARP * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (T*)kc, (T*)vc, (float*)ksc, (float*)vsc, (const int*)lengths,
        (__nv_bfloat16*)out, Hkv, S, window, scale, ts, n_tiles);
  }
  return cudaGetLastError();
}

template <int D, bool QUANT>
cudaError_t launch_read_d(int rep, const void* q, void* kc, void* vc, void* ksc, void* vsc,
                          const void* lengths, void* out, int B, int Hkv, int S, int window,
                          float scale, int ts, int n_tiles, cudaStream_t st) {
#define AQLM_FD_READ(R) \
  launch_read<D, R, QUANT>(q, kc, vc, ksc, vsc, lengths, out, B, Hkv, S, window, scale, ts, n_tiles, rep, st)
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

// window <= 0 means no sliding window.
extern "C" int flash_decode_write_launch(const void* q, const void* k_new, const void* v_new,
                                         const void* ks_new, const void* vs_new, void* k_cache,
                                         void* v_cache, void* ks_cache, void* vs_cache,
                                         const void* offsets, void* out, int B, int Hkv, int S,
                                         int D, int rep, int quant, int window, float scale,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch_d<128>(rep, quant != 0, q, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                         ks_cache, vs_cache, offsets, out, B, Hkv, S, window, scale, st);
  if (D == 64)
    return launch_d<64>(rep, quant != 0, q, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                        ks_cache, vs_cache, offsets, out, B, Hkv, S, window, scale, st);
  return cudaErrorInvalidValue;
}

// B6: flash decode over one layer of the cache as it is, keys below
// lengths[b] (within the window when window > 0); ts and n_tiles are the TPU
// grid's tile length and visited tile count, which decide the result of a
// row with no key in range (see key_range).
extern "C" int flash_decode_launch(const void* q, void* k_cache, void* v_cache, void* ks_cache,
                                   void* vs_cache, const void* lengths, void* out, int B, int Hkv,
                                   int S, int D, int rep, int quant, int window, int ts,
                                   int n_tiles, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ts < 1 || n_tiles < 1) return cudaErrorInvalidValue;
#define AQLM_FD_READ_D(DD, Q)                                                                  \
  return launch_read_d<DD, Q>(rep, q, k_cache, v_cache, ks_cache, vs_cache, lengths, out, B, Hkv, \
                              S, window, scale, ts, n_tiles, st)
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
