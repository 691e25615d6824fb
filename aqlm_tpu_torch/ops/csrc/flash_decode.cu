// K3: fused KV-row write + single-token GQA flash-decode attention over one
// layer of the stacked head-major cache, int8 (with f32 per-row scales) or
// bf16.
//
// Replaces the TPU kernel aqlm_tpu/ops/flash_decode.py:
// flash_decode_write_attention_indexed (_call_idx_wattn, pallas_call at :358).
// The layer index is a pointer offset applied by the caller.
//
// For every (row b, kv head h): write the new key/value row (and its scales)
// at offsets[b], in place; then attend the rep query heads of the group to
// the keys in [max(0, len - window), len), len = offsets[b] + 1, with the
// same length mask and sliding window as the TPU kernel
// (flash_decode.py:32-38, :65-79), in f32 (m, l and accumulators).
//
// What bounds it on an H100: the cache bytes of the valid keys, read once:
// 2 * (D + 4) bytes per key per kv head for int8 (2 * 2D for bf16); the
// arithmetic, 4*rep*D FLOP per key, is far below the card's ridge. Unlike
// the TPU grid, which visits every tile up to max_len, the kernel reads only
// keys below the row's length.
//
// 1, 2, 4 or 8 query heads per kv head (Llama-2-7B: 1 over 32 kv heads;
// Mixtral-8x7B: 4 over 8): flash_decode_rows_kernel. The first design, one
// block per (b, h) walking its row's keys in series, left most SMs idle (32
// blocks at Mixtral's B=4; the row at offset 1999 streamed by one SM) and
// reached 17% of the byte bound. Here each row's keys are cut into splits of
// kps keys (64, 128 or 256; flash-decoding) counted from the row's first
// key, gridded with the kv heads and the rows. The plan
// (flash_decode.row_plan) depends only on what the host knows (B, Hkv, rep,
// D, max_len, the window, the SM count); the offsets stay on the device: a
// block whose split lies past its row's keys exits at once, and a window
// of at most kps keys is one split, so its rows need no merge. Within a
// block each warp takes the split's 16-key tiles w, w + 8, ... on its own:
//   - loads: lane 0 issues bulk copies of the warp's K and V rows (one a
//     tile, each completing on the warp's barrier), the lanes cp.async the
//     two f32 scale planes;
//   - scores: mma.sync m16n8k16 with the keys as the 16-row operand and the
//     rep heads (padded to 8) as the 8 columns (an int8 key is exact in
//     bf16). A thread's 16-byte chunk of a row is its A values of four
//     (int8) or two (bf16) k-steps, the query's B fragments permuted to
//     match (the dot product does not care which dims meet in which k
//     slot);
//   - softmax: the warp's max of each head (shuffles), p = exp(s - max)
//     times the key's value scale into the warp's p buffer, the exp sums;
//   - values: the lanes take the dims, p broadcast from shared memory into
//     f32 FMAs (an int8 value widened by a byte permute and an add).
// The warps meet once, at the end: their sums, each weighted by exp(its max
// - the split's), are added in warp order. A row held by one split writes
// its output at once. Otherwise each split writes (m, l, acc) to f32
// partials and the row's last split to finish (an atomic ticket, released
// and acquired, which it resets to zero for the next launch) merges them in
// split order, as flash_decode.merge_partials defines, so the result does not
// change from run to run: one launch, no memset, no host sync. The split
// holding offsets[b] writes the new row (and its scales) to the cache and
// takes it from k_new/v_new; no block reads that cache row. A row whose
// offset lies outside [0, S) writes nothing and returns NaN.
//
// Other head counts per kv head (Falcon-7B: 71 over one kv head; a block
// per (b, h, split) would need ~145 KB of accumulators for all its heads on
// the CUDA cores) run split-KV with every head of the group in 16-row mma
// tiles (flash_decode_split_kernel, then flash_decode_combine_kernel). The
// work there is small (Falcon at B=4 and offsets 0/511/512/1999: ~145 MFLOP,
// ~0.4 MB), so latency and the count of busy SMs bound it, not bytes: the
// keys of a row are cut into splits of 64-256 (gridded with the kv heads and
// rows: 128 blocks at Falcon's shape), each block takes every query head of
// its (b, h) (up to 128, in 16-row mma tiles), so each K/V row is read once
// per row, and the two products run as mma.sync m16n8k16. Every block takes
// the new row at `offset` from k_new/v_new; the split holding it writes it.
//
// B6, flash decode without the row write, replaces the TPU kernels
// flash_decode_attention (_call, pallas_call at :152) and
// flash_decode_attention_indexed (_call_idx, :656): the same kernels
// instanced without WRITE. They take each row's length in place of
// offset + 1, read every key from the cache, and at a length of 0 return
// what the TPU grid returns there, the mean of V over the tiles it visits
// (key_range), split like any other range.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;

template <bool QUANT>
struct Storage;
template <>
struct Storage<true> { using T = int8_t; };
template <>
struct Storage<false> { using T = __nv_bfloat16; };

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
// ---------------------------------------------------------------------------
// 1, 2, 4 or 8 query heads per kv head: a row's keys split over blocks
// ---------------------------------------------------------------------------

constexpr int RS_WARPS = 8;
constexpr int RS_THREADS = RS_WARPS * 32;
constexpr int RS_MAX_KPS = 256;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use on an H100

// Splits a row of the grid holds: every split of the cache, or, where `span`
// (the most keys a row attends) is shorter, the splits a run of `span` keys
// takes, counted from its first key. flash_decode.row_splits computes the
// same.
__host__ __device__ inline int row_splits(int S, int kps, int span) {
  const int full = (S + kps - 1) / kps;
  if (span <= 0 || span >= S) return full;
  return min(full, (span + kps - 1) / kps);
}

// Byte offsets of a block's dynamic shared memory, a split of kps keys:
// region 0 holds the K rows, the V rows and the two f32 scale planes, and,
// once every warp's products are done, the warps' sums [8][REP][D] f32;
// then each warp's p [8][REP][16 mtw + 4] f32 (mtw: the 16-key tiles a warp
// takes), the warps' max and exp sum of each head [2][8][8], the heads' max
// and denominator [2][8]; the row's splits' (m, l), later their merge
// weights, [splits][8][2]; each warp's two barriers (its K and V bulk
// copies); the last-split flag. flash_decode.row_smem computes the same
// total, and a launch whose total differs is refused.
struct RowLayout {
  int kps, row, rep, d, splits, mtw;
  bool quant;
  __host__ __device__ RowLayout(int kps_, int d_, int rep_, bool quant_, int splits_)
      : kps(kps_), row(d_ * (quant_ ? 1 : 2)), rep(rep_), d(d_), splits(splits_),
        mtw((kps_ / 16 + RS_WARPS - 1) / RS_WARPS), quant(quant_) {}
  __host__ __device__ int v() const { return kps * row; }
  __host__ __device__ int ks() const { return 2 * kps * row; }
  __host__ __device__ int vs() const { return ks() + kps * 4; }
  __host__ __device__ int p() const {
    const int kv = 2 * kps * row + (quant ? 8 * kps : 0), red = RS_WARPS * rep * d * 4;
    return kv > red ? kv : red;
  }
  __host__ __device__ int pstride() const { return 16 * mtw + 4; }  // floats of a head's p row
  __host__ __device__ int stats() const { return p() + RS_WARPS * rep * pstride() * 4; }
  __host__ __device__ int mz() const { return stats() + (2 * 64 + 2 * 8) * 4; }
  __host__ __device__ int bars() const { return mz() + splits * 8 * 2 * 4; }
  __host__ __device__ int flag() const { return bars() + RS_WARPS * 2 * 8; }
  __host__ __device__ int total() const { return flag() + 16; }
};

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// atomicAdd at gpu scope with release (this block's stores, ordered before
// it by a barrier, are visible to whoever acquires the value it writes) and
// acquire (the stores released by earlier adds are visible after it).
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// EPL (2 or 4) consecutive elements of a value row in shared memory -> f32.
// An int8 b: with u = b + 128 (the sign bit flipped), the f32 with bits
// 0x4B0000uu is 2^23 + u, so subtracting 2^23 + 128 gives b exactly (a byte
// permute and an add an element).
template <int EPL>
__device__ __forceinline__ void v_elems(const int8_t* p, float* f) {
  const uint32_t w = (EPL == 4 ? *reinterpret_cast<const uint32_t*>(p)
                               : (uint32_t)*reinterpret_cast<const unsigned short*>(p)) ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    f[e] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | e)) - 8388736.f;
}
template <int EPL>
__device__ __forceinline__ void v_elems(const __nv_bfloat16* p, float* f) {
  if (EPL == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    aqlm::bf16x2_to_float(w.x, f[0], f[1]);
    aqlm::bf16x2_to_float(w.y, f[2], f[3]);
  } else {
    aqlm::bf16x2_to_float(*reinterpret_cast<const uint32_t*>(p), f[0], f[1]);
  }
}

// Block (h, b, z): keys [kstart + z kps, kstart + (z + 1) kps) of row b's
// range for kv head h. WRITE (K3) writes the new row at offsets[b] (the
// split holding it); without it (B6) `offsets` holds the rows' lengths and
// the cache is only read. Warp w takes the 16-key tiles w, w + 8, ... of the
// split on its own (its rows' loads, scores, softmax and p V); the warps meet
// once, at the end.
template <int D, int REP, bool QUANT, bool WRITE>
__global__ void __launch_bounds__(RS_THREADS)
flash_decode_rows_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Hkv, REP, D]
                         const typename Storage<QUANT>::T* __restrict__ k_new,  // [B, Hkv, D]
                         const typename Storage<QUANT>::T* __restrict__ v_new,
                         const float* __restrict__ ks_new,  // [B, Hkv] (int8 only)
                         const float* __restrict__ vs_new,
                         typename Storage<QUANT>::T* k_cache,  // [B, Hkv, S, D] one layer
                         typename Storage<QUANT>::T* v_cache,
                         float* ks_cache,  // [B, Hkv, S] one layer
                         float* vs_cache,
                         const int* __restrict__ offsets,  // [B] (lengths without WRITE)
                         __nv_bfloat16* __restrict__ out,  // [B, Hkv, REP, D]
                         float* __restrict__ part_acc,     // [B, Hkv, splits, REP, D]
                         float* __restrict__ part_ml,      // [B, Hkv, splits, REP, 2]
                         int* __restrict__ tickets,        // [B * Hkv], zero between launches
                         int Hkv, int S, int window, float scale, int kps, int ts, int n_tiles) {
  using T = typename Storage<QUANT>::T;
  constexpr int ROW = D * (int)sizeof(T);  // bytes of a key row
  constexpr int CPR = ROW / 16;            // 16-byte chunks a row: 4, 8 or 16
  constexpr int EPC = 16 / (int)sizeof(T);  // elements a chunk
  constexpr int EPL = D / 32;               // value elements a lane
  constexpr int MTW = RS_MAX_KPS / 16 / RS_WARPS;  // the most 16-key tiles a warp takes
  extern __shared__ __align__(16) unsigned char smem[];
  const RowLayout Lo(kps, D, REP, QUANT, gridDim.z);
  unsigned char* sk = smem;
  unsigned char* sv = smem + Lo.v();
  float* sks = reinterpret_cast<float*>(smem + Lo.ks());
  float* svs = reinterpret_cast<float*>(smem + Lo.vs());
  const int pst = Lo.pstride();
  float* wm = reinterpret_cast<float*>(smem + Lo.stats());  // [8 warps][8 heads]
  float* wl = wm + 64;                                       // [8 warps][8 heads]
  float* hmax = wl + 64;                                     // [8 heads]
  float* hden = hmax + 8;                                    // [8 heads]
  float* smz = reinterpret_cast<float*>(smem + Lo.mz());     // [splits][8 heads][2]
  int* s_last = reinterpret_cast<int*>(smem + Lo.flag());

  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int bh = b * Hkv + h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment row and column pair
  float* pw = reinterpret_cast<float*>(smem + Lo.p()) + warp * REP * pst;  // this warp's p [REP][pst]
  const int pos = offsets[b];
  __nv_bfloat16* o = out + (size_t)bh * REP * D;
  if (WRITE && (pos < 0 || pos >= S)) {
    // no row to write inside the cache: touch nothing, and make the row's
    // output NaN so the fault shows instead of corrupting device memory
    if (z == 0)
      for (int i = tid; i < REP * D; i += RS_THREADS) o[i] = __float2bfloat16(NAN);
    return;
  }
  int kstart, kend;
  bool uniform;
  key_range<WRITE>(pos, S, window, ts, n_tiles, kstart, kend, uniform);
  const int k0 = kstart + z * kps, k1 = min(kend, k0 + kps);
  if (k0 >= k1) return;  // no key of the row in this split
  const int n_act = (kend - kstart + kps - 1) / kps;  // the row's splits that hold keys
  const int nk = k1 - k0, n_mt = (nk + 15) / 16;
  // the query's B fragments, in flight with the rows: head gid (zero past
  // REP), the dims that thread tig's chunk (tig + 4 i) of a K row holds at
  // sub-step u
  uint32_t qf[CPR / 4][EPC / 4][2];
#pragma unroll
  for (int i = 0; i < CPR / 4; ++i)
#pragma unroll
    for (int u = 0; u < EPC / 4; ++u) {
      const int dim = (tig + 4 * i) * EPC + 4 * u;
      const uint2 w = gid < REP
                          ? *reinterpret_cast<const uint2*>(q + ((size_t)bh * REP + gid) * D + dim)
                          : make_uint2(0, 0);
      qf[i][u][0] = w.x;
      qf[i][u][1] = w.y;
    }

  T* kc = k_cache + (size_t)bh * S * D;
  T* vc = v_cache + (size_t)bh * S * D;
  float* ksc = QUANT ? ks_cache + (size_t)bh * S : nullptr;
  float* vsc = QUANT ? vs_cache + (size_t)bh * S : nullptr;
  const int rf = WRITE ? pos - k0 : -1;  // the new row's place in the split
  const int my_mt = warp < n_mt ? (n_mt - warp + RS_WARPS - 1) / RS_WARPS : 0;

  // 1. this warp's rows into shared memory, all in flight at once: its K
  // rows and its V rows by bulk copies (one a 16-key tile, lane 0 issuing,
  // each completing on its barrier), both scale planes by the lanes'
  // cp.async (zero past the split). V rows past the split up to a 16-key
  // tile are zeroed (their p is 0, and 0 times a stale NaN is not). The new
  // row replaces its stale copy once the bulk copies land, and its warp
  // writes it to the cache.
  uint64_t* kbar = reinterpret_cast<uint64_t*>(smem + Lo.bars()) + 2 * warp;
  uint64_t* vbar = kbar + 1;
  if (lane == 0) {
    aqlm::mbar_init(kbar, 1);
    aqlm::mbar_init(vbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    int bytes = 0;
    for (int j = 0; j < my_mt; ++j) bytes += min(16, nk - (warp + RS_WARPS * j) * 16) * ROW;
    aqlm::mbar_arrive_expect_tx(kbar, bytes);
    for (int j = 0; j < my_mt; ++j) {
      const int r = (warp + RS_WARPS * j) * 16, n = min(16, nk - r) * ROW;
      aqlm::bulk_copy(sk + r * ROW, kc + (size_t)(k0 + r) * D, n, kbar);
    }
    aqlm::mbar_arrive_expect_tx(vbar, bytes);
    for (int j = 0; j < my_mt; ++j) {
      const int r = (warp + RS_WARPS * j) * 16, n = min(16, nk - r) * ROW;
      aqlm::bulk_copy(sv + r * ROW, vc + (size_t)(k0 + r) * D, n, vbar);
    }
  }
  __syncwarp();  // the barriers initialised before any lane waits on them
  if constexpr (QUANT) {
    for (int i = lane; i < my_mt * 16; i += 32) {
      const int r = (warp + RS_WARPS * (i / 16)) * 16 + i % 16;
      const bool valid = r < nk;
      aqlm::cp_async4(sks + r, ksc + (valid ? k0 + r : k0), valid);
      aqlm::cp_async4(svs + r, vsc + (valid ? k0 + r : k0), valid);
    }
  }
  aqlm::cp_async_commit();
  if (my_mt > 0 && (n_mt - 1) % RS_WARPS == warp)  // the split's last tile: zero its V rows past nk
    for (int i = lane; i < (n_mt * 16 - nk) * ROW / 16; i += 32)
      reinterpret_cast<uint4*>(sv + nk * ROW)[i] = make_uint4(0, 0, 0, 0);
  const bool fresh = rf >= 0 && rf < nk && (rf / 16) % RS_WARPS == warp;
  const T* kn = WRITE ? k_new + (size_t)bh * D : nullptr;
  const T* vn = WRITE ? v_new + (size_t)bh * D : nullptr;
  if (fresh)
    for (int d = lane; d < D; d += 32) {
      kc[(size_t)pos * D + d] = kn[d];
      vc[(size_t)pos * D + d] = vn[d];
    }

  aqlm::mbar_wait(kbar, 0);
  aqlm::cp_async_wait<0>();
  if (fresh) {
    T* skr = reinterpret_cast<T*>(sk + rf * ROW);
    for (int d = lane; d < D; d += 32) skr[d] = kn[d];
    if (QUANT && lane == 0) {
      ksc[pos] = sks[rf] = ks_new[bh];
      vsc[pos] = svs[rf] = vs_new[bh];
    }
  }
  __syncwarp();  // this warp's K rows and scales visible to it

  // 2. scores of the warp's 16-key tiles on the tensor cores: S^T [16 keys
  // x 8 heads], element e of tile j: key 16 mt + gid + 8 (e >> 1), head
  // 2 tig + (e & 1)
  float sc[MTW][4];
  float tmax[2] = {-INFINITY, -INFINITY};  // heads 2 tig, 2 tig + 1
#pragma unroll
  for (int j = 0; j < MTW; ++j) {
    const int mt = warp + RS_WARPS * j;
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = -INFINITY;
    if (j >= my_mt) continue;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const int r0 = mt * 16 + gid, r1 = r0 + 8;
#pragma unroll
    for (int i = 0; i < CPR / 4; ++i) {
      const int ch = tig + 4 * i;
      const uint4 w0 = *reinterpret_cast<const uint4*>(sk + r0 * ROW + ch * 16);
      const uint4 w1 = *reinterpret_cast<const uint4*>(sk + r1 * ROW + ch * 16);
#pragma unroll
      for (int u = 0; u < EPC / 4; ++u) {
        uint32_t a[4];
        if constexpr (QUANT) {
          aqlm::s8x4_to_bf16x2(word_of(w0, u), a[0], a[2]);
          aqlm::s8x4_to_bf16x2(word_of(w1, u), a[1], a[3]);
        } else {
          a[0] = word_of(w0, 2 * u);
          a[2] = word_of(w0, 2 * u + 1);
          a[1] = word_of(w1, 2 * u);
          a[3] = word_of(w1, 2 * u + 1);
        }
        mma_bf16_16816(c, a, qf[i][u][0], qf[i][u][1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1;
      const float ksv = QUANT ? sks[r] : 1.f;
      sc[j][e] = r < nk ? (uniform ? 0.f : c[e] * ksv * scale) : -INFINITY;
      tmax[e & 1] = fmaxf(tmax[e & 1], sc[j][e]);
    }
  }

  // 3. the warp's max of each head, p = exp(s - max) (times the key's value
  // scale into p V) and the exp sums; lanes gid = 0 keep the warp's (m, l)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], off));
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < MTW; ++j) {
    if (j >= my_mt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kl = 16 * j + gid + 8 * (e >> 1), head = 2 * tig + (e & 1);
      const float p = sc[j][e] == -INFINITY ? 0.f : expf(sc[j][e] - tmax[e & 1]);
      lsum[e & 1] += p;
      if (head < REP) pw[head * pst + kl] = QUANT ? p * svs[16 * (warp + RS_WARPS * j) + kl - 16 * j] : p;
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], off);
    if (gid == 0 && 2 * tig + hh < REP) {
      wm[warp * 8 + 2 * tig + hh] = tmax[hh];
      wl[warp * 8 + 2 * tig + hh] = lsum[hh];
    }
  }
  aqlm::mbar_wait(vbar, 0);
  if (fresh) {
    T* svr = reinterpret_cast<T*>(sv + rf * ROW);
    for (int d = lane; d < D; d += 32) svr[d] = vn[d];
  }
  __syncwarp();  // this warp's V rows and p visible to it

  // 4. p V over the warp's keys, its lanes EPL dims each
  float acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
#pragma unroll
  for (int j = 0; j < MTW; ++j) {
    if (j >= my_mt) continue;
    const int kb = (warp + RS_WARPS * j) * 16;
#pragma unroll 2
    for (int kk = 0; kk < 16; kk += 4) {
      float4 p4[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r)
        p4[r] = *reinterpret_cast<const float4*>(pw + r * pst + 16 * j + kk);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float v[EPL];
        v_elems<EPL>(reinterpret_cast<const T*>(sv + (kb + kk + jj) * ROW) + lane * EPL, v);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float pj = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y : jj == 2 ? p4[r].z : p4[r].w;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pj, v[e], acc[r][e]);
        }
      }
    }
  }
  __syncthreads();  // every warp done with the rows: region 0 free for the warps' sums
  float* red = reinterpret_cast<float*>(smem);  // [RS_WARPS][REP][D]
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float* dst = red + (warp * REP + r) * D + lane * EPL;
    if constexpr (EPL == 4)
      *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    else
      *reinterpret_cast<float2*>(dst) = make_float2(acc[r][0], acc[r][1]);
  }
  if (tid < REP) {  // the split's max and exp sum of each head, and each warp's weight in it
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < RS_WARPS; ++w) m = fmaxf(m, wm[w * 8 + tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < RS_WARPS; ++w) {
      const float c = wl[w * 8 + tid] > 0.f ? expf(wm[w * 8 + tid] - m) : 0.f;
      l += c * wl[w * 8 + tid];
      wm[w * 8 + tid] = c;
    }
    hmax[tid] = m;
    hden[tid] = l;
  }
  __syncthreads();

  // 5. the warps' sums, each weighted by exp(its max - the split's), in warp
  // order; one split writes the row, else the split's partial state, and the
  // row's last split merges them
  const int nz = gridDim.z;
  float* pacc = part_acc + ((size_t)bh * nz + z) * REP * D;
  for (int i = tid; i < REP * D; i += RS_THREADS) {
    const int r = i / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < RS_WARPS; ++w) a += wm[w * 8 + r] * red[w * REP * D + i];
    if (n_act == 1) o[i] = __float2bfloat16(a / fmaxf(hden[r], 1e-30f));
    else pacc[i] = a;
  }
  if (n_act == 1) return;
  if (tid < REP) {
    float* pml = part_ml + ((size_t)bh * nz + z) * REP * 2;
    pml[2 * tid] = hmax[tid];
    pml[2 * tid + 1] = hden[tid];
  }
  // the block's partial state, then its ticket: one release-acquire atomic
  // after the barrier (the barrier orders every thread's stores before it)
  __syncthreads();
  if (tid == 0) *s_last = atomic_add_acq_rel(tickets + bh, 1) == n_act - 1;
  __syncthreads();
  if (!*s_last) return;
  // the merge, splits in order: their (m, l) into shared memory while each
  // thread's first MZ partial sums load into registers, then each head's
  // max, denominator and split weights exp(m_z - max), then the sums
  constexpr int MZ = 8;
  constexpr int EPT = (REP * D + RS_THREADS - 1) / RS_THREADS;  // elements a thread
  const float* pa = part_acc + (size_t)bh * nz * REP * D;
  const float* pm = part_ml + (size_t)bh * nz * REP * 2;
  for (int i = tid; i < n_act * REP * 2; i += RS_THREADS)
    smz[(i / (REP * 2)) * 16 + i % (REP * 2)] = __ldcg(pm + i);
  float first[EPT][MZ];
#pragma unroll
  for (int k = 0; k < EPT; ++k)
#pragma unroll
    for (int zz = 0; zz < MZ; ++zz) {
      const int i = tid + k * RS_THREADS;
      first[k][zz] = i < REP * D && zz < n_act ? __ldcg(pa + (size_t)zz * REP * D + i) : 0.f;
    }
  __syncthreads();
  if (tid < REP) {
    float mx = NEG;
    for (int zz = 0; zz < n_act; ++zz) mx = fmaxf(mx, smz[zz * 16 + 2 * tid]);
    float den = 0.f;
    for (int zz = 0; zz < n_act; ++zz) {
      const float c = expf(smz[zz * 16 + 2 * tid] - mx);
      den += c * smz[zz * 16 + 2 * tid + 1];
      smz[zz * 16 + 2 * tid] = c;
    }
    hden[tid] = den;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int i = tid + k * RS_THREADS, r = i / D;
    if (i >= REP * D) break;
    float num = 0.f;
#pragma unroll
    for (int zz = 0; zz < MZ; ++zz)
      if (zz < n_act) num += smz[zz * 16 + 2 * r] * first[k][zz];
#pragma unroll 8
    for (int zz = MZ; zz < n_act; ++zz)
      num += smz[zz * 16 + 2 * r] * __ldcg(pa + (size_t)zz * REP * D + i);
    o[i] = __float2bfloat16(num / fmaxf(hden[r], 1e-30f));
  }
  if (tid == 0) tickets[bh] = 0;  // every split of the row has taken its ticket
}

template <int D, int REP, bool QUANT, bool WRITE>
cudaError_t launch_rows(const void* q, const void* kn, const void* vn, const void* ksn,
                        const void* vsn, void* kc, void* vc, void* ksc, void* vsc,
                        const void* offsets, void* out, void* part_acc, void* part_ml,
                        void* tickets, int B, int Hkv, int S, int window, float scale, int kps,
                        int splits, int smem, int ts, int n_tiles, cudaStream_t st) {
  using T = typename Storage<QUANT>::T;
  const int span = window <= 0 ? 0 : WRITE ? window : max(window, n_tiles * ts);
  if (kps < 64 || kps > RS_MAX_KPS || kps % 64 ||
      smem != RowLayout(kps, D, REP, QUANT, splits).total() ||
      smem > SMEM_LIMIT || splits != row_splits(S, kps, span) ||
      (splits > 1 && (!part_acc || !part_ml || !tickets)))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(flash_decode_rows_kernel<D, REP, QUANT, WRITE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  flash_decode_rows_kernel<D, REP, QUANT, WRITE><<<dim3(Hkv, B, splits), RS_THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const T*)kn, (const T*)vn, (const float*)ksn, (const float*)vsn,
      (T*)kc, (T*)vc, (float*)ksc, (float*)vsc, (const int*)offsets, (__nv_bfloat16*)out,
      (float*)part_acc, (float*)part_ml, (int*)tickets, Hkv, S, window, scale, kps, ts, n_tiles);
  return cudaGetLastError();
}

// One head dim, cache type and WRITE flag: the row kernels at 1/2/4/8 heads
// per kv head, split-KV on the tensor cores at any other count.
template <int D, bool QUANT, bool WRITE>
cudaError_t dispatch(int rep, const void* q, const void* kn, const void* vn, const void* ksn,
                     const void* vsn, void* kc, void* vc, void* ksc, void* vsc,
                     const void* offsets, void* out, void* part_acc, void* part_ml,
                     void* tickets, int B, int Hkv, int S, int window, float scale, int kps,
                     int splits, int smem, int ts, int n_tiles, cudaStream_t st) {
#define AQLM_FD_ROWS(R)                                                                       \
  launch_rows<D, R, QUANT, WRITE>(q, kn, vn, ksn, vsn, kc, vc, ksc, vsc, offsets, out,       \
                                  part_acc, part_ml, tickets, B, Hkv, S, window, scale, kps, \
                                  splits, smem, ts, n_tiles, st)
  switch (rep) {
    case 1: return AQLM_FD_ROWS(1);
    case 2: return AQLM_FD_ROWS(2);
    case 4: return AQLM_FD_ROWS(4);
    case 8: return AQLM_FD_ROWS(8);
    default:
      if (rep < 1 || kps < KT || splits != (S + kps - 1) / kps) return cudaErrorInvalidValue;
      return launch_split<D, QUANT, WRITE>(q, kn, vn, ksn, vsn, kc, vc, ksc, vsc, offsets, out,
                                           part_acc, part_ml, B, Hkv, S, window, scale, rep, kps,
                                           ts, n_tiles, st);
  }
#undef AQLM_FD_ROWS
}

}  // namespace

// window <= 0 means no sliding window. 1/2/4/8 query heads per kv head run
// the row kernel as flash_decode.row_plan lays it out: kps keys a split (64,
// 128 or 256), `splits` splits a row in the grid, `smem` dynamic bytes
// (checked against the kernel's own layout); when splits > 1, partials
// part_acc [B, Hkv, splits, rep, D] and part_ml [..., rep, 2] f32 and
// tickets [B * Hkv] int32, zero before the first launch (each launch leaves
// them zero). Any other count runs split-KV: kps a multiple of 64, splits =
// ceil(S / kps), the same partials, no tickets, smem unused.
extern "C" int flash_decode_write_launch(const void* q, const void* k_new, const void* v_new,
                                         const void* ks_new, const void* vs_new, void* k_cache,
                                         void* v_cache, void* ks_cache, void* vs_cache,
                                         const void* offsets, void* out, void* part_acc,
                                         void* part_ml, void* tickets, int B, int Hkv, int S,
                                         int D, int rep, int quant, int window, int kps,
                                         int splits, int smem, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define AQLM_FD_WRITE(DD, Q)                                                                  \
  return dispatch<DD, Q, true>(rep, q, k_new, v_new, ks_new, vs_new, k_cache, v_cache,        \
                               ks_cache, vs_cache, offsets, out, part_acc, part_ml, tickets, \
                               B, Hkv, S, window, scale, kps, splits, smem, 0, 0, st)
  if (D == 128) {
    if (quant) AQLM_FD_WRITE(128, true);
    AQLM_FD_WRITE(128, false);
  }
  if (D == 64) {
    if (quant) AQLM_FD_WRITE(64, true);
    AQLM_FD_WRITE(64, false);
  }
#undef AQLM_FD_WRITE
  return cudaErrorInvalidValue;
}

// B6: flash decode over one layer of the cache as it is, keys below
// lengths[b] (within the window when window > 0); ts and n_tiles are the TPU
// grid's tile length and visited tile count, which decide the result of a
// row with no key in range (see key_range); kps, splits, smem, the partials
// and the tickets as above.
extern "C" int flash_decode_launch(const void* q, void* k_cache, void* v_cache, void* ks_cache,
                                   void* vs_cache, const void* lengths, void* out, void* part_acc,
                                   void* part_ml, void* tickets, int B, int Hkv, int S, int D,
                                   int rep, int quant, int window, int ts, int n_tiles, int kps,
                                   int splits, int smem, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ts < 1 || n_tiles < 1) return cudaErrorInvalidValue;
#define AQLM_FD_READ(DD, Q)                                                                    \
  return dispatch<DD, Q, false>(rep, q, nullptr, nullptr, nullptr, nullptr, k_cache, v_cache,  \
                                ks_cache, vs_cache, lengths, out, part_acc, part_ml, tickets, \
                                B, Hkv, S, window, scale, kps, splits, smem, ts, n_tiles, st)
  if (D == 128) {
    if (quant) AQLM_FD_READ(128, true);
    AQLM_FD_READ(128, false);
  }
  if (D == 64) {
    if (quant) AQLM_FD_READ(64, true);
    AQLM_FD_READ(64, false);
  }
#undef AQLM_FD_READ
  return cudaErrorInvalidValue;
}
