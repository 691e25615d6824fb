// K1: Kx8 codebook GEMV for decode (batch <= 8), over the tiled codes layout.
//
// Replaces the TPU kernels of aqlm_tpu/ops/lut_gemv.py: lut_gemv_kx8_tiled
// (_call, pallas_call at :181), lut_gemv_kx8_indexed (_call_indexed, :435)
// and lut_gemv_kx8_grouped_indexed (_call_grouped, :518), and, with its
// expert grid axis, lut_moe_gemv_kx8 (_call_moe, :272) and
// lut_moe_gemv_kx8_indexed (_call_moe_indexed, :351). The layer index is a
// pointer offset applied by the caller; an optional per-out-tile projection
// map picks each tile's codebooks (fused q/k/v or gate/up).
//
// The TPU kernel's own algorithm: a table of every (input group, codebook,
// code) product with the activations,
//   lut[b, ig, k, s] = dot(x[b, ig*8 : ig*8+8], cb[p, k, s])      (f32)
//   y[b, o] = scales[o] * sum_{ig, k} lut[b, ig, k, codes[ig*K+k, o]]
// so each (column, group, codebook) costs one lookup of B f32 values and B
// adds. JAX builds the whole table in device memory; here each block builds
// the part it needs in shared memory, chunk by chunk, and it never leaves.
//
// What bounds it on an H100: the codes, 0.25 byte per weight for 2x8, read
// once (Mixtral-8x7B's all-expert gate/up: 117.4 MB, 35 us at 3.35 TB/s);
// next, shared memory: the lookups read B x 4 bytes per (column, group,
// codebook) (0.47 GB at B = 1 for that launch, 16 us at the card's ~29.6
// TB/s of shared memory) and the tables are written once per block.
//
// Design (256 threads, two blocks an SM): a block owns C output columns (C
// 256 or 512, all in one projection, the last block of a projection cut at
// its end; chosen by lut_gemv.plan) and a run of input groups (a split).
// Each table serves the block's C columns, so the build costs 256 / C of the
// lookups' values. It walks the run in chunks of two (group block,
// codebook) pairs; a group block is 16 / BP groups, BP = B rounded up to 1,
// 2, 4 or 8, so a chunk's tables are 32 KB whatever B is:
//   - the tables: one mma.sync m16n8k8 (bf16 in, f32 out) per pair and 8
//     codes, its 16 rows the (group, row of x) pairs of the group block, its
//     8 columns the codes (f32 x as a hi + lo bf16 pair, two products). Table
//     row s holds the 32 floats (table, row of x) of code s for every table of
//     the chunk, so a lookup's address depends on its table alone in its
//     bank; each store instruction's lanes write 32 different banks (each
//     lane's four sources rotated by its lane);
//   - the codes stream through a ring of 2-6 chunks by cp.async, rows padded
//     by 16 bytes (a phase's code reads on distinct banks); the codebooks
//     are staged once per block;
//   - the lookups: the P = 32 / min(BP, 4) lanes of a phase each read their
//     own table (P / 2 tables and both halves of a 32-byte entry at BP 8):
//     no two lanes of a phase ever meet in a bank, whatever the codes. A lane
//     reads CV codes of its table at once and keeps CV x J columns' sums in
//     registers (C / 8 floats) for the whole run;
//   - chunk c is looked up, then chunk c + 1's tables are built into the
//     second buffer (its products and selects fill the lookups' latencies;
//     its activations were loaded a chunk earlier): one block-wide barrier a
//     chunk.
// The lanes' sums meet by shuffles once per run (a halving butterfly: each
// exchange halves the values a lane holds); with more than one split per
// column block, each writes f32 partial sums and the last block to finish
// (an atomic ticket) adds them in a fixed order, so the result does not
// depend on block timing. The scale and the output cast run there.
//
// The all-expert form (MOE) runs every expert of a Mixtral projection in one
// launch, the expert on the third grid axis: each expert's blocks read its
// own codes, codebooks, scales and (down) activations and own their split-K
// partials and tickets; the output is f32 [E, B, OUT], as on the TPU. The axis
// is a template flag only the MoE instances compile in.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int G = 8;              // in_group_size the kernel is written for
constexpr int ROWS = 256;         // table rows: the codes of an 8-bit codebook
constexpr int ROW_FLOATS = 32;    // a table row: (table, row of x) of every table of a chunk
constexpr int TABLE_BYTES = ROWS * ROW_FLOATS * 4;  // one chunk's tables
constexpr int PAIRS = 2;          // (group block, codebook) pairs a chunk
constexpr int CODE_PAD = 16;      // bytes past each staged code row
constexpr int MAX_STAGES = 6;
constexpr int SMEM_LIMIT = 232448;
constexpr int THREADS = 256;  // two blocks an SM
constexpr int WARPS = THREADS / 32;

template <int C, int BP>
struct Shape {
  static constexpr int BH = BP < 4 ? BP : 4;     // floats of one lookup
  static constexpr int NH = BP / BH;             // lookups an entry (2 at BP 8)
  static constexpr int P = 32 / BH;              // lanes of a shared-memory phase
  static constexpr int PT = P / NH;              // tables those lanes read
  static constexpr int GBS = 16 / BP;            // groups of a group block
  static constexpr int NT = PAIRS * GBS;         // tables of a chunk
  static constexpr int CV0 = C * P / THREADS;
  static constexpr int CV = CV0 < 16 ? CV0 : 16;  // codes a lane reads at once
  static constexpr int J = CV0 / CV;             // code vectors a lane owns
  static constexpr int N = J * CV * BH;          // the lane's sums (C / 8)
  static_assert(NT == PT, "each lane of a phase reads a table of its own");
  static_assert(N == C / 8, "the lane's sums");
};

// Dynamic shared memory: two table buffers, the code ring, the block's
// codebooks (K x 256 rows of 16 bytes, zeros past S), the ticket flag
// (lut_gemv.plan computes the same).
__host__ __device__ inline int smem_bytes(int C, int bp, int stages, int K) {
  return 2 * TABLE_BYTES + stages * (PAIRS * 16 / bp) * (C + CODE_PAD) + K * ROWS * 16 + 16;
}

__device__ __forceinline__ void mma_bf16_m16n8k8(float* d, uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The sums of the lanes that differ in the bits below PT (the lanes of one
// column vector and half), by a halving butterfly: at each exchange a lane
// keeps half of its values (the upper half where its bit is set) and adds
// the partner's copy of that half. With N >= PT the lane ends with N / PT
// sums; with fewer values the last exchanges add whole copies.
template <int N, int D, int PT>
__device__ __forceinline__ void lane_reduce(float* a, int lane) {
  if constexpr (D < PT) {
    if constexpr (N >= 2) {
      const bool up = lane & D;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? a[i] : a[i + N / 2];
        const float keep = up ? a[i + N / 2] : a[i];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, D);
      }
      lane_reduce<N / 2, D * 2, PT>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], D);
      lane_reduce<1, D * 2, PT>(a, lane);
    }
  }
}

__device__ __forceinline__ void cp_async_wait_dyn(int pending) {
  switch (pending) {
    case 0: aqlm::cp_async_wait<0>(); break;
    case 1: aqlm::cp_async_wait<1>(); break;
    case 2: aqlm::cp_async_wait<2>(); break;
    case 3: aqlm::cp_async_wait<3>(); break;
    default: aqlm::cp_async_wait<4>(); break;
  }
}

template <int C, int BP, int XF32, int MOE>
__global__ void __launch_bounds__(THREADS, 2)
lut_gemv_kernel(const void* __restrict__ x,              // [B, IN] bf16 or f32 ([E, B, IN] or shared when MOE)
                const uint8_t* __restrict__ codes,       // [NT, K*IG, tn] of one layer ([E, ...] when MOE)
                const __nv_bfloat16* __restrict__ cb,    // [P, K, S, G] of one layer ([E, K, S, G] when MOE)
                const float* __restrict__ scales,        // [OUT] of one layer ([E, OUT] when MOE)
                const int* __restrict__ proj_map,        // [NT] or null
                void* __restrict__ out,                  // [B, OUT] bf16 or f32 ([E, B, OUT] f32 when MOE)
                float* __restrict__ partials,            // [(E,) splits, B, OUT] when split
                int* __restrict__ tickets,               // [(E,) OUT / C] zeroed, when split
                int out_f32, int B, int n_tiles, int kig, int tn, int K, int S,
                int in_features, int gb_per_split, int stages, long long x_estride,
                int proj_width, int blocks_per_proj) {
  using SH = Shape<C, BP>;
  constexpr int GBS = SH::GBS, NT = SH::NT, P = SH::P, PT = SH::PT, BH = SH::BH;
  constexpr int CV = SH::CV, J = SH::J, N = SH::N;
  constexpr int ROW_BYTES = C + CODE_PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tab = reinterpret_cast<float*>(smem);  // 2 x [ROWS][ROW_FLOATS]
  uint8_t* s_codes = smem + 2 * TABLE_BYTES;      // stages x [NT][ROW_BYTES]
  uint4* s_cb = reinterpret_cast<uint4*>(s_codes + stages * NT * ROW_BYTES);  // [K][ROWS]
  int& s_last = *reinterpret_cast<int*>(s_cb + K * ROWS);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int out_features = n_tiles * tn;
  const int n_groups = kig / K;
  constexpr int xb = XF32 ? 4 : 2;
  const unsigned char* xp = static_cast<const unsigned char*>(x);
  if constexpr (MOE) {  // expert blockIdx.z: its own operands, output and split-K scratch
    const size_t e = blockIdx.z;
    xp += e * x_estride * xb;  // 0 when every expert reads the same rows
    codes += e * n_tiles * kig * tn;
    cb += e * K * S * G;
    scales += e * out_features;
    out = static_cast<float*>(out) + e * B * out_features;
    if (gridDim.y > 1) {
      partials += e * gridDim.y * B * out_features;
      tickets += e * gridDim.x;
    }
  }
  // block bx: columns [col0, col0 + C) of projection bx / blocks_per_proj,
  // the last block of a projection cut at its end (col_lim)
  const int proj0 = blockIdx.x / blocks_per_proj * proj_width;
  const int col0 = proj0 + blockIdx.x % blocks_per_proj * C;
  const int col_lim = proj0 + proj_width;
  const int proj = proj_map ? proj_map[col0 / tn] : 0;
  {  // the block's codebooks, zeros past S (their table rows are never read)
    const uint4* cbp = reinterpret_cast<const uint4*>(cb + (size_t)proj * K * S * G);
    for (int i = tid; i < K * ROWS; i += THREADS)
      s_cb[i] = i % ROWS < S ? __ldg(cbp + (i / ROWS) * S + i % ROWS) : make_uint4(0, 0, 0, 0);
  }
  const int g_begin = blockIdx.y * gb_per_split * GBS;
  const int g_end = min(n_groups, g_begin + gb_per_split * GBS);
  const int n_pairs = (g_end - g_begin + GBS - 1) / GBS * K;
  const int n_chunks = (n_pairs + PAIRS - 1) / PAIRS;

  // chunk c's code rows: table t is pair c * PAIRS + t / GBS, group t % GBS of its block
  auto load_codes = [&](int c, int st) {
    uint8_t* dst = s_codes + st * NT * ROW_BYTES;
    for (int i = tid; i < NT * (C / 16); i += THREADS) {
      const int t = i / (C / 16), c16 = i % (C / 16);
      const int p = c * PAIRS + t / GBS, k = p % K;
      const int g = g_begin + (p / K) * GBS + t % GBS;
      const int col = col0 + c16 * 16;
      const bool valid = p < n_pairs && g < g_end && col < col_lim;
      const uint8_t* src =
          valid ? codes + ((size_t)(col / tn) * kig + (size_t)g * K + k) * tn + col % tn : codes;
      aqlm::cp_async16(dst + t * ROW_BYTES + c16 * 16, src, valid);
    }
  };

  // chunk c's A fragments (rows gid and gid + 8 of each pair: (group, row of
  // x)), loaded a chunk before their build so that it waits on no load
  const int gid = lane / 4, tig = lane % 4;
  using XV = typename std::conditional<XF32 != 0, float2, uint32_t>::type;
  auto load_a = [&](int c, XV (&xa)[PAIRS][2]) {
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      const int p = c * PAIRS + q;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = gid + 8 * hr, b = row % BP;
        const int g = g_begin + (p / K) * GBS + row / BP;
        const bool ok = p < n_pairs && b < B && g < g_end;
        const size_t at = ok ? (size_t)b * in_features + g * G + 2 * tig : 0;
        if constexpr (XF32)
          xa[q][hr] = ok ? __ldg(reinterpret_cast<const float2*>(xp) + at / 2) : make_float2(0.f, 0.f);
        else
          xa[q][hr] = ok ? __ldg(reinterpret_cast<const uint32_t*>(xp) + at / 2) : 0u;
      }
    }
  };
  // chunk c's tables into `tab`: warp w builds codes [32 w, 32 w + 32) of both pairs
  auto build = [&](int c, const XV (&xa)[PAIRS][2], float* tab) {
    uint32_t a_hi[PAIRS][2], a_lo[PAIRS][2];
    int kq[PAIRS];
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      kq[q] = (c * PAIRS + q) % K;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if constexpr (XF32) {
          const __nv_bfloat162 hi = __floats2bfloat162_rn(xa[q][hr].x, xa[q][hr].y);
          a_hi[q][hr] = *reinterpret_cast<const uint32_t*>(&hi);
          a_lo[q][hr] = pack2(xa[q][hr].x - __low2float(hi), xa[q][hr].y - __high2float(hi));
        } else {
          a_hi[q][hr] = xa[q][hr];
          a_lo[q][hr] = 0u;
        }
      }
    }
#pragma unroll
    for (int sti = 0; sti < 4; ++sti) {
      const int s0 = (warp * 4 + sti) * 8;
      float d[PAIRS][4];
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        // B column gid: code s0 + gid, its elements 2 tig, 2 tig + 1 (an
        // invalid pair has zero A, so its table is zero)
        const uint32_t bf =
            reinterpret_cast<const uint32_t*>(s_cb + kq[q] * ROWS + s0 + gid)[tig];
        d[q][0] = d[q][1] = d[q][2] = d[q][3] = 0.f;
        mma_bf16_m16n8k8(d[q], a_hi[q][0], a_hi[q][1], bf);
        if constexpr (XF32) mma_bf16_m16n8k8(d[q], a_lo[q][0], a_lo[q][1], bf);
      }
      // D (row r, column n) is table q * GBS + r / BP, row of x r % BP, code
      // s0 + n: float q * 16 + r of row s0 + n. The lane's four sources of
      // one column (rows gid, gid + 8 of both pairs) go to floats gid + 8 i;
      // store i writes source (i + tig) % 4, so its 32 lanes meet 32 banks.
#pragma unroll
      for (int fam = 0; fam < 2; ++fam) {
        const float src[4] = {d[0][fam], d[0][2 + fam], d[1][fam], d[1][2 + fam]};
        float r1[4], r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) r1[i] = (tig & 1) ? src[(i + 1) & 3] : src[i];
#pragma unroll
        for (int i = 0; i < 4; ++i) r[i] = (tig & 2) ? r1[(i + 2) & 3] : r1[i];
        float* row = tab + (s0 + 2 * tig + fam) * ROW_FLOATS + gid;
#pragma unroll
        for (int i = 0; i < 4; ++i) row[8 * ((i + tig) & 3)] = r[i];
      }
    }
  };

  // the lane's table, half of an entry and code vectors
  const int cs = lane / P, ls = lane % P;
  const int ts = ls % PT, h = ls / PT;
  const int lane_float = ts * BP + h * BH;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;

  auto lookups = [&](const float* tab, const uint8_t* stage) {
    const uint8_t* crow = stage + ts * ROW_BYTES;
    const float* tl = tab + lane_float;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int cvi = warp * (32 / P) + cs + j * (WARPS * 32 / P);
      uint32_t cw[CV / 4];
      if constexpr (CV == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(crow + cvi * CV);
        cw[0] = v.x; cw[1] = v.y; cw[2] = v.z; cw[3] = v.w;
      } else if constexpr (CV == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(crow + cvi * CV);
        cw[0] = v.x; cw[1] = v.y;
      } else {
        cw[0] = *reinterpret_cast<const uint32_t*>(crow + cvi * CV);
      }
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const int code = __byte_perm(cw[i / 4], 0, 0x4440 + (i % 4));
        const float* e = tl + code * ROW_FLOATS;
        float* a = acc + (j * CV + i) * BH;
        if constexpr (BH == 4) {
          const float4 v = *reinterpret_cast<const float4*>(e);
          a[0] += v.x; a[1] += v.y; a[2] += v.z; a[3] += v.w;
        } else if constexpr (BH == 2) {
          const float2 v = *reinterpret_cast<const float2*>(e);
          a[0] += v.x; a[1] += v.y;
        } else {
          a[0] += *e;
        }
      }
    }
  };

  for (int c = 0; c < stages - 1; ++c) {
    if (c < n_chunks) load_codes(c, c);
    aqlm::cp_async_commit();
  }
  __syncthreads();  // the codebooks
  XV xa[PAIRS][2], xn[PAIRS][2];
  load_a(0, xa);
  if (n_chunks > 0) build(0, xa, s_tab);
  load_a(1, xa);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_dyn(stages - 2);  // chunk c's codes, this thread's copies
    __syncthreads();  // everyone's; chunk c's tables; chunk c - 1's stage and buffer are free
    const int cn = c + stages - 1;
    if (cn < n_chunks) load_codes(cn, cn % stages);
    aqlm::cp_async_commit();
    load_a(c + 2, xn);
    // the lookups first: the next build's products and selects have no
    // order with them and fill their latencies
    lookups(s_tab + (c & 1) * ROWS * ROW_FLOATS, s_codes + (c % stages) * NT * ROW_BYTES);
    if (c + 1 < n_chunks) build(c + 1, xa, s_tab + ((c + 1) & 1) * ROWS * ROW_FLOATS);
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      xa[q][0] = xn[q][0];
      xa[q][1] = xn[q][1];
    }
  }
  aqlm::cp_async_wait<0>();

  lane_reduce<N, 1, PT>(acc, lane);
  // the lane's sums: values [off, off + NF) of its N, where the exchanges'
  // bits (lowest first) chose halves from the top
  constexpr int NF = N >= PT ? N / PT : 1;
  int off = 0;
  bool writer = true;
#pragma unroll
  for (int d = 1, half = N / 2; d < PT; d *= 2, half /= 2) {
    if (half >= 1) {
      if (lane & d) off += half;
    } else if (lane & d) {
      writer = false;  // a copy: the lane with these bits clear writes it
    }
  }

  auto value_at = [&](int r, int& col, int& b) {
    const int n = off + r, j = n / (CV * BH), i = (n / BH) % CV;
    col = (warp * (32 / P) + cs + j * (WARPS * 32 / P)) * CV + i;
    b = h * BH + n % BH;
  };
  if (gridDim.y == 1) {
    if (writer) {
#pragma unroll
      for (int r = 0; r < NF; ++r) {
        int col, b;
        value_at(r, col, b);
        if (b >= B || col0 + col >= col_lim) continue;
        const float v = acc[r] * scales[col0 + col];
        const size_t at = (size_t)b * out_features + col0 + col;
        if (out_f32)
          static_cast<float*>(out)[at] = v;
        else
          static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(v);
      }
    }
    return;
  }
  if (writer) {
#pragma unroll
    for (int r = 0; r < NF; ++r) {
      int col, b;
      value_at(r, col, b);
      if (b < B && col0 + col < col_lim)
        partials[((size_t)blockIdx.y * B + b) * out_features + col0 + col] = acc[r];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < B * C; i += THREADS) {
    const int b = i / C, col = col0 + i % C;
    if (col >= col_lim) continue;
    float s = 0.f;
    for (int sp = 0; sp < (int)gridDim.y; ++sp)
      s += __ldcg(partials + ((size_t)sp * B + b) * out_features + col);
    const float v = s * scales[col];
    const size_t at = (size_t)b * out_features + col;
    if (out_f32)
      static_cast<float*>(out)[at] = v;
    else
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(v);
  }
}

template <int C, int BP, int XF32, int MOE>
cudaError_t launch_c(const void* x, const void* codes, const void* cb, const void* scales,
                     const void* proj_map, void* out, void* partials, void* tickets, int x_f32,
                     int out_f32, int B, int splits, int gb_per_split, int stages, int smem,
                     int experts, long long x_estride, int n_tiles, int kig, int tn, int K, int S,
                     int in_features, int proj_width, int blocks_per_proj, cudaStream_t stream) {
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(lut_gemv_kernel<C, BP, XF32, MOE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_proj = n_tiles * tn / proj_width;
  const dim3 grid(n_proj * blocks_per_proj, splits, experts);
  lut_gemv_kernel<C, BP, XF32, MOE><<<grid, THREADS, smem, stream>>>(
      x, (const uint8_t*)codes, (const __nv_bfloat16*)cb, (const float*)scales,
      (const int*)proj_map, out, (float*)partials, (int*)tickets, out_f32, B, n_tiles, kig,
      tn, K, S, in_features, gb_per_split, stages, x_estride, proj_width, blocks_per_proj);
  return cudaGetLastError();
}

template <int BP, int MOE>
cudaError_t launch_bp(int cols, const void* x, const void* codes, const void* cb,
                      const void* scales, const void* proj_map, void* out, void* partials,
                      void* tickets, int x_f32, int out_f32, int B, int splits, int gb_per_split,
                      int stages, int smem, int experts, long long x_estride, int n_tiles,
                      int kig, int tn, int K, int S, int in_features, int proj_width,
                      int blocks_per_proj, cudaStream_t st) {
#define AQLM_LUT_CASE(NC)                                                                     \
  case NC:                                                                                    \
    if (x_f32)                                                                                \
      return launch_c<NC, BP, 1, MOE>(x, codes, cb, scales, proj_map, out, partials, tickets, \
                                      x_f32, out_f32, B, splits, gb_per_split, stages, smem,  \
                                      experts, x_estride, n_tiles, kig, tn, K, S,             \
                                      in_features, proj_width, blocks_per_proj, st);          \
    return launch_c<NC, BP, 0, MOE>(x, codes, cb, scales, proj_map, out, partials, tickets,   \
                                    x_f32, out_f32, B, splits, gb_per_split, stages, smem,    \
                                    experts, x_estride, n_tiles, kig, tn, K, S, in_features,  \
                                    proj_width, blocks_per_proj, st);
  switch (cols) {
    AQLM_LUT_CASE(256) AQLM_LUT_CASE(512)
    default: return cudaErrorInvalidValue;
  }
#undef AQLM_LUT_CASE
}

template <int MOE>
cudaError_t launch_moe(int bp, int cols, const void* x, const void* codes, const void* cb,
                       const void* scales, const void* proj_map, void* out, void* partials,
                       void* tickets, int x_f32, int out_f32, int B, int splits, int gb_per_split,
                       int stages, int smem, int experts, long long x_estride, int n_tiles,
                       int kig, int tn, int K, int S, int in_features, int proj_width,
                       int blocks_per_proj, cudaStream_t st) {
#define AQLM_LUT_BP(NB)                                                                         \
  case NB:                                                                                      \
    return launch_bp<NB, MOE>(cols, x, codes, cb, scales, proj_map, out, partials, tickets,     \
                              x_f32, out_f32, B, splits, gb_per_split, stages, smem, experts,   \
                              x_estride, n_tiles, kig, tn, K, S, in_features, proj_width,       \
                              blocks_per_proj, st);
  switch (bp) {
    AQLM_LUT_BP(1) AQLM_LUT_BP(2) AQLM_LUT_BP(4) AQLM_LUT_BP(8)
    default: return cudaErrorInvalidValue;
  }
#undef AQLM_LUT_BP
}

}  // namespace

// One launch of K1 as lut_gemv.plan lays it out: `cols` output columns a
// block (256 or 512), the output cut into
// projections of `proj_width` columns (a multiple of 128; OUT for one),
// `blocks_per_proj` blocks each, the last cut at the projection's end, so a
// block's columns lie in one projection,
// `splits` blocks along the input groups of `gb_per_split` group blocks each
// (a group block is 16 / BP groups, BP = B rounded up to 1, 2, 4 or 8),
// `stages` code-ring stages, `smem` dynamic shared bytes (checked against
// the kernel's own layout). x_f32 / out_f32 select f32 (1) or bf16 (0)
// activations and output. moe = 1 runs the all-expert instances: `experts`
// blocks along the third grid axis, codes [E, NT, K*IG, tn], cb [E, K, S, 8],
// scales [E, OUT], x [E, B, IN] with x_estride = B * IN (or one shared [B, IN]
// with x_estride = 0), f32 output [E, B, OUT]. With splits > 1, partials
// ([E,] splits, B, OUT f32) and tickets ([E,] one per column block, int32,
// zeroed) are required.
extern "C" int lut_gemv_launch(const void* x, const void* codes, const void* cb,
                               const void* scales, const void* proj_map, void* out,
                               void* partials, void* tickets, int x_f32, int out_f32, int B,
                               int cols, int splits, int gb_per_split, int stages, int smem,
                               int moe, int experts, long long x_estride, int n_tiles, int kig,
                               int tn, int K, int S, int in_features, int proj_width,
                               int blocks_per_proj, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int bp = B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8;
  if (B < 1 || B > 8 || K < 1 || K > 8 || S < 1 || S > 256 || kig % K || splits < 1 ||
      gb_per_split < 1 || stages < 2 || stages > MAX_STAGES || experts < 1 ||
      proj_width < 128 || proj_width % 128 || (n_tiles * tn) % proj_width ||
      blocks_per_proj != (proj_width + cols - 1) / cols || in_features != kig / K * G ||
      (moe && (proj_map || !out_f32)))
    return cudaErrorInvalidValue;
  if (smem != smem_bytes(cols, bp, stages, K) || smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  const int n_gb = (kig / K + 16 / bp - 1) / (16 / bp);
  if ((long long)(splits - 1) * gb_per_split >= n_gb) return cudaErrorInvalidValue;
  if (moe)
    return launch_moe<1>(bp, cols, x, codes, cb, scales, nullptr, out, partials, tickets, x_f32, 1,
                         B, splits, gb_per_split, stages, smem, experts, x_estride, n_tiles, kig,
                         tn, K, S, in_features, proj_width, blocks_per_proj, st);
  return launch_moe<0>(bp, cols, x, codes, cb, scales, proj_map, out, partials, tickets, x_f32,
                       out_f32, B, splits, gb_per_split, stages, smem, 1, 0, n_tiles, kig, tn, K,
                       S, in_features, proj_width, blocks_per_proj, st);
}
