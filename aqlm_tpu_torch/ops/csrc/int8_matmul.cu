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
// - Decode, T <= 8: bound by bytes (Llama-2-7B fused gate_up at T = 4:
//   90 MB, ~27 us at 3.35 TB/s), laid out by the wrapper's planning function
//   (int8_matmul.plan, a GemvPlan), split over no blocks: no partials, no
//   tickets, no second launch, and the result does not change from run to
//   run. Two kernels, by the row count:
//     - 1-2 rows, the row kernel on the CUDA cores: a block of 8 warps owns
//       a 16-row tile, a warp 2 rows; 32 lanes read 512 contiguous bytes of
//       a row an instruction, the next 1024-column chunk in flight, widen
//       them to f32 exactly and multiply them against the activation rows,
//       staged as f32 in 1024-column chunks. At 1-2 rows its T FMAs a weight
//       keep up with the bytes, and its reads are the most efficient the
//       card serves here (many warps an SM, whole rows in 512-byte runs):
//       the tensor-core GEMV below was 3.5-9% slower at 1 row of Llama's
//       qkv, gate/up and lm_head and Mixtral's all-expert shapes (PERF.md).
//       It splits nothing over blocks: at OUT = 4096 a split's partial sums,
//       fix-up and ticket fill cost more than the blocks it added bought.
//     - 3-8 rows, the tensor-core GEMV, transposed, as the int4 GEMV's is
//       (int4_matmul.cu): past 2 rows the row kernel's f32 activation reads
//       (T x 64 bytes a lane for every 32 weight bytes) and T FMAs a weight
//       pace it, not the bytes. W is the 16-row A operand of mma.sync
//       m16n8k16 and the activation rows, padded to 8, the 8-column B
//       operand, with f32 sums. A warp copies each 16-row x 256-column item
//       of W into its ring in shared memory by cp.async, two rows' 256
//       contiguous bytes an instruction (loaded straight into the
//       fragments' registers, eight rows' 64-byte halves an instruction,
//       the same bytes came slower from device memory, and more of them in
//       flight slower still); a thread reads back 16 bytes at 64 seg + 16
//       tig of rows gid and gid + 8, and each 4-byte word widens exactly to
//       bf16 (|w8| <= 127, s8x4_to_bf16x2) straight into one k16 step's A
//       fragment: its columns j0 .. j0 + 3 stand for mma k 2 tig,
//       2 tig + 1, 2 tig + 8, 2 tig + 9. That permutation of the
//       contraction inside each step is undone on the B side by reading the
//       activations at the same columns (x[gid][j0 .. j0 + 3] are the
//       thread's own B values), so x is staged in its natural order. One
//       block of 16 warps an SM walks a contiguous run of 16-row tiles (the
//       expert a tile coordinate); the warps of a block take a tile's
//       contraction in 16 contiguous pieces of whole 64-column units and
//       add their sums in shared memory in warp order. Each warp stages its
//       own piece's activations once by bulk copies (the whole contraction
//       where it fits beside the rings; else in the fewest runs of the
//       contraction that fit, each tile's sums kept in shared memory between
//       them: Llama's down at 4-8 rows, Mixtral's per-expert down at 3-8), so
//       no warp waits for another's, and keeps its next item in flight
//       across tile boundaries.
//   Both apply the scale and the bf16 cast in the epilogue.
// - Prefill, T > 8: bound by operations (2*T*OUT*IN on the bf16 tensor cores;
//   Llama-2-7B's fused qkv at T = 1024: 103 GFLOP, 0.104 ms at 989
//   TFLOP/s), laid out by the wrapper's planning function
//   (int8_matmul.plan), in B10's shape (int8_gemm_t_kernel below): a
//   warp-specialised block owns a BM x 128 tile of y (BM 256 past 256 rows,
//   128 past 64, else 64) and walks the contraction in 64-column slabs:
//     - the producer warp keeps a ring of TMA copies in flight: the x tile
//       [BM x 64] (128-byte swizzle; a 3-D map, so per-expert x is a
//       coordinate) and the int8 w8 slab [128 OUT x 64 IN], each on its own
//       full/empty mbarriers; rows past T and OUT and columns past
//       in_features (the maps' width, never ld) arrive as zeros;
//     - three widening warps turn the w8 slab into one of two bf16 W^T
//       buffers, exactly (|w8| <= 127; two byte-permutes and a bf16 subtract
//       per pair, s8x4_to_bf16x2), straight into wgmma's K-major core-matrix
//       layout: w8's rows are already K-major for y = x w8^T, so a lane
//       widens 16 contiguous bytes into two 16-byte core-matrix rows, its
//       column chunk rotated so that a phase's reads and writes each meet
//       eight bank groups;
//     - one or two consumer warpgroups run wgmma.mma_async m64n128k16 (x
//       through a 128B-swizzle descriptor, W^T an unswizzled one) with f32
//       sums, keeping one slab's products in flight while the next slab's
//       barriers are awaited. At BM 64 (one warpgroup, 256 threads) two
//       blocks share an SM.
//   The scale and the bf16 cast run in the epilogue. Each weight is widened
//   ceil(T / BM) times (4 at T = 1024). The widening and the products
//   together set the pace: at the fused qkv, T = 1024, the kernel takes
//   ~2.5x its operation bound, ~0.76x that without the widening and ~0.59x
//   without the products (experiments/torch_int8_int4_ablate.py), so both
//   contend for shared memory and neither alone bounds it. Where the output
//   tiles would leave the card idle (short prompts, narrow projections), the
//   contraction is split over blocks: each writes f32 partial sums and the
//   last block of an output tile to finish (an atomic ticket, which it zeroes
//   again for the next launch) adds them in a fixed order.
//
// All experts (MoE): w8 [E, OUT, ld], w_scale [E, OUT], out [E, T, OUT]; x is
// [T, in_features] shared by every expert (gate and up) or [E, T,
// in_features], one slab per expert (down). One launch covers every expert:
// the expert is the row kernel's grid y axis and the tensor-core GEMV's
// tiles' leading coordinate (a block whose run of tiles crosses an expert
// boundary stages that expert's x anew, where x is per expert), and is
// folded with the splits into the prefill grid's z axis;
// each tile or block offsets its pointers (decode) or its tensor-map
// coordinates (prefill) by its expert, and the prefill's split partial sums
// and tickets are per expert, so the last-block reduction never mixes
// experts. Mixtral-8x7B decode at T = 4 reads 470 MB of gate weights (0.14
// ms at 3.35 TB/s): the same byte-bound GEMV with E times the tiles. The
// expert axis is a template flag (MOE): a single matrix runs the kernels
// compiled without it, so its registers and code stay those of the
// one-matrix kernel.
//
// The activation backward (B10, int8_matmul_transposed: _call_t, pallas_call
// at :153; the backward of every int8 projection, aqlm_tpu/ops/runtime.py:305)
// is a kernel of its own below, so the forward instances keep their
// registers: dx[t, i] = bf16( sum_o bf16(g[t, o] * w_scale[o]) * w8[o, i] ).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace aqlm;

constexpr int T_SMEM_LIMIT = 232448;  // dynamic shared memory a block may use on an H100

// Four int8 packed in a word -> four exact floats: with u = s + 128 (the sign
// bit flipped), the float with bits 0x4B0000uu is 2^23 + u.
__device__ __forceinline__ void s8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// ---------------------------------------------------------------------------
// decode at 1-2 rows: the CUDA-core row kernel
// ---------------------------------------------------------------------------

constexpr int RV_MAX_T = 2;                // rows (of x) this kernel takes
constexpr int RV_WARPS = 8;
constexpr int RV_THREADS = RV_WARPS * 32;
constexpr int RV_R = 2;                    // output rows per warp
constexpr int RV_ROWS = RV_WARPS * RV_R;   // output rows per block: one 16-row tile
constexpr int RV_CHUNK = 1024;             // columns of x staged per pass
constexpr int RV_STEP = 512;               // columns one warp load covers: 32 lanes x 16
constexpr int RV_STEPS = RV_CHUNK / RV_STEP;

// float4 q of a staged x row lives at q ^ ((q >> 3) & 3): the eight lanes of
// a 16-byte shared-memory phase then fall on eight different bank groups
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 3) & 3); }

// A block of 8 warps owns one 16-row tile (of one expert: blockIdx.y) over
// the whole contraction; a warp owns 2 rows, each lane reads 16 weights of
// a row with one 16-byte load, 32 lanes 512 contiguous bytes, and the next
// 1024-column chunk's loads are issued before the current chunk computes.
// The weights are widened to f32 exactly and multiplied against the
// activation rows, staged as f32 in 1024-column chunks; the warp's lanes'
// sums meet by shuffles in a fixed order.
template <int B, bool MOE>
__global__ void __launch_bounds__(RV_THREADS)
int8_gemv_rows_kernel(const __nv_bfloat16* __restrict__ x,  // [B, in_features], or [E, B, ...]
                      const int8_t* __restrict__ w8,         // [E, OUT, ld] of one layer
                      const float* __restrict__ w_scale,     // [E, OUT]
                      __nv_bfloat16* __restrict__ out,       // [E, B, OUT]
                      int out_features, int in_features, int ld, int x_per_expert) {
  __shared__ __align__(16) float s_x[B][RV_CHUNK];

  if (MOE) {  // the expert (blockIdx.y) is a pointer offset
    const size_t ex = blockIdx.y;
    x += x_per_expert ? ex * B * in_features : 0;
    w8 += ex * out_features * ld;
    w_scale += ex * out_features;
    out += ex * B * out_features;
  }

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * RV_ROWS + warp * RV_R;
  const int8_t* wrow[RV_R];
  bool rvalid[RV_R];
#pragma unroll
  for (int r = 0; r < RV_R; ++r) {
    rvalid[r] = row0 + r < out_features;
    wrow[r] = w8 + (size_t)(rvalid[r] ? row0 + r : 0) * ld;
  }
  float acc[B][RV_R];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int r = 0; r < RV_R; ++r) acc[b][r] = 0.f;

  // a lane's 16 weights of each row and step of the chunk at c0 (zeros past the end)
  auto load_w = [&](uint4 (&dst)[RV_STEPS][RV_R], int c0) {
    const int n = in_features - c0;
#pragma unroll
    for (int s = 0; s < RV_STEPS; ++s) {
      const int c = s * RV_STEP + lane * 16;
#pragma unroll
      for (int r = 0; r < RV_R; ++r)
        dst[s][r] = (c < n && rvalid[r])
                        ? __ldcs(reinterpret_cast<const uint4*>(wrow[r] + c0 + c))
                        : make_uint4(0, 0, 0, 0);
    }
  };

  uint4 wv[RV_STEPS][RV_R];
  load_w(wv, 0);
  for (int c0 = 0; c0 < in_features; c0 += RV_CHUNK) {
    const int n = min(RV_CHUNK, in_features - c0);  // a multiple of 16
    __syncthreads();  // the previous chunk's readers are done with s_x
    for (int i = tid; i < B * (RV_CHUNK / 8); i += RV_THREADS) {
      const int b = i / (RV_CHUNK / 8), c8 = i % (RV_CHUNK / 8);
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
    uint4 wnext[RV_STEPS][RV_R];
    load_w(wnext, c0 + RV_CHUNK);
#pragma unroll
    for (int s = 0; s < RV_STEPS; ++s) {
      const int c = s * RV_STEP + lane * 16;
      if (c >= n) break;
      float wf[RV_R][16];
#pragma unroll
      for (int r = 0; r < RV_R; ++r) {
        s8x4_to_float(wv[s][r].x, wf[r]);
        s8x4_to_float(wv[s][r].y, wf[r] + 4);
        s8x4_to_float(wv[s][r].z, wf[r] + 8);
        s8x4_to_float(wv[s][r].w, wf[r] + 12);
      }
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
        for (int r = 0; r < RV_R; ++r)
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[b][r] = fmaf(xv[e], wf[r][e], acc[b][r]);
      }
    }
#pragma unroll
    for (int s = 0; s < RV_STEPS; ++s)
#pragma unroll
      for (int r = 0; r < RV_R; ++r) wv[s][r] = wnext[s][r];
  }

  // every lane ends with the warp's full sums; lane b * RV_R + r writes (b, r)
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int r = 0; r < RV_R; ++r) {
      float v = acc[b][r];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == b * RV_R + r && rvalid[r])
        out[(size_t)b * out_features + row0 + r] = __float2bfloat16(v * w_scale[row0 + r]);
    }
}

// ---------------------------------------------------------------------------
// decode at 3-8 rows: the tensor-core GEMV
// ---------------------------------------------------------------------------

constexpr int GV_WARPS = 16;
constexpr int GV_THREADS = GV_WARPS * 32;
constexpr int GV_ROWS = 16;                         // output rows of a tile: one m16 tile
constexpr int GV_RED = GV_WARPS * GV_ROWS * 8 * 4;  // one tile's warp sums, f32; two alternate
constexpr int GV_TILE = GV_ROWS * 8 * 4;            // one tile's f32 sums, kept between runs
constexpr int GV_UNIT = 64;    // columns: a warp's piece is whole units (64-byte aligned reads)
constexpr int GV_ITEM = 256;   // columns a warp takes at once: 16 rows x 256 bytes of weights
constexpr int GV_STAGES = 2;   // a warp's ring of items: the one it computes, the next in flight
constexpr int GV_STAGE = GV_ROWS * GV_ITEM;  // bytes of an item
constexpr int GV_CPR = GV_ITEM / 16;         // 16-byte chunks of an item's row
constexpr int GV_RPI = 32 / GV_CPR;          // rows a warp's copy instruction covers

// 16 weight bytes into shared memory by cp.async (L2 only), zeros where !ok
__device__ __forceinline__ void cp_w16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Where 16-byte chunk c of row r of a staged item lies: chunk c ^ gv_swz(r)
// of the row (the xor keeps a chunk in its aligned group of 8). The copies'
// phases (8 lanes, 8 chunks of a group of one row) and the fragment reads'
// phases (rows 2p and 2p + 1, chunks 4 seg .. 4 seg + 3: the first row's
// land in one half of the group, the second's in the other) each meet eight
// bank groups.
__device__ __forceinline__ int gv_swz(int r) { return ((r & 1) << 2) | ((r >> 1) & 3); }

// The GEMV's shared memory for T rows, `tiles` 16-row tiles over `blocks`
// blocks: two alternating buffers of the warps' sums; (where the contraction
// takes several runs, each tile's sums kept between them, `park`;) each
// warp's barrier for its activation copies; each warp's ring of GV_STAGES
// weight items; then each warp's own activation columns: T rows of `piece`
// columns (the largest piece a warp takes in a run: the contraction's
// 64-column units dealt into 16 x `chunks` contiguous pieces) and 16 bytes
// more, so that the rows of a phase's reads start 16 bytes apart from bank
// to bank. One run where the whole contraction fits, else the fewest runs
// that fit. int8_matmul.gemv_layout computes the same, and a launch whose
// runs or total differ is refused.
struct GemvLayout {
  int chunks, piece, total_;
  __host__ __device__ GemvLayout(int T, int in_features, int tiles, int blocks) {
    const int n_units = (in_features + GV_UNIT - 1) / GV_UNIT;
    const int run = (tiles + blocks - 1) / blocks;  // the most tiles a block walks
    for (chunks = 1;; ++chunks) {
      const int pieces = GV_WARPS * chunks;
      piece = (n_units + pieces - 1) / pieces * GV_UNIT;
      total_ = 2 * GV_RED + (chunks > 1 ? run * GV_TILE : 0) + GV_WARPS * 8 +
               GV_WARPS * GV_STAGES * GV_STAGE + GV_WARPS * T * (2 * piece + 16);
      if (total_ <= T_SMEM_LIMIT || n_units <= pieces) break;
    }
  }
  __host__ __device__ int total() const { return total_; }
};

// y^T = W x^T on the tensor cores: W is the 16-row A operand, the (at most 8)
// activation rows the 8-column B operand. One block of 16 warps an SM walks
// a contiguous run of 16-row tiles (tile t: expert t / row_tiles); in run c
// warp w takes the contraction's piece q = 16 c + w (columns [k0, k1), whole
// 64-column units, the last piece ending at in_features) of every tile, in
// items of GV_ITEM columns, and the warps' sums meet in shared memory,
// added in warp order. A warp copies each item into its ring in shared
// memory by cp.async, a lane 16 bytes, two rows' 256 contiguous bytes an
// instruction (whole cache lines in long runs: the fragments' own layout
// would read eight rows' 64-byte halves an instruction, which device memory
// serves more slowly), zeros past OUT and past the piece, and keeps the
// next GV_STAGES - 1 items (across tiles and runs) in flight while one
// computes. A thread then reads chunk 4 seg + tig (segment seg) of rows gid
// and gid + 8 of the item; word s of a segment's chunk gives its A values of
// one k16 step (its columns j0 .. j0 + 3 stand for mma k 2 tig, 2 tig + 1,
// 2 tig + 8, 2 tig + 9) and its B values are x[gid][j0 .. j0 + 3], read
// from the warp's own staged activation columns (each warp takes the same
// piece in every tile, so it stages it once, and waits for no other
// warp's). The sums' two buffers let a tile end at one barrier.
template <bool MOE>
__global__ void __launch_bounds__(GV_THREADS, 1)
int8_gemv_kernel(const __nv_bfloat16* __restrict__ x,  // [T, in_features], or [E, T, ...]
                 const int8_t* __restrict__ w8,         // [E, OUT, ld] of one layer
                 const float* __restrict__ w_scale,     // [E, OUT]
                 __nv_bfloat16* __restrict__ out,       // [E, T, OUT]
                 int T, int out_features, int in_features, int ld, int experts,
                 int x_per_expert, int chunks, int piece) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_tiles = (out_features + GV_ROWS - 1) / GV_ROWS;
  const int tiles = (MOE ? experts : 1) * row_tiles;
  const int n_units = (in_features + GV_UNIT - 1) / GV_UNIT, pieces = GV_WARPS * chunks;
  const int run = (tiles + gridDim.x - 1) / gridDim.x;
  const int xs = 2 * piece + 16;  // bytes of a staged activation row
  float* park = reinterpret_cast<float*>(smem + 2 * GV_RED);  // [run][16][8]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  // this warp's barrier, item ring [GV_STAGES][16][128] and staged columns [T][xs bytes]
  uint64_t* xbar =
      reinterpret_cast<uint64_t*>(smem + 2 * GV_RED + (chunks > 1 ? run * GV_TILE : 0)) + warp;
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(xbar - warp + GV_WARPS) + warp * GV_STAGES * GV_STAGE;
  unsigned char* xw = ring + (GV_WARPS - warp) * GV_STAGES * GV_STAGE + (size_t)warp * T * xs;
  const int t_begin = blockIdx.x * tiles / gridDim.x;
  const int t_end = (blockIdx.x + 1) * tiles / gridDim.x;
  const size_t w_expert = (size_t)out_features * ld;
  // this warp's piece of run c: columns [k0, k1), possibly empty
  auto piece_of = [&](int c, int& k0, int& k1) {
    const int q = c * GV_WARPS + warp;
    k0 = GV_UNIT * (q * n_units / pieces);
    k1 = min(in_features, GV_UNIT * ((q + 1) * n_units / pieces));
  };

  // the copy cursor (run lc, tile lt, item lj; lc's piece [lk0, lk1) of ln
  // items) walks the warp's items in compute order; lc == chunks past the last
  int lc = 0, lt = t_begin, lj = 0, lk0 = 0, lk1 = 0, ln = 0;
  auto next_run = [&]() {
    for (; lc < chunks; ++lc) {
      piece_of(lc, lk0, lk1);
      ln = (lk1 - lk0 + GV_ITEM - 1) / GV_ITEM;
      if (ln > 0) return;
    }
  };
  next_run();
  // the item at the cursor into ring slot `st`: lane l copies chunk l %
  // GV_CPR of rows GV_RPI i + l / GV_CPR (zeros past the piece and past OUT),
  // one commit group an item (an empty one past the last); then advance
  auto copy_w = [&](int st) {
    if (lc < chunks) {
      const int e = MOE ? lt / row_tiles : 0;
      const int col = lk0 + GV_ITEM * lj + 16 * (lane % GV_CPR);
      const int8_t* w = w8 + (MOE ? e * w_expert : 0) + col;
      const int row0 = (lt - e * row_tiles) * GV_ROWS;
      unsigned char* d = ring + st * GV_STAGE;
#pragma unroll
      for (int i = 0; i < GV_ROWS / GV_RPI; ++i) {
        const int r = GV_RPI * i + lane / GV_CPR;
        const bool ok = row0 + r < out_features && col < lk1;
        cp_w16(d + r * GV_ITEM + 16 * ((lane % GV_CPR) ^ gv_swz(r)),
               ok ? w + (size_t)(row0 + r) * ld : w8, ok);
      }
      if (++lj == ln) {
        lj = 0;
        if (++lt == t_end) {
          lt = t_begin;
          ++lc;
          next_run();
        }
      }
    }
    aqlm::cp_async_commit();
  };

  // the warp's piece [k0, k1) of expert e's activations into its rows: lane
  // 0 bulk-copies each row, completing on the warp's barrier, which it waits
  // on (wait_x) only before their first use
  int x_phase = 0;
  if (lane == 0) {
    aqlm::mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto issue_x = [&](int k0, int k1, int e) {
    const __nv_bfloat16* xe = x + (MOE && x_per_expert ? (size_t)e * T * in_features : 0) + k0;
    const int bytes = 2 * (k1 - k0);
    __syncwarp();  // the lanes' reads of the columns staged before come first
    if (lane == 0) {
      aqlm::fence_proxy_async();
      aqlm::mbar_arrive_expect_tx(xbar, T * bytes);
      for (int r = 0; r < T; ++r)
        aqlm::bulk_copy(xw + (size_t)r * xs, xe + (size_t)r * in_features, bytes, xbar);
    }
  };
  auto wait_x = [&]() {
    aqlm::mbar_wait(xbar, x_phase);
    x_phase ^= 1;
    __syncwarp();
  };

  // one item's products: the thread's chunks of ring slot `st` against its
  // staged activation columns; len: the piece's columns from the item's start
  auto item = [&](int st, int j, int len, float (&acc)[4]) {
    const unsigned char* sw = ring + st * GV_STAGE;
#pragma unroll
    for (int seg = 0; seg < GV_ITEM / 64; ++seg) {
      if (64 * seg >= len) break;  // a segment wholly past the piece meets zeros
      const int ch = 4 * seg + tig;
      const uint4 w0 = *reinterpret_cast<const uint4*>(sw + gid * GV_ITEM + 16 * (ch ^ gv_swz(gid)));
      const uint4 w1 =
          *reinterpret_cast<const uint4*>(sw + (gid + 8) * GV_ITEM + 16 * (ch ^ gv_swz(gid + 8)));
      // x[gid][j0 .. j0 + 15] of the segment: the B values of this thread's four steps
      uint4 xv[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
      if (gid < T && 64 * seg + 16 * tig < len) {
        const unsigned char* xp = xw + (size_t)gid * xs + 2 * (GV_ITEM * j + 64 * seg + 16 * tig);
        xv[0] = *reinterpret_cast<const uint4*>(xp);
        xv[1] = *reinterpret_cast<const uint4*>(xp + 16);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t a[4];
        s8x4_to_bf16x2(word_of(w0, s), a[0], a[2]);
        s8x4_to_bf16x2(word_of(w1, s), a[1], a[3]);
        mma_bf16_16816(acc, a, word_of(xv[s >> 1], 2 * (s & 1)),
                       word_of(xv[s >> 1], 2 * (s & 1) + 1));
      }
    }
  };

#pragma unroll
  for (int st = 0; st + 1 < GV_STAGES; ++st) copy_w(st);
  int slot = 0;  // the ring slot of the next item to compute
  int x_c = -1, x_e = -1;  // the run and expert whose activations are staged
  bool x_wait = false;
  int k = 0;  // tiles ended so far: their parity picks the sums' buffer
  for (int c = 0; c < chunks; ++c) {
    int k0, k1;
    piece_of(c, k0, k1);
    const int pt = (k1 - k0 + GV_ITEM - 1) / GV_ITEM;  // items of this warp's piece
    for (int t = t_begin; t < t_end; ++t, ++k) {
      const int e = MOE ? t / row_tiles : 0;
      if (pt > 0 && (x_c != c || (MOE && x_per_expert && e != x_e))) {
        issue_x(k0, k1, e);
        x_c = c;
        x_e = e;
        x_wait = true;
      }
      // element q: row gid + 8 (q >> 1), activation row 2 tig + (q & 1)
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < pt; ++j) {
        // the item GV_STAGES - 1 ahead goes into the slot the last item left
        // (every lane is done reading it), then this one's copies are awaited
        __syncwarp();
        copy_w(slot == 0 ? GV_STAGES - 1 : slot - 1);
        aqlm::cp_async_wait<GV_STAGES - 1>();
        __syncwarp();
        if (x_wait) {
          wait_x();
          x_wait = false;
        }
        item(slot, j, k1 - k0 - GV_ITEM * j, acc);
        slot = slot + 1 == GV_STAGES ? 0 : slot + 1;
      }

      // the warps' sums meet in shared memory and are added in warp order
      // (then to the earlier runs' sum of the tile, kept in `park`). The
      // warps of a block keep to one tile: letting warps run ahead to the
      // next tile (split barriers) spread their reads over more rows and was
      // slower.
      float* red = reinterpret_cast<float*>(smem) + (k & 1) * (GV_RED / 4);  // [GV_WARPS][16][8]
#pragma unroll
      for (int q = 0; q < 4; ++q)
        red[(warp * GV_ROWS + gid + 8 * (q >> 1)) * 8 + 2 * tig + (q & 1)] = acc[q];
      __syncthreads();
      if (tid < GV_ROWS * 8) {
        const int rr = tid / 8, bb = tid % 8, row = (t - e * row_tiles) * GV_ROWS + rr;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < GV_WARPS; ++w) v += red[(w * GV_ROWS + rr) * 8 + bb];
        float* pk = park + (t - t_begin) * (GV_TILE / 4) + tid;
        if (c > 0) v = *pk + v;
        if (c + 1 < chunks) *pk = v;
        else if (bb < T && row < out_features)
          out[((size_t)e * T + bb) * out_features + row] =
              __float2bfloat16(v * __ldg(w_scale + (size_t)e * out_features + row));
      }
    }
  }
  aqlm::cp_async_wait<0>();  // the empty groups past the last item
}

template <bool MOE>
int gemv_dispatch(const void* x, const void* w8, const void* w_scale, void* out, int experts,
                  int x_per_expert, int T, int out_features, int in_features, int ld, int blocks,
                  int runs, int smem, cudaStream_t st) {
  const int tiles = experts * ((out_features + GV_ROWS - 1) / GV_ROWS);
  if (T <= RV_MAX_T) {  // the row kernel: a block a tile, static shared memory
    if (blocks != tiles || runs != 0 || smem != 0) return cudaErrorInvalidValue;
    const dim3 grid((out_features + RV_ROWS - 1) / RV_ROWS, experts);
    if (T == 1)
      int8_gemv_rows_kernel<1, MOE><<<grid, RV_THREADS, 0, st>>>(
          (const __nv_bfloat16*)x, (const int8_t*)w8, (const float*)w_scale, (__nv_bfloat16*)out,
          out_features, in_features, ld, x_per_expert);
    else
      int8_gemv_rows_kernel<2, MOE><<<grid, RV_THREADS, 0, st>>>(
          (const __nv_bfloat16*)x, (const int8_t*)w8, (const float*)w_scale, (__nv_bfloat16*)out,
          out_features, in_features, ld, x_per_expert);
    return cudaGetLastError();
  }
  if (blocks < 1 || blocks > tiles) return cudaErrorInvalidValue;
  const GemvLayout lo(T, in_features, tiles, blocks);
  if (runs != lo.chunks || smem != lo.total() || smem > T_SMEM_LIMIT) return cudaErrorInvalidValue;
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_gemv_kernel<MOE>, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  int8_gemv_kernel<MOE><<<blocks, GV_THREADS, smem, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w8, (const float*)w_scale, (__nv_bfloat16*)out, T,
      out_features, in_features, ld, experts, x_per_expert, lo.chunks, lo.piece);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward (B10): dx = bf16(g * w_scale) @ w8
// ---------------------------------------------------------------------------
//
// The contraction runs over OUT, w8's row index; dx has w8's column count
// (ld = IN_pad). Two paths, laid out by the wrapper's planning function
// (int8_matmul.plan_t):
//
// - T <= 8, a column GEMV, bound by bytes: w8 is read once (q 4096 x 4096 at
//   T = 1: 16.8 MB, 5.0 us at 3.35 TB/s). A block owns CW = 32 * VW columns
//   of dx and a run of OUT rows (a split). bf16(g * scale) of that run is
//   staged once in shared memory as f32, rounded as the TPU wrapper rounds
//   it (aqlm_tpu/ops/int8_matmul.py:176). Each warp walks every eighth
//   4-row run of OUT: a lane loads VW consecutive bytes of a w8 row (16 at
//   T <= 4, 8 past it, so that the lane's VW x T sums stay in 64 registers),
//   neighbouring lanes neighbouring bytes, four rows in flight; the int8 is
//   widened exactly (a byte-permute into a float's mantissa, s8x4_to_float)
//   and multiplied into the f32 sums. The eight warps' sums meet in shared
//   memory in warp order; the splits (enough to fill the card twice) meet in
//   a fixed-order last-block reduction (an atomic ticket per column block,
//   zeroed again by that block), so the result does not depend on block
//   timing.
// - T > 8, a warp-specialised GEMM, bound by operations (2 * T * OUT * ld on
//   the bf16 tensor cores; gate at T = 1024: 92 GFLOP, 0.093 ms at 989
//   TFLOP/s), in K2's shape (gather_prefill.cu). First a small kernel writes
//   bf16(g * scale) [T, OUT] once (the A operand is the same for every column
//   block: widening it in each, 32 times at IN 4096, left the widening warps
//   the slowest role). Then 384 threads own a BM x 128 tile of dx (BM 256
//   past 256 rows, else 128) and walk OUT in 64-row slabs:
//     - warp 8, the producer, keeps a ring of 2-4 stages of TMA copies in
//       flight: the A tile [BM x 64 OUT] (128-byte swizzle) and the int8 w8
//       slab [64 OUT x 128 IN], each on its own mbarrier; rows past T, OUT or
//       ld arrive as zeros;
//     - warps 9-11 widen the w8 slab into one of two bf16 W^T buffers,
//       straight into wgmma's K-major core-matrix layout (exact: |w8| <= 127;
//       each thread transposes an 8 x 4 byte block, its four 16-byte stores
//       rotated so that a phase's eight fall on eight bank groups);
//     - warps 0-7, two consumer warpgroups, run wgmma.mma_async m64n128k16
//       (A through a 128B-swizzle descriptor, W^T an unswizzled one) with f32
//       sums, keeping one slab's products in flight while the next slab's
//       barriers are awaited. Per-stage full/empty barriers replace
//       block-wide syncs.
//   Where the output tiles would leave the card idle (T = 200 at IN 4096:
//   64 tiles), OUT is split over blocks and the f32 partial tiles meet in the
//   same fixed-order last-block reduction. The epilogue casts to bf16.

constexpr int TV_THREADS = 256;  // GEMV: eight warps
constexpr int TV_WARPS = TV_THREADS / 32;
constexpr int TV_UNROLL = 4;     // w8 rows a warp has in flight

template <int T>
struct GemvT {
  static constexpr int VW = T <= 4 ? 16 : 8;  // w8 bytes (dx columns) a lane loads from a row
  static constexpr int CW = 32 * VW;          // dx columns of a block
  static constexpr int TP = T == 1 ? 1 : T == 2 ? 2 : T <= 4 ? 4 : 8;  // staged g row width
};

// The GEMV's dynamic shared memory: the staged bf16(g * scale) [rows][TP]
// f32, then the warps' sums [8][T][CW] f32 (int8_matmul.plan_t computes the same).
__host__ __device__ inline int gemv_t_smem(int T, int rows) {
  const int vw = T <= 4 ? 16 : 8, tp = T == 1 ? 1 : T == 2 ? 2 : T <= 4 ? 4 : 8;
  return rows * tp * 4 + TV_WARPS * T * 32 * vw * 4;
}

template <int T>
__global__ void __launch_bounds__(TV_THREADS, 2)
int8_gemv_t_kernel(const void* __restrict__ g,           // [T, OUT] bf16, or f32 when g_f32
                   const int8_t* __restrict__ w8,        // [OUT, ld]
                   const float* __restrict__ w_scale,    // [OUT]
                   __nv_bfloat16* __restrict__ out,      // [T, ld]
                   float* __restrict__ partials,         // [splits, T, ld] when split
                   int* __restrict__ tickets,            // [column blocks], zero, when split
                   int g_f32, int out_features, int ld, int rows_per_split) {
  using S = GemvT<T>;
  constexpr int VW = S::VW, CW = S::CW, TP = S::TP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_g = reinterpret_cast<float*>(smem);     // [rows_per_split][TP]
  float* s_red = s_g + rows_per_split * TP;        // [TV_WARPS][T][CW]
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int col0 = blockIdx.x * CW;
  const int o_begin = blockIdx.y * rows_per_split;
  const int rows = min(rows_per_split, out_features - o_begin);

  // bf16(g * scale) of the split's rows, zeros past OUT and past T
  for (int i = tid; i < rows_per_split * TP; i += TV_THREADS) {
    const int t = i / rows_per_split, r = i % rows_per_split;
    float v = 0.f;
    if (t < T && r < rows) {
      const size_t at = (size_t)t * out_features + o_begin + r;
      const float gv = g_f32 ? static_cast<const float*>(g)[at]
                             : __bfloat162float(static_cast<const __nv_bfloat16*>(g)[at]);
      v = __bfloat162float(__float2bfloat16(gv * w_scale[o_begin + r]));
    }
    s_g[r * TP + t] = v;
  }
  __syncthreads();

  const int c = col0 + lane * VW;
  const bool cvalid = c < ld;  // ld % 16 == 0: a lane's VW columns are all in or all out
  const int8_t* wp = w8 + (size_t)o_begin * ld + (cvalid ? c : 0);
  float acc[T][VW];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[t][e] = 0.f;

  for (int r0 = warp * TV_UNROLL; r0 < rows; r0 += TV_WARPS * TV_UNROLL) {
    uint32_t wv[TV_UNROLL][VW / 4];
#pragma unroll
    for (int u = 0; u < TV_UNROLL; ++u) {
      const bool ok = cvalid && r0 + u < rows;
      if constexpr (VW == 16) {
        const uint4 v = ok ? __ldcs(reinterpret_cast<const uint4*>(wp + (size_t)(r0 + u) * ld))
                           : make_uint4(0, 0, 0, 0);
        wv[u][0] = v.x; wv[u][1] = v.y; wv[u][2] = v.z; wv[u][3] = v.w;
      } else {
        const uint2 v = ok ? __ldcs(reinterpret_cast<const uint2*>(wp + (size_t)(r0 + u) * ld))
                           : make_uint2(0, 0);
        wv[u][0] = v.x; wv[u][1] = v.y;
      }
    }
#pragma unroll
    for (int u = 0; u < TV_UNROLL; ++u) {
      // rows past `rows` hold zeros in s_g (rows_per_split is a multiple of 32)
      float gs[TP];
      const float* gp = s_g + (r0 + u) * TP;
      if constexpr (TP == 1) {
        gs[0] = gp[0];
      } else if constexpr (TP == 2) {
        const float2 v = *reinterpret_cast<const float2*>(gp);
        gs[0] = v.x; gs[1] = v.y;
      } else {
#pragma unroll
        for (int q = 0; q < TP / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(gp)[q];
          gs[4 * q] = v.x; gs[4 * q + 1] = v.y; gs[4 * q + 2] = v.z; gs[4 * q + 3] = v.w;
        }
      }
#pragma unroll
      for (int q = 0; q < VW / 4; ++q) {
        float f[4];
        s8x4_to_float(wv[u][q], f);
#pragma unroll
        for (int t = 0; t < T; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][4 * q + e] = fmaf(gs[t], f[e], acc[t][4 * q + e]);
      }
    }
  }

  // the warps' sums, added in warp order
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int q = 0; q < VW / 4; ++q)
      reinterpret_cast<float4*>(s_red + (warp * T + t) * CW + lane * VW)[q] =
          make_float4(acc[t][4 * q], acc[t][4 * q + 1], acc[t][4 * q + 2], acc[t][4 * q + 3]);
  __syncthreads();
  for (int i = tid; i < T * CW; i += TV_THREADS) {
    const int t = i / CW, cc = i % CW, col = col0 + cc;
    if (col >= ld) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < TV_WARPS; ++w) s += s_red[(w * T + t) * CW + cc];
    if (gridDim.y == 1)
      out[(size_t)t * ld + col] = __float2bfloat16(s);
    else
      partials[((size_t)blockIdx.y * T + t) * ld + col] = s;
  }
  if (gridDim.y == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {  // every split has taken its ticket once the last has: zero it for the next launch
    s_last = atomicAdd(tickets + blockIdx.x, 1) == (int)gridDim.y - 1;
    if (s_last) tickets[blockIdx.x] = 0;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < T * CW; i += TV_THREADS) {
    const int t = i / CW, col = col0 + i % CW;
    if (col >= ld) continue;
    float s = 0.f;
    for (int sp = 0; sp < (int)gridDim.y; ++sp)
      s += __ldcg(partials + ((size_t)sp * T + t) * ld + col);
    out[(size_t)t * ld + col] = __float2bfloat16(s);
  }
}

template <int T>
cudaError_t gemv_t_launch(const void* g, const void* w8, const void* w_scale, void* out,
                          void* partials, void* tickets, int g_f32, int out_features, int ld,
                          int splits, int rows_per_split, int smem, cudaStream_t stream) {
  static int smem_set = 0;  // one per instantiation: the largest size opted into so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemv_t_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid((ld + GemvT<T>::CW - 1) / GemvT<T>::CW, splits);
  int8_gemv_t_kernel<T><<<grid, TV_THREADS, smem, stream>>>(
      g, (const int8_t*)w8, (const float*)w_scale, (__nv_bfloat16*)out, (float*)partials,
      (int*)tickets, g_f32, out_features, ld, rows_per_split);
  return cudaGetLastError();
}

// bf16(g * scale) [T, OUT] for the GEMM: computed once here, not once per
// column block (the A operand is the same for all of them), rounded as the
// TPU wrapper rounds it. Eight elements a thread (OUT % 8 == 0).
__global__ void __launch_bounds__(256)
int8_scale_g_kernel(const void* __restrict__ g, const float* __restrict__ w_scale,
                    __nv_bfloat16* __restrict__ gs, int g_f32, int out_features, long long n8) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const int o = (int)(i * 8 % out_features);
  float f[8];
  if (g_f32) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(g) + 2 * i);
    const float4 b = __ldg(reinterpret_cast<const float4*>(g) + 2 * i + 1);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    aqlm::bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(g) + i), f);
  }
  const float4 a = __ldg(reinterpret_cast<const float4*>(w_scale + o));
  const float4 b = __ldg(reinterpret_cast<const float4*>(w_scale + o) + 1);
  reinterpret_cast<uint4*>(gs)[i] =
      make_uint4(pack_bf16x2(f[0] * a.x, f[1] * a.y), pack_bf16x2(f[2] * a.z, f[3] * a.w),
                 pack_bf16x2(f[4] * b.x, f[5] * b.y), pack_bf16x2(f[6] * b.z, f[7] * b.w));
}

constexpr int TG_THREADS = 384;
constexpr int TG_PRODUCER = 8;        // warp 8
constexpr int TG_WIDEN = 96;          // warps 9-11
constexpr int TG_CONSUMERS = 8;       // warps 0-7: two warpgroups
constexpr int TG_BN = 128;            // dx columns per block (w8 columns)
constexpr int TG_BK = 64;             // OUT rows (the contraction) per slab
constexpr int TG_W8 = TG_BK * TG_BN;  // bytes of an int8 slab
constexpr int TG_B = TG_BN * TG_BK * 2;  // bytes of a widened W^T tile
constexpr int TG_MAX_STAGES = 4;

// Byte offsets in the GEMM's dynamic shared memory from its first
// 1024-aligned byte (the swizzled A tiles need it; hence the 1024 bytes of
// slack in the total); int8_matmul.plan_t computes the same total, and a
// launch whose total differs is refused.
struct TLayout {
  int bm, stages;
  __host__ __device__ TLayout(int bm_, int st) : bm(bm_), stages(st) {}
  __host__ __device__ int a(int s) const { return s * bm * TG_BK * 2; }
  __host__ __device__ int w8(int s) const { return a(stages) + s * TG_W8; }
  __host__ __device__ int bt(int b) const { return w8(stages) + b * TG_B; }
  __host__ __device__ int bar() const { return bt(2); }
  __host__ __device__ int n_bars() const { return 3 * stages + 4; }
  __host__ __device__ int flag() const { return bar() + n_bars() * 8; }
  __host__ __device__ int total() const { return flag() + 16 + 1024; }
};

// MT: 64-row wgmma tiles per consumer warpgroup (BM = 128 * MT).
template <int MT>
__global__ void __launch_bounds__(TG_THREADS, 1)
int8_gemm_t_kernel(const __grid_constant__ CUtensorMap a_map,  // bf16(g * scale) [T, OUT]
                   const __grid_constant__ CUtensorMap w_map,  // w8 [OUT, ld] int8
                   __nv_bfloat16* __restrict__ out,            // [T, ld]
                   float* __restrict__ partials,               // [splits, Tpad, ld] when split
                   int* __restrict__ tickets,                  // [row tiles, col tiles], zero
                   int T, int out_features, int ld, int splits, int slabs_per_split,
                   int stages) {
  constexpr int BM = 128 * MT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const TLayout L(BM, stages);
  uint64_t* afull = reinterpret_cast<uint64_t*>(smem + L.bar());
  uint64_t* wfull = afull + stages;
  uint64_t* empty = wfull + stages;
  uint64_t* bfull = empty + stages;
  uint64_t* bempty = bfull + 2;
  int& s_last = *reinterpret_cast<int*>(smem + L.flag());

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * TG_BN, row0 = blockIdx.y * BM, sp = blockIdx.z;
  const int n_slabs = (out_features + TG_BK - 1) / TG_BK;
  const int s_begin = sp * slabs_per_split;
  const int n_local = min(n_slabs, s_begin + slabs_per_split) - s_begin;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(afull + i, 1);  // the producer's expect_tx; its TMA completes it
      mbar_init(wfull + i, 1);
      mbar_init(empty + i, TG_CONSUMERS + TG_WIDEN / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(bfull + i, TG_WIDEN / 32);
      mbar_init(bempty + i, TG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == TG_PRODUCER) {
    // slab j -> stage j % stages, refilled once its consumers and widening
    // warps released it
    if (lane == 0) {
      for (int j = 0; j < n_local; ++j) {
        const int st = j % stages, o0 = (s_begin + j) * TG_BK;
        if (j >= stages) mbar_wait(empty + st, (j / stages - 1) & 1);
        mbar_arrive_expect_tx(wfull + st, TG_W8);
        tma_load_2d(smem + L.w8(st), &w_map, col0, o0, wfull + st);
        mbar_arrive_expect_tx(afull + st, BM * TG_BK * 2);
        tma_load_2d(smem + L.a(st), &a_map, o0, row0, afull + st);
      }
    }
  } else if (warp > TG_PRODUCER) {
    // W^T: the int8 slab [64 o][128 i] -> bf16 core matrices (i / 8, o / 8),
    // each 16-byte row eight o of one i, into buffer j % 2. A unit is 8 rows x
    // 4 columns (eight word reads).
    const int dt = tid - (TG_PRODUCER + 1) * 32;
    for (int j = 0; j < n_local; ++j) {
      const int st = j % stages, wb = j & 1;
      mbar_wait(wfull + st, (j / stages) & 1);
      if (j >= 2) mbar_wait(bempty + wb, (j / 2 - 1) & 1);
      const unsigned char* sw = smem + L.w8(st);
      unsigned char* sb = smem + L.bt(wb);
      for (int u = dt; u < (TG_BK / 8) * (TG_BN / 4); u += TG_WIDEN) {
        const int ob = u / (TG_BN / 4), iq = u % (TG_BN / 4);
        uint32_t wv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          wv[r] = *reinterpret_cast<const uint32_t*>(sw + (ob * 8 + r) * TG_BN + iq * 4) ^
                  0x80808080u;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int c = (cc + (iq >> 1)) & 3;  // rotated: a phase's 8 stores on 8 bank groups
          const uint32_t sel = 0x7650u + c;
          float f[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            f[r] = __uint_as_float(__byte_perm(wv[r], 0x4B000000u, sel)) - 8388736.f;
          const int i = iq * 4 + c;
          *reinterpret_cast<uint4*>(sb + ((i >> 3) * (TG_BK / 8) + ob) * 128 + (i & 7) * 16) =
              make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                         pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
        }
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bfull + wb);
        mbar_arrive(empty + st);
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [wg * 64 * MT, (wg + 1) * 64 * MT) of the tile
    const int wg = warp >> 2;
    const bool active = row0 + wg * 64 * MT < T;  // a warpgroup of padding rows only waits
    float acc[MT][64];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
    for (int j = 0; j < n_local; ++j) {
      const int st = j % stages, wb = j & 1;
      mbar_wait(afull + st, (j / stages) & 1);
      mbar_wait(bfull + wb, (j / 2) & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      if (active) {
        fence_proxy_async();
        wgmma_fence();
        const unsigned char* sa = smem + L.a(st);
        const unsigned char* sb = smem + L.bt(wb);
#pragma unroll
        for (int kk = 0; kk < TG_BK / 16; ++kk) {
          const uint64_t db = make_desc(sb + kk * 256);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wgmma_m64n128k16(acc[m], make_desc_sw128(sa + (wg * MT + m) * 64 * TG_BK * 2 + kk * 32),
                             db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // slab j - 1's products are done
      }
      if (j > 0) {
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(empty + (j - 1) % stages);
          mbar_arrive(bempty + ((j - 1) & 1));
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
        for (int c = 0; c < TG_BN / 8; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = rbase + m * 64 + 8 * h, col = cbase + 8 * c;
            if (row < T && col < ld)
              *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * ld + col) =
                  __floats2bfloat162_rn(acc[m][4 * c + 2 * h], acc[m][4 * c + 2 * h + 1]);
          }
      return;
    }
    // split contraction: park the f32 partial tile, the last block sums
    const int t_pad = gridDim.y * BM;
    float* part = partials + (size_t)sp * t_pad * ld;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < TG_BN / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rbase + m * 64 + 8 * h, col = cbase + 8 * c;
          if (row < T && col < ld)
            *reinterpret_cast<float2*>(part + (size_t)row * ld + col) =
                make_float2(acc[m][4 * c + 2 * h], acc[m][4 * c + 2 * h + 1]);
        }
    __threadfence();
    asm volatile("bar.sync 1, %0;\n" ::"n"(TG_CONSUMERS * 32) : "memory");
    if (tid == 0) {  // the last split zeroes the tile's ticket for the next launch
      int* tk = tickets + blockIdx.y * gridDim.x + blockIdx.x;
      s_last = atomicAdd(tk, 1) == splits - 1;
      if (s_last) *tk = 0;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(TG_CONSUMERS * 32) : "memory");
    if (!s_last) return;
    __threadfence();
    for (int i = tid; i < BM * (TG_BN / 4); i += TG_CONSUMERS * 32) {
      const int row = row0 + i / (TG_BN / 4), col = col0 + (i % (TG_BN / 4)) * 4;
      if (row >= T || col >= ld) continue;  // ld % 16 == 0: four columns all in or all out
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int z = 0; z < splits; ++z) {
        const float4 pz = __ldcg(reinterpret_cast<const float4*>(
            partials + ((size_t)z * t_pad + row) * ld + col));
        v.x += pz.x;
        v.y += pz.y;
        v.z += pz.z;
        v.w += pz.w;
      }
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * ld + col);
      o[0] = __floats2bfloat162_rn(v.x, v.y);
      o[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  }
}

template <int MT>
cudaError_t gemm_t_launch(const void* g, const void* w8, const void* w_scale, void* out,
                          void* partials, void* tickets, void* gs, int g_f32, int T,
                          int out_features, int ld, int splits, int slabs_per_split, int stages,
                          int smem, cudaStream_t stream) {
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemm_t_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  constexpr int BM = 128 * MT;
  const EncodeTiled encode = encoder();
  if (!encode) return cudaErrorNotSupported;
  const long long n8 = (long long)T * out_features / 8;
  int8_scale_g_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, stream>>>(
      g, (const float*)w_scale, (__nv_bfloat16*)gs, g_f32, out_features, n8);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const cuuint32_t unit[2] = {1, 1};
  // bf16(g * scale) [T][OUT]: boxes of 64 columns x BM rows, 128B-swizzled
  CUtensorMap a_map;
  const cuuint64_t a_dims[2] = {(cuuint64_t)out_features, (cuuint64_t)T};
  const cuuint64_t a_strides[1] = {(cuuint64_t)out_features * 2};
  const cuuint32_t a_box[2] = {TG_BK, (cuuint32_t)BM};
  if (encode(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, gs, a_dims, a_strides, a_box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // w8 [OUT][ld]: boxes of 128 columns x 64 rows, unswizzled
  CUtensorMap w_map;
  const cuuint64_t w_dims[2] = {(cuuint64_t)ld, (cuuint64_t)out_features};
  const cuuint64_t w_strides[1] = {(cuuint64_t)ld};
  const cuuint32_t w_box[2] = {TG_BN, TG_BK};
  if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w8), w_dims, w_strides,
             w_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const dim3 grid((ld + TG_BN - 1) / TG_BN, (T + BM - 1) / BM, splits);
  int8_gemm_t_kernel<MT><<<grid, TG_THREADS, smem, stream>>>(
      a_map, w_map, (__nv_bfloat16*)out, (float*)partials, (int*)tickets, T, out_features, ld,
      splits, slabs_per_split, stages);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// prefill: T > 8, the forward GEMM (int8_matmul.plan lays it out)
// ---------------------------------------------------------------------------

constexpr int FG_BN = 128;    // output channels (w8 rows) per block
constexpr int FG_BK = 64;     // contraction columns per slab
constexpr int FG_WIDEN = 96;  // widening threads: the three warps after the producer
constexpr int FG_MAX_STAGES = 8;

// Widening unit u of a slab: 16 bytes (column chunk kp) of w8 row n. The
// eight lanes of a 16-byte phase (u = 8 p + q) take rows 8 (p / 4) + q, so
// their stores (core-matrix row n % 8) meet eight bank groups, and rotate
// their chunk by q / 2 + p, so that their reads (64-byte rows: bank group
// 4 (n % 2) + kp) do too; the four phases of a row group cover its chunks.
__device__ __forceinline__ void widen_unit(int u, int& n, int& kp) {
  const int p = u >> 3, q = u & 7;
  n = (p >> 2) * 8 + q;
  kp = ((q >> 1) + p) & 3;
}

// Two bf16 of a row written as one pair where OUT is even (col is), else
// one by one, the second only inside OUT.
__device__ __forceinline__ void store_out(__nv_bfloat16* o, bool pair, bool second, float a,
                                          float b) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
  } else {
    o[0] = __float2bfloat16(a);
    if (second) o[1] = __float2bfloat16(b);
  }
}

// One w8 slab widened into W^T by the FG_WIDEN widening threads (dt: this
// thread's index among them). A thread's units are u = dt + FG_WIDEN i; all
// its loads are issued first, so that their latencies overlap.
__device__ __forceinline__ void widen_slab(const unsigned char* __restrict__ sw,
                                           unsigned char* __restrict__ sb, int dt) {
  constexpr int UNITS = (FG_BN * 4 + FG_WIDEN - 1) / FG_WIDEN;
  uint4 v[UNITS];
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int u = dt + i * FG_WIDEN;
    int n, kp;
    widen_unit(u, n, kp);
    if (u < FG_BN * 4) v[i] = *reinterpret_cast<const uint4*>(sw + n * FG_BK + kp * 16);
  }
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int u = dt + i * FG_WIDEN;
    if (u >= FG_BN * 4) continue;
    int n, kp;
    widen_unit(u, n, kp);
    uint32_t h[8];
    s8x4_to_bf16x2(v[i].x, h[0], h[1]);
    s8x4_to_bf16x2(v[i].y, h[2], h[3]);
    s8x4_to_bf16x2(v[i].z, h[4], h[5]);
    s8x4_to_bf16x2(v[i].w, h[6], h[7]);
    unsigned char* d = sb + ((n >> 3) * (FG_BK / 8) + 2 * kp) * 128 + (n & 7) * 16;
    *reinterpret_cast<uint4*>(d) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(d + 128) = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// MT: 64-row wgmma tiles per consumer warpgroup; NWG: consumer warpgroups
// (BM = 64 * MT * NWG). The shared memory is B10's TLayout: per stage the x
// tile and the w8 slab, two W^T buffers, the barriers (x full, w8 full,
// stage empty per stage; W^T full and empty per buffer).
template <int MT, int NWG, bool MOE>
__global__ void __launch_bounds__(NWG * 128 + 128, NWG == 1 ? 2 : 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap x_map,  // x [E or 1, T, in_features] bf16
                 const __grid_constant__ CUtensorMap w_map,  // w8 [E, OUT, in_features of ld] int8
                 const float* __restrict__ w_scale,          // [E, OUT]
                 __nv_bfloat16* __restrict__ out,            // [E, T, OUT]
                 float* __restrict__ partials,               // [E, splits, Tpad, OUT] when split
                 int* __restrict__ tickets,                  // [E, row tiles, col tiles], zero
                 int T, int out_features, int in_features, int splits, int slabs_per_split,
                 int stages, int x_per_expert) {
  constexpr int BM = 64 * MT * NWG;
  constexpr int CONSUMERS = 4 * NWG;  // consumer warps; the producer is the next one
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const TLayout L(BM, stages);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + L.bar());
  uint64_t* wfull = xfull + stages;
  uint64_t* empty = wfull + stages;
  uint64_t* bfull = empty + stages;
  uint64_t* bempty = bfull + 2;
  int& s_last = *reinterpret_cast<int*>(smem + L.flag());

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // z = expert * splits + split with MOE, the split alone without
  const int e = MOE ? (int)blockIdx.z / splits : 0;
  const int sp = MOE ? (int)blockIdx.z % splits : (int)blockIdx.z;
  const int col0 = blockIdx.x * FG_BN, row0 = blockIdx.y * BM;
  const int n_slabs = (in_features + FG_BK - 1) / FG_BK;
  const int s_begin = sp * slabs_per_split;
  const int n_local = min(n_slabs, s_begin + slabs_per_split) - s_begin;
  if (MOE) {  // x and w8 take the expert as a tensor-map coordinate
    w_scale += (size_t)e * out_features;
    out += (size_t)e * T * out_features;
  }

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(xfull + i, 1);  // the producer's expect_tx; its TMA completes it
      mbar_init(wfull + i, 1);
      mbar_init(empty + i, CONSUMERS + FG_WIDEN / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(bfull + i, FG_WIDEN / 32);
      mbar_init(bempty + i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // the producer: slab j -> stage j % stages, refilled once its consumers
    // and widening warps released it
    if (lane == 0) {
      for (int j = 0; j < n_local; ++j) {
        const int st = j % stages, k0 = (s_begin + j) * FG_BK;
        if (j >= stages) mbar_wait(empty + st, (j / stages - 1) & 1);
        mbar_arrive_expect_tx(wfull + st, FG_BN * FG_BK);
        tma_load_3d(smem + L.w8(st), &w_map, k0, col0, e, wfull + st);
        mbar_arrive_expect_tx(xfull + st, BM * FG_BK * 2);
        tma_load_3d(smem + L.a(st), &x_map, k0, row0, x_per_expert ? e : 0, xfull + st);
      }
    }
  } else if (warp > CONSUMERS) {
    // widening warps: the int8 slab [128 n][64 i] -> bf16 core matrices
    // (n / 8, i / 8) of W^T buffer j % 2, each 16-byte row eight i of one n
    const int dt = tid - (CONSUMERS + 1) * 32;
    for (int j = 0; j < n_local; ++j) {
      const int st = j % stages, wb = j & 1;
      mbar_wait(wfull + st, (j / stages) & 1);
      if (j >= 2) mbar_wait(bempty + wb, (j / 2 - 1) & 1);
      widen_slab(smem + L.w8(st), smem + L.bt(wb), dt);  // widen
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bfull + wb);
        mbar_arrive(empty + st);
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [wg * 64 * MT, (wg + 1) * 64 * MT) of the tile
    const int wg = warp >> 2;
    const bool active = row0 + wg * 64 * MT < T;  // a warpgroup of padding rows only waits
    float acc[MT][64];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
    for (int j = 0; j < n_local; ++j) {
      const int st = j % stages, wb = j & 1;
      mbar_wait(xfull + st, (j / stages) & 1);
      mbar_wait(bfull + wb, (j / 2) & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      if (active) {  // the slab's products
        fence_proxy_async();
        wgmma_fence();
        const unsigned char* sa = smem + L.a(st);
        const unsigned char* sb = smem + L.bt(wb);
#pragma unroll
        for (int kk = 0; kk < FG_BK / 16; ++kk) {
          const uint64_t db = make_desc(sb + kk * 256);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wgmma_m64n128k16(acc[m], make_desc_sw128(sa + (wg * MT + m) * 64 * FG_BK * 2 + kk * 32),
                             db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // slab j - 1's products are done
      }
      if (j > 0) {
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(empty + (j - 1) % stages);
          mbar_arrive(bempty + ((j - 1) & 1));
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
    const bool pair = (out_features & 1) == 0;
    if (splits == 1) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < FG_BN / 8; ++c) {
          const int col = cbase + 8 * c;
          if (col >= out_features) continue;
          const float s0 = __ldg(w_scale + col);
          const float s1 = col + 1 < out_features ? __ldg(w_scale + col + 1) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = rbase + m * 64 + 8 * h;
            if (row < T)
              store_out(out + (size_t)row * out_features + col, pair, col + 1 < out_features,
                        acc[m][4 * c + 2 * h] * s0, acc[m][4 * c + 2 * h + 1] * s1);
          }
        }
      return;
    }
    // split contraction: park the f32 partial tile, the last block sums
    const int t_pad = gridDim.y * BM;
    float* part = partials + ((size_t)e * splits + sp) * t_pad * out_features;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < FG_BN / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rbase + m * 64 + 8 * h, col = cbase + 8 * c;
          if (row >= T || col >= out_features) continue;
          float* p = part + (size_t)row * out_features + col;
          if (pair) {
            *reinterpret_cast<float2*>(p) = make_float2(acc[m][4 * c + 2 * h], acc[m][4 * c + 2 * h + 1]);
          } else {
            p[0] = acc[m][4 * c + 2 * h];
            if (col + 1 < out_features) p[1] = acc[m][4 * c + 2 * h + 1];
          }
        }
    __threadfence();
    bar_sync(1, CONSUMERS * 32);
    if (tid == 0) {  // the last split zeroes the tile's ticket for the next launch
      int* tk = tickets + ((size_t)e * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      s_last = atomicAdd(tk, 1) == splits - 1;
      if (s_last) *tk = 0;
    }
    bar_sync(1, CONSUMERS * 32);
    if (!s_last) return;
    __threadfence();
    reduce_splits<BM, FG_BN, CONSUMERS * 32>(
        partials + (size_t)e * splits * t_pad * out_features, (size_t)t_pad * out_features, splits,
        w_scale, out, row0, col0, T, out_features, tid);
  }
}

template <int MT, int NWG, bool MOE>
cudaError_t gemm_launch(const void* x, const void* w8, const void* w_scale, void* out,
                        void* partials, void* tickets, int experts, int x_per_expert, int T,
                        int splits, int slabs_per_split, int stages, int smem, int out_features,
                        int in_features, int ld, cudaStream_t stream) {
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemm_kernel<MT, NWG, MOE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  constexpr int BM = 64 * MT * NWG;
  const EncodeTiled encode = encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  // x [E or 1][T][in_features]: boxes of 64 columns x BM rows, 128B-swizzled
  CUtensorMap x_map;
  const cuuint64_t x_dims[3] = {(cuuint64_t)in_features, (cuuint64_t)T,
                                (cuuint64_t)(x_per_expert ? experts : 1)};
  const cuuint64_t x_strides[2] = {(cuuint64_t)in_features * 2, (cuuint64_t)T * in_features * 2};
  const cuuint32_t x_box[3] = {FG_BK, (cuuint32_t)BM, 1};
  if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), x_dims, x_strides,
             x_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // w8 [E][OUT][ld], read as [E][OUT][in_features]: boxes of 64 columns x 128 rows
  CUtensorMap w_map;
  const cuuint64_t w_dims[3] = {(cuuint64_t)in_features, (cuuint64_t)out_features,
                                (cuuint64_t)experts};
  const cuuint64_t w_strides[2] = {(cuuint64_t)ld, (cuuint64_t)out_features * ld};
  const cuuint32_t w_box[3] = {FG_BK, FG_BN, 1};
  if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w8), w_dims, w_strides,
             w_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const dim3 grid((out_features + FG_BN - 1) / FG_BN, (T + BM - 1) / BM, experts * splits);
  int8_gemm_kernel<MT, NWG, MOE><<<grid, NWG * 128 + 128, smem, stream>>>(
      x_map, w_map, (const float*)w_scale, (__nv_bfloat16*)out, (float*)partials, (int*)tickets, T,
      out_features, in_features, splits, slabs_per_split, stages, x_per_expert);
  return cudaGetLastError();
}

template <bool MOE>
int gemm_dispatch(const void* x, const void* w8, const void* w_scale, void* out, void* partials,
                  void* tickets, int experts, int x_per_expert, int T, int splits,
                  int cols_per_split, int out_features, int in_features, int ld, int bm,
                  int stages, int smem, cudaStream_t st) {
  if (stages < 2 || stages > FG_MAX_STAGES || smem > T_SMEM_LIMIT || cols_per_split < FG_BK ||
      cols_per_split % FG_BK || (long long)(splits - 1) * cols_per_split >= in_features ||
      (bm != 64 && bm != 128 && bm != 256) || smem != TLayout(bm, stages).total() ||
      (splits > 1 && (!partials || !tickets)))
    return cudaErrorInvalidValue;
#define AQLM_INT8_GEMM(MT, NWG)                                                               \
  return gemm_launch<MT, NWG, MOE>(x, w8, w_scale, out, partials, tickets, experts,           \
                                   x_per_expert, T, splits, cols_per_split / FG_BK, stages,    \
                                   smem, out_features, in_features, ld, st)
  if (bm == 256) AQLM_INT8_GEMM(2, 2);
  if (bm == 128) AQLM_INT8_GEMM(1, 2);
  AQLM_INT8_GEMM(1, 1);
#undef AQLM_INT8_GEMM
}

bool shapes_ok(int experts, int T, int out_features, int in_features, int ld) {
  return experts >= 1 && T >= 1 && out_features >= 1 && in_features >= 16 &&
         in_features % 16 == 0 && ld % 16 == 0 && in_features <= ld;
}

}  // namespace

// The forward, as int8_matmul.plan lays it out. w8 [E, OUT, ld], w_scale
// [E, OUT], out [E, T, OUT]; x [T, in_features] shared by the experts
// (x_per_expert = 0) or [E, T, in_features]; E = 1 for one matrix;
// in_features and ld multiples of 16. One matrix (or one expert) needs no
// offsets: it runs the kernels compiled without them.
//
// The prefill GEMM, T > 8: bm 64, 128 or 256 rows a block, `stages` ring
// stages, `smem` dynamic bytes, checked against the kernel's own layout.
// splits > 1 splits the contraction into runs of cols_per_split columns (a
// multiple of 64); partials [E, splits, ceil(T/bm)*bm, OUT] f32 and tickets
// [E, ceil(T/bm), ceil(OUT/128)] int32 are then required, the tickets zero
// before the first launch: the last block of each output tile zeroes its
// ticket again, so launches on one stream share one buffer.
extern "C" int int8_matmul_launch(const void* x, const void* w8, const void* w_scale, void* out,
                                  void* partials, void* tickets, int experts, int x_per_expert,
                                  int T, int splits, int cols_per_split, int out_features,
                                  int in_features, int ld, int bm, int stages, int smem,
                                  void* stream) {
  if (!shapes_ok(experts, T, out_features, in_features, ld) || T <= 8 || splits < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (experts > 1)
    return gemm_dispatch<true>(x, w8, w_scale, out, partials, tickets, experts, x_per_expert, T,
                               splits, cols_per_split, out_features, in_features, ld, bm, stages,
                               smem, st);
  return gemm_dispatch<false>(x, w8, w_scale, out, partials, tickets, 1, 0, T, splits,
                              cols_per_split, out_features, in_features, ld, bm, stages, smem,
                              st);
}

// The decode GEMV, T <= 8: `blocks` blocks, `runs` the activations' staged
// runs and `smem` the dynamic bytes, the last two as GemvLayout computes them.
extern "C" int int8_gemv_launch(const void* x, const void* w8, const void* w_scale, void* out,
                                int experts, int x_per_expert, int T, int out_features,
                                int in_features, int ld, int blocks, int runs, int smem,
                                void* stream) {
  if (!shapes_ok(experts, T, out_features, in_features, ld) || T > 8)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (experts > 1)
    return gemv_dispatch<true>(x, w8, w_scale, out, experts, x_per_expert, T, out_features,
                               in_features, ld, blocks, runs, smem, st);
  return gemv_dispatch<false>(x, w8, w_scale, out, 1, 0, T, out_features, in_features, ld, blocks,
                              runs, smem, st);
}

// The activation backward, as int8_matmul.plan_t lays it out: g [T, OUT]
// bf16 (g_f32 = 0) or f32, w8 [OUT, ld] int8, w_scale [OUT] f32 -> out
// [T, ld] bf16; OUT a multiple of 8, ld of 16. bm = 0 runs the column GEMV
// (T <= 8; `per_split` OUT rows a split, a multiple of 32), bm = 128 or 256
// the GEMM (`per_split` 64-row slabs a split, `stages` ring stages; `gs`, a
// [T, OUT] bf16 scratch, receives bf16(g * scale) first). `smem`
// is checked against the kernel's own layout. With splits > 1, partials (GEMV
// [splits, T, ld], GEMM [splits, ceil(T / bm) * bm, ld] f32) and tickets (GEMV
// [ceil(ld / column block)], GEMM [ceil(T / bm), ceil(ld / 128)] int32, zero
// before the first launch; the last block of each column block or tile
// zeroes its ticket again) are required.
extern "C" int int8_matmul_t_launch(const void* g, const void* w8, const void* w_scale, void* out,
                                    void* partials, void* tickets, void* gs, int g_f32, int T,
                                    int out_features, int ld, int bm, int splits, int per_split,
                                    int stages, int smem, void* stream) {
  if (T < 1 || out_features < 8 || out_features % 8 || ld < 16 || ld % 16 || splits < 1 ||
      per_split < 1 || smem > T_SMEM_LIMIT)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bm == 0) {
    if (T > 8 || per_split % (TV_WARPS * TV_UNROLL) || smem != gemv_t_smem(T, per_split) ||
        (long long)(splits - 1) * per_split >= out_features)
      return cudaErrorInvalidValue;
#define AQLM_INT8_T_CASE(NT)                                                                  \
  case NT:                                                                                    \
    return gemv_t_launch<NT>(g, w8, w_scale, out, partials, tickets, g_f32, out_features, ld, \
                             splits, per_split, smem, st);
    switch (T) {
      AQLM_INT8_T_CASE(1) AQLM_INT8_T_CASE(2) AQLM_INT8_T_CASE(3) AQLM_INT8_T_CASE(4)
      AQLM_INT8_T_CASE(5) AQLM_INT8_T_CASE(6) AQLM_INT8_T_CASE(7) AQLM_INT8_T_CASE(8)
      default: return cudaErrorInvalidValue;
    }
#undef AQLM_INT8_T_CASE
  }
  if ((bm != 128 && bm != 256) || stages < 2 || stages > TG_MAX_STAGES || !gs ||
      smem != TLayout(bm, stages).total() ||
      (long long)(splits - 1) * per_split >= (out_features + TG_BK - 1) / TG_BK)
    return cudaErrorInvalidValue;
  if (bm == 256)
    return gemm_t_launch<2>(g, w8, w_scale, out, partials, tickets, gs, g_f32, T, out_features,
                            ld, splits, per_split, stages, smem, st);
  return gemm_t_launch<1>(g, w8, w_scale, out, partials, tickets, gs, g_f32, T, out_features, ld,
                          splits, per_split, stages, smem, st);
}
