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
//   activation rows, padded to 8, the other. A thread loads 64 bytes of each
//   128-byte packing block (two 16-byte loads per row, neighbouring threads
//   neighbouring bytes) and widens each 4-byte word straight into its A
//   fragment: the low nibbles for group 2i, the high nibbles for group
//   2i + 1, each group an f32 fragment added in with its scale. The
//   widening is exact (bf16 q - 8) and nothing is rounded with the scale,
//   as on the prefill path. The first design split the
//   contraction over blocks to fill the card at OUT = 4096 (partial sums,
//   a fence, an atomic ticket, and a torch.zeros of the tickets before each
//   launch) and loaded 8 bytes of x from L1 for every mma; at o that fixed
//   cost set a ~0.012 ms floor, above torch._weight_int4pack_mm
//   (experiments/torch_int4_gemv_ablate.py: unsplit, or without the x
//   loads, it ran 20-40% faster). Now one block of 16 warps an SM walks a
//   contiguous run of 16-row tiles (the expert a tile coordinate), the
//   warps of a block taking a tile's packing blocks in turn and adding their
//   sums in shared memory in warp order: no split over blocks, no partials,
//   no tickets, no second launch, and the result does not change from run
//   to run. Each warp stages the activation columns of its own packing
//   blocks once in shared memory by bulk copies (the whole contraction: at
//   most 8 x 11008 bf16 a block; where that does not fit, Mixtral's
//   per-expert down at 7-8 rows, in two runs of the contraction, each tile's
//   sums kept in shared memory between them), so no warp waits for
//   another's, and keeps its next packing block in flight across tile
//   boundaries.
// - Prefill, T > 8: bound by operations (2*T*OUT*IN on the bf16 tensor
//   cores; Llama-2-7B's fused qkv at T = 1024: 103 GFLOP, 0.104 ms at 989
//   TFLOP/s), laid out by the wrapper's planning function (int4_matmul.plan)
//   in int8_matmul.cu's shape. A 384-thread block owns a 128 x 128 (or 64 x
//   128) tile of y and walks the contraction in 64-column slabs, four to a
//   packing block:
//     - the producer warp keeps two rings in flight: the x tile [BM x 64]
//       by TMA (128-byte swizzle; a 3-D map, so per-expert x is a
//       coordinate; rows past T and columns past in_features arrive as
//       zeros), and once a packing block the packed slab [128 OUT x 128
//       bytes] by TMA (128-byte swizzle, so that rows of 128 bytes do not
//       meet on a bank) with its two groups' scales by the lanes' cp.async;
//     - three dequantiser warps unpack one nibble of each byte of the slab
//       (the low nibbles are group 2i's 128 columns in order, the high ones
//       group 2i + 1's) exactly into bf16 (q - 8): the bf16 with bits 0x43qq
//       is 128 + q, minus 136 (nib4_to_bf16x2); straight into wgmma's
//       K-major core-matrix layout, one of four W^T buffers, each phase's
//       reads and writes on eight bank groups;
//     - two consumer warpgroups (64 rows each) run wgmma.mma_async
//       m64n128k16 over a group's two slabs into a group accumulator, then
//       fold it in with the group's scales in f32 (acc += s[g, o] * group
//       sum); nothing is rounded with its scale. At T <= 64, where a second
//       64-row warpgroup would hold only padding, the tile is 64 rows and
//       the two warpgroups take alternate groups, adding their sums at the
//       end (KSPLIT).
//   The fold waits for its group's products, so a warpgroup's tensor work
//   drains once a group: with the dequantisers it is what bounds the kernel
//   (experiments/torch_int8_int4_ablate.py). Making the two warpgroups take
//   turns, so that one folds while the other's products run, was slower; a
//   second group accumulator, so that a warpgroup folds while its next
//   group's products run, needs more registers than ptxas gives a 384-thread
//   block even under setmaxnreg (it spilled). Each weight is unpacked
//   ceil(T / 128) times (ceil(T / 64) at T <= 64). Where the output tiles
//   would leave the card idle, the contraction is split over blocks (in
//   whole packing blocks): each writes f32 partial sums and the last block of
//   an output tile to finish (an atomic ticket, which it zeroes again for the
//   next launch) adds them in a fixed order.
//
// All experts (MoE): w4 [E, OUT, ldb], gscale [E, 2 * ldb / 128, OUT], out
// [E, T, OUT]; x is [T, in_features] shared by every expert (gate and up)
// or [E, T, in_features], one slab per expert (down), never padded. One
// launch covers every expert: the expert is the decode tiles' leading
// coordinate and is folded with the splits into the prefill grid's z axis;
// each tile or block offsets its pointers (decode) or its tensor-map
// coordinates (prefill) by its expert, and the prefill's split partial sums
// and tickets are per expert, so the last-block reduction never mixes
// experts. Mixtral-8x7B
// decode at T = 4 reads 235 MB of gate nibbles and 14.7 MB of scales
// (~0.075 ms at 3.35 TB/s): the same tensor-core GEMV with E times the
// blocks. The expert axis is a template flag (MOE): a single matrix runs
// the kernels compiled without it, so their registers and code stay those
// of the one-matrix kernels.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace aqlm;

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

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use on an H100
constexpr int GV_WARPS = 16;
constexpr int GV_THREADS = GV_WARPS * 32;
constexpr int GV_ROWS = 16;                         // output rows of a tile: one m16 tile
constexpr int GV_RED = GV_WARPS * GV_ROWS * 8 * 4;  // one tile's warp sums, f32; two alternate
constexpr int GV_TILE = GV_ROWS * 8 * 4;            // one tile's f32 sums, kept between runs
constexpr int GV_XROW = 512 + 16;                   // a staged activation row of one packing block

// The GEMV's shared memory for T rows, `tiles` 16-row tiles over `blocks`
// blocks: two alternating buffers of the warps' sums; (where the contraction
// takes several runs, each tile's sums kept between them, `park`;) each
// warp's barrier for its activation copies; then each warp's own
// activation columns (the packing blocks it takes, `slots` of them, T rows
// of 256 columns each, 16 bytes apart from bank to bank), for the whole
// contraction where they fit, else for `chunks` runs of packing blocks in
// turn. int4_matmul.gemv_layout
// computes the same, and a launch whose chunks or total differ is refused.
struct GemvLayout {
  int n_pb, chunks, pbc, slots, park, total_;
  __host__ __device__ GemvLayout(int T, int in_features, int tiles, int blocks) {
    n_pb = (in_features + 255) / 256;
    const int run = (tiles + blocks - 1) / blocks;  // the most tiles a block walks
    for (chunks = 1;; ++chunks) {
      pbc = (n_pb + chunks - 1) / chunks;
      slots = (pbc + GV_WARPS - 1) / GV_WARPS;
      park = chunks > 1 ? run * GV_TILE : 0;
      if (2 * GV_RED + park + GV_WARPS * 8 + GV_WARPS * slots * T * GV_XROW <= SMEM_LIMIT ||
          pbc <= GV_WARPS)
        break;
    }
    total_ = 2 * GV_RED + park + GV_WARPS * 8 + GV_WARPS * slots * T * GV_XROW;
  }
  __host__ __device__ int total() const { return total_; }
};

// y^T = W x^T on the tensor cores: W is the 16-row A operand, the (at most 8)
// activation rows the 8-column B operand. One block of 16 warps an SM walks
// a contiguous run of 16-row tiles (tile t: expert t / row_tiles); within a
// tile warp w takes packing blocks p = w, w + 16, ... of the run, and the
// warps' sums meet in shared memory, added in warp order. A thread holds
// bytes 16 tig .. 16 tig + 15 and 64 + 16 tig .. of rows gid and gid + 8 of
// a packing block; one of its 4-byte words gives its A values of one
// 16-column step (its columns j0 .. j0 + 3 stand for mma k 2 tig, 2 tig + 1,
// 2 tig + 8, 2 tig + 9) and its B values are x[gid][j0 .. j0 + 3], read from
// the warp's own staged activation columns (each warp takes the same packing
// blocks in every tile, so it stages them once, and waits for no other
// warp's). Each warp keeps its next packing block (across tiles and runs) in
// flight while one computes; the sums' two buffers let a tile end at one
// barrier.
template <bool MOE>
__global__ void __launch_bounds__(GV_THREADS, 1)
int4_gemv_kernel(const __nv_bfloat16* __restrict__ x,  // [T, in_features], or [E, T, ...]
                 const uint8_t* __restrict__ w4,        // [E, OUT, ldb] of one layer
                 const float* __restrict__ gscale,      // [E, 2 * ldb / 128, OUT]
                 __nv_bfloat16* __restrict__ out,       // [E, T, OUT]
                 int T, int out_features, int in_features, int ldb, int experts,
                 int x_per_expert, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_tiles = (out_features + GV_ROWS - 1) / GV_ROWS;
  const int tiles = (MOE ? experts : 1) * row_tiles;
  // GemvLayout's runs (`chunks`, checked by the launch) unpacked with few
  // divisions: the first loads issue sooner
  const int n_pb = (in_features + 255) / 256, pbc = (n_pb + chunks - 1) / chunks;
  const int slots = (pbc + GV_WARPS - 1) / GV_WARPS;
  const int run = (tiles + gridDim.x - 1) / gridDim.x;
  float* park = reinterpret_cast<float*>(smem + 2 * GV_RED);  // [run][16][8]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  // this warp's barrier and staged columns: [slot j][T][GV_XROW bytes]
  uint64_t* xbar =
      reinterpret_cast<uint64_t*>(smem + 2 * GV_RED + (chunks > 1 ? run * GV_TILE : 0)) + warp;
  unsigned char* xw = reinterpret_cast<unsigned char*>(xbar - warp + GV_WARPS) +
                      (size_t)warp * slots * T * GV_XROW;
  const int t_begin = blockIdx.x * tiles / gridDim.x;
  const int t_end = (blockIdx.x + 1) * tiles / gridDim.x;
  const size_t w_expert = (size_t)out_features * ldb;
  const size_t s_expert = (size_t)(2 * ldb / 128) * out_features;
  // this warp's packing blocks of a tile in run c
  auto per_tile = [&](int c) {
    const int n = min(n_pb, (c + 1) * pbc) - c * pbc;
    return warp < n ? (n - warp + GV_WARPS - 1) / GV_WARPS : 0;
  };

  // the load cursor (run lc, tile lt, item lj) walks the warp's items in
  // compute order; lc == chunks past the last
  int lc = 0, lt = t_begin, lj = 0;
  auto skip_empty = [&]() {
    while (lc < chunks && per_tile(lc) == 0) ++lc;
  };
  skip_empty();
  // the item at the cursor: a thread's 64 bytes of its packing block, then
  // the block's two group scales of its rows (zeros past the end; the bytes
  // go out first); then advance
  auto load_w = [&](uint4 (&d)[4], float (&sc)[4]) {
    const uint4 z = make_uint4(0, 0, 0, 0);
    const bool in = lc < chunks && lt < t_end;
    const int p = lc * pbc + warp + GV_WARPS * lj;
    const int e = MOE ? lt / row_tiles : 0;
    const int r0 = (lt - e * row_tiles) * GV_ROWS + gid, r1 = r0 + 8;
    const bool v0 = in && r0 < out_features, v1 = in && r1 < out_features;
    const uint8_t* w = w4 + (MOE ? e * w_expert : 0) + 128 * (size_t)p + 16 * tig;
    const float* sg = gscale + (MOE ? e * s_expert : 0) + (size_t)(2 * p) * out_features;
    d[0] = v0 ? __ldcs(reinterpret_cast<const uint4*>(w + (size_t)r0 * ldb)) : z;
    d[1] = v0 ? __ldcs(reinterpret_cast<const uint4*>(w + (size_t)r0 * ldb + 64)) : z;
    d[2] = v1 ? __ldcs(reinterpret_cast<const uint4*>(w + (size_t)r1 * ldb)) : z;
    d[3] = v1 ? __ldcs(reinterpret_cast<const uint4*>(w + (size_t)r1 * ldb + 64)) : z;
    sc[0] = v0 ? __ldg(sg + r0) : 0.f;
    sc[1] = v1 ? __ldg(sg + r1) : 0.f;
    sc[2] = v0 ? __ldg(sg + out_features + r0) : 0.f;
    sc[3] = v1 ? __ldg(sg + out_features + r1) : 0.f;
    if (!in) return;
    if (++lj < per_tile(lc)) return;
    lj = 0;
    if (++lt < t_end) return;
    lt = t_begin;
    ++lc;
    skip_empty();
  };

  // the warp's packing blocks of run c of expert e's activations into its
  // slots: lane 0 bulk-copies each row's 512 bytes (the columns past
  // in_features zeroed by the lanes instead), completing on the warp's
  // barrier, which it waits on (wait_x) only before their first use
  int x_phase = 0;
  if (lane == 0) {
    aqlm::mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto issue_x = [&](int c, int e, int pt) {
    const __nv_bfloat16* xe = x + (MOE && x_per_expert ? (size_t)e * T * in_features : 0);
    const int col0 = 256 * (c * pbc + warp);
    const int tail = min(in_features - col0 - GV_WARPS * 256 * (pt - 1), 256);
    if (tail < 256)  // the last packing block's columns past in_features: the copy skips them
      for (int i = lane; i < T * (256 - tail) / 8; i += 32) {
        const int r = i / ((256 - tail) / 8), cc = i % ((256 - tail) / 8);
        *reinterpret_cast<uint4*>(xw + (size_t)((pt - 1) * T + r) * GV_XROW + 2 * tail + 16 * cc) =
            make_uint4(0, 0, 0, 0);
      }
    __syncwarp();  // the lanes' reads of the last run's columns come first
    if (lane == 0) {
      aqlm::fence_proxy_async();
      aqlm::mbar_arrive_expect_tx(xbar, T * (512 * (pt - 1) + 2 * tail));
      for (int j = 0; j < pt; ++j)
        for (int r = 0; r < T; ++r)
          aqlm::bulk_copy(xw + (size_t)(j * T + r) * GV_XROW,
                          xe + (size_t)r * in_features + col0 + GV_WARPS * 256 * j,
                          j + 1 < pt ? 512 : 2 * tail, xbar);
    }
  };
  auto wait_x = [&]() {
    aqlm::mbar_wait(xbar, x_phase);
    x_phase ^= 1;
    __syncwarp();
  };

  uint4 w0[4], w1[4];
  float s0[4], s1[4];
  load_w(w0, s0);
  int x_c = -1, x_e = -1;  // the run and expert whose activations are staged
  bool x_wait = false;
  int k = 0;  // tiles ended so far: their parity picks the sums' buffer
  for (int c = 0; c < chunks; ++c) {
    const int pt = per_tile(c);
    for (int t = t_begin; t < t_end; ++t, ++k) {
      const int e = MOE ? t / row_tiles : 0;
      if (pt > 0 && (x_c != c || (MOE && x_per_expert && e != x_e))) {
        issue_x(c, e, pt);
        x_c = c;
        x_e = e;
        x_wait = true;
      }
      // element q: row gid + 8 (q >> 1), activation row 2 tig + (q & 1)
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < pt; ++j) {
        load_w(w1, s1);  // the next packing block is in flight while this one computes
        if (x_wait) {
          wait_x();
          x_wait = false;
        }
        const int p = c * pbc + warp + GV_WARPS * j;
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // group 2p (low nibbles), then 2p + 1 (high)
          if (256 * p + 128 * half >= in_features) break;  // a group wholly past the end meets zeros
          float g[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int seg = 0; seg < 2; ++seg) {
            // x[gid][c0 .. c0 + 15] of the packing block: the B values of this thread's four steps
            uint4 xv[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
            if (gid < T) {
              const unsigned char* xp = xw + (size_t)(j * T + gid) * GV_XROW +
                                        2 * (128 * half + 64 * seg + 16 * tig);
              xv[0] = *reinterpret_cast<const uint4*>(xp);
              xv[1] = *reinterpret_cast<const uint4*>(xp + 16);
            }
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              uint32_t u0 = word_of(w0[seg], s), u1 = word_of(w0[2 + seg], s);
              u0 = (half ? u0 >> 4 : u0) & 0x0F0F0F0Fu;
              u1 = (half ? u1 >> 4 : u1) & 0x0F0F0F0Fu;
              uint32_t a[4];
              nib4_to_bf16x2(u0, a[0], a[2]);
              nib4_to_bf16x2(u1, a[1], a[3]);
              mma_bf16_16816(g, a, word_of(xv[s >> 1], 2 * (s & 1)),
                             word_of(xv[s >> 1], 2 * (s & 1) + 1));
            }
          }
          const float sa = s0[2 * half], sb = s0[2 * half + 1];
          acc[0] = fmaf(g[0], sa, acc[0]);
          acc[1] = fmaf(g[1], sa, acc[1]);
          acc[2] = fmaf(g[2], sb, acc[2]);
          acc[3] = fmaf(g[3], sb, acc[3]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w0[q] = w1[q];
          s0[q] = s1[q];
        }
      }

      // the warps' sums meet in shared memory and are added in warp order
      // (then to the earlier runs' sum of the tile, kept in `park`)
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
          out[((size_t)(MOE ? e : 0) * T + bb) * out_features + row] = __float2bfloat16(v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// prefill: T > 8 (int4_matmul.plan lays it out)
// ---------------------------------------------------------------------------

constexpr int Q_BN = 128;           // output channels per block
constexpr int Q_BK = 64;            // x columns per slab; four slabs a packing block
constexpr int Q_PB = 128;           // bytes of a packing block's row: 256 columns, 2 groups
constexpr int Q_NB = 4;             // W^T buffers: two groups
constexpr int Q_DQ = 96;            // dequantiser threads: warps 9-11
constexpr int Q_CONSUMERS = 8;      // warps 0-7; warp 8 is the producer
constexpr int Q_THREADS = 384;
constexpr int Q_MAX_STAGES = 8;

// Byte offsets in the dynamic shared memory from its first 1024-aligned
// byte (the swizzled TMA tiles need it; hence the 1024 bytes of slack):
// the x ring, two packed slabs and their scales, four W^T buffers, the
// barriers, the split path's flag. int4_matmul.plan computes the same
// total, and a launch whose total differs is refused. With KSPLIT the x ring
// (at least 32 KB) also passes warpgroup 1's sums to warpgroup 0 at the end.
struct QLayout {
  int bm, stages;
  __host__ __device__ QLayout(int bm_, int st) : bm(bm_), stages(st) {}
  __host__ __device__ int x(int s) const { return s * bm * Q_BK * 2; }
  __host__ __device__ int w4(int b) const { return x(stages) + b * Q_BN * Q_PB; }
  __host__ __device__ int sc(int b) const { return w4(2) + b * 2 * Q_BN * 4; }
  __host__ __device__ int bt(int i) const { return sc(2) + i * Q_BN * Q_BK * 2; }
  __host__ __device__ int bar() const { return bt(Q_NB); }
  __host__ __device__ int n_bars() const { return 2 * stages + 4 + 2 * Q_NB; }
  __host__ __device__ int flag() const { return bar() + n_bars() * 8; }
  __host__ __device__ int total() const { return flag() + 16 + 1024; }
};

// Dequantiser unit u of a slab: 16 bytes (column chunk kp of the slab's
// half of the packing block) of row n. The eight lanes of a 16-byte phase
// (u = 8 p + q) take rows 8 (u / 32) + q and one chunk: their stores
// (core-matrix row n % 8) and their reads (the TMA's 128-byte swizzle puts
// chunk c of row n at c ^ (n % 8)) each meet eight bank groups.
__device__ __forceinline__ void dq_unit(int u, int& n, int& kp) {
  n = (u >> 5) * 8 + (u & 7);
  kp = (u >> 3) & 3;
}

// Quarter jj of a packing block's slab (bytes 64 (jj % 2) .. + 63 of each
// row, low nibbles for jj < 2) unpacked into W^T by the Q_DQ dequantiser
// threads (dt: this thread's index among them). A thread's units are
// u = dt + Q_DQ i; all its loads are issued first, so that their latencies
// overlap.
__device__ __forceinline__ void unpack_slab(const unsigned char* __restrict__ sw,
                                            unsigned char* __restrict__ sb, int dt, int jj) {
  constexpr int UNITS = (Q_BN * 4 + Q_DQ - 1) / Q_DQ;
  const int shift = (jj >> 1) * 4;
  uint4 v[UNITS];
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int u = dt + i * Q_DQ;
    int n, kp;
    dq_unit(u, n, kp);
    if (u < Q_BN * 4)
      v[i] = *reinterpret_cast<const uint4*>(sw + n * Q_PB + (((jj & 1) * 4 + kp) ^ (n & 7)) * 16);
  }
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int u = dt + i * Q_DQ;
    if (u >= Q_BN * 4) continue;
    int n, kp;
    dq_unit(u, n, kp);
    uint32_t h[8];
    nib4_to_bf16x2((v[i].x >> shift) & 0x0F0F0F0Fu, h[0], h[1]);
    nib4_to_bf16x2((v[i].y >> shift) & 0x0F0F0F0Fu, h[2], h[3]);
    nib4_to_bf16x2((v[i].z >> shift) & 0x0F0F0F0Fu, h[4], h[5]);
    nib4_to_bf16x2((v[i].w >> shift) & 0x0F0F0F0Fu, h[6], h[7]);
    unsigned char* d = sb + ((n >> 3) * (Q_BK / 8) + 2 * kp) * 128 + (n & 7) * 16;
    *reinterpret_cast<uint4*>(d) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(d + 128) = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// KSPLIT: a 64-row tile whose two consumer warpgroups take alternate groups
// of the contraction and add their sums at the end (T <= 64, where a second
// warpgroup of rows would hold only padding); else a 128-row tile, 64 rows
// a warpgroup.
template <bool MOE, bool KSPLIT>
__global__ void __launch_bounds__(Q_THREADS, 1)
int4_gemm_kernel(const __grid_constant__ CUtensorMap x_map,  // x [E or 1, T, in_features] bf16
                 const __grid_constant__ CUtensorMap w_map,  // w4 [E, OUT, ldb] uint8
                 const float* __restrict__ gscale,           // [E, n_groups, OUT]
                 __nv_bfloat16* __restrict__ out,            // [E, T, OUT]
                 float* __restrict__ partials,               // [E, splits, Tpad, OUT] when split
                 int* __restrict__ tickets,                  // [E, row tiles, col tiles], zero
                 int T, int out_features, int in_features, int n_groups, int splits,
                 int blocks_per_split, int stages, int x_per_expert) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int BM = KSPLIT ? 64 : 128;
  constexpr int SLAB_USERS = KSPLIT ? 4 : Q_CONSUMERS;  // consumer warps reading a slab
  const QLayout L(BM, stages);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + L.bar());
  uint64_t* xempty = xfull + stages;
  uint64_t* wfull = xempty + stages;
  uint64_t* wempty = wfull + 2;
  uint64_t* bfull = wempty + 2;
  uint64_t* bempty = bfull + Q_NB;
  int& s_last = *reinterpret_cast<int*>(smem + L.flag());

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // z = expert * splits + split with MOE, the split alone without
  const int e = MOE ? (int)blockIdx.z / splits : 0;
  const int sp = MOE ? (int)blockIdx.z % splits : (int)blockIdx.z;
  const int col0 = blockIdx.x * Q_BN, row0 = blockIdx.y * BM;
  const int n_blocks = (in_features + 2 * Q_PB - 1) / (2 * Q_PB);
  const int b_begin = sp * blocks_per_split;
  const int n_local = 4 * (min(n_blocks, b_begin + blocks_per_split) - b_begin);  // slabs
  if (MOE) {  // x and w4 take the expert as a tensor-map coordinate
    gscale += (size_t)e * n_groups * out_features;
    out += (size_t)e * T * out_features;
  }

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(xfull + i, 1);  // the producer's expect_tx; its TMA completes it
      mbar_init(xempty + i, SLAB_USERS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(wfull + i, 33);  // the producer's 32 lanes' scale copies and its TMA
      mbar_init(wempty + i, Q_DQ / 32 + Q_CONSUMERS);
    }
    for (int i = 0; i < Q_NB; ++i) {
      mbar_init(bfull + i, Q_DQ / 32);
      mbar_init(bempty + i, SLAB_USERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == Q_CONSUMERS) {
    // the producer: packing block b -> packed stage b % 2 (refilled once
    // its dequantisers and consumers released it), slab j -> x stage
    // j % stages (refilled once its consumers released it)
    for (int j = 0; j < n_local; ++j) {
      if ((j & 3) == 0) {
        const int b = j >> 2, ws = b & 1, p = b_begin + b;
        if (b >= 2) mbar_wait(wempty + ws, (b / 2 - 1) & 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(wfull + ws, Q_BN * Q_PB);
          tma_load_3d(smem + L.w4(ws), &w_map, p * Q_PB, col0, e, wfull + ws);
        }
        float* sc = reinterpret_cast<float*>(smem + L.sc(ws));
        for (int q = lane; q < 2 * Q_BN; q += 32) {  // groups 2p and 2p + 1, zeros past OUT
          const int r = q % Q_BN;
          const bool valid = col0 + r < out_features;
          const float* src =
              valid ? gscale + (size_t)(2 * p + q / Q_BN) * out_features + col0 + r : gscale;
          aqlm::cp_async4(sc + q, src, valid);
        }
        mbar_arrive_cp_async(wfull + ws);
      }
      const int st = j % stages;
      if (j >= stages) mbar_wait(xempty + st, (j / stages - 1) & 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(xfull + st, BM * Q_BK * 2);
        tma_load_3d(smem + L.x(st), &x_map, (4 * b_begin + j) * Q_BK, row0, x_per_expert ? e : 0,
                    xfull + st);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives its issuer
  } else if (warp > Q_CONSUMERS) {
    // dequantisers: slab j (quarter jj of packing block j / 4: bytes
    // 64 (jj % 2) .. + 63 of each row, low nibbles for jj < 2) -> bf16 (q - 8)
    // core matrices (n / 8, i / 8) of W^T buffer j % 4
    const int dt = tid - (Q_CONSUMERS + 1) * 32;
    for (int j = 0; j < n_local; ++j) {
      const int b = j >> 2, ws = b & 1, jj = j & 3, wb = j % Q_NB;
      if (jj == 0) mbar_wait(wfull + ws, (b / 2) & 1);
      if (j >= Q_NB) mbar_wait(bempty + wb, (j / Q_NB - 1) & 1);
      unpack_slab(smem + L.w4(ws), smem + L.bt(wb), dt, jj);  // unpack
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bfull + wb);
        if (jj == 3) mbar_arrive(wempty + ws);
      }
    }
  } else {
    // consumers. Group g is slabs 2g and 2g + 1; a group's products go into
    // gacc, then are folded into acc with the group's scales once they are
    // done. Row split (!KSPLIT): warpgroup wg owns rows [64 wg, 64 wg + 64)
    // and runs every group. KSPLIT: both own the tile's 64 rows; warpgroup wg
    // runs the groups g = wg mod 2.
    const int wg = warp >> 2;
    const bool active = KSPLIT || row0 + wg * 64 < T;  // padding rows only wait
    float acc[64], gacc[64];  // gacc: a group's sum (its first product overwrites it)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = gacc[i] = 0.f;
    const int n_grp = n_local / 2;
    for (int g = KSPLIT ? wg : 0; g < n_grp; g += KSPLIT ? 2 : 1) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = 2 * g + q, st = j % stages, wb = j % Q_NB;
        mbar_wait(xfull + st, (j / stages) & 1);
        mbar_wait(bfull + wb, (j / Q_NB) & 1);
        __syncwarp();  // converged for the .aligned wgmma instructions
        if (active) {  // the slab's products
          fence_proxy_async();
          wgmma_fence();
          const unsigned char* sa = smem + L.x(st) + (KSPLIT ? 0 : wg * 64 * Q_BK * 2);
          const unsigned char* sb = smem + L.bt(wb);
#pragma unroll
          for (int kk = 0; kk < Q_BK / 16; ++kk)
            wgmma_m64n128k16(gacc, make_desc_sw128(sa + kk * 32), make_desc(sb + kk * 256),
                             q | kk);
          wgmma_commit();
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // release each slab once its products are done
        if (q == 0) wgmma_wait<1>();  // (an idle warpgroup has none in flight)
        else wgmma_wait<0>();
        const int j = 2 * g + q;
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(xempty + j % stages);
          mbar_arrive(bempty + j % Q_NB);
        }
      }
      // fold: acc += s[g, o] * group sum, the scales from the packed stage
      const int b = g >> 1, ws = b & 1;
      mbar_wait(wfull + ws, (b / 2) & 1);
      fence_regs(gacc);
      if (active) {
        const float* s = reinterpret_cast<const float*>(smem + L.sc(ws)) + (g & 1) * Q_BN +
                         (lane & 3) * 2;
#pragma unroll
        for (int c = 0; c < Q_BN / 8; ++c) {
          const float2 sv = *reinterpret_cast<const float2*>(s + 8 * c);
          acc[4 * c] = fmaf(gacc[4 * c], sv.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(gacc[4 * c + 1], sv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(gacc[4 * c + 2], sv.x, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(gacc[4 * c + 3], sv.y, acc[4 * c + 3]);
        }
      }
      if (KSPLIT || (g & 1)) {  // this warpgroup is done with the packing block's scales
        __syncwarp();
        if (lane == 0) mbar_arrive(wempty + ws);
      }
    }
    if (KSPLIT) {
      // warpgroup 1's sums join warpgroup 0's through the x ring, which no
      // copy or product touches any more once both have left the loop
      float* red = reinterpret_cast<float*>(smem + L.x(0));
      const int t128 = tid & 127;
      bar_sync(1, Q_CONSUMERS * 32);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) red[i * 128 + t128] = acc[i];
      }
      bar_sync(1, Q_CONSUMERS * 32);
      if (wg == 1 && splits == 1) return;
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += red[i * 128 + t128];
      }
    }

    // accumulator 4c + 2h + p of thread (warp, lane): row 16 (warp % 4) +
    // lane / 4 + 8 h of the warpgroup's 64, column 8 c + 2 (lane % 4) + p
    const int rbase = row0 + (KSPLIT ? 0 : wg * 64) + (warp & 3) * 16 + (lane >> 2);
    const int cbase = col0 + (lane & 3) * 2;
    const bool pair = (out_features & 1) == 0;
    const bool writer = !KSPLIT || wg == 0;  // KSPLIT: warpgroup 0 holds the sums
    if (splits == 1) {
#pragma unroll
      for (int c = 0; c < Q_BN / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rbase + 8 * h, col = cbase + 8 * c;
          if (row >= T || col >= out_features) continue;
          __nv_bfloat16* o = out + (size_t)row * out_features + col;
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
          } else {
            o[0] = __float2bfloat16(acc[4 * c + 2 * h]);
            if (col + 1 < out_features) o[1] = __float2bfloat16(acc[4 * c + 2 * h + 1]);
          }
        }
      return;
    }
    // split contraction: park the f32 partial tile, the last block sums
    const int t_pad = gridDim.y * BM;
    float* part = partials + ((size_t)e * splits + sp) * t_pad * out_features;
#pragma unroll
    for (int c = 0; c < Q_BN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + 8 * h, col = cbase + 8 * c;
        if (!writer || row >= T || col >= out_features) continue;
        float* p = part + (size_t)row * out_features + col;
        if (pair) {
          *reinterpret_cast<float2*>(p) = make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
        } else {
          p[0] = acc[4 * c + 2 * h];
          if (col + 1 < out_features) p[1] = acc[4 * c + 2 * h + 1];
        }
      }
    __threadfence();
    bar_sync(1, Q_CONSUMERS * 32);
    if (tid == 0) {  // the last split zeroes the tile's ticket for the next launch
      int* tk = tickets + ((size_t)e * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      s_last = atomicAdd(tk, 1) == splits - 1;
      if (s_last) *tk = 0;
    }
    bar_sync(1, Q_CONSUMERS * 32);
    if (!s_last) return;
    __threadfence();
    reduce_splits<BM, Q_BN, Q_CONSUMERS * 32>(
        partials + (size_t)e * splits * t_pad * out_features, (size_t)t_pad * out_features, splits,
        nullptr, out, row0, col0, T, out_features, tid);
  }
}

template <bool MOE, bool KSPLIT>
cudaError_t gemm_launch(const void* x, const void* w4, const void* gscale, void* out,
                        void* partials, void* tickets, int experts, int x_per_expert, int T,
                        int splits, int blocks_per_split, int stages, int smem, int out_features,
                        int in_features, int ldb, cudaStream_t stream) {
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(int4_gemm_kernel<MOE, KSPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  constexpr int BM = KSPLIT ? 64 : 128;
  const EncodeTiled encode = encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  // x [E or 1][T][in_features]: boxes of 64 columns x BM rows, 128B-swizzled
  CUtensorMap x_map;
  const cuuint64_t x_dims[3] = {(cuuint64_t)in_features, (cuuint64_t)T,
                                (cuuint64_t)(x_per_expert ? experts : 1)};
  const cuuint64_t x_strides[2] = {(cuuint64_t)in_features * 2, (cuuint64_t)T * in_features * 2};
  const cuuint32_t x_box[3] = {Q_BK, (cuuint32_t)BM, 1};
  if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), x_dims, x_strides,
             x_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // w4 [E][OUT][ldb]: boxes of one packing block (128 bytes) x 128 rows, 128B-swizzled
  CUtensorMap w_map;
  const cuuint64_t w_dims[3] = {(cuuint64_t)ldb, (cuuint64_t)out_features, (cuuint64_t)experts};
  const cuuint64_t w_strides[2] = {(cuuint64_t)ldb, (cuuint64_t)out_features * ldb};
  const cuuint32_t w_box[3] = {Q_PB, Q_BN, 1};
  if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w4), w_dims, w_strides,
             w_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const dim3 grid((out_features + Q_BN - 1) / Q_BN, (T + BM - 1) / BM, experts * splits);
  int4_gemm_kernel<MOE, KSPLIT><<<grid, Q_THREADS, smem, stream>>>(
      x_map, w_map, (const float*)gscale, (__nv_bfloat16*)out, (float*)partials, (int*)tickets, T,
      out_features, in_features, 2 * ldb / 128, splits, blocks_per_split, stages, x_per_expert);
  return cudaGetLastError();
}

template <bool MOE>
int gemm_dispatch(const void* x, const void* w4, const void* gscale, void* out, void* partials,
                  void* tickets, int experts, int x_per_expert, int T, int splits,
                  int cols_per_split, int out_features, int in_features, int ldb, int bm,
                  int stages, int smem, cudaStream_t st) {
  if ((bm != 64 && bm != 128) || stages < 2 || stages > Q_MAX_STAGES || smem > SMEM_LIMIT ||
      smem != QLayout(bm, stages).total() || (bm == 64 && stages * 64 * Q_BK * 2 < 32768) ||
      cols_per_split < 2 * Q_PB ||
      cols_per_split % (2 * Q_PB) || (long long)(splits - 1) * cols_per_split >= in_features)
    return cudaErrorInvalidValue;
  if (bm == 64)
    return gemm_launch<MOE, true>(x, w4, gscale, out, partials, tickets, experts, x_per_expert, T,
                                  splits, cols_per_split / (2 * Q_PB), stages, smem, out_features,
                                  in_features, ldb, st);
  return gemm_launch<MOE, false>(x, w4, gscale, out, partials, tickets, experts, x_per_expert, T,
                                 splits, cols_per_split / (2 * Q_PB), stages, smem, out_features,
                                 in_features, ldb, st);
}

template <bool MOE>
int gemv_dispatch(const void* x, const void* w4, const void* gscale, void* out, int experts,
                  int x_per_expert, int T, int out_features, int in_features, int ldb,
                  int blocks, int runs, int smem, cudaStream_t st) {
  const int tiles = experts * ((out_features + GV_ROWS - 1) / GV_ROWS);
  if (blocks < 1 || blocks > tiles) return cudaErrorInvalidValue;
  const GemvLayout lo(T, in_features, tiles, blocks);
  if (runs != lo.chunks || smem != lo.total() || smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_gemv_kernel<MOE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  int4_gemv_kernel<MOE><<<blocks, GV_THREADS, smem, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)w4, (const float*)gscale, (__nv_bfloat16*)out, T,
      out_features, in_features, ldb, experts, x_per_expert, lo.chunks);
  return cudaGetLastError();
}

bool shapes_ok(int experts, int T, int out_features, int in_features, int ldb) {
  return experts >= 1 && T >= 1 && out_features >= 1 && in_features >= 16 &&
         in_features % 16 == 0 && ldb >= Q_PB && ldb % Q_PB == 0 && in_features <= 2 * ldb;
}

}  // namespace

// The forward, as int4_matmul.plan lays it out. w4 [E, OUT, ldb],
// gscale [E, 2 * ldb / 128, OUT], out [E, T, OUT]; x [T, in_features] shared
// by the experts (x_per_expert = 0) or [E, T, in_features]; E = 1 for one
// matrix. ldb is the packed row length (IN_pad / 2, a multiple of 128);
// in_features <= 2 * ldb and a multiple of 16. One matrix (or one expert)
// needs no offsets: it runs the kernels compiled without them.
//
// The prefill GEMM, T > 8: bm = 128, or 64 with the contraction's groups
// split over the two consumer warpgroups; `stages` x-ring stages, `smem`
// dynamic bytes, checked against the kernel's own layout; splits > 1 splits
// its contraction into runs of cols_per_split columns (a multiple of 256),
// and partials [E, splits, ceil(T/bm)*bm, OUT] f32 and tickets [E,
// ceil(T/bm), ceil(OUT/128)] int32 are then required, the tickets zero
// before the first launch: the last block of each output tile zeroes its
// ticket again, so launches on one stream share one buffer.
extern "C" int int4_matmul_launch(const void* x, const void* w4, const void* gscale, void* out,
                                  void* partials, void* tickets, int experts, int x_per_expert,
                                  int T, int splits, int cols_per_split, int out_features,
                                  int in_features, int ldb, int bm, int stages, int smem,
                                  void* stream) {
  if (!shapes_ok(experts, T, out_features, in_features, ldb) || T <= 8 || splits < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (experts > 1)
    return gemm_dispatch<true>(x, w4, gscale, out, partials, tickets, experts, x_per_expert, T,
                               splits, cols_per_split, out_features, in_features, ldb, bm, stages,
                               smem, st);
  return gemm_dispatch<false>(x, w4, gscale, out, partials, tickets, 1, 0, T, splits,
                              cols_per_split, out_features, in_features, ldb, bm, stages, smem,
                              st);
}

// The decode GEMV, T <= 8: `blocks` blocks, `runs` the activations' staged
// runs and `smem` the dynamic bytes, the last two as GemvLayout computes them.
extern "C" int int4_gemv_launch(const void* x, const void* w4, const void* gscale, void* out,
                                int experts, int x_per_expert, int T, int out_features,
                                int in_features, int ldb, int blocks, int runs, int smem,
                                void* stream) {
  if (!shapes_ok(experts, T, out_features, in_features, ldb) || T > 8)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (experts > 1)
    return gemv_dispatch<true>(x, w4, gscale, out, experts, x_per_expert, T, out_features,
                               in_features, ldb, blocks, runs, smem, st);
  return gemv_dispatch<false>(x, w4, gscale, out, 1, 0, T, out_features, in_features, ldb, blocks,
                              runs, smem, st);
}
