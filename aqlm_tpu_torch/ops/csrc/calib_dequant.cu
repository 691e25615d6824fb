// B13 and B14: the differentiable Kx8 dequant of calibration, forward and backward.
//
// B13 replaces the TPU kernel aqlm_tpu/ops/kernels.py: dequantize_onehot
// (_dequant_call, pallas_call at :307), the forward of the custom VJP
// _dequant_groups_kernel (aqlm_tpu/ops/dequant.py:113-133):
//
//   W[o, ig*g + j] = scale[o] * sum_k cb[k, codes[o, ig, k], j]
//
// summed in f32 in codebook order from zero. precise: the f32 entries as
// they are (the TPU's f32 one-hot matmul at HIGHEST precision); otherwise
// each entry rounds to bf16 first (its bf16 one-hot matmul, kernels.py:93-122).
//
// B14 replaces aqlm_tpu/ops/kernels.py: cb_grad_segment (_cb_grad_call,
// pallas_call at :244), that VJP's backward (dequant.py:141-169):
//
//   dcb[k, s, j] = sum over groups i with codes[i, k] == s of data[i, j]
//
// precise: data in f32; otherwise each value rounds to bf16 first (the TPU's
// single-pass bf16 dot).
//
// What bounds them on an H100: bytes. B13 writes the f32 weight (OUT*IN*4,
// 180 MB at Llama-2-7B's gate) and reads K bytes of codes per group; B14
// reads the f32 gradient of the same size. At 3.35 TB/s both are ~0.057 ms
// at gate; the codebooks (K*S*g*4 bytes, 16 KB for 2x8) are noise.
//
// Design. The TPU's one-hot matmul is a device for its MXU; on Hopper both are
// gathers and scatters through shared memory.
// - B13 is a stream of whole-line stores. Every block copies the codebooks
//   into shared memory (rounded to bf16 there when not precise). W is walked
//   as one flat array: at g % 4 == 0 a lane owns one float4 of it (two lanes a
//   group at g = 8), so each warp store writes 512 contiguous bytes and every
//   32-byte sector is written whole by one instruction (the first design gave
//   a thread a whole group, two float4 stores 16 bytes apart, each warp store
//   spread over 1 KB: its stores alone ran at 26% of the byte bound); at
//   other g a lane owns one float (128 contiguous bytes a warp store). A
//   thread takes four such units a step, their code loads issued before any
//   sum: one load of K bytes where K is 1, 2, 4 or 8 and the codes are
//   aligned for it, else K byte loads into a 64-bit word (3.6% slower at
//   gate; the next step's loads in flight as well, or 2 or 8 units, gained
//   nothing).
//   The lanes of a group read neighbouring float4s of one codebook row, so
//   the gathers cost nothing measurable. Indices are 32-bit (a launch of
//   more than 2^31 - 1 floats is cut into runs of whole rows), and a unit's
//   group and row come from a multiply and a shift (division by a
//   magic number), not a division. The sum keeps the order k = 0..K-1 from
//   0.0f, then times the scale, so precise results are bit-identical to
//   kernels.dequant_plain. What bounds it now: the stores (contiguous
//   stores alone reach 87% of the byte bound at gate, a fill_ 95%) and the
//   codes' reads from device memory among them (~0.012 ms at gate: with the
//   codes in L2 the kernel runs at the stores' pace).
// - B14: one block of 1024 threads an SM (kernels.cb_grad_plan), each over a
//   contiguous run of the groups. A thread owns two neighbouring columns of
//   its groups (one float2 load; thread rows of g / 2 lanes, so no division
//   per element, a warp's load 256 contiguous bytes) and has two batches of
//   four groups' data and codes in flight. It adds each float with a shared
//   f32 atomic, which the card runs as a 32-bit compare-and-swap loop
//   (ATOMS.CAST.SPIN): into 32 / (g / 2) copies, a warp's i-th group row
//   into copy i, the copies whose banks alias keeping their columns in
//   swapped pairs, so each add of a warp falls on 32 distinct banks whatever
//   the codes (at gate a float a thread with four copies ran 1.35x slower,
//   one 64-bit compare-and-swap a float2 2.4x slower, a ring of bulk copies
//   with 16 consumer warps 1.7x slower). Each block then writes the sum of
//   its copies to its own slice of a partial-sum buffer (kept per stream by
//   the wrapper), and a second short kernel adds the slices in block order
//   into the output: no global atomics, no memset, a fixed merge order. The
//   atomics' order within a block is not fixed, so sums may differ in the
//   last bits from run to run. A group's codes come in one load as in B13
//   (two byte loads at K = 2 ran 15% slower at gate, the 64-bit byte-load
//   path 1.9x: half the groups a batch). Odd g, unaligned data or copies
//   that do not fit take a float a thread and fewer copies. What bounds it
//   now: the loads (with no adds at all it runs 8-13% faster at gate, at
//   68-73% of the byte bound with 64 KB in flight an SM); the merge takes
//   ~0.002 ms.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int DQ_THREADS = 256;  // B13 block
constexpr int DQ_UNITS = 4;      // float4s (or floats) a B13 thread takes a step
constexpr int CG_THREADS = 1024;  // B14 block: one an SM
constexpr int CG_UNROLL = 8;      // groups a B14 thread has in flight
constexpr int MG_CHUNK = 16;      // partial slices a merge thread adds
constexpr int MG_MAX_CHUNKS = 16;  // so at most 256 partial slices (blocks)

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

using aqlm::div_by;
using aqlm::fast_div;
using aqlm::FastDiv;

// a group's K code bytes, byte k at bits 8k: one load of B bytes (B = K,
// aligned for it), or K byte loads (B = 0)
template <int B>
__device__ __forceinline__ uint64_t load_codes(const uint8_t* p, int K) {
  if constexpr (B == 1) {
    return __ldg(p);
  } else if constexpr (B == 2) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  } else if constexpr (B == 4) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (B == 8) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
  } else {
    uint64_t w = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < K) w |= (uint64_t)__ldg(p + k) << (8 * k);
    return w;
  }
}

// a thread's register for one group's codes: 32 bits where K <= 4 is known
template <int B>
using CodeWord = std::conditional_t<B == 1 || B == 2 || B == 4, uint32_t, uint64_t>;

__device__ __forceinline__ int code_of(uint64_t w, int k) { return (int)((w >> (8 * k)) & 0xffu); }

// the codebooks [K, S, g] into shared memory, rounded to bf16 unless precise
template <bool kPrecise>
__device__ __forceinline__ void fill_codebooks(float* s_cb, const float* __restrict__ cb, int n_cb) {
  if ((n_cb & 3) == 0 && (reinterpret_cast<uintptr_t>(cb) & 15) == 0) {
    for (int i = threadIdx.x; i < n_cb / 4; i += blockDim.x) {
      float4 v = __ldg(reinterpret_cast<const float4*>(cb) + i);
      if (!kPrecise) {
        v.x = round_bf16(v.x);
        v.y = round_bf16(v.y);
        v.z = round_bf16(v.z);
        v.w = round_bf16(v.w);
      }
      reinterpret_cast<float4*>(s_cb)[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < n_cb; i += blockDim.x) {
      const float v = __ldg(cb + i);
      s_cb[i] = kPrecise ? v : round_bf16(v);
    }
  }
}

// B13 at g % 4 == 0: lane owns float4 f of W (group f / (g/4), quarter f % (g/4))
template <bool kPrecise, int kCodeBytes>
__global__ void __launch_bounds__(DQ_THREADS)
    dequant4_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ cb,
                    const float* __restrict__ scales, float4* __restrict__ out, uint32_t n4,
                    FastDiv per_group, FastDiv per_row, int K, int S, int g) {
  extern __shared__ float4 smem4[];
  float* s_cb = reinterpret_cast<float*>(smem4);  // [K, S, g]
  fill_codebooks<kPrecise>(s_cb, cb, K * S * g);
  __syncthreads();
  const uint32_t q = (uint32_t)g >> 2;
  const uint32_t step = gridDim.x * (DQ_THREADS * DQ_UNITS);
  for (uint32_t f0 = blockIdx.x * (DQ_THREADS * DQ_UNITS) + threadIdx.x; f0 < n4; f0 += step) {
    uint32_t n[DQ_UNITS];
    CodeWord<kCodeBytes> cw[DQ_UNITS];
#pragma unroll
    for (int u = 0; u < DQ_UNITS; ++u) {
      const uint32_t f = f0 + u * DQ_THREADS;
      n[u] = div_by(f, per_group);
      cw[u] = f < n4 ? load_codes<kCodeBytes>(codes + (size_t)n[u] * K, K) : 0;
    }
#pragma unroll
    for (int u = 0; u < DQ_UNITS; ++u) {
      const uint32_t f = f0 + u * DQ_THREADS;
      if (f >= n4) break;
      const int col = (int)(f - n[u] * q) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= K) break;
        const float4 v =
            *reinterpret_cast<const float4*>(s_cb + (k * S + code_of(cw[u], k)) * g + col);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      if (scales) {
        const float s = __ldg(scales + div_by(n[u], per_row));
        acc.x *= s;
        acc.y *= s;
        acc.z *= s;
        acc.w *= s;
      }
      out[f] = acc;
    }
  }
}

// B13 at any other g: lane owns float e of W (group e / g, column e % g)
template <bool kPrecise>
__global__ void __launch_bounds__(DQ_THREADS)
    dequant1_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ cb,
                    const float* __restrict__ scales, float* __restrict__ out, uint32_t n1,
                    FastDiv per_group, FastDiv per_row, int K, int S, int g) {
  extern __shared__ float4 smem4[];
  float* s_cb = reinterpret_cast<float*>(smem4);  // [K, S, g]
  fill_codebooks<kPrecise>(s_cb, cb, K * S * g);
  __syncthreads();
  const uint32_t step = gridDim.x * (DQ_THREADS * DQ_UNITS);
  for (uint32_t e0 = blockIdx.x * (DQ_THREADS * DQ_UNITS) + threadIdx.x; e0 < n1; e0 += step) {
    uint32_t n[DQ_UNITS];
    uint64_t cw[DQ_UNITS];
#pragma unroll
    for (int u = 0; u < DQ_UNITS; ++u) {
      const uint32_t e = e0 + u * DQ_THREADS;
      n[u] = div_by(e, per_group);
      cw[u] = e < n1 ? load_codes<0>(codes + (size_t)n[u] * K, K) : 0;
    }
#pragma unroll
    for (int u = 0; u < DQ_UNITS; ++u) {
      const uint32_t e = e0 + u * DQ_THREADS;
      if (e >= n1) break;
      const int col = (int)(e - n[u] * (uint32_t)g);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= K) break;
        acc += s_cb[(k * S + code_of(cw[u], k)) * g + col];
      }
      out[e] = scales ? acc * __ldg(scales + div_by(n[u], per_row)) : acc;
    }
  }
}

// B14: block b adds the groups [b * per_block, (b + 1) * per_block) into
// shared [K, S, slots, g] copies and writes their sum over the slots to
// dst + b * K*S*g. A thread owns V neighbouring columns (V = 2: one float2
// load, two adds): thread t takes columns V * (t % cols) (and + V * cols,
// ... when g > V * cols) of the groups t / cols, t / cols + rows, ...; at
// slots = 32 / cols the i-th group row of a warp adds into copy i, and at
// V = 2 the copies whose banks alias (i and i + slots / 2) keep their
// columns in swapped pairs (j ^ 1), so each of a warp's adds falls on 32
// distinct banks whatever the codes. The card has no shared f32 add: each
// is a 32-bit compare-and-swap loop.
template <bool kPrecise, int kCodeBytes, int V>
__global__ void __launch_bounds__(CG_THREADS, 1)
    cb_grad_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ data,
                   float* __restrict__ dst, long long n_groups, long long per_block, int K, int S,
                   int g, int cols, int rows, int slots) {
  // groups a thread has in flight a batch (twice that in all): fewer where a
  // group's codes take a 64-bit register, so nothing spills
  constexpr int U = CG_UNROLL / V / (int)(sizeof(CodeWord<kCodeBytes>) / 4);
  using Vec = std::conditional_t<V == 2, float2, float>;
  extern __shared__ float4 smem4[];
  float* s_acc = reinterpret_cast<float*>(smem4);  // [K, S, slots, g]
  const int n_acc = K * S * g;
  const int row_stride = slots * g;
  for (int i = threadIdx.x; i < n_acc * slots; i += CG_THREADS) s_acc[i] = 0.f;
  __syncthreads();
  const int tr = threadIdx.x / cols;
  const int tj = threadIdx.x - tr * cols;
  float* s_mine = s_acc + (tr % slots) * g;  // this thread's copy
  const int sw = V == 2 ? ((tr % slots) * g) >> 5 : 0;  // its column pairs swapped (aliasing copies)
  const long long g0 = blockIdx.x * per_block;
  const long long g1 = min(n_groups, g0 + per_block);
  if (tr < rows) {
    const long long batch = (long long)rows * U;
    for (int j = V * tj; j < g; j += V * cols) {
      // the next batch's data and codes are in flight while this batch is added
      Vec v[U];
      CodeWord<kCodeBytes> cw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = g0 + tr + (long long)u * rows;
        v[u] = i < g1 ? __ldg(reinterpret_cast<const Vec*>(data + i * g + j)) : Vec{};
        cw[u] = i < g1 ? load_codes<kCodeBytes>(codes + i * K, K) : 0;
      }
      for (long long i0 = g0 + tr; i0 < g1; i0 += batch) {
        Vec v_next[U];
        CodeWord<kCodeBytes> cw_next[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long i = i0 + batch + (long long)u * rows;
          v_next[u] = i < g1 ? __ldg(reinterpret_cast<const Vec*>(data + i * g + j)) : Vec{};
          cw_next[u] = i < g1 ? load_codes<kCodeBytes>(codes + i * K, K) : 0;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i0 + (long long)u * rows >= g1) break;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (k >= K) break;
            float* p = s_mine + (k * S + code_of(cw[u], k)) * row_stride + j;
            if constexpr (V == 2) {
              atomicAdd(p + sw, kPrecise ? v[u].x : round_bf16(v[u].x));
              atomicAdd(p + (sw ^ 1), kPrecise ? v[u].y : round_bf16(v[u].y));
            } else {
              atomicAdd(p, kPrecise ? v[u] : round_bf16(v[u]));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          v[u] = v_next[u];
          cw[u] = cw_next[u];
        }
      }
    }
  }
  __syncthreads();
  float* d = dst + (size_t)blockIdx.x * n_acc;
  for (int i = threadIdx.x; i < n_acc; i += CG_THREADS) {
    const int row = i / g, j = i - row * g;
    const float* src = s_acc + row * row_stride;
    float v = src[j];
    for (int c = 1; c < slots; ++c)  // copies in order (copy c's pairs swapped where it aliases)
      v += src[c * g + (V == 2 ? j ^ ((c * g) >> 5) : j)];
    d[i] = v;
  }
}

// out[e] = sum over b < P of partials[b, e], in block order: thread (x, y)
// adds slices [16y, 16y + 16) of element blockIdx.x * 32 + x, then row 0 adds
// the chunks' sums in chunk order
__global__ void __launch_bounds__(32 * MG_MAX_CHUNKS)
    cb_grad_merge_kernel(const float* __restrict__ partials, float* __restrict__ out, int n_acc,
                         int P) {
  __shared__ float s_sum[MG_MAX_CHUNKS][32];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (e < n_acc) {
    const int p0 = threadIdx.y * MG_CHUNK;
    float v[MG_CHUNK];
#pragma unroll
    for (int u = 0; u < MG_CHUNK; ++u)
      v[u] = p0 + u < P ? __ldg(partials + (size_t)(p0 + u) * n_acc + e) : 0.f;
#pragma unroll
    for (int u = 0; u < MG_CHUNK; ++u)
      if (p0 + u < P) acc += v[u];
  }
  s_sum[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < n_acc) {
    float s = s_sum[0][threadIdx.x];
    for (int c = 1; c < (int)blockDim.y; ++c) s += s_sum[c][threadIdx.x];
    out[e] = s;
  }
}

template <typename Kernel>
cudaError_t smem_attr(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// blocks of `kernel` resident on the card at once with `smem` bytes each,
// capped by `need`
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, int smem, long long need, int* grid) {
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DQ_THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (long long)sms * per_sm;
  if (need < blocks) blocks = need;
  *grid = (int)(blocks < 1 ? 1 : blocks);
  return cudaSuccess;
}

// one run of whole rows (n_units < 2^31 float4s or floats)
template <typename Kernel, typename Out>
cudaError_t dequant_run(Kernel kernel, const uint8_t* codes, const float* cb, const float* scales,
                        Out* out, uint32_t n_units, FastDiv per_group, FastDiv per_row, int K,
                        int S, int g, int smem, cudaStream_t st) {
  int grid = 0;
  cudaError_t err = smem_attr(kernel, smem);
  if (err != cudaSuccess) return err;
  err = resident_grid(kernel, smem, ((long long)n_units + DQ_THREADS * DQ_UNITS - 1) /
                                        (DQ_THREADS * DQ_UNITS), &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, DQ_THREADS, smem, st>>>(codes, cb, scales, out, n_units, per_group, per_row, K,
                                         S, g);
  return cudaGetLastError();
}

template <bool kPrecise>
cudaError_t launch_dequant(const uint8_t* codes, const float* cb, const float* scales, float* out,
                           long long n_groups, int IG, int K, int S, int g, cudaStream_t st) {
  const int smem = K * S * g * (int)sizeof(float);
  const bool vec = (g & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int per_unit = vec ? 4 : 1;  // floats a lane stores
  const int code_bytes =
      (K == 1 || K == 2 || K == 4 || K == 8) && reinterpret_cast<uintptr_t>(codes) % K == 0 ? K : 0;
  const FastDiv per_group = fast_div((uint32_t)(g / per_unit));
  const FastDiv per_row = fast_div((uint32_t)IG);
  // runs of whole rows of fewer than 2^31 floats, so every index fits in 32 bits
  const long long row_floats = (long long)IG * g;
  const long long rows_per_run = ((1ll << 31) - 1) / row_floats;
  if (rows_per_run < 1) return cudaErrorInvalidValue;  // a row of 2^31 floats or more
  const long long n_rows = n_groups / IG;
  for (long long r0 = 0; r0 < n_rows; r0 += rows_per_run) {
    const long long rows = n_rows - r0 < rows_per_run ? n_rows - r0 : rows_per_run;
    const uint8_t* c = codes + r0 * IG * K;
    const float* s = scales ? scales + r0 : nullptr;
    float* o = out + r0 * row_floats;
    const uint32_t n_units = (uint32_t)(rows * row_floats / per_unit);
    cudaError_t err;
    if (!vec) {
      err = dequant_run(dequant1_kernel<kPrecise>, c, cb, s, o, n_units, per_group, per_row, K, S,
                        g, smem, st);
    } else {
      float4* o4 = reinterpret_cast<float4*>(o);
      switch (code_bytes) {
        case 1:
          err = dequant_run(dequant4_kernel<kPrecise, 1>, c, cb, s, o4, n_units, per_group,
                            per_row, K, S, g, smem, st);
          break;
        case 2:
          err = dequant_run(dequant4_kernel<kPrecise, 2>, c, cb, s, o4, n_units, per_group,
                            per_row, K, S, g, smem, st);
          break;
        case 4:
          err = dequant_run(dequant4_kernel<kPrecise, 4>, c, cb, s, o4, n_units, per_group,
                            per_row, K, S, g, smem, st);
          break;
        case 8:
          err = dequant_run(dequant4_kernel<kPrecise, 8>, c, cb, s, o4, n_units, per_group,
                            per_row, K, S, g, smem, st);
          break;
        default:
          err = dequant_run(dequant4_kernel<kPrecise, 0>, c, cb, s, o4, n_units, per_group,
                            per_row, K, S, g, smem, st);
      }
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool kPrecise, int kCodeBytes, int V>
cudaError_t cb_grad_run(const uint8_t* codes, const float* data, float* dst, long long n_groups,
                        int K, int S, int g, int blocks, int slots, cudaStream_t st) {
  const int smem = K * S * g * slots * (int)sizeof(float);
  auto kernel = cb_grad_kernel<kPrecise, kCodeBytes, V>;
  cudaError_t err = smem_attr(kernel, smem);
  if (err != cudaSuccess) return err;
  const int cols = g / V < CG_THREADS ? g / V : CG_THREADS;
  const int rows = CG_THREADS / cols;
  const long long per_block = (n_groups + blocks - 1) / blocks;
  kernel<<<blocks, CG_THREADS, smem, st>>>(codes, data, dst, n_groups, per_block, K, S, g, cols,
                                           rows, slots);
  return cudaGetLastError();
}

template <bool kPrecise, int V>
cudaError_t cb_grad_codes(const uint8_t* codes, const float* data, float* dst, long long n_groups,
                          int K, int S, int g, int blocks, int slots, cudaStream_t st) {
  const int code_bytes =
      (K == 1 || K == 2 || K == 4 || K == 8) && reinterpret_cast<uintptr_t>(codes) % K == 0 ? K : 0;
  switch (code_bytes) {
    case 1:
      return cb_grad_run<kPrecise, 1, V>(codes, data, dst, n_groups, K, S, g, blocks, slots, st);
    case 2:
      return cb_grad_run<kPrecise, 2, V>(codes, data, dst, n_groups, K, S, g, blocks, slots, st);
    case 4:
      return cb_grad_run<kPrecise, 4, V>(codes, data, dst, n_groups, K, S, g, blocks, slots, st);
    case 8:
      return cb_grad_run<kPrecise, 8, V>(codes, data, dst, n_groups, K, S, g, blocks, slots, st);
    default:
      return cb_grad_run<kPrecise, 0, V>(codes, data, dst, n_groups, K, S, g, blocks, slots, st);
  }
}

template <bool kPrecise>
cudaError_t launch_cb_grad(const uint8_t* codes, const float* data, float* out, float* partials,
                           long long n_groups, int K, int S, int g, int blocks, int slots, int vec,
                           cudaStream_t st) {
  auto run = vec == 2 ? cb_grad_codes<kPrecise, 2> : cb_grad_codes<kPrecise, 1>;
  cudaError_t err = run(codes, data, partials, n_groups, K, S, g, blocks, slots, st);
  if (err != cudaSuccess) return err;
  const int n_acc = K * S * g;
  const dim3 block(32, (blocks + MG_CHUNK - 1) / MG_CHUNK);
  cb_grad_merge_kernel<<<(n_acc + 31) / 32, block, 0, st>>>(partials, out, n_acc, blocks);
  return cudaGetLastError();
}

}  // namespace

// codes [OG, IG, K] uint8; cb [K, S, g] f32; scales [OG] f32 or null; out [OG, IG*g] f32.
extern "C" int calib_dequant_launch(const void* codes, const void* cb, const void* scales,
                                    void* out, long long n_groups, int IG, int K, int S, int g,
                                    int precise, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_groups == 0) return cudaSuccess;
  if (IG < 1 || n_groups % IG || K < 1 || K > 8 || g < 1) return cudaErrorInvalidValue;
  if (precise)
    return launch_dequant<true>((const uint8_t*)codes, (const float*)cb, (const float*)scales,
                                (float*)out, n_groups, IG, K, S, g, st);
  return launch_dequant<false>((const uint8_t*)codes, (const float*)cb, (const float*)scales,
                               (float*)out, n_groups, IG, K, S, g, st);
}

// codes [G, K] uint8; data [G, g] f32; out [K, S, g] f32, every element
// written; partials [blocks, K, S, g] f32 scratch;
// blocks (1-256), slots (1, or 32 / cols, cols = g / vec: the shared
// copies a block keeps) and vec (1, or 2: a thread a float2, for even g and
// 8-byte aligned data) as kernels.cb_grad_plan gives them.
extern "C" int cb_grad_launch(const void* codes, const void* data, void* out, void* partials,
                              long long n_groups, int K, int S, int g, int blocks, int slots,
                              int vec, int precise, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K < 1 || K > 8 || g < 1 || blocks < 1 || blocks > MG_CHUNK * MG_MAX_CHUNKS ||
      !partials || (vec != 1 && vec != 2) || g % vec ||
      (vec == 2 && reinterpret_cast<uintptr_t>(data) % 8) ||
      (slots != 1 && slots * (g / vec) != 32))
    return cudaErrorInvalidValue;
  if (precise)
    return launch_cb_grad<true>((const uint8_t*)codes, (const float*)data, (float*)out,
                                (float*)partials, n_groups, K, S, g, blocks, slots, vec, st);
  return launch_cb_grad<false>((const uint8_t*)codes, (const float*)data, (float*)out,
                               (float*)partials, n_groups, K, S, g, blocks, slots, vec, st);
}
