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
// - B13: every block copies the codebooks into shared memory (rounded to bf16
//   there when not precise), then each thread takes one group (o, ig) at a
//   time in a grid-stride loop: it reads its K code bytes, gathers K rows of
//   g floats from shared memory, sums them, scales, and writes the g floats
//   of W row o as 16-byte stores (g % 4 == 0; one float at a time else).
//   Neighbouring threads take neighbouring groups, so a warp writes 32*g
//   contiguous floats and reads 32*K contiguous code bytes.
// - B14: every block accumulates a private [K, S, g] f32 copy in shared
//   memory with shared atomics: thread t takes element e = group*g + j of
//   the data (neighbouring threads read neighbouring floats; the g lanes of
//   one group share its code bytes), and adds it at (k, code_k, j) for every
//   k. The block's copy then goes into the zeroed output with one global
//   atomic add per non-zero element. Sums are taken in no fixed order, so
//   results may differ in the last bits from run to run.
// Both grids hold as many blocks as fit on the card at once (the occupancy
// API), so the codebook copy is paid once per resident block.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <bool kPrecise>
__global__ void __launch_bounds__(THREADS)
    dequant_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ cb,
                   const float* __restrict__ scales, float* __restrict__ out, long long n_groups,
                   int IG, int K, int S, int g) {
  extern __shared__ float4 smem4[];
  float* s_cb = reinterpret_cast<float*>(smem4);  // [K, S, g]
  const int n_cb = K * S * g;
  for (int i = threadIdx.x; i < n_cb; i += THREADS) {
    const float v = __ldg(cb + i);
    s_cb[i] = kPrecise ? v : round_bf16(v);
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long n = (long long)blockIdx.x * THREADS + threadIdx.x; n < n_groups; n += stride) {
    const uint8_t* c = codes + n * K;
    const float scale = scales ? __ldg(scales + n / IG) : 1.f;
    float* dst = out + n * g;
    if ((g & 3) == 0) {
      for (int j = 0; j < g; j += 4) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int k = 0; k < K; ++k) {
          const float4 v = *reinterpret_cast<const float4*>(
              s_cb + ((size_t)k * S + __ldg(c + k)) * g + j);
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
        if (scales) {
          acc.x *= scale;
          acc.y *= scale;
          acc.z *= scale;
          acc.w *= scale;
        }
        *reinterpret_cast<float4*>(dst + j) = acc;
      }
    } else {
      for (int j = 0; j < g; ++j) {
        float acc = 0.f;
        for (int k = 0; k < K; ++k) acc += s_cb[((size_t)k * S + __ldg(c + k)) * g + j];
        dst[j] = scales ? acc * scale : acc;
      }
    }
  }
}

template <bool kPrecise>
__global__ void __launch_bounds__(THREADS)
    cb_grad_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ data,
                   float* __restrict__ out, long long n_elem, int K, int S, int g) {
  extern __shared__ float4 smem4[];
  float* s_acc = reinterpret_cast<float*>(smem4);  // [K, S, g]
  const int n_acc = K * S * g;
  for (int i = threadIdx.x; i < n_acc; i += THREADS) s_acc[i] = 0.f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < n_elem; e += stride) {
    const long long i = e / g;
    const int j = (int)(e - i * g);
    float v = __ldg(data + e);
    if (!kPrecise) v = round_bf16(v);
    const uint8_t* c = codes + i * K;
    for (int k = 0; k < K; ++k) {
      const int s = (int)__ldg(c + k);
      atomicAdd(s_acc + ((size_t)k * S + s) * g + j, v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_acc; i += THREADS) {
    const float v = s_acc[i];
    if (v != 0.f) atomicAdd(out + i, v);
  }
}

// blocks of `kernel` that fit on the card at once with `smem` bytes each,
// capped by the work (`units` items at THREADS a block)
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int smem, long long units, int* grid) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (units + THREADS - 1) / THREADS;
  long long blocks = (long long)sms * per_sm;
  if (need < blocks) blocks = need;
  *grid = (int)(blocks < 1 ? 1 : blocks);
  return cudaSuccess;
}

template <bool kPrecise>
cudaError_t launch_dequant(const void* codes, const void* cb, const void* scales, void* out,
                           long long n_groups, int IG, int K, int S, int g, cudaStream_t st) {
  const int smem = K * S * g * (int)sizeof(float);
  auto kernel = dequant_kernel<kPrecise>;
  int grid = 0;
  cudaError_t err = grid_for(kernel, smem, n_groups, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, st>>>((const uint8_t*)codes, (const float*)cb,
                                      (const float*)scales, (float*)out, n_groups, IG, K, S, g);
  return cudaGetLastError();
}

template <bool kPrecise>
cudaError_t launch_cb_grad(const void* codes, const void* data, void* out, long long n_groups,
                           int K, int S, int g, cudaStream_t st) {
  const int smem = K * S * g * (int)sizeof(float);
  auto kernel = cb_grad_kernel<kPrecise>;
  const long long n_elem = n_groups * g;
  int grid = 0;
  cudaError_t err = grid_for(kernel, smem, n_elem, &grid);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(out, 0, (size_t)smem, st);
  if (err != cudaSuccess) return err;
  if (n_elem == 0) return cudaSuccess;
  kernel<<<grid, THREADS, smem, st>>>((const uint8_t*)codes, (const float*)data, (float*)out,
                                      n_elem, K, S, g);
  return cudaGetLastError();
}

}  // namespace

// codes [OG, IG, K] uint8; cb [K, S, g] f32; scales [OG] f32 or null; out [OG, IG*g] f32.
extern "C" int calib_dequant_launch(const void* codes, const void* cb, const void* scales,
                                    void* out, long long n_groups, int IG, int K, int S, int g,
                                    int precise, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_groups == 0) return cudaSuccess;
  if (precise) return launch_dequant<true>(codes, cb, scales, out, n_groups, IG, K, S, g, st);
  return launch_dequant<false>(codes, cb, scales, out, n_groups, IG, K, S, g, st);
}

// codes [G, K] uint8; data [G, g] f32; out [K, S, g] f32 (zeroed here).
extern "C" int cb_grad_launch(const void* codes, const void* data, void* out, long long n_groups,
                              int K, int S, int g, int precise, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (precise) return launch_cb_grad<true>(codes, data, out, n_groups, K, S, g, st);
  return launch_cb_grad<false>(codes, data, out, n_groups, K, S, g, st);
}
