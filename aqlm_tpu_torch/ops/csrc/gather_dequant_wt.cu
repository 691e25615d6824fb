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
// Design: the codebooks ([K, S, 8] bf16, 8 KB at K = 2, S = 256) sit in
// shared memory. A block of 128 threads owns 128 consecutive output columns
// over a run of 32 input groups; each thread takes one column o. Per input
// group it reads its K codes (one byte each, neighbouring threads on
// neighbouring bytes of the tile's row), each codebook entry as one 16-byte
// load of 8 bf16 from shared memory, adds them in f32, scales in f32 and
// writes 8 values to rows ig*8 ... ig*8+7 of column o: per row a warp writes
// 32 consecutive values (64 bytes in bf16). Its f32 operations are those of
// its plain version in the same order, so the result is bit-identical.
#include "common.cuh"

namespace {

constexpr int G = 8;
constexpr int THREADS = 128;  // output columns per block, one a thread
constexpr int IG_RUN = 32;    // input groups per block

template <typename OT>
__global__ void __launch_bounds__(THREADS)
gather_dequant_wt_kernel(const uint8_t* __restrict__ codes,     // [NT, K*IG, tn]
                         const __nv_bfloat16* __restrict__ cb,  // [K, S, 8]
                         const float* __restrict__ scales,      // [OUT]
                         OT* __restrict__ out,                  // [IG*8, OUT]
                         int out_features, int kig, int tn, int K, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* s_cb = reinterpret_cast<uint4*>(smem);  // entry k*S + s: 8 bf16
  for (int i = threadIdx.x; i < K * S; i += THREADS)
    s_cb[i] = __ldg(reinterpret_cast<const uint4*>(cb) + i);
  __syncthreads();

  const int o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= out_features) return;
  const int ig_count = kig / K;
  const int ig0 = blockIdx.y * IG_RUN;
  const int ig1 = min(ig_count, ig0 + IG_RUN);
  const int t = o / tn, c = o - t * tn;
  const uint8_t* cp = codes + (size_t)t * kig * tn + c;
  const float sc = scales[o];
#pragma unroll 2
  for (int ig = ig0; ig < ig1; ++ig) {
    const uint8_t* row = cp + (size_t)ig * K * tn;
    float acc[G];
    aqlm::bf16x8_to_float(s_cb[__ldg(row)], acc);
    for (int k = 1; k < K; ++k) {
      float f[G];
      aqlm::bf16x8_to_float(s_cb[k * S + __ldg(row + (size_t)k * tn)], f);
#pragma unroll
      for (int j = 0; j < G; ++j) acc[j] += f[j];
    }
    OT* dst = out + (size_t)ig * G * out_features + o;
#pragma unroll
    for (int j = 0; j < G; ++j) aqlm::store1(dst + (size_t)j * out_features, acc[j] * sc);
  }
}

template <typename OT>
cudaError_t launch_typed(const void* codes, const void* cb, const void* scales, void* out, int nt,
                         int kig, int tn, int K, int S, cudaStream_t stream) {
  const int out_features = nt * tn;
  const dim3 grid((out_features + THREADS - 1) / THREADS, (kig / K + IG_RUN - 1) / IG_RUN);
  const size_t smem = (size_t)K * S * 16;  // at most 32 KB (K <= 8, S <= 256)
  gather_dequant_wt_kernel<OT><<<grid, THREADS, smem, stream>>>(
      (const uint8_t*)codes, (const __nv_bfloat16*)cb, (const float*)scales, (OT*)out,
      out_features, kig, tn, K, S);
  return cudaGetLastError();
}

}  // namespace

// codes [NT, K*IG, tn] uint8 (ig-major rows), cb [K, S, 8] bf16, scales
// [OUT = NT*tn] f32; out [IG*8, OUT], bf16 (out_bf16) or f32. K <= 8, S <= 256.
extern "C" int gather_dequant_wt_launch(const void* codes, const void* cb, const void* scales,
                                        void* out, int out_bf16, int nt, int kig, int tn, int K,
                                        int S, void* stream) {
  if (K < 1 || K > 8 || S < 1 || S > 256 || kig % K || nt < 1 || tn < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return launch_typed<__nv_bfloat16>(codes, cb, scales, out, nt, kig, tn, K, S, st);
  return launch_typed<float>(codes, cb, scales, out, nt, kig, tn, K, S, st);
}
