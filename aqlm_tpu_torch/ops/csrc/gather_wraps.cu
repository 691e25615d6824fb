// B16: the lane-gather wrap probe.
//
// Replaces the TPU kernel aqlm_tpu/ops/kernels.py: gather_wraps
// (_wrap_probe_kernel, pallas_call at :75), a probe of whether Mosaic's lane
// gather (take_along_axis over the 128 lanes of an (8, 128) f32 tile) takes
// an index outside [0, 128) modulo 128. The JAX package drops a `& 127` lane
// mask in its LUT-GEMV and gather-prefill kernels where the probe says so.
// The port's codes kernels index shared memory by the byte code itself and
// never consult the probe; it is kept so that the port answers the same
// question on its own hardware.
//
// The probe's gather, run the way a warp gathers across lanes: each warp
// holds one 128-wide row of the table, four consecutive entries a lane, and
// fetches entry idx from lane idx / 4 with __shfl_sync, whose source lane is
// taken modulo the width (32) when it lies outside, as CUDA documents; the
// entry within the lane is idx % 4. Indices 128..255 therefore read
// tab[idx % 128] if and only if the shuffle wraps. Bound: launch latency
// (8 KB in, 4 KB out).
#include "common.cuh"

namespace {

__global__ void gather_wraps_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                                    float* __restrict__ out) {
  const int row = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float4 t = reinterpret_cast<const float4*>(tab + row * 128)[lane];
  const int4 ix = reinterpret_cast<const int4*>(idx + row * 128)[lane];
  const int id[4] = {ix.x, ix.y, ix.z, ix.w};
  float res[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int src = id[j] >> 2;  // past lane 31 for idx >= 128: wrapped by the shuffle
    const float v0 = __shfl_sync(0xffffffffu, t.x, src);
    const float v1 = __shfl_sync(0xffffffffu, t.y, src);
    const float v2 = __shfl_sync(0xffffffffu, t.z, src);
    const float v3 = __shfl_sync(0xffffffffu, t.w, src);
    const int e = id[j] & 3;
    res[j] = e == 0 ? v0 : e == 1 ? v1 : e == 2 ? v2 : v3;
  }
  reinterpret_cast<float4*>(out + row * 128)[lane] = make_float4(res[0], res[1], res[2], res[3]);
}

}  // namespace

// tab and out [rows, 128] f32, idx [rows, 128] int32; one warp a row.
extern "C" int gather_wraps_launch(const void* tab, const void* idx, void* out, int rows,
                                   void* stream) {
  if (rows < 1 || rows > 32) return cudaErrorInvalidValue;
  gather_wraps_kernel<<<1, rows * 32, 0, (cudaStream_t)stream>>>(
      (const float*)tab, (const int*)idx, (float*)out);
  return cudaGetLastError();
}
