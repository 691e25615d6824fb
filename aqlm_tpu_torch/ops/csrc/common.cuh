// Small helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aqlm {

// Two bf16 packed in a 32-bit word -> two floats (bf16 is the top half of f32).
__device__ __forceinline__ void bf16x2_to_float(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// Eight bf16 (16 bytes) -> eight floats.
__device__ __forceinline__ void bf16x8_to_float(const uint4& v, float* f) {
  bf16x2_to_float(v.x, f[0], f[1]);
  bf16x2_to_float(v.y, f[2], f[3]);
  bf16x2_to_float(v.z, f[4], f[5]);
  bf16x2_to_float(v.w, f[6], f[7]);
}

// Eight consecutive activations (one input group) as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(p)), f);
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// n / d for 0 <= n < 2^31 and d >= 1 by a multiply and a shift: with
// l = ceil(log2 d) and m = floor(2^32 (2^l - d) / d) + 1, n / d = (mulhi(n, m) + n) >> l.
struct FastDiv {
  uint32_t m;
  uint32_t l;
};

inline FastDiv fast_div(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  const uint64_t m = ((1ull << 32) * ((1ull << l) - d)) / d + 1;
  return {(uint32_t)m, l};
}

__device__ __forceinline__ uint32_t div_by(uint32_t n, FastDiv f) {
  return (__umulhi(n, f.m) + n) >> f.l;
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// cp.async: 16 bytes global -> shared through L2 (with a source-size
// operand, 0 when !valid, the 16 destination bytes are zero-filled), 4 bytes
// through L1, and the group commit and wait.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem_src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem_src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace aqlm
