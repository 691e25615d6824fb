// Hopper helpers shared by the port's warp-specialised kernels (K2 in
// gather_prefill.cu, B10's and the forward's GEMMs in int8_matmul.cu, the
// int4 GEMM in int4_matmul.cu): shared-memory addresses, mbarriers, named
// barriers, TMA tile and bulk copies, wgmma descriptors and instructions, exact
// int8 -> bf16 widening, the split path's fixed-order reduction, and the
// tensor-map encoder reached through the runtime (no libcuda link).
#pragma once

#include <cuda.h>  // CUtensorMap
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aqlm {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// The barrier's next arrival comes when every cp.async this thread issued so far has landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Waits for the phase of the given parity to complete. A pipeline fault
// that would leave a barrier short of arrivals traps after ~2^34 cycles
// (seconds), so it fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}
// Shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma operand descriptors, K-major. W^T, no swizzle: 8 x 16-byte core
// matrices of 128 contiguous bytes, the next along K 128 bytes on (LBO),
// the next 8 rows 1024 bytes on (SBO, a 64-wide slab holds eight along K).
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32);
}
// The activations, as TMA writes them with the 128-byte swizzle: one
// 128-byte row (64 inputs) a token, 8-row atoms of 1024 bytes (SBO); a k16
// step starts 32 bytes further into the atom.
__device__ __forceinline__ uint64_t make_desc_sw128(const void* p) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// One box of a 3-D tensor map (inner coordinate first) into shared memory,
// completing on `bar` by its byte count; rows past the tensor read as zero.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, completing on `bar` by its byte count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of the accumulators across a wait.
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], bf16 in, f32 accumulators.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The same product with D's old value kept (acc != 0) or dropped (acc == 0:
// D = A * B, so an accumulator needs no zeroing before its first product).
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                                 int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

// Named barrier `id` (1-15; 0 is __syncthreads): `count` threads, a
// multiple of 32, meet.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Exact int8 -> bf16 of four packed bytes, two bf16x2 words (bytes 0-1 and
// 2-3): with m = w & 0x7f, bf16 0x43mm is 128 + m, and 0x4300 / 0x4380 are
// 128 / 256 as the sign bit is clear / set, so their difference is the
// signed byte (every integer in [-128, 127] is a bf16).
__device__ __forceinline__ void s8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t m = w & 0x7f7f7f7fu, s = w & 0x80808080u;
  uint32_t a0 = __byte_perm(m, 0x43434343u, 0x4140), a1 = __byte_perm(m, 0x43434343u, 0x4342);
  uint32_t c0 = __byte_perm(s, 0x43434343u, 0x4140), c1 = __byte_perm(s, 0x43434343u, 0x4342);
  const __nv_bfloat162 v0 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a0),
                                    *reinterpret_cast<__nv_bfloat162*>(&c0));
  const __nv_bfloat162 v1 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a1),
                                    *reinterpret_cast<__nv_bfloat162*>(&c1));
  lo = *reinterpret_cast<const uint32_t*>(&v0);
  hi = *reinterpret_cast<const uint32_t*>(&v1);
}

// The split path's last block of an output tile: out[row, col] = bf16(
// scale[col] * sum_z partials[z][row][col]) (scale null: 1) over the
// ROWS x COLS tile at (row0, col0), the splits added in order z = 0, 1, ...,
// so the result does not depend on block timing. Four columns a load where
// OUT % 4 == 0, else one; each thread keeps four loads in flight a split.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void reduce_splits(const float* __restrict__ p0, size_t z_stride,
                                              int splits, const float* __restrict__ scale,
                                              __nv_bfloat16* __restrict__ out, int row0, int col0,
                                              int T, int out_features, int tid) {
  constexpr int PER = 4;
  const bool quad = (out_features & 3) == 0;
  const int width = quad ? 4 : 1, per_row = COLS / width, n_items = ROWS * per_row;
  for (int i0 = tid; i0 < n_items; i0 += THREADS * PER) {
    float4 v[PER];
    size_t off[PER];
    bool ok[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = i0 + k * THREADS, row = row0 + i / per_row, col = col0 + (i % per_row) * width;
      ok[k] = i < n_items && row < T && col < out_features;  // quad: four columns all in or out
      off[k] = ok[k] ? (size_t)row * out_features + col : 0;
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int z = 0; z < splits; ++z) {
      const float* pz = p0 + (size_t)z * z_stride;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        if (!ok[k]) continue;
        if (quad) {
          const float4 a = __ldcg(reinterpret_cast<const float4*>(pz + off[k]));
          v[k].x += a.x;
          v[k].y += a.y;
          v[k].z += a.z;
          v[k].w += a.w;
        } else {
          v[k].x += __ldcg(pz + off[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (!ok[k]) continue;
      const int col = (int)(off[k] % out_features);
      if (quad) {
        float4 s = make_float4(1.f, 1.f, 1.f, 1.f);
        if (scale) s = __ldg(reinterpret_cast<const float4*>(scale + col));
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[k].x * s.x, v[k].y * s.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[k].z * s.z, v[k].w * s.w);
        *reinterpret_cast<uint2*>(out + off[k]) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
      } else {
        out[off[k]] = __float2bfloat16(v[k].x * (scale ? __ldg(scale + col) : 1.f));
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One box of a 2-D tensor map (inner coordinate first) into shared memory,
// completing on `bar` by its byte count; elements past the tensor read as zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime (null if missing).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace aqlm
