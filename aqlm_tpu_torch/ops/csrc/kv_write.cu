// B8: in-place write of one new row per (batch row, kv head) into one layer
// of the stacked head-major KV cache.
//
// Replaces the TPU kernels aqlm_tpu/ops/flash_decode.py: kv_write_inplace
// (_kv_write, pallas_call at :464) and kv_write4_inplace (_kv_write4,
// pallas_call at :524). The layer index is a pointer offset applied by the
// caller.
//
// Each plane is a cache [B, H, S, row] of some element type seen as bytes,
// with its new rows [B, H, row]: block (h, b) copies row (b, h) of every
// plane to sequence position offsets[b]. A row whose offset lies outside
// [0, S) writes nothing (no host read-back of the offsets). One launch takes
// up to four planes: k, v and the two f32 scale planes of the int8 cache.
//
// What bounds it on an H100: the bytes of the new rows, read once and
// written once, and the launch itself: at Llama-2-7B's decode shape (B 4,
// H 32, D 128, int8 + f32 scales) one launch moves 2 x 4 x 32 x 136 bytes.
//
// Design: one 32-thread block per (b, h); a row whose length is a multiple
// of 16 bytes (and whose planes are 16-byte aligned, which the caller
// checks) moves in 16-byte loads and stores, one per lane; other rows (the
// 4-byte scale rows) move in 4-byte or single-byte words.
#include "common.cuh"

namespace {

constexpr int MAX_PLANES = 4;

struct Plane {
  char* cache;      // [B, H, S, row_bytes]: one layer
  const char* src;  // [B, H, row_bytes]
  int row_bytes;
};

struct Planes {
  Plane p[MAX_PLANES];
  int n;
};

__global__ void __launch_bounds__(32)
kv_write_kernel(Planes planes, const int* __restrict__ offsets, int H, int S) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int bh = b * H + h;
  const int offset = offsets[b];
  if (offset < 0 || offset >= S) return;
  // unrolled, so the planes are indexed statically (no local-memory copy)
#pragma unroll
  for (int i = 0; i < MAX_PLANES; ++i) {
    if (i >= planes.n) break;
    const Plane pl = planes.p[i];
    const int rb = pl.row_bytes;
    char* dst = pl.cache + ((size_t)bh * S + offset) * rb;
    const char* src = pl.src + (size_t)bh * rb;
    if (rb % 16 == 0) {
      for (int c = threadIdx.x; c < rb / 16; c += 32)
        reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(src)[c];
    } else if (rb % 4 == 0) {
      for (int c = threadIdx.x; c < rb / 4; c += 32)
        reinterpret_cast<uint32_t*>(dst)[c] = reinterpret_cast<const uint32_t*>(src)[c];
    } else {
      for (int c = threadIdx.x; c < rb; c += 32) dst[c] = src[c];
    }
  }
}

}  // namespace

// caches[i] [B, H, S, row_bytes[i]] (one layer), srcs[i] [B, H, row_bytes[i]],
// n_planes in 1..4; offsets [B] int32.
extern "C" int kv_write_launch(void* const* caches, const void* const* srcs,
                               const int* row_bytes, int n_planes, const void* offsets, int B,
                               int H, int S, void* stream) {
  if (n_planes < 1 || n_planes > MAX_PLANES) return (int)cudaErrorInvalidValue;
  Planes planes{};
  planes.n = n_planes;
  for (int i = 0; i < n_planes; ++i)
    planes.p[i] = {(char*)caches[i], (const char*)srcs[i], row_bytes[i]};
  kv_write_kernel<<<dim3(H, B), 32, 0, (cudaStream_t)stream>>>(planes, (const int*)offsets, H, S);
  return (int)cudaGetLastError();
}
