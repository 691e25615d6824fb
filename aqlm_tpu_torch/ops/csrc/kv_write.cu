// B8: in-place write of one new row per (batch row, kv head) into one layer
// of the stacked head-major KV cache.
//
// Replaces the TPU kernels aqlm_tpu/ops/flash_decode.py: kv_write_inplace
// (_kv_write, pallas_call at :464) and kv_write4_inplace (_kv_write4,
// pallas_call at :524). The layer index is a pointer offset applied by the
// caller.
//
// Each plane is a cache [B, H, S, row] of some element type seen as bytes,
// with its new rows [B, H, row]: row (b, h) of every plane goes to sequence
// position offsets[b]. A row whose offset lies outside [0, S) writes nothing
// (no host read-back of the offsets). One launch takes up to four planes: k,
// v and the two f32 scale planes of the int8 cache.
//
// What bounds it on an H100: the launch. At Llama-2-7B's decode shape (B 4,
// H 32, D 128, int8 + f32 scales) one launch moves 2 x 4 x 32 x 264 bytes,
// 0.00002 ms at 3.35 TB/s; a kernel node of a CUDA graph alone costs far
// more, so what the kernel can do is pay one memory round trip, not several.
//
// Design: a row moves in words of 16 bytes where its length is a multiple
// of 16 (and its planes are 16-byte aligned, which the caller checks), else
// of 4 bytes, else of 1. Thread t of the grid takes word t of every plane
// that has one (the words of a plane laid out (b, h)-major), so whole warps
// work on every plane, the 4-byte scale rows included, and the grid is as
// many 128-thread blocks as the widest plane's words fill (8 at the decode
// shape above; the first design ran a one-warp block per (b, h), 128 of
// them, with 8 of 32 lanes busy on each int8 row). A thread first loads its
// words of every plane and their rows' offsets into registers, then stores:
// the stores wait on one round trip (the first design loaded and stored
// plane by plane, each load behind the previous plane's store, as the
// compiler must assume the planes may alias). A thread's row and word come
// from a multiply and a shift (aqlm::FastDiv), not a division.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int MAX_PLANES = 4;
constexpr int KV_THREADS = 128;

struct Plane {
  char* cache;      // [B, H, S, row_bytes]: one layer
  const char* src;  // [B, H, row_bytes]
  int row_bytes;
  int word;         // bytes a thread moves: 16, 4 or 1
  int words;        // row_bytes / word
  aqlm::FastDiv per_row;  // division by words
};

struct Planes {
  Plane p[MAX_PLANES];
  int n;
};

__global__ void __launch_bounds__(KV_THREADS)
kv_write_kernel(Planes planes, const int* __restrict__ offsets, int BH, aqlm::FastDiv per_b, int S) {
  const uint32_t t = blockIdx.x * KV_THREADS + threadIdx.x;
  uint4 v[MAX_PLANES];
  uint32_t bh[MAX_PLANES], c[MAX_PLANES];
  int off[MAX_PLANES];
  // every load first: this thread's word of each plane and its row's offset
  // (unrolled, so the planes are indexed statically: no local-memory copy)
#pragma unroll
  for (int i = 0; i < MAX_PLANES; ++i) {
    off[i] = -1;
    const Plane pl = planes.p[i];
    if (i >= planes.n || t >= (uint32_t)BH * pl.words) continue;
    bh[i] = aqlm::div_by(t, pl.per_row);
    c[i] = t - bh[i] * pl.words;
    off[i] = __ldg(offsets + aqlm::div_by(bh[i], per_b));
    const char* src = pl.src + (size_t)bh[i] * pl.row_bytes + (size_t)c[i] * pl.word;
    if (pl.word == 16) {
      v[i] = __ldg(reinterpret_cast<const uint4*>(src));
    } else if (pl.word == 4) {
      v[i].x = __ldg(reinterpret_cast<const unsigned int*>(src));
    } else {
      v[i].x = (unsigned char)__ldg(src);
    }
  }
  // then every store
#pragma unroll
  for (int i = 0; i < MAX_PLANES; ++i) {
    if (off[i] < 0 || off[i] >= S) continue;
    const Plane pl = planes.p[i];
    char* dst = pl.cache + ((size_t)bh[i] * S + off[i]) * pl.row_bytes + (size_t)c[i] * pl.word;
    if (pl.word == 16) {
      *reinterpret_cast<uint4*>(dst) = v[i];
    } else if (pl.word == 4) {
      *reinterpret_cast<unsigned int*>(dst) = v[i].x;
    } else {
      *dst = (char)v[i].x;
    }
  }
}

}  // namespace

// caches[i] [B, H, S, row_bytes[i]] (one layer), srcs[i] [B, H, row_bytes[i]],
// n_planes in 1..4; offsets [B] int32.
extern "C" int kv_write_launch(void* const* caches, const void* const* srcs,
                               const int* row_bytes, int n_planes, const void* offsets, int B,
                               int H, int S, void* stream) {
  if (n_planes < 1 || n_planes > MAX_PLANES || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  Planes planes{};
  planes.n = n_planes;
  long long threads = 0;
  for (int i = 0; i < n_planes; ++i) {
    const int rb = row_bytes[i];
    if (rb < 1) return (int)cudaErrorInvalidValue;
    const int word = rb % 16 == 0 ? 16 : rb % 4 == 0 ? 4 : 1;
    planes.p[i] = {(char*)caches[i], (const char*)srcs[i], rb, word, rb / word,
                   aqlm::fast_div((uint32_t)(rb / word))};
    threads = std::max(threads, (long long)B * H * (rb / word));
  }
  if (threads >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((threads + KV_THREADS - 1) / KV_THREADS);
  kv_write_kernel<<<blocks, KV_THREADS, 0, (cudaStream_t)stream>>>(
      planes, (const int*)offsets, B * H, aqlm::fast_div((uint32_t)H), S);
  return (int)cudaGetLastError();
}
