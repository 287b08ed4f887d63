// Reading int16 samples that start at any 2-byte offset as aligned words.
//
// The planes' rows start anywhere and their pitches are not multiples of 16
// bytes, so a run of samples is read as the one or two aligned 8-byte words
// that cover it, through the read-only path, and moved into place with a
// word select and __funnelshift_r. An aligned word that holds one byte of a
// tensor lies inside the tensor's allocation (allocations start and end on
// multiples of 16 bytes or more), so no such read leaves it. Shared by
// tile_gather.cu, mc_gather.cu and sad_sweep.cu.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// A pointer rounded down to 16 bytes, and the int16 elements it lost.
struct AlignedPlanes {
  const char* p;
  int e0;
};

__device__ __forceinline__ AlignedPlanes align_planes(const int16_t* planes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(planes);
  AlignedPlanes r;
  r.p = reinterpret_cast<const char*>(a & ~static_cast<uintptr_t>(15));
  r.e0 = static_cast<int>(a & 15) >> 1;
  return r;
}

__device__ __forceinline__ int32_t lo16(uint32_t w) {
  return static_cast<int32_t>(static_cast<int16_t>(w & 0xffffu));
}

__device__ __forceinline__ int32_t hi16(uint32_t w) {
  return static_cast<int32_t>(w) >> 16;
}

// Four consecutive int16s from element e of the aligned base, still packed
// two to a word. Only the first `cnt` (1..4) are needed: the second aligned
// word is read only when one of those lies in it, so a run that ends with
// the tensor never touches the word after it.
__device__ __forceinline__ uint2 load4_i16_packed(const char* ab, long long e,
                                                  int cnt = 4) {
  const uint2* p = reinterpret_cast<const uint2*>(ab) + (e >> 2);
  const unsigned b = static_cast<unsigned>(e) & 3u;
  const uint2 lo = __ldg(p);
  uint2 hi = make_uint2(0u, 0u);
  if (b + cnt > 4u) hi = __ldg(p + 1);
  uint32_t w0 = lo.x, w1 = lo.y, w2 = hi.x;
  if (b & 2u) { w0 = lo.y; w1 = hi.x; w2 = hi.y; }
  const unsigned sh = (b & 1u) << 4;
  return make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
}
