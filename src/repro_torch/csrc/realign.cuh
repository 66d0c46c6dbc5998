// 16- and 8-byte realignment shared by the byte-streaming kernels
// (framing.cu, dp_reduce.cu).
//
// A kernel that reads a byte run starting at any address loads the two
// aligned 16-byte (8-byte) words that hold it and shifts them into place,
// so every global load is a whole aligned uint4 (uint2) and every loaded
// word holds at least one byte of the run (no word reaches past the
// aligned words the run itself touches).  Neighbouring threads read
// neighbouring runs, so the second word of one thread is the first of the
// next: one pass over device memory, the repeat served from L1 / L2.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Bytes [delta, delta + 16) of the 32 bytes lo:hi (little-endian, lo
// first), 0 <= delta < 16.  delta is uniform across a warp wherever the
// kernels call this, so the selects cost no divergence.
__device__ __forceinline__ uint4 realign16(uint4 lo, uint4 hi,
                                           unsigned delta) {
  const bool two = delta & 8, one = delta & 4;
  // the five words from word (delta >> 2) on
  unsigned w0 = two ? lo.z : lo.x, w1 = two ? lo.w : lo.y;
  unsigned w2 = two ? hi.x : lo.z, w3 = two ? hi.y : lo.w;
  unsigned w4 = two ? hi.z : hi.x;
  const unsigned w5 = two ? hi.w : hi.y;
  if (one) {
    w0 = w1;
    w1 = w2;
    w2 = w3;
    w3 = w4;
    w4 = w5;
  }
  const unsigned sh = (delta & 3) * 8;   // funnel shift by 0 returns w_j
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// Bytes [delta, delta + 8) of the 16 bytes lo:hi, 0 <= delta < 8.
__device__ __forceinline__ uint2 realign8(uint2 lo, uint2 hi,
                                          unsigned delta) {
  const bool one = delta & 4;
  const unsigned w0 = one ? lo.y : lo.x, w1 = one ? hi.x : lo.y;
  const unsigned w2 = one ? hi.y : hi.x;
  const unsigned sh = (delta & 3) * 8;
  return make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
}

// The 16 bytes at p (any alignment) by aligned loads: one where p is
// 16-byte aligned, else the two words that hold them.
__device__ __forceinline__ uint4 load16(const unsigned char* p) {
  const unsigned delta = (unsigned)((uintptr_t)p & 15);
  const uint4* w = reinterpret_cast<const uint4*>(p - delta);
  if (!delta) return w[0];
  return realign16(w[0], w[1], delta);
}
