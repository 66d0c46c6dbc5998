// Min-max quantization codes without a division where that is provably
// exact, shared by the quantizers (pack4.cu, quantize.cu).
//
// The code of x under (mn, scale) is clamp(rint(fl(d / scale)), 0, levels)
// with d = fl(x - mn): IEEE division, round half to even, as the plain
// PyTorch versions and the JAX package compute it.  With rs =
// __frcp_rn(scale) a normal float, t = fl(d * rs) is within about
// 3 * 2**-24 * |d / scale| of fl(d / scale): below 3e-6 while t <= levels +
// 1 (levels <= 255 keeps it below 4.6e-5).  So where t also lies farther
// than 2**-13 from every half-integer, fl(d / scale) rounds to the same
// integer as t, and rint(t) is t + 1.5 * 2**23 - 1.5 * 2**23 (exact below
// 2**22; below -2**22 the result is negative, clamped to 0 on both
// sides).  Every other element -- near a tie, NaN, +-inf, t above levels +
// 1, or a scale whose reciprocal is not a normal float (rs is then NaN, so
// t is NaN) -- is flagged, and a group of elements holding a flagged one
// takes rintf(__fdiv_rn(d, scale)) for all of them.  The fast path has no
// branch, so a thread's elements interleave; the division runs for few
// groups (about 2**-12 of randn elements lie near a tie).  The clamp is
// fminf(fmaxf(q, 0), levels): a NaN quotient gives code 0, as the plain
// version's uint8 cast of NaN does.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

// __frcp_rn(scale) where that is a normal float, else NaN (every element
// then takes the division).
__device__ __forceinline__ float qcode_rcp(float scale) {
  const float rcp = __frcp_rn(scale);
  return rcp >= FLT_MIN && rcp <= FLT_MAX ? rcp : NAN;
}

__device__ __forceinline__ float qcode_max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// q[e] = clamp(rint(fl(fl(x[e] - mn) / scale)), 0, levels), an integer
// in a float (-0.0 for a negative zero), for V elements; rs =
// qcode_rcp(scale).  The fast path's two checks are kept as running
// maxima that carry NaN, and where any of the V elements is flagged all
// V take the division (the same integers: the division is the rule).
template <int V>
__device__ __forceinline__ void qcodes(const float* x, float mn, float scale,
                                       float rs, float levels, float* q) {
  constexpr float kMagic = 12582912.0f;          // 1.5 * 2**23
  constexpr float kTie = 0.5f - 1.0f / 8192.0f;  // 0.5 - 2**-13
  float off = 0.0f, tmax = -INFINITY;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float t = __fmul_rn(__fsub_rn(x[e], mn), rs);
    q[e] = __fsub_rn(__fadd_rn(t, kMagic), kMagic);
    off = qcode_max_nan(off, fabsf(__fsub_rn(t, q[e])));
    tmax = qcode_max_nan(tmax, t);
  }
  if (!(off < kTie && tmax <= levels + 1.0f)) {
#pragma unroll
    for (int e = 0; e < V; ++e)
      q[e] = rintf(__fdiv_rn(__fsub_rn(x[e], mn), scale));
  }
#pragma unroll
  for (int e = 0; e < V; ++e) q[e] = fminf(fmaxf(q[e], 0.0f), levels);
}

// The byte q0 | q1 << 4 of two 4-bit codes held as floats, in the low
// byte of the result (exact: q1 * 16 + q0 < 2**8, then 2**23 + it).
__device__ __forceinline__ uint32_t qcode_pair(float q0, float q1) {
  return __float_as_uint(__fadd_rn(__fmaf_rn(q1, 16.0f, q0), 8388608.0f));
}

// An 8-bit code held as a float, in the low byte of the result (exact:
// 2**23 + q, q < 2**8; a -0.0 code gives 0).
__device__ __forceinline__ uint32_t qcode_byte(float q) {
  return __float_as_uint(__fadd_rn(q, 8388608.0f));
}

// Four 8-bit codes as one word, q[0] in the low byte, gathered by byte
// permutes.
__device__ __forceinline__ uint32_t qcode_word(const float* q) {
  return __byte_perm(__byte_perm(qcode_byte(q[0]), qcode_byte(q[1]), 0x0040),
                     __byte_perm(qcode_byte(q[2]), qcode_byte(q[3]), 0x0040),
                     0x5410);
}
