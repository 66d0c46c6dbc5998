// q4 wire pack / unpack for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/pack4.py::pack4_wire
// (_pack4_kernel) and ::unpack4_wire (_unpack4_kernel).
//
// pack : x (M, N) f32, per-row min/scale -> (M, ceil(N/2)) u8, byte j of
//        a row = code[2j] | code[2j+1] << 4, code = clip(rint((x-min)/scale),
//        0, 15); odd N gets a zero pad code written here, so no padded copy
//        of x ever exists.
// unpack: the inverse, codes*scale+min in f32, pad column dropped.
// Row r's (min, scale) is (mn[r * mn_stride], sc[r * sc_stride]): stride 1
// for per-row statistics, 0 for one pair over the tensor (the codec's
// expanded pair, read in place).
//
// Bound on the card: memory.  Both move ~4.5 bytes per element (f32 one
// way, half a byte the other) for a handful of flops, far below the
// H100's ~300 flops/byte ridge.
//
// Design (kernels/pack4.py::geometry sizes the launch):
// - Rows without division: block b works chunk b % chunks of row b /
//   chunks (one 32-bit division a block), reads the row's (min, scale)
//   once, and works R units a thread, blockDim apart, so neighbouring
//   lanes take neighbouring units.  A unit is 8 elements and 4 packed
//   bytes.  The grid follows the work: R and blockDim shrink until a small
//   tensor fills the SMs twice over, or a short row is one block.
// - Alignment: a row's units start where its 4-byte packed words (pack) or
//   16-byte f32 words (unpack) start; the at most 3 bytes (pack) or 3
//   elements (unpack) before them and the row's short end (and odd pad)
//   are done one by one by the row's first block.  The other side then
//   sits at an offset that is the same for the whole row: pack reads the
//   2 (offset 0) or 3 aligned float4s that hold a unit's 8 elements and
//   takes them at that offset (a compile-time select, one instantiation an
//   offset); unpack reads the 1 or 2 aligned u32s that hold the unit's 8
//   codes and funnel-shifts them into place.  A unit at a row's end whose
//   words reach past the tensor is read element by element, its in-tensor
//   elements only: no load leaves the tensor.
// - Wide, neighbouring accesses: every thread's loads for its R units are
//   issued before any arithmetic.  pack stores one u32 a unit (a warp
//   writes 128 contiguous bytes an instruction).  unpack passes each
//   unit's 8 codes through two warp shuffles so that each float4 store of
//   the warp covers 512 contiguous bytes (a lane's own 32 contiguous bytes
//   would leave each instruction strided).  The f32 side, read or written
//   once, goes through the streaming cache hints (ld.global.cs /
//   st.global.cs), which measured faster than plain accesses on the large
//   leaves (PERF.md, the q4 pair's findings).
// - Codes by qcode.cuh: a reciprocal product where provably the same as
//   the division, IEEE division for the units holding a flagged element;
//   a unit's 4 bytes gathered from the codes by byte permutes.
//
// Bit-exactness with the plain PyTorch version (and the JAX package):
// IEEE division where the product cannot be proven equal, rintf (round
// half to even, like jnp.round / torch.round), and the dequant written as
// __fmul_rn then __fadd_rn so nvcc cannot contract it into an FMA.  Never
// build with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qcode.cuh"

namespace {

constexpr float kLevels = 15.0f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;

// The aligned float4 at p, read element by element (its elements in
// [lo, hi) only, the rest 0) where it reaches outside [lo, hi).
__device__ __forceinline__ float4 load4_in(const float* p, const float* lo,
                                           const float* hi) {
  if (p >= lo && p + 4 <= hi) return *reinterpret_cast<const float4*>(p);
  float e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = p + k >= lo && p + k < hi ? p[k] : 0.0f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

// The aligned u32 at p, read byte by byte where it reaches outside
// [lo, hi).
__device__ __forceinline__ uint32_t load_u32_in(const uint32_t* p,
                                                const uint8_t* lo,
                                                const uint8_t* hi) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(p);
  if (b >= lo && b + 4 <= hi) return *p;
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (b + k >= lo && b + k < hi) w |= (uint32_t)b[k] << (8 * k);
  return w;
}

// code -> code * scale + min, the code's float taken exactly (2^23 + c
// less 2^23) and no FMA.
__device__ __forceinline__ float dequant(uint32_t c, float mn, float sc) {
  const float q = __fsub_rn(__uint_as_float(0x4B000000u | c), 8388608.0f);
  return __fadd_rn(__fmul_rn(q, sc), mn);
}

// The 4 codes of a 16-bit half (code k in bits 4k..4k+3), dequantized.
__device__ __forceinline__ float4 dequant4(uint32_t half, float mn,
                                           float sc) {
  return make_float4(dequant(half & 15u, mn, sc),
                     dequant(half >> 4 & 15u, mn, sc),
                     dequant(half >> 8 & 15u, mn, sc),
                     dequant(half >> 12 & 15u, mn, sc));
}

// pack's units of one row: unit u is output bytes [head + 4u, + 4) (an
// aligned u32) and elements [2 (head + 4u), + 8), which start D elements
// into an aligned float4.
template <int R, int D>
__device__ __forceinline__ void pack_units(
    const float* __restrict__ xr, uint8_t* __restrict__ orow, int head,
    int units, int first, int stride, float mn, float sc, float rs,
    const float* lo, const float* hi) {
  constexpr int W = D ? 3 : 2;   // aligned float4s holding a unit
  float4 v[R][W];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int u = first + j * stride;
    if (u < units) {
      const float* p = xr + 2 * (head + 4 * u) - D;
      const bool edge = u == 0 || u == units - 1;
#pragma unroll
      for (int w = 0; w < W; ++w)
        v[j][w] = edge ? load4_in(p + 4 * w, lo, hi)
                       : __ldcs(reinterpret_cast<const float4*>(p + 4 * w));
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int u = first + j * stride;
    if (u < units) {
      float e[4 * W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        e[4 * w] = v[j][w].x;
        e[4 * w + 1] = v[j][w].y;
        e[4 * w + 2] = v[j][w].z;
        e[4 * w + 3] = v[j][w].w;
      }
      float q[8];
      qcodes<8>(e + D, mn, sc, rs, kLevels, q);
      // the 4 bytes' low bytes, gathered by byte permutes
      const uint32_t lo2 = __byte_perm(qcode_pair(q[0], q[1]),
                                       qcode_pair(q[2], q[3]), 0x0040);
      const uint32_t hi2 = __byte_perm(qcode_pair(q[4], q[5]),
                                       qcode_pair(q[6], q[7]), 0x0040);
      *reinterpret_cast<uint32_t*>(orow + head + 4 * u) =
          __byte_perm(lo2, hi2, 0x5410);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
pack4_kernel(const float* __restrict__ x, const float* __restrict__ mn,
             const float* __restrict__ sc, uint8_t* __restrict__ out,
             int n, int h, long long mn_stride, long long sc_stride,
             int chunks, const float* x_end) {
  const int row = blockIdx.x / chunks;
  const int chunk = blockIdx.x - row * chunks;
  const float m = mn[row * mn_stride], s = sc[row * sc_stride];
  const float rs = qcode_rcp(s);
  const float* xr = x + (long long)row * n;
  uint8_t* orow = out + (long long)row * h;
  // bytes before the row's first aligned u32; whole units of pairs after
  const int head = min((int)((4 - ((uintptr_t)orow & 3)) & 3), h);
  const int pairs = n >> 1;
  const int units = pairs > head ? (pairs - head) >> 2 : 0;
  const int d = (int)((((uintptr_t)xr >> 2) + 2 * head) & 3);
  const int first = chunk * R * blockDim.x + threadIdx.x;
  switch (d) {
    case 0:
      pack_units<R, 0>(xr, orow, head, units, first, blockDim.x, m, s, rs, x,
                       x_end);
      break;
    case 1:
      pack_units<R, 1>(xr, orow, head, units, first, blockDim.x, m, s, rs, x,
                       x_end);
      break;
    case 2:
      pack_units<R, 2>(xr, orow, head, units, first, blockDim.x, m, s, rs, x,
                       x_end);
      break;
    default:
      pack_units<R, 3>(xr, orow, head, units, first, blockDim.x, m, s, rs, x,
                       x_end);
  }
  if (chunk == 0) {   // the head bytes, then the short end and the pad
    const int ones = h - 4 * units;
    for (int t = threadIdx.x; t < ones; t += blockDim.x) {
      const int j = t < head ? t : t + 4 * units;
      const bool pad = 2 * j + 1 >= n;
      float v[2] = {xr[2 * j], pad ? 0.0f : xr[2 * j + 1]}, q[2];
      qcodes<2>(v, m, s, rs, kLevels, q);
      orow[j] = (uint8_t)qcode_pair(q[0], pad ? 0.0f : q[1]);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
unpack4_kernel(const uint8_t* __restrict__ packed,
               const float* __restrict__ mn, const float* __restrict__ sc,
               float* __restrict__ out, int n, int h, long long mn_stride,
               long long sc_stride, int chunks, const uint8_t* p_end) {
  const int row = blockIdx.x / chunks;
  const int chunk = blockIdx.x - row * chunks;
  const float m = mn[row * mn_stride], s = sc[row * sc_stride];
  const uint8_t* pr = packed + (long long)row * h;
  float* yr = out + (long long)row * n;
  // elements before the row's first aligned float4; whole units after
  const int head = min((int)((4 - (((uintptr_t)yr >> 2) & 3)) & 3), n);
  const int units = (n - head) >> 3;
  // unit u's 8 codes are nibbles [g + 8u, + 8) counted from address 0:
  // bits [shift, shift + 32) of the aligned u32 pair at wbase + u
  const uintptr_t g = 2 * (uintptr_t)pr + head;
  const unsigned shift = 4 * (unsigned)(g & 7);
  const uint32_t* wbase =
      reinterpret_cast<const uint32_t*>((g >> 1) & ~(uintptr_t)3);
  const int first = chunk * R * blockDim.x + threadIdx.x;
  uint32_t w0[R], w1[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int u = first + j * blockDim.x;
    w0[j] = w1[j] = 0;
    if (u < units) {
      const uint32_t* p = wbase + u;
      const bool edge = u == 0 || u == units - 1;
      w0[j] = edge ? load_u32_in(p, packed, p_end) : p[0];
      if (shift) w1[j] = edge ? load_u32_in(p + 1, packed, p_end) : p[1];
    }
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint32_t codes = __funnelshift_r(w0[j], w1[j], shift);
    // the warp's 32 units are 256 consecutive outputs: store k writes
    // float4 slot 32k + lane, the (slot & 1) half of unit slot >> 1
    const int u0 = first + j * blockDim.x - lane;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int slot = 32 * k + lane;
      const uint32_t word = __shfl_sync(kFull, codes, slot >> 1);
      const int u = u0 + (slot >> 1);
      if (u < units)
        __stcs(reinterpret_cast<float4*>(yr + head + 8 * u + 4 * (slot & 1)),
               dequant4(word >> (16 * (slot & 1)), m, s));
    }
  }
  if (chunk == 0) {   // the head elements, then the short end
    const int ones = n - 8 * units;
    for (int t = threadIdx.x; t < ones; t += blockDim.x) {
      const int e = t < head ? t : t + 8 * units;
      yr[e] = dequant(pr[e >> 1] >> (4 * (e & 1)) & 15u, m, s);
    }
  }
}

}  // namespace

extern "C" {

// Every entry point returns cudaGetLastError() right after its launch.
// units_per_thread (1, 2 or 4), threads and chunks (blocks a row) come
// from kernels/pack4.py::geometry.
int pack4_wire_launch(const void* x, const void* mn, const void* sc,
                      void* out, long long m, long long n,
                      long long mn_stride, long long sc_stride,
                      int units_per_thread, int threads, int chunks,
                      void* stream) {
  if (m == 0 || n == 0) return 0;
  const long long h = (n + 1) / 2;
  const dim3 grid((unsigned)(m * chunks));
  const float* xf = (const float*)x;
  const float* x_end = xf + m * n;
  cudaStream_t st = (cudaStream_t)stream;
#define PACK4_ARGS                                                          \
  xf, (const float*)mn, (const float*)sc, (uint8_t*)out, (int)n, (int)h, \
      mn_stride, sc_stride, chunks, x_end
  switch (units_per_thread) {
    case 1: pack4_kernel<1><<<grid, threads, 0, st>>>(PACK4_ARGS); break;
    case 2: pack4_kernel<2><<<grid, threads, 0, st>>>(PACK4_ARGS); break;
    case 4: pack4_kernel<4><<<grid, threads, 0, st>>>(PACK4_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PACK4_ARGS
  return (int)cudaGetLastError();
}

int unpack4_wire_launch(const void* packed, const void* mn, const void* sc,
                        void* out, long long m, long long n,
                        long long mn_stride, long long sc_stride,
                        int units_per_thread, int threads, int chunks,
                        void* stream) {
  if (m == 0 || n == 0) return 0;
  const long long h = (n + 1) / 2;
  const dim3 grid((unsigned)(m * chunks));
  const uint8_t* p = (const uint8_t*)packed;
  cudaStream_t st = (cudaStream_t)stream;
#define UNPACK4_ARGS                                                     \
  p, (const float*)mn, (const float*)sc, (float*)out, (int)n, (int)h, \
      mn_stride, sc_stride, chunks, p + m * h
  switch (units_per_thread) {
    case 1: unpack4_kernel<1><<<grid, threads, 0, st>>>(UNPACK4_ARGS); break;
    case 2: unpack4_kernel<2><<<grid, threads, 0, st>>>(UNPACK4_ARGS); break;
    case 4: unpack4_kernel<4><<<grid, threads, 0, st>>>(UNPACK4_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef UNPACK4_ARGS
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
