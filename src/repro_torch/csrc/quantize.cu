// Per-tile min-max k-bit quantize -> dequantize, and the q8 wire quantizer,
// for Hopper (sm_90a).
//
// quant_dequant_kernel replaces the Pallas TPU kernel
// src/repro/kernels/quantize.py::quant_dequant (_qdq_kernel): the C(x) of a
// quantizing stage cut in training, run on the forward activation and on
// the backward activation-gradient, both (B, S*d).
//
// quantize_wire_kernel replaces ::quantize_wire (_quantize_kernel): the
// sender side of the per-tile q8 wire format of the real pipeline.  Same
// tile walk and the same arithmetic up to the code, which it writes as
// uint8, and each tile's (min, scale) pair goes to meta[i, 2j], meta[i,
// 2j+1] of the (gm, 2*gn) f32 meta array.  The input may be bf16 (the
// reference casts to f32 first; bf16 values are exact in f32).  Bound:
// bytes, elem + 1 per element (at (8, 98304) bf16, 2.36 MB, 0.000704 ms
// at 3.35 TB/s); the same 48-of-132-SM occupancy note applies.
//
// One block per (bm, bn) tile, grid (n/bn, m/bm).  Pass 1 reduces the
// tile's min and max in f32 across the block (its bm rows at row stride
// n); pass 2 quantizes, dequantizes and writes each element once, in the
// input type (bf16 rounds to nearest even):
//   scale = span > 0 ? span / levels : 1
//   code  = clamp(rint((x - min) / scale), 0, levels)
//   out   = code * scale + min
// Division is IEEE (__fdiv_rn), rint rounds half to even like jnp.round /
// torch.round, and the dequant is __fmul_rn then __fadd_rn so that nvcc
// cannot contract it into an FMA: the result is bit-identical to the plain
// PyTorch version and to the JAX package's eager reference.  Never build
// with --use_fast_math.  The whole-tensor fallback tile (n not a multiple
// of 128) is this kernel on one tile: one block, slow but right, and off
// the training path (S*768 is a multiple of 256).
//
// Bound on the card: bytes.  The function reads x once and writes C(x)
// once, 2*m*n*elem bytes: at (8, 98304) bf16 that is 3.1 MB, 0.000939 ms
// at 3.35 TB/s; its few f32 operations per element are far below the
// ridge.  The kernel reads its tile twice (the second time mostly from
// L1/L2).  Left for later: at the training shape the 48 tiles fill 48 of
// 132 SMs; splitting a tile over a cluster, or several blocks per tile
// with a second reduction pass, would fill the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Min and max over the block; every thread gets both.  ws: 2 * kWarps.
__device__ void block_minmax(float* lo, float* hi, float* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float a = *lo, b = *hi;
  for (int o = 16; o > 0; o >>= 1) {
    a = fminf(a, __shfl_xor_sync(kFull, a, o));
    b = fmaxf(b, __shfl_xor_sync(kFull, b, o));
  }
  if (lane == 0) {
    ws[warp] = a;
    ws[kWarps + warp] = b;
  }
  __syncthreads();
  a = ws[0];
  b = ws[kWarps];
  for (int w = 1; w < kWarps; ++w) {
    a = fminf(a, ws[w]);
    b = fmaxf(b, ws[kWarps + w]);
  }
  *lo = a;
  *hi = b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_dequant_kernel(const T* __restrict__ x, T* __restrict__ out,
                     long long n, int bm, int bn, float levels) {
  __shared__ float ws[2 * kWarps];
  const long long origin =
      (long long)blockIdx.y * bm * n + (long long)blockIdx.x * bn;
  const T* xt = x + origin;
  T* ot = out + origin;

  float lo = INFINITY, hi = -INFINITY;
  for (int r = 0; r < bm; ++r)
    for (int c = threadIdx.x; c < bn; c += kThreads) {
      const float v = to_f32(xt[r * n + c]);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  block_minmax(&lo, &hi, ws);

  const float span = __fsub_rn(hi, lo);
  const float scale = span > 0.0f ? __fdiv_rn(span, levels) : 1.0f;
  for (int r = 0; r < bm; ++r)
    for (int c = threadIdx.x; c < bn; c += kThreads) {
      const float v = to_f32(xt[r * n + c]);
      const float q = rintf(__fdiv_rn(__fsub_rn(v, lo), scale));
      const float code = fminf(fmaxf(q, 0.0f), levels);
      store(ot + r * n + c, __fadd_rn(__fmul_rn(code, scale), lo));
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_wire_kernel(const T* __restrict__ x, unsigned char* __restrict__ codes,
                     float* __restrict__ meta, long long n, int bm, int bn,
                     float levels) {
  __shared__ float ws[2 * kWarps];
  const long long origin =
      (long long)blockIdx.y * bm * n + (long long)blockIdx.x * bn;
  const T* xt = x + origin;
  unsigned char* ct = codes + origin;

  float lo = INFINITY, hi = -INFINITY;
  for (int r = 0; r < bm; ++r)
    for (int c = threadIdx.x; c < bn; c += kThreads) {
      const float v = to_f32(xt[r * n + c]);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  block_minmax(&lo, &hi, ws);

  const float span = __fsub_rn(hi, lo);
  const float scale = span > 0.0f ? __fdiv_rn(span, levels) : 1.0f;
  for (int r = 0; r < bm; ++r)
    for (int c = threadIdx.x; c < bn; c += kThreads) {
      const float v = to_f32(xt[r * n + c]);
      const float q = rintf(__fdiv_rn(__fsub_rn(v, lo), scale));
      ct[r * n + c] = (unsigned char)fminf(fmaxf(q, 0.0f), levels);
    }
  if (threadIdx.x == 0) {
    float* mt = meta + (long long)blockIdx.y * 2 * gridDim.x + 2 * blockIdx.x;
    mt[0] = lo;
    mt[1] = scale;
  }
}

template <typename T>
int launch_wire(const void* x, void* codes, void* meta, int bits, long long m,
                long long n, long long bm, long long bn, cudaStream_t s) {
  const dim3 grid((unsigned)(n / bn), (unsigned)(m / bm));
  quantize_wire_kernel<T><<<grid, kThreads, 0, s>>>(
      (const T*)x, (unsigned char*)codes, (float*)meta, n, (int)bm, (int)bn,
      (float)((1 << bits) - 1));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* out, int bits, long long m, long long n,
           long long bm, long long bn, cudaStream_t s) {
  const dim3 grid((unsigned)(n / bn), (unsigned)(m / bm));
  quant_dequant_kernel<T><<<grid, kThreads, 0, s>>>(
      (const T*)x, (T*)out, n, (int)bm, (int)bn, (float)((1 << bits) - 1));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  The caller checks 1 <= bits <= 8,
// that (bm, bn) tiles (m, n), n / bn < 2**31 and m / bm < 65536.  Returns
// cudaGetLastError() right after the launch (cudaErrorInvalidValue for
// an unknown dtype).
int quant_dequant_launch(const void* x, void* out, int dtype, int bits,
                         long long m, long long n, long long bm, long long bn,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(x, out, bits, m, n, bm, bn, s);
    case 1: return launch<__nv_bfloat16>(x, out, bits, m, n, bm, bn, s);
  }
  return (int)cudaErrorInvalidValue;
}

// codes: (m, n) uint8; meta: (m / bm, 2 * n / bn) float32.  The same
// checks by the caller as above, and 1 <= bits <= 8.
int quantize_wire_launch(const void* x, void* codes, void* meta, int dtype,
                         int bits, long long m, long long n, long long bm,
                         long long bn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_wire<float>(x, codes, meta, bits, m, n, bm, bn, s);
    case 1:
      return launch_wire<__nv_bfloat16>(x, codes, meta, bits, m, n, bm, bn, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
