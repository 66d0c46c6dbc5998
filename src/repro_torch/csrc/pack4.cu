// q4 wire pack / unpack for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/pack4.py::pack4_wire
// (_pack4_kernel) and ::unpack4_wire (_unpack4_kernel).
//
// pack : x (M, N) f32, per-row min/scale (M,) -> (M, ceil(N/2)) u8, byte j of
//        a row = code[2j] | code[2j+1] << 4, code = clip(rint((x-min)/scale),
//        0, 15); odd N gets a zero pad code written here, so no padded copy
//        of x ever exists.
// unpack: the inverse, codes*scale+min in f32, pad column dropped.
//
// Bound on the card: memory.  Both move ~4.5 bytes per element (f32 one
// way, half a byte the other) for a handful of flops, far below the
// H100's ~300 flops/byte ridge.  One grid-stride pass with neighbouring
// threads on neighbouring bytes keeps every access coalesced.
//
// Bit-exactness with the plain PyTorch version (and the JAX package):
// IEEE division (__fdiv_rn), rintf (round half to even, like jnp.round /
// torch.round), and the dequant written as __fmul_rn then __fadd_rn so
// nvcc cannot contract it into an FMA.  Never build with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned q4_code(float x, float mn, float sc) {
  float q = rintf(__fdiv_rn(__fsub_rn(x, mn), sc));
  return (unsigned)fminf(fmaxf(q, 0.0f), 15.0f);
}

__global__ void pack4_kernel(const float* __restrict__ x,
                             const float* __restrict__ mn,
                             const float* __restrict__ sc,
                             uint8_t* __restrict__ out,
                             long long n, long long h, long long total) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long row = t / h;
    const long long i = 2 * (t - row * h);
    const float* xr = x + row * n;
    const float m = mn[row], s = sc[row];
    const unsigned lo = q4_code(xr[i], m, s);
    const unsigned hi = (i + 1 < n) ? q4_code(xr[i + 1], m, s) : 0u;
    out[t] = (uint8_t)(lo | (hi << 4));
  }
}

__global__ void unpack4_kernel(const uint8_t* __restrict__ p,
                               const float* __restrict__ mn,
                               const float* __restrict__ sc,
                               float* __restrict__ out,
                               long long n, long long h, long long total) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long row = t / h;
    const long long i = 2 * (t - row * h);
    const float m = mn[row], s = sc[row];
    const unsigned b = p[t];
    float* o = out + row * n + i;
    o[0] = __fadd_rn(__fmul_rn((float)(b & 0xFu), s), m);
    if (i + 1 < n) o[1] = __fadd_rn(__fmul_rn((float)(b >> 4), s), m);
  }
}

constexpr int kThreads = 256;

unsigned grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // 32 blocks per SM, then grid-stride
  return (unsigned)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

// Every entry point returns cudaGetLastError() right after its launch.
int pack4_wire_launch(const void* x, const void* mn, const void* sc,
                      void* out, long long m, long long n, void* stream) {
  const long long h = (n + 1) / 2, total = m * h;
  if (total == 0) return 0;
  pack4_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)mn, (const float*)sc, (uint8_t*)out, n,
      h, total);
  return (int)cudaGetLastError();
}

int unpack4_wire_launch(const void* packed, const void* mn, const void* sc,
                        void* out, long long m, long long n, void* stream) {
  const long long h = (n + 1) / 2, total = m * h;
  if (total == 0) return 0;
  unpack4_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const float*)mn, (const float*)sc,
      (float*)out, n, h, total);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
