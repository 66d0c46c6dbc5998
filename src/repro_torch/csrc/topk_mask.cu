// Block-local TopK mask for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_mask.py::
// topk_block (_topk_kernel): the C(x) of a TopK stage cut in training, run
// on the forward activation and on the backward activation-gradient.
//
// One block per (row, tile), grid (n/bn, m).  Each row of each bn-wide
// tile keeps about k = ceil(k_frac*bn) of its entries, chosen by the TPU
// kernel's threshold bisection, step for step:
//   hi = max |x|, lo = 0
//   24 times: mid = 0.5f * (lo + hi)
//             cnt = #(|x| >= mid)
//             cnt > k ? lo = mid : hi = mid
//   out = |x| >= lo ? x : 0
// The TPU kernel counts in f32; a count of at most 2**24 is exact in f32,
// so the block's integer count takes the same decisions bit for bit.  So
// an all-zero row keeps every entry (hi = lo = 0), and every tie at lo is
// kept.  The bisection's magnitudes (bn <= 2048 f32, at most 8 KB) are
// staged once in shared memory; the whole-row fallback tile (n not a
// multiple of 128, off the training path) can outgrow shared memory, so
// that instance reads |x| from global memory (L1/L2) on every step.
//
// Bound on the card: bytes.  The function reads x once and writes the
// masked x once, 2*m*n*elem bytes: at (8, 98304) bf16 that is 3.1 MB,
// 0.000939 ms at 3.35 TB/s.  The 24 passes over shared memory, each with a
// block reduction, are the kernel's cost and not the function's.  Left
// for later: a radix select over the staged bits, or one warp per
// (row, tile) with the count in registers, would cut the 48 barriers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStaged = 2048;  // the widest lane block (kernels/tiling.py)
constexpr int kIters = 24;        // src/repro/kernels/topk_mask.py ITERS
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// Sum over the block; every thread gets the total.  ws: kWarps + 1.
__device__ int block_sum(int v, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += ws[w];
  __syncthreads();  // ws is reused by the next call
  return total;
}

// Max over the block; every thread gets it.  ws: kWarps.
__device__ float block_max(float v, float* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  float m = ws[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, ws[w]);
  return m;
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
topk_block_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                  int bn, int k) {
  __shared__ float mag[kStaged ? kMaxStaged : 1];
  __shared__ float fws[kWarps];
  __shared__ int iws[kWarps];
  const long long origin = (long long)blockIdx.y * n + (long long)blockIdx.x * bn;
  const T* xt = x + origin;
  T* ot = out + origin;
  auto at = [&](int i) {
    return kStaged ? mag[i] : fabsf(to_f32(xt[i]));
  };

  float top = 0.0f;
  for (int i = threadIdx.x; i < bn; i += kThreads) {
    const float a = fabsf(to_f32(xt[i]));
    if (kStaged) mag[i] = a;
    top = fmaxf(top, a);
  }
  float hi = block_max(top, fws);  // its barrier also publishes mag[]
  float lo = 0.0f;
  for (int it = 0; it < kIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    int cnt = 0;
    for (int i = threadIdx.x; i < bn; i += kThreads) cnt += at(i) >= mid;
    if (block_sum(cnt, iws) > k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  for (int i = threadIdx.x; i < bn; i += kThreads)
    ot[i] = at(i) >= lo ? xt[i] : zero<T>();
}

template <typename T>
int launch(const void* x, void* out, long long m, long long n, long long bn,
           long long k, cudaStream_t s) {
  const dim3 grid((unsigned)(n / bn), (unsigned)m);
  if (bn <= kMaxStaged)
    topk_block_kernel<T, true><<<grid, kThreads, 0, s>>>(
        (const T*)x, (T*)out, n, (int)bn, (int)k);
  else
    topk_block_kernel<T, false><<<grid, kThreads, 0, s>>>(
        (const T*)x, (T*)out, n, (int)bn, (int)k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  The caller checks that bn divides n,
// 1 <= k <= bn < 2**31 and m < 65536.  Returns cudaGetLastError() right
// after the launch (cudaErrorInvalidValue for an unknown dtype).
int topk_block_launch(const void* x, void* out, int dtype, long long m,
                      long long n, long long bn, long long k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(x, out, m, n, bn, k, s);
    case 1: return launch<__nv_bfloat16>(x, out, m, n, bn, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
