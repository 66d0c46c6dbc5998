// Exact per-row TopK select for Hopper (sm_90a): threshold + compaction.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_select.py::
// topk_threshold (_threshold_kernel) and the XLA epilogue of
// ::topk_select_wire, which the TPU left to XLA only because Mosaic has no
// per-lane scatter.
//
// topk_threshold_kernel: one block per row.  31 bisection steps over the
//   int32 bit pattern of |x| (non-negative floats order like their bits;
//   -0.0 -> +0.0 -> 0) find the EXACT k-th largest magnitude: step b keeps
//   bit b when count(bits >= t | 1<<b) >= k.  Each step streams the row
//   from global memory (the prefill row, S*d = 98,304 bf16, is 192 KB:
//   too big for shared memory, resident in the 50 MB L2 after the first
//   step) and reduces the count across the block.
// topk_compact_kernel: one block per row.  Pass 1 counts entries above the
//   threshold (c_gt); pass 2 walks the row in block-sized chunks in index
//   order with two block-wide exclusive scans per chunk -- ties at the
//   threshold, then kept entries -- so exactly k entries are kept (all
//   above the threshold, then ties by lowest index, lax.top_k's rule) and
//   written in ascending index order with their values.  It stops once k
//   entries are written.
//
// Bound on the card: memory (a few int compares per byte read).  With one
// block per row and a batch of a few requests only a few SMs work; the
// threshold also reads its row 31 times (from L2).  Simple first: a
// multi-block-per-row or radix-select version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ int mag_bits(T v) {
  return __float_as_int(fabsf(to_f32(v)));
}

// Sum of v over the block; every thread gets the total.  ws: kWarps + 1.
__device__ int block_sum(int v, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? ws[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) w += __shfl_down_sync(kFull, w, o);
    if (lane == 0) ws[kWarps] = w;
  }
  __syncthreads();
  const int total = ws[kWarps];
  __syncthreads();  // ws is reused by the next call
  return total;
}

// Exclusive prefix sum of v over the block in thread order; *total gets
// the block total.  ws: kWarps + 1.
__device__ int block_exclusive_scan(int v, int* total, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? ws[lane] : 0;
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kWarps) ws[lane] = wi - w;
    if (lane == kWarps - 1) ws[kWarps] = wi;
  }
  __syncthreads();
  const int r = ws[warp] + incl - v;
  *total = ws[kWarps];
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_threshold_kernel(const T* __restrict__ x, float* __restrict__ thresh,
                      int n, int k) {
  __shared__ int ws[kWarps + 1];
  const T* xr = x + (long long)blockIdx.x * n;
  int t = 0;
  for (int b = 30; b >= 0; --b) {
    const int cand = t | (1 << b);
    int cnt = 0;
    for (int i = threadIdx.x; i < n; i += kThreads)
      cnt += mag_bits(xr[i]) >= cand;
    if (block_sum(cnt, ws) >= k) t = cand;
  }
  if (threadIdx.x == 0) thresh[blockIdx.x] = __int_as_float(t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_compact_kernel(const T* __restrict__ x, const float* __restrict__ thresh,
                    T* __restrict__ vals, int* __restrict__ idx, int n,
                    int k) {
  __shared__ int ws[kWarps + 1];
  const long long row = blockIdx.x;
  const T* xr = x + row * n;
  T* vr = vals + row * k;
  int* ir = idx + row * k;
  const int tb = __float_as_int(thresh[row]);

  int c = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) c += mag_bits(xr[i]) > tb;
  const int quota = k - block_sum(c, ws);  // ties to keep, lowest index first

  int eq_seen = 0, kept = 0;  // totals over earlier chunks, block-uniform
  for (int base = 0; base < n && kept < k; base += kThreads) {
    const int i = base + threadIdx.x;
    const int bits = i < n ? mag_bits(xr[i]) : -1;
    const int gt = bits > tb;
    const int eq = bits == tb;
    int eq_total, keep_total;
    const int eq_before = eq_seen + block_exclusive_scan(eq, &eq_total, ws);
    const int keep = gt | (eq & (eq_before + 1 <= quota));
    const int slot = kept + block_exclusive_scan(keep, &keep_total, ws);
    if (keep) {
      ir[slot] = i;
      vr[slot] = xr[i];
    }
    eq_seen += eq_total;
    kept += keep_total;
  }
}

template <typename T>
int launch_threshold(const void* x, void* thresh, long long m, long long n,
                     long long k, cudaStream_t s) {
  topk_threshold_kernel<T><<<(unsigned)m, kThreads, 0, s>>>(
      (const T*)x, (float*)thresh, (int)n, (int)k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_compact(const void* x, const void* thresh, void* vals, void* idx,
                   long long m, long long n, long long k, cudaStream_t s) {
  topk_compact_kernel<T><<<(unsigned)m, kThreads, 0, s>>>(
      (const T*)x, (const float*)thresh, (T*)vals, (int*)idx, (int)n,
      (int)k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() right after the launch (or cudaErrorInvalidValue for
// an unknown dtype).  The caller checks 1 <= k <= n < 2**31, m >= 1.
int topk_threshold_launch(const void* x, void* thresh, int dtype,
                          long long m, long long n, long long k,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_threshold<float>(x, thresh, m, n, k, s);
    case 1: return launch_threshold<__nv_bfloat16>(x, thresh, m, n, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

int topk_compact_launch(const void* x, const void* thresh, void* vals,
                        void* idx, int dtype, long long m, long long n,
                        long long k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_compact<float>(x, thresh, vals, idx, m, n, k, s);
    case 1:
      return launch_compact<__nv_bfloat16>(x, thresh, vals, idx, m, n, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
