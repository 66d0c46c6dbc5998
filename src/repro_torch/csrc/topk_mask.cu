// Block-local TopK mask for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_mask.py::
// topk_block (_topk_kernel): the C(x) of a TopK stage cut in training, run
// on the forward activation and on the backward activation-gradient.
//
// Each row of each bn-wide tile keeps about k = ceil(k_frac*bn) of its
// entries, chosen by the TPU kernel's threshold bisection:
//   hi = max |x| (NaN if the tile holds one), lo = 0
//   24 times: mid = 0.5f * (lo + hi)
//             count(|x| >= mid) > k ? lo = mid : hi = mid
//   out = |x| >= lo ? x : 0
// So an all-zero row keeps every entry (hi = lo = 0), every tie at lo is
// kept, and a row holding a NaN keeps every other entry (mid is NaN, so lo
// stays 0).
//
// The bisection's decision depends on the data through one number.  Let
// a_1 >= a_2 >= ... be the row's non-NaN magnitudes.  Then count(|x| >=
// mid) > k holds exactly when a_{k+1} exists and mid <= a_{k+1} (false
// for a NaN mid on both sides).  The kernel finds a_{k+1} exactly, then
// runs the 24 steps as scalar f32 arithmetic (__fadd_rn then __fmul_rn,
// as the TPU kernel rounds them): the same lo, bit for bit.  The TPU
// kernel counts in f32, exact up to 2**24 entries, so its decisions are
// the integer ones.
//
// Bound on the card: bytes.  The function reads x once and writes the
// masked x once, 2*m*n*elem bytes: at the training cut (8, 98304) bf16
// that is 3.1 MB, 0.000939 ms at 3.35 TB/s.  Running the bisection
// itself would take 24 counting passes over the tile, each with a block
// reduction.  This design is one block per (row, tile), grid (n/bn, m),
// 384 blocks at the cut:
//   1. each thread loads its share of the tile once, with 16-byte vectors
//      (8 bf16 or 4 f32), and keeps it in registers (2048 entries over 256
//      threads: 1 vector a thread in bf16, 2 in f32);
//   2. the max, over the magnitudes' bit patterns (non-negative floats
//      order as unsigned integers, and NaN above inf);
//   3. a_{k+1} by a radix select over those bits: 8-bit digits from the
//      top, a shared-memory histogram a digit (plain atomics: same-address
//      adds within a warp cost no more here than aggregating them with
//      __match_any_sync, which measured slower), NaN never counted.  bf16
//      magnitudes have 15 significant bits, so 2 digit passes; f32 takes
//      4.  Two barriers a pass: warp 0 alone scans the 256 bins, and two
//      histograms alternate, so zeroing costs none;
//   4. the 24 scalar steps, in every thread;
//   5. the mask, written once with 16-byte vectors.
// A tile wider than 8 vectors a thread (the whole-row fallback tile when n
// is not a multiple of 128, off the training path) reads its row from
// global memory (L1/L2) on every pass instead of holding it.  What still
// holds it well above its bound: the load, the digit passes (two block
// barriers each) and the 24 dependent scalar steps follow each other in
// series in every block, with no other work to overlap them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;        // one 8-bit digit; one bin a thread
constexpr int kHeld = 8;          // units (16 B each) a thread holds at most
constexpr int kIters = 24;        // src/repro/kernels/topk_mask.py ITERS
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;  // keys above it are NaN
static_assert(kThreads == kBins && kBins == 32 * 8,
              "one bin a thread to zero, 8 a lane of warp 0 to scan");

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

// V consecutive elements, one 16-byte access when V * sizeof(T) == 16.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The magnitude's bit pattern: |x| as f32 bits (bf16 widens exactly).
template <typename T>
__device__ __forceinline__ unsigned key_of(T v) {
  return __float_as_uint(fabsf(to_f32(v)));
}

// The bits [lo, hi) of f32 keys that digit pass p selects on: 8-bit
// digits from bit 31 down, the last one 7 bits.
__device__ __forceinline__ int digit_hi(int p) { return 31 - 8 * p; }
__device__ __forceinline__ int digit_lo(int p) { return max(23 - 8 * p, 0); }

// One (row, tile) a block, grid (n/bn, m).  R > 0: a thread holds its at
// most R units of V elements (and their keys) in registers; R == 0: every
// pass reads them from global memory.  kPasses digit passes cover the
// significant key bits (bf16: 2, f32: 4).
template <typename T, int V, int R, int kPasses>
__global__ void __launch_bounds__(kThreads)
topk_block_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                  int bn, int k) {
  using P = Pack<T, V>;
  __shared__ unsigned hist[2][kBins];
  __shared__ unsigned s_top, s_prefix, s_need;
  __shared__ int s_found;
  const long long origin =
      (long long)blockIdx.y * n + (long long)blockIdx.x * bn;
  const P* xt = reinterpret_cast<const P*>(x + origin);
  P* ot = reinterpret_cast<P*>(out + origin);
  const int units = bn / V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  P held[R > 0 ? R : 1];
  if (R > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int u = threadIdx.x + j * kThreads;
      if (u < units) held[j] = xt[u];
    }
  }
  hist[0][threadIdx.x] = 0;
  hist[1][threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    s_top = 0;
    s_found = 0;
  }
  __syncthreads();

  // The keys (kDead past the tile's end, above every real key) and their
  // max, NaN included.
  constexpr unsigned kDead = 0xffffffffu;
  unsigned keys[R > 0 ? R * V : 1];
  unsigned top = 0;
  if (R > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool live = (int)threadIdx.x + j * kThreads < units;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        keys[j * V + e] = live ? key_of(held[j].v[e]) : kDead;
        top = max(top, live ? keys[j * V + e] : 0u);
      }
    }
  } else {
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const P v = xt[u];
#pragma unroll
      for (int e = 0; e < V; ++e) top = max(top, key_of(v.v[e]));
    }
  }
  top = __reduce_max_sync(kFull, top);
  if (lane == 0) atomicMax(&s_top, top);

  // Digit pass p adds each non-NaN key whose bits above `hi` equal the
  // prefix's to the bin of its bits [lo, hi); warp 0 then finds the bin
  // holding the need-th largest, counting from the top bin down.
  unsigned prefix = 0, need = (unsigned)k + 1;
  for (int p = 0; p < kPasses; ++p) {
    const int hi = digit_hi(p), lo = digit_lo(p);
    const unsigned mask = (1u << (hi - lo)) - 1;
    unsigned* h = hist[p & 1];
    auto add = [&](unsigned key) {
      if (key <= kInfBits && (key >> hi) == (prefix >> hi))
        atomicAdd(&h[(key >> lo) & mask], 1u);
    };
    if (R > 0) {
#pragma unroll
      for (int i = 0; i < R * V; ++i) add(keys[i]);
    } else {
      for (int u = threadIdx.x; u < units; u += kThreads) {
        const P v = xt[u];
#pragma unroll
        for (int e = 0; e < V; ++e) add(key_of(v.v[e]));
      }
    }
    hist[(p + 1) & 1][threadIdx.x] = 0;   // the next pass's, read before
    __syncthreads();
    if (warp == 0) {   // lane l: bins 255 - 8l down to 248 - 8l
      unsigned c[8], sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[q] = h[kBins - 1 - 8 * lane - q];
        sum += c[q];
      }
      unsigned incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      unsigned above = incl - sum;
      if (above < need && need <= incl) {   // a_{k+1} lies in these bins
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (above < need && need <= above + c[q]) {
            s_prefix = prefix | ((unsigned)(kBins - 1 - 8 * lane - q) << lo);
            s_need = need - above;
            s_found = 1;
          }
          above += c[q];
        }
      }
    }
    __syncthreads();
    if (!s_found) break;   // fewer than k + 1 non-NaN entries
    prefix = s_prefix;
    need = s_need;
  }

  // The bisection, as scalar arithmetic in every thread.
  const bool found = s_found;
  const float a = __uint_as_float(prefix);
  float lo = 0.0f, hi = __uint_as_float(s_top);
  for (int it = 0; it < kIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (found && mid <= a) {
      lo = mid;
    } else {
      hi = mid;
    }
  }

  auto mask = [&](const P& v) {
    P o;
#pragma unroll
    for (int e = 0; e < V; ++e)
      o.v[e] = fabsf(to_f32(v.v[e])) >= lo ? v.v[e] : zero<T>();
    return o;
  };
  if (R > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int u = threadIdx.x + j * kThreads;
      if (u < units) ot[u] = mask(held[j]);
    }
  } else {
    for (int u = threadIdx.x; u < units; u += kThreads) ot[u] = mask(xt[u]);
  }
}

template <typename T, int V, int R>
int launch_r(const void* x, void* out, long long m, long long n, long long bn,
             long long k, cudaStream_t s) {
  const dim3 grid((unsigned)(n / bn), (unsigned)m);
  constexpr int kPasses = sizeof(T) == 2 ? 2 : 4;
  topk_block_kernel<T, V, R, kPasses><<<grid, kThreads, 0, s>>>(
      (const T*)x, (T*)out, n, (int)bn, (int)k);
  return (int)cudaGetLastError();
}

// The units a thread holds, rounded up to 1, 2, 4 or 8 (0: more, reread).
template <typename T, int V>
int launch_v(const void* x, void* out, long long m, long long n, long long bn,
             long long k, cudaStream_t s) {
  const long long per = (bn / V + kThreads - 1) / kThreads;
  if (per <= 1) return launch_r<T, V, 1>(x, out, m, n, bn, k, s);
  if (per <= 2) return launch_r<T, V, 2>(x, out, m, n, bn, k, s);
  if (per <= 4) return launch_r<T, V, 4>(x, out, m, n, bn, k, s);
  if (per <= kHeld) return launch_r<T, V, kHeld>(x, out, m, n, bn, k, s);
  return launch_r<T, V, 0>(x, out, m, n, bn, k, s);
}

// 16-byte vectors where the row stride, the tile width and both pointers
// allow them, single elements otherwise.
template <typename T>
int launch(const void* x, void* out, long long m, long long n, long long bn,
           long long k, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out);
  return n % V == 0 && bn % V == 0 && ptrs % 16 == 0
             ? launch_v<T, V>(x, out, m, n, bn, k, s)
             : launch_v<T, 1>(x, out, m, n, bn, k, s);
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
