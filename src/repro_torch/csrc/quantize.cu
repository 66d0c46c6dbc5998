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
// at 3.35 TB/s).  One block per tile, grid (n/bn, m/bm): at the pipeline's
// shape 48 tiles fill 48 of 132 SMs, and the tile is read twice.
//
// Both quantize and dequantize each element of a (bm, bn) tile with the
// tile's min and max, in f32, and write it once in the output type (bf16
// rounds to nearest even):
//   scale = span > 0 ? span / levels : 1
//   code  = clamp(rint((x - min) / scale), 0, levels)
//   out   = code * scale + min
// Division is IEEE (__fdiv_rn), rint rounds half to even like jnp.round /
// torch.round, and the dequant is __fmul_rn then __fadd_rn so that nvcc
// cannot contract it into an FMA: the result is bit-identical to the plain
// PyTorch version and to the JAX package's eager reference.  Never build
// with --use_fast_math.
//
// quant_dequant's bound on the card: bytes.  The function reads x once
// and writes C(x) once, 2*m*n*elem bytes: at the training cut (8, 98304)
// bf16 that is 3.1 MB, 0.000939 ms at 3.35 TB/s; its few f32 operations
// per element are far below the ridge.  At that shape the tile grid is
// only 48 tiles of 32 KB, so one block a tile leaves most SMs idle and
// too few loads in flight.  The design: each tile runs on a thread-block
// cluster of up to 8 blocks, one block for every 512 16-byte vectors of
// the tile (two a thread: fewer, fuller threads keep more loads and
// arithmetic in flight each), so the cut's tile takes 4 blocks in bf16
// and 8 in f32 (192 and 384 blocks).  Each block loads its share once with
// 16-byte vectors, keeps it in registers and reduces min and max over it
// (bf16 pairs in one instruction).  Its thread t then writes the block's
// pair into block t's shared memory with st.async, which completes on
// block t's mbarrier: a block waits only until every pair has landed in
// its own shared memory (a cluster barrier here took longer).  Each block
// quantizes what it holds (the code without a division where that is
// provably exact, see qdq) and stores it with 16-byte vectors: one HBM
// read and one write per element.  min and max are exact
// in any order, so the split changes no bit.  A share larger than 8
// vectors a thread (the (256, 2048) tile of batch 256) is read a second
// time, from L2, instead of being held.  The whole-tensor fallback tile
// (n not a multiple of 128, off the training path) is one cluster that
// loops over the tensor, element by element where n or a pointer does not
// allow 16-byte vectors.  What still holds it well above its bound: the
// load, the exchange and the arithmetic follow each other in series in
// every tile, and with 48 tiles, all in flight at once, nothing overlaps
// them.
//
// In both kernels min and max propagate NaN, as the plain version and the
// reference do: a tile holding a NaN dequantizes to NaN everywhere, and
// its wire meta is (NaN, 1) (span NaN, so the scale falls back to 1), the
// min being the input's NaN, bits and all (a tile whose min came out NaN
// is read again for it: min.NaN gives the canonical NaN); fminf / fmaxf
// would drop the NaN and hide it behind a finite tile.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kHeld = 8;        // units (16 B each) a thread holds at most
constexpr int kPerThread = 2;   // units a thread aims at
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

// NaN-propagating min / max (PTX min.NaN / max.NaN, sm_80+): a NaN in
// either operand is the result.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Min and max over the block, NaN-propagating; every thread gets both.
// ws: 2 * kWarps.
__device__ void block_minmax(float* lo, float* hi, float* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float a = *lo, b = *hi;
  for (int o = 16; o > 0; o >>= 1) {
    a = min_nan(a, __shfl_xor_sync(kFull, a, o));
    b = max_nan(b, __shfl_xor_sync(kFull, b, o));
  }
  if (lane == 0) {
    ws[warp] = a;
    ws[kWarps + warp] = b;
  }
  __syncthreads();
  a = ws[0];
  b = ws[kWarps];
  for (int w = 1; w < kWarps; ++w) {
    a = min_nan(a, ws[w]);
    b = max_nan(b, ws[kWarps + w]);
  }
  *lo = a;
  *hi = b;
}

// V consecutive elements, one 16-byte access when V * sizeof(T) == 16.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Folds a pack into (lo, hi); bf16 pairs through the packed NaN-propagating
// min / max (one instruction for two elements).
template <typename T, int V>
__device__ __forceinline__ void fold(const Pack<T, V>& p, float& lo,
                                     float& hi) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    lo = min_nan(lo, to_f32(p.v[e]));
    hi = max_nan(hi, to_f32(p.v[e]));
  }
}
__device__ __forceinline__ void fold(const Pack<__nv_bfloat16, 8>& p,
                                     float& lo, float& hi) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p.v);
  __nv_bfloat162 l = q[0], h = q[0];
#pragma unroll
  for (int e = 1; e < 4; ++e) {
    l = __hmin2_nan(l, q[e]);
    h = __hmax2_nan(h, q[e]);
  }
  lo = min_nan(lo, min_nan(__low2float(l), __high2float(l)));
  hi = max_nan(hi, max_nan(__low2float(h), __high2float(h)));
}

// Writes V f32 results into a pack (bf16 two at a time, both RNE).
template <typename T, int V>
__device__ __forceinline__ void put(Pack<T, V>& o, const float* r) {
#pragma unroll
  for (int e = 0; e < V; ++e) store(&o.v[e], r[e]);
}
__device__ __forceinline__ void put(Pack<__nv_bfloat16, 8>& o,
                                    const float* r) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(o.v);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    q[e] = __floats2bfloat162_rn(r[2 * e], r[2 * e + 1]);
}

// Quantizes and dequantizes a pack with the tile's (lo, scale); rs is
// __frcp_rn(scale), or NaN where that is not a normal float.  The code is
// rint(fl(d / scale)), d = x - lo, taken without a division where that is
// provably the same: t = fl(d * rs) is within 3 * 2**-24 * |d / scale| of
// fl(d / scale), below 4.6e-5 while t <= 256 (codes are at most 255); so
// where t lies farther than 2**-13 from every half-integer, fl(d / scale)
// rounds to the same integer as t, and rint(t) is t + 1.5 * 2**23 -
// 1.5 * 2**23 (exact below 2**22).  Any other element (near a tie, NaN,
// inf, or no usable reciprocal) takes the IEEE division.  The fast path
// has no branch, so a thread's elements interleave; the division runs
// only for the few flagged ones.
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> qdq(const Pack<T, V>& p, float lo,
                                          float scale, float rs,
                                          float levels) {
  constexpr float kMagic = 12582912.0f;         // 1.5 * 2**23
  constexpr float kTie = 0.5f - 1.0f / 8192.0f;  // 0.5 - 2**-13
  float r[V];
  unsigned slow = 0;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float t = __fmul_rn(__fsub_rn(to_f32(p.v[e]), lo), rs);
    r[e] = __fsub_rn(__fadd_rn(t, kMagic), kMagic);
    const bool fast = t <= 256.0f && fabsf(__fsub_rn(t, r[e])) < kTie;
    slow |= (unsigned)!fast << e;
  }
  if (slow) {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (slow >> e & 1)
        r[e] = rintf(__fdiv_rn(__fsub_rn(to_f32(p.v[e]), lo), scale));
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float code = fminf(fmaxf(r[e], 0.0f), levels);
    r[e] = __fadd_rn(__fmul_rn(code, scale), lo);
  }
  Pack<T, V> o;
  put(o, r);
  return o;
}

// Element offset, from the tile's origin, of unit u (V elements) of a
// tile whose rows hold row_units units (2**row_shift of them where
// row_shift >= 0: every lane tile) at row stride n.
template <typename I>
__device__ __forceinline__ long long unit_offset(I u, int row_units,
                                                 int row_shift, long long n,
                                                 int v) {
  const I r = row_shift >= 0 ? u >> row_shift : u / row_units;
  return (long long)r * n + (long long)(u - r * row_units) * v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One (bm, bn) tile a cluster of csize blocks, grid (csize * n/bn, m/bm).
// R > 0: a thread holds its at most R units in registers; R == 0: it
// reads them again for the second pass.
template <typename T, int V, int R>
__global__ void __launch_bounds__(kThreads)
quant_dequant_kernel(const T* __restrict__ x, T* __restrict__ out,
                     long long n, int bm, int bn, int row_shift,
                     float levels) {
  using P = Pack<T, V>;
  __shared__ alignas(8) float part[2 * kMaxCluster];  // (min, max) a block
  __shared__ alignas(8) unsigned long long full;      // all pairs landed
  __shared__ float ws[2 * kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  if (threadIdx.x == 0) {   // expects csize pairs of 8 bytes
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_u32(&full)));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(&full)), "r"(8 * csize) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // a block writes into the others' shared memory only once every block
  // of the cluster has initialised its barrier: arrive now, wait just
  // before those writes
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  const long long origin = (long long)blockIdx.y * bm * n +
                           (long long)(blockIdx.x / csize) * bn;
  const T* xt = x + origin;
  T* ot = out + origin;
  const int row_units = bn / V;
  const long long units = (long long)bm * row_units;
  const int stride = csize * kThreads;
  const int first = rank * kThreads + threadIdx.x;
  auto at = [&](auto u) { return unit_offset(u, row_units, row_shift, n, V); };

  float lo = INFINITY, hi = -INFINITY;
  P held[R > 0 ? R : 1];
  if (R > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int u = first + j * stride;
      if (u < units) held[j] = *reinterpret_cast<const P*>(xt + at(u));
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (first + j * stride < units) fold(held[j], lo, hi);
  } else {
    for (long long u = first; u < units; u += stride)
      fold(*reinterpret_cast<const P*>(xt + at(u)), lo, hi);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(kFull, lo, o));
    hi = max_nan(hi, __shfl_xor_sync(kFull, hi, o));
  }
  if (lane == 0) {
    ws[warp] = lo;
    ws[kWarps + warp] = hi;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (threadIdx.x < csize) {     // this block's pair into block t's slot
    float a = ws[0], b = ws[kWarps];
    for (int w = 1; w < kWarps; ++w) {
      a = min_nan(a, ws[w]);
      b = max_nan(b, ws[kWarps + w]);
    }
    unsigned slot, bar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(slot) : "r"(smem_u32(&part[2 * rank])),
                   "r"((unsigned)threadIdx.x));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(bar) : "r"(smem_u32(&full)),
                   "r"((unsigned)threadIdx.x));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
        "[%0], {%1, %2}, [%3];"
        :: "r"(slot), "f"(a), "f"(b), "r"(bar) : "memory");
  }
  // every pair has landed here (so no block still writes into this one
  // when it exits)
  for (unsigned done = 0; !done;)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_u32(&full)) : "memory");
  lo = part[0];
  hi = part[1];
  for (int c = 1; c < csize; ++c) {  // the same order in every block
    lo = min_nan(lo, part[2 * c]);
    hi = max_nan(hi, part[2 * c + 1]);
  }

  const float span = __fsub_rn(hi, lo);
  const float scale = span > 0.0f ? __fdiv_rn(span, levels) : 1.0f;
  const float rcp = __frcp_rn(scale);
  const float rs = rcp >= FLT_MIN && rcp <= FLT_MAX ? rcp : NAN;
  if (R > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int u = first + j * stride;
      if (u < units)
        *reinterpret_cast<P*>(ot + at(u)) = qdq(held[j], lo, scale, rs,
                                                levels);
    }
  } else {
    for (long long u = first; u < units; u += stride) {
      const long long off = at(u);
      *reinterpret_cast<P*>(ot + off) = qdq(
          *reinterpret_cast<const P*>(xt + off), lo, scale, rs, levels);
    }
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
      lo = min_nan(lo, v);
      hi = max_nan(hi, v);
    }
  block_minmax(&lo, &hi, ws);
  // A NaN in the tile: its meta min is that NaN, bits and all, as torch's
  // amin keeps it (min.NaN gives the canonical NaN), so read the tile again.
  if (lo != lo) {
    __syncthreads();
    for (int r = 0; r < bm; ++r)
      for (int c = threadIdx.x; c < bn; c += kThreads) {
        const float v = to_f32(xt[r * n + c]);
        if (v != v) ws[0] = v;
      }
    __syncthreads();
    lo = ws[0];
  }

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

// One quant_dequant launch: its arguments, grid and cluster size.
struct QdqLaunch {
  const void* x;
  void* out;
  long long n;
  int bm, bn, row_shift;
  float levels;
  dim3 grid;
  int csize;
  cudaStream_t s;
};

template <typename T, int V, int R>
int launch_cluster(const QdqLaunch& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = a.grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = a.s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, quant_dequant_kernel<T, V, R>, (const T*)a.x, (T*)a.out, a.n,
      a.bm, a.bn, a.row_shift, a.levels);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return (int)(err != cudaSuccess ? err : last);
}

// The cluster: one block a kPerThread * kThreads units of the tile (two
// 16-byte vectors a thread: fewer, fuller threads keep more loads and
// arithmetic in flight each), at most kMaxCluster; the units a thread
// then holds, rounded up to 1, 2, 4 or 8 (R = 0: more than kHeld, read
// twice).
template <typename T, int V>
int launch_v(const void* x, void* out, int bits, long long m, long long n,
             long long bm, long long bn, cudaStream_t s) {
  const long long row_units = bn / V, units = bm * row_units;
  const long long csize = std::min<long long>(
      kMaxCluster, (units + kPerThread * kThreads - 1) /
                       (kPerThread * kThreads));
  const long long per = (units + csize * kThreads - 1) / (csize * kThreads);
  int row_shift = -1;
  if ((row_units & (row_units - 1)) == 0)
    for (row_shift = 0; (1LL << row_shift) < row_units; ++row_shift) {}
  const QdqLaunch a{x, out, n, (int)bm, (int)bn, row_shift,
                    (float)((1 << bits) - 1),
                    dim3((unsigned)(csize * (n / bn)), (unsigned)(m / bm)),
                    (int)csize, s};
  if (per <= 1) return launch_cluster<T, V, 1>(a);
  if (per <= 2) return launch_cluster<T, V, 2>(a);
  if (per <= 4) return launch_cluster<T, V, 4>(a);
  if (per <= kHeld) return launch_cluster<T, V, kHeld>(a);
  return launch_cluster<T, V, 0>(a);
}

// 16-byte vectors where the row stride, the tile width and both pointers
// allow them, single elements otherwise.
template <typename T>
int launch(const void* x, void* out, int bits, long long m, long long n,
           long long bm, long long bn, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out);
  return n % V == 0 && bn % V == 0 && ptrs % 16 == 0
             ? launch_v<T, V>(x, out, bits, m, n, bm, bn, s)
             : launch_v<T, 1>(x, out, bits, m, n, bm, bn, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  The caller checks 1 <= bits <= 8,
// that (bm, bn) tiles (m, n), bn < 2**31, 8 * n / bn < 2**31 and m / bm <
// 65536.  Returns the launch's error (cudaErrorInvalidValue for an
// unknown dtype).
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
