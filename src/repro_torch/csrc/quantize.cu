// Per-tile min-max k-bit quantize -> dequantize, and the q8 wire quantizer,
// for Hopper (sm_90a).
//
// quant_dequant_kernel replaces the Pallas TPU kernel
// src/repro/kernels/quantize.py::quant_dequant (_qdq_kernel): the C(x) of a
// quantizing stage cut in training, run on the forward activation and on
// the backward activation-gradient, both (B, S*d).
//
// quantize_wire_kernel replaces ::quantize_wire (_quantize_kernel): the
// sender side of the per-tile q8 wire format of the real pipeline.  The
// same tile walk and the same arithmetic up to the code, which it writes
// as uint8, and each tile's (min, scale) pair goes to meta[i, 2j], meta[i,
// 2j+1] of the (gm, 2*gn) f32 meta array.  The input may be bf16 (the
// reference casts to f32 first; bf16 values are exact in f32).
//
// Both quantize each element of a (bm, bn) tile with the tile's min and
// max, in f32:
//   scale = span > 0 ? span / levels : 1
//   code  = clamp(rint((x - min) / scale), 0, levels)
//   out   = code * scale + min          (quant_dequant, in the input type;
//                                        bf16 rounds to nearest even)
// Division is IEEE (__fdiv_rn) where the code cannot be proven equal
// without it (qcode.cuh), rint rounds half to even like jnp.round /
// torch.round, and the dequant is __fmul_rn then __fadd_rn so that nvcc
// cannot contract it into an FMA: the results are bit-identical to the
// plain PyTorch versions and to the JAX package's eager references.
// Never build with --use_fast_math.
//
// Bound on the card: bytes.  quant_dequant reads x once and writes C(x)
// once, 2*m*n*elem bytes (at the training cut (8, 98304) bf16, 3.1 MB,
// 0.000939 ms at 3.35 TB/s); quantize_wire reads x once and writes one
// byte an element and 8 bytes a tile (at the pipeline hop (8, 98304) bf16,
// 2.36 MB, 0.000704 ms).  Their few f32 operations an element are far
// below the ridge.  At those shapes the tile grid is only 48 tiles of (8,
// 2048), so one block a tile would leave most SMs idle with too few loads
// in flight.
//
// The design, one routine (cluster_tile) for both kernels, each supplying
// only its output (its epilogue):
// - A tile runs on a thread-block cluster of up to 8 blocks, one block for
//   every 512 16-byte units of the tile (kernels/quantize.py::geometry,
//   two a thread: fewer, fuller threads keep more loads and arithmetic in
//   flight each): 4 blocks in bf16 and 8 in f32 at (8, 2048) (192 and 384
//   blocks at the cut and the hop).
// - Each block loads its share once with 16-byte vectors, keeps it in
//   registers and reduces min and max over it (bf16 pairs in one
//   instruction); a share larger than 8 units a thread (the (256, 2048)
//   tile of a 256-row batch) is read a second time, from L2, instead.
// - Its thread t writes the block's (min, max) into block t's shared
//   memory with st.async, which completes on block t's mbarrier: a block
//   waits only until every pair has landed in its own shared memory (a
//   cluster barrier took longer).  min and max are exact in any order, so
//   the split changes no bit.
// - Each block codes what it holds by qcode.cuh's rule (the reciprocal
//   product where provably the division's integer) and writes it once:
//   quant_dequant a 16-byte vector a unit, quantize_wire the unit's 8 (bf16)
//   or 4 (f32) codes as one 8- or 4-byte word, so a warp's stores cover
//   neighbouring addresses of a tile row.  The cluster's first block
//   writes the wire tile's (min, scale) as one 8-byte store.
// - Where n, bn or a pointer does not allow 16-byte vectors (the
//   whole-tensor fallback tile of n not a multiple of 128, a view), a unit
//   is one element.
//
// NaN: min and max propagate it (min.NaN / max.NaN), as the plain versions
// and the reference do, so a tile holding a NaN dequantizes to NaN
// everywhere, and its wire meta is (NaN, 1) (span NaN, so the scale falls
// back to 1); fminf / fmaxf would drop the NaN and hide it behind a finite
// tile.  The wire meta's min is the input's NaN, bits and all, as the
// reference's min keeps it, but min.NaN gives the canonical NaN: so a warp
// whose min came out NaN (one compare, the same in all its lanes after the
// shuffle reduce) finds, among the units its threads hold (or read again),
// the NaN of the largest bit pattern as a signed integer and takes that as
// its min, and where a block's or the cluster's min comes out NaN the
// partial mins are combined again by that rule.  It is order-free, so the
// meta is the same in every run, and it is the plain version's
// (kernels/quantize.py).  A block-wide search behind a barrier vote cost
// 5-6% of the wire kernel's time on the H100, a check of every block's
// min and that combine always 6-12% (PERF.md, the quantize_wire findings).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "qcode.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kHeld = 8;        // units a thread holds at most
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
// either operand gives the canonical NaN.
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

// min.NaN, except that a NaN operand is the result with its own bits, and
// of two NaNs the larger bit pattern as a signed integer (order-free).
__device__ __forceinline__ float min_keep_nan(float a, float b) {
  const bool na = a != a, nb = b != b;
  if (na && nb) return __float_as_int(a) >= __float_as_int(b) ? a : b;
  if (na || nb) return na ? a : b;
  return min_nan(a, b);
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

// The largest bit pattern, as a signed integer, of the pack's NaNs (bf16
// widened exactly), or INT_MIN.
template <typename T, int V>
__device__ __forceinline__ int nan_bits(const Pack<T, V>& p) {
  int b = INT_MIN;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float v = to_f32(p.v[e]);
    if (v != v) b = max(b, __float_as_int(v));
  }
  return b;
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

// quant_dequant's epilogue: each unit's codes dequantized into T.
template <typename T>
struct Dequantized {
  static constexpr bool kNanBits = false;  // its NaN tiles are NaN anyway
  T* out;

  template <int V>
  __device__ __forceinline__ void unit(long long off, const float* q,
                                       float lo, float scale) const {
    float r[V];
#pragma unroll
    for (int e = 0; e < V; ++e) r[e] = __fadd_rn(__fmul_rn(q[e], scale), lo);
    Pack<T, V> o;
    put(o, r);
    *reinterpret_cast<Pack<T, V>*>(out + off) = o;
  }
  __device__ __forceinline__ void tile(int, int, int, float, float) const {}
};

// quantize_wire's epilogue: each unit's codes as one word (8 codes: 8
// bytes; 4: 4 bytes; 1: a byte), the tile's (min, scale) as 8 bytes.
struct WireCodes {
  static constexpr bool kNanBits = true;   // the meta carries the NaN
  unsigned char* codes;
  float* meta;

  template <int V>
  __device__ __forceinline__ void unit(long long off, const float* q, float,
                                       float) const {
    if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(codes + off) =
          make_uint2(qcode_word(q), qcode_word(q + 4));
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint32_t*>(codes + off) = qcode_word(q);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        codes[off + e] = (unsigned char)qcode_byte(q[e]);
    }
  }
  __device__ __forceinline__ void tile(int i, int j, int gn, float lo,
                                       float scale) const {
    *reinterpret_cast<float2*>(meta + (long long)i * 2 * gn + 2 * j) =
        make_float2(lo, scale);
  }
};

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

// One (bm, bn) tile a cluster of csize blocks, grid (csize * n/bn, m/bm):
// block `rank` of the cluster works units rank * kThreads + t + j * csize *
// kThreads.  R > 0: a thread holds its at most R units in registers; R ==
// 0: it reads them again for the second pass.  `out` writes the codes and
// the tile's meta.
template <typename T, int V, int R, typename Out>
__device__ __forceinline__ void cluster_tile(const T* __restrict__ x,
                                             long long n, int bm, int bn,
                                             int row_shift, float levels,
                                             const Out& out) {
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

  const int tile_col = blockIdx.x / csize;
  const long long origin =
      (long long)blockIdx.y * bm * n + (long long)tile_col * bn;
  const T* xt = x + origin;
  const int row_units = bn / V;
  const long long units = (long long)bm * row_units;
  const int stride = csize * kThreads;
  const int first = rank * kThreads + threadIdx.x;
  auto at = [&](auto u) { return unit_offset(u, row_units, row_shift, n, V); };

  P held[R > 0 ? R : 1];
  if (R > 0) {   // every load in flight before any arithmetic
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int u = first + j * stride;
      if (u < units) held[j] = *reinterpret_cast<const P*>(xt + at(u));
    }
  }
  // f(offset from the tile's origin, pack) for each unit of this thread
  auto each = [&](auto f) {
    if (R > 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int u = first + j * stride;
        if (u < units) f(at(u), held[j]);
      }
    } else {
      for (long long u = first; u < units; u += stride) {
        const long long off = at(u);
        f(off, *reinterpret_cast<const P*>(xt + off));
      }
    }
  };

  float lo = INFINITY, hi = -INFINITY;
  each([&](long long, const P& p) { fold(p, lo, hi); });
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(kFull, lo, o));
    hi = max_nan(hi, __shfl_xor_sync(kFull, hi, o));
  }
  if (Out::kNanBits && lo != lo) {   // the same in the whole warp; rare
    int b = INT_MIN;   // the warp's NaN, bits and all, for its min
    each([&](long long, const P& p) { b = max(b, nan_bits(p)); });
    lo = __int_as_float(__reduce_max_sync(kFull, b));
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
    if (Out::kNanBits && a != a) {   // a warp's NaN: keep its bits
      a = ws[0];
      for (int w = 1; w < kWarps; ++w) a = min_keep_nan(a, ws[w]);
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
  if (Out::kNanBits && lo != lo) {   // a block's NaN: keep its bits
    lo = part[0];
    for (int c = 1; c < csize; ++c) lo = min_keep_nan(lo, part[2 * c]);
  }

  const float span = __fsub_rn(hi, lo);
  const float scale = span > 0.0f ? __fdiv_rn(span, levels) : 1.0f;
  const float rs = qcode_rcp(scale);
  each([&](long long off, const P& p) {
    float v[V], q[V];
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = to_f32(p.v[e]);
    qcodes<V>(v, lo, scale, rs, levels, q);
    out.template unit<V>(origin + off, q, lo, scale);
  });
  if (rank == 0 && threadIdx.x == 0)
    out.tile(blockIdx.y, tile_col, gridDim.x / csize, lo, scale);
}

template <typename T, int V, int R>
__global__ void __launch_bounds__(kThreads)
quant_dequant_kernel(const T* __restrict__ x, T* __restrict__ out,
                     long long n, int bm, int bn, int row_shift,
                     float levels) {
  cluster_tile<T, V, R>(x, n, bm, bn, row_shift, levels,
                        Dequantized<T>{out});
}

template <typename T, int V, int R>
__global__ void __launch_bounds__(kThreads)
quantize_wire_kernel(const T* __restrict__ x,
                     unsigned char* __restrict__ codes,
                     float* __restrict__ meta, long long n, int bm, int bn,
                     int row_shift, float levels) {
  cluster_tile<T, V, R>(x, n, bm, bn, row_shift, levels,
                        WireCodes{codes, meta});
}

// One launch's shape: its tile, grid and cluster size.
struct Launch {
  long long n;
  int bm, bn, row_shift;
  float levels;
  dim3 grid;
  int csize;
  cudaStream_t s;
};

template <typename K, typename... A>
int cluster_launch(const Launch& l, K kernel, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = l.grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = l.s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)l.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return (int)(err != cudaSuccess ? err : last);
}

struct QdqArgs {
  const void* x;
  void* out;
};
struct WireArgs {
  const void* x;
  void* codes;
  void* meta;
};

template <typename T, int V, int R>
int start(const Launch& l, const QdqArgs& a) {
  return cluster_launch(l, quant_dequant_kernel<T, V, R>, (const T*)a.x,
                        (T*)a.out, l.n, l.bm, l.bn, l.row_shift, l.levels);
}
template <typename T, int V, int R>
int start(const Launch& l, const WireArgs& a) {
  return cluster_launch(l, quantize_wire_kernel<T, V, R>, (const T*)a.x,
                        (unsigned char*)a.codes, (float*)a.meta, l.n, l.bm,
                        l.bn, l.row_shift, l.levels);
}

template <typename T, int V, typename A>
int by_held(const Launch& l, const A& a, int held) {
  switch (held) {
    case 0: return start<T, V, 0>(l, a);
    case 1: return start<T, V, 1>(l, a);
    case 2: return start<T, V, 2>(l, a);
    case 4: return start<T, V, 4>(l, a);
    case kHeld: return start<T, V, kHeld>(l, a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename A>
int by_width(const Launch& l, const A& a, int v, int held) {
  constexpr int kVec = 16 / sizeof(T);
  if (v == kVec) return by_held<T, kVec>(l, a, held);
  if (v == 1) return by_held<T, 1>(l, a, held);
  return (int)cudaErrorInvalidValue;
}

// Checks the geometry from kernels/quantize.py::geometry (v elements a
// unit, csize blocks a tile, held units a thread or 0) against the tile,
// then launches.  `aligned`: both pointers allow v-element vectors.
template <typename A>
int launch(const A& a, bool aligned, int dtype, int bits, long long m,
           long long n, long long bm, long long bn, int v, int csize,
           int held, cudaStream_t s) {
  const long long row_units = v > 0 ? bn / v : 0, units = bm * row_units;
  if (v < 1 || n % v || bn % v || (v > 1 && !aligned) || csize < 1 ||
      csize > kMaxCluster || held < 0 ||
      (held > 0 && (long long)csize * kThreads * held < units))
    return (int)cudaErrorInvalidValue;
  int row_shift = -1;
  if ((row_units & (row_units - 1)) == 0)
    for (row_shift = 0; (1LL << row_shift) < row_units; ++row_shift) {}
  const Launch l{n, (int)bm, (int)bn, row_shift, (float)((1 << bits) - 1),
                 dim3((unsigned)(csize * (n / bn)), (unsigned)(m / bm)),
                 csize, s};
  switch (dtype) {
    case 0: return by_width<float>(l, a, v, held);
    case 1: return by_width<__nv_bfloat16>(l, a, v, held);
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  The caller checks 1 <= bits <= 8,
// that (bm, bn) tiles (m, n), bn < 2**31, 8 * n / bn < 2**31 and m / bm <
// 65536; v, csize and held come from kernels/quantize.py::geometry.
// Returns the launch's error (cudaErrorInvalidValue for an unknown dtype or
// a geometry that does not cover the tile).
int quant_dequant_launch(const void* x, void* out, int dtype, int bits,
                         long long m, long long n, long long bm, long long bn,
                         int v, int csize, int held, void* stream) {
  return launch(QdqArgs{x, out}, aligned16(x) && aligned16(out), dtype,
                bits, m, n, bm, bn, v, csize, held, (cudaStream_t)stream);
}

// codes: (m, n) uint8; meta: (m / bm, 2 * n / bn) float32, both fresh
// allocations (8-byte stores).  The same checks by the caller as above.
int quantize_wire_launch(const void* x, void* codes, void* meta, int dtype,
                         int bits, long long m, long long n, long long bm,
                         long long bn, int v, int csize, int held,
                         void* stream) {
  return launch(WireArgs{x, codes, meta}, aligned16(x) && aligned16(codes),
                dtype, bits, m, n, bm, bn, v, csize, held,
                (cudaStream_t)stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
