// Fused receive-side decode + sum of the data-parallel gradient ring, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dp_reduce.py::
// decode_sum_fused (_decode_sum_kernel).
//
// slots: (dp, row_bytes) uint8, the fused payload buffer of every source
// rank, in source-rank order.  For each parameter leaf l (the plan table)
// the q8 codes (one byte an element) or q4 codes (two a byte: the low
// nibble for an even element, the high nibble for an odd one) sit at
// [off, off + nbytes) of every row, and that source's per-tensor f32
// (min, scale) at meta_off.  out[out_off + i] = sum over s = 0..dp-1, in
// that order, of code_s(i) * scale_s + min_s.
//
// Bound on the card: bytes.  The function reads dp code bytes (q8) or dp
// half bytes (q4) per element and writes one f32: at dp = 4 on the q8
// payload of gpt2-small about 0.99 GB, 0.295 ms at 3.35 TB/s, for 2·dp
// float32 operations per element (the q4 payload 0.2213 ms).
//
// Design.  The Pallas kernel walks each leaf whole in VMEM under a 4 MB
// budget; here the bank streams from device memory and has no size limit.
// - Runs: each thread owns a run of 16 elements of one leaf (16 code
//   bytes under q8, 8 under q4) and, for up to kBatch sources at a time,
//   starts every source's 16-byte (q8) or 8-byte (q4) load before any
//   arithmetic, so dp vectors are in flight a thread (dp = 4: all).
// - Alignment: rows of the bank are row_bytes apart, and at gpt2-small
//   row_bytes = 8 (mod 16), so odd and even sources sit 8 bytes apart in
//   16-byte alignment (any offset in general: a leaf's codes start
//   anywhere).  Each source's run comes in as the aligned words that hold
//   it, realigned by a funnel shift (realign.cuh).  A warp's second words
//   are its first words shifted by one lane, so DRAM sees one pass and
//   L1 / L2 serve the repeat.  Chosen over staging the tile's dp spans
//   in shared memory by cp.async.bulk: bulk copies need 16-byte aligned
//   windows (the same realignment, moved into shared memory), and an
//   mbarrier ring buys little for a stream whose per-byte work is a few
//   ALU operations.
// - Stores: a lane's 16 results are 64 contiguous bytes, so stored from
//   the lane they would hit 16 lines a warp instruction, a quarter of
//   each (measured twice slower than one element a thread).  The warp's
//   32 runs are 512 consecutive outputs: each lane writes its run into a
//   padded staging row of shared memory, and the warp stores them back
//   as float4s, neighbouring lanes on neighbouring addresses, where the
//   leaf's out_off is a multiple of 4 (every gpt2-small leaf) and the
//   warp's runs are whole; else one by one.  A leaf's short last run is
//   read byte by byte.
// - Persistent blocks: a grid of as many blocks as fit on the card at
//   once walks the runs in tiles of kThreads runs, none crossing a leaf.
//   Each block reads the leaf table and all dp x leaves (min, scale)
//   pairs into shared memory once (meta_off has any alignment, so the
//   pairs are read byte by byte, once), and finds each tile's leaf by
//   walking the table forward: its tiles only increase.
//
// Bit-exactness with the plain PyTorch version, the port's unfused loop
// and every replica: a code becomes its float exactly (2^23 + code, less
// 2^23), the dequant is __fmul_rn then __fadd_rn (never an FMA),
// accumulated with __fadd_rn in source-rank order s = 0..dp-1, the first
// source's value taken as it is (so -0.0 stays -0.0).  Offsets and counts
// are int64 (the bank is 494 MB at dp = 4, q8).
#include <cuda_runtime.h>
#include <stdint.h>

#include "realign.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;            // elements a thread's run
constexpr int kRow = kRun + 4;      // staging row (padded: no bank conflict)
constexpr int kBatch = 4;           // sources whose loads fly together
constexpr int kCols = 6;            // kind, off, meta_off, n, out_off, tile0
constexpr int kMaxSmem = 232448;    // what a block can use on an H100

__device__ __forceinline__ float load_f32(const uint8_t* p) {
  const uint32_t u = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                     ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  return __uint_as_float(u);
}

// code (0..255) as a float, exactly: the bits of 2^23 + code, less 2^23.
__device__ __forceinline__ float code_f32(uint32_t code) {
  return __fsub_rn(__uint_as_float(0x4B000000u | code), 8388608.0f);
}

// Adds source s's dequantized run v (16 code bytes under q8, the 8 of
// v.x, v.y under q4: 16 codes either way) to acc, or starts it (s = 0).
template <bool Q4>
__device__ __forceinline__ void accumulate(const uint4 v, float2 m,
                                           bool first, float* acc) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < (Q4 ? 8 : 16); ++b) {
    const uint32_t byte = (w[b >> 2] >> (8 * (b & 3))) & 0xFFu;
#pragma unroll
    for (int h = 0; h < (Q4 ? 2 : 1); ++h) {
      const uint32_t code = Q4 ? (byte >> (4 * h)) & 0xFu : byte;
      const int e = Q4 ? 2 * b + h : b;
      const float d = __fadd_rn(__fmul_rn(code_f32(code), m.y), m.x);
      acc[e] = first ? d : __fadd_rn(acc[e], d);
    }
  }
}

// Run r of leaf L, summed over every source into acc: code bytes
// [off + B r, off + B r + B) of each row (B = 16 under q8, 8 under q4),
// elements [kRun r, kRun r + kRun) of the leaf.
template <bool Q4>
__device__ __forceinline__ void decode_run(const uint8_t* __restrict__ slots,
                                           long long row_bytes, int dp,
                                           const long long* L,
                                           const float2* meta, long long r,
                                           float* acc) {
  constexpr int B = Q4 ? 8 : 16;
  const long long n = L[3];
  const long long nbytes = Q4 ? (n + 1) / 2 : n;
  const int kb = nbytes - B * r < B ? (int)(nbytes - B * r) : B;
  const uint8_t* base = slots + L[1] + B * r;
  for (int s0 = 0; s0 < dp; s0 += kBatch) {
    uint4 lo[kBatch], hi[kBatch];
    unsigned dl[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {        // every load first
      lo[j] = hi[j] = make_uint4(0u, 0u, 0u, 0u);
      dl[j] = 0u;
      if (s0 + j >= dp) continue;
      const uint8_t* p = base + (long long)(s0 + j) * row_bytes;
      if (kb == B && Q4) {
        dl[j] = (unsigned)((uintptr_t)p & 7);
        const uint2* w = reinterpret_cast<const uint2*>(p - dl[j]);
        const uint2 a = __ldg(w);
        lo[j] = make_uint4(a.x, a.y, 0u, 0u);
        if (dl[j]) {
          const uint2 b = __ldg(w + 1);
          hi[j] = make_uint4(b.x, b.y, 0u, 0u);
        }
      } else if (kb == B) {
        dl[j] = (unsigned)((uintptr_t)p & 15);
        const uint4* w = reinterpret_cast<const uint4*>(p - dl[j]);
        lo[j] = __ldg(w);
        if (dl[j]) hi[j] = __ldg(w + 1);
      } else {                                // a leaf's short last run
        uint32_t u[4] = {0u, 0u, 0u, 0u};
        for (int b = 0; b < kb; ++b)
          u[b >> 2] |= (uint32_t)p[b] << (8 * (b & 3));
        lo[j] = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (s0 + j >= dp) continue;
      uint4 v;
      if (Q4) {
        const uint2 x = realign8(make_uint2(lo[j].x, lo[j].y),
                                 make_uint2(hi[j].x, hi[j].y), dl[j]);
        v = make_uint4(x.x, x.y, 0u, 0u);
      } else {
        v = realign16(lo[j], hi[j], dl[j]);
      }
      accumulate<Q4>(v, meta[s0 + j], s0 + j == 0, acc);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
decode_sum_kernel(const uint8_t* __restrict__ slots, long long row_bytes,
                  int dp, const long long* __restrict__ table, int leaves,
                  long long tiles, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);     // kThreads x kRow
  long long* tab = reinterpret_cast<long long*>(stage + kThreads * kRow);
  float2* meta = reinterpret_cast<float2*>(tab + leaves * kCols);
  for (int i = threadIdx.x; i < leaves * kCols; i += kThreads)
    tab[i] = table[i];
  __syncthreads();
  for (int i = threadIdx.x; i < leaves * dp; i += kThreads) {
    const int l = i / dp, s = i - l * dp;
    const uint8_t* p = slots + (long long)s * row_bytes + tab[l * kCols + 2];
    meta[i] = make_float2(load_f32(p), load_f32(p + 4));   // (min, scale)
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float* ws = stage + (threadIdx.x - lane) * kRow;   // this warp's rows
  int l = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    while (l + 1 < leaves && tab[(l + 1) * kCols + 5] <= t) ++l;
    const long long* L = tab + l * kCols;
    const long long n = L[3];
    const long long r = (t - L[5]) * kThreads + threadIdx.x;
    float acc[kRun] = {};
    if (r * kRun < n) {
      if (L[0])
        decode_run<true>(slots, row_bytes, dp, L, meta + l * dp, r, acc);
      else
        decode_run<false>(slots, row_bytes, dp, L, meta + l * dp, r, acc);
    }
    // the warp's 32 runs are 512 consecutive outputs: each lane's run goes
    // into its staging row, and back out as float4s that neighbouring
    // lanes store to neighbouring addresses
    __syncwarp();                  // the warp is done reading the last tile
    float4* row = reinterpret_cast<float4*>(ws + lane * kRow);
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q)
      row[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                           acc[4 * q + 3]);
    __syncwarp();
    const long long e0 = (r - lane) * kRun;   // the warp's first element
    float* o = out + L[4] + e0;
    const bool whole = (L[4] & 3) == 0 && e0 + 32 * kRun <= n;
#pragma unroll
    for (int k = 0; k < kRun / 4; ++k) {
      const int q = 32 * k + lane;            // float4 q of the warp's 128
      const float4 v = *reinterpret_cast<const float4*>(
          ws + (q >> 2) * kRow + 4 * (q & 3));
      if (whole) {
        reinterpret_cast<float4*>(o)[q] = v;
      } else {
        const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (e0 + 4 * q + i < n) o[4 * q + i] = f[i];
      }
    }
  }
}

}  // namespace

extern "C" {

// table: (leaves, 6) int64 in device memory, rows (kind 0 = q8 / 1 = q4,
// off, meta_off, n, out_off, first tile), first tiles ascending from 0, a
// tile kThreads runs of 16 elements (4096); tiles = the tile count of all
// leaves.  The caller checks the layout against row_bytes, 1 <= dp <=
// 4096, leaves >= 1 and that 20480 + leaves * (48 + 8 dp) bytes fit
// kMaxSmem.  Returns cudaGetLastError() right after the launch.
int decode_sum_launch(const void* slots, long long row_bytes, int dp,
                      const void* table, int leaves, long long tiles,
                      void* out, void* stream) {
  const long long smem = 4LL * kThreads * kRow +
                         (long long)leaves * (kCols * 8 + 8LL * dp);
  if (dp < 1 || dp > 4096 || leaves < 1 || tiles < 1 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(decode_sum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_sum_kernel, kThreads, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(tiles < cap ? tiles : cap);
  decode_sum_kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const uint8_t*)slots, row_bytes, dp, (const long long*)table, leaves,
      tiles, (float*)out);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
