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
// Design.  The Pallas kernel walks each leaf whole in VMEM under a 4 MB
// budget; here the bank streams from device memory and has no size limit.
// The leaves are very uneven (38.6 M elements against 768 at gpt2-small),
// so the element space of all leaves is cut into tiles of kTile elements,
// none crossing a leaf, and a grid-stride loop over the tiles balances
// them: a block finds its tile's leaf by a binary search over the tiles'
// prefix table (uploaded once per plan tuple by the wrapper), reads the dp
// (min, scale) pairs of that leaf into shared memory byte by byte (meta_off
// has any alignment), and each thread owns elements of the tile.
//
// Bound on the card: bytes.  The function reads dp code bytes (q8) or dp
// half bytes (q4) per element and writes one f32: at dp = 4 on the q8
// payload of gpt2-small about 0.99 GB, 0.295 ms at 3.35 TB/s, for 2·dp
// float32 operations per element.  This first version loads one byte a
// thread per source (coalesced across the warp); wider loads are later
// work.
//
// Bit-exactness with the plain PyTorch version, the port's unfused loop
// and every replica: the dequant is __fmul_rn then __fadd_rn (never an
// FMA), accumulated with __fadd_rn in source-rank order s = 0..dp-1.
// Offsets and counts are int64 (the bank is 494 MB at dp = 4, q8).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kTile = 8192;   // elements per tile, 32 per thread
constexpr int kCols = 6;            // kind, off, meta_off, n, out_off, tile0

__device__ __forceinline__ float load_f32(const uint8_t* p) {
  const uint32_t u = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                     ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  return __uint_as_float(u);
}

__global__ void __launch_bounds__(kThreads)
decode_sum_kernel(const uint8_t* __restrict__ slots, long long row_bytes,
                  int dp, const long long* __restrict__ table, int leaves,
                  long long tiles, float* __restrict__ out) {
  extern __shared__ float meta[];   // (min, scale) of each source
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    int lo = 0, hi = leaves - 1;    // the last leaf whose first tile <= t
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[mid * kCols + 5] <= t) lo = mid; else hi = mid - 1;
    }
    const long long* e = table + lo * kCols;
    const long long kind = e[0], off = e[1], meta_off = e[2], n = e[3];
    const long long out_off = e[4];
    __syncthreads();                // the previous tile is done with meta
    for (int j = threadIdx.x; j < 2 * dp; j += blockDim.x)
      meta[j] = load_f32(slots + (long long)(j >> 1) * row_bytes + meta_off +
                         4 * (j & 1));
    __syncthreads();
    const long long first = (t - e[5]) * kTile;
    const long long last = first + kTile < n ? first + kTile : n;
    for (long long i = first + threadIdx.x; i < last; i += blockDim.x) {
      const long long byte = kind ? off + (i >> 1) : off + i;
      const int shift = kind ? (int)(i & 1) * 4 : 0;
      const unsigned mask = kind ? 0xFu : 0xFFu;
      float acc = 0.0f;
      for (int s = 0; s < dp; ++s) {
        const unsigned code = (slots[(long long)s * row_bytes + byte] >>
                               shift) & mask;
        const float d = __fadd_rn(__fmul_rn((float)code, meta[2 * s + 1]),
                                  meta[2 * s]);
        acc = s == 0 ? d : __fadd_rn(acc, d);
      }
      out[out_off + i] = acc;
    }
  }
}

}  // namespace

extern "C" {

// table: (leaves, 6) int64 in device memory, rows (kind 0 = q8 / 1 = q4,
// off, meta_off, n, out_off, first tile), first tiles ascending from 0;
// tiles = the tile count of all leaves.  The caller checks the layout
// against row_bytes, 1 <= dp <= 4096 and leaves >= 1.  Returns
// cudaGetLastError() right after the launch.
int decode_sum_launch(const void* slots, long long row_bytes, int dp,
                      const void* table, int leaves, long long tiles,
                      void* out, void* stream) {
  if (dp < 1 || dp > 4096 || leaves < 1 || tiles < 1)
    return (int)cudaErrorInvalidValue;
  const long long cap = 132LL * 16;  // 16 blocks per SM, then grid-stride
  const unsigned grid = (unsigned)(tiles < cap ? tiles : cap);
  decode_sum_kernel<<<grid, kThreads, 2 * dp * sizeof(float),
                      (cudaStream_t)stream>>>(
      (const uint8_t*)slots, row_bytes, dp, (const long long*)table, leaves,
      tiles, (float*)out);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
