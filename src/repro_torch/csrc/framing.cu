// Payload framing for fused wire hops, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/framing.py::frame_parts
// (_frame_kernel) and ::unframe_parts (_unframe_kernel).
//
// frame  : n flat uint8 leaf segments -> one hop buffer, segment p at byte
//          offset off[p] (the concatenate, byte for byte).
// unframe: the inverse, segment p copied out of the buffer into its own
//          fresh allocation (so a later dtype view of it starts aligned).
//
// Bound on the card: bytes, each byte read once and written once (the
// q8-tiled backward hop of a full-width gpt2-small microbatch, 786,816 B
// each way, is 0.00047 ms at 3.35 TB/s; a DP gradient payload of
// gpt2-small, 123,570,536 B under q8, 0.0738 ms).
//
// Design.  One launch a call.  The segment table goes by value, in a
// capacity class of 4, 16, 64 or 240 segments (16 B an entry: the leaf
// pointer and the buffer offset; the next entry's offset gives the size),
// so the two-segment hop passes a parameter block of about 100 B and a
// 39-segment DP payload one of 1 KB, within the 4 KB kernel-parameter
// limit.  The work list is flat: block b copies the buffer bytes
// [b * chunk, (b + 1) * chunk), whichever segments they belong to, after
// a binary search of the offsets for its first segment; the grid is sized
// by the total bytes, so no block idles behind a small segment.  The
// chunk is 16 KB (a DP payload: thousands of blocks), halved down to 4 KB
// while that would leave SMs without two blocks: a copy spread over few
// SMs runs at their load-store paths' rate (the hop as 49 blocks of 16 KB
// measured slower than as 193 blocks of 4 KB, one vector a thread).
// Inside a block each piece (the part of one segment in the chunk) is
// copied with 16-byte stores: head bytes until the destination is 16-byte
// aligned, then each thread moves up to kUnroll vectors, all loads first,
// source bytes realigned from aligned 16-byte loads by a funnel shift
// wherever source and destination differ in alignment (every other leaf
// of a DP payload sits 8 bytes off), then the tail bytes.  The
// reference's 4 MB VMEM guard (FRAME_MAX_BYTES) has no counterpart: the
// kernel streams through device memory and takes any size.
#include <cuda_runtime.h>
#include <stdint.h>

#include "realign.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                          // vectors a thread
constexpr long long kChunk = 16LL * kThreads * kUnroll;   // 16 KB a block
constexpr long long kMinChunk = 16LL * kThreads;          // 4 KB
constexpr int kMaxParts = 240;

template <int C>
struct Table {
  unsigned char* seg[C];   // the leaf side of each copy
  long long off[C + 1];    // byte offsets in the buffer; off[n] its end
  int n;
};

// The block copies nb bytes from src to dst (any alignments, nb <= kChunk).
__device__ __forceinline__ void copy_piece(unsigned char* dst,
                                           const unsigned char* src,
                                           long long nb) {
  const int t = threadIdx.x;
  long long head = (long long)((16 - ((uintptr_t)dst & 15)) & 15);
  head = head < nb ? head : nb;
  const long long nvec = (nb - head) >> 4;
  const long long tail = head + (nvec << 4);
  if (t < head) dst[t] = src[t];
  if (t >= 32 && tail + (t - 32) < nb)
    dst[tail + t - 32] = src[tail + t - 32];
  const unsigned char* s = src + head;
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = t + (long long)u * kThreads;
    if (i < nvec) v[u] = load16(s + 16 * i);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = t + (long long)u * kThreads;
    if (i < nvec) d[i] = v[u];
  }
}

// __grid_constant__: the table is read where the launch put it; without
// it the compiler copies a small one to local memory to index it.
template <int C>
__global__ void __launch_bounds__(kThreads)
framing_kernel(const __grid_constant__ Table<C> t, unsigned char* buf,
               long long begin, long long chunk, int to_buf) {
  const long long lo = begin + (long long)blockIdx.x * chunk;
  const long long end = t.off[t.n];
  const long long hi = lo + chunk < end ? lo + chunk : end;
  int a = 0, b = t.n - 1;     // the last segment starting at or before lo
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (t.off[mid] <= lo) a = mid; else b = mid - 1;
  }
  for (int p = a; p < t.n && t.off[p] < hi; ++p) {
    const long long from = t.off[p] > lo ? t.off[p] : lo;
    const long long to = t.off[p + 1] < hi ? t.off[p + 1] : hi;
    unsigned char* leaf = t.seg[p] + (from - t.off[p]);
    if (to_buf)
      copy_piece(buf + from, leaf, to - from);
    else
      copy_piece(leaf, buf + from, to - from);
  }
}

template <int C>
int launch_class(void* buf, const long long* ptrs, const long long* offs,
                 int n, long long chunk, int to_buf, cudaStream_t s) {
  Table<C> t;
  for (int p = 0; p < n; ++p) {
    t.seg[p] = (unsigned char*)ptrs[p];
    t.off[p] = offs[p];
  }
  t.off[n] = offs[n];
  t.n = n;
  const long long blocks = (offs[n] - offs[0] + chunk - 1) / chunk;
  framing_kernel<C><<<(unsigned)blocks, kThreads, 0, s>>>(
      t, (unsigned char*)buf, offs[0], chunk, to_buf);
  return (int)cudaGetLastError();
}

// The chunk: kChunk, halved down to kMinChunk while the grid would not
// give every SM two blocks (a small payload spread over all SMs: one SM
// moves a small copy no faster than its own load-store path allows).
int launch(void* buf, const long long* ptrs, const long long* offs, int n,
           int to_buf, cudaStream_t s) {
  const long long total = offs[n] - offs[0];
  if (n < 1 || n > kMaxParts || total <= 0 ||
      (total + kMinChunk - 1) / kMinChunk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  long long chunk = kChunk;
  while (chunk > kMinChunk && (total + chunk - 1) / chunk < 2LL * sms)
    chunk /= 2;
  if (n <= 4) return launch_class<4>(buf, ptrs, offs, n, chunk, to_buf, s);
  if (n <= 16) return launch_class<16>(buf, ptrs, offs, n, chunk, to_buf, s);
  if (n <= 64) return launch_class<64>(buf, ptrs, offs, n, chunk, to_buf, s);
  return launch_class<kMaxParts>(buf, ptrs, offs, n, chunk, to_buf, s);
}

}  // namespace

extern "C" {

// ptrs[p]: the leaf segment p (uint8, offs[p + 1] - offs[p] bytes); offs:
// n + 1 ascending byte offsets in buf.  The caller checks 1 <= n <= 240,
// that the segments tile buf without overlap and that none is empty.
// Returns cudaGetLastError() right after the launch.
int frame_parts_launch(void* buf, const long long* ptrs,
                       const long long* offs, int n, void* stream) {
  return launch(buf, ptrs, offs, n, 1, (cudaStream_t)stream);
}

int unframe_parts_launch(const void* buf, const long long* ptrs,
                         const long long* offs, int n, void* stream) {
  return launch((void*)buf, ptrs, offs, n, 0, (cudaStream_t)stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
