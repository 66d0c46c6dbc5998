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
// One launch over a small descriptor table of (pointer, offset, bytes) of
// at most 16 segments, passed by value: grid (chunks, n), block y copies
// segment y with a grid-stride loop over its bytes.  A payload of more
// segments (a DP gradient payload: three per parameter leaf) is framed by
// one launch per group of 16 into the same buffer (kernels/framing.py).  Bound on the card: bytes,
// each byte read once and written once (at the q8-tiled backward hop of a
// full-width gpt2-small microbatch, 786,816 B each way, 0.00047 ms at
// 3.35 TB/s: launch latency dominates at these sizes).  Where both ends of
// a segment are 16-byte aligned the copy moves 16 bytes a thread (uint4),
// where both are 4-byte aligned 4 bytes, else single bytes; the tail past
// the last whole vector goes byte by byte.  The reference's 4 MB VMEM
// guard (FRAME_MAX_BYTES) has no counterpart: the kernel streams through
// device memory and takes any size.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxParts = 16;
constexpr int kThreads = 256;

struct Table {
  unsigned char* seg[kMaxParts];  // the leaf side of each copy
  long long off[kMaxParts];       // byte offset in the hop buffer
  long long bytes[kMaxParts];
};

template <typename V>
__device__ __forceinline__ void copy_as(const unsigned char* src,
                                        unsigned char* dst, long long nb) {
  const long long nv = nb / (long long)sizeof(V);
  const V* s = (const V*)src;
  V* d = (V*)dst;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < nv; i += stride) d[i] = s[i];
  for (long long i = nv * (long long)sizeof(V) + first; i < nb; i += stride)
    dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
framing_kernel(Table t, unsigned char* buf, int to_buf) {
  const int p = blockIdx.y;
  const unsigned char* src = to_buf ? t.seg[p] : buf + t.off[p];
  unsigned char* dst = to_buf ? buf + t.off[p] : t.seg[p];
  const long long nb = t.bytes[p];
  const uintptr_t a = (uintptr_t)src | (uintptr_t)dst;
  if ((a & 15) == 0)
    copy_as<uint4>(src, dst, nb);
  else if ((a & 3) == 0)
    copy_as<unsigned>(src, dst, nb);
  else
    copy_as<unsigned char>(src, dst, nb);
}

int launch(void* buf, const long long* ptrs, const long long* offs,
           const long long* sizes, int n, int to_buf, cudaStream_t s) {
  if (n < 1 || n > kMaxParts) return (int)cudaErrorInvalidValue;
  Table t;
  long long most = 0;
  for (int p = 0; p < n; ++p) {
    t.seg[p] = (unsigned char*)ptrs[p];
    t.off[p] = offs[p];
    t.bytes[p] = sizes[p];
    most = sizes[p] > most ? sizes[p] : most;
  }
  long long chunks = (most + kThreads * 16 - 1) / (kThreads * 16);
  chunks = chunks < 1 ? 1 : (chunks > 1024 ? 1024 : chunks);
  framing_kernel<<<dim3((unsigned)chunks, (unsigned)n), kThreads, 0, s>>>(
      t, (unsigned char*)buf, to_buf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs[p]: the leaf segment p (uint8, sizes[p] bytes); offs[p]: its byte
// offset in buf.  The caller checks 1 <= n <= 16, that the segments tile
// buf without overlap and that no size is 0.  Returns cudaGetLastError()
// right after the launch.
int frame_parts_launch(void* buf, const long long* ptrs,
                       const long long* offs, const long long* sizes, int n,
                       void* stream) {
  return launch(buf, ptrs, offs, sizes, n, 1, (cudaStream_t)stream);
}

int unframe_parts_launch(const void* buf, const long long* ptrs,
                         const long long* offs, const long long* sizes, int n,
                         void* stream) {
  return launch((void*)buf, ptrs, offs, sizes, n, 0, (cudaStream_t)stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
