// Exact per-row TopK select for Hopper (sm_90a): threshold + compaction,
// many blocks a row.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_select.py::
// topk_threshold (_threshold_kernel) and the XLA epilogue of
// ::topk_select_wire, which the TPU left to XLA only because Mosaic has no
// per-lane scatter.
//
// Bound on the card: memory bytes.  The function reads its row once and
// writes k values and indices; per element it needs a few integer
// compares.  The rows run from (4, 768) at serving decode to one
// (1, 38,597,376) f32 gradient leaf in the data-parallel TopK reduce, so
// one block a row would leave most of the 132 SMs idle.  Every kernel
// here cuts each row into C chunks in index order (the host plans C, see
// kernels/topk_select.py::select_grid) and runs a (C * M)-block grid.
//
// topk_threshold: a radix select over the 31 magnitude bits (the value's
//   bits with the sign cleared: non-negative floats order like their
//   bits, -0.0 -> 0, NaN above inf).  Digit passes of 11, 10 and 10 bits
//   from bit 30 down (bf16 needs two: its bits 15..0 are zero).  In pass p
//   each block builds a shared-memory histogram of the digit over the
//   elements whose higher bits equal the prefix found so far, and adds
//   its nonzero bins to the row's histogram in global scratch with integer
//   atomics.  The last block of the row to finish (an atomic ticket after
//   __threadfence) scans the bins from the top for the digit that holds
//   the k-th largest, stores the longer prefix and the rank left within
//   it, and zeroes the histogram and the ticket for the next pass.  One
//   launch a pass; nothing returns to the host.  Integer counts do not
//   depend on the order of the atomics, so the result is the bisection's
//   bit pattern exactly: the largest t with count(bits >= t) >= k.  Pass
//   p reads the row again (from L2 when it fits), except that in f32 pass
//   1 also keeps its candidates (the elements of pass 0's bin, when that
//   bin holds at most an eighth of the row): each block gathers a tile's
//   in shared memory and appends them at the row's one atomic cursor, into
//   a scratch row of n / 8 ints, and pass 2 splits the row's candidates
//   evenly over its blocks and reads only those: a 154 MB leaf is read
//   twice, not three times.  A row of one chunk runs every pass in one
//   block, in one launch, without scratch.
// topk_compact: a chunked, stable stream compaction over the same grid.
//   A count launch writes each chunk's (count above the threshold, count
//   equal to it); the write launch sums the counts of the chunks before
//   its own (and of the row: the tie quota is k - sum(above)), skips a
//   chunk that keeps nothing, and walks its chunk in tiles of 8 elements
//   a thread with one block-wide exclusive scan a tile (the next tile's
//   loads issued before it), writing the kept entries (all above, then
//   ties lowest index first: lax.top_k's rule) in ascending index order.
//   A row of one chunk counts and writes in one launch, and a row of one
//   tile reads its elements once.
//
// Loads are aligned 16-byte vectors (4 f32 / 8 bf16) over the aligned
// range that covers a chunk.  A vector that reaches outside the chunk (its
// first or last, for an odd n or a misaligned row start) is read element
// by element, its in-chunk elements only: no load leaves the tensor.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBins = 2048;          // pass 0's digit: bits 30..20
constexpr int kMaxPer = kMaxBins / kThreads;
// per row of threshold scratch: the histogram, then ticket, prefix, rank,
// whether pass 1 keeps its candidates for pass 2, and their count
constexpr int kTicket = kMaxBins, kPrefix = kMaxBins + 1,
              kRank = kMaxBins + 2, kKeep = kMaxBins + 3,
              kCursor = kMaxBins + 4, kState = kMaxBins + 5;
constexpr int kUnroll = 4;              // 16-byte loads in flight a thread
constexpr int kWalk = 8;                // elements a thread per walk tile

// Raw element bits from aligned 16-byte loads, and their magnitude bits.
template <typename T>
struct Elems;

template <>
struct Elems<float> {
  static constexpr int kPerVec = 4;
  static __device__ void load(const float* p, unsigned* r) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  }
  static __device__ unsigned load_one(const float* p) {
    return __float_as_uint(__ldg(p));
  }
  static __device__ int mag(unsigned r) { return (int)(r & 0x7fffffffu); }
  static __device__ float value(unsigned r) { return __uint_as_float(r); }
};

template <>
struct Elems<__nv_bfloat16> {
  static constexpr int kPerVec = 8;
  static __device__ void load(const __nv_bfloat16* p, unsigned* r) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[2 * i] = w[i] & 0xffffu;
      r[2 * i + 1] = w[i] >> 16;
    }
  }
  static __device__ unsigned load_one(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ int mag(unsigned r) {
    return (int)((r << 16) & 0x7fffffffu);
  }
  static __device__ __nv_bfloat16 value(unsigned r) {
    return __ushort_as_bfloat16((unsigned short)r);
  }
};

// Elements [lo, lo + len) of x as whole aligned vectors: vector j holds
// elements lo - head + j * kPerVec ...; an element is in range when its
// position pos = j * kPerVec + e - head lies in [0, len).
template <typename T>
struct Span {
  const T* a;           // 16-byte aligned
  long long head, len, nvec;
  __device__ Span(const T* x, long long lo, long long n_) : len(n_) {
    const T* p = x + lo;
    a = reinterpret_cast<const T*>(reinterpret_cast<uintptr_t>(p) &
                                   ~(uintptr_t)15);
    head = p - a;
    nvec = (head + len + Elems<T>::kPerVec - 1) / Elems<T>::kPerVec;
  }
  // position of vector j's first element
  __device__ long long pos(long long j) const {
    return j * Elems<T>::kPerVec - head;
  }
  __device__ bool whole(long long p0) const {
    return p0 >= 0 && p0 + Elems<T>::kPerVec <= len;
  }
  __device__ bool in(long long p) const { return p >= 0 && p < len; }
  // Vector j's raw element bits: one 16-byte load where the vector lies in
  // the span, else a scalar load of each of its elements in the span (0
  // for the others).
  __device__ void load(long long j, unsigned* r) const {
    using E = Elems<T>;
    const long long p0 = pos(j);
    if (whole(p0)) {
      E::load(a + j * E::kPerVec, r);
      return;
    }
#pragma unroll
    for (int e = 0; e < E::kPerVec; ++e)
      r[e] = in(p0 + e) ? E::load_one(a + j * E::kPerVec + e) : 0u;
  }
};

// Calls f(mag_bits) for every element of the span, kUnroll coalesced
// vector loads in flight a thread, and tile_done() in every thread after
// each tile of kThreads * kUnroll vectors.
template <typename T, typename F, typename G>
__device__ __forceinline__ void for_each_mag(const Span<T>& s, F f,
                                             G tile_done) {
  using E = Elems<T>;
  constexpr int V = E::kPerVec;
  for (long long t0 = 0; t0 < s.nvec; t0 += (long long)kThreads * kUnroll) {
    const long long j0 = t0 + threadIdx.x;
    unsigned r[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + (long long)u * kThreads;
      if (j < s.nvec) s.load(j, r[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + (long long)u * kThreads;
      const long long p0 = s.pos(j);
      if (j < s.nvec && s.whole(p0)) {
#pragma unroll
        for (int e = 0; e < V; ++e) f(E::mag(r[u][e]));
      } else if (j < s.nvec) {            // a chunk's first or last vector
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (s.in(p0 + e)) f(E::mag(r[u][e]));
      }
    }
    tile_done();
  }
}

template <typename T, typename F>
__device__ __forceinline__ void for_each_mag(const Span<T>& s, F f) {
  for_each_mag(s, f, [] {});
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

// Pass p's digit: bits [shift, shift + width) of the magnitude.
__device__ __forceinline__ int pass_shift(int p) { return p == 0 ? 20 : 20 - 10 * p; }
__device__ __forceinline__ int pass_width(int p) { return p == 0 ? 11 : 10; }

// Adds to the shared hist the digit of pass p of every element of s whose
// bits above the digit equal prefix.
template <typename T>
__device__ void histogram(const Span<T>& s, int p, int prefix, int* hist) {
  const int shift = pass_shift(p), above = shift + pass_width(p);
  const int mask = (1 << pass_width(p)) - 1;
  for_each_mag(s, [&](int b) {
    if ((b >> above) == prefix) atomicAdd(hist + ((b >> shift) & mask), 1);
  });
}

// Thread t holds c[j] = count of bin top - 1 - j (j < per), top = bins -
// per * t: thread 0 the highest bins.  Returns the digit d with
// count(digit > d) < rank <= count(digit >= d), rank - count(digit > d)
// and the count of bin d.  ws: kWarps + 4.
__device__ int3 pick_digit(const int (&c)[kMaxPer], int per, int top,
                           int rank, int* ws) {
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j)
    if (j < per) sum += c[j];
  int total;
  int above = block_exclusive_scan(sum, &total, ws);
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    if (j < per) {
      if (above < rank && rank <= above + c[j]) {
        ws[kWarps + 1] = top - 1 - j;
        ws[kWarps + 2] = rank - above;
        ws[kWarps + 3] = c[j];
      }
      above += c[j];
    }
  }
  __syncthreads();
  const int3 r = make_int3(ws[kWarps + 1], ws[kWarps + 2], ws[kWarps + 3]);
  __syncthreads();
  return r;
}

// A row of one chunk: every pass in this block, the histogram in shared
// memory only.
template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_threshold_row_kernel(const T* __restrict__ x, float* __restrict__ thresh,
                          long long n, int k, int passes) {
  __shared__ int hist[kMaxBins];
  __shared__ int ws[kWarps + 4];
  const long long row = blockIdx.x;
  const Span<T> s(x, row * n, n);
  int prefix = 0, rank = k;
  for (int p = 0; p < passes; ++p) {
    const int bins = 1 << pass_width(p), per = bins / kThreads;
    for (int b = threadIdx.x; b < bins; b += kThreads) hist[b] = 0;
    __syncthreads();
    histogram(s, p, prefix, hist);
    __syncthreads();
    const int top = bins - per * threadIdx.x;
    int c[kMaxPer];
#pragma unroll
    for (int j = 0; j < kMaxPer; ++j) c[j] = j < per ? hist[top - 1 - j] : 0;
    const int3 d = pick_digit(c, per, top, rank, ws);
    prefix = (prefix << pass_width(p)) | d.x;
    rank = d.y;
  }
  if (threadIdx.x == 0)
    thresh[row] = __int_as_float(prefix << pass_shift(passes - 1));
}

// One pass over chunk blockIdx.x % chunks of row blockIdx.x / chunks.
// state: per row kState ints, zero before pass 0.  cand (m * (n / 8)
// ints, or null): in 3-pass rows, when pass 0 found at most an eighth of
// the row in its bin, pass 1 also appends its candidates' bits to the
// row's part of cand, in any order, and pass 2 reads only those.
template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_threshold_pass_kernel(const T* __restrict__ x, int* __restrict__ state,
                           int* __restrict__ cand, float* __restrict__ thresh,
                           long long n, int k, long long chunk, int chunks,
                           int p, int passes) {
  constexpr int kTileElems = kThreads * kUnroll * Elems<T>::kPerVec;
  __shared__ int hist[kMaxBins];
  __shared__ int ws[kWarps + 4];
  // a tile's candidates (f32 only: bf16 keeps none)
  __shared__ int tile[sizeof(T) == 4 ? kTileElems : 1];
  __shared__ int ntile, base, ncopy;
  __shared__ bool last;
  const long long row = blockIdx.x / chunks;
  const int ci = blockIdx.x % chunks;       // the chunk
  const long long lo = ci * chunk;
  int* st = state + row * kState;
  const int bins = 1 << pass_width(p), per = bins / kThreads;
  const int prefix = p ? st[kPrefix] : 0;   // the previous launch's
  const bool use_cand = sizeof(T) == 4 && cand != nullptr && p && st[kKeep];
  int* const cr = use_cand ? cand + row * (n / 8) : nullptr;
  for (int b = threadIdx.x; b < bins; b += kThreads) hist[b] = 0;
  if (threadIdx.x == 0) ntile = 0;
  __syncthreads();
  const Span<T> s(x, row * n + lo, min(chunk, n - lo));
  if (use_cand && p == 1) {             // bits 30..20 == prefix: keep them
    for_each_mag(
        s,
        [&](int b) {
          if ((b >> 20) == prefix) {
            atomicAdd(hist + ((b >> 10) & 1023), 1);
            tile[atomicAdd(&ntile, 1)] = b;
          }
        },
        [&] {                           // append the tile's at the cursor
          __syncthreads();
          if (threadIdx.x == 0) {
            ncopy = ntile;
            ntile = 0;
            if (ncopy) base = atomicAdd(st + kCursor, ncopy);
          }
          __syncthreads();
          for (int i = threadIdx.x; i < ncopy; i += kThreads)
            cr[base + i] = tile[i];
          __syncthreads();
        });
  } else if (use_cand) {                // pass 2: this block's share
    const long long total = st[kCursor];
    const long long b1 = total * (ci + 1) / chunks;
    for (long long i = total * ci / chunks + threadIdx.x; i < b1;
         i += kThreads) {
      const int b = cr[i];
      if ((b >> 10) == prefix) atomicAdd(hist + (b & 1023), 1);
    }
  } else {
    histogram(s, p, prefix, hist);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kThreads)
    if (hist[b]) atomicAdd(st + b, hist[b]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(st + kTicket, 1) == chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int top = bins - per * threadIdx.x;
  int c[kMaxPer];
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j)
    c[j] = j < per ? __ldcg(st + top - 1 - j) : 0;
  const int3 d = pick_digit(c, per, top, p ? __ldcg(st + kRank) : k, ws);
  for (int b = threadIdx.x; b < bins; b += kThreads) st[b] = 0;
  if (threadIdx.x == 0) {
    const int next = (prefix << pass_width(p)) | d.x;
    st[kTicket] = 0;
    st[kPrefix] = next;
    st[kRank] = d.y;
    if (p == 0) st[kKeep] = d.z <= n / 8;
    if (p == passes - 1) thresh[row] = __int_as_float(next << pass_shift(p));
  }
}

// (count above tb, count equal to tb) over the span, block-wide.
template <typename T>
__device__ int2 count_chunk(const Span<T>& s, int tb, int* ws) {
  int gt = 0, eq = 0;
  for_each_mag(s, [&](int b) {
    gt += b > tb;
    eq += b == tb;
  });
  gt = block_sum(gt, ws);
  eq = block_sum(eq, ws);
  return make_int2(gt, eq);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_compact_count_kernel(const T* __restrict__ x,
                          const float* __restrict__ thresh,
                          int2* __restrict__ counts, long long n,
                          long long chunk, int chunks) {
  __shared__ int ws[kWarps + 1];
  const long long row = blockIdx.x / chunks;
  const long long lo = (blockIdx.x % chunks) * chunk;
  const int2 c = count_chunk(Span<T>(x, row * n + lo, min(chunk, n - lo)),
                             __float_as_int(thresh[row]), ws);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// Writes the kept entries of chunk blockIdx.x % chunks.  counts: the count
// launch's (above, equal) per chunk, or null for one chunk a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_compact_write_kernel(const T* __restrict__ x,
                          const float* __restrict__ thresh,
                          const int2* __restrict__ counts,
                          T* __restrict__ vals, int* __restrict__ idx,
                          long long n, int k, long long chunk, int chunks) {
  using E = Elems<T>;
  constexpr int V = E::kPerVec, kVecs = kWalk / V;
  __shared__ int ws[kWarps + 1];
  const long long row = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const long long lo = c * chunk;
  const Span<T> s(x, row * n + lo, min(chunk, n - lo));
  const int tb = __float_as_int(thresh[row]);

  // A row of one tile takes its counts from the tile's own scan below.
  const bool one_tile = counts == nullptr && s.nvec <= kThreads * kVecs;
  int gt_all = 0, gt_before = 0, eq_before = 0;  // the row, earlier chunks
  int2 own = make_int2(0, 0);
  if (counts == nullptr && !one_tile) {
    own = count_chunk(s, tb, ws);
    gt_all = own.x;
  } else if (counts != nullptr) {
    const int2* rc = counts + row * chunks;
    int a = 0, g = 0, q = 0;
    for (int i = threadIdx.x; i < chunks; i += kThreads) {
      const int2 v = rc[i];
      a += v.x;
      if (i < c) {
        g += v.x;
        q += v.y;
      }
    }
    gt_all = block_sum(a, ws);
    gt_before = block_sum(g, ws);
    eq_before = block_sum(q, ws);
    own = rc[c];
  }
  const int quota = k - gt_all;         // ties kept in the row
  int ties = quota - eq_before;         // ties this chunk may still keep
  int keep = one_tile ? k : own.x + min(max(ties, 0), own.y);
  if (keep == 0) return;
  const long long first = gt_before + min(max(quota, 0), eq_before);
  T* vr = vals + row * k;
  int* ir = idx + row * k;

  // Tile t0 is thread-ordered: thread i takes vectors t0 + i * kVecs ...
  // The next tile's loads are issued before this tile's scan.
  constexpr long long kTile = (long long)kThreads * kVecs;
  unsigned r[kWalk], next[kWalk];
  const auto load = [&](long long v0, unsigned* dst) {
#pragma unroll
    for (int u = 0; u < kVecs; ++u)
      if (v0 + u < s.nvec) s.load(v0 + u, dst + u * V);
  };
  load((long long)threadIdx.x * kVecs, next);
  int kept = 0;                         // in this chunk, block-uniform
  for (long long t0 = 0; t0 < s.nvec && kept < keep; t0 += kTile) {
    const long long v0 = t0 + (long long)threadIdx.x * kVecs;
#pragma unroll
    for (int e = 0; e < kWalk; ++e) r[e] = next[e];
    if (t0 + kTile < s.nvec) load(v0 + kTile, next);
    const long long p0 = s.pos(v0);     // of this thread's first element
    bool in[kWalk];
#pragma unroll
    for (int e = 0; e < kWalk; ++e)
      in[e] = s.in(p0 + e);               // false past the last vector
    int g = 0, q = 0;
#pragma unroll
    for (int e = 0; e < kWalk; ++e) {
      const int b = E::mag(r[e]);
      g += in[e] && b > tb;
      q += in[e] && b == tb;
    }
    int total;
    const int ex = block_exclusive_scan(g | (q << 16), &total, ws);
    const int g_ex = ex & 0xffff, q_ex = ex >> 16;
    if (one_tile) ties = k - (total & 0xffff);
    long long slot = first + kept + g_ex + min(max(ties, 0), q_ex);
    int tie = q_ex;
    if (g | q) {
#pragma unroll
      for (int e = 0; e < kWalk; ++e) {
        if (in[e]) {
          const int b = E::mag(r[e]);
          bool take = b > tb;
          if (b == tb) take = tie++ < ties;
          if (take && slot < k) {
            ir[slot] = (int)(lo + p0 + e);
            vr[slot] = E::value(r[e]);
          }
          slot += take;
        }
      }
    }
    kept += (total & 0xffff) + min(max(ties, 0), total >> 16);
    ties -= total >> 16;
  }
}

template <typename T>
int launch_threshold(const void* x, void* thresh, void* state, void* cand,
                     long long m, long long n, long long k,
                     long long chunk, long long chunks, cudaStream_t s) {
  const int passes = sizeof(T) == 2 ? 2 : 3;
  if (chunks == 1) {
    topk_threshold_row_kernel<T><<<(unsigned)m, kThreads, 0, s>>>(
        (const T*)x, (float*)thresh, n, (int)k, passes);
    return (int)cudaGetLastError();
  }
  for (int p = 0; p < passes; ++p) {
    topk_threshold_pass_kernel<T><<<(unsigned)(m * chunks), kThreads, 0,
                                     s>>>(
        (const T*)x, (int*)state, (int*)cand, (float*)thresh, n, (int)k,
        chunk, (int)chunks, p, passes);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
int launch_compact(const void* x, const void* thresh, void* counts,
                   void* vals, void* idx, long long m, long long n,
                   long long k, long long chunk, long long chunks,
                   cudaStream_t s) {
  const unsigned grid = (unsigned)(m * chunks);
  if (chunks > 1) {
    topk_compact_count_kernel<T><<<grid, kThreads, 0, s>>>(
        (const T*)x, (const float*)thresh, (int2*)counts, n, chunk,
        (int)chunks);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  topk_compact_write_kernel<T><<<grid, kThreads, 0, s>>>(
      (const T*)x, (const float*)thresh,
      chunks > 1 ? (const int2*)counts : nullptr, (T*)vals, (int*)idx, n,
      (int)k, chunk, (int)chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Ints of threshold scratch a row needs when it has more than one chunk.
int topk_select_state_ints() { return kState; }

// dtype: 0 = float32, 1 = bfloat16.  Rows of n elements cut into `chunks`
// chunks of `chunk` elements (the last shorter, none empty).  For more than
// one chunk a row: state, m * topk_select_state_ints() zeroed int32;
// cand, m * (n / 8) int32, for float32 (null for bfloat16, whose two
// passes keep no candidates); counts, m * chunks * 2 int32.  All are unused for one chunk a row.  Return cudaGetLastError()
// after the launches (the first failing one), or cudaErrorInvalidValue
// for an unknown dtype.  The caller checks 1 <= k <= n < 2**31, m >= 1
// and the chunking.
int topk_threshold_launch(const void* x, void* thresh, void* state,
                          void* cand, int dtype, long long m, long long n,
                          long long k, long long chunk, long long chunks,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_threshold<float>(x, thresh, state, cand, m, n, k, chunk,
                                     chunks, s);
    case 1:
      return launch_threshold<__nv_bfloat16>(x, thresh, state, nullptr, m, n,
                                             k, chunk, chunks, s);
  }
  return (int)cudaErrorInvalidValue;
}

int topk_compact_launch(const void* x, const void* thresh, void* counts,
                        void* vals, void* idx, int dtype, long long m,
                        long long n, long long k, long long chunk,
                        long long chunks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_compact<float>(x, thresh, counts, vals, idx, m, n, k,
                                   chunk, chunks, s);
    case 1:
      return launch_compact<__nv_bfloat16>(x, thresh, counts, vals, idx, m,
                                           n, k, chunk, chunks, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
