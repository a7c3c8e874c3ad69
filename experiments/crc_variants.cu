// Variants of G1 (crc32c_chunks) for crc_variants.py: a copy of the
// library's loop (ceph_tpu_torch/csrc/crc32c.cu) with switches — runs of
// 16, 32 or 64 words a thread, 1, 2, 4 or 8 copies of the byte tables, a
// persistent grid that walks the segments (its next segment's loads in
// flight or not), and the loop with parts left out (its loads only, its
// chain without loads, no per-thread operator), which give no CRC.  Run
// 32 with 1 copy, one block a segment, is the library's kernel; the
// script holds every variant that computes the CRC to the library's
// digests.  Built by crc_variants.py, never by the library.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCrcThreads = 256;  // checksum.CRC_THREADS
constexpr int kTabEntries = 1024;  // 4 bytes x 256 values

// What a variant of the loop keeps: kFull computes the CRC; the others
// time one part of it and give no CRC.
enum Mode { kFull = 0, kLoadsOnly = 1, kNoLoads = 2, kNoLaneOp = 3 };

// A read-only load the compiler keeps where it is written: volatile asm
// stays in order, so all of a thread's K loads are in flight before its
// serial chain starts.
__device__ __forceinline__ uint32_t load_nc(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Column form of a 32x32 GF(2) operator: cols[j * stride] is the image
// of bit j (checksum._apply).
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* __restrict__ cols,
                                              int stride, uint32_t v) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) acc ^= cols[j * stride] & (0u - ((v >> j) & 1u));
  return acc;
}

// M^(4T) s: XOR over the 4 bytes of s of tab[byte][value], from this
// lane's copy (entry e of copy c at word e * kCopies + c).
template <int kCopies>
__device__ __forceinline__ uint32_t step(const uint32_t* mine, uint32_t s) {
  return mine[(0 * 256 + (s & 255u)) * kCopies] ^
         mine[(1 * 256 + ((s >> 8) & 255u)) * kCopies] ^
         mine[(2 * 256 + ((s >> 16) & 255u)) * kCopies] ^
         mine[(3 * 256 + (s >> 24)) * kCopies];
}

// This thread's words of segment b (zero in the zero prefix).
template <int kRun, int kMode>
__device__ __forceinline__ void load_run(uint32_t (&w)[kRun],
                                         const uint32_t* __restrict__ x,
                                         long long b, long long n_words,
                                         int k_words, int segs, int pad) {
  const long long q = b / segs;
  const int seg = static_cast<int>(b % segs);
  const uint32_t* src = x + q * n_words;
  // real index of this thread's first word (negative: the zero prefix)
  const long long first =
      static_cast<long long>(seg) * kCrcThreads * k_words + threadIdx.x - pad;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    const long long i = first + static_cast<long long>(u) * kCrcThreads;
    w[u] = 0u;
    if (kMode == kNoLoads)
      w[u] = static_cast<uint32_t>(i);
    else if (u < k_words && i >= 0)
      w[u] = load_nc(src + i);
  }
}

// Blocks walk segments b = blockIdx.x, blockIdx.x + gridDim.x, ... of
// kCrcThreads * k_words words (k_words <= kRun); at <32, 1, kFull, false>
// with one block a segment this is the library's kernel.  kPipe loads the
// next segment's words before the chain of this one.
template <int kRun, int kCopies, int kMode, bool kPipe = false>
__global__ void __launch_bounds__(kCrcThreads)
    crc32c_chunks_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                         const uint32_t* __restrict__ tabs,
                         const uint32_t* __restrict__ lane_ops,
                         const uint32_t* __restrict__ ladder, long long n_words,
                         int k_words, int segs, int pad, uint32_t final_xor,
                         long long n_segs) {
  __shared__ uint32_t tab[kTabEntries * kCopies];
  __shared__ uint32_t part[kCrcThreads / 32];
  const int t = threadIdx.x;
  for (int i = t; i < kTabEntries * kCopies; i += kCrcThreads)
    tab[i] = tabs[i / kCopies];
  const uint32_t* mine = tab + (t & (kCopies - 1));
  bool staged = false;
  uint32_t w[kRun];
  uint32_t next[kRun];
  if constexpr (kPipe) {
    if (blockIdx.x < n_segs)
      load_run<kRun, kMode>(w, x, blockIdx.x, n_words, k_words, segs, pad);
  }

  for (long long b = blockIdx.x; b < n_segs; b += gridDim.x) {
    const long long q = b / segs;  // chunk
    const int seg = static_cast<int>(b % segs);
    if constexpr (kPipe) {
      if (b + gridDim.x < n_segs)
        load_run<kRun, kMode>(next, x, b + gridDim.x, n_words, k_words,
                              segs, pad);
    } else {
      load_run<kRun, kMode>(w, x, b, n_words, k_words, segs, pad);
    }
    if (!staged) {
      __syncthreads();  // the tables are in place
      staged = true;
    }
    uint32_t s = 0;
#pragma unroll
    for (int u = 0; u < kRun; ++u)
      if (u < k_words)
        s = (kMode == kLoadsOnly ? s : step<kCopies>(mine, s)) ^ w[u];
    // this thread's share of the segment's raw CRC, then XOR over the
    // block
    uint32_t v = kMode == kNoLaneOp ? s : gf2_apply(lane_ops + t, kCrcThreads, s);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, d);
    if ((t & 31) == 0) part[t >> 5] = v;
    __syncthreads();
    if (t == 0) {
      uint32_t raw = 0;
#pragma unroll
      for (int i = 0; i < kCrcThreads / 32; ++i) raw ^= part[i];
      for (int d = segs - 1 - seg, j = 0; d; d >>= 1, ++j)
        if (d & 1) raw = gf2_apply(ladder + 32 * j, 1, raw);
      if (seg == 0) raw ^= final_xor;
      atomicXor(y + q, raw);
    }
    if (b + gridDim.x < n_segs) __syncthreads();  // part is read
    if constexpr (kPipe) {
#pragma unroll
      for (int u = 0; u < kRun; ++u) w[u] = next[u];
    }
  }
}

// Checks the split, zeroes y and launches crc32c_chunks_kernel on
// min(chunks * segs, max_blocks) blocks (max_blocks <= 0: one a segment).
template <int kRun, int kCopies, int kMode, bool kPipe = false>
cudaError_t launch_crc(const void* x, void* y, const void* tabs,
                       const void* lane_ops, const void* ladder,
                       long long chunks, long long n_words, int k_words,
                       int segs, int pad, unsigned int final_xor,
                       long long max_blocks, cudaStream_t stream) {
  if (chunks < 0 || n_words <= 0 || k_words < 1 || k_words > kRun ||
      segs < 1 || pad < 0 || pad >= kCrcThreads * k_words ||
      static_cast<long long>(segs) * kCrcThreads * k_words - pad != n_words ||
      chunks * segs > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (chunks == 0) return cudaSuccess;
  cudaError_t e = cudaMemsetAsync(y, 0, chunks * sizeof(uint32_t), stream);
  if (e != cudaSuccess) return e;
  const long long n_segs = chunks * segs;
  const long long blocks =
      max_blocks > 0 && max_blocks < n_segs ? max_blocks : n_segs;
  crc32c_chunks_kernel<kRun, kCopies, kMode, kPipe>
      <<<static_cast<unsigned>(blocks), kCrcThreads, 0, stream>>>(
          static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
          static_cast<const uint32_t*>(tabs),
          static_cast<const uint32_t*>(lane_ops),
          static_cast<const uint32_t*>(ladder), n_words, k_words, segs, pad,
          final_xor, n_segs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The arguments of crc32c_chunks, the variant (run 16, 32 or 64; copies
// 1, 2, 4 or 8; mode 0-3 of Mode; pipe 1: the next segment's loads before
// this one's chain) and the grid's block cap (<= 0: a block a segment).
int crc_variant(int run, int copies, int mode, int pipe, long long max_blocks,
                const void* x, void* y, const void* tabs,
                const void* lane_ops, const void* ladder, long long chunks,
                long long n_words, int k_words, int segs, int pad,
                unsigned int final_xor, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CRC_VARIANT(R, C, M, P)                                           \
  if (run == R && copies == C && mode == M && pipe == P)                  \
    return launch_crc<R, C, M, P>(x, y, tabs, lane_ops, ladder, chunks,   \
                                  n_words, k_words, segs, pad, final_xor, \
                                  max_blocks, s);
  CRC_VARIANT(16, 8, kFull, false)
  CRC_VARIANT(32, 8, kFull, false)
  CRC_VARIANT(64, 8, kFull, false)
  CRC_VARIANT(32, 4, kFull, false)
  CRC_VARIANT(32, 2, kFull, false)
  CRC_VARIANT(32, 1, kFull, false)
  CRC_VARIANT(32, 8, kFull, true)
  CRC_VARIANT(32, 2, kFull, true)
  CRC_VARIANT(32, 1, kFull, true)
  CRC_VARIANT(32, 8, kLoadsOnly, false)
  CRC_VARIANT(32, 8, kNoLoads, false)
  CRC_VARIANT(32, 8, kNoLaneOp, false)
#undef CRC_VARIANT
  return cudaErrorInvalidValue;
}

}  // extern "C"
