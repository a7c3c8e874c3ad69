// G1: standard CRC32C of fixed-length chunks on Hopper (sm_90a).
//
// crc32c_chunks replaces the JAX package's device CRC, which is an XLA
// graph rather than a Pallas kernel: ceph_tpu/ops/checksum.py
// CrcPlan.device_fn, a leaf map of 32 masked constants per word and a
// balanced tree of zero-extension operators.  As plain PyTorch that tree
// is some 600 elementwise passes over a 1 MiB chunk; here each word costs
// four table lookups.  Wrapped by ceph_tpu_torch/ops/checksum.py
// crc32c_chunks, which builds every table below on the host
// (checksum.kernel_tables) and checks shapes, dtype and alignment.
//
// Math.  The raw (init 0, no final xor) CRC is GF(2)-linear, and
// processing one 4-byte word w from state c gives M^4 (c ^ w), where M^n is
// the operator that appends n zero bytes (checksum._zero_operator).  For a
// run of N words, raw = XOR_i M^(4 (N - i)) w_i.
//
// Split.  A chunk of n_words words is cut into `segs` segments of
// T * K words (T = kCrcThreads threads a block, K = k_words words a
// thread, checksum.kernel_split), after a zero prefix of `pad` words that
// makes the chunk whole segments; leading zeros add nothing to a raw CRC,
// so the prefix changes no result.  One block takes one segment.  Thread t
// takes the words t, t + T, t + 2T, ... of it, so every load of a warp
// reads 128 contiguous bytes, and keeps the state s <- M^(4T) s ^ w.  After
// its K words, s = XOR_k M^(4T (K - 1 - k)) w_(t + Tk), and the segment's
// raw CRC is XOR_t M^(4 (T - t)) s_t: one operator per thread (lane_ops),
// then a plain XOR across the block.  Thread 0 shifts the segment's raw
// CRC past the segments after it, M^(4 T K (segs - 1 - seg)), by the
// binary ladder M^(4 T K 2^j) (ladder), and XORs it into the chunk's
// output, which the C entry zeroed first; segment 0 also XORs the affine
// constant final_xor (CrcPlan.final_xor) that turns the raw CRC into the
// standard one.  The XORs commute, so the blocks of a chunk need no order.
//
// Lookups.  M^(4T) s is computed a byte at a time: XOR over the 4 bytes n
// of s of tab[n][byte], 1024 entries (4 KiB), staged once per block in
// shared memory.  Random lookups by 32 lanes collide in the banks about
// 3.5 ways; copies of the table that spread the lanes over the banks cost
// more to stage than they save (below).
//
// What bounds it: the bytes it reads, once each (rows * chunks * n_words *
// 4; 88 MiB for the fused CRC of a 64-stripe k=8, m=3 batch, ~27.5 us at
// 3.35 TB/s); a device copy moving as many bytes takes ~36 us on an H100
// SXM at 700 W.  Its instructions come close: per word 4 lookups, their
// byte extracts and 2 three-input XORs, and per thread the 32 masked XORs
// of its operator.  On that card, at (11, 8 MiB) in 128 KiB chunks: 16
// words a thread on nibble tables (8 lookups a word, a copy per lane, no
// bank conflicts) took ~100 us; byte tables in 8 copies ~80 us, and ~62 us
// at 32 words a thread; 4, 2 and 1 copies ~60, ~59 and ~57 us; 64 words, a
// persistent grid, or the next segment's loads in flight during the chain
// were no faster.  Its loads alone take ~38 us and its chain alone ~44 us;
// together they overlap only in part (experiments/crc_variants.cu times a
// copy of this loop with those switches).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCrcThreads = 256;   // checksum.CRC_THREADS
constexpr int kCrcMaxRun = 32;     // checksum.CRC_MAX_RUN: K <= 32
constexpr int kTabEntries = 1024;  // 4 bytes x 256 values

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

// M^(4T) s: XOR over the 4 bytes of s of tab[byte][value].
__device__ __forceinline__ uint32_t step(const uint32_t* tab, uint32_t s) {
  return tab[s & 255u] ^ tab[256 + ((s >> 8) & 255u)] ^
         tab[512 + ((s >> 16) & 255u)] ^ tab[768 + (s >> 24)];
}

// One block a segment of kCrcThreads * k_words words (k_words <=
// kCrcMaxRun); segment b is segment b % segs of chunk b / segs.
__global__ void __launch_bounds__(kCrcThreads)
    crc32c_chunks_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                         const uint32_t* __restrict__ tabs,
                         const uint32_t* __restrict__ lane_ops,
                         const uint32_t* __restrict__ ladder, long long n_words,
                         int k_words, int segs, int pad, uint32_t final_xor) {
  __shared__ uint32_t tab[kTabEntries];
  __shared__ uint32_t part[kCrcThreads / 32];
  const int t = threadIdx.x;
  for (int i = t; i < kTabEntries; i += kCrcThreads) tab[i] = tabs[i];
  const long long q = blockIdx.x / segs;  // chunk
  const int seg = static_cast<int>(blockIdx.x % segs);
  // this thread's words (zero in the zero prefix), all loads in flight
  // before the chain: the real index of its first word is negative in
  // the prefix
  const uint32_t* src = x + q * n_words;
  const long long first =
      static_cast<long long>(seg) * kCrcThreads * k_words + t - pad;
  uint32_t w[kCrcMaxRun];
#pragma unroll
  for (int u = 0; u < kCrcMaxRun; ++u) {
    const long long i = first + static_cast<long long>(u) * kCrcThreads;
    w[u] = 0u;
    if (u < k_words && i >= 0) w[u] = load_nc(src + i);
  }
  __syncthreads();  // the tables are in place
  uint32_t s = 0;
#pragma unroll
  for (int u = 0; u < kCrcMaxRun; ++u)
    if (u < k_words) s = step(tab, s) ^ w[u];
  // this thread's share of the segment's raw CRC, then XOR over the block
  uint32_t v = gf2_apply(lane_ops + t, kCrcThreads, s);
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
}

}  // namespace

extern "C" {

// G1.  x: (chunks, n_words) uint32 little-endian words, 4-byte aligned;
// y: (chunks,) uint32 standard CRC32C.  tabs: (4, 256) uint32, M^(4T) of
// each byte value at each byte; lane_ops: (32, T) uint32, column j of
// M^(4 (T - t)) at [j][t]; ladder: (32, 32) uint32, M^(4 T k_words 2^j)
// by columns.  segs * T * k_words - pad == n_words, 0 <= pad < T * k_words,
// 1 <= k_words <= 32 (checksum.kernel_split; the wrapper checks).  Zeroes
// y on `stream`, then launches one block a segment.  Returns
// cudaGetLastError().
int crc32c_chunks(const void* x, void* y, const void* tabs,
                  const void* lane_ops, const void* ladder, long long chunks,
                  long long n_words, int k_words, int segs, int pad,
                  unsigned int final_xor, void* stream) {
  if (chunks < 0 || n_words <= 0 || k_words < 1 || k_words > kCrcMaxRun ||
      segs < 1 || pad < 0 || pad >= kCrcThreads * k_words ||
      static_cast<long long>(segs) * kCrcThreads * k_words - pad != n_words ||
      chunks * segs > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (chunks == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(y, 0, chunks * sizeof(uint32_t), s);
  if (e != cudaSuccess) return e;
  crc32c_chunks_kernel<<<static_cast<unsigned>(chunks * segs), kCrcThreads,
                         0, s>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(tabs),
      static_cast<const uint32_t*>(lane_ops),
      static_cast<const uint32_t*>(ladder), n_words, k_words, segs, pad,
      final_xor);
  return cudaGetLastError();
}

}  // extern "C"
