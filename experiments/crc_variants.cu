// Variants of G1 (crc32c_chunks) for crc_variants.py.
//
// - the library's tensor-core kernel (ceph_tpu_torch/csrc/crc32c.cu,
//   included below) at other template arguments: int8 or binary
//   products, 2 or 4 words a load, 1, 2 or 4 loads a Horner step, 4 or 8
//   warps a block, 16, 32 or 64 words a lane a segment (crc_mma);
// - the same persistent walk and loads with no products: the words
//   XORed into the digest, no CRC (crc_loads);
// - the table chain of the first port: a 4 KiB byte table of M^(4T) in
//   shared memory, 4 lookups a word, 32 words a thread, one block a
//   segment (crc_chain), and the same loop with every lane of a warp
//   reading one table entry (mask 0: no bank conflicts, the same
//   instructions, no CRC), the probe of what bounded it.
//
// Built by crc_variants.py, never by the library.

#include "../ceph_tpu_torch/csrc/crc32c.cu"

namespace {

// ------------------------------------------------- the loads alone
template <int kV, int kWarps, int kWords, bool kVec>
__global__ void __launch_bounds__(32 * kWarps)
    loads_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                 long long n_words, long long blocks, int iters, int segs,
                 int pad) {
  using G = g1::Geometry<false, kV, 1, kWarps, kWords>;
  uint32_t w[G::kIters][kV];
  for (long long b = blockIdx.x; b < blocks; b += gridDim.x) {
    g1::load_segment<G, kV, 1, kVec>(w, x, b, n_words, iters, segs, pad);
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < G::kIters; ++i)
#pragma unroll
      for (int u = 0; u < kV; ++u) v ^= w[i][u];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, d);
    if ((threadIdx.x & 31) == 0) atomicXor(y + b / segs, v);
  }
}

// ------------------------------------------------- the table chain
constexpr int kChainThreads = 256;
constexpr int kChainRun = 32;
constexpr int kTabEntries = 1024;  // 4 bytes x 256 values

__device__ __forceinline__ uint32_t lane_apply(const uint32_t* __restrict__ cols,
                                               uint32_t v) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    acc ^= cols[j * kChainThreads] & (0u - ((v >> j) & 1u));
  return acc;
}

// M^(4T) s: XOR over the 4 bytes of s of tab[byte][value]; a mask of 0
// makes every lane read entry 0 of each byte's table.
__device__ __forceinline__ uint32_t step(const uint32_t* tab, uint32_t s,
                                         uint32_t mask) {
  return tab[s & mask] ^ tab[256 + ((s >> 8) & mask)] ^
         tab[512 + ((s >> 16) & mask)] ^ tab[768 + ((s >> 24) & mask)];
}

__global__ void __launch_bounds__(kChainThreads)
    chain_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                 const uint32_t* __restrict__ tabs,
                 const uint32_t* __restrict__ lane_ops,
                 const uint32_t* __restrict__ ladder, long long n_words,
                 int k_words, int segs, int pad, uint32_t final_xor,
                 uint32_t mask) {
  __shared__ uint32_t tab[kTabEntries];
  __shared__ uint32_t part[kChainThreads / 32];
  const int t = threadIdx.x;
  for (int i = t; i < kTabEntries; i += kChainThreads) tab[i] = tabs[i];
  const long long q = blockIdx.x / segs;
  const int seg = static_cast<int>(blockIdx.x % segs);
  const uint32_t* src = x + q * n_words;
  const long long first =
      static_cast<long long>(seg) * kChainThreads * k_words + t - pad;
  uint32_t w[kChainRun];
#pragma unroll
  for (int u = 0; u < kChainRun; ++u) {
    const long long i = first + static_cast<long long>(u) * kChainThreads;
    w[u] = 0u;
    if (u < k_words && i >= 0) w[u] = g1::load_word(src + i);
  }
  __syncthreads();
  uint32_t s = 0;
#pragma unroll
  for (int u = 0; u < kChainRun; ++u)
    if (u < k_words) s = step(tab, s, mask) ^ w[u];
  uint32_t v = lane_apply(lane_ops + t, s);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, d);
  if ((t & 31) == 0) part[t >> 5] = v;
  __syncthreads();
  if (t == 0) {
    uint32_t raw = 0;
#pragma unroll
    for (int i = 0; i < kChainThreads / 32; ++i) raw ^= part[i];
    for (int d = segs - 1 - seg, j = 0; d; d >>= 1, ++j)
      if (d & 1) raw = g1::gf2_apply(ladder + 32 * j, raw);
    if (seg == 0) raw ^= final_xor;
    atomicXor(y + q, raw);
  }
}

template <int kV, int kWarps, int kWords>
int launch_loads(const void* x, void* y, long long chunks, long long n_words,
                 int iters, int segs, int pad, cudaStream_t s) {
  using G = g1::Geometry<false, kV, 1, kWarps, kWords>;
  if (n_words % kV || reinterpret_cast<uintptr_t>(x) % (4 * kV))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(y, 0, chunks * sizeof(uint32_t), s);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, loads_kernel<kV, kWarps, kWords, true>, G::kThreads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = chunks * segs;
  const long long grid = blocks < per_sm * sms ? blocks : per_sm * sms;
  loads_kernel<kV, kWarps, kWords, true>
      <<<static_cast<unsigned>(grid), G::kThreads, 0, s>>>(
          static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), n_words,
          blocks, iters, segs, pad);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The library's kernel at the template arguments (b1, words, loads,
// warps, per_lane) of checksum.CrcGeometry, on its tables.
int crc_mma(int b1, int words, int loads, int warps, int per_lane,
            const void* x, void* y, const void* ops, const void* shift,
            const void* fin, const void* ladder, long long chunks,
            long long n_words, int iters, int segs, int pad,
            unsigned int final_xor, void* stream) {
#define G1_VARIANT(B1, V, LP, NW, W)                                          \
  if (b1 == B1 && words == V && loads == LP && warps == NW && per_lane == W) \
    return g1::launch<B1, V, LP, NW, W>(x, y, ops, shift, fin, ladder, chunks, \
                                        n_words, iters, segs, pad, final_xor, \
                                        stream);
  G1_VARIANT(false, 4, 1, 8, 32)
  G1_VARIANT(false, 2, 1, 8, 32)
  G1_VARIANT(false, 4, 1, 4, 32)
  G1_VARIANT(false, 4, 1, 8, 16)
  G1_VARIANT(true, 4, 1, 8, 32)
  G1_VARIANT(true, 4, 2, 8, 32)
  G1_VARIANT(true, 4, 4, 8, 32)
  G1_VARIANT(true, 4, 1, 4, 32)
  G1_VARIANT(true, 4, 1, 8, 16)
  G1_VARIANT(true, 4, 1, 8, 64)
  G1_VARIANT(true, 4, 1, 4, 64)
#undef G1_VARIANT
  return cudaErrorInvalidValue;
}

// The loads of the int8 kernel at (words, warps, per_lane), XORed.
int crc_loads(int words, int warps, int per_lane, const void* x, void* y,
              long long chunks, long long n_words, int iters, int segs,
              int pad, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (words == 4 && warps == 8 && per_lane == 32)
    return launch_loads<4, 8, 32>(x, y, chunks, n_words, iters, segs, pad, s);
  if (words == 2 && warps == 8 && per_lane == 32)
    return launch_loads<2, 8, 32>(x, y, chunks, n_words, iters, segs, pad, s);
  return cudaErrorInvalidValue;
}

// The table chain at 32 words a thread (mask 255), or the probe (mask 0).
int crc_chain(const void* x, void* y, const void* tabs, const void* lane_ops,
              const void* ladder, long long chunks, long long n_words,
              int k_words, int segs, int pad, unsigned int final_xor,
              unsigned int mask, void* stream) {
  if (chunks <= 0 || k_words < 1 || k_words > kChainRun ||
      static_cast<long long>(segs) * kChainThreads * k_words - pad != n_words)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(y, 0, chunks * sizeof(uint32_t), s);
  if (e != cudaSuccess) return e;
  chain_kernel<<<static_cast<unsigned>(chunks * segs), kChainThreads, 0, s>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(tabs),
      static_cast<const uint32_t*>(lane_ops),
      static_cast<const uint32_t*>(ladder), n_words, k_words, segs, pad,
      final_xor, mask);
  return cudaGetLastError();
}

}  // extern "C"
