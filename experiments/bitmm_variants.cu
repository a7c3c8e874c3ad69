// Variants of G4 (gf_bitmm) for bitmm_variants.py, which races them beside
// the library's kernel (ceph_tpu_torch/csrc/gf_bitmm.cu, included below):
//
// (a) the first design (first::), kept as it was so that old and new are
//     timed in one call: the data transposed into A fragments by byte
//     permutes, one output row's 8 bit-rows as B, each sum's low bit
//     placed by shifts and ORs, a quad reduce-scatter of the partial words;
//     its fragment table is bitmm_variants.first_plan;
// (b) the binary products alone: mma.m16n8k256 (and m16n8k128) on register
//     operands, 8 independent accumulators a warp, folded into one stored
//     word: the binary mma.sync rate of the card;
// (c) the library's loads alone: its tile walk and loads (with and without
//     the next tile's prefetch), the words XORed into one stored word;
// (d) the integer work alone: the library's kernels, and the first
//     design's, with each product replaced by XORs of its operands (the
//     packing, and the transposes and shuffles, stay);
// (e) the library's kernels at other settings, as copies below (var::)
//     with the settings as template parameters: blocks an SM under
//     __launch_bounds__, the next tile's prefetch on or off, the shift-adds
//     left to the compiler (the library's way) or forced onto the FMA pipe
//     by multipliers it cannot see through, and the column kernel (c > 8
//     in the library) on one half of K or both, at c <= 8 too.
//
// (f), wgmma on b1 operands, is bitmm_wgmma.cu: a separate build, so that
// a ptxas refusal leaves these variants standing.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface; never by the library.

#include "../ceph_tpu_torch/csrc/gf_bitmm.cu"

namespace var {

struct TensorMma {
  __device__ __forceinline__ static void run(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_b1(d, a, b0, b1);
  }
  __device__ __forceinline__ static void run128(int (&d)[4], uint32_t a0,
                                                uint32_t a1, uint32_t b0) {
    mma_b1_k128(d, a0, a1, b0);
  }
};

// (d): the product replaced by two XORs of its operands
struct XorMma {
  __device__ __forceinline__ static void run(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    d[0] ^= static_cast<int>(a[0] ^ b0);
    d[1] ^= static_cast<int>(a[1] ^ b1);
    d[2] ^= static_cast<int>(a[2]);
    d[3] ^= static_cast<int>(a[3]);
  }
  __device__ __forceinline__ static void run128(int (&d)[4], uint32_t a0,
                                                uint32_t a1, uint32_t b0) {
    d[0] ^= static_cast<int>(a0 ^ b0);
    d[1] ^= static_cast<int>(a1);
  }
};

// g4::place_pair with the shift-adds as multiplies by k16 = 2^16 and two =
// 2, which the kernels hide from the compiler when kFma (so they issue as
// IMAD on the FMA pipe).
template <bool kFma>
__device__ __forceinline__ void place_pair(uint32_t& lo_out, uint32_t& hi_out,
                                           const int (&d)[4][4],
                                           uint32_t k16, uint32_t two) {
  if constexpr (!kFma) {
    g4::place_pair(lo_out, hi_out, d);
  } else {
#pragma unroll
    for (int v = 1; v >= 0; --v) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 2 * h + v;
        const uint32_t lo = static_cast<uint32_t>(d[0][i]) +
                            static_cast<uint32_t>(d[1][i]) * k16;
        const uint32_t hi = static_cast<uint32_t>(d[2][i]) +
                            static_cast<uint32_t>(d[3][i]) * k16;
        const uint32_t bits = __byte_perm(lo, hi, 0x6420) & 0x01010101u;
        uint32_t& out = h ? hi_out : lo_out;
        out = out * two + bits;
      }
    }
  }
}

// g4::group_words with the settings
template <bool kFma, class Mma>
__device__ __forceinline__ void group_words(uint32_t (&out)[2][4],
                                            const uint32_t (&a)[4][4],
                                            uint32_t fr0, uint32_t fr1,
                                            uint32_t k16, uint32_t two) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int w = 0; w < 4; ++w) out[h][w] = 0u;
#pragma unroll
  for (int p = 3; p >= 0; --p) {
    uint32_t b[2][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      b[0][u] = __byte_perm(fr0, 0u, g4::place_sel(u, p));
      b[1][u] = __byte_perm(fr1, 0u, g4::place_sel(u, p));
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t av[4] = {a[0][w], a[1][w], a[2][w], a[3][w]};
      int d[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) d[u][i] = 0;
        Mma::run(d[u], av, b[0][u], b[1][u]);
      }
      place_pair<kFma>(out[0][w], out[1][w], d, k16, two);
    }
  }
}

// g4::gf_bitmm_words with the settings
template <int kBlocks, bool kPrefetch, bool kFma, class Mma>
__global__ void __launch_bounds__(g4::kThreads, kBlocks)
    words_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                 const uint32_t* __restrict__ frag, int r, int c,
                 long long L, long long tiles) {
  using namespace g4;
  extern __shared__ uint32_t s_frag[];  // [group][h][lane]
  const int groups = (r + 3) >> 2;
  for (int i = threadIdx.x; i < groups * kWordGroupWords; i += kThreads)
    s_frag[i] = frag[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t k16 = 1u << 16, two = 2u;
  if (kFma) asm volatile("" : "+r"(k16), "+r"(two));
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long tile =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  uint32_t a[4][4];
  if constexpr (kPrefetch)
    load_words(a, x, c, L, tile * kWordTile + 16 * g, t);
  for (; tile < tiles; tile += stride) {
    const long long col = tile * kWordTile + 16 * g;
    uint32_t nxt[4][4];
    if constexpr (kPrefetch)
      load_words(nxt, x, c, L, col + stride * kWordTile, t);
    else
      load_words(a, x, c, L, col, t);
    for (int G = 0; G < groups; ++G) {
      uint32_t out[2][4];
      group_words<kFma, Mma>(out, a, s_frag[(2 * G) * 32 + lane],
                             s_frag[(2 * G + 1) * 32 + lane], k16, two);
      const int row = 4 * G + t;
      if (row < r) {
        uint8_t* dst = y + row * L + col;
        if (col < L) store16(dst, out[0]);
        if (col + 128 < L) store16(dst + 128, out[1]);
      }
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int w = 0; w < 4; ++w) a[i][w] = nxt[i][w];
    }
  }
}

// g4::group_columns with the settings
template <int kH, bool kFma, class Mma>
__device__ __forceinline__ void group_columns(uint32_t (&out)[4],
                                              const uint32_t (&cw)[kH][4][4],
                                              const uint32_t (&fr)[4][kH],
                                              uint32_t k16, uint32_t two) {
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = 0u;
#pragma unroll
  for (int p = 3; p >= 0; --p) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      int d[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) d[u][i] = 0;
        if constexpr (kH == 1) {
          Mma::run128(d[u], cw[0][q][u], cw[0][q + 2][u], fr[p][0]);
        } else {
          const uint32_t av[4] = {cw[0][q][u], cw[0][q + 2][u], cw[1][q][u],
                                  cw[1][q + 2][u]};
          Mma::run(d[u], av, fr[p][0], fr[p][1]);
        }
      }
      place_pair<kFma>(out[q], out[q + 2], d, k16, two);
    }
  }
}

// g4::gf_bitmm_columns with the settings
template <int kH, int kBlocks, bool kPrefetch, bool kFma, class Mma>
__global__ void __launch_bounds__(g4::kThreads, kBlocks)
    columns_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                   const uint32_t* __restrict__ frag, int r, int c,
                   long long L, long long tiles) {
  using namespace g4;
  extern __shared__ uint32_t s_frag[];  // [group][p][h][lane]
  const int groups = (r + 3) >> 2;
  for (int i = threadIdx.x; i < groups * kColumnGroupWords; i += kThreads)
    s_frag[i] = frag[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t k16 = 1u << 16, two = 2u;
  if (kFma) asm volatile("" : "+r"(k16), "+r"(two));
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long tile =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  uint32_t w[kH][4][4];
  if constexpr (kPrefetch)
    load_rows<kH>(w, x, c, L, tile * kColumnTile + 16 * g, t);
  for (; tile < tiles; tile += stride) {
    const long long col = tile * kColumnTile + 16 * g;
    if constexpr (!kPrefetch) load_rows<kH>(w, x, c, L, col, t);
    uint32_t cw[kH][4][4];
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        transpose4(cw[h][q], w[h][0][q], w[h][1][q], w[h][2][q], w[h][3][q]);
    if constexpr (kPrefetch)
      load_rows<kH>(w, x, c, L, col + stride * kColumnTile, t);
    for (int G = 0; G < groups; ++G) {
      uint32_t fr[4][kH];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int h = 0; h < kH; ++h)
          fr[p][h] = s_frag[((G * 4 + p) * 2 + h) * 32 + lane];
      uint32_t out[4];
      group_columns<kH, kFma, Mma>(out, cw, fr, k16, two);
      const int row = 4 * G + t;
      if (row < r && col < L) store16(y + row * L + col, out);
    }
  }
}

template <int kBlocks, bool kPrefetch, bool kFma, class Mma = TensorMma>
int launch_words(const void* x, void* y, const void* frag, int r, int c,
                 long long L, void* stream) {
  return g4::launch(words_kernel<kBlocks, kPrefetch, kFma, Mma>,
                    g4::kWordTile, g4::kWordGroupWords, kBlocks, x, y, frag,
                    r, c, L, stream);
}

template <int kH, int kBlocks, bool kPrefetch, bool kFma,
          class Mma = TensorMma>
int launch_columns(const void* x, void* y, const void* frag, int r, int c,
                   long long L, void* stream) {
  return g4::launch(columns_kernel<kH, kBlocks, kPrefetch, kFma, Mma>,
                    g4::kColumnTile, g4::kColumnGroupWords, kBlocks, x, y,
                    frag, r, c, L, stream);
}

}  // namespace var

namespace first {

using var::TensorMma;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileBytes = 128;  // columns of a row a warp takes at once
constexpr int kBlocksPerSm = 8;
constexpr size_t kSmemDefault = 48 * 1024;

__device__ __forceinline__ void load16(uint32_t (&w)[4], const uint8_t* p) {
  asm volatile("ld.global.nc.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "l"(p));
}

// 4 x 4 byte transpose: byte e of b[u] = byte u of a_e.
__device__ __forceinline__ void transpose4(uint32_t (&b)[4], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140);  // a0.0 a1.0 a0.1 a1.1
  const uint32_t t1 = __byte_perm(a0, a1, 0x7362);  // a0.2 a1.2 a0.3 a1.3
  const uint32_t t2 = __byte_perm(a2, a3, 0x5140);
  const uint32_t t3 = __byte_perm(a2, a3, 0x7362);
  b[0] = __byte_perm(t0, t2, 0x5410);
  b[1] = __byte_perm(t0, t2, 0x7632);
  b[2] = __byte_perm(t1, t3, 0x5410);
  b[3] = __byte_perm(t1, t3, 0x7632);
}

// Word t of the OR of the four lanes' w[0..3] over the quad of lane t.
__device__ __forceinline__ uint32_t quad_reduce_scatter(const uint32_t (&w)[4],
                                                        int t) {
  const bool hi = t & 2;
  uint32_t k0 = hi ? w[2] : w[0];
  uint32_t k1 = hi ? w[3] : w[1];
  k0 |= __shfl_xor_sync(0xffffffffu, hi ? w[0] : w[2], 2);
  k1 |= __shfl_xor_sync(0xffffffffu, hi ? w[1] : w[3], 2);
  const bool odd = t & 1;
  return (odd ? k1 : k0) | __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 1);
}

template <class Mma>
__global__ void __launch_bounds__(kThreads)
    gf_bitmm_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                    const uint32_t* __restrict__ frag, int r, int c,
                    long long L, long long tiles) {
  extern __shared__ uint32_t s_frag[];  // [row][b0, b1][lane]
  for (int i = threadIdx.x; i < r * 64; i += kThreads) s_frag[i] = frag[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long tile = static_cast<long long>(blockIdx.x) * kWarps +
                        (threadIdx.x >> 5);
       tile < tiles; tile += stride) {
    const long long col = tile * kTileBytes + 16 * g;
    const bool live = col < L;
    // cw[h][q][u]: column col + 4 q + u of input rows 16 h + 4 t + e
    uint32_t cw[2][4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * h + 4 * t + e;
#pragma unroll
        for (int q = 0; q < 4; ++q) w[e][q] = 0u;
        if (live && j < c) load16(w[e], x + j * L + col);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        transpose4(cw[h][q], w[0][q], w[1][q], w[2][q], w[3][q]);
    }
    for (int i = 0; i < r; ++i) {
      const uint32_t b0 = s_frag[(2 * i) * 32 + lane];
      const uint32_t b1 = s_frag[(2 * i + 1) * 32 + lane];
      uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          int d[4] = {0, 0, 0, 0};
          const uint32_t a[4] = {cw[0][q][u], cw[0][q + 2][u], cw[1][q][u],
                                 cw[1][q + 2][u]};
          Mma::run(d, a, b0, b1);
          const int sh = 8 * u + 2 * t;
          out[q] |= ((d[0] & 1u) | ((d[1] & 1u) << 1)) << sh;
          out[q + 2] |= ((d[2] & 1u) | ((d[3] & 1u) << 1)) << sh;
        }
      }
      const uint32_t word = quad_reduce_scatter(out, t);
      if (live)
        *reinterpret_cast<uint32_t*>(y + i * L + col + 4 * t) = word;
    }
  }
}


template <class Mma>
int launch(const void* x, void* y, const void* frag, int r, int c,
           long long L, void* stream) {
  const size_t smem = static_cast<size_t>(r) * 64 * sizeof(uint32_t);
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf_bitmm_kernel<Mma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long tiles = (L + kTileBytes - 1) / kTileBytes;
  long long blocks = (tiles + kWarps - 1) / kWarps;
  const long long cap =
      static_cast<long long>(g4::sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  gf_bitmm_kernel<Mma><<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const uint32_t*>(frag), r, c, L, tiles);
  return cudaGetLastError();
}

}  // namespace first

namespace {

// (b) the products alone
constexpr int kChains = 8;

template <bool kK128>
__global__ void __launch_bounds__(256)
    products_kernel(uint32_t* __restrict__ y, uint32_t seed, int iters) {
  const uint32_t id = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t a[kChains][4];
#pragma unroll
  for (int m = 0; m < kChains; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[m][i] = (seed + id) * (2654435761u + 2 * (4 * m + i));
  const uint32_t b0 = seed ^ (id * 40503u), b1 = ~b0;
  int d[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int m = 0; m < kChains; ++m) {
      if (kK128)
        mma_b1_k128(d[m], a[m][0], a[m][1], b0);
      else
        mma_b1(d[m], a[m], b0, b1);
    }
  }
  int v = 0;
#pragma unroll
  for (int m = 0; m < kChains; ++m) v += d[m][0] + d[m][1] + d[m][2] + d[m][3];
  y[id] = static_cast<uint32_t>(v);
}

// (c) the library's tile walk and loads alone
template <bool kPrefetch>
__global__ void __launch_bounds__(g4::kThreads, g4::kWordBlocks)
    loads_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ y,
                 int c, long long L, long long tiles) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long stride = static_cast<long long>(gridDim.x) * g4::kWarps;
  long long tile =
      static_cast<long long>(blockIdx.x) * g4::kWarps + (threadIdx.x >> 5);
  uint32_t a[4][4];
  uint32_t v = 0;
  if constexpr (kPrefetch)
    g4::load_words(a, x, c, L, tile * g4::kWordTile + 16 * g, t);
  for (; tile < tiles; tile += stride) {
    const long long col = tile * g4::kWordTile + 16 * g;
    uint32_t nxt[4][4];
    if constexpr (kPrefetch)
      g4::load_words(nxt, x, c, L, col + stride * g4::kWordTile, t);
    else
      g4::load_words(a, x, c, L, col, t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int w = 0; w < 4; ++w) v ^= a[i][w];
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int w = 0; w < 4; ++w) a[i][w] = nxt[i][w];
    }
  }
  y[blockIdx.x * blockDim.x + threadIdx.x] = v;
}

// (e) the library's kernels at other settings (the library's: its blocks
// an SM, prefetch on, the shift-adds left to the compiler)
using Launch = int (*)(const void*, void*, const void*, int, int, long long,
                       void*);
using var::launch_columns;
using var::launch_words;
using var::XorMma;
constexpr int kLibBlocks = g4::kWordBlocks;
constexpr int kLibColumnBlocks = g4::kColumnBlocks;
constexpr Launch kCandidates[] = {
    launch_words<kLibBlocks, true, false>,
    launch_words<2, true, false>,
    launch_words<4, true, false>,
    launch_words<kLibBlocks, false, false>,
    launch_words<4, false, false>,
    launch_words<kLibBlocks, true, true>,
    launch_words<kLibBlocks, true, false, XorMma>,  // (d)
};
// the column kernel (its own table layout), on one half of K or both
constexpr Launch kColumnCandidates[] = {
    launch_columns<1, kLibColumnBlocks, true, false>,
    launch_columns<2, kLibColumnBlocks, true, false>,
    launch_columns<1, 3, true, false>,
    launch_columns<2, 3, true, false>,
    launch_columns<1, kLibColumnBlocks, false, false>,
    launch_columns<1, kLibColumnBlocks, true, false, XorMma>,  // (d)
};

template <int N>
int pick(const Launch (&list)[N], int which, const void* x, void* y,
         const void* frag, int r, int c, long long L, void* stream) {
  if (which < 0 || which >= N || r <= 0 || c <= 0 || c > 32 || L <= 0 ||
      L % 16)
    return cudaErrorInvalidValue;
  return list[which](x, y, frag, r, c, L, stream);
}

}  // namespace

extern "C" {

// (e) and (d): candidate ``which`` of kCandidates on (c <= 8, L) bytes
// with the word kernel's table, or of kColumnCandidates (column = 1) with
// the column kernel's.
int cand_bitmm(int column, int which, const void* x, void* y,
               const void* frag, int r, int c, long long L, void* stream) {
  if (column)
    return pick(kColumnCandidates, which, x, y, frag, r, c, L, stream);
  if (c > 8) return cudaErrorInvalidValue;
  return pick(kCandidates, which, x, y, frag, r, c, L, stream);
}

int cand_count(int column) {
  return column ? static_cast<int>(sizeof(kColumnCandidates) /
                                   sizeof(kColumnCandidates[0]))
                : static_cast<int>(sizeof(kCandidates) /
                                   sizeof(kCandidates[0]));
}

// (a), and (d) of the first design (xor_products = 1).
int first_bitmm(int xor_products, const void* x, void* y, const void* frag,
              int r, int c, long long L, void* stream) {
  if (r <= 0 || c <= 0 || c > 32 || L <= 0 || L % 16)
    return cudaErrorInvalidValue;
  return xor_products
             ? first::launch<var::XorMma>(x, y, frag, r, c, L, stream)
             : first::launch<first::TensorMma>(x, y, frag, r, c, L, stream);
}

// (b): ``blocks`` blocks of 256 threads, ``iters`` x 8 products a warp.
int products(int k128, void* y, int blocks, int iters, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k128)
    products_kernel<true><<<blocks, 256, 0, s>>>(static_cast<uint32_t*>(y),
                                                 12345u, iters);
  else
    products_kernel<false><<<blocks, 256, 0, s>>>(static_cast<uint32_t*>(y),
                                                  12345u, iters);
  return cudaGetLastError();
}

// (c): the loads alone on (c <= 8, L) bytes; y holds one word a thread
// of a grid of loads_blocks(L) blocks.
long long loads_blocks(long long L) {
  const long long tiles = (L + g4::kWordTile - 1) / g4::kWordTile;
  long long blocks = (tiles + g4::kWarps - 1) / g4::kWarps;
  const long long cap =
      static_cast<long long>(g4::sm_count()) * g4::kWordBlocks;
  return blocks > cap ? cap : blocks;
}

int loads(int prefetch, const void* x, void* y, int c, long long L,
          void* stream) {
  const long long tiles = (L + g4::kWordTile - 1) / g4::kWordTile;
  const auto blocks = static_cast<unsigned>(loads_blocks(L));
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const uint8_t*>(x);
  auto yp = static_cast<uint32_t*>(y);
  if (prefetch)
    loads_kernel<true><<<blocks, g4::kThreads, 0, s>>>(xp, yp, c, L, tiles);
  else
    loads_kernel<false><<<blocks, g4::kThreads, 0, s>>>(xp, yp, c, L, tiles);
  return cudaGetLastError();
}

}  // extern "C"
