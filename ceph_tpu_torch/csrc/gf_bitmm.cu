// G4: the GF(2^8) region product out(r, L) = M(r, c) . x(c, L) on Hopper's
// binary tensor cores (sm_90a), as a GF(2) bit-matrix product:
//
//   bits(8r, L) = bitmatrix(M)(8r, 8c) . planes(8c, L)   mod 2
//
// with bitmatrix(M) of ceph_tpu_torch/ops/gf256.py (row 8i + k is bit k of
// output row i, column 8j + s bit s of input row j: LSB first).
//
// gf_bitmm replaces the JAX package's mxu realization, which is an XLA dot
// graph rather than a Pallas kernel: ceph_tpu/ops/ec_kernels.py
// gf_matmul_mxu_graph (reached through RegionMatmul(kernel="mxu") and
// gf_region_graph(kernel="mxu")), which unpacks the bytes into 0/1 bf16
// planes, multiplies on the matrix unit with f32 accumulation, keeps the low
// bit and packs the planes back into bytes.  Wrapped by
// ceph_tpu_torch/ops/ec_kernels.py gf_bitmm_lanes, which builds the fragment
// table on the host (ec_kernels.bitmm_plan) and checks shapes and
// alignment.
//
// What bounds it: the bytes, (r + c) L, each input read once and each
// output written once (88 MiB for the 3x8 encode of a 64-stripe batch of
// 1 MiB stripes, ~27.5 us at 3.35 TB/s).  One mma.m16n8k256 gives 128
// output bits whatever K holds, so a launch needs r L / 16 of them at
// least (4 ceil(r / 4) L / 16 here).  What a design spends around them is
// integer work on the ALU and FMA pipes, and that is what it keeps small.
//
// Outputs (both kernels).  B column n = 2 rho + v of the product for bit
// pair p of a group of 4 output rows is bit 2 p + v of output row
// 4 G + rho, so lane (g, t) (lane = 4 g + t; layout in gf2_mma.cuh) gets
// in d[0], d[1] bits 2 p and 2 p + 1 of its own row 4 G + t at A row g's
// column, and in d[2], d[3] at A row g + 8's: every bit of a byte lands in
// one lane, no reduction across lanes, and each lane stores whole uint4s
// (a warp writes 128 contiguous bytes of 4 rows at a time).  A sum is at
// most 256, so its low byte keeps its parity (256 wraps to 0, even).  Two
// sums share a word as lo + (hi << 16), one byte permute gathers the low
// bytes of four sums (columns u = 0..3 of a word), a LOP3 keeps bit 0 of
// each byte, and a Horner step out = (out << 1) + W, bits 7 down to 0,
// places them.  The compiler issues the shift-adds as IMAD on the FMA
// pipe: 0.71 FMA-pipe and 0.74 ALU instructions a sum in the word
// kernel's SASS, byte permutes of B included (chip_smoke.BITMM_*_OPS),
// against 2.75 in the first design's loop before its transposes.  Rows
// past r fill the last group of 4 (their lanes compute and do not store).
//
// Inputs, by c:
// - c <= 8, gf_bitmm_words (the EC hot path: k = 8): A is the data as
//   loaded, with no transpose.  An A row is a group of 4 byte columns and
//   its 256 k-bits the 32-bit words of the 8 input rows there (k =
//   32 e + 8 u + s: row e, column u of the group, bit s).  A lane loads one
//   uint4 (16 columns) of rows t and 4 + t at columns col and col + 128 of
//   a 256-column tile (col = 256 tile + 16 g): word w of them is a[0] and
//   a[2] of mma w (A row g) and a[1], a[3] (A row g + 8).  B is
//   block-diagonal in u: the mma (u, p) meets only byte u of each A word,
//   so the host packs the bytes p = 0..3 of a lane's B register in one word
//   (ec_kernels.bitmm_plan) and a byte permute moves byte p to byte u.
//   Every lane loads, 16 bytes at a time, and issues the next tile's loads
//   before this tile's products.
// - 8 < c <= 32, gf_bitmm_columns: 8 c bits do not fit one such K, and
//   more k-steps would multiply the products, so an A row is one byte
//   column and its k-bits the bytes of up to 32 input rows (k = 8 j + s),
//   as in the first design: a lane loads a uint4 of rows 16 h + 4 t + e
//   (e < 4) at col = 128 tile + 16 g and 8 byte permutes turn each 4 words
//   into 4 column words (transpose4).  B is then one register a lane for
//   each p and half h of K, no permute.  At c <= 16 the upper half of K is
//   zero and the products are m16n8k128.
// Input rows past c load nothing, and the last tile of a row is masked 16
// columns at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gf2_mma.cuh"

namespace g4 {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr int kWordTile = 256;         // columns of every row a warp takes
constexpr int kWordGroupWords = 64;    // frag words of a group: [h][lane]
constexpr int kColumnTile = 128;
constexpr int kColumnGroupWords = 256;  // [p][h][lane]
// Blocks an SM under __launch_bounds__: 3 for the word kernel; the column
// kernel holds twice the words and takes 2 (experiments/bitmm_variants.py
// races other counts).
constexpr int kWordBlocks = 3;
constexpr int kColumnBlocks = 2;

__device__ __forceinline__ void load16(uint32_t (&w)[4], const uint8_t* p) {
  asm volatile("ld.global.nc.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "l"(p));
}

__device__ __forceinline__ void store16(uint8_t* p, const uint32_t (&w)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Bits 2 p + 1, then 2 p, of four products' sums (d[u], u = byte of the
// word) onto lo (from d[u][0..1]) and hi (d[u][2..3]) by Horner steps.
__device__ __forceinline__ void place_pair(uint32_t& lo_out, uint32_t& hi_out,
                                           const int (&d)[4][4]) {
#pragma unroll
  for (int v = 1; v >= 0; --v) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * h + v;
      const uint32_t lo = static_cast<uint32_t>(d[0][i]) +
                          (static_cast<uint32_t>(d[1][i]) << 16);
      const uint32_t hi = static_cast<uint32_t>(d[2][i]) +
                          (static_cast<uint32_t>(d[3][i]) << 16);
      const uint32_t bits = __byte_perm(lo, hi, 0x6420) & 0x01010101u;
      uint32_t& out = h ? hi_out : lo_out;
      out = (out << 1) + bits;
    }
  }
}

// ---------------------------------------------------------------- c <= 8

// The A words of one 256-column tile: a[i][w] is word w of the uint4 of
// input row 4 (i >> 1) + t at column col + 128 (i & 1); zero past c or L.
__device__ __forceinline__ void load_words(uint32_t (&a)[4][4],
                                           const uint8_t* __restrict__ x,
                                           int c, long long L, long long col,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = 4 * (i >> 1) + t;
    const long long at = col + 128 * (i & 1);
#pragma unroll
    for (int w = 0; w < 4; ++w) a[i][w] = 0u;
    if (j < c && at < L) load16(a[i], x + j * L + at);
  }
}

// Byte-permute selector moving byte p of a register to byte u, zeros
// elsewhere (selector 4 is byte 0 of the zero operand).
__host__ __device__ constexpr uint32_t place_sel(int u, int p) {
  return (0x4444u & ~(0xFu << (4 * u))) | (static_cast<uint32_t>(p) << (4 * u));
}

// One group of 4 output rows over one tile: out[h][w] is word w of lane
// t's row at col + 128 h; fr0, fr1 the group's packed B registers.
__device__ __forceinline__ void group_words(uint32_t (&out)[2][4],
                                            const uint32_t (&a)[4][4],
                                            uint32_t fr0, uint32_t fr1) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int w = 0; w < 4; ++w) out[h][w] = 0u;
#pragma unroll
  for (int p = 3; p >= 0; --p) {
    uint32_t b[2][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      b[0][u] = __byte_perm(fr0, 0u, place_sel(u, p));
      b[1][u] = __byte_perm(fr1, 0u, place_sel(u, p));
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t av[4] = {a[0][w], a[1][w], a[2][w], a[3][w]};
      int d[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) d[u][i] = 0;
        mma_b1(d[u], av, b[0][u], b[1][u]);
      }
      place_pair(out[0][w], out[1][w], d);
    }
  }
}

// The next tile's loads are issued before this tile's products.
__global__ void __launch_bounds__(kThreads, kWordBlocks)
    gf_bitmm_words(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                   const uint32_t* __restrict__ frag, int r, int c,
                   long long L, long long tiles) {
  extern __shared__ uint32_t s_frag[];  // [group][h][lane]
  const int groups = (r + 3) >> 2;
  for (int i = threadIdx.x; i < groups * kWordGroupWords; i += kThreads)
    s_frag[i] = frag[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long tile =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  uint32_t a[4][4];
  load_words(a, x, c, L, tile * kWordTile + 16 * g, t);
  for (; tile < tiles; tile += stride) {
    const long long col = tile * kWordTile + 16 * g;
    uint32_t nxt[4][4];
    load_words(nxt, x, c, L, col + stride * kWordTile, t);
    for (int G = 0; G < groups; ++G) {
      uint32_t out[2][4];
      group_words(out, a, s_frag[(2 * G) * 32 + lane],
                  s_frag[(2 * G + 1) * 32 + lane]);
      const int row = 4 * G + t;
      if (row < r) {
        uint8_t* dst = y + row * L + col;
        if (col < L) store16(dst, out[0]);
        if (col + 128 < L) store16(dst + 128, out[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int w = 0; w < 4; ++w) a[i][w] = nxt[i][w];
  }
}

// ----------------------------------------------------------- 8 < c <= 32

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

// The rows of one 128-column tile as loaded: w[h][e][q] is word q of the
// uint4 of input row 16 h + 4 t + e at column col; zero past c or L.
template <int kH>
__device__ __forceinline__ void load_rows(uint32_t (&w)[kH][4][4],
                                          const uint8_t* __restrict__ x,
                                          int c, long long L, long long col,
                                          int t) {
#pragma unroll
  for (int h = 0; h < kH; ++h) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 16 * h + 4 * t + e;
#pragma unroll
      for (int q = 0; q < 4; ++q) w[h][e][q] = 0u;
      if (j < c && col < L) load16(w[h][e], x + j * L + col);
    }
  }
}

// One group of 4 output rows over one tile: out[q] is word q of lane t's
// row at col; cw[h][q][u] is column col + 4 q + u of input rows
// 16 h + 4 t + e (byte e), fr[p][h] the group's B registers.
template <int kH>
__device__ __forceinline__ void group_columns(uint32_t (&out)[4],
                                              const uint32_t (&cw)[kH][4][4],
                                              const uint32_t (&fr)[4][kH]) {
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
          mma_b1_k128(d[u], cw[0][q][u], cw[0][q + 2][u], fr[p][0]);
        } else {
          const uint32_t av[4] = {cw[0][q][u], cw[0][q + 2][u], cw[1][q][u],
                                  cw[1][q + 2][u]};
          mma_b1(d[u], av, fr[p][0], fr[p][1]);
        }
      }
      place_pair(out[q], out[q + 2], d);
    }
  }
}

// The next tile's loads are issued before this tile's products.
template <int kH>
__global__ void __launch_bounds__(kThreads, kColumnBlocks)
    gf_bitmm_columns(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                     const uint32_t* __restrict__ frag, int r, int c,
                     long long L, long long tiles) {
  extern __shared__ uint32_t s_frag[];  // [group][p][h][lane]
  const int groups = (r + 3) >> 2;
  for (int i = threadIdx.x; i < groups * kColumnGroupWords; i += kThreads)
    s_frag[i] = frag[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long tile =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  uint32_t w[kH][4][4];
  load_rows<kH>(w, x, c, L, tile * kColumnTile + 16 * g, t);
  for (; tile < tiles; tile += stride) {
    const long long col = tile * kColumnTile + 16 * g;
    uint32_t cw[kH][4][4];
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        transpose4(cw[h][q], w[h][0][q], w[h][1][q], w[h][2][q], w[h][3][q]);
    load_rows<kH>(w, x, c, L, col + stride * kColumnTile, t);
    for (int G = 0; G < groups; ++G) {
      uint32_t fr[4][kH];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int h = 0; h < kH; ++h)
          fr[p][h] = s_frag[((G * 4 + p) * 2 + h) * 32 + lane];
      uint32_t out[4];
      group_columns<kH>(out, cw, fr);
      const int row = 4 * G + t;
      if (row < r && col < L) store16(y + row * L + col, out);
    }
  }
}

// ---------------------------------------------------------------- launch

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    return 132;
  return n;
}

using Kernel = void (*)(const uint8_t*, uint8_t*, const uint32_t*, int, int,
                        long long, long long);

// Launch ``kernel`` over ceil(L / tile_bytes) tiles, a warp a tile, at most
// ``blocks_per_sm`` blocks an SM, with the fragment table (group_words
// words a group of 4 output rows) staged in shared memory.
inline int launch(Kernel kernel, int tile_bytes, int group_words,
                  int blocks_per_sm, const void* x, void* y,
                  const void* frag, int r, int c, long long L,
                  void* stream) {
  const size_t smem =
      static_cast<size_t>((r + 3) / 4) * group_words * sizeof(uint32_t);
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long tiles = (L + tile_bytes - 1) / tile_bytes;
  long long blocks = (tiles + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sm_count()) * blocks_per_sm;
  if (blocks > cap) blocks = cap;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const uint32_t*>(frag), r, c, L, tiles);
  return cudaGetLastError();
}

}  // namespace g4

extern "C" {

// G4.  x: (c, L) bytes, y: (r, L) bytes, frag: ec_kernels.bitmm_plan's
// uint32 B fragments, (ceil(r / 4), 2, 32) for c <= 8 and
// (ceil(r / 4), 4, 2, 32) above.  1 <= c <= 32, L % 16 == 0, x and y
// 16-byte aligned (the wrapper checks).  Returns cudaGetLastError().
int gf_bitmm(const void* x, void* y, const void* frag, int r, int c,
             long long L, void* stream) {
  if (r <= 0 || c <= 0 || c > 32 || L < 0 || L % 16)
    return cudaErrorInvalidValue;
  if (L == 0) return cudaSuccess;
  using namespace g4;
  if (c <= 8)
    return launch(gf_bitmm_words, kWordTile, kWordGroupWords, kWordBlocks, x,
                  y, frag, r, c, L, stream);
  return launch(c <= 16 ? gf_bitmm_columns<1> : gf_bitmm_columns<2>,
                kColumnTile, kColumnGroupWords, kColumnBlocks, x, y, frag, r,
                c, L, stream);
}

}  // extern "C"
