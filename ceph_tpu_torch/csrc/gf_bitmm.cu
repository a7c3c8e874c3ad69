// G4: the GF(2^8) region product out(r, L) = M(r, c) . x(c, L) on Hopper's
// binary tensor cores (sm_90a), as a GF(2) bit-matrix product:
//
//   bits(8r, L) = bitmatrix(M)(8r, 8c) . planes(8c, L)   mod 2
//
// with bitmatrix(M) of ceph_tpu_torch/ops/gf256.py (row 8i + t is bit t of
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
// Operands.  The data is operand A and the matrix operand B of
// mma.m16n8k256.b1 (gf2_mma.cuh): an A row is one byte column of the data,
// its 256 k-bits the c bytes of that column (k = 8 j + s, zero for j >= c),
// and an n-tile is the 8 bit-rows of one output row, so 8r needs no padding
// and each mma gives every bit of 16 output bytes.
// - A.  A lane (g, t) loads 16 bytes (one uint4, columns col .. col + 15,
//   col = 128 tile + 16 g) of each of the input rows 4 t + e and
//   16 + 4 t + e, e < 4: the 8 lanes of one t read 128 contiguous bytes of
//   a row.  Eight byte permutes (transpose4) turn the 4 words that cover
//   columns col + 4 q .. col + 4 q + 3 of rows 4 t .. 4 t + 3 into 4 column
//   words, byte e of the one for column col + 4 q + u being row 4 t + e:
//   bit 8 e + s of it is k = 32 t + 8 e + s, the A fragment as it stands.
//   mma (q, u), q < 2, takes column col + 4 q + u as A row g and column
//   col + 4 (q + 2) + u as row g + 8.
// - B.  The host lays bitmatrix(M), zero-padded to 256 columns, out as the
//   b0, b1 fragments of each output row: ec_kernels.bitmm_plan, (r, 2, 32)
//   words, staged in shared memory once per block (256 r bytes).
// - Epilogue.  d[0], d[1] of mma (q, u) are bits 2 t and 2 t + 1 of output
//   row i at A row g's column, d[2], d[3] at row g + 8's.  Their low bits
//   are packed into byte u of word q (or q + 2) of the lane; the four lanes
//   of a quad then hold disjoint bits of the same 16 bytes, and a
//   reduce-scatter over the quad (three shuffles) leaves lane t with the
//   whole word t: 4 bytes at col + 4 t, so a warp stores 128 contiguous
//   bytes of the row.
// Zero padding: K is padded to 256 (the c bytes use 8c of the 256 k-bits;
// lanes of a quad whose rows are all >= c load nothing) and the last tile of
// a row is masked by lane.  Folding four column groups into K with a
// block-diagonal B is a later redesign.
//
// What bounds it: the bytes, (r + c) L, each input read once and each
// output written once (88 MiB for the 3x8 encode of a 64-stripe batch of
// 1 MiB stripes, ~27.5 us at 3.35 TB/s).  The binary products are r L / 16
// mma a launch (1.6 M for that encode), the byte permutes 8 a column word.
// The design is the simple one: no software pipeline, one tile a warp at a
// time, grid-stride.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gf2_mma.cuh"

namespace g4 {

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
          mma_b1(d, a, b0, b1);
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

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    return 132;
  return n;
}

}  // namespace g4

extern "C" {

// G4.  x: (c, L) bytes, y: (r, L) bytes, frag: (r, 2, 32) uint32, the B
// fragments of ec_kernels.bitmm_plan.  1 <= c <= 32, L % 16 == 0, x and y
// 16-byte aligned (the wrapper checks).  Returns cudaGetLastError().
int gf_bitmm(const void* x, void* y, const void* frag, int r, int c,
             long long L, void* stream) {
  if (r <= 0 || c <= 0 || c > 32 || L < 0 || L % 16)
    return cudaErrorInvalidValue;
  if (L == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(r) * 64 * sizeof(uint32_t);
  if (smem > g4::kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        g4::gf_bitmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long tiles = (L + g4::kTileBytes - 1) / g4::kTileBytes;
  long long blocks = (tiles + g4::kWarps - 1) / g4::kWarps;
  const long long cap =
      static_cast<long long>(g4::sm_count()) * g4::kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  g4::gf_bitmm_kernel<<<static_cast<unsigned>(blocks), g4::kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const uint32_t*>(frag), r, c, L, tiles);
  return cudaGetLastError();
}

}  // extern "C"
