// G1: standard CRC32C of fixed-length chunks on Hopper (sm_90a), the
// per-word work as GF(2) products on the tensor cores.
//
// crc32c_chunks replaces the JAX package's device CRC, which is an XLA
// graph rather than a Pallas kernel: ceph_tpu/ops/checksum.py
// CrcPlan.device_fn, a leaf map of 32 masked constants per word and a
// balanced tree of zero-extension operators.  Wrapped by
// ceph_tpu_torch/ops/checksum.py crc32c_chunks, which builds every table
// below on the host (checksum.kernel_tables) and checks shapes, dtype and
// alignment.
//
// Math.  The raw (init 0, no final xor) CRC is GF(2)-linear: a chunk of
// n words gives raw = XOR_i M^(4 (n - i)) w_i, where M^b is the 32x32
// operator that appends b zero bytes (checksum._zero_operator).  A GF(2)
// matrix-vector product is an integer product whose low bit is kept: with
// 0/1 operator entries, sum_k a_k b_k mod 2 is the XOR of the a_k whose
// b_k is 1, and only the low bit of each a_k counts.
//
// Rows.  A warp takes 32 * kV words at a time, lane l the kV words
// kV l .. kV l + kV - 1 (one 16- or 8-byte load, coalesced).  As an mma
// A operand (16 rows, fragment rows g and g + 8 in lanes 4g .. 4g + 3)
// these are 16 rows of 2 kV words each: row g + 8h (h = 0, 1) is the
// words 4 kV g + h + 2q, q < 2 kV, of the warp's tile (every other word:
// lane 4g + t holds words 2v + h of its load for row g + 8h).  kLoads
// loads a step make a row of R = 2 kV kLoads words.  One operator A =
// [M^(4 E(word))], the same for all 16 rows, gives each row's raw CRC
// relative to its own last word (E counts words from it, checksum
// kernel_tables): 4 n-tiles of 8 output bits, the operator in registers.
//
// - int8 (kB1 false, m16n8k32.s8): one k-step takes one word of each
//   row; its 32 bits sit in the low bits of the bytes of w >> j, j < 8
//   (w >> j holds bits j, j + 8, j + 16, j + 24 in bit 0 of its bytes),
//   so the unpack is one shift a register and no mask: the bits above
//   bit 0 of a byte drop out of the low bit of the product.  The host
//   lays A's columns out in that order.
// - binary (kB1 true, m16n8k256.b1 and.popc): one k-step takes the
//   whole load, lane l's four words as they are; popc(a & b) has the
//   GF(2) product in its low bit.
//
// Upper levels, by linearity.  A warp's rows are Horner chains over the
// block's steps: the s32 accumulators of a step start as the previous
// state times M^(4 kIterWords) (one more k-step, the "shift" operator)
// and the step's data is added; then the low byte of each accumulator
// is packed (byte_perm) straight into the A fragment of the next state
// k-step, since the host picked the output-bit order so that the C
// fragment of lane (g, t) is the A fragment it needs.  After the
// segment's last step, each lane applies to its 16 state bits the final
// operators M^(4 (distance of its row's last word from the segment end))
// (fin), the warp and the block XOR, and thread 0 shifts the segment's
// raw CRC past the segments after it by the binary ladder, XORs
// final_xor on segment 0 (CrcPlan.final_xor) and XORs it into the
// chunk's digest, which the C entry zeroed.  The XORs commute, so the
// blocks need no order.  A zero prefix of `pad` words makes each chunk
// whole segments: leading zeros add nothing to a raw CRC.
//
// No shared-memory table lookup remains per data word (the kernel of the
// first port, a 4 KiB byte table looked up 4 times a word, ran at 2.1x
// its bound, bound by those lookups; experiments/crc_variants.cu keeps it
// as a variant).  Blocks are persistent: each loads the operator
// fragments once and walks segments b, b + gridDim.x, ...; each lane
// loads all of a segment's words (kWords) before the chain, and the next
// segment's loads are in flight during this one's final combine.
//
// What bounds it: the bytes it reads, once each (88 MiB for the fused CRC
// of a 64-stripe k=8, m=3 batch, ~27.5 us at 3.35 TB/s); as products it
// is 32 x 32 bit-products a word, 23.9 us at the H100's int8 tensor-core
// rate.  The library launches binary products, runs of 8 words, 8 warps,
// 32 words a lane: on an H100 SXM at 700 W, ~41 us at (11, 8 MiB) in
// 128 KiB chunks, where the same walk's loads alone take ~37 us and the
// int8 products ~92 us (175 registers: one block an SM, and 7 shifts a
// word); PERF.md has the race (experiments/crc_variants.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace g1 {

// What one instantiation computes with: binary or int8 products, kV
// words a load, kLoads loads a row step, kWarps warps a block, kWords
// words a lane a segment.
template <bool kB1, int kV, int kLoads, int kWarps, int kWords>
struct Geometry {
  static_assert(kV == 2 || kV == 4, "a lane loads 2 or 4 words");
  static_assert(!kB1 || kV == 4, "a binary k-step takes 4 words a lane");
  static_assert(kWords % (kV * kLoads) == 0, "whole steps a segment");
  static constexpr int kThreads = 32 * kWarps;
  // Horner steps a segment, at most
  static constexpr int kIters = kWords / (kV * kLoads);
  // data k-steps a Horner step
  static constexpr int kSteps = kB1 ? kLoads : kLoads * kV * 2;
  // words a block takes a Horner step
  static constexpr int kIterWords = kThreads * kV * kLoads;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kB1>
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (kB1)
    mma_b1(d, a, b0, b1);
  else
    mma_s8(d, a, b0, b1);
}

// Read-only loads the compiler keeps where they are written (volatile
// asm stays in order), so all of a segment's loads are in flight before
// its chain starts.
__device__ __forceinline__ void load_words(uint32_t (&w)[4],
                                           const uint32_t* p) {
  asm volatile("ld.global.nc.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "l"(p));
}

__device__ __forceinline__ void load_words(uint32_t (&w)[2],
                                           const uint32_t* p) {
  asm volatile("ld.global.nc.v2.u32 {%0,%1}, [%2];"
               : "=r"(w[0]), "=r"(w[1])
               : "l"(p));
}

__device__ __forceinline__ uint32_t load_word(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Column form of a 32x32 GF(2) operator: cols[j] is the image of bit j
// (checksum._apply).
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* __restrict__ cols,
                                              uint32_t v) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) acc ^= cols[j] & (0u - ((v >> j) & 1u));
  return acc;
}

// The low bytes of a, b, c, d as one register.
__device__ __forceinline__ uint32_t low_bytes(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// This lane's words of segment `b` (zero in the zero prefix): step `it`,
// load p at words ((it kWarps + warp) kLoads + p) 32 kV + kV lane of the
// segment.  kVec: whole aligned loads (n_words and pad multiples of kV).
template <class G, int kV, int kLoads, bool kVec>
__device__ __forceinline__ void load_segment(
    uint32_t (&w)[G::kIters * kLoads][kV], const uint32_t* __restrict__ x,
    long long b, long long n_words, int iters, int segs, int pad) {
  const long long q = b / segs;
  const int seg = static_cast<int>(b % segs);
  const uint32_t* src = x + q * n_words;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(seg) * iters * G::kIterWords +
                         kV * lane - pad;
#pragma unroll
  for (int it = 0; it < G::kIters; ++it) {
#pragma unroll
    for (int p = 0; p < kLoads; ++p) {
      uint32_t(&d)[kV] = w[it * kLoads + p];
#pragma unroll
      for (int u = 0; u < kV; ++u) d[u] = 0u;
      if (it >= iters) continue;
      const long long i =
          base + static_cast<long long>((it * (G::kThreads / 32) + warp) *
                                            kLoads + p) * 32 * kV;
      if constexpr (kVec) {
        if (i >= 0) load_words(d, src + i);
      } else {
#pragma unroll
        for (int u = 0; u < kV; ++u)
          if (i + u >= 0) d[u] = load_word(src + i + u);
      }
    }
  }
}

// ops: [kSteps][4 n-tiles][2][32 lanes] B fragments of the data k-steps;
// shift: [4][2][32] B fragments of the state k-step, M^(4 kIterWords);
// fin: [kWarps][16 rows][32] columns of each row's final operator, by the
// A-fragment position of the state bit; ladder: [32][32], rung j is
// M^(4 segment words 2^j) by columns.
template <bool kB1, int kV, int kLoads, int kWarps, int kWords, bool kVec>
__global__ void __launch_bounds__(32 * kWarps)
    crc32c_mma_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                      const uint32_t* __restrict__ ops,
                      const uint32_t* __restrict__ shift,
                      const uint32_t* __restrict__ fin,
                      const uint32_t* __restrict__ ladder, long long n_words,
                      long long blocks, int iters, int segs, int pad,
                      uint32_t final_xor) {
  using G = Geometry<kB1, kV, kLoads, kWarps, kWords>;
  __shared__ uint32_t part[2][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t op[G::kSteps][4][2];
#pragma unroll
  for (int s = 0; s < G::kSteps; ++s)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        op[s][nt][r] = __ldg(ops + ((s * 4 + nt) * 2 + r) * 32 + lane);
  uint32_t sh[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      sh[nt][r] = __ldg(shift + (nt * 2 + r) * 32 + lane);

  uint32_t w[G::kIters * kLoads][kV];
  long long b = blockIdx.x;
  if (b < blocks)
    load_segment<G, kV, kLoads, kVec>(w, x, b, n_words, iters, segs, pad);
  for (int parity = 0; b < blocks; b += gridDim.x, parity ^= 1) {
    // the rows' Horner chains over the segment's steps
    uint32_t st[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int it = 0; it < G::kIters; ++it) {
      if (it >= iters) break;
      int acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
        if (it > 0) mma<kB1>(acc[nt], st, sh[nt][0], sh[nt][1]);
      }
#pragma unroll
      for (int p = 0; p < kLoads; ++p) {
        const uint32_t(&d)[kV] = w[it * kLoads + p];
        if constexpr (kB1) {
          const uint32_t a[4] = {d[0], d[1], d[2], d[3]};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma<kB1>(acc[nt], a, op[p][nt][0], op[p][nt][1]);
        } else {
#pragma unroll
          for (int v = 0; v < kV / 2; ++v) {
            const uint32_t lo = d[2 * v], hi = d[2 * v + 1];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t a[4] = {lo >> j, hi >> j, lo >> (j + 4),
                                     hi >> (j + 4)};
              const int s = (p * (kV / 2) + v) * 4 + j;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma<kB1>(acc[nt], a, op[s][nt][0], op[s][nt][1]);
            }
          }
        }
      }
      // C fragment of lane (g, t) -> A fragment of the next state k-step
      st[0] = low_bytes(acc[0][0], acc[0][1], acc[1][0], acc[1][1]);
      st[1] = low_bytes(acc[0][2], acc[0][3], acc[1][2], acc[1][3]);
      st[2] = low_bytes(acc[2][0], acc[2][1], acc[3][0], acc[3][1]);
      st[3] = low_bytes(acc[2][2], acc[2][3], acc[3][2], acc[3][3]);
    }
    const long long cur = b;
    if (b + gridDim.x < blocks)  // the next segment's loads in flight now
      load_segment<G, kV, kLoads, kVec>(w, x, b + gridDim.x, n_words, iters,
                                        segs, pad);
    // each row's state shifted to the segment's end, XOR over the block
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i & 1);
      const uint4 f = __ldg(reinterpret_cast<const uint4*>(
          fin + (warp * 16 + row) * 32 + 16 * (i >> 1) + 4 * t));
      v ^= f.x & (0u - (st[i] & 1u));
      v ^= f.y & (0u - ((st[i] >> 8) & 1u));
      v ^= f.z & (0u - ((st[i] >> 16) & 1u));
      v ^= f.w & (0u - ((st[i] >> 24) & 1u));
    }
#pragma unroll
    for (int dl = 16; dl > 0; dl >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, dl);
    if (lane == 0) part[parity][warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long q = cur / segs;
      const int seg = static_cast<int>(cur % segs);
      uint32_t raw = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) raw ^= part[parity][i];
      for (int d = segs - 1 - seg, j = 0; d; d >>= 1, ++j)
        if (d & 1) raw = gf2_apply(ladder + 32 * j, raw);
      if (seg == 0) raw ^= final_xor;
      atomicXor(y + q, raw);
    }
  }
}

// Resident blocks of one instantiation on the current device, times its
// SMs: the persistent grid.  0 on a CUDA error.
template <bool kB1, int kV, int kLoads, int kWarps, int kWords, bool kVec>
int persistent_grid() {
  static int cached[64];  // per device; a race stores the same value
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, crc32c_mma_kernel<kB1, kV, kLoads, kWarps, kWords, kVec>,
            32 * kWarps, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

// Checks the split, zeroes y on `stream`, launches a persistent grid.
// Returns a cudaError_t.
template <bool kB1, int kV, int kLoads, int kWarps, int kWords>
int launch(const void* x, void* y, const void* ops, const void* shift,
           const void* fin, const void* ladder, long long chunks,
           long long n_words, int iters, int segs, int pad,
           unsigned int final_xor, void* stream) {
  using G = Geometry<kB1, kV, kLoads, kWarps, kWords>;
  const long long seg_words = static_cast<long long>(iters) * G::kIterWords;
  if (chunks < 0 || n_words <= 0 || iters < 1 || iters > G::kIters ||
      segs < 1 || pad < 0 || pad >= seg_words ||
      segs * seg_words - pad != n_words || chunks * segs > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (chunks == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(y, 0, chunks * sizeof(uint32_t), s);
  if (e != cudaSuccess) return e;
  const long long blocks = chunks * segs;
  const bool vec = n_words % kV == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * kV) == 0;
  auto kernel = vec ? crc32c_mma_kernel<kB1, kV, kLoads, kWarps, kWords, true>
                    : crc32c_mma_kernel<kB1, kV, kLoads, kWarps, kWords, false>;
  const int resident =
      vec ? persistent_grid<kB1, kV, kLoads, kWarps, kWords, true>()
          : persistent_grid<kB1, kV, kLoads, kWarps, kWords, false>();
  if (resident <= 0) return cudaErrorLaunchFailure;
  const unsigned grid =
      static_cast<unsigned>(blocks < resident ? blocks : resident);
  kernel<<<grid, G::kThreads, 0, s>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(ops), static_cast<const uint32_t*>(shift),
      static_cast<const uint32_t*>(fin), static_cast<const uint32_t*>(ladder),
      n_words, blocks, iters, segs, pad, final_xor);
  return cudaGetLastError();
}

}  // namespace g1

extern "C" {

// G1.  x: (chunks, n_words) uint32 little-endian words, 4-byte aligned;
// y: (chunks,) uint32 standard CRC32C.  ops, shift, fin, ladder: the
// tables of checksum.kernel_tables for this setting (binary products,
// 4 words a load, 1 load a step, 8 warps, 32 words a lane: checksum
// CRC_GEOMETRY mirrors the template arguments); segs * iters * 1024 - pad
// == n_words, 1 <= iters <= 8, 0 <= pad < iters * 1024
// (checksum.kernel_split; the wrapper checks).  Returns cudaGetLastError().
int crc32c_chunks(const void* x, void* y, const void* ops, const void* shift,
                  const void* fin, const void* ladder, long long chunks,
                  long long n_words, int iters, int segs, int pad,
                  unsigned int final_xor, void* stream) {
  return g1::launch<true, 4, 1, 8, 32>(x, y, ops, shift, fin, ladder, chunks,
                                       n_words, iters, segs, pad, final_xor,
                                       stream);
}

}  // extern "C"
