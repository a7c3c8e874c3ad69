// Erasure-code region kernels for Hopper (sm_90a): out(r, n4) = M(r, c) . x(c, n4)
// over GF(2^8) (K1, K2) or over GF(2) (K3), on uint32 lanes that each hold 4
// bytes of a row.
//
// Three kernels, all wrapped by ceph_tpu_torch/ops/ec_kernels.py and bound
// through a plain C interface (ctypes, see ops/cuda_lib.py):
//
// gf_bitterm (K1) replaces the Pallas bit-term kernel of the JAX package,
//   ceph_tpu/ops/ec_kernels.py RegionMatmul._lanes_op with the body
//   _rows_op/_accumulate_row over _terms, which spends 8 shift-mask-multiply
//   terms on every general coefficient.  Here the product is a nibble-table
//   lookup done by byte permutes (PTX prmt, SASS PRMT), four bytes at once:
//   a * b = lo_a[b & 15] ^ hi_a[b >> 4] with lo_a[n] = a * n and
//   hi_a[n] = a * (n << 4), the host's ec_kernels.nibble_table(M), (r, c, 32)
//   bytes lo[16] then hi[16].  A prmt picks 4 bytes out of 8 by 3-bit
//   indices, so the kernel splits each nibble once more, by linearity:
//   lo_a[n] = lo_a[n & 7] ^ (bit 3 of n ? lo_a[8] : 0), and the same for hi.
//   1. Per input word v, shared by every output row: the selectors (bits
//      0-2 and bits 4-6 of each byte k packed into nibble k, an AND, a shift,
//      an OR and a prmt each) and the byte masks of bits 3 and 7 (a prmt in
//      sign-replicate mode on v << 4 and on v): 12 instructions as
//      written, 10 as ptxas issues them.
//   2. Per word and general coefficient: one prmt on lo[0..7], one on
//      hi[0..7], one 3-input XOR of both into the accumulator, and one
//      AND-XOR each for the bit-3 and bit-7 terms (lo[8], hi[8] broadcast
//      to 4 bytes once per coefficient and thread): 5 instructions as
//      written, which ptxas issues as 2 PRMT and 3-4 LOP3.  A
//      coefficient 1 is one XOR, a 0 is skipped; the matrix is the same for
//      every thread, so these branches are warp-uniform.
//   Layout: a grid-stride loop over 16-byte lane groups (uint4), neighbouring
//   threads on neighbouring addresses.  A thread loads kBitermBatch input
//   rows of its group at once, then applies them to kRowBlock output rows
//   held in registers; x is re-read only ceil(r / kRowBlock) times (the
//   re-reads hit L1/L2).  The table and the coefficient bytes (the skip /
//   plain-XOR flags) are staged once per block in shared memory, 33 bytes
//   per coefficient, and read as warp-uniform 16-byte broadcasts, one pair
//   per coefficient for the thread's 4 words.
//   What bounds it: bytes are c*N read and r*N written (for the 8+3 encode
//   at N = 8 MiB per row, 88 MiB, ~27.5 us at 3.35 TB/s).  Its instruction
//   mix for that encode, as ptxas issues it, is 726 ALU instructions per
//   16-byte column group of all rows (9 per input word: ptxas turns the
//   OR-with-shift into LEA.HI and the shift left into an FMA-pipe IMAD; 25
//   per general coefficient and group; 4 per coefficient 1; 2 flag
//   compares per coefficient; chip_smoke.bitterm_mix), ~23 us at 64
//   results per clock per SM, 132 SMs and 1.98 GHz, under the byte bound;
//   the bit-term chain it replaced needed ~42 us there.  On an H100
//   SXM at 700 W its loads and stores alone run at a device copy's time
//   (~36 us) and the selectors add ~1 us, but each coefficient's flag and
//   table loads feed warp-uniform branches and the permutes behind them, so
//   the loop needs warps to hide that latency: at 97 registers (2 blocks of
//   256 per SM) the encode took ~49 us; 4 input rows at once and
//   __launch_bounds__(256, 4) hold it to 64 registers with no spills, 4
//   blocks per SM, ~42 us.  More blocks spill; 8 rows in registers, whole
//   16-entry lookups, no flags (every coefficient by its table) or
//   128-thread blocks were no faster at both the encode and the 8x8 decode
//   (experiments/kernel_variants.cu sets these switches of this same
//   loop).
//
// gf_bitxor (K2) replaces the Pallas bitxor body of the same kernel,
//   ceph_tpu/ops/ec_kernels.py _bitxor_rows (chosen by RegionMatmul
//   _rows_core): the product as XORs of GF(2) bit-planes, B = bitmatrix(M)
//   (8r x 8c), where output plane 8i+t is the XOR of the input planes 8j+s
//   with B[8i+t, 8j+s] = 1.  It is bit-sliced:
//   1. A thread owns a 32-byte column group of every row: the uint4 at g and
//      the uint4 at g + n4/8 (two coalesced loads a row, kBitxorBatch rows
//      in flight at once).  It transposes the group's 8 words in registers
//      into 8 plane words (bitslice: three delta-swap stages), word s
//      holding bit s of all 32 bytes, and stores them in shared memory laid
//      out [plane][thread], so a thread only touches its own column and the
//      loop needs no barrier.
//   2. Each output plane is one register, the XOR of the planes that row of
//      B names: the host lists them (ec_kernels.bitxor_plan) as a CSR whose
//      rows are padded to whole quads with the zero plane 8c, read as one
//      warp-uniform int4 per four planes (staged as [plane][thread] offsets,
//      so a term is an add, a shared load and half a 3-input XOR).  No term
//      is predicated off and no plane is shifted: the shift of the JAX body
//      is the inverse transpose.
//   3. The 8 planes of output row i are transposed back (bitslice is its
//      own inverse) and stored as two uint4.
//   The plan is staged in shared memory beside the planes when both fit
//   48 KiB, else read from global memory through the cache.  Block size:
//   the largest of 256..32 threads whose planes fit 40 KiB (128 for c = 8).
//   What bounds it: per 256 input bytes of the 3x8 encode about 660
//   transpose operations (11 transposes of ~60), 576 plane loads and 64
//   plane stores, so ~19 us on the ALU pipe and ~23 us of shared-memory
//   accesses at 132 SMs and 1.98 GHz, against ~27.5 us of bytes.  Measured
//   on an H100 SXM at 700 W (chip_smoke.py, and experiments/
//   kernel_variants.py, which switches the loop's phases off one at a
//   time): the input phase alone takes ~40 us, the CSR walk alone ~40 us,
//   the transposes under 1 % of the whole, and the two phases overlap only
//   in part, so it runs at ~2.1x the byte bound (K1: ~1.55x).  Keep the
//   loop in one function: with its input phase in a device function of its
//   own, ptxas kept the shared-memory base in a vector register instead of
//   a uniform one, the CSR walk's addresses moved from LEA to IMAD, and
//   the kernel ran slower.
//
// gf_sched_xor (K3) replaces the Pallas kernel of the JAX package's
//   ScheduledXor (ceph_tpu/ops/ec_kernels.py ScheduledXor._rows_op, body
//   _sched_plane_rows): out(R, L) = B(R, C) . x(C, L) over GF(2) for the
//   bit-matrix codes (liberation, blaum_roth, liber8tion), whose rows are
//   packet rows already, so each output row is the XOR of the input rows
//   where B[r, c] = 1, with no bit extraction and no packing.  It does not
//   run the CSE'd schedule: the host lowers B (ec_kernels.sched_xor_plan)
//   into blocks of kSchedRows output rows and, for each block, the list of
//   (input row, mask) pairs of the inputs that feed it, mask bit i set when
//   the input feeds row i of the block.  A thread walks 16-byte column groups
//   (uint4) in a grid-stride loop, keeps the block's kSchedRows accumulators
//   in registers, reads each listed input row once and XORs it into the
//   rows of its mask, then stores the block's rows; an empty row stores
//   zeros.  The loads are pipelined: the next kBatch inputs are in flight
//   while the current kBatch are XORed in (on an H100 SXM at 700 W the
//   loop that waited for each batch before XORing it ran at ~1.5 TB/s,
//   the pipelined one at ~2.1 TB/s, against ~2.5 TB/s for a device copy
//   of the same bytes).  It needs ~142 registers, so it runs in 128-thread
//   blocks: three fit an SM, where one 256-thread block would.  The plan is
//   staged in shared memory when it fits 48 KiB, else read from global
//   memory through the cache.
//   Packet mode: the codec's chunks are (n, L) with L = G * w * 64, and
//   packet row j*w + p at granule gi and byte o lives at byte
//   j*L + gi*w*64 + p*64 + o.  The plan names each input row as (j, p), and
//   column group g = (gi, o / 16) reads and writes at those addresses, so
//   the chunks go in and come out as they are, with no permute around the
//   kernel.  Plane-row mode is the same addressing at w = 1.
//   What bounds it: bytes.  Every input row is read once per block of 16
//   output rows (once for every bit-matrix code of m = 2, where R = 2w <= 16)
//   and every output row is written once, (C + R) * L bytes: 117 MB for the
//   liberation k=5 encode of an 80 MiB object (L = 2,396,800), 35 us at
//   3.35 TB/s.  The work is about 80 instructions per (input row, block) pair
//   per column group: 35 * 80 per 16 bytes for that encode, ~13 M warp
//   instructions, ~12.5 us at 4 issued per clock on 132 SMs at 1.98 GHz;
//   it hides the loads only when they are pipelined.
//   The knobs the code fixes (kSchedBatch loads in flight, kSchedThreads a
//   block, kSchedPerSm blocks per SM; no register cap, plain stores) were
//   chosen by timing the others with experiments/kernel_variants.py, which
//   instantiates this same loop at other template arguments.
//
// None of them uses the tensor cores; wgmma and TMA are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowBlock = 4;        // output rows a gf_bitterm thread holds
constexpr int kBitermBatch = 4;     // input rows loaded at once by gf_bitterm
constexpr int kBitermThreads = 256;
constexpr int kBitermMinBlocks = 4;  // its blocks per SM: 64 registers
constexpr int kBitermPerSm = 16;    // gf_bitterm's grid cap, blocks per SM
constexpr int kBitxorBatch = 8;     // input rows loaded at once by gf_bitxor
constexpr int kSchedRows = 16;      // must match ec_kernels.SCHED_ROW_BLOCK
constexpr int kSchedBatch = 4;      // loads in flight a thread in gf_sched_xor
constexpr int kSchedThreads = 128;  // gf_sched_xor's block size
constexpr int kSchedPerSm = 8;      // gf_sched_xor's grid cap, blocks per SM
constexpr int kPacketLanes = 4;     // uint4 lanes of a 64-byte packet
constexpr size_t kSmemDefault = 48 * 1024;

__device__ __forceinline__ void xor4(uint4& a, const uint4& b) {
  a.x ^= b.x; a.y ^= b.y; a.z ^= b.z; a.w ^= b.w;
}

// PTX prmt.b32 in its default mode: byte n of the result is byte
// (s >> 4n) & 7 of the 8 bytes {b, a} (bytes 0-3 from a), or, where bit
// 4n + 3 of s is set, that byte's top bit copied into all 8 bits.  Only
// the low 16 bits of s are read.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// What gf_bitterm computes once per input word, for every output row.
struct Nibbles {
  uint32_t lo;   // nibble k = bits 0-2 of byte k: prmt selector into lo[0..7]
  uint32_t hi;   // nibble k = bits 4-6 of byte k: prmt selector into hi[0..7]
  uint32_t mlo;  // byte k = 0xff where bit 3 of byte k is set
  uint32_t mhi;  // byte k = 0xff where bit 7 of byte k is set
};

__device__ __forceinline__ Nibbles nibbles(uint32_t v) {
  // t has the 3-bit index of byte k at bits 8k..8k+2; t | t >> 4 puts those
  // of bytes 0 and 1 in byte 0 and those of bytes 2 and 3 in byte 2
  const uint32_t t = v & 0x07070707u;
  const uint32_t h = (v >> 4) & 0x07070707u;
  Nibbles n;
  n.lo = prmt(t | (t >> 4), 0u, 0x0020u);
  n.hi = prmt(h | (h >> 4), 0u, 0x0020u);
  n.mlo = prmt(v << 4, 0u, 0xBA98u);  // sign-replicate bytes 0-3
  n.mhi = prmt(v, 0u, 0xBA98u);
  return n;
}

// gf_bitterm's ways of multiplying: the library's product (kSplit), the
// product by whole 16-entry lookups (kSelect16), and the two phases alone,
// which experiments/kernel_variants.cu times.
enum BitermMode { kSplit, kSelect16, kLoadsOnly, kSelectorsOnly };

// acc ^= a * v over GF(2^8) for one coefficient a, given v's Nibbles and
// a's table (lo = lo_a[0..15], hi = hi_a[0..15] as uint4).
template <int kMode>
__device__ __forceinline__ uint32_t mul_word(const Nibbles& n, const uint4& lo,
                                             const uint4& hi, uint32_t b8,
                                             uint32_t b128) {
  if constexpr (kMode == kSelect16) {
    // 16 entries: one prmt on entries 0-7, one on 8-15, bit 3 chooses
    const uint32_t l0 = prmt(lo.x, lo.y, n.lo), l1 = prmt(lo.z, lo.w, n.lo);
    const uint32_t h0 = prmt(hi.x, hi.y, n.hi), h1 = prmt(hi.z, hi.w, n.hi);
    return ((l0 & ~n.mlo) | (l1 & n.mlo)) ^ ((h0 & ~n.mhi) | (h1 & n.mhi));
  } else {
    // lo_a[n] = lo_a[n & 7] ^ (bit 3 ? lo_a[8] : 0), the same for hi
    return prmt(lo.x, lo.y, n.lo) ^ prmt(hi.x, hi.y, n.hi) ^ (n.mlo & b8) ^
           (n.mhi & b128);
  }
}

// K1's loop.  kRows output rows are held in registers and kBatch input rows
// loaded at once; the library instantiates the defaults.  The other
// settings are for experiments/kernel_variants.cu: kMode (the combine, or
// one phase alone), kThreads and kMinBlocks (block size, register cap),
// and kFlags (false: every coefficient, 0 and 1 too, through its table,
// with no branch and no flag load).
template <int kRows = kRowBlock, int kBatch = kBitermBatch, int kMode = kSplit,
          int kThreads = kBitermThreads, int kMinBlocks = kBitermMinBlocks,
          bool kFlags = true>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gf_bitterm_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                  const uint8_t* __restrict__ coef,
                  const uint4* __restrict__ tab, int r, int c,
                  long long groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rc = r * c;
  uint4* s_tab = reinterpret_cast<uint4*>(smem);  // lo, hi per coefficient
  uint8_t* s_coef = smem + static_cast<size_t>(rc) * 2 * sizeof(uint4);
  for (int t = threadIdx.x; t < 2 * rc; t += blockDim.x) s_tab[t] = tab[t];
  for (int t = threadIdx.x; t < rc; t += blockDim.x) s_coef[t] = coef[t];
  __syncthreads();
  // input rows j0.. of column group g
  auto load = [&](long long g, int j0, uint4 (&v)[kBatch]) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      v[b] = make_uint4(0, 0, 0, 0);
      if (j0 + b < c) v[b] = x[static_cast<long long>(j0 + b) * groups + g];
    }
  };
  // acc[ii] ^= M[i0 + ii, j0 + b] * v[b] for the rows and inputs there are
  auto apply = [&](const uint4 (&v)[kBatch], int i0, int j0,
                   uint4 (&acc)[kRows]) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = j0 + b;
      if (j >= c) break;
      if constexpr (kMode == kLoadsOnly) {
        xor4(acc[0], v[b]);
        continue;
      }
      const Nibbles n[4] = {nibbles(v[b].x), nibbles(v[b].y),
                            nibbles(v[b].z), nibbles(v[b].w)};
      if constexpr (kMode == kSelectorsOnly) {
        acc[0].x ^= n[0].lo ^ n[0].hi ^ n[0].mlo ^ n[0].mhi;
        acc[0].y ^= n[1].lo ^ n[1].hi ^ n[1].mlo ^ n[1].mhi;
        acc[0].z ^= n[2].lo ^ n[2].hi ^ n[2].mlo ^ n[2].mhi;
        acc[0].w ^= n[3].lo ^ n[3].hi ^ n[3].mlo ^ n[3].mhi;
        continue;
      }
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        const int i = i0 + ii;
        if (i >= r) break;
        const int k = i * c + j;
        const uint8_t cf = kFlags ? s_coef[k] : 2;
        if (cf == 1) {
          xor4(acc[ii], v[b]);
        } else if (cf != 0) {
          const uint4 lo = s_tab[2 * k], hi = s_tab[2 * k + 1];
          const uint32_t b8 = prmt(lo.z, 0u, 0u);    // lo_a[8] = a * 8
          const uint32_t b128 = prmt(hi.z, 0u, 0u);  // hi_a[8] = a * 128
          acc[ii].x ^= mul_word<kMode>(n[0], lo, hi, b8, b128);
          acc[ii].y ^= mul_word<kMode>(n[1], lo, hi, b8, b128);
          acc[ii].z ^= mul_word<kMode>(n[2], lo, hi, b8, b128);
          acc[ii].w ^= mul_word<kMode>(n[3], lo, hi, b8, b128);
        }
      }
    }
  };
  auto store = [&](long long g, int i0, const uint4 (&acc)[kRows]) {
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii) {
      if (i0 + ii < r)
        y[static_cast<long long>(i0 + ii) * groups + g] = acc[ii];
    }
  };
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; g < groups; g += stride) {
    for (int i0 = 0; i0 < r; i0 += kRows) {
      uint4 acc[kRows];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) acc[ii] = make_uint4(0, 0, 0, 0);
      for (int j0 = 0; j0 < c; j0 += kBatch) {
        uint4 v[kBatch];
        load(g, j0, v);
        apply(v, i0, j0, acc);
      }
      store(g, i0, acc);
    }
  }
}

// One delta-swap stage over the pairs (k, k + kStride) of w: bit kStride of
// the word number trades places with bit kStride of the bit position.
template <int kStride>
__device__ __forceinline__ void swap_stage(uint32_t (&w)[8], uint32_t m) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k & kStride) continue;
    const uint32_t t = ((w[k] >> kStride) ^ w[k + kStride]) & m;
    w[k + kStride] ^= t;
    w[k] ^= t << kStride;
  }
}

// 32 bytes as 8 little-endian words (word k = bytes 4k..4k+3) <-> 8 planes:
// afterwards word s holds bit s of every byte, bit 8b + k of it from byte
// 4k + b.  The three stages swap the word number's bits with the low three
// bits of the bit position, so the transpose is its own inverse.
__device__ __forceinline__ void bitslice(uint32_t (&w)[8]) {
  swap_stage<1>(w, 0x55555555u);
  swap_stage<2>(w, 0x33333333u);
  swap_stage<4>(w, 0x0f0f0f0fu);
}

// K2's loop.  It loads kBatch input rows at once.  kIn (the input phase:
// loads, transposes, plane stores), kWalk (the CSR walk) and kSlice (the
// transposes) are always on in the library, which computes the product;
// experiments/kernel_variants.cu switches them off one at a time to time
// the phases of this same loop alone.
template <bool kStage, int kBatch = kBitxorBatch, bool kIn = true,
          bool kWalk = true, bool kSlice = true>
__global__ void gf_bitxor_kernel(const uint4* __restrict__ x,
                                 uint4* __restrict__ y,
                                 const int* __restrict__ ptr,
                                 const int4* __restrict__ idx, int r, int c,
                                 int n_quads, long long groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  const int n_planes = 8 * c + 1;  // plane 8c stays zero: the CSR's padding
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem);  // [plane][thread]
  const int* p = ptr;
  const int4* q = idx;
  if constexpr (kStage) {  // plane numbers staged as [plane][thread] offsets
    int4* s_idx = reinterpret_cast<int4*>(planes + n_planes * nt);
    int* s_ptr = reinterpret_cast<int*>(s_idx + n_quads);
    for (int t = threadIdx.x; t < n_quads; t += nt) {
      const int4 o = idx[t];
      s_idx[t] = make_int4(o.x * nt, o.y * nt, o.z * nt, o.w * nt);
    }
    for (int t = threadIdx.x; t <= 8 * r; t += nt) s_ptr[t] = ptr[t];
    __syncthreads();
    p = s_ptr;
    q = s_idx;
  }
  uint32_t* pt = planes + threadIdx.x;
  pt[(n_planes - 1) * nt] = 0u;
  const long long row = 2 * groups;  // uint4 lanes per row
  const long long stride = static_cast<long long>(gridDim.x) * nt;
  for (long long g = static_cast<long long>(blockIdx.x) * nt + threadIdx.x;
       g < groups; g += stride) {
    for (int j0 = 0; kIn && j0 < c; j0 += kBatch) {
      uint4 v[2 * kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (j0 + b < c) {
          const uint4* xr = x + static_cast<long long>(j0 + b) * row + g;
          v[2 * b] = xr[0];
          v[2 * b + 1] = xr[groups];
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (j0 + b < c) {
          uint32_t w[8] = {v[2 * b].x,     v[2 * b].y,     v[2 * b].z,
                           v[2 * b].w,     v[2 * b + 1].x, v[2 * b + 1].y,
                           v[2 * b + 1].z, v[2 * b + 1].w};
          if constexpr (kSlice) bitslice(w);
#pragma unroll
          for (int s = 0; s < 8; ++s) pt[(8 * (j0 + b) + s) * nt] = w[s];
        }
      }
    }
    for (int i = 0; i < r; ++i) {
      uint32_t acc[8];
      if constexpr (kWalk) {
        int k = p[8 * i];
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          uint32_t a = 0u;
          const int end = p[8 * i + s + 1];
#pragma unroll 2
          for (; k < end; ++k) {
            int4 o = q[k];
            if constexpr (!kStage) {
              o = make_int4(o.x * nt, o.y * nt, o.z * nt, o.w * nt);
            }
            a ^= (pt[o.x] ^ pt[o.y]) ^ (pt[o.z] ^ pt[o.w]);
          }
          acc[s] = a;
        }
      } else {  // the first 8 planes, as they are
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[s] = pt[s * nt];
      }
      if constexpr (kSlice) bitslice(acc);
      uint4* yr = y + static_cast<long long>(i) * row + g;
      yr[0] = make_uint4(acc[0], acc[1], acc[2], acc[3]);
      yr[groups] = make_uint4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
}

// gf_sched_xor's XOR step: input v[j] into the accumulators of the rows
// its mask names.  The mask is the same for the whole warp, so the
// predicated XORs never diverge.
struct MaskedXor {
  template <int kBatch>
  __device__ __forceinline__ static void apply(uint4 (&acc)[kSchedRows],
                                               const uint4 (&v)[kBatch],
                                               const uint32_t (&mask)[kBatch]) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
#pragma unroll
      for (int i = 0; i < kSchedRows; ++i) {
        if ((mask[j] >> i) & 1u) xor4(acc[i], v[j]);
      }
    }
  }
};

// K3's loop.  Its fixed knobs (loads in flight, block size, the register
// cap of __launch_bounds__, streaming stores, the XOR step) are template
// arguments so that experiments/kernel_variants.cu can time other
// settings of this same loop; the library instantiates one
// (gf_sched_xor below).
template <int kBatch, int kThreads, int kMinBlocks = 1, bool kStream = false,
          class XorIn = MaskedXor>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gf_sched_xor_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                    const int* __restrict__ ptr,
                    const int4* __restrict__ entries, int rows,
                    int n_entries, int w, bool stage, long long lanes,
                    long long cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_blocks = (rows + kSchedRows - 1) / kSchedRows;
  const int* p = ptr;
  const int4* e = entries;
  if (stage) {  // the same for every thread of the launch
    int4* s_e = reinterpret_cast<int4*>(smem);
    int* s_p = reinterpret_cast<int*>(s_e + n_entries);
    for (int t = threadIdx.x; t < n_entries; t += blockDim.x) s_e[t] = entries[t];
    for (int t = threadIdx.x; t <= n_blocks; t += blockDim.x) s_p[t] = ptr[t];
    __syncthreads();
    p = s_p;
    e = s_e;
  }
  // a row is `lanes` uint4 lanes and `cols` = lanes / w column groups;
  // packet p of chunk j at granule gi starts at lane
  // j * lanes + gi * w * kPacketLanes + p * kPacketLanes
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < cols; g += stride) {
    const long long lane = (g / kPacketLanes) * w * kPacketLanes +
                           g % kPacketLanes;
    for (int b = 0; b < n_blocks; ++b) {
      uint4 acc[kSchedRows];
#pragma unroll
      for (int i = 0; i < kSchedRows; ++i) acc[i] = make_uint4(0, 0, 0, 0);
      const int end = p[b + 1];
      // kBatch entries: their inputs and row masks (0 past the end)
      auto load = [&](int k, uint4 (&v)[kBatch], uint32_t (&mask)[kBatch]) {
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          mask[j] = 0u;
          v[j] = make_uint4(0, 0, 0, 0);
          if (k + j < end) {
            const int4 en = e[k + j];  // (chunk, packet, mask, 0)
            mask[j] = static_cast<uint32_t>(en.z);
            v[j] = x[static_cast<long long>(en.x) * lanes +
                     en.y * kPacketLanes + lane];
          }
        }
      };
      // pipelined: the next batch's loads are in flight while this batch
      // is XORed in
      uint4 v[kBatch];
      uint32_t mask[kBatch];
      load(p[b], v, mask);
      for (int k = p[b]; k < end; k += kBatch) {
        uint4 vn[kBatch];
        uint32_t mn[kBatch];
        load(k + kBatch, vn, mn);
        XorIn::apply(acc, v, mask);
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          v[j] = vn[j];
          mask[j] = mn[j];
        }
      }
      const int r0 = b * kSchedRows;
      int jo = r0 / w;
      int po = r0 - jo * w;
#pragma unroll
      for (int i = 0; i < kSchedRows; ++i) {
        if (r0 + i < rows) {
          uint4* dst = y + static_cast<long long>(jo) * lanes +
                       po * kPacketLanes + lane;
          if constexpr (kStream) {
            __stcs(dst, acc[i]);
          } else {
            *dst = acc[i];
          }
        }
        if (++po == w) {
          po = 0;
          ++jo;
        }
      }
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

long long grid_for(long long work, int threads, int per_sm) {
  long long blocks = (work + threads - 1) / threads;
  const long long cap = static_cast<long long>(sm_count()) * per_sm;
  return blocks < cap ? blocks : cap;
}

int smem_optin() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return n;
}

// gf_bitterm_kernel<...> over `groups` uint4 lane groups, at most
// kBitermPerSm blocks per SM, its table and flags (33 bytes a coefficient)
// staged in shared memory.
template <int kRows = kRowBlock, int kBatch = kBitermBatch, int kMode = kSplit,
          int kThreads = kBitermThreads, int kMinBlocks = kBitermMinBlocks,
          bool kFlags = true>
cudaError_t launch_bitterm(const void* x, void* y, const void* coef,
                           const void* tab, int r, int c, long long groups,
                           cudaStream_t stream) {
  auto* kernel = gf_bitterm_kernel<kRows, kBatch, kMode, kThreads, kMinBlocks,
                                   kFlags>;
  const size_t smem = static_cast<size_t>(r) * c * (2 * sizeof(uint4) + 1);
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = grid_for(groups, kThreads, kBitermPerSm);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y),
      static_cast<const uint8_t*>(coef), static_cast<const uint4*>(tab), r, c,
      groups);
  return cudaGetLastError();
}

// gf_bitxor_kernel<kStage, kBatch, kIn, kWalk, kSlice> in blocks of
// `threads` with `smem` bytes of shared memory.
template <bool kStage, int kBatch = kBitxorBatch, bool kIn = true,
          bool kWalk = true, bool kSlice = true>
cudaError_t launch_bitxor(const void* x, void* y, const void* ptr,
                          const void* idx, int r, int c, int n_quads,
                          long long groups, int threads, size_t smem,
                          cudaStream_t stream) {
  auto* kernel = gf_bitxor_kernel<kStage, kBatch, kIn, kWalk, kSlice>;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = grid_for(groups, threads, 32);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y),
      static_cast<const int*>(ptr), static_cast<const int4*>(idx), r, c,
      n_quads, groups);
  return cudaGetLastError();
}

// gf_sched_xor_kernel<kBatch, kThreads, kMinBlocks, kStream, XorIn> at
// most per_sm blocks per SM.
template <int kBatch, int kThreads, int kMinBlocks = 1, bool kStream = false,
          class XorIn = MaskedXor>
cudaError_t launch_sched(const void* x, void* y, const void* ptr,
                         const void* entries, int rows, int n_entries, int w,
                         long long lanes, int per_sm, cudaStream_t stream) {
  const int n_blocks = (rows + kSchedRows - 1) / kSchedRows;
  const size_t smem = static_cast<size_t>(n_entries) * sizeof(int4) +
                      static_cast<size_t>(n_blocks + 1) * sizeof(int);
  const bool stage = smem <= kSmemDefault;
  const long long cols = lanes / w;
  const long long blocks = grid_for(cols, kThreads, per_sm);
  gf_sched_xor_kernel<kBatch, kThreads, kMinBlocks, kStream, XorIn>
      <<<static_cast<unsigned>(blocks), kThreads, stage ? smem : 0, stream>>>(
          static_cast<const uint4*>(x), static_cast<uint4*>(y),
          static_cast<const int*>(ptr), static_cast<const int4*>(entries),
          rows, n_entries, w, stage, lanes, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1.  x: (c, n4) uint32, y: (r, n4) uint32, coef: (r, c) bytes,
// tab: (r, c, 32) bytes, lo[16] = M[i,j] * n then hi[16] = M[i,j] * (n << 4)
// (ec_kernels.nibble_table).  n4 % 4 == 0, pointers 16-byte aligned (the
// wrapper checks).  Returns cudaGetLastError().
int gf_bitterm(const void* x, void* y, const void* coef, const void* tab,
               int r, int c, long long n4, void* stream) {
  if (r <= 0 || c <= 0 || n4 < 0 || n4 % 4) return cudaErrorInvalidValue;
  if (n4 == 0) return cudaSuccess;
  return launch_bitterm(x, y, coef, tab, r, c, n4 / 4,
                        static_cast<cudaStream_t>(stream));
}

// K2.  x: (c, n4) uint32, y: (r, n4) uint32; ptr: (8r + 1) int32 quad
// offsets and idx: (n_quads, 4) int32 plane numbers, the plan of
// ec_kernels.bitxor_plan.  n4 % 8 == 0, pointers 16-byte aligned (the
// wrapper checks).  Block size: the largest of 256..32 threads whose
// (8c + 1) planes fit 40 KiB, else 32 threads with the planes in what a
// block may opt in to; the plan is staged beside the planes when the two fit
// 48 KiB.
int gf_bitxor(const void* x, void* y, const void* ptr, const void* idx,
              int r, int c, int n_quads, long long n4, void* stream) {
  if (r <= 0 || c <= 0 || n_quads < 0 || n4 < 0 || n4 % 8)
    return cudaErrorInvalidValue;
  if (n4 == 0) return cudaSuccess;
  const size_t per_thread = static_cast<size_t>(8 * c + 1) * sizeof(uint32_t);
  int threads = 32;
  for (int t = 256; t > 32; t >>= 1) {
    if (per_thread * t <= 40 * 1024) {
      threads = t;
      break;
    }
  }
  const size_t planes = per_thread * threads;
  if (planes > static_cast<size_t>(smem_optin())) return cudaErrorInvalidValue;
  const size_t plan = static_cast<size_t>(n_quads) * sizeof(int4) +
                      static_cast<size_t>(8 * r + 1) * sizeof(int);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes + plan <= kSmemDefault)
    return launch_bitxor<true>(x, y, ptr, idx, r, c, n_quads, n4 / 8, threads,
                               planes + plan, s);
  return launch_bitxor<false>(x, y, ptr, idx, r, c, n_quads, n4 / 8, threads,
                              planes, s);
}

// K3.  x: (C / w, n4) uint32 chunks, y: (rows / w, n4) uint32; ptr:
// (ceil(rows / 16) + 1) int32 and entries: (n_entries, 4) int32 (chunk,
// packet, row mask, 0), the plan of ec_kernels.sched_xor_plan for packet
// count w (w = 1: plane rows).  n4 % 4 == 0 and, for w > 1, n4 % (16 w)
// == 0; pointers 16-byte aligned (the wrapper checks).
int gf_sched_xor(const void* x, void* y, const void* ptr, const void* entries,
                 int rows, int n_entries, int w, long long n4, void* stream) {
  if (rows < 0 || n_entries < 0 || w <= 0 || n4 < 0 || n4 % 4 ||
      (w > 1 && n4 % (16LL * w)) || rows % w)
    return cudaErrorInvalidValue;
  if (n4 == 0 || rows == 0) return cudaSuccess;
  return launch_sched<kSchedBatch, kSchedThreads>(
      x, y, ptr, entries, rows, n_entries, w, n4 / 4, kSchedPerSm,
      static_cast<cudaStream_t>(stream));
}

// Largest dynamic shared memory a block may opt in to on the current device.
int gf_smem_optin(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

const char* gf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
