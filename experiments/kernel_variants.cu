// Variants of the port's K1 (gf_bitterm), K2 (gf_bitxor) and K3
// (gf_sched_xor) kernels that the library does not build, timed beside it by
// kernel_variants.py: what bounds each kernel, and why the library's fixed
// settings are what they are.
//
// It includes the library's source and launches the library's own loops at
// other template arguments, so a variant differs from the library's kernel
// only where it says:
// K1 (gf_bitterm_kernel): whole 16-entry lookups (two prmts and a select per
//   nibble) instead of 8-entry ones and the bit-3/bit-7 terms, no branch on
//   the coefficient flags, other counts of output rows in registers, of input
//   rows loaded at once and of blocks per SM under __launch_bounds__, or one
//   phase alone (the loads, the selectors).
// K2 (gf_bitxor_kernel): 2 or 4 input rows in flight instead of 8, or one
//   phase switched off (the input phase, the CSR walk, the transposes).
// K3 (gf_sched_xor_kernel): 8 loads in flight, 256-thread blocks, a
//   register cap, streaming stores, another grid cap, or another XOR step
//   (a uniform switch per set bit of the mask, or one XOR per input: the
//   memory pattern alone).
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface.

#include "../ceph_tpu_torch/csrc/gf_region.cu"

namespace {

// XOR step: only the rows of each set bit of the mask, by a warp-uniform
// switch.
struct SparseXor {
  template <int kBatch>
  __device__ __forceinline__ static void apply(uint4 (&acc)[kSchedRows],
                                               const uint4 (&v)[kBatch],
                                               const uint32_t (&mask)[kBatch]) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      for (uint32_t m = mask[j]; m; m &= m - 1) {
        switch (__ffs(m) - 1) {
#define XOR_ROW(n) case n: xor4(acc[n], v[j]); break;
          XOR_ROW(0) XOR_ROW(1) XOR_ROW(2) XOR_ROW(3)
          XOR_ROW(4) XOR_ROW(5) XOR_ROW(6) XOR_ROW(7)
          XOR_ROW(8) XOR_ROW(9) XOR_ROW(10) XOR_ROW(11)
          XOR_ROW(12) XOR_ROW(13) XOR_ROW(14) XOR_ROW(15)
#undef XOR_ROW
          default: break;
        }
      }
    }
  }
};

// XOR step: every input into row 0 only; the loads and stores are the
// library's, so the kernel times its memory pattern, not the product.
struct MemOnlyXor {
  template <int kBatch>
  __device__ __forceinline__ static void apply(uint4 (&acc)[kSchedRows],
                                               const uint4 (&v)[kBatch],
                                               const uint32_t (&)[kBatch]) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) xor4(acc[0], v[j]);
  }
};

// K2's loop, staged, at 128 threads: the library's block size for c = 8.
template <int kB, bool kIn = true, bool kWalk = true, bool kSlice = true>
int run_bitxor(const void* x, void* y, const void* ptr, const void* idx,
               int r, int c, int n_quads, long long n4) {
  constexpr int kThreads = 128;
  const size_t smem = static_cast<size_t>(8 * c + 1) * 4 * kThreads +
                      static_cast<size_t>(n_quads) * sizeof(int4) +
                      static_cast<size_t>(8 * r + 1) * sizeof(int);
  return launch_bitxor<true, kB, kIn, kWalk, kSlice>(
      x, y, ptr, idx, r, c, n_quads, n4 / 8, kThreads, smem, nullptr);
}

}  // namespace

extern "C" {

// K1 variant, the arguments of gf_bitterm and a mode: 0-4 the library's
// rows, batch and block size with mode 0 the library's setting, 1 16-entry
// lookups, 2 the loads and stores alone (every input XORed into row 0), 3
// the selectors alone (each input's Nibbles into row 0), 4 no flags (every
// coefficient, 0 and 1 too, by its table); 5-13 the product at other
// (rows in registers, input rows at once, block size, blocks per SM under
// __launch_bounds__), 8 without flags.
int variant_bitterm(const void* x, void* y, const void* coef, const void* tab,
                    int r, int c, long long n4, int mode) {
  const long long groups = n4 / 4;
  constexpr int R = kRowBlock, B = kBitermBatch, T = kBitermThreads;
#define RUN(...) \
  launch_bitterm<__VA_ARGS__>(x, y, coef, tab, r, c, groups, nullptr)
  switch (mode) {
    case 0: return RUN(R, B, kSplit);
    case 1: return RUN(R, B, kSelect16);
    case 2: return RUN(R, B, kLoadsOnly);
    case 3: return RUN(R, B, kSelectorsOnly);
    case 4: return RUN(R, B, kSplit, T, 1, false);
    case 5: return RUN(4, 8, kSplit, T, 3);
    case 6: return RUN(4, 8, kSplit, T, 1);
    case 7: return RUN(4, 4, kSplit, 128, 8);
    case 8: return RUN(4, 4, kSplit, T, 4, false);
    case 9: return RUN(4, 3, kSplit, T, 4);
    case 10: return RUN(4, 2, kSplit, T, 5);
    case 11: return RUN(4, 2, kSplit, T, 6);
    case 12: return RUN(8, 2, kSplit, T, 4);
    case 13: return RUN(8, 4, kSplit, T, 3);
    default: return cudaErrorInvalidValue;
  }
#undef RUN
}

// K2 variant, the arguments of gf_bitxor and: mode 0 the product, 1 the
// input phase only (each output row stored from the first 8 planes), 2 the
// CSR walk and stores only (no loads), 3 no transposes; batch 2, 4 or 8
// input rows in flight (modes 1-3: 8, the library's).
int variant_bitxor(const void* x, void* y, const void* ptr, const void* idx,
                   int r, int c, int n_quads, long long n4, int mode,
                   int batch) {
#define RUN(...) run_bitxor<__VA_ARGS__>(x, y, ptr, idx, r, c, n_quads, n4)
  if (mode == 0 && batch == 2) return RUN(2);
  if (mode == 0 && batch == 4) return RUN(4);
  if (mode == 0 && batch == 8) return RUN(8);
  if (mode == 1 && batch == 8) return RUN(8, true, false);
  if (mode == 2 && batch == 8) return RUN(8, false, true);
  if (mode == 3 && batch == 8) return RUN(8, true, true, false);
#undef RUN
  return cudaErrorInvalidValue;
}

// K3 variant, the arguments of gf_sched_xor and: mode 0 the library's
// knobs, 1 8 loads in flight, 2 256-thread blocks, 3
// __launch_bounds__(128, 5), 4 streaming stores, 5 the sparse switch, 6
// the memory pattern alone; per_sm the grid cap in blocks per SM (the
// library's: 8).
int variant_sched(const void* x, void* y, const void* ptr,
                  const void* entries, int rows, int n_entries, int w,
                  long long n4, int mode, int per_sm) {
  const long long lanes = n4 / 4;
#define RUN(...)                                                         \
  launch_sched<__VA_ARGS__>(x, y, ptr, entries, rows, n_entries, w, lanes, \
                            per_sm, nullptr)
  switch (mode) {
    case 0: return RUN(kSchedBatch, kSchedThreads);
    case 1: return RUN(8, 128);
    case 2: return RUN(4, 256);
    case 3: return RUN(4, 128, 5);
    case 4: return RUN(4, 128, 1, true);
    case 5: return RUN(4, 128, 1, false, SparseXor);
    case 6: return RUN(4, 128, 1, false, MemOnlyXor);
    default: return cudaErrorInvalidValue;
  }
#undef RUN
}

}  // extern "C"
