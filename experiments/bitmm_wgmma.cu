// (f) of bitmm_variants.py: does ptxas for sm_90a take wgmma on b1
// operands (AND, popcount), and at what rate?  One warpgroup a block runs
// wgmma.mma_async m64n64k256 .s32.b1.b1.and.popc back to back on A and B
// in shared memory (no swizzle, 8 x 16-byte core matrices), folds its 32
// sums a thread into one stored word.  The operands are a fixed pattern:
// this times the products, it computes nothing of G4.
//
// Built by bitmm_variants.py in its own nvcc, so that a refusal leaves the
// other variants standing; never by the library.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;         // M of A and N of B
constexpr int kRowBytes = 32;     // 256 k-bits

// Shared-memory matrix descriptor: start address, leading-dimension byte
// offset (between core matrices along K), stride byte offset (between
// 8-row groups), no swizzle; addresses and offsets in 16-byte units.
__device__ __forceinline__ uint64_t descriptor(const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint64_t lbo = 128 >> 4, sbo = 256 >> 4;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (lbo << 16) |
         (sbo << 32);
}

__global__ void __launch_bounds__(128)
    wgmma_b1_kernel(uint32_t* __restrict__ y, int iters) {
  __shared__ __align__(128) uint8_t sa[kRows * kRowBytes];
  __shared__ __align__(128) uint8_t sb[kRows * kRowBytes];
  for (int i = threadIdx.x; i < kRows * kRowBytes; i += blockDim.x) {
    sa[i] = static_cast<uint8_t>(i * 37 + blockIdx.x);
    sb[i] = static_cast<uint8_t>(i * 91 + 7);
  }
  asm volatile("fence.proxy.async.shared::cta;");
  __syncthreads();
  const uint64_t da = descriptor(sa), db = descriptor(sb);
  int d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
        " %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
    asm volatile("wgmma.commit_group.sync.aligned;");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  int v = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) v += d[i];
  y[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<uint32_t>(v);
}

}  // namespace

extern "C" {

// ``blocks`` blocks of one warpgroup, ``iters`` m64n64k256 products each
// (32 m16n8k256 products' worth of output bits apiece).
int wgmma_products(void* y, int blocks, int iters, void* stream) {
  wgmma_b1_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(y), iters);
  return cudaGetLastError();
}

}  // extern "C"
