// GF(2^8) region kernels for Hopper (sm_90a): out(r, n4) = M(r, c) . x(c, n4)
// over GF(2^8), on uint32 lanes that each hold 4 independent bytes of a row.
//
// Two kernels, both wrapped by ceph_tpu_torch/ops/ec_kernels.py and bound
// through a plain C interface (ctypes, see ops/cuda_lib.py):
//
// gf_bitterm (K1) replaces the Pallas bit-term kernel of the JAX package,
//   ceph_tpu/ops/ec_kernels.py RegionMatmul._lanes_op with the body
//   _rows_op/_accumulate_row over _terms.  For every output row it
//   XOR-accumulates ((x[j] >> s) & 0x01010101) * gf(M[i,j] * 2^s): the
//   masked shift puts bit s of each byte in the byte's low bit, and the
//   integer multiply broadcasts the constant byte into every byte slot with
//   no carries.  Coefficient 1 is one XOR, coefficient 0 is skipped.
//   Design: a grid-stride loop over 16-byte lane groups (uint4), neighbouring
//   threads on neighbouring addresses.  Each thread owns all r output rows of
//   its group, kRowBlock rows at a time in registers, so x is re-read only
//   ceil(r / kRowBlock) times (once for r <= 4; the re-reads hit L1).  The
//   per-matrix table gf(M[i,j] * 2^s) is built on the host as (r, c, 8)
//   bytes and staged once per block in shared memory with the coefficient
//   bytes beside it as the skip / plain-XOR flag: 9 bytes per coefficient,
//   at most 9 KiB for r, c <= 32.
//
// gf_bitxor (K2) replaces the Pallas bitxor body of the same kernel,
//   ceph_tpu/ops/ec_kernels.py _bitxor_rows (chosen by RegionMatmul
//   _rows_core): the product as the CSE'd XOR program over GF(2) bit-planes
//   built by ops/xor_schedule.build_schedule.  It does not generate code per
//   matrix: the host lowers the schedule into a flat program of int4
//   instructions (ec_kernels.lower_schedule) whose node slots are allocated
//   by liveness, and this kernel interprets it.  The slots live in shared
//   memory laid out [slot][thread], so a thread only ever touches its own
//   column and the program needs no barrier.  Each thread handles one uint32
//   lane per iteration of a grid-stride loop.
//
// What bounds them on an H100: bytes are c*N read and r*N written (for the
// 8+3 encode at N = 8 MiB per row, 88 MiB, ~27.5 us at 3.35 TB/s).  Integer
// issue is larger for K1's own instruction mix: per lane column of 32 input
// bytes the 8+3 encode is 332 shifts, ANDs and XORs on the ALU pipe and 112
// multiply-adds on the FMA pipe, 64 results per clock per SM each; at
// 132 SMs and 1.98 GHz the ALU pipe alone needs ~42 us, so K1 is bound by
// that pipe, not by bytes.  K2 trades the multiplies for a CSE'd XOR program
// (93 shared XORs for the same matrix, 558 operations per lane counting plane
// extraction and packing), and every one of them reads and writes shared
// memory, so it is bound by shared-memory traffic and instruction decode.
// Neither uses the tensor cores; wgmma, TMA and the nibble-table design are
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kMask = 0x01010101u;
constexpr int kRowBlock = 4;
constexpr int kBitermThreads = 256;

// program opcodes; must match ceph_tpu_torch/ops/ec_kernels.py
enum : int { kLoad = 0, kXor = 1, kInit = 2, kAcc = 3, kStore = 4, kZero = 5 };

__device__ __forceinline__ void xor4(uint4& a, const uint4& b) {
  a.x ^= b.x; a.y ^= b.y; a.z ^= b.z; a.w ^= b.w;
}

__device__ __forceinline__ void mac4(uint4& a, const uint4& v, int s,
                                     uint32_t coef) {
  a.x ^= ((v.x >> s) & kMask) * coef;
  a.y ^= ((v.y >> s) & kMask) * coef;
  a.z ^= ((v.z >> s) & kMask) * coef;
  a.w ^= ((v.w >> s) & kMask) * coef;
}

__global__ void gf_bitterm_kernel(const uint4* __restrict__ x,
                                  uint4* __restrict__ y,
                                  const uint8_t* __restrict__ coef,
                                  const uint2* __restrict__ tab, int r, int c,
                                  long long groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rc = r * c;
  uint2* s_tab = reinterpret_cast<uint2*>(smem);
  uint8_t* s_coef = smem + static_cast<size_t>(rc) * sizeof(uint2);
  for (int t = threadIdx.x; t < rc; t += blockDim.x) {
    s_tab[t] = tab[t];
    s_coef[t] = coef[t];
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    for (int i0 = 0; i0 < r; i0 += kRowBlock) {
      uint4 acc[kRowBlock];
#pragma unroll
      for (int ii = 0; ii < kRowBlock; ++ii) acc[ii] = make_uint4(0, 0, 0, 0);
      for (int j = 0; j < c; ++j) {
        const uint4 v = x[static_cast<long long>(j) * groups + g];
#pragma unroll
        for (int ii = 0; ii < kRowBlock; ++ii) {
          const int i = i0 + ii;
          if (i < r) {
            const uint8_t cf = s_coef[i * c + j];
            if (cf == 1) {
              xor4(acc[ii], v);
            } else if (cf != 0) {
              const uint2 w = s_tab[i * c + j];
#pragma unroll
              for (int s = 0; s < 4; ++s) {
                mac4(acc[ii], v, s, (w.x >> (8 * s)) & 0xffu);
                mac4(acc[ii], v, s + 4, (w.y >> (8 * s)) & 0xffu);
              }
            }
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < kRowBlock; ++ii) {
        if (i0 + ii < r) y[static_cast<long long>(i0 + ii) * groups + g] = acc[ii];
      }
    }
  }
}

__global__ void gf_bitxor_kernel(const uint32_t* __restrict__ x,
                                 uint32_t* __restrict__ y,
                                 const int4* __restrict__ prog, int n_prog,
                                 long long n4) {
  extern __shared__ uint32_t slots[];  // [slot][blockDim.x]
  const int t = threadIdx.x;
  const int bd = blockDim.x;
  const long long stride = static_cast<long long>(gridDim.x) * bd;
  for (long long lane = static_cast<long long>(blockIdx.x) * bd + t;
       lane < n4; lane += stride) {
    int cur_row = -1;  // last input row loaded: planes of one row share it
    uint32_t cur = 0;
    for (int pc = 0; pc < n_prog; ++pc) {
      const int4 in = __ldg(prog + pc);
      switch (in.x) {
        case kLoad:  // slot y = plane w of input row z
          if (in.z != cur_row) {
            cur = __ldg(x + static_cast<long long>(in.z) * n4 + lane);
            cur_row = in.z;
          }
          slots[in.y * bd + t] = (cur >> in.w) & kMask;
          break;
        case kXor:  // slot y = slot z ^ slot w
          slots[in.y * bd + t] = slots[in.z * bd + t] ^ slots[in.w * bd + t];
          break;
        case kInit:  // accumulator y = slot z << w
          slots[in.y * bd + t] = slots[in.z * bd + t] << in.w;
          break;
        case kAcc:  // accumulator y ^= slot z << w
          slots[in.y * bd + t] ^= slots[in.z * bd + t] << in.w;
          break;
        case kStore:  // output row y = slot z
          y[static_cast<long long>(in.y) * n4 + lane] = slots[in.z * bd + t];
          break;
        case kZero:  // output row y = 0
          y[static_cast<long long>(in.y) * n4 + lane] = 0u;
          break;
        default:
          break;
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

}  // namespace

extern "C" {

// K1.  x: (c, n4) uint32, y: (r, n4) uint32, coef: (r, c) bytes,
// tab: (r, c, 8) bytes = gf(M[i,j] * 2^s).  n4 % 4 == 0, pointers 16-byte
// aligned (the wrapper checks).  Returns cudaGetLastError().
int gf_bitterm(const void* x, void* y, const void* coef, const void* tab,
               int r, int c, long long n4, void* stream) {
  if (r <= 0 || c <= 0 || n4 < 0 || n4 % 4) return cudaErrorInvalidValue;
  if (n4 == 0) return cudaSuccess;
  const long long groups = n4 / 4;
  const size_t smem = static_cast<size_t>(r) * c * (sizeof(uint2) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf_bitterm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = grid_for(groups, kBitermThreads, 16);
  gf_bitterm_kernel<<<static_cast<unsigned>(blocks), kBitermThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y),
      static_cast<const uint8_t*>(coef), static_cast<const uint2*>(tab), r, c,
      groups);
  return cudaGetLastError();
}

// K2.  x: (c, n4) uint32, y: (r, n4) uint32, prog: (n_prog, 4) int32 program
// over n_slots slots; threads * n_slots * 4 bytes of shared memory.
int gf_bitxor(const void* x, void* y, const void* prog, int n_prog,
              int n_slots, long long n4, int threads, void* stream) {
  if (n_prog < 0 || n_slots < 0 || n4 < 0 || threads <= 0 || threads > 1024)
    return cudaErrorInvalidValue;
  if (n4 == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(n_slots) * threads * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf_bitxor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = grid_for(n4, threads, 32);
  gf_bitxor_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const int4*>(prog), n_prog, n4);
  return cudaGetLastError();
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
