// The binary tensor-core product both GF(2) kernels run (crc32c.cu and
// gf_bitmm.cu): one mma.sync m16n8k256 (or m16n8k128) on b1 operands, AND
// then popcount, accumulated into s32.  The low bit of each sum is the GF(2) product.
//
// Fragment layout, as both kernels use it on sm_90a (lane = 4 g + t):
// a[0] holds A row g, k = 32 t .. 32 t + 31; a[1] row g + 8, the same k;
// a[2] row g, k = 128 + 32 t .. ; a[3] row g + 8, the same k.  b0 holds
// B column g, k = 32 t .. 32 t + 31; b1 column g, k = 128 + 32 t ..  Bit
// beta of a register pairs with bit beta of the register it meets.  d[0],
// d[1] are D(g, 2 t), D(g, 2 t + 1); d[2], d[3] the same columns of row
// g + 8.  mma_b1_k128 (m16n8k128) is the first half of that: a0, a1 and
// b0 at k = 32 t .., the same D.

#pragma once

#include <stdint.h>

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_b1_k128(int (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}
