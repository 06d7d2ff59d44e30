// Warp-level tensor-core helpers shared by the port's
// attention kernels (sm_90a): inline PTX for mma.sync m16n8k16 on bf16 with
// f32 accumulators and ldmatrix (cp.async and smem_addr live in common.cuh).
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = threadIdx.x % 32,
// gq = lane / 4, tq = lane % 4):
//   A (16 x 16, row-major), four b32 registers of two bf16 each:
//     a0 = A[gq][2tq..2tq+1], a1 = A[gq+8][2tq..], a2 = A[gq][2tq+8..],
//     a3 = A[gq+8][2tq+8..]
//   B (16 x 8, column-major), two registers: b0 = B[2tq..2tq+1][gq],
//     b1 = B[2tq+8..2tq+9][gq]
//   C/D (16 x 8, f32): c0, c1 = C[gq][2tq..2tq+1], c2, c3 = C[gq+8][2tq..]
// so the C fragments of two adjacent 8-column tiles are, packed to bf16, the A
// fragment of the 16-column product that consumes them (P . V in registers).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace sm90 {

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 2^x by the special-function unit (max relative error ~2^-22; flushes
// subnormal results to 0).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a . b, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) -> hi = bf16 pair (x0 in the low half), lo = bf16 pair of the
// residuals x - hi: hi + lo carries 16 significant bits of each f32.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

}  // namespace sm90
