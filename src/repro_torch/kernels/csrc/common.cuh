// Constants, launch helpers and the packed-row staging shared by every kernel
// library of the port.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr float kNegInf = -1e30f;     // finite "minus infinity", as the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90

// Lets `kern` take `smem` bytes of dynamic shared memory: above 48 KB only
// when opted in, above kMaxSmem never.
template <typename Kern>
cudaError_t opt_in_smem(Kern kern, int smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

inline bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// The widest copy (16, 4 or 1 bytes) that splits every row of two leaves.
inline int copy_width(const void* a, const void* b, int row_bytes) {
  if (row_bytes % 16 == 0 && aligned(a, 16) && aligned(b, 16)) return 16;
  if (row_bytes % 4 == 0 && aligned(a, 4) && aligned(b, 4)) return 4;
  return 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes < 16 zero-fills the rest (0: all zeros,
// and nothing is read from src).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Row index of packed sparse row t of (sequence seq, kv head kv): slab
// [.., Kv, S, ..] when page_tab is null, else through the sequence's
// page-table row (S = Pg * ps logical rows) into the pool [n_pages, Kv, ps,
// ..].  A page id out of [0, n_pages) is clamped, so a corrupt table can
// never address outside the pool.
__device__ __forceinline__ size_t sparse_row(const int* __restrict__ page_tab, int seq,
                                             int kv, int Kv, int S, int ps, int n_pages,
                                             int t) {
  if (page_tab == nullptr) return (static_cast<size_t>(seq) * Kv + kv) * S + t;
  const int page = min(max(__ldg(page_tab + static_cast<size_t>(seq) * (S / ps) + t / ps), 0),
                       n_pages - 1);
  return (static_cast<size_t>(page) * Kv + kv) * ps + t % ps;
}

// int8 index -> column, clamped below dh, so that a corrupt index can never
// address outside a block's tiles (valid top-k indices are < dh <= 128).
__device__ __forceinline__ int col(int8_t i, int dh) {
  return min(static_cast<int>(static_cast<uint8_t>(i)), dh - 1);
}

// Copy packed rows [t0, t0 + n) of one leaf (row_bytes each, rows addressed
// by sparse_row) into contiguous staging rows, g bytes a copy (16 and 4:
// cp.async; 1: plain loads, for rows whose size or base is not 4-aligned),
// spread over the block's n_threads threads.  The caller commits the group.
// A thread keeps one column of pieces and steps over rows, so that its
// divisions do not depend on the row and leave a loop over tiles.
__device__ __forceinline__ void stage_rows(unsigned char* dst, const void* src, int row_bytes,
                                           int g, int t0, int n, const int* page_tab, int seq,
                                           int kv, int Kv, int S, int ps, int n_pages,
                                           int n_threads) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const int cpr = row_bytes / g;
  auto copy = [&](int r, int c) {
    const size_t row = sparse_row(page_tab, seq, kv, Kv, S, ps, n_pages, t0 + r);
    const unsigned char* from = s + row * row_bytes + c * g;
    unsigned char* to = dst + r * row_bytes + c * g;
    if (g == 16) cp_async16(to, from);
    else if (g == 4) cp_async4(to, from);
    else *to = *from;
  };
  if (cpr <= n_threads) {
    const int per = n_threads / cpr;       // rows a pass
    const int c = threadIdx.x % cpr, r0 = threadIdx.x / cpr;
    if (r0 < per)
      for (int r = r0; r < n; r += per) copy(r, c);
  } else {
    for (int i = threadIdx.x; i < n * cpr; i += n_threads) {
      const int r = i / cpr;
      copy(r, i - r * cpr);
    }
  }
}

}  // namespace sm90
