// SWAN decode attention for Hopper (sm_90a), slab and paged.
//
// Replaces the TPU kernels `swan_decode_pallas` (slab) and
// `swan_decode_paged_pallas` (page pool), src/repro/kernels/swan_decode/
// swan_decode.py: one decode query group attends over [packed sparse prefix ||
// dense ring] with ONE online softmax, reading the compressed cache as it is
// stored (no dense [S, dh] tensor is ever formed, in device memory or in shared
// memory).
//
// Slab and paged share one body; only the address of sparse row t differs
// (`sparse_row`): slab row ((b*Kv + kv)*S + t), paged row
// ((page_tab[b, t / ps]*Kv + kv)*ps + t % ps), the scale addressed the same
// way.  Each block reads its own page ids (the TPU kernel's scalar prefetch);
// rows past sp_len are never read, so trash-page tails are never touched.  The
// arithmetic and its order do not depend on the layout, so the paged kernel
// equals the slab kernel bit for bit on the same logical rows.
//
// What bounds it: device-memory bytes.  Per (sequence, kv head) it streams the
// sp_len valid packed rows (k values of 1-4 bytes + k int8 indices, per side,
// plus an f32 scale per row when int8) and the b x dh ring, and does ~4 flops
// per byte read -- far below the card's ~295 flops/byte ridge.  The design
// therefore spends nothing on tensor cores and everything on reading each byte
// once:
//   * one thread block per (b, kv) with q^ [G, dh] staged in shared memory as f32;
//   * warps walk the sparse rows t < sp_len (rows past sp_len are never read --
//     the TPU kernel's mask, without the bytes);
//   * within a row the 32 lanes take the k packed entries (neighbouring lanes,
//     neighbouring addresses), the score is a warp-reduced
//     sum_j vals[t,j] * q^[g, idx[t,j]] (a gather from shared memory instead of
//     the TPU kernel's one-hot expansion), and the value side adds
//     p_g * v_vals[t,j] into acc[g, v_idx[t,j]] in the warp's shared accumulator.
//     The k indices of one packed vector are distinct (top-k), so the lanes of a
//     warp never collide and no atomics are needed;
//   * each warp keeps its own (m, l, acc[G][dh]) online softmax, rescaled once per
//     tile of kTileRows rows; the warps are merged at the end, the ring is folded
//     in densely, and the result is normalised.
// One block per (b, kv) uses B*Kv of the 132 SMs; split-S across blocks, TMA and
// wgmma are later work.
//
// Plain C entry point (loaded with ctypes); returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 4;          // rows per warp between two rescales

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row index of sparse row t of (sequence bi, kv head kv): slab when page_tab is
// null, else through the page table (S = Pg * ps logical rows).  A page id out
// of [0, n_pages) is clamped so that a corrupt table can never address outside
// the pool.
__device__ __forceinline__ size_t sparse_row(const int* __restrict__ page_tab, int bi,
                                             int kv, int Kv, int S, int ps, int n_pages,
                                             int t) {
  if (page_tab == nullptr) return (static_cast<size_t>(bi) * Kv + kv) * S + t;
  const int page = min(max(__ldg(page_tab + static_cast<size_t>(bi) * (S / ps) + t / ps), 0),
                       n_pages - 1);
  return (static_cast<size_t>(page) * Kv + kv) * ps + t % ps;
}

// int8 index -> column; clamped so that a corrupt index can never address
// outside this block's shared memory (valid top-k indices are < dh <= 128).
__device__ __forceinline__ int col(int8_t i, int dh) {
  return min(static_cast<int>(static_cast<uint8_t>(i)), dh - 1);
}

// QT: type of q, the ring and the output (float or bf16).
// VT: type of the packed values (QT, int8 with an f32 per-row scale, or fp8 e4m3).
template <typename QT, typename VT, int G>
__global__ void __launch_bounds__(kThreads)
swan_decode_kernel(const QT* __restrict__ q, const VT* __restrict__ k_vals,
                   const int8_t* __restrict__ k_idx, const VT* __restrict__ v_vals,
                   const int8_t* __restrict__ v_idx, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const QT* __restrict__ buf_k,
                   const QT* __restrict__ buf_v, const int* __restrict__ buf_pos,
                   const int* __restrict__ pos, const int* __restrict__ sp_len,
                   const int* __restrict__ page_tab, QT* __restrict__ out, int Kv,
                   int dh, int S, int k, int b, int ps, int n_pages, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                         // [G][dh]
  float* acc_s = q_s + G * dh;               // [kWarps][G][dh]
  float* m_s = acc_s + kWarps * G * dh;      // [kWarps][G]
  float* l_s = m_s + kWarps * G;             // [kWarps][G]; later the merge weights
  float* lsum_s = l_s + kWarps * G;          // [G] final denominators
  float* pb_s = lsum_s + G;                  // [G][b] ring scores, then probabilities

  const int bk = blockIdx.x;                 // (sequence, kv head) = bi * Kv + kv
  const int bi = bk / Kv;
  const int kv = bk % Kv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int my_pos = pos[bi];
  const int n_sp = min(max(sp_len[bi], 0), S);

  for (int i = threadIdx.x; i < G * dh; i += kThreads)
    q_s[i] = to_f32(q[static_cast<size_t>(bk) * G * dh + i]);
  for (int i = threadIdx.x; i < kWarps * G * dh; i += kThreads) acc_s[i] = 0.f;
  __syncthreads();

  // ---- sparse prefix: per-warp online softmax --------------------------------
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) { m[g] = sm90::kNegInf; l[g] = 0.f; }
  float* acc_w = acc_s + warp * G * dh;

  for (int t0 = warp * kTileRows; t0 < n_sp; t0 += kWarps * kTileRows) {
    float s[kTileRows][G];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const int t = t0 + r;                  // warp-uniform
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      float ks = 1.f;
      if (t < n_sp) {
        const size_t row = sparse_row(page_tab, bi, kv, Kv, S, ps, n_pages, t);
        const VT* kr = k_vals + row * k;
        const int8_t* ki = k_idx + row * k;
        for (int j = lane; j < k; j += 32) {
          const float x = to_f32(kr[j]);
          const int d = col(ki[j], dh);
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] += x * q_s[g * dh + d];
        }
        if (k_scale != nullptr) ks = k_scale[row];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float sc = warp_sum(part[g]) * ks * scale;
        s[r][g] = (t < n_sp) ? sc : sm90::kNegInf;
      }
    }
    // one rescale per tile
    float corr[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = sm90::kNegInf;
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) mt = fmaxf(mt, s[r][g]);
      const float m_new = fmaxf(m[g], mt);
      corr[g] = expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float p = (t0 + r < n_sp) ? expf(s[r][g] - m_new) : 0.f;
        s[r][g] = p;
        psum += p;
      }
      l[g] = l[g] * corr[g] + psum;
      m[g] = m_new;
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      for (int d = lane; d < dh; d += 32) acc_w[g * dh + d] *= corr[g];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const int t = t0 + r;
      if (t < n_sp) {
        const size_t row = sparse_row(page_tab, bi, kv, Kv, S, ps, n_pages, t);
        const VT* vv = v_vals + row * k;
        const int8_t* vi = v_idx + row * k;
        const float vs = (v_scale != nullptr) ? v_scale[row] : 1.f;
        for (int j = lane; j < k; j += 32) {
          const float x = to_f32(vv[j]) * vs;
          const int d = col(vi[j], dh);
#pragma unroll
          for (int g = 0; g < G; ++g) acc_w[g * dh + d] += s[r][g] * x;
        }
      }
      __syncwarp();                          // the next row may hit the same columns
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) { m_s[warp * G + g] = m[g]; l_s[warp * G + g] = l[g]; }
  }

  // ---- ring scores (dense): warps over slots, lanes over dh --------------------
  const size_t ring0 = static_cast<size_t>(bk) * b;
  for (int t = warp; t < b; t += kWarps) {
    const int bp = buf_pos[static_cast<size_t>(bi) * b + t];
    const bool valid = bp >= 0 && bp <= my_pos;          // warp-uniform
    float part[G];
#pragma unroll
    for (int g = 0; g < G; ++g) part[g] = 0.f;
    if (valid) {
      const QT* kr = buf_k + (ring0 + t) * dh;
      for (int d = lane; d < dh; d += 32) {
        const float x = to_f32(kr[d]);
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] += x * q_s[g * dh + d];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sc = warp_sum(part[g]) * scale;
      if (lane == 0) pb_s[g * b + t] = valid ? sc : sm90::kNegInf;
    }
  }
  __syncthreads();

  // ---- merge: warp g owns query row g -------------------------------------------
  if (warp < G) {
    const int g = warp;
    float mx = sm90::kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + g]);
    for (int t = lane; t < b; t += 32) mx = fmaxf(mx, pb_s[g * b + t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float lsum = 0.f;
    for (int t = lane; t < b; t += 32) {
      const int bp = buf_pos[static_cast<size_t>(bi) * b + t];
      const float p = (bp >= 0 && bp <= my_pos) ? expf(pb_s[g * b + t] - mx) : 0.f;
      pb_s[g * b + t] = p;
      lsum += p;
    }
    lsum = warp_sum(lsum);
    __syncwarp();
    if (lane == 0) {
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(m_s[w * G + g] - mx);
        lsum += l_s[w * G + g] * c;
        l_s[w * G + g] = c;                  // merge weight of warp w's accumulator
      }
      lsum_s[g] = fmaxf(lsum, 1e-30f);
    }
  }
  __syncthreads();

  // ---- output: thread per (g, d) --------------------------------------------------
  for (int i = threadIdx.x; i < G * dh; i += kThreads) {
    const int g = i / dh, d = i % dh;
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += acc_s[(w * G + g) * dh + d] * l_s[w * G + g];
    for (int t = 0; t < b; ++t) {
      const float p = pb_s[g * b + t];
      if (p != 0.f) o += p * to_f32(buf_v[(ring0 + t) * dh + d]);
    }
    out[static_cast<size_t>(bk) * G * dh + i] = from_f32<QT>(o / lsum_s[g]);
  }
}

int smem_bytes(int G, int dh, int b) {
  return static_cast<int>(sizeof(float)) *
         (G * dh + kWarps * G * dh + 2 * kWarps * G + G + G * b);
}

template <typename QT, typename VT, int G>
cudaError_t launch(const void* q, const void* k_vals, const void* k_idx, const void* v_vals,
                   const void* v_idx, const void* k_scale, const void* v_scale,
                   const void* buf_k, const void* buf_v, const void* buf_pos,
                   const void* pos, const void* sp_len, const void* page_tab, void* out,
                   int B, int Kv, int dh, int S, int k, int b, int ps, int n_pages,
                   cudaStream_t stream) {
  const int smem = smem_bytes(G, dh, b);
  auto kern = swan_decode_kernel<QT, VT, G>;
  cudaError_t err = sm90::opt_in_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<B * Kv, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const VT*>(k_vals),
      static_cast<const int8_t*>(k_idx), static_cast<const VT*>(v_vals),
      static_cast<const int8_t*>(v_idx), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const QT*>(buf_k),
      static_cast<const QT*>(buf_v), static_cast<const int*>(buf_pos),
      static_cast<const int*>(pos), static_cast<const int*>(sp_len),
      static_cast<const int*>(page_tab), static_cast<QT*>(out), Kv, dh, S, k, b, ps, n_pages,
      static_cast<float>(1.0 / sqrt(static_cast<double>(dh))));
  return cudaGetLastError();
}

template <typename QT, typename VT>
cudaError_t launch_g(int G, const void* q, const void* kv, const void* ki, const void* vv,
                     const void* vi, const void* ks, const void* vs, const void* bk,
                     const void* bv, const void* bp, const void* pos, const void* sp,
                     const void* tab, void* out, int B, int Kv, int dh, int S, int k, int b,
                     int ps, int np, cudaStream_t st) {
#define SWAN_G_ARGS q, kv, ki, vv, vi, ks, vs, bk, bv, bp, pos, sp, tab, out, B, Kv, dh, S, k, b, ps, np, st
  switch (G) {
    case 1: return launch<QT, VT, 1>(SWAN_G_ARGS);
    case 2: return launch<QT, VT, 2>(SWAN_G_ARGS);
    case 4: return launch<QT, VT, 4>(SWAN_G_ARGS);
    case 8: return launch<QT, VT, 8>(SWAN_G_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef SWAN_G_ARGS
}

}  // namespace

// Type codes: q_type 0 = f32, 1 = bf16 (also the ring's and the output's type);
// v_type 0 = f32, 1 = bf16, 2 = int8 (k_scale/v_scale required), 3 = fp8 e4m3.
// v_type must equal q_type unless it is 2 or 3.  Pointers are device pointers of
// contiguous tensors: q/out [B,Kv,G,dh], buf_k/v [B,Kv,b,dh], buf_pos [B,b],
// pos/sp_len [B] (int32).  Slab (page_tab null): k/v_vals and k/v_idx
// [B,Kv,S,k], k/v_scale [B,Kv,S] (or null).  Paged: the same leaves as a pool
// [n_pages,Kv,ps,k] (scale [n_pages,Kv,ps]) and page_tab [B, S/ps] int32, so
// S is the shipped table width times ps.
extern "C" int swan_decode_launch(int q_type, int v_type, const void* q, const void* k_vals,
                                  const void* k_idx, const void* v_vals, const void* v_idx,
                                  const void* k_scale, const void* v_scale, const void* buf_k,
                                  const void* buf_v, const void* buf_pos, const void* pos,
                                  const void* sp_len, const void* page_tab, void* out, int B,
                                  int Kv, int G, int dh, int S, int k, int b, int ps,
                                  int n_pages, void* stream) {
  if (k < 1 || k > dh || dh > 128 || b < 1 || B < 1 || Kv < 1) return cudaErrorInvalidValue;
  if (page_tab != nullptr && (ps < 1 || n_pages < 1 || S % ps != 0)) return cudaErrorInvalidValue;
  const bool quant = v_type == 2;
  if (quant != (k_scale != nullptr && v_scale != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWAN_ARGS q, k_vals, k_idx, v_vals, v_idx, k_scale, v_scale, buf_k, buf_v, buf_pos, \
                  pos, sp_len, page_tab, out, B, Kv, dh, S, k, b, ps, n_pages, st
  if (q_type == 0) {
    switch (v_type) {
      case 0: return launch_g<float, float>(G, SWAN_ARGS);
      case 2: return launch_g<float, int8_t>(G, SWAN_ARGS);
      case 3: return launch_g<float, __nv_fp8_e4m3>(G, SWAN_ARGS);
    }
  } else if (q_type == 1) {
    switch (v_type) {
      case 1: return launch_g<__nv_bfloat16, __nv_bfloat16>(G, SWAN_ARGS);
      case 2: return launch_g<__nv_bfloat16, int8_t>(G, SWAN_ARGS);
      case 3: return launch_g<__nv_bfloat16, __nv_fp8_e4m3>(G, SWAN_ARGS);
    }
  }
#undef SWAN_ARGS
  return cudaErrorInvalidValue;
}

extern "C" const char* swan_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
