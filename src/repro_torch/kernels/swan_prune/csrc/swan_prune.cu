// SWAN fused winnowing (rotate, magnitude top-k, pack) for Hopper (sm_90a).
//
// Replaces the TPU kernel `swan_prune_pallas`,
// src/repro/kernels/swan_prune/swan_prune.py:58: for every vector x [dh] of
// x [B,Kv,S,dh] (f32 or bf16), x_hat = x . P[kv] in f32 (P [Kv,dh,dh] f32), then
// the k_max largest |x_hat| in descending order, ties to the lowest index (the TPU
// kernel's arg-max loop, :40-42, and lax.top_k), packed as vals [B,Kv,S,k_max] in
// x's dtype and idx [B,Kv,S,k_max] int8.
//
// What bounds it: bytes.  At the bench shape (B=4, Kv=8, S=2048, dh=128, k=64,
// bf16 x) the function moves 29.9 MB (x, P, vals, idx once): 8.9 us at 3.35 TB/s,
// against 2.1e9 rotation operations (2.2 us at the bf16 tensor-core rate).  This
// first version rotates in f32 on CUDA cores, reading P from shared memory.
// The design:
//   * one block per (row tile of 64 vectors, kv head, batch) holds P[kv] in
//     shared memory (64 KB at dh = 128, f32), loaded once for the tile's rows;
//   * one warp per vector: the row is staged in shared memory, each lane computes
//     x_hat at columns lane + 32j (4 columns at dh = 128) as a sum over d in
//     order, then writes |x_hat| to the warp's shared row;
//   * the top-k is a rank, not a chain of k arg-max steps: each element counts
//     the elements with a larger |x_hat|, or an equal one at a lower index, and
//     is stored at position rank when rank < k_max.  That is exactly the order
//     of a stable descending sort, so the packed order equals the reference's.
//
// Plain C entry point (loaded with ctypes); returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 64;             // vectors per block: each warp walks 8
constexpr int kMaxDh = 128;           // int8 indices; 4 columns per lane
constexpr int kCols = kMaxDh / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);         // round to nearest even, as torch's cast
}

int smem_bytes(int dh) {
  return static_cast<int>(sizeof(float)) * (dh * dh + 2 * kWarps * dh);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
swan_prune_kernel(const T* __restrict__ x, const float* __restrict__ p_rot,
                  T* __restrict__ vals, int8_t* __restrict__ idx, int Kv, int S, int dh,
                  int k) {
  extern __shared__ float smem[];
  float* p_s = smem;                          // [dh][dh] P[kv]
  float* x_s = p_s + dh * dh;                 // [kWarps][dh] the warp's vector
  float* a_s = x_s + kWarps * dh;             // [kWarps][dh] its |x_hat|

  const int s0 = blockIdx.x * kRows;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const float* p = p_rot + static_cast<size_t>(kv) * dh * dh;
  for (int i = threadIdx.x; i < dh * dh; i += kWarps * 32) p_s[i] = p[i];
  __syncthreads();

  float* xw = x_s + w * dh;
  float* aw = a_s + w * dh;
  const int s_end = min(s0 + kRows, S);
  for (int s = s0 + w; s < s_end; s += kWarps) {
    const size_t row = (static_cast<size_t>(b) * Kv + kv) * S + s;
    for (int d = lane; d < dh; d += 32) xw[d] = to_f32(x[row * dh + d]);
    __syncwarp();

    float h[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) h[j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float xd = xw[d];
      const float* pr = p_s + d * dh;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = lane + 32 * j;
        if (c < dh) h[j] = fmaf(xd, pr[c], h[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      if (c < dh) aw[c] = fabsf(h[j]);
    }
    __syncwarp();

#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      if (c >= dh) continue;
      const float a = fabsf(h[j]);
      int rank = 0;
      for (int e = 0; e < dh; ++e) {
        const float ae = aw[e];
        rank += (ae > a) || (ae == a && e < c);
      }
      if (rank < k) {
        vals[row * k + rank] = from_f32<T>(h[j]);
        idx[row * k + rank] = static_cast<int8_t>(c);
      }
    }
    __syncwarp();                             // the next vector overwrites xw, aw
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* p_rot, void* vals, void* idx, int B, int Kv,
                   int S, int dh, int k, cudaStream_t stream) {
  const int smem = smem_bytes(dh);
  auto kern = swan_prune_kernel<T>;
  cudaError_t err = sm90::opt_in_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRows - 1) / kRows, Kv, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(p_rot), static_cast<T*>(vals),
      static_cast<int8_t*>(idx), Kv, S, dh, k);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = f32, 1 = bf16 (x and vals).  Pointers are device pointers of
// contiguous tensors: x [B,Kv,S,dh], p_rot [Kv,dh,dh] f32, vals [B,Kv,S,k] and
// idx [B,Kv,S,k] int8.
extern "C" int swan_prune_launch(int dtype, const void* x, const void* p_rot, void* vals,
                                 void* idx, int B, int Kv, int S, int dh, int k,
                                 void* stream) {
  if (B < 1 || Kv < 1 || S < 1 || dh < 1 || dh > kMaxDh || k < 1 || k > dh)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, p_rot, vals, idx, B, Kv, S, dh, k, st);
    case 1: return launch<__nv_bfloat16>(x, p_rot, vals, idx, B, Kv, S, dh, k, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* swan_prune_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
