// SWAN chunk-prefill sparse-prefix statistics for Hopper (sm_90a), slab and paged.
//
// Replaces the TPU kernels `swan_chunk_stats_pallas` (slab) and
// `swan_chunk_stats_paged_pallas` (page pool), src/repro/kernels/flash_prefill/
// swan_chunk.py: Q = C*G chunk queries of one (lane, kv head) against the valid
// packed sparse prefix t < sp_len, returned as MERGEABLE partial softmax stats
//   m_safe [P,Kv,Q] (0 where no row was valid), l [P,Kv,Q], o_unnorm [P,Kv,Q,dh],
// all f32, with the Pallas body's numerics: q, the dequantised values and every
// sum in f32.  The dense [ring || chunk] side and the merge stay outside.
//
// What bounds it: bytes.  The function is a sparse product: 4*Q*k flops per
// valid row (q.k over the k stored entries, p.v into them), against the packed
// rows, q and the three f32 outputs read or written once.  At the engine's chunk
// (P=2, Q=1024, dh=128, k=64, sp_len 1000|1920, bf16 values) that is ~6.2 us of
// operations at the bf16 tensor-core rate and ~7.7 us of bytes.  This kernel
// works on the dense expansion (4*Q*sp_len*dh flops, twice the sparse count) in
// f32 on CUDA cores, which at 67 TFLOP/s is ~0.18 ms of arithmetic alone: far
// above the bound, and tensor-core dots or gather-side scoring would cut it.
// The design expands each tile of packed rows ONCE
// into dense f32 [BS, dh] tiles in shared memory (zero-fill, then scatter: the k
// indices of one vector are distinct, so no two threads write one element) and
// reuses them for a tile of QT queries, as the TPU kernel does with its one-hot
// expansion:
//   * one block per (query tile of QT, kv head, lane): 16 x Kv x P blocks at the
//     full-width chunk (Q = 256*4), enough to fill the 132 SMs;
//   * the block stages its q tile in shared memory as f32, then walks the valid
//     rows in tiles of BS: expand k and v, [QT, BS] scores (thread = 4 queries x
//     2 rows), a masked online softmax per query (max and sum by shuffles over
//     the 16 threads that share a query), p into shared memory, and
//     acc[QT, dh] += p . v (thread = 4 queries x dh/16 columns, in registers);
//   * rows past sp_len are never read; sp_len = 0 writes (0, 0, 0).
// Slab and paged share the body: only the row address differs (`sparse_row`),
// so the paged kernel equals the slab kernel bit for bit on the same logical
// rows.  Each q tile re-reads the prefix (mostly from L2); tensor-core dots on a
// bf16 expansion of the tile and fewer re-reads are the first speed steps.
//
// Plain C entry point (loaded with ctypes); returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 64;               // queries per block: 16 thread rows x 4
constexpr int kBS = 32;               // sparse rows per tile: 16 thread columns x 2
constexpr int kMaxDh = 128;           // acc columns per thread: kMaxDh / 16
constexpr float kNegInf = -1e30f;     // finite "minus infinity", as the TPU kernel
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// Row index of sparse row t of (lane, kv head kv): slab when page_tab is null,
// else through the lane's page-table row (S = Pg * ps logical rows); page ids
// are clamped into the pool.
__device__ __forceinline__ size_t sparse_row(const int* __restrict__ page_tab, int lane,
                                             int kv, int Kv, int S, int ps, int n_pages,
                                             int t) {
  if (page_tab == nullptr) return (static_cast<size_t>(lane) * Kv + kv) * S + t;
  const int page = min(max(__ldg(page_tab + static_cast<size_t>(lane) * (S / ps) + t / ps), 0),
                       n_pages - 1);
  return (static_cast<size_t>(page) * Kv + kv) * ps + t % ps;
}

// int8 index -> column, clamped inside the tile (valid indices are < dh).
__device__ __forceinline__ int col(int8_t i, int dh) {
  return min(static_cast<int>(static_cast<uint8_t>(i)), dh - 1);
}

// strides (in floats) of the shared tiles, padded against bank conflicts
__host__ __device__ __forceinline__ int q_stride(int dh) { return dh + 4; }
__host__ __device__ __forceinline__ int kv_stride(int dh) { return dh + 1; }
constexpr int kPStride = kBS + 1;

int smem_bytes(int dh) {
  return static_cast<int>(sizeof(float)) *
         (kQT * q_stride(dh) + 2 * kBS * kv_stride(dh) + kQT * kPStride);
}

// VT: type of the packed values (f32, bf16, int8 with an f32 per-row scale, fp8 e4m3).
template <typename VT>
__global__ void __launch_bounds__(kThreads)
swan_chunk_kernel(const float* __restrict__ q, const VT* __restrict__ k_vals,
                  const int8_t* __restrict__ k_idx, const VT* __restrict__ v_vals,
                  const int8_t* __restrict__ v_idx, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ sp_len,
                  const int* __restrict__ page_tab, float* __restrict__ m_out,
                  float* __restrict__ l_out, float* __restrict__ o_out, int Kv, int Q,
                  int dh, int S, int k, int ps, int n_pages, float scale) {
  extern __shared__ float smem[];
  const int QS = q_stride(dh), KS = kv_stride(dh);
  float* q_s = smem;                          // [kQT][QS]
  float* k_s = q_s + kQT * QS;                // [kBS][KS] expanded key tile
  float* v_s = k_s + kBS * KS;                // [kBS][KS] expanded value tile
  float* p_s = v_s + kBS * KS;                // [kQT][kPStride] probabilities

  const int q0 = blockIdx.x * kQT;
  const int kv = blockIdx.y;
  const int lane = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;                    // queries ty*4 .. ty*4+3
  const int tx = tid & 15;                    // rows tx*2, tx*2+1; columns tx + 16c
  const int n_valid = min(max(sp_len[lane], 0), S);
  const size_t head = static_cast<size_t>(lane) * Kv + kv;

  for (int i = tid; i < kQT * dh; i += kThreads) {
    const int qq = i / dh, d = i % dh;
    q_s[qq * QS + d] = (q0 + qq < Q) ? q[(head * Q + q0 + qq) * dh + d] : 0.f;
  }

  float m[4], l[4], acc[4][kMaxDh / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDh / 16; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = 0; t0 < n_valid; t0 += kBS) {
    // ---- expand the packed tile: zero-fill, then scatter -------------------
    for (int i = tid; i < kBS * KS; i += kThreads) { k_s[i] = 0.f; v_s[i] = 0.f; }
    __syncthreads();
    for (int e = tid; e < kBS * k; e += kThreads) {
      const int r = e / k, j = e % k, t = t0 + r;
      if (t < n_valid) {
        const size_t row = sparse_row(page_tab, lane, kv, Kv, S, ps, n_pages, t);
        float xk = to_f32(k_vals[row * k + j]);
        float xv = to_f32(v_vals[row * k + j]);
        if (k_scale != nullptr) { xk *= k_scale[row]; xv *= v_scale[row]; }
        k_s[r * KS + col(k_idx[row * k + j], dh)] = xk;
        v_s[r * KS + col(v_idx[row * k + j], dh)] = xv;
      }
    }
    __syncthreads();

    // ---- scores [4 queries][2 rows] per thread ------------------------------
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) { s[i][0] = 0.f; s[i][1] = 0.f; }
    const float* qr = q_s + (ty * 4) * QS;
    const float* kr = k_s + (tx * 2) * KS;
    for (int d = 0; d < dh; ++d) {
      const float k0 = kr[d], k1 = kr[KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = qr[i * QS + d];
        s[i][0] += a * k0;
        s[i][1] += a * k1;
      }
    }
    bool ok[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) ok[j] = t0 + tx * 2 + j < n_valid;

    // ---- online softmax per query (16 threads share a query row) ------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
      float mt = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float ps_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * 4 + i) * kPStride + tx * 2 + j] = p;
        ps_sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ps_sum += __shfl_xor_sync(0xffffffffu, ps_sum, o);
      l[i] = l[i] * corr + ps_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxDh / 16; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // ---- acc[4 queries][dh/16 columns] += p . v ------------------------------
    const int rows = min(kBS, n_valid - t0);
    for (int r = 0; r < rows; ++r) {
      const float* vr = v_s + r * KS;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty * 4 + i) * kPStride + r];
#pragma unroll
        for (int c = 0; c < kMaxDh / 16; ++c) {
          const int d = tx + 16 * c;
          if (d < dh) acc[i][c] += p * vr[d];
        }
      }
    }
    __syncthreads();                          // the next tile overwrites k_s, v_s, p_s
  }

  // ---- write the stats of this block's valid queries -------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qq = q0 + ty * 4 + i;
    if (qq >= Q) continue;
    const size_t qi = head * Q + qq;
    if (tx == 0) {
      m_out[qi] = (m[i] > 0.5f * kNegInf) ? m[i] : 0.f;   // empty prefix -> 0
      l_out[qi] = l[i];
    }
#pragma unroll
    for (int c = 0; c < kMaxDh / 16; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) o_out[qi * dh + d] = acc[i][c];
    }
  }
}

template <typename VT>
cudaError_t launch(const void* q, const void* k_vals, const void* k_idx, const void* v_vals,
                   const void* v_idx, const void* k_scale, const void* v_scale,
                   const void* sp_len, const void* page_tab, void* m_out, void* l_out,
                   void* o_out, int P, int Kv, int Q, int dh, int S, int k, int ps,
                   int n_pages, cudaStream_t stream) {
  const int smem = smem_bytes(dh);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = swan_chunk_kernel<VT>;
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Q + kQT - 1) / kQT, Kv, P);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const VT*>(k_vals),
      static_cast<const int8_t*>(k_idx), static_cast<const VT*>(v_vals),
      static_cast<const int8_t*>(v_idx), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(sp_len),
      static_cast<const int*>(page_tab), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(o_out), Kv, Q, dh, S, k, ps, n_pages,
      static_cast<float>(1.0 / sqrt(static_cast<double>(dh))));
  return cudaGetLastError();
}

}  // namespace

// v_type 0 = f32, 1 = bf16, 2 = int8 (k_scale/v_scale required), 3 = fp8 e4m3.
// Pointers are device pointers of contiguous tensors: q [P,Kv,Q,dh] f32,
// sp_len [P] int32, m_out/l_out [P,Kv,Q] and o_out [P,Kv,Q,dh] f32.  Slab
// (page_tab null): k/v_vals and k/v_idx [P,Kv,S,k], k/v_scale [P,Kv,S] (or
// null).  Paged: the leaves as a pool [n_pages,Kv,ps,k] (scale
// [n_pages,Kv,ps]) and page_tab [P, S/ps] int32 (the lanes' page-table rows).
extern "C" int swan_chunk_launch(int v_type, const void* q, const void* k_vals,
                                 const void* k_idx, const void* v_vals, const void* v_idx,
                                 const void* k_scale, const void* v_scale, const void* sp_len,
                                 const void* page_tab, void* m_out, void* l_out, void* o_out,
                                 int P, int Kv, int Q, int dh, int S, int k, int ps,
                                 int n_pages, void* stream) {
  if (k < 1 || k > dh || dh > kMaxDh || P < 1 || Kv < 1 || Q < 1 || S < 1)
    return cudaErrorInvalidValue;
  if (page_tab != nullptr && (ps < 1 || n_pages < 1 || S % ps != 0)) return cudaErrorInvalidValue;
  if ((v_type == 2) != (k_scale != nullptr && v_scale != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CHUNK_ARGS q, k_vals, k_idx, v_vals, v_idx, k_scale, v_scale, sp_len, page_tab, m_out, \
                   l_out, o_out, P, Kv, Q, dh, S, k, ps, n_pages, st
  switch (v_type) {
    case 0: return launch<float>(CHUNK_ARGS);
    case 1: return launch<__nv_bfloat16>(CHUNK_ARGS);
    case 2: return launch<int8_t>(CHUNK_ARGS);
    case 3: return launch<__nv_fp8_e4m3>(CHUNK_ARGS);
  }
#undef CHUNK_ARGS
  return cudaErrorInvalidValue;
}

extern "C" const char* swan_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
