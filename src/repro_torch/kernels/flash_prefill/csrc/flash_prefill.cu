// GQA flash attention (prefill), causal or full, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`,
// src/repro/kernels/flash_prefill/flash_prefill.py:113: q [B,Sq,H,dh] against
// k/v [B,Sk,Kv,dh] (f32 or bf16), o [B,Sq,H,dh] in q's dtype, with the Pallas
// body's numerics: scores, the online softmax (m, l) and the accumulator in f32,
// masked scores at -1e30, the causal mask top-left (key t visible to query i iff
// t <= i), and o = acc / max(l, 1e-30).
//
// What bounds it: operations.  Causal at the bench shape (B=4, Sq=Sk=2048, H=32,
// Kv=8, dh=128, bf16) the function needs 4*B*H*Sq*Sk*dh/2 = 1.37e11 operations,
// 0.139 ms at the dense bf16 tensor-core rate, against 168 MB of q, k, v and o
// (0.050 ms at 3.35 TB/s).  This kernel is the simple, right first version: its
// products run in f32 on CUDA cores (at best ~2 ms of arithmetic at 67 TFLOP/s),
// and tensor cores (mma/wgmma on bf16 tiles) are the first speed step.
// The design keeps what the TPU kernel keeps out of device memory, and reads each
// K/V tile once per kv group rather than once per query head:
//   * one block per (64 query rows of one kv group, kv head, batch).  A row is a
//     (position, head) pair, r = pos*G + g, so the block's rows hold every head of
//     the group at QT = 64/G positions (any G), and the G heads of one position
//     are contiguous in q and o;
//   * the block stages its q rows in shared memory as f32, then walks the keys in
//     tiles of 32: K and V tiles in shared memory as f32, [64, 32] scores
//     (thread = 4 rows x 2 keys), a masked online softmax per row (max and sum by
//     shuffles over the 16 threads that share a row), p into shared memory, and
//     acc[64, dh] += p . v (thread = 4 rows x dh/16 columns, in registers);
//   * causal: the key loop stops after the block's last query position, so tiles
//     above the diagonal are never read (the TPU kernel skips whole key blocks
//     above it, :81).
//
// Plain C entry point (loaded with ctypes); returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kQR = 64;               // query rows per block: 16 thread rows x 4
constexpr int kKT = 32;               // keys per tile: 16 thread columns x 2
constexpr int kMaxDh = 128;           // acc columns per thread: kMaxDh / 16
constexpr float kNegInf = -1e30f;     // finite "minus infinity", as the TPU kernel
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);         // round to nearest even, as torch's cast
}

// strides (in floats) of the shared tiles, padded against bank conflicts
__host__ __device__ __forceinline__ int q_stride(int dh) { return dh + 4; }
__host__ __device__ __forceinline__ int kv_stride(int dh) { return dh + 1; }
constexpr int kPStride = kKT + 1;

int smem_bytes(int dh) {
  return static_cast<int>(sizeof(float)) *
         (kQR * q_stride(dh) + 2 * kKT * kv_stride(dh) + kQR * kPStride);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
                     int Kv, int dh, int causal, float scale) {
  extern __shared__ float smem[];
  const int QS = q_stride(dh), KS = kv_stride(dh);
  float* q_s = smem;                          // [kQR][QS]
  float* k_s = q_s + kQR * QS;                // [kKT][KS]
  float* v_s = k_s + kKT * KS;                // [kKT][KS]
  float* p_s = v_s + kKT * KS;                // [kQR][kPStride] probabilities

  const int G = H / Kv;
  const int n_rows = Sq * G;                  // (position, head) rows of the group
  const int r0 = blockIdx.x * kQR;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;                    // rows ty*4 .. ty*4+3
  const int tx = tid & 15;                    // keys tx*2, tx*2+1; columns tx + 16c

  // element offset of (row r of this block, column 0) in q and o
  auto row_offset = [&](int r) -> size_t {
    const int rg = r0 + r, pos = rg / G, g = rg - pos * G;
    return ((static_cast<size_t>(b) * Sq + pos) * H + kv * G + g) * dh;
  };

  for (int i = tid; i < kQR * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    q_s[r * QS + d] = (r0 + r < n_rows) ? to_f32(q[row_offset(r) + d]) : 0.f;
  }

  int qpos[4];                                // -1 for rows past the group's end
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rg = r0 + ty * 4 + i;
    qpos[i] = rg < n_rows ? rg / G : -1;
  }
  const int last_pos = (min(r0 + kQR, n_rows) - 1) / G;
  const int n_keys = causal ? min(Sk, last_pos + 1) : Sk;

  float m[4], l[4], acc[4][kMaxDh / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDh / 16; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = 0; t0 < n_keys; t0 += kKT) {
    // ---- K and V tiles as f32 (rows of one kv head: stride Kv*dh) -----------
    for (int i = tid; i < kKT * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh, t = t0 + r;
      float xk = 0.f, xv = 0.f;
      if (t < n_keys) {
        const size_t off = ((static_cast<size_t>(b) * Sk + t) * Kv + kv) * dh + d;
        xk = to_f32(k[off]);
        xv = to_f32(v[off]);
      }
      k_s[r * KS + d] = xk;
      v_s[r * KS + d] = xv;
    }
    __syncthreads();

    // ---- scores [4 rows][2 keys] per thread ---------------------------------
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

    // ---- masked online softmax per row (16 threads share a row) -------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = t0 + tx * 2 + j;
        ok[j] = qpos[i] >= 0 && t < n_keys && (!causal || t <= qpos[i]);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
      }
      float mt = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * 4 + i) * kPStride + tx * 2 + j] = p;
        p_sum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) p_sum += __shfl_xor_sync(0xffffffffu, p_sum, w);
      l[i] = l[i] * corr + p_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxDh / 16; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // ---- acc[4 rows][dh/16 columns] += p . v ---------------------------------
    const int keys = min(kKT, n_keys - t0);
    for (int r = 0; r < keys; ++r) {
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

  // ---- o = acc / max(l, 1e-30), in q's dtype ---------------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] < 0) continue;
    const size_t base = row_offset(ty * 4 + i);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxDh / 16; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) o[base + d] = from_f32<T>(acc[i][c] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int H, int Kv, int dh, int causal, cudaStream_t stream) {
  const int smem = smem_bytes(dh);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = flash_prefill_kernel<T>;
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int G = H / Kv;
  const dim3 grid((Sq * G + kQR - 1) / kQR, Kv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, Kv, dh, causal,
      static_cast<float>(1.0 / sqrt(static_cast<double>(dh))));
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = f32, 1 = bf16 (q, k, v and o all of it).  Pointers are device
// pointers of contiguous tensors: q and o [B,Sq,H,dh], k and v [B,Sk,Kv,dh].
// causal != 0 masks top-left (key t visible to query i iff t <= i).
extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k, const void* v,
                                    void* o, int B, int Sq, int Sk, int H, int Kv, int dh,
                                    int causal, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Kv < 1 || H % Kv != 0 || dh < 1 || dh > kMaxDh)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, k, v, o, B, Sq, Sk, H, Kv, dh, causal, st);
    case 1: return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Kv, dh, causal, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
