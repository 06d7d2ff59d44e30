// SWAN fused winnowing (rotate, magnitude top-k, pack) for Hopper (sm_90a).
//
// Replaces the TPU kernel `swan_prune_pallas`,
// src/repro/kernels/swan_prune/swan_prune.py:58: for every vector x [dh] of
// x [B,Kv,S,dh] (f32 or bf16), x_hat = x . P[kv] in f32 (P [Kv,dh,dh] f32), then
// the k_max largest |x_hat| in descending order, ties to the lowest index (the TPU
// kernel's arg-max loop, :40-42, and lax.top_k), packed as vals [B,Kv,S,k_max] in
// x's dtype and idx [B,Kv,S,k_max] int8.
//
// What bounds it: bytes, in principle.  At the bench shape (B=4, Kv=8, S=2048,
// dh=128, k=64, bf16 x) the function moves 29.9 MB (x, P, vals, idx once): 8.9 us
// at 3.35 TB/s, against 2.1e9 rotation operations (2.2 us at the bf16
// tensor-core rate).  What a straightforward kernel spends its time on is
// O(dh^2) work per vector on the wrong unit: the rotation as f32 FMAs on CUDA
// cores and a top-k that compares every element with every other.  The design:
//   * persistent blocks: 16 warps, one block an SM, sm_count / Kv blocks per kv
//     head, each splitting P[kv] ONCE into three bf16 parts (hi + mid + lo, the
//     24 bits of f32 P; x is exact in bf16) and walking tiles of 64 vectors of
//     that head in a pipeline of two x and two x_hat buffers: tile t is sorted
//     while tile t + 1 is rotated and tile t + 2 staged by cp.async, one barrier
//     a tile;
//   * the rotation on tensor cores: mma.sync m16n8k16, x . P_hi + x . P_mid +
//     x . P_lo into one f32 accumulator (a warp owns 32 vectors x 16 columns),
//     handed to a shared f32 tile;
//   * the top-k as a bitonic sorting network on one 64-bit key per element,
//     |x_hat| bits << 8 | (127 - column) << 1 | sign: a strict total order
//     (larger magnitude first, then lower column), so the network gives exactly
//     the stable descending sort, with no data-dependent control flow, and the
//     value and index are rebuilt from the key.  8 lanes sort one vector, 16
//     keys each: 22 steps stay in registers, 6 exchange keys by shuffles.  The
//     full sort costs no more than a top-half merge here (the lanes that would
//     idle sort the lower half), so every k_max <= dh takes the same path;
//   * dh < 128 is padded: zero columns of x and rows and columns of P, whose
//     keys (index field below every real column's) sort after every element.
// On an H100 the sort sets the time: a compare-exchange is 2 64-bit compares
// and 4 selects on the integer pipe, ~1,900 instructions a lane a vector.
// Timed on an H100 and dropped (PERF.md): 2 lanes x 64 keys at 8 warps
// (one shuffle step, slower), keys as subnormal doubles ordered by the FP64
// pipe's min/max (slower), the high words by FMNMX (slower), the next tile's
// k-steps interleaved between the sort's levels (no faster).
// The f32 instance rotates on CUDA cores (f32 P in shared memory, one warp a
// vector, the sum over d in order) and shares the tile walk, the sort and the
// writes.
//
// Plain C entry point (loaded with ctypes); returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using u64 = unsigned long long;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;             // vectors per tile
constexpr int kD = 128;               // dh padded; int8 indices address dh <= 128
constexpr int kParts = 3;             // bf16 parts of P
constexpr int kHS = kD + 8;           // f32 row stride of the x_hat tile
constexpr int kLanes = 8;             // lanes that sort one vector
constexpr int kKeys = kD / kLanes;    // keys a lane holds
static_assert(kThreads / kLanes == kRows, "one vector of the tile a lane group");

// row strides (elements) of the staged x tiles: 16 bytes of padding keep
// ldmatrix rows (bf16) off each other's banks
template <typename T> __host__ __device__ constexpr int x_stride() {
  return kD + 16 / static_cast<int>(sizeof(T));
}
constexpr int kRS = x_stride<bf16>();  // P parts share the bf16 stride

template <typename T> __host__ __device__ constexpr int p_smem() {
  return sizeof(T) == 2 ? kParts * kD * kRS * 2 : kD * kD * 4;
}
template <typename T> __host__ __device__ constexpr int x_smem() {
  return 2 * kRows * x_stride<T>() * static_cast<int>(sizeof(T));
}
constexpr int kHSmem = 2 * kRows * kHS * 4;        // two x_hat tiles
template <typename T> __host__ __device__ constexpr int smem_bytes() {
  return p_smem<T>() + x_smem<T>() + kHSmem;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);         // round to nearest even, as torch's cast
}

// ---- keys --------------------------------------------------------------------

__device__ __forceinline__ u64 make_key(float v, int col) {
  const uint32_t u = __float_as_uint(v);
  return (static_cast<u64>(u & 0x7fffffffu) << 8) | (static_cast<u64>(kD - 1 - col) << 1) |
         (u >> 31);
}
__device__ __forceinline__ float key_value(u64 key) {
  return __uint_as_float((static_cast<uint32_t>(key >> 8) & 0x7fffffffu) |
                         (static_cast<uint32_t>(key) << 31));
}
__device__ __forceinline__ int key_col(u64 key) {
  return kD - 1 - static_cast<int>((key >> 1) & (kD - 1));
}

// One step (block size S, distance D) of the bitonic network over the kD keys
// of one vector, network position p = kKeys * j + i for key i of lane j of the
// vector's lane group.  A block of positions with (p & S) == 0 sorts descending,
// the others ascending; S = kD is the last level, all descending.  Keys within
// a vector are distinct (the column field), so no compare sees equal keys.
template <int S, int D>
__device__ __forceinline__ void bitonic_steps(u64 (&key)[kKeys], int j) {
  if constexpr (D >= kKeys) {         // partner key i of lane j ^ (D / kKeys)
    const bool lower = (j & (D / kKeys)) == 0;
    const bool asc = ((kKeys * j) & S) != 0;
    const bool keep_max = lower != asc;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const u64 o = __shfl_xor_sync(0xffffffffu, key[i], D / kKeys);
      key[i] = ((key[i] > o) == keep_max) ? key[i] : o;
    }
  } else {                            // partner key i + D of this lane
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      if (i & D) continue;
      const bool asc = ((kKeys * j + i) & S) != 0;
      const u64 a = key[i], b = key[i + D];
      const bool swap = (a < b) != asc;
      key[i] = swap ? b : a;
      key[i + D] = swap ? a : b;
    }
  }
  if constexpr (D > 1) bitonic_steps<S, D / 2>(key, j);
}

template <int S>
__device__ __forceinline__ void bitonic_sort(u64 (&key)[kKeys], int j) {
  bitonic_steps<S, S / 2>(key, j);
  if constexpr (S < kD) bitonic_sort<2 * S>(key, j);
}

// Lane j of a vector's lane group loads the 16-byte chunks j + 8m (m < 4) of
// its x_hat row, so the 8 lanes read 128 contiguous bytes at a time.
__device__ __forceinline__ void load_keys(const float* h_row, int j, u64 (&key)[kKeys]) {
#pragma unroll
  for (int m = 0; m < kKeys / 4; ++m) {
    const int c = 4 * (j + kLanes * m);
    const float4 v = *reinterpret_cast<const float4*>(h_row + c);
    key[4 * m] = make_key(v.x, c);
    key[4 * m + 1] = make_key(v.y, c + 1);
    key[4 * m + 2] = make_key(v.z, c + 2);
    key[4 * m + 3] = make_key(v.w, c + 3);
  }
}

// After the sort lane j holds positions 16j .. 16j + 15: it writes those below
// k as vals and idx of packed row `row`.  out_vec: k % 16 == 0 and both outputs
// 16-byte aligned.
template <typename T>
__device__ __forceinline__ void write_keys(const u64 (&key)[kKeys], int j, int k, size_t row,
                                           T* __restrict__ vals, int8_t* __restrict__ idx,
                                           bool out_vec) {
  const int p0 = kKeys * j;
  if (p0 >= k) return;
  const size_t o = row * static_cast<size_t>(k) + p0;
  if (out_vec && p0 + kKeys <= k) {
    uint32_t w[kKeys * sizeof(T) / 4], q[kKeys / 4];
#pragma unroll
    for (int i = 0; i < kKeys; i += 4) {
      q[i / 4] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        q[i / 4] |= static_cast<uint32_t>(key_col(key[i + e])) << (8 * e);
    }
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(key_value(key[i]));
      } else if (i % 2 == 0) {
        w[i / 2] = sm90::bits(__floats2bfloat162_rn(key_value(key[i]), key_value(key[i + 1])));
      }
    }
    uint4* vd = reinterpret_cast<uint4*>(vals + o);
#pragma unroll
    for (int i = 0; i < kKeys * static_cast<int>(sizeof(T)) / 16; ++i)
      vd[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    uint4* id = reinterpret_cast<uint4*>(idx + o);
#pragma unroll
    for (int i = 0; i < kKeys / 16; ++i)
      id[i] = make_uint4(q[4 * i], q[4 * i + 1], q[4 * i + 2], q[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kKeys; ++i)
      if (p0 + i < k) {
        vals[o + i] = from_f32<T>(key_value(key[i]));
        idx[o + i] = static_cast<int8_t>(key_col(key[i]));
      }
  }
}

// ---- rotation ----------------------------------------------------------------

// x_hat tile = x tile . (P_hi + P_mid + P_lo) on tensor cores: warp w owns rows
// 32 (w / kWarpCols) .. + 32 and kCW columns from kCW (w % kWarpCols), two m16
// tiles by kCW / 8 n8 tiles, over the kD / 16 k-steps; then its accumulators go
// to the shared tile.
constexpr int kWarpCols = kWarps / (kRows / 32);   // warps across the columns
constexpr int kCW = kD / kWarpCols;                // columns a warp
__device__ __forceinline__ void rotate(const bf16* x_s, const bf16* p_s, float* h_s, int) {
  constexpr int kNP = kCW / 16;                    // 16-column ldmatrix pieces
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp / kWarpCols) * 32, c0 = (warp % kWarpCols) * kCW;
  float acc[2][2 * kNP][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * kNP; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[2][4], b[kParts][kNP][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      sm90::ldmatrix_x4(a[mt], x_s + (r0 + 16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8) * kRS +
                                   kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int part = 0; part < kParts; ++part)
#pragma unroll
      for (int np = 0; np < kNP; ++np)
        sm90::ldmatrix_x4_trans(b[part][np],
                                p_s + (part * kD + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                          kRS +
                                      c0 + 16 * np + (lane >> 4) * 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int part = 0; part < kParts; ++part)
#pragma unroll
        for (int np = 0; np < kNP; ++np) {
          sm90::mma_bf16(acc[mt][2 * np], a[mt], b[part][np][0], b[part][np][1]);
          sm90::mma_bf16(acc[mt][2 * np + 1], a[mt], b[part][np][2], b[part][np][3]);
        }
  }
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * kNP; ++nt) {
      float* h = h_s + (r0 + 16 * mt + gq) * kHS + c0 + 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(h) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(h + 8 * kHS) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// f32 on CUDA cores: one warp a vector, lane + 32 c the columns of lane, the
// sum over d in order (f32 FMAs).
__device__ __forceinline__ void rotate(const float* x_s, const float* p_s, float* h_s, int dh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    const float* xr = x_s + r * x_stride<float>();
    float h[kD / 32];
#pragma unroll
    for (int c = 0; c < kD / 32; ++c) h[c] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float xd = xr[d];
#pragma unroll
      for (int c = 0; c < kD / 32; ++c) h[c] = fmaf(xd, p_s[d * kD + lane + 32 * c], h[c]);
    }
#pragma unroll
    for (int c = 0; c < kD / 32; ++c) h_s[r * kHS + lane + 32 * c] = h[c];
  }
}

// P[kv] into shared memory, zero past dh: bf16 parts [part][d][e] (stride kRS),
// or f32 [d][e].  Entry i = threadIdx.x + u kThreads of a thread, 16 loads in
// flight before their stores, so that the split waits on the L2 4 times, not 64.
template <typename PT>
__device__ __forceinline__ void load_p(const float* __restrict__ p, int dh, PT* p_s) {
  constexpr int kPer = kD * kD / kThreads, kBatch = 16;
  for (int u0 = 0; u0 < kPer; u0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = threadIdx.x + (u0 + u) * kThreads, d = i / kD, e = i % kD;
      v[u] = (d < dh && e < dh) ? __ldg(p + d * dh + e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = threadIdx.x + (u0 + u) * kThreads, d = i / kD, e = i % kD;
      if constexpr (sizeof(PT) == 4) {
        p_s[i] = v[u];
      } else {
        const bf16 hi = __float2bfloat16(v[u]);
        const float r = v[u] - __bfloat162float(hi);
        const bf16 mid = __float2bfloat16(r);
        p_s[d * kRS + e] = hi;
        p_s[(kD + d) * kRS + e] = mid;
        p_s[(2 * kD + d) * kRS + e] = __float2bfloat16(r - __bfloat162float(mid));
      }
    }
  }
}

// ---- the tile walk -------------------------------------------------------------

// Block (bx, kv) takes tiles bx, bx + G, ... (G = gridDim.x) of head kv's
// B * ceil(S / 64) tiles (tile t: sequence t / tps, rows 64 (t % tps) ..), in a
// pipeline of two x buffers and two x_hat buffers: while tile t is sorted from
// x_hat buffer t % 2, tile t + G is rotated from x buffer (t + 1) % 2 into the
// other x_hat buffer and tile t + 2G is staged into x buffer t % 2; one barrier
// a tile.  x_vec: rows of 16-byte pieces (dh * sizeof(T) % 16 == 0, x 16-byte
// aligned), staged by cp.async; otherwise element by element.
template <typename T>
__device__ __forceinline__ void prune_tiles(const T* __restrict__ x, const float* __restrict__ p_rot,
                                            T* __restrict__ vals, int8_t* __restrict__ idx, int B,
                                            int Kv, int S, int dh, int k, bool x_vec, bool out_vec,
                                            unsigned char* smem) {
  using PT = typename std::conditional<sizeof(T) == 2, bf16, float>::type;
  constexpr int XS = x_stride<T>();
  PT* p_s = reinterpret_cast<PT*>(smem);
  T* x_s = reinterpret_cast<T*>(smem + p_smem<T>());
  float* h_s = reinterpret_cast<float*>(smem + p_smem<T>() + x_smem<T>());
  const int kv = blockIdx.y, G = gridDim.x;
  const int tps = (S + kRows - 1) / kRows;
  const int n_tiles = B * tps;
  const int r = threadIdx.x / kLanes, j = threadIdx.x % kLanes;   // this lane's vector

  // both x buffers zeroed once: columns past dh are never copied
  for (int i = threadIdx.x; i < x_smem<T>() / 16; i += kThreads)
    reinterpret_cast<uint4*>(x_s)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  auto rows_of = [&](int t, int& n) {
    const int b = t / tps, s0 = (t - b * tps) * kRows;
    n = min(kRows, S - s0);
    return (static_cast<size_t>(b) * Kv + kv) * S + s0;
  };
  auto stage = [&](int t, int buf) {
    int n;
    const T* src = x + rows_of(t, n) * dh;
    T* dst = x_s + buf * kRows * XS;
    if (x_vec) {
      constexpr int kPer = 16 / sizeof(T);
      const int cpr = dh / kPer;
      for (int i = threadIdx.x; i < n * cpr; i += kThreads) {
        const int rr = i / cpr, c = i - rr * cpr;
        sm90::cp_async16(dst + rr * XS + c * kPer, src + static_cast<size_t>(rr) * dh + c * kPer);
      }
    } else {
      for (int i = threadIdx.x; i < n * dh; i += kThreads) {
        const int rr = i / dh;
        dst[rr * XS + i - rr * dh] = src[i];
      }
    }
    sm90::cp_async_commit();
  };

  const int t0 = blockIdx.x;                     // < n_tiles: the launch's grid
  stage(t0, 0);
  if (t0 + G < n_tiles) stage(t0 + G, 1);
  load_p(p_rot + static_cast<size_t>(kv) * dh * dh, dh, p_s);   // under the copies
  sm90::cp_async_wait_all();
  __syncthreads();
  rotate(x_s, p_s, h_s, dh);                     // tile t0
  for (int t = t0, cur = 0; t < n_tiles; t += G, cur ^= 1) {
    sm90::cp_async_wait_all();
    __syncthreads();        // x_hat of tile t and x of tile t + G in place; the
                            // last sort has left the other x_hat buffer
    if (t + 2 * G < n_tiles) stage(t + 2 * G, cur);
    u64 key[kKeys];
    load_keys(h_s + (cur * kRows + r) * kHS, j, key);
    rotate(x_s + (cur ^ 1) * kRows * XS, p_s, h_s + (cur ^ 1) * kRows * kHS, dh);
    bitonic_sort<2>(key, j);
    int n;
    const size_t row0 = rows_of(t, n);
    if (r < n) write_keys<T>(key, j, k, row0 + r, vals, idx, out_vec);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
swan_prune_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ p_rot,
                       bf16* __restrict__ vals, int8_t* __restrict__ idx, int B, int Kv, int S,
                       int dh, int k, int x_vec, int out_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  prune_tiles<bf16>(x, p_rot, vals, idx, B, Kv, S, dh, k, x_vec, out_vec, smem);
}

__global__ void __launch_bounds__(kThreads, 1)
swan_prune_f32_kernel(const float* __restrict__ x, const float* __restrict__ p_rot,
                      float* __restrict__ vals, int8_t* __restrict__ idx, int B, int Kv, int S,
                      int dh, int k, int x_vec, int out_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  prune_tiles<float>(x, p_rot, vals, idx, B, Kv, S, dh, k, x_vec, out_vec, smem);
}

template <typename T, typename Kern>
cudaError_t launch(Kern kern, const void* x, const void* p_rot, void* vals, void* idx, int B,
                   int Kv, int S, int dh, int k, cudaStream_t stream) {
  const int smem = smem_bytes<T>();
  cudaError_t err = sm90::opt_in_smem(kern, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  // one wave: a block an SM, the SMs shared out between the kv heads
  const int tiles = B * ((S + kRows - 1) / kRows);
  const dim3 grid(std::max(1, std::min(tiles, sms / Kv)), Kv);
  const bool x_vec = (dh * static_cast<int>(sizeof(T))) % 16 == 0 && sm90::aligned(x, 16);
  const bool out_vec = k % 16 == 0 && sm90::aligned(vals, 16) && sm90::aligned(idx, 16);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(p_rot), static_cast<T*>(vals),
      static_cast<int8_t*>(idx), B, Kv, S, dh, k, x_vec, out_vec);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = f32, 1 = bf16 (x and vals).  Pointers are device pointers of
// contiguous tensors: x [B,Kv,S,dh], p_rot [Kv,dh,dh] f32, vals [B,Kv,S,k] and
// idx [B,Kv,S,k] int8.
extern "C" int swan_prune_launch(int dtype, const void* x, const void* p_rot, void* vals,
                                 void* idx, int B, int Kv, int S, int dh, int k,
                                 void* stream) {
  if (B < 1 || Kv < 1 || Kv > 65535 || S < 1 || dh < 1 || dh > kD || k < 1 || k > dh)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(swan_prune_f32_kernel, x, p_rot, vals, idx, B, Kv, S, dh, k, st);
    case 1: return launch<bf16>(swan_prune_bf16_kernel, x, p_rot, vals, idx, B, Kv, S, dh, k, st);
  }
  return cudaErrorInvalidValue;
}

// Shared memory of one block of the dtype's instance (mirrored by the
// wrapper's ``smem_bytes``).
extern "C" int swan_prune_smem_bytes(int dtype) {
  return dtype == 1 ? smem_bytes<bf16>() : smem_bytes<float>();
}

extern "C" const char* swan_prune_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
