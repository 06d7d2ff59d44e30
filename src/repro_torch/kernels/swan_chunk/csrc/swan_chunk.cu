// SWAN chunk-prefill sparse-prefix statistics for Hopper (sm_90a), slab and paged.
//
// Replaces the TPU kernels `swan_chunk_stats_pallas` (slab) and
// `swan_chunk_stats_paged_pallas` (page pool), src/repro/kernels/flash_prefill/
// swan_chunk.py: Q = C*G chunk queries of one (lane, kv head) against the valid
// packed sparse prefix t < sp_len, returned as MERGEABLE partial softmax stats
//   m_safe [P,Kv,Q] (0 where no row was valid), l [P,Kv,Q], o_unnorm [P,Kv,Q,dh],
// all f32, with the Pallas body's contract: q, the dequantised values and every
// sum in f32.  The dense [ring || chunk] side and the merge stay outside.
//
// What bounds it: bytes.  The function is a sparse product: 4*Q*k flops per
// valid row (q.k over the k stored entries, p.v into them), against the packed
// rows, q and the three f32 outputs read or written once.  At the engine's chunk
// (P=2, Q=1024, dh=128, k=64, sp_len 1000|1920, bf16 values) that is ~6.2 us of
// operations at the bf16 tensor-core rate and ~7.7 us of bytes.  A kernel works
// on the dense expansion (4*Q*sp_len*dh flops, twice the sparse count), as the
// TPU kernel does with its one-hot expansion, so its products must run at the
// tensor-core rate to stay near the byte bound, and the expansion (one shared
// store per packed entry) must not be repeated more often than needed.
//
// bf16, int8 and fp8 values: warp-level tensor cores.
//   * one block of 8 warps per (128 queries, kv head, lane), 16 queries a warp:
//     8 x Kv x P = 128 blocks at the engine chunk, one wave on 132 SMs, and the
//     prefix is expanded 8 times (once per query tile) instead of 16;
//   * each tile of 64 packed rows is expanded ONCE into bf16 [64, dh16 + 8]
//     shared tiles of k and v (zero-fill, then scatter: the k indices of one
//     vector are distinct, so no two threads write one element; 4 threads of
//     one warp own a row, so a __syncwarp orders its zero-fill and scatter);
//     bf16, fp8-e4m3 and int8 values are exact in bf16;
//   * the packed vals, idx and scales of tile j+1 are copied by cp.async into
//     the other of two staging buffers while tile j is expanded and multiplied;
//   * S = Q.K^T and O += P.V by mma.sync m16n8k16 with f32 accumulators.  q
//     (f32 by contract) is split into q_hi + q_lo bf16 parts, stored with the
//     block's 128 rows in shared memory, so S is two products; the int8 key
//     scale multiplies S after the product; the online softmax runs on the
//     accumulators in f32, in natural units as the twin's (exp2 of
//     (s - m) * log2 e); p (times the int8 value scale) is split into p_hi +
//     p_lo bf16 A fragments, so O is two products; l sums the f32 p.  Each
//     split keeps 16 significant bits: the scheme agrees with the f32 twin to
//     ~1e-5, where one bf16 rounding of q or p misses 1e-5 by two orders of
//     magnitude.  int8 values dequantise to scores a few times larger, whose
//     16-bit q error misses 1e-4: there q gets a third part q_lo2 (24 bits, a
//     third product) (tests/test_torch_swan_chunk.py emulates the scheme);
//   * the q and K fragments of a k-step (V: of a half k-step) load by
//     ldmatrix in a ring of two, the next step's while this one's products
//     issue: the asm statements keep their order, and two warps a scheduler
//     cannot hide a load's latency alone;
//   * rows past sp_len are never read; the last tile masks its tail; sp_len = 0
//     writes (0, 0, 0).
//   What bounds it now: the dense products on mma.sync (2 or 3 per side, for
//   twice the sparse count) and the expansion, both repeated by each query
//   tile: it runs at ~3 % of its byte bound.  wgmma, as B5's body has, is the
//   next step for the products.
//   A cluster of the 8 query-tile blocks of one (lane, kv head) could share the
//   expansion through distributed shared memory: each block would expand 8 of
//   a tile's 64 rows and read the rest from its neighbours, cutting the packed
//   reads from L2 and the expansion stores per block 8-fold (≈ 7/8 of the
//   expansion time) at the price of a cluster barrier per tile.  Not built.
//
// f32 values: f32 products on CUDA cores (the contract's 1e-5 agreement on f32
// values would take a three-way bf16 split of both operands): one block per
// (64 queries, kv head, lane); the q tile, expanded f32 k and v tiles of 32
// rows and the probabilities in shared memory; [64, 32] scores (thread = 4
// queries x 2 rows), the online softmax by shuffles over the 16 threads that
// share a query, acc[64, dh] += p.v (thread = 4 queries x dh/16 columns).
//
// Slab and paged share each body: only the row address differs (`sparse_row`,
// kernels/csrc/common.cuh, as `stage_rows`), so the paged kernel equals the
// slab kernel bit for bit on the same logical rows.
//
// Plain C entry point (loaded with ctypes); returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kMaxDh = 128;

// ---------------------------------------------------------------------------
// bf16 / int8 / fp8 values: mma.sync tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 256;         // 8 warps x 16 queries
constexpr int kQT = 128;              // queries per block
constexpr int kBS = 64;               // packed rows per tile

__host__ __device__ __forceinline__ int pad16(int dh) { return (dh + 15) & ~15; }
__host__ __device__ __forceinline__ int row_stride(int dh) { return pad16(dh) + 8; }
__host__ __device__ __forceinline__ int a16(int bytes) { return (bytes + 15) & ~15; }

// One staging buffer: k vals | v vals | k idx | v idx | k scale | v scale.
struct Stage {
  int vals, idx, scale;
  __host__ __device__ Stage(int k, int vb) : vals(a16(kBS * k * vb)), idx(a16(kBS * k)),
                                             scale(kBS * 4) {}
  __host__ __device__ int bytes() const { return 2 * (vals + idx + scale); }
};

// the q tile as q_parts bf16 parts, [q_parts][kQT][row_stride]
__host__ __device__ __forceinline__ int q_bytes(int q_parts, int dh) {
  return q_parts * kQT * row_stride(dh) * static_cast<int>(sizeof(__nv_bfloat16));
}

// expanded k and v tiles, the parts of the q tile, two staging buffers
int smem_bytes(int dh, int k, int vb, int q_parts) {
  return 2 * kBS * row_stride(dh) * static_cast<int>(sizeof(__nv_bfloat16)) +
         q_bytes(q_parts, dh) + 2 * Stage(k, vb).bytes();
}

}  // namespace tc

__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t x) {
  return __float2bfloat16(static_cast<float>(x));       // exact: |x| <= 128
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_fp8_e4m3 x) {
  return __float2bfloat16(static_cast<float>(x));       // exact: 4 significant bits
}

// VT: type of the packed values (bf16, int8 with an f32 per-row scale, fp8 e4m3).
// bf16 parts of q: hi + lo (16 bits), and lo2 for int8 (24 bits).
template <typename VT>
constexpr int kQParts = std::is_same<VT, int8_t>::value ? 3 : 2;

template <typename VT>
__global__ void __launch_bounds__(tc::kThreads, 1)
swan_chunk_mma_kernel(const float* __restrict__ q, const VT* __restrict__ k_vals,
                      const int8_t* __restrict__ k_idx, const VT* __restrict__ v_vals,
                      const int8_t* __restrict__ v_idx, const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale, const int* __restrict__ sp_len,
                      const int* __restrict__ page_tab, float* __restrict__ m_out,
                      float* __restrict__ l_out, float* __restrict__ o_out, int Kv, int Q,
                      int dh, int S, int k, int ps, int n_pages, float scale, int g_vals,
                      int g_idx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int RS = tc::row_stride(dh), D = tc::pad16(dh), nd = D / 16;
  __nv_bfloat16* k_e = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kBS][RS]
  __nv_bfloat16* v_e = k_e + tc::kBS * RS;
  __nv_bfloat16* q_s = v_e + tc::kBS * RS;                 // [kQParts][kQT][RS]
  unsigned char* stage0 = reinterpret_cast<unsigned char*>(q_s) + tc::q_bytes(kQParts<VT>, dh);
  const tc::Stage lay(k, static_cast<int>(sizeof(VT)));
  const bool scaled = k_scale != nullptr;

  const int q0 = blockIdx.x * tc::kQT, kv = blockIdx.y, lane_p = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int n_valid = min(max(sp_len[lane_p], 0), S);
  const int n_tiles = (n_valid + tc::kBS - 1) / tc::kBS;
  const size_t head = static_cast<size_t>(lane_p) * Kv + kv;

  // packed tile j into staging buffer st (only rows below sp_len)
  auto load_tile = [&](int j, int st) {
    const int t0 = j * tc::kBS, n = min(tc::kBS, n_valid - t0);
    unsigned char* sb = stage0 + st * lay.bytes();
    const int vb = k * static_cast<int>(sizeof(VT));
    auto stage = [&](unsigned char* dst, const void* src, int row_bytes, int g) {
      sm90::stage_rows(dst, src, row_bytes, g, t0, n, page_tab, lane_p, kv, Kv, S, ps, n_pages,
                       tc::kThreads);
    };
    stage(sb, k_vals, vb, g_vals);
    stage(sb + lay.vals, v_vals, vb, g_vals);
    sb += 2 * lay.vals;
    stage(sb, k_idx, k, g_idx);
    stage(sb + lay.idx, v_idx, k, g_idx);
    if (scaled) {
      sb += 2 * lay.idx;
      stage(sb, k_scale, 4, 4);
      stage(sb + lay.scale, v_scale, 4, 4);
    }
    sm90::cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0, 0);

  // q = q_hi + q_lo [+ q_lo2] into the warp's 16 rows of each part of q_s (read
  // back as A fragments by ldmatrix, k-step by k-step)
  const int qw = q0 + warp * 16;
  const bool warp_live = qw < Q;
  for (int i = lane; i < 16 * (D / 2); i += 32) {
    const int r = i / (D / 2), c = 2 * (i - r * (D / 2)), row = qw + r;
    const float* qr = q + (head * Q + row) * dh;
    float x0 = row < Q && c < dh ? qr[c] : 0.f, x1 = row < Q && c + 1 < dh ? qr[c + 1] : 0.f;
#pragma unroll
    for (int part = 0; part < kQParts<VT>; ++part) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      *reinterpret_cast<__nv_bfloat162*>(q_s + (part * tc::kQT + warp * 16 + r) * RS + c) = h;
      x0 -= __low2float(h);
      x1 -= __high2float(h);
    }
  }

  float oacc[kMaxDh / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxDh / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_r[2] = {sm90::kNegInf, sm90::kNegInf}, l_r[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    sm90::cp_async_wait_all();
    __syncthreads();            // tile j staged; every warp is done with tile j-1
    if (j + 1 < n_tiles) load_tile(j + 1, (j + 1) & 1);
    const int t0 = j * tc::kBS;
    const unsigned char* sb = stage0 + (j & 1) * lay.bytes();
    const float* ksc = reinterpret_cast<const float*>(sb + 2 * (lay.vals + lay.idx));
    const float* vsc = ksc + tc::kBS;

    // ---- expand: 4 threads of one warp per row, zero-fill then scatter -------
    {
      const VT* kv_s = reinterpret_cast<const VT*>(sb);
      const VT* vv_s = reinterpret_cast<const VT*>(sb + lay.vals);
      const int8_t* ki_s = reinterpret_cast<const int8_t*>(sb + 2 * lay.vals);
      const int8_t* vi_s = ki_s + lay.idx;
      const int r = tid >> 2, sub = tid & 3;
      for (int c = sub; c < D / 8; c += 4) {
        *reinterpret_cast<uint4*>(k_e + r * RS + c * 8) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(v_e + r * RS + c * 8) = make_uint4(0, 0, 0, 0);
      }
      __syncwarp();
      if (t0 + r < n_valid) {
        for (int e = sub; e < k; e += 4) {
          k_e[r * RS + sm90::col(ki_s[r * k + e], dh)] = to_bf16(kv_s[r * k + e]);
          v_e[r * RS + sm90::col(vi_s[r * k + e], dh)] = to_bf16(vv_s[r * k + e]);
        }
      }
    }
    __syncthreads();            // the expanded tile is complete
    if (!warp_live) continue;

    // ---- S = (q_hi + q_lo [+ q_lo2]) . K^T: [16 queries x 64 rows] per warp --
    float s[tc::kBS / 8][4];
#pragma unroll
    for (int n = 0; n < tc::kBS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    // K and q fragments of k-step kk, in a ring of two k-steps: the next
    // k-step's loads are in flight while this one's products issue
    uint32_t kb[2][tc::kBS / 16][4], qf[2][kQParts<VT>][4];
    auto load_s = [&](int kk, uint32_t (&kd)[tc::kBS / 16][4], uint32_t (&qd)[kQParts<VT>][4]) {
#pragma unroll
      for (int part = 0; part < kQParts<VT>; ++part)
        sm90::ldmatrix_x4(qd[part], q_s + (part * tc::kQT + warp * 16 + (lane & 7) +
                                           ((lane >> 3) & 1) * 8) * RS +
                                          kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < tc::kBS / 16; ++np)
        sm90::ldmatrix_x4(kd[np], k_e + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                                      kk * 16 + ((lane >> 3) & 1) * 8);
    };
    load_s(0, kb[0], qf[0]);
#pragma unroll
    for (int kk = 0; kk < kMaxDh / 16; ++kk) {
      if (kk < nd) {
        if (kk + 1 < nd) load_s(kk + 1, kb[(kk + 1) & 1], qf[(kk + 1) & 1]);
#pragma unroll
        for (int part = 0; part < kQParts<VT>; ++part)
#pragma unroll
          for (int np = 0; np < tc::kBS / 16; ++np) {
            sm90::mma_bf16(s[2 * np], qf[kk & 1][part], kb[kk & 1][np][0], kb[kk & 1][np][1]);
            sm90::mma_bf16(s[2 * np + 1], qf[kk & 1][part], kb[kk & 1][np][2],
                           kb[kk & 1][np][3]);
          }
      }
    }

    // ---- key scale, score scale, tail mask, online softmax -------------------
    // (scores stay in natural units, as the twin's: exp2 takes (s - m) * log2 e,
    // whose rounding is relative to s - m, not to s)
    const bool masked = t0 + tc::kBS > n_valid;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < tc::kBS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1);
        float x = s[n][e];
        if (scaled) x *= ksc[c];
        x *= scale;
        if (masked && t0 + c >= n_valid) x = sm90::kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float corr = exp2f((m_r[i] - mx[i]) * sm90::kLog2e);
      m_r[i] = mx[i];
      l_r[i] *= corr;
#pragma unroll
      for (int n = 0; n < kMaxDh / 8; ++n) {
        oacc[n][2 * i] *= corr;
        oacc[n][2 * i + 1] *= corr;
      }
    }
    // p (times the value scale) as A fragments, split into bf16 hi + lo
    uint32_t ph[tc::kBS / 16][4], pl[tc::kBS / 16][4];
#pragma unroll
    for (int n = 0; n < tc::kBS / 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = (!masked || s[n][e] > 0.5f * sm90::kNegInf)
                   ? exp2f((s[n][e] - mx[e >> 1]) * sm90::kLog2e)
                   : 0.f;
      l_r[0] += p[0] + p[1];
      l_r[1] += p[2] + p[3];
      if (scaled) {             // the tail's scales were never staged: 0 keeps p = 0
        const int c = n * 8 + 2 * tq;
        const float v0 = masked && t0 + c >= n_valid ? 0.f : vsc[c];
        const float v1 = masked && t0 + c + 1 >= n_valid ? 0.f : vsc[c + 1];
        p[0] *= v0;
        p[1] *= v1;
        p[2] *= v0;
        p[3] *= v1;
      }
      sm90::split_bf16(p[0], p[1], ph[n >> 1][2 * (n & 1)], pl[n >> 1][2 * (n & 1)]);
      sm90::split_bf16(p[2], p[3], ph[n >> 1][2 * (n & 1) + 1], pl[n >> 1][2 * (n & 1) + 1]);
    }

    // ---- O += (p_hi + p_lo) . V: [16 queries x dh] per warp -----------------
    // V fragments by half-step h = (k-step h/2, dh columns 64*(h%2) ..), in a
    // ring of two half-steps
    constexpr int kHalf = kMaxDh / 32;        // 16-column pairs per half-step
    uint32_t vb[2][kHalf][4];
    auto load_v = [&](int h, uint32_t (&dst)[kHalf][4]) {
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        const int dp = (h & 1) * kHalf + d;
        if (dp < nd)
          sm90::ldmatrix_x4_trans(dst[d], v_e + ((h >> 1) * 16 + (lane & 7) +
                                                 ((lane >> 3) & 1) * 8) * RS +
                                                dp * 16 + (lane >> 4) * 8);
      }
    };
    load_v(0, vb[0]);
#pragma unroll
    for (int h = 0; h < 2 * (tc::kBS / 16); ++h) {
      if (h + 1 < 2 * (tc::kBS / 16)) load_v(h + 1, vb[(h + 1) & 1]);
      const int kk = h >> 1;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        const int dp = (h & 1) * kHalf + d;
        if (dp < nd) {
          sm90::mma_bf16(oacc[2 * dp], ph[kk], vb[h & 1][d][0], vb[h & 1][d][1]);
          sm90::mma_bf16(oacc[2 * dp + 1], ph[kk], vb[h & 1][d][2], vb[h & 1][d][3]);
          sm90::mma_bf16(oacc[2 * dp], pl[kk], vb[h & 1][d][0], vb[h & 1][d][1]);
          sm90::mma_bf16(oacc[2 * dp + 1], pl[kk], vb[h & 1][d][2], vb[h & 1][d][3]);
        }
      }
    }
  }

  // ---- write the stats of this warp's valid queries --------------------------
  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = qw + gq + 8 * i;
    if (row >= Q) continue;
    const size_t qi = head * Q + row;
    if (tq == 0) {
      m_out[qi] = (m_r[i] > 0.5f * sm90::kNegInf) ? m_r[i] : 0.f;   // empty prefix -> 0
      l_out[qi] = l;
    }
#pragma unroll
    for (int n = 0; n < kMaxDh / 8; ++n) {
      const int c = n * 8 + 2 * tq;
      if (c < dh) o_out[qi * dh + c] = oacc[n][2 * i];
      if (c + 1 < dh) o_out[qi * dh + c + 1] = oacc[n][2 * i + 1];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 values: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kThreads = 256;
constexpr int kQT = 64;               // queries per block: 16 thread rows x 4
constexpr int kBS = 32;               // sparse rows per tile: 16 thread columns x 2

// strides (in floats) of the shared tiles, padded against bank conflicts
__host__ __device__ __forceinline__ int q_stride(int dh) { return dh + 4; }
__host__ __device__ __forceinline__ int kv_stride(int dh) { return dh + 1; }
constexpr int kPStride = kBS + 1;

int smem_bytes(int dh) {
  return static_cast<int>(sizeof(float)) *
         (kQT * q_stride(dh) + 2 * kBS * kv_stride(dh) + kQT * kPStride);
}

}  // namespace f32

__global__ void __launch_bounds__(f32::kThreads)
swan_chunk_f32_kernel(const float* __restrict__ q, const float* __restrict__ k_vals,
                      const int8_t* __restrict__ k_idx, const float* __restrict__ v_vals,
                      const int8_t* __restrict__ v_idx, const int* __restrict__ sp_len,
                      const int* __restrict__ page_tab, float* __restrict__ m_out,
                      float* __restrict__ l_out, float* __restrict__ o_out, int Kv, int Q,
                      int dh, int S, int k, int ps, int n_pages, float scale) {
  using namespace f32;
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
    m[i] = sm90::kNegInf;
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
        const size_t row = sm90::sparse_row(page_tab, lane, kv, Kv, S, ps, n_pages, t);
        k_s[r * KS + sm90::col(k_idx[row * k + j], dh)] = k_vals[row * k + j];
        v_s[r * KS + sm90::col(v_idx[row * k + j], dh)] = v_vals[row * k + j];
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
      for (int j = 0; j < 2; ++j) s[i][j] = ok[j] ? s[i][j] * scale : sm90::kNegInf;
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
      m_out[qi] = (m[i] > 0.5f * sm90::kNegInf) ? m[i] : 0.f;   // empty prefix -> 0
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
cudaError_t launch_mma(const void* q, const void* k_vals, const void* k_idx,
                       const void* v_vals, const void* v_idx, const void* k_scale,
                       const void* v_scale, const void* sp_len, const void* page_tab,
                       void* m_out, void* l_out, void* o_out, int P, int Kv, int Q, int dh,
                       int S, int k, int ps, int n_pages, cudaStream_t stream) {
  const int smem = tc::smem_bytes(dh, k, static_cast<int>(sizeof(VT)), kQParts<VT>);
  auto kern = swan_chunk_mma_kernel<VT>;
  cudaError_t err = sm90::opt_in_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + tc::kQT - 1) / tc::kQT, Kv, P);
  kern<<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const VT*>(k_vals),
      static_cast<const int8_t*>(k_idx), static_cast<const VT*>(v_vals),
      static_cast<const int8_t*>(v_idx), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(sp_len),
      static_cast<const int*>(page_tab), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(o_out), Kv, Q, dh, S, k, ps, n_pages,
      static_cast<float>(1.0 / sqrt(static_cast<double>(dh))),
      sm90::copy_width(k_vals, v_vals, k * static_cast<int>(sizeof(VT))),
      sm90::copy_width(k_idx, v_idx, k));
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k_vals, const void* k_idx, const void* v_vals,
                       const void* v_idx, const void* sp_len, const void* page_tab,
                       void* m_out, void* l_out, void* o_out, int P, int Kv, int Q, int dh,
                       int S, int k, int ps, int n_pages, cudaStream_t stream) {
  const int smem = f32::smem_bytes(dh);
  cudaError_t err = sm90::opt_in_smem(swan_chunk_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + f32::kQT - 1) / f32::kQT, Kv, P);
  swan_chunk_f32_kernel<<<grid, f32::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_vals),
      static_cast<const int8_t*>(k_idx), static_cast<const float*>(v_vals),
      static_cast<const int8_t*>(v_idx), static_cast<const int*>(sp_len),
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
    case 0:
      return launch_f32(q, k_vals, k_idx, v_vals, v_idx, sp_len, page_tab, m_out, l_out, o_out,
                        P, Kv, Q, dh, S, k, ps, n_pages, st);
    case 1: return launch_mma<__nv_bfloat16>(CHUNK_ARGS);
    case 2: return launch_mma<int8_t>(CHUNK_ARGS);
    case 3: return launch_mma<__nv_fp8_e4m3>(CHUNK_ARGS);
  }
#undef CHUNK_ARGS
  return cudaErrorInvalidValue;
}

extern "C" const char* swan_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
