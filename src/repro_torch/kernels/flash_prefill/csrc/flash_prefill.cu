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
// (0.050 ms at 3.35 TB/s).  So the products belong on the tensor cores.
//
// Both instances keep what the TPU kernel keeps out of device memory, and read
// each K/V tile once per kv group rather than once per query head: a block owns
// rows r = pos*G + g of one kv group (any G), so the G heads of a position share
// every K/V tile and sit contiguous in q and o; causal, the key loop stops after
// the block's last query position (the TPU kernel skips whole key blocks above
// the diagonal, :81).
//
// bf16 instance (the bench's and any bf16 caller's): Hopper's warpgroup MMA.
//   * one block of 2 warpgroups per (128 rows of one kv group, kv head, batch),
//     64 rows a warpgroup (wgmma's M);
//   * the q rows and K/V tiles of 64 keys stay bf16 in shared memory, stored as
//     two 64-column halves with the 128-byte swizzle that wgmma's SW128 layouts
//     read (dh zero-padded to 128, which is exact); q and a ring of two K/V
//     stages are filled by cp.async 16 B a thread, so tile j+1 is in flight
//     while tile j is multiplied, and a proxy fence hands them to wgmma;
//   * S = Q.K^T: wgmma m64n64k16, Q and K both from shared memory (K-major),
//     f32 accumulators; the online softmax runs on the accumulators in
//     registers (f32, ex2.approx on log2-scaled scores; max and sum over the 4
//     lanes that share a row); O += P.V: wgmma m64n128k16 with P from
//     registers (the S accumulators, packed to bf16, are its A fragments) and
//     V from shared memory MN-major (transposed by the instruction);
//   * P is the one operand the f32 contract does not hand over in bf16: one
//     bf16 rounding of P misses the one-bf16-step agreement on rows with few
//     visible keys, so P = P_hi + P_lo (both bf16) and P.V is two products;
//     l sums the f32 P;
//   * only tiles that cross a warp's diagonal (or the key tail) evaluate the
//     mask; a warpgroup skips a tile that lies wholly above its rows; the grid
//     runs the heaviest query tiles (the last positions) first, so the causal
//     triangle's short tiles fill the tail of the grid.
//   What bounds it now: each warpgroup waits for its products before its
//   softmax, and the block barrier of every tile keeps the two warpgroups in
//   step, so the tensor cores idle while both run their softmax (ping-pong
//   scheduling or a producer warp with mbarriers is the next step); and the
//   second P.V product.
//
// f32 instance: f32 products on CUDA cores (no tensor-core type keeps f32
// agreement at 2e-5): one block per (64 query rows of one kv group, kv head,
// batch); q rows, K and V tiles of 32 keys and the probabilities as f32 in
// shared memory; [64, 32] scores (thread = 4 rows x 2 keys), the masked online
// softmax by shuffles over the 16 threads that share a row, acc[64, dh] += p.v
// (thread = 4 rows x dh/16 columns, in registers).
//
// Plain C entry point (loaded with ctypes); returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kMaxDh = 128;

// ---------------------------------------------------------------------------
// bf16 instance: wgmma tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 256;         // 2 warpgroups x 64 query rows
constexpr int kBM = 128;              // query rows per block
constexpr int kBN = 64;               // keys per tile
constexpr int kStages = 2;            // K/V ring depth
constexpr int kRowBytes = 128;        // one 64-column half of a row: the swizzle atom's width
constexpr int kHalfQ = kBM * kRowBytes;          // one half of the q tile
constexpr int kHalfKV = kBN * kRowBytes;         // one half of a K or V tile
// q tile, the K/V ring, and 1 KB to align the base on the swizzle atoms
int smem_bytes() { return 1024 + 2 * kHalfQ + kStages * 2 * 2 * kHalfKV; }

// Byte offset of 16-byte chunk c (columns 8c..8c+7, c < 16) of row r in a tile
// of `rows` rows stored as two 64-column halves [half][rows][128 B], each with
// the 128-byte swizzle (chunk ^= row % 8) of wgmma's SW128 layouts.
__device__ __forceinline__ int swz(int r, int c, int rows) {
  return (c >> 3) * rows * kRowBytes + r * kRowBytes + (((c & 7) ^ (r & 7)) << 4);
}

}  // namespace tc

// wgmma matrix descriptor of a 128-byte-swizzled tile at p: LBO, the byte
// offset between atoms along MN of an MN-major operand (unused K-major); SBO,
// the byte offset between groups of 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lbo, int sbo) {
  return static_cast<uint64_t>((sm90::smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of an accumulator across the asm
// statements that issue or await the products writing it
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// shared-memory writes of the generic proxy (cp.async, stores) -> visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A . B, m64n64k16, A and B from shared memory (K-major, 128-byte
// swizzle); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A . B, m64n128k16, A from registers (each warp's 16 rows as the mma.sync
// A fragment), B from shared memory MN-major (transposed; 128-byte swizzle).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__global__ void __launch_bounds__(tc::kThreads, 1)
flash_prefill_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          int Sq, int Sk, int H, int Kv, int dh, int causal, float scale_log2,
                          int vec, int B, int n_row_tiles) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned base: every tile's swizzle atoms start on 1024 B
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;                                      // [2][kBM][128 B]
  unsigned char* kv_s = base + 2 * tc::kHalfQ;                    // [stage][K, V][2][kBN][128 B]
  const int nd = ((dh + 15) & ~15) / 16;                          // k-steps of 16 columns

  // heaviest first: the linear block id walks the row tiles from the last one,
  // every (kv head, batch) of a row tile before the next
  const int id = static_cast<int>(blockIdx.x), per_tile = Kv * B;
  const int tile = n_row_tiles - 1 - id / per_tile;
  const int kv = id % per_tile / B, b = id % B;
  const int G = H / Kv, n_rows = Sq * G, r0 = tile * tc::kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wgi = tid >> 7;
  const int gq = lane >> 2, tq = lane & 3;
  const int last_pos = (min(r0 + tc::kBM, n_rows) - 1) / G;
  const int n_keys = causal ? min(Sk, last_pos + 1) : Sk;
  const int n_tiles = (n_keys + tc::kBN - 1) / tc::kBN;

  auto row_off = [&](int rg) -> size_t {           // (position, head) row -> element offset
    const int pos = rg / G, g = rg - pos * G;
    return ((static_cast<size_t>(b) * Sq + pos) * H + kv * G + g) * dh;
  };
  // this warpgroup's 64 rows, and this thread's two (gq and gq + 8 of its warp's 16)
  const int gr = r0 + wgi * 64;
  const bool wg_live = gr < n_rows;
  const int wg_hi = min(gr + 63, n_rows - 1) / G;          // last position of the warpgroup
  const int w_lo = min(r0 + warp * 16, n_rows - 1) / G;    // first position of the warp
  bool live[2];
  int rpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rg = r0 + warp * 16 + gq + 8 * i;
    live[i] = rg < n_rows;
    rpos[i] = live[i] ? rg / G : INT_MAX;                    // a dead row sees every key
  }

  // the block's q rows, and K/V tile j into stage st: swizzled, zeros past the
  // group's rows, past n_keys and past dh
  auto load_q = [&]() {
    if (vec) {
      for (int i = tid; i < tc::kBM * 16; i += tc::kThreads) {
        const int r = i >> 4, c = i & 15, rg = r0 + r;
        const bool ok = rg < n_rows && c * 8 < dh;
        sm90::cp_async16(q_s + tc::swz(r, c, tc::kBM), ok ? q + row_off(rg) + c * 8 : q,
                         ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < tc::kBM * 128; i += tc::kThreads) {
        const int r = i >> 7, cc = i & 127, rg = r0 + r;
        const __nv_bfloat16 x =
            rg < n_rows && cc < dh ? q[row_off(rg) + cc] : __float2bfloat16(0.f);
        *reinterpret_cast<__nv_bfloat16*>(q_s + tc::swz(r, cc >> 3, tc::kBM) + (cc & 7) * 2) = x;
      }
    }
  };
  auto load_tile = [&](int j, int st) {
    const int t0 = j * tc::kBN;
    unsigned char* ks = kv_s + st * 4 * tc::kHalfKV;
    unsigned char* vs = ks + 2 * tc::kHalfKV;
    if (vec) {
      for (int i = tid; i < tc::kBN * 16; i += tc::kThreads) {
        const int r = i >> 4, c = i & 15, t = t0 + r;
        const bool ok = t < n_keys && c * 8 < dh;
        const size_t off = ((static_cast<size_t>(b) * Sk + (ok ? t : 0)) * Kv + kv) * dh + c * 8;
        sm90::cp_async16(ks + tc::swz(r, c, tc::kBN), ok ? k + off : k, ok ? 16 : 0);
        sm90::cp_async16(vs + tc::swz(r, c, tc::kBN), ok ? v + off : v, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < tc::kBN * 128; i += tc::kThreads) {
        const int r = i >> 7, cc = i & 127, t = t0 + r;
        __nv_bfloat16 xk = __float2bfloat16(0.f), xv = xk;
        if (t < n_keys && cc < dh) {
          const size_t off = ((static_cast<size_t>(b) * Sk + t) * Kv + kv) * dh + cc;
          xk = k[off];
          xv = v[off];
        }
        const int at = tc::swz(r, cc >> 3, tc::kBN) + (cc & 7) * 2;
        *reinterpret_cast<__nv_bfloat16*>(ks + at) = xk;
        *reinterpret_cast<__nv_bfloat16*>(vs + at) = xv;
      }
    }
    sm90::cp_async_commit();
  };

  load_q();
  load_tile(0, 0);

  float oacc[64];                             // m64n128 accumulator: column 8n + 2tq + (e & 1)
#pragma unroll                                // of row gq + 8 (e >> 1) in oacc[4n + e]
  for (int i = 0; i < 64; ++i) oacc[i] = 0.f;
  float m_r[2] = {sm90::kNegInf, sm90::kNegInf}, l_r[2] = {0.f, 0.f};
  const uint64_t q_desc = sw128_desc(q_s + wgi * 64 * tc::kRowBytes, 16, 1024);

  for (int j = 0; j < n_tiles; ++j) {
    sm90::cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();                  // tile j landed; every warpgroup is done with tile j-1
    if (j + 1 < n_tiles) load_tile(j + 1, (j + 1) & 1);
    const int t0 = j * tc::kBN;
    if (!wg_live || (causal && t0 > wg_hi)) continue;   // no row of the warpgroup sees it
    unsigned char* ks = kv_s + (j & 1) * 4 * tc::kHalfKV;
    unsigned char* vs = ks + 2 * tc::kHalfKV;

    // ---- S = Q . K^T: [64 rows x 64 keys] per warpgroup, s[4n + e] ------------
    float s[32];
    const uint64_t k_desc = sw128_desc(ks, 16, 1024);
    wgmma_fence();
    for (int kk = 0; kk < nd; ++kk) {
      const int qa = ((kk >> 2) * tc::kHalfQ + (kk & 3) * 32) >> 4;
      const int ka = ((kk >> 2) * tc::kHalfKV + (kk & 3) * 32) >> 4;
      wgmma_m64n64k16_ss(s, q_desc + qa, k_desc + ka, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    // ---- scale, mask (diagonal and tail tiles only), online softmax ----------
    const bool masked = (causal && t0 + tc::kBN - 1 > w_lo) || t0 + tc::kBN > n_keys;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < tc::kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * scale_log2;
        if (masked) {
          const int t = t0 + n * 8 + 2 * tq + (e & 1);
          if (!(t < n_keys && (!causal || t <= rpos[e >> 1]))) x = sm90::kNegInf;
        }
        s[4 * n + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float corr = sm90::ex2_approx(m_r[i] - mx[i]);
      m_r[i] = mx[i];
      l_r[i] *= corr;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        oacc[4 * n + 2 * i] *= corr;
        oacc[4 * n + 2 * i + 1] *= corr;
      }
    }
    // P as A fragments of the P.V product, split into bf16 hi + lo
    uint32_t ph[tc::kBN / 16][4], pl[tc::kBN / 16][4];
#pragma unroll
    for (int n = 0; n < tc::kBN / 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = (!masked || s[4 * n + e] > 0.5f * sm90::kNegInf)
                   ? sm90::ex2_approx(s[4 * n + e] - mx[e >> 1])
                   : 0.f;
      l_r[0] += p[0] + p[1];
      l_r[1] += p[2] + p[3];
      sm90::split_bf16(p[0], p[1], ph[n >> 1][2 * (n & 1)], pl[n >> 1][2 * (n & 1)]);
      sm90::split_bf16(p[2], p[3], ph[n >> 1][2 * (n & 1) + 1], pl[n >> 1][2 * (n & 1) + 1]);
    }

    // ---- O += (P_hi + P_lo) . V: [64 rows x 128 columns] per warpgroup --------
    const uint64_t v_desc = sw128_desc(vs, tc::kHalfKV, 1024);
    fence_operands(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < tc::kBN / 16; ++kk) {
      wgmma_m64n128k16_rs_tb(oacc, ph[kk], v_desc + ((kk * 16 * tc::kRowBytes) >> 4), 1);
      wgmma_m64n128k16_rs_tb(oacc, pl[kk], v_desc + ((kk * 16 * tc::kRowBytes) >> 4), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(oacc);
  }

  // ---- o = acc / max(l, 1e-30), bf16 -------------------------------------------
  if (!wg_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (!live[i]) continue;
    const size_t off = row_off(r0 + warp * 16 + gq + 8 * i);
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col < dh) o[off + col] = __float2bfloat16(oacc[4 * n + 2 * i] * inv);
      if (col + 1 < dh) o[off + col + 1] = __float2bfloat16(oacc[4 * n + 2 * i + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 instance: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kThreads = 256;
constexpr int kQR = 64;               // query rows per block: 16 thread rows x 4
constexpr int kKT = 32;               // keys per tile: 16 thread columns x 2

// strides (in floats) of the shared tiles, padded against bank conflicts
__host__ __device__ __forceinline__ int q_stride(int dh) { return dh + 4; }
__host__ __device__ __forceinline__ int kv_stride(int dh) { return dh + 1; }
constexpr int kPStride = kKT + 1;

int smem_bytes(int dh) {
  return static_cast<int>(sizeof(float)) *
         (kQR * q_stride(dh) + 2 * kKT * kv_stride(dh) + kQR * kPStride);
}

}  // namespace f32

__global__ void __launch_bounds__(f32::kThreads)
flash_prefill_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                         int H, int Kv, int dh, int causal, float scale) {
  using namespace f32;
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
    q_s[r * QS + d] = (r0 + r < n_rows) ? q[row_offset(r) + d] : 0.f;
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
    m[i] = sm90::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDh / 16; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = 0; t0 < n_keys; t0 += kKT) {
    // ---- K and V tiles (rows of one kv head: stride Kv*dh) -------------------
    for (int i = tid; i < kKT * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh, t = t0 + r;
      float xk = 0.f, xv = 0.f;
      if (t < n_keys) {
        const size_t off = ((static_cast<size_t>(b) * Sk + t) * Kv + kv) * dh + d;
        xk = k[off];
        xv = v[off];
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
        s[i][j] = ok[j] ? s[i][j] * scale : sm90::kNegInf;
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

  // ---- o = acc / max(l, 1e-30) -----------------------------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] < 0) continue;
    const size_t base = row_offset(ty * 4 + i);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxDh / 16; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) o[base + d] = acc[i][c] * inv;
    }
  }
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Sk, int H, int Kv, int dh, int causal, cudaStream_t stream) {
  const int smem = tc::smem_bytes();
  cudaError_t err = sm90::opt_in_smem(flash_prefill_bf16_kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_row_tiles = (Sq * (H / Kv) + tc::kBM - 1) / tc::kBM;
  const long long blocks = static_cast<long long>(n_row_tiles) * Kv * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int vec =
      dh % 8 == 0 && sm90::aligned(q, 16) && sm90::aligned(k, 16) && sm90::aligned(v, 16);
  const float scale_log2 = static_cast<float>(sm90::kLog2e / sqrt(static_cast<double>(dh)));
  flash_prefill_bf16_kernel<<<static_cast<unsigned>(blocks), tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, H, Kv, dh,
      causal, scale_log2, vec, B, n_row_tiles);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Sk, int H, int Kv, int dh, int causal, cudaStream_t stream) {
  const int smem = f32::smem_bytes(dh);
  cudaError_t err = sm90::opt_in_smem(flash_prefill_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  const int G = H / Kv;
  const dim3 grid((Sq * G + f32::kQR - 1) / f32::kQR, Kv, B);
  flash_prefill_f32_kernel<<<grid, f32::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, H, Kv, dh, causal,
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
    case 0: return launch_f32(q, k, v, o, B, Sq, Sk, H, Kv, dh, causal, st);
    case 1: return launch_bf16(q, k, v, o, B, Sq, Sk, H, Kv, dh, causal, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
