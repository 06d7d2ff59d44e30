// SWAN decode attention for Hopper (sm_90a), slab and paged.
//
// Replaces the TPU kernels `swan_decode_pallas` (slab) and
// `swan_decode_paged_pallas` (page pool), src/repro/kernels/swan_decode/
// swan_decode.py: one decode query group attends over [packed sparse prefix ||
// dense ring] with ONE online softmax, reading the compressed cache as it is
// stored (no dense [S, dh] tensor is ever formed, in device memory or in shared
// memory).
//
// What bounds it: device-memory bytes.  Per (sequence, kv head) it streams the
// sp_len valid packed rows (k values of 1-4 bytes + k int8 indices, per side,
// plus an f32 scale per row when int8) and the b x dh ring, and does ~4
// operations per byte read -- far below the card's ~295 operations/byte ridge.
// So it spends nothing on tensor cores and everything on keeping bytes in
// flight on every SM:
//
//   * split-S (flash-decoding).  The grid is (B*Kv, n_split + 1).  Prefix
//     split j < n_split (blockIdx.y = j + 1) owns logical rows [j*R, (j+1)*R)
//     (R = kSplitRows), with n_split = ceil(S / R) from the host-known extent S
//     (slab S, or Pg*ps for the pool).  A block reads sp_len on the device and
//     exits at once when its rows all lie past it, so the host reads nothing
//     and the launch stays graph-capturable.  Split n_split (blockIdx.y = 0,
//     first in the launch order) scores the ring beside the prefix.  Each
//     block leaves its partial (acc[dh][G], m[G], l[G]) in f32 in a workspace
//     the wrapper allocates.  At the serve shape 288 of the 544 blocks work,
//     all resident at once (3 blocks an SM);
//   * staged tiles.  A prefix split copies its packed vals / idx (/ int8
//     scale) rows for k and v into shared memory, kTile rows at a time, by
//     cp.async in a ring of two buffers (`sm90::stage_rows`: 16-, 4- or 1-byte
//     pieces by row size and alignment, through the slab or the page table),
//     so the next tile is in flight while this one is used.  The tiles are 32
//     rows, not 64: two 64-row buffers alone (49 KB at bf16, k=64) would push a
//     block past 48 KB and cut the blocks an SM holds;
//   * scoring.  q^ sits in shared memory as [dh][G] f32, so one 16-byte load
//     gathers column d for G = 4 queries.  Each warp owns 4 rows of a tile;
//     tpr threads share a row, each taking E entries (16 bytes of bf16 or f32
//     values, 8 of int8 or fp8) and their indices with one vector load each,
//     and the row's score is reduced over those tpr threads only;
//   * one online-softmax rescale per tile and warp, lane-distributed: lane
//     r*G + g holds row r's score for query g and the running (m, l) of g;
//   * accumulation.  The warp scatters its 4 value rows into a dense f32 row
//     buffer of its own (zero-fill, then scatter: the k indices of a packed
//     vector are distinct, so no two lanes write one element), then each lane
//     accumulates p . v for 4 columns x G queries in registers.  A 16-byte
//     read-modify-write per entry into a shared acc[dh][G] costs more
//     shared-memory wavefronts (random columns conflict in banks) and a
//     __syncwarp per row;
//   * fixed-order merges, no atomics.  A block merges its 8 warps in warp
//     order; `swan_decode_merge_kernel` (one block per (sequence, kv head) and
//     a thread per output, same stream) merges the active prefix splits in
//     split order and then the ring, normalises (denominator >= 1e-30, so an
//     all-empty row gives 0, never NaN) and writes o in q's dtype.  Atomics
//     would make the bits depend on timing; a last-block ticket would need a
//     zeroed counter that outlives the launch, shared by every stream that
//     launches it.  In this order two launches give identical bits and the
//     paged kernel equals the slab kernel.
//
// What holds it back now: the work per row -- random q^ gathers, the
// scatter, shuffles and barriers, with 8 warps a block and <= 3 blocks an SM
// -- and one tile in flight per block (PERF.md has the numbers).
//
// Slab and paged share one body: only the address of sparse row t differs
// (`sm90::sparse_row`).  Split boundaries are logical rows fixed by R alone, and
// the merge reads only the splits below sp_len, so a paged launch over
// Pg*ps != S rows equals the slab launch bit for bit on the same logical rows.
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
constexpr int kTile = 32;                       // packed rows per staged tile
constexpr int kRowsPerWarp = kTile / kWarps;    // rows of a tile each warp owns
constexpr int kStages = 2;                      // staging buffers in the ring
constexpr int kSplitRows = 256;                 // R: logical prefix rows per split

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int a16(int bytes) { return (bytes + 15) & ~15; }

__device__ __forceinline__ int pow2ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// An unsigned type of N bytes, for one vector load of N bytes.
template <int N> struct Bytes;
template <> struct Bytes<16> { using T = uint4; };
template <> struct Bytes<8> { using T = uint2; };
template <> struct Bytes<4> { using T = uint32_t; };

// G consecutive floats (16-byte aligned for G >= 4) in and out of shared memory.
template <int G>
__device__ __forceinline__ void ld_g(const float* p, float (&v)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int i = 0; i < G / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
    }
  } else if constexpr (G == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int G>
__device__ __forceinline__ void st_g(float* p, const float (&v)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int i = 0; i < G / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                    v[4 * i + 3]);
  } else if constexpr (G == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// Entries [j0, j0 + E) of a row of n values as f32 (0 past n): one vector load
// of E values when `vec` (n % E == 0, the row aligned to E values), else E
// scalar loads.
template <typename T, int E>
__device__ __forceinline__ void load_entries(const T* row, int j0, int n, bool vec,
                                             float (&x)[E]) {
  if (vec) {
    using V = typename Bytes<E * static_cast<int>(sizeof(T))>::T;
    const V raw = *reinterpret_cast<const V*>(row + j0);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = to_f32(v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = j0 + e < n ? to_f32(row[j0 + e]) : 0.f;
  }
}

// part[g] += sum over the packed entries [j0, j0 + E) of a row of k of
// vals[j] * q^[idx[j]][g]: the E values and their E indices in one vector
// load each when `vec` (k % E == 0), else scalar loads up to k.
template <typename VT, int E, int G>
__device__ __forceinline__ void score_entries(const VT* vals, const int8_t* idx, int j0, int k,
                                              int dh, bool vec, const float* q_s,
                                              float (&part)[G]) {
  auto add = [&](float x, int d) {
    float qv[G];
    ld_g<G>(q_s + d * G, qv);
#pragma unroll
    for (int g = 0; g < G; ++g) part[g] = fmaf(x, qv[g], part[g]);
  };
  if (vec) {
    using V = typename Bytes<E * static_cast<int>(sizeof(VT))>::T;
    const V rv = *reinterpret_cast<const V*>(vals + j0);
    const typename Bytes<E>::T ri = *reinterpret_cast<const typename Bytes<E>::T*>(idx + j0);
    const VT* xv = reinterpret_cast<const VT*>(&rv);
    const int8_t* iv = reinterpret_cast<const int8_t*>(&ri);
#pragma unroll
    for (int e = 0; e < E; ++e) add(to_f32(xv[e]), sm90::col(iv[e], dh));
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (j0 + e < k) add(to_f32(vals[j0 + e]), sm90::col(idx[j0 + e], dh));
  }
}

// One staging buffer of kTile rows: k vals | v vals | k idx | v idx | k scale | v scale.
struct Stage {
  int vals, idx, scale;
  __host__ __device__ Stage(int k, int vb) : vals(a16(kTile * k * vb)), idx(a16(kTile * k)),
                                             scale(kTile * 4) {}
  __host__ __device__ int bytes() const { return 2 * (vals + idx + scale); }
};

__host__ __device__ __forceinline__ int row_stride(int dh) { return (dh + 3) & ~3; }

// Byte offsets of the shared-memory regions of one block: q^ [dh][G] | the
// warps' dense row buffers [kWarps][kRowsPerWarp][row_stride] | m, l
// [kWarps][G] each | the warps' tile scores, then probabilities
// [kWarps][kRowsPerWarp][G] (later the merge weights) | one region used in
// turn: the staging ring of a prefix split or the ring split's scores [G][b],
// then the warps' accumulators [kWarps][dh][G] for the block's merge.
struct Smem {
  int q, rows, ml, sc, tail, bytes;
  __host__ __device__ Smem(int G, int dh, int b, int k, int vb) {
    q = 0;
    rows = q + a16(4 * G * dh);
    ml = rows + 4 * kWarps * kRowsPerWarp * row_stride(dh);
    sc = ml + a16(4 * 2 * kWarps * G);
    tail = sc + a16(4 * kWarps * kRowsPerWarp * G);
    const int staged = kStages * Stage(k, vb).bytes(), ring = a16(4 * G * b);
    const int acc = 4 * kWarps * G * dh;
    bytes = tail + max(max(staged, ring), acc);
  }
};

// floats of one split's partial: acc [dh][G], then m [G], then l [G]
__host__ __device__ __forceinline__ int partial_floats(int G, int dh) { return G * (dh + 2); }

__host__ __device__ __forceinline__ int n_splits(int S) {
  return (S + kSplitRows - 1) / kSplitRows;
}

// Arguments shared by the two halves of the decode kernel.
template <typename QT, typename VT>
struct Args {
  const VT* k_vals; const int8_t* k_idx; const VT* v_vals; const int8_t* v_idx;
  const float* k_scale; const float* v_scale; const QT* buf_k; const QT* buf_v;
  const int* buf_pos; const int* page_tab;
  int Kv, dh, S, k, b, ps, n_pages;
  float scale;
  int g_vals, g_idx;          // stage_rows copy widths of the vals and idx rows
  bool ring_vec;              // ring rows load as 16-byte vectors
};

// A prefix split: rows [row0, n_end) of (bi, kv), staged tile by tile; leaves
// each warp's (m, l) in m_s / l_s and its acc in acc_s (over the staging ring).
template <typename QT, typename VT, int G>
__device__ __forceinline__ void prefix_split(const Args<QT, VT>& a, int bi, int kv, int row0,
                                             int n_end, const float* q_s, float* rows_s,
                                             float* m_s, float* l_s, float* sc_s,
                                             unsigned char* tail) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = a.k, dh = a.dh;
  const Stage lay(k, static_cast<int>(sizeof(VT)));
  const bool scaled = a.k_scale != nullptr;
  const int n_tiles = (n_end - row0 + kTile - 1) / kTile;

  auto load_tile = [&](int j) {
    const int t0 = row0 + j * kTile, n = min(kTile, n_end - t0);
    unsigned char* sb = tail + (j % kStages) * lay.bytes();
    auto stage = [&](unsigned char* dst, const void* src, int row_bytes, int g) {
      sm90::stage_rows(dst, src, row_bytes, g, t0, n, a.page_tab, bi, kv, a.Kv, a.S, a.ps,
                       a.n_pages, kThreads);
    };
    const int vb = k * static_cast<int>(sizeof(VT));
    stage(sb, a.k_vals, vb, a.g_vals);
    stage(sb + lay.vals, a.v_vals, vb, a.g_vals);
    sb += 2 * lay.vals;
    stage(sb, a.k_idx, k, a.g_idx);
    stage(sb + lay.idx, a.v_idx, k, a.g_idx);
    if (scaled) {
      sb += 2 * lay.idx;
      stage(sb, a.k_scale, 4, 4);
      stage(sb + lay.scale, a.v_scale, 4, 4);
    }
    sm90::cp_async_commit();
  };
  load_tile(0);

  // score side: tpr threads per row, E entries each (16 bytes of f32 or bf16
  // values, 8 bytes of int8 or fp8 ones: 16 would cost registers)
  constexpr int E = sizeof(VT) >= 2 ? 16 / static_cast<int>(sizeof(VT)) : 8;
  const int tpr = min(32, pow2ceil((k + E - 1) / E));
  const int rpp = 32 / tpr;                              // rows per pass
  const int n_pass = max(1, kRowsPerWarp / rpp);
  const bool vec = k % E == 0;
  const int sub = lane % tpr, rr = lane / tpr, j0 = sub * E;

  float* sc_w = sc_s + warp * kRowsPerWarp * G;
  const int RS = row_stride(dh);
  float* vrow = rows_s + warp * kRowsPerWarp * RS;     // the warp's dense v rows
  // the value side's accumulators: lane owns columns [4 lane, 4 lane + 4)
  const int c0 = 4 * lane;
  float acc[4][G];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[e][g] = 0.f;
  // the warp's softmax state, lane-distributed: lane i < kPairs owns row
  // i / G and query g = i % G of the tile, and keeps (m, l) of that query
  constexpr int kPairs = kRowsPerWarp * G;               // a power of two <= 32
  const int my_r = lane / G, my_g = lane % G;
  float m = sm90::kNegInf, l = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    sm90::cp_async_wait_all();
    __syncthreads();            // tile j staged; every warp is done with tile j-1
    if (j + 1 < n_tiles) load_tile(j + 1);
    const int n = min(kTile, n_end - row0 - j * kTile);  // rows in this tile
    const unsigned char* sb = tail + (j % kStages) * lay.bytes();
    const VT* kv_s = reinterpret_cast<const VT*>(sb);
    const VT* vv_s = reinterpret_cast<const VT*>(sb + lay.vals);
    const int8_t* ki_s = reinterpret_cast<const int8_t*>(sb + 2 * lay.vals);
    const int8_t* vi_s = ki_s + lay.idx;
    const float* ksc = reinterpret_cast<const float*>(sb + 2 * (lay.vals + lay.idx));
    const float* vsc = ksc + kTile;
    const int w0 = warp * kRowsPerWarp;                  // the warp's first row

    // ---- scores of the warp's rows --------------------------------------------
    for (int p = 0; p < n_pass; ++p) {
      const int r = p * rpp + rr, lt = w0 + r;
      const bool live = r < kRowsPerWarp && lt < n;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (live && j0 < k)
        score_entries<VT, E, G>(kv_s + lt * k, ki_s + lt * k, j0, k, dh, vec, q_s, part);
      for (int o = tpr >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
      }
      if (live && sub == 0) {
        const float ks = (scaled ? ksc[lt] : 1.f) * a.scale;
#pragma unroll
        for (int g = 0; g < G; ++g) sc_w[r * G + g] = part[g] * ks;
      }
    }
    __syncwarp();

    // ---- one online-softmax rescale per tile ----------------------------------
    // (shuffles over the lanes of one query: lane ^ G, lane ^ 2G, ...)
    const bool ok = lane < kPairs && w0 + my_r < n;
    const float sc = ok ? sc_w[lane] : sm90::kNegInf;
    float mt = sc;
#pragma unroll
    for (int o = G; o < kPairs; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float m_new = fmaxf(m, mt);
    const float c = expf(m - m_new);
    const float pv = ok ? expf(sc - m_new) : 0.f;
    float psum = pv;
#pragma unroll
    for (int o = G; o < kPairs; o <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * c + psum;
    m = m_new;
    if (lane < kPairs) sc_w[lane] = pv;                  // the rows' p, [r][g]
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float cg = __shfl_sync(0xffffffffu, c, g);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e][g] *= cg;
    }

    // ---- values: the warp's rows expanded into its dense row buffer (zero-fill,
    // then scatter: the k indices of a row are distinct), then lanes over columns
    for (int i = lane; i < kRowsPerWarp * RS / 4; i += 32)
      reinterpret_cast<float4*>(vrow)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
    for (int r = 0; r < kRowsPerWarp && w0 + r < n; ++r) {
      const int lt = w0 + r;
      const float vs = scaled ? vsc[lt] : 1.f;
      for (int e = lane; e < k; e += 32)
        vrow[r * RS + sm90::col(vi_s[lt * k + e], dh)] = to_f32(vv_s[lt * k + e]) * vs;
    }
    __syncwarp();               // also: sc_w's probabilities are written
    if (c0 < dh) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (w0 + r >= n) break;
        float pr[G];
        ld_g<G>(sc_w + r * G, pr);
        const float4 x = *reinterpret_cast<const float4*>(vrow + r * RS + c0);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[0][g] = fmaf(pr[g], x.x, acc[0][g]);
          acc[1][g] = fmaf(pr[g], x.y, acc[1][g]);
          acc[2][g] = fmaf(pr[g], x.z, acc[2][g]);
          acc[3][g] = fmaf(pr[g], x.w, acc[3][g]);
        }
      }
    }
    __syncwarp();               // the next tile refills the row buffer
  }
  if (lane < G) { m_s[warp * G + lane] = m; l_s[warp * G + lane] = l; }
  __syncthreads();              // every warp is done with the staging ring
  float* acc_w = reinterpret_cast<float*>(tail) + warp * G * dh;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c0 + e < dh) st_g<G>(acc_w + (c0 + e) * G, acc[e]);
}

// The ring split: slots 0 <= buf_pos <= pos of (bi, kv), dense.  Leaves the
// same per-warp state as a prefix split: every warp's m is the ring's max,
// warp 0 carries the ring's l, each warp's acc (over pb_s) sums its own slots.
template <typename QT, typename VT, int G>
__device__ __forceinline__ void ring_split(const Args<QT, VT>& a, int bi, int bk, int my_pos,
                                           const float* q_s, float* m_s, float* l_s,
                                           float* pb_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dh = a.dh, b = a.b;
  constexpr int CE = 16 / static_cast<int>(sizeof(QT));   // entries per 16 bytes
  const int lpr = min(32, pow2ceil((dh + CE - 1) / CE));    // lanes per slot
  const int rpi = 32 / lpr;                                  // slots per warp step
  const int sub = lane % lpr, rr = lane / lpr, d0 = sub * CE;
  const size_t ring0 = static_cast<size_t>(bk) * b;
  const int* bpos = a.buf_pos + static_cast<size_t>(bi) * b;

  // ---- scores [G][b] ------------------------------------------------------------
#pragma unroll 4
  for (int t0 = warp * rpi; t0 < b; t0 += kWarps * rpi) {
    const int t = t0 + rr;
    float part[G];
#pragma unroll
    for (int g = 0; g < G; ++g) part[g] = 0.f;
    if (t < b && d0 < dh) {
      float x[CE];
      load_entries<QT, CE>(a.buf_k + (ring0 + t) * dh, d0, dh, a.ring_vec, x);
#pragma unroll
      for (int e = 0; e < CE; ++e) {
        if (d0 + e < dh) {
          float qv[G];
          ld_g<G>(q_s + (d0 + e) * G, qv);
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] = fmaf(x[e], qv[g], part[g]);
        }
      }
    }
    for (int o = lpr >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
    }
    if (t < b && sub == 0) {
      const int bp = bpos[t];
      const bool valid = bp >= 0 && bp <= my_pos;
#pragma unroll
      for (int g = 0; g < G; ++g) pb_s[g * b + t] = valid ? part[g] * a.scale : sm90::kNegInf;
    }
  }
  __syncthreads();

  // ---- softmax over the slots: warp g owns query g --------------------------------
  if (warp < G) {
    const int g = warp;
    float mx = sm90::kNegInf;
    for (int t = lane; t < b; t += 32) mx = fmaxf(mx, pb_s[g * b + t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float ls = 0.f;
    for (int t = lane; t < b; t += 32) {
      const int bp = bpos[t];
      const float p = (bp >= 0 && bp <= my_pos) ? expf(pb_s[g * b + t] - mx) : 0.f;
      pb_s[g * b + t] = p;
      ls += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
    if (lane == 0) {
      for (int w = 0; w < kWarps; ++w) {
        m_s[w * G + g] = mx;
        l_s[w * G + g] = w == 0 ? ls : 0.f;
      }
    }
  }
  __syncthreads();

  // ---- acc[d][g] = sum_t p[g][t] v[t][d]: the warp's slots, lanes over d ----------
  // (VE columns a lane, so that VE x G accumulators stay within 32 registers)
  constexpr int VE = CE < 32 / G ? CE : 32 / G;
  const int vpr = min(32, pow2ceil((dh + VE - 1) / VE));    // lanes per slot
  const int vsub = lane % vpr, vr = lane / vpr, c0 = vsub * VE;
  float acc[VE][G];
#pragma unroll
  for (int e = 0; e < VE; ++e)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[e][g] = 0.f;
#pragma unroll 4
  for (int t0 = warp * (32 / vpr); t0 < b; t0 += kWarps * (32 / vpr)) {
    const int t = t0 + vr;
    if (t < b && c0 < dh) {
      float x[VE], p[G];
      load_entries<QT, VE>(a.buf_v + (ring0 + t) * dh, c0, dh, a.ring_vec, x);
#pragma unroll
      for (int g = 0; g < G; ++g) p[g] = pb_s[g * b + t];
#pragma unroll
      for (int e = 0; e < VE; ++e)
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (p[g] != 0.f) acc[e][g] = fmaf(p[g], x[e], acc[e][g]);
    }
  }
  for (int o = vpr; o < 32; o <<= 1) {       // the warp's slot lanes, fixed order
#pragma unroll
    for (int e = 0; e < VE; ++e)
#pragma unroll
      for (int g = 0; g < G; ++g) acc[e][g] += __shfl_xor_sync(0xffffffffu, acc[e][g], o);
  }
  __syncthreads();              // every warp is done with pb_s: acc goes over it
  if (vr == 0) {
    float* acc_w = pb_s + warp * G * dh;
#pragma unroll
    for (int e = 0; e < VE; ++e)
      if (c0 + e < dh) st_g<G>(acc_w + (c0 + e) * G, acc[e]);
  }
}

// Blocks an SM must hold (the register budget): 3 (80 registers) for bf16 q
// and G <= 4, the serve path; 2 for f32 q; 1 for G = 8.  Tighter budgets
// spill.
template <typename QT, int G>
constexpr int kMinBlocks = G > 4 ? 1 : sizeof(QT) == 2 ? 3 : 2;

// QT: type of q, the ring and the output (float or bf16).
// VT: type of the packed values (QT, int8 with an f32 per-row scale, or fp8 e4m3).
// Block (bk = bi*Kv + kv, y): y = 0 is the ring split (split n_split, first
// in the launch order, so it runs beside the prefix), y = j + 1 prefix split
// j; writes its partial to ws[bk][split].
template <typename QT, typename VT, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks<QT, G>)
swan_decode_kernel(Args<QT, VT> a, const QT* __restrict__ q, const int* __restrict__ pos,
                   const int* __restrict__ sp_len, float* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dh = a.dh;
  const Smem L(G, dh, a.b, a.k, static_cast<int>(sizeof(VT)));
  float* q_s = reinterpret_cast<float*>(smem_raw + L.q);       // [dh][G]
  float* rows_s = reinterpret_cast<float*>(smem_raw + L.rows);
  float* acc_s = reinterpret_cast<float*>(smem_raw + L.tail);  // [kWarps][dh][G], last
  float* m_s = reinterpret_cast<float*>(smem_raw + L.ml);      // [kWarps][G]
  float* l_s = m_s + kWarps * G;                               // [kWarps][G]
  float* sc_s = reinterpret_cast<float*>(smem_raw + L.sc);
  unsigned char* tail = smem_raw + L.tail;

  const int bk = blockIdx.x, bi = bk / a.Kv, kv = bk % a.Kv;
  const int n_split = gridDim.y - 1;
  const int split = blockIdx.y == 0 ? n_split : blockIdx.y - 1;
  const int n_sp = min(max(sp_len[bi], 0), a.S);
  const int row0 = split * kSplitRows;
  if (split < n_split && row0 >= n_sp) return;   // empty: the merge never reads it

  for (int i = threadIdx.x; i < G * dh; i += kThreads) {
    const int g = i / dh, d = i - g * dh;
    q_s[d * G + g] = to_f32(q[static_cast<size_t>(bk) * G * dh + i]);
  }

  if (split < n_split) {
    prefix_split<QT, VT, G>(a, bi, kv, row0, min(n_sp, row0 + kSplitRows), q_s, rows_s,
                            m_s, l_s, sc_s, tail);
  } else {
    __syncthreads();
    ring_split<QT, VT, G>(a, bi, bk, pos[bi], q_s, m_s, l_s, reinterpret_cast<float*>(tail));
  }
  __syncthreads();

  // ---- merge the warps in warp order into this split's partial ------------------
  float* part = ws + (static_cast<size_t>(bk) * (n_split + 1) + split) * partial_floats(G, dh);
  float* wgt = sc_s;                                            // [kWarps][G]
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = sm90::kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + g]);
    float ls = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w * G + g] - mx);
      wgt[w * G + g] = c;
      ls += l_s[w * G + g] * c;
    }
    part[G * dh + g] = mx;
    part[G * dh + G + g] = ls;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * dh; i += kThreads) {
    const int g = i % G;
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += acc_s[w * G * dh + i] * wgt[w * G + g];
    part[i] = o;
  }
}

// One block per (sequence, kv head), a thread per output (G*dh <= 1024): the
// active prefix splits (those below sp_len) in split order, then the ring
// split; o = sum_j acc_j e^(m_j - M) / max(sum_j l_j e^(m_j - M), 1e-30),
// written in q's dtype.
template <typename QT>
__global__ void __launch_bounds__(1024)
swan_decode_merge_kernel(const float* __restrict__ ws, const int* __restrict__ sp_len,
                         QT* __restrict__ out, int Kv, int G, int dh, int S) {
  extern __shared__ float w_s[];       // [n_split + 1][G] m, then weights; [G] 1/den
  const int bk = blockIdx.x, bi = bk / Kv;
  const int n_split = n_splits(S);
  const int n_act = (min(max(sp_len[bi], 0), S) + kSplitRows - 1) / kSplitRows;
  const int P = partial_floats(G, dh);
  const float* part = ws + static_cast<size_t>(bk) * (n_split + 1) * P;
  float* l_s = w_s + (n_split + 1) * G;
  float* den_s = l_s + (n_split + 1) * G;
  auto at = [&](int j) {               // the j-th partial in merge order
    return part + static_cast<size_t>(j < n_act ? j : n_split) * P;
  };

  for (int i = threadIdx.x; i < (n_act + 1) * G; i += blockDim.x) {
    const int j = i / G, g = i - j * G;
    w_s[i] = at(j)[G * dh + g];
    l_s[i] = at(j)[G * dh + G + g];
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = sm90::kNegInf;
    for (int j = 0; j <= n_act; ++j) mx = fmaxf(mx, w_s[j * G + g]);
    float ls = 0.f;
    for (int j = 0; j <= n_act; ++j) {
      const float c = expf(w_s[j * G + g] - mx);
      w_s[j * G + g] = c;
      ls += l_s[j * G + g] * c;
    }
    den_s[g] = fmaxf(ls, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * dh; i += blockDim.x) {
    const int g = i % G, d = i / G;
    float o = 0.f;
#pragma unroll 4
    for (int j = 0; j <= n_act; ++j) o += at(j)[i] * w_s[j * G + g];
    out[static_cast<size_t>(bk) * G * dh + g * dh + d] = from_f32<QT>(o / den_s[g]);
  }
}

size_t workspace_bytes(int B, int Kv, int G, int dh, int S) {
  return sizeof(float) * static_cast<size_t>(B) * Kv * (n_splits(S) + 1) *
         partial_floats(G, dh);
}

template <typename QT, typename VT, int G>
cudaError_t launch(const void* q, const void* k_vals, const void* k_idx, const void* v_vals,
                   const void* v_idx, const void* k_scale, const void* v_scale,
                   const void* buf_k, const void* buf_v, const void* buf_pos,
                   const void* pos, const void* sp_len, const void* page_tab, void* out,
                   void* ws, long long ws_bytes, int B, int Kv, int dh, int S, int k, int b,
                   int ps, int n_pages, cudaStream_t stream) {
  const int n_split = n_splits(S);
  if (n_split + 1 > 65535 || ws == nullptr ||
      ws_bytes < static_cast<long long>(workspace_bytes(B, Kv, G, dh, S)))
    return cudaErrorInvalidValue;
  const int vb = static_cast<int>(sizeof(VT));
  const int smem = Smem(G, dh, b, k, vb).bytes;
  auto kern = swan_decode_kernel<QT, VT, G>;
  cudaError_t err = sm90::opt_in_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int merge_smem = static_cast<int>(sizeof(float)) * (2 * n_split + 3) * G;
  auto merge = swan_decode_merge_kernel<QT>;
  err = sm90::opt_in_smem(merge, merge_smem);
  if (err != cudaSuccess) return err;

  Args<QT, VT> a;
  a.k_vals = static_cast<const VT*>(k_vals);
  a.k_idx = static_cast<const int8_t*>(k_idx);
  a.v_vals = static_cast<const VT*>(v_vals);
  a.v_idx = static_cast<const int8_t*>(v_idx);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.buf_k = static_cast<const QT*>(buf_k);
  a.buf_v = static_cast<const QT*>(buf_v);
  a.buf_pos = static_cast<const int*>(buf_pos);
  a.page_tab = static_cast<const int*>(page_tab);
  a.Kv = Kv; a.dh = dh; a.S = S; a.k = k; a.b = b; a.ps = ps; a.n_pages = n_pages;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  a.g_vals = sm90::copy_width(k_vals, v_vals, k * vb);
  a.g_idx = sm90::copy_width(k_idx, v_idx, k);
  a.ring_vec = dh % (16 / static_cast<int>(sizeof(QT))) == 0 && sm90::aligned(buf_k, 16) &&
               sm90::aligned(buf_v, 16);

  kern<<<dim3(B * Kv, n_split + 1), kThreads, smem, stream>>>(
      a, static_cast<const QT*>(q), static_cast<const int*>(pos),
      static_cast<const int*>(sp_len), static_cast<float*>(ws));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge<<<B * Kv, G * dh, merge_smem, stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(sp_len), static_cast<QT*>(out), Kv,
      G, dh, S);
  return cudaGetLastError();
}

template <typename QT, typename VT>
cudaError_t launch_g(int G, const void* q, const void* kv, const void* ki, const void* vv,
                     const void* vi, const void* ks, const void* vs, const void* bk,
                     const void* bv, const void* bp, const void* pos, const void* sp,
                     const void* tab, void* out, void* ws, long long wsb, int B, int Kv,
                     int dh, int S, int k, int b, int ps, int np, cudaStream_t st) {
#define SWAN_G_ARGS q, kv, ki, vv, vi, ks, vs, bk, bv, bp, pos, sp, tab, out, ws, wsb, B, Kv, \
                    dh, S, k, b, ps, np, st
  // Any other G is served by the wrapper (swan_decode.py:g_plan): zero query
  // rows pad it to the next instance, and G > 8 is cut into groups of <= 8.
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
// S is the shipped table width times ps.  workspace: ws_bytes of device
// memory for the splits' f32 partials, at least
// 4 * B * Kv * (ceil(S / 256) + 1) * G * (dh + 2) (else the launch is refused).
extern "C" int swan_decode_launch(int q_type, int v_type, const void* q, const void* k_vals,
                                  const void* k_idx, const void* v_vals, const void* v_idx,
                                  const void* k_scale, const void* v_scale, const void* buf_k,
                                  const void* buf_v, const void* buf_pos, const void* pos,
                                  const void* sp_len, const void* page_tab, void* out,
                                  void* workspace, long long ws_bytes, int B, int Kv, int G,
                                  int dh, int S, int k, int b, int ps, int n_pages,
                                  void* stream) {
  if (k < 1 || k > dh || dh > 128 || b < 1 || B < 1 || Kv < 1 || S < 0)
    return cudaErrorInvalidValue;
  if (page_tab != nullptr && (ps < 1 || n_pages < 1 || S % ps != 0)) return cudaErrorInvalidValue;
  const bool quant = v_type == 2;
  if (quant != (k_scale != nullptr && v_scale != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWAN_ARGS q, k_vals, k_idx, v_vals, v_idx, k_scale, v_scale, buf_k, buf_v, buf_pos, \
                  pos, sp_len, page_tab, out, workspace, ws_bytes, B, Kv, dh, S, k, b, ps, \
                  n_pages, st
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
