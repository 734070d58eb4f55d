// Grouped-query decode attention for Hopper (sm_90a) over the stacked KV
// cache, bf16 in and out, f32 inside: one kernel launch per call, for a
// bf16 cache and for an int8 cache.
//
// Replaces the Pallas TPU kernel gofr_tpu/ops/decode_attention.py
// (gqa_decode_attention_tpu): _decode_kernel over the fp cache (:42) and
// _decode_kernel_quant over the int8 one (:147, int8 body :110-116, scale
// DMAs :68-87). One query token per batch row attends the first kv_len[b]
// positions of the padded cache at `layer`; each KV head's n_rep query heads
// contract against the un-expanded keys, with an online softmax in f32.
//   - bf16 cache: [L, B, S_max, KV, D];
//   - int8 cache: values FLAT [L, B, S_max, KV*D], bf16 scales seq-minor
//     [L, B, KV, S_max], one per (position, KV head). The scales fold in per
//     position: score_j = (q . k_j) * ks_j * D^-1/2 and acc += (p_j * vs_j)
//     * v_j, so no dequantized copy of the cache exists anywhere.
// kv_len is clamped to S_max (a row at capacity carries S_max + 1); a kv_len
// of 0 or less attends nothing valid: like the JAX code's finite -1e30 mask,
// every position is then masked and the row is uniform over S_max.
//
// The verify window of speculative decoding goes through the same kernel:
// q [B, W, H, D], and window position t of row b attends the first
// kv_len[b] + t positions, which is what gofr_tpu/models/llama.py's
// decode_window (:1504-1506) and paged_decode_window (:1404-1406) compute
// in plain XLA with attention(..., causal=True, q_offset=kv_len - 1). The
// JAX package has no kernel for it. The window's query rows (W * n_rep of
// a KV head) take the place of a decode token's n_rep rows in the same
// tiles, so a row's live prefix is still read once for all of them: a
// window fills the whole m16 tile (up to 16 rows) or two (up to 32), where
// a decode token keeps its rows 0..7 (W = 1 is the decode kernel as it
// was). The wrapper splits a wider window into launches of up to 32 rows.
//
// What bounds both kernels on the H100: bytes. Each live position is read
// once (K and V: KV*D*2 bytes each in bf16, KV*(D+2) in int8 with its
// scale) for ~4*n_rep*D FLOPs, far under the tensor-core ridge, so the floor
// is the live bytes over 3.35 TB/s: ~10 us for the int8 path's decode at
// 8 slots x 2000 positions, ~20 us for the bf16 cache at the same shape.
// The arithmetic has to stay well under that: on the CUDA cores (8 dims a
// lane, shuffles to reduce each dot product) it would take ~65 warp
// instructions a position and head.
//
// What the design does about it:
//   - many bytes in flight: a CTA stages 64-position tiles of K and V (and
//     keeps the int8 scales of all its tiles in shared memory) through a
//     three-stage ring of 16-byte cp.async copies; a tile's V is issued
//     with its K, and two tiles are in flight while the third is computed
//     (32 KB per CTA in int8, 64 KB in bf16). One barrier per tile;
//   - the products on the tensor cores: mma.sync m16n8k16 with the n_rep
//     query rows as rows 0..n_rep-1 of A (the rest zero), f32 accumulate.
//     Each warp owns 16 positions of a tile: S = q K^T is two 8-position
//     tiles whose accumulators are, packed, the A operand of P V. bf16 K is
//     read from the (padded) ring rows as it is, V through ldmatrix.trans;
//   - int8: codes become f16 exactly with one byte permute and one f16x2
//     subtract per pair (1024 + 128 + code - 1152). K's codes feed the B
//     fragment straight from the ring, each lane's 32-bit word holding the
//     4 dims of its k slots (q's fragment uses the same order of dims).
//     V's B fragments come from the codes too: a lane reads D/8 dims of 4
//     positions and byte-permutes pairs of positions into f16x2, so output
//     column n of tile dt is dim n*D/8 + dt. Rows are swizzled in 16-byte
//     chunks so both reads are free of bank conflicts at D = 128. q goes
//     to f16 divided by 16 (exact, |q| < 1e6); the K scale multiplies the
//     score, the V scale rides P;
//   - several tiles per CTA: each warp keeps its own running (max, sum,
//     acc) over its positions (an online softmax, as the TPU kernel's
//     fori_loop carries it), so the softmax needs no barrier; the four
//     warps merge once, at the end;
//   - one launch per call, merged by a thread-block cluster (no global
//     state). The grid is (KV head,
//     batch row, splits) with each row-head's splits one cluster along z
//     (n_splits planned by the wrapper for about two CTAs per SM). Split k
//     takes the tiles k, k + n_splits, ... of the live prefix, read on the
//     device from the clamped kv_len: every rank gets an even share of
//     any length, and only a row shorter than n_splits tiles leaves a rank
//     idle (it reads no cache). A row with one live split writes its
//     output directly. Otherwise each live CTA leaves its (max, sum, acc)
//     in its shared memory and every rank of the cluster merges a slice of
//     the outputs from the live ranks' memory (distributed shared memory),
//     with no partials in HBM and no counter to keep between calls;
//   - kv_len is read on the device: the host never syncs to size the work;
//   - exp2 with log2(e) folded into the score scale.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "cp_async.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using gofr::cp_async16;
using gofr::cp_commit;
using gofr::cp_wait;

constexpr int TILE = 64;                // positions per staged tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int WP = TILE / WARPS;        // positions of a tile per warp
constexpr int STAGES = 3;               // tiles in the ring
constexpr int MAX_SPAN = 8192;          // positions per CTA, at most
constexpr int MAX_SPLITS = 8;           // CTAs per row and head: one cluster
constexpr int MAX_ROWS = 32;            // query rows a launch: two m16 tiles
constexpr float NEG = -1e30f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool INT8>
struct Cache {  // bf16: rows padded by 8 elements (conflict-free fragments)
  using T = bf16;
  template <int D>
  static constexpr int row_bytes = (D + 8) * 2;
};
template <>
struct Cache<true> {  // int8: dense rows, 16-byte chunks swizzled by row
  using T = int8_t;
  template <int D>
  static constexpr int row_bytes = D;
};

// Where 16-byte chunk c of ring row r lies in the row. int8 rows are
// swizzled so that the 8 lanes of a phase touch 8 distinct bank groups,
// both when a K fragment reads chunks 2t, 2t+1 of rows g and when a V
// fragment reads chunk g of rows 2t, 2t+1, 2t+8, 2t+9 (D = 128; at D = 64
// the V reads keep a 2-way conflict).
template <bool INT8, int D>
__device__ __forceinline__ int chunk_at(int c, int r) {
  if constexpr (INT8 && D >= 128) return c ^ (r & 1) ^ (((r >> 1) & 3) << 1);
  if constexpr (INT8 && D >= 32) return c ^ (r & 1);
  return c;
}

// the same 4 int8 codes of two positions x and y -> four f16x2 pairs
// (x_i, y_i), exact (see codes_to_half2)
__device__ __forceinline__ void pair_codes_to_half2(uint32_t x, uint32_t y,
                                                    uint32_t* h) {
  const uint32_t u = x ^ 0x80808080u, v = y ^ 0x80808080u;
  const uint32_t lo = __byte_perm(u, v, 0x5140);  // x0 y0 x1 y1
  const uint32_t hi = __byte_perm(u, v, 0x7362);  // x2 y2 x3 y3
  const uint32_t in[4] = {__byte_perm(lo, 0x64646464u, 0x4140),
                          __byte_perm(lo, 0x64646464u, 0x4342),
                          __byte_perm(hi, 0x64646464u, 0x4140),
                          __byte_perm(hi, 0x64646464u, 0x4342)};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm("sub.f16x2 %0, %1, %2;" : "=r"(h[i]) : "r"(in[i]), "r"(0x64806480u));
}

// 4 int8 codes -> two f16x2 (codes 0,1 and 2,3), exact: a byte permute
// makes 1024 + 128 + code, one f16x2 subtract removes 1152
__device__ __forceinline__ void codes_to_half2(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  asm("sub.f16x2 %0, %1, %2;"
      : "=r"(lo) : "r"(__byte_perm(u, 0x64646464u, 0x4140)), "r"(0x64806480u));
  asm("sub.f16x2 %0, %1, %2;"
      : "=r"(hi) : "r"(__byte_perm(u, 0x64646464u, 0x4342)), "r"(0x64806480u));
}

// D[16x8] += A[16x16] B[16x8] with A's rows 8..15 zero and only the rows
// 0..7 of D kept (d0, d1): the n_rep query rows live in rows 0..7
template <bool F16>
__device__ __forceinline__ void mma_rows8(float& d0, float& d1, uint32_t a0,
                                          uint32_t a2, uint32_t b0, uint32_t b1) {
  float x2, x3;
  if constexpr (F16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%10,%10};\n"
        : "+f"(d0), "+f"(d1), "=f"(x2), "=f"(x3)
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%10,%10};\n"
        : "+f"(d0), "+f"(d1), "=f"(x2), "=f"(x3)
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f));
}

// four 8x8 b16 matrices, transposed on the way in (row-major V -> the
// column-major B operand of P V)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(gofr::smem_addr(p)));
}

template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (F16) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The merge of a row and KV head's splits, run by every CTA of its cluster
// (the splits, ranks 0 .. n_splits-1, of which 0 .. n_live-1 are live):
// after the cluster barrier each rank reads the live ranks' (max, sum) and
// accumulators [ROWS][D] from their shared memory (c_ml, c_acc, at the
// same offsets in every CTA) and writes its slice of the R x D outputs
// (a decode token's rows at ob + r * D; a window's query row r at ob +
// (r / NREP) * t_stride + (r % NREP) * D). The second barrier keeps every
// rank's memory alive until all have read it.
template <int D, int NREP, int ROWS, bool WIN>
__device__ __forceinline__ void cluster_merge(const float* c_acc,
                                             const float* c_ml, int n_live,
                                             int R, bf16* __restrict__ ob,
                                             int64_t t_stride) {
  namespace cg = cooperative_groups;
  __shared__ float s_ml[MAX_SPLITS][ROWS][2];
  __shared__ float s_w[MAX_SPLITS][ROWS];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  cluster.sync();
  for (int i = tid; i < n_live * R * 2; i += THREADS) {
    const int s = i / (R * 2);
    s_ml[s][(i / 2) % R][i % 2] =
        cluster.map_shared_rank(c_ml, s)[i % (R * 2)];
  }
  __syncthreads();
  if (tid < R) {
    float M = -INFINITY, den = 0.f;
    for (int s = 0; s < n_live; ++s) M = fmaxf(M, s_ml[s][tid][0]);
    for (int s = 0; s < n_live; ++s) {
      s_w[s][tid] = ex2(s_ml[s][tid][0] - M);
      den += s_w[s][tid] * s_ml[s][tid][1];
    }
    for (int s = 0; s < n_live; ++s) s_w[s][tid] /= fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const int ranks = cluster.num_blocks();
  const int per = (R * D + ranks - 1) / ranks;
  const int lo = (int)cluster.block_rank() * per;
  const int hi = min(lo + per, R * D);
  for (int i = lo + tid; i < hi; i += THREADS) {
    float v[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      v[s] = s < n_live ? cluster.map_shared_rank(c_acc, s)[i] : 0.f;
    float out = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < n_live) out = fmaf(s_w[s][i / D], v[s], out);
    if constexpr (WIN) {
      const int r = i / D;
      ob[(r / NREP) * t_stride + (r % NREP) * D + i % D] =
          __float2bfloat16(out);
    } else {
      ob[i] = __float2bfloat16(out);
    }
  }
  cluster.sync();
}

// D[16x8] += A[16x16] B[16x8], all four rows' accumulators kept: the
// verify window's query rows fill both halves of the m16 tile
template <bool F16>
__device__ __forceinline__ void mma16(float& d0, float& d1, float& d2,
                                      float& d3, uint32_t a0, uint32_t a1,
                                      uint32_t a2, uint32_t a3, uint32_t b0,
                                      uint32_t b1) {
  if constexpr (F16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two consecutive k slots of a query row's A fragment (null row: zero).
// bf16: dims kk*16 + 2t (+8 for the high half), as they are; int8: f16 of
// q / 16 at dims t*D/4 + 4kk (+2), the order in which one 32-bit word of
// codes feeds a B fragment
template <int D, bool INT8>
__device__ __forceinline__ uint32_t q_word(const bf16* qr, int kk, int t4,
                                           int hi) {
  if (qr == nullptr) return 0u;
  if constexpr (INT8) {
    const bf16* p = qr + t4 * (D / 4) + 4 * kk + 2 * hi;
    return pack2<true>(__bfloat162float(p[0]) * 0.0625f,
                       __bfloat162float(p[1]) * 0.0625f);
  } else {
    return *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 2 * t4 + 8 * hi);
  }
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): the f32
// accumulator holds row g at columns 2t, 2t+1 and row g + 8 at the same
// columns; A holds row g (and g + 8) at k = 2t, 2t+1 (a0, a1) and 2t+8,
// 2t+9 (a2, a3); B holds column g at the same k. A warp owns 16 positions
// of each tile: S = q K^T is two 8-position tiles, and their accumulators
// ARE the A operand of P V.
//
// Query rows. One launch takes the wn window positions w0 .. w0+wn-1 of
// q [B, W, H, D] (H = KV*NREP): query row r of a KV head is position
// t = w0 + r / NREP, head r % NREP, R = wn*NREP rows in all, and row r
// attends the first kv_len[b] + t positions (causal from kv_len[b] - 1,
// capped at S). MROWS is the row capacity: 8 is the decode token (W = 1,
// the decode kernel as it was: its n_rep rows in rows 0..7 of A, rows
// 8..15 zero, mma_rows8, one key count for every row); 16 fills the m16
// tile and 32 takes two, for a window (each row its own key count). A
// lane holds the rows g + 8h, h < MROWS / 8.
//
// grid (KV, B, n_splits) in clusters of (1, 1, n_splits), THREADS threads.
// kc/vc the stacked caches (see the note at the top); ks/vs the int8
// scales (null for bf16); o like q. qscale = D^-1/2 * log2(e).
template <int D, int NREP, bool INT8, int MROWS>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const bf16* __restrict__ q, const void* __restrict__ kc,
              const void* __restrict__ vc, const bf16* __restrict__ ks,
              const bf16* __restrict__ vs, const int* __restrict__ kv_len,
              bf16* __restrict__ o, int B, int S, int KV, int layer, int span,
              int W, int w0, int wn, float qscale) {
  using T = typename Cache<INT8>::T;
  constexpr int ROW = Cache<INT8>::template row_bytes<D>;  // ring row bytes
  constexpr int TILE_BYTES = TILE * ROW;
  constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte copies per row
  constexpr int KT = D / 16;                    // k-steps over the head dim
  constexpr int DT = D / 8;                     // P V output tiles of 8 dims
  constexpr int HR = MROWS / 8;                 // query rows a lane holds
  constexpr int MT = (HR + 1) / 2;              // m16 tiles
  constexpr bool WIN = MROWS > 8;               // a verify window
  constexpr int ROWS = WIN ? MROWS : NREP;      // merge state rows
  static_assert(WP == 16 && NREP <= MROWS && (MROWS == 8 || MROWS == 16 ||
                                               MROWS == 32),
                "a warp: 16 positions; 8, 16 or 32 query rows");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;  // [STAGES][K, V][TILE_BYTES]
  // int8: the scales of this CTA's positions, [K, V][span]
  float* s_scale = reinterpret_cast<float*>(smem + STAGES * 2 * TILE_BYTES);
  // 32 rows: the A fragments of q, [MT][KT][lane] (16 rows keep them in
  // registers)
  uint4* s_qa = reinterpret_cast<uint4*>(
      smem + STAGES * 2 * TILE_BYTES + (INT8 ? 2 * span * 4 : 0));
  __shared__ float s_m[WARPS][ROWS], s_l[WARPS][ROWS];

  // the splits of a row-head are one cluster along z; split k takes the
  // tiles k, k + n_splits, k + 2 n_splits, ... of the live prefix, so the
  // ranks share any length evenly and all of them have work
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int R = WIN ? wn * NREP : NREP;
  const int raw = kv_len[b];
  // the launch's first row sees raw + w0 keys, its last raw + w0 + wn - 1;
  // a row that sees none (raw + t <= 0) is masked over all S positions
  const bool live = raw + w0 > 0;
  const int n_keys = live ? min(raw + w0 + wn - 1, S) : S;
  const int n_key_tiles = (n_keys + TILE - 1) / TILE;
  const int n_live = min(n_splits, n_key_tiles);  // ranks with a tile
  // the CTA's part of the merge state, from the start of shared memory
  // once the loop is done
  float* s_acc = reinterpret_cast<float*>(smem);   // [WARPS][ROWS][D]
  float* c_acc = s_acc + WARPS * ROWS * D;         // [ROWS][D]
  float* c_ml = c_acc + ROWS * D;                  // [ROWS][2]
  const int H = KV * NREP;
  const int64_t t_stride = (int64_t)H * D;  // one window position
  const int64_t row0 = (((int64_t)b * W + w0) * H + kvh * NREP) * D;
  bf16* ob = o + row0;
  if (split >= n_live) {  // no live tile: only a share of the merge
    if (n_live > 1)
      cluster_merge<D, NREP, ROWS, WIN>(c_acc, c_ml, n_live, R, ob,
                                        t_stride);
    return;
  }
  const int n_tiles = (n_key_tiles - split + n_splits - 1) / n_splits;

  const int64_t row_stride = (int64_t)KV * D;  // elements, both layouts
  const int64_t base =
      ((int64_t)layer * B + b) * S * row_stride + (int64_t)kvh * D;
  const T* kb = static_cast<const T*>(kc) + base;
  const T* vb = static_cast<const T*>(vc) + base;

  // this CTA's tile t (positions (split + t*n_splits)*TILE ..) into ring
  // stage t % STAGES, K and V together; rows past n_keys are zero-filled
  auto issue = [&](int t) {
    unsigned char* dk = ring + (t % STAGES) * 2 * TILE_BYTES;
    unsigned char* dv = dk + TILE_BYTES;
    const int p0 = (split + t * n_splits) * TILE;
    for (int i = tid; i < TILE * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = p0 + r < n_keys;
      const int64_t off =
          ok ? (int64_t)(p0 + r) * row_stride + c * (16 / (int)sizeof(T)) : 0;
      const int dst = r * ROW + chunk_at<INT8, D>(c, r) * 16;
      cp_async16(dk + dst, kb + off, ok);
      cp_async16(dv + dst, vb + off, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_commit();
  }

  // while the first tiles load: the int8 scales of this CTA's tiles (zero
  // past n_keys, so a masked row weighs nothing) and the q fragments
  if constexpr (INT8) {
    const int64_t sb = (((int64_t)layer * B + b) * KV + kvh) * S;
    for (int j = tid; j < n_tiles * TILE; j += THREADS) {
      const int pos = (split + j / TILE * n_splits) * TILE + j % TILE;
      const bool ok = pos < n_keys;
      s_scale[j] = ok ? __bfloat162float(ks[sb + pos]) : 0.f;
      s_scale[span + j] = ok ? __bfloat162float(vs[sb + pos]) : 0.f;
    }
  }
  // query row r of this KV head (null past the launch's R rows)
  auto q_row = [&](int r) -> const bf16* {
    return r < R ? q + row0 + (r / NREP) * t_stride + (r % NREP) * D
                 : nullptr;
  };
  // this lane's rows g + 8h: the keys each sees and whether it sees any
  // (a decode token's rows all see n_keys)
  int nk[HR];
  bool lv[HR];
#pragma unroll
  for (int h = 0; h < HR; ++h) {
    const int r = g + 8 * h;
    const int seen = raw + w0 + r / NREP;
    lv[h] = WIN ? seen > 0 : live;
    nk[h] = !WIN ? n_keys : r < R ? (lv[h] ? min(seen, S) : S) : 0;
  }
  // A fragments of q: rows g (a0, a2) and g + 8 (a1, a3) of each m tile
  uint32_t qa[KT][HR == 1 ? 2 : 4];
  if constexpr (HR <= 2) {
    const bf16* qr0 = q_row(g);
    const bf16* qr1 = q_row(g + 8);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if constexpr (HR == 1) {
        qa[kk][0] = q_word<D, INT8>(qr0, kk, t4, 0);
        qa[kk][1] = q_word<D, INT8>(qr0, kk, t4, 1);
      } else {
        qa[kk][0] = q_word<D, INT8>(qr0, kk, t4, 0);
        qa[kk][1] = q_word<D, INT8>(qr1, kk, t4, 0);
        qa[kk][2] = q_word<D, INT8>(qr0, kk, t4, 1);
        qa[kk][3] = q_word<D, INT8>(qr1, kk, t4, 1);
      }
    }
  } else {
    for (int i = tid; i < MT * KT * 32; i += THREADS) {
      const int mt = i / (KT * 32), kk = (i / 32) % KT, ln = i % 32;
      const bf16* qr0 = q_row(16 * mt + ln / 4);
      const bf16* qr1 = q_row(16 * mt + ln / 4 + 8);
      s_qa[i] = make_uint4(q_word<D, INT8>(qr0, kk, ln % 4, 0),
                           q_word<D, INT8>(qr1, kk, ln % 4, 0),
                           q_word<D, INT8>(qr0, kk, ln % 4, 1),
                           q_word<D, INT8>(qr1, kk, ln % 4, 1));
    }
  }
  const float sscale = INT8 ? qscale * 16.f : qscale;

  // this lane's query rows g + 8h: running max, sum (its share) and acc
  // at dims dt*8 + 2t, +1
  float m[HR], l[HR], acc[HR][DT][2];
#pragma unroll
  for (int h = 0; h < HR; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) acc[h][dt][0] = acc[h][dt][1] = 0.f;
  }
  const int r0 = warp * WP;  // the warp's rows of a tile

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<STAGES - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();        // ... everyone's; and stage t-1 is free again
    if (t + STAGES - 1 < n_tiles) issue(t + STAGES - 1);
    cp_commit();
    const unsigned char* sk = ring + (t % STAGES) * 2 * TILE_BYTES;
    const unsigned char* sv = sk + TILE_BYTES;

    // S = q K^T over the warp's 16 positions (two tiles of 8). One m tile
    // of rows 0..7: even and odd k-steps in two accumulators, two short
    // mma chains instead of one long one; more rows: one chain an m tile
    float s[HR][2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int row = r0 + nt * 8 + g;
      // one k-step's B fragment of K, converted where it is used so that
      // no fragment array stays live across the mma chain
      uint32_t w[INT8 ? KT : 1];  // int8: this lane's D/4 codes of the row
      const unsigned char* kp = sk + row * ROW + 4 * t4;  // bf16
      if constexpr (INT8) {
        if constexpr (D >= 64) {
#pragma unroll
          for (int h = 0; h < KT / 4; ++h) {
            const int c = t4 * (KT / 4) + h;
            const uint4 x = *reinterpret_cast<const uint4*>(
                sk + row * ROW + chunk_at<INT8, D>(c, row) * 16);
            w[4 * h] = x.x;
            w[4 * h + 1] = x.y;
            w[4 * h + 2] = x.z;
            w[4 * h + 3] = x.w;
          }
        } else {
          w[0] = *reinterpret_cast<const uint32_t*>(sk + row * ROW + 4 * t4);
        }
      }
      auto kfrag = [&](int kk, uint32_t& b0, uint32_t& b1) {
        if constexpr (INT8) {
          codes_to_half2(w[kk], b0, b1);
        } else {
          b0 = *reinterpret_cast<const uint32_t*>(kp + kk * 32);
          b1 = *reinterpret_cast<const uint32_t*>(kp + kk * 32 + 16);
        }
      };
      if constexpr (HR == 1) {
        float s2[2][2] = {};
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t b0, b1;
          kfrag(kk, b0, b1);
          mma_rows8<INT8>(s2[kk & 1][0], s2[kk & 1][1], qa[kk][0], qa[kk][1],
                          b0, b1);
        }
        s[0][nt][0] = s2[0][0] + s2[1][0];
        s[0][nt][1] = s2[0][1] + s2[1][1];
      } else {
        float d[MT][4] = {};
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t b0, b1;
          kfrag(kk, b0, b1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint4 a;
            if constexpr (HR == 2)
              a = make_uint4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
            else
              a = s_qa[(mt * KT + kk) * 32 + lane];
            mma16<INT8>(d[mt][0], d[mt][1], d[mt][2], d[mt][3], a.x, a.y, a.z,
                        a.w, b0, b1);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          s[2 * mt][nt][0] = d[mt][0];
          s[2 * mt][nt][1] = d[mt][1];
          s[2 * mt + 1][nt][0] = d[mt][2];
          s[2 * mt + 1][nt][1] = d[mt][3];
        }
      }
    }

    // scale, mask, online softmax over each row's 16 positions (4 lanes)
    float pw[HR][2][2];
#pragma unroll
    for (int h = 0; h < HR; ++h) {
      float mx = m[h];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = t * TILE + r0 + nt * 8 + 2 * t4 + e;  // in this CTA
          const int pos =
              (split + t * n_splits) * TILE + r0 + nt * 8 + 2 * t4 + e;
          const float v = s[h][nt][e] * sscale * (INT8 ? s_scale[j] : 1.f);
          s[h][nt][e] = pos < nk[h] ? (lv[h] ? v : NEG) : -INFINITY;
          mx = fmaxf(mx, s[h][nt][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // mx = -inf: nothing valid yet, acc and l are still 0
      const float alpha = mx == -INFINITY ? 1.f : ex2(m[h] - mx);
      m[h] = mx;
      l[h] *= alpha;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[h][dt][0] *= alpha;
        acc[h][dt][1] *= alpha;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = t * TILE + r0 + nt * 8 + 2 * t4 + e;
          const float p = s[h][nt][e] == -INFINITY ? 0.f : ex2(s[h][nt][e] - m[h]);
          l[h] += p;
          pw[h][nt][e] = INT8 ? p * s_scale[span + j] : p;  // V scale rides P
        }
    }
    // P as the A operand: row g + 8h at k = 2t, 2t+1 (positions of the
    // first 8-tile) and 2t+8, 2t+9 (the second)
    uint32_t pa[HR][2];
#pragma unroll
    for (int h = 0; h < HR; ++h) {
      pa[h][0] = pack2<INT8>(pw[h][0][0], pw[h][0][1]);
      pa[h][1] = pack2<INT8>(pw[h][1][0], pw[h][1][1]);
    }
    // acc[rows] += P V for one 8-dim output tile from its B fragment
    auto pv = [&](int dt, uint32_t b0, uint32_t b1) {
      if constexpr (HR == 1) {
        mma_rows8<INT8>(acc[0][dt][0], acc[0][dt][1], pa[0][0], pa[0][1], b0,
                        b1);
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma16<INT8>(acc[2 * mt][dt][0], acc[2 * mt][dt][1],
                      acc[2 * mt + 1][dt][0], acc[2 * mt + 1][dt][1],
                      pa[2 * mt][0], pa[2 * mt + 1][0], pa[2 * mt][1],
                      pa[2 * mt + 1][1], b0, b1);
      }
    };

    // O += P V over the warp's 16 rows of V
    if constexpr (INT8) {
      // B fragments straight from the codes: lane (g, t) reads dims
      // g*D/8 .. of positions 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1), and output
      // tile dt's column n holds dim n*D/8 + dt
      constexpr int NW = D >= 32 ? D / 32 : 1;  // 32-bit words a position
      uint32_t x[4][NW];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = r0 + 2 * t4 + (k & 1) + (k >> 1) * 8;
        const unsigned char* rp = sv + row * ROW;
        if constexpr (D == 128) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              rp + chunk_at<INT8, D>(g, row) * 16);
          x[k][0] = v.x;
          x[k][1] = v.y;
          x[k][2] = v.z;
          x[k][3] = v.w;
        } else if constexpr (D == 64) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              rp + chunk_at<INT8, D>(g / 2, row) * 16 + (g & 1) * 8);
          x[k][0] = v.x;
          x[k][1] = v.y;
        } else {
          x[k][0] = *reinterpret_cast<const uint16_t*>(rp + g * 2);
        }
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint32_t b0[4], b1[4];
        pair_codes_to_half2(x[0][w], x[1][w], b0);
        pair_codes_to_half2(x[2][w], x[3][w], b1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * w + i < DT) pv(4 * w + i, b0[i], b1[i]);
      }
    } else {
      const unsigned char* vb0 = sv + r0 * ROW;
      const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vb0 + vrow * ROW + (dt * 8 + (lane >> 4) * 8) * 2);
        pv(dt, vf[0], vf[1]);
        pv(dt + 1, vf[2], vf[3]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the warps' merge

  // each row's sum over its 4 lanes; each lane keeps distinct dims of acc
#pragma unroll
  for (int h = 0; h < HR; ++h) {
    const int r = g + 8 * h;
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (r < R) {
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = INT8 ? (2 * t4 + e) * DT + dt : dt * 8 + 2 * t4 + e;
          s_acc[(warp * ROWS + r) * D + d] = acc[h][dt][e];
        }
      if (t4 == 0) {
        s_m[warp][r] = m[h];
        s_l[warp][r] = l[h];
      }
    }
  }
  __syncthreads();

  // this CTA's (max, sum, acc); a warp with no valid position weighs 0.
  // A row-head with one live split is done; otherwise the cluster merges
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, s_m[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = s_m[w][r] == -INFINITY ? 0.f : ex2(s_m[w][r] - M);
      L += wt * s_l[w][r];
      A += wt * s_acc[(w * ROWS + r) * D + i % D];
    }
    if (n_live == 1) {
      const float out = A / fmaxf(L, 1e-30f);
      if constexpr (WIN)
        ob[(r / NREP) * t_stride + (r % NREP) * D + i % D] =
            __float2bfloat16(out);
      else
        ob[i] = __float2bfloat16(out);
    } else {
      c_acc[i] = A;
      if (i % D == 0) {
        c_ml[2 * r] = M;
        c_ml[2 * r + 1] = L;
      }
    }
  }
  if (n_live > 1)
    cluster_merge<D, NREP, ROWS, WIN>(c_acc, c_ml, n_live, R, ob, t_stride);
}

struct Args {
  const void *q, *kc, *vc, *ks, *vs, *kv_len;  // ks/vs: int8 cache only
  void* o;
  int B, S, KV, layer, span, n_splits;
  int W, w0, wn;  // q's window positions; this launch's first and count
};

template <int D, int NREP, bool INT8, int MROWS>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t ring =
      (size_t)STAGES * 2 * TILE * Cache<INT8>::template row_bytes<D>;
  // int8: the scales of a CTA's positions; 32 rows: q's A fragments
  const size_t loop = ring + (INT8 ? 2 * (size_t)a.span * sizeof(float) : 0) +
                      (MROWS == 32 ? (size_t)2 * (D / 16) * 32 * 16 : 0);
  // after the loop: the warps' and the CTA's merge state
  constexpr int ROWS = MROWS > 8 ? MROWS : NREP;
  constexpr size_t merge =
      ((size_t)(WARPS + 1) * ROWS * D + ROWS * 2) * sizeof(float);
  const size_t smem = loop > merge ? loop : merge;
  auto kernel = decode_kernel<D, NREP, INT8, MROWS>;
  // dynamic and static shared memory together may pass the 48 KB default
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.KV, a.B, a.n_splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.n_splits;  // a row-head's splits
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float qscale = 1.4426950408889634f / sqrtf((float)D);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(a.q), a.kc, a.vc,
      static_cast<const bf16*>(a.ks), static_cast<const bf16*>(a.vs),
      static_cast<const int*>(a.kv_len), static_cast<bf16*>(a.o), a.B, a.S,
      a.KV, a.layer, a.span, a.W, a.w0, a.wn, qscale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the row capacity of a launch: 8 for one token a row (the decode kernel;
// a window of W = 1 too, so it is that launch), else 16 or 32 query rows
template <bool INT8, int D, int NREP>
int launch_rows(const Args& a, cudaStream_t s) {
  const int rows = a.wn * NREP;
  if (a.W == 1) return launch<D, NREP, INT8, 8>(a, s);
  if (rows <= 16) return launch<D, NREP, INT8, 16>(a, s);
  return launch<D, NREP, INT8, 32>(a, s);
}

template <bool INT8, int D>
int launch_d(int n_rep, const Args& a, cudaStream_t s) {
  switch (n_rep) {
    case 1: return launch_rows<INT8, D, 1>(a, s);
    case 2: return launch_rows<INT8, D, 2>(a, s);
    case 4: return launch_rows<INT8, D, 4>(a, s);
    case 8: return launch_rows<INT8, D, 8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool INT8>
int launch_any(int D, int n_rep, const Args& a, void* stream) {
  if (a.B <= 0 || a.S <= 0 || a.KV <= 0 || a.layer < 0 || a.span <= 0 ||
      a.span % TILE || a.span > MAX_SPAN || a.n_splits <= 0 ||
      a.n_splits > MAX_SPLITS ||
      a.span < ((a.S + TILE - 1) / TILE + a.n_splits - 1) / a.n_splits * TILE ||
      a.W <= 0 || a.w0 < 0 || a.wn <= 0 || a.w0 + a.wn > a.W ||
      a.wn * n_rep > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<INT8, 16>(n_rep, a, s);
    case 64: return launch_d<INT8, 64>(n_rep, a, s);
    case 128: return launch_d<INT8, 128>(n_rep, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Positions per staged tile, the most positions one CTA takes (its span,
// a multiple of the tile), the most splits a row and the most query rows
// (window positions x n_rep) one launch takes; the wrapper plans with them.
extern "C" int gofr_decode_tile_len() { return TILE; }
extern "C" int gofr_decode_max_span() { return MAX_SPAN; }
extern "C" int gofr_decode_max_splits() { return MAX_SPLITS; }
extern "C" int gofr_decode_max_rows() { return MAX_ROWS; }

// q [B, H, D] bf16 (H = KV * n_rep); k/v cache [L, B, S, KV, D] bf16;
// kv_len int32 [B]; o [B, H, D] bf16. n_splits: CTAs per row and KV head
// (one cluster), at most MAX_SPLITS; span: the most positions one of them
// takes, ceil(ceil(S / TILE) / n_splits) tiles or more. Returns a
// cudaError_t (0 on success).
extern "C" int gofr_gqa_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* kv_len,
    void* o, int B, int S, int KV, int n_rep, int D, int layer, int span,
    int n_splits, void* stream) {
  const Args a{q, k_cache, v_cache, nullptr, nullptr, kv_len, o,
               B, S, KV, layer, span, n_splits, 1, 0, 1};
  return launch_any<false>(D, n_rep, a, stream);
}

// The int8 cache: k/v values [L, B, S, KV*D] int8 (16-byte aligned), k/v
// scales [L, B, KV, S] bf16; everything else as above.
extern "C" int gofr_gqa_decode_attention_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* kv_len, void* o,
    int B, int S, int KV, int n_rep, int D, int layer, int span, int n_splits,
    void* stream) {
  const Args a{q, k_cache, v_cache, k_scale, v_scale, kv_len, o,
               B, S, KV, layer, span, n_splits, 1, 0, 1};
  return launch_any<true>(D, n_rep, a, stream);
}

// The verify window: q and o [B, W, H, D] bf16, and this launch takes the
// positions w0 .. w0+wn-1 (wn * n_rep <= MAX_ROWS); position t attends the
// first kv_len[b] + t positions of the cache. The bf16 cache as above.
extern "C" int gofr_gqa_decode_window(
    const void* q, const void* k_cache, const void* v_cache, const void* kv_len,
    void* o, int B, int S, int KV, int n_rep, int D, int layer, int span,
    int n_splits, int W, int w0, int wn, void* stream) {
  const Args a{q, k_cache, v_cache, nullptr, nullptr, kv_len, o,
               B, S, KV, layer, span, n_splits, W, w0, wn};
  return launch_any<false>(D, n_rep, a, stream);
}

// The verify window over the int8 cache.
extern "C" int gofr_gqa_decode_window_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* kv_len, void* o,
    int B, int S, int KV, int n_rep, int D, int layer, int span, int n_splits,
    int W, int w0, int wn, void* stream) {
  const Args a{q, k_cache, v_cache, k_scale, v_scale, kv_len, o,
               B, S, KV, layer, span, n_splits, W, w0, wn};
  return launch_any<true>(D, n_rep, a, stream);
}
