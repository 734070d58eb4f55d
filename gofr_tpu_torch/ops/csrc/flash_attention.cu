// Flash prefill attention for Hopper (sm_90a), bf16 in and out, f32 inside.
//
// Replaces the Pallas TPU kernel gofr_tpu/ops/flash_attention.py
// (flash_attention_tpu -> _attn_kernel): causal or full softmax attention
// with scale D^-0.5, a static q_offset and an optional per-row kv_len mask,
// computed with an online softmax so the [Tq, Tk] logits never reach
// device memory.
//
// What bounds it on the H100. Per (query, key) pair the causal and kv_len
// masks keep, it does 4 * D FLOPs on the tensor cores; the bytes it must
// move are q, o and the live K/V once. At the serving paths' shapes (H = 32,
// KV = 8, D = 128): the 512-token wave of 2 is bounded by bytes (6 us) and,
// being 256 work items of at most 4 K/V tiles, by latency; one 2048-token
// prompt and the burst of 8 prompts into the 2048 bucket are bounded by
// operations (34 and 168 GFLOP: 0.035 and 0.17 ms at 989 TFLOP/s). Each
// 128-row item reads its whole live K/V prefix, so the L2 serves every K/V
// byte once per item: that stream, not HBM, is what the 2048 shapes press
// on besides the tensor cores.
// What the design does about it:
//   - persistent: one CTA an SM walks work items (128 query rows of one
//     head of one batch row), heads fastest (a KV head's n_rep heads run
//     side by side and meet in the L2 on its K/V), then batch rows, then
//     query tiles from the last (the longest causal chain) to the first;
//   - warp-specialised: one producer warpgroup gives its registers away
//     (setmaxnreg.dec to 40) and two consumer warpgroups of 64 query rows
//     take them (setmaxnreg.inc to 232); the roles split in one if/else
//     that never reconverges;
//   - one elected producer thread moves every tile by TMA
//     (cp.async.bulk.tensor; 4-D maps over [B, T, heads, D] encoded on the
//     host, so rows past T are zero-filled at each batch row's own edge):
//     Q into one of two buffers (the next item's Q lands while this one's
//     is read), K/V tiles of 128 keys through a ring (2 stages at D = 128,
//     4 below) with full and empty mbarriers, K and V apart (K is released
//     once S is computed, V once P V is). Tiles land swizzled as wgmma
//     reads them: 128-byte swizzle in column blocks of 64 (two at D = 128),
//     32-byte at D = 16;
//   - S = Q K^T on wgmma m64n128k16, Q and K from shared memory, both
//     K-major; the online softmax runs on S in registers (max on the raw
//     logits, exp2 with D^-0.5 * log2(e) folded into one FMA); P is packed
//     to bf16 in registers, where S's accumulator layout is already the
//     A-operand layout of O += P V (wgmma m64nDk16, V from shared memory as
//     an MN-major B through the transpose bit). S of tile t and P V of tile
//     t - 1 are issued together, so the softmax of t runs while P V of
//     t - 1 and the other warpgroup's products use the tensor cores. O is
//     divided by l once and written once, rows past Tq masked;
//   - K/V are read GROUPED ([B, Tk, KV, D], kv head h / n_rep): no
//     repeat_kv copy exists;
//   - causal work: tiles past the diagonal (q_offset included) and past
//     kv_len[b] are never loaded; only boundary tiles are masked;
//   - no shape has to divide a tile: TMA zero-fills the ragged edges and
//     the kernel masks them. An item with no K/V tile to read (kv_len <= 0)
//     loads nothing and writes zeros, as the TPU kernel's empty loop does.
// Masked logits are the finite -2^100 (about -1.3e30, standing in for the
// JAX code's -1e30 and exact under the exp2 scale), so a fully masked row
// is uniform rather than NaN.

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace gofr::sm90;

constexpr int BQ = 128;        // query rows per work item: two warpgroups of 64
constexpr int BK = 128;        // keys per K/V tile
constexpr int THREADS = 384;   // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMER_WARPS = 8;
// the CTA keeps the 168 registers a thread it was launched with (65536 /
// 384, rounded down to 8): what the consumers take, the producer gives
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 3 * 168 - 2 * CONSUMER_REGS;
constexpr float NEG = -0x1p100f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  // a row of a tile in one column block: the swizzle width (128 bytes = 64
  // columns; the whole 32-byte row at D = 16)
  static constexpr int ROWB = D * 2 < 128 ? D * 2 : 128;
  static constexpr int BOXC = ROWB / 2;      // columns of one TMA box
  static constexpr int NCB = D * 2 / ROWB;   // column blocks of a row
  static constexpr int KPB = ROWB / 32;      // k-steps of 16 in a block
  // Q buffers (consecutive work items alternate) and K/V tiles in the
  // ring: as many as fit the 227 KB (192 KB at D = 128)
  static constexpr int QBUF = 2;
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;  // one K or one V tile
  // [Q0][Q1][K0][V0][K1][V1].. then the barriers: Q landed and Q free (a
  // Q buffer each), full_k, full_v, empty_k, empty_v (a stage each)
  __host__ __device__ static constexpr uint32_t k(int s) {
    return QBUF * Q_BYTES + 2u * s * KV_BYTES;
  }
  __host__ __device__ static constexpr uint32_t v(int s) {
    return k(s) + KV_BYTES;
  }
  static constexpr uint32_t bars = QBUF * Q_BYTES + 2u * STAGES * KV_BYTES;
  static constexpr uint32_t n_bars = 2 * QBUF + 4 * STAGES;
  // + 1024 so the base can be rounded up to the swizzle atoms' alignment
  static constexpr size_t total = bars + 8 * n_bars + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One work item: a 128-row query tile of one head of one batch row, and the
// K/V tiles it reads. Items are numbered heads fastest (a KV head's n_rep
// heads adjacent, so their K/V reads meet in the L2), then batch rows, then
// query tiles from the last (the longest causal chain) to the first.
struct Work {
  int b, h, q0, kvl, n_tiles;
};

__device__ __forceinline__ Work work_item(int w, const int* kv_len, int B,
                                          int Tq, int Tk, int H, int causal,
                                          int q_offset) {
  Work it;
  const int n_qt = (Tq + BQ - 1) / BQ;
  it.h = w % H;
  w /= H;
  it.b = w % B;
  it.q0 = (n_qt - 1 - w / B) * BQ;
  it.kvl = kv_len ? min(kv_len[it.b], Tk) : Tk;
  int k_end = it.kvl;
  if (causal) k_end = min(k_end, min(it.q0 + BQ, Tq) + q_offset);  // last q pos + 1
  it.n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  return it;
}

// Persistent: gridDim.x CTAs (one an SM) walk the work items blockIdx.x,
// blockIdx.x + gridDim.x, ...; the producer loads the next item's Q and
// K/V while the consumers finish the current one.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const int* __restrict__ kv_len, bf16* __restrict__ o, int B,
                 int Tq, int Tk, int H, int KV, int causal, int q_offset,
                 float scale_log2) {
  using L = Layout<D>;
  constexpr int STAGES = L::STAGES, QBUF = L::QBUF;
  extern __shared__ unsigned char smem_raw[];
  // every tile block starts at a multiple of 1024 bytes from here
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::bars;
  auto q_full = [&](int qb) { return bars + 8u * qb; };
  auto q_free = [&](int qb) { return bars + 8u * (QBUF + qb); };
  // K and V arrive and are released apart: K of a tile is free once S is
  // computed, V once P V is
  auto full_k = [&](int s) { return bars + 8u * (2 * QBUF + s); };
  auto full_v = [&](int s) { return bars + 8u * (2 * QBUF + STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8u * (2 * QBUF + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8u * (2 * QBUF + 3 * STAGES + s); };
  const int n_work = ((Tq + BQ - 1) / BQ) * B * H;
  auto item = [&](int w) {
    return work_item(w, kv_len, B, Tq, Tk, H, causal, q_offset);
  };

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < QBUF; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_free(qb), CONSUMER_WARPS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), CONSUMER_WARPS);
      mbar_init(empty_v(s), CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load -------------------------
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&tm_q);
      tma_prefetch_desc(&tm_k);
      tma_prefetch_desc(&tm_v);
      int qi = 0, kt = 0;  // Q loads and K/V tiles issued so far
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const Work it = item(w);
        if (it.n_tiles == 0) continue;
        const int qb = qi % QBUF;
        if (qi >= QBUF) mbar_wait(q_free(qb), ((qi / QBUF) & 1) ^ 1);
        ++qi;
        mbar_arrive_expect_tx(q_full(qb), L::Q_BYTES);
#pragma unroll
        for (int cb = 0; cb < L::NCB; ++cb)
          tma_load_4d(base + qb * L::Q_BYTES + cb * BQ * L::ROWB, &tm_q,
                      q_full(qb), cb * L::BOXC, it.h, it.q0, it.b);
        const int kvh = it.h / (H / KV);
        for (int t = 0; t < it.n_tiles; ++t, ++kt) {
          const int s = kt % STAGES;
          const uint32_t free_par = ((kt / STAGES) & 1) ^ 1;
          if (kt >= STAGES) mbar_wait(empty_k(s), free_par);
          mbar_arrive_expect_tx(full_k(s), L::KV_BYTES);
#pragma unroll
          for (int cb = 0; cb < L::NCB; ++cb)
            tma_load_4d(base + L::k(s) + cb * BK * L::ROWB, &tm_k, full_k(s),
                        cb * L::BOXC, kvh, t * BK, it.b);
          if (kt >= STAGES) mbar_wait(empty_v(s), free_par);
          mbar_arrive_expect_tx(full_v(s), L::KV_BYTES);
#pragma unroll
          for (int cb = 0; cb < L::NCB; ++cb)
            tma_load_4d(base + L::v(s) + cb * BK * L::ROWB, &tm_v, full_v(s),
                        cb * L::BOXC, kvh, t * BK, it.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup -------------------------
    regs_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;

    // wgmma descriptors. Q (A) and K (B) are K-major, V (B) is MN-major
    // (its next column block LBO away); all share the upper half (the
    // 8-row stride and the swizzle), so a descriptor is its lower half,
    // rebuilt beside each wgmma from an opaque base so that the compiler
    // does not hoist the 8 Q descriptors out of the loop into registers.
    const uint32_t hi =
        (uint32_t)(make_desc(base, 16, 8 * L::ROWB, L::ROWB) >> 32);
    const uint32_t q_lo = (uint32_t)make_desc(base + wg * 64 * L::ROWB, 16,
                                              8 * L::ROWB, L::ROWB);
    const uint32_t k_lo = (uint32_t)make_desc(base + L::k(0), 16, 8 * L::ROWB,
                                              L::ROWB);
    const uint32_t v_lo = (uint32_t)make_desc(base + L::v(0), BK * L::ROWB,
                                              8 * L::ROWB, L::ROWB);
    constexpr uint32_t STAGE_STEP = (2 * L::KV_BYTES) >> 4;  // desc units
    auto desc = [&](uint32_t lo, uint32_t off_bytes) {
      return ((uint64_t)hi << 32) | (lo + (off_bytes >> 4));
    };

    float acc[D / 2];
    float sc[BK / 2];   // S of the newest tile, then its probabilities
    uint32_t p[BK / 4]; // P of the previous tile, bf16, A operand of P V

    // S[64 x BK] = Q K^T of the tile in stage s, Q in buffer qb
    auto issue_s = [&](int qb, int s) {
      const uint32_t q = opaque(q_lo) + qb * (L::Q_BYTES >> 4);
      const uint32_t k = k_lo + s * STAGE_STEP;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc,
                 desc(q, (kk / L::KPB) * BQ * L::ROWB + (kk % L::KPB) * 32),
                 desc(k, (kk / L::KPB) * BK * L::ROWB + (kk % L::KPB) * 32),
                 kk > 0);
    };
    // O[64 x D] += P[64 x BK] V[BK x D] of the tile in stage s
    auto issue_pv = [&](int s) {
      const uint32_t v = v_lo + s * STAGE_STEP;
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs(acc, &p[4 * j], desc(v, j * 16 * L::ROWB), 1);
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto par = [&](int kt) { return (uint32_t)((kt / STAGES) & 1); };

    int qi = 0, kt0 = 0;  // Q loads and K/V tiles consumed so far
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const Work it = item(w);
      const int n_tiles = it.n_tiles, kvl = it.kvl;
      const int row0 = it.q0 + wg * 64;        // this warpgroup's first row
      const int r = row0 + warp * 16 + g;      // this thread's rows r, r + 8
      const int qpos0 = r + q_offset, qpos1 = qpos0 + 8;
      const int wg_first = row0 + q_offset;
      const int wg_last = min(row0 + 64, Tq) - 1 + q_offset;
      // the tiles this warpgroup computes, a prefix of the item's: none for
      // rows past Tq; under causal, none past this warpgroup's last row
      int n_mine = row0 < Tq ? n_tiles : 0;
      if (causal && n_mine > 0)
        n_mine = min(n_mine, wg_last >= 0 ? wg_last / BK + 1 : 0);

#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
      // online softmax of tile t in sc: mask (boundary tiles only), new row
      // max, the probabilities in place and their sums; acc and l are
      // rescaled later, once the P V that reads the old acc is done
      float alpha0, alpha1, sum0, sum1;
      auto softmax = [&](int t) {
        const int k0 = t * BK;
        if (k0 + BK > kvl || (causal && k0 + BK - 1 > wg_first)) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int kpos = k0 + (i / 4) * 8 + 2 * c + (i & 1);
            const int qpos = (i & 2) ? qpos1 : qpos0;
            if (kpos >= kvl || (causal && kpos > qpos)) sc[i] = NEG;
          }
        }
        // a row is spread over the 4 lanes of a quad
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          if (i & 2) mx1 = fmaxf(mx1, sc[i]);
          else mx0 = fmaxf(mx0, sc[i]);
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        alpha0 = ex2((m0 - mx0) * scale_log2);
        alpha1 = ex2((m1 - mx1) * scale_log2);
        m0 = mx0;
        m1 = mx1;
        const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
        sum0 = 0.f;
        sum1 = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          sc[i] = ex2(fmaf(sc[i], scale_log2, (i & 2) ? -mb1 : -mb0));
          if (i & 2) sum1 += sc[i];
          else sum0 += sc[i];
        }
      };
      auto rescale_and_pack = [&]() {
        l0 = l0 * alpha0 + sum0;
        l1 = l1 * alpha1 + sum1;
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;
#pragma unroll
        for (int i = 0; i < BK / 4; ++i)
          p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
      };

      const int qb = qi % QBUF;
      if (n_tiles > 0) {
        mbar_wait(q_full(qb), (qi / QBUF) & 1);
        __syncwarp();
      }
      if (n_mine > 0) {
        // tile 0: S only
        mbar_wait(full_k(kt0 % STAGES), par(kt0));
        __syncwarp();
        wgmma_fence();
        issue_s(qb, kt0 % STAGES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        release(empty_k(kt0 % STAGES));
        softmax(0);
        rescale_and_pack();
        // tile t: S of t and P V of t - 1 issued together; the softmax of
        // t runs while P V of t - 1 (and the other warpgroup's products)
        // occupy the tensor cores
        for (int t = 1; t < n_mine; ++t) {
          const int s = (kt0 + t) % STAGES, sp = (kt0 + t - 1) % STAGES;
          mbar_wait(full_k(s), par(kt0 + t));
          mbar_wait(full_v(sp), par(kt0 + t - 1));
          __syncwarp();
          fence_regs(acc);
          fence_regs(p);
          wgmma_fence();
          issue_s(qb, s);
          wgmma_commit();
          issue_pv(sp);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(sc);
          release(empty_k(s));
          softmax(t);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(p);
          release(empty_v(sp));
          rescale_and_pack();
        }
      }
      // Q is read (every S of this item is done): a later item's may land
      if (n_tiles > 0) release(q_free(qb));
      if (n_mine > 0) {
        // the last tile's P V
        const int sl = (kt0 + n_mine - 1) % STAGES;
        mbar_wait(full_v(sl), par(kt0 + n_mine - 1));
        __syncwarp();
        fence_regs(acc);
        fence_regs(p);
        wgmma_fence();
        issue_pv(sl);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        release(empty_v(sl));
      }
      // tiles this warpgroup skips: released in their own phase once landed
      for (int t = n_mine; t < n_tiles; ++t) {
        const int s = (kt0 + t) % STAGES;
        mbar_wait(full_k(s), par(kt0 + t));
        mbar_wait(full_v(s), par(kt0 + t));
        release(empty_k(s));
        release(empty_v(s));
      }
      if (n_tiles > 0) ++qi;
      kt0 += n_tiles;

      // O / l, written once; rows past Tq are not written. An item with no
      // K/V tile to read writes zeros.
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      bf16* dst = o + (((int64_t)it.b * Tq + r) * H + it.h) * D + 2 * c;
      const int64_t row8 = (int64_t)8 * H * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (r < Tq)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (r + 8 < Tq)
          *reinterpret_cast<uint32_t*>(dst + row8 + 8 * j) =
              pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime (no
// -lcuda at link time)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a contiguous bf16 [B, T, heads, D] tensor whose box is
// `rows` rows of one head and `cols` columns, swizzled `cols * 2` bytes.
// Returns 0 or an error code (10000 + the CUresult).
int make_map(CUtensorMap* map, const void* ptr, int B, int T, int heads,
             int D, int cols, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)T * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + (int)res;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* o, int B, int Tq, int Tk, int H, int KV, int causal,
           int q_offset, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = make_map(&tm_q, q, B, Tq, H, D, L::BOXC, BQ);
  if (!err) err = make_map(&tm_k, k, B, Tk, KV, D, L::BOXC, BK);
  if (!err) err = make_map(&tm_v, v, B, Tk, KV, D, L::BOXC, BK);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::total);
  if (attr != cudaSuccess) return (int)attr;
  const long long n_work = (long long)((Tq + BQ - 1) / BQ) * B * H;
  if (n_work > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(n_work < n_sm ? n_work : n_sm);
  flash_fwd_kernel<D><<<grid, THREADS, L::total, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const int*>(kv_len), static_cast<bf16*>(o),
      B, Tq, Tk, H, KV, causal, q_offset, LOG2E / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k/v [B, Tk, KV, D], o [B, Tq, H, D]: contiguous bf16 at
// 16-byte-aligned addresses. kv_len: int32 [B] or null. Returns 0 on
// success, a cudaError_t, or 10000 + a CUresult when a tensor map cannot be
// encoded.
extern "C" int gofr_flash_attention(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o, int B, int Tq,
                                    int Tk, int H, int KV, int D, int causal,
                                    int q_offset, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, kv_len, o, B, Tq, Tk, H, KV, causal, q_offset, s);
    case 64: return launch<64>(q, k, v, kv_len, o, B, Tq, Tk, H, KV, causal, q_offset, s);
    case 128: return launch<128>(q, k, v, kv_len, o, B, Tq, Tk, H, KV, causal, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
