// Flash prefill attention for Hopper (sm_90a), bf16 in and out, f32 inside.
//
// Replaces the Pallas TPU kernel gofr_tpu/ops/flash_attention.py
// (flash_attention_tpu -> _attn_kernel): causal or full softmax attention
// with scale D^-0.5, a static q_offset and an optional per-row kv_len mask,
// computed with an online softmax so the [Tq, Tk] logits never reach
// device memory.
//
// What bounds it on the H100: at the serving prefill shapes (Tq = Tk = 512,
// H = 32, KV = 8, D = 128) the work is ~128 FLOPs per byte of q, k, v and o
// — under the card's ~295 FLOP/byte ridge, so the floor is memory traffic;
// longer prompts cross into tensor-core throughput. What the design does
// about it:
//   - one CTA per (b*h, 64-query tile), four warps of 16 query rows each;
//     K/V tiles of 64 keys are double-buffered in shared memory with 16-byte
//     cp.async copies (the next tile loads while this one computes), so
//     each K/V byte crosses DRAM once per query tile;
//   - Q K^T and P V run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate). Q, the logits S, the probabilities P and the output
//     accumulator O all stay in registers: the S fragments are rescaled
//     in place and repacked as bf16 into the A operand of P V, and the
//     running max / sum live beside them. O is written once;
//   - K/V are read GROUPED ([B, Tk, KV, D], kv head h / n_rep): the
//     repeat_kv expansion of the TPU path never exists;
//   - tiles past the causal diagonal (q_offset included) and past kv_len[b]
//     are never loaded; the ragged edges (Tq, Tk not multiples of 64) are
//     zero-filled by the copies and masked here, so no shape has to divide
//     a block.
// Masked logits are the finite -1e30 of the JAX code, so a fully masked
// row gives a uniform row rather than NaN. wgmma/TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using gofr::cp_async16;
using gofr::cp_commit;
using gofr::cp_wait;
using gofr::smem_addr;

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per staged tile
constexpr int THREADS = 128;    // four warps, 16 query rows each
constexpr float NEG = -1e30f;

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // padded row: conflict-free fragment loads
  static constexpr size_t q = 0;                                  // [BQ][LD]
  static constexpr size_t k = q + sizeof(bf16) * BQ * LD;         // [2][BK][LD]
  static constexpr size_t v = k + sizeof(bf16) * 2 * BK * LD;     // [2][BK][LD]
  static constexpr size_t total = v + sizeof(bf16) * 2 * BK * LD;
};

// rows [row0, row0 + 64) of a strided bf16 matrix into padded smem rows;
// rows at or past `valid` become zeros
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int valid, int64_t stride) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = row0 + r < valid;
    cp_async16(dst + r * Smem<D>::LD + c,
               ok ? src + (int64_t)(row0 + r) * stride + c : src, ok);
  }
}

// D[16x8] += A[16x16] B[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices, transposed on the way in (row-major V -> the
// column-major B operand of P V)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, c = lane % 4): an f32
// accumulator holds rows g and g + 8, columns 2c and 2c + 1 of its 16x8
// tile; an A register set holds the same rows at columns 2c, 2c + 1 and
// 2c + 8, 2c + 9 of its 16x16 tile — so two neighbouring S tiles ARE one
// A fragment of P once packed to bf16.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kv_len,
                 bf16* __restrict__ o, int Tq, int Tk, int H, int KV,
                 int causal, int q_offset, float scale) {
  constexpr int LD = Smem<D>::LD;
  constexpr int NT = BK / 8;   // S tiles of 8 keys
  constexpr int DT = D / 8;    // O tiles of 8 dims
  constexpr int KT = D / 16;   // k-steps over the head dim
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + Smem<D>::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + Smem<D>::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + Smem<D>::v);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;

  const bf16* qb = q + ((int64_t)b * Tq * H + h) * D;      // row t at qb + t*H*D
  const bf16* kb = k + ((int64_t)b * Tk * KV + kvh) * D;   // row t at kb + t*KV*D
  const bf16* vb = v + ((int64_t)b * Tk * KV + kvh) * D;

  const int kvl = kv_len ? min(kv_len[b], Tk) : Tk;
  int k_end = kvl;
  if (causal) k_end = min(k_end, min(q0 + BQ, Tq) + q_offset);  // last q pos + 1
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  load_tile<D>(sQ, qb, q0, Tq, (int64_t)H * D);
  if (n_tiles > 0) {
    load_tile<D>(sK, kb, 0, Tk, (int64_t)KV * D);
    load_tile<D>(sV, vb, 0, Tk, (int64_t)KV * D);
  }
  cp_commit();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int qpos[2] = {q0 + r0 + q_offset, q0 + r0 + 8 + q_offset};
  float acc[DT][4];
  #pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    #pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  uint32_t qf[KT][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<D>(sK + (buf ^ 1) * BK * LD, kb, (t + 1) * BK, Tk, (int64_t)KV * D);
      load_tile<D>(sV + (buf ^ 1) * BK * LD, vb, (t + 1) * BK, Tk, (int64_t)KV * D);
    }
    cp_commit();
    cp_wait<1>();  // all but the newest group: Q and tile t have landed
    __syncthreads();
    if (t == 0) {
      #pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const bf16* p = sQ + r0 * LD + kk * 16 + 2 * c;
        qf[kk][0] = ld_u32(p);
        qf[kk][1] = ld_u32(p + 8 * LD);
        qf[kk][2] = ld_u32(p + 8);
        qf[kk][3] = ld_u32(p + 8 * LD + 8);
      }
    }
    const bf16* cK = sK + buf * BK * LD;
    const bf16* cV = sV + buf * BK * LD;

    // S[16 x 64] = Q K^T for this warp's rows
    float s[NT][4];
    #pragma unroll
    for (int n = 0; n < NT; ++n) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const bf16* kp = cK + (n * 8 + g) * LD + 2 * c;
      #pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        mma16816(s[n], qf[kk], ld_u32(kp + kk * 16), ld_u32(kp + kk * 16 + 8));
    }

    // mask, scale, online softmax (a row is spread over 4 lanes)
    float mx[2] = {m[0], m[1]};
    #pragma unroll
    for (int n = 0; n < NT; ++n)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const int kpos = t * BK + n * 8 + 2 * c + (e & 1);
        const bool ok = kpos < kvl && (!causal || kpos <= qpos[row]);
        s[n][e] = ok ? s[n][e] * scale : NEG;
        mx[row] = fmaxf(mx[row], s[n][e]);
      }
    float alpha[2];
    #pragma unroll
    for (int row = 0; row < 2; ++row) {
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
      alpha[row] = __expf(m[row] - mx[row]);
      m[row] = mx[row];
      l[row] *= alpha[row];
    }
    #pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    #pragma unroll
    for (int n = 0; n < NT; ++n)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;  // this lane's share of the row sum
      }

    // O[16 x D] += P[16 x 64] V[64 x D], 16 keys per k-step
    #pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * j][0], s[2 * j][1]),
          pack_bf16(s[2 * j][2], s[2 * j][3]),
          pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int vrow = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      #pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, cV + vrow * LD + dt * 8 + (lane >> 4) * 8);
        mma16816(acc[dt], pa, vf[0], vf[1]);
        mma16816(acc[dt + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }
  cp_wait<0>();

  // O / l, written once
  #pragma unroll
  for (int row = 0; row < 2; ++row) {
    float sum = l[row];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int qrow = q0 + r0 + row * 8;
    if (qrow >= Tq) continue;
    bf16* dst = o + (((int64_t)b * Tq + qrow) * H + h) * D + 2 * c;
    #pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(acc[dt][2 * row] * inv, acc[dt][2 * row + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* o, int B, int Tq, int Tk, int H, int KV, int causal,
           int q_offset, cudaStream_t stream) {
  const size_t smem = Smem<D>::total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(kv_len),
      static_cast<bf16*>(o), Tq, Tk, H, KV, causal, q_offset,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k/v [B, Tk, KV, D], o [B, Tq, H, D]: contiguous bf16.
// kv_len: int32 [B] or null. Returns a cudaError_t (0 on success).
extern "C" int gofr_flash_attention(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o, int B, int Tq,
                                    int Tk, int H, int KV, int D, int causal,
                                    int q_offset, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, kv_len, o, B, Tq, Tk, H, KV, causal, q_offset, s);
    case 64: return launch<64>(q, k, v, kv_len, o, B, Tq, Tk, H, KV, causal, q_offset, s);
    case 128: return launch<128>(q, k, v, kv_len, o, B, Tq, Tk, H, KV, causal, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
