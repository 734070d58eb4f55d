// Grouped-query decode attention for Hopper (sm_90a) over the stacked KV
// cache, bf16 in and out, f32 inside. Flash-decoding: a split pass and a
// combine pass.
//
// Replaces the Pallas TPU kernel gofr_tpu/ops/decode_attention.py
// (gqa_decode_attention_tpu -> _decode_kernel, fp cache): one query token
// per batch row attends the first kv_len[b] positions of the padded cache
// [L, B, S_max, KV, D] at `layer`, each KV head's n_rep query heads
// contracting against the un-expanded keys, with an online softmax in f32.
//
// What bounds it on the H100: bytes. Each live cache position is read once
// (K and V, KV*D*2 bytes each) for ~4*n_rep*D FLOPs — a few FLOPs per byte,
// far under the tensor-core ridge — so the floor is the live KV bytes over
// 3.35 TB/s. What the design does about it:
//   - the TPU kernel runs one program per batch row; at 4 slots x 8 KV
//     heads that is 32 CTAs on 132 SMs, too few to pull full bandwidth. Here
//     the grid is (S-chunks of 128 positions, KV head, batch row): each CTA
//     reads one chunk of one head's keys and values once and serves all
//     n_rep query rows from it, and a combine kernel merges the partial
//     (max, sum, accumulator) of the chunks;
//   - chunks past kv_len[b] exit at once, so the cost follows the live
//     prefix, not S_max; kv_len is clamped to S_max (a row at capacity can
//     carry kv_len = S_max + 1), which the TPU kernel's cdiv(kv_len, block)
//     would overrun;
//   - every thread loads 16 bytes along D; the cache is read in place at
//     `layer`, with no copy.
// A kv_len of 0 or less attends nothing valid: like the JAX code's finite
// -1e30 mask, every position is then masked and the row is uniform over
// S_max.
//
// The int8 split kernel replaces _decode_kernel_quant (the int8 branch of
// _decode_kernel, gofr_tpu/ops/decode_attention.py:147, body :110-116,
// scale DMAs :68-87): the cache is int8 stored FLAT [L, B, S_max, KV*D]
// with bf16 scales seq-minor [L, B, KV, S_max], one scale per (position,
// KV head). Its bound is the bytes too: live positions x KV x (D + 2) x 2
// (K and V), half the fp cache's. What the design does about it:
//   - the same grid and combine pass as the fp kernel;
//   - head kvh of position j is D contiguous bytes, so one 16-byte load
//     brings 16 codes and D = 128 takes 8 threads per position;
//   - a chunk's 128 K scales and 128 V scales are contiguous in the
//     seq-minor planes (256 B each): each CTA loads them into shared memory
//     once;
//   - the scales fold in per position, not per element: score_j =
//     (q . k_int8_j) * ks_j * D^-1/2 and acc += (p_j * vs_j) * v_int8_j, in
//     f32, so no dequantized copy of the cache exists anywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int CHUNK = 128;   // cache positions per split CTA
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack16(const int4& raw, float* out) {
  const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[4 * i] = c[i].x;
    out[4 * i + 1] = c[i].y;
    out[4 * i + 2] = c[i].z;
    out[4 * i + 3] = c[i].w;
  }
}

// grid (n_splits, KV, B). Writes, per (b, kv head, split, query row r), the
// unnormalised accumulator [D] and (max, sum) of its chunk; an empty chunk
// writes max = -inf and sum = 0 so the combine ignores it.
template <int D, int NREP>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                    const bf16* __restrict__ vc, const int* __restrict__ kv_len,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int B, int S, int KV, int layer, float scale) {
  constexpr int G = D / 8;             // threads per cache row (16 B each)
  constexpr int RPI = THREADS / G;     // cache rows per CTA iteration
  __shared__ float sq[NREP][D];
  __shared__ float ss[NREP][CHUNK];
  __shared__ float sacc[RPI][NREP][D];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x;
  const int raw = kv_len[b];
  const int n_keys = raw <= 0 ? S : min(raw, S);
  const bool live = raw > 0;
  const int start = split * CHUNK;
  const int64_t part = ((int64_t)b * KV + kvh) * n_splits + split;
  float* acc_out = part_acc + part * NREP * D;
  float* ml_out = part_ml + part * NREP * 2;
  if (start >= n_keys) {
    for (int i = tid; i < NREP * D; i += THREADS) acc_out[i] = 0.f;
    if (tid < NREP) {
      ml_out[2 * tid] = -INFINITY;
      ml_out[2 * tid + 1] = 0.f;
    }
    return;
  }
  const int n = min(CHUNK, n_keys - start);
  const int H = KV * NREP;
  const int64_t row_stride = (int64_t)KV * D;
  const int64_t base = (((int64_t)layer * B + b) * S * KV + kvh) * D;
  const bf16* kb = kc + base + start * row_stride;
  const bf16* vb = vc + base + start * row_stride;

  const bf16* qb = q + ((int64_t)b * H + (int64_t)kvh * NREP) * D;
  for (int i = tid; i < NREP * D; i += THREADS)
    sq[i / D][i % D] = __bfloat162float(qb[i]) * scale;
  __syncthreads();

  // scores: G consecutive threads share one cache row, 8 dims each
  const int grp = tid / G, gl = tid % G;
  for (int j0 = 0; j0 < n; j0 += RPI) {
    const int j = j0 + grp;
    float kf[8];
    if (j < n) {
      unpack8(*reinterpret_cast<const uint4*>(kb + j * row_stride + gl * 8), kf);
    } else {
      for (int e = 0; e < 8; ++e) kf[e] = 0.f;
    }
    float dot[NREP];
    for (int r = 0; r < NREP; ++r) {
      float acc = 0.f;
      for (int e = 0; e < 8; ++e) acc += kf[e] * sq[r][gl * 8 + e];
      dot[r] = acc;
    }
    for (int off = G / 2; off > 0; off /= 2)
      for (int r = 0; r < NREP; ++r)
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
    if (gl == 0 && j < n)
      for (int r = 0; r < NREP; ++r) ss[r][j] = live ? dot[r] : NEG;
  }
  __syncthreads();

  // softmax statistics of the chunk, one warp per query row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < NREP; r += THREADS / 32) {
    float mx = NEG;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ss[r][j]);
    for (int off = 16; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(ss[r][j] - mx);
      ss[r][j] = p;
      sum += p;
    }
    for (int off = 16; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ml_out[2 * r] = mx;
      ml_out[2 * r + 1] = sum;
    }
  }
  __syncthreads();

  // accumulator: each thread sums its 8 dims over its rows of the chunk
  float a[NREP][8];
  for (int r = 0; r < NREP; ++r)
    for (int e = 0; e < 8; ++e) a[r][e] = 0.f;
  for (int j = grp; j < n; j += RPI) {
    float vf[8];
    unpack8(*reinterpret_cast<const uint4*>(vb + j * row_stride + gl * 8), vf);
    for (int r = 0; r < NREP; ++r) {
      const float p = ss[r][j];
      for (int e = 0; e < 8; ++e) a[r][e] += p * vf[e];
    }
  }
  for (int r = 0; r < NREP; ++r)
    for (int e = 0; e < 8; ++e) sacc[grp][r][gl * 8 + e] = a[r][e];
  __syncthreads();
  for (int i = tid; i < NREP * D; i += THREADS) {
    float sum = 0.f;
    for (int g = 0; g < RPI; ++g) sum += sacc[g][i / D][i % D];
    acc_out[i] = sum;
  }
}

// The int8 counterpart of decode_split_kernel, same grid and outputs. kc/vc
// are the flat int8 values [L, B, S, KV*D], ks/vs the bf16 scales
// [L, B, KV, S].
template <int D, int NREP>
__global__ void __launch_bounds__(THREADS)
decode_split_int8_kernel(const bf16* __restrict__ q,
                         const int8_t* __restrict__ kc,
                         const int8_t* __restrict__ vc,
                         const bf16* __restrict__ ks,
                         const bf16* __restrict__ vs,
                         const int* __restrict__ kv_len,
                         float* __restrict__ part_acc,
                         float* __restrict__ part_ml, int B, int S, int KV,
                         int layer, float scale) {
  constexpr int G = D / 16;            // threads per cache row (16 codes each)
  constexpr int RPI = THREADS / G;     // cache rows per CTA iteration
  constexpr int WARPS = THREADS / 32;
  __shared__ __align__(16) float sq[NREP][D];
  __shared__ float ss[NREP][CHUNK];
  __shared__ float sks[CHUNK];
  __shared__ float svs[CHUNK];
  __shared__ float sacc[WARPS][NREP][D];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x;
  const int raw = kv_len[b];
  const int n_keys = raw <= 0 ? S : min(raw, S);
  const bool live = raw > 0;
  const int start = split * CHUNK;
  const int64_t part = ((int64_t)b * KV + kvh) * n_splits + split;
  float* acc_out = part_acc + part * NREP * D;
  float* ml_out = part_ml + part * NREP * 2;
  if (start >= n_keys) {
    for (int i = tid; i < NREP * D; i += THREADS) acc_out[i] = 0.f;
    if (tid < NREP) {
      ml_out[2 * tid] = -INFINITY;
      ml_out[2 * tid + 1] = 0.f;
    }
    return;
  }
  const int n = min(CHUNK, n_keys - start);
  const int H = KV * NREP;
  const int64_t row_stride = (int64_t)KV * D;
  const int64_t base =
      (((int64_t)layer * B + b) * S + start) * row_stride + (int64_t)kvh * D;
  const int8_t* kb = kc + base;
  const int8_t* vb = vc + base;
  const int64_t sbase = (((int64_t)layer * B + b) * KV + kvh) * S + start;
  for (int j = tid; j < n; j += THREADS) {
    sks[j] = __bfloat162float(ks[sbase + j]);
    svs[j] = __bfloat162float(vs[sbase + j]);
  }
  const bf16* qb = q + ((int64_t)b * H + (int64_t)kvh * NREP) * D;
  for (int i = tid; i < NREP * D; i += THREADS)
    sq[i / D][i % D] = __bfloat162float(qb[i]) * scale;
  __syncthreads();

  // scores: G consecutive threads share one cache row, 16 codes each; the
  // K scale multiplies the finished dot product
  const int grp = tid / G, gl = tid % G;
  for (int j0 = 0; j0 < n; j0 += RPI) {
    const int j = j0 + grp;
    float kf[16];
    if (j < n) {
      unpack16(*reinterpret_cast<const int4*>(kb + j * row_stride + gl * 16),
               kf);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) kf[e] = 0.f;
    }
    float dot[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float4* qv = reinterpret_cast<const float4*>(&sq[r][gl * 16]);
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 x = qv[t];
        acc += kf[4 * t] * x.x + kf[4 * t + 1] * x.y + kf[4 * t + 2] * x.z +
               kf[4 * t + 3] * x.w;
      }
      dot[r] = acc;
    }
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2) {
#pragma unroll
      for (int r = 0; r < NREP; ++r)
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
    }
    if (gl == 0 && j < n) {
#pragma unroll
      for (int r = 0; r < NREP; ++r) ss[r][j] = live ? dot[r] * sks[j] : NEG;
    }
  }
  __syncthreads();

  // softmax statistics of the chunk, one warp per query row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < NREP; r += WARPS) {
    float mx = NEG;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ss[r][j]);
    for (int off = 16; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(ss[r][j] - mx);
      ss[r][j] = p;
      sum += p;
    }
    for (int off = 16; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ml_out[2 * r] = mx;
      ml_out[2 * r + 1] = sum;
    }
  }
  __syncthreads();

  // accumulator: each thread sums its 16 dims over its rows of the chunk,
  // weighting each row by p_j * vs_j
  float a[NREP][16];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
#pragma unroll
    for (int e = 0; e < 16; ++e) a[r][e] = 0.f;
  }
  for (int j = grp; j < n; j += RPI) {
    float vf[16];
    unpack16(*reinterpret_cast<const int4*>(vb + j * row_stride + gl * 16), vf);
    const float w = svs[j];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float p = ss[r][j] * w;
#pragma unroll
      for (int e = 0; e < 16; ++e) a[r][e] += p * vf[e];
    }
  }
  // lanes gl, gl + G, ... of a warp hold the same dims: sum them in the
  // warp, then the WARPS partial sums through shared memory
#pragma unroll
  for (int off = G; off < 32; off *= 2) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        a[r][e] += __shfl_xor_sync(0xffffffffu, a[r][e], off);
    }
  }
  if (lane < G) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
#pragma unroll
      for (int e = 0; e < 16; ++e) sacc[warp][r][gl * 16 + e] = a[r][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < NREP * D; i += THREADS) {
    float sum = 0.f;
    for (int w = 0; w < WARPS; ++w) sum += sacc[w][i / D][i % D];
    acc_out[i] = sum;
  }
}

// grid (B * H), D threads: merge the splits of one (b, h) into o [B, H, D].
template <int D, int NREP>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, bf16* __restrict__ o,
                      int KV, int n_splits) {
  const int H = KV * NREP;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / NREP, r = h % NREP;
  const int d = threadIdx.x;
  const int64_t first = ((int64_t)b * KV + kvh) * n_splits;
  float mx = -INFINITY;
  for (int s = 0; s < n_splits; ++s)
    mx = fmaxf(mx, part_ml[((first + s) * NREP + r) * 2]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* ml = part_ml + ((first + s) * NREP + r) * 2;
    const float w = expf(ml[0] - mx);  // 0 for an empty split (max = -inf)
    den += w * ml[1];
    num += w * part_acc[((first + s) * NREP + r) * D + d];
  }
  o[((int64_t)b * H + h) * D + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
}

struct Args {
  const void *q, *kc, *vc, *ks, *vs, *kv_len;  // ks/vs: int8 cache only
  void *part_acc, *part_ml, *o;
  int B, S, KV, layer, n_splits;
};

template <int D, int NREP, bool INT8>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.n_splits, a.KV, a.B);
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (INT8) {
    decode_split_int8_kernel<D, NREP><<<grid, THREADS, 0, stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const int8_t*>(a.kc),
        static_cast<const int8_t*>(a.vc), static_cast<const bf16*>(a.ks),
        static_cast<const bf16*>(a.vs), static_cast<const int*>(a.kv_len),
        static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml), a.B,
        a.S, a.KV, a.layer, scale);
  } else {
    decode_split_kernel<D, NREP><<<grid, THREADS, 0, stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kc),
        static_cast<const bf16*>(a.vc), static_cast<const int*>(a.kv_len),
        static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml), a.B,
        a.S, a.KV, a.layer, scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<D, NREP><<<a.B * a.KV * NREP, D, 0, stream>>>(
      static_cast<const float*>(a.part_acc),
      static_cast<const float*>(a.part_ml), static_cast<bf16*>(a.o), a.KV,
      a.n_splits);
  return (int)cudaGetLastError();
}

template <bool INT8, int D>
int launch_d(int n_rep, const Args& a, cudaStream_t s) {
  switch (n_rep) {
    case 1: return launch<D, 1, INT8>(a, s);
    case 2: return launch<D, 2, INT8>(a, s);
    case 4: return launch<D, 4, INT8>(a, s);
    case 8: return launch<D, 8, INT8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool INT8>
int launch_any(int D, int n_rep, const Args& a, void* stream) {
  if (a.B <= 0 || a.S <= 0 || a.KV <= 0 || a.layer < 0 ||
      a.n_splits != (a.S + CHUNK - 1) / CHUNK)
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

// Cache positions each split CTA covers; the wrapper sizes the partials.
extern "C" int gofr_decode_split_len() { return CHUNK; }

// q [B, H, D] bf16 (H = KV * n_rep); k/v cache [L, B, S, KV, D] bf16;
// kv_len int32 [B]; part_acc f32 [B, KV, n_splits, n_rep, D]; part_ml f32
// [B, KV, n_splits, n_rep, 2]; o [B, H, D] bf16. n_splits = ceil(S / CHUNK).
// Returns a cudaError_t (0 on success).
extern "C" int gofr_gqa_decode_attention(const void* q, const void* k_cache,
                                         const void* v_cache, const void* kv_len,
                                         void* part_acc, void* part_ml, void* o,
                                         int B, int S, int KV, int n_rep, int D,
                                         int layer, int n_splits, void* stream) {
  const Args a{q, k_cache, v_cache, nullptr, nullptr, kv_len, part_acc,
               part_ml, o, B, S, KV, layer, n_splits};
  return launch_any<false>(D, n_rep, a, stream);
}

// The int8 cache: k/v values [L, B, S, KV*D] int8 (16-byte aligned), k/v
// scales [L, B, KV, S] bf16; everything else as above.
extern "C" int gofr_gqa_decode_attention_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* kv_len,
    void* part_acc, void* part_ml, void* o, int B, int S, int KV, int n_rep,
    int D, int layer, int n_splits, void* stream) {
  const Args a{q, k_cache, v_cache, k_scale, v_scale, kv_len, part_acc,
               part_ml, o, B, S, KV, layer, n_splits};
  return launch_any<true>(D, n_rep, a, stream);
}
