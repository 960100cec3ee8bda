// Whole MViT MultiscaleBlock for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel audio_visual_deepfake_detection_tpu/ops/pallas/
// mvit_block.py::fused_multiscale_block (pl.pallas_call at :343), K4: a
// stride-1 MultiscaleBlock whose k/v pool to a (T, 1, 1) grid,
//   LN1 -> qkv -> TokenPool q (3,3,3) stride 1 + per-head LN -> TokenPool
//   k, v to (T, 1, 1) + per-head LN -> pooled attention with the temporal
//   rel-pos band -> + q -> proj -> + x -> LN2 -> fc1 -> GELU -> fc2 -> + y1,
// for x (B, 1 + T S, C), S = Hs Ws <= 16 spatial cells.
//
// Why several launches: the TPU kernel keeps a whole chunk (1 + 512 S rows
// x C) resident in VMEM for one grid step. A Hopper block has 227 KB, and
// every query row attends all T + 1 pooled keys of its chunk, which exist
// only once every row of the chunk has been through LN1, qkv and the pools.
// So one wrapper call (avdd_msblock) runs seven launches on the caller's
// stream, each a kernel of this file or of mvit_attention.cu:
//   1. LN1 + qkv product (LN fused into the product's A-tile loads);
//   2. the q pool + per-head LN, written in the (B, N, C) token layout;
//   3. the k/v pools straight to (B, nh, T + 1, d), class token last;
//   4. pooled attention (mvit_attention.cu, band built there from rel_t),
//      + q, written to the token layout;
//   5. proj product + bias + residual x;
//   6. LN2 + fc1 product + bias + exact GELU;
//   7. fc2 product + bias + residual.
// No grid-wide sync in a cooperative launch: the pools and the attention
// need different thread layouts, and a cooperative grid would cap the
// blocks in flight at one wave for the whole block.
//
// Numerics follow msblock_math: f32 LN statistics (fast variance, clamped),
// products of compute-dtype values accumulated in f32 and rounded once, bias
// and residual adds in the compute dtype, f32 softmax statistics, the exp
// rounded before P.V. It differs from msblock_math only by summation order.
//
// What bounds it on this card: at production one chunk-block is ~7-9 GFLOP
// (stage 3: 2048 + 1 rows x 384 channels; products 24 C^2 per row plus
// attention 3 x 513 x C per row), against ~30-60 MB of device-memory traffic
// for the intermediates this design writes (qkv, pooled q, context, y1 and
// the 4C hidden, in the compute dtype): compute-bound. In bf16 the products
// run on the tensor cores (mma.sync m16n8k16, f32 accumulate, 64 x 64 tiles
// staged in shared memory), in f32 as a 64 x 64 register-tiled FMA GEMM (full
// f32 precision). Left for later: wgmma with TMA-staged tiles, and fusing the
// launches into one pass per tile of query time steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

extern "C" int avdd_pooled_attention(const void* q, const void* k, const void* v,
                                     const void* band, const void* rel, void* out,
                                     int B, int nh, int nq, int nk, int d, int T, int S,
                                     long long qsb, long long qsh, long long qsn,
                                     long long osb, long long osh, long long osn,
                                     float scale, int flags, int dtype, void* stream);

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int BM = 64, BN = 64, BK = 16;   // product tile
constexpr int MAXD = 128;
constexpr float LN_EPS = 1e-6f;
enum { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RES = 2 };
enum { PRESCALE = 1, BAND_ROUND = 2, CLS_FIRST = 4, BAND_TABLE = 8 };  // mvit_attention.cu

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ __forceinline__ static float load(const float* p, size_t i) { return __ldg(p + i); }
  __device__ __forceinline__ static float rnd(float v) { return v; }
  __device__ __forceinline__ static void store(float* p, size_t i, float v) { p[i] = v; }
};
template <> struct Num<__nv_bfloat16> {
  __device__ __forceinline__ static float load(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
  }
  __device__ __forceinline__ static float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, size_t i, float v) {
    p[i] = __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f32 products, register-tiled FMA (full f32 precision):
// out[m, n] = epi(sum_k A'[m, k] W[n, k]), A (M, K), W (N, K) row-major in
// the compute dtype; A' = A, or with ln != null the row LN of A with affine
// ln[0:K] (weight), ln[K:2K] (bias), rounded to the compute dtype. Thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j (i, j < 4).
template <typename T>
__global__ void __launch_bounds__(NT)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ W,
            const float* __restrict__ ln, const float* __restrict__ bias,
            const T* __restrict__ res, T* out, int M, int N, int K, int epi) {
  using Nm = Num<T>;
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN + 4];
  __shared__ float mu[BM], rs[BM];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (ln) {   // row statistics, f32, fast variance clamped at 0 (flax)
    for (int r = warp; r < BM; r += NWARP) {
      const int m = min(m0 + r, M - 1);
      float s = 0.f, s2 = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float a = Nm::load(A, (size_t)m * K + k);
        s += a;
        s2 += a * a;
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      if (lane == 0) {
        const float mean = s / K;
        mu[r] = mean;
        rs[r] = rsqrtf(fmaxf(s2 / K - mean * mean, 0.f) + LN_EPS);
      }
    }
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * BK; idx += NT) {
      const int r = idx / BK, kk = idx % BK, m = min(m0 + r, M - 1), k = k0 + kk;
      float a = Nm::load(A, (size_t)m * K + k);
      if (ln) a = Nm::rnd((a - mu[r]) * (rs[r] * ln[k]) + ln[K + k]);
      As[kk][r] = a;
      Ws[kk][r] = Nm::load(W, (size_t)(n0 + r) * K + k);   // BN == BM rows of W
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      const size_t o = (size_t)m * N + n;
      float y = Nm::rnd(Nm::rnd(acc[i][j]) + Nm::rnd(bias[n]));
      if (epi == EPI_BIAS_GELU)
        y = Nm::rnd(0.5f * y * (1.f + erff(y * 0.70710678118654752f)));
      else if (epi == EPI_BIAS_RES)
        y = Nm::rnd(Nm::load(res, o) + y);
      Nm::store(out, o, y);
    }
  }
}

// bf16 products on the tensor cores (mma.sync m16n8k16, f32 accumulate), the
// same function and epilogues as gemm_kernel: a 64 x 64 tile per block, k in
// steps of 32 staged in shared memory (one 16-byte load per thread for each
// operand), warp w owning rows 16 (w % 4) and columns 32 (w / 4) of the tile.
constexpr int GK = 32;
constexpr int LDS = GK + 8;   // bf16 row stride: conflict-free fragment loads

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(NT)
gemm_mma_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                const float* __restrict__ ln, const float* __restrict__ bias,
                const __nv_bfloat16* __restrict__ res, __nv_bfloat16* out, int M, int N,
                int K, int epi) {
  using Nm = Num<__nv_bfloat16>;
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 Ws[BN][LDS];
  __shared__ float mu[BM], rs[BM];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = 16 * (warp % 4), wn = 32 * (warp / 4);
  if (ln) {
    for (int r = warp; r < BM; r += NWARP) {
      const int m = min(m0 + r, M - 1);
      float s = 0.f, s2 = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float a = Nm::load(A, (size_t)m * K + k);
        s += a;
        s2 += a * a;
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      if (lane == 0) {
        const float mean = s / K;
        mu[r] = mean;
        rs[r] = rsqrtf(fmaxf(s2 / K - mean * mean, 0.f) + LN_EPS);
      }
    }
  }
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int lr = threadIdx.x / 4, lc = 8 * (threadIdx.x % 4);   // this thread's 8-wide load
  const int lm = min(m0 + lr, M - 1);
  for (int k0 = 0; k0 < K; k0 += GK) {
    __syncthreads();
    uint4 av = *reinterpret_cast<const uint4*>(A + (size_t)lm * K + k0 + lc);
    if (ln) {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&av);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + lc + i;
        e[i] = __float2bfloat16_rn((__bfloat162float(e[i]) - mu[lr]) * (rs[lr] * ln[k])
                                   + ln[K + k]);
      }
    }
    *reinterpret_cast<uint4*>(&As[lr][lc]) = av;
    *reinterpret_cast<uint4*>(&Ws[lr][lc]) =
        *reinterpret_cast<const uint4*>(W + (size_t)(n0 + lr) * K + k0 + lc);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      const __nv_bfloat16* r0 = &As[wm + g][kk + 2 * t];
      const __nv_bfloat16* r1 = &As[wm + g + 8][kk + 2 * t];
      const uint32_t a[4] = {ld_pair(r0), ld_pair(r1), ld_pair(r0 + 8), ld_pair(r1 + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* br = &Ws[wn + 8 * j + g][kk + 2 * t];
        mma_bf16(acc[j], a, ld_pair(br), ld_pair(br + 8));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm + g + (e >= 2 ? 8 : 0);
      const int n = n0 + wn + 8 * j + 2 * t + (e & 1);
      if (m >= M) continue;
      const size_t o = (size_t)m * N + n;
      float y = Nm::rnd(Nm::rnd(acc[j][e]) + Nm::rnd(bias[n]));
      if (epi == EPI_BIAS_GELU)
        y = Nm::rnd(0.5f * y * (1.f + erff(y * 0.70710678118654752f)));
      else if (epi == EPI_BIAS_RES)
        y = Nm::rnd(Nm::load(res, o) + y);
      Nm::store(out, o, y);
    }
}

// Per-head LN of d values held by a warp (lane owns dd = lane + 32 j), f32
// statistics, affine lw/lb, rounded; written to dst[dd].
template <typename T>
__device__ __forceinline__ void head_ln_store(float (&y)[MAXD / 32], int d,
                                              const float* lw, const float* lb,
                                              T* dst) {
  using Nm = Num<T>;
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < MAXD / 32; ++j) { s += y[j]; s2 += y[j] * y[j]; }
  const float mean = warp_sum(s) / d;
  const float r = rsqrtf(fmaxf(warp_sum(s2) / d - mean * mean, 0.f) + LN_EPS);
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < MAXD / 32; ++j) {
    const int dd = lane + 32 * j;
    if (dd < d) Nm::store(dst, dd, Nm::rnd((y[j] - mean) * (r * lw[dd]) + lb[dd]));
  }
}

// q pool: depthwise (3,3,3) conv, stride 1, padding 1, over the (T, Hs, Ws)
// grid of head h's q columns of qkv (B, N, 3C); the class token passes
// through; per-head LN -> qp (B, N, C). One warp per (sample, token, head).
template <typename T>
__global__ void __launch_bounds__(NT)
pool_q_kernel(const T* __restrict__ qkv, const float* __restrict__ taps,
              const float* __restrict__ pln, T* qp, int B, int Tt, int hs, int ws,
              int C, int nh) {
  using Nm = Num<T>;
  const int d = C / nh, S = hs * ws, N = 1 + Tt * S;
  const long long task = (long long)blockIdx.x * NWARP + threadIdx.x / 32;
  if (task >= (long long)B * N * nh) return;
  const int h = task % nh;
  const int n = (task / nh) % N;
  const int b = task / ((long long)nh * N);
  const int lane = threadIdx.x % 32;
  const T* base = qkv + (size_t)b * N * 3 * C + h * d;
  float y[MAXD / 32];
#pragma unroll
  for (int j = 0; j < MAXD / 32; ++j) y[j] = 0.f;
  if (n == 0) {
#pragma unroll
    for (int j = 0; j < MAXD / 32; ++j) {
      const int dd = lane + 32 * j;
      if (dd < d) y[j] = Nm::load(base, dd);
    }
  } else {
    const int g = n - 1, t = g / S, i = (g % S) / ws, jw = g % ws;
    for (int dt = 0; dt < 3; ++dt) {
      const int tt = t + dt - 1;
      if (tt < 0 || tt >= Tt) continue;
      for (int di = 0; di < 3; ++di) {
        const int ii = i + di - 1;
        if (ii < 0 || ii >= hs) continue;
        for (int dj = 0; dj < 3; ++dj) {
          const int jj = jw + dj - 1;
          if (jj < 0 || jj >= ws) continue;
          const T* src = base + (size_t)(1 + (tt * hs + ii) * ws + jj) * 3 * C;
          const float* tp = taps + ((dt * 3 + di) * 3 + dj) * d;
#pragma unroll
          for (int j = 0; j < MAXD / 32; ++j) {
            const int dd = lane + 32 * j;
            if (dd < d) y[j] = fmaf(tp[dd], Nm::load(src, dd), y[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MAXD / 32; ++j) y[j] = Nm::rnd(y[j]);
  }
  head_ln_store<T>(y, d, pln, pln + d, qp + ((size_t)b * N + n) * C + h * d);
}

// k / v pools: depthwise (3,3,3) conv, padding 1, with a spatial stride that
// leaves one output cell, so output (t, 0, 0) reads the cells (i, j) in
// {0, 1}^2 of the grid through kernel taps (i + 1, j + 1); per-head LN ->
// kvp (2, B, nh, T + 1, d), the class token LAST. One warp per (k or v,
// sample, head, output row).
template <typename T>
__global__ void __launch_bounds__(NT)
pool_kv_kernel(const T* __restrict__ qkv, const float* __restrict__ taps,
               const float* __restrict__ pln, T* kvp, int B, int Tt, int hs, int ws,
               int C, int nh) {
  using Nm = Num<T>;
  const int d = C / nh, S = hs * ws, N = 1 + Tt * S;
  const long long task = (long long)blockIdx.x * NWARP + threadIdx.x / 32;
  if (task >= 2LL * B * nh * (Tt + 1)) return;
  const int r = task % (Tt + 1);
  long long rest = task / (Tt + 1);
  const int h = rest % nh;
  rest /= nh;
  const int b = rest % B, which = rest / B;     // 0 k, 1 v
  const int lane = threadIdx.x % 32;
  const T* base = qkv + (size_t)b * N * 3 * C + (1 + which) * C + h * d;
  const float* tw = taps + (size_t)(1 + which) * 27 * d;
  const float* lw = pln + (size_t)(1 + which) * 2 * d;
  float y[MAXD / 32];
#pragma unroll
  for (int j = 0; j < MAXD / 32; ++j) y[j] = 0.f;
  if (r == Tt) {    // class token
#pragma unroll
    for (int j = 0; j < MAXD / 32; ++j) {
      const int dd = lane + 32 * j;
      if (dd < d) y[j] = Nm::load(base, dd);
    }
  } else {
    for (int dt = 0; dt < 3; ++dt) {
      const int tt = r + dt - 1;
      if (tt < 0 || tt >= Tt) continue;
      for (int i = 0; i < 2 && i < hs; ++i)
        for (int jw = 0; jw < 2 && jw < ws; ++jw) {
          const T* src = base + (size_t)(1 + (tt * hs + i) * ws + jw) * 3 * C;
          const float* tp = tw + ((dt * 3 + i + 1) * 3 + jw + 1) * d;
#pragma unroll
          for (int j = 0; j < MAXD / 32; ++j) {
            const int dd = lane + 32 * j;
            if (dd < d) y[j] = fmaf(tp[dd], Nm::load(src, dd), y[j]);
          }
        }
    }
#pragma unroll
    for (int j = 0; j < MAXD / 32; ++j) y[j] = Nm::rnd(y[j]);
  }
  head_ln_store<T>(y, d, lw, lw + d,
                   kvp + ((((size_t)which * B + b) * nh + h) * (Tt + 1) + r) * d);
}

template <typename T>
int gemm(const void* A, const void* W, const float* ln, const float* bias,
         const void* res, void* out, int M, int N, int K, int epi, cudaStream_t s) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  if constexpr (sizeof(T) == 2)
    gemm_mma_kernel<<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(W), ln, bias,
        static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out), M, N, K, epi);
  else
    gemm_kernel<T><<<grid, NT, 0, s>>>(static_cast<const T*>(A), static_cast<const T*>(W),
                                       ln, bias, static_cast<const T*>(res),
                                       static_cast<T*>(out), M, N, K, epi);
  return (int)cudaGetLastError();
}

struct Block {   // the packed inputs, in MSBlockPacked's order, and scratch
  const void* x; const float* ln1; const void* wqkv; const float* bqkv;
  const float* taps; const float* pool_ln; const float* rel_t;
  const void* wp; const float* bp; const float* ln2;
  const void* w1; const float* b1; const void* w2; const float* b2;
  void* qkv; void* qp; void* kvp; void* ctx; void* y1; void* hid; void* out;
};

template <typename T>
int run(const Block& k, int B, int Tt, int hs, int ws, int C, int nh, int dtype,
        cudaStream_t s) {
  const int S = hs * ws, N = 1 + Tt * S, M = B * N, d = C / nh;
  int e;
  if ((e = gemm<T>(k.x, k.wqkv, k.ln1, k.bqkv, nullptr, k.qkv, M, 3 * C, C, EPI_BIAS, s)))
    return e;
  const T* qkv = static_cast<const T*>(k.qkv);
  const long long q_tasks = (long long)M * nh, kv_tasks = 2LL * B * nh * (Tt + 1);
  pool_q_kernel<T><<<(unsigned)((q_tasks + NWARP - 1) / NWARP), NT, 0, s>>>(
      qkv, k.taps, k.pool_ln, static_cast<T*>(k.qp), B, Tt, hs, ws, C, nh);
  if ((e = (int)cudaGetLastError())) return e;
  pool_kv_kernel<T><<<(unsigned)((kv_tasks + NWARP - 1) / NWARP), NT, 0, s>>>(
      qkv, k.taps, k.pool_ln, static_cast<T*>(k.kvp), B, Tt, hs, ws, C, nh);
  if ((e = (int)cudaGetLastError())) return e;
  const T* kp = static_cast<const T*>(k.kvp);
  const T* vp = kp + (size_t)B * nh * (Tt + 1) * d;
  const int flags = PRESCALE | CLS_FIRST | BAND_TABLE | (S <= 4 ? BAND_ROUND : 0);
  if ((e = avdd_pooled_attention(k.qp, kp, vp, nullptr, k.rel_t, k.ctx, B, nh, N, Tt + 1,
                                 d, Tt, S, (long long)N * C, d, C, (long long)N * C, d, C,
                                 1.f / sqrtf((float)d), flags, dtype, s)))
    return e;
  if ((e = gemm<T>(k.ctx, k.wp, nullptr, k.bp, k.x, k.y1, M, C, C, EPI_BIAS_RES, s)))
    return e;
  if ((e = gemm<T>(k.y1, k.w1, k.ln2, k.b1, nullptr, k.hid, M, 4 * C, C, EPI_BIAS_GELU, s)))
    return e;
  return gemm<T>(k.hid, k.w2, nullptr, k.b2, k.y1, k.out, M, C, 4 * C, EPI_BIAS_RES, s);
}

}  // namespace

extern "C" {

// One block on `stream`; returns the first CUDA error (0 = all launched).
// x (B, 1 + T hs ws, C) and the four weights in the compute dtype (dtype 0
// float32, 1 bfloat16), the other packed inputs f32; scratch: qkv (B, N, 3C),
// qp, ctx, y1 (B, N, C), kvp (2, B, nh, T + 1, d), hid (B, N, 4C); out
// (B, N, C). Takes C % 64 == 0, head_dim <= 128, hs ws <= 16.
int avdd_msblock(const void* x, const void* ln1, const void* wqkv, const void* bqkv,
                 const void* taps, const void* pool_ln, const void* rel_t,
                 const void* wp, const void* bp, const void* ln2, const void* w1,
                 const void* b1, const void* w2, const void* b2, void* qkv, void* qp,
                 void* kvp, void* ctx, void* y1, void* hid, void* out, int B, int T,
                 int hs, int ws, int C, int nh, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || hs <= 0 || ws <= 0 || hs * ws > 16 || nh <= 0 || C % 64 ||
      C % nh || C / nh > MAXD)
    return (int)cudaErrorInvalidValue;
  Block k{x, static_cast<const float*>(ln1), wqkv, static_cast<const float*>(bqkv),
          static_cast<const float*>(taps), static_cast<const float*>(pool_ln),
          static_cast<const float*>(rel_t), wp, static_cast<const float*>(bp),
          static_cast<const float*>(ln2), w1, static_cast<const float*>(b1), w2,
          static_cast<const float*>(b2), qkv, qp, kvp, ctx, y1, hid, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(k, B, T, hs, ws, C, nh, dtype, s);
  if (dtype == 1) return run<__nv_bfloat16>(k, B, T, hs, ws, C, nh, dtype, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
