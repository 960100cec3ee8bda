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
// stream (nine in bf16, where each LN's row statistics are a small pass of
// their own), each a kernel of this file or of mvit_attention.cu:
//   1. LN1 + qkv product (LN applied to the product's A operand);
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
// What bounds it on this card: at the 32 chunks the extractor hands it, a
// stage-3 block (65,568 rows x 384 channels) is 314 GFLOP (products 24 C^2 a
// row, attention 3 x 513 x C a row) against 101 MB in and out: operations,
// 0.32 ms at the tensor peak. The intermediates this design sends through
// device memory (qkv 151 MB, pooled q, context and y1 50 MB each, the 4C
// hidden 201 MB, each written once and read once) are another ~1 GB, 0.3 ms
// at the memory rate, so the products must run near the tensor peak and the
// launches between them near the memory rate. What the design does: in bf16
// the four products are one wgmma GEMM (below) with the LN statistics taken
// once per row; the attention step keeps its scores in registers on wgmma
// (mvit_attention.cu); the pools read 16 bytes a lane. float32 stays a
// 64 x 64 register-tiled FMA GEMM at full precision with scalar pools. Left
// for later: fc1 + GELU + fc2 in one kernel so the hidden stays on chip, and
// tiles larger than 128 x 192 (or TMA multicast) to take less from L2.

#include <type_traits>

#include "wgmma.cuh"

extern "C" int avdd_pooled_attention(const void* q, const void* k, const void* v,
                                     const void* band, const void* rel, void* out,
                                     int B, int nh, int nq, int nk, int d, int T, int S,
                                     long long qsb, long long qsh, long long qsn,
                                     long long osb, long long osh, long long osn,
                                     float scale, int flags, int dtype, void* stream,
                                     int* route);

namespace {

using namespace avdd;

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int FM = 64, FN = 64, FK = 16;   // f32 product tile
constexpr int MAXD = 128;
constexpr float LN_EPS = 1e-6f;
enum { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RES = 2 };
enum { PRESCALE = 1, BAND_ROUND = 2, CLS_FIRST = 4, BAND_TABLE = 8 };  // mvit_attention.cu

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
  __shared__ float As[FK][FM + 4];
  __shared__ float Ws[FK][FN + 4];
  __shared__ float mu[FM], rs[FM];
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (ln) {   // row statistics, f32, fast variance clamped at 0 (flax)
    for (int r = warp; r < FM; r += NWARP) {
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
  for (int k0 = 0; k0 < K; k0 += FK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < FM * FK; idx += NT) {
      const int r = idx / FK, kk = idx % FK, m = min(m0 + r, M - 1), k = k0 + kk;
      float a = Nm::load(A, (size_t)m * K + k);
      if (ln) a = Nm::rnd((a - mu[r]) * (rs[r] * ln[k]) + ln[K + k]);
      As[kk][r] = a;
      Ws[kk][r] = Nm::load(W, (size_t)(n0 + r) * K + k);   // FN == FM rows of W
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
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

// ---- bf16 products on wgmma -------------------------------------------------
// The same function and epilogues as gemm_kernel. These products are long
// and thin (M = 65,568 rows at 32 chunks against K, N of a few hundred): a
// tile's k loop is only 3 to 48 steps and what a product moves (A in, out
// back, the residual) weighs about as much as what it multiplies.
// - A block of two warpgroups owns a GM x BN output tile (64 rows a
//   warpgroup, BN = 192 for every production width; column tiles fastest in
//   the grid, so neighbouring SMs share A rows in L2). k advances in steps
//   of GKT = 64 (one 128-byte swizzled row) through a ring of GS stages, each
//   an A tile (GM rows) and a W tile (BN rows), filled by cp.async two steps
//   ahead of the products.
// - A reaches wgmma as its register operand: each warp reads its 16 x 16
//   fragments from the A tile with ldmatrix, once per k step, and, with LN,
//   normalises them there from the row statistics that ln_stats_kernel left
//   (one pass per row, not one per column block). W is the shared-memory
//   operand. A k step's four wgmma (m64nBNk16) stay in flight while the next
//   step's fragments are read and normalised into the other half of a
//   double-buffered register set.
// - The epilogue rounds as gemm_kernel does. With a residual it parks the
//   tile in shared memory and reads the residual and writes the rows in
//   16-byte pieces (measured 10% faster there, NVIDIA H100 80GB HBM3, 700 W);
//   without one each thread writes its own bf16 pairs (parking measured
//   12-20% slower for the wide qkv and fc1 outputs).
// cp.async rather than TMA: a stage is five 16-byte copies per thread, needs
// no tensor map per call, and a persistent variant that loaded the next
// tile's stages under the epilogue measured within 5% of this one: at these
// tile sizes the k loop runs at the rate L2 feeds 40 KB a step to every SM.
constexpr int GM = 128, GKT = 64, GS = 4, GNT = 256;

template <int BN> struct GemmTile {      // a stage: the A tile, then the W tile
  static constexpr int STAGE = (GM + BN) * 128;
  static constexpr int EROW = 2 * BN + 16;           // bytes of a parked output row
  static constexpr int SMEM = GS * STAGE + 1024;     // + GM * EROW when the tile is parked
};

// Row statistics of A (M, K) bf16 for the LN fused into the next product:
// stats[m] = (mean, rsqrt(var + eps)), f32, fast variance clamped at 0. A
// warp per row, 16-byte loads.
__global__ void __launch_bounds__(NT)
ln_stats_kernel(const __nv_bfloat16* __restrict__ A, float2* __restrict__ stats, int M, int K) {
  const int m = blockIdx.x * NWARP + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (m >= M) return;
  const uint4* row = reinterpret_cast<const uint4*>(A + (size_t)m * K);
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < K / 8; c += 32) {
    const uint4 v = row[c];
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      s += f.x + f.y;
      s2 += f.x * f.x + f.y * f.y;
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const float mean = s / K;
    stats[m] = make_float2(mean, rsqrtf(fmaxf(s2 / K - mean * mean, 0.f) + LN_EPS));
  }
}

// LN of a pair of bf16 values of one row: (x - mu) * (rs * w) + b, rounded.
__device__ __forceinline__ uint32_t ln_pair(uint32_t v, float2 st, float2 w, float2 b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16((x.x - st.x) * (st.y * w.x) + b.x, (x.y - st.x) * (st.y * w.y) + b.y);
}

template <int BN, bool LN, bool PARK>
__global__ void __launch_bounds__(GNT, 1)
gemm_wgmma_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                  const float2* __restrict__ stats, const float* __restrict__ ln,
                  const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                  __nv_bfloat16* out, int M, int N, int K, int epi) {
  using Nm = Num<__nv_bfloat16>;
  constexpr int STAGE = GemmTile<BN>::STAGE, EROW = GemmTile<BN>::EROW;
  extern __shared__ __align__(16) unsigned char smraw[];
  const uint32_t raw = smem_u32(smraw), ring = (raw + 1023u) & ~1023u;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nkt = K / GKT;

  auto load_stage = [&](int j) {     // k step j -> stage j % GS; rows past M zero-filled
    if (j < nkt) {
      const uint32_t sa = ring + (j % GS) * STAGE, sw = sa + GM * 128;
      const __nv_bfloat16* a = A + (size_t)j * GKT;
      const __nv_bfloat16* w = W + (size_t)n0 * K + (size_t)j * GKT;
#pragma unroll
      for (int i = 0; i < GM * 8 / GNT; ++i) {
        const int idx = tid + GNT * i, r = idx / 8, c = idx % 8;
        const bool ok = m0 + r < M;
        cp_async16_to(sa + swz(r, c), ok ? a + (size_t)(m0 + r) * K + 8 * c : A, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < BN * 8 / GNT; ++i) {
        const int idx = tid + GNT * i, r = idx / 8, c = idx % 8;
        cp_async16_to(sw + swz(r, c), w + (size_t)r * K + 8 * c, 16);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < GS - 2; ++j) load_stage(j);

  // this thread's fragment rows (g and g + 8 of the warp's 16) and, for
  // ldmatrix, the tile row and chunk half this lane names
  const int fr = 64 * wg + 16 * warp;
  const int lrow = fr + (lane & 7) + 8 * ((lane >> 3) & 1), lhalf = lane >> 4;
  float2 st0 = make_float2(0.f, 1.f), st1 = st0;
  if (LN) {
    st0 = stats[min(m0 + fr + g, M - 1)];
    st1 = stats[min(m0 + fr + g + 8, M - 1)];
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t af[2][4][4];

  auto step = [&](auto buf, int j) {
    constexpr int I = decltype(buf)::value;
    cp_wait<GS - 3>();            // this thread's copies of k step j have landed
    fence_async_shared();
    __syncthreads();              // everyone's have; step j - 2 is consumed by both warpgroups
    load_stage(j + GS - 2);       // into the stage step j - 2 left
    const uint32_t sa = ring + (j % GS) * STAGE, sw = sa + GM * 128;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldmatrix_x4_at(af[I][kk], sa + swz(lrow, 2 * kk + lhalf));
      if (LN) {
        const int c = j * GKT + 16 * kk + 2 * t;
        const float2 w0 = *reinterpret_cast<const float2*>(ln + c);
        const float2 w1 = *reinterpret_cast<const float2*>(ln + c + 8);
        const float2 b0 = *reinterpret_cast<const float2*>(ln + K + c);
        const float2 b1 = *reinterpret_cast<const float2*>(ln + K + c + 8);
        af[I][kk][0] = ln_pair(af[I][kk][0], st0, w0, b0);
        af[I][kk][1] = ln_pair(af[I][kk][1], st1, w0, b0);
        af[I][kk][2] = ln_pair(af[I][kk][2], st0, w1, b1);
        af[I][kk][3] = ln_pair(af[I][kk][3], st1, w1, b1);
      }
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<BN, 0>::run(acc, af[I][kk], tile_desc(sw + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();              // step j - 1 is done; step j runs on
  };
  for (int j = 0; j < nkt; j += 2) {
    step(std::integral_constant<int, 0>{}, j);
    if (j + 1 < nkt) step(std::integral_constant<int, 1>{}, j + 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_wait<0>();

  if constexpr (PARK) {
    // bias (+ GELU) rounded into this warpgroup's 64 parked rows (the ring
    // is free once every warp's products are done), then whole rows out, the
    // residual added on the way
    __syncthreads();
    unsigned char* park = smraw + (ring - raw) + 64 * wg * EROW;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int n = n0 + 8 * jj + 2 * t;
      const float b0 = Nm::rnd(bias[n]), b1 = Nm::rnd(bias[n + 1]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float y0 = Nm::rnd(Nm::rnd(acc[4 * jj + 2 * hf]) + b0);
        float y1 = Nm::rnd(Nm::rnd(acc[4 * jj + 2 * hf + 1]) + b1);
        if (epi == EPI_BIAS_GELU) {
          y0 = gelu_erf(y0);
          y1 = gelu_erf(y1);
        }
        *reinterpret_cast<uint32_t*>(park + (16 * warp + g + 8 * hf) * EROW +
                                     2 * (8 * jj + 2 * t)) = pack_bf16(y0, y1);
      }
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");   // this warpgroup's rows
    constexpr int CH = BN / 8;    // 16-byte pieces of a row
#pragma unroll 4
    for (int idx = tid % 128; idx < 64 * CH; idx += 128) {
      const int r = idx / CH, c = idx % CH, m = m0 + 64 * wg + r;
      if (m >= M) continue;
      uint4 v = *reinterpret_cast<const uint4*>(park + r * EROW + 16 * c);
      const size_t o = (size_t)m * N + n0 + 8 * c;
      if (epi == EPI_BIAS_RES) {
        const uint4 rv = *reinterpret_cast<const uint4*>(res + o);
        const __nv_bfloat162* ye = reinterpret_cast<const __nv_bfloat162*>(&v);
        const __nv_bfloat162* re = reinterpret_cast<const __nv_bfloat162*>(&rv);
        uint32_t* vo = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 yf = __bfloat1622float2(ye[i]), rf = __bfloat1622float2(re[i]);
          vo[i] = pack_bf16(rf.x + yf.x, rf.y + yf.y);
        }
      }
      *reinterpret_cast<uint4*>(out + o) = v;
    }
  } else {
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int n = n0 + 8 * jj + 2 * t;
      const float b0 = Nm::rnd(bias[n]), b1 = Nm::rnd(bias[n + 1]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + fr + g + 8 * hf;
        if (m >= M) continue;
        const size_t o = (size_t)m * N + n;
        float y0 = Nm::rnd(Nm::rnd(acc[4 * jj + 2 * hf]) + b0);
        float y1 = Nm::rnd(Nm::rnd(acc[4 * jj + 2 * hf + 1]) + b1);
        if (epi == EPI_BIAS_GELU) {
          y0 = Nm::rnd(gelu_erf(y0));
          y1 = Nm::rnd(gelu_erf(y1));
        } else if (epi == EPI_BIAS_RES) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + o));
          y0 = Nm::rnd(r.x + y0);
          y1 = Nm::rnd(r.y + y1);
        }
        Nm::store2(out, o, y0, y1);
      }
    }
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

// ---- bf16 pools with 16-byte loads -----------------------------------------
// The same functions as pool_q_kernel / pool_kv_kernel for bf16 and a head
// dim that is a multiple of 8: 16 lanes per task, a lane eight consecutive
// channels, so a tap is one 16-byte load per lane instead of d two-byte loads
// spread over a warp. Taps accumulate in the same order as the scalar
// kernels; the per-head LN reduces over the 16 lanes.
constexpr int PV = 8;          // channels per lane
constexpr int PL = 16;         // lanes per task (head dim <= 128)

__device__ __forceinline__ void tap_fma(float (&y)[PV], const float* tp, const __nv_bfloat16* src) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const float4 w0 = *reinterpret_cast<const float4*>(tp);
  const float4 w1 = *reinterpret_cast<const float4*>(tp + 4);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(e[0]), b = __bfloat1622float2(e[1]);
  const float2 c = __bfloat1622float2(e[2]), d = __bfloat1622float2(e[3]);
  y[0] = fmaf(w0.x, a.x, y[0]); y[1] = fmaf(w0.y, a.y, y[1]);
  y[2] = fmaf(w0.z, b.x, y[2]); y[3] = fmaf(w0.w, b.y, y[3]);
  y[4] = fmaf(w1.x, c.x, y[4]); y[5] = fmaf(w1.y, c.y, y[5]);
  y[6] = fmaf(w1.z, d.x, y[6]); y[7] = fmaf(w1.w, d.y, y[7]);
}

// Per-head LN over the PL lanes of a task (inactive lanes hold zeros and
// store nothing), affine lw / lb at this lane's channels, one 16-byte store.
__device__ __forceinline__ void head_ln_store_vec(const float (&y)[PV], int d, bool active,
                                                  const float* lw, const float* lb,
                                                  __nv_bfloat16* dst) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < PV; ++i) { s += y[i]; s2 += y[i] * y[i]; }
#pragma unroll
  for (int o = PL / 2; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (!active) return;
  const float mean = s / d;
  const float r = rsqrtf(fmaxf(s2 / d - mean * mean, 0.f) + LN_EPS);
  uint4 o;
  uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int i = 0; i < PV / 2; ++i)
    op[i] = pack_bf16((y[2 * i] - mean) * (r * lw[2 * i]) + lb[2 * i],
                      (y[2 * i + 1] - mean) * (r * lw[2 * i + 1]) + lb[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = o;
}

__device__ __forceinline__ void round_all(float (&y)[PV]) {
#pragma unroll
  for (int i = 0; i < PV; ++i) y[i] = Num<__nv_bfloat16>::rnd(y[i]);
}

__global__ void __launch_bounds__(NT)
pool_q_vec_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ taps,
                  const float* __restrict__ pln, __nv_bfloat16* qp, int B, int Tt, int hs,
                  int ws, int C, int nh) {
  const int d = C / nh, S = hs * ws, N = 1 + Tt * S;
  const long long task = ((long long)blockIdx.x * NT + threadIdx.x) / PL;
  const int c0 = PV * (threadIdx.x % PL);
  const bool active = task < (long long)B * N * nh && c0 < d;
  float y[PV] = {};
  int h = 0, n = 0, b = 0;
  if (active) {
    h = task % nh;
    n = (task / nh) % N;
    b = task / ((long long)nh * N);
    const __nv_bfloat16* base = qkv + (size_t)b * N * 3 * C + h * d + c0;
    if (n == 0) {
      const uint4 v = *reinterpret_cast<const uint4*>(base);
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < PV / 2; ++i) {
        const float2 f = __bfloat1622float2(e[i]);
        y[2 * i] = f.x; y[2 * i + 1] = f.y;
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
            tap_fma(y, taps + ((dt * 3 + di) * 3 + dj) * d + c0,
                    base + (size_t)(1 + (tt * hs + ii) * ws + jj) * 3 * C);
          }
        }
      }
      round_all(y);
    }
  }
  head_ln_store_vec(y, d, active, pln + c0, pln + d + c0,
                    qp + ((size_t)b * N + n) * C + h * d + c0);
}

__global__ void __launch_bounds__(NT)
pool_kv_vec_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ taps,
                   const float* __restrict__ pln, __nv_bfloat16* kvp, int B, int Tt, int hs,
                   int ws, int C, int nh) {
  const int d = C / nh, S = hs * ws, N = 1 + Tt * S;
  const long long task = ((long long)blockIdx.x * NT + threadIdx.x) / PL;
  const int c0 = PV * (threadIdx.x % PL);
  const bool active = task < 2LL * B * nh * (Tt + 1) && c0 < d;
  float y[PV] = {};
  int r = 0, h = 0, b = 0, which = 0;
  if (active) {
    r = task % (Tt + 1);
    long long rest = task / (Tt + 1);
    h = rest % nh;
    rest /= nh;
    b = rest % B;
    which = rest / B;     // 0 k, 1 v
    const __nv_bfloat16* base = qkv + (size_t)b * N * 3 * C + (1 + which) * C + h * d + c0;
    const float* tw = taps + (size_t)(1 + which) * 27 * d + c0;
    if (r == Tt) {        // class token
      const uint4 v = *reinterpret_cast<const uint4*>(base);
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < PV / 2; ++i) {
        const float2 f = __bfloat1622float2(e[i]);
        y[2 * i] = f.x; y[2 * i + 1] = f.y;
      }
    } else {
      for (int dt = 0; dt < 3; ++dt) {
        const int tt = r + dt - 1;
        if (tt < 0 || tt >= Tt) continue;
        for (int i = 0; i < 2 && i < hs; ++i)
          for (int jw = 0; jw < 2 && jw < ws; ++jw)
            tap_fma(y, tw + ((dt * 3 + i + 1) * 3 + jw + 1) * d,
                    base + (size_t)(1 + (tt * hs + i) * ws + jw) * 3 * C);
      }
      round_all(y);
    }
  }
  const float* lw = pln + (size_t)(1 + which) * 2 * d + c0;
  head_ln_store_vec(y, d, active, lw, lw + d,
                    kvp + ((((size_t)which * B + b) * nh + h) * (Tt + 1) + r) * d + c0);
}

template <int BN, bool LN, bool PARK>
int launch_wgmma(const __nv_bfloat16* A, const __nv_bfloat16* W, const float2* stats,
                 const float* ln, const float* bias, const __nv_bfloat16* res,
                 __nv_bfloat16* out, int M, int N, int K, int epi, cudaStream_t s) {
  static int configured = 0;
  constexpr int bytes = GemmTile<BN>::SMEM;     // the parked tile reuses the ring
  static_assert(GM * GemmTile<BN>::EROW <= GS * GemmTile<BN>::STAGE, "parked tile fits the ring");
  if (int e = set_smem(gemm_wgmma_kernel<BN, LN, PARK>, bytes, configured)) return e;
  gemm_wgmma_kernel<BN, LN, PARK><<<dim3(N / BN, (M + GM - 1) / GM), GNT, bytes, s>>>(
      A, W, stats, ln, bias, res, out, M, N, K, epi);
  return (int)cudaGetLastError();
}

// out = epi(A' W^T): float32 on gemm_kernel (LN inside), bfloat16 on
// gemm_wgmma_kernel with 192-column tiles where they divide N (else 64),
// after ln_stats_kernel when A' is the LN of A.
template <typename T>
int gemm(const void* A, const void* W, const float* ln, const float* bias,
         const void* res, void* out, void* stats, int M, int N, int K, int epi, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(A);
    const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(W);
    const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(res);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    float2* st = static_cast<float2*>(stats);
    if (ln) {
      ln_stats_kernel<<<(M + NWARP - 1) / NWARP, NT, 0, s>>>(a, st, M, K);
      if (int e = (int)cudaGetLastError()) return e;
    }
    // this block's products: LN without a residual (qkv, fc1), or a residual without LN
#define AVDD_GEMM(BN)                                                                      \
    return ln ? launch_wgmma<BN, true, false>(a, w, st, ln, bias, r, o, M, N, K, epi, s)   \
              : launch_wgmma<BN, false, true>(a, w, st, ln, bias, r, o, M, N, K, epi, s)
    if (N % 192 == 0) { AVDD_GEMM(192); }     // every production width
    AVDD_GEMM(64);                            // any other C % 64 == 0
#undef AVDD_GEMM
  } else {
    dim3 grid(N / FN, (M + FM - 1) / FM);
    gemm_kernel<T><<<grid, NT, 0, s>>>(static_cast<const T*>(A), static_cast<const T*>(W),
                                       ln, bias, static_cast<const T*>(res),
                                       static_cast<T*>(out), M, N, K, epi);
    return (int)cudaGetLastError();
  }
}

struct Block {   // the packed inputs, in MSBlockPacked's order, and scratch
  const void* x; const float* ln1; const void* wqkv; const float* bqkv;
  const float* taps; const float* pool_ln; const float* rel_t;
  const void* wp; const float* bp; const float* ln2;
  const void* w1; const float* b1; const void* w2; const float* b2;
  void* qkv; void* qp; void* kvp; void* ctx; void* y1; void* hid; void* stats; void* out;
};

// The launches of one block, in order; stops at the first CUDA error.
template <typename T>
int run(const Block& k, int B, int Tt, int hs, int ws, int C, int nh, int dtype, cudaStream_t s) {
  const int S = hs * ws, N = 1 + Tt * S, M = B * N, d = C / nh;
  int e;
#define AVDD_STEP(call) if ((e = (call))) return e
  AVDD_STEP(gemm<T>(k.x, k.wqkv, k.ln1, k.bqkv, nullptr, k.qkv, k.stats, M, 3 * C, C, EPI_BIAS, s));
  const T* qkv = static_cast<const T*>(k.qkv);
  const long long q_tasks = (long long)M * nh, kv_tasks = 2LL * B * nh * (Tt + 1);
  const bool vec = sizeof(T) == 2 && d % PV == 0;
  if constexpr (sizeof(T) == 2) {
    if (vec) {
      const int per = NT / PL;     // tasks a block
      pool_q_vec_kernel<<<(unsigned)((q_tasks + per - 1) / per), NT, 0, s>>>(
          qkv, k.taps, k.pool_ln, static_cast<T*>(k.qp), B, Tt, hs, ws, C, nh);
      AVDD_STEP((int)cudaGetLastError());
      pool_kv_vec_kernel<<<(unsigned)((kv_tasks + per - 1) / per), NT, 0, s>>>(
          qkv, k.taps, k.pool_ln, static_cast<T*>(k.kvp), B, Tt, hs, ws, C, nh);
      AVDD_STEP((int)cudaGetLastError());
    }
  }
  if (!vec) {
    pool_q_kernel<T><<<(unsigned)((q_tasks + NWARP - 1) / NWARP), NT, 0, s>>>(
        qkv, k.taps, k.pool_ln, static_cast<T*>(k.qp), B, Tt, hs, ws, C, nh);
    AVDD_STEP((int)cudaGetLastError());
    pool_kv_kernel<T><<<(unsigned)((kv_tasks + NWARP - 1) / NWARP), NT, 0, s>>>(
        qkv, k.taps, k.pool_ln, static_cast<T*>(k.kvp), B, Tt, hs, ws, C, nh);
    AVDD_STEP((int)cudaGetLastError());
  }
  const T* kp = static_cast<const T*>(k.kvp);
  const T* vp = kp + (size_t)B * nh * (Tt + 1) * d;
  const int flags = PRESCALE | CLS_FIRST | BAND_TABLE | (S <= 4 ? BAND_ROUND : 0);
  AVDD_STEP(avdd_pooled_attention(k.qp, kp, vp, nullptr, k.rel_t, k.ctx, B, nh, N, Tt + 1, d,
                                  Tt, S, (long long)N * C, d, C, (long long)N * C, d, C,
                                  1.f / sqrtf((float)d), flags, dtype, s, nullptr));
  AVDD_STEP(gemm<T>(k.ctx, k.wp, nullptr, k.bp, k.x, k.y1, k.stats, M, C, C, EPI_BIAS_RES, s));
  AVDD_STEP(gemm<T>(k.y1, k.w1, k.ln2, k.b1, nullptr, k.hid, k.stats, M, 4 * C, C,
                    EPI_BIAS_GELU, s));
  AVDD_STEP(gemm<T>(k.hid, k.w2, nullptr, k.b2, k.y1, k.out, k.stats, M, C, 4 * C, EPI_BIAS_RES,
                    s));
#undef AVDD_STEP
  return 0;
}

}  // namespace

extern "C" {

// One block on `stream`; returns the first CUDA error (0 = all launched).
// x (B, 1 + T hs ws, C) and the four weights in the compute dtype (dtype 0
// float32, 1 bfloat16), the other packed inputs f32; scratch: qkv (B, N, 3C),
// qp, ctx, y1 (B, N, C), kvp (2, B, nh, T + 1, d), hid (B, N, 4C), stats
// (B, N, 2) f32 (bfloat16 only: the LN row statistics); out (B, N, C). Takes
// C % 64 == 0, head_dim <= 128, hs ws <= 16.
int avdd_msblock(const void* x, const void* ln1, const void* wqkv, const void* bqkv,
                 const void* taps, const void* pool_ln, const void* rel_t,
                 const void* wp, const void* bp, const void* ln2, const void* w1,
                 const void* b1, const void* w2, const void* b2, void* qkv, void* qp,
                 void* kvp, void* ctx, void* y1, void* hid, void* stats, void* out, int B,
                 int T, int hs, int ws, int C, int nh, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || hs <= 0 || ws <= 0 || hs * ws > 16 || nh <= 0 || C % 64 ||
      C % nh || C / nh > MAXD)
    return (int)cudaErrorInvalidValue;
  Block k{x, static_cast<const float*>(ln1), wqkv, static_cast<const float*>(bqkv),
          static_cast<const float*>(taps), static_cast<const float*>(pool_ln),
          static_cast<const float*>(rel_t), wp, static_cast<const float*>(bp),
          static_cast<const float*>(ln2), w1, static_cast<const float*>(b1), w2,
          static_cast<const float*>(b2), qkv, qp, kvp, ctx, y1, hid, stats, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(k, B, T, hs, ws, C, nh, dtype, s);
  if (dtype == 1) return run<__nv_bfloat16>(k, B, T, hs, ws, C, nh, dtype, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
