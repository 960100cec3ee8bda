// The float32 MultiscaleBlock (K4 in f32, the dtype cli/extract_features.py
// computes in unless told otherwise) for Hopper: 3xTF32 products on wgmma.
// It computes what msblock_math's f32 path computes: LN statistics in f32
// (flax's fast variance clamped at 0, eps 1e-6), f32 products summed in
// f32, the bias and residual adds, the three depthwise (3,3,3) TokenPools
// each with its per-head LN, the pooled attention with the temporal rel-pos
// band (mvit_attention_f32.cu), the exact GELU.
//
// What bounds it: 24 C^2 operations a row for the four products and 6 C a
// key of attention (a stage-3 block at 32 chunks: 314 GFLOP) against a few
// KB of a row moved: operations. On the CUDA cores (67 TFLOP/s in f32) the
// products bound it; on the tensor cores in TF32 (495 TFLOP/s) each runs
// three times (x = hi + lo, hi = rna(x), lo = rna(x - hi); hi.hi + hi.lo +
// lo.hi, lo.lo left out), ~165 TFLOP/s of f32 work at the peak.
//
// Launches, in the bf16 order (mvit_block.cu):
//   1. LN1 row statistics;
//   2. qkv product: LN1 applied to the A operand as it is split;
//   3. the q pool + per-head LN, the (B, N, C) token layout;
//   4. the k / v pools + per-head LN, written as the attention reads them:
//      k split (B nh, T, wd), v split and transposed (B nh, wd, tp), eight
//      keys a warp so a value row takes 16-byte stores, the class key and
//      value f32 (mvit_f32.cuh);
//   5. the attention + q -> the context (B, N, C);
//   6. proj product + bias + x;
//   7. LN2 row statistics;
//   8. fc1 product (LN2 on its A operand) + bias + exact GELU;
//   9. fc2 product + bias + y1.
// The product is K1's f32 mainloop (wgmma.cuh's Tf32Gemm) with A split in
// the consumers: a block of two consumer warpgroups (64 rows each) and a
// producer warp owns 128 rows and BN columns (128, or 96 / 64 where C takes
// no 128); the producer's TMA brings each 32-deep slice of the f32 A tile and
// of the weight's hi and lo parts (split once at packing) into a ring of
// four stages (full / empty mbarriers). Each consumer warpgroup splits its
// 64 rows of the slice in shared memory, normalising them first where the
// product takes an LN (hi over the f32 values in place, lo into a tile of
// its own), then sums hi.lo, lo.hi, hi.hi per stage and adds that stage's
// sum into the accumulators in f32. Splitting in the consumer sends each intermediate
// through device memory once, in f32, where split operands would take
// twice its bytes (the 4C hidden of a stage-2 block at 32 chunks: 805 MB in
// f32). Column tiles are the grid's fastest axis, so the blocks of a row
// tile read its A rows from L2.

#include <cmath>

#include "mvit_f32.cuh"

namespace avdd_mvit {
namespace {

using namespace avdd;

constexpr float LN_EPS = 1e-6f;
constexpr int G_STAGES = 4;
enum { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RES = 2 };

struct Maps { CUtensorMap a, whi, wlo; };
struct Epi {
  const float2* stats; const float* ln;    // row (mean, rsqrt(var + eps)), affine (2, K); LN only
  const float* bias; const float* res; float* out;
  int M, N, K;
};

// K1's 3xTF32 mainloop (wgmma.cuh), A by TMA in f32 and split by the consumers
template <int BN> using Tile = Tf32Gemm<BN, G_STAGES, false>;
constexpr int G_ROWS = Tile<64>::ROWS;       // rows a product block: two consumer warpgroups
constexpr int G_K = Tile<64>::KS;            // contraction values a stage: one 128-byte row
constexpr int G_THREADS = Tile<64>::THREADS; // two consumer warpgroups and a producer warp

// Row statistics of A (M, K) f32: (mean, rsqrt(var + eps)), the fast
// variance clamped at 0. A warp a row, 16-byte loads.
__global__ void __launch_bounds__(256)
ln_stats_f32_kernel(const float* __restrict__ A, float2* __restrict__ stats, int M, int K) {
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const float4* row = reinterpret_cast<const float4*>(A + (size_t)m * K);
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < K / 4; c += 32) {
    const float4 v = row[c];
    s += (v.x + v.y) + (v.z + v.w);
    s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const float mean = s / K;
    stats[m] = make_float2(mean, rsqrtf(fmaxf(s2 / K - mean * mean, 0.f) + LN_EPS));
  }
}

// out[m, n] = epi(sum_k A'[m, k] W[n, k]), A' = A or its row LN (f32).
template <int BN, bool LN, int EPI>
__global__ void __launch_bounds__(G_THREADS, 1)
gemm_f32_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Epi e) {
  using G = Tile<BN>;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t base = (smem_u32(smraw) + 1023u) & ~1023u;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * G_ROWS;
  const int nk = e.K / G_K;
  G::init(base);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {                     // the producer warp: one thread issues the TMA
    if (threadIdx.x == 256)
      G::produce(base, &maps.a, nullptr, &maps.whi, &maps.wlo, 0, m0, n0, nk);
    return;
  }
  // the 16-byte chunk sc of rows sr + 16 i (i < 4) of this warpgroup's 64:
  // what this thread splits each stage
  const int ct = threadIdx.x % 128, sc = ct % 8, sr = ct / 8;
  float2 st[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    st[i] = LN ? e.stats[min(m0 + 64 * wg + sr + 16 * i, e.M - 1)] : make_float2(0.f, 1.f);
  float acc[BN / 2];
  G::consume(base, wg, nk, acc, [&](int kb, uint32_t a_t, uint32_t lo_t) {
    float4 w4 = make_float4(1.f, 1.f, 1.f, 1.f), b4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (LN) {
      w4 = *reinterpret_cast<const float4*>(e.ln + kb * G_K + 4 * sc);
      b4 = *reinterpret_cast<const float4*>(e.ln + e.K + kb * G_K + 4 * sc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off = swz(sr + 16 * i, sc);
      float4 v = ld_shared_v4(a_t + off);
      if (LN) {
        const float mu = st[i].x, rs = st[i].y;
        v.x = (v.x - mu) * (rs * w4.x) + b4.x;
        v.y = (v.y - mu) * (rs * w4.y) + b4.y;
        v.z = (v.z - mu) * (rs * w4.z) + b4.z;
        v.w = (v.w - mu) * (rs * w4.w) + b4.w;
      }
      st_split_v4(a_t + off, lo_t + off, v);
    }
  });

  // epilogue: element (row 16 warp + g + 8 hf, column 8 j + 2 t + e)
  const int warp = ct / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = m0 + 64 * wg + 16 * warp + g + 8 * hf;
    if (m >= e.M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      const size_t o = (size_t)m * e.N + n;
      const float2 bb = *reinterpret_cast<const float2*>(e.bias + n);
      float y0 = acc[4 * j + 2 * hf] + bb.x, y1 = acc[4 * j + 2 * hf + 1] + bb.y;
      if (EPI == EPI_BIAS_GELU) {
        y0 = gelu_erf(y0);
        y1 = gelu_erf(y1);
      } else if (EPI == EPI_BIAS_RES) {
        const float2 r = *reinterpret_cast<const float2*>(e.res + o);
        y0 = r.x + y0;
        y1 = r.y + y1;
      }
      *reinterpret_cast<float2*>(e.out + o) = make_float2(y0, y1);
    }
  }
}

template <int BN, bool LN, int EPI>
int launch_gemm_bn(const float* A, const float* whi, const float* wlo, const Epi& e,
                   cudaStream_t stream) {
  static int configured = 0;
  if (int r = set_smem(gemm_f32_kernel<BN, LN, EPI>, Tile<BN>::SMEM, configured)) return r;
  const long long row_tiles = ((long long)e.M + G_ROWS - 1) / G_ROWS;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  Maps maps;
  const uint64_t ad[2] = {(uint64_t)e.K, (uint64_t)e.M}, wd[2] = {(uint64_t)e.K, (uint64_t)e.N};
  const uint64_t stride[1] = {4ull * e.K};
  const uint32_t abox[2] = {G_K, G_ROWS}, wbox[2] = {G_K, (uint32_t)BN};
  if (int r = f32_tensor_map(&maps.a, A, 2, ad, stride, abox)) return r;
  if (int r = f32_tensor_map(&maps.whi, whi, 2, wd, stride, wbox)) return r;
  if (int r = f32_tensor_map(&maps.wlo, wlo, 2, wd, stride, wbox)) return r;
  gemm_f32_kernel<BN, LN, EPI><<<dim3(e.N / BN, (unsigned)row_tiles), G_THREADS, Tile<BN>::SMEM,
                                 stream>>>(maps, e);
  return (int)cudaGetLastError();
}

// The widest column tile C takes (it then divides 3C and 4C too).
template <bool LN, int EPI>
int launch_gemm(int C, const float* A, const float* whi, const float* wlo, const Epi& e,
                cudaStream_t stream) {
  if (C % 128 == 0) return launch_gemm_bn<128, LN, EPI>(A, whi, wlo, e, stream);
  if (C % 96 == 0) return launch_gemm_bn<96, LN, EPI>(A, whi, wlo, e, stream);
  return launch_gemm_bn<64, LN, EPI>(A, whi, wlo, e, stream);
}

int launch_ln_stats(const float* A, float2* stats, int M, int K, cudaStream_t stream) {
  ln_stats_f32_kernel<<<(M + 7) / 8, 256, 0, stream>>>(A, stats, M, K);
  return (int)cudaGetLastError();
}

// ---- the pools: a warp a task, four channels a lane (16-byte loads) ----------
__device__ __forceinline__ void tap4(float4& y, float4 w, float4 v) {
  y.x = fmaf(w.x, v.x, y.x);
  y.y = fmaf(w.y, v.y, y.y);
  y.z = fmaf(w.z, v.z, y.z);
  y.w = fmaf(w.w, v.w, y.w);
}

// Per-head LN of the d values a warp holds (lanes past d hold zeros), f32
// statistics, the affine at this lane's channels; zeros past d.
__device__ __forceinline__ float4 head_ln4(float4 y, int d, bool act, const float* lw,
                                           const float* lb) {
  const float s = warp_sum((y.x + y.y) + (y.z + y.w));
  const float s2 = warp_sum((y.x * y.x + y.y * y.y) + (y.z * y.z + y.w * y.w));
  if (!act) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float mean = s / d, r = rsqrtf(fmaxf(s2 / d - mean * mean, 0.f) + LN_EPS);
  const float4 w = *reinterpret_cast<const float4*>(lw), b = *reinterpret_cast<const float4*>(lb);
  return make_float4((y.x - mean) * (r * w.x) + b.x, (y.y - mean) * (r * w.y) + b.y,
                     (y.z - mean) * (r * w.z) + b.z, (y.w - mean) * (r * w.w) + b.w);
}

// q pool: depthwise (3,3,3), stride 1, padding 1 over the (T, Hs, Ws) grid
// of head h's q columns of qkv (B, N, 3C); the class token passes through;
// per-head LN -> qp (B, N, C). A warp per (sample, token, head).
__global__ void __launch_bounds__(256)
pool_q_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ taps,
                  const float* __restrict__ pln, float* __restrict__ qp, int B, int Tt, int hs,
                  int ws, int C, int nh) {
  const int d = C / nh, S = hs * ws, N = 1 + Tt * S;
  const long long task = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (task >= (long long)B * N * nh) return;
  const int lane = threadIdx.x % 32, c0 = 4 * lane;
  const bool act = c0 < d;
  const int h = (int)(task % nh), n = (int)((task / nh) % N);
  const long long b = task / ((long long)nh * N);
  const float* base = qkv + (size_t)b * N * 3 * C + h * d + c0;
  float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
  if (act) {
    if (n == 0) {
      y = *reinterpret_cast<const float4*>(base);
    } else {
      const int gi = n - 1, t = gi / S, i = (gi % S) / ws, jw = gi % ws;
      for (int dt = 0; dt < 3; ++dt) {
        const int tt = t + dt - 1;
        if (tt < 0 || tt >= Tt) continue;
        for (int di = 0; di < 3; ++di) {
          const int ii = i + di - 1;
          if (ii < 0 || ii >= hs) continue;
          for (int dj = 0; dj < 3; ++dj) {
            const int jj = jw + dj - 1;
            if (jj < 0 || jj >= ws) continue;
            tap4(y, *reinterpret_cast<const float4*>(taps + ((dt * 3 + di) * 3 + dj) * d + c0),
                 *reinterpret_cast<const float4*>(base + (size_t)(1 + (tt * hs + ii) * ws + jj) *
                                                             3 * C));
          }
        }
      }
    }
  }
  const float4 o = head_ln4(y, d, act, pln + c0, pln + d + c0);
  if (act) *reinterpret_cast<float4*>(qp + ((size_t)b * N + n) * C + h * d + c0) = o;
}

// k / v pools: depthwise (3,3,3), padding 1, a spatial stride that leaves one
// output cell (output (t, 0, 0) reads cells (i, j) in {0, 1}^2 through taps
// (i + 1, j + 1)); per-head LN; k split -> (B nh, T, wd), v split and
// transposed -> (B nh, wd, tp) at f32_key_pos, the class token's k and v f32
// -> kvcls (2, B nh, d); zeros in the padding. A warp per (k or v, sample,
// head, eight output rows r): r < T a grid row, r = T the class token, past
// it a padded key; eight rows, so that a transposed value row takes them as
// two 16-byte stores.
constexpr int KV_ROWS = 8;

__global__ void __launch_bounds__(256)
pool_kv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ taps,
                   const float* __restrict__ pln, float* khi, float* klo, float* vthi,
                   float* vtlo, float* kvcls, int B, int Tt, int hs, int ws, int C, int nh) {
  const int d = C / nh, S = hs * ws, N = 1 + Tt * S;
  const int wd = f32_head_width(d), tp = f32_keys_padded(Tt);
  const int groups = (max(Tt + 1, tp) + KV_ROWS - 1) / KV_ROWS;
  const long long task = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (task >= 2LL * B * nh * groups) return;
  const int r0 = (int)(task % groups) * KV_ROWS;
  long long rest = task / groups;
  const int h = (int)(rest % nh);
  rest /= nh;
  const int b = (int)(rest % B), which = (int)(rest / B);     // 0 k, 1 v
  const long long bh = (long long)b * nh + h;
  const int lane = threadIdx.x % 32, c0 = 4 * lane;
  const bool act = c0 < d;
  const float* base = qkv + (size_t)b * N * 3 * C + (1 + which) * C + h * d + c0;
  const float* tw = taps + (size_t)(1 + which) * 27 * d + c0;
  const float* lw = pln + (size_t)(1 + which) * 2 * d + c0;
  float4 val[KV_ROWS];
#pragma unroll
  for (int u = 0; u < KV_ROWS; ++u) {
    const int r = r0 + u;
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    if (act && r < Tt) {
      for (int dt = 0; dt < 3; ++dt) {
        const int tt = r + dt - 1;
        if (tt < 0 || tt >= Tt) continue;
        for (int i = 0; i < 2 && i < hs; ++i)
          for (int jw = 0; jw < 2 && jw < ws; ++jw)
            tap4(y, *reinterpret_cast<const float4*>(tw + ((dt * 3 + i + 1) * 3 + jw + 1) * d),
                 *reinterpret_cast<const float4*>(base + (size_t)(1 + (tt * hs + i) * ws + jw) *
                                                             3 * C));
      }
    } else if (act && r == Tt) {
      y = *reinterpret_cast<const float4*>(base);
    }
    if (r <= Tt) y = head_ln4(y, d, act, lw, lw + d);     // r is the same across the warp
    if (r == Tt && act)
      *reinterpret_cast<float4*>(kvcls + ((size_t)which * B * nh + bh) * d + c0) = y;
    val[u] = r < Tt ? y : make_float4(0.f, 0.f, 0.f, 0.f);
    if (which == 0 && r < Tt && c0 < wd) {
      uint32_t hh[4], ll[4];
      tf32_split(y.x, hh[0], ll[0]);
      tf32_split(y.y, hh[1], ll[1]);
      tf32_split(y.z, hh[2], ll[2]);
      tf32_split(y.w, hh[3], ll[3]);
      const size_t at = ((size_t)bh * Tt + r) * wd + c0;
      *reinterpret_cast<uint4*>(khi + at) = make_uint4(hh[0], hh[1], hh[2], hh[3]);
      *reinterpret_cast<uint4*>(klo + at) = make_uint4(ll[0], ll[1], ll[2], ll[3]);
    }
  }
  if (which == 0 || c0 >= wd || r0 >= tp) return;
  // v^T: channel c0 + x's eight positions r0 .. r0 + 7 hold rows r0 + 0, 2,
  // 4, 6, 1, 3, 5, 7 (f32_key_pos)
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    uint32_t hh[KV_ROWS], ll[KV_ROWS];
#pragma unroll
    for (int s8 = 0; s8 < KV_ROWS; ++s8) {
      const float4 v4 = val[s8 < 4 ? 2 * s8 : 2 * (s8 - 4) + 1];
      tf32_split(x == 0 ? v4.x : x == 1 ? v4.y : x == 2 ? v4.z : v4.w, hh[s8], ll[s8]);
    }
    const size_t at = ((size_t)bh * wd + c0 + x) * tp + r0;
    *reinterpret_cast<uint4*>(vthi + at) = make_uint4(hh[0], hh[1], hh[2], hh[3]);
    *reinterpret_cast<uint4*>(vthi + at + 4) = make_uint4(hh[4], hh[5], hh[6], hh[7]);
    *reinterpret_cast<uint4*>(vtlo + at) = make_uint4(ll[0], ll[1], ll[2], ll[3]);
    *reinterpret_cast<uint4*>(vtlo + at + 4) = make_uint4(ll[4], ll[5], ll[6], ll[7]);
  }
}

}  // namespace

int msblock_f32(const BlockF32& k, cudaStream_t s) {
  const int S = k.hs * k.ws, N = 1 + k.T * S, M = k.B * N, C = k.C, d = C / k.nh;
  const int wd = f32_head_width(d), tp = f32_keys_padded(k.T), bhn = k.B * k.nh;
  if (d % 4 || k.rel_rows < 2 * k.T - 1) return (int)cudaErrorInvalidValue;
  const size_t C2 = (size_t)C * C;
  const float* w = k.wsplit;
  const float* rel_hi = w + 24 * C2;
  const float* rel_lo = rel_hi + (size_t)k.rel_rows * wd;
  float* khi = k.kvp;
  float* klo = khi + (size_t)bhn * k.T * wd;
  float* vthi = klo + (size_t)bhn * k.T * wd;
  float* vtlo = vthi + (size_t)bhn * wd * tp;
  float* kvcls = vtlo + (size_t)bhn * wd * tp;
  int e;
#define AVDD_STEP(call) if ((e = (call))) return e
  AVDD_STEP(launch_ln_stats(k.x, k.stats, M, C, s));
  AVDD_STEP((launch_gemm<true, EPI_BIAS>(C, k.x, w, w + 3 * C2,
                                         Epi{k.stats, k.ln1, k.bqkv, nullptr, k.qkv, M, 3 * C, C},
                                         s)));
  const long long q_tasks = (long long)M * k.nh;
  const long long kv_tasks = 2LL * bhn * (((k.T + 1 > tp ? k.T + 1 : tp) + KV_ROWS - 1) / KV_ROWS);
  pool_q_f32_kernel<<<(unsigned)((q_tasks + 7) / 8), 256, 0, s>>>(
      k.qkv, k.taps, k.pool_ln, k.qp, k.B, k.T, k.hs, k.ws, C, k.nh);
  AVDD_STEP((int)cudaGetLastError());
  pool_kv_f32_kernel<<<(unsigned)((kv_tasks + 7) / 8), 256, 0, s>>>(
      k.qkv, k.taps, k.pool_ln, khi, klo, vthi, vtlo, kvcls, k.B, k.T, k.hs, k.ws, C, k.nh);
  AVDD_STEP((int)cudaGetLastError());
  AttnF32 a;
  a.q = k.qp; a.qsb = (long long)N * C; a.qsh = d; a.qsn = C;
  a.khi = khi; a.klo = klo; a.vthi = vthi; a.vtlo = vtlo;
  a.kc = kvcls; a.vc = kvcls + (size_t)bhn * d; a.cstride = d;
  a.relhi = rel_hi; a.rello = rel_lo; a.band = nullptr;
  a.out = k.ctx; a.osb = (long long)N * C; a.osh = d; a.osn = C;
  a.nh = k.nh; a.nq = N; a.T = k.T; a.S = S; a.d = d;
  a.flags = PRESCALE | CLS_FIRST | BAND_TABLE;
  a.scale = (float)(1.0 / sqrt((double)d));
  AVDD_STEP(launch_attention_f32(a, k.B, s));
  AVDD_STEP((launch_gemm<false, EPI_BIAS_RES>(C, k.ctx, w + 6 * C2, w + 7 * C2,
                                              Epi{nullptr, nullptr, k.bp, k.x, k.y1, M, C, C},
                                              s)));
  AVDD_STEP(launch_ln_stats(k.y1, k.stats, M, C, s));
  AVDD_STEP((launch_gemm<true, EPI_BIAS_GELU>(
      C, k.y1, w + 8 * C2, w + 12 * C2, Epi{k.stats, k.ln2, k.b1, nullptr, k.hid, M, 4 * C, C},
      s)));
  AVDD_STEP((launch_gemm<false, EPI_BIAS_RES>(
      C, k.hid, w + 16 * C2, w + 20 * C2, Epi{nullptr, nullptr, k.b2, k.y1, k.out, M, C, 4 * C},
      s)));
#undef AVDD_STEP
  return 0;
}

}  // namespace avdd_mvit
