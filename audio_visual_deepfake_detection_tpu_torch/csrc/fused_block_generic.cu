// The fused localizer block (K1 / K6) at every shape of its domain that the
// wgmma instances do not take: head widths D = C / n_head other than 32, 64,
// 96 and 128 (any multiple of 8 from 8 to 512), and C from 1088 to 2048,
// both dtypes, the four modes, any half window or dense attention, any T.
// It computes what the Pallas kernel computes at those shapes
// (audio_visual_deepfake_detection_tpu/ops/pallas/fused_block.py, generated
// per shape by _make_kernel at :224), with the rounding points of the plain
// version block_math (ops/kernels/fused_block.py), operation by operation:
// the LN moments one-pass in bf16 and two-pass in f32, every cdot summed in
// f32 and rounded once to the compute dtype, banded scores from products
// rounded to the compute dtype and the context summed offset by offset in
// it, the f32 softmax, the GELU of the dtype, droppath coefficients
// multiplied into the layer scales in f32 and rounded once.
//
// Design: a simple one, right first. Seven launches through a scratch of
// 7 B T C elements of the compute dtype (generic_scratch_elems):
// - rows: a block a (row, stream): the LN of the input rows the depthwise
//   k3 conv reads, the conv, the mask, the plain LN, into an A operand;
// - q | k | v, proj, fc1, fc2: one CUDA-core GEMM (128 x 128 output
//   tiles, 16-deep slices staged in shared memory as f32, 8 x 8 outputs a
//   thread, f32 FMA sums) with the block's epilogue of each product: bias,
//   q scale, mask, residual and layer scale, GELU;
// - attention: a block per (sample, head, 32 query rows), a warp 4 rows,
//   32-key tiles of k and v staged in shared memory as f32 (k rows padded
//   to D + 4 floats, so the 32 lanes, a key each, read 16 bytes at a time
//   from distinct banks).
//   Pass 1 computes each lane's running maximum and sum of exps over its
//   keys, merged over the warp; pass 2 recomputes the scores, forms the
//   weights as block_math does (dense: e / sum; banded: e x (1 / sum)),
//   rounds them to the compute dtype and hands them by shuffles, in key
//   order, to the lanes that own the context's columns (dense: f32 sums
//   rounded once; banded: the sum rounded to the compute dtype at every
//   offset, as block_math sums it). Keys outside a band, past T or masked
//   weigh exactly what they weigh in block_math.
// - LN of y1 (the proj residual, kept in the output rows) between proj and
//   fc1; fc2's epilogue reads y1 back from the output row it overwrites.
// What bounds it: the CUDA cores. Every product runs at the FMA rate, not
// the tensor cores': 12 C^2 multiply-adds a row, plus 2 (2w + 1) D (banded)
// or 3 T D (dense, both passes and P.V) a row and head.

#include <cmath>

#include "fused_block.cuh"

namespace avdd_k1 {
namespace {

constexpr int GT = 256;                 // threads of every launch here
constexpr int GV = MAX_C_ANY / GT;      // values of a row a thread holds
constexpr int BM = 128, BN = 128, BK = 16;  // GEMM tile and slice
constexpr int AR = 32;                  // attention: query rows a block
constexpr int AK = 32;                  // keys a staged tile
constexpr int RPW = AR / (GT / 32);     // query rows a warp
constexpr int MAX_DV = 16;              // context columns a lane holds: 512 / 32

enum { EPI_QKV = 0, EPI_PROJ = 1, EPI_FC1 = 2, EPI_FC2 = 3 };

template <typename T>
__device__ __forceinline__ float rnd(float v) { return Num<T>::rnd(v); }

template <typename T>
__device__ __forceinline__ float ld(const T* p, size_t i) { return Num<T>::load(p, i); }

// Sum over the block of every thread's v; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                      // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < GT / 32 ? red[lane] : 0.f);
}

// _ln_plain on a row of C values held GV a thread (channel tid + GT j):
// one-pass moments in bf16, two-pass in f32; no affine.
template <bool BF16>
__device__ __forceinline__ void ln_plain(float (&v)[GV], int C, float* red) {
  float s1 = 0.f;
#pragma unroll
  for (int j = 0; j < GV; ++j)
    if (threadIdx.x + GT * j < C) s1 += v[j];
  const float mu = block_sum(s1, red) / C;
  if (BF16) {
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < GV; ++j)
      if (threadIdx.x + GT * j < C) s2 = fmaf(v[j], v[j], s2);
    const float m2 = block_sum(s2, red) / C;
    const float rs = rsqrtf(fmaxf(__fsub_rn(m2, __fmul_rn(mu, mu)), 0.f) + LN_EPS);
#pragma unroll
    for (int j = 0; j < GV; ++j) v[j] = __fsub_rn(__fmul_rn(v[j], rs), __fmul_rn(mu, rs));
  } else {
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < GV; ++j) {
      v[j] = __fsub_rn(v[j], mu);
      if (threadIdx.x + GT * j < C) s2 = fmaf(v[j], v[j], s2);
    }
    const float rs = rsqrtf(block_sum(s2, red) / C + LN_EPS);
#pragma unroll
    for (int j = 0; j < GV; ++j) v[j] = __fmul_rn(v[j], rs);
  }
}

// The A operand of stream `which` (blockIdx.y: 0 q, 1 k, 2 v) at row
// blockIdx.x = b T + t: LN with the stream's affine of the input rows the
// conv reads (zero outside the sequence), the k3 depthwise conv, the mask,
// rounded, the plain LN, rounded (qkv_rows before its products).
template <typename T>
__global__ void __launch_bounds__(GT) rows_kernel(const ParamsG p, T* a3) {
  __shared__ float red[GT / 32];
  constexpr bool BF16 = sizeof(T) == 2;
  const int C = p.C, r = blockIdx.x, which = blockIdx.y, b = r / p.T, t = r % p.T;
  const T* x = static_cast<const T*>(p.x) + (size_t)b * p.T * C;
  const T* xo = static_cast<const T*>(p.xo) + (size_t)b * p.T * C;
  const bool ds = p.mode == MODE_DS_SELF;
  const T* src = x;
  int rw = ROW_LNQ_W;
  if (p.mode == MODE_QV_K || p.mode == MODE_KV) {
    if (which == 1) { rw = ROW_LNK_W; src = xo; }
    if (which == 2) { rw = ROW_LNV_W; if (p.mode == MODE_KV) src = xo; }
  }
  const int tap = ROW_QCONV + 3 * which;
  const float* vecs = p.vecs;
  float y[GV];
#pragma unroll
  for (int j = 0; j < GV; ++j) y[j] = 0.f;
  // input k of the conv, weight tap + k: ds_self odd[t - 1], even[t],
  // odd[t]; otherwise rows t - 1, t, t + 1 of the stream
  for (int k = 0; k < 3; ++k) {
    const T* base = ds ? (k == 1 ? x : xo) : src;
    const int s = ds ? (k == 0 ? t - 1 : t) : t - 1 + k;
    if (s < 0 || s >= p.T) continue;    // a zero row: adds exactly nothing
    float l[GV];
#pragma unroll
    for (int j = 0; j < GV; ++j) {
      const int c = threadIdx.x + GT * j;
      l[j] = c < C ? ld(base, (size_t)s * C + c) : 0.f;
    }
    ln_plain<BF16>(l, C, red);
#pragma unroll
    for (int j = 0; j < GV; ++j) {
      const int c = threadIdx.x + GT * j;
      if (c < C) {
        const float a = rnd<T>(__fadd_rn(__fmul_rn(l[j], vecs[rw * C + c]), vecs[(rw + 1) * C + c]));
        y[j] = __fadd_rn(y[j], __fmul_rn(a, vecs[(tap + k) * C + c]));
      }
    }
  }
  const float mv = p.mask[r] ? 1.f : 0.f;
#pragma unroll
  for (int j = 0; j < GV; ++j) y[j] = rnd<T>(__fmul_rn(y[j], mv));
  ln_plain<BF16>(y, C, red);
  T* dst = a3 + (size_t)which * p.B * p.T * C + (size_t)r * C;
#pragma unroll
  for (int j = 0; j < GV; ++j) {
    const int c = threadIdx.x + GT * j;
    if (c < C) Num<T>::store(dst, c, y[j]);
  }
}

// Plain LN of y1 (the output rows after proj), rounded: fc1's A operand.
template <typename T>
__global__ void __launch_bounds__(GT) ln_kernel(const ParamsG p, T* h) {
  __shared__ float red[GT / 32];
  const int C = p.C;
  const size_t r = blockIdx.x;
  const T* y1 = static_cast<const T*>(p.out) + r * C;
  float v[GV];
#pragma unroll
  for (int j = 0; j < GV; ++j) {
    const int c = threadIdx.x + GT * j;
    v[j] = c < C ? ld(y1, c) : 0.f;
  }
  ln_plain<sizeof(T) == 2>(v, C, red);
#pragma unroll
  for (int j = 0; j < GV; ++j) {
    const int c = threadIdx.x + GT * j;
    if (c < C) Num<T>::store(h + r * C, c, v[j]);
  }
}

struct GemmArgs {
  const void* a[3]; const void* w[3]; void* o[3];   // per blockIdx.z (q, k, v) or [0]
  int M, N, K;
  float qscale;                                     // q's d^-1/2 (EPI_QKV)
};

// o = epilogue(a . w^T): a (M, K) and w (N, K) row-major in the compute
// dtype, sums in f32, each output's over k in order. A block owns a 128 x
// 128 output tile, a thread 8 x 8 of it (rows 4 ty .. and 64 + 4 ty ..,
// columns likewise: the float4 reads of a 16-deep slice hit distinct
// banks); the next slice is fetched into registers while this one is used.
// N is a multiple of 64 and K of 16.
template <typename T, int EPI>
__global__ void __launch_bounds__(GT) gemm_kernel(const ParamsG p, const GemmArgs g) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Ws[2][BK][BN];
  constexpr bool BF16 = sizeof(T) == 2;
  const int z = blockIdx.z;
  const T* A = static_cast<const T*>(g.a[z]);
  const T* W = static_cast<const T*>(g.w[z]);
  T* O = static_cast<T*>(g.o[z]);
  const int M = g.M, N = g.N, K = g.K;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // this thread's 8 loads of each slice from a and from w: row lr, depth
  // lk .. lk + 7 (zeros past M and N)
  const int lr = tid / 2, lk = 8 * (tid % 2);
  const bool arow = m0 + lr < M, wrow = n0 + lr < N;
  const T* ap = A + (size_t)(arow ? m0 + lr : 0) * K + lk;
  const T* wp = W + (size_t)(wrow ? n0 + lr : 0) * K + lk;
  float ra[8], rw[8];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ra[i] = arow ? ld(ap, k0 + i) : 0.f;
      rw[i] = wrow ? ld(wp, k0 + i) : 0.f;
    }
  };
  auto put = [&](int s) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      As[s][lk + i][lr] = ra[i];
      Ws[s][lk + i][lr] = rw[i];
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  fetch(0);
  put(0);
  __syncthreads();
  const int nk = K / BK;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb & 1;
    if (kb + 1 < nk) fetch((kb + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[s][k][64 + 4 * ty]);
      const float4 w0 = *reinterpret_cast<const float4*>(&Ws[s][k][4 * tx]);
      const float4 w1 = *reinterpret_cast<const float4*>(&Ws[s][k][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    if (kb + 1 < nk) put(s ^ 1);        // the other buffer: last read before the barrier above
    __syncthreads();
  }

  const int C = p.C;
  const float* vecs = p.vecs;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
    const int b = m / p.T, t = m % p.T;
    const float mv = p.mask[m] ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n >= N) continue;
      const size_t at = (size_t)m * N + n;
      const float c = rnd<T>(acc[i][j]);
      float y;
      if (EPI == EPI_QKV) {
        y = rnd<T>(c + rnd<T>(vecs[(ROW_Q_BIAS + z) * C + n]));
        if (z == 0) y = rnd<T>(y * rnd<T>(g.qscale));
      } else if (EPI == EPI_PROJ) {
        const T* x = static_cast<const T*>(p.x);
        float att = rnd<T>(c + rnd<T>(vecs[ROW_P_BIAS * C + n]));
        att = rnd<T>(att * mv);
        float skip = ld(x, at);
        if (p.mode == MODE_DS_SELF) {   // MaxPool(3, 2, 1) over odd[t - 1], even[t], odd[t]
          const T* xo = static_cast<const T*>(p.xo);
          const float xe = skip, xd = ld(xo, at);
          const float om1 = t == 0 ? -CUDART_INF_F : ld(xo, at - C);
          skip = om1 >= fmaxf(xe, xd) ? om1 : (xe >= xd ? xe : xd);
        }
        const float coef = p.coefs ? p.coefs[2 * b] : 1.f;
        const float sa = rnd<T>(__fmul_rn(vecs[ROW_SCALE_ATTN * C + n], coef));
        y = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(skip, mv)), rnd<T>(__fmul_rn(att, sa))));
      } else if (EPI == EPI_FC1) {
        y = rnd<T>(gelu<BF16>(rnd<T>(c + rnd<T>(p.fc1b[n]))));
      } else {
        float h = rnd<T>(c + rnd<T>(vecs[ROW_FC2_BIAS * C + n]));
        h = rnd<T>(h * mv);
        const float coef = p.coefs ? p.coefs[2 * b + 1] : 1.f;
        const float sm = rnd<T>(__fmul_rn(vecs[ROW_SCALE_MLP * C + n], coef));
        y = rnd<T>(__fadd_rn(ld(O, at), rnd<T>(__fmul_rn(h, sm))));   // O holds y1
      }
      Num<T>::store(O, at, y);
    }
  }
}

// attention_ctx of block_math for 32 query rows of one (sample, head): q,
// k, v the three (B, T, C) planes of `qkv`, the context into `ctx`.
template <typename T, bool DENSE>
__global__ void __launch_bounds__(GT) attend_kernel(const ParamsG p, const T* qkv, T* ctx) {
  extern __shared__ __align__(16) float att_sm[];
  const int D = p.D, C = p.C, Tn = p.T, w = p.w;
  const int nrt = (Tn + AR - 1) / AR;
  const int bh = blockIdx.x / nrt, b = bh / p.NH, h = bh % p.NH;
  const int r0 = (blockIdx.x % nrt) * AR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int KS = D + 4;                  // k row stride: float4 reads by the 32 lanes,
                                         // a key each, fall in distinct banks (D % 8 == 0)
  float* qs = att_sm;                       // AR x D
  float* ks = qs + AR * D;               // AK x KS
  float* vs = ks + AK * KS;              // AK x D
  float* kinfo = vs + AK * D;            // AK: dense 1 / 0 valid key; banded the penalty
  const size_t plane = (size_t)p.B * Tn * C;
  const T* q = qkv + (size_t)b * Tn * C + h * D;
  const T* k = q + plane;
  const T* v = k + plane;
  const uint8_t* mrow = p.mask + (size_t)b * Tn;
  for (int i = threadIdx.x; i < AR * D; i += GT) {
    const int r = i / D, c = i % D;
    qs[i] = r0 + r < Tn ? ld(q, (size_t)(r0 + r) * C + c) : 0.f;
  }
  const int k_lo = DENSE ? 0 : max(r0 - w, 0);
  const int k_hi = DENSE ? Tn : min(r0 + AR - 1 + w + 1, Tn);
  const float fill = rnd<T>(NEG_INF);
  // stage keys k0 .. k0 + AK - 1 (v too in pass 2); past k_hi: zeros
  auto stage = [&](int k0, bool with_v) {
    __syncthreads();
    for (int i = threadIdx.x; i < AK * D; i += GT) {
      const int r = i / D, c = i % D, key = k0 + r;
      const bool in = key < k_hi;
      ks[r * KS + c] = in ? ld(k, (size_t)key * C + c) : 0.f;
      if (with_v) {
        const float vv = in ? ld(v, (size_t)key * C + c) : 0.f;
        vs[i] = DENSE && in && !mrow[key] ? 0.f : vv;   // dense: v * mask
      }
    }
    if (threadIdx.x < AK) {
      const int key = k0 + threadIdx.x;
      const float ok = key < k_hi && mrow[key] ? 1.f : 0.f;
      kinfo[threadIdx.x] = DENSE ? ok : rnd<T>(__fmul_rn(ok - 1.f, NEG_PENALTY));
    }
    __syncthreads();
  };
  // this lane's key k0 + lane against the warp's rows: the score, or -inf
  // where the key is not one the row attends
  auto scores = [&](int k0, float (&s)[RPW]) {
    const float4* kr = reinterpret_cast<const float4*>(ks + lane * KS);
    const float4* qr = reinterpret_cast<const float4*>(qs + warp * RPW * D);
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    auto add = [&](float& acc, float a, float b) {
      acc = DENSE ? fmaf(a, b, acc) : __fadd_rn(acc, rnd<T>(__fmul_rn(a, b)));
    };
#pragma unroll 2
    for (int c4 = 0; c4 < D / 4; ++c4) {        // channels 4 c4 .. 4 c4 + 3, in order
      const float4 kv = kr[c4];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv = qr[r * (D / 4) + c4];
        add(s[r], qv.x, kv.x);
        add(s[r], qv.y, kv.y);
        add(s[r], qv.z, kv.z);
        add(s[r], qv.w, kv.w);
      }
    }
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = r0 + warp * RPW + r;
      const bool att = i < Tn && key < k_hi && (DENSE || (key >= i - w && key <= i + w));
      float sc;
      if (DENSE) sc = kinfo[lane] > 0.f ? rnd<T>(s[r]) : fill;
      else sc = rnd<T>(rnd<T>(s[r]) + kinfo[lane]);
      s[r] = att ? sc : -CUDART_INF_F;
    }
  };

  // pass 1: each lane's running maximum and sum of exps, then the warp's
  float mx[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) { mx[r] = -CUDART_INF_F; l[r] = 0.f; }
  for (int k0 = k_lo; k0 < k_hi; k0 += AK) {
    stage(k0, false);
    float s[RPW];
    scores(k0, s);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (s[r] == -CUDART_INF_F) continue;
      if (s[r] > mx[r]) { l[r] = l[r] * expf(mx[r] - s[r]) + 1.f; mx[r] = s[r]; }
      else l[r] += expf(s[r] - mx[r]);
    }
  }
  float inv[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const float m = warp_max(mx[r]);
    const float part = mx[r] == -CUDART_INF_F ? 0.f : l[r] * expf(mx[r] - m);
    l[r] = warp_sum(part);
    mx[r] = m;
    inv[r] = 1.f / l[r];
  }

  // pass 2: the weights in the compute dtype, the context column by column
  float acc[RPW][MAX_DV];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < MAX_DV; ++j) acc[r][j] = 0.f;
  for (int k0 = k_lo; k0 < k_hi; k0 += AK) {
    stage(k0, true);
    float s[RPW];
    scores(k0, s);
    float pw[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float e = s[r] == -CUDART_INF_F ? 0.f : expf(s[r] - mx[r]);
      pw[r] = rnd<T>(DENSE ? e / l[r] : __fmul_rn(e, inv[r]));
    }
    const int nkeys = min(AK, k_hi - k0);
    for (int j = 0; j < nkeys; ++j) {
      float vv[MAX_DV];                 // key j's values in this lane's columns
#pragma unroll
      for (int jj = 0; jj < MAX_DV; ++jj) {
        const int c = lane + 32 * jj;
        vv[jj] = 32 * jj < D && c < D ? vs[j * D + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(0xffffffffu, pw[r], j);
#pragma unroll
        for (int jj = 0; jj < MAX_DV; ++jj) {
          if (32 * jj < D) {
            if (DENSE) acc[r][jj] = fmaf(pj, vv[jj], acc[r][jj]);
            else acc[r][jj] = rnd<T>(__fadd_rn(acc[r][jj], rnd<T>(__fmul_rn(pj, vv[jj]))));
          }
        }
      }
    }
  }
  T* out = ctx + (size_t)b * Tn * C + h * D;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = r0 + warp * RPW + r;
    if (i >= Tn) continue;
    const float mv = mrow[i] ? 1.f : 0.f;
#pragma unroll
    for (int jj = 0; jj < MAX_DV; ++jj) {
      const int c = lane + 32 * jj;
      if (32 * jj < D && c < D)
        Num<T>::store(out, (size_t)i * C + c, rnd<T>(__fmul_rn(rnd<T>(acc[r][jj]), mv)));
    }
  }
}

template <typename T, int EPI>
int gemm(const ParamsG& p, const GemmArgs& g, int nz, cudaStream_t s) {
  const dim3 grid((unsigned)((g.M + BM - 1) / BM), (unsigned)((g.N + BN - 1) / BN),
                  (unsigned)nz);
  gemm_kernel<T, EPI><<<grid, GT, 0, s>>>(p, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const ParamsG& p, T* scratch, cudaStream_t s) {
  const long long R = (long long)p.B * p.T, RC = R * p.C;
  T* a3 = scratch;                 // 3 R C: the streams' A operands
  T* qkv = a3 + 3 * RC;            // 3 R C: q (scaled), k, v
  T* ctx = qkv + 3 * RC;           // R C: the context, then LN(y1)
  T* hid = scratch;                // R 4C over a3 | q | k once attention is done
  T* out = static_cast<T*>(p.out);
  int e;
  rows_kernel<T><<<dim3((unsigned)R, 3), GT, 0, s>>>(p, a3);
  if ((e = (int)cudaGetLastError())) return e;
  GemmArgs g{};
  g.M = (int)R;
  g.N = p.C;
  g.K = p.C;
  g.qscale = (float)(1.0 / std::sqrt((double)p.D));
  for (int z = 0; z < 3; ++z) {
    g.a[z] = a3 + z * RC;
    g.w[z] = p.wt[z];
    g.o[z] = qkv + z * RC;
  }
  if ((e = gemm<T, EPI_QKV>(p, g, 3, s))) return e;
  const int smem = (int)((AR * p.D + AK * (p.D + 4) + AK * p.D + AK) * sizeof(float));
  const unsigned nblk = (unsigned)((long long)p.B * p.NH * ((p.T + AR - 1) / AR));
  if (p.w <= 0) {
    static int configured = 0;
    if ((e = set_smem(attend_kernel<T, true>, smem, configured))) return e;
    attend_kernel<T, true><<<nblk, GT, smem, s>>>(p, qkv, ctx);
  } else {
    static int configured = 0;
    if ((e = set_smem(attend_kernel<T, false>, smem, configured))) return e;
    attend_kernel<T, false><<<nblk, GT, smem, s>>>(p, qkv, ctx);
  }
  if ((e = (int)cudaGetLastError())) return e;
  g.a[0] = ctx; g.w[0] = p.wt[3]; g.o[0] = out;
  if ((e = gemm<T, EPI_PROJ>(p, g, 1, s))) return e;
  ln_kernel<T><<<(unsigned)R, GT, 0, s>>>(p, ctx);
  if ((e = (int)cudaGetLastError())) return e;
  g.a[0] = ctx; g.w[0] = p.wt[4]; g.o[0] = hid; g.N = 4 * p.C;
  if ((e = gemm<T, EPI_FC1>(p, g, 1, s))) return e;
  g.a[0] = hid; g.w[0] = p.wt[5]; g.o[0] = out; g.N = p.C; g.K = 4 * p.C;
  return gemm<T, EPI_FC2>(p, g, 1, s);
}

}  // namespace

int launch_generic(const ParamsG& p, void* scratch, int dtype, cudaStream_t stream) {
  if ((long long)p.B * p.T > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return dtype == 1 ? launch_t(p, static_cast<__nv_bfloat16*>(scratch), stream)
                    : launch_t(p, static_cast<float*>(scratch), stream);
}

}  // namespace avdd_k1
