// Fused localizer transformer block for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel audio_visual_deepfake_detection_tpu/ops/pallas/
// fused_block.py::fused_transformer_block (pl.pallas_call at :535), and with
// it the forward of fused_transformer_block_train (:753), which is the same
// kernel given per-sample droppath coefficients. One launch computes a whole
// block of the HRLR backbone:
//   pre-LN -> depthwise k3 convs -> plain LN (affines folded into the dense
//   weights by pack_block_params) -> q/k/v dense -> banded (2w+1 offsets) or
//   dense attention -> proj -> layer-scaled residual -> LN -> GELU MLP (4C)
//   -> layer-scaled residual,
// each layer scale multiplied by the sample's droppath coefficient of that
// branch (coefs (B, 2) f32 in {0, 1/keep}; a null pointer means 1, the eval
// launch): the product is taken in f32 and rounded once to the compute dtype,
// as block_math does. The backward of the training path is not a kernel: it
// differentiates block_math from the saved inputs, as the JAX package does.
// The modes are self, qv_k, kv (cross-modal k/v stream) and ds_self (stride 2:
// the caller passes even/odd rows; the stride-2 depthwise conv and the
// MaxPool(3,2,1) skip are composed from them). Numerics follow the plain
// version block_math in ops/kernels/fused_block.py: products accumulate in
// f32 and round to the compute dtype where the JAX kernel rounds, LN moments
// are one-pass in bf16 and two-pass in f32, softmax is f32.
//
// What bounds it on this card: at B=512, T=768 one block is ~0.6 TFLOP of
// matrix products (q/k/v/proj 4 x C^2, MLP 8 x C^2 per row) against ~0.4 GB
// of HBM traffic (read x and xo, write y), ~1500 FLOP/byte, far above the
// H100's ridge; the weights (1.5 MB bf16) stay in L2. So it is compute-bound
// once the products run on the tensor cores. This version is bound by
// neither yet: on an H100 SXM (700 W) a full-T block at B=512 in bf16 takes
// ~20 ms, ~31 TFLOP/s; each 16-row tile streams the whole 1.5 MB of weights
// from L2 through one 8-warp block per SM, with no prefetch.
//
// What this first design does about it: every intermediate stays in shared
// memory (no HBM round trips between the ten steps; the XLA path of the JAX
// package moved ~2.7 GB per block), one thread block per (sample, tile of 16
// query rows) with a halo of w+1 input rows each side (attention needs +-w
// k/v rows, each of which needs +-1 conv rows). In bf16 the six products
// run on the tensor cores (mma.sync m16n8k16, f32 accumulate, A fragments
// from shared memory, B fragments straight from L2); in f32 they are a
// register-tiled FMA loop, to keep full f32 precision. Both read the dense
// weights in torch's (out, in) layout, K-contiguous. Not yet done: wgmma,
// TMA-staged weights, larger tiles (shared memory caps a tile at 16 rows
// with f32 intermediates), more than one block per SM.
// Dense attention (window -1, T=24 at production) takes one of two paths:
// - T <= DENSE_MAX_T (31): the whole sequence in one thread block, one key
//   per lane (one launch);
// - any longer T (over-length eval inputs, e.g. T = 48 for a 1536-step
//   video): two launches over tiles of TQ_BAND query rows. Phase 1 computes
//   each tile's k and v rows (LN, conv, LN, dense; the same arithmetic as the
//   whole-sequence path) into a (B, T, 2C) scratch in the compute dtype,
//   whose values are already rounded to it. Phase 2 computes the tile's q
//   and attends each (row, head) warp to all T keys from the scratch in
//   three passes (row max, sum of exps, P.V), recomputing the scores, so the
//   rounding points of block_math stay and shared memory does not grow with T.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int C = 256;          // channels
constexpr int NH = 4;           // heads
constexpr int D = C / NH;       // head width (64: two channels per lane)
constexpr int NT = 256;         // threads per block
constexpr int NWARP = NT / 32;
// Shared row strides (floats): even, so mma A fragments load as float2, and
// = 8 mod 32, so a half-warp's fragment loads hit 32 distinct banks.
constexpr int LD = C + 8;
constexpr int LDH = 4 * C + 8;  // MLP hidden row stride
constexpr int TQ_BAND = 16;     // query rows per block, banded attention
constexpr int BAND_MAX_W = 8;   // largest half window, banded attention
constexpr int DENSE_MAX_T = 31; // whole-sequence rows, dense attention: one
                                // key per lane, and 32 rows would need more
                                // than SMEM_MAX (static_assert below); longer
                                // T takes the tiled two-phase path
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr float LN_EPS = 1e-5f;
constexpr float NEG_INF = -1e30f;
constexpr float NEG_PENALTY = 1e4f;

enum {
  ROW_LNQ_W = 0, ROW_LNQ_B = 1, ROW_LNK_W = 2, ROW_LNK_B = 3,
  ROW_LNV_W = 4, ROW_LNV_B = 5, ROW_QCONV = 6, ROW_KCONV = 9, ROW_VCONV = 12,
  ROW_Q_BIAS = 15, ROW_K_BIAS = 16, ROW_V_BIAS = 17, ROW_P_BIAS = 18,
  ROW_SCALE_ATTN = 19, ROW_FC2_BIAS = 20, ROW_SCALE_MLP = 21
};
enum { MODE_SELF = 0, MODE_QV_K = 1, MODE_KV = 2, MODE_DS_SELF = 3 };
// PHASE_WHOLE: one launch does everything; PHASE_KV / PHASE_ATTN: the two
// launches of the tiled dense path
enum { PHASE_WHOLE = 0, PHASE_KV = 1, PHASE_ATTN = 2 };

template <typename T> struct Num;
template <> struct Num<float> {
  static constexpr bool kBf16 = false;
  __device__ __forceinline__ static float load(const float* p, size_t i) { return __ldg(p + i); }
  __device__ __forceinline__ static float rnd(float v) { return v; }
  __device__ __forceinline__ static void store(float* p, size_t i, float v) { p[i] = v; }
};
template <> struct Num<__nv_bfloat16> {
  static constexpr bool kBf16 = true;
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

struct Params {
  const void* x;        // (B, T, C) compute dtype (ds_self: even rows)
  const void* xo;       // (B, T, C) other stream (ds_self: odd rows)
  const uint8_t* mask;  // (B, T) bool
  const float* vecs;    // (22, C) packed vectors
  // dense weights, (out, in) row-major in the compute dtype
  const void* wq; const void* wk; const void* wv; const void* wp;  // (C, C)
  const void* wf1;      // (4C, C)
  const void* wf2;      // (C, 4C)
  const float* fc1b;    // (4C,)
  void* out;            // (B, T, C)
  void* kv;             // (B, T, 2C) k | v scratch of the tiled dense path
  const float* coefs;   // (B, 2) droppath coefficients (attn, mlp), or null = 1
  int T, w, mode, tq;   // w: half window (0 = dense); tq: query rows per block
  int phase;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Plain LN of one row held by a warp (lane owns channels lane + 32 i):
// writes the normalized values back into v.
template <bool BF16>
__device__ __forceinline__ void ln_plain_row(float (&v)[C / 32]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) s += v[i];
  const float mu = warp_sum(s) / C;
  if (BF16) {  // one-pass moments, as the JAX kernel in bf16
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) s2 += v[i] * v[i];
    const float m2 = warp_sum(s2) / C;
    const float rs = rsqrtf(fmaxf(m2 - mu * mu, 0.f) + LN_EPS);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) v[i] = v[i] * rs - mu * rs;
  } else {     // two-pass in f32
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) { const float r = v[i] - mu; s2 += r * r; }
    const float rs = rsqrtf(warp_sum(s2) / C + LN_EPS);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) v[i] = (v[i] - mu) * rs;
  }
}

// f32 erf as the Eigen rational approximation (JAX fused_block._erf).
__device__ __forceinline__ float erf_rational(float x) {
  x = fminf(fmaxf(x, -4.f), 4.f);
  const float x2 = x * x;
  float a = -2.72614225801306e-10f;
  a = a * x2 + 2.77068142495902e-08f;
  a = a * x2 + -2.10102402082508e-06f;
  a = a * x2 + -5.69250639462346e-05f;
  a = a * x2 + -7.34990630326855e-04f;
  a = a * x2 + -2.95459980854025e-03f;
  a = a * x2 + -1.60960333262415e-02f;
  float b = -1.45660718464996e-05f;
  b = b * x2 + -2.13374055278905e-04f;
  b = b * x2 + -1.68282697438203e-03f;
  b = b * x2 + -7.37332916720468e-03f;
  b = b * x2 + -1.42647390514189e-02f;
  return x * a / b;
}

template <bool BF16>
__device__ __forceinline__ float gelu(float x) {
  if (BF16) {  // division-free polynomial (JAX fused_block._gelu_cheap)
    const float xc = fminf(fmaxf(x, -4.f), 4.f);
    const float t = xc * xc * 0.125f + -1.f;
    float p = -0.007718835957348347f;
    p = p * t + 0.023225031793117523f;
    p = p * t + -0.03750486299395561f;
    p = p * t + 0.06115540862083435f;
    p = p * t + -0.10322453081607819f;
    p = p * t + 0.1585356444120407f;
    p = p * t + -0.23859895765781403f;
    p = p * t + 0.49765539169311523f;
    return 0.5f * x + 0.35355339059327373f * x * (xc * p);
  }
  return 0.5f * x * (1.f + erf_rational(x * 0.7071067811865476f));
}

// f32 products, register-tiled FMA: out[m, n] = sum_k A[m, k] Wt[n, k] for
// m < M, n < N; A in shared memory (row stride lda), Wt (N, K) row-major in
// global memory. Thread t owns rows m0 + t/64 + 4i and columns n0 + t%64 + 64j
// (i, j < 4): a warp shares its rows (A is a broadcast) and each thread reads
// its W rows four k at a time (float4), summing k in order.
template <typename Epi>
__device__ __forceinline__ void gemm_fma(const float* A, int lda, int M, int K,
                                         const float* __restrict__ Wt, int N,
                                         Epi epi) {
  const int rg = threadIdx.x >> 6;
  const int c0 = threadIdx.x & 63;
  for (int n0 = 0; n0 < N; n0 += 256) {
    for (int m0 = 0; m0 < M; m0 += 16) {
      float acc[4][4];
      const float* arow[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        arow[i] = A + min(m0 + rg + 4 * i, M - 1) * lda;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      const float* wrow[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wrow[j] = Wt + (size_t)(n0 + c0 + 64 * j) * K;
      for (int k = 0; k < K; k += 4) {
        float4 wv[4], av[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = __ldg(reinterpret_cast<const float4*>(wrow[j] + k));
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(arow[i] + k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = acc[i][j];
            a = fmaf(av[i].x, wv[j].x, a);
            a = fmaf(av[i].y, wv[j].y, a);
            a = fmaf(av[i].z, wv[j].z, a);
            acc[i][j] = fmaf(av[i].w, wv[j].w, a);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + rg + 4 * i;
        if (m < M) {
#pragma unroll
          for (int j = 0; j < 4; ++j) epi(m, n0 + c0 + 64 * j, acc[i][j]);
        }
      }
    }
  }
}

// bf16 products on the tensor cores: out[m, n] = sum_k A[m, k] Wt[n, k],
// A in shared memory (f32 holding bf16 values, so the conversion is exact),
// Wt (N, K) bf16 in global memory (K-contiguous: the mma B fragments). Warp w
// owns columns [w N/8, (w+1) N/8) in chunks of 32 (four n8 tiles) and all
// rows in passes of 32 (two m16 tiles); mma.sync m16n8k16, f32 accumulate.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename Epi>
__device__ __forceinline__ void gemm_mma(const float* A, int lda, int M, int K,
                                         const __nv_bfloat16* __restrict__ Wt,
                                         int N, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ncols = N / NWARP;
  for (int nc = 0; nc < ncols; nc += 32) {
    const int nbase = warp * ncols + nc;
    for (int m0 = 0; m0 < M; m0 += 32) {
      const bool two = m0 + 16 < M;          // second m16 tile has rows
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
      const float* arow[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        arow[mt][0] = A + min(m0 + 16 * mt + g, M - 1) * lda + 2 * t;
        arow[mt][1] = A + min(m0 + 16 * mt + g + 8, M - 1) * lda + 2 * t;
      }
      const __nv_bfloat16* wrow[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) wrow[nt] = Wt + (size_t)(nbase + 8 * nt + g) * K + 2 * t;
      for (int k0 = 0; k0 < K; k0 += 16) {
        uint32_t b[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          b[nt][0] = __ldg(reinterpret_cast<const unsigned int*>(wrow[nt] + k0));
          b[nt][1] = __ldg(reinterpret_cast<const unsigned int*>(wrow[nt] + k0 + 8));
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt == 1 && !two) break;
          const float2 x0 = *reinterpret_cast<const float2*>(arow[mt][0] + k0);
          const float2 x1 = *reinterpret_cast<const float2*>(arow[mt][1] + k0);
          const float2 x2 = *reinterpret_cast<const float2*>(arow[mt][0] + k0 + 8);
          const float2 x3 = *reinterpret_cast<const float2*>(arow[mt][1] + k0 + 8);
          const uint32_t a[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                                 pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r = m0 + 16 * mt + g, n = nbase + 8 * nt + 2 * t;
          if (r < M) { epi(r, n, acc[mt][nt][0]); epi(r, n + 1, acc[mt][nt][1]); }
          if (r + 8 < M) { epi(r + 8, n, acc[mt][nt][2]); epi(r + 8, n + 1, acc[mt][nt][3]); }
        }
      }
    }
  }
}

// Products of the block, W (N, K) in both dtypes: tensor cores in bf16,
// register-tiled FMA in f32 (full f32 precision).
template <typename T, typename Epi>
__device__ __forceinline__ void block_gemm(const float* A, int lda, int M, int K,
                                           const void* W, int N, Epi epi) {
  if constexpr (Num<T>::kBf16)
    gemm_mma(A, lda, M, K, static_cast<const __nv_bfloat16*>(W), N, epi);
  else
    gemm_fma(A, lda, M, K, static_cast<const float*>(W), N, epi);
}

struct Layout {   // shared-memory carve-up, in floats
  int hw = 0, nkv = 0, nin = 0, mask_f = 0, r1_f = 0, r2_f = 0;
  __host__ __device__ constexpr Layout(int tq, int w) {
    hw = w > 0 ? w : 0;
    nkv = tq + 2 * hw;          // k/v rows (query tile + halo)
    nin = nkv + 2;              // input rows (+-1 for the depthwise conv)
    mask_f = (nin + 3) & ~3;
    int a = 3 * nin * LD, b = (tq + 2 * nkv) * LD, c = tq * LDH;
    r1_f = a > b ? a : b;
    r1_f = r1_f > c ? r1_f : c;
    r2_f = (tq + 2 * nkv) * LD;
  }
  __host__ __device__ constexpr int bytes() const { return 4 * (mask_f + r1_f + r2_f); }
};
static_assert(Layout(DENSE_MAX_T, 0).bytes() <= SMEM_MAX, "dense tile over SMEM_MAX");
static_assert(Layout(TQ_BAND, BAND_MAX_W).bytes() <= SMEM_MAX, "band tile over SMEM_MAX");

template <typename T>
__global__ void __launch_bounds__(NT)
fused_block_kernel(Params p) {
  using N = Num<T>;
  constexpr bool BF16 = N::kBf16;
  extern __shared__ __align__(16) float smem[];
  const int T_ = p.T, TQ = p.tq, mode = p.mode;
  const Layout lay(TQ, p.w);
  const int hw = lay.hw, NKV = lay.nkv, NIN = lay.nin;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TQ;          // first query row of this tile
  const int in0 = r0 - hw - 1;             // seq row of input row 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* vecs = p.vecs;
  const T* x = static_cast<const T*>(p.x) + (size_t)b * T_ * C;
  const T* xo = static_cast<const T*>(p.xo) + (size_t)b * T_ * C;
  const float coef_attn = p.coefs ? p.coefs[2 * b] : 1.f;
  const float coef_mlp = p.coefs ? p.coefs[2 * b + 1] : 1.f;

  float* maskf = smem;                     // [NIN] 1 valid / 0 masked or outside
  float* R1 = smem + lay.mask_f;
  float* R2 = R1 + lay.r1_f;
  float* L0 = R1;                          // LN'd streams, NIN rows each
  float* L1 = R1 + NIN * LD;
  float* L2 = R1 + 2 * NIN * LD;

  // ---- 1. pre-LN of the input rows (zero outside the sequence) ----------
  for (int j = threadIdx.x; j < NIN; j += NT) {
    const int s = in0 + j;
    maskf[j] = (s >= 0 && s < T_ && p.mask[(size_t)b * T_ + s]) ? 1.f : 0.f;
  }
  for (int j = warp; j < NIN; j += NWARP) {
    const int s = in0 + j;
    const bool in = s >= 0 && s < T_;
    float vx[C / 32], vo[C / 32];
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      vx[i] = in ? N::load(x, (size_t)s * C + lane + 32 * i) : 0.f;
      vo[i] = (in && mode != MODE_SELF) ? N::load(xo, (size_t)s * C + lane + 32 * i) : 0.f;
    }
    if (in) {
      ln_plain_row<BF16>(vx);
      if (mode != MODE_SELF) ln_plain_row<BF16>(vo);
    }
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      const float z = in ? 1.f : 0.f;   // rows outside the sequence stay 0
      const float* v = vecs;
      L0[j * LD + c] = z * N::rnd(vx[i] * v[ROW_LNQ_W * C + c] + v[ROW_LNQ_B * C + c]);
      if (mode == MODE_DS_SELF) {
        L1[j * LD + c] = z * N::rnd(vo[i] * v[ROW_LNQ_W * C + c] + v[ROW_LNQ_B * C + c]);
      } else if (mode != MODE_SELF) {
        L1[j * LD + c] = z * N::rnd(vo[i] * v[ROW_LNK_W * C + c] + v[ROW_LNK_B * C + c]);
        const float vv = mode == MODE_QV_K ? vx[i] : vo[i];
        L2[j * LD + c] = z * N::rnd(vv * v[ROW_LNV_W * C + c] + v[ROW_LNV_B * C + c]);
      }
    }
  }
  __syncthreads();

  // ---- 2. depthwise k3 conv (masked) + plain LN -> PQ, PK, PV -----------
  float* PQ = R2;
  float* PK = R2 + TQ * LD;
  float* PV = R2 + (TQ + NKV) * LD;
  const int ntask = p.phase == PHASE_ATTN ? TQ : TQ + 2 * NKV;
  for (int task = warp; task < ntask; task += NWARP) {
    int which, i;                          // 0 q, 1 k, 2 v; kv-local row i
    if (task < TQ) { which = 0; i = task + hw; }
    else if (task < TQ + NKV) { which = 1; i = task - TQ; }
    else { which = 2; i = task - TQ - NKV; }
    const int row0 = which == 0 ? ROW_QCONV : (which == 1 ? ROW_KCONV : ROW_VCONV);
    const int jc = i + 1;                  // input row of the conv centre
    const float mv = maskf[jc];
    const float* src = (mode == MODE_SELF || which == 0) ? L0 : (which == 1 ? L1 : L2);
    float y[C / 32];
#pragma unroll
    for (int k = 0; k < C / 32; ++k) {
      const int c = lane + 32 * k;
      const float w0 = vecs[row0 * C + c], w1 = vecs[(row0 + 1) * C + c],
                  w2 = vecs[(row0 + 2) * C + c];
      float acc;
      if (mode == MODE_DS_SELF)   // y[i] = w0 odd[i-1] + w1 even[i] + w2 odd[i]
        acc = L1[(jc - 1) * LD + c] * w0 + L0[jc * LD + c] * w1 + L1[jc * LD + c] * w2;
      else
        acc = src[(jc - 1) * LD + c] * w0 + src[jc * LD + c] * w1 + src[(jc + 1) * LD + c] * w2;
      y[k] = N::rnd(acc * mv);
    }
    ln_plain_row<BF16>(y);
    float* dst = which == 0 ? PQ + (i - hw) * LD : (which == 1 ? PK : PV) + i * LD;
#pragma unroll
    for (int k = 0; k < C / 32; ++k) dst[lane + 32 * k] = N::rnd(y[k]);
  }
  __syncthreads();

  // ---- 3. q/k/v dense -----------------------------------------------------
  float* Qd = R1;
  float* Kd = R1 + TQ * LD;
  float* Vd = R1 + (TQ + NKV) * LD;
  const float qscale = N::rnd(1.f / sqrtf((float)D));
  if (p.phase != PHASE_KV)
    block_gemm<T>(PQ, LD, TQ, C, p.wq, C,
            [&](int m, int n, float acc) {
              const float q = N::rnd(N::rnd(acc) + N::rnd(vecs[ROW_Q_BIAS * C + n]));
              Qd[m * LD + n] = N::rnd(q * qscale);
            });
  if (p.phase != PHASE_ATTN) {
    block_gemm<T>(PK, LD, NKV, C, p.wk, C,
            [&](int m, int n, float acc) {
              Kd[m * LD + n] = N::rnd(N::rnd(acc) + N::rnd(vecs[ROW_K_BIAS * C + n]));
            });
    block_gemm<T>(PV, LD, NKV, C, p.wv, C,
            [&](int m, int n, float acc) {
              Vd[m * LD + n] = N::rnd(N::rnd(acc) + N::rnd(vecs[ROW_V_BIAS * C + n]));
            });
  }
  __syncthreads();
  if (p.phase == PHASE_KV) {   // k | v rows of this tile (hw = 0: row i = seq r0 + i)
    T* kvb = static_cast<T*>(p.kv) + (size_t)b * T_ * 2 * C;
    for (int idx = threadIdx.x; idx < TQ * C; idx += NT) {
      const int i = idx / C, c = idx % C;
      if (r0 + i < T_) {
        N::store(kvb, (size_t)(r0 + i) * 2 * C + c, Kd[i * LD + c]);
        N::store(kvb, (size_t)(r0 + i) * 2 * C + C + c, Vd[i * LD + c]);
      }
    }
    return;
  }

  // ---- 4. attention: one warp per (query row, head), lane owns 2 channels
  float* CTX = R2;
  for (int task = warp; task < TQ * NH; task += NWARP) {
    const int i = task / NH, h = task % NH;
    const int ca = h * D + lane, cb = ca + 32;
    const float mq = maskf[i + hw + 1];
    const float qa = Qd[i * LD + ca], qb = Qd[i * LD + cb];
    float oa, ob;
    if (hw > 0) {
      // banded: scores in the compute dtype (rounded products, f32 sum),
      // -1e4 penalty on masked keys, -1e30 outside the sequence, f32 softmax
      float sc[2 * BAND_MAX_W + 1];
      float mx = -CUDART_INF_F;
      const float pen = N::rnd(-NEG_PENALTY);
      for (int d = -hw; d <= hw; ++d) {
        const int kk = i + hw + d;                 // kv-local key row
        const int s = r0 + i + d;                  // its sequence row
        const float e = N::rnd(qa * Kd[kk * LD + ca]) + N::rnd(qb * Kd[kk * LD + cb]);
        float v = N::rnd(warp_sum(e));
        v = N::rnd(v + (maskf[kk + 1] > 0.5f ? 0.f : pen));
        v = (s >= 0 && s < T_) ? v : NEG_INF;
        sc[d + hw] = v;
        mx = fmaxf(mx, v);
      }
      float den = 0.f;
      for (int d = 0; d <= 2 * hw; ++d) { sc[d] = expf(sc[d] - mx); den += sc[d]; }
      const float inv = 1.f / den;
      oa = 0.f; ob = 0.f;
      for (int d = -hw; d <= hw; ++d) {
        const int kk = i + hw + d;
        const float pr = N::rnd(sc[d + hw] * inv);
        oa = N::rnd(oa + N::rnd(pr * Vd[kk * LD + ca]));
        ob = N::rnd(ob + N::rnd(pr * Vd[kk * LD + cb]));
      }
    } else if (p.phase == PHASE_ATTN) {
      // dense, tiled: all T keys from the scratch, three passes over them
      // (scores recomputed bit for bit); -1e30 fill on invalid keys, values
      // masked, f32 softmax
      const T* kvb = static_cast<const T*>(p.kv) + (size_t)b * T_ * 2 * C;
      const uint8_t* mrow = p.mask + (size_t)b * T_;
      const float fill = N::rnd(NEG_INF);
      auto score = [&](int j) {
        const size_t r = (size_t)j * 2 * C;
        const float v = N::rnd(warp_sum(qa * N::load(kvb, r + ca) + qb * N::load(kvb, r + cb)));
        return mrow[j] ? v : fill;
      };
      float mx = -CUDART_INF_F;
      for (int j = 0; j < T_; ++j) mx = fmaxf(mx, score(j));
      float den = 0.f;
      for (int j = 0; j < T_; ++j) den += expf(score(j) - mx);
      float sa = 0.f, sb = 0.f;
      for (int j = 0; j < T_; ++j) {
        const float pj = N::rnd(expf(score(j) - mx) / den);
        const float mj = mrow[j] ? 1.f : 0.f;
        const size_t r = (size_t)j * 2 * C + C;
        sa += pj * N::rnd(N::load(kvb, r + ca) * mj);
        sb += pj * N::rnd(N::load(kvb, r + cb) * mj);
      }
      oa = N::rnd(sa);
      ob = N::rnd(sb);
    } else {
      // dense (whole sequence, T <= 31): lane j keeps the score of key j;
      // -1e30 fill on invalid keys, values masked, f32 softmax
      float mine = -CUDART_INF_F;
      const float fill = N::rnd(NEG_INF);
      for (int j = 0; j < T_; ++j) {
        float v = N::rnd(warp_sum(qa * Kd[j * LD + ca] + qb * Kd[j * LD + cb]));
        v = maskf[j + 1] > 0.5f ? v : fill;
        if (lane == j) mine = v;
      }
      const float mx = warp_max(mine);
      const float e = lane < T_ ? expf(mine - mx) : 0.f;
      const float pr = N::rnd(e / warp_sum(e));
      float sa = 0.f, sb = 0.f;
      for (int j = 0; j < T_; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
        const float mj = maskf[j + 1];
        sa += pj * N::rnd(Vd[j * LD + ca] * mj);
        sb += pj * N::rnd(Vd[j * LD + cb] * mj);
      }
      oa = N::rnd(sa);
      ob = N::rnd(sb);
    }
    CTX[i * LD + ca] = oa * mq;   // zero invalid query rows
    CTX[i * LD + cb] = ob * mq;
  }
  __syncthreads();

  // ---- 5. proj + masked skip + layer-scaled residual -> Y1 ---------------
  float* Y1 = R2 + TQ * LD;
  block_gemm<T>(CTX, LD, TQ, C, p.wp, C,
          [&](int m, int n, float acc) {
            const int s = r0 + m;
            const float mq = maskf[m + hw + 1];
            float y1 = 0.f;
            if (s < T_) {
              const float att = N::rnd(N::rnd(acc) + N::rnd(vecs[ROW_P_BIAS * C + n])) * mq;
              float skip = N::load(x, (size_t)s * C + n);
              if (mode == MODE_DS_SELF) {   // MaxPool(3, 2, 1), -inf padding
                const float om1 = s > 0 ? N::load(xo, (size_t)(s - 1) * C + n) : -CUDART_INF_F;
                skip = fmaxf(fmaxf(om1, skip), N::load(xo, (size_t)s * C + n));
              }
              y1 = N::rnd(skip * mq + N::rnd(att * N::rnd(vecs[ROW_SCALE_ATTN * C + n] * coef_attn)));
            }
            Y1[m * LD + n] = y1;
          });
  __syncthreads();

  // ---- 6. plain LN (ln2 affine folded into wf1) -> HL --------------------
  float* HL = R2 + 2 * TQ * LD;
  for (int m = warp; m < TQ; m += NWARP) {
    float v[C / 32];
#pragma unroll
    for (int k = 0; k < C / 32; ++k) v[k] = Y1[m * LD + lane + 32 * k];
    ln_plain_row<BF16>(v);
#pragma unroll
    for (int k = 0; k < C / 32; ++k) HL[m * LD + lane + 32 * k] = N::rnd(v[k]);
  }
  __syncthreads();

  // ---- 7. fc1 + GELU -> HID (TQ x 4C) ------------------------------------
  float* HID = R1;
  block_gemm<T>(HL, LD, TQ, C, p.wf1, 4 * C,
          [&](int m, int n, float acc) {
            const float h = N::rnd(N::rnd(acc) + N::rnd(p.fc1b[n]));
            HID[m * LDH + n] = N::rnd(gelu<BF16>(h));
          });
  __syncthreads();

  // ---- 8. fc2 + masked, layer-scaled residual -> out ---------------------
  T* out = static_cast<T*>(p.out) + (size_t)b * T_ * C;
  block_gemm<T>(HID, LDH, TQ, 4 * C, p.wf2, C,
          [&](int m, int n, float acc) {
            const int s = r0 + m;
            if (s >= T_) return;
            const float mq = maskf[m + hw + 1];
            const float h = N::rnd(N::rnd(acc) + N::rnd(vecs[ROW_FC2_BIAS * C + n])) * mq;
            const float y = N::rnd(Y1[m * LD + n] +
                                   N::rnd(h * N::rnd(vecs[ROW_SCALE_MLP * C + n] * coef_mlp)));
            N::store(out, (size_t)s * C + n, y);
          });
}

// Dense attention takes the tiled two-phase path above DENSE_MAX_T rows, or
// at any T when force_tiled is set (used only to time the two paths).
int dense_tiled(int T, int w, int force_tiled) {
  return (w <= 0 && (force_tiled || T > DENSE_MAX_T)) ? 1 : 0;
}

int tile_rows(int T, int w, int tiled) { return (w > 0 || tiled) ? TQ_BAND : T; }

template <typename T>
int launch(Params p, int B, cudaStream_t stream) {
  const int bytes = Layout(p.tq, p.w).bytes();
  static int configured = 0;    // largest dynamic smem size set so far
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  dim3 grid((p.T + p.tq - 1) / p.tq, B);
  if (p.phase == PHASE_WHOLE) {
    fused_block_kernel<T><<<grid, NT, bytes, stream>>>(p);
    return (int)cudaGetLastError();
  }
  p.phase = PHASE_KV;
  fused_block_kernel<T><<<grid, NT, bytes, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  p.phase = PHASE_ATTN;
  fused_block_kernel<T><<<grid, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) a launch needs, or -1 if the shape is not
// supported (a half window above BAND_MAX_W).
int avdd_fused_block_smem(int T, int w, int force_tiled, int dtype) {
  (void)dtype;
  if (w > BAND_MAX_W) return -1;
  return Layout(tile_rows(T, w, dense_tiled(T, w, force_tiled)), w).bytes();
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// dtype: 0 float32, 1 bfloat16. mode: 0 self, 1 qv_k, 2 kv, 3 ds_self.
// Dense weights: (out, in) row-major in the compute dtype (torch's Linear
// layout), for both dtypes. Dense attention (w = 0) picks its path here
// (dense_tiled); the tiled path needs kv, a (B, T, 2C) scratch in the
// compute dtype, so the caller passes one for every dense launch. coefs:
// (B, 2) f32 droppath coefficients of the training forward, or null.
int avdd_fused_block(const void* x, const void* xo, const void* mask,
                     const void* vecs, const void* wq, const void* wk,
                     const void* wv, const void* wp, const void* wf1,
                     const void* wf2, const void* fc1b, void* out, void* kv,
                     const void* coefs, int B, int T, int c, int n_head, int w, int mode,
                     int force_tiled, int dtype, void* stream) {
  const int tiled = dense_tiled(T, w, force_tiled);
  if (c != C || n_head != NH || avdd_fused_block_smem(T, w, force_tiled, dtype) < 0 ||
      mode < 0 || mode > 3 || B <= 0 || T <= 0 || (tiled && !kv))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.xo = xo ? xo : x;
  p.mask = static_cast<const uint8_t*>(mask);
  p.vecs = static_cast<const float*>(vecs);
  p.wq = wq; p.wk = wk; p.wv = wv; p.wp = wp; p.wf1 = wf1; p.wf2 = wf2;
  p.fc1b = static_cast<const float*>(fc1b);
  p.out = out;
  p.kv = kv;
  p.coefs = static_cast<const float*>(coefs);
  p.T = T; p.w = w > 0 ? w : 0; p.mode = mode; p.tq = tile_rows(T, w, tiled);
  p.phase = tiled ? PHASE_KV : PHASE_WHOLE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
