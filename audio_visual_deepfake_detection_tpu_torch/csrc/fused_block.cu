// Fused localizer transformer block for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel audio_visual_deepfake_detection_tpu/ops/pallas/
// fused_block.py::fused_transformer_block (pl.pallas_call at :535), and with
// it the forward of fused_transformer_block_train (:753), which is the same
// kernel given per-sample droppath coefficients. One call computes a whole
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
// What bounds it on this card: a row costs 12 C^2 = 786k multiply-adds
// (q, k, v, proj 4 C^2, the MLP 8 C^2) against ~1-2 KB of HBM traffic, far
// above the H100's ridge: the tensor cores bound it once the six products
// run on them, provided the 1.5 MB of bf16 weights reach each SM fast
// enough. A tile of m rows reads all of them from L2, so the rows a weight
// fetch serves decide whether L2 or the tensor cores set the pace; the
// CUDA-core work a row needs (five LNs, three depthwise convs, 4 x (2w+1)
// scores and context sums, the GELU of 4C values) is second.
//
// bf16 (the main path, and K6's training forward), two launches on wgmma:
// - PHASE_QKV: per tile of 64 rows of one sample, LN -> depthwise conv ->
//   LN of each stream into a 64 x 256 bf16 tile in shared memory (a warp LNs
//   the input rows each run of four output rows needs, one more each side),
//   then the q / k / v product and its bias (q scaled) to a (B, T, 3C) bf16
//   scratch. The values there are the ones block_math rounds to bf16, so the
//   split is exact; it costs 3C x 2 bytes written and read a row.
// - PHASE_TAIL: per tile, attention from the scratch (a thread per (row,
//   head); banded reads the 2w+1 key and value rows through L1, dense all T
//   in three passes), the context into the tile, proj + the masked,
//   layer-scaled residual (y1, kept in the output rows), its LN into the
//   tile, then fc1 -> GELU -> fc2 over 16 chunks of 64 hidden units: the
//   chunk goes through an 8 KB tile and fc2's sums stay in registers, so
//   the 4C hidden never lies whole anywhere.
// Both: a block is one warpgroup and one tile of 64 rows. The weights come
// by TMA (boxes of 64 inputs x 256 or 64 outputs, 128B-swizzled, straight
// from torch's (out, in) layout) through a ring of two 32 KB stages, each
// with an mbarrier that the TMA completes; thread 0 re-arms a slot as soon
// as the products that read it are done, so the next product's slices
// arrive while the warpgroup runs LN, attention or GELU. Two blocks share an
// SM and run out of step, so one's CUDA-core work overlaps the other's
// products.
// The products are wgmma m64n256k16 / m64n64k16 with both operands in shared
// memory (tiles written by the consumers are fenced to the async proxy).
// Dense attention (window -1) is the same path at any T: the scratch holds
// every key. The rounding points are block_math's: cdot rounded once,
// one-pass LN moments, banded scores and the -1e4 penalty in bf16 (products
// rounded, f32 sums), f32 softmax, the context summed offset by offset in
// bf16, the division-free GELU, droppath coefficients multiplied into the
// layer scales in f32 and rounded once.
//
// f32 (what the card is held to against the CPU): the first design, kept.
// Every intermediate stays in shared memory as f32, one thread block per
// (sample, tile of 16 query rows) with a halo of w+1 input rows each side;
// the six products are a register-tiled FMA loop (full f32 precision)
// reading the weights from L2. Dense attention takes one of two paths:
// - T <= DENSE_MAX_T (31): the whole sequence in one thread block, one key
//   per lane (one launch);
// - any longer T: two launches over tiles of TQ_BAND query rows. Phase 1
//   computes each tile's k and v rows into a (B, T, 2C) scratch; phase 2
//   computes the tile's q and attends each (row, head) warp to all T keys
//   from the scratch in three passes (row max, sum of exps, P.V),
//   recomputing the scores, so shared memory does not grow with T.

#include "wgmma.cuh"

namespace {

using namespace avdd;

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

// Products of the f32 kernel, W (N, K) f32.
template <typename T, typename Epi>
__device__ __forceinline__ void block_gemm(const float* A, int lda, int M, int K,
                                           const void* W, int N, Epi epi) {
  static_assert(sizeof(T) == 4, "the shared-memory kernel runs float32 only");
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
  constexpr bool BF16 = false;
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

// ---- bf16: two launches on wgmma --------------------------------------------
// Launch 1 (PHASE_QKV) writes the rounded q (scaled), k and v rows of every
// sequence row to a (B, T, 3C) scratch; launch 2 (PHASE_TAIL) reads them for
// attention and runs proj, LN and the MLP. A block is one warpgroup and a
// tile of 64 rows of one sample; two blocks share an SM.
constexpr int WG_ROWS = 64;                    // rows a block owns
constexpr int NTW = 128;                       // one warpgroup
constexpr int STAGES = 2;                      // weight ring depth
constexpr int STAGE = 32768;                   // a stage: 256 rows x 128 B
constexpr int TILE = WG_ROWS * 2 * C;          // 64 x 256 bf16: four 8 KB blocks of 64 columns
constexpr int HCHUNK = WG_ROWS * 128;          // 64 x 64 bf16 hidden chunk
constexpr int QKV_STAGES = 12;                 // wq, wk, wv: four 64-deep slices each
constexpr int TAIL_STAGES = 4 + 2 * 16;        // wp, then fc1 | fc2 of 16 hidden chunks
constexpr int WG_SMEM = 1024 + STAGES * STAGE + TILE + HCHUNK + 8 * (STAGES + 1);
// banded attention in chunks of this many query rows: their q, keys and
// values (with the halo) are staged in the ring's space
constexpr int ATT_ROWS = 32;
static_assert((3 * ATT_ROWS + 4 * BAND_MAX_W) * 512 <= STAGES * STAGE, "staged rows over the ring");
static_assert(2 * (WG_SMEM + 1024) <= 233472, "two wgmma blocks over an SM's shared memory");
enum { PHASE_QKV = 0, PHASE_TAIL = 1 };

// Tensor maps of the six weights, (out, in) bf16: wq, wk, wv, wp in boxes
// of 64 inputs x 256 outputs; wf1 in boxes of 64 inputs x 64 hidden units;
// wf2 in boxes of 64 hidden units x 256 outputs;
// and the (B, T, 3C) q|k|v scratch, unswizzled, in boxes of 256 channels x
// ATT_ROWS rows (q) or ATT_ROWS + 2w rows (keys, values).
struct WeightMaps { CUtensorMap w[6]; CUtensorMap q, kv; };

struct ParamsW {
  const __nv_bfloat16* x; const __nv_bfloat16* xo;
  const uint8_t* mask; const float* vecs; const float* fc1b; const float* coefs;
  __nv_bfloat16* qkv;   // (B, T, 3C) q | k | v scratch
  __nv_bfloat16* out;   // (B, T, C); also holds y1 between proj and fc2
  int T, w, mode, tiles;
};

// Byte offset of element (r, c) in a TILE: 64-column block c / 64, 128-byte
// swizzled row r.
__device__ __forceinline__ uint32_t tile_at(int r, int c) {
  return (uint32_t)((c >> 6) * 8192) + swz(r, (c >> 3) & 7) + 2 * (c & 7);
}

__device__ __forceinline__ float rnd16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// The weight stages in the order the products take them. QKV: wq, wk, wv,
// each as four 64-deep input slices of all 256 outputs. TAIL: wp likewise,
// then for each 64-wide hidden chunk j its fc1 rows (four 8 KB boxes, one
// per 64-deep input slice) and its fc2 columns. Stage i lands in slot
// i % STAGES and completes its bytes on that slot's barrier.
__device__ void load_stage(const WeightMaps& maps, uint32_t dst, uint32_t full, int i, int phase) {
  mbar_expect_tx(full, STAGE);
  if (phase == PHASE_QKV) {
    tma_load_2d(dst, &maps.w[i / 4], 64 * (i % 4), 0, full);
  } else if (i < 4) {
    tma_load_2d(dst, &maps.w[3], 64 * i, 0, full);
  } else if ((i - 4) % 2 == 0) {
    for (int kb = 0; kb < 4; ++kb)
      tma_load_2d(dst + kb * 8192, &maps.w[4], 64 * kb, 64 * ((i - 4) / 2), full);
  } else {
    tma_load_2d(dst, &maps.w[5], 64 * ((i - 4) / 2), 0, full);
  }
}

// Ring of weight stages. take() waits for the next stage; release(i), once
// the products reading the i-th stage taken are complete, has thread 0 load
// stage i + STAGES into its slot (the warpgroup's own wgmma were its only
// readers, so no other barrier is needed).
struct Ring {
  const WeightMaps* maps;
  uint32_t base, bars;   // stage 0; a full barrier per slot
  int n, count, phase;   // stages taken so far, stages in all, PHASE_*
  __device__ void start() {
    if (threadIdx.x == 0)
      for (int i = 0; i < STAGES && i < count; ++i)
        load_stage(*maps, base + i * STAGE, bars + 8 * i, i, phase);
  }
  __device__ uint32_t take() {
    const int s = n % STAGES;
    mbar_wait(bars + 8 * s, (n / STAGES) & 1);
    ++n;
    return base + s * STAGE;
  }
  __device__ void release(int i) const {
    const int s = i % STAGES;
    if (threadIdx.x == 0 && i + STAGES < count)
      load_stage(*maps, base + s * STAGE, bars + 8 * s, i + STAGES, phase);
  }
};

// acc = tile (64 x 256) . W^T over the next four stages (W 256 x 256).
__device__ __forceinline__ void product256(float (&acc)[128], uint32_t tile, Ring& ring) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int kb = 0; kb < 4; ++kb) {
    const uint32_t st = ring.take();
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaSS<256>::run(acc, tile_desc(tile + kb * 8192 + kk * 32), tile_desc(st + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();
    if (kb) ring.release(ring.n - 2);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(ring.n - 1);
}

// One sequence row of a stream, plain LN (one-pass moments) with the
// stream's affine, rounded; this lane's channels c0 .. c0 + 7. Zero outside
// the sequence. The whole warp calls it for the same row.
__device__ __forceinline__ void ln_stream_row(float (&l)[8], const __nv_bfloat16* src, int s,
                                              int T, int c0, const float (&lw)[8],
                                              const float (&lb)[8]) {
  const bool in = s >= 0 && s < T;
  float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (in) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)s * C + c0);
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = unpack2(u[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) { s1 += f[i]; s2 += f[i] * f[i]; }
  const float mu = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
  const float rs = rsqrtf(fmaxf(m2 - mu * mu, 0.f) + LN_EPS);
#pragma unroll
  for (int i = 0; i < 8; ++i) l[i] = in ? rnd16((f[i] * rs - mu * rs) * lw[i] + lb[i]) : 0.f;
}

// Conv output row (already masked) -> rounded, plain LN, rounded -> the
// tile's row r (this lane's 16 bytes).
__device__ __forceinline__ void ln_store_row(float (&y)[8], uint32_t tile, int r, int lane) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) { y[i] = rnd16(y[i]); s1 += y[i]; s2 += y[i] * y[i]; }
  const float mu = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
  const float rs = rsqrtf(fmaxf(m2 - mu * mu, 0.f) + LN_EPS);
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = pack_bf16(y[2 * i] * rs - mu * rs, y[2 * i + 1] * rs - mu * rs);
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(tile + (uint32_t)((lane >> 3) * 8192) + swz(r, lane & 7)),
                  "r"(u[0]), "r"(u[1]), "r"(u[2]), "r"(u[3]) : "memory");
}

// The conv + LN rows of stream `which` (0 q, 1 k, 2 v) for the tile's 64
// rows into `tile`: warp w does rows 16 w .. 16 w + 15 in two runs of
// eight, each run LN-ing the input rows it needs (one more on each side) at
// once, so their loads and reductions overlap; a conv row overwrites the
// input row it no longer needs. (The two runs unrolled into one measured 7%
// slower a block on an H100 SXM at 700 W.)
__device__ void conv_rows(const ParamsW& p, int which, int b, int r0, uint32_t tile, int warp,
                          int lane) {
  constexpr int RUN = 8;
  const float* v = p.vecs;
  const int c0 = 8 * lane;
  int rw = ROW_LNQ_W;
  const __nv_bfloat16* src = p.x + (size_t)b * p.T * C;
  const __nv_bfloat16* odd = p.xo + (size_t)b * p.T * C;
  if (p.mode == MODE_QV_K || p.mode == MODE_KV) {
    if (which == 1) { rw = ROW_LNK_W; src = odd; }
    if (which == 2) { rw = ROW_LNV_W; if (p.mode == MODE_KV) src = odd; }
  }
  float lw[8], lb[8], w0[8], w1[8], w2[8];
  const int tap = ROW_QCONV + 3 * which;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lw[i] = v[rw * C + c0 + i];
    lb[i] = v[(rw + 1) * C + c0 + i];
    w0[i] = v[tap * C + c0 + i];
    w1[i] = v[(tap + 1) * C + c0 + i];
    w2[i] = v[(tap + 2) * C + c0 + i];
  }
  const uint8_t* mrow = p.mask + (size_t)b * p.T;
#pragma unroll 1
  for (int run = 0; run < 16 / RUN; ++run) {
    const int i0 = 16 * warp + RUN * run, s0 = r0 + i0;
    if (p.mode == MODE_DS_SELF) {   // y[i] = w0 odd[i-1] + w1 even[i] + w2 odd[i]
      float le[RUN][8], lo[RUN + 1][8];
#pragma unroll
      for (int k = 0; k <= RUN; ++k) ln_stream_row(lo[k], odd, s0 - 1 + k, p.T, c0, lw, lb);
#pragma unroll
      for (int k = 0; k < RUN; ++k) ln_stream_row(le[k], src, s0 + k, p.T, c0, lw, lb);
#pragma unroll
      for (int o = 0; o < RUN; ++o) {
        const int s = s0 + o;
        const float mv = (s < p.T && mrow[s]) ? 1.f : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) le[o][i] = (lo[o][i] * w0[i] + le[o][i] * w1[i] + lo[o + 1][i] * w2[i]) * mv;
        ln_store_row(le[o], tile, i0 + o, lane);
      }
    } else {
      float l[RUN + 2][8];
#pragma unroll
      for (int k = 0; k < RUN + 2; ++k) ln_stream_row(l[k], src, s0 - 1 + k, p.T, c0, lw, lb);
#pragma unroll
      for (int o = 0; o < RUN; ++o) {
        const int s = s0 + o;
        const float mv = (s < p.T && mrow[s]) ? 1.f : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) l[o][i] = (l[o][i] * w0[i] + l[o + 1][i] * w1[i] + l[o + 2][i] * w2[i]) * mv;
        ln_store_row(l[o], tile, i0 + o, lane);
      }
    }
  }
}

// Attention -> the tile (CTX). Warp w takes rows w, w + 4, ... of the rows
// it is given, so the four warps walk neighbouring rows together. Lane l
// holds head l / 8, channels 8 (l % 8) .. + 7 of it: a warp reads a q, k or
// v row as one 512-byte run, the eight lanes of a head sum a score with
// three shuffles, and each lane writes its 16 bytes of the row's context.
// Invalid query rows give zeros.
__device__ __forceinline__ float head_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}
__device__ __forceinline__ void ctx_store(uint32_t tile, int i, int lane, const uint32_t (&c)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(tile + (uint32_t)((lane / 8) * 8192) + swz(i, lane % 8)), "r"(c[0]),
                  "r"(c[1]), "r"(c[2]), "r"(c[3]) : "memory");
}
__device__ __forceinline__ uint4 lds16(uint32_t a) {
  uint4 u;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w) : "r"(a));
  return u;
}

// Banded, rows i0 .. i0 + ATT_ROWS - 1 of the tile, from rows staged by TMA
// (512 bytes a row, zeros outside the sequence): their q at `qst`, their
// keys and values, rows r0 + i0 - W .. r0 + i0 + ATT_ROWS - 1 + W of the
// scratch, at `kst` and `vst`. Rounded products summed in f32 and rounded,
// the -1e4 penalty in bf16, -1e30 outside the sequence, f32 softmax, the
// context summed offset by offset in bf16. The half window is a template
// parameter and the key masks come from two ballots, so a row is one
// branch-free block and two rows' loads and shuffles interleave.
template <int W>
__device__ void attend_band(const ParamsW& p, int b, int r0, int i0, uint32_t qst, uint32_t kst,
                            uint32_t vst, int warp, int lane, uint32_t tile) {
  constexpr int ROWS = ATT_ROWS + 2 * W;
  static_assert(ROWS <= 64, "two ballots hold the staged rows' masks");
  const int T_ = p.T, off = (lane / 8) * 128 + (lane % 8) * 16, s0 = r0 + i0 - W;
  const uint8_t* mrow = p.mask + (size_t)b * T_;
  auto valid = [&](int s) { return s >= 0 && s < T_ && mrow[s] != 0; };
  // bit j: staged row j is a valid key (inside the sequence, not masked)
  const uint32_t lo = __ballot_sync(0xffffffffu, valid(s0 + lane));
  const uint32_t hi = __ballot_sync(0xffffffffu, lane + 32 < ROWS && valid(s0 + 32 + lane));
  auto bit = [&](int j) { return ((j < 32 ? lo >> j : hi >> (j - 32)) & 1u) != 0; };
  const float pen = rnd16(-NEG_PENALTY);
#pragma unroll 2
  for (int i = warp; i < ATT_ROWS; i += 4) {
    const int r = r0 + i0 + i;
    const uint4 qu = lds16(qst + (uint32_t)(i * 512 + off));
    const uint32_t q[4] = {qu.x, qu.y, qu.z, qu.w};
    float sc[2 * W + 1];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int d = -W; d <= W; ++d) {
      const uint4 ku = lds16(kst + (uint32_t)((i + W + d) * 512 + off));
      const uint32_t kw[4] = {ku.x, ku.y, ku.z, ku.w};
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 pr = unpack2(bf16x2_mul(q[e], kw[e]));
        part += pr.x + pr.y;
      }
      part = rnd16(head_sum(part));
      const bool inseq = r + d >= 0 && r + d < T_;
      const float sv = !inseq ? NEG_INF : bit(i + W + d) ? part : rnd16(part + pen);
      sc[d + W] = sv;
      mx = fmaxf(mx, sv);
    }
    float den = 0.f;
#pragma unroll
    for (int d = 0; d <= 2 * W; ++d) {
      sc[d] = expf(sc[d] - mx);
      den += sc[d];
    }
    const float inv = 1.f / den;
    uint32_t ctx[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int d = -W; d <= W; ++d) {   // a key outside the sequence was staged as zeros
      const uint32_t pr = pack_bf16(sc[d + W] * inv, sc[d + W] * inv);
      const uint4 vu = lds16(vst + (uint32_t)((i + W + d) * 512 + off));
      const uint32_t vw[4] = {vu.x, vu.y, vu.z, vu.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) ctx[e] = bf16x2_add(ctx[e], bf16x2_mul(pr, vw[e]));
    }
    const bool live = r < T_ && bit(i + W);
#pragma unroll
    for (int e = 0; e < 4; ++e) ctx[e] = live ? ctx[e] : 0u;
    ctx_store(tile, i0 + i, lane, ctx);
  }
}

// Dense, all 64 rows of the tile against all T keys of the scratch: f32 dot
// products rounded once, -1e30 fill on invalid keys, f32 softmax in three
// passes over the keys, values masked, P.V summed in f32 and rounded once.
__device__ void attend_dense(const ParamsW& p, int b, int r0, int warp, int lane, uint32_t tile) {
  const int T_ = p.T;
  const uint8_t* mrow = p.mask + (size_t)b * T_;
  const __nv_bfloat16* base = p.qkv + (size_t)b * T_ * 3 * C + (lane / 8) * D + 8 * (lane % 8);
  auto row = [&](int s, int part) {          // 8 values of q (0), k (1) or v (2) of row s
    return *reinterpret_cast<const uint4*>(base + (size_t)s * 3 * C + part * C);
  };
  const float fill = rnd16(NEG_INF);
#pragma unroll 1
  for (int i = warp; i < WG_ROWS; i += 4) {
    const int r = r0 + i;
    uint32_t ctx[4] = {0u, 0u, 0u, 0u};
    if (r < T_ && mrow[r]) {
      const uint4 qu = row(r, 0);
      const uint32_t q[4] = {qu.x, qu.y, qu.z, qu.w};
      auto score = [&](int j) {
        const uint4 ku = row(j, 1);
        const uint32_t kw[4] = {ku.x, ku.y, ku.z, ku.w};
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = unpack2(q[e]), k = unpack2(kw[e]);
          part = fmaf(a.x, k.x, part);
          part = fmaf(a.y, k.y, part);
        }
        part = head_sum(part);
        return mrow[j] ? rnd16(part) : fill;
      };
      float mx = -CUDART_INF_F;
#pragma unroll 4
      for (int j = 0; j < T_; ++j) mx = fmaxf(mx, score(j));
      float den = 0.f;
#pragma unroll 4
      for (int j = 0; j < T_; ++j) den += expf(score(j) - mx);
      float sa[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = 0; j < T_; ++j) {
        const float pj = rnd16(expf(score(j) - mx) / den);
        if (!mrow[j]) continue;      // its value row is masked to zero
        const uint4 vu = row(j, 2);
        const uint32_t vw[4] = {vu.x, vu.y, vu.z, vu.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = unpack2(vw[e]);
          sa[2 * e] = fmaf(pj, a.x, sa[2 * e]);
          sa[2 * e + 1] = fmaf(pj, a.y, sa[2 * e + 1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) ctx[e] = pack_bf16(sa[2 * e], sa[2 * e + 1]);
    }
    ctx_store(tile, i, lane, ctx);
  }
}

// The bf16 GELU (the division-free polynomial, rounded) of every bf16 value.
__device__ __nv_bfloat16 gelu_cheap_table[65536];
struct GeluCheap {
  __device__ float operator()(float x) const { return gelu<true>(x); }
};

// The L2 is asked for the tile's input rows s0 .. s0 + n - 1 of x (B, T, C)
// ahead of the loads that need them.
__device__ __forceinline__ void prefetch_rows(const __nv_bfloat16* x, int s0, int n, int T) {
  for (int i = threadIdx.x; i < 4 * n; i += NTW) {
    const int s = s0 + i / 4;
    if (s >= 0 && s < T)
      asm volatile("prefetch.global.L2 [%0];\n" :: "l"(x + (size_t)s * C + 64 * (i % 4)));
  }
}

template <int PHASE>
__global__ void __launch_bounds__(NTW, 1)
fused_block_wgmma_kernel(const __grid_constant__ WeightMaps maps, const ParamsW p) {
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t ring_base = (smem_u32(smraw) + 1023u) & ~1023u;
  const uint32_t hc = ring_base + STAGES * STAGE, tile = hc + HCHUNK, bars = tile + TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + 8 * s, 1);   // ring slots, staged rows
    mbar_init_fence();
  }
  __syncthreads();
  Ring ring{&maps, ring_base, bars, 0, PHASE == PHASE_QKV ? QKV_STAGES : TAIL_STAGES, PHASE};
  if (PHASE == PHASE_QKV) ring.start();
  const int tps = (p.T + WG_ROWS - 1) / WG_ROWS;
  const int b = blockIdx.x / tps, r0 = (blockIdx.x % tps) * WG_ROWS;
  const int T_ = p.T;
  const __nv_bfloat16* xb = p.x + (size_t)b * T_ * C;
  const __nv_bfloat16* ob = p.xo + (size_t)b * T_ * C;
  prefetch_rows(xb, r0 - 1, WG_ROWS + 2, T_);       // the conv's rows, the skip's
  if (p.mode != MODE_SELF) prefetch_rows(ob, r0 - 1, WG_ROWS + 2, T_);
  const float* v = p.vecs;
  const uint8_t* mrow = p.mask + (size_t)b * T_;
  float acc[128];

  if (PHASE == PHASE_QKV) {
    const float qscale = rnd16(1.f / sqrtf((float)D));
#pragma unroll 1
    for (int which = 0; which < 3; ++which) {
      conv_rows(p, which, b, r0, tile, warp, lane);
      fence_async_shared();
      bar_sync(1, 128);
      product256(acc, tile, ring);
      const int brow = (ROW_Q_BIAS + which) * C;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int n = 8 * j + 2 * t;
        const float b0 = rnd16(v[brow + n]), b1 = rnd16(v[brow + n + 1]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = r0 + 16 * warp + g + 8 * hf;
          if (m >= T_) continue;
          float y0 = rnd16(rnd16(acc[4 * j + 2 * hf]) + b0);
          float y1 = rnd16(rnd16(acc[4 * j + 2 * hf + 1]) + b1);
          if (which == 0) { y0 = rnd16(y0 * qscale); y1 = rnd16(y1 * qscale); }
          *reinterpret_cast<uint32_t*>(p.qkv + ((size_t)b * T_ + m) * 3 * C + which * C + n) =
              pack_bf16(y0, y1);
        }
      }
      // every warp's products have read the tile before the next stream's rows land
      bar_sync(1, 128);
    }
    return;
  }

  // ---- PHASE_TAIL ----
  // attention first, in chunks of ATT_ROWS query rows whose q, keys and
  // values TMA stages in the ring's space; then the ring starts on wp
  if (p.w > 0) {
    const int rows = ATT_ROWS + 2 * p.w;
    const uint32_t kst = ring_base + ATT_ROWS * 512, vst = kst + rows * 512;
    const uint32_t stbar = bars + 8 * STAGES;
    for (int i0 = 0, k = 0; i0 < WG_ROWS; i0 += ATT_ROWS, ++k) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(stbar, (ATT_ROWS + 2 * rows) * 512);
        tma_load_3d(ring_base, &maps.q, 0, r0 + i0, b, stbar);
        tma_load_3d(kst, &maps.kv, C, r0 + i0 - p.w, b, stbar);
        tma_load_3d(vst, &maps.kv, 2 * C, r0 + i0 - p.w, b, stbar);
      }
      mbar_wait(stbar, k & 1);
      switch (p.w) {
#define AVDD_BAND(W) \
  case W: attend_band<W>(p, b, r0, i0, ring_base, kst, vst, warp, lane, tile); break;
        AVDD_BAND(1) AVDD_BAND(2) AVDD_BAND(3) AVDD_BAND(4)
        AVDD_BAND(5) AVDD_BAND(6) AVDD_BAND(7) AVDD_BAND(8)
#undef AVDD_BAND
      }
      fence_async_shared();
      __syncthreads();               // the staged rows are read before they are refilled
    }
  } else {
    attend_dense(p, b, r0, warp, lane, tile);
    fence_async_shared();
    __syncthreads();
  }
  ring.start();
  product256(acc, tile, ring);

  // proj + masked skip + layer-scaled residual -> y1 (to out, and kept in
  // acc), then its plain LN (quad of four threads = one row) -> the tile
  const float coef_attn = p.coefs ? p.coefs[2 * b] : 1.f;
  const float coef_mlp = p.coefs ? p.coefs[2 * b + 1] : 1.f;
  __nv_bfloat16* outb = p.out + (size_t)b * T_ * C;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = 16 * warp + g + 8 * hf, m = r0 + i;
    const bool in = m < T_;
    const float mq = (in && mrow[m]) ? 1.f : 0.f;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int n = 8 * j + 2 * t;
      float y[2] = {0.f, 0.f};
      if (in) {
        float2 skip = unpack2(*reinterpret_cast<const uint32_t*>(xb + (size_t)m * C + n));
        if (p.mode == MODE_DS_SELF) {   // MaxPool(3, 2, 1), -inf padding
          const float2 o = unpack2(*reinterpret_cast<const uint32_t*>(ob + (size_t)m * C + n));
          float2 om1 = make_float2(-CUDART_INF_F, -CUDART_INF_F);
          if (m > 0) om1 = unpack2(*reinterpret_cast<const uint32_t*>(ob + (size_t)(m - 1) * C + n));
          skip = make_float2(fmaxf(fmaxf(om1.x, skip.x), o.x), fmaxf(fmaxf(om1.y, skip.y), o.y));
        }
        const float sk[2] = {skip.x, skip.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float att = rnd16(rnd16(acc[4 * j + 2 * hf + e]) +
                                  rnd16(v[ROW_P_BIAS * C + n + e])) * mq;
          const float sa = rnd16(v[ROW_SCALE_ATTN * C + n + e] * coef_attn);
          y[e] = rnd16(sk[e] * mq + rnd16(att * sa));
        }
        *reinterpret_cast<uint32_t*>(outb + (size_t)m * C + n) = pack_bf16(y[0], y[1]);
      }
      acc[4 * j + 2 * hf] = y[0];
      acc[4 * j + 2 * hf + 1] = y[1];
      s1 += y[0] + y[1];
      s2 += y[0] * y[0] + y[1] * y[1];
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
    const float mu = s1 / C, rs = rsqrtf(fmaxf(s2 / C - mu * mu, 0.f) + LN_EPS);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int n = 8 * j + 2 * t;
      const float y0 = acc[4 * j + 2 * hf], y1 = acc[4 * j + 2 * hf + 1];
      asm volatile("st.shared.b32 [%0], %1;\n"
                   :: "r"(tile + tile_at(i, n)), "r"(pack_bf16(y0 * rs - mu * rs, y1 * rs - mu * rs))
                   : "memory");
    }
  }
  fence_async_shared();
  bar_sync(1, 128);

  // MLP over 16 hidden chunks of 64: fc1 -> GELU -> the chunk tile -> fc2,
  // whose sums stay in acc; fc2 of chunk j runs while fc1 of j + 1 is issued
  const uint16_t* gt = reinterpret_cast<const uint16_t*>(gelu_cheap_table);
  float h1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) h1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    const uint32_t st1 = ring.take();
    fence_regs(h1);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaSS<64>::run(h1, tile_desc(tile + kb * 8192 + kk * 32),
                         tile_desc(st1 + kb * 8192 + kk * 32), kb | kk);
    wgmma_commit();
    wgmma_wait<0>();                 // fc1 of j and fc2 of j - 1
    fence_regs(h1);
    fence_regs(acc);
    if (j) ring.release(ring.n - 2);
    ring.release(ring.n - 1);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = 8 * jj + 2 * t;
      const float b0 = rnd16(p.fc1b[64 * j + n]), b1 = rnd16(p.fc1b[64 * j + n + 1]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {   // GELU of the rounded fc1 output, from the table
        const uint32_t a0 = __ldg(gt + bf16_bits(rnd16(h1[4 * jj + 2 * hf]) + b0));
        const uint32_t a1 = __ldg(gt + bf16_bits(rnd16(h1[4 * jj + 2 * hf + 1]) + b1));
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(hc + swz(16 * warp + g + 8 * hf, jj) + 4 * t), "r"(a0 | a1 << 16)
                     : "memory");
      }
    }
    fence_async_shared();
    bar_sync(1, 128);
    const uint32_t st2 = ring.take();
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaSS<256>::run(acc, tile_desc(hc + kk * 32), tile_desc(st2 + kk * 32), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(ring.n - 1);

  // fc2 bias, masked, layer-scaled residual onto y1 -> out
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = r0 + 16 * warp + g + 8 * hf;
    if (m >= T_) continue;
    const float mq = mrow[m] ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int n = 8 * j + 2 * t;
      uint32_t* o = reinterpret_cast<uint32_t*>(outb + (size_t)m * C + n);
      const float2 y1 = unpack2(*o);
      const float yv[2] = {y1.x, y1.y};
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float h = rnd16(rnd16(acc[4 * j + 2 * hf + e]) + rnd16(v[ROW_FC2_BIAS * C + n + e])) * mq;
        y[e] = rnd16(yv[e] + rnd16(h * rnd16(v[ROW_SCALE_MLP * C + n + e] * coef_mlp)));
      }
      *o = pack_bf16(y[0], y[1]);
    }
  }
}

int launch_wgmma(const ParamsW& p, const void* const* w, cudaStream_t stream) {
  static __nv_bfloat16* table = nullptr;
  static unsigned table_ready = 0;
  if (!table)
    if (int e = (int)cudaGetSymbolAddress(reinterpret_cast<void**>(&table), gelu_cheap_table))
      return e;
  if (int e = fill_table(table, GeluCheap{}, table_ready, stream)) return e;
  static int configured = 0;
  if (int e = set_smem(fused_block_wgmma_kernel<PHASE_QKV>, WG_SMEM, configured)) return e;
  static int configured_tail = 0;
  if (int e = set_smem(fused_block_wgmma_kernel<PHASE_TAIL>, WG_SMEM, configured_tail)) return e;
  WeightMaps maps;
  const uint64_t sq[2] = {C, C}, st[1] = {2 * C};
  const uint32_t box[2] = {64, 256};
  for (int i = 0; i < 4; ++i)
    if (int e = bf16_tensor_map(&maps.w[i], w[i], 2, sq, st, box)) return e;
  const uint64_t d1[2] = {C, 4 * C}, d2[2] = {4 * C, C}, st2[1] = {8 * C};
  const uint32_t box1[2] = {64, 64};
  if (int e = bf16_tensor_map(&maps.w[4], w[4], 2, d1, st, box1)) return e;
  if (int e = bf16_tensor_map(&maps.w[5], w[5], 2, d2, st2, box)) return e;
  const uint64_t dq[3] = {3 * C, (uint64_t)p.T, (uint64_t)(p.tiles / ((p.T + WG_ROWS - 1) / WG_ROWS))};
  const uint64_t sq3[2] = {3 * C * 2, (uint64_t)p.T * 3 * C * 2};
  const uint32_t boxq[3] = {C, ATT_ROWS, 1}, boxkv[3] = {C, (uint32_t)(ATT_ROWS + 2 * p.w), 1};
  if (int e = bf16_tensor_map(&maps.q, p.qkv, 3, dq, sq3, boxq, false)) return e;
  if (int e = bf16_tensor_map(&maps.kv, p.qkv, 3, dq, sq3, boxkv, false)) return e;
  const unsigned grid = (unsigned)p.tiles;
  fused_block_wgmma_kernel<PHASE_QKV><<<grid, NTW, WG_SMEM, stream>>>(maps, p);
  if (int e = (int)cudaGetLastError()) return e;
  fused_block_wgmma_kernel<PHASE_TAIL><<<grid, NTW, WG_SMEM, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

// Dense f32 attention takes the tiled two-phase path above DENSE_MAX_T rows.
int dense_tiled(int T, int w) { return (w <= 0 && T > DENSE_MAX_T) ? 1 : 0; }

int tile_rows(int T, int w, int tiled) { return (w > 0 || tiled) ? TQ_BAND : T; }

int launch_f32(Params p, int B, cudaStream_t stream) {
  const int bytes = Layout(p.tq, p.w).bytes();
  static int configured = 0;    // largest dynamic smem size set so far
  if (int e = set_smem(fused_block_kernel<float>, bytes, configured)) return e;
  dim3 grid((p.T + p.tq - 1) / p.tq, B);
  if (p.phase == PHASE_WHOLE) {
    fused_block_kernel<float><<<grid, NT, bytes, stream>>>(p);
    return (int)cudaGetLastError();
  }
  p.phase = PHASE_KV;
  fused_block_kernel<float><<<grid, NT, bytes, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  p.phase = PHASE_ATTN;
  fused_block_kernel<float><<<grid, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) a launch needs, or -1 if the shape is not
// supported (a half window above BAND_MAX_W).
int avdd_fused_block_smem(int T, int w, int dtype) {
  if (w > BAND_MAX_W) return -1;
  if (dtype == 1) return WG_SMEM;
  return Layout(tile_rows(T, w, dense_tiled(T, w)), w).bytes();
}

// Launch on `stream`; returns the first CUDA error (0 = launched).
// dtype: 0 float32, 1 bfloat16. mode: 0 self, 1 qv_k, 2 kv, 3 ds_self.
// Dense weights: (out, in) row-major in the compute dtype (torch's Linear
// layout), for both dtypes. coefs: (B, 2) f32 droppath coefficients of the
// training forward, or null. kv: a scratch in the compute dtype, (B, T, 3C)
// for bfloat16 (the q | k | v rows between its two launches, any window);
// for float32 (B, T, 2C), needed by dense attention only, whose path is
// picked here (dense_tiled).
int avdd_fused_block(const void* x, const void* xo, const void* mask,
                     const void* vecs, const void* wq, const void* wk,
                     const void* wv, const void* wp, const void* wf1,
                     const void* wf2, const void* fc1b, void* out, void* kv,
                     const void* coefs, int B, int T, int c, int n_head, int w, int mode,
                     int dtype, void* stream) {
  const int tiled = dense_tiled(T, w);
  if (c != C || n_head != NH || avdd_fused_block_smem(T, w, dtype) < 0 ||
      mode < 0 || mode > 3 || B <= 0 || T <= 0 || ((tiled || dtype == 1) && !kv) ||
      dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    ParamsW p;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.xo = static_cast<const __nv_bfloat16*>(xo ? xo : x);
    p.mask = static_cast<const uint8_t*>(mask);
    p.vecs = static_cast<const float*>(vecs);
    p.fc1b = static_cast<const float*>(fc1b);
    p.coefs = static_cast<const float*>(coefs);
    p.qkv = static_cast<__nv_bfloat16*>(kv);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.T = T; p.w = w > 0 ? w : 0; p.mode = mode;
    p.tiles = B * ((T + WG_ROWS - 1) / WG_ROWS);
    const void* ws[6] = {wq, wk, wv, wp, wf1, wf2};
    return launch_wgmma(p, ws, s);
  }
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
  return launch_f32(p, B, s);
}

}  // extern "C"
