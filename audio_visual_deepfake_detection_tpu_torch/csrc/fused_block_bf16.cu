// The bfloat16 fused block (K1 / K6 in bf16) at the shapes of shape_ok past
// wgmma_shape_ok: head widths other than 32 / 64 / 96 / 128 (any multiple of
// 8 from 8 to 512) and C from 1088 to 2048, the four modes, any window, any
// T. It computes what the Pallas kernel computes at those shapes
// (audio_visual_deepfake_detection_tpu/ops/pallas/fused_block.py, generated
// per shape by _make_kernel at :224) with the rounding points of the plain
// version block_math (ops/kernels/fused_block.py): LN moments one-pass in
// bf16, every cdot summed in f32 and rounded once, the bias adds, q scale,
// mask, residual and layer scale each rounded as block_math's bf16 steps
// round them, the division-free GELU, droppath coefficients multiplied into
// the layer scales in f32 and rounded once. The attention is
// fused_block_attend.cu's (its numerics are stated there; the banded scores
// are exact sums of exact products, rounded once, where block_math rounds
// each product and sums the context offset by offset in bf16).
//
// What bounds it: 24 C^2 operations a row for the six products against a
// few KB moved: the tensor cores, once the products run on them. The bf16
// two-launch instances (fused_block.cu) keep a 64 x C tile of every stream
// in shared memory and their weights' ring beside it, which stops at C =
// 1024; their in-tile attention and the tensor-core attention launch are
// built for head widths 32 / 64 / 96 / 128.
//
// Design: the f32 route's eight launches through a scratch in device memory
// (fused_block_f32.cu), in bf16, with bf16_scratch_elems = 7 B T C values:
//   1. (none: the bf16 weights are read as they are);
//   2. streams: a block per (row, stream) (stream_row_block): the LN of the
//      input rows the k3 conv reads, the conv, the mask, the LN -> a3 (R, 3C);
//   3. q | k | v GEMM (N = 3C, K = C; an output tile's A columns and weight
//      are its stream's): bias, q scaled -> qkv (R, 3C), the layout the
//      attention launch reads;
//   4. attention (fused_block_attend.cu): head widths up to 128 on the
//      instance of 32 / 64 / 96 / 128 (zeros past D), the context over q;
//      past 128 the wide kernel, its context into a3;
//   5. proj GEMM: bias, mask, the skip (ds_self: the max-pool of the odd
//      rows around), layer-scaled residual -> y1 in the output rows;
//   6. LN of y1 (a block a row) -> h (R, C);
//   7. fc1 GEMM: bias, GELU -> hid (R, 4C), over a3 and qkv;
//   8. fc2 GEMM (K = 4C): bias, mask, layer-scaled onto y1 -> the output.
// The GEMM is wgmma.cuh's Tf32Gemm mainloop with PROD_BF16: a block of two
// consumer warpgroups (128 rows) and a producer warp, output tiles of BN =
// 128 columns (64 where C is no multiple of 128 or 128 leaves SMs idle), a
// ring of four stages of one 64-deep slice of A and of W by TMA (128B
// swizzled, straight from torch's (out, in) layout), one m64nBNk16 product
// per k16 step summed by the tensor cores per stage and added in f32.

#include "fused_block.cuh"

namespace avdd_k1 {
namespace {

constexpr int BSTAGES = 4;
enum { EPI_QKV = 0, EPI_PROJ = 1, EPI_FC1 = 2, EPI_FC2 = 3 };

// A, and the weight of each stream (q | k | v: three; else one)
struct GemmMapsB { CUtensorMap a, w[3]; };

template <int BN> using GemmTileB = Tf32Gemm<BN, BSTAGES, true, 1, PROD_BF16>;
constexpr int GB_ROWS = GemmTileB<64>::ROWS;       // rows a GEMM block
constexpr int GBK = GemmTileB<64>::KS;             // contraction values a stage
constexpr int GB_THREADS = GemmTileB<64>::THREADS;

__device__ __forceinline__ float ldb(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// ---- 2. streams: LN -> depthwise k3 conv (masked) -> LN, a block a row --------
__global__ void __launch_bounds__(RB_THREADS) bf16_rows_kernel(const __grid_constant__ ParamsB p) {
  __shared__ float red[RB_THREADS / 32];
  const long long m = blockIdx.x;
  const int which = blockIdx.y, C = p.C;
  float y[RB_V];
  stream_row_block<__nv_bfloat16>(p.x, p.xo, p.mask, p.vecs, p.T, C, p.mode, m, which, y, red);
  __nv_bfloat16* dst = p.a3 + (size_t)m * 3 * C + which * C;
#pragma unroll
  for (int j = 0; j < RB_V; ++j) {
    const int c = threadIdx.x + RB_THREADS * j;
    if (c < C) dst[c] = __float2bfloat16_rn(y[j]);
  }
}

// ---- 6. LN of y1 (ln2's affine folded into wf1), a block a row -----------------
__global__ void __launch_bounds__(RB_THREADS) bf16_ln_kernel(const __grid_constant__ ParamsB p) {
  __shared__ float red[RB_THREADS / 32];
  const size_t m = blockIdx.x;
  const int C = p.C;
  float y[RB_V];
#pragma unroll
  for (int j = 0; j < RB_V; ++j) {
    const int c = threadIdx.x + RB_THREADS * j;
    y[j] = c < C ? ldb(p.out, m * C + c) : 0.f;
  }
  ln_block_row<true>(y, C, red);
#pragma unroll
  for (int j = 0; j < RB_V; ++j) {
    const int c = threadIdx.x + RB_THREADS * j;
    if (c < C) p.h[m * C + c] = __float2bfloat16_rn(y[j]);
  }
}

// ---- 3, 5, 7, 8: the bf16 GEMM and its epilogues --------------------------------
// out[m, n] = sum_k A[m, k] W[n, k] over k < K for the block's 128 rows and
// BN columns; EPI_QKV: A's columns and the weight are the output tile's
// stream's (n0 / C; BN divides C).
template <int EPI, int BN>
__global__ void __launch_bounds__(GB_THREADS, 1)
bf16_gemm_kernel(const __grid_constant__ GemmMapsB maps, const __grid_constant__ ParamsB p,
                 int K) {
  using G = GemmTileB<BN>;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t base = (smem_u32(smraw) + 1023u) & ~1023u;
  const int m0 = blockIdx.x * GB_ROWS, n0 = blockIdx.y * BN, C = p.C;
  const int which = EPI == EPI_QKV ? n0 / C : 0;
  const int nk = K / GBK;
  G::init(base);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {                     // the producer warp: one thread issues the TMA
    if (threadIdx.x == 256)
      G::produce(base, &maps.a, nullptr, &maps.w[which], nullptr, which * C, m0,
                 n0 - which * C, nk);
    return;
  }
  float acc[BN / 2];
  G::consume(base, wg, nk, acc, [](int, uint32_t, uint32_t) {});

  // epilogue: element (row 16 warp + g + 8 hf, column 8 j + 2 t + e), each
  // step rounded as block_math's bf16 steps round it
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const long long R = (long long)p.B * p.T;
  const float* v = p.vecs;
  const float qscale = rnd16((float)(1.0 / sqrt((double)p.D)));
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long long m = (long long)m0 + 64 * wg + 16 * warp + g + 8 * hf;
    if (m >= R) continue;
    const int b = (int)(m / p.T), sq = (int)(m % p.T);
    const float mv = p.mask[m] ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float cv = rnd16(acc[4 * j + 2 * hf + e]);
        const int nn = n + e;
        if (EPI == EPI_QKV) {
          y[e] = rnd16(cv + rnd16(v[(ROW_Q_BIAS + which) * C + nn - which * C]));
          if (which == 0) y[e] = rnd16(y[e] * qscale);
        } else if (EPI == EPI_PROJ) {
          const size_t at = (size_t)m * C + nn;
          const float att = rnd16(rnd16(cv + rnd16(v[ROW_P_BIAS * C + nn])) * mv);
          float skip = ldb(p.x, at);
          if (p.mode == MODE_DS_SELF) {  // MaxPool(3, 2, 1) over odd[t - 1], even[t], odd[t]
            const float xd = ldb(p.xo, at);
            const float om1 = sq == 0 ? -CUDART_INF_F : ldb(p.xo, at - C);
            skip = om1 >= fmaxf(skip, xd) ? om1 : (skip >= xd ? skip : xd);
          }
          const float coef = p.coefs ? p.coefs[2 * b] : 1.f;
          const float sa = rnd16(__fmul_rn(v[ROW_SCALE_ATTN * C + nn], coef));
          y[e] = rnd16(__fadd_rn(rnd16(__fmul_rn(skip, mv)), rnd16(__fmul_rn(att, sa))));
        } else if (EPI == EPI_FC1) {
          y[e] = rnd16(gelu<true>(rnd16(cv + rnd16(p.fc1b[nn]))));
        } else {
          const float hh = rnd16(rnd16(cv + rnd16(v[ROW_FC2_BIAS * C + nn])) * mv);
          const float coef = p.coefs ? p.coefs[2 * b + 1] : 1.f;
          const float sm = rnd16(__fmul_rn(v[ROW_SCALE_MLP * C + nn], coef));
          y[e] = rnd16(__fadd_rn(ldb(p.out, (size_t)m * C + nn), rnd16(__fmul_rn(hh, sm))));
        }
      }
      __nv_bfloat16* dst = EPI == EPI_QKV ? p.qkv + (size_t)m * 3 * C + n
                         : EPI == EPI_FC1 ? p.hid + (size_t)m * 4 * C + n
                                          : p.out + (size_t)m * C + n;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(y[0], y[1]);
    }
  }
}

// One GEMM: A (R, a_cols) with rows a_stride values apart; W (N, K), or the
// three (C, C) weights wq, wk, wv for EPI_QKV (N = 3C).
template <int EPI, int BN>
int launch_gemm_bn(const ParamsB& p, const __nv_bfloat16* a, int a_cols, int a_stride,
                   const __nv_bfloat16* const* w, int N, int K, cudaStream_t stream) {
  static int configured = 0;
  if (int e = set_smem(bf16_gemm_kernel<EPI, BN>, GemmTileB<BN>::SMEM, configured)) return e;
  const uint64_t R = (uint64_t)p.B * p.T;
  GemmMapsB maps;
  const uint64_t ad[2] = {(uint64_t)a_cols, R}, as[1] = {2ull * a_stride};
  const uint32_t abox[2] = {GBK, GB_ROWS}, wbox[2] = {GBK, (uint32_t)BN};
  if (int e = bf16_tensor_map(&maps.a, a, 2, ad, as, abox)) return e;
  const int nw = EPI == EPI_QKV ? 3 : 1;
  const uint64_t wd[2] = {(uint64_t)K, (uint64_t)(N / nw)}, ws[1] = {2ull * K};
  for (int i = 0; i < nw; ++i)
    if (int e = bf16_tensor_map(&maps.w[i], w[i], 2, wd, ws, wbox)) return e;
  const dim3 grid((unsigned)((R + GB_ROWS - 1) / GB_ROWS), (unsigned)(N / BN));
  bf16_gemm_kernel<EPI, BN><<<grid, GB_THREADS, GemmTileB<BN>::SMEM, stream>>>(maps, p, K);
  return (int)cudaGetLastError();
}

// Output tiles of 128 columns where C allows it and they fill the card;
// else 64.
template <int EPI>
int launch_gemm(const ParamsB& p, const __nv_bfloat16* a, int a_cols, int a_stride,
                const __nv_bfloat16* const* w, int N, int K, cudaStream_t stream) {
  const long long rows = ((long long)p.B * p.T + GB_ROWS - 1) / GB_ROWS;
  const bool wide = p.C % 128 == 0 && rows * (N / 128) >= 132;
  return wide ? launch_gemm_bn<EPI, 128>(p, a, a_cols, a_stride, w, N, K, stream)
              : launch_gemm_bn<EPI, 64>(p, a, a_cols, a_stride, w, N, K, stream);
}

}  // namespace

int launch_bf16(ParamsB& p, __nv_bfloat16* scratch, cudaStream_t stream) {
  const long long R = (long long)p.B * p.T;
  if (R > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bf16_carve(p, scratch);
  const int C = p.C;
  bf16_rows_kernel<<<dim3((unsigned)R, 3), RB_THREADS, 0, stream>>>(p);
  int e = (int)cudaGetLastError();
  if (e) return e;
  if ((e = launch_gemm<EPI_QKV>(p, p.a3, 3 * C, 3 * C, p.wt, 3 * C, C, stream))) return e;
  if ((e = launch_attend_scratch(p, stream))) return e;
  const bool in_a3 = ctx_in_a3(p.D);
  if ((e = launch_gemm<EPI_PROJ>(p, in_a3 ? p.a3 : p.qkv, C, in_a3 ? C : 3 * C, p.wt + 3, C, C,
                                 stream)))
    return e;
  bf16_ln_kernel<<<(unsigned)R, RB_THREADS, 0, stream>>>(p);
  if ((e = (int)cudaGetLastError())) return e;
  if ((e = launch_gemm<EPI_FC1>(p, p.h, C, C, p.wt + 4, 4 * C, C, stream))) return e;
  return launch_gemm<EPI_FC2>(p, p.hid, 4 * C, 4 * C, p.wt + 5, C, 4 * C, stream);
}

}  // namespace avdd_k1
