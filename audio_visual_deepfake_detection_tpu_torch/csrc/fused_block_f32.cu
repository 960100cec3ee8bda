// The float32 fused block (K1 / K6 in f32, the compute dtype of every shipped
// YAML) for Hopper: 3xTF32 products on wgmma. It computes what block_math
// (ops/kernels/fused_block.py, the JAX block_math's f32 path) computes:
// two-pass LN, the exact rational GELU, f32 sums of the products, the -1e4
// masked-key penalty and -1e30 outside the band or on dense invalid keys, an
// f32 softmax, invalid query rows zeroed, the droppath coefficients in the
// layer scales.
//
// What bounds it: 24 C^2 operations a row for the six products (and 4 C a
// key of attention) against a few KB of a row moved. On the CUDA cores
// (67 TFLOP/s in f32) the products bound it; on the tensor cores in TF32
// (495 TFLOP/s) they run three times: each f32 value x is split into a TF32
// high part hi = rna(x) and a TF32 residual lo = rna(x - hi), and a product
// is summed as hi.hi + hi.lo + lo.hi in the f32 accumulators (lo.lo, below
// 2^-22 of it, is left out), so a product costs three TF32 ones, ~165
// TFLOP/s of f32 at the peak. A single TF32 pass (~3 decimal digits) is not
// taken: f32 stays full precision. Measured on an H100 against block_math
// with its f32 steps in f64 (tools/k1_compare_trees.py --precision), the
// block's worst |d| is 0.3-0.6x the first design's FMA loop's at the
// production shapes; from block_math in f32 it is up to 2.8x the FMA
// loop's, since that loop summed in the order of the f32 matmuls it is held
// to, and shared their rounding (tests/test_torch_f32_block.py models the
// tensor cores' truncating sums).
//
// Design. The f32 operands take twice the bytes of bf16 ones and both parts
// of each, so a 64-row tile of every stream and the weight ring (what the
// bf16 kernel keeps in shared memory) do not fit from C = 512 on. The block
// runs as eight launches through a scratch in device memory instead, each
// product a GEMM whose operands arrive split:
//   1. prep: the six weights split into hi / lo (12 C^2 each), and the key
//      columns of the transposed v past T zeroed;
//   2. streams: per (row, stream), a warp (a block past C = 1024, where a
//      lane's share of three rows would spill) LNs the three input rows the
//      k3 conv reads, convolves, LNs, and writes the row split (R, 3C);
//   3. qkv GEMM (N = 3C, K = C; each output tile reads its stream's input
//      columns): bias, q scaled -> q (R, C) as it is, k split (R, C), v
//      split and transposed (B, C, Tp), the layouts the attention reads;
//   4. attention (fused_block_f32_attend.cu; head widths other than 32 /
//      64 / 96 / 128 padded with zeros to the next, past 128 in 128-column
//      blocks) -> the context split (R, C);
//   5. proj GEMM: bias, masked skip (ds_self: the max-pool of the odd rows
//      around), layer-scaled residual -> y1 in the output rows;
//   6. LN of y1 (a warp a row, a block past C = 1024) -> split (R, C);
//   7. fc1 GEMM: bias, exact GELU -> the hidden units split (R, 4C);
//   8. fc2 GEMM (K = 4C): bias, masked, layer-scaled onto y1 -> the output.
// The GEMM is wgmma.cuh's Tf32Gemm mainloop (K4's f32 products share it):
// a block of two consumer warpgroups (64 rows each, so 128 rows) and a
// producer warp, an output tile of BN = 128 columns (64 where C is not a
// multiple of 128, or where 128 leaves SMs idle); the producer's TMA
// brings each 32-deep slice of A hi, A lo, W hi and W lo into a ring of
// three stages; the weight slice serves the tile's 128 rows. Per stage each
// warpgroup sums hi.lo, lo.hi, then hi.hi into a per-stage sum that f32
// adds into the accumulators, the two warpgroups' stages interleaving on
// the SM. The epilogue works on the accumulators in registers (thread
// (g, t) of warp w: rows 16 w + g and + 8, columns 8 j + 2 t, + 1).

#include "fused_block.cuh"

namespace avdd_k1 {
namespace {

constexpr int GSTAGES = 3;
enum { EPI_QKV = 0, EPI_PROJ = 1, EPI_FC1 = 2, EPI_FC2 = 3 };

struct GemmMaps { CUtensorMap ahi, alo, whi, wlo; };

// the 3xTF32 mainloop (wgmma.cuh) on operands split beforehand
template <int BN> using GemmTile = Tf32Gemm<BN, GSTAGES, true>;
constexpr int GM_ROWS = GemmTile<64>::ROWS;       // rows a GEMM block: two consumer warpgroups
constexpr int GK = GemmTile<64>::KS;              // contraction values a stage: one 128-byte row
constexpr int G_THREADS = GemmTile<64>::THREADS;  // two consumer warpgroups and a producer warp

// ---- 1. prep ------------------------------------------------------------------
__global__ void __launch_bounds__(256) f32_prep_kernel(const __grid_constant__ ParamsF p) {
  const long long C2 = (long long)p.C * p.C;
  const long long n4 = 3 * C2;                      // float4s of the 12 C^2 weights
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const long long e = 4 * i;                      // element of [wq; wk; wv; wp; wf1; wf2]
    const int m = e < 4 * C2 ? (int)(e / C2) : (e < 8 * C2 ? 4 : 5);
    const long long off = m < 4 ? m * C2 : (m == 4 ? 4 * C2 : 8 * C2);
    const float4 v = __ldg(reinterpret_cast<const float4*>(p.wt[m] + (e - off)));
    const float vv[4] = {v.x, v.y, v.z, v.w};
    float h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t hh, ll;
      tf32_split(vv[k], hh, ll);
      h[k] = __uint_as_float(hh);
      l[k] = __uint_as_float(ll);
    }
    *reinterpret_cast<float4*>(p.whi + e) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(p.wlo + e) = make_float4(l[0], l[1], l[2], l[3]);
  }
  // keys T .. Tp - 1 of every transposed v row: zero, so that the attention's
  // last tile multiplies its zero probabilities by finite values
  const int pad = p.Tp - p.T;
  const long long npad = (long long)p.B * p.C * pad;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < npad; i += stride) {
    const size_t at = (size_t)(i / pad) * p.Tp + p.T + i % pad;
    p.vthi[at] = 0.f;
    p.vtlo[at] = 0.f;
  }
}

// ---- 2. streams: LN -> depthwise k3 conv (masked) -> LN, split ----------------
// Plain LN (two-pass) of one row held by a warp: lane owns channels
// lane + 32 i, i < nc (= C / 32 <= NC).
template <int NC>
__device__ __forceinline__ void ln_plain_row(float (&v)[NC], int nc, int C) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (i < nc) s += v[i];
  const float mu = warp_sum(s) / C;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (i < nc) { const float r = v[i] - mu; s2 += r * r; }
  const float rs = rsqrtf(warp_sum(s2) / C + LN_EPS);
#pragma unroll
  for (int i = 0; i < NC; ++i) v[i] = (v[i] - mu) * rs;
}

// A warp per (row, stream): the stream's three input rows (ds_self: odd
// s - 1, even s, odd s; else s - 1, s, s + 1; zero outside the sequence) LN'd
// with the stream's affine, the conv's taps, the row's mask, LN, split.
template <int NC>
__global__ void __launch_bounds__(256) f32_streams_kernel(const __grid_constant__ ParamsF p) {
  const long long task = ((long long)blockIdx.x * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const long long R = (long long)p.B * p.T;
  if (task >= 3 * R) return;
  const int which = (int)(task % 3), C = p.C, nc = C / 32, T_ = p.T;
  const long long m = task / 3;
  const int b = (int)(m / T_), s = (int)(m % T_);
  const float* v = p.vecs;
  const float* xb = p.x + (size_t)b * T_ * C;
  const float* ob = p.xo + (size_t)b * T_ * C;
  // the stream's source rows and LN affine (block_math's qkv_rows)
  const bool ds = p.mode == MODE_DS_SELF;
  int rw = ROW_LNQ_W;
  const float* src = xb;
  if (!ds && p.mode != MODE_SELF && which > 0) {
    rw = which == 1 ? ROW_LNK_W : ROW_LNV_W;
    src = (which == 1 || p.mode == MODE_KV) ? ob : xb;
  }
  float l[3][NC];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* base = ds ? (r == 1 ? xb : ob) : src;
    const int sr = ds ? (r == 0 ? s - 1 : s) : s - 1 + r;
    const bool in = sr >= 0 && sr < T_;
#pragma unroll
    for (int i = 0; i < NC; ++i) l[r][i] = (in && i < nc) ? __ldg(base + (size_t)sr * C + lane + 32 * i) : 0.f;
    if (in) ln_plain_row(l[r], nc, C);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      l[r][i] = (in && i < nc) ? l[r][i] * v[rw * C + c] + v[(rw + 1) * C + c] : 0.f;
    }
  }
  const float mv = p.mask[m] ? 1.f : 0.f;
  const int tap = ROW_QCONV + 3 * which;
  float y[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = i < nc ? lane + 32 * i : 0;
    y[i] = i < nc ? (l[0][i] * v[tap * C + c] + l[1][i] * v[(tap + 1) * C + c] +
                     l[2][i] * v[(tap + 2) * C + c]) * mv
                  : 0.f;
  }
  ln_plain_row(y, nc, C);
  float* hi = p.xhi + (size_t)m * 3 * C + which * C;
  float* lo = p.xlo + (size_t)m * 3 * C + which * C;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (i >= nc) continue;
    uint32_t h, q;
    tf32_split(y[i], h, q);
    hi[lane + 32 * i] = __uint_as_float(h);
    lo[lane + 32 * i] = __uint_as_float(q);
  }
}

// ---- 6. LN of y1 (ln2's affine folded into wf1), split -------------------------
template <int NC>
__global__ void __launch_bounds__(256) f32_ln_kernel(const __grid_constant__ ParamsF p) {
  const long long m = ((long long)blockIdx.x * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32, C = p.C, nc = C / 32;
  if (m >= (long long)p.B * p.T) return;
  float y[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) y[i] = i < nc ? p.out[(size_t)m * C + lane + 32 * i] : 0.f;
  ln_plain_row(y, nc, C);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (i >= nc) continue;
    uint32_t h, q;
    tf32_split(y[i], h, q);
    p.chi[(size_t)m * C + lane + 32 * i] = __uint_as_float(h);
    p.clo[(size_t)m * C + lane + 32 * i] = __uint_as_float(q);
  }
}

// ---- 2 and 6 past C = 1024: a block a row (stream_row_block, ln_block_row) ----
// There a warp's three rows of C / 32 values a lane would spill.
__global__ void __launch_bounds__(RB_THREADS) f32_streams_block_kernel(
    const __grid_constant__ ParamsF p) {
  __shared__ float red[RB_THREADS / 32];
  const long long m = blockIdx.x;
  const int which = blockIdx.y, C = p.C;
  float y[RB_V];
  stream_row_block<float>(p.x, p.xo, p.mask, p.vecs, p.T, C, p.mode, m, which, y, red);
  float* hi = p.xhi + (size_t)m * 3 * C + which * C;
  float* lo = p.xlo + (size_t)m * 3 * C + which * C;
#pragma unroll
  for (int j = 0; j < RB_V; ++j) {
    const int c = threadIdx.x + RB_THREADS * j;
    if (c >= C) continue;
    uint32_t h, q;
    tf32_split(y[j], h, q);
    hi[c] = __uint_as_float(h);
    lo[c] = __uint_as_float(q);
  }
}

__global__ void __launch_bounds__(RB_THREADS) f32_ln_block_kernel(const __grid_constant__ ParamsF p) {
  __shared__ float red[RB_THREADS / 32];
  const size_t m = blockIdx.x;
  const int C = p.C;
  float y[RB_V];
#pragma unroll
  for (int j = 0; j < RB_V; ++j) {
    const int c = threadIdx.x + RB_THREADS * j;
    y[j] = c < C ? p.out[m * C + c] : 0.f;
  }
  ln_block_row<false>(y, C, red);
#pragma unroll
  for (int j = 0; j < RB_V; ++j) {
    const int c = threadIdx.x + RB_THREADS * j;
    if (c >= C) continue;
    uint32_t h, q;
    tf32_split(y[j], h, q);
    p.chi[m * C + c] = __uint_as_float(h);
    p.clo[m * C + c] = __uint_as_float(q);
  }
}

// ---- 3, 5, 7, 8: the 3xTF32 GEMM and its epilogues -----------------------------
// out[m, n] = sum_k A[m, k] W[n, k] over k < K for the block's 128 rows and
// BN columns; A's columns start at the output tile's stream (EPI_QKV: the
// tile's n0 / C; BN divides C).
template <int EPI, int BN>
__global__ void __launch_bounds__(G_THREADS, 1)
f32_gemm_kernel(const __grid_constant__ GemmMaps maps, const __grid_constant__ ParamsF p,
                int K) {
  using G = GemmTile<BN>;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t base = (smem_u32(smraw) + 1023u) & ~1023u;
  const int m0 = blockIdx.x * GM_ROWS, n0 = blockIdx.y * BN, C = p.C;
  const int acol = EPI == EPI_QKV ? n0 / C * C : 0;
  const int nk = K / GK;
  G::init(base);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {                     // the producer warp: one thread issues the TMA
    if (threadIdx.x == 256)
      G::produce(base, &maps.ahi, &maps.alo, &maps.whi, &maps.wlo, acol, m0, n0, nk);
    return;
  }
  float acc[BN / 2];
  G::consume(base, wg, nk, acc, [](int, uint32_t, uint32_t) {});

  // epilogue: element (row 16 warp + g + 8 hf, column 8 j + 2 t + e)
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const long long R = (long long)p.B * p.T;
  const float* v = p.vecs;
  const float qscale = (float)(1.0 / sqrt((double)p.D));   // block_math's f32 1 / sqrt(d)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long long m = (long long)m0 + 64 * wg + 16 * warp + g + 8 * hf;
    if (m >= R) continue;
    const int b = (int)(m / p.T), sq = (int)(m % p.T);
    const float mq = p.mask[m] ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      float y0 = acc[4 * j + 2 * hf], y1 = acc[4 * j + 2 * hf + 1];
      if (EPI == EPI_QKV) {
        const int which = n0 / C, c = n - which * C;
        const int brow = (ROW_Q_BIAS + which) * C;
        y0 += v[brow + c];
        y1 += v[brow + c + 1];
        if (which == 0) {
          *reinterpret_cast<float2*>(p.q + (size_t)m * C + c) = make_float2(y0 * qscale,
                                                                            y1 * qscale);
        } else if (which == 1) {
          store_split2(p.khi, p.klo, (size_t)m * C + c, y0, y1);
        } else {                       // v^T (b, c, s)
          uint32_t h0, l0, h1, l1;
          tf32_split(y0, h0, l0);
          tf32_split(y1, h1, l1);
          const size_t at = ((size_t)b * C + c) * p.Tp + sq;
          p.vthi[at] = __uint_as_float(h0);
          p.vtlo[at] = __uint_as_float(l0);
          p.vthi[at + p.Tp] = __uint_as_float(h1);
          p.vtlo[at + p.Tp] = __uint_as_float(l1);
        }
      } else if (EPI == EPI_PROJ) {
        const float coef = p.coefs ? p.coefs[2 * b] : 1.f;
        const float2 xs = *reinterpret_cast<const float2*>(p.x + (size_t)m * C + n);
        float sk[2] = {xs.x, xs.y};
        if (p.mode == MODE_DS_SELF) {    // MaxPool(3, 2, 1), -inf padding
          const float2 o = *reinterpret_cast<const float2*>(p.xo + (size_t)m * C + n);
          float2 om1 = make_float2(-CUDART_INF_F, -CUDART_INF_F);
          if (sq > 0) om1 = *reinterpret_cast<const float2*>(p.xo + (size_t)(m - 1) * C + n);
          sk[0] = fmaxf(fmaxf(om1.x, sk[0]), o.x);
          sk[1] = fmaxf(fmaxf(om1.y, sk[1]), o.y);
        }
        const float a0 = (y0 + v[ROW_P_BIAS * C + n]) * mq, a1 = (y1 + v[ROW_P_BIAS * C + n + 1]) * mq;
        const float s0 = v[ROW_SCALE_ATTN * C + n] * coef, s1 = v[ROW_SCALE_ATTN * C + n + 1] * coef;
        *reinterpret_cast<float2*>(p.out + (size_t)m * C + n) =
            make_float2(sk[0] * mq + a0 * s0, sk[1] * mq + a1 * s1);
      } else if (EPI == EPI_FC1) {
        y0 = gelu<false>(y0 + p.fc1b[n]);
        y1 = gelu<false>(y1 + p.fc1b[n + 1]);
        store_split2(p.xhi, p.xlo, (size_t)m * 4 * C + n, y0, y1);
      } else {
        const float coef = p.coefs ? p.coefs[2 * b + 1] : 1.f;
        float2* o = reinterpret_cast<float2*>(p.out + (size_t)m * C + n);
        const float2 r = *o;
        const float h0 = (y0 + v[ROW_FC2_BIAS * C + n]) * mq, h1 = (y1 + v[ROW_FC2_BIAS * C + n + 1]) * mq;
        *o = make_float2(r.x + h0 * (v[ROW_SCALE_MLP * C + n] * coef),
                         r.y + h1 * (v[ROW_SCALE_MLP * C + n + 1] * coef));
      }
    }
  }
}

// One GEMM: A (R, a_cols) split, W (N, K) split; output columns N.
template <int EPI, int BN>
int launch_gemm_bn(const ParamsF& p, const float* ahi, const float* alo, int a_cols,
                   const float* whi, const float* wlo, int N, int K, cudaStream_t stream) {
  static int configured = 0;
  if (int e = set_smem(f32_gemm_kernel<EPI, BN>, GemmTile<BN>::SMEM, configured)) return e;
  const uint64_t R = (uint64_t)p.B * p.T;
  GemmMaps maps;
  const uint64_t ad[2] = {(uint64_t)a_cols, R}, as[1] = {4ull * a_cols};
  const uint64_t wd[2] = {(uint64_t)K, (uint64_t)N}, ws[1] = {4ull * K};
  const uint32_t abox[2] = {GK, GM_ROWS}, wbox[2] = {GK, (uint32_t)BN};
  if (int e = f32_tensor_map(&maps.ahi, ahi, 2, ad, as, abox)) return e;
  if (int e = f32_tensor_map(&maps.alo, alo, 2, ad, as, abox)) return e;
  if (int e = f32_tensor_map(&maps.whi, whi, 2, wd, ws, wbox)) return e;
  if (int e = f32_tensor_map(&maps.wlo, wlo, 2, wd, ws, wbox)) return e;
  const dim3 grid((unsigned)((R + GM_ROWS - 1) / GM_ROWS), (unsigned)(N / BN));
  f32_gemm_kernel<EPI, BN><<<grid, G_THREADS, GemmTile<BN>::SMEM, stream>>>(maps, p, K);
  return (int)cudaGetLastError();
}

// Output tiles of 128 columns where C allows it and they fill the card;
// else 64.
template <int EPI>
int launch_gemm(const ParamsF& p, const float* ahi, const float* alo, int a_cols,
                const float* whi, const float* wlo, int N, int K, cudaStream_t stream) {
  const long long rows = ((long long)p.B * p.T + GM_ROWS - 1) / GM_ROWS;
  const bool wide = p.C % 128 == 0 && rows * (N / 128) >= 132;
  return wide ? launch_gemm_bn<EPI, 128>(p, ahi, alo, a_cols, whi, wlo, N, K, stream)
              : launch_gemm_bn<EPI, 64>(p, ahi, alo, a_cols, whi, wlo, N, K, stream);
}

template <int NC>
int launch_rows(const ParamsF& p, cudaStream_t stream) {
  const long long R = (long long)p.B * p.T;
  f32_streams_kernel<NC><<<(unsigned)((3 * R + 7) / 8), 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}
template <int NC>
int launch_ln(const ParamsF& p, cudaStream_t stream) {
  const long long R = (long long)p.B * p.T;
  f32_ln_kernel<NC><<<(unsigned)((R + 7) / 8), 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The streams' rows (2) and the LN (6): a warp a row up to C = 1024, a
// block a row past it.
int launch_rows_any(const ParamsF& p, cudaStream_t stream) {
  const int C = p.C;
  if (C <= 1024)
    return C <= 256 ? launch_rows<8>(p, stream)
                    : (C <= 512 ? launch_rows<16>(p, stream) : launch_rows<32>(p, stream));
  f32_streams_block_kernel<<<dim3((unsigned)((long long)p.B * p.T), 3), RB_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}
int launch_ln_any(const ParamsF& p, cudaStream_t stream) {
  const int C = p.C;
  if (C <= 1024)
    return C <= 256 ? launch_ln<8>(p, stream)
                    : (C <= 512 ? launch_ln<16>(p, stream) : launch_ln<32>(p, stream));
  f32_ln_block_kernel<<<(unsigned)((long long)p.B * p.T), RB_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_f32(ParamsF& p, float* scratch, cudaStream_t stream) {
  f32_carve(p, scratch);
  const int C = p.C;
  const long long C2 = (long long)C * C;
  f32_prep_kernel<<<264, 256, 0, stream>>>(p);
  if (int e = (int)cudaGetLastError()) return e;
  int e = launch_rows_any(p, stream);
  if (e) return e;
  if ((e = launch_gemm<EPI_QKV>(p, p.xhi, p.xlo, 3 * C, p.whi, p.wlo, 3 * C, C, stream)))
    return e;
  if ((e = launch_f32_attend(p, stream))) return e;
  if ((e = launch_gemm<EPI_PROJ>(p, p.chi, p.clo, C, p.whi + 3 * C2, p.wlo + 3 * C2, C, C,
                                 stream)))
    return e;
  if ((e = launch_ln_any(p, stream))) return e;
  if ((e = launch_gemm<EPI_FC1>(p, p.chi, p.clo, C, p.whi + 4 * C2, p.wlo + 4 * C2, 4 * C, C,
                                stream)))
    return e;
  return launch_gemm<EPI_FC2>(p, p.xhi, p.xlo, 4 * C, p.whi + 8 * C2, p.wlo + 8 * C2, C,
                              4 * C, stream);
}

}  // namespace avdd_k1
