// Full (non-banded) multi-head attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel audio_visual_deepfake_detection_tpu/ops/pallas/
// full_attention.py::full_mha (pl.pallas_call at :101), K8, the attention of
// every Emotion2Vec AltBlock:
//
//   out = softmax(q k^T + key_bias) v
//
// for q (already scaled), k, v (B, H, T, d) and an additive per-sample key
// bias (0 = attend, -1e30 = padding key; absent = no padding).
//
// What bounds it on this card: 4 T^2 d operations a (sample, head) against
// 4 T d values moved (q, k, v in, out back): T / 2 = 240 operations a byte in
// bf16 at T = 479, just under the H100's ridge of ~295, so the bound is
// device memory with the tensor cores close behind, as long as the scores
// (479^2 f32 = 0.9 MB a (sample, head)) stay on chip. In f32 each product
// is three TF32 ones: 12 T^2 d operations at the TF32 rate, the bound.
//
// bf16's softmax is the TPU kernel's two-pass one: the maximum over all keys,
// exps rounded to the compute dtype, the denominator summed in f32 from the
// rounded exps, P.V accumulated in f32 and one divide per output element at
// the end. (An online softmax would rescale partial sums and round
// differently.) Padding query rows attend the valid keys like any other
// row; a row whose keys are all masked gets uniform weights: both finite.
//
// bf16 (head dim a multiple of 16), what the design does: the scores never
// leave registers. A block of two warpgroups owns 128 query rows, q held as
// the register A operand of wgmma (m64n64k16, f32 accumulate). Pass 1 walks
// the key tiles, computes q k^T per 64-key tile and keeps only the running
// row maximum (exact in any order). Pass 2 recomputes each score tile, takes
// exp(s - m) rounded to bf16 in the accumulator's registers, sums it into z,
// and hands the same registers to the P.V wgmma as its A operand (the
// accumulator layout of one product is the A layout of the next). That is
// 6 T^2 d operations instead of 4, for no shared-memory scores, no rescaling
// and no cap on T. Key and value tiles stream through a four-stage ring of
// 128B-swizzled shared tiles filled by cp.async three tiles ahead, one
// __syncthreads per tile; a (sample, head)'s k and v are re-read by its 4
// row blocks (T = 479), from L2. The ragged last key tile is zero-filled on
// load and masked in registers (-inf, weight 0). 34 KB of shared memory and
// at most 128 registers a thread: two blocks, four warpgroups, an SM, so one
// warpgroup's exps overlap another's products. Head dims 80-128 take the
// instance of width 128: a tile row is two 64-column swizzled sub-tiles,
// q k^T runs eight 16-deep steps and P.V two 64-column products, one block
// an SM (66 KB, the context's 64 accumulators more a thread). cp.async rather than TMA: q,
// k, v arrive as strided views of one (B, T, 3, H, d) projection, and a
// 16-byte copy per thread needs no tensor map per call.
// f32: 3xTF32 on the tensor cores, the KEY_BIAS mode of the f32 pooled
// attention (mvit_attention_f32.cu, K3's and K4's): 64 query rows a
// warpgroup over 32-key tiles, each tile's k and v staged as they are by
// cp.async and split into TF32 parts in shared memory (v transposed), an
// online softmax (the
// row maximum and denominator kept over the tiles, the context rescaled when
// the maximum moves; "exps rounded to f32" is no rounding), each product
// hi.hi + hi.lo + lo.hi with every 32-deep stage's tensor-core sum folded
// into f32. It differs from the two-pass softmax by f32 rounding only, and
// keeps no score rows: T has no cap. q, k, v and out are addressed through
// (sample, head, row) strides, so the caller's projection output and
// (B, T, H d) result need no copies.

#include "mvit_f32.cuh"

namespace {

using namespace avdd;

constexpr int KT = 64;                // keys per staged tile
constexpr int MAXD = 128;             // largest head dim

struct Params {
  const void* q; const void* k; const void* v;
  const float* bias;                              // (B, T) or null
  void* out;
  long long qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost;
  int H, T, d;
};

// ---- bf16 on the tensor cores (wgmma) ---------------------------------------
// A block owns BMW = 128 query rows, 64 per warpgroup; warp w of a warpgroup
// owns rows 16 w .. 16 w + 15 and thread (g, t) the rows g and g + 8 of them.
// q stays in registers as the A operand for the whole kernel. Key and value
// tiles of KT = 64 rows stream through a ring of NS swizzled stages in the
// order K_0 .. K_n-1 (pass 1), then K_0, V_0, K_1, V_1, ... (pass 2); all 256
// threads copy a tile with cp.async, NS - 1 tiles ahead of the products.
constexpr int NTW = 256;              // two warpgroups
constexpr int BMW = 128;              // query rows per block
constexpr int NS = 4;                 // ring stages
constexpr int SUB_BYTES = KT * 128;   // 64 rows of 128 bytes: 64 columns of a tile

// The kernel's widths: DW = 64 for head dims up to 64, 128 above (a tile
// row is DW / 64 swizzled sub-tiles of 64 columns side by side, and the
// context DW / 64 accumulators of 64 columns; at DW = 128 its registers
// leave one block an SM).
template <int DW> struct Width {
  static constexpr int NSUB = DW / 64;
  static constexpr int TILE_BYTES = NSUB * SUB_BYTES;
  static constexpr int SMEM = NS * TILE_BYTES + NS * KT * 4 + 1024;   // tiles, key biases, alignment
};

template <int DW>
__global__ void __launch_bounds__(NTW, DW == 64 ? 2 : 1)
full_mha_wgmma_kernel(Params p) {
  constexpr int NSUB = Width<DW>::NSUB, TILE_BYTES = Width<DW>::TILE_BYTES, KS = DW / 16;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int d = p.d, nk = p.T;
  const uint32_t raw = smem_u32(smraw);
  const uint32_t tiles = (raw + 1023u) & ~1023u;            // shared address of stage 0
  const float* bias_sm = reinterpret_cast<const float*>(smraw + (tiles - raw) + NS * TILE_BYTES);
  const uint32_t bias_addr = tiles + NS * TILE_BYTES;
  // one grid axis (no 65535 cap on B H), row blocks fastest
  const int nrb = (nk + BMW - 1) / BMW, bh = blockIdx.x / nrb, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = (blockIdx.x % nrb) * BMW + 64 * wg + 16 * warp + g, row1 = row0 + 8;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h * p.ksh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + h * p.vsh;
  const float* bias = p.bias ? p.bias + (size_t)b * nk : nullptr;
  const int nt = (nk + KT - 1) / KT, ntot = 3 * nt;

  // tile j of the sequence -> stage j % NS; rows past T and columns past d are
  // zero-filled, so a padded key scores 0 (masked below) and weighs nothing
  auto load_tile = [&](int j) {
    if (j < ntot) {
      const bool is_v = j >= nt && ((j - nt) & 1);
      const int k0 = (j < nt ? j : (j - nt) / 2) * KT;
      const __nv_bfloat16* src = is_v ? vp : kp;
      const long long st = is_v ? p.vst : p.kst;
      const uint32_t dst = tiles + (j % NS) * TILE_BYTES;
#pragma unroll
      for (int i = 0; i < KT * 8 * NSUB / NTW; ++i) {
        const int idx = tid + NTW * i, r = idx / (8 * NSUB), cc = idx % (8 * NSUB);
        const int c = cc % 8, row = k0 + r;
        const bool ok = row < nk && 8 * cc < d;
        cp_async16_to(dst + (cc / 8) * SUB_BYTES + swz(r, c),
                      ok ? src + (size_t)row * st + 8 * cc : src, ok ? 16 : 0);
      }
      if (bias && !is_v && tid < KT) {
        const bool ok = k0 + tid < nk;
        cp_async4_to(bias_addr + ((j % NS) * KT + tid) * 4, ok ? bias + k0 + tid : bias,
                     ok ? 4 : 0);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) load_tile(j);

  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = 16 * kk + 2 * t;
    const bool ok = 16 * kk < d;
    qa[kk][0] = ok && row0 < nk ? ld_pair(q + (size_t)row0 * p.qst + c) : 0u;
    qa[kk][1] = ok && row1 < nk ? ld_pair(q + (size_t)row1 * p.qst + c) : 0u;
    qa[kk][2] = ok && row0 < nk ? ld_pair(q + (size_t)row0 * p.qst + c + 8) : 0u;
    qa[kk][3] = ok && row1 < nk ? ld_pair(q + (size_t)row1 * p.qst + c + 8) : 0u;
  }

  float S[32], O[NSUB][32];
  uint32_t pa[4][4] = {};
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, z0 = 0.f, z1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    S[i] = 0.f;
#pragma unroll
    for (int u = 0; u < NSUB; ++u) O[u][i] = 0.f;
  }

  for (int j = 0; j < ntot; ++j) {
    cp_wait<NS - 2>();          // this thread's copies of tile j have landed
    fence_async_shared();
    __syncthreads();            // everyone's have, and tile j - 1 is consumed
    load_tile(j + NS - 1);      // into the stage tile j - 1 left
    const int stage = j % NS;
    const uint32_t tile = tiles + stage * TILE_BYTES;
    const bool is_v = j >= nt && ((j - nt) & 1);
    if (is_v) {                 // O += P V_i: V (key, c) is a transposed B
#pragma unroll
      for (int u = 0; u < NSUB; ++u) {
        fence_regs(O[u]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaRS<64, 1>::run(O[u], pa[kk], tile_desc(tile + u * SUB_BYTES + kk * 2048), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(O[u]);
      }
      continue;
    }
    // S = q K_i^T, then + bias, padded keys at -inf
    const int k0 = (j < nt ? j : (j - nt) / 2) * KT;
    fence_regs(S);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      if (16 * kk < d)
        WgmmaRS<64, 0>::run(S, qa[kk], tile_desc(tile + (kk / 4) * SUB_BYTES + (kk % 4) * 32),
                            kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(S);
    const float* bs = bias_sm + stage * KT;
    const bool ragged = k0 + KT > nk;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 8 * jj + 2 * t;
      if (bias) {
        const float2 bb = *reinterpret_cast<const float2*>(bs + col);
        S[4 * jj] += bb.x; S[4 * jj + 1] += bb.y; S[4 * jj + 2] += bb.x; S[4 * jj + 3] += bb.y;
      }
      if (ragged) {
        if (k0 + col >= nk) S[4 * jj] = S[4 * jj + 2] = -CUDART_INF_F;
        if (k0 + col + 1 >= nk) S[4 * jj + 1] = S[4 * jj + 3] = -CUDART_INF_F;
      }
    }
    if (j < nt) {               // pass 1: the row maximum, exact in any order
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        m0 = fmaxf(m0, fmaxf(S[4 * jj], S[4 * jj + 1]));
        m1 = fmaxf(m1, fmaxf(S[4 * jj + 2], S[4 * jj + 3]));
      }
      if (j == nt - 1) {        // the row's four threads agree on it
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      }
    } else {                    // pass 2: exps (ex2.approx: its 2 ulp vanish in the bf16
                                // rounding) rounded to bf16, z from the rounded exps
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const __nv_bfloat162 e0 = __floats2bfloat162_rn(__expf(S[4 * jj] - m0),
                                                        __expf(S[4 * jj + 1] - m0));
        const __nv_bfloat162 e1 = __floats2bfloat162_rn(__expf(S[4 * jj + 2] - m1),
                                                        __expf(S[4 * jj + 3] - m1));
        z0 += __low2float(e0) + __high2float(e0);
        z1 += __low2float(e1) + __high2float(e1);
        pa[jj / 2][2 * (jj % 2)] = *reinterpret_cast<const uint32_t*>(&e0);
        pa[jj / 2][2 * (jj % 2) + 1] = *reinterpret_cast<const uint32_t*>(&e1);
      }
    }
  }
  cp_wait<0>();
  z0 += __shfl_xor_sync(0xffffffffu, z0, 1);
  z0 += __shfl_xor_sync(0xffffffffu, z0, 2);
  z1 += __shfl_xor_sync(0xffffffffu, z1, 1);
  z1 += __shfl_xor_sync(0xffffffffu, z1, 2);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + b * p.osb + h * p.osh;
  using N = Num<__nv_bfloat16>;
#pragma unroll
  for (int u = 0; u < NSUB; ++u)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 64 * u + 8 * jj + 2 * t;
      if (c >= d) continue;
      if (row0 < nk)
        N::store2(out, (size_t)row0 * p.ost + c, N::rnd(O[u][4 * jj] / z0),
                  N::rnd(O[u][4 * jj + 1] / z0));
      if (row1 < nk)
        N::store2(out, (size_t)row1 * p.ost + c, N::rnd(O[u][4 * jj + 2] / z1),
                  N::rnd(O[u][4 * jj + 3] / z1));
    }
}

template <int DW>
int launch_dw(const Params& p, int B, cudaStream_t stream) {
  static int configured = 0;
  constexpr int smem = Width<DW>::SMEM;
  if (int e = set_smem(full_mha_wgmma_kernel<DW>, smem, configured)) return e;
  // row blocks fastest: the blocks of a (sample, head) run together and share its k, v in L2
  full_mha_wgmma_kernel<DW><<<(unsigned)((p.T + BMW - 1) / BMW * B * p.H), NTW, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch(const Params& p, int B, cudaStream_t stream) {
  return p.d <= 64 ? launch_dw<64>(p, B, stream) : launch_dw<128>(p, B, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched). q, k, v and
// out hold (B, H, T, d) addressed through (sample, head, row) strides in
// elements, rows of d contiguous values; bias (B, T) f32 or null. dtype: 0
// float32, 1 bfloat16. bfloat16 takes a head dim that is a multiple of 16
// and q, k, v rows on 16-byte boundaries; float32 a head dim that is a
// multiple of 4, q, k, v and out on 16 bytes with strides that are
// multiples of 4. The wrapper copies what is not so; anything else is
// refused. When `route` is not null
// it receives the kernel launched: 0 bf16 wgmma, 1 f32 3xTF32 wgmma.
int avdd_full_mha(const void* q, const void* k, const void* v, const void* bias, void* out,
                  int B, int H, int T, int d,
                  long long qsb, long long qsh, long long qst,
                  long long ksb, long long ksh, long long kst,
                  long long vsb, long long vsh, long long vst,
                  long long osb, long long osh, long long ost, int dtype, void* stream,
                  int* route) {
  const long long strides[] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst};
  const uintptr_t qkv = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  if (B <= 0 || H <= 0 || T <= 0 || d <= 0 || d > MAXD || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    bool ok = d % 4 == 0 && (qkv | (uintptr_t)out) % 16 == 0 &&
              (osb | osh | ost) % 4 == 0;
    for (long long st : strides) ok = ok && st % 4 == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
    avdd_mvit::AttnF32 a{};
    a.q = static_cast<const float*>(q);
    a.qsb = qsb; a.qsh = qsh; a.qsn = qst;
    a.k = static_cast<const float*>(k);
    a.v = static_cast<const float*>(v);
    a.ksb = ksb; a.ksh = ksh; a.kst = kst; a.vsb = vsb; a.vsh = vsh; a.vst = vst;
    a.kbias = static_cast<const float*>(bias);
    a.out = static_cast<float*>(out);
    a.osb = osb; a.osh = osh; a.osn = ost;
    a.nh = H; a.T = T; a.d = d;
    const int e = avdd_mvit::launch_k8_f32(a, B, s);
    if (e == 0 && route) *route = 1;
    return e;
  }
  bool vec_ok = qkv % 16 == 0 && ost % 2 == 0 && osb % 2 == 0 && osh % 2 == 0 &&
                (uintptr_t)out % 4 == 0;
  for (long long st : strides) vec_ok = vec_ok && st % 8 == 0;
  if (d % 16 != 0 || !vec_ok || (long long)B * H * ((T + BMW - 1) / BMW) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.qsb = qsb; p.qsh = qsh; p.qst = qst; p.ksb = ksb; p.ksh = ksh; p.kst = kst;
  p.vsb = vsb; p.vsh = vsh; p.vst = vst; p.osb = osb; p.osh = osh; p.ost = ost;
  p.H = H; p.T = T; p.d = d;
  const int e = launch(p, B, s);
  if (e == 0 && route) *route = 0;
  return e;
}

}  // extern "C"
