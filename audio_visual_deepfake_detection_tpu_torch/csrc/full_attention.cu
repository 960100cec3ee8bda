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
// (479^2 f32 = 0.9 MB a (sample, head)) stay on chip.
//
// The softmax is the TPU kernel's two-pass one: the maximum over all keys,
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
// warpgroup's exps overlap another's products. cp.async rather than TMA: q,
// k, v arrive as strided views of one (B, T, 3, H, d) projection, and a
// 16-byte copy per thread needs no tensor map per call.
// f32: FMA at full precision, 32 query rows a block with their score rows
// in shared memory (8 rows when T is past ~1600, up to T ~ 6600). q, k, v
// and out are addressed through (sample, head, row) strides, so the caller's
// projection output and (B, T, H d) result need no copies.

#include "wgmma.cuh"

namespace {

using namespace avdd;

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int KT = 64;                // keys per staged tile
constexpr int MAXD = 64;              // largest head dim

struct Params {
  const void* q; const void* k; const void* v;
  const float* bias;                              // (B, T) or null
  void* out;
  long long qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost;
  int H, T, d;
};

template <int R>
__host__ __device__ inline int fma_smem_floats(int d, int T) {
  const int ldd = d + 1;
  return R * ldd + R * T + KT * ldd + R;
}

// ---- f32: FMA at full precision, R query rows a block ---------------------
template <int R>
__global__ void __launch_bounds__(NT)
full_mha_kernel(Params p) {
  constexpr int ACC = R * MAXD / NT;    // P.V outputs per thread
  constexpr int RPT = R / (NT / KT);    // score rows per thread
  using T = float;
  using N = Num<T>;
  extern __shared__ __align__(16) float sm[];
  const int d = p.d, ldd = d + 1, nk = p.T;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int n0 = blockIdx.y * R;
  float* Q = sm;
  float* Sc = Q + R * ldd;           // R x nk scores, then exps
  float* KV = Sc + R * nk;           // KT keys (or values) x d
  float* Z = KV + KT * ldd;
  const T* q = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kp = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* vp = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh;
  const float* bias = p.bias ? p.bias + (size_t)b * nk : nullptr;

  for (int idx = threadIdx.x; idx < R * d; idx += NT) {
    const int r = idx / d, c = idx % d, n = n0 + r;
    Q[r * ldd + c] = n < nk ? N::load(q, (size_t)n * p.qst + c) : 0.f;
  }
  // ---- scores: thread owns key kk of the tile and rows rg + 4 i ----------
  const int kk = threadIdx.x % KT, rg = threadIdx.x / KT;
  for (int k0 = 0; k0 < nk; k0 += KT) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < KT * d; idx += NT) {
      const int j = idx / d, c = idx % d, key = k0 + j;
      KV[j * ldd + c] = key < nk ? N::load(kp, (size_t)key * p.kst + c) : 0.f;
    }
    __syncthreads();
    const int key = k0 + kk;
    if (key >= nk) continue;
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    const float* krow = KV + kk * ldd;
    for (int c = 0; c < d; ++c) {
      const float kv = krow[c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(Q[(rg + 4 * i) * ldd + c], kv, acc[i]);
    }
    const float kb = bias ? bias[key] : 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) Sc[(rg + 4 * i) * nk + key] = acc[i] + kb;
  }
  __syncthreads();

  // ---- softmax: a warp per row; exps rounded to the compute dtype --------
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += NWARP) {
    float* srow = Sc + r * nk;
    float m = -CUDART_INF_F;
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float z = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = N::rnd(expf(srow[j] - m));
      srow[j] = e;
      z += e;
    }
    z = warp_sum(z);
    if (lane == 0) Z[r] = z;
  }

  // ---- P.V: thread owns outputs threadIdx.x + NT a (row-major R x d) -----
  float o[ACC];
  int orow[ACC], ocol[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int idx = min((int)threadIdx.x + NT * a, R * d - 1);
    o[a] = 0.f; orow[a] = idx / d; ocol[a] = idx % d;
  }
  const int nacc = (R * d + NT - 1 - (int)threadIdx.x) / NT;
  for (int k0 = 0; k0 < nk; k0 += KT) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < KT * d; idx += NT) {
      const int j = idx / d, c = idx % d, key = k0 + j;
      KV[j * ldd + c] = key < nk ? N::load(vp, (size_t)key * p.vst + c) : 0.f;
    }
    __syncthreads();
    const int kn = min(KT, nk - k0);
    for (int j = 0; j < kn; ++j) {
      const float* vrow = KV + j * ldd;
#pragma unroll
      for (int a = 0; a < ACC; ++a)
        if (a < nacc) o[a] = fmaf(Sc[orow[a] * nk + k0 + j], vrow[ocol[a]], o[a]);
    }
  }
  T* out = static_cast<T*>(p.out) + b * p.osb + h * p.osh;
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    if (a >= nacc) break;
    const int r = orow[a], n = n0 + r;
    if (n >= nk) continue;
    N::store(out, (size_t)n * p.ost + ocol[a], N::rnd(o[a] / Z[r]));
  }
}

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
constexpr int TILE_BYTES = KT * 128;  // 64 rows of 128 bytes
constexpr int WG_SMEM = NS * TILE_BYTES + NS * KT * 4 + 1024;   // tiles, key biases, alignment

__global__ void __launch_bounds__(NTW, 2)
full_mha_wgmma_kernel(Params p) {
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
      for (int i = 0; i < KT * 8 / NTW; ++i) {
        const int idx = tid + NTW * i, r = idx / 8, c = idx % 8, row = k0 + r;
        const bool ok = row < nk && 8 * c < d;
        cp_async16_to(dst + swz(r, c), ok ? src + (size_t)row * st + 8 * c : src, ok ? 16 : 0);
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

  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = 16 * kk + 2 * t;
    const bool ok = 16 * kk < d;
    qa[kk][0] = ok && row0 < nk ? ld_pair(q + (size_t)row0 * p.qst + c) : 0u;
    qa[kk][1] = ok && row1 < nk ? ld_pair(q + (size_t)row1 * p.qst + c) : 0u;
    qa[kk][2] = ok && row0 < nk ? ld_pair(q + (size_t)row0 * p.qst + c + 8) : 0u;
    qa[kk][3] = ok && row1 < nk ? ld_pair(q + (size_t)row1 * p.qst + c + 8) : 0u;
  }

  float S[32], O[32];
  uint32_t pa[4][4] = {};
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, z0 = 0.f, z1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) S[i] = O[i] = 0.f;

  for (int j = 0; j < ntot; ++j) {
    cp_wait<NS - 2>();          // this thread's copies of tile j have landed
    fence_async_shared();
    __syncthreads();            // everyone's have, and tile j - 1 is consumed
    load_tile(j + NS - 1);      // into the stage tile j - 1 left
    const int stage = j % NS;
    const uint32_t tile = tiles + stage * TILE_BYTES;
    const bool is_v = j >= nt && ((j - nt) & 1);
    if (is_v) {                 // O += P V_i: V (key, c) is a transposed B
      fence_regs(O);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRS<64, 1>::run(O, pa[kk], tile_desc(tile + kk * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(O);
      continue;
    }
    // S = q K_i^T, then + bias, padded keys at -inf
    const int k0 = (j < nt ? j : (j - nt) / 2) * KT;
    fence_regs(S);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (16 * kk < d) WgmmaRS<64, 0>::run(S, qa[kk], tile_desc(tile + kk * 32), kk > 0);
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
  for (int jj = 0; jj < 8; ++jj) {
    const int c = 8 * jj + 2 * t;
    if (c >= d) continue;
    if (row0 < nk)
      N::store2(out, (size_t)row0 * p.ost + c, N::rnd(O[4 * jj] / z0), N::rnd(O[4 * jj + 1] / z0));
    if (row1 < nk)
      N::store2(out, (size_t)row1 * p.ost + c, N::rnd(O[4 * jj + 2] / z1),
                N::rnd(O[4 * jj + 3] / z1));
  }
}

// f32: 32 query rows a block while their score rows fit, else 8.
bool f32_wide(int d, int T) { return 4 * fma_smem_floats<32>(d, T) <= SMEM_MAX; }

int smem_bytes(bool mma, int d, int T) {
  if (mma) return WG_SMEM;
  return 4 * (f32_wide(d, T) ? fma_smem_floats<32>(d, T) : fma_smem_floats<8>(d, T));
}

template <int R>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  static int configured = 0;
  const int bytes = 4 * fma_smem_floats<R>(p.d, p.T);
  if (int e = set_smem(full_mha_kernel<R>, bytes, configured)) return e;
  full_mha_kernel<R><<<dim3(B * p.H, (p.T + R - 1) / R), NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch(const Params& p, int B, bool mma, cudaStream_t stream) {
  if (!mma) return f32_wide(p.d, p.T) ? launch_f32<32>(p, B, stream) : launch_f32<8>(p, B, stream);
  static int configured = 0;
  if (int e = set_smem(full_mha_wgmma_kernel, WG_SMEM, configured)) return e;
  // row blocks fastest: the blocks of a (sample, head) run together and share its k, v in L2
  full_mha_wgmma_kernel<<<(unsigned)((p.T + BMW - 1) / BMW * B * p.H), NTW, WG_SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) a launch at (T, d, dtype) needs; more than
// 232448 cannot launch (float32 only: its score rows grow with T).
int avdd_full_mha_smem(int T, int d, int dtype) { return smem_bytes(dtype == 1, d, T); }

// Launch on `stream`; returns cudaGetLastError() (0 = launched). q, k, v and
// out hold (B, H, T, d) addressed through (sample, head, row) strides in
// elements, rows of d contiguous values; bias (B, T) f32 or null. dtype: 0
// float32, 1 bfloat16. bfloat16 takes a head dim that is a multiple of 16
// and q, k, v rows on 16-byte boundaries (the wrapper copies what is not);
// anything else is refused.
int avdd_full_mha(const void* q, const void* k, const void* v, const void* bias, void* out,
                  int B, int H, int T, int d,
                  long long qsb, long long qsh, long long qst,
                  long long ksb, long long ksh, long long kst,
                  long long vsb, long long vsh, long long vst,
                  long long osb, long long osh, long long ost, int dtype, void* stream) {
  const long long strides[] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst};
  bool vec_ok = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0 && ost % 2 == 0 &&
                osb % 2 == 0 && osh % 2 == 0 && (uintptr_t)out % 4 == 0;
  for (long long s : strides) vec_ok = vec_ok && s % 8 == 0;
  const bool mma = dtype == 1;
  if (B <= 0 || H <= 0 || T <= 0 || d <= 0 || d > MAXD || dtype < 0 || dtype > 1 ||
      (mma && (d % 16 != 0 || !vec_ok ||
               (long long)B * H * ((T + BMW - 1) / BMW) > 0x7fffffffLL)) ||
      smem_bytes(mma, d, T) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.qsb = qsb; p.qsh = qsh; p.qst = qst; p.ksb = ksb; p.ksh = ksh; p.kst = kst;
  p.vsb = vsb; p.vsh = vsh; p.vst = vst; p.osb = osb; p.osh = osh; p.ost = ost;
  p.H = H; p.T = T; p.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(p, B, mma, s);
}

}  // extern "C"
