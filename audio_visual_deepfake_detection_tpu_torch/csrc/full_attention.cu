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
// stay on chip. Those are 479^2 f32 = 0.9 MB a (sample, head) and do not fit
// in shared memory at once, so a block owns 32 query rows and all keys: its
// 32 x T f32 score rows stay in shared memory (66 KB at T = 479) and never
// reach device memory; k and v are re-read by each of the 15 row blocks of a
// (sample, head), from L2.
//
// The softmax is the TPU kernel's two-pass one: the maximum over all keys,
// exps rounded to the compute dtype, the denominator summed in f32 from the
// rounded exps, P.V accumulated in f32 and one divide per output element at
// the end. (An online softmax would rescale partial sums and round
// differently.) Padding query rows attend the valid keys like any other
// row; a row whose keys are all masked gets uniform weights: both finite.
// T need not be a multiple of the 64-key tile: the last tile's missing keys
// are zero-filled on load and take no weight.
//
// bf16 (head dim a multiple of 16): q.k and P.V on mma.sync m16n8k16 (f32
// accumulate); key and value tiles of 64 rows arrive by cp.async in two
// buffers, tile it + 1 loading while tile it computes; two blocks fit an SM
// at T = 479. f32: FMA at full precision. q, k, v and out are addressed
// through (sample, head, row) strides, so the caller's (B, T, 3, H, d)
// projection output and (B, T, H d) result need no copies. Left for later:
// wgmma, keeping the exps in bf16 to halve the shared-memory rows.

#include "common.cuh"

namespace {

using namespace avdd;

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int R = 32;                 // query rows per block
constexpr int KT = 64;                // keys per staged tile
constexpr int MAXD = 64;              // largest head dim
constexpr int ACC = R * MAXD / NT;    // P.V outputs per thread (FMA kernel)
constexpr int RPT = R / (NT / KT);    // score rows per thread (FMA kernel)

struct Params {
  const void* q; const void* k; const void* v;
  const float* bias;                              // (B, T) or null
  void* out;
  long long qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost;
  int H, T, d;
};

__host__ __device__ inline int fma_smem_floats(int d, int T) {
  const int ldd = d + 1;
  return R * ldd + R * T + KT * ldd + R;
}

// ---- f32: FMA at full precision ------------------------------------------
__global__ void __launch_bounds__(NT)
full_mha_kernel(Params p) {
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

// ---- bf16 on the tensor cores ----------------------------------------------
// Warp w owns the 16-row half w % 2 of the block's 32 rows and a quarter
// w / 2 of the columns (16 keys of a score tile, then d / 4 of the output).
constexpr int LDB = 8;                      // bf16 pad of a shared row

struct MmaLayout {      // shared-memory carve-up in bytes
  int ldq, nkp, q, kt, sc, z, bytes;
  __host__ __device__ MmaLayout(int d, int nk) {
    ldq = d + LDB;
    nkp = (nk + KT - 1) / KT * KT;
    q = 0;
    kt = q + 2 * R * ldq;               // two K (then V) tiles
    sc = kt + 2 * 2 * KT * ldq;
    z = sc + 4 * R * (nkp + 4);
    bytes = z + 4 * R;
  }
};

// A fragment of rows [m0, m0 + 16) at column k0 of a bf16 row-major tile.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* A, int ld,
                                       int m0, int k0) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const __nv_bfloat16* r0 = A + (m0 + g) * ld + k0 + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * ld;
  a[0] = ld_pair(r0); a[1] = ld_pair(r1); a[2] = ld_pair(r0 + 8); a[3] = ld_pair(r1 + 8);
}

// Rows [r0, r0 + rows) of a strided (., d) bf16 array into a shared tile by
// cp.async; rows at or past `hi` are zero-filled.
__device__ __forceinline__ void copy_rows_async(__nv_bfloat16* dst, int ldq,
                                                const __nv_bfloat16* src, long long stride,
                                                int r0, int rows, int hi, int d) {
  const int d8 = d / 8;
  for (int idx = threadIdx.x; idx < rows * d8; idx += NT) {
    const int j = idx / d8, c = 8 * (idx % d8), row = r0 + j;
    const bool ok = row < hi;
    cp_async16(dst + j * ldq + c, src + (size_t)(ok ? row : 0) * stride + c, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(NT, 2)
full_mha_mma_kernel(Params p) {
  using N = Num<__nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smb[];
  const int d = p.d, nk = p.T;
  const MmaLayout L(d, nk);
  const int ldq = L.ldq, lds = L.nkp + 4;
  __nv_bfloat16* Q = reinterpret_cast<__nv_bfloat16*>(smb + L.q);
  __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(smb + L.kt);   // [2][KT][ldq]
  float* Sc = reinterpret_cast<float*>(smb + L.sc);
  float* Z = reinterpret_cast<float*>(smb + L.z);
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int n0 = blockIdx.y * R;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h * p.ksh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + h * p.vsh;
  const float* bias = p.bias ? p.bias + (size_t)b * nk : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mt = 16 * (warp % 2), wq = warp / 2;     // row half, column quarter
  const int ntiles = L.nkp / KT;

  copy_rows_async(Kb, ldq, kp, p.kst, 0, KT, nk, d);
  cp_commit();
  for (int idx = threadIdx.x; idx < R * (d / 8); idx += NT) {
    const int r = idx / (d / 8), c = 8 * (idx % (d / 8)), n = n0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < nk) v = *reinterpret_cast<const uint4*>(q + (size_t)n * p.qst + c);
    *reinterpret_cast<uint4*>(Q + r * ldq + c) = v;
  }

  // ---- scores -> Sc; tile it + 1 loads while tile it computes --------------
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * KT;
    const __nv_bfloat16* Kt = Kb + (it & 1) * KT * ldq;
    cp_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) {
      copy_rows_async(Kb + ((it + 1) & 1) * KT * ldq, ldq, kp, p.kst, k0 + KT, KT, nk, d);
      cp_commit();
    }
    float sa[2][4] = {};
    for (int c0 = 0; c0 < d; c0 += 16) {
      uint32_t a[4];
      frag_a(a, Q, ldq, mt, c0);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* br = Kt + (16 * wq + 8 * j + g) * ldq + c0 + 2 * t;
        mma_bf16(sa[j], a, ld_pair(br), ld_pair(br + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt + g + (e >= 2 ? 8 : 0);
        const int key = k0 + 16 * wq + 8 * j + 2 * t + (e & 1);
        Sc[r * lds + key] = sa[j][e] + ((bias && key < nk) ? bias[key] : 0.f);
      }
  }
  __syncthreads();

  copy_rows_async(Kb, ldq, vp, p.vst, 0, KT, nk, d);   // V tile 0 loads during the softmax
  cp_commit();

  // ---- softmax: exps rounded to bf16, the tile padding's keys 0 ------------
  for (int r = warp; r < R; r += NWARP) {
    float* srow = Sc + r * lds;
    float m = -CUDART_INF_F;
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float z = 0.f;
    for (int j = lane; j < L.nkp; j += 32) {
      const float e = j < nk ? N::rnd(expf(srow[j] - m)) : 0.f;
      srow[j] = e;
      z += e;
    }
    z = warp_sum(z);
    if (lane == 0) Z[r] = z;
  }

  // ---- P.V: this warp's rows, head-dim columns 8 (wq + 4 i) ----------------
  const int ntile = d / 8;
  const int mine = (ntile - wq + 3) / 4;             // n8 tiles of this warp
  float oa[MAXD / 32][4] = {};
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * KT;
    const __nv_bfloat16* Vs = Kb + (it & 1) * KT * ldq;   // row-major (key, c)
    cp_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) {
      copy_rows_async(Kb + ((it + 1) & 1) * KT * ldq, ldq, vp, p.vst, k0 + KT, KT, nk, d);
      cp_commit();
    }
    for (int kk = 0; kk < KT; kk += 16) {
      const float* s0 = Sc + (mt + g) * lds + k0 + kk + 2 * t;
      const float* s1 = s0 + 8 * lds;
      const uint32_t a[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s1[0], s1[1]),
                             pack_bf16(s0[8], s0[9]), pack_bf16(s1[8], s1[9])};
#pragma unroll
      for (int i = 0; i < MAXD / 32; ++i) {
        if (i >= mine) break;
        uint32_t b0, b1;
        frag_b_trans(b0, b1, Vs, ldq, kk, 8 * (wq + 4 * i));
        mma_bf16(oa[i], a, b0, b1);
      }
    }
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + b * p.osb + h * p.osh;
#pragma unroll
  for (int i = 0; i < MAXD / 32; ++i) {
    if (i >= mine) break;
    const int c = 8 * (wq + 4 * i) + 2 * t;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mt + g + 8 * hf, n = n0 + r;
      if (n >= nk) continue;
      N::store2(out, (size_t)n * p.ost + c, N::rnd(oa[i][2 * hf] / Z[r]),
                N::rnd(oa[i][2 * hf + 1] / Z[r]));
    }
  }
}

// bf16: the tensor-core kernel; f32: FMA.
int smem_bytes(bool mma, int d, int T) {
  return mma ? MmaLayout(d, T).bytes : 4 * fma_smem_floats(d, T);
}

int launch(const Params& p, int B, bool mma, cudaStream_t stream) {
  const int bytes = smem_bytes(mma, p.d, p.T);
  dim3 grid(B * p.H, (p.T + R - 1) / R);
  if (mma) {
    static int configured = 0;
    if (int e = set_smem(full_mha_mma_kernel, bytes, configured)) return e;
    full_mha_mma_kernel<<<grid, NT, bytes, stream>>>(p);
  } else {
    static int configured = 0;
    if (int e = set_smem(full_mha_kernel, bytes, configured)) return e;
    full_mha_kernel<<<grid, NT, bytes, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) a launch at (T, d, dtype) needs; more than
// 232448 cannot launch.
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
      (mma && (d % 16 != 0 || !vec_ok)) || smem_bytes(mma, d, T) > SMEM_MAX)
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
