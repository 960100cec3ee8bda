// MViT pooled attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel audio_visual_deepfake_detection_tpu/ops/pallas/
// mvit_attention.py::fused_pooled_attention (pl.pallas_call at :103), K3,
// and is the attention step of the whole-block kernel K4 (mvit_block.cu):
//
//   out = softmax(s) v (+ q),  s[n, k] = scale q[n].k[k] + band[n, k]
//
// with k/v pooled to a (T, 1, 1) grid: T grid keys then the class-token key
// LAST (no band on it). Two ways to get the band:
// - given (K3): a (BH, Nq, T) f32 array the caller built;
// - BAND_TABLE (K4): built here by index arithmetic from the temporal
//   rel-pos table, band[n, k] = q[n] . rel[t_n - k + T - 1], t_n = g / S for
//   grid row g; no shear, no gather array.
// Flags for K4: PRESCALE (q rounded to the compute dtype after the scale, as
// the XLA path; K3 scales the f32 scores instead), BAND_ROUND (the band
// rounded to the compute dtype: the XLA Toeplitz branch at S <= 4),
// CLS_FIRST (row 0 is the class-token query: no band, no residual).
// Numerics follow the plain versions (pooled_attention_math, msblock_math):
// f32 scores and softmax statistics, the exp rounded to the compute dtype,
// z summed from the rounded exps, P.V in f32 divided by z, rounded once,
// then the residual add in the compute dtype.
//
// What bounds it on this card: at production a row attends 513 keys of
// d = 96, so per row ~2 x 513 x 96 FMAs (three with the band) against 2 d
// values read and d written: far above the H100's ridge, compute-bound.
//
// Three kernels. K4's call (bf16, head dim 96, BAND_TABLE) takes
// pooled_attention_wgmma_kernel: scores, band and P.V on wgmma, the scores
// in registers, two passes that recompute them (the maximum, then the exps),
// no cap on Nk; its comment says the rest. K3's call (the band given as an
// array) and other head dims in bf16 take pooled_attention_mma_kernel: one
// 256-thread block per (sample x head, 32 query rows), q, the 32 x Nk f32
// score rows, a 64-key k (then v) tile and the rel-pos rows it needs in
// shared memory (~150 KB at Nk = 513, one block an SM), every product on
// mma.sync m16n8k16, the softmax over the stored row with no second pass
// over device memory and no online rescaling (which would round differently
// from the JAX kernel). float32 takes pooled_attention_kernel: the same
// layout with FMA products at full precision.

#include "wgmma.cuh"

namespace {

using namespace avdd;

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int R = 32;                 // query rows per block
constexpr int KT = 64;                // keys per staged tile
constexpr int MAXD = 128;             // largest head dim
constexpr int ACC = R * MAXD / NT;    // P.V outputs per thread
constexpr int RPT = R / (NT / KT);    // score rows per thread
enum { PRESCALE = 1, BAND_ROUND = 2, CLS_FIRST = 4, BAND_TABLE = 8 };

struct Params {
  const void* q; const void* k; const void* v;   // q strided; k, v (BH, Nk, d)
  const float* band;                              // (BH, Nq, Nk - 1), K3
  const void* rel;                                // (>= 2T - 1, d), BAND_TABLE
  void* out;
  long long qsb, qsh, qsn, osb, osh, osn;         // (sample, head, row) strides
  int nh, nq, nk, d, T, S, flags;
  float scale;
};

__host__ __device__ inline int smem_floats(int d, int nk) {
  const int ldd = d + 1;
  return 2 * R * ldd + R * nk + KT * ldd + (R + KT - 1) * ldd + R;
}

template <typename T>
__global__ void __launch_bounds__(NT)
pooled_attention_kernel(Params p) {
  using N = Num<T>;
  extern __shared__ __align__(16) float sm[];
  const int d = p.d, ldd = d + 1, nk = p.nk, nq = p.nq, nkg = nk - 1;
  const int bh = blockIdx.y, b = bh / p.nh, h = bh % p.nh;
  const int n0 = blockIdx.x * R;
  const int cls = (p.flags & CLS_FIRST) ? 1 : 0;
  const bool table = p.flags & BAND_TABLE;
  float* Qa = sm;                    // q as the scores read it
  float* Qb = Qa + R * ldd;          // q as stored (band, residual)
  float* Sc = Qb + R * ldd;          // R x nk scores, then exps
  float* KV = Sc + R * nk;           // KT keys (or values) x d
  float* Rl = KV + KT * ldd;         // rel-pos rows of the key tile
  float* Z = Rl + (R + KT - 1) * ldd;
  const T* q = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kp = static_cast<const T*>(p.k) + (size_t)bh * nk * d;
  const T* vp = static_cast<const T*>(p.v) + (size_t)bh * nk * d;

  const float qscale = N::rnd(p.scale);
  for (int idx = threadIdx.x; idx < R * d; idx += NT) {
    const int r = idx / d, c = idx % d, n = n0 + r;
    const float qv = n < nq ? N::load(q, (size_t)n * p.qsn + c) : 0.f;
    Qb[r * ldd + c] = qv;
    Qa[r * ldd + c] = (p.flags & PRESCALE) ? N::rnd(qv * qscale) : qv;
  }
  // time steps spanned by this tile's grid rows (the band table's window)
  const int g0 = max(n0 - cls, 0);
  const int g1 = max(min(n0 + R, nq) - 1 - cls, 0);
  const int t0 = g0 / p.S, t1 = g1 / p.S;

  // ---- scores: thread owns key kk of the tile and rows rg + 4 i ----------
  const int kk = threadIdx.x % KT, rg = threadIdx.x / KT;
  for (int k0 = 0; k0 < nk; k0 += KT) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < KT * d; idx += NT) {
      const int j = idx / d, c = idx % d, key = k0 + j;
      KV[j * ldd + c] = key < nk ? N::load(kp, (size_t)key * d + c) : 0.f;
    }
    const int rbase = t0 - (k0 + KT - 1) + p.T - 1;   // table row of Rl row 0
    const int nrel = t1 - t0 + KT;
    if (table) {
      for (int idx = threadIdx.x; idx < nrel * d; idx += NT) {
        const int j = idx / d, c = idx % d, row = rbase + j;
        Rl[j * ldd + c] = (row >= 0 && row <= 2 * p.T - 2)
                              ? N::load(static_cast<const T*>(p.rel), (size_t)row * d + c) : 0.f;
      }
    }
    __syncthreads();
    const int key = k0 + kk;
    if (key >= nk) continue;
    float acc[RPT], bacc[RPT];
    int rrow[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      acc[i] = 0.f; bacc[i] = 0.f;
      const int g = n0 + rg + 4 * i - cls;
      const int rr = (g >= 0 ? g / p.S : 0) - key + p.T - 1 - rbase;
      rrow[i] = min(max(rr, 0), nrel - 1);
    }
    const float* krow = KV + kk * ldd;
    for (int c = 0; c < d; ++c) {
      const float kv = krow[c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(Qa[(rg + 4 * i) * ldd + c], kv, acc[i]);
      if (table) {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          bacc[i] = fmaf(Qb[(rg + 4 * i) * ldd + c], Rl[rrow[i] * ldd + c], bacc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + 4 * i, n = n0 + r;
      if (n >= nq) continue;
      float s = (p.flags & PRESCALE) ? acc[i] : acc[i] * p.scale;
      if (n >= cls && key < nkg) {
        if (table)
          s += (p.flags & BAND_ROUND) ? N::rnd(bacc[i]) : bacc[i];
        else
          s += p.band[((size_t)bh * nq + n) * nkg + key];
      }
      Sc[r * nk + key] = s;
    }
  }
  __syncthreads();

  // ---- softmax: a warp per row; exps rounded to the compute dtype --------
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += NWARP) {
    float* srow = Sc + r * nk;
    if (n0 + r >= nq) {
      for (int j = lane; j < nk; j += 32) srow[j] = 0.f;
      if (lane == 0) Z[r] = 1.f;
      continue;
    }
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
      KV[j * ldd + c] = key < nk ? N::load(vp, (size_t)key * d + c) : 0.f;
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
    const int r = orow[a], c = ocol[a], n = n0 + r;
    if (n >= nq) continue;
    float y = N::rnd(o[a] / Z[r]);
    if (n >= cls) y = N::rnd(y + Qb[r * ldd + c]);
    N::store(out, (size_t)n * p.osn + c, y);
  }
}

// ---- bf16 on the tensor cores ------------------------------------------
// The same function for bf16 with every product (q.k, q.rel, P.V) on
// mma.sync m16n8k16 (bf16 in, f32 accumulate): products of bf16 values are
// exact in f32, so this differs from the FMA kernel only in summation
// order. The band comes from a small product G = q . rel^T over the table
// rows the key tile needs (at most R + KT - 1), read back by index. Warp w
// owns the 16-row half w % 2 of the tile and a quarter w / 2 of its columns.
constexpr int LDB = 8;                      // bf16 pad of a shared row
constexpr int NREL = R + KT;                // table rows per key tile (>= R + KT - 1)

// A fragment of rows [m0, m0 + 16) at column k0 of a bf16 row-major tile.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* A, int ld,
                                       int m0, int k0) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const __nv_bfloat16* r0 = A + (m0 + g) * ld + k0 + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * ld;
  a[0] = ld_pair(r0); a[1] = ld_pair(r1); a[2] = ld_pair(r0 + 8); a[3] = ld_pair(r1 + 8);
}

// acc[j] += A[m0:m0+16, :K] . Bt[n0 + 8 j : n0 + 8 j + 8, :K]^T for j < nt
// (Bt row-major (n, k): the mma's column-major B).
template <int MAXT>
__device__ __forceinline__ void mma_rows(float (&acc)[MAXT][4], int nt, const __nv_bfloat16* A,
                                         int lda, int m0, const __nv_bfloat16* Bt, int ldb,
                                         int n0, int K) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    frag_a(a, A, lda, m0, k0);
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      if (j >= nt) break;
      const __nv_bfloat16* br = Bt + (n0 + 8 * j + g) * ldb + k0 + 2 * t;
      mma_bf16(acc[j], a, ld_pair(br), ld_pair(br + 8));
    }
  }
}

struct MmaLayout {      // shared-memory carve-up in bytes
  int ldq, nkp, q, qb, kt, rel, g, sc, z, bytes;
  __host__ __device__ MmaLayout(int d, int nk) {
    ldq = d + LDB;
    nkp = (nk + KT - 1) / KT * KT;
    q = 0;
    qb = q + 2 * R * ldq;
    kt = qb + 2 * R * ldq;              // two K (then V) tiles
    rel = kt + 2 * 2 * KT * ldq;        // two rel-pos tiles
    g = rel + 2 * 2 * NREL * ldq;
    sc = g + 4 * R * (NREL + 4);
    z = sc + 4 * R * (nkp + 4);
    bytes = z + 4 * R;
  }
};

// Asynchronous 16-byte copies (cp.async) of rows [r0, r0 + rows) of a
// (., d) bf16 array into a shared tile; rows outside [0, hi) are zero-filled.
// The caller commits the group and waits for it before reading the tile.
__device__ __forceinline__ void copy_rows_async(__nv_bfloat16* dst, int ldq,
                                           const __nv_bfloat16* src, int r0, int rows,
                                           int hi, int d) {
  const int d8 = d / 8;
  for (int idx = threadIdx.x; idx < rows * d8; idx += NT) {
    const int j = idx / d8, c = 8 * (idx % d8), row = r0 + j;
    const bool ok = row >= 0 && row < hi;
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + j * ldq + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src + (size_t)(ok ? row : 0) * d + c), "r"(ok ? 16 : 0));
  }
}
__global__ void __launch_bounds__(NT, 1)
pooled_attention_mma_kernel(Params p) {
  using N = Num<__nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smb[];
  const int d = p.d, nk = p.nk, nq = p.nq, nkg = nk - 1;
  const MmaLayout L(d, nk);
  const int ldq = L.ldq, lds = L.nkp + 4, ldg = NREL + 4;
  __nv_bfloat16* Qa = reinterpret_cast<__nv_bfloat16*>(smb + L.q);
  __nv_bfloat16* Qb = reinterpret_cast<__nv_bfloat16*>(smb + L.qb);
  __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(smb + L.kt);   // [2][KT][ldq]
  __nv_bfloat16* Rb = reinterpret_cast<__nv_bfloat16*>(smb + L.rel);  // [2][NREL][ldq]
  float* G = reinterpret_cast<float*>(smb + L.g);
  float* Sc = reinterpret_cast<float*>(smb + L.sc);
  float* Z = reinterpret_cast<float*>(smb + L.z);
  const int bh = blockIdx.y, b = bh / p.nh, h = bh % p.nh;
  const int n0 = blockIdx.x * R;
  const int cls = (p.flags & CLS_FIRST) ? 1 : 0;
  const bool table = p.flags & BAND_TABLE;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + (size_t)bh * nk * d;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + (size_t)bh * nk * d;
  const __nv_bfloat16* rel = static_cast<const __nv_bfloat16*>(p.rel);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mt = 16 * (warp % 2), wq = warp / 2;     // row half, column quarter

  const float qscale = N::rnd(p.scale);
  for (int idx = threadIdx.x; idx < R * (d / 8); idx += NT) {
    const int r = idx / (d / 8), c = 8 * (idx % (d / 8)), n = n0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < nq) v = *reinterpret_cast<const uint4*>(q + (size_t)n * p.qsn + c);
    *reinterpret_cast<uint4*>(Qb + r * ldq + c) = v;
    if (p.flags & PRESCALE) {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * qscale);
    }
    *reinterpret_cast<uint4*>(Qa + r * ldq + c) = v;
  }
  const int t0 = max(n0 - cls, 0) / p.S;

  // ---- scores + band -> Sc; tile it + 1 loads while tile it computes ------
  const int ntiles = L.nkp / KT;
  auto rbase_of = [&](int k0) { return t0 - (k0 + KT - 1) + p.T - 1; };
  auto load_kr = [&](int it) {
    const int buf = it & 1;
    copy_rows_async(Kb + buf * KT * ldq, ldq, kp, it * KT, KT, nk, d);
    if (table)
      copy_rows_async(Rb + buf * NREL * ldq, ldq, rel, rbase_of(it * KT), NREL, 2 * p.T - 1, d);
    cp_commit();
  };
  load_kr(0);
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * KT, rbase = rbase_of(k0);
    const __nv_bfloat16* Kt = Kb + (it & 1) * KT * ldq;
    const __nv_bfloat16* Rs = Rb + (it & 1) * NREL * ldq;
    cp_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) load_kr(it + 1);
    if (table) {   // G = Qb . Rs^T: this warp's rows, columns [24 wq, 24 wq + 24)
      float ga[3][4] = {};
      mma_rows<3>(ga, 3, Qb, ldq, mt, Rs, ldq, 24 * wq, d);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int col = 24 * wq + 8 * j + 2 * t;
        G[(mt + g) * ldg + col] = ga[j][0];
        G[(mt + g) * ldg + col + 1] = ga[j][1];
        G[(mt + g + 8) * ldg + col] = ga[j][2];
        G[(mt + g + 8) * ldg + col + 1] = ga[j][3];
      }
    }
    float sa[2][4] = {};
    mma_rows<2>(sa, 2, Qa, ldq, mt, Kt, ldq, 16 * wq, d);
    __syncthreads();   // G complete
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt + g + (e >= 2 ? 8 : 0);
        const int key = k0 + 16 * wq + 8 * j + 2 * t + (e & 1);
        const int n = n0 + r;
        float s = (p.flags & PRESCALE) ? sa[j][e] : sa[j][e] * p.scale;
        if (n >= cls && n < nq && key < nkg) {
          if (table) {
            const int l = (n - cls) / p.S - key + p.T - 1 - rbase;
            s += (p.flags & BAND_ROUND) ? N::rnd(G[r * ldg + l]) : G[r * ldg + l];
          } else {
            s += p.band[((size_t)bh * nq + n) * nkg + key];
          }
        }
        Sc[r * lds + key] = s;
      }
  }
  __syncthreads();

  copy_rows_async(Kb, ldq, vp, 0, KT, nk, d);   // V tile 0 loads during the softmax
  cp_commit();

  // ---- softmax: exps rounded to bf16, padded keys 0 -----------------------
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
      copy_rows_async(Kb + ((it + 1) & 1) * KT * ldq, ldq, vp, k0 + KT, KT, nk, d);
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
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = mt + g + (e >= 2 ? 8 : 0), n = n0 + r;
      const int c = 8 * (wq + 4 * i) + 2 * t + (e & 1);
      if (n >= nq) continue;
      float y = N::rnd(oa[i][e] / Z[r]);
      if (n >= cls) y = N::rnd(y + __bfloat162float(Qb[r * ldq + c]));
      N::store(out, (size_t)n * p.osn + c, y);
    }
  }
}

// ---- bf16 with the band from the table, on wgmma (K4's attention step) ------
// Head dim WD = 96 (every stride-1 stage of mvit_v2_b), flags PRESCALE,
// CLS_FIRST and BAND_TABLE. A block of two warpgroups owns 128 query rows, 64
// a warpgroup; both q (scaled for the scores, as stored for the band and the
// residual) stay in registers as wgmma's A operand. The scores never reach
// shared memory: pass 1 walks the 64-key tiles, computes s = qs k^T + band
// in registers and keeps the row maximum; pass 2 recomputes s, takes
// exp(s - m) rounded to bf16, sums z from it and hands the registers to the
// P.V wgmma. The band is a Toeplitz gather: for a key tile at k0 a warpgroup
// needs q . rel[j] for the NREL table rows j its rows' time steps can meet,
// so it computes G = q rel_window^T (64 x NREL) with one more wgmma, parks G
// in shared memory (its 16 rows per warp are read back by that warp alone)
// and thread (row r, key column c) adds G[r][dt_r + 63 - c], an address that
// does not change from tile to tile. Key / value tiles and the block's table
// window stream through a ring of NS stages filled by cp.async, one
// __syncthreads per tile. A tile is two 128B-swizzled halves of 64 columns
// (the second half holds columns 64..95).
constexpr int WD = 96, WKS = WD / 16, WCH = WD / 8;    // head dim, k16 steps, 16-byte chunks
constexpr int WROWS = 128, WNT = 256;
constexpr int KV_BYTES = 2 * KT * 128;                 // a key or value tile

// Table rows a warpgroup's 64 query rows can meet in one key tile: their
// time steps span (S - 1 + 63) / S, a tile 63 more, the window start is
// rounded down to eight rows.
__host__ __device__ inline int nrel_needed(int S) { return (S + 62) / S + 71; }
// Rows of the block's table window: where the second warpgroup's starts,
// plus NREL.
__host__ __device__ inline int window_rows(int S, int nrel) {
  return (S + 63) / S / 8 * 8 + nrel;
}
__host__ __device__ inline int wg_smem_bytes(int S, int nrel, int ns) {
  return 1024 + ns * (KV_BYTES + window_rows(S, nrel) * 256) + 2 * 64 * (nrel + 4) * 4;
}

template <int NREL, int NS>
__global__ void __launch_bounds__(WNT, 1)
pooled_attention_wgmma_kernel(Params p) {
  using N = Num<__nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int nk = p.nk, nq = p.nq, nkg = nk - 1, S = p.S;
  const int rw = window_rows(S, NREL), stage_bytes = KV_BYTES + rw * 256;
  const uint32_t raw = smem_u32(smraw), ring = (raw + 1023u) & ~1023u;
  constexpr int LDG = NREL + 4;
  const int bh = blockIdx.y, b = bh / p.nh, h = bh % p.nh;
  const int n0 = blockIdx.x * WROWS;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  float* Gs = reinterpret_cast<float*>(smraw + (ring - raw) + NS * stage_bytes) +
              (64 * wg + 16 * warp) * LDG;               // this warp's 16 rows of G
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + (size_t)bh * nk * WD;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + (size_t)bh * nk * WD;
  const __nv_bfloat16* rel = static_cast<const __nv_bfloat16*>(p.rel);
  const int nt = (nk + KT - 1) / KT, ntot = 3 * nt;

  // the block's and this warpgroup's first time step; the warpgroup's window
  // starts `off` rows into the block's
  const int t0b = max(n0 - 1, 0) / S;
  const int off = (max(n0 + 64 * wg - 1, 0) / S - t0b) / 8 * 8;
  const int row0 = n0 + 64 * wg + 16 * warp + g, row1 = row0 + 8;
  const bool band0 = row0 >= 1 && row0 < nq, band1 = row1 >= 1 && row1 < nq;
  // G column of (this row, key column c) is dt + 63 - c
  const int dt0 = band0 ? (row0 - 1) / S - t0b - off : 0;
  const int dt1 = band1 ? (row1 - 1) / S - t0b - off : 0;

  auto load_step = [&](int j) {
    if (j < ntot) {
      const bool is_v = j >= nt && ((j - nt) & 1);
      const int k0 = (j < nt ? j : (j - nt) / 2) * KT;
      const __nv_bfloat16* src = is_v ? vp : kp;
      const uint32_t dst = ring + (j % NS) * stage_bytes;
#pragma unroll
      for (int i = 0; i < KT * WCH / WNT; ++i) {
        const int idx = tid + WNT * i, r = idx / WCH, c = idx % WCH, row = k0 + r;
        const bool ok = row < nk;
        cp_async16_to(dst + (c / 8) * (KT * 128) + swz(r, c % 8),
                      ok ? src + (size_t)row * WD + 8 * c : src, ok ? 16 : 0);
      }
      if (!is_v && k0 < nkg) {     // table rows rb .. rb + rw - 1 of this tile's window
        const int rb = t0b - (k0 + KT - 1) + p.T - 1;
        for (int idx = tid; idx < rw * WCH; idx += WNT) {
          const int r = idx / WCH, c = idx % WCH, row = rb + r;
          const bool ok = row >= 0 && row <= 2 * p.T - 2;
          cp_async16_to(dst + KV_BYTES + (c / 8) * (rw * 128) + swz(r, c % 8),
                        ok ? rel + (size_t)row * WD + 8 * c : rel, ok ? 16 : 0);
        }
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) load_step(j);

  uint32_t qa[WKS][4], qb[WKS][4];
  const float qscale = N::rnd(p.scale);
#pragma unroll
  for (int kk = 0; kk < WKS; ++kk) {
    const int c = 16 * kk + 2 * t;
    qb[kk][0] = row0 < nq ? ld_pair(q + (size_t)row0 * p.qsn + c) : 0u;
    qb[kk][1] = row1 < nq ? ld_pair(q + (size_t)row1 * p.qsn + c) : 0u;
    qb[kk][2] = row0 < nq ? ld_pair(q + (size_t)row0 * p.qsn + c + 8) : 0u;
    qb[kk][3] = row1 < nq ? ld_pair(q + (size_t)row1 * p.qsn + c + 8) : 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qb[kk][i]));
      qa[kk][i] = pack_bf16(f.x * qscale, f.y * qscale);
    }
  }

  float Sc[32], O[WD / 2], G[NREL / 2];
  uint32_t pa[4][4] = {};
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, z0 = 0.f, z1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) Sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WD / 2; ++i) O[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NREL / 2; ++i) G[i] = 0.f;

  for (int j = 0; j < ntot; ++j) {
    cp_wait<NS - 2>();
    fence_async_shared();
    __syncthreads();
    load_step(j + NS - 1);
    const uint32_t tile = ring + (j % NS) * stage_bytes;
    const bool is_v = j >= nt && ((j - nt) & 1);
    if (is_v) {                 // O += P V_i, V (key, c) a transposed B of two column blocks
      fence_regs(O);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRS<WD, 1>::run(O, pa[kk], tile_desc(tile + kk * 2048, KT * 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(O);
      continue;
    }
    const int k0 = (j < nt ? j : (j - nt) / 2) * KT;
    const bool banded = k0 < nkg;
    fence_regs(Sc);
    fence_regs(G);
    wgmma_fence();
    if (banded) {               // G = q rel_window^T over this warpgroup's NREL rows
      const uint32_t win = tile + KV_BYTES + off * 128;
#pragma unroll
      for (int kk = 0; kk < WKS; ++kk)
        WgmmaRS<NREL, 0>::run(G, qb[kk], tile_desc(win + (kk / 4) * (rw * 128) + (kk % 4) * 32),
                              kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < WKS; ++kk)
      WgmmaRS<64, 0>::run(Sc, qa[kk], tile_desc(tile + (kk / 4) * (KT * 128) + (kk % 4) * 32),
                          kk > 0);
    wgmma_commit();
    wgmma_wait<1>();            // G is done; the scores' product runs on
    fence_regs(G);
    if (banded) {
      __syncwarp();             // the last tile's reads of G are done
      const bool rnd = p.flags & BAND_ROUND;
#pragma unroll
      for (int jj = 0; jj < NREL / 8; ++jj) {
        const int col = 8 * jj + 2 * t;
        float2 lo = make_float2(G[4 * jj], G[4 * jj + 1]);
        float2 hi = make_float2(G[4 * jj + 2], G[4 * jj + 3]);
        if (rnd) {
          lo.x = N::rnd(lo.x); lo.y = N::rnd(lo.y); hi.x = N::rnd(hi.x); hi.y = N::rnd(hi.y);
        }
        *reinterpret_cast<float2*>(Gs + g * LDG + col) = lo;
        *reinterpret_cast<float2*>(Gs + (g + 8) * LDG + col) = hi;
      }
      __syncwarp();
      wgmma_wait<0>();
      fence_regs(Sc);
      const float* g0 = Gs + g * LDG + dt0 + 63 - 2 * t;
      const float* g1 = Gs + (g + 8) * LDG + dt1 + 63 - 2 * t;
      const bool part = k0 + KT > nkg;     // a tile that also holds the class key
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 8 * jj;              // this thread's columns: c + 2 t, c + 2 t + 1
        const bool k_a = !part || k0 + c + 2 * t < nkg, k_b = !part || k0 + c + 2 * t + 1 < nkg;
        if (band0 && k_a) Sc[4 * jj] += g0[-c];
        if (band0 && k_b) Sc[4 * jj + 1] += g0[-c - 1];
        if (band1 && k_a) Sc[4 * jj + 2] += g1[-c];
        if (band1 && k_b) Sc[4 * jj + 3] += g1[-c - 1];
      }
    }
    wgmma_wait<0>();
    fence_regs(Sc);
    if (k0 + KT > nk) {         // keys past the last: -inf, weight 0
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int key = k0 + 8 * jj + 2 * t;
        if (key >= nk) Sc[4 * jj] = Sc[4 * jj + 2] = -CUDART_INF_F;
        if (key + 1 >= nk) Sc[4 * jj + 1] = Sc[4 * jj + 3] = -CUDART_INF_F;
      }
    }
    if (j < nt) {               // pass 1: the row maximum
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        m0 = fmaxf(m0, fmaxf(Sc[4 * jj], Sc[4 * jj + 1]));
        m1 = fmaxf(m1, fmaxf(Sc[4 * jj + 2], Sc[4 * jj + 3]));
      }
      if (j == nt - 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      }
    } else {                    // pass 2: exps (ex2.approx: its 2 ulp vanish in the bf16
                                // rounding) rounded to bf16, z from the rounded exps
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const __nv_bfloat162 e0 = __floats2bfloat162_rn(__expf(Sc[4 * jj] - m0),
                                                        __expf(Sc[4 * jj + 1] - m0));
        const __nv_bfloat162 e1 = __floats2bfloat162_rn(__expf(Sc[4 * jj + 2] - m1),
                                                        __expf(Sc[4 * jj + 3] - m1));
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
  // + q: the residual columns 8 jj + 2 t (+ 1) of a row sit in its A fragment
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + b * p.osb + h * p.osh;
#pragma unroll
  for (int jj = 0; jj < WD / 8; ++jj) {
    const int c = 8 * jj + 2 * t;
    const float2 r0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&qb[jj / 2][2 * (jj % 2)]));
    const float2 r1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&qb[jj / 2][2 * (jj % 2) + 1]));
    if (row0 < nq) {
      float y0 = N::rnd(O[4 * jj] / z0), y1 = N::rnd(O[4 * jj + 1] / z0);
      if (row0 >= 1) { y0 = N::rnd(y0 + r0.x); y1 = N::rnd(y1 + r0.y); }
      N::store2(out, (size_t)row0 * p.osn + c, y0, y1);
    }
    if (row1 < nq) {
      float y0 = N::rnd(O[4 * jj + 2] / z1), y1 = N::rnd(O[4 * jj + 3] / z1);
      if (row1 >= 1) { y0 = N::rnd(y0 + r1.x); y1 = N::rnd(y1 + r1.y); }
      N::store2(out, (size_t)row1 * p.osn + c, y0, y1);
    }
  }
}

template <int NREL, int NS>
int launch_wgmma(const Params& p, int B, cudaStream_t stream) {
  static int configured = 0;
  const int bytes = wg_smem_bytes(p.S, NREL, NS);
  if (int e = set_smem(pooled_attention_wgmma_kernel<NREL, NS>, bytes, configured)) return e;
  pooled_attention_wgmma_kernel<NREL, NS><<<dim3((p.nq + WROWS - 1) / WROWS, B * p.nh), WNT,
                                            bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// The wgmma kernel takes K4's call: bf16, head dim 96, the band from the
// table with q pre-scaled and the class token first, 16-byte loads.
bool use_wgmma(int dtype, int d, int flags, bool vec_ok, bool out_pairs) {
  const int need = PRESCALE | CLS_FIRST | BAND_TABLE;
  return dtype == 1 && d == WD && (flags & need) == need && vec_ok && out_pairs;
}

// bf16 with a head dim that is a multiple of 16 and operands that take
// 16-byte loads: the tensor-core kernel; anything else (f32 always): FMA.
bool use_mma(int dtype, int d, bool vec_ok) { return dtype == 1 && d % 16 == 0 && vec_ok; }

int smem_bytes(bool mma, int d, int nk) {
  return mma ? MmaLayout(d, nk).bytes : 4 * smem_floats(d, nk);
}

template <typename T>
int launch(const Params& p, int B, bool mma, cudaStream_t stream) {
  const int bytes = smem_bytes(mma, p.d, p.nk);
  dim3 grid((p.nq + R - 1) / R, B * p.nh);
  if (mma) {
    static int configured = 0;
    if (int e = set_smem(pooled_attention_mma_kernel, bytes, configured)) return e;
    pooled_attention_mma_kernel<<<grid, NT, bytes, stream>>>(p);
  } else {
    static int configured = 0;
    if (int e = set_smem(pooled_attention_kernel<T>, bytes, configured)) return e;
    pooled_attention_kernel<T><<<grid, NT, bytes, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched). B samples x
// nh heads; q and out are addressed through (sample, head, row) strides in
// elements, k and v are (B * nh, nk, d) with the class-token key last.
// dtype: 0 float32, 1 bfloat16.
int avdd_pooled_attention(const void* q, const void* k, const void* v,
                          const void* band, const void* rel, void* out,
                          int B, int nh, int nq, int nk, int d, int T, int S,
                          long long qsb, long long qsh, long long qsn,
                          long long osb, long long osh, long long osn,
                          float scale, int flags, int dtype, void* stream) {
  const bool table = flags & BAND_TABLE;
  const bool vec_ok = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)rel) % 16 == 0 &&
                      qsb % 8 == 0 && qsh % 8 == 0 && qsn % 8 == 0;
  const bool mma = use_mma(dtype, d, vec_ok);
  const bool out_pairs = (osb | osh | osn) % 2 == 0 && (uintptr_t)out % 4 == 0;   // bf16x2 stores
  const bool wg = use_wgmma(dtype, d, flags, vec_ok, out_pairs) && nk - 1 == T && rel;
  if (B <= 0 || nh <= 0 || nq <= 0 || nk < 2 || d <= 0 || d > MAXD || S <= 0 ||
      dtype < 0 || dtype > 1 || (!wg && smem_bytes(mma, d, nk) > SMEM_MAX) ||
      (table && (!rel || nk - 1 != T)) ||
      (!table && !band))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.band = static_cast<const float*>(band);
  p.rel = rel;
  p.out = out;
  p.qsb = qsb; p.qsh = qsh; p.qsn = qsn; p.osb = osb; p.osh = osh; p.osn = osn;
  p.nh = nh; p.nq = nq; p.nk = nk; p.d = d; p.T = T; p.S = S; p.flags = flags;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wg) {
    const int need = nrel_needed(S);
    if (need <= 80) return launch_wgmma<80, 4>(p, B, s);
    if (need <= 88) return launch_wgmma<88, 4>(p, B, s);
    return launch_wgmma<136, 2>(p, B, s);     // S = 1 needs 134
  }
  if (dtype == 0) return launch<float>(p, B, false, s);
  return launch<__nv_bfloat16>(p, B, mma, s);
}

}  // extern "C"
