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
// The score row of 513 keys fits in shared memory, so the softmax needs no
// second pass over device memory and no online rescaling (which would round
// differently from the JAX kernel).
//
// What this first design does about it: one 256-thread block per (sample x
// head, 32 query rows); q, the 32 x Nk f32 score rows, a 64-key k (then v)
// tile and the rel-pos rows the tile needs stay in shared memory. In bf16
// (head dim a multiple of 16) every product runs on the tensor cores
// (mma.sync m16n8k16, f32 accumulate); in f32 they are FMA (full precision).
// Not yet done: wgmma, more than one block per SM (~150 KB of shared memory
// at Nk = 513), overlapping the k/v tile loads with the products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int R = 32;                 // query rows per block
constexpr int KT = 64;                // keys per staged tile
constexpr int MAXD = 128;             // largest head dim
constexpr int ACC = R * MAXD / NT;    // P.V outputs per thread
constexpr int RPT = R / (NT / KT);    // score rows per thread
constexpr int SMEM_MAX = 232448;
enum { PRESCALE = 1, BAND_ROUND = 2, CLS_FIRST = 4, BAND_TABLE = 8 };

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ __forceinline__ static float load(const float* p, size_t i) { return __ldg(p + i); }
  __device__ __forceinline__ static float rnd(float v) { return v; }
  __device__ __forceinline__ static void store(float* p, size_t i, float v) { p[i] = v; }
};
template <> struct Num<__nv_bfloat16> {
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
  const void* q; const void* k; const void* v;   // q strided; k, v (BH, Nk, d)
  const float* band;                              // (BH, Nq, Nk - 1), K3
  const void* rel;                                // (>= 2T - 1, d), BAND_TABLE
  void* out;
  long long qsb, qsh, qsn, osb, osh, osn;         // (sample, head, row) strides
  int nh, nq, nk, d, T, S, flags;
  float scale;
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

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
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
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// B fragment (k = rows r0 .. r0 + 15, n = columns c0 .. c0 + 7) of a
// row-major (k, n) bf16 shared tile, transposed on the way by ldmatrix.
__device__ __forceinline__ void frag_b_trans(uint32_t& b0, uint32_t& b1,
                                             const __nv_bfloat16* tile, int ld, int r0, int c0) {
  const __nv_bfloat16* src = tile + (r0 + (threadIdx.x % 16)) * ld + c0;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1) : "r"(addr));
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

// bf16 with a head dim that is a multiple of 16 and operands that take
// 16-byte loads: the tensor-core kernel; anything else (f32 always): FMA.
bool use_mma(int dtype, int d, bool vec_ok) { return dtype == 1 && d % 16 == 0 && vec_ok; }

int smem_bytes(bool mma, int d, int nk) {
  return mma ? MmaLayout(d, nk).bytes : 4 * smem_floats(d, nk);
}

template <typename K>
int set_smem(K kernel, int bytes, int& configured) {
  if (bytes <= configured) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e == cudaSuccess) configured = bytes;
  return (int)e;
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
  if (B <= 0 || nh <= 0 || nq <= 0 || nk < 2 || d <= 0 || d > MAXD || S <= 0 ||
      dtype < 0 || dtype > 1 || smem_bytes(mma, d, nk) > SMEM_MAX ||
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
  if (dtype == 0) return launch<float>(p, B, false, s);
  return launch<__nv_bfloat16>(p, B, mma, s);
}

}  // extern "C"
