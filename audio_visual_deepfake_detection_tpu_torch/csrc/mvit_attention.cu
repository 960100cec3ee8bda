// MViT pooled attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel audio_visual_deepfake_detection_tpu/ops/pallas/
// mvit_attention.py::fused_pooled_attention (pl.pallas_call at :103), K3,
// and is the attention step of the whole-block kernel K4 (mvit_block.cu):
//
//   out = softmax(s) v (+ q),  s[n, k] = scale q[n].k[k] + band[n, k]
//
// with k/v pooled to a (T, 1, 1) grid: T grid keys then the class-token key
// LAST (no band on it). Two sources of the band:
// - BAND_TABLE (every call of the MViT forward, K3's blocks 0, 1, 23 and
//   K4's attention step): built here from the temporal rel-pos table,
//   band[n, k] = q[n] . rel[t_n - k + T - 1], t_n = g / S for grid row g;
//   no band array exists anywhere;
// - given (K3's JAX contract, fused_pooled_attention(q, k, v, band, scale)):
//   a (BH, Nq, T) f32 array the caller built.
// Flags: PRESCALE (q rounded to the compute dtype after the scale, as the
// XLA path of the whole block; without it the f32 scores are scaled, as
// K3's caller does), BAND_ROUND (the band rounded to the compute dtype: the
// XLA Toeplitz branch at S <= 4), CLS_FIRST (row 0 is the class-token
// query: no band, no residual; K4 only).
// Numerics follow the plain versions (pooled_attention_math, msblock_math):
// f32 scores and softmax statistics, the exp rounded to the compute dtype,
// z summed from the rounded exps, P.V in f32 divided by z, rounded once,
// then the residual add in the compute dtype.
//
// What bounds it on this card: at production a row attends 513 keys of
// d = 96, so per row ~3 x 513 x 96 multiply-adds (scores, band, P.V)
// against 2 d values read and d written: far above the H100's ridge,
// operations. With the band taken from the table the bytes are q, k, v, the
// table rows and the output; a (BH, Ng, T) f32 band array would be 2.1 GB a
// call at blocks 0-1 of 32 chunks (written where it is built, read here).
//
// Two kernels. bf16 with head dim 32, 64 or 96 (every MViT call) takes
// pooled_attention_wgmma_kernel: scores, band and P.V on wgmma, the scores
// in registers, two passes that recompute them (the maximum, then the exps)
// rather than an online softmax, which would round differently from the
// JAX kernel; its comment says the rest. float32 (and bf16 at any other
// head dim or alignment) takes pooled_attention_kernel: one 256-thread
// block per (sample x head, 32 query rows), the 32 x Nk score rows in
// shared memory, FMA products at full precision.

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
  const float* band;                              // (BH, Nq - cls, Nk - 1)
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
          s += p.band[((size_t)bh * (nq - cls) + n - cls) * nkg + key];
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

// ---- bf16 on wgmma: every bf16 call at head dim 32, 64 or 96 ---------------
// A block of two warpgroups owns 128 query rows, 64 a warpgroup; q stays in
// registers as wgmma's A operand, as stored (band, residual and, without
// PRESCALE, the scores) and, with PRESCALE, scaled and rounded for the
// scores. The scores never reach shared memory: pass 1 walks the 64-key
// tiles of grid keys, computes s = q k^T (x scale) + band in registers and
// keeps the row maximum; pass 2 recomputes s, takes exp(s - m) rounded to
// bf16, sums z from it and hands the registers to the P.V wgmma. The class
// key (the last of k and v) is no tile of its own (T = 512 grid keys fill
// eight tiles exactly): each thread dots its q fragment columns with it, a
// quad sums the four, and its exp joins z and O at the end. The band (NREL):
// - from the table, directly (NREL = DIRECT_BAND; no class row and S a
//   multiple of 64: MViT blocks 0-1): a warpgroup's 64 rows are one time
//   step t, so band[r][k0 + c] = q[r] . rel[t - k0 - c + T - 1] is itself a
//   64 x 64 product of q with the tile's 64 table rows stored in reverse:
//   one more wgmma beside the scores', added element by element;
// - from the table, gathered (NREL > 0: K4's steps, block 23): for a key
//   tile at k0 a warpgroup needs q . rel[j] for the NREL table rows its
//   rows' time steps can meet; it computes G = q rel_window^T (64 x NREL)
//   with one more wgmma, parks G in shared memory (its 16 rows per warp are
//   read back by that warp alone) and thread (row r, key column c) adds
//   G[r][dt_r + 63 - c], an address that does not change from tile to tile;
// - from a given f32 array (NREL = 0), one load per score.
// Key / value tiles and the block's table window stream through a ring of
// NS stages filled by cp.async, one __syncthreads per tile. A tile row is
// one or two 128B-swizzled halves of 64 columns (head dim 96: the second
// holds columns 64..95). Head dim 32 runs its P.V product 64 columns wide
// over value columns 32..63 that are zero-filled, and drops them.
constexpr int WROWS = 128, WNT = 256;

template <int WD> struct WgDim {
  static constexpr int KS = WD / 16;                  // k16 steps along the head dim
  static constexpr int CH = WD / 8;                   // 16-byte chunks of a row
  static constexpr int HALVES = (WD + 63) / 64;       // 64-column blocks of a tile row
  static constexpr int PVN = WD < 64 ? 64 : WD;       // width of the P.V product
  static constexpr int LCH = PVN / 8;                 // chunks a key or value row fills
  static constexpr int KV_BYTES = HALVES * KT * 128;  // a key or value tile
};

// Table rows a warpgroup's 64 query rows can meet in one key tile: their
// time steps span (S - 1 + 63) / S, a tile 63 more, the window start is
// rounded down to eight rows.
__host__ __device__ inline int nrel_needed(int S) { return (S + 62) / S + 71; }
// Rows of the table a stage holds: the block's window (where the second
// warpgroup's starts, plus NREL), or with DIRECT_BAND a reversed 64-row
// window for each warpgroup, or none (the band given).
constexpr int DIRECT_BAND = -1;
__host__ __device__ inline int window_rows(int S, int nrel) {
  return nrel == DIRECT_BAND ? 2 * KT : nrel ? (S + 63) / S / 8 * 8 + nrel : 0;
}
template <int WD>
int wg_smem_bytes(int S, int nrel, int ns) {
  using D = WgDim<WD>;
  return 1024 + ns * (D::KV_BYTES + window_rows(S, nrel) * D::HALVES * 128) +
         (nrel > 0 ? 2 * 64 * (nrel + 4) * 4 : 0);
}

template <int WD, int NREL, int NS>
__global__ void __launch_bounds__(WNT, 1)
pooled_attention_wgmma_kernel(Params p) {
  using N = Num<__nv_bfloat16>;
  using D = WgDim<WD>;
  constexpr bool GATHER = NREL > 0, DIRECT = NREL == DIRECT_BAND;
  constexpr int GN = GATHER ? NREL : 8, LDG = GN + 4;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int nk = p.nk, nq = p.nq, nkg = nk - 1, S = p.S;
  const int cls = (p.flags & CLS_FIRST) ? 1 : 0;
  const bool prescale = p.flags & PRESCALE;
  const int rw = window_rows(S, NREL), stage_bytes = D::KV_BYTES + rw * D::HALVES * 128;
  const uint32_t raw = smem_u32(smraw), ring = (raw + 1023u) & ~1023u;
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
  const int nt = (nkg + KT - 1) / KT, ntot = 3 * nt;    // tiles of grid keys

  // the block's and this warpgroup's first time step (grid rows start after
  // the class row when there is one); the warpgroup's window starts `off`
  // rows into the block's
  const int t0b = max(n0 - cls, 0) / S;
  const int off = (max(n0 + 64 * wg - cls, 0) / S - t0b) / 8 * 8;
  const int row0 = n0 + 64 * wg + 16 * warp + g, row1 = row0 + 8;
  const bool band0 = row0 >= cls && row0 < nq, band1 = row1 >= cls && row1 < nq;
  // G column of (this row, key column c) is dt + 63 - c
  const int dt0 = band0 ? (row0 - cls) / S - t0b - off : 0;
  const int dt1 = band1 ? (row1 - cls) / S - t0b - off : 0;

  auto load_step = [&](int j) {
    if (j < ntot) {
      const bool is_v = j >= nt && ((j - nt) & 1);
      const int k0 = (j < nt ? j : (j - nt) / 2) * KT;
      const __nv_bfloat16* src = is_v ? vp : kp;
      const uint32_t dst = ring + (j % NS) * stage_bytes;
#pragma unroll
      for (int i = 0; i < KT * D::LCH / WNT; ++i) {
        const int idx = tid + WNT * i, r = idx / D::LCH, c = idx % D::LCH, row = k0 + r;
        const bool ok = row < nkg && c < D::CH;      // past the grid keys or the head dim: zeros
        cp_async16_to(dst + (c / 8) * (KT * 128) + swz(r, c % 8),
                      ok ? src + (size_t)row * WD + 8 * c : src, ok ? 16 : 0);
      }
      if (GATHER && !is_v) {  // table rows rb .. rb + rw - 1 of this tile's window
        const int rb = t0b - (k0 + KT - 1) + p.T - 1;
        for (int idx = tid; idx < rw * D::CH; idx += WNT) {
          const int r = idx / D::CH, c = idx % D::CH, row = rb + r;
          const bool ok = row >= 0 && row <= 2 * p.T - 2;
          cp_async16_to(dst + D::KV_BYTES + (c / 8) * (rw * 128) + swz(r, c % 8),
                        ok ? rel + (size_t)row * WD + 8 * c : rel, ok ? 16 : 0);
        }
      }
      if (DIRECT && !is_v) {  // row c of warpgroup w's window: table row t_w - k0 - c + T - 1
#pragma unroll
        for (int i = 0; i < 2 * KT * D::CH / WNT; ++i) {
          const int idx = tid + WNT * i, w = idx / (KT * D::CH), r = idx / D::CH % KT;
          const int c = idx % D::CH, row = (n0 + 64 * w) / S - k0 - r + p.T - 1;
          const bool ok = row >= 0 && row <= 2 * p.T - 2;
          cp_async16_to(dst + D::KV_BYTES + w * (KT * D::HALVES * 128) + (c / 8) * (KT * 128) +
                            swz(r, c % 8),
                        ok ? rel + (size_t)row * WD + 8 * c : rel, ok ? 16 : 0);
        }
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) load_step(j);

  uint32_t qa[D::KS][4], qb[D::KS][4];
  const float qscale = N::rnd(p.scale);
#pragma unroll
  for (int kk = 0; kk < D::KS; ++kk) {
    const int c = 16 * kk + 2 * t;
    qb[kk][0] = row0 < nq ? ld_pair(q + (size_t)row0 * p.qsn + c) : 0u;
    qb[kk][1] = row1 < nq ? ld_pair(q + (size_t)row1 * p.qsn + c) : 0u;
    qb[kk][2] = row0 < nq ? ld_pair(q + (size_t)row0 * p.qsn + c + 8) : 0u;
    qb[kk][3] = row1 < nq ? ld_pair(q + (size_t)row1 * p.qsn + c + 8) : 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qb[kk][i]));
      qa[kk][i] = prescale ? pack_bf16(f.x * qscale, f.y * qscale) : qb[kk][i];
    }
  }

  // the class key (the last of k and v) is no tile of its own: each thread
  // dots its A-fragment columns of q with it and sums over its quad
  const __nv_bfloat16* kc = kp + (size_t)nkg * WD;
  float sc0 = 0.f, sc1 = 0.f;       // the two rows' class-key scores
  auto class_scores = [&](float& c0, float& c1) {
    c0 = c1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < D::KS; ++kk) {
      const int c = 16 * kk + 2 * t;
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kc + c));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kc + c + 8));
      const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][0]));
      const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][1]));
      const float2 a2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][2]));
      const float2 a3 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][3]));
      c0 += a0.x * lo.x + a0.y * lo.y + a2.x * hi.x + a2.y * hi.y;
      c1 += a1.x * lo.x + a1.y * lo.y + a3.x * hi.x + a3.y * hi.y;
    }
    c0 += __shfl_xor_sync(0xffffffffu, c0, 1);
    c0 += __shfl_xor_sync(0xffffffffu, c0, 2);
    c1 += __shfl_xor_sync(0xffffffffu, c1, 1);
    c1 += __shfl_xor_sync(0xffffffffu, c1, 2);
    if (!prescale) {
      c0 *= p.scale;
      c1 *= p.scale;
    }
  };

  float Sc[32], O[D::PVN / 2], G[GN / 2], Bd[DIRECT ? 32 : 1];
  uint32_t pa[4][4] = {};
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, z0 = 0.f, z1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) Sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D::PVN / 2; ++i) O[i] = 0.f;
#pragma unroll
  for (int i = 0; i < GN / 2; ++i) G[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DIRECT ? 32 : 1); ++i) Bd[i] = 0.f;

  for (int j = 0; j < ntot; ++j) {
    cp_wait<NS - 2>();
    fence_async_shared();
    __syncthreads();
    load_step(j + NS - 1);
    const uint32_t tile = ring + (j % NS) * stage_bytes;
    const bool is_v = j >= nt && ((j - nt) & 1);
    if (is_v) {                 // O += P V_i, V (key, c) a transposed B of PVN columns
      fence_regs(O);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRS<D::PVN, 1>::run(O, pa[kk], tile_desc(tile + kk * 2048, KT * 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(O);
      continue;
    }
    const int k0 = (j < nt ? j : (j - nt) / 2) * KT;
    const bool part = k0 + KT > nkg;     // the last tile, past the grid keys
    fence_regs(Sc);
    if constexpr (GATHER) fence_regs(G);
    if constexpr (DIRECT) fence_regs(Bd);
    wgmma_fence();
    if constexpr (DIRECT) {     // the band tile itself: q . (this warpgroup's reversed window)^T
      const uint32_t win = tile + D::KV_BYTES + wg * (KT * D::HALVES * 128);
#pragma unroll
      for (int kk = 0; kk < D::KS; ++kk)
        WgmmaRS<64, 0>::run(Bd, qb[kk], tile_desc(win + (kk / 4) * (KT * 128) + (kk % 4) * 32),
                            kk > 0);
    }
    if constexpr (GATHER) {     // G = q rel_window^T over this warpgroup's NREL rows
      const uint32_t win = tile + D::KV_BYTES + off * 128;
#pragma unroll
      for (int kk = 0; kk < D::KS; ++kk)
        WgmmaRS<GN, 0>::run(G, qb[kk], tile_desc(win + (kk / 4) * (rw * 128) + (kk % 4) * 32),
                            kk > 0);
      wgmma_commit();
    }
#pragma unroll
    for (int kk = 0; kk < D::KS; ++kk)
      WgmmaRS<64, 0>::run(Sc, qa[kk], tile_desc(tile + (kk / 4) * (KT * 128) + (kk % 4) * 32),
                          kk > 0);
    wgmma_commit();
    if constexpr (GATHER) {
      wgmma_wait<1>();          // G is done; the scores' product runs on
      fence_regs(G);
      __syncwarp();             // the last tile's reads of G are done
      const bool rnd = p.flags & BAND_ROUND;
#pragma unroll
      for (int jj = 0; jj < GN / 8; ++jj) {
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
    }
    wgmma_wait<0>();
    fence_regs(Sc);
    if constexpr (DIRECT) fence_regs(Bd);
    if (!prescale) {
#pragma unroll
      for (int i = 0; i < 32; ++i) Sc[i] *= p.scale;
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + 2 * t;        // this thread's columns: c, c + 1
      const bool k_a = !part || k0 + c < nkg, k_b = !part || k0 + c + 1 < nkg;
      if constexpr (DIRECT) {
        const bool rnd = p.flags & BAND_ROUND;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float bv = rnd ? N::rnd(Bd[4 * jj + e]) : Bd[4 * jj + e];
          if ((e < 2 ? band0 : band1) && (e & 1 ? k_b : k_a)) Sc[4 * jj + e] += bv;
        }
      } else if constexpr (GATHER) {
        const float* g0 = Gs + g * LDG + dt0 + 63 - c;
        const float* g1 = Gs + (g + 8) * LDG + dt1 + 63 - c;
        if (band0 && k_a) Sc[4 * jj] += g0[0];
        if (band0 && k_b) Sc[4 * jj + 1] += g0[-1];
        if (band1 && k_a) Sc[4 * jj + 2] += g1[0];
        if (band1 && k_b) Sc[4 * jj + 3] += g1[-1];
      } else {
        const size_t base = (size_t)bh * (nq - cls) * nkg + k0 + c;
        if (band0 && k_a) Sc[4 * jj] += p.band[base + (size_t)(row0 - cls) * nkg];
        if (band0 && k_b) Sc[4 * jj + 1] += p.band[base + (size_t)(row0 - cls) * nkg + 1];
        if (band1 && k_a) Sc[4 * jj + 2] += p.band[base + (size_t)(row1 - cls) * nkg];
        if (band1 && k_b) Sc[4 * jj + 3] += p.band[base + (size_t)(row1 - cls) * nkg + 1];
      }
    }
    if (part) {                 // keys past the grid keys: -inf, weight 0
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int key = k0 + 8 * jj + 2 * t;
        if (key >= nkg) Sc[4 * jj] = Sc[4 * jj + 2] = -CUDART_INF_F;
        if (key + 1 >= nkg) Sc[4 * jj + 1] = Sc[4 * jj + 3] = -CUDART_INF_F;
      }
    }
    if (j < nt) {               // pass 1: the row maximum
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        m0 = fmaxf(m0, fmaxf(Sc[4 * jj], Sc[4 * jj + 1]));
        m1 = fmaxf(m1, fmaxf(Sc[4 * jj + 2], Sc[4 * jj + 3]));
      }
      if (j == nt - 1) {        // the class key's score joins the maximum
        class_scores(sc0, sc1);
        m0 = fmaxf(m0, sc0);
        m1 = fmaxf(m1, sc1);
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
  {   // the class key: its rounded exp joins z and its value row O
    const __nv_bfloat162 e = __floats2bfloat162_rn(__expf(sc0 - m0), __expf(sc1 - m1));
    const float e0 = __low2float(e), e1 = __high2float(e);
    z0 += e0;
    z1 += e1;
    const __nv_bfloat16* vc = vp + (size_t)nkg * WD;
#pragma unroll
    for (int jj = 0; jj < WD / 8; ++jj) {
      const float2 vv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vc + 8 * jj + 2 * t));
      O[4 * jj] += e0 * vv.x;
      O[4 * jj + 1] += e0 * vv.y;
      O[4 * jj + 2] += e1 * vv.x;
      O[4 * jj + 3] += e1 * vv.y;
    }
  }
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
      if (row0 >= cls) { y0 = N::rnd(y0 + r0.x); y1 = N::rnd(y1 + r0.y); }
      N::store2(out, (size_t)row0 * p.osn + c, y0, y1);
    }
    if (row1 < nq) {
      float y0 = N::rnd(O[4 * jj + 2] / z1), y1 = N::rnd(O[4 * jj + 3] / z1);
      if (row1 >= cls) { y0 = N::rnd(y0 + r1.x); y1 = N::rnd(y1 + r1.y); }
      N::store2(out, (size_t)row1 * p.osn + c, y0, y1);
    }
  }
}

template <int WD, int NREL, int NS>
int launch_wgmma(const Params& p, int B, cudaStream_t stream) {
  static int configured = 0;
  const int bytes = wg_smem_bytes<WD>(p.S, NREL, NS);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (int e = set_smem(pooled_attention_wgmma_kernel<WD, NREL, NS>, bytes, configured)) return e;
  pooled_attention_wgmma_kernel<WD, NREL, NS><<<dim3((p.nq + WROWS - 1) / WROWS, B * p.nh), WNT,
                                                bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// The band's instantiation: given; from the table directly when each
// warpgroup's 64 rows are one time step (no class row, S a multiple of 64:
// MViT blocks 0-1); else the gathered window that holds nrel_needed(S) rows.
template <int WD>
int launch_wgmma_dim(const Params& p, int B, bool table, cudaStream_t s) {
  if (!table) return launch_wgmma<WD, 0, 4>(p, B, s);
  if (!(p.flags & CLS_FIRST) && p.S % KT == 0) return launch_wgmma<WD, DIRECT_BAND, 4>(p, B, s);
  const int need = nrel_needed(p.S);
  if (need <= 80) return launch_wgmma<WD, 80, 4>(p, B, s);
  if (need <= 88) return launch_wgmma<WD, 88, 4>(p, B, s);
  return launch_wgmma<WD, 136, WD == 96 ? 2 : 4>(p, B, s);     // S = 1 needs 134
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  static int configured = 0;
  const int bytes = 4 * smem_floats(p.d, p.nk);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (int e = set_smem(pooled_attention_kernel<T>, bytes, configured)) return e;
  pooled_attention_kernel<T><<<dim3((p.nq + R - 1) / R, B * p.nh), NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched). B samples x
// nh heads; q and out are addressed through (sample, head, row) strides in
// elements, k and v are (B * nh, nk, d) with the class-token key last; the
// band is (B * nh, nq - cls, nk - 1) f32 unless BAND_TABLE names the table
// rel (>= 2T - 1, d) in the compute dtype. dtype: 0 float32, 1 bfloat16.
// When `route` is not null it receives the kernel launched: 0 the FMA
// kernel, 1 the wgmma kernel with the band given, 2 with the band from the
// table.
int avdd_pooled_attention(const void* q, const void* k, const void* v,
                          const void* band, const void* rel, void* out,
                          int B, int nh, int nq, int nk, int d, int T, int S,
                          long long qsb, long long qsh, long long qsn,
                          long long osb, long long osh, long long osn,
                          float scale, int flags, int dtype, void* stream, int* route) {
  const bool table = flags & BAND_TABLE;
  if (B <= 0 || nh <= 0 || nq <= 0 || nk < 2 || d <= 0 || d > MAXD || S <= 0 ||
      dtype < 0 || dtype > 1 || (table && (!rel || nk - 1 != T)) || (!table && !band))
    return (int)cudaErrorInvalidValue;
  const bool vec_ok = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)rel) % 16 == 0 &&
                      qsb % 8 == 0 && qsh % 8 == 0 && qsn % 8 == 0;
  const bool out_pairs = (osb | osh | osn) % 2 == 0 && (uintptr_t)out % 4 == 0;  // bf16x2 stores
  const bool wg = dtype == 1 && (d == 32 || d == 64 || d == 96) && vec_ok && out_pairs;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.band = static_cast<const float*>(band);
  p.rel = rel;
  p.out = out;
  p.qsb = qsb; p.qsh = qsh; p.qsn = qsn; p.osb = osb; p.osh = osh; p.osn = osn;
  p.nh = nh; p.nq = nq; p.nk = nk; p.d = d; p.T = T; p.S = S; p.flags = flags;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  if (wg)
    e = d == 96 ? launch_wgmma_dim<96>(p, B, table, s)
        : d == 64 ? launch_wgmma_dim<64>(p, B, table, s) : launch_wgmma_dim<32>(p, B, table, s);
  else
    e = dtype == 0 ? launch<float>(p, B, s) : launch<__nv_bfloat16>(p, B, s);
  if (e == 0 && route) *route = wg ? (table ? 2 : 1) : 0;
  return e;
}

}  // extern "C"
