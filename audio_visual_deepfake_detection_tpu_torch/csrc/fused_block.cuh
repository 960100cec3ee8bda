// Fused localizer transformer block (K1 / K6) for Hopper: what the seven
// translation units of its kernels share, so that they compile in parallel.
// fused_block.cu holds the C entry points and the bfloat16 kernel instance
// for the production block (C = 256, 4 heads of 64, its shape compile-time
// constants), fused_block_any.cu and fused_block_any_qkv.cu the second and
// the first launch of the bfloat16 instance for any shape of wgmma_shape_ok,
// fused_block_attend.cu the bfloat16 attention launch on the tensor cores
// (dense attention, bands wider than MAX_W, and every attention of the
// bfloat16 scratch route), fused_block_f32.cu and fused_block_f32_attend.cu
// the float32 kernels at every shape of shape_ok, fused_block_bf16.cu the
// bfloat16 scratch route, which takes the shapes past wgmma_shape_ok. The
// design is described in fused_block.cu (bf16), fused_block_f32.cu (f32)
// and fused_block_bf16.cu (bf16 past wgmma_shape_ok).

#pragma once

#include "wgmma.cuh"

namespace avdd_k1 {

using namespace avdd;

constexpr int MAX_C = 1024;     // widest block of the bf16 two-launch instances
constexpr int MAX_C_ANY = 2048; // widest block of the kernel
constexpr int MAX_W = 16;       // largest half window of the bf16 tail's banded
                                // step (attend_band); wider bands take the
                                // tensor-core step
constexpr float LN_EPS = 1e-5f;
constexpr float NEG_INF = -1e30f;
constexpr float NEG_PENALTY = 1e4f;

// The shapes the kernel takes (the Python wrapper's kernel_shape_ok): C a
// multiple of 64 up to MAX_C_ANY, a head width D = C / n_head that is a
// multiple of 8 from 8 to 512, any half window w, and dense attention
// (w <= 0), at any T.
inline bool shape_ok(int c, int n_head) {
  if (c < 64 || c > MAX_C_ANY || c % 64 || n_head <= 0 || c % n_head) return false;
  const int d = c / n_head;
  return d % 8 == 0 && d >= 8 && d <= 512;
}
// The shapes of the bf16 two-launch instances and of the f32 attention's
// own head widths: C up to MAX_C, D of 32, 64, 96 or 128. The rest of
// shape_ok runs the scratch routes: f32's eight launches with the head
// width padded to an instance's (D < 128) or in 128-column blocks (D >
// 128), and bf16's eight launches of fused_block_bf16.cu.
inline bool wgmma_shape_ok(int c, int n_head) {
  if (!shape_ok(c, n_head) || c > MAX_C) return false;
  const int d = c / n_head;
  return d == 32 || d == 64 || d == 96 || d == 128;
}

enum {
  ROW_LNQ_W = 0, ROW_LNQ_B = 1, ROW_LNK_W = 2, ROW_LNK_B = 3,
  ROW_LNV_W = 4, ROW_LNV_B = 5, ROW_QCONV = 6, ROW_KCONV = 9, ROW_VCONV = 12,
  ROW_Q_BIAS = 15, ROW_K_BIAS = 16, ROW_V_BIAS = 17, ROW_P_BIAS = 18,
  ROW_SCALE_ATTN = 19, ROW_FC2_BIAS = 20, ROW_SCALE_MLP = 21
};
enum { MODE_SELF = 0, MODE_QV_K = 1, MODE_KV = 2, MODE_DS_SELF = 3 };

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

// ---- bf16: two launches on wgmma --------------------------------------------
// Launch 1 (PHASE_QKV) writes the rounded q (scaled), k and v rows of every
// sequence row to a (B, T, 3C) scratch; launch 2 (PHASE_TAIL) reads them for
// attention and runs proj, LN and the MLP. A block is one warpgroup and a
// tile of 64 rows of one sample.
constexpr int WG_ROWS = 64;                    // rows a block owns
constexpr int NTW = 128;                       // one warpgroup
constexpr int STAGES = 2;                      // weight ring depth
constexpr int STAGE = 32768;                   // a stage: up to four boxes
constexpr int BOX = 8192;                      // a TMA box: 64 rows x 128 B; also
                                               // a 64-column block of the tile
constexpr int HCHUNK = WG_ROWS * 128;          // 64 x 64 bf16 hidden chunk
constexpr int SLAB = 256;                      // widest attention slab, channels
enum { PHASE_QKV = 0, PHASE_TAIL = 1 };
// Where the tail takes the attention context from: its banded step over
// TMA-staged rows (1 <= w <= MAX_W), or the q columns of the scratch, which
// the attention launch (fused_block_attend.cu) overwrote with the context
// between the two (dense attention, and bands of w > MAX_W).
enum { ATT_BAND = 0, ATT_SCRATCH = 1 };

// Dynamic shared memory of a block: the ring, the hidden chunk, the 64 x C
// tile (C / 64 blocks of 64 columns), the barriers, and 1 KB of alignment.
inline int wg_smem(int c) { return 1024 + STAGES * STAGE + HCHUNK + WG_ROWS * 2 * c + 8 * (STAGES + 1); }

// Tensor maps of the six weights, (out, in) bf16, in boxes of 64 inputs x
// Dims::br outputs (wf2: 64 hidden units x br outputs; wf1 64 x 64); and the
// (B, T, 3C) q|k|v scratch, unswizzled, in boxes of a slab's channels x
// att_rows rows (q) or att_rows + 2w rows (keys, values).
struct WeightMaps { CUtensorMap w[6]; CUtensorMap q, kv; };

struct ParamsW {
  const __nv_bfloat16* x; const __nv_bfloat16* xo;
  const uint8_t* mask; const float* vecs; const float* fc1b; const float* coefs;
  __nv_bfloat16* qkv;   // (B, T, 3C) q | k | v scratch
  __nv_bfloat16* out;   // (B, T, C); also holds y1 between proj and fc2
  int T, w, mode, tiles;
  int C, D;             // channels, head width
  int ks;               // C / 64: 64-deep input slices of a product
  int nb;               // output groups of up to 256 columns: ceil(C / 256)
  int f1;               // stages of an fc1 chunk: ceil(ks / 4)
  int slab;             // channels of an attention slab: whole heads, <= 256
  int att_rows;         // banded: query rows a staged chunk holds
  int attn;             // ATT_*: where the tail's attention context comes from
};

// The block's shape and what follows from it: compile-time constants in the
// kernel instance for the production block (CW = 256: C = 256, 4 heads of
// 64), the launch's values otherwise (CW = 0).
struct Dims {
  int C;                // channels
  int ks;               // C / 64
  int nb;               // ceil(C / 256)
  int f1;               // ceil(ks / 4)
  int br;               // rows of a box of wq, wk, wv, wp, wf2: one group's
                        // 256 in the production instance, else 64
  int D;                // head width
  int slab;             // channels of an attention slab
};
template <int CW>
__device__ __forceinline__ Dims dims_of(const ParamsW& p) {
  static_assert(CW == 0 || CW == 256, "the production instance or any shape");
  return CW ? Dims{256, 4, 1, 1, 256, 64, 256} : Dims{p.C, p.ks, p.nb, p.f1, 64, p.D, p.slab};
}

// Byte offset of element (r, c) in a tile: 64-column block c / 64, 128-byte
// swizzled row r.
__device__ __forceinline__ uint32_t tile_at(int r, int c) {
  return (uint32_t)((c >> 6) * BOX) + swz(r, (c >> 3) & 7) + 2 * (c & 7);
}

__device__ __forceinline__ float rnd16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// The weight stages in the order the products take them. QKV: wq, wk, wv,
// each per output group as ks 64-deep input slices of the group's columns.
// TAIL: wp likewise, then per output group, for each 64-wide hidden chunk j,
// its fc1 rows in f1 stages of up to four slices, and its fc2 columns of the
// group. A stage is n boxes of `bytes` each (rows of 128 bytes), box b at
// (c0 + dc b, c1 + dr b) of map `map` (coordinates innermost first), landing
// one after the other; br is Dims::br.
struct StageLoad { int map, n, c0, c1, dc, dr, bytes; };

__host__ __device__ inline StageLoad stage_of(int C, int ks, int nb, int f1, int br, int i,
                                              int phase) {
  const int per = nb * ks;                   // stages of a C x C product
  if (phase == PHASE_QKV || i < per) {
    const int m = phase == PHASE_QKV ? i / per : 3, r = i % per;
    const int n0 = 256 * (r / ks), k = r % ks;
    const int cols = C - n0 < 256 ? C - n0 : 256;
    return {m, cols / br, 64 * k, n0, 0, br, 128 * br};
  }
  i -= per;
  const int chunk = f1 + 1, per_group = (C / 16) * chunk;
  const int n0 = 256 * (i / per_group), r = i % per_group, j = r / chunk, f = r % chunk;
  if (f < f1) {
    const int left = ks - 4 * f;
    return {4, left < 4 ? left : 4, 256 * f, 64 * j, 64, 0, BOX};
  }
  const int cols = C - n0 < 256 ? C - n0 : 256;
  return {5, cols / br, 64 * j, n0, 0, br, 128 * br};
}

static __device__ void load_stage(const WeightMaps& maps, const Dims& d, uint32_t dst,
                                  uint32_t full, int i, int phase) {
  const StageLoad s = stage_of(d.C, d.ks, d.nb, d.f1, d.br, i, phase);
  mbar_expect_tx(full, s.n * s.bytes);
  for (int b = 0; b < s.n; ++b)
    tma_load_2d(dst + b * s.bytes, &maps.w[s.map], s.c0 + s.dc * b, s.c1 + s.dr * b, full);
}

// Ring of weight stages. take() waits for the next stage; release_to(k),
// once the products reading every stage taken before the k-th are complete,
// has thread 0 load stage i + STAGES into the slot of each stage i < k not yet
// released (the warpgroup's own wgmma were its only readers, so no other
// barrier is needed).
struct Ring {
  const WeightMaps* maps;
  Dims d;
  uint32_t base, bars;   // stage 0; a full barrier per slot
  int n, rel, count, phase;   // stages taken, released; stages in all; PHASE_*
  __device__ void start() {
    if (threadIdx.x == 0)
      for (int i = 0; i < STAGES && i < count; ++i)
        load_stage(*maps, d, base + i * STAGE, bars + 8 * i, i, phase);
  }
  __device__ uint32_t take() {
    const int s = n % STAGES;
    mbar_wait(bars + 8 * s, (n / STAGES) & 1);
    ++n;
    return base + s * STAGE;
  }
  __device__ void release_to(int k) {
    for (; rel < k; ++rel) {
      const int s = rel % STAGES;
      if (threadIdx.x == 0 && rel + STAGES < count)
        load_stage(*maps, d, base + s * STAGE, bars + 8 * s, rel + STAGES, phase);
    }
  }
};

// The first NG / 2 accumulators of acc, as wgmma's operand of width NG (the
// array itself at 256, so the compiler tracks its registers as before).
template <int NG>
__device__ __forceinline__ float (&acc_of(float (&acc)[128]))[NG / 2] {
  if constexpr (NG == 256) return acc;
  else return *reinterpret_cast<float (*)[NG / 2]>(&acc);
}

// acc = tile (64 x C) . W^T for one output group of NG columns, over the
// next ks stages (a 64-deep slice of the group's NG weight rows each).
template <int NG>
__device__ __forceinline__ void product(float (&acc)[NG / 2], uint32_t tile, Ring& ring, int ks) {
#pragma unroll
  for (int i = 0; i < NG / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int kb = 0; kb < ks; ++kb) {
    const uint32_t st = ring.take();
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaSS<NG>::run(acc, tile_desc(tile + kb * BOX + kk * 32), tile_desc(st + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();
    ring.release_to(ring.n - 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release_to(ring.n);
}

// Calls F<NG> for an output group of ng columns (64, 128, 192 or 256).
#define AVDD_BY_WIDTH(ng, CALL)          \
  switch (ng) {                          \
    case 64: CALL(64); break;            \
    case 128: CALL(128); break;          \
    case 192: CALL(192); break;          \
    default: CALL(256); break;           \
  }

// One sequence row of a stream, plain LN (one-pass moments) with the
// stream's affine, rounded; this lane's channels c0 .. c0 + 7 (`act`: the
// lane holds channels of the row, at most 256 of them: C <= 256). Zero
// outside the sequence. The whole warp calls it for the same row.
__device__ __forceinline__ void ln_stream_row(float (&l)[8], const __nv_bfloat16* src, int s,
                                              int T, int C, int c0, bool act, const float (&lw)[8],
                                              const float (&lb)[8]) {
  const bool in = s >= 0 && s < T;
  float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (in && act) {
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

__device__ __forceinline__ void st_shared16(uint32_t a, const uint32_t (&u)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "r"(u[0]), "r"(u[1]), "r"(u[2]), "r"(u[3]) : "memory");
}
__device__ __forceinline__ uint4 lds16(uint32_t a) {
  uint4 u;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w) : "r"(a));
  return u;
}
// The tile's 16 bytes of row r from column c (a multiple of 8).
__device__ __forceinline__ uint32_t tile_chunk(uint32_t tile, int r, int c) {
  return tile + (uint32_t)((c >> 6) * BOX) + swz(r, (c >> 3) & 7);
}

// Conv output row (already masked; zero on an inactive lane) -> rounded,
// plain LN, rounded -> the tile's row r (this lane's 16 bytes, if `act`).
__device__ __forceinline__ void ln_store_row(float (&y)[8], uint32_t tile, int r, int lane, int C,
                                             bool act) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) { y[i] = rnd16(y[i]); s1 += y[i]; s2 += y[i] * y[i]; }
  const float mu = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
  const float rs = rsqrtf(fmaxf(m2 - mu * mu, 0.f) + LN_EPS);
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = pack_bf16(y[2 * i] * rs - mu * rs, y[2 * i + 1] * rs - mu * rs);
  if (act) st_shared16(tile_chunk(tile, r, 8 * lane), u);
}

// The stream `which` (0 q, 1 k, 2 v) reads: its source rows and LN affine.
__device__ __forceinline__ void stream_of(const ParamsW& p, int C, int which, int b,
                                          const __nv_bfloat16*& src, const __nv_bfloat16*& odd,
                                          int& rw) {
  rw = ROW_LNQ_W;
  src = p.x + (size_t)b * p.T * C;
  odd = p.xo + (size_t)b * p.T * C;
  if (p.mode == MODE_QV_K || p.mode == MODE_KV) {
    if (which == 1) { rw = ROW_LNK_W; src = odd; }
    if (which == 2) { rw = ROW_LNV_W; if (p.mode == MODE_KV) src = odd; }
  }
}

// The conv + LN rows of stream `which` for the tile's 64 rows into `tile`,
// C <= 256 (a lane holds 8 channels of a row): warp w does rows 16 w ..
// 16 w + 15 in two runs of eight, each run LN-ing the input rows it needs
// (one more on each side) at once, so their loads and reductions overlap; a
// conv row overwrites the input row it no longer needs. (The two runs
// unrolled into one measured 7% slower a block on an H100 SXM at 700 W.)
__device__ __forceinline__ void conv_rows(const ParamsW& p, const Dims& d, int which, int b,
                                          int r0, uint32_t tile, int warp, int lane) {
  constexpr int RUN = 8;
  const float* v = p.vecs;
  const int C = d.C, c0 = 8 * lane;
  const bool act = c0 < C;
  const __nv_bfloat16 *src, *odd;
  int rw;
  stream_of(p, C, which, b, src, odd, rw);
  float lw[8], lb[8], w0[8], w1[8], w2[8];
  const int tap = ROW_QCONV + 3 * which;
#pragma unroll
  for (int i = 0; i < 8; ++i) {   // zeros on an inactive lane: its conv rows are 0
    lw[i] = act ? v[rw * C + c0 + i] : 0.f;
    lb[i] = act ? v[(rw + 1) * C + c0 + i] : 0.f;
    w0[i] = act ? v[tap * C + c0 + i] : 0.f;
    w1[i] = act ? v[(tap + 1) * C + c0 + i] : 0.f;
    w2[i] = act ? v[(tap + 2) * C + c0 + i] : 0.f;
  }
  const uint8_t* mrow = p.mask + (size_t)b * p.T;
#pragma unroll 1
  for (int run = 0; run < 16 / RUN; ++run) {
    const int i0 = 16 * warp + RUN * run, s0 = r0 + i0;
    if (p.mode == MODE_DS_SELF) {   // y[i] = w0 odd[i-1] + w1 even[i] + w2 odd[i]
      float le[RUN][8], lo[RUN + 1][8];
#pragma unroll
      for (int k = 0; k <= RUN; ++k) ln_stream_row(lo[k], odd, s0 - 1 + k, p.T, C, c0, act, lw, lb);
#pragma unroll
      for (int k = 0; k < RUN; ++k) ln_stream_row(le[k], src, s0 + k, p.T, C, c0, act, lw, lb);
#pragma unroll
      for (int o = 0; o < RUN; ++o) {
        const int s = s0 + o;
        const float mv = (s < p.T && mrow[s]) ? 1.f : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) le[o][i] = (lo[o][i] * w0[i] + le[o][i] * w1[i] + lo[o + 1][i] * w2[i]) * mv;
        ln_store_row(le[o], tile, i0 + o, lane, C, act);
      }
    } else {
      float l[RUN + 2][8];
#pragma unroll
      for (int k = 0; k < RUN + 2; ++k) ln_stream_row(l[k], src, s0 - 1 + k, p.T, C, c0, act, lw, lb);
#pragma unroll
      for (int o = 0; o < RUN; ++o) {
        const int s = s0 + o;
        const float mv = (s < p.T && mrow[s]) ? 1.f : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) l[o][i] = (l[o][i] * w0[i] + l[o + 1][i] * w1[i] + l[o + 2][i] * w2[i]) * mv;
        ln_store_row(l[o], tile, i0 + o, lane, C, act);
      }
    }
  }
}

// The same rows for C > 256, in three passes over the 256-channel groups
// of a row (a lane holds 8 channels of each): (A) the moments of the input
// rows a run of four output rows needs, (B) group by group their LN, the
// conv, its rounded output into the tile and the output rows' moments, (C)
// the output rows' LN in place. The arithmetic and its rounding points are
// conv_rows'; only the order of the f32 sums of the moments differs.
__device__ __forceinline__ void conv_rows_wide(const ParamsW& p, const Dims& d, int which,
                                               int b, int r0, uint32_t tile, int warp,
                                               int lane) {
  constexpr int RUN = 4;
  constexpr int NIN = 2 * RUN + 1;           // input rows a run reads, at most (ds_self)
  const float* v = p.vecs;
  const int C = d.C;
  const bool ds = p.mode == MODE_DS_SELF;
  const __nv_bfloat16 *src, *odd;
  int rw;
  stream_of(p, C, which, b, src, odd, rw);
  const int tap = ROW_QCONV + 3 * which;
  const uint8_t* mrow = p.mask + (size_t)b * p.T;
  // input row k of a run: ds_self odd rows s0 - 1 + k (k <= RUN), then even
  // rows s0 + k - RUN - 1; otherwise rows s0 - 1 + k (k < RUN + 2)
  const int nin = ds ? 2 * RUN + 1 : RUN + 2;
  auto in_row = [&](int k, int s0, const __nv_bfloat16*& base) {
    if (ds && k > RUN) { base = src; return s0 + k - RUN - 1; }
    base = ds ? odd : src;
    return s0 - 1 + k;
  };
  auto load8 = [&](float (&f)[8], const __nv_bfloat16* base, int s, int c0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = 0.f;
    if (s >= 0 && s < p.T && c0 < C) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + (size_t)s * C + c0);
      const uint32_t* u = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t2 = unpack2(u[i]);
        f[2 * i] = t2.x;
        f[2 * i + 1] = t2.y;
      }
    }
  };
#pragma unroll 1
  for (int run = 0; run < 16 / RUN; ++run) {
    const int i0 = 16 * warp + RUN * run, s0 = r0 + i0;
    // (A) input rows' moments
    float mu[NIN], rs[NIN];
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      mu[k] = 0.f;
      rs[k] = 0.f;
      if (k >= nin) continue;
      const __nv_bfloat16* base;
      const int s = in_row(k, s0, base);
      float s1 = 0.f, s2 = 0.f;
      for (int c0 = 8 * lane; c0 < C; c0 += 256) {
        float f[8];
        load8(f, base, s, c0);
#pragma unroll
        for (int i = 0; i < 8; ++i) { s1 += f[i]; s2 += f[i] * f[i]; }
      }
      mu[k] = warp_sum(s1) / C;
      rs[k] = rsqrtf(fmaxf(warp_sum(s2) / C - mu[k] * mu[k], 0.f) + LN_EPS);
    }
    // (B) group by group: LN, conv, rounded output into the tile, moments
    float so1[RUN], so2[RUN];
#pragma unroll
    for (int o = 0; o < RUN; ++o) { so1[o] = 0.f; so2[o] = 0.f; }
    for (int c0 = 8 * lane; c0 - 8 * lane < C; c0 += 256) {
      const bool act = c0 < C;
      float lw[8], lb[8], w0[8], w1[8], w2[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        lw[i] = act ? v[rw * C + c0 + i] : 0.f;
        lb[i] = act ? v[(rw + 1) * C + c0 + i] : 0.f;
        w0[i] = act ? v[tap * C + c0 + i] : 0.f;
        w1[i] = act ? v[(tap + 1) * C + c0 + i] : 0.f;
        w2[i] = act ? v[(tap + 2) * C + c0 + i] : 0.f;
      }
      float l[NIN][8];
#pragma unroll
      for (int k = 0; k < NIN; ++k) {
#pragma unroll
        for (int i = 0; i < 8; ++i) l[k][i] = 0.f;
        if (k >= nin) continue;
        const __nv_bfloat16* base;
        const int s = in_row(k, s0, base);
        float f[8];
        load8(f, base, s, c0);
        const bool in = s >= 0 && s < p.T;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          l[k][i] = in ? rnd16((f[i] * rs[k] - mu[k] * rs[k]) * lw[i] + lb[i]) : 0.f;
      }
#pragma unroll
      for (int o = 0; o < RUN; ++o) {
        const int s = s0 + o;
        const float mv = (s < p.T && mrow[s]) ? 1.f : 0.f;
        float y[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = ds ? l[o][i] * w0[i] + l[RUN + 1 + o][i] * w1[i] + l[o + 1][i] * w2[i]
                             : l[o][i] * w0[i] + l[o + 1][i] * w1[i] + l[o + 2][i] * w2[i];
          y[i] = rnd16(a * mv);
          so1[o] += y[i];
          so2[o] += y[i] * y[i];
        }
        uint32_t u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) u[i] = pack_bf16(y[2 * i], y[2 * i + 1]);
        if (act) st_shared16(tile_chunk(tile, i0 + o, c0), u);
      }
    }
    // (C) the output rows' LN, in place (each lane reads back its own chunks)
#pragma unroll
    for (int o = 0; o < RUN; ++o) {
      const float m = warp_sum(so1[o]) / C;
      const float r = rsqrtf(fmaxf(warp_sum(so2[o]) / C - m * m, 0.f) + LN_EPS);
      for (int c0 = 8 * lane; c0 < C; c0 += 256) {
        const uint32_t a = tile_chunk(tile, i0 + o, c0);
        const uint4 yu = lds16(a);
        const uint32_t yw[4] = {yu.x, yu.y, yu.z, yu.w};
        uint32_t u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 y2 = unpack2(yw[i]);
          u[i] = pack_bf16(y2.x * r - m * r, y2.y * r - m * r);
        }
        st_shared16(a, u);
      }
    }
  }
}

// Attention -> the tile (CTX), a slab of whole heads at a time (`width`
// channels from column col0). Warp w takes rows w, w + 4, ... of the rows it
// is given, so the four warps walk neighbouring rows together. Lane l holds
// channels col0 + 8 l .. + 7, of head l / P of the slab (P = D / 8 lanes a
// head): a warp reads a q, k or v row's slab as one run of 16-byte pieces,
// the P lanes of a head sum a score by shuffles, and each lane writes its 16
// bytes of the row's context. Lanes past the slab's width hold zeros. Invalid
// query rows give zeros.
__device__ __forceinline__ float head_sum(float v, int P, int lane) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  if (P == 12) {   // D = 96: three quads a head
    const int lead = lane - lane % 12;
    return __shfl_sync(0xffffffffu, v, lead) + __shfl_sync(0xffffffffu, v, lead + 4) +
           __shfl_sync(0xffffffffu, v, lead + 8);
  }
  if (P >= 8) v += __shfl_xor_sync(0xffffffffu, v, 4);
  if (P >= 16) v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v;
}

// Banded, rows i0 .. i0 + AR - 1 of the tile, from rows of one slab staged by
// TMA (rb bytes a row, zeros outside the sequence): their q at `qst`, their
// keys and values, rows r0 + i0 - W .. r0 + i0 + AR - 1 + W of the scratch,
// at `kst` and `vst`. Rounded products summed in f32 and rounded, the -1e4
// penalty in bf16, -1e30 outside the sequence, f32 softmax, the context
// summed offset by offset in bf16. The key masks come from two ballots. A
// half window W > 0 is a template parameter, so a row is one branch-free
// block and two rows' loads and shuffles interleave (the production
// instance's W = 1 .. 8); W = 0 takes the runtime half window p.w <= WMAX in
// one instance, its offsets unrolled to WMAX and those beyond p.w predicated
// off (scores -inf, values not read), which keeps the build's instances few.
template <int W, int WMAX = MAX_W>
__device__ void attend_band(const ParamsW& p, const Dims& dm, int b, int r0, int i0, int col0,
                            int width, uint32_t qst, uint32_t kst, uint32_t vst, int warp,
                            int lane, uint32_t tile) {
  constexpr int WM = W > 0 ? W : WMAX;       // offsets unrolled
  constexpr int AR = WM > 8 ? 16 : 32;       // the host's att_rows
  static_assert(AR + 2 * WM <= 64, "two ballots hold the staged rows' masks");
  const int w = W > 0 ? W : p.w, rows = AR + 2 * w;
  const int T_ = p.T, rb = 2 * dm.slab, off = 16 * lane, s0 = r0 + i0 - w, P = dm.D / 8;
  const bool act = 8 * lane < width;
  const uint8_t* mrow = p.mask + (size_t)b * T_;
  auto valid = [&](int s) { return s >= 0 && s < T_ && mrow[s] != 0; };
  // bit j: staged row j is a valid key (inside the sequence, not masked)
  const uint32_t lo = __ballot_sync(0xffffffffu, valid(s0 + lane));
  const uint32_t hi = __ballot_sync(0xffffffffu, lane + 32 < rows && valid(s0 + 32 + lane));
  auto bit = [&](int j) { return ((j < 32 ? lo >> j : hi >> (j - 32)) & 1u) != 0; };
  const float pen = rnd16(-NEG_PENALTY);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 2
  for (int i = warp; i < AR; i += 4) {
    const int r = r0 + i0 + i;
    const uint4 qu = act ? lds16(qst + (uint32_t)(i * rb + off)) : zero;
    const uint32_t q[4] = {qu.x, qu.y, qu.z, qu.w};
    float sc[2 * WM + 1];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int d = -WM; d <= WM; ++d) {
      const bool on = W > 0 || (d >= -w && d <= w);   // compile-time true for W > 0
      const uint4 ku = act && on ? lds16(kst + (uint32_t)((i + w + d) * rb + off)) : zero;
      const uint32_t kw[4] = {ku.x, ku.y, ku.z, ku.w};
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 pr = unpack2(bf16x2_mul(q[e], kw[e]));
        part += pr.x + pr.y;
      }
      part = rnd16(head_sum(part, P, lane));
      const bool inseq = on && r + d >= 0 && r + d < T_;
      const float sv = !inseq ? NEG_INF : bit(i + w + d) ? part : rnd16(part + pen);
      sc[d + WM] = on ? sv : -CUDART_INF_F;
      mx = fmaxf(mx, sc[d + WM]);
    }
    float den = 0.f;
#pragma unroll
    for (int d = 0; d <= 2 * WM; ++d) {
      sc[d] = expf(sc[d] - mx);
      den += sc[d];
    }
    const float inv = 1.f / den;
    uint32_t ctx[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int d = -WM; d <= WM; ++d) {   // a key outside the sequence was staged as zeros
      if (W == 0 && (d < -w || d > w)) continue;
      const uint32_t pr = pack_bf16(sc[d + WM] * inv, sc[d + WM] * inv);
      const uint4 vu = act ? lds16(vst + (uint32_t)((i + w + d) * rb + off)) : zero;
      const uint32_t vw[4] = {vu.x, vu.y, vu.z, vu.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) ctx[e] = bf16x2_add(ctx[e], bf16x2_mul(pr, vw[e]));
    }
    const bool live = r < T_ && bit(i + w);
#pragma unroll
    for (int e = 0; e < 4; ++e) ctx[e] = live ? ctx[e] : 0u;
    if (act) st_shared16(tile_chunk(tile, i0 + i, col0 + 8 * lane), ctx);
  }
}

// The context the attention launch left in the q columns of the scratch
// (invalid rows already zero) -> the tile; rows past T are zeros.
__device__ __forceinline__ void ctx_from_scratch(const ParamsW& p, const Dims& d, int b, int r0,
                                                 uint32_t tile) {
  const int C = d.C, cpr = C / 8;            // 16-byte chunks a row
  const __nv_bfloat16* src = p.qkv + (size_t)b * p.T * 3 * C;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < WG_ROWS * cpr; idx += NTW) {
    const int i = idx / cpr, c = 8 * (idx % cpr), r = r0 + i;
    const uint4 u = r < p.T ? *reinterpret_cast<const uint4*>(src + (size_t)r * 3 * C + c)
                            : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
    st_shared16(tile_chunk(tile, i, c), w4);
  }
}

// The bf16 GELU (the division-free polynomial, rounded) of every bf16 value.
static __device__ __nv_bfloat16 gelu_cheap_table[65536];   // one a translation unit
struct GeluCheap {
  __device__ float operator()(float x) const { return gelu<true>(x); }
};

// The L2 is asked for the tile's input rows s0 .. s0 + n - 1 of x (B, T, C)
// ahead of the loads that need them.
__device__ __forceinline__ void prefetch_rows(const __nv_bfloat16* x, int s0, int n, int T, int C) {
  const int lines = C / 64;                  // 128-byte lines a row
  for (int i = threadIdx.x; i < lines * n; i += NTW) {
    const int s = s0 + i / lines;
    if (s >= 0 && s < T)
      asm volatile("prefetch.global.L2 [%0];\n" :: "l"(x + (size_t)s * C + 64 * (i % lines)));
  }
}

// Thread (warp, g, t) of the accumulator layout: rows 16 warp + g + 8 hf,
// columns g0 + 8 j + 2 t + e of an output group.
struct Frag { int warp, g, t; };

// q, k or v (`which`) of one output group: the product, bias (q scaled), to
// the scratch.
template <int NG>
__device__ __forceinline__ void qkv_group(const ParamsW& p, const Dims& d, int which, int b,
                                          int r0, int g0, uint32_t tile, Ring& ring,
                                          float (&accf)[128], Frag fr) {
  float (&acc)[NG / 2] = acc_of<NG>(accf);
  product<NG>(acc, tile, ring, d.ks);
  const int C = d.C;
  const float* v = p.vecs;
  const int brow = (ROW_Q_BIAS + which) * C;
  const float qscale = rnd16(1.f / sqrtf((float)d.D));
#pragma unroll
  for (int j = 0; j < NG / 8; ++j) {
    const int n = g0 + 8 * j + 2 * fr.t;
    const float b0 = rnd16(v[brow + n]), b1 = rnd16(v[brow + n + 1]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = r0 + 16 * fr.warp + fr.g + 8 * hf;
      if (m >= p.T) continue;
      float y0 = rnd16(rnd16(acc[4 * j + 2 * hf]) + b0);
      float y1 = rnd16(rnd16(acc[4 * j + 2 * hf + 1]) + b1);
      if (which == 0) { y0 = rnd16(y0 * qscale); y1 = rnd16(y1 * qscale); }
      *reinterpret_cast<uint32_t*>(p.qkv + ((size_t)b * p.T + m) * 3 * C + which * C + n) =
          pack_bf16(y0, y1);
    }
  }
}

// proj of one output group + masked skip + layer-scaled residual -> y1, to
// the output rows and kept in acc; adds each row's sums for its LN to s1, s2.
template <int NG>
__device__ __forceinline__ void proj_group(const ParamsW& p, const Dims& d, int b, int r0,
                                           int g0, uint32_t tile, Ring& ring,
                                           float (&accf)[128], Frag fr, float (&s1)[2],
                                           float (&s2)[2]) {
  float (&acc)[NG / 2] = acc_of<NG>(accf);
  product<NG>(acc, tile, ring, d.ks);
  const int C = d.C, T_ = p.T;
  const float* v = p.vecs;
  const float coef_attn = p.coefs ? p.coefs[2 * b] : 1.f;
  const __nv_bfloat16* xb = p.x + (size_t)b * T_ * C;
  const __nv_bfloat16* ob = p.xo + (size_t)b * T_ * C;
  __nv_bfloat16* outb = p.out + (size_t)b * T_ * C;
  const uint8_t* mrow = p.mask + (size_t)b * T_;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = r0 + 16 * fr.warp + fr.g + 8 * hf;
    const bool in = m < T_;
    const float mq = (in && mrow[m]) ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < NG / 8; ++j) {
      const int n = g0 + 8 * j + 2 * fr.t;
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
      s1[hf] += y[0] + y[1];
      s2[hf] += y[0] * y[0] + y[1] * y[1];
    }
  }
}

// y1's plain LN of one output group -> the tile: from acc (one group), or
// read back from the output rows this thread wrote (several).
template <int NG>
__device__ __forceinline__ void ln_group(const ParamsW& p, const Dims& d, int b, int r0, int g0,
                                         uint32_t tile, float (&accf)[128], bool from_out,
                                         Frag fr, const float (&mu)[2], const float (&rs)[2]) {
  float (&acc)[NG / 2] = acc_of<NG>(accf);
  const __nv_bfloat16* outb = p.out + (size_t)b * p.T * d.C;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = 16 * fr.warp + fr.g + 8 * hf, m = r0 + i;
#pragma unroll
    for (int j = 0; j < NG / 8; ++j) {
      const int n = g0 + 8 * j + 2 * fr.t;
      float y0 = acc[4 * j + 2 * hf], y1 = acc[4 * j + 2 * hf + 1];
      if (from_out) {
        const float2 yy = m < p.T ? unpack2(*reinterpret_cast<const uint32_t*>(outb + (size_t)m * d.C + n))
                                  : make_float2(0.f, 0.f);
        y0 = yy.x;
        y1 = yy.y;
      }
      asm volatile("st.shared.b32 [%0], %1;\n"
                   :: "r"(tile + tile_at(i, n)),
                      "r"(pack_bf16(y0 * rs[hf] - mu[hf] * rs[hf], y1 * rs[hf] - mu[hf] * rs[hf]))
                   : "memory");
    }
  }
}

// The MLP for one output group: C / 16 hidden chunks of 64, each fc1 (f1
// stages) -> GELU -> the chunk tile -> fc2 of the group's columns, whose sums
// stay in acc; fc2 of chunk j runs while fc1 of j + 1 is issued. Then the
// fc2 bias, masked and layer-scaled, onto y1 -> the output rows.
template <int NG>
__device__ __forceinline__ void mlp_group(const ParamsW& p, const Dims& d, int b, int r0, int g0,
                                          uint32_t tile, uint32_t hc, Ring& ring,
                                          float (&accf)[128], float (&h1)[32], Frag fr) {
  float (&acc)[NG / 2] = acc_of<NG>(accf);
  const uint16_t* gt = reinterpret_cast<const uint16_t*>(gelu_cheap_table);
  const int C = d.C, T_ = p.T;
  const float* v = p.vecs;
#pragma unroll
  for (int i = 0; i < NG / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int j = 0; j < C / 16; ++j) {
#pragma unroll 1
    for (int f = 0; f < d.f1; ++f) {
      const uint32_t st1 = ring.take();
      const int nk = min(4, d.ks - 4 * f);
      fence_regs(h1);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (kb >= nk) break;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaSS<64>::run(h1, tile_desc(tile + (4 * f + kb) * BOX + kk * 32),
                           tile_desc(st1 + kb * BOX + kk * 32), f | kb | kk);
      }
      wgmma_commit();
      if (f + 1 < d.f1) {
        wgmma_wait<1>();
        ring.release_to(ring.n - 1);
      }
    }
    wgmma_wait<0>();                 // fc1 of j and fc2 of j - 1
    fence_regs(h1);
    fence_regs(acc);
    ring.release_to(ring.n);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = 8 * jj + 2 * fr.t;
      const float b0 = rnd16(p.fc1b[64 * j + n]), b1 = rnd16(p.fc1b[64 * j + n + 1]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {   // GELU of the rounded fc1 output, from the table
        const uint32_t a0 = __ldg(gt + bf16_bits(rnd16(h1[4 * jj + 2 * hf]) + b0));
        const uint32_t a1 = __ldg(gt + bf16_bits(rnd16(h1[4 * jj + 2 * hf + 1]) + b1));
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(hc + swz(16 * fr.warp + fr.g + 8 * hf, jj) + 4 * fr.t),
                        "r"(a0 | a1 << 16)
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
      WgmmaSS<NG>::run(acc, tile_desc(hc + kk * 32), tile_desc(st2 + kk * 32), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release_to(ring.n);

  // fc2 bias, masked, layer-scaled residual onto y1 -> out
  const float coef_mlp = p.coefs ? p.coefs[2 * b + 1] : 1.f;
  __nv_bfloat16* outb = p.out + (size_t)b * T_ * C;
  const uint8_t* mrow = p.mask + (size_t)b * T_;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = r0 + 16 * fr.warp + fr.g + 8 * hf;
    if (m >= T_) continue;
    const float mq = mrow[m] ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < NG / 8; ++j) {
      const int n = g0 + 8 * j + 2 * fr.t;
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

// CW: 256 for the production block (C = 256, 4 heads of 64) with its shape
// compile-time constants, or 0 for any shape of the domain.
template <int PHASE, int CW>
__global__ void __launch_bounds__(NTW, 1)
fused_block_wgmma_kernel(const __grid_constant__ WeightMaps maps,
                         const __grid_constant__ ParamsW p) {
  extern __shared__ __align__(1024) unsigned char smraw[];
  const Dims d = dims_of<CW>(p);
  const uint32_t ring_base = (smem_u32(smraw) + 1023u) & ~1023u;
  const uint32_t hc = ring_base + STAGES * STAGE, tile = hc + HCHUNK, bars = tile + WG_ROWS * 2 * d.C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Frag fr{warp, lane / 4, lane % 4};
  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + 8 * s, 1);   // ring slots, staged rows
    mbar_init_fence();
  }
  __syncthreads();
  const int count = PHASE == PHASE_QKV ? 3 * d.nb * d.ks
                                       : d.nb * d.ks + d.nb * (d.C / 16) * (d.f1 + 1);
  Ring ring{&maps, d, ring_base, bars, 0, 0, count, PHASE};
  if (PHASE == PHASE_QKV) ring.start();
  const int tps = (p.T + WG_ROWS - 1) / WG_ROWS;
  const int b = blockIdx.x / tps, r0 = (blockIdx.x % tps) * WG_ROWS;
  const int T_ = p.T, C = d.C;
  const __nv_bfloat16* xb = p.x + (size_t)b * T_ * C;
  const __nv_bfloat16* ob = p.xo + (size_t)b * T_ * C;
  prefetch_rows(xb, r0 - 1, WG_ROWS + 2, T_, C);       // the conv's rows, the skip's
  if (p.mode != MODE_SELF) prefetch_rows(ob, r0 - 1, WG_ROWS + 2, T_, C);
  float acc[128];

  if (PHASE == PHASE_QKV) {
#pragma unroll 1
    for (int which = 0; which < 3; ++which) {
      if (C <= 256) conv_rows(p, d, which, b, r0, tile, warp, lane);
      else conv_rows_wide(p, d, which, b, r0, tile, warp, lane);
      fence_async_shared();
      bar_sync(1, 128);
#pragma unroll 1
      for (int g0 = 0; g0 < C; g0 += 256) {
#define AVDD_QKV(NG) qkv_group<NG>(p, d, which, b, r0, g0, tile, ring, acc, fr)
        AVDD_BY_WIDTH(min(256, C - g0), AVDD_QKV)
#undef AVDD_QKV
      }
      // every warp's products have read the tile before the next stream's rows land
      bar_sync(1, 128);
    }
    return;
  }

  // ---- PHASE_TAIL ----
  // attention first: banded slab by slab, in chunks of att_rows query rows
  // whose q, keys and values TMA stages in the ring's space; else the
  // context the attention launch wrote. Then the ring starts on wp
  if (p.attn == ATT_BAND) {
    const int ar = p.att_rows, rows = ar + 2 * p.w, rb = 2 * d.slab;
    const uint32_t kst = ring_base + ar * rb, vst = kst + rows * rb;
    const uint32_t stbar = bars + 8 * STAGES;
    int k = 0;
    for (int i0 = 0; i0 < WG_ROWS; i0 += ar) {
      for (int col0 = 0; col0 < C; col0 += d.slab, ++k) {
        if (threadIdx.x == 0) {
          mbar_expect_tx(stbar, (ar + 2 * rows) * rb);
          tma_load_3d(ring_base, &maps.q, col0, r0 + i0, b, stbar);
          tma_load_3d(kst, &maps.kv, C + col0, r0 + i0 - p.w, b, stbar);
          tma_load_3d(vst, &maps.kv, 2 * C + col0, r0 + i0 - p.w, b, stbar);
        }
        mbar_wait(stbar, k & 1);
        const int width = min(d.slab, C - col0);
#define AVDD_BAND(W, WMAX) \
  attend_band<W, WMAX>(p, d, b, r0, i0, col0, width, ring_base, kst, vst, warp, lane, tile)
        if constexpr (CW == 0) {  // any shape: two instances, w <= 8 and w <= 16
          if (p.w <= 8) AVDD_BAND(0, 8);
          else AVDD_BAND(0, MAX_W);
        } else {
          switch (p.w) {
            case 1: AVDD_BAND(1, 1); break;
            case 2: AVDD_BAND(2, 2); break;
            case 3: AVDD_BAND(3, 3); break;
            case 4: AVDD_BAND(4, 4); break;
            case 5: AVDD_BAND(5, 5); break;
            case 6: AVDD_BAND(6, 6); break;
            case 7: AVDD_BAND(7, 7); break;
            case 8: AVDD_BAND(8, 8); break;
            default: AVDD_BAND(0, MAX_W); break;
          }
        }
#undef AVDD_BAND
        fence_async_shared();
        __syncthreads();               // the staged rows are read before they are refilled
      }
    }
  } else {
    ctx_from_scratch(p, d, b, r0, tile);
    fence_async_shared();
    __syncthreads();
  }
  ring.start();

  // proj + masked skip + layer-scaled residual -> y1 (to out), then its plain
  // LN (quad of four threads = one row) -> the tile
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll 1
  for (int g0 = 0; g0 < C; g0 += 256) {
#define AVDD_PROJ(NG) proj_group<NG>(p, d, b, r0, g0, tile, ring, acc, fr, s1, s2)
    AVDD_BY_WIDTH(min(256, C - g0), AVDD_PROJ)
#undef AVDD_PROJ
  }
  float mu[2], rs[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    s1[hf] += __shfl_xor_sync(0xffffffffu, s1[hf], 1);
    s2[hf] += __shfl_xor_sync(0xffffffffu, s2[hf], 1);
    s1[hf] += __shfl_xor_sync(0xffffffffu, s1[hf], 2);
    s2[hf] += __shfl_xor_sync(0xffffffffu, s2[hf], 2);
    mu[hf] = s1[hf] / C;
    rs[hf] = rsqrtf(fmaxf(s2[hf] / C - mu[hf] * mu[hf], 0.f) + LN_EPS);
  }
  const bool several = C > 256;
  if (several) bar_sync(1, 128);   // every group's proj has read the context
#pragma unroll 1
  for (int g0 = 0; g0 < C; g0 += 256) {
#define AVDD_LN(NG) ln_group<NG>(p, d, b, r0, g0, tile, acc, several, fr, mu, rs)
    AVDD_BY_WIDTH(min(256, C - g0), AVDD_LN)
#undef AVDD_LN
  }
  fence_async_shared();
  bar_sync(1, 128);

  float h1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) h1[i] = 0.f;
#pragma unroll 1
  for (int g0 = 0; g0 < C; g0 += 256) {
#define AVDD_MLP(NG) mlp_group<NG>(p, d, b, r0, g0, tile, hc, ring, acc, h1, fr)
    AVDD_BY_WIDTH(min(256, C - g0), AVDD_MLP)
#undef AVDD_MLP
  }
}

// One launch of the kernel instance <PHASE, CW> on p.tiles blocks.
template <int PHASE, int CW>
int launch_phase(const WeightMaps& maps, const ParamsW& p, int smem, cudaStream_t stream) {
  static int configured = 0;
  if (int e = set_smem(fused_block_wgmma_kernel<PHASE, CW>, smem, configured)) return e;
  fused_block_wgmma_kernel<PHASE, CW><<<(unsigned)p.tiles, NTW, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

// The any-shape instance's first launch, compiled in fused_block_any_qkv.cu
// (its second is fused_block_any.cu's, so the two build side by side).
int launch_qkv_any(const WeightMaps& maps, const ParamsW& p, int smem, cudaStream_t stream);

// The attention launch on the tensor cores (fused_block_attend.cu), between
// the first launch and the tail when p.attn == ATT_SCRATCH: the context of
// every row into the q columns of the scratch.
int launch_attend(const ParamsW& p, cudaStream_t stream);

// Both launches of the kernel instance CW (256: the production block; 0: any
// shape), in the translation unit that compiles its second launch (the
// GELU table the second reads is that unit's).
template <int CW>
int launch_wgmma(ParamsW& p, const void* const* w, cudaStream_t stream) {
  static __nv_bfloat16* table = nullptr;
  static unsigned table_ready = 0;
  if (!table)
    if (int e = (int)cudaGetSymbolAddress(reinterpret_cast<void**>(&table), gelu_cheap_table))
      return e;
  if (int e = fill_table(table, GeluCheap{}, table_ready, stream)) return e;
  const int C = p.C, smem = wg_smem(C);
  WeightMaps maps;
  const uint64_t sq[2] = {(uint64_t)C, (uint64_t)C}, st[1] = {2ull * C};
  const uint32_t box[2] = {64, CW == 256 ? 256u : 64u}, box1[2] = {64, 64};   // Dims::br
  for (int i = 0; i < 4; ++i)
    if (int e = bf16_tensor_map(&maps.w[i], w[i], 2, sq, st, box)) return e;
  const uint64_t d1[2] = {(uint64_t)C, 4ull * C}, d2[2] = {4ull * C, (uint64_t)C},
                 st2[1] = {8ull * C};
  if (int e = bf16_tensor_map(&maps.w[4], w[4], 2, d1, st, box1)) return e;
  if (int e = bf16_tensor_map(&maps.w[5], w[5], 2, d2, st2, box)) return e;
  const uint64_t dq[3] = {3ull * C, (uint64_t)p.T, (uint64_t)(p.tiles / ((p.T + WG_ROWS - 1) / WG_ROWS))};
  const uint64_t sq3[2] = {6ull * C, (uint64_t)p.T * 6 * C};
  // (the banded step's boxes; another route reads no staged rows, and its
  // window may exceed a box's 256 rows)
  const int wb = p.attn == ATT_BAND ? p.w : 0;
  const uint32_t boxq[3] = {(uint32_t)p.slab, (uint32_t)p.att_rows, 1},
                 boxkv[3] = {(uint32_t)p.slab, (uint32_t)(p.att_rows + 2 * wb), 1};
  if (int e = bf16_tensor_map(&maps.q, p.qkv, 3, dq, sq3, boxq, false)) return e;
  if (int e = bf16_tensor_map(&maps.kv, p.qkv, 3, dq, sq3, boxkv, false)) return e;
  int e;
  if constexpr (CW == 0) e = launch_qkv_any(maps, p, smem, stream);
  else e = launch_phase<PHASE_QKV, CW>(maps, p, smem, stream);
  if (!e && p.attn == ATT_SCRATCH) e = launch_attend(p, stream);
  return e ? e : launch_phase<PHASE_TAIL, CW>(maps, p, smem, stream);
}

// ---- float32: 3xTF32 on wgmma (fused_block_f32.cu, fused_block_f32_attend.cu)
// Eight launches through a scratch in device memory (design in
// fused_block_f32.cu); R = B T rows, Tp = T rounded up to KEY_TILE.
constexpr int KEY_TILE = 32;    // keys a tile of the f32 attention launch

struct ParamsF {
  const float* x;       // (B, T, C) (ds_self: even rows)
  const float* xo;      // (B, T, C) other stream (ds_self: odd rows); x in self mode
  const uint8_t* mask;  // (B, T) bool
  const float* vecs;    // (22, C) packed vectors
  const float* fc1b;    // (4C,)
  const float* coefs;   // (B, 2) droppath coefficients (attn, mlp), or null = 1
  const float* wt[6];   // wq, wk, wv, wp (C, C), wf1 (4C, C), wf2 (C, 4C): (out, in)
  float* out;           // (B, T, C): y1 after proj, the block's output after fc2
  int B, T, C, NH, D, w, mode, Tp;
  // the scratch, carved by f32_carve
  float* whi; float* wlo;     // 12 C^2 each: [wq; wk; wv] (3C, C) | wp | wf1 | wf2
  float* xhi; float* xlo;     // (R, 3C) conv + LN rows of the q | k | v streams,
                              // later (R, 4C) the GELU'd hidden units
  float* q;                   // (R, C) q, scaled
  float* khi; float* klo;     // (R, C) k
  float* vthi; float* vtlo;   // (B, C, Tp) v transposed, keys past T zero
  float* chi; float* clo;     // (R, C) the attention context, later LN(y1)
  float* s; float* slo;       // f32_scores_gemm: (B H, T, Tp) the scores, then P hi | P lo
};

// Dense attention past head width 128 runs as two GEMMs through the scores
// (fused_block_f32_attend.cu), which then take 2 B H T Tp floats more.
__host__ __device__ inline bool f32_scores_gemm(int d, int w) { return d > 128 && w <= 0; }

// Floats of scratch a call needs (H heads, half window w; w <= 0 dense);
// carves `scratch` into p's fields.
inline long long f32_scratch_elems(long long B, long long T, long long C, long long H, int w) {
  const long long R = B * T, Tp = (T + KEY_TILE - 1) / KEY_TILE * KEY_TILE;
  const long long scores = f32_scores_gemm((int)(C / H), w) ? 2 * B * H * T * Tp : 0;
  return 24 * C * C + 13 * R * C + 2 * B * C * Tp + scores;
}
inline void f32_carve(ParamsF& p, float* scratch) {
  const long long C = p.C, R = (long long)p.B * p.T;
  p.Tp = (p.T + KEY_TILE - 1) / KEY_TILE * KEY_TILE;
  float* f = scratch;
  auto take = [&](long long n) { float* r = f; f += n; return r; };
  p.whi = take(12 * C * C); p.wlo = take(12 * C * C);
  p.xhi = take(4 * R * C); p.xlo = take(4 * R * C);
  p.q = take(R * C);
  p.khi = take(R * C); p.klo = take(R * C);
  p.vthi = take((long long)p.B * C * p.Tp); p.vtlo = take((long long)p.B * C * p.Tp);
  p.chi = take(R * C); p.clo = take(R * C);
  const long long ns = f32_scores_gemm(p.D, p.w) ? (long long)p.B * p.NH * p.T * p.Tp : 0;
  p.s = ns ? take(ns) : nullptr;
  p.slo = ns ? take(ns) : nullptr;
}

// Two adjacent values a, b split into TF32 parts: hi[i], hi[i + 1] and lo[i],
// lo[i + 1] (i even).
__device__ __forceinline__ void store_split2(float* hi, float* lo, size_t i, float a, float b) {
  uint32_t ha, la, hb, lb;
  tf32_split(a, ha, la);
  tf32_split(b, hb, lb);
  *reinterpret_cast<float2*>(hi + i) = make_float2(__uint_as_float(ha), __uint_as_float(hb));
  *reinterpret_cast<float2*>(lo + i) = make_float2(__uint_as_float(la), __uint_as_float(lb));
}

// The f32 block's launches (fused_block_f32.cu), and its attention launch
// (fused_block_f32_attend.cu), which they call.
int launch_f32(ParamsF& p, float* scratch, cudaStream_t stream);
int launch_f32_attend(const ParamsF& p, cudaStream_t stream);

// The instance for any width, compiled in fused_block_any.cu.
int launch_wgmma_any(ParamsW& p, const void* const* w, cudaStream_t stream);

// ---- a row a block: the streams' rows and the LN of y1 at any C -----------
// The f32 launches past C = 1024 (there a warp's three rows of C / 32
// values a lane spill) and the bf16 scratch route at every C hold a row in a
// block of RB_THREADS threads, channel tid + RB_THREADS j in value j.
constexpr int RB_THREADS = 256;
constexpr int RB_V = MAX_C_ANY / RB_THREADS;

// Sum over the block of every thread's v; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                      // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < RB_THREADS / 32 ? red[lane] : 0.f);
}

// _ln_plain on a row held by the block: one-pass moments in bf16, two-pass
// in f32; no affine.
template <bool BF16>
__device__ __forceinline__ void ln_block_row(float (&v)[RB_V], int C, float* red) {
  float s1 = 0.f;
#pragma unroll
  for (int j = 0; j < RB_V; ++j)
    if (threadIdx.x + RB_THREADS * j < C) s1 += v[j];
  const float mu = block_sum(s1, red) / C;
  if (BF16) {
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < RB_V; ++j)
      if (threadIdx.x + RB_THREADS * j < C) s2 = fmaf(v[j], v[j], s2);
    const float m2 = block_sum(s2, red) / C;
    const float rs = rsqrtf(fmaxf(__fsub_rn(m2, __fmul_rn(mu, mu)), 0.f) + LN_EPS);
#pragma unroll
    for (int j = 0; j < RB_V; ++j) v[j] = __fsub_rn(__fmul_rn(v[j], rs), __fmul_rn(mu, rs));
  } else {
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < RB_V; ++j) {
      v[j] = __fsub_rn(v[j], mu);
      if (threadIdx.x + RB_THREADS * j < C) s2 = fmaf(v[j], v[j], s2);
    }
    const float rs = rsqrtf(block_sum(s2, red) / C + LN_EPS);
#pragma unroll
    for (int j = 0; j < RB_V; ++j) v[j] = __fmul_rn(v[j], rs);
  }
}

// qkv_rows before its products, stream `which` (0 q, 1 k, 2 v) of row r =
// b T + s, held by the block: the LN with the stream's affine of the input
// rows the k3 depthwise conv reads (ds_self: odd s - 1, even s, odd s; else
// s - 1, s, s + 1; zero outside the sequence), the conv, the mask, the plain
// LN, rounded to T where block_math rounds. Into y.
template <typename T>
__device__ __forceinline__ void stream_row_block(const T* x, const T* xo, const uint8_t* mask,
                                                 const float* vecs, int T_, int C, int mode,
                                                 long long r, int which, float (&y)[RB_V],
                                                 float* red) {
  constexpr bool BF16 = sizeof(T) == 2;
  const int b = (int)(r / T_), t = (int)(r % T_);
  const T* xb = x + (size_t)b * T_ * C;
  const T* ob = xo + (size_t)b * T_ * C;
  const bool ds = mode == MODE_DS_SELF;
  const T* src = xb;
  int rw = ROW_LNQ_W;
  if (mode == MODE_QV_K || mode == MODE_KV) {
    if (which == 1) { rw = ROW_LNK_W; src = ob; }
    if (which == 2) { rw = ROW_LNV_W; if (mode == MODE_KV) src = ob; }
  }
  const int tap = ROW_QCONV + 3 * which;
#pragma unroll
  for (int j = 0; j < RB_V; ++j) y[j] = 0.f;
  for (int k = 0; k < 3; ++k) {
    const T* base = ds ? (k == 1 ? xb : ob) : src;
    const int s = ds ? (k == 0 ? t - 1 : t) : t - 1 + k;
    if (s < 0 || s >= T_) continue;     // a zero row: adds exactly nothing
    float l[RB_V];
#pragma unroll
    for (int j = 0; j < RB_V; ++j) {
      const int c = threadIdx.x + RB_THREADS * j;
      l[j] = c < C ? Num<T>::load(base, (size_t)s * C + c) : 0.f;
    }
    ln_block_row<BF16>(l, C, red);
#pragma unroll
    for (int j = 0; j < RB_V; ++j) {
      const int c = threadIdx.x + RB_THREADS * j;
      if (c < C) {
        const float a = Num<T>::rnd(
            __fadd_rn(__fmul_rn(l[j], vecs[rw * C + c]), vecs[(rw + 1) * C + c]));
        y[j] = __fadd_rn(y[j], __fmul_rn(a, vecs[(tap + k) * C + c]));
      }
    }
  }
  const float mv = mask[r] ? 1.f : 0.f;
#pragma unroll
  for (int j = 0; j < RB_V; ++j) y[j] = Num<T>::rnd(__fmul_rn(y[j], mv));
  ln_block_row<BF16>(y, C, red);
}

// ---- bfloat16 past wgmma_shape_ok: the scratch route ------------------------
// fused_block_bf16.cu: eight launches through a scratch of bf16_scratch_elems
// bf16 values; its design is there.
struct ParamsB {
  const __nv_bfloat16* x; const __nv_bfloat16* xo;  // as ParamsF's
  const uint8_t* mask; const float* vecs; const float* fc1b; const float* coefs;
  const __nv_bfloat16* wt[6];   // wq, wk, wv, wp (C, C), wf1 (4C, C), wf2 (C, 4C): (out, in)
  __nv_bfloat16* out;           // (B, T, C): y1 after proj, the block's output after fc2
  int B, T, C, NH, D, w, mode;
  // the scratch, carved by bf16_carve
  __nv_bfloat16* a3;    // (R, 3C) the streams' rows; later (R, C) the context where
                        // ctx_in_a3
  __nv_bfloat16* qkv;   // (R, 3C) q (scaled) | k | v; the context over q unless ctx_in_a3
  __nv_bfloat16* h;     // (R, C) LN(y1)
  __nv_bfloat16* hid;   // (R, 4C) the GELU'd hidden units, over a3 and qkv
};
// The attention launch writes the context over q, which only the block that
// read it reads, at head widths up to 128; past 128 every 128-column block
// of a head reads all of its q, so the context goes to a3 instead.
__host__ __device__ inline bool ctx_in_a3(int d) { return d > 128; }

inline long long bf16_scratch_elems(long long B, long long T, long long C) {
  return 7 * B * T * C;
}
inline void bf16_carve(ParamsB& p, __nv_bfloat16* scratch) {
  const long long RC = (long long)p.B * p.T * p.C;
  p.a3 = scratch;
  p.qkv = scratch + 3 * RC;
  p.h = scratch + 6 * RC;
  p.hid = scratch;
}

// The bf16 scratch route's launches (fused_block_bf16.cu) and its attention
// launch (fused_block_attend.cu), which they call.
int launch_bf16(ParamsB& p, __nv_bfloat16* scratch, cudaStream_t stream);
int launch_attend_scratch(const ParamsB& p, cudaStream_t stream);

// The route a launch took (avdd_fused_block's `route`; ROUTE_NAMES in
// ops/kernels/fused_block.py): f32's eight launches and bf16's two-launch
// instances inside wgmma_shape_ok, f32's and bf16's scratch routes past it.
enum { ROUTE_F32 = 0, ROUTE_BF16 = 1, ROUTE_F32_DOMAIN = 2, ROUTE_BF16_DOMAIN = 3 };

}  // namespace avdd_k1
