// MViT pooled attention in float32 for Hopper (sm_90a): the f32 route of K3
// (mvit_attention.cu's C entry: both of K3's entries) and K4's attention
// step (mvit_block_f32.cu), on the tensor cores in 3xTF32; and, as its
// KEY_BIAS mode, K8's full attention in f32 (full_attention.cu's C entry):
// softmax(q k^T + key_bias) v with q scaled by the caller, no band, no class
// key, no residual; a masked key keeps its value and weighs exp(-1e30 - max),
// so a sample whose keys are all masked averages v; keys past T weigh 0.
//
// It computes what pooled_attention_math and msblock_math's attention
// compute in f32, per (sample, head):
//   out = softmax(scale q k^T + [band | 0]) v (+ q),
// T grid keys then the class key last (no band on it), the band from the
// temporal table, band[n, k] = q[n] . rel[t_n - k + T - 1] (t_n the time
// step of grid row n), or given; CLS_FIRST: row 0 is the class query (no
// band, no residual). Where it differs, by f32 rounding only: every product
// is 3xTF32 (hi.hi + hi.lo + lo.hi of the TF32 parts, the tensor cores'
// sum of one 32-deep stage added to an f32 sum: their own accumulation
// truncates), the scores are scaled after the product (PRESCALE's rounding
// of q * scale is f32's own here, as BAND_ROUND's is), the softmax is
// online (a row's maximum and denominator kept over the key tiles, the
// context rescaled when the maximum moves) and the class key's score and
// value are f32 FMA sums.
//
// What bounds it on this card: a (64 query rows, 32 keys) tile is three
// products of 64 x 32 x d (scores, the band's G, P.V), three times over on
// the tensor cores; at d = 96 the operands it streams (k, the table rows,
// v^T, each split) are 72 KB a tile, so the tile's 3.5 MFLOP run near
// 50 operations a byte of L2: operations at the TF32 rate, with the L2's
// rate close behind.
//
// Design: a block of one warpgroup owns 64 query rows of one (sample,
// head). Its q is split once into two swizzled tiles (read by the scores'
// and G's products, both operands in shared memory). Per key tile of 32:
// - S = q k^T per 32-deep stage of the head dim (12 products each, two
//   stages in flight before the first wait);
// - G = q rel^T over 32 table rows, the same products. The rows a key tile
//   needs, t_n - k + T - 1 over the block's rows and the tile's keys, are
//   the previous tile's shifted down by 32: each tile computes 32 new rows
//   of G (one more block of 32 for each 32 time steps the rows span, before
//   the first tile) into a ring of 128 columns (table row mod 128) in
//   shared memory, and thread (row, key) adds G[row][t_row - key + T - 1].
//   Every warp writes and reads only its own 16 rows of the ring. The
//   tile's 32 keys and 32 table rows sit in one 64-row B tile, so S and G
//   are one m64n64k8 product (q read once for both);
// - the online softmax in registers; P split into TF32 parts in registers
//   is the A operand of P.V (m64nNk8 from registers, N = 48 at head dim 96,
//   two products), v^T (channel rows of 32 keys, each eight stored even
//   keys first) the B operand.
// k and the table rows (one stream) and v^T (another) come through rings
// of NS stages by cp.async, the k / table stage of tile i + NS loaded once
// tile i's scores and G are done, the v^T stage once its P.V is done.
// K3's and K4's split operands come from a launch before (k3_split_kernel;
// K4's pools write them). K8 (KEY_BIAS) stages each tile's k and v rows as they are,
// f32 through (sample, head, key) strides, so its strided views of the
// (B, T, 3, H, d) projection are read once, and splits them in shared
// memory (v transposed) after each tile's wait: a pre-pass splitting all of
// k and v cost 18% of the call at B = 64.

#include "mvit_f32.cuh"

namespace avdd_mvit {
namespace {

using namespace avdd;

constexpr int A_ROWS = 64;      // query rows a block: one warpgroup
constexpr int A_NT = 128;
constexpr int KEYS = 32;        // keys a tile
constexpr int RING = 128;       // G columns: table rows mod 128
constexpr int LDG = RING + 4;   // floats from one G row to the next

template <int WD, int MODE> struct Att {
  static constexpr bool TABLE = MODE == M_TABLE;
  static constexpr int KB = WD / 32;                   // 32-deep stages of the head dim
  static constexpr int QPART = A_ROWS * WD * 4;        // q hi (or lo): KB blocks of 64 rows
  static constexpr int BN = TABLE ? 2 * KEYS : KEYS;   // B rows of q's product: keys (+ table rows)
  static constexpr int BLK = BN * 128;                 // one 32-column block of them, hi or lo
  static constexpr int VPART = WD * KEYS * 4;          // v^T hi or lo: WD rows of 128 bytes
  static constexpr int NS = WD <= 96 ? 2 : 1;          // stages of each stream
  static constexpr int PN = WD == 96 ? 48 : WD == 128 ? 32 : WD;   // P.V width a product
  static constexpr int KR = 2 * KB * BLK;              // a k (and table) stage: hi blocks, lo blocks
  static constexpr int VS = 2 * VPART;                 // a v^T stage
  // K8 (M_FULL) stages k and v as they are, f32 rows, and splits one tile
  // of each in shared memory: one split stage each, NS raw stages
  static constexpr int NSPLIT = MODE == M_FULL ? 1 : NS;
  static constexpr int RAWT = KEYS * WD * 4;           // a raw k (or v) tile
  static constexpr int RAW = MODE == M_FULL ? NS * 2 * RAWT : 0;
  static constexpr int SMEM = 1024 + 2 * QPART + NSPLIT * (KR + VS) + RAW +
                              (TABLE ? A_ROWS * LDG * 4 : 0);
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

template <int WD, int MODE>
__global__ void __launch_bounds__(A_NT, 1) attention_f32_kernel(const __grid_constant__ AttnF32 p) {
  using A = Att<WD, MODE>;
  constexpr int NS = A::NS, PN = A::PN, KB = A::KB, BN = A::BN;
  constexpr bool TABLE = A::TABLE, FULL = MODE == M_FULL;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t raw = smem_u32(smraw);
  const uint32_t qhi = (raw + 1023u) & ~1023u, qlo = qhi + A::QPART;
  const uint32_t krs = qlo + A::QPART, vss = krs + A::NSPLIT * A::KR;
  const uint32_t rws = vss + A::NSPLIT * A::VS;     // K8's raw stages: k, v of each
  float* Gs = reinterpret_cast<float*>(smraw + (rws + A::RAW - raw));
  const int T = p.T, S = p.S, nq = p.nq, d = p.d;
  const int cls = !FULL && (p.flags & CLS_FIRST) ? 1 : 0;
  // row blocks fastest: the blocks of a (sample, head) run together and
  // share its keys and values in L2 (K8: one grid axis, any B nh)
  const int nrb = FULL ? (nq + A_ROWS - 1) / A_ROWS : 1;
  const int bh = FULL ? blockIdx.x / nrb : blockIdx.y, b = bh / p.nh, h = bh % p.nh;
  const int n0 = (FULL ? blockIdx.x % nrb : blockIdx.x) * A_ROWS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = n0 + 16 * warp + g, row1 = row0 + 8;
  const int nt = (T + KEYS - 1) / KEYS, tp = nt * KEYS;
  const float* q = p.q + b * p.qsb + h * p.qsh;
  const float* khi = p.khi + (size_t)bh * T * WD;
  const float* klo = p.klo + (size_t)bh * T * WD;
  const float* vthi = p.vthi + (size_t)bh * WD * tp;
  const float* vtlo = p.vtlo + (size_t)bh * WD * tp;
  const float* kbias = FULL && p.kbias ? p.kbias + (size_t)b * T : nullptr;
  const float* kraw = FULL ? p.k + b * p.ksb + h * p.ksh : nullptr;
  const float* vraw = FULL ? p.v + b * p.vsb + h * p.vsh : nullptr;

  // The band: key tile i needs table rows jb0 - 32 i .. jb0 - 32 i + 31 +
  // (the time steps the block's grid rows span); G block m holds rows
  // jb0 + 32 m .. + 31, so step i (from -M) computes block -i.
  int M = 0, jb0 = 0;
  if (TABLE) {
    const int t_first = max(n0 - cls, 0) / S;
    const int t_last = max(min(n0 + A_ROWS, nq) - 1 - cls, 0) / S;
    M = (t_last - t_first + 31) / 32;
    jb0 = t_first + T - KEYS;
  }
  // step i's stage: per 32-column block, its 32 keys (zeros before tile 0
  // and past T) and then, with the table, its 32 table rows (zeros out of
  // range), so that one product gives the scores and G side by side
  // K8: tile i's raw k (or v) rows, keys past T zero
  auto load_raw = [&](int i, int which) {
    if (i >= 0 && i < nt) {
      const uint32_t st = rws + (i % NS) * 2 * A::RAWT + which * A::RAWT;
      const float* src = which ? vraw : kraw;
      const long long kst = which ? p.vst : p.kst;
#pragma unroll
      for (int x = 0; x < KEYS * WD / 4 / A_NT; ++x) {
        const int idx = tid + A_NT * x, r = idx / (WD / 4), c = idx % (WD / 4), key = KEYS * i + r;
        const bool ok = key < T && 4 * c < d;     // zeros past T and past d
        cp_async16_to(st + 16 * idx, src + (ok ? key : 0) * kst + (ok ? 4 * c : 0), ok ? 16 : 0);
      }
    }
    cp_commit();
  };
  auto load_kr = [&](int i) {
    if constexpr (FULL) {
      load_raw(i, 0);
      return;
    }
    if (i >= -M && i < nt) {
      const uint32_t st = krs + ((i + M) % NS) * A::KR;
      constexpr int CH = KEYS * WD / 4;            // 16-byte chunks of one part
#pragma unroll
      for (int x = 0; x < 2 * CH / A_NT; ++x) {
        const int idx = tid + A_NT * x, part = idx / CH, r = (idx % CH) / (WD / 4);
        const int c = idx % (WD / 4), key = KEYS * i + r;
        const bool ok = i >= 0 && key < T;
        cp_async16_to(st + part * (KB * A::BLK) + (c / 8) * A::BLK + swz(r, c % 8),
                      (part ? klo : khi) + (size_t)(ok ? key : 0) * WD + 4 * c, ok ? 16 : 0);
      }
      if constexpr (TABLE) {
        const int j0 = jb0 - KEYS * i;
#pragma unroll
        for (int x = 0; x < 2 * CH / A_NT; ++x) {
          const int idx = tid + A_NT * x, part = idx / CH, r = (idx % CH) / (WD / 4);
          const int c = idx % (WD / 4), row = j0 + r;
          const bool ok = row >= 0 && row <= 2 * T - 2;
          cp_async16_to(st + part * (KB * A::BLK) + (c / 8) * A::BLK + swz(KEYS + r, c % 8),
                        (part ? p.rello : p.relhi) + (size_t)(ok ? row : 0) * WD + 4 * c,
                        ok ? 16 : 0);
        }
      }
    }
    cp_commit();
  };
  auto load_v = [&](int i) {     // tile i's v^T: WD channel rows of 32 keys
    if constexpr (FULL) {
      load_raw(i, 1);
      return;
    }
    if (i >= 0 && i < nt) {
      const uint32_t st = vss + (i % NS) * A::VS;
      constexpr int CH = WD * 8;
#pragma unroll
      for (int x = 0; x < 2 * CH / A_NT; ++x) {
        const int idx = tid + A_NT * x, part = idx / CH, ch = (idx % CH) / 8, c = idx % 8;
        cp_async16_to(st + part * A::VPART + swz(ch, c),
                      (part ? vtlo : vthi) + (size_t)ch * tp + KEYS * i + 4 * c, 16);
      }
    }
    cp_commit();
  };
  // the two streams' groups alternate: kr(-M), v(-M), kr(-M + 1), ...
  for (int i = -M; i < -M + NS - 1; ++i) {
    load_kr(i);
    load_v(i);
  }
  load_kr(-M + NS - 1);

  // q of the block's rows (zeros past nq and past d), split into its tiles
#pragma unroll 4
  for (int i = tid; i < A_ROWS * WD / 4; i += A_NT) {
    const int r = i / (WD / 4), c = i % (WD / 4), row = n0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < nq && 4 * c < d) v = *reinterpret_cast<const float4*>(q + (size_t)row * p.qsn + 4 * c);
    const uint32_t off = (c / 8) * (A_ROWS * 128) + swz(r, c % 8);
    st_split_v4(qhi + off, qlo + off, v);
  }

  const bool band0 = row0 >= cls && row0 < nq, band1 = row1 >= cls && row1 < nq;
  // the table row of key 0 for each of this thread's rows
  const int tr0 = band0 ? (row0 - cls) / S + T - 1 : 0;
  const int tr1 = band1 ? (row1 - cls) / S + T - 1 : 0;
  const float scale = p.scale;
  // SG: the scores (elements 0-15: keys 8 jj + 2 t + e % 2) and, with the
  // table, G (16-31: the step's table rows, the same columns)
  float SG[BN / 2], part[BN / 2], O[WD / 2], Ot[PN / 2];
  uint32_t ph[4][4], pl[4][4];
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, z0 = 0.f, z1 = 0.f, sc0 = 1.f, sc1 = 1.f;
#pragma unroll
  for (int i = 0; i < WD / 2; ++i) O[i] = 0.f;

  // acc = q b^T over 32-deep stage kb of the head dim, b the stage's BN-row
  // tile: 12 products (the small ones first) into one tensor-core sum
  auto stage = [&](int kb, float (&acc)[BN / 2], uint32_t st) {
    const uint32_t qa = kb * (A_ROWS * 128), bh_ = st + kb * A::BLK, bl_ = bh_ + KB * A::BLK;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaTf32SS<BN>::run(acc, tile_desc(qhi + qa + 32 * kk), tile_desc(bl_ + 32 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaTf32SS<BN>::run(acc, tile_desc(qlo + qa + 32 * kk), tile_desc(bh_ + 32 * kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaTf32SS<BN>::run(acc, tile_desc(qhi + qa + 32 * kk), tile_desc(bh_ + 32 * kk), 1);
  };
  // SG = q b^T over the head dim, each stage's sum folded in f32: stage 0
  // straight into SG and stage 1 into part in flight together, then one
  // stage at a time
  auto product = [&](uint32_t st) {
    fence_regs(SG);
    fence_regs(part);
    wgmma_fence();
    stage(0, SG, st);
    if constexpr (KB > 1) stage(1, part, st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(SG);
    fence_regs(part);
    if constexpr (KB > 1) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) SG[e] += part[e];
    }
#pragma unroll
    for (int kb = 2; kb < KB; ++kb) {
      fence_regs(part);
      wgmma_fence();
      stage(kb, part, st);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) SG[e] += part[e];
    }
  };

#pragma unroll 1
  for (int i = -M; i < nt; ++i) {
    cp_wait<2 * NS - 2>();       // this thread's copies of step i's keys and rows have landed
    fence_async_shared();
    __syncthreads();             // everyone's have; the previous tile's P.V is done
    load_v(i + NS - 1);
    if constexpr (FULL) {        // K8: tile i's k split into the k stage
      const uint32_t src = rws + (i % NS) * 2 * A::RAWT;
#pragma unroll
      for (int x = 0; x < KEYS * WD / 4 / A_NT; ++x) {
        const int idx = tid + A_NT * x, r = idx / (WD / 4), c = idx % (WD / 4);
        const uint32_t off = (c / 8) * A::BLK + swz(r, c % 8);
        st_split_v4(krs + off, krs + KB * A::BLK + off, ld_shared_v4(src + 16 * idx));
      }
      fence_async_shared();
      __syncthreads();
    }
    product(FULL ? krs : krs + ((i + M) % NS) * A::KR);
    if constexpr (TABLE) {       // G block -i into the ring (this warp's rows)
      const int jb = jb0 - KEYS * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Gs[(16 * warp + g + 8 * (e >> 1)) * LDG + ((jb + 8 * jj + 2 * t + (e & 1)) & (RING - 1))] =
              SG[16 + 4 * jj + e];
      __syncwarp();
    }
    if (i >= 0) {
      float (&Sc)[BN / 2] = SG;
      // element e of column block jj: row (e < 2 ? row0 : row1), key k0 + 8 jj + 2 t + e % 2
      const int k0 = KEYS * i;
      float tm0 = -CUDART_INF_F, tm1 = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * jj + 2 * t + (e & 1), hf = e >> 1;
          float s = FULL ? Sc[4 * jj + e] : Sc[4 * jj + e] * scale;   // K8's q comes scaled
          if (key >= T) {
            s = -CUDART_INF_F;
          } else if constexpr (FULL) {
            if (kbias) s += kbias[key];
          } else if (hf ? band1 : band0) {
            if constexpr (TABLE)
              s += Gs[(16 * warp + g + 8 * hf) * LDG + (((hf ? tr1 : tr0) - key) & (RING - 1))];
            else
              s += p.band[((size_t)bh * (nq - cls) + (hf ? row1 : row0) - cls) * T + key];
          }
          Sc[4 * jj + e] = s;
          if (hf) tm1 = fmaxf(tm1, s);
          else tm0 = fmaxf(tm0, s);
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, o));
        tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, o));
      }
      // key 0 is in every row's first tile: the maxima are finite from there on
      const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
      sc0 = expf(m0 - mn0);
      sc1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float pe = expf(Sc[e] - ((e & 2) ? m1 : m0));
        Sc[e] = pe;
        if (e & 2) s1 += pe;
        else s0 += pe;
      }
      z0 = z0 * sc0 + s0;
      z1 = z1 * sc1 + s1;
      // P as the register operand, each eight keys even ones first (as v^T stores them)
#pragma unroll
      for (int s8 = 0; s8 < 4; ++s8) {
        tf32_split(Sc[4 * s8], ph[s8][0], pl[s8][0]);
        tf32_split(Sc[4 * s8 + 2], ph[s8][1], pl[s8][1]);
        tf32_split(Sc[4 * s8 + 1], ph[s8][2], pl[s8][2]);
        tf32_split(Sc[4 * s8 + 3], ph[s8][3], pl[s8][3]);
      }
    }
    cp_wait<2 * NS - 2>();       // this thread's copies of tile i's v^T have landed
    fence_async_shared();
    __syncthreads();             // everyone's have; step i's scores and G are done
    if constexpr (FULL) {        // K8: tile i's v split and turned into the v^T stage
      const float* vr = reinterpret_cast<const float*>(
          smraw + (rws + (i % NS) * 2 * A::RAWT + A::RAWT - raw));
#pragma unroll
      for (int x = 0; x < WD * 8 / A_NT; ++x) {
        // channel ch, positions 4 c .. 4 c + 3: keys 8 (c / 2) + 2 j (+ 1 for odd c)
        const int idx = tid + A_NT * x, ch = idx % WD, c = idx / WD;
        const float* col = vr + (8 * (c / 2) + (c & 1)) * WD + ch;
        st_split_v4(vss + swz(ch, c), vss + A::VPART + swz(ch, c),
                    make_float4(col[0], col[2 * WD], col[4 * WD], col[6 * WD]));
      }
      fence_async_shared();
    }
    load_kr(i + NS);
    if constexpr (FULL) __syncthreads();
    if (i >= 0) {
      const uint32_t vt = FULL ? vss : vss + (i % NS) * A::VS;
#pragma unroll
      for (int half = 0; half < WD / PN; ++half) {
        const uint32_t vh = vt + half * PN * 128, vl = vh + A::VPART;
        fence_regs(Ot);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaTf32RS<PN>::run(Ot, ph[kk], tile_desc(vl + 32 * kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) WgmmaTf32RS<PN>::run(Ot, pl[kk], tile_desc(vh + 32 * kk), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) WgmmaTf32RS<PN>::run(Ot, ph[kk], tile_desc(vh + 32 * kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(Ot);
        // the context rescaled to the new maxima, the tile's P.V added in f32
#pragma unroll
        for (int e = 0; e < PN / 2; ++e)
          O[half * PN / 2 + e] = O[half * PN / 2 + e] * ((e & 2) ? sc1 : sc0) + Ot[e];
      }
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    z0 += __shfl_xor_sync(0xffffffffu, z0, o);
    z1 += __shfl_xor_sync(0xffffffffu, z1, o);
  }

  float* out = p.out + b * p.osb + h * p.osh;
  if constexpr (FULL) {          // K8: the context alone
#pragma unroll
    for (int jj = 0; jj < WD / 8; ++jj) {
      const int c = 8 * jj + 2 * t;
      if (c >= d) continue;
      if (row0 < nq)
        *reinterpret_cast<float2*>(out + (size_t)row0 * p.osn + c) =
            make_float2(O[4 * jj] / z0, O[4 * jj + 1] / z0);
      if (row1 < nq)
        *reinterpret_cast<float2*>(out + (size_t)row1 * p.osn + c) =
            make_float2(O[4 * jj + 2] / z1, O[4 * jj + 3] / z1);
    }
    return;
  }
  // the class key: its score from this thread's columns of q, summed over the quad
  const float* kc = p.kc + (size_t)bh * p.cstride;
  const float* vc = p.vc + (size_t)bh * p.cstride;
  const float* q0 = q + (size_t)min(row0, nq - 1) * p.qsn;
  const float* q1 = q + (size_t)min(row1, nq - 1) * p.qsn;
  float c0 = 0.f, c1 = 0.f;
#pragma unroll
  for (int jj = 0; jj < WD / 8; ++jj) {
    const int c = 8 * jj + 2 * t;
    if (c < d) {
      const float2 kk = *reinterpret_cast<const float2*>(kc + c);
      const float2 a = *reinterpret_cast<const float2*>(q0 + c);
      const float2 bb = *reinterpret_cast<const float2*>(q1 + c);
      c0 = fmaf(a.y, kk.y, fmaf(a.x, kk.x, c0));
      c1 = fmaf(bb.y, kk.y, fmaf(bb.x, kk.x, c1));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    c0 += __shfl_xor_sync(0xffffffffu, c0, o);
    c1 += __shfl_xor_sync(0xffffffffu, c1, o);
  }
  c0 *= scale;
  c1 *= scale;
  const float mc0 = fmaxf(m0, c0), mc1 = fmaxf(m1, c1);
  const float a0 = expf(m0 - mc0), a1 = expf(m1 - mc1);
  const float e0 = expf(c0 - mc0), e1 = expf(c1 - mc1);
  z0 = z0 * a0 + e0;
  z1 = z1 * a1 + e1;
#pragma unroll
  for (int jj = 0; jj < WD / 8; ++jj) {
    const int c = 8 * jj + 2 * t;
    if (c >= d) continue;
    const float2 vv = *reinterpret_cast<const float2*>(vc + c);
    if (row0 < nq) {
      float y0 = (O[4 * jj] * a0 + e0 * vv.x) / z0, y1 = (O[4 * jj + 1] * a0 + e0 * vv.y) / z0;
      if (row0 >= cls) {
        const float2 r = *reinterpret_cast<const float2*>(q0 + c);
        y0 += r.x;
        y1 += r.y;
      }
      *reinterpret_cast<float2*>(out + (size_t)row0 * p.osn + c) = make_float2(y0, y1);
    }
    if (row1 < nq) {
      float y0 = (O[4 * jj + 2] * a1 + e1 * vv.x) / z1, y1 = (O[4 * jj + 3] * a1 + e1 * vv.y) / z1;
      if (row1 >= cls) {
        const float2 r = *reinterpret_cast<const float2*>(q1 + c);
        y0 += r.x;
        y1 += r.y;
      }
      *reinterpret_cast<float2*>(out + (size_t)row1 * p.osn + c) = make_float2(y0, y1);
    }
  }
}

template <int WD, int MODE>
int launch_wd(const AttnF32& p, int B, cudaStream_t stream) {
  static int configured = 0;
  constexpr int bytes = Att<WD, MODE>::SMEM;
  if (int e = set_smem(attention_f32_kernel<WD, MODE>, bytes, configured)) return e;
  const long long rb = (p.nq + A_ROWS - 1) / A_ROWS, bhn = (long long)B * p.nh;
  if (MODE == M_FULL ? rb * bhn > 0x7fffffffLL : bhn > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid = MODE == M_FULL ? dim3((unsigned)(rb * bhn)) : dim3((unsigned)rb, (unsigned)bhn);
  attention_f32_kernel<WD, MODE><<<grid, A_NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// Every mode at head dims up to 128, each rounded up to a width of 32, 64,
// 96 or 128 (every operand zero past d, so the scores and the first d
// columns of the context are those of d; K8's raw k and v tiles are staged
// with zeros past d too).
template <int MODE>
int launch_mode(const AttnF32& p, int B, cudaStream_t stream) {
  switch (f32_head_width(p.d)) {
    case 32: return launch_wd<32, MODE>(p, B, stream);
    case 64: return launch_wd<64, MODE>(p, B, stream);
    case 96: return launch_wd<96, MODE>(p, B, stream);
    default: return launch_wd<128, MODE>(p, B, stream);
  }
}

// K3's operands split for the attention: the grid keys (B nh, T, wd), the
// grid values transposed (B nh, wd, tp) in f32_key_pos order, the table
// (2T - 1, wd) when there is one; zeros in every padding. k, v (B nh, T +
// 1, d) with the class token last.
__global__ void __launch_bounds__(256)
k3_split_kernel(const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ rel, float* khi, float* klo, float* vthi, float* vtlo,
                float* relhi, float* rello, int bhn, int T, int d) {
  const int wd = f32_head_width(d), tp = f32_keys_padded(T), w4 = wd / 4, nk = T + 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  auto split4 = [](float* hi, float* lo, size_t at, float4 x) {
    uint32_t h[4], l[4];
    tf32_split(x.x, h[0], l[0]);
    tf32_split(x.y, h[1], l[1]);
    tf32_split(x.z, h[2], l[2]);
    tf32_split(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  };
  const long long nkc = (long long)bhn * T * w4;
  for (long long i = first; i < nkc; i += stride) {
    const int c = (int)(i % w4);
    const long long row = i / w4, bh = row / T, key = row % T;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * c < d) x = *reinterpret_cast<const float4*>(k + ((size_t)bh * nk + key) * d + 4 * c);
    split4(khi, klo, (size_t)row * wd + 4 * c, x);
  }
  const long long nv = (long long)bhn * wd * tp;
  for (long long i = first; i < nv; i += stride) {
    const int pos = (int)(i % tp), ch = (int)((i / tp) % wd);
    const long long bh = i / ((long long)tp * wd);
    const int in8 = pos & 7, key = (pos & ~7) | (in8 < 4 ? 2 * in8 : 2 * (in8 - 4) + 1);
    const float x = (ch < d && key < T) ? v[((size_t)bh * nk + key) * d + ch] : 0.f;
    uint32_t hh, ll;
    tf32_split(x, hh, ll);
    vthi[i] = __uint_as_float(hh);
    vtlo[i] = __uint_as_float(ll);
  }
  if (rel) {
    const long long nr = (2LL * T - 1) * w4;
    for (long long i = first; i < nr; i += stride) {
      const int c = (int)(i % w4);
      const long long row = i / w4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * c < d) x = *reinterpret_cast<const float4*>(rel + (size_t)row * d + 4 * c);
      split4(relhi, rello, (size_t)row * wd + 4 * c, x);
    }
  }
}

}  // namespace

int launch_attention_f32(const AttnF32& p, int B, cudaStream_t stream) {
  if (B <= 0 || p.nh <= 0 || p.nq <= 0 || p.T <= 0 || p.S <= 0 || p.d <= 0 || p.d > 128 ||
      p.d % 4)
    return (int)cudaErrorInvalidValue;
  if (p.flags & KEY_BIAS) return launch_mode<M_FULL>(p, B, stream);
  return (p.flags & BAND_TABLE) ? launch_mode<M_TABLE>(p, B, stream)
                                : launch_mode<M_BAND>(p, B, stream);
}

long long k3_f32_scratch_bytes(int bhn, int T, int d, bool table) {
  const long long wd = f32_head_width(d), tp = f32_keys_padded(T);
  return 4LL * (2LL * bhn * T * wd + 2LL * bhn * wd * tp + (table ? 2 * (2LL * T - 1) * wd : 0));
}

int launch_k3_f32(AttnF32 p, const float* k, const float* v, const float* rel, void* scratch,
                  int B, cudaStream_t stream) {
  const int bhn = B * p.nh, T = p.T, d = p.d;
  const long long wd = f32_head_width(d), tp = f32_keys_padded(T);
  float* s = static_cast<float*>(scratch);
  float* khi = s;
  float* klo = khi + (size_t)bhn * T * wd;
  float* vthi = klo + (size_t)bhn * T * wd;
  float* vtlo = vthi + (size_t)bhn * wd * tp;
  float* relhi = vtlo + (size_t)bhn * wd * tp;
  float* rello = relhi + (2 * (size_t)T - 1) * wd;
  const bool table = p.flags & BAND_TABLE;
  const long long work = (long long)bhn * wd * tp;
  const int blocks = (int)((work + 255) / 256 < 132 * 16 ? (work + 255) / 256 : 132 * 16);
  k3_split_kernel<<<blocks, 256, 0, stream>>>(k, v, table ? rel : nullptr, khi, klo, vthi, vtlo,
                                              relhi, rello, bhn, T, d);
  if (int e = (int)cudaGetLastError()) return e;
  p.khi = khi; p.klo = klo; p.vthi = vthi; p.vtlo = vtlo;
  p.kc = k + (size_t)T * d;
  p.vc = v + (size_t)T * d;
  p.cstride = (long long)(T + 1) * d;
  p.relhi = table ? relhi : nullptr;
  p.rello = table ? rello : nullptr;
  return launch_attention_f32(p, B, stream);
}

int launch_k8_f32(AttnF32 p, int B, cudaStream_t stream) {
  p.flags = KEY_BIAS;
  p.S = 1;
  p.nq = p.T;
  p.scale = 1.f;
  return launch_attention_f32(p, B, stream);
}

}  // namespace avdd_mvit
