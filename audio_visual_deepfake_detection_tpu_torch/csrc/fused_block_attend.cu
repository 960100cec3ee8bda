// The attention step of the bfloat16 fused block kernel (K1 / K6) on the
// tensor cores, a launch of its own between the block's q | k | v launch and
// its tail (fused_block.cuh::launch_wgmma, p.attn == ATT_SCRATCH): dense
// attention at every T, and every band of half window w > MAX_W. It reads the rounded, scaled q and the k, v rows of the
// (B, T, 3C) scratch and writes each row's context over its q, which only
// the thread that read it reads; the tail copies the context into its tile.
//
// It computes what block_math (ops/kernels/fused_block.py, the JAX
// block_math's w <= 0 and banded branches) computes, per head:
// - scores: q . k summed in f32 and rounded once to bf16;
// - dense: invalid keys filled with rnd16(-1e30), f32 softmax, the
//   probabilities rounded to bf16 before P.V, masked keys' values zero;
// - banded: the -1e4 penalty on masked keys added in bf16, -1e30 outside
//   the band and the sequence, f32 softmax, p = rnd16(exp * (1 / den)), the
//   values as they are;
// - P.V summed in f32 and rounded once; invalid query rows zero.
// Where it differs from block_math, by f32 or bf16 rounding only (held by
// check_bf16 against it on the card): the denominator is summed online, one
// rescale each time a row's maximum moves; the exps are ex2.approx's (2 ulp
// of f32, below the bf16 rounding of p); the dense quotient is
// e * (1 / den), not e / den; the banded branch's JAX form rounds each
// product before the f32 sum and sums the context offset by offset in bf16,
// where wgmma sums exact products and the context in f32.
//
// What bounds it on this card: per (sample, head) 4 T^2 D multiply-adds of
// scores and P.V (6 T^2 D counted with the second pass's scores) against
// 4 T D values moved: T / 2 operations a byte, so from T ~ 600 on the tensor
// cores bound it, as long as the scores stay on chip (at T = 2304 they would
// be 21 MB a (sample, head) in f32).
//
// Design (K8's, csrc/full_attention.cu, with the block's numerics): a block
// of two warpgroups owns 128 query rows of one (sample, head), q held as the
// register A operand of wgmma m64n64k16 (f32 accumulate) for the whole
// kernel. Pass 1 walks the key tiles of 64 and keeps each row's running
// maximum and denominator (the exps of this thread's columns, rescaled when
// the maximum moves; the four threads of a row merge theirs at the end).
// Pass 2 recomputes each score tile, forms p in the accumulator registers
// and hands them to the P.V wgmma as its A operand (the accumulator layout
// of one product is the A layout of the next): the scores never leave
// registers and T has no cap. Key and value tiles stream through a ring of
// four 128B-swizzled shared stages filled by cp.async three tiles ahead, one
// __syncthreads a tile; the ragged last tile is zero-filled on load and
// masked in registers. A band visits only the key tiles that meet
// [r0 - w, r0 + 127 + w]. Each warp takes a tile's key mask from two ballots.
// Head width WD (32, 64, 96, 128) is a template parameter: a staged row is
// one or two 64-column halves, the P.V product max(64, WD) wide (head width
// 32 runs it over zero-filled value columns and drops them). The bf16
// scratch route (fused_block_bf16.cu) runs every window here, a head
// narrower than an instance on the next wider one with q, k and v zero past
// its width (PAD), a head past 128 on the wide kernel below.

#include "fused_block.cuh"

namespace avdd_k1 {
namespace {

constexpr int KT = 64;          // keys a staged tile
constexpr int AT_ROWS = 128;    // query rows a block: two warpgroups
constexpr int AT_NT = 256;
constexpr int NS = 4;           // ring stages

template <int WD> struct HeadDim {
  static constexpr int KS = WD / 16;                // k16 steps of q . k
  static constexpr int CH = WD / 8;                 // 16-byte chunks of a head's row
  static constexpr int PVN = WD < 64 ? 64 : WD;     // width of the P.V product
  static constexpr int LCH = PVN / 8;               // chunks a staged row holds
  static constexpr int TILE = (PVN + 63) / 64 * KT * 128;   // bytes of a staged tile
  // 96 and 128: q, the scores and the context take ~180 registers a thread
  static constexpr int BLOCKS_PER_SM = WD <= 64 ? 2 : 1;
};

constexpr int smem_bytes(int tile) { return 1024 + NS * tile; }

// PAD: the head's width D = p.D is below the instance's WD; q, k and v are
// staged as zeros past D, which change no score and no context column, and
// only the first D context columns are written.
template <int WD, bool BAND, bool PAD>
__global__ void __launch_bounds__(AT_NT, HeadDim<WD>::BLOCKS_PER_SM)
fused_block_attend_kernel(const __grid_constant__ ParamsW p) {
  using HD = HeadDim<WD>;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t ring = (smem_u32(smraw) + 1023u) & ~1023u;
  const int T_ = p.T, C = p.C, w = p.w;
  const int D = PAD ? p.D : WD;
  const int nrb = (T_ + AT_ROWS - 1) / AT_ROWS, H = C / D;
  // one grid axis, row blocks fastest: the blocks of a (sample, head) run
  // together and share its keys and values in L2
  const int bh = blockIdx.x / nrb, b = bh / H, h = bh % H, r0 = (blockIdx.x % nrb) * AT_ROWS;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = r0 + 64 * wg + 16 * warp + g, row1 = row0 + 8;
  const size_t ld = 3 * (size_t)C;
  __nv_bfloat16* qh = p.qkv + (size_t)b * T_ * ld + h * D;    // k at + C, v at + 2C
  const uint8_t* mrow = p.mask + (size_t)b * T_;
  const bool live0 = row0 < T_ && mrow[row0], live1 = row1 < T_ && mrow[row1];
  int lo = 0, hi = (T_ - 1) / KT;            // the key tiles visited
  if (BAND) {
    lo = max(r0 - w, 0) / KT;
    hi = min(r0 + AT_ROWS - 1 + w, T_ - 1) / KT;
  }
  const int nt = hi - lo + 1, ntot = 3 * nt;
  // step j: K tile lo + j (pass 1), then K, V of tile lo + (j - nt) / 2 in turn
  auto tile_of = [&](int j) { return lo + (j < nt ? j : (j - nt) / 2); };
  auto is_v = [&](int j) { return j >= nt && ((j - nt) & 1); };

  auto load_step = [&](int j) {
    if (j < ntot) {
      const int k0 = tile_of(j) * KT;
      const __nv_bfloat16* src = qh + (is_v(j) ? 2 : 1) * C;
      const uint32_t dst = ring + (j % NS) * HD::TILE;
#pragma unroll
      for (int i = 0; i < KT * HD::LCH / AT_NT; ++i) {
        const int idx = tid + AT_NT * i, r = idx / HD::LCH, c = idx % HD::LCH, key = k0 + r;
        const bool ok = key < T_ && c < (PAD ? D / 8 : HD::CH);   // past T or the head: zeros
        cp_async16_to(dst + (c / 8) * (KT * 128) + swz(r, c % 8),
                      ok ? src + (size_t)key * ld + 8 * c : src, ok ? 16 : 0);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) load_step(j);

  // q rows row0, row1 of this head (zeros past T): columns 16 kk + 2 t (+ 1,
  // + 8, + 9), the same elements this thread writes the context to
  uint32_t qa[HD::KS][4];
#pragma unroll
  for (int kk = 0; kk < HD::KS; ++kk) {
    const int c = 16 * kk + 2 * t;
    const bool in0 = !PAD || c < D, in8 = !PAD || c + 8 < D;
    qa[kk][0] = row0 < T_ && in0 ? ld_pair(qh + (size_t)row0 * ld + c) : 0u;
    qa[kk][1] = row1 < T_ && in0 ? ld_pair(qh + (size_t)row1 * ld + c) : 0u;
    qa[kk][2] = row0 < T_ && in8 ? ld_pair(qh + (size_t)row0 * ld + c + 8) : 0u;
    qa[kk][3] = row1 < T_ && in8 ? ld_pair(qh + (size_t)row1 * ld + c + 8) : 0u;
  }

  float S[32], O[HD::PVN / 2];
  uint32_t pa[4][4] = {};
  // this thread's running maximum and denominator of its columns of rows
  // row0 (m0, z0) and row1 (m1, z1); after pass 1 the row's, and 1 / den
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, z0 = 0.f, z1 = 0.f, inv0 = 0.f, inv1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) S[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD::PVN / 2; ++i) O[i] = 0.f;
  const float fill = rnd16(NEG_INF), pen = rnd16(-NEG_PENALTY);

  // the row's four threads merge their (m, z)
  auto merge = [&](float& m, float& z) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, o), zo = __shfl_xor_sync(0xffffffffu, z, o);
      const float mn = fmaxf(m, mo);
      z = (m == -CUDART_INF_F ? 0.f : z * __expf(m - mn)) +
          (mo == -CUDART_INF_F ? 0.f : zo * __expf(mo - mn));
      m = mn;
    }
  };

  for (int j = 0; j < ntot; ++j) {
    cp_wait<NS - 2>();          // this thread's copies of step j have landed
    fence_async_shared();
    __syncthreads();            // everyone's have, and step j - 1 is consumed
    load_step(j + NS - 1);      // into the stage step j - 1 left
    const uint32_t tile = ring + (j % NS) * HD::TILE;
    if (is_v(j)) {              // O += P V: V (key, c) a transposed B of PVN columns
      fence_regs(O);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRS<HD::PVN, 1>::run(O, pa[kk], tile_desc(tile + kk * 2048, KT * 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(O);
      continue;
    }
    const int k0 = tile_of(j) * KT;
    // key k0 + c is valid (inside the sequence, not masked): bit c % 32 of vlo / vhi
    const bool va = k0 + lane < T_ && mrow[k0 + lane];
    const bool vb = k0 + 32 + lane < T_ && mrow[k0 + 32 + lane];
    fence_regs(S);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD::KS; ++kk)
      WgmmaRS<64, 0>::run(S, qa[kk], tile_desc(tile + (kk / 4) * (KT * 128) + (kk % 4) * 32),
                          kk > 0);
    wgmma_commit();
    const uint32_t vlo = __ballot_sync(0xffffffffu, va), vhi = __ballot_sync(0xffffffffu, vb);
    wgmma_wait<0>();
    fence_regs(S);
    // scores as block_math forms them; element e of column block jj is
    // (row e < 2 ? row0 : row1, key k0 + 8 jj + 2 t + e % 2). A dense tile
    // of valid keys only (the warp's ballots agree) is rounded and no more.
    const bool full = !BAND && (vlo & vhi) == 0xffffffffu;
    if (full) {
#pragma unroll
      for (int i = 0; i < 32; ++i) S[i] = rnd16(S[i]);
    } else {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * jj + 2 * t + (e & 1), key = k0 + col;
          const bool valid = ((jj < 4 ? vlo >> col : vhi >> (col - 32)) & 1u) != 0;
          float s = rnd16(S[4 * jj + e]);
          if (BAND) {
            if (!valid) s = rnd16(s + pen);
            const int dk = key - (e < 2 ? row0 : row1);
            if (key >= T_ || dk < -w || dk > w) s = NEG_INF;
          } else if (!valid) {
            s = key < T_ ? fill : -CUDART_INF_F;    // a key past T is none
          }
          S[4 * jj + e] = s;
        }
      }
    }
    if (j < nt) {               // pass 1: maxima and denominators
      float tm0 = -CUDART_INF_F, tm1 = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        tm0 = fmaxf(tm0, fmaxf(S[4 * jj], S[4 * jj + 1]));
        tm1 = fmaxf(tm1, fmaxf(S[4 * jj + 2], S[4 * jj + 3]));
      }
      // the maxima move to mn: z rescaled, the tile's exps added; a maximum
      // still -inf (none of this thread's keys so far) leaves z at 0
      const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s0 += __expf(S[4 * jj] - mn0) + __expf(S[4 * jj + 1] - mn0);
        s1 += __expf(S[4 * jj + 2] - mn1) + __expf(S[4 * jj + 3] - mn1);
      }
      if (mn0 != -CUDART_INF_F) {
        z0 = z0 * __expf(m0 - mn0) + s0;
        m0 = mn0;
      }
      if (mn1 != -CUDART_INF_F) {
        z1 = z1 * __expf(m1 - mn1) + s1;
        m1 = mn1;
      }
      if (j == nt - 1) {
        merge(m0, z0);
        merge(m1, z1);
        inv0 = 1.f / z0;
        inv1 = 1.f / z1;
      }
      continue;
    }
    // pass 2: p rounded to bf16 into the A operand of P.V (dense: masked
    // keys' values are zero, so their p is)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * jj + 2 * t + (e & 1);
        const bool valid = ((jj < 4 ? vlo >> col : vhi >> (col - 32)) & 1u) != 0;
        pr[e] = __expf(S[4 * jj + e] - (e < 2 ? m0 : m1)) * (e < 2 ? inv0 : inv1);
        if (!BAND && !full && !valid) pr[e] = 0.f;
      }
      pa[jj / 2][2 * (jj % 2)] = pack_bf16(pr[0], pr[1]);
      pa[jj / 2][2 * (jj % 2) + 1] = pack_bf16(pr[2], pr[3]);
    }
  }
  cp_wait<0>();
  // the context over q (rows past T stay as they are; invalid rows zero)
#pragma unroll
  for (int jj = 0; jj < HD::PVN / 8; ++jj) {
    const int c = 8 * jj + 2 * t;
    if (8 * jj >= D) break;
    if (row0 < T_)
      *reinterpret_cast<uint32_t*>(qh + (size_t)row0 * ld + c) =
          live0 ? pack_bf16(O[4 * jj], O[4 * jj + 1]) : 0u;
    if (row1 < T_)
      *reinterpret_cast<uint32_t*>(qh + (size_t)row1 * ld + c) =
          live1 ? pack_bf16(O[4 * jj + 2], O[4 * jj + 3]) : 0u;
  }
}


// ---- head widths past 128 (the bf16 scratch route) -------------------------------
// A block of two warpgroups owns 128 query rows of one (sample, head) and 128
// of its context columns (a head's last block the rest, zero columns past
// D): the blocks of a row block each recompute the scores for their own
// columns. q is staged once into shared memory (D / 64 blocks of 128
// swizzled rows, at most 128 KB: as registers it would be D / 4 a thread)
// and is the A operand of m64n64k16 from there; k streams with each key tile
// in 128-channel chunks, v in the block's 128 columns, through a ring of
// four 16 KB stages. The steps: pass 1 a key tile's chunks, pass 2 its
// chunks and then its values; the numerics are fused_block_attend_kernel's.
// Every block of a head reads all of q, so the context goes to a3, not over
// q.
constexpr int WQ_BLOCK = AT_ROWS * 128;   // 64 channels of q: 128 rows of 128 bytes
constexpr int WSTAGE = KT * 256;          // 128 channels of k (or columns of v) of 64 keys
constexpr int WNS = 4;

inline int wide_smem(int d) { return 1024 + (d + 63) / 64 * WQ_BLOCK + WNS * WSTAGE; }

template <bool BAND>
__global__ void __launch_bounds__(AT_NT, 1)
fused_block_attend_wide_kernel(const __grid_constant__ ParamsB p) {
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t qs = (smem_u32(smraw) + 1023u) & ~1023u;
  const int T_ = p.T, C = p.C, w = p.w, D = p.D;
  const int nqb = (D + 63) / 64, nk = (D + 127) / 128;   // q blocks; k chunks = column blocks
  const uint32_t ring = qs + nqb * WQ_BLOCK;
  const int nrb = (T_ + AT_ROWS - 1) / AT_ROWS, H = C / D;
  // one grid axis, row blocks fastest, then column blocks: the blocks of a
  // (sample, head) run together and share its q, k and v in L2
  const int rest = blockIdx.x / nrb, cb = rest % nk, bh = rest / nk;
  const int b = bh / H, h = bh % H, r0 = (blockIdx.x % nrb) * AT_ROWS, c0 = cb * 128;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = r0 + 64 * wg + 16 * warp + g, row1 = row0 + 8;
  const size_t ld = 3 * (size_t)C;
  const __nv_bfloat16* qh = p.qkv + (size_t)b * T_ * ld + h * D;   // k at + C, v at + 2C
  const uint8_t* mrow = p.mask + (size_t)b * T_;
  const bool live0 = row0 < T_ && mrow[row0], live1 = row1 < T_ && mrow[row1];
  int lo = 0, hi = (T_ - 1) / KT;
  if (BAND) {
    lo = max(r0 - w, 0) / KT;
    hi = min(r0 + AT_ROWS - 1 + w, T_ - 1) / KT;
  }
  const int nt = hi - lo + 1, n1 = nt * nk, ntot = n1 + nt * (nk + 1);
  // step j: pass 1 chunk j % nk of tile lo + j / nk; pass 2 (i = j - n1)
  // chunk i % (nk + 1) of tile lo + i / (nk + 1), its values at nk
  auto tile_of = [&](int j) { return lo + (j < n1 ? j / nk : (j - n1) / (nk + 1)); };
  auto sub_of = [&](int j) { return j < n1 ? j % nk : (j - n1) % (nk + 1); };

  auto load_step = [&](int j) {
    if (j < ntot) {
      const int k0 = tile_of(j) * KT, sub = sub_of(j);
      const bool v = sub == nk;
      const int col0 = v ? c0 : 128 * sub;          // the head's columns staged
      const __nv_bfloat16* src = qh + (v ? 2 : 1) * C + col0;
      const uint32_t dst = ring + (j % WNS) * WSTAGE;
#pragma unroll
      for (int i = 0; i < KT * 16 / AT_NT; ++i) {
        const int idx = tid + AT_NT * i, r = idx / 16, c = idx % 16, key = k0 + r;
        const bool ok = key < T_ && col0 + 8 * c < D;
        cp_async16_to(dst + (c / 8) * (KT * 128) + swz(r, c % 8),
                      ok ? src + (size_t)key * ld + 8 * c : src, ok ? 16 : 0);
      }
    }
    cp_commit();
  };
  // q of the block's rows (zeros past T and D): its own group, first
  for (int i = tid; i < AT_ROWS * nqb * 8; i += AT_NT) {
    const int r = i / (nqb * 8), c = i % (nqb * 8), row = r0 + r;
    const bool ok = row < T_ && 8 * c < D;
    cp_async16_to(qs + (c / 8) * WQ_BLOCK + swz(r, c % 8),
                  ok ? qh + (size_t)row * ld + 8 * c : qh, ok ? 16 : 0);
  }
  cp_commit();
#pragma unroll
  for (int j = 0; j < WNS - 1; ++j) load_step(j);

  float S[32], O[64];
  uint32_t pa[4][4] = {};
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, z0 = 0.f, z1 = 0.f, inv0 = 0.f, inv1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) S[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) O[i] = 0.f;
  const float fill = rnd16(NEG_INF), pen = rnd16(-NEG_PENALTY);
  const uint32_t qw = qs + wg * (64 * 128);        // this warpgroup's 64 rows of each q block

  auto merge = [&](float& m, float& z) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, o), zo = __shfl_xor_sync(0xffffffffu, z, o);
      const float mn = fmaxf(m, mo);
      z = (m == -CUDART_INF_F ? 0.f : z * __expf(m - mn)) +
          (mo == -CUDART_INF_F ? 0.f : zo * __expf(mo - mn));
      m = mn;
    }
  };

#pragma unroll 1
  for (int j = 0; j < ntot; ++j) {
    cp_wait<WNS - 2>();
    fence_async_shared();
    __syncthreads();
    load_step(j + WNS - 1);
    const uint32_t tile = ring + (j % WNS) * WSTAGE;
    const int sub = sub_of(j);
    if (sub == nk) {              // O += P V over the block's 128 columns
      fence_regs(O);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRS<128, 1>::run(O, pa[kk], tile_desc(tile + kk * 2048, KT * 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(O);
      continue;
    }
    // this chunk's share of the scores: 128 channels (fewer in the last)
    fence_regs(S);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int ch = 128 * sub + 16 * kk;
      if (ch >= D) break;
      WgmmaSS<64>::run(S, tile_desc(qw + (ch / 64) * WQ_BLOCK + (kk % 4) * 32),
                       tile_desc(tile + (kk / 4) * (KT * 128) + (kk % 4) * 32), ch > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(S);
    if (sub < nk - 1) continue;
    const int k0 = tile_of(j) * KT;
    const bool va = k0 + lane < T_ && mrow[k0 + lane];
    const bool vb = k0 + 32 + lane < T_ && mrow[k0 + 32 + lane];
    const uint32_t vlo = __ballot_sync(0xffffffffu, va), vhi = __ballot_sync(0xffffffffu, vb);
    const bool full = !BAND && (vlo & vhi) == 0xffffffffu;
    if (full) {
#pragma unroll
      for (int i = 0; i < 32; ++i) S[i] = rnd16(S[i]);
    } else {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * jj + 2 * t + (e & 1), key = k0 + col;
          const bool valid = ((jj < 4 ? vlo >> col : vhi >> (col - 32)) & 1u) != 0;
          float s = rnd16(S[4 * jj + e]);
          if (BAND) {
            if (!valid) s = rnd16(s + pen);
            const int dk = key - (e < 2 ? row0 : row1);
            if (key >= T_ || dk < -w || dk > w) s = NEG_INF;
          } else if (!valid) {
            s = key < T_ ? fill : -CUDART_INF_F;
          }
          S[4 * jj + e] = s;
        }
      }
    }
    if (j < n1) {                 // pass 1: maxima and denominators
      float tm0 = -CUDART_INF_F, tm1 = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        tm0 = fmaxf(tm0, fmaxf(S[4 * jj], S[4 * jj + 1]));
        tm1 = fmaxf(tm1, fmaxf(S[4 * jj + 2], S[4 * jj + 3]));
      }
      const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s0 += __expf(S[4 * jj] - mn0) + __expf(S[4 * jj + 1] - mn0);
        s1 += __expf(S[4 * jj + 2] - mn1) + __expf(S[4 * jj + 3] - mn1);
      }
      if (mn0 != -CUDART_INF_F) {
        z0 = z0 * __expf(m0 - mn0) + s0;
        m0 = mn0;
      }
      if (mn1 != -CUDART_INF_F) {
        z1 = z1 * __expf(m1 - mn1) + s1;
        m1 = mn1;
      }
      if (j == n1 - 1) {
        merge(m0, z0);
        merge(m1, z1);
        inv0 = 1.f / z0;
        inv1 = 1.f / z1;
      }
      continue;
    }
    // pass 2: p rounded to bf16 into the A operand of P.V
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * jj + 2 * t + (e & 1);
        const bool valid = ((jj < 4 ? vlo >> col : vhi >> (col - 32)) & 1u) != 0;
        pr[e] = __expf(S[4 * jj + e] - (e < 2 ? m0 : m1)) * (e < 2 ? inv0 : inv1);
        if (!BAND && !full && !valid) pr[e] = 0.f;
      }
      pa[jj / 2][2 * (jj % 2)] = pack_bf16(pr[0], pr[1]);
      pa[jj / 2][2 * (jj % 2) + 1] = pack_bf16(pr[2], pr[3]);
    }
  }
  cp_wait<0>();
  // the context into a3 (R, C) (invalid rows zero)
  __nv_bfloat16* out = p.a3 + (size_t)b * T_ * C + h * D + c0;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int c = 8 * jj + 2 * t;
    if (c0 + 8 * jj >= D) break;
    if (row0 < T_)
      *reinterpret_cast<uint32_t*>(out + (size_t)row0 * C + c) =
          live0 ? pack_bf16(O[4 * jj], O[4 * jj + 1]) : 0u;
    if (row1 < T_)
      *reinterpret_cast<uint32_t*>(out + (size_t)row1 * C + c) =
          live1 ? pack_bf16(O[4 * jj + 2], O[4 * jj + 3]) : 0u;
  }
}

template <int WD, bool BAND, bool PAD>
int launch_wd(const ParamsW& p, cudaStream_t stream) {
  static int configured = 0;
  constexpr int bytes = smem_bytes(HeadDim<WD>::TILE);
  if (int e = set_smem(fused_block_attend_kernel<WD, BAND, PAD>, bytes, configured)) return e;
  const long long b = p.tiles / ((p.T + WG_ROWS - 1) / WG_ROWS);
  const long long blocks = b * (p.C / p.D) * ((p.T + AT_ROWS - 1) / AT_ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_block_attend_kernel<WD, BAND, PAD><<<(unsigned)blocks, AT_NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// Head widths 32 / 64 / 96 / 128 run their instance, narrower ones the next
// wider instance padded with zeros (the scratch route only).
template <bool BAND>
int launch_band(const ParamsW& p, cudaStream_t stream) {
  switch (p.D) {
    case 32: return launch_wd<32, BAND, false>(p, stream);
    case 64: return launch_wd<64, BAND, false>(p, stream);
    case 96: return launch_wd<96, BAND, false>(p, stream);
    case 128: return launch_wd<128, BAND, false>(p, stream);
    default: break;
  }
  if (p.D < 32) return launch_wd<32, BAND, true>(p, stream);
  if (p.D < 64) return launch_wd<64, BAND, true>(p, stream);
  if (p.D < 96) return launch_wd<96, BAND, true>(p, stream);
  if (p.D < 128) return launch_wd<128, BAND, true>(p, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool BAND>
int launch_wide(const ParamsB& p, cudaStream_t stream) {
  static int configured = 0;
  const int bytes = wide_smem(p.D);
  if (int e = set_smem(fused_block_attend_wide_kernel<BAND>, bytes, configured)) return e;
  const long long blocks = (long long)p.B * (p.C / p.D) * ((p.D + 127) / 128) *
                           ((p.T + AT_ROWS - 1) / AT_ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_block_attend_wide_kernel<BAND><<<(unsigned)blocks, AT_NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_attend(const ParamsW& p, cudaStream_t stream) {
  return p.w > 0 ? launch_band<true>(p, stream) : launch_band<false>(p, stream);
}

int launch_attend_scratch(const ParamsB& pb, cudaStream_t stream) {
  if (ctx_in_a3(pb.D))
    return pb.w > 0 ? launch_wide<true>(pb, stream) : launch_wide<false>(pb, stream);
  ParamsW p{};
  p.qkv = pb.qkv;
  p.mask = pb.mask;
  p.T = pb.T;
  p.w = pb.w;
  p.C = pb.C;
  p.D = pb.D;
  p.tiles = pb.B * ((pb.T + WG_ROWS - 1) / WG_ROWS);
  return launch_attend(p, stream);
}

}  // namespace avdd_k1
