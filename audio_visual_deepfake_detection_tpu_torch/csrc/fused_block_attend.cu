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
// 32 runs it over zero-filled value columns and drops them).

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

template <int WD, bool BAND>
__global__ void __launch_bounds__(AT_NT, HeadDim<WD>::BLOCKS_PER_SM)
fused_block_attend_kernel(const __grid_constant__ ParamsW p) {
  using HD = HeadDim<WD>;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t ring = (smem_u32(smraw) + 1023u) & ~1023u;
  const int T_ = p.T, C = p.C, w = p.w;
  const int nrb = (T_ + AT_ROWS - 1) / AT_ROWS, H = C / WD;
  // one grid axis, row blocks fastest: the blocks of a (sample, head) run
  // together and share its keys and values in L2
  const int bh = blockIdx.x / nrb, b = bh / H, h = bh % H, r0 = (blockIdx.x % nrb) * AT_ROWS;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = r0 + 64 * wg + 16 * warp + g, row1 = row0 + 8;
  const size_t ld = 3 * (size_t)C;
  __nv_bfloat16* qh = p.qkv + (size_t)b * T_ * ld + h * WD;   // k at + C, v at + 2C
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
        const bool ok = key < T_ && c < HD::CH;   // past T or the head width: zeros
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
    qa[kk][0] = row0 < T_ ? ld_pair(qh + (size_t)row0 * ld + c) : 0u;
    qa[kk][1] = row1 < T_ ? ld_pair(qh + (size_t)row1 * ld + c) : 0u;
    qa[kk][2] = row0 < T_ ? ld_pair(qh + (size_t)row0 * ld + c + 8) : 0u;
    qa[kk][3] = row1 < T_ ? ld_pair(qh + (size_t)row1 * ld + c + 8) : 0u;
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
    if (8 * jj >= WD) break;
    if (row0 < T_)
      *reinterpret_cast<uint32_t*>(qh + (size_t)row0 * ld + c) =
          live0 ? pack_bf16(O[4 * jj], O[4 * jj + 1]) : 0u;
    if (row1 < T_)
      *reinterpret_cast<uint32_t*>(qh + (size_t)row1 * ld + c) =
          live1 ? pack_bf16(O[4 * jj + 2], O[4 * jj + 3]) : 0u;
  }
}

template <int WD, bool BAND>
int launch_wd(const ParamsW& p, cudaStream_t stream) {
  static int configured = 0;
  constexpr int bytes = smem_bytes(HeadDim<WD>::TILE);
  if (int e = set_smem(fused_block_attend_kernel<WD, BAND>, bytes, configured)) return e;
  const long long b = p.tiles / ((p.T + WG_ROWS - 1) / WG_ROWS);
  const long long blocks = b * (p.C / WD) * ((p.T + AT_ROWS - 1) / AT_ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_block_attend_kernel<WD, BAND><<<(unsigned)blocks, AT_NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool BAND>
int launch_band(const ParamsW& p, cudaStream_t stream) {
  switch (p.D) {
    case 32: return launch_wd<32, BAND>(p, stream);
    case 64: return launch_wd<64, BAND>(p, stream);
    case 96: return launch_wd<96, BAND>(p, stream);
    case 128: return launch_wd<128, BAND>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

int launch_attend(const ParamsW& p, cudaStream_t stream) {
  return p.w > 0 ? launch_band<true>(p, stream) : launch_band<false>(p, stream);
}

}  // namespace avdd_k1
