// The attention launch of the float32 fused block (K1 / K6 in f32,
// fused_block_f32.cu's fourth launch): dense attention and every band, on
// the tensor cores in 3xTF32. It reads q (scaled, as it is), k split (R, C)
// and v split and transposed (B, C, Tp) from the scratch, and writes the
// context split (R, C) for the proj GEMM.
//
// It computes what block_math's attention_ctx computes in f32, per head:
// scores q . k summed in f32; dense: invalid keys filled with -1e30, f32
// softmax, masked keys' values zero; banded: the -1e4 penalty added to
// masked keys, -1e30 outside the band and the sequence, f32 softmax, the
// values as they are; invalid query rows zero. Where it differs, by f32
// rounding only: the products are 3xTF32 (hi.hi + hi.lo + lo.hi, summed by
// the tensor cores over 32 keys or 32 channels, those parts added in f32:
// their own accumulation truncates), the softmax is online (a row's maximum
// and denominator kept over the key tiles, the context rescaled when the
// maximum moves), and the context is divided by the denominator once at the
// end.
//
// What bounds it: per (sample, head) 4 T^2 D operations dense (4 T (2w + 1)
// D banded), three times over on the tensor cores, against 4 T D values
// moved. A (64 query rows, 32 keys) tile costs 3 x (D / 8) score products
// and 3 x 4 P.V ones, m64n32k8 / m64nDk8, beside 16 exps a thread.
//
// Design: a block of one warpgroup owns 64 query rows of one (sample,
// head). Its q is split once into two swizzled tiles (64 rows, D / 32
// blocks of 128-byte rows); the key tiles of 32 stream through a ring of
// stages (k hi, k lo: 32 key rows; v^T hi, v^T lo: D channel rows of 32
// keys) filled by cp.async ahead, k rows past T zero-filled. Per key tile:
// S = q . k^T (m64n32, both operands in shared memory); the masks from one
// ballot; the row maxima over the row's four threads; p = exp(s - max); the
// denominator and the context rescaled; p split into a 64 x 32 tile in
// shared memory; O = O x rescale + P . V (m64nD, B the v^T tile). tf32
// products take both operands K-major, hence v transposed by the qkv GEMM's
// epilogue. A band
// visits only the key tiles that meet [r0 - w, r0 + 63 + w].

#include "fused_block.cuh"

namespace avdd_k1 {
namespace {

constexpr int FA_ROWS = 64;     // query rows a block: one warpgroup
constexpr int FA_NT = 128;

template <int WD> struct F32Head {
  static constexpr int KB = WD / 32;                   // 32-channel blocks of q . k
  static constexpr int QPART = FA_ROWS * WD * 4;       // q hi (or lo): D / 32 blocks of 64 rows
  static constexpr int KPART = KEY_TILE * WD * 4;      // k hi (or lo): D / 32 blocks of 32 rows
  static constexpr int VPART = WD * KEY_TILE * 4;      // v^T hi (or lo): D rows of 128 bytes
  static constexpr int PPART = FA_ROWS * KEY_TILE * 4; // p hi (or lo): 64 rows of 128 bytes
  static constexpr int STAGE = 2 * KPART + 2 * VPART;
  static constexpr int NS = (WD == 64 || WD == 128) ? 2 : 3;   // ring stages
  static constexpr int SMEM = 1024 + 2 * QPART + 2 * PPART + NS * STAGE;
  static constexpr int BLOCKS_PER_SM = WD <= 64 ? 2 : 1;
};

__device__ __forceinline__ void st_shared8(uint32_t a, uint32_t x, uint32_t y) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" :: "r"(a), "r"(x), "r"(y) : "memory");
}

template <int WD, bool BAND>
__global__ void __launch_bounds__(FA_NT, F32Head<WD>::BLOCKS_PER_SM)
f32_attend_kernel(const __grid_constant__ ParamsF p) {
  using HD = F32Head<WD>;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t qhi = (smem_u32(smraw) + 1023u) & ~1023u, qlo = qhi + HD::QPART;
  const uint32_t phi = qlo + HD::QPART, plo = phi + HD::PPART, ring = plo + HD::PPART;
  const int T_ = p.T, C = p.C, w = p.w;
  const int nrb = (T_ + FA_ROWS - 1) / FA_ROWS, H = C / WD;
  // one grid axis, row blocks fastest: the blocks of a (sample, head) run
  // together and share its keys and values in L2
  const int bh = blockIdx.x / nrb, b = bh / H, h = bh % H, r0 = (blockIdx.x % nrb) * FA_ROWS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = r0 + 16 * warp + g, row1 = row0 + 8;
  const size_t rb = (size_t)b * T_;          // the sample's first row in (R, .)
  const uint8_t* mrow = p.mask + rb;
  int lo_t = 0, hi_t = (T_ - 1) / KEY_TILE;  // the key tiles visited
  if (BAND) {
    lo_t = max(r0 - w, 0) / KEY_TILE;
    hi_t = min(r0 + FA_ROWS - 1 + w, T_ - 1) / KEY_TILE;
  }
  const int nt = hi_t - lo_t + 1;

  auto load_tile = [&](int j) {
    if (j < nt) {
      const int k0 = (lo_t + j) * KEY_TILE;
      const uint32_t st = ring + (j % HD::NS) * HD::STAGE;
      constexpr int KCH = KEY_TILE * WD / 4;           // 16-byte chunks of a k part
#pragma unroll
      for (int i = 0; i < 2 * KCH / FA_NT; ++i) {      // k hi, k lo: (key r, chunk c)
        const int idx = tid + FA_NT * i, part = idx / KCH, r = (idx % KCH) / (WD / 4),
                  c = idx % (WD / 4), key = k0 + r;
        const bool ok = key < T_;
        const float* src = (part ? p.klo : p.khi) + (rb + (ok ? key : 0)) * C + h * WD + 4 * c;
        cp_async16_to(st + part * HD::KPART + (c / 8) * (KEY_TILE * 128) + swz(r, c % 8), src,
                      ok ? 16 : 0);
      }
      constexpr int VCH = WD * KEY_TILE / 4;           // 16-byte chunks of a v^T part
#pragma unroll
      for (int i = 0; i < 2 * VCH / FA_NT; ++i) {      // v^T hi, lo: (channel ch, chunk c)
        const int idx = tid + FA_NT * i, part = idx / VCH, ch = (idx % VCH) / 8, c = idx % 8;
        const float* src = (part ? p.vtlo : p.vthi) + ((size_t)b * C + h * WD + ch) * p.Tp + k0 +
                           4 * c;
        cp_async16_to(st + 2 * HD::KPART + part * HD::VPART + swz(ch, c), src, 16);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < HD::NS - 1; ++j) load_tile(j);

  // q of the block's rows (zeros past T), split into its two tiles
#pragma unroll 4
  for (int i = tid; i < FA_ROWS * WD / 4; i += FA_NT) {
    const int r = i / (WD / 4), c = i % (WD / 4), row = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < T_) v = *reinterpret_cast<const float4*>(p.q + (rb + row) * C + h * WD + 4 * c);
    const float vv[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) tf32_split(vv[k], hi[k], lo[k]);
    const uint32_t off = (c / 8) * (FA_ROWS * 128) + swz(r, c % 8);
    st_shared16(qhi + off, hi);
    st_shared16(qlo + off, lo);
  }

  float S[16], St[16], O[WD / 2], Ot[WD / 2];
#pragma unroll
  for (int i = 0; i < WD / 2; ++i) O[i] = 0.f;
  // the running maximum and this thread's share of the denominator of rows
  // row0 (m0, z0) and row1 (m1, z1)
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, z0 = 0.f, z1 = 0.f;

#pragma unroll 1
  for (int j = 0; j < nt; ++j) {
    cp_wait<HD::NS - 2>();       // this thread's copies of tile j have landed
    fence_async_shared();
    __syncthreads();             // everyone's have; tile j - 1's stage and p are free
    load_tile(j + HD::NS - 1);
    const uint32_t st = ring + (j % HD::NS) * HD::STAGE;
    const uint32_t khi = st, klo = st + HD::KPART, vhi = st + 2 * HD::KPART,
                   vlo = vhi + HD::VPART;
    const int k0 = (lo_t + j) * KEY_TILE;
    // bit c: key k0 + c is valid (inside the sequence, not masked)
    const uint32_t vbits = __ballot_sync(0xffffffffu, k0 + lane < T_ && mrow[k0 + lane]);
    // S summed per 32 channels of the head (12 products into St), the
    // parts added in f32 (the tensor cores' accumulation truncates)
#pragma unroll
    for (int kb = 0; kb < HD::KB; ++kb) {
      fence_regs(St);
      wgmma_fence();
      const uint32_t qb = kb * (FA_ROWS * 128), kbo = kb * (KEY_TILE * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // the small products first (as the GEMM's)
        WgmmaTf32SS<32>::run(St, tile_desc(qhi + qb + 32 * kk), tile_desc(klo + kbo + 32 * kk),
                             kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32SS<32>::run(St, tile_desc(qlo + qb + 32 * kk), tile_desc(khi + kbo + 32 * kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32SS<32>::run(St, tile_desc(qhi + qb + 32 * kk), tile_desc(khi + kbo + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(St);
#pragma unroll
      for (int i = 0; i < 16; ++i) S[i] = kb ? S[i] + St[i] : St[i];
    }
    // element e of column block jj: row (e < 2 ? row0 : row1), key
    // k0 + 8 jj + 2 t + e % 2
    float tm0 = -CUDART_INF_F, tm1 = -CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * jj + 2 * t + (e & 1), key = k0 + col;
        const bool valid = (vbits >> col) & 1u;
        float s = S[4 * jj + e];
        if (BAND) {
          if (!valid) s += -NEG_PENALTY;
          const int dk = key - (e < 2 ? row0 : row1);
          if (key >= T_ || dk < -w || dk > w) s = -CUDART_INF_F;
        } else if (!valid) {
          s = key < T_ ? NEG_INF : -CUDART_INF_F;   // a key past T is none
        }
        S[4 * jj + e] = s;
        if (e < 2) tm0 = fmaxf(tm0, s);
        else tm1 = fmaxf(tm1, s);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, o));
      tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, o));
    }
    // the maxima move to mn; a maximum still -inf (no key yet) exps against 0
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    const float mu0 = mn0 == -CUDART_INF_F ? 0.f : mn0, mu1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float sc0 = expf(m0 - mu0), sc1 = expf(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * jj + 2 * t + (e & 1);
        pr[e] = expf(S[4 * jj + e] - (e < 2 ? mu0 : mu1));
        if (e < 2) s0 += pr[e];
        else s1 += pr[e];
        // dense: a masked key counts in the denominator, its value is zero
        if (!BAND && !((vbits >> col) & 1u)) pr[e] = 0.f;
      }
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(pr[e], h[e], l[e]);
      const int col = 8 * jj + 2 * t, ra = 16 * warp + g;
      const uint32_t a0 = swz(ra, col / 4) + 4 * (col % 4), a1 = swz(ra + 8, col / 4) + 4 * (col % 4);
      st_shared8(phi + a0, h[0], h[1]);
      st_shared8(plo + a0, l[0], l[1]);
      st_shared8(phi + a1, h[2], h[3]);
      st_shared8(plo + a1, l[2], l[3]);
    }
    z0 = z0 * sc0 + s0;
    z1 = z1 * sc1 + s1;
    fence_async_shared();
    __syncthreads();             // p is whole before the tensor cores read it
    fence_regs(Ot);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaTf32SS<WD>::run(Ot, tile_desc(phi + 32 * kk), tile_desc(vlo + 32 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaTf32SS<WD>::run(Ot, tile_desc(plo + 32 * kk), tile_desc(vhi + 32 * kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaTf32SS<WD>::run(Ot, tile_desc(phi + 32 * kk), tile_desc(vhi + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(Ot);
    // the context rescaled to the new maxima, the tile's P.V added in f32
#pragma unroll
    for (int i = 0; i < WD / 2; ++i) O[i] = O[i] * ((i & 2) ? sc1 : sc0) + Ot[i];
  }
  cp_wait<0>();
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    z0 += __shfl_xor_sync(0xffffffffu, z0, o);
    z1 += __shfl_xor_sync(0xffffffffu, z1, o);
  }
  // the context, split (invalid query rows zero)
  const bool live0 = row0 < T_ && mrow[row0], live1 = row1 < T_ && mrow[row1];
#pragma unroll
  for (int jj = 0; jj < WD / 8; ++jj) {
    const size_t c = (size_t)h * WD + 8 * jj + 2 * t;
    if (row0 < T_)
      store_split2(p.chi, p.clo, (rb + row0) * C + c, live0 ? O[4 * jj] / z0 : 0.f,
                   live0 ? O[4 * jj + 1] / z0 : 0.f);
    if (row1 < T_)
      store_split2(p.chi, p.clo, (rb + row1) * C + c, live1 ? O[4 * jj + 2] / z1 : 0.f,
                   live1 ? O[4 * jj + 3] / z1 : 0.f);
  }
}

template <int WD, bool BAND>
int launch_wd(const ParamsF& p, cudaStream_t stream) {
  static int configured = 0;
  constexpr int bytes = F32Head<WD>::SMEM;
  if (int e = set_smem(f32_attend_kernel<WD, BAND>, bytes, configured)) return e;
  const long long blocks = (long long)p.B * (p.C / WD) * ((p.T + FA_ROWS - 1) / FA_ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  f32_attend_kernel<WD, BAND><<<(unsigned)blocks, FA_NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool BAND>
int launch_band(const ParamsF& p, cudaStream_t stream) {
  switch (p.D) {
    case 32: return launch_wd<32, BAND>(p, stream);
    case 64: return launch_wd<64, BAND>(p, stream);
    case 96: return launch_wd<96, BAND>(p, stream);
    case 128: return launch_wd<128, BAND>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

int launch_f32_attend(const ParamsF& p, cudaStream_t stream) {
  return p.w > 0 ? launch_band<true>(p, stream) : launch_band<false>(p, stream);
}

}  // namespace avdd_k1
