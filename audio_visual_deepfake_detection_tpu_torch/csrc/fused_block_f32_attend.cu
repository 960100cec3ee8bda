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
// visits only the key tiles that meet [r0 - w, r0 + 63 + w]. The instances
// are the head widths 32, 64, 96 and 128; a narrower head runs the next
// wider one with q, k and v zero past its width (PAD), a head past 128 the
// wide kernel below. K7 past its tiled kernel runs the banded instances up
// to head width 128 on its own operands (band_attend.cuh, launch_band_f32
// below): k and v split into the same layouts first, q read in place
// through its strides, the context written unsplit.

#include "fused_block.cuh"
#include "band_attend.cuh"

namespace avdd_k1 {
namespace {

template <class P> constexpr bool IS_BAND = false;    // K7's operands
template <> constexpr bool IS_BAND<BandParams> = true;

// K7: the context of rows row0, row1 of (sample b, head h), columns c, c + 1
// (c < D), divided by the rows' denominators (invalid rows zero).
__device__ __forceinline__ void band_store(const BandParams& p, int b, int h, int row0, int c,
                                           const float* o, bool live0, bool live1, float z0,
                                           float z1) {
  float* out = static_cast<float*>(p.io.out) + b * p.io.so[0] + h * p.io.so[1] + c;
  const size_t ls = (size_t)p.io.so[2];
  if (row0 < p.T)
    *reinterpret_cast<float2*>(out + row0 * ls) =
        live0 ? make_float2(o[0] / z0, o[1] / z0) : make_float2(0.f, 0.f);
  if (row0 + 8 < p.T)
    *reinterpret_cast<float2*>(out + (row0 + 8) * ls) =
        live1 ? make_float2(o[2] / z1, o[3] / z1) : make_float2(0.f, 0.f);
}

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

// PAD: the head's width D = p.D is below the instance's WD; q, k and v are
// staged as zeros past D, which change no score and no context column, and
// only the first D context columns are written. P: ParamsF (K1) or
// BandParams (K7, whose D may be 4 mod 8: a column pair lies wholly inside
// or outside the head).
template <int WD, bool BAND, bool PAD, class P>
__global__ void __launch_bounds__(FA_NT, F32Head<WD>::BLOCKS_PER_SM)
f32_attend_kernel(const __grid_constant__ P p) {
  using HD = F32Head<WD>;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t qhi = (smem_u32(smraw) + 1023u) & ~1023u, qlo = qhi + HD::QPART;
  const uint32_t phi = qlo + HD::QPART, plo = phi + HD::PPART, ring = plo + HD::PPART;
  const int T_ = p.T, C = p.C, w = p.w;
  const int D = PAD ? p.D : WD;
  const int nrb = (T_ + FA_ROWS - 1) / FA_ROWS, H = C / D;
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
        const bool ok = key < T_ && (!PAD || 4 * c < D);
        const float* src = (part ? p.klo : p.khi) + (rb + (ok ? key : 0)) * C + h * D +
                           (PAD && !ok ? 0 : 4 * c);
        cp_async16_to(st + part * HD::KPART + (c / 8) * (KEY_TILE * 128) + swz(r, c % 8), src,
                      ok ? 16 : 0);
      }
      constexpr int VCH = WD * KEY_TILE / 4;           // 16-byte chunks of a v^T part
#pragma unroll
      for (int i = 0; i < 2 * VCH / FA_NT; ++i) {      // v^T hi, lo: (channel ch, chunk c)
        const int idx = tid + FA_NT * i, part = idx / VCH, ch = (idx % VCH) / 8, c = idx % 8;
        const bool okv = !PAD || ch < D;
        const float* src = (part ? p.vtlo : p.vthi) +
                           ((size_t)b * C + h * D + (okv ? ch : 0)) * p.Tp + k0 + 4 * c;
        cp_async16_to(st + 2 * HD::KPART + part * HD::VPART + swz(ch, c), src, okv ? 16 : 0);
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
    if (row < T_ && (!PAD || 4 * c < D)) {
      if constexpr (IS_BAND<P>)
        v = *reinterpret_cast<const float4*>(static_cast<const float*>(p.io.q) +
                                             b * p.io.sq[0] + h * p.io.sq[1] +
                                             row * p.io.sq[2] + 4 * c);
      else
        v = *reinterpret_cast<const float4*>(p.q + (rb + row) * C + h * D + 4 * c);
    }
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
    if (PAD && 8 * jj >= D) break;
    if constexpr (IS_BAND<P>) {
      if (!PAD || 8 * jj + 2 * t < D)
        band_store(p, b, h, row0, 8 * jj + 2 * t, O + 4 * jj, live0, live1, z0, z1);
    } else {
      const size_t c = (size_t)h * D + 8 * jj + 2 * t;
      if (row0 < T_)
        store_split2(p.chi, p.clo, (rb + row0) * C + c, live0 ? O[4 * jj] / z0 : 0.f,
                     live0 ? O[4 * jj + 1] / z0 : 0.f);
      if (row1 < T_)
        store_split2(p.chi, p.clo, (rb + row1) * C + c, live1 ? O[4 * jj + 2] / z1 : 0.f,
                     live1 ? O[4 * jj + 3] / z1 : 0.f);
    }
  }
}

// ---- head widths past 128, banded ---------------------------------------------
// A block of one warpgroup owns 64 query rows of one (sample, head) and 128
// of its context columns (a head's last block the rest, zero columns past
// D): the blocks of a row block each recompute the scores for their own
// columns. q and k (f32_pad_qk_kernel's planes) stream with each key tile
// in 64-channel chunks, so none of the head's width stays
// in shared memory: at D = 512, q split would be 256 KB, over the 227 KB a
// block has, and the context 256 accumulators a thread of one warpgroup.
// Per key tile: a step per chunk (its q hi / lo and k hi / lo tiles; the
// scores summed per 32 channels, 12 products into St added in f32, as
// above), then one step of the tile's v^T hi / lo (128 channel rows of 32
// keys) for P.V; the softmax as above.
constexpr int WC = 64;          // channels of q and k a score step stages
constexpr int WCOLS = 128;      // context columns a block
struct Wide {
  static constexpr int QPART = FA_ROWS * WC * 4;       // q hi (or lo): 2 blocks of 64 rows
  static constexpr int KPART = KEY_TILE * WC * 4;      // k hi (or lo): 2 blocks of 32 rows
  static constexpr int VPART = WCOLS * KEY_TILE * 4;   // v^T hi (or lo): 128 rows of 128 bytes
  static constexpr int PPART = FA_ROWS * KEY_TILE * 4;
  static constexpr int STAGE = 2 * QPART + 2 * KPART;  // a score step; a P.V step takes 2 VPART
  static constexpr int NS = 3;
  static constexpr int SMEM = 1024 + 2 * PPART + NS * STAGE;
  static_assert(2 * VPART <= STAGE && SMEM <= SMEM_MAX, "shared memory");
};

// q split and k, head by head, padded with zeros to Dp = D rounded up to 32
// channels: four (H, R, Dp) planes q hi | q lo | k hi | k lo over the
// operand rows xhi | xlo (8 R C floats, free once the q | k | v GEMM has
// read them; 4 H R Dp <= 8 R C since D >= 24). Both kernels past head
// width 128 read them.
__global__ void __launch_bounds__(256) f32_pad_qk_kernel(const __grid_constant__ ParamsF p) {
  const int D = p.D, Dp = (D + 31) / 32 * 32, C = p.C;
  const long long R = (long long)p.B * p.T, n = (long long)(C / D) * R * Dp;
  float* qh = p.xhi;
  float* ql = qh + n;
  float* kh = ql + n;
  float* kl = kh + n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int c = (int)(i % Dp);
    const long long hr = i / Dp, r = hr % R;
    const int h = (int)(hr / R);
    float a = 0.f, b = 0.f, e = 0.f, f = 0.f;
    if (c < D) {
      const size_t at = (size_t)r * C + h * D + c;
      uint32_t x, y;
      tf32_split(p.q[at], x, y);
      a = __uint_as_float(x);
      b = __uint_as_float(y);
      e = p.khi[at];
      f = p.klo[at];
    }
    qh[i] = a;
    ql[i] = b;
    kh[i] = e;
    kl[i] = f;
  }
}

__global__ void __launch_bounds__(FA_NT, 1)
f32_attend_wide_kernel(const __grid_constant__ ParamsF p) {
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t phi = (smem_u32(smraw) + 1023u) & ~1023u, plo = phi + Wide::PPART;
  const uint32_t ring = plo + Wide::PPART;
  const int T_ = p.T, C = p.C, w = p.w, D = p.D, Dp = (D + 31) / 32 * 32;
  const int nrb = (T_ + FA_ROWS - 1) / FA_ROWS, H = C / D;
  const int ncb = (D + WCOLS - 1) / WCOLS, nq = (D + WC - 1) / WC, per = nq + 1;
  const long long R = (long long)p.B * T_, n = (long long)H * R * Dp;
  // one grid axis, row blocks fastest, then column blocks: the blocks of a
  // (sample, head) run together and share its q, k and v in L2
  const int rest = blockIdx.x / nrb, cb = rest % ncb, bh = rest / ncb;
  const int b = bh / H, h = bh % H, r0 = (blockIdx.x % nrb) * FA_ROWS, c0 = cb * WCOLS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = r0 + 16 * warp + g, row1 = row0 + 8;
  const size_t rb = (size_t)b * T_;
  const uint8_t* mrow = p.mask + rb;
  const int lo_t = max(r0 - w, 0) / KEY_TILE;        // the key tiles the band meets
  const int hi_t = min(r0 + FA_ROWS - 1 + w, T_ - 1) / KEY_TILE;
  const int total = (hi_t - lo_t + 1) * per;   // steps: per key tile nq chunks, then P.V

  auto load_step = [&](int i) {
    if (i < total) {
      const int sub = i % per, k0 = (lo_t + i / per) * KEY_TILE;
      const uint32_t st = ring + (i % Wide::NS) * Wide::STAGE;
      if (sub < nq) {                  // q and k, channels WC sub ..
        const int ch0 = sub * WC;
        constexpr int QCH = FA_ROWS * WC / 4, KCH = KEY_TILE * WC / 4;   // 16-byte chunks a part
#pragma unroll 1
        for (int i2 = 0; i2 < 2 * QCH / FA_NT; ++i2) {
          const int idx = tid + FA_NT * i2, part = idx / QCH, r = (idx % QCH) / (WC / 4),
                    c = idx % (WC / 4), row = r0 + r, ch = ch0 + 4 * c;
          const bool ok = row < T_ && ch < Dp;
          const float* src = p.xhi + part * n + (ok ? (h * R + rb + row) * Dp + ch : 0);
          cp_async16_to(st + part * Wide::QPART + (c / 8) * (FA_ROWS * 128) + swz(r, c % 8), src,
                        ok ? 16 : 0);
        }
#pragma unroll 1
        for (int i2 = 0; i2 < 2 * KCH / FA_NT; ++i2) {
          const int idx = tid + FA_NT * i2, part = idx / KCH, r = (idx % KCH) / (WC / 4),
                    c = idx % (WC / 4), key = k0 + r, ch = ch0 + 4 * c;
          const bool ok = key < T_ && ch < Dp;
          const float* src = p.xhi + (2 + part) * n + (ok ? (h * R + rb + key) * Dp + ch : 0);
          cp_async16_to(st + 2 * Wide::QPART + part * Wide::KPART + (c / 8) * (KEY_TILE * 128) +
                            swz(r, c % 8),
                        src, ok ? 16 : 0);
        }
      } else {                         // v^T hi, lo: the block's context columns
        constexpr int VCH = WCOLS * KEY_TILE / 4;
#pragma unroll 1
        for (int i2 = 0; i2 < 2 * VCH / FA_NT; ++i2) {
          const int idx = tid + FA_NT * i2, part = idx / VCH, ch = (idx % VCH) / 8, c = idx % 8;
          const bool ok = c0 + ch < D;
          const float* src = (part ? p.vtlo : p.vthi) +
                             ((size_t)b * C + h * D + (ok ? c0 + ch : 0)) * p.Tp + k0 + 4 * c;
          cp_async16_to(st + part * Wide::VPART + swz(ch, c), src, ok ? 16 : 0);
        }
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < Wide::NS - 1; ++i) load_step(i);

  float S[16], St[16], O[WCOLS / 2], Ot[WCOLS / 2];
#pragma unroll
  for (int i = 0; i < 16; ++i) S[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WCOLS / 2; ++i) O[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, z0 = 0.f, z1 = 0.f, sc0 = 1.f, sc1 = 1.f;

#pragma unroll 1
  for (int i = 0; i < total; ++i) {
    cp_wait<Wide::NS - 2>();
    fence_async_shared();
    __syncthreads();             // step i has landed; step i - 1's stage and p are free
    load_step(i + Wide::NS - 1);
    const int sub = i % per, k0 = (lo_t + i / per) * KEY_TILE;
    const uint32_t st = ring + (i % Wide::NS) * Wide::STAGE;
    if (sub == nq) {             // O = O x rescale + P . V over the block's columns
      const uint32_t vhi = st, vlo = st + Wide::VPART;
      fence_regs(Ot);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32SS<WCOLS>::run(Ot, tile_desc(phi + 32 * kk), tile_desc(vlo + 32 * kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32SS<WCOLS>::run(Ot, tile_desc(plo + 32 * kk), tile_desc(vhi + 32 * kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32SS<WCOLS>::run(Ot, tile_desc(phi + 32 * kk), tile_desc(vhi + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(Ot);
#pragma unroll
      for (int q = 0; q < WCOLS / 2; ++q) O[q] = O[q] * ((q & 2) ? sc1 : sc0) + Ot[q];
      continue;
    }
    // the chunk's scores, per 32 channels (a block past D is zeros: skipped)
#pragma unroll
    for (int kb = 0; kb < WC / 32; ++kb) {
      if (sub * WC + 32 * kb >= D) break;
      const uint32_t qb = st + kb * (FA_ROWS * 128), qlb = qb + Wide::QPART;
      const uint32_t kbh = st + 2 * Wide::QPART + kb * (KEY_TILE * 128), kbl = kbh + Wide::KPART;
      fence_regs(St);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32SS<32>::run(St, tile_desc(qb + 32 * kk), tile_desc(kbl + 32 * kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32SS<32>::run(St, tile_desc(qlb + 32 * kk), tile_desc(kbh + 32 * kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32SS<32>::run(St, tile_desc(qb + 32 * kk), tile_desc(kbh + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(St);
#pragma unroll
      for (int q = 0; q < 16; ++q) S[q] = (sub == 0 && kb == 0) ? St[q] : S[q] + St[q];
    }
    if (sub < nq - 1) continue;
    // the tile's scores are whole: masks, maxima, p into its two tiles
    const uint32_t vbits = __ballot_sync(0xffffffffu, k0 + lane < T_ && mrow[k0 + lane]);
    float tm0 = -CUDART_INF_F, tm1 = -CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * jj + 2 * t + (e & 1), key = k0 + col;
        const bool valid = (vbits >> col) & 1u;
        float s = S[4 * jj + e];
        if (!valid) s += -NEG_PENALTY;
        const int dk = key - (e < 2 ? row0 : row1);
        if (key >= T_ || dk < -w || dk > w) s = -CUDART_INF_F;
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
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    const float mu0 = mn0 == -CUDART_INF_F ? 0.f : mn0, mu1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    sc0 = expf(m0 - mu0);
    sc1 = expf(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pr[e] = expf(S[4 * jj + e] - (e < 2 ? mu0 : mu1));
        if (e < 2) s0 += pr[e];
        else s1 += pr[e];
      }
      uint32_t hh[4], ll[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(pr[e], hh[e], ll[e]);
      const int col = 8 * jj + 2 * t, ra = 16 * warp + g;
      const uint32_t a0 = swz(ra, col / 4) + 4 * (col % 4);
      const uint32_t a1 = swz(ra + 8, col / 4) + 4 * (col % 4);
      st_shared8(phi + a0, hh[0], hh[1]);
      st_shared8(plo + a0, ll[0], ll[1]);
      st_shared8(phi + a1, hh[2], hh[3]);
      st_shared8(plo + a1, ll[2], ll[3]);
    }
    z0 = z0 * sc0 + s0;
    z1 = z1 * sc1 + s1;
  }
  cp_wait<0>();
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    z0 += __shfl_xor_sync(0xffffffffu, z0, o);
    z1 += __shfl_xor_sync(0xffffffffu, z1, o);
  }
  const bool live0 = row0 < T_ && mrow[row0], live1 = row1 < T_ && mrow[row1];
#pragma unroll
  for (int jj = 0; jj < WCOLS / 8; ++jj) {
    if (c0 + 8 * jj >= D) break;
    const size_t c = (size_t)h * D + c0 + 8 * jj + 2 * t;
    if (row0 < T_)
      store_split2(p.chi, p.clo, (rb + row0) * C + c, live0 ? O[4 * jj] / z0 : 0.f,
                   live0 ? O[4 * jj + 1] / z0 : 0.f);
    if (row1 < T_)
      store_split2(p.chi, p.clo, (rb + row1) * C + c, live1 ? O[4 * jj + 2] / z1 : 0.f,
                   live1 ? O[4 * jj + 3] / z1 : 0.f);
  }
}

// ---- dense attention past head width 128: two GEMMs through the scores ---------
// The wide kernel above recomputes a row block's scores in each of its D /
// 128 column blocks and re-stages q with every key tile: run dense at
// (2048, 4), B=2, T=2304, the block took 23.3 ms on an H100 (700 W), behind
// the plain version's 21.3. Dense, the scores of a (sample, head) are one
// T x T GEMM over D, so they are formed once: from f32_pad_qk_kernel's
// planes the scores GEMM (Tf32Gemm, 3xTF32 per 32 channels as above) writes
// the masked scores (B H, T, Tp); a block a row takes the f32 softmax as
// block_math does (the maximum, the sum of exps, e / sum; masked keys' p
// zero, their values being zero) and writes P split over them; the P.V
// GEMM (K = Tp, W = v^T split) writes the context split, invalid rows zero.
using ScoreGemm = Tf32Gemm<128, 3, true>;
struct ScoreMaps { CUtensorMap ahi, alo, whi, wlo; };

// PV false: S[bh, i, j] = q_i . k_j for query rows blockIdx.y and keys
// blockIdx.x (tiles of 128), masked keys -1e30; PV true: the context of
// rows blockIdx.y, head columns blockIdx.x (tiles of 128), from P (B H, T,
// Tp) and v^T.
template <bool PV>
__global__ void __launch_bounds__(ScoreGemm::THREADS, 1)
f32_scores_gemm_kernel(const __grid_constant__ ScoreMaps maps, const __grid_constant__ ParamsF p) {
  using G = ScoreGemm;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t base = (smem_u32(smraw) + 1023u) & ~1023u;
  const int T_ = p.T, C = p.C, D = p.D, H = C / D;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const long long R = (long long)p.B * T_;
  const int m0 = blockIdx.y * G::ROWS, n0 = blockIdx.x * 128;
  const int arow = PV ? bh * T_ + m0 : (int)(h * R + (long long)b * T_ + m0);
  const int wrow = PV ? b * C + h * D + n0 : (int)(h * R + (long long)b * T_ + n0);
  const int nk = PV ? p.Tp / G::KS : (D + 31) / 32;
  G::init(base);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    if (threadIdx.x == 256)
      G::produce(base, &maps.ahi, &maps.alo, &maps.whi, &maps.wlo, 0, arow, wrow, nk);
    return;
  }
  float acc[64];
  G::consume(base, wg, nk, acc, [](int, uint32_t, uint32_t) {});
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint8_t* mrow = p.mask + (size_t)b * T_;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = m0 + 64 * wg + 16 * warp + g + 8 * hf;
    if (i >= T_) continue;
    if (PV) {
      const bool live = mrow[i];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (n >= D) continue;
        store_split2(p.chi, p.clo, ((size_t)b * T_ + i) * C + h * D + n,
                     live ? acc[4 * j + 2 * hf] : 0.f, live ? acc[4 * j + 2 * hf + 1] : 0.f);
      }
    } else {
      float* srow = p.s + ((size_t)bh * T_ + i) * p.Tp;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = n0 + 8 * j + 2 * t + e;
          if (key < T_) srow[key] = mrow[key] ? acc[4 * j + 2 * hf + e] : NEG_INF;
        }
      }
    }
  }
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_max(lane < 8 ? red[lane] : -CUDART_INF_F);
}

// A block a score row: p = e / sum over the row's T keys, zero at masked
// keys and past T, split over the row (hi) and into slo.
__global__ void __launch_bounds__(256) f32_softmax_rows_kernel(const __grid_constant__ ParamsF p) {
  __shared__ float red[8];
  const long long row = blockIdx.x;                  // (b H + h) T + i
  const int T_ = p.T, Tp = p.Tp, b = (int)(row / T_) / (p.C / p.D);
  float* s = p.s + row * Tp;
  float* lo = p.slo + row * Tp;
  const uint8_t* mrow = p.mask + (size_t)b * T_;
  float m = -CUDART_INF_F;
  for (int j = threadIdx.x; j < T_; j += 256) m = fmaxf(m, s[j]);
  m = block_max(m, red);
  float z = 0.f;
  for (int j = threadIdx.x; j < T_; j += 256) z += expf(s[j] - m);
  z = block_sum(z, red);
  for (int j = threadIdx.x; j < Tp; j += 256) {
    const float e = j < T_ && mrow[j] ? expf(s[j] - m) / z : 0.f;
    uint32_t x, y;
    tf32_split(e, x, y);
    s[j] = __uint_as_float(x);
    lo[j] = __uint_as_float(y);
  }
}

int launch_scores_gemm(const ParamsF& p, cudaStream_t stream) {
  const int D = p.D, Dp = (D + 31) / 32 * 32, H = p.C / D, T_ = p.T;
  const long long R = (long long)p.B * T_, n = (long long)H * R * Dp, BH = (long long)p.B * H;
  if (BH > 65535 || R * H > 0x7fffffffLL || BH * T_ > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static int conf_s = 0, conf_v = 0;
  if (int e = set_smem(f32_scores_gemm_kernel<false>, ScoreGemm::SMEM, conf_s)) return e;
  if (int e = set_smem(f32_scores_gemm_kernel<true>, ScoreGemm::SMEM, conf_v)) return e;
  f32_pad_qk_kernel<<<528, 256, 0, stream>>>(p);
  if (int e = (int)cudaGetLastError()) return e;
  const uint32_t box[2] = {32, 128};
  ScoreMaps ms;
  const uint64_t qd[2] = {(uint64_t)Dp, (uint64_t)(H * R)}, qs[1] = {4ull * Dp};
  if (int e = f32_tensor_map(&ms.ahi, p.xhi, 2, qd, qs, box)) return e;
  if (int e = f32_tensor_map(&ms.alo, p.xhi + n, 2, qd, qs, box)) return e;
  if (int e = f32_tensor_map(&ms.whi, p.xhi + 2 * n, 2, qd, qs, box)) return e;
  if (int e = f32_tensor_map(&ms.wlo, p.xhi + 3 * n, 2, qd, qs, box)) return e;
  const unsigned tt = (unsigned)((T_ + 127) / 128);
  f32_scores_gemm_kernel<false><<<dim3(tt, tt, (unsigned)BH), ScoreGemm::THREADS,
                                  ScoreGemm::SMEM, stream>>>(ms, p);
  if (int e = (int)cudaGetLastError()) return e;
  f32_softmax_rows_kernel<<<(unsigned)(BH * T_), 256, 0, stream>>>(p);
  if (int e = (int)cudaGetLastError()) return e;
  ScoreMaps mv;
  const uint64_t pd[2] = {(uint64_t)p.Tp, (uint64_t)(BH * T_)}, ps[1] = {4ull * p.Tp};
  const uint64_t vd[2] = {(uint64_t)p.Tp, (uint64_t)p.B * p.C};
  if (int e = f32_tensor_map(&mv.ahi, p.s, 2, pd, ps, box)) return e;
  if (int e = f32_tensor_map(&mv.alo, p.slo, 2, pd, ps, box)) return e;
  if (int e = f32_tensor_map(&mv.whi, p.vthi, 2, vd, ps, box)) return e;
  if (int e = f32_tensor_map(&mv.wlo, p.vtlo, 2, vd, ps, box)) return e;
  f32_scores_gemm_kernel<true><<<dim3((unsigned)((D + 127) / 128), tt, (unsigned)BH),
                                 ScoreGemm::THREADS, ScoreGemm::SMEM, stream>>>(mv, p);
  return (int)cudaGetLastError();
}

template <int WD, bool BAND, bool PAD, class P>
int launch_wd(const P& p, cudaStream_t stream) {
  static int configured = 0;
  constexpr int bytes = F32Head<WD>::SMEM;
  if (int e = set_smem(f32_attend_kernel<WD, BAND, PAD, P>, bytes, configured)) return e;
  const long long blocks = (long long)p.B * (p.C / p.D) * ((p.T + FA_ROWS - 1) / FA_ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  f32_attend_kernel<WD, BAND, PAD, P><<<(unsigned)blocks, FA_NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_wide(const ParamsF& p, cudaStream_t stream) {
  static int configured = 0;
  if (int e = set_smem(f32_attend_wide_kernel, Wide::SMEM, configured)) return e;
  const long long blocks = (long long)p.B * (p.C / p.D) * ((p.D + WCOLS - 1) / WCOLS) *
                           ((p.T + FA_ROWS - 1) / FA_ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  f32_pad_qk_kernel<<<528, 256, 0, stream>>>(p);
  if (int e = (int)cudaGetLastError()) return e;
  f32_attend_wide_kernel<<<(unsigned)blocks, FA_NT, Wide::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// K7's k and v into the f32 kernel's layouts, a block a (sample, head, 32
// keys, 32 channels) tile, keys to Tp and channels to D rounded up to 32,
// each value split into its TF32 parts: k into (B T, C), v transposed
// through shared memory into (B, C, Tp), keys past T zero.
__global__ void __launch_bounds__(256) band_f32_prep_kernel(const __grid_constant__ BandParams p) {
  __shared__ float tile[32][33];
  const int D = p.D, H = p.C / D, T_ = p.T;
  const int nc = (D + 31) / 32, nk = p.Tp / 32;
  const int c0 = 32 * (blockIdx.x % nc), k0 = 32 * ((blockIdx.x / nc) % nk);
  const int bh = blockIdx.x / (nc * nk), b = bh / H, h = bh % H;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const BandIO& io = p.io;
  const float* k = static_cast<const float*>(io.k) + b * io.sk[0] + h * io.sk[1];
  const float* v = static_cast<const float*>(io.v) + b * io.sv[0] + h * io.sv[1];
  const int c = c0 + tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {       // rows key, channels c: v into the tile, k out
    const int key = k0 + ty + 8 * i;
    const bool in = key < T_ && c < D;
    tile[ty + 8 * i][tx] = in ? v[key * io.sv[2] + c] : 0.f;
    if (in) {
      const size_t at = ((size_t)b * T_ + key) * p.C + h * D + c;
      uint32_t hi, lo;
      tf32_split(k[key * io.sk[2] + c], hi, lo);
      p.khi[at] = __uint_as_float(hi);
      p.klo[at] = __uint_as_float(lo);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {       // rows channel, keys k0 + tx: v^T
    const int ch = c0 + ty + 8 * i;
    if (ch >= D) continue;
    uint32_t hi, lo;
    tf32_split(tile[tx][ty + 8 * i], hi, lo);
    const size_t at = ((size_t)b * p.C + h * D + ch) * p.Tp + k0 + tx;
    p.vthi[at] = __uint_as_float(hi);
    p.vtlo[at] = __uint_as_float(lo);
  }
}

// Head widths 32 / 64 / 96 / 128 run their instance, narrower ones the next
// wider instance padded with zeros, wider ones (K1 only) the wide kernel
// (banded) or the scores GEMMs (dense).
template <bool BAND, class P>
int launch_band(const P& p, cudaStream_t stream) {
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
  if constexpr (IS_BAND<P>) return (int)cudaErrorInvalidValue;
  else if constexpr (BAND) return launch_wide(p, stream);
  else return launch_scores_gemm(p, stream);
}

}  // namespace

int launch_f32_attend(const ParamsF& p, cudaStream_t stream) {
  return p.w > 0 ? launch_band<true>(p, stream) : launch_band<false>(p, stream);
}

// K7 (head widths up to 128): the prep launch, then always banded (w = 0
// attends the row's own key only).
int launch_band_f32(BandParams p, float* scratch, cudaStream_t stream) {
  if (p.D > 128) return (int)cudaErrorInvalidValue;
  const long long R = (long long)p.B * p.T, H = p.C / p.D;
  p.Tp = (p.T + KEY_TILE - 1) / KEY_TILE * KEY_TILE;
  float* f = scratch;
  auto take = [&](long long n) { float* r = f; f += n; return r; };
  p.khi = take(R * p.C);
  p.klo = take(R * p.C);
  p.vthi = take((long long)p.B * p.C * p.Tp);
  p.vtlo = take((long long)p.B * p.C * p.Tp);
  const long long blocks = (long long)p.B * H * (p.Tp / 32) * ((p.D + 31) / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  band_f32_prep_kernel<<<(unsigned)blocks, 256, 0, stream>>>(p);
  if (int e = (int)cudaGetLastError()) return e;
  return launch_band<true>(p, stream);
}

}  // namespace avdd_k1
