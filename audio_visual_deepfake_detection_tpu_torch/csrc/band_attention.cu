// Banded sliding-window attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel audio_visual_deepfake_detection_tpu/ops/pallas/
// band_attention.py::band_attention_pallas (pl.pallas_call at :105), the
// forward of band_attention_fused (:124): the attention of the localizer's
// unfused TransformerBlock (training with dropout > 0). For q (pre-scaled),
// k, v of shape (B, H, T, D) and a (B, T) bool key mask, query row i attends
// keys i-w .. i+w:
//   s_d = sum_c q[i, c] k[i+d, c] + (key i+d masked ? -1e4 : 0),
//   -inf where i+d falls outside the sequence (edge rows renormalise),
//   p = softmax over the 2w+1 offsets, out[i] = sum_d p_d v[i+d],
//   and a row whose own key slot is masked comes out zero.
// The arithmetic is the Pallas body's, in the input dtype: in bf16 the
// products q k, the penalised score, s - max, the exp, the running sum of the
// exps, the quotient and the running p v sum are each rounded to bf16 where
// that body rounds them (the head sum itself accumulates in f32 and rounds
// once); in f32 nothing is rounded. The quotient is e times the f32
// reciprocal of the sum, rounded to bf16: for bf16 e and sum that is the
// rounded f32 quotient, bit for bit (the quotient of two 8-bit mantissas
// lies at least 2^-18 of itself from a bf16 rounding midpoint, the product's
// error is under 2^-23; tests/test_torch_band_attention.py checks every
// pair). The plain version is band_attention_plain in
// ops/kernels/band_attention.py.
//
// What bounds it on this card: bytes. A call reads q, k, v and writes out
// once, 4 B H T D elements, against (2w+1) 4 D operations a row: ~7 FLOP a
// byte in bf16 at w = 3, far below the ridge (~295).
// What this design does about it: every byte is moved once from device
// memory, in 16-byte pieces, and the arithmetic a row needs is cut and
// spread over enough warps to hide under the copies.
// - A block computes a tile: ROWS = 8 consecutive query rows of one sample
//   across a slab of heads, the heads of one 512-byte run of a row (all 4
//   heads of 64 in bf16; 2 in f32; 512 / (D x element size) in general).
//   With the head views of the unfused block ((B, T, H D) projections) that
//   run is contiguous.
// - Its k and v rows, the ±w halo included, are staged once into shared
//   memory by 16-byte cp.async (zeros outside the sequence), so a staged row
//   serves all 2w+1 queries that read it; the halo is re-read from L2. q is
//   read straight into registers and the output written once, as 16-byte
//   vectors. A row is a chain of dependent steps (loads, shuffles, exps,
//   the running sums), so what hides the latency is many short blocks: a
//   warp a row, six blocks (48 warps) an SM within 40 registers a thread,
//   one block's copies in flight while the others compute.
// - Lane l of a warp holds 16 bytes of head slot l / P (P = 8 lanes a head
//   for bf16 D = 64, 16 for f32 D = 64; 8, 16 or 32 in general). The 2w+1
//   dot products are each lane's eight (four) rounded products summed in
//   f32, then summed over the P lanes by halving exchanges (log2 P rounds,
//   a shuffle per kept pair) that leave each lane the totals of its own
//   (2w+1) / P offsets: the lane rounds, penalises and exps only those, and
//   a shuffle per offset hands every lane the exps for the running sum and
//   the context. Products are mul.rn.bf16x2, the context add.rn.bf16x2, as
//   torch rounds them.
// - w is a template parameter (0 .. 16), P another: the offsets unroll, the
//   scores stay in registers, and two ballots give a row's key masks (the
//   second only for w = 16, whose 33rd offset spills past a 32-bit word).
//   Above w = 8 a block holds 2w + 8 staged rows and each lane more scores,
//   so an SM runs three such blocks (launch bounds) and not six.
// - One grid axis over (sample, row tile, head slab): no cap on B x H.
// The TPU kernel's whole-(T, D) VMEM tiles and 128-lane padding are not
// carried over.
//
// The rest of the Pallas kernel's domain, half windows above MAX_W and head
// rows over 512 bytes (head widths up to 512), runs two other routes
// (route_of):
// - float32 heads up to 128 wide on the tensor cores, on K1's attention
//   kernel (band_attend.cuh): 64 query rows a block with their q split in
//   shared memory visit only the 32-key tiles that meet the band, scores and
//   P.V in 3xTF32 on wgmma after a launch that splits k and v into TF32
//   parts, an online f32 softmax. Past 128 K1's kernel re-stages q with
//   every key tile and recomputes the scores for each 128 context columns,
//   and ran slower than band_rows_kernel at head widths 256 and 512.
// - bfloat16, and float32 past 128, band_rows_kernel below: the plain
//   version's steps in its order, bf16 scores on mma.sync. A bf16 route
//   that sums the context in f32 on the tensor cores is nearer the f32
//   function, but the plain version's running bf16 sums drift from it by
//   up to ~7e-2, so such a route leaves check_k7's per-element bound
//   against the plain version (atol = rtol = 2e-2) at wide windows
//   (tools/k7_bf16_order.py); tracking those sums takes them one offset at
//   a time, in order.

#include "common.cuh"
#include "band_attend.cuh"

namespace {

using namespace avdd;

constexpr int NW = 8;            // warps of a block
constexpr int NT = NW * 32;
constexpr int ROWS = NW;         // query rows of a block, a warp each
constexpr int MAX_W = 16;        // largest half window of the tiled kernel
constexpr int SLAB = 512;        // bytes of a staged row: 32 lanes x 16 bytes
constexpr float PENALTY = -1e4f;
static_assert(2 * MAX_W + 1 <= 64, "two ballots hold a row's key masks");

struct Strides { long long b, h, t; };

// x / d for 0 <= x < 2^31 by a multiply and a shift (Granlund and
// Montgomery): the block index is split without a division instruction.
struct FastDiv {
  unsigned m = 1, s = 0;
  FastDiv() = default;
  explicit FastDiv(unsigned d) {
    while ((1u << s) < d) ++s;
    m = (unsigned)(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned operator()(unsigned x) const {
    return (__umulhi(x, m) + x) >> s;
  }
};

struct Params {
  const char* q;
  const char* k;
  const char* v;
  const uint8_t* valid;          // (B, T)
  char* out;
  Strides sq, sk, sv, so;        // in bytes
  int H, T, tiles, slabs;
  FastDiv by_tiles, by_slabs;
  int n;                         // blocks: B x tiles x slabs
  int chunks;                    // 16-byte chunks of a head row
};

// The 16 bytes a lane holds, and the arithmetic on them, per input dtype.
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  __device__ __forceinline__ static float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // the two bf16 of a pair as f32, summed: one bit operation each
  __device__ __forceinline__ static float pair_sum(uint32_t w) {
    return __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
  }
  // sum of the eight products, each rounded to bf16, in f32
  __device__ __forceinline__ static float dot(const uint4& a, const uint4& b) {
    return (pair_sum(bf16x2_mul(a.x, b.x)) + pair_sum(bf16x2_mul(a.y, b.y))) +
           (pair_sum(bf16x2_mul(a.z, b.z)) + pair_sum(bf16x2_mul(a.w, b.w)));
  }
  // acc += p v with p rounded to bf16, the product and the sum each rounded
  __device__ __forceinline__ static void axpy(uint4& acc, float p, const uint4& v) {
    const uint32_t pp = pack_bf16(p, p);
    acc.x = bf16x2_add(acc.x, bf16x2_mul(pp, v.x));
    acc.y = bf16x2_add(acc.y, bf16x2_mul(pp, v.y));
    acc.z = bf16x2_add(acc.z, bf16x2_mul(pp, v.z));
    acc.w = bf16x2_add(acc.w, bf16x2_mul(pp, v.w));
  }
};
template <> struct Vec<float> {
  __device__ __forceinline__ static float rnd(float x) { return x; }
  __device__ __forceinline__ static float dot(const uint4& a, const uint4& b) {
    float s = __uint_as_float(a.x) * __uint_as_float(b.x);
    s = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), s);
    s = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), s);
    return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), s);
  }
  __device__ __forceinline__ static void axpy(uint4& acc, float p, const uint4& v) {
    acc.x = __float_as_uint(fmaf(p, __uint_as_float(v.x), __uint_as_float(acc.x)));
    acc.y = __float_as_uint(fmaf(p, __uint_as_float(v.y), __uint_as_float(acc.y)));
    acc.z = __float_as_uint(fmaf(p, __uint_as_float(v.z), __uint_as_float(acc.z)));
    acc.w = __float_as_uint(fmaf(p, __uint_as_float(v.w), __uint_as_float(acc.w)));
  }
};

__device__ __forceinline__ uint4 ldg16(const char* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// P lanes a head (8, 16 or 32; a head row of fewer 16-byte chunks leaves
// the rest of its lanes holding zeros). A block computes one tile: query
// rows r0 .. r0 + ROWS - 1 of sample b across head slab `slab`, a warp a row.
template <typename T, int W, int P>
__global__ void __launch_bounds__(NT, W > 8 ? 3 : 6) band_attention_kernel(const Params p) {
  using V = Vec<T>;
  constexpr int K = 2 * W + 1;                     // offsets a row attends
  constexpr int NO = (K + P - 1) / P;              // offsets a lane finishes
  constexpr int LOG2P = P == 8 ? 3 : P == 16 ? 4 : 5;
  constexpr int SR = ROWS + 2 * W;                 // staged rows: the tile and its halo
  constexpr long long VB = 16;                     // bytes a lane holds of a row
  static_assert(P == 1 << LOG2P, "8, 16 or 32 lanes a head");
  extern __shared__ __align__(16) char smem[];     // the tile's k rows, then its v rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned tile = p.by_slabs(blockIdx.x), bt = p.by_tiles(tile);
  const int slab = blockIdx.x - tile * p.slabs, b = bt;
  const int r0 = (tile - bt * p.tiles) * ROWS, r = r0 + warp;
  const int c = lane % P;                          // the lane's 16-byte chunk of its head
  const int lead = lane - c;                       // the head's first lane
  const int h = slab * (32 / P) + lane / P;
  const bool live = h < p.H && c < p.chunks;

  // k and v rows r0 - W .. r0 + ROWS + W - 1, a warp a row, zeros outside
  // the sequence and for lanes without a head chunk
  const char* kb0 = p.k + b * p.sk.b + h * p.sk.h + c * VB;
  const char* vb0 = p.v + b * p.sv.b + h * p.sv.h + c * VB;
#pragma unroll
  for (int i = 0; i < (SR + NW - 1) / NW; ++i) {
    const int rr = warp + i * NW, s = r0 - W + rr;
    if (rr < SR) {
      const bool in = live && s >= 0 && s < p.T;
      cp_async16(smem + rr * SLAB + lane * 16, in ? kb0 + s * p.sk.t : p.k, in ? 16 : 0);
      cp_async16(smem + (SR + rr) * SLAB + lane * 16, in ? vb0 + s * p.sv.t : p.v, in ? 16 : 0);
    }
  }
  cp_commit();
  if (r >= p.T) {                                  // past the sequence: staging only
    cp_wait_all();
    __syncthreads();
    return;
  }
  // bit j: key r + j - W (staged row warp + j) is inside the sequence and
  // not masked; offsets 32 .. K - 1 in a second word
  const uint8_t* mrow = p.valid + (size_t)b * p.T;
  auto valid = [&](int j) {
    const int ks = r - W + j;
    return j < K && ks >= 0 && ks < p.T && mrow[ks] != 0;
  };
  const uint32_t kb = __ballot_sync(0xffffffffu, valid(lane));
  const uint32_t kb_hi = K > 32 ? __ballot_sync(0xffffffffu, valid(32 + lane)) : 0u;
  auto bit = [&](int j) { return ((j < 32 ? kb >> (j & 31) : kb_hi >> (j & 31)) & 1u) != 0; };
  const uint4 q = live ? ldg16(p.q + b * p.sq.b + h * p.sq.h + r * p.sq.t + c * VB)
                       : make_uint4(0u, 0u, 0u, 0u);
  cp_wait_all();
  __syncthreads();

  // the lane's part of the score of every offset j = d + W (key r + d is
  // staged row warp + j) ...
  const char* kst = smem + warp * SLAB + lane * 16;
  const char* vst = kst + SR * SLAB;
  float part[NO * P];
#pragma unroll
  for (int j = 0; j < NO * P; ++j)
    part[j] = j < K ? V::dot(q, *reinterpret_cast<const uint4*>(kst + j * SLAB)) : 0.f;
  // ... summed over the head's P lanes by halving exchanges: lane c ends
  // with the totals of offsets NO c .. NO c + NO - 1
#pragma unroll
  for (int lv = 1; lv <= LOG2P; ++lv) {
    const int half = P >> lv, len = NO * half;     // values kept this round
    const bool upper = c & half;
#pragma unroll
    for (int m = 0; m < NO * P / 2; ++m) {         // a constant trip count: fully unrolled
      if (m < len) {
        const float give = upper ? part[m] : part[m + len];
        part[m] = (upper ? part[m + len] : part[m]) + __shfl_xor_sync(0xffffffffu, give, half);
      }
    }
  }
  const float pen = V::rnd(PENALTY);
  float e[NO];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < NO; ++m) {
    const int j = NO * c + m, d = j - W;
    const float s = V::rnd(part[m]);
    const bool inseq = j < K && r + d >= 0 && r + d < p.T;
    e[m] = !inseq ? -CUDART_INF_F : bit(j) ? s : V::rnd(s + pen);
    mx = fmaxf(mx, e[m]);
  }
#pragma unroll
  for (int o = 1; o < P; o *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  // offset 0 is inside the sequence, so mx is finite
#pragma unroll
  for (int m = 0; m < NO; ++m) e[m] = V::rnd(expf(V::rnd(e[m] - mx)));
  // every lane gathers the head's exps and sums them in offset order
  float ex[K];
  float den = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ex[j] = __shfl_sync(0xffffffffu, e[j % NO], lead + j / NO);
    den = j == 0 ? ex[0] : V::rnd(den + ex[j]);
  }
  const float inv = __frcp_rn(den);
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < K; ++j)                      // a key outside the sequence was staged as zeros
    V::axpy(acc, ex[j] * inv, *reinterpret_cast<const uint4*>(vst + j * SLAB));
  if (!bit(W)) acc = make_uint4(0u, 0u, 0u, 0u);   // own key slot masked
  if (live)
    *reinterpret_cast<uint4*>(p.out + b * p.so.b + h * p.so.h + r * p.so.t + c * VB) = acc;
}

template <typename T, int W, int P>
int launch_p(const Params& p, cudaStream_t stream) {
  static int configured = 0;
  const int smem = 2 * (ROWS + 2 * W) * SLAB;
  if (int e = set_smem(band_attention_kernel<T, W, P>, smem, configured)) return e;
  band_attention_kernel<T, W, P><<<p.n, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch_w(const Params& p, int lanes, cudaStream_t s) {
  switch (lanes) {
    case 8: return launch_p<T, W, 8>(p, s);
    case 16: return launch_p<T, W, 16>(p, s);
    case 32: return launch_p<T, W, 32>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// launch_w<T, w> for the runtime w, one template instance per w <= MAX_W.
template <typename T, int W = 0>
int launch(const Params& p, int w, int lanes, cudaStream_t s) {
  if (w == W) return launch_w<T, W>(p, lanes, s);
  if constexpr (W < MAX_W) return launch<T, W + 1>(p, w, lanes, s);
  return (int)cudaErrorInvalidValue;
}

// ---- past the tiled kernel: band_rows_kernel ----------------------------------
// A block owns NW x RPW query rows of one (sample, head), a warp RPW of them
// (2, or 1 where blocks of 16 rows would not give every SM two), its lanes
// the head row's 16-byte pieces (CPL a lane). The keys the block's bands
// meet, [r0 - w, r0 + rows - 1 + w] in the sequence, stream through two
// shared stages of KTB = 32 rows (cp.async, zeros past them and the head,
// rows 16 bytes apart in banks) twice: k, then v. Each warp visits only the
// keys its own rows' bands meet.
// - Scores. bf16: 16 (row, key) pairs an mma.sync m16n8k16, its A rows the
//   pairs' products rounded to bf16 (mul.rn.bf16x2, as torch rounds them),
//   B ones, so the tensor cores sum each pair's products in f32 (two
//   chains of steps, added at the end); q in registers in the A layout.
//   f32: each lane's part of the RPW x KPS dot products (Vec::dot), summed
//   over the warp by halving exchanges (31 shuffles, each lane left one
//   total). Rounded, penalised where the key is masked, and kept at (row,
//   offset) in shared memory (a scratch in device memory where the block's
//   (rows, 2w + 1) do not fit), with each row's maximum.
// - Per row, in offset order: the exps, rounded as the plain version rounds
//   them, and their running sum, a shuffle per offset, the warp's rows
//   interleaved; then p = e / sum, rounded, over the scores.
// - Context: per key in order, p v into each row's running sum (Vec::axpy:
//   in bf16 the product and the sum each rounded), v's piece read from the
//   stage once for the warp's rows; a row's p outside its band is 0, which
//   adds nothing, so the rows' sums interleave without a branch.
// Offsets outside the sequence are skipped: their exps are exactly 0. So
// this takes band_attention_plain's steps in its order, and differs from it
// only by the f32 order of each score's sum (and in f32 the context's fused
// multiply-adds).
constexpr int KTB = 32;           // keys a stage
constexpr int SCORES_SMEM = 96 * 1024;   // shared memory the scores may take
constexpr unsigned FULL = 0xffffffffu;

struct RowsParams {
  const char* q;
  const char* k;
  const char* v;
  const uint8_t* valid;
  char* out;
  Strides sq, sk, sv, so;          // in bytes
  void* s;                         // (B, H, T, 2w + 1) scores where they do not fit on chip
  int H, T, w;                     // w < T
  int chunks;                      // 16-byte pieces of a head row
  int rblocks;                     // row blocks of a (sample, head)
};

__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Blocks an SM holds (the register cap): bf16's q in mma.sync's layout is
// 32 registers per 256 values of a head row; f32's q and context 8 per
// piece and row.
template <typename T, int CPL, int RPW>
constexpr int rows_blocks_per_sm() {
  return sizeof(T) == 2 ? (CPL == 1 ? 3 : 2) : (CPL * RPW <= 4 ? 3 : 2);
}

template <typename T, int CPL, int RPW>
__global__ void __launch_bounds__(NT, rows_blocks_per_sm<T, CPL, RPW>())
band_rows_kernel(const __grid_constant__ RowsParams p) {
  using V = Vec<T>;
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int RB = NW * RPW;                     // query rows a block
  constexpr int KPS = BF16 ? 16 / RPW : 32 / RPW;  // keys a score step
  constexpr int ROWB = CPL * 512 + 16;             // bytes of a staged key row (+16: banks)
  constexpr int TILE = KTB * ROWB;
  extern __shared__ __align__(16) char smem[];     // two stages, then the scores
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x / p.rblocks, r0 = (blockIdx.x - bh * p.rblocks) * RB;
  const int b = bh / p.H, h = bh - b * p.H;
  const int Tn = p.T, w = p.w, K = 2 * w + 1;
  const int rw = r0 + RPW * warp;                  // the warp's rows rw .. rw + RPW - 1
  const int lo = max(r0 - w, 0), hi = min(r0 + RB - 1 + w, Tn - 1);
  const int nt = (hi - lo) / KTB + 1;
  const uint8_t* mrow = p.valid + (size_t)b * Tn;
  // row r's offset d at sb[(r - r0) K + d]: shared memory, or the scratch
  T* sb = (p.s ? static_cast<T*>(p.s) + ((size_t)bh * Tn + r0) * K
               : reinterpret_cast<T*>(smem + 2 * TILE)) + w;
  const char* kb = p.k + b * p.sk.b + h * p.sk.h;
  const char* vb = p.v + b * p.sv.b + h * p.sv.h;
  // the keys the band of some row of the warp meets: wlo .. whi
  const int wlo = max(rw - w, lo), whi = rw < Tn ? min(rw + RPW - 1 + w, hi) : wlo - 1;
  auto in_band = [&](int r, int key) { return r < Tn && key >= r - w && key <= r + w; };

  // key rows k0 .. k0 + KTB - 1 of x into stage st, zeros past hi and the head
  auto stage = [&](const char* x, long long step, int k0, int st) {
    for (int i = threadIdx.x; i < KTB * 32 * CPL; i += NT) {
      const int r = i / (32 * CPL), c = i % (32 * CPL), key = k0 + r;
      const bool in = key <= hi && c < p.chunks;
      cp_async16(smem + st * TILE + r * ROWB + c * 16, in ? x + key * step + c * 16 : x,
                 in ? 16 : 0);
    }
    cp_commit();
  };
  // tile t + 1 into the stage tile t - 1 left; then tile t has landed, for
  // everyone
  auto next = [&](const char* x, long long step, int t) {
    if (t + 1 < nt) stage(x, step, lo + (t + 1) * KTB, (t + 1) & 1);
    else cp_commit();
    cp_wait1();
    __syncthreads();
  };

  // scores; each lane keeps the running maximum of one row's scores
  const float pen = V::rnd(PENALTY);
  float mx = -CUDART_INF_F;
  // a score: rounded, penalised where the key is masked, kept
  auto keep = [&](int r, int key, float total) {
    if (key > hi || !in_band(r, key)) return;
    float s = V::rnd(total);
    if (!mrow[key]) s = V::rnd(s + pen);
    sb[(r - r0) * K + key - r] = static_cast<T>(s);   // bf16: a bf16 value, exact
    mx = fmaxf(mx, s);
  };
  const int gq = lane >> 2, tq = lane & 3;         // mma.sync's thread coordinates
  // bf16: q of row rw + gq % RPW in mma.sync's A layout, channels 16 s +
  // 2 tq (+ 1) in qa[s][0] and + 8 in qa[s][1]; f32: q[rr][j] the lane's
  // pieces lane + 32 j of row rw + rr
  constexpr int NQA = BF16 ? 16 * CPL : 1;
  uint32_t qa[NQA][2];
  uint4 q[BF16 ? 1 : RPW][BF16 ? 1 : CPL];
  const char* qrow = p.q + b * p.sq.b + h * p.sq.h;
  if constexpr (BF16) {
    const int r = rw + gq % RPW;
#pragma unroll
    for (int st = 0; st < NQA; ++st)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = 16 * st + 8 * u + 2 * tq;    // channels c, c + 1 (D is even)
        qa[st][u] = r < Tn && c < 8 * p.chunks
                        ? __ldg(reinterpret_cast<const unsigned*>(qrow + r * p.sq.t + 2 * c))
                        : 0u;
      }
  } else {
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int r = rw + rr, c = lane + 32 * j;
        q[rr][j] = r < Tn && c < p.chunks ? ldg16(qrow + r * p.sq.t + c * 16)
                                          : make_uint4(0u, 0u, 0u, 0u);
      }
  }
  const int nsteps = (p.chunks + 1) / 2;           // 16-channel steps of a bf16 head row
  stage(kb, p.sk.t, lo, 0);
  for (int t = 0; t < nt; ++t) {
    next(kb, p.sk.t, t);
    const char* tile = smem + (t & 1) * TILE;
    const int k0 = lo + t * KTB;
    const int g0 = max(wlo - k0, 0) / KPS * KPS, g1 = min(whi - k0, KTB - 1);
#pragma unroll 1
    for (int g = g0; g <= g1; g += KPS) {               // the groups of keys the warp meets
      const int ka = k0 + g;
      if constexpr (BF16) {
        // 16 (row, key) pairs on mma.sync: pair m is row m % RPW, key m /
        // RPW; its A row holds the products rounded to bf16 (mul.rn.bf16x2),
        // B is ones, so every column of C is the pair's f32 sum. Thread (gq,
        // tq) forms pairs gq and gq + 8: one row, keys kg and kg + 8 / RPW.
        const int kg = gq / RPW;
        const char* k0p = tile + (g + kg) * ROWB + 4 * tq;
        const char* k1p = k0p + (8 / RPW) * ROWB;
        constexpr uint32_t ONES = 0x3f803f80u;     // bf16 1.0, twice
        float c[2][4] = {};                        // even and odd steps: two chains
#pragma unroll
        for (int st = 0; st < NQA; ++st) {
          if (st >= nsteps) break;
          const uint32_t a[4] = {
              bf16x2_mul(qa[st][0], *reinterpret_cast<const uint32_t*>(k0p + 32 * st)),
              bf16x2_mul(qa[st][0], *reinterpret_cast<const uint32_t*>(k1p + 32 * st)),
              bf16x2_mul(qa[st][1], *reinterpret_cast<const uint32_t*>(k0p + 32 * st + 16)),
              bf16x2_mul(qa[st][1], *reinterpret_cast<const uint32_t*>(k1p + 32 * st + 16))};
          mma_bf16(c[st & 1], a, ONES, ONES);
        }
        if (tq < 2)
          keep(rw + gq % RPW, ka + kg + tq * (8 / RPW),
               tq ? c[0][2] + c[1][2] : c[0][0] + c[1][0]);
      } else {
        // each lane's part of the RPW x KPS dot products, summed over the
        // warp by halving exchanges: lane l ends with the total of value l,
        // (row rr, key kk) at rr KPS + kk
        float part[32];
#pragma unroll
        for (int kk = 0; kk < KPS; ++kk) {
          uint4 kc[CPL];
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            kc[j] = *reinterpret_cast<const uint4*>(tile + (g + kk) * ROWB + j * 512 + lane * 16);
#pragma unroll
          for (int rr = 0; rr < RPW; ++rr) {
            float sum = V::dot(q[rr][0], kc[0]);
#pragma unroll
            for (int j = 1; j < CPL; ++j) sum += V::dot(q[rr][j], kc[j]);
            part[rr * KPS + kk] = sum;
          }
        }
#pragma unroll
        for (int lv = 1; lv <= 5; ++lv) {
          const int half = 32 >> lv;
          const bool upper = lane & half;
#pragma unroll
          for (int m = 0; m < 16; ++m) {
            if (m < half) {
              const float give = upper ? part[m] : part[m + half];
              part[m] = (upper ? part[m + half] : part[m]) + __shfl_xor_sync(FULL, give, half);
            }
          }
        }
        keep(rw + lane / KPS, ka + lane % KPS, part[0]);
      }
    }
    __syncthreads();                               // tile t consumed
  }
  // each row's maximum over the lanes that kept its scores: bf16 lanes
  // with one gq % RPW, f32 lanes with one lane / KPS
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const bool other_row = BF16 ? (o >= 4 && o < 4 * RPW) : o >= KPS;
    if (!other_row) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  }
  __syncwarp();                                    // the warp's scores are visible to it

  // per row, in offset order, the warp's rows interleaved: the exps' running
  // sum, then p over the scores. An offset outside the sequence adds 0.
  float m[RPW], den[RPW];
  int olo[RPW], ohi[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = rw + rr;
    m[rr] = __shfl_sync(FULL, mx, BF16 ? 4 * rr : rr * KPS);   // finite for a row in T
    olo[rr] = max(-w, -r);
    ohi[rr] = r < Tn ? min(w, Tn - 1 - r) : -w - 1;
    den[rr] = 0.f;
  }
  auto ex = [&](int rr, int o) {
    const float s = static_cast<float>(sb[(rw + rr - r0) * K + o]);
    return V::rnd(expf(V::rnd(s - m[rr])));
  };
#pragma unroll 1
  for (int o0 = -w; o0 <= w; o0 += 32) {
    float e[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int o = o0 + lane;
      e[rr] = o >= olo[rr] && o <= ohi[rr] ? ex(rr, o) : 0.f;
    }
    const int n = min(32, w - o0 + 1);
#pragma unroll 4
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) den[rr] = V::rnd(den[rr] + __shfl_sync(FULL, e[rr], i));
  }
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll 1
    for (int o = olo[rr] + lane; o <= ohi[rr]; o += 32)
      sb[(rw + rr - r0) * K + o] = static_cast<T>(V::rnd(ex(rr, o) / den[rr]));
  __syncwarp();                                    // p is visible to the warp

  // the context: per key in order, p v into each row's running sum
  uint4 acc[RPW][CPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[rr][j] = make_uint4(0u, 0u, 0u, 0u);
  stage(vb, p.sv.t, lo, 0);
  for (int t = 0; t < nt; ++t) {
    next(vb, p.sv.t, t);
    const char* tile = smem + (t & 1) * TILE;
    const int k0 = lo + t * KTB;
    float pr[RPW];                                 // lane l: p of key k0 + l, each row
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = rw + rr, key = k0 + lane;
      pr[rr] = key <= hi && in_band(r, key) ? static_cast<float>(sb[(r - r0) * K + key - r])
                                            : 0.f;
    }
    // the keys of the tile the warp meets; a row's p of a key outside its
    // band is 0, whose product adds nothing (acc + 0 v is acc, bit for bit)
    const int kk0 = max(wlo - k0, 0), kk1 = min(whi - k0, KTB - 1);
#pragma unroll 4
    for (int kk = kk0; kk <= kk1; ++kk) {
      uint4 vc[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        vc[j] = *reinterpret_cast<const uint4*>(tile + kk * ROWB + j * 512 + lane * 16);
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float pv = __shfl_sync(FULL, pr[rr], kk);
#pragma unroll
        for (int j = 0; j < CPL; ++j) V::axpy(acc[rr][j], pv, vc[j]);
      }
    }
    __syncthreads();                               // tile t consumed
  }
  cp_wait_all();
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = rw + rr;
    if (r >= Tn) break;
    const bool own = mrow[r] != 0;                 // own key slot masked: zero
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < p.chunks)
        *reinterpret_cast<uint4*>(p.out + b * p.so.b + h * p.so.h + r * p.so.t + c * 16) =
            own ? acc[rr][j] : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The rows a warp takes: 2, or 1 where fewer than two blocks of NW x 2
// rows an SM (132 on an H100) would run.
constexpr int RPW_WIDE = 2;
int rows_per_warp(long long bh, int T) {
  return bh * ((T + NW * RPW_WIDE - 1) / (NW * RPW_WIDE)) >= 2 * 132 ? RPW_WIDE : 1;
}

// Bytes of shared memory a launch takes, and whether the scores fit in it.
int rows_smem(int cpl, int rpw, int w, int es, bool& scores_on_chip) {
  const long long scores = (long long)NW * rpw * (2 * w + 1) * es;
  scores_on_chip = scores <= SCORES_SMEM;
  return 2 * KTB * (cpl * 512 + 16) + (scores_on_chip ? (int)scores : 0);
}

template <typename T, int CPL, int RPW>
int launch_rows(RowsParams p, void* scratch, long long bh, cudaStream_t stream) {
  static int configured = 0;
  bool on_chip;
  const int smem = rows_smem(CPL, RPW, p.w, (int)sizeof(T), on_chip);
  p.s = on_chip ? nullptr : scratch;
  if (!p.s && !on_chip) return (int)cudaErrorInvalidValue;
  p.rblocks = (p.T + NW * RPW - 1) / (NW * RPW);
  const long long blocks = bh * p.rblocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (int e = set_smem(band_rows_kernel<T, CPL, RPW>, smem, configured)) return e;
  band_rows_kernel<T, CPL, RPW><<<(unsigned)blocks, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// CPL pieces a lane: up to 32, 64 or 128 pieces of a head row (bf16 1 or 2,
// f32 2 or 4); RPW as rows_per_warp says.
template <typename T>
int launch_rows_for(const RowsParams& p, void* scratch, long long bh, cudaStream_t s) {
  const bool wide = rows_per_warp(bh, p.T) == RPW_WIDE;
  if constexpr (sizeof(T) == 2) {                  // bf16 head rows up to 1024 bytes
    if (p.chunks <= 32)
      return wide ? launch_rows<T, 1, 2>(p, scratch, bh, s) : launch_rows<T, 1, 1>(p, scratch, bh, s);
    return wide ? launch_rows<T, 2, 2>(p, scratch, bh, s) : launch_rows<T, 2, 1>(p, scratch, bh, s);
  } else {                                         // f32 past head width 128
    if (p.chunks <= 64)
      return wide ? launch_rows<T, 2, 2>(p, scratch, bh, s) : launch_rows<T, 2, 1>(p, scratch, bh, s);
    return wide ? launch_rows<T, 4, 2>(p, scratch, bh, s) : launch_rows<T, 4, 1>(p, scratch, bh, s);
  }
}

// The route a launch takes (BandArgs::route; ROUTE_NAMES and route_of in
// ops/kernels/band_attention.py): the tiled kernel up to MAX_W and 512-byte
// head rows; past it band_rows_kernel in bf16, K1's f32 attention on the
// tensor cores in f32 up to head width 128 (where it holds q split on chip),
// band_rows_kernel in f32 past 128.
enum { ROUTE_TILED = 0, ROUTE_ROWS_BF16 = 1, ROUTE_F32_WGMMA = 2, ROUTE_ROWS_F32 = 3 };
constexpr int F32_WGMMA_MAX_D = 128;
int route_of(int D, int es, int w) {
  if (w <= MAX_W && D * es <= SLAB) return ROUTE_TILED;
  if (es == 2) return ROUTE_ROWS_BF16;
  return D <= F32_WGMMA_MAX_D ? ROUTE_F32_WGMMA : ROUTE_ROWS_F32;
}

// Bytes of scratch a call past the tiled kernel takes (w capped at T - 1):
// K1's f32 attention k and v split; band_rows_kernel the scores of every
// (row, offset) where a block's do not fit in shared memory, else none.
long long scratch_bytes(int B, int H, int T, int D, int w, int es) {
  const long long wc = w < T ? w : T - 1;
  if (route_of(D, es, w) == ROUTE_F32_WGMMA)
    return 4 * avdd_k1::band_f32_scratch_elems(B, H, T, D);
  const int chunks = D * es / 16, cpl = chunks <= 32 ? 1 : chunks <= 64 ? 2 : 4;
  bool on_chip;
  rows_smem(cpl, rows_per_warp((long long)B * H, T), (int)wc, es, on_chip);
  return on_chip ? 0 : (long long)B * H * T * (2 * wc + 1) * es;
}

}  // namespace

extern "C" {

// The launch's arguments as one block of bytes: one foreign-call argument
// costs the host a fraction of two dozen.
struct BandArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* valid;
  void* out;
  void* stream;
  void* scratch;                 // past the tiled kernel: avdd_band_attention_scratch bytes
  int* route;                    // set to the ROUTE_* the launch took
  long long strides[12];         // q, k, v, out: (batch, head, row), in elements
  int B, H, T, D, w, dtype;
};

// Bytes of scratch a launch at this shape takes (0: none).
long long avdd_band_attention_scratch(int B, int H, int T, int D, int w, int dtype) {
  const int es = dtype == 0 ? 4 : 2;
  if (B <= 0 || H <= 0 || T <= 0 || w < 0 || route_of(D, es, w) == ROUTE_TILED) return 0;
  return scratch_bytes(B, H, T, D, w, es);
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// q, k, v, out: (B, H, T, D) through element strides (batch, head, row), the
// D values of a row contiguous, every row 16-byte aligned (the stride of a
// dimension of size 1 is never used); valid: (B, T) bool, contiguous. D x
// element size a multiple of 16 bytes, D at most 512; any w >= 0 (route_of);
// scratch: avdd_band_attention_scratch bytes; dtype: 0 float32, 1 bfloat16.
int avdd_band_attention(const BandArgs* a) {
  const int B = a->B, H = a->H, T = a->T, D = a->D, w = a->w, dtype = a->dtype;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const long long es = dtype == 0 ? 4 : 2;
  const long long row = D * es;
  if (B <= 0 || H <= 0 || T <= 0 || w < 0 || D > 512 || row % 16)
    return (int)cudaErrorInvalidValue;
  const int route = route_of(D, (int)es, w);
  // in elements; a stride steps a dimension only where its size exceeds 1
  long long el[4][3];
  Strides st[4];                                   // in bytes
  for (int i = 0; i < 4; ++i) {
    const long long* e = a->strides + 3 * i;
    el[i][0] = B > 1 ? e[0] : 0;
    el[i][1] = H > 1 ? e[1] : 0;
    el[i][2] = T > 1 ? e[2] : 0;
    st[i] = {el[i][0] * es, el[i][1] * es, el[i][2] * es};
    if ((st[i].b | st[i].h | st[i].t) % 16) return (int)cudaErrorInvalidValue;
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a->q) | reinterpret_cast<uintptr_t>(a->k) |
                         reinterpret_cast<uintptr_t>(a->v) | reinterpret_cast<uintptr_t>(a->out);
  if (addr % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const int wc = w < T ? w : T - 1;                // the band capped at the sequence
  *a->route = route;
  if (route == ROUTE_F32_WGMMA) {                  // K1's f32 attention on the operands
    if (!a->scratch) return (int)cudaErrorInvalidValue;
    avdd_k1::BandParams p{};
    p.mask = static_cast<const uint8_t*>(a->valid);
    p.B = B;
    p.T = T;
    p.C = H * D;
    p.D = D;
    p.w = wc;
    p.io = {a->q, a->k, a->v, a->out,
            {el[0][0], el[0][1], el[0][2]}, {el[1][0], el[1][1], el[1][2]},
            {el[2][0], el[2][1], el[2][2]}, {el[3][0], el[3][1], el[3][2]}};
    return avdd_k1::launch_band_f32(p, static_cast<float*>(a->scratch), s);
  }
  if (route != ROUTE_TILED) {
    RowsParams p;
    p.q = static_cast<const char*>(a->q);
    p.k = static_cast<const char*>(a->k);
    p.v = static_cast<const char*>(a->v);
    p.valid = static_cast<const uint8_t*>(a->valid);
    p.out = static_cast<char*>(a->out);
    p.sq = st[0];
    p.sk = st[1];
    p.sv = st[2];
    p.so = st[3];
    p.s = nullptr;
    p.H = H;
    p.T = T;
    p.w = wc;
    p.chunks = (int)(row / 16);
    const long long bh = (long long)B * H;
    return dtype == 0 ? launch_rows_for<float>(p, a->scratch, bh, s)
                      : launch_rows_for<__nv_bfloat16>(p, a->scratch, bh, s);
  }
  Params p;
  p.q = static_cast<const char*>(a->q);
  p.k = static_cast<const char*>(a->k);
  p.v = static_cast<const char*>(a->v);
  p.valid = static_cast<const uint8_t*>(a->valid);
  p.out = static_cast<char*>(a->out);
  p.sq = st[0];
  p.sk = st[1];
  p.sv = st[2];
  p.so = st[3];
  p.H = H;
  p.T = T;
  p.tiles = (T + ROWS - 1) / ROWS;
  p.chunks = (int)(row / 16);
  int lanes = 8;                                   // lanes a head: a power of 2, >= chunks
  while (lanes < p.chunks) lanes *= 2;
  p.slabs = (H + 32 / lanes - 1) / (32 / lanes);
  p.by_tiles = FastDiv(p.tiles);
  p.by_slabs = FastDiv(p.slabs);
  const long long n = (long long)B * p.tiles * p.slabs;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.n = (int)n;
  return dtype == 0 ? launch<float>(p, w, lanes, s) : launch<__nv_bfloat16>(p, w, lanes, s);
}

}  // extern "C"
