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
// carried over. The rest of the Pallas kernel's domain, half windows above
// MAX_W and head rows over 512 bytes (head widths up to 512), runs
// band_any_kernel below, a simple design: a warp a row, the offsets
// streamed in order.

#include "common.cuh"

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

// Every other window and head width of the domain: half windows above
// MAX_W and head rows of whole 16-byte pieces up to ANY_ROW bytes. A warp
// a query row of one (sample, head), its lane l the row's 16-byte pieces
// l, l + 32, ..; the offsets stream in order, three passes over them (the
// row maximum, the sum of the exps, the context), each recomputing a
// score from the k row (read through L1, which the neighbouring rows'
// warps share) and summing it over the warp. No score is kept, so nothing
// limits w. The arithmetic and its order are band_attention_plain's, in
// the input dtype: products, score, penalty, s - max, exp, the running sum
// of the exps, the quotient (a division, as the plain version's), the
// products with v and the running context each rounded where it rounds
// them; offsets outside the sequence are skipped (their exp is exactly 0).
constexpr int ANY_PIECES = 4;                      // 16-byte pieces a lane holds
constexpr int ANY_ROW = 32 * ANY_PIECES * 16;      // bytes of the widest head row

template <typename T>
__global__ void __launch_bounds__(NT) band_any_kernel(const Params p, int w, long long rows) {
  using V = Vec<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long id = (long long)blockIdx.x * NW + warp;    // (b, h, i), i fastest
  if (id >= rows) return;
  const int i = (int)(id % p.T);
  const long long bh = id / p.T;
  const int h = (int)(bh % p.H), b = (int)(bh / p.H);
  const char* kb = p.k + b * p.sk.b + h * p.sk.h;
  const char* vb = p.v + b * p.sv.b + h * p.sv.h;
  const char* qr = p.q + b * p.sq.b + h * p.sq.h + i * p.sq.t;
  uint4 q[ANY_PIECES];
#pragma unroll
  for (int j = 0; j < ANY_PIECES; ++j) {
    const int c = lane + 32 * j;
    q[j] = c < p.chunks ? ldg16(qr + 16 * c) : make_uint4(0u, 0u, 0u, 0u);
  }
  const uint8_t* mrow = p.valid + (size_t)b * p.T;
  const int lo = max(-w, -i), hi = min(w, p.T - 1 - i);
  const float pen = V::rnd(PENALTY);
  auto score = [&](int d) {
    const char* kr = kb + (i + d) * p.sk.t;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < ANY_PIECES; ++j) {
      const int c = lane + 32 * j;
      if (c < p.chunks) s += V::dot(q[j], ldg16(kr + 16 * c));
    }
    s = V::rnd(warp_sum(s));
    return mrow[i + d] ? s : V::rnd(s + pen);
  };
  float mx = -CUDART_INF_F;
  for (int d = lo; d <= hi; ++d) mx = fmaxf(mx, score(d));
  float den = 0.f;
  for (int d = lo; d <= hi; ++d) {
    const float e = V::rnd(expf(V::rnd(score(d) - mx)));
    den = d == lo ? e : V::rnd(den + e);
  }
  uint4 acc[ANY_PIECES];
#pragma unroll
  for (int j = 0; j < ANY_PIECES; ++j) acc[j] = make_uint4(0u, 0u, 0u, 0u);
  for (int d = lo; d <= hi; ++d) {
    const float e = V::rnd(expf(V::rnd(score(d) - mx)));
    const float pq = e / den;                      // rounded to the dtype by axpy
    const char* vr = vb + (i + d) * p.sv.t;
#pragma unroll
    for (int j = 0; j < ANY_PIECES; ++j) {
      const int c = lane + 32 * j;
      if (c < p.chunks) V::axpy(acc[j], pq, ldg16(vr + 16 * c));
    }
  }
  char* orow = p.out + b * p.so.b + h * p.so.h + i * p.so.t;
  const bool own = mrow[i] != 0;                   // own key slot masked: zero
#pragma unroll
  for (int j = 0; j < ANY_PIECES; ++j) {
    const int c = lane + 32 * j;
    if (c < p.chunks)
      *reinterpret_cast<uint4*>(orow + 16 * c) = own ? acc[j] : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T>
int launch_any(const Params& p, int w, long long rows, cudaStream_t stream) {
  const long long blocks = (rows + NW - 1) / NW;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  band_any_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(p, w, rows);
  return (int)cudaGetLastError();
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
  long long strides[12];         // q, k, v, out: (batch, head, row), in elements
  int B, H, T, D, w, dtype;
};

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// q, k, v, out: (B, H, T, D) through element strides (batch, head, row), the
// D values of a row contiguous, every row 16-byte aligned (the stride of a
// dimension of size 1 is never used); valid: (B, T) bool, contiguous. D x
// element size a multiple of 16 bytes, D at most 512 (rows up to ANY_ROW
// bytes); any w >= 0 (the tiled kernel up to MAX_W and rows of
// 512 bytes, band_any_kernel beyond); dtype: 0 float32, 1 bfloat16.
int avdd_band_attention(const BandArgs* a) {
  const int B = a->B, H = a->H, T = a->T, D = a->D, w = a->w, dtype = a->dtype;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const long long es = dtype == 0 ? 4 : 2;
  const long long row = D * es;
  if (B <= 0 || H <= 0 || T <= 0 || w < 0 || D > 512 || row % 16 || row > ANY_ROW)
    return (int)cudaErrorInvalidValue;
  const bool tiled = w <= MAX_W && row <= SLAB;    // else band_any_kernel
  // in bytes; a stride steps a dimension only where its size exceeds 1
  Strides st[4];
  for (int i = 0; i < 4; ++i) {
    const long long* e = a->strides + 3 * i;
    st[i] = {B > 1 ? e[0] * es : 0, H > 1 ? e[1] * es : 0, T > 1 ? e[2] * es : 0};
    if ((st[i].b | st[i].h | st[i].t) % 16) return (int)cudaErrorInvalidValue;
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a->q) | reinterpret_cast<uintptr_t>(a->k) |
                         reinterpret_cast<uintptr_t>(a->v) | reinterpret_cast<uintptr_t>(a->out);
  if (addr % 16) return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  if (!tiled) {
    const long long rows = (long long)B * H * T;
    return dtype == 0 ? launch_any<float>(p, w, rows, s)
                      : launch_any<__nv_bfloat16>(p, w, rows, s);
  }
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
