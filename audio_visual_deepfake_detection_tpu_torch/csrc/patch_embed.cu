// MViT patch embed for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel audio_visual_deepfake_detection_tpu/ops/pallas/
// patch_embed.py::fused_patch_embed (pl.pallas_call at :169), K2: the Conv3d
// kernel (3,15,15), stride (1,12,12), padding (1,3,3) of 96x96x3 frames into
// an 8x8 grid of F-wide tokens per frame, as an implicit GEMM: M = B T 64
// tokens, N = F features, K = 3 x 15 x 15 x 3 = 2025 taps.
//
// Frames arrive as uint8 (the raw chunks: the kernel forms float(u) times
// 1/255 in f32, the same multiply as the pipelines' normalisation) or as f32
// frames in [0, 1]. Numerics (patch_embed_math): the frames are rounded to
// the compute dtype, all 2025 taps accumulate in f32 (exact products of
// compute-dtype values), the sum is rounded once and the bias, rounded too,
// is added in the compute dtype.
//
// What bounds it on this card: 2 x 2025 operations per output value against
// 3 bytes of uint8 frame per token; at 32 chunks of 512 frames 408 GFLOP
// against 0.45 GB in and 0.2 GB out: operations, 0.41 ms at the bf16 tensor
// peak. So the bf16 products run on wgmma (patch_embed_wgmma_kernel), fed
// from frames staged once in shared memory and weights streamed from L2
// once per pair of output frames. float32 stays an FMA kernel at full
// precision (patch_embed_kernel): it is not on the main path. The TPU's
// lane-group relayout and 0/1 row-select matmuls (patch_embed.py:12-32)
// existed because Mosaic has no strided access; they are not carried over.

#include "wgmma.cuh"

namespace {

using namespace avdd;

constexpr int KT = 3, KH = 15, KW = 15, CIN = 3;
constexpr int SH = 12, SW = 12, PT = 1, PH = 3, PW = 3;
constexpr int HIN = 96, WIN = 96, OH = 8, OW = 8;
constexpr int FRAME = HIN * WIN * CIN;          // values of a frame
constexpr float INV255 = 1.0f / 255.0f;         // np.float32(1 / 255)

template <typename In> struct Frame;
template <> struct Frame<float> {
  __device__ __forceinline__ static float load(const float* p, size_t i) { return __ldg(p + i); }
};
template <> struct Frame<uint8_t> {
  __device__ __forceinline__ static float load(const uint8_t* p, size_t i) {
    return (float)__ldg(p + i) * INV255;
  }
};

// ---- float32: FMA ---------------------------------------------------------
// One block per (sample, frame, two output rows): the input window (3 frames
// x 27 rows x 99 columns x 3 channels, zero padded) is staged once in shared
// memory, so no unfold tensor exists; each thread owns one feature and 8
// tokens, so every weight it loads (coalesced across features) feeds 8 FMAs.
constexpr int ROWS = 2;                          // output rows per block
constexpr int WROWS = (ROWS - 1) * SH + KH;      // 27 input rows
constexpr int WCOLS = (OW - 1) * SW + KW;        // 99 input columns
constexpr int WIN_FLOATS = KT * WROWS * WCOLS * CIN;
constexpr int TOK = OW / 2;                      // tokens per row per thread
constexpr int MAXF = 128;

// video (B, T, 96, 96, 3); w (2025, F) tap-major f32; bias (F,) f32; out (B,
// T, 8, 8, F) f32. Block: 2 x FP threads (FP = F rounded up to a warp);
// thread (g, f) owns feature f and columns g, g + 2, ...
template <typename In>
__global__ void patch_embed_kernel(const In* __restrict__ video, const float* __restrict__ w,
                                   const float* __restrict__ bias, float* out,
                                   int Tn, int F, int FP) {
  extern __shared__ __align__(16) float win[];   // [KT][WROWS][WCOLS][CIN]
  const int oh0 = blockIdx.x * ROWS, t = blockIdx.y, b = blockIdx.z;
  const In* vb = video + (size_t)b * Tn * FRAME;
  for (int idx = threadIdx.x; idx < WIN_FLOATS; idx += blockDim.x) {
    const int c = idx % CIN;
    int rest = idx / CIN;
    const int col = rest % WCOLS;
    rest /= WCOLS;
    const int row = rest % WROWS, kt = rest / WROWS;
    const int tt = t + kt - PT, hh = oh0 * SH - PH + row, ww = col - PW;
    float v = 0.f;
    if (tt >= 0 && tt < Tn && hh >= 0 && hh < HIN && ww >= 0 && ww < WIN)
      v = Frame<In>::load(vb, (((size_t)tt * HIN + hh) * WIN + ww) * CIN + c);
    win[idx] = v;
  }
  __syncthreads();
  const int f = threadIdx.x % FP, g = threadIdx.x / FP;
  if (f >= F) return;
  float acc[ROWS][TOK];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < TOK; ++i) acc[r][i] = 0.f;
  int tap = 0;
  for (int kt = 0; kt < KT; ++kt) {
    for (int kh = 0; kh < KH; ++kh) {
      const float* rowp[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        rowp[r] = win + ((kt * WROWS + r * SH + kh) * WCOLS + g * SW) * CIN;
      for (int kwc = 0; kwc < KW * CIN; ++kwc, ++tap) {
        const float wv = __ldg(w + (size_t)tap * F + f);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int i = 0; i < TOK; ++i)
            acc[r][i] = fmaf(rowp[r][2 * i * SW * CIN + kwc], wv, acc[r][i]);
      }
    }
  }
  const float bf = bias[f];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < TOK; ++i) {
      const int oh = oh0 + r, ow = g + 2 * i;
      out[((((size_t)b * Tn + t) * OH + oh) * OW + ow) * F + f] = acc[r][i] + bf;
    }
}

// ---- bf16 on wgmma ----------------------------------------------------------
// K is ordered (kt, kh, pos): each (kt, kh) is a run of JP = 48 positions,
// position 1 + 3 kw + c holding tap (kw, c) and positions 0, 46, 47 zero
// weights. A staged frame row keeps pixel 0 at element SOFF = 16 (so that
// cp.async writes 16-byte pieces) with zeros on both sides, and then token
// ow's position 0 sits at element 36 ow + 6: every pair of adjacent k an A
// fragment takes starts on an even element, one aligned load.
//
// A persistent block (one per SM) of two warpgroups walks a contiguous run
// of output-frame pairs (sample-major). Warpgroup w computes frame t0 + w of
// a pair as one m64 x nWN tile (the frame's 64 tokens x the features, WN =
// 96, or 128 for F > 96; features past F are zero weights), k running over
// 45 (kt, kh) runs of three k16 products. The steps of phase kt of a pair
// read input frame t0 + w + kt - 1, so the three phases of a pair read four
// frames and consecutive phases share one; frames live in NSLOT slots of
// shared memory and each is fetched once per run within a sample. With three
// slots it is fetched by cp.async a phase ahead into the slot the last phase
// left (a frame the block has not fetched ahead, at the start of a run or of
// a sample, is fetched and waited for); with two (bf16 frames at WN = 128,
// where a third leaves no room) each phase fetches its new frame and waits.
// The weights stream through a ring of WS stages of RUNS (kt, kh) runs each
// (WN features x 48 positions in rows of 128 bytes, 128B-swizzled; three runs
// a stage for uint8 frames at WN = 96, else one, as what fits), WS - 2 steps
// ahead, so one step's products run while the next step's A fragments are
// read from the staged frames (uint8 pairs widened, scaled by 1/255 and
// rounded on the way).
constexpr int JP = 48;                           // positions of a (kt, kh) run
constexpr int NRUN = KT * KH;                    // (kt, kh) runs of an output frame
constexpr int SROWS = PH + HIN;                  // staged rows: 3 zero rows + 96
constexpr int SLEN = 320;                        // elements of a staged row
constexpr int SOFF = 16;                         // element of pixel 0 in a staged row
constexpr int PNT = 256;

// uint8 WN 96: 3 runs a stage, 3 slots; bf16 WN 96 and uint8 WN 128: 1 run,
// 3 slots; bf16 WN 128: 1 run, 2 slots
template <typename E, int WN> struct PeCfg {
  static constexpr int WTILE = WN * 128;                        // a run's weight tile, bytes
  static constexpr int SLOT = SROWS * SLEN * (int)sizeof(E);    // uint8 31,680; bf16 63,360
  static constexpr int WS = 3;                                  // weight stages
  static constexpr int RUNS =                                   // (kt, kh) runs a weight stage
      sizeof(E) == 1 && 1024 + WS * 3 * WTILE + 3 * SLOT <= SMEM_MAX ? 3 : 1;
  static constexpr int NSLOT = 1024 + WS * RUNS * WTILE + 3 * SLOT <= SMEM_MAX ? 3 : 2;
  static constexpr int SMEM = 1024 + WS * RUNS * WTILE + NSLOT * SLOT;
};

// Two adjacent staged values as the bf16 pair of an A fragment.
__device__ __forceinline__ uint32_t frame_pair(const __nv_bfloat16* p) { return ld_pair(p); }
__device__ __forceinline__ uint32_t frame_pair(const uint8_t* p) {
  const uint32_t v = *reinterpret_cast<const uint16_t*>(p);
  // 2^23 + u as a float, minus 2^23: u exactly, then the pipeline's multiply
  const float lo = __uint_as_float(0x4B000000u | (v & 0xFFu)) - 8388608.f;
  const float hi = __uint_as_float(0x4B000000u | (v >> 8)) - 8388608.f;
  return pack_bf16(lo * INV255, hi * INV255);
}

// video (B, T, 96, 96, 3) uint8 or bf16; w (45, WN, 48) bf16; bias (F,) f32;
// out (B, T, 8, 8, F) bf16.
template <typename E, int WN>
__global__ void __launch_bounds__(PNT, 1)
patch_embed_wgmma_kernel(const E* __restrict__ video, const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias, __nv_bfloat16* out, int B, int Tn,
                         int F) {
  using N = Num<__nv_bfloat16>;
  using C = PeCfg<E, WN>;
  constexpr int SLOT = C::SLOT, RUNS = C::RUNS, WS = C::WS, WTILE = C::WTILE, NSLOT = C::NSLOT;
  constexpr int AHEAD = WS - 2, SPP = KH / RUNS, STAGE = RUNS * WTILE;   // SPP: steps a phase
  extern __shared__ __align__(16) unsigned char smraw[];
  const uint32_t raw = smem_u32(smraw), ring = (raw + 1023u) & ~1023u;
  unsigned char* slot_base = smraw + (ring - raw) + WS * STAGE;
  const uint32_t slot_u32 = ring + WS * STAGE;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int pps = (Tn + 1) / 2, kstride = Tn + 2;
  const long long npair = (long long)B * pps;
  const long long p_lo = npair * blockIdx.x / gridDim.x;
  const long long p_hi = npair * (blockIdx.x + 1) / gridDim.x;
  const int nphase = 3 * (int)(p_hi - p_lo), nsteps = SPP * nphase;

  {   // the zero rows and side pads of the three slots, once
    constexpr int RB = SLEN * (int)sizeof(E) / 16, PB = SOFF * (int)sizeof(E) / 16;
    uint4* s4 = reinterpret_cast<uint4*>(slot_base);
    for (int idx = tid; idx < NSLOT * SROWS * RB; idx += PNT) {
      const int r = idx / RB % SROWS, c = idx % RB;
      if (r < PH || c < PB || c >= RB - PB) s4[idx] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  auto load_w = [&](int s) {     // step s -> runs RUNS (s % (45 / RUNS)) on, stage s % WS
    if (s < nsteps) {
      const uint32_t dst = ring + (s % WS) * STAGE;
      const __nv_bfloat16* src = w + (size_t)(s % (NRUN / RUNS)) * RUNS * WN * JP;
      for (int idx = tid; idx < RUNS * WN * JP / 8; idx += PNT) {
        const int r = idx / (JP / 8), c = idx % (JP / 8);
        cp_async16_to(dst + swz(r, c), src + r * JP + 8 * c, 16);
      }
    }
  };
  // frame key of warpgroup w_ in phase q of this block: b (T + 2) + frame + 1
  auto frame_key = [&](int q, int w_) {
    const long long pp = p_lo + q / 3;
    return (int)(pp / pps) * kstride + 2 * (int)(pp % pps) + w_ + q % 3;
  };
  int key0 = -1, key1 = -1, key2 = -1;          // the frame each slot holds or is receiving
  auto resident = [&](int k) { return key0 == k || key1 == k || key2 == k; };
  auto slot_of = [&](int k) { return key0 == k ? 0 : key1 == k ? 1 : 2; };
  auto victim = [&](int a, int b_, int c) {     // a slot holding none of a, b_, c
    return (key0 != a && key0 != b_ && key0 != c) ? 0
         : (key1 != a && key1 != b_ && key1 != c) ? 1
         : (NSLOT > 2 && key2 != a && key2 != b_ && key2 != c) ? 2 : -1;
  };
  auto load_frame = [&](int slot, int k) {
    (slot == 0 ? key0 : slot == 1 ? key1 : key2) = k;
    const int b = k / kstride, f = k % kstride - 1;
    const bool ok = f >= 0 && f < Tn;            // frames past either end: zeros
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        video + ((size_t)b * Tn + (ok ? f : 0)) * FRAME);
    constexpr int RCH = WIN * CIN * (int)sizeof(E) / 16;   // 16-byte pieces of a row
    const uint32_t dst = slot_u32 + slot * SLOT + (PH * SLEN + SOFF) * (int)sizeof(E);
    for (int idx = tid; idx < HIN * RCH; idx += PNT) {
      const int h = idx / RCH, c = idx % RCH;
      cp_async16_to(dst + h * SLEN * (int)sizeof(E) + 16 * c, src + (size_t)h * RCH * 16 + 16 * c,
                    ok ? 16 : 0);
    }
  };
  // at the start of phase q: fetch what it needs and has not been fetched
  // (returns true: wait for it), and one phase ahead what fits
  auto phase_frames = [&](int q) {
    const int a = frame_key(q, 0), c = frame_key(q, 1);
    bool wait = false;
    if (!resident(a)) { load_frame(victim(a, c, c), a); wait = true; }
    if (!resident(c)) { load_frame(victim(a, c, c), c); wait = true; }
    if (q + 1 < nphase) {
      const int na = frame_key(q + 1, 0), nc = frame_key(q + 1, 1);
      if (!resident(na)) {
        const int v = victim(a, c, nc);
        if (v >= 0) load_frame(v, na);
      }
      if (!resident(nc)) {
        const int v = victim(a, c, na);
        if (v >= 0) load_frame(v, nc);
      }
    }
    return wait;
  };

  // this thread's A rows: tokens 16 warp + g (oh 2 warp, ow g) and + 8 (oh + 1)
  const int foff = 2 * warp * SH * SLEN + g * SW * CIN + SOFF - PW * CIN - 1 + 2 * tq;
  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  uint32_t af[2][3 * RUNS][4];
  int slot = 0;

#pragma unroll
  for (int j = 0; j < AHEAD; ++j) {
    load_w(j);
    cp_commit();
  }
  __syncthreads();   // the pads are written

  auto step = [&](auto buf, int s) {
    constexpr int I = decltype(buf)::value;
    cp_wait<WS - 3>();            // this thread's copies of step s (and its frames) have landed
    fence_async_shared();
    __syncthreads();              // everyone's have; step s - 2 is consumed
    const int q = s / SPP, kh = s % SPP * RUNS;      // the step's first run: (q % 3, kh)
    const bool wait = kh == 0 && phase_frames(q);
    load_w(s + AHEAD);            // into the stage step s - 2 left
    cp_commit();
    if (wait) {
      cp_wait<0>();
      __syncthreads();
    }
    if (kh == 0) slot = slot_of(frame_key(q, wg));
    const E* s0 = reinterpret_cast<const E*>(slot_base) + slot * (SLOT / (int)sizeof(E)) + foff +
                  kh * SLEN;
    const E* s1 = s0 + SH * SLEN;
#pragma unroll
    for (int k = 0; k < 3 * RUNS; ++k) {     // run k / 3: the next staged row
      const E* a0 = s0 + k / 3 * SLEN + 16 * (k % 3), * a1 = s1 + k / 3 * SLEN + 16 * (k % 3);
      af[I][k][0] = frame_pair(a0);
      af[I][k][1] = frame_pair(a1);
      af[I][k][2] = frame_pair(a0 + 8);
      af[I][k][3] = frame_pair(a1 + 8);
    }
    fence_regs(acc);
    wgmma_fence();
    const uint32_t wt = ring + (s % WS) * STAGE;
#pragma unroll
    for (int k = 0; k < 3 * RUNS; ++k)
      WgmmaRS<WN, 0>::run(acc, af[I][k], tile_desc(wt + k / 3 * WTILE + 32 * (k % 3)), 1);
    wgmma_commit();
    if (kh + RUNS < KH || q % 3 < 2) {
      wgmma_wait<1>();            // step s - 1 is done; step s runs on
      return;
    }
    // the pair's last step: its frame out, bias added in bf16
    wgmma_wait<0>();
    fence_regs(acc);
    const long long pp = p_lo + q / 3;
    const int b = (int)(pp / pps), t = 2 * (int)(pp % pps) + wg;
    if (t < Tn) {
      __nv_bfloat16* o = out + ((size_t)b * Tn + t) * (OH * OW) * F;
#pragma unroll
      for (int jj = 0; jj < WN / 8; ++jj) {
        const int f = 8 * jj + 2 * tq;
        if (f >= F) continue;
        const bool two = f + 1 < F;      // an odd F's last feature stands alone
        const float b0 = N::rnd(bias[f]), b1 = two ? N::rnd(bias[f + 1]) : 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const size_t i = (size_t)(16 * warp + g + 8 * hf) * F + f;
          const float y0 = N::rnd(N::rnd(acc[4 * jj + 2 * hf]) + b0);
          const float y1 = N::rnd(N::rnd(acc[4 * jj + 2 * hf + 1]) + b1);
          if (F % 2 == 0) {
            N::store2(o, i, y0, y1);
          } else {
            N::store(o, i, y0);
            if (two) N::store(o, i + 1, y1);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  };
  for (int s = 0; s < nsteps; s += 2) {
    step(std::integral_constant<int, 0>{}, s);
    if (s + 1 < nsteps) step(std::integral_constant<int, 1>{}, s + 1);
  }
  wgmma_wait<0>();
  cp_wait<0>();
}

// f32 frames -> bf16 frames (round to nearest even), four values a thread
// and pass, for the wgmma kernel's staged-frame layout.
__global__ void frames_bf16_kernel(const float4* __restrict__ in, uint2* __restrict__ out,
                                   size_t n4) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = in[i];
    out[i] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

template <typename E, int WN>
int launch_wgmma_n(const E* video, const __nv_bfloat16* w, const float* bias,
                   __nv_bfloat16* out, int B, int Tn, int F, cudaStream_t stream) {
  static int configured = 0;
  constexpr int bytes = PeCfg<E, WN>::SMEM;
  static_assert(bytes <= SMEM_MAX, "patch embed stages fit in shared memory");
  if (int e = set_smem(patch_embed_wgmma_kernel<E, WN>, bytes, configured)) return e;
  const long long npair = (long long)B * ((Tn + 1) / 2);
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (int)(npair < sms ? npair : sms);
  patch_embed_wgmma_kernel<E, WN><<<grid, PNT, bytes, stream>>>(video, w, bias, out, B, Tn, F);
  return (int)cudaGetLastError();
}

// the product width pack_weight laid the weights out for
template <typename E>
int launch_wgmma(const E* video, const __nv_bfloat16* w, const float* bias,
                 __nv_bfloat16* out, int B, int Tn, int F, cudaStream_t stream) {
  return F <= 96 ? launch_wgmma_n<E, 96>(video, w, bias, out, B, Tn, F, stream)
                 : launch_wgmma_n<E, 128>(video, w, bias, out, B, Tn, F, stream);
}

template <typename In>
int launch_fma(const In* video, const float* w, const float* bias, float* out,
               int B, int Tn, int F, cudaStream_t stream) {
  static int configured = 0;
  if (int e = set_smem(patch_embed_kernel<In>, 4 * WIN_FLOATS, configured)) return e;
  const int fp = (F + 31) / 32 * 32;
  patch_embed_kernel<In><<<dim3(OH / ROWS, Tn, B), 2 * fp, 4 * WIN_FLOATS, stream>>>(
      video, w, bias, out, Tn, F, fp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// video (B, T, 96, 96, 3): uint8 when in_u8, else float32; bias (F,) f32.
// dtype 0: float32 out, w (2025, F) tap-major f32. dtype 1: bfloat16 out, w
// (45, N, 48) bf16 with N = 96 for F <= 96, else 128 (pack_weight). F <= 128
// either way. float32
// frames are first rounded into `scratch` (B T 96 96 3 bf16; unused for
// uint8). The wgmma kernel's copies need video (or scratch) on 16 bytes.
int avdd_patch_embed(const void* video, const void* w, const void* bias, void* out,
                     void* scratch, int B, int T, int F, int dtype, int in_u8, void* stream) {
  if (B <= 0 || T <= 0 || F <= 0 || T > 65535 || dtype < 0 || dtype > 1 ||
      F > MAXF)
    return (int)cudaErrorInvalidValue;
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* wf = static_cast<const float*>(w);
    float* o = static_cast<float*>(out);
    return in_u8 ? launch_fma(static_cast<const uint8_t*>(video), wf, bf, o, B, T, F, s)
                 : launch_fma(static_cast<const float*>(video), wf, bf, o, B, T, F, s);
  }
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (in_u8) {
    if ((uintptr_t)video % 16) return (int)cudaErrorInvalidValue;
    return launch_wgmma(static_cast<const uint8_t*>(video), wb, bf, o, B, T, F, s);
  }
  if (!scratch || (uintptr_t)scratch % 16 || (uintptr_t)video % 16)
    return (int)cudaErrorInvalidValue;
  const size_t n4 = (size_t)B * T * FRAME / 4;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  frames_bf16_kernel<<<8 * sms, 256, 0, s>>>(static_cast<const float4*>(video),
                                              static_cast<uint2*>(scratch), n4);
  if (int e = (int)cudaGetLastError()) return e;
  return launch_wgmma(static_cast<const __nv_bfloat16*>(scratch), wb, bf, o, B, T, F, s);
}

}  // extern "C"
