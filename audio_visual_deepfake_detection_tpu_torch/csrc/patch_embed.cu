// MViT patch embed for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel audio_visual_deepfake_detection_tpu/ops/pallas/
// patch_embed.py::fused_patch_embed (pl.pallas_call at :169), K2: the Conv3d
// kernel (3,15,15), stride (1,12,12), padding (1,3,3) of 96x96x3 frames into
// an 8x8 grid of F-wide tokens per frame, as an implicit GEMM: M = B T 64
// tokens, N = F features, K = 3 x 15 x 15 x 3 = 2025 taps.
//
// Numerics (patch_embed_math): the f32 frames are rounded to the compute
// dtype, all 2025 taps accumulate in f32 (exact products of compute-dtype
// values), the sum is rounded once and the bias, rounded too, is added in
// the compute dtype.
//
// What bounds it on this card: 2 x 2025 FLOP per output against ~15 bytes
// of frame input per token; compute-bound (12.7 GFLOP per 512-frame chunk
// at F = 96) until the products run on the tensor cores (bf16 below), then
// the weight stream from L2 (the packed weights, 415 KB, once per block).
//
// What it does about it, f32 (FMA): one block per (sample, frame, two output rows):
// the input window (3 frames x 27 rows x 99 columns x 3 channels, zero
// padded, rounded to the compute dtype) is staged once in shared memory,
// so no unfold tensor exists; each thread owns one feature and 8 tokens,
// so every weight it loads (coalesced across features) feeds 8 FMAs. The
// TPU's lane-group relayout and 0/1 row-select matmuls (patch_embed.py:12-32)
// existed because Mosaic has no strided access; they are not carried over.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KT = 3, KH = 15, KW = 15, CIN = 3;
constexpr int SH = 12, SW = 12, PT = 1, PH = 3, PW = 3;
constexpr int HIN = 96, WIN = 96, OH = 8, OW = 8;
constexpr int ROWS = 2;                          // output rows per block
constexpr int WROWS = (ROWS - 1) * SH + KH;      // 27 input rows
constexpr int WCOLS = (OW - 1) * SW + KW;        // 99 input columns
constexpr int WIN_FLOATS = KT * WROWS * WCOLS * CIN;
constexpr int TOK = OW / 2;                      // tokens per row per thread
constexpr int MAXF = 128;

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ __forceinline__ static float load(const float* p, size_t i) { return __ldg(p + i); }
  __device__ __forceinline__ static float rnd(float v) { return v; }
  __device__ __forceinline__ static void store(float* p, size_t i, float v) { p[i] = v; }
};
template <> struct Num<__nv_bfloat16> {
  __device__ __forceinline__ static float load(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
  }
  __device__ __forceinline__ static float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, size_t i, float v) {
    p[i] = __float2bfloat16_rn(v);
  }
};

// video (B, T, 96, 96, 3) f32; w (2025, F) tap-major in the compute dtype;
// bias (F,) f32; out (B, T, 8, 8, F). Block: 2 x FP threads (FP = F rounded
// up to a warp); thread (g, f) owns feature f and columns g, g + 2, ...
template <typename T>
__global__ void patch_embed_kernel(const float* __restrict__ video,
                                   const T* __restrict__ w,
                                   const float* __restrict__ bias, T* out,
                                   int Tn, int F, int FP) {
  using N = Num<T>;
  extern __shared__ __align__(16) float win[];   // [KT][WROWS][WCOLS][CIN]
  const int oh0 = blockIdx.x * ROWS, t = blockIdx.y, b = blockIdx.z;
  const float* vb = video + (size_t)b * Tn * HIN * WIN * CIN;
  for (int idx = threadIdx.x; idx < WIN_FLOATS; idx += blockDim.x) {
    const int c = idx % CIN;
    int rest = idx / CIN;
    const int col = rest % WCOLS;
    rest /= WCOLS;
    const int row = rest % WROWS, kt = rest / WROWS;
    const int tt = t + kt - PT, hh = oh0 * SH - PH + row, ww = col - PW;
    float v = 0.f;
    if (tt >= 0 && tt < Tn && hh >= 0 && hh < HIN && ww >= 0 && ww < WIN)
      v = N::rnd(vb[(((size_t)tt * HIN + hh) * WIN + ww) * CIN + c]);
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
        const float wv = N::load(w, (size_t)tap * F + f);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int i = 0; i < TOK; ++i)
            acc[r][i] = fmaf(rowp[r][2 * i * SW * CIN + kwc], wv, acc[r][i]);
      }
    }
  }
  const float bf = N::rnd(bias[f]);
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < TOK; ++i) {
      const int oh = oh0 + r, ow = g + 2 * i;
      N::store(out, ((((size_t)b * Tn + t) * OH + oh) * OW + ow) * F + f,
               N::rnd(N::rnd(acc[r][i]) + bf));
    }
}

// bf16 on the tensor cores: the same implicit GEMM with mma.sync m16n8k16
// (f32 accumulate; products of bf16 values are exact, so only the summation
// order differs from the FMA kernel). K is ordered (kt, kh, kw * 3 + c) with
// each 45-wide (kw, c) run padded to 48 (zero weights), so an A fragment's
// pairs are adjacent in a window row. One block per (sample, frame, 4 output
// rows): the bf16 window (3 frames x 51 rows x 304) in shared memory, warp w
// owning 16 tokens (2 rows) and n8 feature tiles w / 2, w / 2 + 4, ...;
// B fragments come straight from the packed (F, 2160) weights in L2.
constexpr int MROWS = 4;                          // output rows per block
constexpr int MWROWS = (MROWS - 1) * SH + KH;     // 51 window rows
constexpr int RLEN = 304;                         // bf16 per window row (>= 297 + 3)
constexpr int JP = 48;                            // padded kw * 3 + c run
constexpr int KP = KT * KH * JP;                  // 2160
constexpr int MWIN = KT * MWROWS * RLEN;

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(256)
patch_embed_mma_kernel(const float* __restrict__ video, const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias, __nv_bfloat16* out, int Tn, int F) {
  using N = Num<__nv_bfloat16>;
  extern __shared__ __align__(16) __nv_bfloat16 wnd[];   // [KT][MWROWS][RLEN]
  const int oh0 = blockIdx.x * MROWS, t = blockIdx.y, b = blockIdx.z;
  const float* vb = video + (size_t)b * Tn * HIN * WIN * CIN;
  for (int idx = threadIdx.x; idx < MWIN; idx += blockDim.x) {
    const int e = idx % RLEN, rest = idx / RLEN;
    const int row = rest % MWROWS, kt = rest / MWROWS;
    const int tt = t + kt - PT, hh = oh0 * SH - PH + row, ww = e / CIN - PW, c = e % CIN;
    float v = 0.f;
    if (e < WCOLS * CIN && tt >= 0 && tt < Tn && hh >= 0 && hh < HIN && ww >= 0 && ww < WIN)
      v = vb[(((size_t)tt * HIN + hh) * WIN + ww) * CIN + c];
    wnd[idx] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int mt = warp % 2, nt0 = warp / 2;
  const int mine = (F / 8 - nt0 + 3) / 4;
  float acc[MAXF / 32][4];
#pragma unroll
  for (int i = 0; i < MAXF / 32; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int kt = 0; kt < KT; ++kt)
    for (int kh = 0; kh < KH; ++kh) {
      const __nv_bfloat16* r0 = wnd + (kt * MWROWS + 2 * mt * SH + kh) * RLEN + g * SW * CIN + 2 * tq;
      const __nv_bfloat16* r1 = r0 + SH * RLEN;              // the next output row
      const int kb = (kt * KH + kh) * JP;
#pragma unroll
      for (int jj = 0; jj < JP; jj += 16) {
        const uint32_t a[4] = {ld_pair(r0 + jj), ld_pair(r1 + jj), ld_pair(r0 + jj + 8),
                               ld_pair(r1 + jj + 8)};
#pragma unroll
        for (int i = 0; i < MAXF / 32; ++i) {
          if (i >= mine) break;
          const __nv_bfloat16* br = w + (size_t)(8 * (nt0 + 4 * i) + g) * KP + kb + jj + 2 * tq;
          mma_bf16(acc[i], a, __ldg(reinterpret_cast<const unsigned int*>(br)),
                   __ldg(reinterpret_cast<const unsigned int*>(br + 8)));
        }
      }
    }
#pragma unroll
  for (int i = 0; i < MAXF / 32; ++i) {
    if (i >= mine) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 16 * mt + g + (e >= 2 ? 8 : 0);
      const int oh = oh0 + m / OW, ow = m % OW;
      const int f = 8 * (nt0 + 4 * i) + 2 * tq + (e & 1);
      N::store(out, ((((size_t)b * Tn + t) * OH + oh) * OW + ow) * F + f,
               N::rnd(N::rnd(acc[i][e]) + N::rnd(bias[f])));
    }
  }
}

template <typename T>
int launch(const float* video, const void* w, const float* bias, void* out,
           int B, int Tn, int F, cudaStream_t stream) {
  static bool configured = false;
  if constexpr (sizeof(T) == 2) {   // bf16: tensor cores, w (F, KP)
    const int bytes = 2 * MWIN;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          patch_embed_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    dim3 grid(OH / MROWS, Tn, B);
    patch_embed_mma_kernel<<<grid, 256, bytes, stream>>>(
        video, static_cast<const __nv_bfloat16*>(w), bias, static_cast<__nv_bfloat16*>(out),
        Tn, F);
  } else {                          // f32: FMA, w (2025, F)
    const int bytes = 4 * WIN_FLOATS;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          patch_embed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    const int fp = (F + 31) / 32 * 32;
    dim3 grid(OH / ROWS, Tn, B);
    patch_embed_kernel<T><<<grid, 2 * fp, bytes, stream>>>(
        video, static_cast<const T*>(w), bias, static_cast<T*>(out), Tn, F, fp);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// dtype: 0 float32 with w (2025, F) tap-major; 1 bfloat16 with w (F, 2160),
// taps (kt, kh, kw * 3 + c) padded to 48 per (kt, kh) (F a multiple of 8).
// video is always f32.
int avdd_patch_embed(const void* video, const void* w, const void* bias, void* out,
                     int B, int T, int F, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || F <= 0 || F > MAXF || T > 65535 || (dtype == 1 && F % 8))
    return (int)cudaErrorInvalidValue;
  const float* v = static_cast<const float*>(video);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(v, w, bf, out, B, T, F, s);
  if (dtype == 1) return launch<__nv_bfloat16>(v, w, bf, out, B, T, F, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
