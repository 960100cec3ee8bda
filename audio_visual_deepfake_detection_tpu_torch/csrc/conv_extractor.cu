// Emotion2Vec conv feature extractor for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel audio_visual_deepfake_detection_tpu/ops/pallas/
// conv_extractor.py::fused_conv_extractor (pl.pallas_call at :210), K5: seven
// bias-free Conv1d layers over a 16 kHz wav, (512 channels, kernel 10, stride
// 5), (512, 3, 2) x 4, (512, 2, 2) x 2, each followed by LayerNorm over the
// channels (eps 1e-5, affine) and the exact GELU; (B, L) f32 in, (B, T6, 512)
// in the compute dtype out.
//
// What bounds it on this card: a 9.6 s wav (153,600 samples) is ~47 GFLOP,
// 24 GFLOP of it in layer 1 (15,359 frames x 1536 x 512), against 0.6 MB of
// wav read and 0.5 MB of features written: far above the ridge, bound by the
// tensor cores in bf16.
//
// The TPU kernel keeps the whole stack of a time tile resident in VMEM. A
// Hopper block has 227 KB of shared memory and layer 0's output for even four
// final frames is ~330 KB in bf16, so the stack cannot stay on chip per
// tile. This design runs one launch per layer, on the caller's stream, with
// the activations (B, T_l, 512) in device memory between them (2 GB in bf16
// for layer 0 at B = 64, read once by layer 1: small beside the products):
//   layer 0: K = 10, no product worth the tensor cores; a warp computes four
//     consecutive frames by FMA from 25 samples it holds in registers;
//   layers 1-6: an implicit GEMM. Frame t of layer l reads rows s t .. s t +
//     k - 1 of the previous layer's (T, 512) output, which are one contiguous
//     run of K = k 512 values (stride <= kernel), so A needs no gather. A
//     block owns 64 frames x all 512 output channels, so that a frame's LN
//     statistics stay inside the block, and LN + affine + GELU + the downcast
//     run in the epilogue from the accumulators.
// The strided layout tricks of the TPU kernel (40-sample rows with halo
// lanes, the unfold matrix, pair reshapes) answer Mosaic's lack of strided
// slices and have no counterpart here. No read goes past the wav: every
// frame's window lies inside its input by the definition of a VALID conv.
//
// bf16: products on mma.sync m16n8k16 (f32 accumulate), tiles of 64 k values
// staged by cp.async into two shared-memory buffers, fragments by ldmatrix.
// f32: register-tiled FMA at full precision. Numerics follow
// conv_extractor_math: weights and wav rounded to the compute dtype, f32
// sums rounded once, f32 LN statistics (fast variance clamped at 0), the LN
// output rounded, GELU in f32 rounded. Left for later: wgmma with TMA tiles,
// layer 0 computed in layer 1's producer.

#include "common.cuh"

namespace {

using namespace avdd;

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int CH = 512;
constexpr int NLAYER = 7;
constexpr float LN_EPS = 1e-5f;
constexpr int KSIZE[NLAYER] = {10, 3, 3, 3, 3, 2, 2};
constexpr int STRIDE[NLAYER] = {5, 2, 2, 2, 2, 2, 2};

// ---- layer 0: wav (B, L) f32 -> (B, T0, 512), kernel 10, stride 5 ----------
// A warp owns R0 consecutive frames: lane l holds sample 5 t0 + l (the R0
// frames span 5 (R0 - 1) + 10 = 25 samples) and channels 2 l + 64 i + {0, 1}.
constexpr int R0 = 4;

template <typename T>
__global__ void __launch_bounds__(NT)
layer0_kernel(const float* __restrict__ wav, const float* __restrict__ w0,
              const float* __restrict__ ln, T* __restrict__ out, int B, int L, int T0) {
  using N = Num<T>;
  __shared__ __align__(16) float Ws[10][CH];
  for (int idx = threadIdx.x; idx < 10 * CH; idx += NT) Ws[idx % 10][idx / 10] = w0[idx];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long groups = (T0 + R0 - 1) / R0;
  const long long task = (long long)blockIdx.x * NWARP + warp;
  if (task >= (long long)B * groups) return;
  const int b = (int)(task / groups), t0 = (int)(task % groups) * R0;
  const int sidx = 5 * t0 + lane;
  const float xs = (lane < 5 * (R0 - 1) + 10 && sidx < L)
                       ? N::rnd(__ldg(wav + (size_t)b * L + sidx)) : 0.f;
  float acc[R0][16];
#pragma unroll
  for (int r = 0; r < R0; ++r)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[r][i] = 0.f;
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    float xr[R0];
#pragma unroll
    for (int r = 0; r < R0; ++r) xr[r] = __shfl_sync(0xffffffffu, xs, 5 * r + j);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 w = *reinterpret_cast<const float2*>(&Ws[j][2 * lane + 64 * i]);
#pragma unroll
      for (int r = 0; r < R0; ++r) {
        acc[r][2 * i] = fmaf(xr[r], w.x, acc[r][2 * i]);
        acc[r][2 * i + 1] = fmaf(xr[r], w.y, acc[r][2 * i + 1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R0; ++r) {
    if (t0 + r >= T0) break;
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float y = N::rnd(acc[r][i]);
      acc[r][i] = y;
      s += y;
      s2 += y * y;
    }
    const float mean = warp_sum(s) / CH;
    const float rs = rsqrtf(fmaxf(warp_sum(s2) / CH - mean * mean, 0.f) + LN_EPS);
    T* dst = out + ((size_t)b * T0 + t0 + r) * CH;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 2 * lane + 64 * i;
      const float2 g = __ldg(reinterpret_cast<const float2*>(ln + c));
      const float2 be = __ldg(reinterpret_cast<const float2*>(ln + CH + c));
      const float z0 = N::rnd((acc[r][2 * i] - mean) * (rs * g.x) + be.x);
      const float z1 = N::rnd((acc[r][2 * i + 1] - mean) * (rs * g.y) + be.y);
      N::store2(dst, c, N::rnd(gelu_erf(z0)), N::rnd(gelu_erf(z1)));
    }
  }
}

// ---- layers 1-6, f32: out[m, :] = gelu(LN(A[m, :K] . W^T)) ----------------
// m = (sample, frame); A row m is the contiguous run in + (b Tin + s t) 512
// of K = k 512 values; W (512, K) row-major. A block owns BM rows x all 512
// columns; warp w owns rows w + 8 i, lane l columns l + 32 j (i < 8, j < 16),
// so a warp holds whole rows and the LN statistics are warp reductions.
constexpr int BM = 64;
constexpr int FK = 16;

__global__ void __launch_bounds__(NT)
conv_ln_gelu_fma_kernel(const float* __restrict__ in, const float* __restrict__ W,
                        const float* __restrict__ ln, float* __restrict__ out,
                        long long M, int Tin, int Tout, int k, int s) {
  __shared__ float As[FK][BM + 4];
  __shared__ float Ws[FK][CH];
  const int K = k * CH;
  const long long m0 = (long long)blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lr = threadIdx.x / 4, lq = threadIdx.x % 4;     // this thread's A load
  const long long lm = min(m0 + lr, M - 1);
  const float* arow = in + ((size_t)(lm / Tout) * Tin + (size_t)s * (lm % Tout)) * CH;
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += FK) {
    __syncthreads();
    const float4 av = *reinterpret_cast<const float4*>(arow + k0 + 4 * lq);
    As[4 * lq + 0][lr] = av.x;
    As[4 * lq + 1][lr] = av.y;
    As[4 * lq + 2][lr] = av.z;
    As[4 * lq + 3][lr] = av.w;
#pragma unroll
    for (int i = 0; i < CH * FK / 4 / NT; ++i) {
      const int idx = threadIdx.x + NT * i, n = idx % CH, q = idx / CH;
      const float4 wv = __ldg(reinterpret_cast<const float4*>(W + (size_t)n * K + k0 + 4 * q));
      Ws[4 * q + 0][n] = wv.x;
      Ws[4 * q + 1][n] = wv.y;
      Ws[4 * q + 2][n] = wv.z;
      Ws[4 * q + 3][n] = wv.w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[8], w[16];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][warp + 8 * i];
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = Ws[kk][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + warp + 8 * i;
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sum += acc[i][j];
      sq += acc[i][j] * acc[i][j];
    }
    const float mean = warp_sum(sum) / CH;
    const float rs = rsqrtf(fmaxf(warp_sum(sq) / CH - mean * mean, 0.f) + LN_EPS);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = lane + 32 * j;
      const float z = (acc[i][j] - mean) * (rs * __ldg(ln + c)) + __ldg(ln + CH + c);
      out[(size_t)m * CH + c] = gelu_erf(z);
    }
  }
}

// ---- layers 1-6, bf16 on the tensor cores ---------------------------------
// The same function. Warp w owns rows 32 (w % 2) .. + 32 and columns
// 128 (w / 2) .. + 128 of the block's 64 x 512 tile: 2 x 16 mma tiles, 128
// f32 accumulators a thread. k runs in steps of BK = 64 through two
// shared-memory stages (A 64 x 64, W 512 x 64, rows padded to 72 values so
// the ldmatrix rows fall in distinct banks); stage it + 1 loads while stage
// it computes.
constexpr int BK = 64;
constexpr int LDT = BK + 8;
constexpr int STAGE = (BM + CH) * LDT;                  // bf16 values per stage
constexpr int MMA_SMEM = 2 * STAGE * 2 + 2 * 4 * BM * 4;

__global__ void __launch_bounds__(NT, 1)
conv_ln_gelu_mma_kernel(const __nv_bfloat16* __restrict__ in,
                        const __nv_bfloat16* __restrict__ W, const float* __restrict__ ln,
                        __nv_bfloat16* __restrict__ out, long long M, int Tin, int Tout,
                        int k, int s) {
  using N = Num<__nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smb[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smb);
  float* red = reinterpret_cast<float*>(smb + 2 * STAGE * 2);   // [2][4][BM]
  const int K = k * CH;
  const long long m0 = (long long)blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = 32 * (warp % 2), wn = 128 * (warp / 2);

  // this thread's two A chunks per stage: rows lr and lr + 32, chunk lc
  const int lr = threadIdx.x / 8, lc = 8 * (threadIdx.x % 8);
  const __nv_bfloat16* arow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = min(m0 + lr + 32 * i, M - 1);
    arow[i] = in + ((size_t)(m / Tout) * Tin + (size_t)s * (m % Tout)) * CH;
  }
  auto load_stage = [&](int it) {
    __nv_bfloat16* As = tiles + (it & 1) * STAGE;
    __nv_bfloat16* Ws = As + BM * LDT;
    const int k0 = it * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) cp_async16(As + (lr + 32 * i) * LDT + lc, arow[i] + k0 + lc);
#pragma unroll
    for (int i = 0; i < CH * BK / 8 / NT; ++i) {
      const int n = lr + 32 * i;
      cp_async16(Ws + n * LDT + lc, W + (size_t)n * K + k0 + lc);
    }
    cp_commit();
  };

  float acc[2][16][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  const int nk = K / BK;
  load_stage(0);
  for (int it = 0; it < nk; ++it) {
    cp_wait_all();
    __syncthreads();
    if (it + 1 < nk) load_stage(it + 1);
    const __nv_bfloat16* As = tiles + (it & 1) * STAGE;
    const __nv_bfloat16* Ws = As + BM * LDT;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], As + (wm + 16 * mi + lane % 16) * LDT + kk + 8 * (lane / 16));
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        uint32_t bf[4];   // b0, b1 of column tile 2 nj, then of 2 nj + 1
        ldmatrix_x4(bf, Ws + (wn + 16 * nj + lane % 8 + 8 * (lane / 16)) * LDT + kk +
                            8 * ((lane / 8) % 2));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], bf[2], bf[3]);
        }
      }
    }
  }

  // ---- epilogue: round, LN over the 512 columns (four warps a row), GELU ---
  // acc[mi][nt][e] is row wm + 16 mi + g + 8 (e / 2), column wn + 8 nt + 2 t + e % 2
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float y = N::rnd(acc[mi][nt][e]);
          acc[mi][nt][e] = y;
          sum += y;
          sq += y * y;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      if (t == 0) {
        const int r = wm + 16 * mi + 8 * h + g;
        red[(warp / 2) * BM + r] = sum;
        red[(4 + warp / 2) * BM + r] = sq;
      }
    }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + 16 * mi + 8 * h + g;
      const long long m = m0 + r;
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sum += red[q * BM + r];
        sq += red[(4 + q) * BM + r];
      }
      const float mean = sum / CH;
      const float rs = rsqrtf(fmaxf(sq / CH - mean * mean, 0.f) + LN_EPS);
      if (m >= M) continue;
      __nv_bfloat16* dst = out + (size_t)m * CH;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int c = wn + 8 * nt + 2 * t;
        const float2 gw = __ldg(reinterpret_cast<const float2*>(ln + c));
        const float2 be = __ldg(reinterpret_cast<const float2*>(ln + CH + c));
        const float z0 = N::rnd((acc[mi][nt][2 * h] - mean) * (rs * gw.x) + be.x);
        const float z1 = N::rnd((acc[mi][nt][2 * h + 1] - mean) * (rs * gw.y) + be.y);
        N::store2(dst, c, N::rnd(gelu_erf(z0)), N::rnd(gelu_erf(z1)));
      }
    }
}

template <typename T>
int run(const float* wav, const float* w0, const void* const* ws, const float* ln, void* even,
        void* odd, void* out, int B, int L, cudaStream_t st) {
  int len[NLAYER];
  int cur = L;
  for (int i = 0; i < NLAYER; ++i) {
    cur = (cur - KSIZE[i]) / STRIDE[i] + 1;
    if (cur < 1) return (int)cudaErrorInvalidValue;
    len[i] = cur;
  }
  const long long tasks = (long long)B * ((len[0] + R0 - 1) / R0);
  layer0_kernel<T><<<(unsigned)((tasks + NWARP - 1) / NWARP), NT, 0, st>>>(
      wav, w0, ln, static_cast<T*>(even), B, L, len[0]);
  if (int e = (int)cudaGetLastError()) return e;
  const void* src = even;
  for (int i = 1; i < NLAYER; ++i) {
    void* dst = i == NLAYER - 1 ? out : (i % 2 ? odd : even);
    const long long M = (long long)B * len[i];
    const unsigned grid = (unsigned)((M + BM - 1) / BM);
    const float* lni = ln + 2 * i * CH;
    if constexpr (sizeof(T) == 2) {
      static int configured = 0;
      if (int e = set_smem(conv_ln_gelu_mma_kernel, MMA_SMEM, configured)) return e;
      conv_ln_gelu_mma_kernel<<<grid, NT, MMA_SMEM, st>>>(
          static_cast<const __nv_bfloat16*>(src), static_cast<const __nv_bfloat16*>(ws[i - 1]),
          lni, static_cast<__nv_bfloat16*>(dst), M, len[i - 1], len[i], KSIZE[i], STRIDE[i]);
    } else {
      conv_ln_gelu_fma_kernel<<<grid, NT, 0, st>>>(
          static_cast<const float*>(src), static_cast<const float*>(ws[i - 1]), lni,
          static_cast<float*>(dst), M, len[i - 1], len[i], KSIZE[i], STRIDE[i]);
    }
    if (int e = (int)cudaGetLastError()) return e;
    src = dst;
  }
  return 0;
}

}  // namespace

extern "C" {

// The seven layers on `stream`; returns the first CUDA error (0 = all
// launched). wav (B, L) f32; w0 (512, 10) f32 holding compute-dtype values;
// w1..w6 (512, k 512) in the compute dtype with the taps outermost in K; ln
// (14, 512) f32 (weight, bias per layer); scratch even (B, T0, 512) and odd
// (B, T1, 512) and out (B, T6, 512) in the compute dtype (dtype 0 float32,
// 1 bfloat16). Layers write even, odd, even, ..., the last one out.
int avdd_conv_extractor(const void* wav, const void* w0, const void* w1, const void* w2,
                        const void* w3, const void* w4, const void* w5, const void* w6,
                        const void* ln, void* even, void* odd, void* out, int B, int L,
                        int dtype, void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const void* ws[6] = {w1, w2, w3, w4, w5, w6};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wavf = static_cast<const float*>(wav);
  const float* w0f = static_cast<const float*>(w0);
  const float* lnf = static_cast<const float*>(ln);
  if (dtype == 0) return run<float>(wavf, w0f, ws, lnf, even, odd, out, B, L, st);
  if (dtype == 1) return run<__nv_bfloat16>(wavf, w0f, ws, lnf, even, odd, out, B, L, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
