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
// tensor cores in bf16, provided the weights reach the SMs fast enough: a
// tile of 64 frames reads a layer's whole weight (1.5 MB for k = 3) from
// L2, ~45 GB a 64-wav call over the six layers.
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
//     tile is 64 frames x all 512 output channels, so that a frame's LN
//     statistics stay inside the block, and LN + affine + GELU + the downcast
//     run in the epilogue from the accumulators.
// The strided layout tricks of the TPU kernel (40-sample rows with halo
// lanes, the unfold matrix, pair reshapes) answer Mosaic's lack of strided
// slices and have no counterpart here. No read goes past the wav: every
// frame's window lies inside its input by the definition of a VALID conv.
//
// bf16: layers 1-6 on wgmma (m64n256k16, both operands in shared memory),
// persistent clusters of two blocks, each two consumer warpgroups and a
// producer warpgroup (setmaxnreg moves its registers to the consumers),
// whose one thread streams A (a 3-D TMA tensor map per tap over the previous
// layer's output, frames at stride s 512) and its half of W, multicast to
// both blocks, through a ring of three 72 KB stages with full / empty
// mbarriers, and runs on into the next tile while the consumers finish the
// last one's LN, GELU and stores (see
// conv_ln_gelu_wgmma_kernel). f32: register-tiled FMA at full precision.
// Numerics follow conv_extractor_math: weights and wav rounded to the
// compute dtype, f32 sums rounded once, f32 LN statistics (fast variance
// clamped at 0), the LN output rounded, GELU in f32 rounded (in bf16 read
// from a table of it over every bf16 input, built on the card: the same
// bits, ~25 instructions fewer an element).

#include "wgmma.cuh"

namespace {

using namespace avdd;

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int CH = 512;
constexpr int NLAYER = 7;
constexpr float LN_EPS = 1e-5f;
constexpr int KSIZE[NLAYER] = {10, 3, 3, 3, 3, 2, 2};
constexpr int STRIDE[NLAYER] = {5, 2, 2, 2, 2, 2, 2};

// The exact GELU (rounded) of every bf16 value: the bf16 layers' GELU input is
// the rounded LN output, so a load from this table replaces erf.
__device__ __nv_bfloat16 gelu_erf_table[65536];
struct GeluErf {
  __device__ float operator()(float x) const { return gelu_erf(x); }
};
__device__ __forceinline__ uint32_t gelu_pair(float z0, float z1) {
  const uint16_t* t = reinterpret_cast<const uint16_t*>(gelu_erf_table);
  return (uint32_t)__ldg(t + bf16_bits(z0)) | (uint32_t)__ldg(t + bf16_bits(z1)) << 16;
}

// ---- layer 0: wav (B, L) f32 -> (B, T0, 512), kernel 10, stride 5 ----------
// A warp takes runs of R0 consecutive frames: lane l holds sample 5 t0 + l
// (the R0 frames span 5 (R0 - 1) + 10 = 25 samples) and channels 2 l + 64 i +
// {0, 1}. Blocks loop over the runs (two an SM), so each stages the weights
// in shared memory once.
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
  auto sample = [&](long long task) {        // this lane's sample of a run, 0 past the end
    if (task >= (long long)B * groups) return 0.f;
    const int b = (int)(task / groups), sidx = 5 * (int)(task % groups) * R0 + lane;
    return (lane < 5 * (R0 - 1) + 10 && sidx < L) ? N::rnd(__ldg(wav + (size_t)b * L + sidx)) : 0.f;
  };
  const long long step = (long long)gridDim.x * NWARP;
  float next = sample((long long)blockIdx.x * NWARP + warp);
  for (long long task = (long long)blockIdx.x * NWARP + warp; task < (long long)B * groups;
       task += step) {
    const int b = (int)(task / groups), t0 = (int)(task % groups) * R0;
    const float xs = next;
    next = sample(task + step);               // the next run's load overlaps this one
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
        if constexpr (sizeof(T) == 2)
          *reinterpret_cast<uint32_t*>(dst + c) = gelu_pair(z0, z1);
        else
          N::store2(dst, c, gelu_erf(z0), gelu_erf(z1));
      }
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

// ---- layers 1-6, bf16 on wgmma -------------------------------------------
// The same function, on persistent clusters of CL blocks that walk groups
// of CL tiles of 64 frames of one sample (block r takes tile CL q + r).
// A block is a producer warpgroup and two consumer warpgroups; each consumer
// warpgroup owns 256 of the 512 output channels of its tile's 64 frames
// (m64n256k16, 128 f32 accumulators a thread). k runs in steps of 64
// values, one (tap j, 64-channel block) pair at a time, through a ring of KS
// stages, each the tile's A slice (64 frames x 64 values) and the W slice
// (512 x 64): frame t's tap j reads row s t + j of the previous layer, so A
// is one box of a 3-D tensor map over that output (channels, frames at
// stride s 512, samples) based at tap j; frames past the layer's end, and
// the missing tiles of the last group, come in as zeros. The blocks of a
// cluster need the same W slice at the same step: each loads 1 / CL of it
// and multicasts it into all, so a weight byte read from L2 serves CL x 64
// frames (L2 bounds the k loop: ~45 GB of weights a 64-wav call with one
// block a slice); a stage is free once the consumers of every block have
// read it (2 CL arrivals on each block's empty barrier). The producer runs ahead into the
// next tile while the consumers run the epilogue: round, per-frame LN
// statistics (a quad of threads holds a row's 256 columns of one warpgroup;
// the two halves meet in shared memory), LN, GELU, store.
constexpr int FR = 64;                          // frames a tile
constexpr int CL = 2;                           // blocks a cluster
constexpr int KS = 3;                           // ring stages
constexpr int A_BYTES = FR * 128;
constexpr int W_BYTES = CH * 128;
constexpr int KSTAGE = A_BYTES + W_BYTES;       // 72 KB
constexpr int NTW = 3 * 128;                    // two consumer warpgroups + the producer's
constexpr int WG_SMEM = 1024 + KS * KSTAGE + 2 * 2 * FR * 8 + 16 * KS;
static_assert(WG_SMEM <= SMEM_MAX, "conv wgmma block over SMEM_MAX");

struct ConvMaps { CUtensorMap a[3]; CUtensorMap w; };   // A per tap, W (512, k 512)

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NTW, 1)
conv_ln_gelu_wgmma_kernel(const __grid_constant__ ConvMaps maps, const float* __restrict__ ln,
                          __nv_bfloat16* __restrict__ out, int B, int Tout, int k) {
  using N = Num<__nv_bfloat16>;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t raw = smem_u32(smraw), ring = (raw + 1023u) & ~1023u;
  float2* red = reinterpret_cast<float2*>(smraw + (ring - raw) + KS * KSTAGE);  // [2][2][FR]
  const uint32_t bars = ring + KS * KSTAGE + 2 * 2 * FR * 8;
  const int warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t rank = cluster_rank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < KS; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (KS + s), 2 * CL);
    }
    mbar_init_fence();
  }
  cluster_sync();
  const int tps = (Tout + FR - 1) / FR, ntiles = B * tps, nk = 8 * k;
  const int groups = (ntiles + CL - 1) / CL, clusters = gridDim.x / CL;
  if (warp_id >= 8) {               // the producer warpgroup: one thread streams
    regs_dec<40>();
    if (warp_id == 8 && lane == 0) {
      int i = 0;
      for (int q = blockIdx.x / CL; q < groups; q += clusters) {
        const int tile = CL * q + (int)rank, b = tile / tps, t0 = (tile % tps) * FR;
        for (int ks = 0; ks < nk; ++ks, ++i) {
          const int s = i % KS;
          if (i >= KS) mbar_wait(bars + 8 * (KS + s), (i / KS - 1) & 1);
          const uint32_t st = ring + s * KSTAGE, full = bars + 8 * s;
          const int j = ks / 8, kc = j * CH + 64 * (ks % 8);
          mbar_expect_tx(full, KSTAGE);
          tma_load_3d(st, &maps.a[j], 64 * (ks % 8), t0, b, full);
          tma_load_2d_multicast(st + A_BYTES + rank * (W_BYTES / CL), &maps.w, kc,
                                (int)rank * (CH / CL), full, (1 << CL) - 1);
        }
      }
    }
  } else {
    regs_inc<232>();
    const int wg = warp_id / 4, warp = warp_id % 4, g = lane / 4, t = lane % 4;
    int n = 0, local = 0;
    float acc[128];
    for (int q = blockIdx.x / CL; q < groups; q += clusters, ++local) {
      const int tile = CL * q + (int)rank, b = tile / tps, t0 = (tile % tps) * FR;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int ks = 0; ks < nk; ++ks) {
        const int s = n % KS;
        mbar_wait(bars + 8 * s, (n / KS) & 1);
        ++n;
        const uint32_t st = ring + s * KSTAGE;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaSS<256>::run(acc, tile_desc(st + kk * 32),
                            tile_desc(st + A_BYTES + wg * (W_BYTES / 2) + kk * 32), 1);
        wgmma_commit();
        wgmma_wait<1>();
        if (ks && threadIdx.x % 128 == 0)     // the previous stage, in every block
          for (int c = 0; c < CL; ++c) mbar_arrive_cluster(bars + 8 * (KS + (n - 2) % KS), c);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (threadIdx.x % 128 == 0)
        for (int c = 0; c < CL; ++c) mbar_arrive_cluster(bars + 8 * (KS + (n - 1) % KS), c);

      // epilogue: acc[4 j + e] is row 16 warp + g + 8 (e / 2), column
      // 256 wg + 8 j + 2 t + e % 2
      float2* half = red + (local & 1) * 2 * FR;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float sum = 0.f, sq = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            const float y = N::rnd(acc[4 * j + e]);
            acc[4 * j + e] = y;
            sum += y;
            sq += y * y;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sq += __shfl_xor_sync(0xffffffffu, sq, 2);
        if (t == 0) half[wg * FR + 16 * warp + g + 8 * hf] = make_float2(sum, sq);
      }
      bar_sync(1, 256);
      if (tile >= ntiles) continue;         // a zero tile of the last group
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * warp + g + 8 * hf, m = t0 + r;
        const float2 s0 = half[r], s1 = half[FR + r];
        const float mean = (s0.x + s1.x) / CH;
        const float rs = rsqrtf(fmaxf((s0.y + s1.y) / CH - mean * mean, 0.f) + LN_EPS);
        if (m >= Tout) continue;
        __nv_bfloat16* dst = out + ((size_t)b * Tout + m) * CH;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int c = 256 * wg + 8 * j + 2 * t;
          const float2 gw = __ldg(reinterpret_cast<const float2*>(ln + c));
          const float2 be = __ldg(reinterpret_cast<const float2*>(ln + CH + c));
          const float z0 = (acc[4 * j + 2 * hf] - mean) * (rs * gw.x) + be.x;
          const float z1 = (acc[4 * j + 2 * hf + 1] - mean) * (rs * gw.y) + be.y;
          *reinterpret_cast<uint32_t*>(dst + c) = gelu_pair(z0, z1);
        }
      }
    }
  }
  cluster_sync();                   // no block leaves while the others may still write to it
}

// One bf16 layer: tensor maps over its input (one per tap) and its weight,
// then persistent clusters of CL blocks, one block an SM at most.
int conv_layer_wgmma(const __nv_bfloat16* in, const __nv_bfloat16* w, const float* ln,
                     __nv_bfloat16* out, int B, int Tin, int Tout, int k, int s,
                     cudaStream_t st) {
  static int configured = 0, sms = 0;
  if (int e = set_smem(conv_ln_gelu_wgmma_kernel, WG_SMEM, configured)) return e;
  if (!sms) {
    int dev = 0;
    if (int e = (int)cudaGetDevice(&dev)) return e;
    if (int e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) return e;
  }
  ConvMaps maps;
  const uint64_t adims[3] = {CH, (uint64_t)Tout, (uint64_t)B};
  const uint64_t astr[2] = {(uint64_t)s * CH * 2, (uint64_t)Tin * CH * 2};
  const uint32_t abox[3] = {64, FR, 1};
  for (int j = 0; j < k; ++j)
    if (int e = bf16_tensor_map(&maps.a[j], in + (size_t)j * CH, 3, adims, astr, abox)) return e;
  const uint64_t wdims[2] = {(uint64_t)k * CH, CH}, wstr[1] = {(uint64_t)k * CH * 2};
  const uint32_t wbox[2] = {64, CH / CL};
  if (int e = bf16_tensor_map(&maps.w, w, 2, wdims, wstr, wbox)) return e;
  const int groups = (B * ((Tout + FR - 1) / FR) + CL - 1) / CL;
  const int clusters = groups < sms / CL ? groups : sms / CL;
  conv_ln_gelu_wgmma_kernel<<<CL * clusters, NTW, WG_SMEM, st>>>(maps, ln, out, B, Tout, k);
  return (int)cudaGetLastError();
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
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (int e = (int)cudaGetDevice(&dev)) return e;
    if (int e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) return e;
  }
  if constexpr (sizeof(T) == 2) {
    static __nv_bfloat16* table = nullptr;
    static unsigned table_ready = 0;
    if (!table)
      if (int e = (int)cudaGetSymbolAddress(reinterpret_cast<void**>(&table), gelu_erf_table))
        return e;
    if (int e = fill_table(table, GeluErf{}, table_ready, st)) return e;
  }
  const long long blocks = ((long long)B * ((len[0] + R0 - 1) / R0) + NWARP - 1) / NWARP;
  layer0_kernel<T><<<(unsigned)(blocks < 2 * sms ? blocks : 2 * sms), NT, 0, st>>>(
      wav, w0, ln, static_cast<T*>(even), B, L, len[0]);
  if (int e = (int)cudaGetLastError()) return e;
  const void* src = even;
  for (int i = 1; i < NLAYER; ++i) {
    void* dst = i == NLAYER - 1 ? out : (i % 2 ? odd : even);
    const float* lni = ln + 2 * i * CH;
    if constexpr (sizeof(T) == 2) {
      if (int e = conv_layer_wgmma(static_cast<const __nv_bfloat16*>(src),
                                   static_cast<const __nv_bfloat16*>(ws[i - 1]), lni,
                                   static_cast<__nv_bfloat16*>(dst), B, len[i - 1], len[i],
                                   KSIZE[i], STRIDE[i], st))
        return e;
    } else {
      const long long M = (long long)B * len[i];
      const unsigned grid = (unsigned)((M + BM - 1) / BM);
      conv_ln_gelu_fma_kernel<<<grid, NT, 0, st>>>(
          static_cast<const float*>(src), static_cast<const float*>(ws[i - 1]), lni,
          static_cast<float*>(dst), M, len[i - 1], len[i], KSIZE[i], STRIDE[i]);
      if (int e = (int)cudaGetLastError()) return e;
    }
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
