// Banded sliding-window attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel audio_visual_deepfake_detection_tpu/ops/pallas/
// band_attention.py::band_attention_pallas (pl.pallas_call at :105), the
// attention of the localizer's unfused TransformerBlock (training with
// dropout > 0). For q (pre-scaled), k, v of shape (B, H, T, D) and a (B, T)
// bool key mask, query row i attends keys i-w .. i+w:
//   s_d = sum_c q[i, c] k[i+d, c] + (key i+d masked ? -1e4 : 0),
//   -inf where i+d falls outside the sequence (edge rows renormalise),
//   p = softmax over the 2w+1 offsets, out[i] = sum_d p_d v[i+d],
//   and a row whose own key slot is masked comes out zero.
// The arithmetic is the Pallas body's, in the input dtype: in bf16 the
// products q k, the scores, the exps, the division and the running p v sum
// are each rounded to bf16 where that body rounds them (the head sum itself
// accumulates in f32 and rounds once); in f32 nothing is rounded. The plain
// version is band_attention_plain in ops/kernels/band_attention.py.
//
// What bounds it on this card: bytes. A call reads q, k, v and writes out
// once, 4 B H T D elements, against (2w+1) 4 D operations a row: ~7 FLOP a
// byte in bf16 at w = 3, far below the ridge.
// What this design does about it: nothing is staged and no score leaves the
// registers. One warp owns one (batch, head, query row); lane l holds
// channels l, l+32, ... of the row (a warp reads 32 consecutive elements at a
// time), the 2w+1 dot products are shuffle reductions, the softmax over the
// offsets lives in registers, and the k / v rows that neighbouring warps of
// the block share are served by L1 / L2 (a block covers 8 consecutive rows of
// one head, so each k / v row is fetched from HBM about once). q, k, v and
// out are read through (batch, head, row) strides, so the caller's split of
// (B, T, H D) into heads costs no copy. The TPU kernel's (G, T, D) VMEM
// tiles and 128-lane padding are not carried over.

#include "common.cuh"

namespace {

using namespace avdd;

constexpr int NT = 256;          // threads per block: 8 rows of one head
constexpr int MAX_W = 8;         // largest half window
constexpr float PENALTY = -1e4f;

struct Strides { long long b, h, t; };

constexpr int HEAD_DIM = 64;     // the localizer's 4 heads of 256 channels
constexpr int VPL = HEAD_DIM / 32;   // values per lane

template <typename T>
__global__ void __launch_bounds__(NT)
band_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const uint8_t* __restrict__ valid,
                      T* __restrict__ out, int H, int Tn, int w,
                      Strides sq, Strides sk, Strides sv, Strides so) {
  using N = Num<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * (NT / 32) + warp;
  if (i >= Tn) return;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const T* qr = q + b * sq.b + h * sq.h + i * sq.t;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const uint8_t* vrow = valid + (size_t)b * Tn;

  float qv[VPL];
#pragma unroll
  for (int c = 0; c < VPL; ++c) qv[c] = N::load(qr, lane + 32 * c);

  float sc[2 * MAX_W + 1];
  float mx = -CUDART_INF_F;
  const float pen = N::rnd(PENALTY);
  for (int d = -w; d <= w; ++d) {
    const int j = i + d;
    float s = -CUDART_INF_F;
    if (j >= 0 && j < Tn) {            // uniform over the warp
      const T* kr = kb + j * sk.t;
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < VPL; ++c) e += N::rnd(qv[c] * N::load(kr, lane + 32 * c));
      s = N::rnd(N::rnd(warp_sum(e)) + (vrow[j] ? 0.f : pen));
    }
    sc[d + w] = s;
    mx = fmaxf(mx, s);
  }
  // offset 0 is always inside the sequence, so mx is finite
  float den = 0.f;
  for (int d = 0; d <= 2 * w; ++d) {
    sc[d] = N::rnd(expf(N::rnd(sc[d] - mx)));
    den = d == 0 ? sc[d] : N::rnd(den + sc[d]);
  }
  float acc[VPL];
#pragma unroll
  for (int c = 0; c < VPL; ++c) acc[c] = 0.f;
  for (int d = -w; d <= w; ++d) {
    const int j = i + d;
    if (j < 0 || j >= Tn) continue;    // p = 0 there, and the shifted v is 0
    const float p = N::rnd(sc[d + w] / den);
    const T* vr = vb + j * sv.t;
#pragma unroll
    for (int c = 0; c < VPL; ++c)
      acc[c] = N::rnd(acc[c] + N::rnd(p * N::load(vr, lane + 32 * c)));
  }
  const float keep = vrow[i] ? 1.f : 0.f;   // zero rows whose own slot is masked
  T* orow = out + b * so.b + h * so.h + i * so.t;
#pragma unroll
  for (int c = 0; c < VPL; ++c) N::store(orow, lane + 32 * c, acc[c] * keep);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           int B, int H, int Tn, int D, int w, Strides sq, Strides sk, Strides sv,
           Strides so, cudaStream_t stream) {
  dim3 grid((Tn + NT / 32 - 1) / (NT / 32), B * H);
  if (D != HEAD_DIM) return (int)cudaErrorInvalidValue;
  band_attention_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), H, Tn, w, sq, sk, sv, so);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// q, k, v, out: (B, H, T, D) through element strides (batch, head, row), the
// D values of a row contiguous; valid: (B, T) bool, contiguous. D = 64 (the
// one head width the localizer has), 0 <= w <= 8, B H <= 65535. dtype: 0 float32, 1 bfloat16.
int avdd_band_attention(const void* q, const void* k, const void* v, const void* valid,
                        void* out, int B, int H, int T, int D, int w,
                        long long qb, long long qh, long long qt,
                        long long kb, long long kh, long long kt,
                        long long vb, long long vh, long long vt,
                        long long ob, long long oh, long long ot,
                        int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || w < 0 || w > MAX_W || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides sq{qb, qh, qt}, sk{kb, kh, kt}, sv{vb, vh, vt}, so{ob, oh, ot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, valid, out, B, H, T, D, w, sq, sk, sv, so, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, valid, out, B, H, T, D, w, sq, sk, sv, so, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
