// The float32 MViT kernels' shared pieces (K3 / K4 in f32, the dtype
// cli/extract_features.py computes in unless told otherwise): the operands
// of the pooled attention as the tensor cores take them in 3xTF32, and the
// launch that mvit_attention.cu (K3's entries) and mvit_block_f32.cu (K4's
// attention step) both call.
//
// tf32 products take both shared-memory operands K-major, so the attention
// reads its keys as they are, (key, channel) rows, and its values
// transposed, (channel, key) rows, each split into a TF32 high part and a
// TF32 residual (hi.hi + hi.lo + lo.hi, as K1's f32 kernel sums them). The
// head dim is padded to a multiple of 32 (one 128-byte row of f32 is one
// 32-deep stage of the product) and the keys of a transposed value row to a
// multiple of 32, zeros in the padding. P (the softmax weights) is the
// register operand of P.V: a thread's score accumulators hold keys 2t and
// 2t + 1 of each eight where the register fragment wants t and t + 4, so a
// transposed value row stores each eight keys even ones first
// (f32_key_pos), which makes the two orders agree.

#pragma once

#include "wgmma.cuh"

namespace avdd_mvit {

enum { PRESCALE = 1, BAND_ROUND = 2, CLS_FIRST = 4, BAND_TABLE = 8 };

struct AttnF32 {
  const float* q;                    // f32, (sample, head, row) strides
  long long qsb, qsh, qsn;
  const float* khi; const float* klo;     // grid keys (B nh, T, wd), split
  const float* vthi; const float* vtlo;   // grid values transposed (B nh, wd, tp), split
  const float* kc; const float* vc;       // the class key and value, f32, row bh at bh * cstride
  long long cstride;
  const float* relhi; const float* rello; // the temporal table (>= 2T - 1, wd), split (BAND_TABLE)
  const float* band;                      // (B nh, nq - cls, T) f32, else
  float* out;
  long long osb, osh, osn;
  int nh, nq, T, S, d, flags;
  float scale;
};

// The padded head width (32, 64, 96 or 128) and key count of the split operands.
__host__ __device__ inline int f32_head_width(int d) { return (d + 31) / 32 * 32; }
__host__ __device__ inline int f32_keys_padded(int T) { return (T + 31) / 32 * 32; }
// Where key k sits in a transposed value row: within each eight, the even
// keys first, then the odd ones.
__host__ __device__ inline int f32_key_pos(int k) {
  return (k & ~7) | ((k & 1) << 2) | ((k >> 1) & 3);
}

__device__ __forceinline__ void st_shared_v4(uint32_t a, uint32_t x, uint32_t y, uint32_t z,
                                             uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" :: "r"(a), "r"(x), "r"(y), "r"(z),
               "r"(w) : "memory");
}
__device__ __forceinline__ float4 ld_shared_v4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a) : "memory");
  return v;
}
// The four values of v split, stored as a 16-byte hi chunk and a lo chunk.
__device__ __forceinline__ void st_split_v4(uint32_t hi, uint32_t lo, float4 v) {
  uint32_t h[4], l[4];
  avdd::tf32_split(v.x, h[0], l[0]);
  avdd::tf32_split(v.y, h[1], l[1]);
  avdd::tf32_split(v.z, h[2], l[2]);
  avdd::tf32_split(v.w, h[3], l[3]);
  st_shared_v4(hi, h[0], h[1], h[2], h[3]);
  st_shared_v4(lo, l[0], l[1], l[2], l[3]);
}

// The attention on ``stream``, B samples (grid: 64-row blocks x B nh);
// returns a CUDA error (0 = launched). Takes d % 4 == 0, d <= 128, B nh <=
// 65535, 16-byte aligned q and out with strides that are multiples of 4.
int launch_attention_f32(const AttnF32& p, int B, cudaStream_t stream);
// K3's entries: k, v (B nh, T + 1, d) with the class token last and, with
// BAND_TABLE, the table rel (>= 2T - 1, d), split into ``scratch``
// (k3_f32_scratch_bytes) by one launch, then the attention on p (q, out,
// band, strides, flags and sizes set by the caller).
long long k3_f32_scratch_bytes(int bhn, int T, int d, bool table);
int launch_k3_f32(AttnF32 p, const float* k, const float* v, const float* rel, void* scratch,
                  int B, cudaStream_t stream);

// One float32 MultiscaleBlock (avdd_msblock's dtype 0): the inputs, the
// split weights and table, and the scratch the launches hand to one another.
struct BlockF32 {
  const float* x; const float* ln1; const float* bqkv; const float* taps; const float* pool_ln;
  const float* bp; const float* ln2; const float* b1; const float* b2;
  const float* wsplit;     // wqkv, wp, w1, w2, each hi then lo, then the table hi, lo (rel_rows, wd)
  float* qkv; float* qp; float* kvp; float* ctx; float* y1; float* hid; float2* stats; float* out;
  int B, T, hs, ws, C, nh, rel_rows;
};
int msblock_f32(const BlockF32& k, cudaStream_t stream);

}  // namespace avdd_mvit
