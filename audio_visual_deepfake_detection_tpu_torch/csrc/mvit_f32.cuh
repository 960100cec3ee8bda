// The float32 attention's shared pieces (K3 / K4 / K8 in f32, the dtype
// cli/extract_features.py computes in unless told otherwise): the operands
// of the attention as the tensor cores take them in 3xTF32, and the
// launch that mvit_attention.cu (K3's entries), mvit_block_f32.cu (K4's
// attention step) and full_attention.cu (K8's f32 entry) call.
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

// KEY_BIAS: K8's full attention (csrc/full_attention.cu): no band, no class
// key, no residual, q scaled by the caller, an additive bias per key.
enum { PRESCALE = 1, BAND_ROUND = 2, CLS_FIRST = 4, BAND_TABLE = 8, KEY_BIAS = 16 };
enum AttnMode { M_BAND, M_TABLE, M_FULL };   // the attention kernel's instances

struct AttnF32 {
  const float* q;                    // f32, (sample, head, row) strides
  long long qsb, qsh, qsn;
  const float* khi; const float* klo;     // grid keys (B nh, T, wd), split
  const float* vthi; const float* vtlo;   // grid values transposed (B nh, wd, tp), split
  const float* kc; const float* vc;       // the class key and value, f32, row bh at bh * cstride
  long long cstride;
  const float* relhi; const float* rello; // the temporal table (>= 2T - 1, wd), split (BAND_TABLE)
  const float* band;                      // (B nh, nq - cls, T) f32, else
  const float* kbias = nullptr;           // KEY_BIAS: (B, T) f32 added to the scores, or null
  const float* k = nullptr;               // KEY_BIAS: k, v (B, nh, T, d) f32 as they are,
  const float* v = nullptr;               // through (sample, head, key) strides
  long long ksb = 0, ksh = 0, kst = 0, vsb = 0, vsh = 0, vst = 0;
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

// the 16-byte shared-memory moves and the split store live in wgmma.cuh
using avdd::ld_shared_v4;
using avdd::st_shared_v4;
using avdd::st_split_v4;

// The attention on ``stream``, B samples (grid: 64-row blocks x B nh, one
// axis for KEY_BIAS); returns a CUDA error (0 = launched). Takes d % 4 ==
// 0, d <= 128 (KEY_BIAS: 32 or 64 after padding), B nh <= 65535 (but for
// KEY_BIAS), 16-byte aligned q and out with strides that are multiples of 4.
int launch_attention_f32(const AttnF32& p, int B, cudaStream_t stream);
// K3's entries: k, v (B nh, T + 1, d) with the class token last and, with
// BAND_TABLE, the table rel (>= 2T - 1, d), split into ``scratch``
// (k3_f32_scratch_bytes) by one launch, then the attention on p (q, out,
// band, strides, flags and sizes set by the caller).
long long k3_f32_scratch_bytes(int bhn, int T, int d, bool table);
int launch_k3_f32(AttnF32 p, const float* k, const float* v, const float* rel, void* scratch,
                  int B, cudaStream_t stream);
// K8's f32 entry: the attention in KEY_BIAS mode on p (q, k, v, out, their
// strides, kbias, nh, T and d set by the caller); it splits k and v itself,
// a tile at a time in shared memory.
int launch_k8_f32(AttnF32 p, int B, cudaStream_t stream);

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
