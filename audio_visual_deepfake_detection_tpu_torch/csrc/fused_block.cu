// Fused localizer transformer block for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel audio_visual_deepfake_detection_tpu/ops/pallas/
// fused_block.py::fused_transformer_block (pl.pallas_call at :535), and with
// it the forward of fused_transformer_block_train (:753), which is the same
// kernel given per-sample droppath coefficients. One call computes a whole
// block of the HRLR or ConvTransformer backbone:
//   pre-LN -> depthwise k3 convs -> plain LN (affines folded into the dense
//   weights by pack_block_params) -> q/k/v dense -> banded (2w+1 offsets) or
//   dense attention -> proj -> layer-scaled residual -> LN -> GELU MLP (4C)
//   -> layer-scaled residual,
// each layer scale multiplied by the sample's droppath coefficient of that
// branch (coefs (B, 2) f32 in {0, 1/keep}; a null pointer means 1, the eval
// launch): the product is taken in f32 and rounded once to the compute dtype,
// as block_math does. The backward of the training path is not a kernel: it
// differentiates block_math from the saved inputs, as the JAX package does.
// The modes are self, qv_k, kv (cross-modal k/v stream) and ds_self (stride 2:
// the caller passes even/odd rows; the stride-2 depthwise conv and the
// MaxPool(3,2,1) skip are composed from them). Numerics follow the plain
// version block_math in ops/kernels/fused_block.py: products accumulate in
// f32 and round to the compute dtype where the JAX kernel rounds, LN moments
// are one-pass in bf16 and two-pass in f32, softmax is f32.
//
// Shapes (shape_ok; ops/kernels/fused_block.py::kernel_shape_ok is the same
// rule, for both dtypes): C a multiple of 64 from 64 to 2048, head width D =
// C / n_head a multiple of 8 from 8 to 512, any half window w >= 1 or dense
// attention, at any T: the Pallas kernel's domain (it is generated per
// shape) cut at those C and D. The bf16 two-launch design below takes C up
// to 1024 and D in {32, 64, 96, 128} (wgmma_shape_ok); every other shape
// runs the bf16 scratch route (fused_block_bf16.cu). The f32 launches take
// every shape; past wgmma_shape_ok their attention runs the head width
// padded to an instance's (D < 128) or in 128-column blocks (D > 128), and
// their rows a block a row past C = 1024. All on the tensor cores.

// What bounds it on this card: a row costs 12 C^2 multiply-adds (q, k, v,
// proj 4 C^2, the MLP 8 C^2; 786k at C = 256) against a few KB of HBM
// traffic, far above the H100's ridge: the tensor cores bound it once the six
// products run on them, provided the 24 C^2 bytes of bf16 weights reach each
// SM fast enough. A tile of m rows reads all of them from L2, so the rows a
// weight fetch serves decide whether L2 or the tensor cores set the pace;
// the CUDA-core work a row needs (five LNs, three depthwise convs, 4 x (2w+1)
// scores and context sums, the GELU of 4C values) is second.
//
// bf16 (opt-in through a YAML's `tpu: compute_dtype: bfloat16`, and the
// dtype chip_smoke.py times the main path in), two launches on wgmma, three
// where the attention runs on the tensor cores:
// - PHASE_QKV: per tile of 64 rows of one sample, LN -> depthwise conv ->
//   LN of each stream into a 64 x C bf16 tile in shared memory (a warp LNs
//   the input rows each run of output rows needs, one more each side), then
//   the q / k / v product and its bias (q scaled) to a (B, T, 3C) bf16
//   scratch. The values there are the ones block_math rounds to bf16, so the
//   split is exact; it costs 3C x 2 bytes written and read a row.
// - the attention launch (fused_block_attend.cu; dense attention at every
//   T, and bands of w > 16): per (sample, head, 128 query rows), scores,
//   softmax and P.V on wgmma from the scratch's q, k, v, the context written
//   over q; its design is in that file.
// - PHASE_TAIL: per tile, the banded attention (w <= 16) from the scratch,
//   or the attention launch's context, into the tile, proj + the masked, layer-scaled residual (y1,
//   kept in the output rows), its LN into the tile, then fc1 -> GELU -> fc2
//   over C / 16 chunks of 64 hidden units: the chunk goes through an 8 KB
//   tile and fc2's sums stay in registers, so the 4C hidden never lies whole
//   anywhere.
// Both: a block is one warpgroup and one tile of 64 rows. A product's output
// columns go in groups of 256 (a remainder of 64, 128 or 192 last): one
// warpgroup's registers hold a 64 x 256 f32 accumulator and no more. With
// more than one group (C > 256) the proj groups write y1 to the output rows
// and its LN reads them back, and the MLP runs once per group, fc1 recomputed
// for each (its 4 C^2 a row again for every group past the first: a cost of
// the one-warpgroup design, paid only above C = 256). The weights come by TMA
// (boxes of 64 inputs x 64 outputs, or x 256 at C = 256, 128B-swizzled,
// straight from torch's (out, in) layout; a stage is one 64-deep slice of a
// group's weights, or four 64 x 64 slices of fc1's) through a ring of two
// 32 KB stages, each with an mbarrier that the
// TMA completes; thread 0 re-arms a slot as soon as the products that read it
// are done, so the next product's slices arrive while the warpgroup runs LN,
// attention or GELU. At C = 256 two blocks share an SM and run out of step,
// so one's CUDA-core work overlaps the other's products; the 64 x C tile
// leaves room for one from C = 512 on. The kernel is built twice: for the
// production block (C = 256, 4 heads of 64) with its shape compile-time
// constants (every loop over slices, groups, chunks and slabs has a known
// count and the head sums a fixed lane pattern, as when the kernel took that
// shape alone) and with the shape read at run time for every other one
// (fused_block_any.cu and fused_block_any_qkv.cu); the f32 kernels are in
// fused_block_f32.cu and fused_block_f32_attend.cu, the bf16 shapes past
// wgmma_shape_ok in fused_block_bf16.cu, all seven built side by side.
// Attention runs per slab of whole heads (at most 256 channels: 8 heads of
// 32, 4 of 64, 2 of 96 or 128): a warp reads a row's slab as one run of 16
// bytes a lane, the D / 8 lanes of a head sum a score by shuffles. Banded
// (2w+1 offsets) stages the slab's q, keys and values, the halo included,
// by TMA into the ring's space in chunks of 32 query rows (16 for w > 8);
// the key masks of a chunk come from two ballots. The rounding points are
// block_math's:
// cdot rounded once, one-pass LN moments, banded scores and the -1e4 penalty
// in bf16 (products rounded, f32 sums), f32 softmax, the context summed offset
// by offset in bf16, the division-free GELU, droppath coefficients multiplied
// into the layer scales in f32 and rounded once.
//
// f32 (the compute dtype of every shipped YAML, and what the card is held to
// against the CPU): eight launches with 3xTF32 products on wgmma through a
// scratch in device memory (fused_block_f32.cu: prep, the streams' rows, the
// q | k | v GEMM, proj, LN, fc1, fc2; fused_block_f32_attend.cu: the
// attention, dense and banded alike); the design is in fused_block_f32.cu.

#include "fused_block.cuh"

using namespace avdd_k1;

extern "C" {

// Elements of the compute dtype a call's scratch holds at half window w (<=
// 0: dense): 3 B T C for bfloat16 inside wgmma_shape_ok (the q | k | v rows
// between its launches), bf16_scratch_elems past it, f32_scratch_elems for
// float32; -1 if the kernel does not take the shape (shape_ok).
long long avdd_fused_block_scratch(int B, int T, int c, int n_head, int w, int dtype) {
  if (!shape_ok(c, n_head) || B <= 0 || T <= 0 || dtype < 0 || dtype > 1) return -1;
  if (dtype == 0) return f32_scratch_elems(B, T, c, n_head, w);
  return wgmma_shape_ok(c, n_head) ? 3ll * B * T * c : bf16_scratch_elems(B, T, c);
}

// Launch on `stream`; returns the first CUDA error (0 = launched) and, when
// launched, the route it took into *route (ROUTE_*).
// dtype: 0 float32, 1 bfloat16. mode: 0 self, 1 qv_k, 2 kv, 3 ds_self.
// Dense weights: (out, in) row-major in the compute dtype (torch's Linear
// layout), for both dtypes. coefs: (B, 2) f32 droppath coefficients of the
// training forward, or null. kv: a scratch of avdd_fused_block_scratch's
// elements of the compute dtype.
int avdd_fused_block(const void* x, const void* xo, const void* mask,
                     const void* vecs, const void* wq, const void* wk,
                     const void* wv, const void* wp, const void* wf1,
                     const void* wf2, const void* fc1b, void* out, void* kv,
                     const void* coefs, int B, int T, int c, int n_head, int w, int mode,
                     int dtype, void* stream, int* route) {
  if (avdd_fused_block_scratch(B, T, c, n_head, w, dtype) < 0 || mode < 0 || mode > 3 || !kv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wgmma = wgmma_shape_ok(c, n_head);
  const void* ws[6] = {wq, wk, wv, wp, wf1, wf2};
  int e;
  if (dtype == 1 && !wgmma) {
    ParamsB p;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.xo = static_cast<const __nv_bfloat16*>(xo ? xo : x);
    p.mask = static_cast<const uint8_t*>(mask);
    p.vecs = static_cast<const float*>(vecs);
    p.fc1b = static_cast<const float*>(fc1b);
    p.coefs = static_cast<const float*>(coefs);
    for (int i = 0; i < 6; ++i) p.wt[i] = static_cast<const __nv_bfloat16*>(ws[i]);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.B = B; p.T = T; p.C = c; p.NH = n_head; p.D = c / n_head;
    p.w = w > 0 ? w : 0; p.mode = mode;
    e = launch_bf16(p, static_cast<__nv_bfloat16*>(kv), s);
    if (!e && route) *route = ROUTE_BF16_DOMAIN;
    return e;
  }
  if (dtype == 1) {
    ParamsW p;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.xo = static_cast<const __nv_bfloat16*>(xo ? xo : x);
    p.mask = static_cast<const uint8_t*>(mask);
    p.vecs = static_cast<const float*>(vecs);
    p.fc1b = static_cast<const float*>(fc1b);
    p.coefs = static_cast<const float*>(coefs);
    p.qkv = static_cast<__nv_bfloat16*>(kv);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.T = T; p.w = w > 0 ? w : 0; p.mode = mode;
    p.tiles = B * ((T + WG_ROWS - 1) / WG_ROWS);
    p.C = c;
    p.D = c / n_head;
    p.ks = c / 64;
    p.nb = (c + 255) / 256;
    p.f1 = (p.ks + 3) / 4;
    p.slab = (SLAB / p.D) * p.D;
    p.att_rows = p.w > 8 ? 16 : 32;
    p.attn = p.w == 0 || p.w > MAX_W ? ATT_SCRATCH : ATT_BAND;
    e = c == 256 && n_head == 4 ? launch_wgmma<256>(p, ws, s) : launch_wgmma_any(p, ws, s);
    if (!e && route) *route = ROUTE_BF16;
    return e;
  }
  ParamsF p;
  p.x = static_cast<const float*>(x);
  p.xo = static_cast<const float*>(xo ? xo : x);
  p.mask = static_cast<const uint8_t*>(mask);
  p.vecs = static_cast<const float*>(vecs);
  p.fc1b = static_cast<const float*>(fc1b);
  p.coefs = static_cast<const float*>(coefs);
  for (int i = 0; i < 6; ++i) p.wt[i] = static_cast<const float*>(ws[i]);
  p.out = static_cast<float*>(out);
  p.B = B; p.T = T; p.C = c; p.NH = n_head; p.D = c / n_head;
  p.w = w > 0 ? w : 0; p.mode = mode;
  e = launch_f32(p, static_cast<float*>(kv), s);
  if (!e && route) *route = wgmma ? ROUTE_F32 : ROUTE_F32_DOMAIN;
  return e;
}

}  // extern "C"
