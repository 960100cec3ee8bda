// K7's float32 banded attention past its tiled kernel (band_attention.cu:
// half windows over 16, head rows over 512 bytes) at head widths up to 128
// runs on K1's f32 tensor-core attention (fused_block_f32_attend.cu: 3xTF32
// on wgmma, 64 query rows a block with their q split in shared memory, the
// 32-key tiles that meet the band, an online softmax), the same templates
// as the block's banded instances. Those kernels take their operands
// through a parameter type: K1's ParamsF, or BandParams here, whose q and
// output are (B, H, T, D) through element strides (batch, head, row; the
// stride of a dimension of size 1 is 0), with C = H D. A first launch
// (band_f32_prep_kernel) splits k and v (transposed) into TF32 parts in a
// scratch, in K1's layouts; q is read in place, the context written unsplit
// into the output. The function is K7's: the -1e4 penalty on masked keys,
// the band capped at the sequence, rows whose own key is masked zero (K1's
// invalid query rows).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace avdd_k1 {

struct BandIO {
  const void* q; const void* k; const void* v; void* out;
  long long sq[3], sk[3], sv[3], so[3];   // (batch, head, row), elements
};

struct BandParams {
  const uint8_t* mask;   // (B, T) bool
  int B, T, C, D, w;     // C = H D; 0 <= w < T
  int Tp;                // T rounded up to 32 keys
  BandIO io;
  // carved by launch_band_f32 from its scratch: k split (B T, C), v split
  // and transposed (B, C, Tp)
  float* khi; float* klo; float* vthi; float* vtlo;
};

// Floats of scratch launch_band_f32 takes.
inline long long band_f32_scratch_elems(long long B, long long H, long long T, long long D) {
  const long long C = H * D, Tp = (T + 31) / 32 * 32;
  return 2 * B * T * C + 2 * B * C * Tp;
}

// Launch on `stream` (D <= 128); return cudaGetLastError().
int launch_band_f32(BandParams p, float* scratch, cudaStream_t stream);

}  // namespace avdd_k1
