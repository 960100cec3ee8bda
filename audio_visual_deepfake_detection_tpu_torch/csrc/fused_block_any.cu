// The bfloat16 fused block kernel (K1 / K6) for any shape of its domain
// (fused_block.cuh::launch_wgmma<0>): its second launch here, its first in
// fused_block_any_qkv.cu, so that the two compile beside fused_block.cu.
// See fused_block.cu.

#include "fused_block.cuh"

namespace avdd_k1 {

int launch_wgmma_any(ParamsW& p, const void* const* w, cudaStream_t stream) {
  return launch_wgmma<0>(p, w, stream);
}

}  // namespace avdd_k1
