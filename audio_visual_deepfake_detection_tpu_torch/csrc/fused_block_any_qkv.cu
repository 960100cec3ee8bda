// The first launch (q / k / v) of the bfloat16 fused block kernel (K1 / K6)
// for any shape of its domain, in a translation unit of its own so that it
// compiles beside fused_block_any.cu's second launch. See fused_block.cu.

#include "fused_block.cuh"

namespace avdd_k1 {

int launch_qkv_any(const WeightMaps& maps, const ParamsW& p, int smem, cudaStream_t stream) {
  return launch_phase<PHASE_QKV, 0>(maps, p, smem, stream);
}

}  // namespace avdd_k1
