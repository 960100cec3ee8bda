// Shared device helpers of the port's kernels: compute-dtype
// load/round/store, warp reductions, paired bf16 arithmetic, the bf16 tensor-core
// instruction (mma.sync m16n8k16, f32 accumulate) with its fragment loads,
// and asynchronous 16-byte copies into shared memory. wgmma.cuh adds the
// warpgroup instruction on top of these.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace avdd {

constexpr int SMEM_MAX = 232448;   // dynamic shared memory a Hopper block can have

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ __forceinline__ static float load(const float* p, size_t i) { return __ldg(p + i); }
  __device__ __forceinline__ static float rnd(float v) { return v; }
  __device__ __forceinline__ static void store(float* p, size_t i, float v) { p[i] = v; }
  __device__ __forceinline__ static void store2(float* p, size_t i, float a, float b) {
    *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
  }
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
  __device__ __forceinline__ static void store2(__nv_bfloat16* p, size_t i, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Exact GELU, x Phi(x) with erf, as torch's and jax.nn.gelu(approximate=False).
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// Two bf16 products / sums, each rounded once to bf16 (round to nearest
// even), as an elementwise bf16 multiply / add in torch rounds them.
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, one row address per lane
// (lanes 8 i .. 8 i + 7 give the rows of matrix i); thread (g, t) of the warp
// receives elements [g][2 t], [g][2 t + 1] of each matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// B fragment (k = rows r0 .. r0 + 15, n = columns c0 .. c0 + 7) of a
// row-major (k, n) bf16 shared tile, transposed on the way by ldmatrix.
__device__ __forceinline__ void frag_b_trans(uint32_t& b0, uint32_t& b1,
                                             const __nv_bfloat16* tile, int ld, int r0, int c0) {
  const __nv_bfloat16* src = tile + (r0 + (threadIdx.x % 16)) * ld + c0;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1) : "r"(addr));
}

// One asynchronous 16-byte copy global -> shared; `bytes` < 16 zero-fills the
// rest (0: the whole chunk). The caller commits the group and waits for it.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A 65,536-entry table of f over every bf16 value, f's result rounded to bf16:
// where the input of an elementwise function is already rounded to bf16 (the
// GELU after a rounded LN or bias), one load replaces its arithmetic and
// gives the same bits as computing it. `table` is a __device__ array of the
// caller's file; fill_table builds it on `stream` at the first call per device
// (into a graph too while one is being captured, then on every replay) and
// waits for it outside a capture.
template <typename F>
__global__ void fill_table_kernel(__nv_bfloat16* table, F f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 65536) table[i] = __float2bfloat16_rn(f(__bfloat162float(__ushort_as_bfloat16((unsigned short)i))));
}
template <typename F>
int fill_table(__nv_bfloat16* table, F f, unsigned& ready_devices, cudaStream_t stream) {
  int dev = 0;
  if (int e = (int)cudaGetDevice(&dev)) return e;
  if (ready_devices >> dev & 1u) return 0;
  fill_table_kernel<<<256, 256, 0, stream>>>(table, f);
  if (int e = (int)cudaGetLastError()) return e;
  cudaStreamCaptureStatus capture;
  if (int e = (int)cudaStreamIsCapturing(stream, &capture)) return e;
  if (capture != cudaStreamCaptureStatusNone) return 0;
  if (int e = (int)cudaStreamSynchronize(stream)) return e;
  ready_devices |= 1u << dev;
  return 0;
}
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Raise a kernel's dynamic shared-memory limit once per size.
template <typename K>
int set_smem(K kernel, int bytes, int& configured) {
  if (bytes <= configured) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e == cudaSuccess) configured = bytes;
  return (int)e;
}

}  // namespace avdd
