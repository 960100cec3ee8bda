"""The two routes for K1 / K6's float32 products on one card, side by side on
the production block (C 256, 4 heads, w 3, self mode, T 768):

(a) 3xTF32 on ``wgmma``: the shipped f32 kernel, the whole block (its eight
    launches) through ``fused_transformer_block``, device ms;
(b) CUDA-core FMA with the weight tile staged once per block and reused
    across every row of it: a register-tiled SGEMM (128 x 128 output tiles,
    8 x 8 a thread, 8-deep slices of A and W staged in shared memory) built
    here, run over the block's four products alone (q | k | v, proj, fc1,
    fc2) on the same rows, device ms; the rest of the block would come on
    top.

Prints one line per batch and a JSON line ``ROUTES {...}``; needs one card:

    python3 tools/f32_route_check.py [--batches 16 64 512]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FMA_SRC = r"""
// out (M, N) = A (M, K) . W (N, K)^T in f32 on the CUDA cores: a block of 256
// threads owns a 128 x 128 output tile; each 8-deep slice of A and W lands
// in shared memory (k-major) and serves the tile's 128 rows and columns;
// each thread sums an 8 x 8 sub-tile in registers, k in order.
extern "C" __global__ void __launch_bounds__(256)
sgemm_nt(const float* __restrict__ A, const float* __restrict__ W, float* __restrict__ out,
         int M, int N, int K) {
  __shared__ float As[2][8][128 + 4], Ws[2][8][128 + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * 128;
  // loader: thread i brings row (i / 2) of the tile, 4 k values at (i % 2) * 4
  const int lr = threadIdx.x / 2, lk = (threadIdx.x % 2) * 4;
  float acc[8][8] = {};
  auto load = [&](int buf, int k0) {
    const int ma = min(m0 + lr, M - 1), nw = min(n0 + lr, N - 1);
    const float4 a = *reinterpret_cast<const float4*>(A + (size_t)ma * K + k0 + lk);
    const float4 w = *reinterpret_cast<const float4*>(W + (size_t)nw * K + k0 + lk);
    As[buf][lk][lr] = a.x; As[buf][lk + 1][lr] = a.y; As[buf][lk + 2][lr] = a.z; As[buf][lk + 3][lr] = a.w;
    Ws[buf][lk][lr] = w.x; Ws[buf][lk + 1][lr] = w.y; Ws[buf][lk + 2][lr] = w.z; Ws[buf][lk + 3][lr] = w.w;
  };
  load(0, 0);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += 8) {
    const int cur = (k0 / 8) & 1;
    if (k0 + 8 < K) load(cur ^ 1, k0 + 8);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float a[8], w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[cur][k][ty * 4 + i];
        a[i + 4] = As[cur][k][64 + ty * 4 + i];
        w[i] = Ws[cur][k][tx * 4 + i];
        w[i + 4] = Ws[cur][k][64 + tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

extern "C" int sgemm_launch(const float* A, const float* W, float* out, int M, int N, int K,
                            void* stream) {
  dim3 grid((M + 127) / 128, (N + 127) / 128);
  sgemm_nt<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(A, W, out, M, N, K);
  return (int)cudaGetLastError();
}
"""


def build_fma():
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import build

    out = os.path.join(REPO, "build", "f32_route_check")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "sgemm.cu"), os.path.join(out, "libsgemm.so")
    with open(src, "w") as f:
        f.write(FMA_SRC)
    subprocess.run([build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    so = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    so.sgemm_launch.argtypes = [p, p, p, i, i, i, p]
    so.sgemm_launch.restype = i
    return so


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[16, 64, 512])
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as c

    smi = c.phase_build()
    so = build_fma()
    dev = "cuda"
    c_, t = 256, 768
    out = {"card": smi}
    for b in args.batches:
        x, xo, mask, packed = c.block_case("self", t, 7, b, torch.float32, dev, seed=t)
        with torch.no_grad():
            a_ms = c.device_ms(lambda: c.run_block("kernel", x, xo, mask, packed, "self", 7))
        m = b * t
        g = torch.Generator(device=dev).manual_seed(0)
        # the four products' operands: (rows, K) inputs and (N, K) weights
        shapes = [(3 * c_, c_), (c_, c_), (4 * c_, c_), (c_, 4 * c_)]
        ins = [torch.randn((m, k), generator=g, device=dev) for _, k in shapes]
        ws = [torch.randn((n, k), generator=g, device=dev) for n, k in shapes]
        outs = [torch.empty((m, n), device=dev) for n, _ in shapes]

        def products():
            stream = torch.cuda.current_stream().cuda_stream
            for (n, k), a_, w_, o_ in zip(shapes, ins, ws, outs):
                err = so.sgemm_launch(a_.data_ptr(), w_.data_ptr(), o_.data_ptr(), m, n, k,
                                      stream)
                if err:
                    raise RuntimeError(f"sgemm launch failed: {err}")
        products()
        torch.cuda.synchronize()
        got = outs[2][:64].double()
        ref = ins[2][:64].double() @ ws[2].double().t()
        fma_err = (got - ref).abs().max().item()
        b_ms = c.device_ms(products)
        flops = 2 * m * sum(n * k for n, k in shapes)
        out[str(b)] = dict(route_a_block_ms=a_ms, route_b_products_ms=b_ms,
                           route_b_tflops=flops / b_ms / 1e9, fma_max_abs_err_vs_f64=fma_err)
        print(f"B={b} T={t}: (a) 3xTF32 whole block {a_ms:.3f} ms; (b) FMA products alone "
              f"{b_ms:.3f} ms ({flops / b_ms / 1e9:.1f} TFLOP/s, max |d| vs f64 {fma_err:.2e}) "
              f"({smi})", flush=True)
        del x, xo, mask, packed, ins, ws, outs
        torch.cuda.empty_cache()
    print("ROUTES " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
