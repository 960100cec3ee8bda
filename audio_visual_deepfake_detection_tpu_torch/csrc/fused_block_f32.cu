// The float32 fused block kernel (K1 / K6 in f32: what the card is held to
// against the CPU), in a translation unit of its own so that it compiles
// beside the bfloat16 instances. See fused_block.cu for the design.

#include "fused_block.cuh"

namespace avdd_k1 {
namespace {

constexpr int NT = 256;         // threads per block
constexpr int NWARP = NT / 32;

// Plain LN (two-pass, f32) of one row held by a warp: lane owns channels
// lane + 32 i for i < nc (= C / 32 <= NC); writes the normalized values back.
template <int NC>
__device__ __forceinline__ void ln_plain_row(float (&v)[NC], int nc, int C) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (i < nc) s += v[i];
  const float mu = warp_sum(s) / C;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (i < nc) { const float r = v[i] - mu; s2 += r * r; }
  const float rs = rsqrtf(warp_sum(s2) / C + LN_EPS);
#pragma unroll
  for (int i = 0; i < NC; ++i) v[i] = (v[i] - mu) * rs;
}

// f32 products, register-tiled FMA: out[m, n] = sum_k A[m, k] Wt[n, k] for
// m < M, n < N (N a multiple of 64); A in shared memory (row stride lda), Wt
// (N, K) row-major in global memory. Thread t owns rows m0 + t/64 + 4i and
// columns n0 + t%64 + 64j (i, j < 4): a warp shares its rows (A is a
// broadcast) and each thread reads its W rows four k at a time (float4),
// summing k in order.
template <typename Epi>
__device__ __forceinline__ void gemm_fma(const float* A, int lda, int M, int K,
                                         const float* __restrict__ Wt, int N,
                                         Epi epi) {
  const int rg = threadIdx.x >> 6;
  const int c0 = threadIdx.x & 63;
  for (int n0 = 0; n0 < N; n0 += 256) {
    for (int m0 = 0; m0 < M; m0 += 16) {
      float acc[4][4];
      const float* arow[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        arow[i] = A + min(m0 + rg + 4 * i, M - 1) * lda;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      const float* wrow[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wrow[j] = Wt + (size_t)min(n0 + c0 + 64 * j, N - 1) * K;
      for (int k = 0; k < K; k += 4) {
        float4 wv[4], av[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = __ldg(reinterpret_cast<const float4*>(wrow[j] + k));
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(arow[i] + k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = acc[i][j];
            a = fmaf(av[i].x, wv[j].x, a);
            a = fmaf(av[i].y, wv[j].y, a);
            a = fmaf(av[i].z, wv[j].z, a);
            acc[i][j] = fmaf(av[i].w, wv[j].w, a);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + rg + 4 * i;
        if (m < M) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + c0 + 64 * j < N) epi(m, n0 + c0 + 64 * j, acc[i][j]);
        }
      }
    }
  }
}

// NC: channels a lane can hold per row / 32 (C <= 32 NC).
template <int NC>
__global__ void __launch_bounds__(NT)
fused_block_kernel(Params p) {
  using N = Num<float>;
  extern __shared__ __align__(16) float smem[];
  const int T_ = p.T, TQ = p.tq, mode = p.mode, C = p.C, NH = p.NH;
  const int nc = C / 32, D = C / NH, nd = D / 32;   // nd: a lane's channels of a head
  const Layout lay(TQ, p.phase == PHASE_WHOLE ? p.w : 0, C);
  const int hw = lay.hw, NKV = lay.nkv, NIN = lay.nin, LD = lay.ld, LDH = lay.ldh;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TQ;          // first query row of this tile
  const int in0 = r0 - hw - 1;             // seq row of input row 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* vecs = p.vecs;
  const float* x = static_cast<const float*>(p.x) + (size_t)b * T_ * C;
  const float* xo = static_cast<const float*>(p.xo) + (size_t)b * T_ * C;
  const float coef_attn = p.coefs ? p.coefs[2 * b] : 1.f;
  const float coef_mlp = p.coefs ? p.coefs[2 * b + 1] : 1.f;

  float* maskf = smem;                     // [NIN] 1 valid / 0 masked or outside
  float* R1 = smem + lay.mask_f;
  float* R2 = R1 + lay.r1_f;
  float* L0 = R1;                          // LN'd streams, NIN rows each
  float* L1 = R1 + NIN * LD;
  float* L2 = R1 + 2 * NIN * LD;

  // ---- 1. pre-LN of the input rows (zero outside the sequence) ----------
  for (int j = threadIdx.x; j < NIN; j += NT) {
    const int s = in0 + j;
    maskf[j] = (s >= 0 && s < T_ && p.mask[(size_t)b * T_ + s]) ? 1.f : 0.f;
  }
  for (int j = warp; j < NIN; j += NWARP) {
    const int s = in0 + j;
    const bool in = s >= 0 && s < T_;
    float vx[NC], vo[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const bool ok = in && i < nc;
      vx[i] = ok ? N::load(x, (size_t)s * C + lane + 32 * i) : 0.f;
      vo[i] = (ok && mode != MODE_SELF) ? N::load(xo, (size_t)s * C + lane + 32 * i) : 0.f;
    }
    if (in) {
      ln_plain_row(vx, nc, C);
      if (mode != MODE_SELF) ln_plain_row(vo, nc, C);
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i >= nc) continue;
      const int c = lane + 32 * i;
      const float z = in ? 1.f : 0.f;   // rows outside the sequence stay 0
      const float* v = vecs;
      L0[j * LD + c] = z * N::rnd(vx[i] * v[ROW_LNQ_W * C + c] + v[ROW_LNQ_B * C + c]);
      if (mode == MODE_DS_SELF) {
        L1[j * LD + c] = z * N::rnd(vo[i] * v[ROW_LNQ_W * C + c] + v[ROW_LNQ_B * C + c]);
      } else if (mode != MODE_SELF) {
        L1[j * LD + c] = z * N::rnd(vo[i] * v[ROW_LNK_W * C + c] + v[ROW_LNK_B * C + c]);
        const float vv = mode == MODE_QV_K ? vx[i] : vo[i];
        L2[j * LD + c] = z * N::rnd(vv * v[ROW_LNV_W * C + c] + v[ROW_LNV_B * C + c]);
      }
    }
  }
  __syncthreads();

  // ---- 2. depthwise k3 conv (masked) + plain LN -> PQ, PK, PV -----------
  float* PQ = R2;
  float* PK = R2 + TQ * LD;
  float* PV = R2 + (TQ + NKV) * LD;
  const int ntask = p.phase == PHASE_ATTN ? TQ : TQ + 2 * NKV;
  for (int task = warp; task < ntask; task += NWARP) {
    int which, i;                          // 0 q, 1 k, 2 v; kv-local row i
    if (task < TQ) { which = 0; i = task + hw; }
    else if (task < TQ + NKV) { which = 1; i = task - TQ; }
    else { which = 2; i = task - TQ - NKV; }
    const int row0 = which == 0 ? ROW_QCONV : (which == 1 ? ROW_KCONV : ROW_VCONV);
    const int jc = i + 1;                  // input row of the conv centre
    const float mv = maskf[jc];
    const float* src = (mode == MODE_SELF || which == 0) ? L0 : (which == 1 ? L1 : L2);
    float y[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      y[k] = 0.f;
      if (k >= nc) continue;
      const int c = lane + 32 * k;
      const float w0 = vecs[row0 * C + c], w1 = vecs[(row0 + 1) * C + c],
                  w2 = vecs[(row0 + 2) * C + c];
      float acc;
      if (mode == MODE_DS_SELF)   // y[i] = w0 odd[i-1] + w1 even[i] + w2 odd[i]
        acc = L1[(jc - 1) * LD + c] * w0 + L0[jc * LD + c] * w1 + L1[jc * LD + c] * w2;
      else
        acc = src[(jc - 1) * LD + c] * w0 + src[jc * LD + c] * w1 + src[(jc + 1) * LD + c] * w2;
      y[k] = N::rnd(acc * mv);
    }
    ln_plain_row(y, nc, C);
    float* dst = which == 0 ? PQ + (i - hw) * LD : (which == 1 ? PK : PV) + i * LD;
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (k < nc) dst[lane + 32 * k] = N::rnd(y[k]);
  }
  __syncthreads();

  // ---- 3. q/k/v dense -----------------------------------------------------
  float* Qd = R1;
  float* Kd = R1 + TQ * LD;
  float* Vd = R1 + (TQ + NKV) * LD;
  const float qscale = N::rnd(1.f / sqrtf((float)D));
  if (p.phase != PHASE_KV)
    gemm_fma(PQ, LD, TQ, C, static_cast<const float*>(p.wq), C,
             [&](int m, int n, float acc) {
               const float q = N::rnd(N::rnd(acc) + N::rnd(vecs[ROW_Q_BIAS * C + n]));
               Qd[m * LD + n] = N::rnd(q * qscale);
             });
  if (p.phase != PHASE_ATTN) {
    gemm_fma(PK, LD, NKV, C, static_cast<const float*>(p.wk), C,
             [&](int m, int n, float acc) {
               Kd[m * LD + n] = N::rnd(N::rnd(acc) + N::rnd(vecs[ROW_K_BIAS * C + n]));
             });
    gemm_fma(PV, LD, NKV, C, static_cast<const float*>(p.wv), C,
             [&](int m, int n, float acc) {
               Vd[m * LD + n] = N::rnd(N::rnd(acc) + N::rnd(vecs[ROW_V_BIAS * C + n]));
             });
  }
  __syncthreads();
  if (p.phase == PHASE_KV) {   // k | v rows of this tile (hw = 0: row i = seq r0 + i)
    float* kvb = static_cast<float*>(p.kv) + (size_t)b * T_ * 2 * C;
    for (int idx = threadIdx.x; idx < TQ * C; idx += NT) {
      const int i = idx / C, c = idx % C;
      if (r0 + i < T_) {
        N::store(kvb, (size_t)(r0 + i) * 2 * C + c, Kd[i * LD + c]);
        N::store(kvb, (size_t)(r0 + i) * 2 * C + C + c, Vd[i * LD + c]);
      }
    }
    return;
  }

  // ---- 4. attention: one warp per (query row, head); lane owns channels
  // h D + lane + 32 e of its head, e < nd
  float* CTX = R2;
  const float* kvs = static_cast<const float*>(p.kv) + (size_t)b * T_ * 2 * C;
  const uint8_t* mrow = p.mask + (size_t)b * T_;
  for (int task = warp; task < TQ * NH; task += NWARP) {
    const int i = task / NH, h = task % NH;
    const int cb = h * D + lane;
    const float mq = maskf[i + hw + 1];
    float qv[4], o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) qv[e] = e < nd ? Qd[i * LD + cb + 32 * e] : 0.f;
    if (p.w > 0) {
      // banded: scores in the compute dtype (rounded products, f32 sum),
      // -1e4 penalty on masked keys, -1e30 outside the sequence, f32 softmax;
      // keys from the halo in shared memory or, tiled, from the scratch
      const float pen = N::rnd(-NEG_PENALTY);
      const int w = p.w;
      auto score = [&](int d) {   // offset d's score, the same bits on every call
        const int s = r0 + i + d;                  // the key's sequence row
        const bool inseq = s >= 0 && s < T_;
        float e = 0.f;
        bool valid;
        if (hw > 0) {
          const int kk = i + hw + d;               // kv-local key row
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < nd) e += N::rnd(qv[c] * Kd[kk * LD + cb + 32 * c]);
          valid = maskf[kk + 1] > 0.5f;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < nd && inseq) e += N::rnd(qv[c] * kvs[(size_t)s * 2 * C + cb + 32 * c]);
          valid = inseq && mrow[s];
        }
        float v = N::rnd(warp_sum(e));
        v = N::rnd(v + (valid ? 0.f : pen));
        return inseq ? v : NEG_INF;
      };
      auto add_value = [&](int d, float pr) {
        const int s = r0 + i + d;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= nd) continue;
          float vv;
          if (hw > 0) vv = Vd[(i + hw + d) * LD + cb + 32 * c];
          else vv = (s >= 0 && s < T_) ? kvs[(size_t)s * 2 * C + C + cb + 32 * c] : 0.f;
          o[c] = N::rnd(o[c] + N::rnd(pr * vv));
        }
      };
      float mx = -CUDART_INF_F;
      if (w <= MAX_W) {   // the score row in registers
        float sc[2 * MAX_W + 1];
        for (int d = -w; d <= w; ++d) {
          sc[d + w] = score(d);
          mx = fmaxf(mx, sc[d + w]);
        }
        float den = 0.f;
        for (int d = 0; d <= 2 * w; ++d) { sc[d] = expf(sc[d] - mx); den += sc[d]; }
        const float inv = 1.f / den;
        for (int d = -w; d <= w; ++d) add_value(d, N::rnd(sc[d + w] * inv));
      } else {            // wider: three passes over the offsets, scores recomputed
        for (int d = -w; d <= w; ++d) mx = fmaxf(mx, score(d));
        float den = 0.f;
        for (int d = -w; d <= w; ++d) den += expf(score(d) - mx);
        const float inv = 1.f / den;
        for (int d = -w; d <= w; ++d) add_value(d, N::rnd(expf(score(d) - mx) * inv));
      }
    } else if (p.phase == PHASE_ATTN) {
      // dense, tiled: all T keys from the scratch, three passes over them
      // (scores recomputed bit for bit); -1e30 fill on invalid keys, values
      // masked, f32 softmax
      const float fill = N::rnd(NEG_INF);
      auto score = [&](int j) {
        const size_t r = (size_t)j * 2 * C;
        float e = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < nd) e += qv[c] * kvs[r + cb + 32 * c];
        const float v = N::rnd(warp_sum(e));
        return mrow[j] ? v : fill;
      };
      float mx = -CUDART_INF_F;
      for (int j = 0; j < T_; ++j) mx = fmaxf(mx, score(j));
      float den = 0.f;
      for (int j = 0; j < T_; ++j) den += expf(score(j) - mx);
      for (int j = 0; j < T_; ++j) {
        const float pj = N::rnd(expf(score(j) - mx) / den);
        const float mj = mrow[j] ? 1.f : 0.f;
        const size_t r = (size_t)j * 2 * C + C;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < nd) o[c] += pj * N::rnd(kvs[r + cb + 32 * c] * mj);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] = N::rnd(o[c]);
    } else {
      // dense (whole sequence, T <= 31): lane j keeps the score of key j;
      // -1e30 fill on invalid keys, values masked, f32 softmax
      float mine = -CUDART_INF_F;
      const float fill = N::rnd(NEG_INF);
      for (int j = 0; j < T_; ++j) {
        float e = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < nd) e += qv[c] * Kd[j * LD + cb + 32 * c];
        float v = N::rnd(warp_sum(e));
        v = maskf[j + 1] > 0.5f ? v : fill;
        if (lane == j) mine = v;
      }
      const float mx = warp_max(mine);
      const float e = lane < T_ ? expf(mine - mx) : 0.f;
      const float pr = N::rnd(e / warp_sum(e));
      for (int j = 0; j < T_; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
        const float mj = maskf[j + 1];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < nd) o[c] += pj * N::rnd(Vd[j * LD + cb + 32 * c] * mj);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] = N::rnd(o[c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < nd) CTX[i * LD + cb + 32 * c] = o[c] * mq;   // zero invalid query rows
  }
  __syncthreads();

  // ---- 5. proj + masked skip + layer-scaled residual -> Y1 ---------------
  float* Y1 = R2 + TQ * LD;
  gemm_fma(CTX, LD, TQ, C, static_cast<const float*>(p.wp), C,
           [&](int m, int n, float acc) {
             const int s = r0 + m;
             const float mq = maskf[m + hw + 1];
             float y1 = 0.f;
             if (s < T_) {
               const float att = N::rnd(N::rnd(acc) + N::rnd(vecs[ROW_P_BIAS * C + n])) * mq;
               float skip = N::load(x, (size_t)s * C + n);
               if (mode == MODE_DS_SELF) {   // MaxPool(3, 2, 1), -inf padding
                 const float om1 = s > 0 ? N::load(xo, (size_t)(s - 1) * C + n) : -CUDART_INF_F;
                 skip = fmaxf(fmaxf(om1, skip), N::load(xo, (size_t)s * C + n));
               }
               y1 = N::rnd(skip * mq + N::rnd(att * N::rnd(vecs[ROW_SCALE_ATTN * C + n] * coef_attn)));
             }
             Y1[m * LD + n] = y1;
           });
  __syncthreads();

  // ---- 6. plain LN (ln2 affine folded into wf1) -> HL --------------------
  float* HL = R2 + 2 * TQ * LD;
  for (int m = warp; m < TQ; m += NWARP) {
    float v[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) v[k] = k < nc ? Y1[m * LD + lane + 32 * k] : 0.f;
    ln_plain_row(v, nc, C);
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (k < nc) HL[m * LD + lane + 32 * k] = N::rnd(v[k]);
  }
  __syncthreads();

  // ---- 7. fc1 + GELU -> HID (TQ x 4C) ------------------------------------
  float* HID = R1;
  gemm_fma(HL, LD, TQ, C, static_cast<const float*>(p.wf1), 4 * C,
           [&](int m, int n, float acc) {
             const float h = N::rnd(N::rnd(acc) + N::rnd(p.fc1b[n]));
             HID[m * LDH + n] = N::rnd(gelu<false>(h));
           });
  __syncthreads();

  // ---- 8. fc2 + masked, layer-scaled residual -> out ---------------------
  float* out = static_cast<float*>(p.out) + (size_t)b * T_ * C;
  gemm_fma(HID, LDH, TQ, 4 * C, static_cast<const float*>(p.wf2), C,
           [&](int m, int n, float acc) {
             const int s = r0 + m;
             if (s >= T_) return;
             const float mq = maskf[m + hw + 1];
             const float h = N::rnd(N::rnd(acc) + N::rnd(vecs[ROW_FC2_BIAS * C + n])) * mq;
             const float y = N::rnd(Y1[m * LD + n] +
                                    N::rnd(h * N::rnd(vecs[ROW_SCALE_MLP * C + n] * coef_mlp)));
             N::store(out, (size_t)s * C + n, y);
           });
}

template <int NC>
int launch_f32_nc(Params p, int B, int bytes, cudaStream_t stream) {
  static int configured = 0;    // largest dynamic smem size set so far
  if (int e = set_smem(fused_block_kernel<NC>, bytes, configured)) return e;
  dim3 grid((p.T + p.tq - 1) / p.tq, B);
  if (p.phase == PHASE_WHOLE) {
    fused_block_kernel<NC><<<grid, NT, bytes, stream>>>(p);
    return (int)cudaGetLastError();
  }
  p.phase = PHASE_KV;
  fused_block_kernel<NC><<<grid, NT, bytes, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  p.phase = PHASE_ATTN;
  fused_block_kernel<NC><<<grid, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_f32(const Params& p, int B, int bytes, cudaStream_t stream) {
  if (p.C <= 256) return launch_f32_nc<8>(p, B, bytes, stream);
  if (p.C <= 512) return launch_f32_nc<16>(p, B, bytes, stream);
  return launch_f32_nc<32>(p, B, bytes, stream);
}

}  // namespace avdd_k1
