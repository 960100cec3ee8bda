"""PyTorch port, the float32 fused block (K1 / K6 in f32): what the CPU can
hold of the kernel's design.

f32 is the compute dtype of every shipped YAML (no YAML sets ``tpu:
compute_dtype``, and both packages' loaders default to float32), so the f32
kernel is what the CLIs run on a shipped config. On the card its products
are 3xTF32 on the tensor cores (``csrc/fused_block_f32.cu``: each operand
split into a TF32 high part and a TF32 residual, hi.hi + hi.lo + lo.hi
summed in f32) and its attention an online softmax over 32-key tiles
(``csrc/fused_block_f32_attend.cu``). Here:

- the shipped YAMLs load with compute_dtype float32 in both packages;
- ``tf32_split``: the high part carries at most 10 mantissa bits and hi +
  lo is x to 2^-22 of it;
- ``split_matmul`` (the split alone: the three products summed in f32 round
  to nearest) stays within 2x the f32 matmul's own distance from an f64
  product, at C = 256 and 1024 and the block's four contractions;
- the kernel's sum as the card forms it, in a model of the tensor cores'
  accumulation (``_tc_matmul``: each k8 step's products exact, aligned to
  the largest term, cut toward zero), stays within 2x a sequential f32 FMA
  sum's distance from f64 (the order of the FMA kernel it replaced), with
  its 32-deep stages folded in f32; a whole contraction left in the tensor
  cores does not;
- the attention launch's tiling rendered in torch (``_attend_tiles_f32``:
  64-row blocks, 32-key tiles, the masks, the online softmax, the split
  products) against ``attention_ctx`` in f32: dense and banded, ragged T,
  masked keys, a fully padded sample."""

import math
import os

import numpy as np
import pytest
import torch

from audio_visual_deepfake_detection_tpu.core import config as jconfig
from audio_visual_deepfake_detection_tpu_torch.core import config as tconfig
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as tfb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = ["configs_train/deepfake_exp5.yaml", "configs_train/deepfake_exp10.yaml",
           "configs_train/deepfake_exp13.yaml", "configs_test/deepfake_exp12_test.yaml"]


@pytest.mark.parametrize("path", SHIPPED)
def test_shipped_yaml_computes_in_float32(path):
    """Neither package's loader gives a shipped YAML another dtype: the f32
    kernel is the one its CLIs run."""
    full = os.path.join(REPO, path)
    assert jconfig.arch_config_from(jconfig.load_config(full)).compute_dtype == "float32"
    assert tconfig.arch_config_from(tconfig.load_config(full)).compute_dtype == "float32"


# ------------------------------------------------------------ the split

def _mantissa_low_bits(x):
    return x.contiguous().view(torch.int32) & 0x1FFF


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_tf32_split_parts(rng, scale):
    x = torch.from_numpy((rng.standard_normal(4096) * scale).astype(np.float32))
    x[:4] = torch.tensor([0.0, -0.0, 1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -12)])
    hi, lo = tfb.tf32_split(x)
    assert int(_mantissa_low_bits(hi).abs().max()) == 0     # at most 10 mantissa bits
    assert int(_mantissa_low_bits(lo).abs().max()) == 0
    assert torch.all((hi - x).abs() <= x.abs() * 2.0 ** -11)
    assert torch.all((hi.double() + lo.double() - x.double()).abs()
                     <= x.abs().double() * 2.0 ** -22)
    # to nearest, ties away from zero (cvt.rna.tf32.f32)
    assert hi[2].item() == 1.0 + 2.0 ** -10
    assert hi[3].item() == -(1.0 + 2.0 ** -10)


@pytest.mark.parametrize("c,k", [(256, 256), (256, 1024), (1024, 1024), (1024, 4096)])
def test_split_matmul_as_close_to_f64_as_f32(rng, c, k):
    """The block's contractions (K = C for q, k, v, proj and fc1, 4C for
    fc2): the 3xTF32 split within 2x the f32 matmul's own max distance from
    the f64 product. The split alone: its sums round to nearest, where the
    card's tensor cores cut toward zero (the next test models that)."""
    a = torch.from_numpy(rng.standard_normal((256, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((c, k)) / math.sqrt(k)).astype(np.float32))
    ref = a.double() @ w.double().t()
    f32 = (a @ w.t()).double() - ref
    split = tfb.split_matmul(a, w).double() - ref
    assert split.abs().max().item() <= 2 * f32.abs().max().item()
    # the left-out lo.lo is no floor: dropping hi.lo would be 2^11 further
    ah, _ = tfb.tf32_split(a)
    wh, _ = tfb.tf32_split(w)
    assert (ah @ wh.t()).double().sub(ref).abs().max() > 100 * split.abs().max()


# --------------------------------- the tensor cores' accumulation (a model)

# the model lives in tests/tf32_model.py, shared with the f32 MViT tests
from tf32_model import fma_matmul as _fma_matmul  # noqa: E402
from tf32_model import tc_matmul as _tc_matmul  # noqa: E402


@pytest.mark.parametrize("k", [256, 1024, 4096])
@pytest.mark.parametrize("kind", ["ln", "gelu"])
def test_tc_stage_sum_as_close_to_f64_as_fma(rng, kind, k):
    """The kernel's 32-deep stages, each a truncating tensor-core sum folded
    into f32, within 2x the sequential f32 FMA sum's max distance from the
    f64 product, on LN'd rows (q, k, v, fc1's input) and GELU outputs
    (fc2's); at K = 4096 (fc2 at C = 1024) the whole contraction in one
    tensor-core sum is more than 2x off: the per-stage fold is what keeps
    the kernel at f32's accuracy in this model."""
    a = torch.from_numpy(rng.standard_normal((128, k)).astype(np.float32))
    if kind == "gelu":
        a = tfb._gelu_exact(a)
    w = torch.from_numpy((rng.standard_normal((64, k)) / math.sqrt(k)).astype(np.float32))
    ref = a.double() @ w.double().t()
    fma = (_fma_matmul(a, w) - ref).abs().max().item()
    assert (_tc_matmul(a, w, 32) - ref).abs().max().item() <= 2 * fma
    if k == 4096:
        assert (_tc_matmul(a, w, 0) - ref).abs().max().item() > 2 * fma


# -------------------------------------- the attention launch's tiling (f32)

ROWS, KEYS = 64, 32      # csrc/fused_block_f32_attend.cu: query rows a block, keys a tile


def _attend_tiles_f32(q, k, v, valid, n_head, w):
    """csrc/fused_block_f32_attend.cu's arithmetic in torch on f32 (B, T, C)
    q (scaled), k, v and a (B, T) bool mask: per (sample, head, block of 64
    query rows) the key tiles of 32 it visits (all; a band: those meeting
    [r0 - w, r0 + 63 + w]), scores by ``split_matmul``, the masks (dense:
    -1e30 on invalid keys, -inf past T; banded: the -1e4 penalty on masked
    keys, -inf outside the band and T), a running maximum, denominator and
    context rescaled tile by tile (p of a dense invalid key counted in the
    denominator, zero in P.V), P.V by ``split_matmul`` over v^T, the context
    divided by the denominator at the end; invalid rows zero."""
    b, t, c = q.shape
    d = c // n_head
    out = torch.zeros_like(q)
    for bi in range(b):
        for h in range(n_head):
            sl = slice(h * d, (h + 1) * d)
            for r0 in range(0, t, ROWS):
                rows = torch.arange(r0, min(r0 + ROWS, t))
                lo, hi = 0, (t - 1) // KEYS
                if w > 0:
                    lo, hi = max(r0 - w, 0) // KEYS, min(r0 + ROWS - 1 + w, t - 1) // KEYS
                m = torch.full((len(rows),), -math.inf)
                z = torch.zeros(len(rows))
                o = torch.zeros(len(rows), d)
                for j in range(lo, hi + 1):
                    keys = torch.arange(j * KEYS, (j + 1) * KEYS)
                    inseq = keys < t
                    at = keys.clamp(max=t - 1)
                    kk = k[bi, at, sl] * inseq[:, None]
                    vv = v[bi, at, sl] * inseq[:, None]
                    ok = inseq & valid[bi, at]
                    s = tfb.split_matmul(q[bi, rows, sl], kk)
                    if w > 0:
                        s = torch.where(ok[None], s, s + tfb.NEG_PENALTY)
                        far = (keys[None] - rows[:, None]).abs() > w
                        s = torch.where(far | ~inseq[None], -math.inf, s)
                    else:
                        s = torch.where(ok[None], s,
                                        torch.where(inseq[None], tfb.NEG_INF, -math.inf))
                    mn = torch.maximum(m, s.amax(1))
                    mu = torch.where(mn == -math.inf, 0.0, mn)
                    sc = torch.exp(m - mu)
                    e = torch.exp(s - mu[:, None])
                    z = z * sc + e.sum(1)
                    if w <= 0:
                        e = e * ok[None]
                    o = o * sc[:, None] + tfb.split_matmul(e, vv.t().contiguous())
                    m = mn
                out[bi, rows, sl] = (o / z[:, None]) * valid[bi, rows][:, None]
    return out


@pytest.mark.parametrize("t,heads,d,w", [(150, 2, 64, 0), (65, 4, 32, 0), (24, 1, 128, 0),
                                         (1, 2, 96, 0), (100, 2, 64, 3), (97, 2, 32, 1),
                                         (150, 2, 64, 20), (300, 1, 32, 48),
                                         (130, 2, 96, 100)])
def test_f32_attention_tiling_matches_plain(rng, t, heads, d, w):
    """The f32 attention launch's tiling and online softmax (torch
    rendering) against the plain ``attention_ctx`` in f32, dense and banded
    (w <= 16 too: the f32 kernel takes every window on the tensor cores) at
    ragged T: a padded tail, a fully padded sample, a band wider than T (the
    f32 block tolerance, 2e-5)."""
    c = heads * d
    lens = [t, (3 * t) // 4, 0]
    valid = torch.from_numpy(np.arange(t)[None, :] < np.asarray(lens)[:, None])
    q, k, v = (torch.from_numpy(rng.standard_normal((3, t, c)).astype(np.float32))
               for _ in range(3))
    q = q * d ** -0.5
    got = _attend_tiles_f32(q, k, v, valid, heads, w)
    ref = tfb.attention_ctx(q, k, v, valid.float()[..., None], n_head=heads, w_overlap=w)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
