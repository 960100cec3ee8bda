"""PyTorch port, K5 (the Emotion2Vec conv extractor) in float32: what the
CPU can hold of its tensor-core route.

On the card (``csrc/conv_extractor.cu::conv_ln_gelu_tf32_kernel``) layers
1-6 are an implicit GEMM in 3xTF32 on ``wgmma``: a cluster of four blocks
covers a tile of 128 frames of one sample, block r output channels 128 r ..
128 r + 127; each 32-deep slice of A is one box of a per-tap 3-D view of the
previous layer's output (frames at stride s 512, zeros past the layer's
end), W is packed (512, k 512), taps outermost, and split into TF32 hi and
lo parts at packing; each stage's tensor-core sum (hi.lo, lo.hi, hi.hi) is
added into f32 accumulators; the LN statistics of a frame are the sum of
the four blocks' 128-column partial sums, exchanged through distributed
shared memory. Here, in the tensor-core model of ``tests/tf32_model.py``:
- the per-tap tile views reproduce every layer's Conv1d (f64), with several
  tiles a sample and a ragged last one;
- the whole stack, products by ``tc_matmul`` per 32-deep stage and LN
  statistics from four 128-column partial sums in the kernel's order,
  against ``conv_extractor_math`` and the JAX ``fused_conv_extractor`` in
  the Pallas interpreter (atol 1e-4, rtol 5e-4: ``chip_smoke.py``'s f32
  rule), and each layer's product against f64 no further than the first
  design's order (one f32 FMA a product, ``fma_matmul``);
- the packing: hi + lo is W to 2^-22, every tap where the A views read it,
  and the CPU wrapper still the plain version on the exact weights."""

import torch_one_thread  # noqa: F401

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from tf32_model import fma_matmul, tc_matmul
from audio_visual_deepfake_detection_tpu.frontends import emotion2vec as je2v
from audio_visual_deepfake_detection_tpu.ops.pallas import conv_extractor as jk5
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import conv_extractor as tk5
from audio_visual_deepfake_detection_tpu_torch.ops.kernels.fused_block import tf32_split

ROWS, KS, CL = 128, 32, 4            # frames a tile, values a stage, blocks a cluster
TOL = dict(atol=1e-4, rtol=5e-4)
CH = tk5.CH


@pytest.fixture
def rng():
    return np.random.default_rng(20)


def _setup(rng, b, length):
    """The JAX extractor's params in its tree (conv_i kernels (k, in, out),
    ln_i scale and bias; conv weights at the fan-in's scale, LN affines
    1 + 0.2 N and 0.2 N), the same weights in torch's (out, in, k) layout,
    the (14, 512) LN rows and b wavs."""
    p, c_in = {}, 1
    for i, (dim, k, _) in enumerate(je2v.CONV_SPEC):
        p[f"conv_{i}"] = {"kernel": (rng.standard_normal((k, c_in, dim))
                                     * (k * c_in) ** -0.5).astype(np.float32)}
        p[f"ln_{i}"] = {"scale": (1 + 0.2 * rng.standard_normal(dim)).astype(np.float32),
                        "bias": (0.2 * rng.standard_normal(dim)).astype(np.float32)}
        c_in = dim
    weights = [torch.from_numpy(np.transpose(p[f"conv_{i}"]["kernel"], (2, 1, 0)).copy())
               for i in range(7)]
    ln = torch.from_numpy(np.stack([p[f"ln_{i}"][k] for i in range(7)
                                    for k in ("scale", "bias")]))
    wav = (rng.standard_normal((b, length)) * 0.5).astype(np.float32)
    return {"params": p}, torch.from_numpy(wav), weights, ln


def tap_tiles(x, k, s, t_out):
    """The A tiles one layer's clusters read, in the producer's order: for
    each sample and each tile of 128 frames, the (128, k 512) rows whose
    32-value slice kb is tap kb // 16, channels 32 (kb % 16) .. + 31 of the
    per-tap view (frame t reads row s t + tap of x), zeros past ``t_out``.
    Returns [(sample, t0, tile)]."""
    b, t_in, ch = x.shape
    tiles = []
    for q in range(b * -(-t_out // ROWS)):
        bb, t0 = divmod(q, -(-t_out // ROWS))
        t0 *= ROWS
        tile = torch.zeros((ROWS, k * ch), dtype=x.dtype)
        for kb in range(k * ch // KS):
            tap, c0 = divmod(kb * KS, ch)
            view = x.as_strided((t_out, ch), (s * ch, 1), x[bb].storage_offset() + tap * ch)
            rows = view[t0:t0 + ROWS, c0:c0 + KS]
            tile[:rows.shape[0], KS * kb:KS * kb + KS] = rows
        tiles.append((bb, t0, tile))
    return tiles


def quarter_stats(y):
    """A frame's LN (sum, sum of squares) over 512 columns as the kernel
    forms them: in each block r (columns 128 r ..), thread t of a quad sums
    its 32 columns 8 j + 2 t + e (j < 16, e < 2) in order, the quad adds
    t ^ 1 then t ^ 2, and every block adds the four blocks' sums in rank
    order. y (M, 512) f32 -> two (M,) f32."""
    q = y.reshape(-1, CL, CH // CL // 8, 4, 2)              # (row, rank, j, t, e)
    s = torch.zeros(q.shape[0], CL, 4)
    s2 = torch.zeros_like(s)
    for j in range(q.shape[2]):
        for e in range(2):
            v = q[:, :, j, :, e]
            s, s2 = s + v, s2 + v * v
    for part in (s, s2):
        part.copy_(part + part[:, :, [1, 0, 3, 2]])
        part.copy_(part + part[:, :, [2, 3, 0, 1]])
    tot, tot2 = torch.zeros(y.shape[0]), torch.zeros(y.shape[0])
    for r in range(CL):
        tot, tot2 = tot + s[:, r, 0], tot2 + s2[:, r, 0]
    return tot, tot2


def ln_gelu(y, stats, ln_w, ln_b):
    s, s2 = stats
    mean = s / CH
    rs = torch.rsqrt(torch.clamp(s2 / CH - mean * mean, min=0.0) + tk5.LN_EPS)
    return F.gelu((y - mean[:, None]) * (rs[:, None] * ln_w) + ln_b)


def model_stack(wav, weights, ln, product):
    """Layers 1-6 of the f32 route over the tile views, ``product(a, w)`` the
    (rows, 512) pre-LN sums of a tile's rows; layer 0 (K = 10, CUDA cores,
    unchanged) is the plain version's. Returns the features and each
    layer's (input, pre-LN sums)."""
    packed = tk5.pack_conv_extractor(weights, ln, torch.float32)
    lens = tk5.layer_lengths(wav.shape[1])
    x = tk5.conv_extractor_math(wav, weights[:1], ln, torch.float32, spec=tk5.CONV_SPEC[:1])
    layers = []
    for i in range(1, 7):
        _, k, s = tk5.CONV_SPEC[i]
        t_out = lens[i]
        out = torch.empty((x.shape[0], t_out, CH))
        pre = torch.empty_like(out)
        for bb, t0, tile in tap_tiles(x, k, s, t_out):
            n = min(ROWS, t_out - t0)
            assert not tile[n:].any()               # the ragged tile's tail: zeros
            y = product(tile[:n], packed.ws[i - 1]).float()
            pre[bb, t0:t0 + n] = y
            out[bb, t0:t0 + n] = ln_gelu(y, quarter_stats(y), ln[2 * i], ln[2 * i + 1])
        layers.append((x, pre))
        x = out
    return x, layers


def conv64(x, w, s):
    return F.conv1d(x.double().transpose(1, 2), w.double(), stride=s).transpose(1, 2)


@pytest.fixture(scope="module")
def tc_stack():
    """One wav of 400 samples (one ragged tile a layer, 39 .. 1 frames)
    through the route's model: tc_matmul per 32-deep stage."""
    params, wav, weights, ln = _setup(np.random.default_rng(5), 1, 400)
    got, layers = model_stack(wav, weights, ln, lambda a, w: tc_matmul(a, w, KS))
    return params, wav, weights, ln, got, layers


def test_route_model_matches_plain_and_jax(tc_stack):
    params, wav, weights, ln, got, _ = tc_stack
    plain = tk5.conv_extractor_math(wav, weights, ln, torch.float32)
    out_len = tk5.conv_output_length(wav.shape[1])
    jax_out = torch.from_numpy(np.array(jk5.fused_conv_extractor(
        jnp.asarray(wav.numpy()), params["params"], out_len=out_len, interpret=True)))
    assert got.shape == plain.shape == jax_out.shape == (1, out_len, CH)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, plain, **TOL)
    torch.testing.assert_close(got, jax_out, **TOL)


def test_route_products_no_further_from_f64_than_fma(tc_stack):
    """Each layer's pre-LN sums, on the same input, no further from the f64
    product than one f32 FMA a product in order (the deleted kernel's)."""
    _, _, weights, _, _, layers = tc_stack
    for i, (x, pre) in enumerate(layers, start=1):
        _, k, s = tk5.CONV_SPEC[i]
        exact = conv64(x, weights[i], s)[0]
        rows = x[0].unfold(0, k, s).permute(0, 2, 1).reshape(exact.shape[0], -1)
        assert torch.equal(rows, tap_tiles(x, k, s, exact.shape[0])[0][2][:exact.shape[0]])
        w = weights[i].permute(0, 2, 1).reshape(CH, -1)
        model_err = (pre[0].double() - exact).abs().max().item()
        fma_err = (fma_matmul(rows, w) - exact).abs().max().item()
        assert model_err <= fma_err, (i, model_err, fma_err)


@pytest.mark.parametrize("b, length", [(2, 16007), (1, 32000)])
def test_tap_tiles_reproduce_every_layer(rng, b, length):
    """Several tiles a sample, ragged last ones: the tiles' rows times the
    packed weights (f64) are each layer's Conv1d, and the stack run that
    way, with the four-block LN statistics, is conv_extractor_math."""
    _, wav, weights, ln = _setup(rng, b, length)
    got, layers = model_stack(wav, weights, ln, lambda a, w: a.double() @ w.double().t())
    assert tk5.layer_lengths(length)[1] > 2 * ROWS
    for i, (x, pre) in enumerate(layers, start=1):
        want = conv64(x, weights[i], tk5.CONV_SPEC[i][2])
        torch.testing.assert_close(pre.double(), want.float().double(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got, tk5.conv_extractor_math(wav, weights, ln, torch.float32),
                               **TOL)


def test_quarter_stats_are_the_row_statistics(rng):
    y = torch.from_numpy(rng.standard_normal((37, CH)).astype(np.float32))
    s, s2 = quarter_stats(y)
    torch.testing.assert_close(s.double(), y.double().sum(1), atol=1e-4, rtol=1e-6)
    torch.testing.assert_close(s2.double(), (y.double() ** 2).sum(1), atol=1e-4, rtol=1e-6)


def test_f32_packing_splits_every_tap(rng):
    """The TF32 parts beside the exact weights: hi + lo is W to 2^-22, both
    TF32 values, tap j channel c of W[n] at column 512 j + c (where the
    producer's slice kb = (512 j + c) // 32 reads it); bf16 packs none."""
    _, _, weights, ln = _setup(rng, 1, 400)
    packed = tk5.pack_conv_extractor(weights, ln, torch.float32)
    assert tk5.pack_conv_extractor(weights, ln, torch.bfloat16).split is None
    assert len(packed.split) == 6
    for i, (w, sp) in enumerate(zip(packed.ws, packed.split), start=1):
        k = tk5.CONV_SPEC[i][1]
        assert sp.shape == (2, CH, k * CH) and sp.dtype == torch.float32 and sp.is_contiguous()
        hi, lo = sp
        assert torch.equal(torch.stack(tf32_split(w)), sp)
        for part in (hi, lo):
            assert not (part.view(torch.int32) & 0x1FFF).any()
        assert ((hi.double() + lo.double() - w.double()).abs()
                <= 2.0 ** -22 * w.double().abs()).all()
        assert torch.equal(w.reshape(CH, k, CH).permute(0, 2, 1), weights[i])
        for kb in range(k * CH // KS):
            tap, c0 = divmod(kb * KS, CH)
            assert torch.equal(w[:, KS * kb:KS * kb + KS], weights[i][:, c0:c0 + KS, tap])


def test_cpu_wrapper_is_the_plain_version_on_the_exact_weights(rng):
    """A CPU tensor takes conv_extractor_math on the packed exact weights
    (not hi + lo), bit for bit, and counts no launch or route."""
    _, wav, weights, ln = _setup(rng, 2, 4000 + 7)
    packed = tk5.pack_conv_extractor(weights, ln, torch.float32)
    unpacked = tk5.unpack_conv_extractor(packed)
    assert all(torch.equal(u, w) for u, w in zip(unpacked, weights))
    tk5.reset_launches()
    got = tk5.fused_conv_extractor(wav, packed)
    assert torch.equal(got, tk5.conv_extractor_math(wav, unpacked, packed.ln, torch.float32))
    assert tk5.LAUNCHES == 0 and not tk5.ROUTES
    assert tk5.ROUTE_NAMES == ("wgmma bf16", "wgmma 3xTF32")
