"""PyTorch port: the plain version of kernel K5 (``conv_extractor_math``) and
its packing vs the JAX ``ConvFeatureExtractor``, on the XLA path and through
the Pallas interpreter, on the CPU.

Tolerances are those of ``tests/test_conv_extractor_fused.py``: f32 atol 1e-4
/ rtol 5e-4 (another summation order through seven layers), bf16 atol = rtol
= 0.08."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.frontends import emotion2vec as je2v
from audio_visual_deepfake_detection_tpu.ops.pallas import conv_extractor as jk5
from audio_visual_deepfake_detection_tpu_torch.frontends import emotion2vec as te2v
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import conv_extractor as tk5


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _noisy(params, rng):
    leaves, tree = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(
        tree, [np.asarray(rng.standard_normal(l.shape) * 0.2, np.float32) for l in leaves])


def _setup(rng, b, length, dtype=jnp.float32):
    model = je2v.ConvFeatureExtractor(dtype=dtype)
    wav = (rng.standard_normal((b, length)) * 0.5).astype(np.float32)
    params = _noisy(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 400))), rng)
    p = params["params"]
    weights = [torch.from_numpy(np.transpose(p[f"conv_{i}"]["kernel"], (2, 1, 0)).copy())
               for i in range(7)]
    ln = torch.from_numpy(np.stack([p[f"ln_{i}"][k] for i in range(7)
                                    for k in ("scale", "bias")]))
    return model, params, wav, weights, ln


def _jax_paths(model, params, wav, monkeypatch, interpret):
    monkeypatch.setattr(jk5, "ENABLED", False)
    monkeypatch.setattr(jk5, "INTERPRET", interpret)
    return np.asarray(jax.jit(model.apply)(params, jnp.asarray(wav)), np.float32)


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "interpreter"])
@pytest.mark.parametrize("length", [16000, 161 * 320 + 400])
def test_math_matches_jax_f32(rng, monkeypatch, length, interpret):
    model, params, wav, weights, ln = _setup(rng, 2, length)
    want = _jax_paths(model, params, wav, monkeypatch, interpret)
    got = tk5.conv_extractor_math(torch.from_numpy(wav), weights, ln, torch.float32).numpy()
    assert got.shape == want.shape == (2, tk5.conv_output_length(length), 512)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=5e-4)


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "interpreter"])
def test_math_matches_jax_bf16(rng, monkeypatch, interpret):
    model, params, wav, weights, ln = _setup(rng, 1, 16000, jnp.bfloat16)
    want = _jax_paths(model, params, wav, monkeypatch, interpret)
    got = tk5.conv_extractor_math(torch.from_numpy(wav), weights, ln, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.08, rtol=0.08)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_is_the_plain_version(rng, dtype):
    """A CPU tensor takes ``conv_extractor_math`` through the packed weights
    (the unpacked views make the conv sum in another order: f32 1e-5, bf16
    one rounding step, 2e-2), and no launch is counted."""
    _, _, wav, weights, ln = _setup(rng, 2, 4000 + 7)
    tk5.reset_launches()
    packed = tk5.pack_conv_extractor(weights, ln, dtype)
    assert [tuple(w.shape) for w in packed.ws] == [(512, 1536)] * 4 + [(512, 1024)] * 2
    got = tk5.fused_conv_extractor(torch.from_numpy(wav), packed)
    want = tk5.conv_extractor_math(torch.from_numpy(wav), weights, ln, dtype)
    assert got.dtype == dtype and tuple(got.shape) == (2, tk5.conv_output_length(4007), 512)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert tk5.LAUNCHES == 0


def test_lengths_and_refusals(rng):
    assert tk5.layer_lengths(153600) == [30719, 15359, 7679, 3839, 1919, 959, 479]
    assert tk5.conv_output_length(153600) == je2v.conv_output_length(153600) == 479
    assert tk5.CONV_SPEC == je2v.CONV_SPEC == te2v.CONV_SPEC
    _, _, _, weights, ln = _setup(rng, 1, 400)
    packed = tk5.pack_conv_extractor(weights, ln, torch.float32)
    with pytest.raises(ValueError):
        tk5.fused_conv_extractor(torch.zeros((1, 399)), packed)        # no output frame
    with pytest.raises(ValueError):
        tk5.fused_conv_extractor(torch.zeros((1, 400), dtype=torch.float64), packed)
    assert tuple(tk5.fused_conv_extractor(torch.zeros((1, 400)), packed).shape) == (1, 1, 512)


def test_module_other_spec_runs_eager_layers(rng):
    """A spec other than CONV_SPEC does not reach K5's wrapper."""
    spec = ((16, 10, 5), (16, 3, 2))
    jm = je2v.ConvFeatureExtractor(spec=spec)
    wav = (rng.standard_normal((2, 800)) * 0.5).astype(np.float32)
    params = _noisy(jm.init(jax.random.PRNGKey(0), jnp.asarray(wav)), rng)
    tm = te2v.ConvFeatureExtractor(spec=spec)
    with torch.no_grad():
        for i, layer in enumerate(tm.conv_layers):
            p = params["params"]
            layer[0].weight.copy_(torch.from_numpy(
                np.transpose(p[f"conv_{i}"]["kernel"], (2, 1, 0)).copy()))
            layer[2][1].weight.copy_(torch.from_numpy(p[f"ln_{i}"]["scale"]))
            layer[2][1].bias.copy_(torch.from_numpy(p[f"ln_{i}"]["bias"]))
        got = tm(torch.from_numpy(wav)).numpy()
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(wav)))
    assert got.shape == want.shape == (2, 79, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=5e-4)


# --------------------------------------------- the bf16 kernel's tap views
# csrc/conv_extractor.cu runs layers 1-6 in bf16 as an implicit GEMM over
# tiles of 64 frames of one sample: k steps of 64 values, tap j = step / 8 and
# channel block step % 8, each A slice one box of a 3-D tensor map over the
# previous layer's output (channels, frames at stride s 512, samples) based
# at tap j, frames past the layer's end read as zeros; W is the packed
# (512, k 512) weight, taps outermost.

def _tap_view(x, j, k, s, t_out):
    """The tensor map of tap j over x (B, T_in, 512): frame t's row s t + j."""
    b, t_in, ch = x.shape
    return x.as_strided((b, t_out, ch), (t_in * ch, s * ch, 1), x.storage_offset() + j * ch)


def _tiled_layer(x, w_packed, k, s, t_out, tile=64):
    """The products of one layer as the kernel's tiles sum them."""
    b = x.shape[0]
    out = torch.zeros((b, t_out, tk5.CH), dtype=torch.float64)
    for t0 in range(0, t_out, tile):
        acc = torch.zeros((b, tile, tk5.CH), dtype=torch.float64)
        for step in range(8 * k):
            j, cb = divmod(step, 8)
            a = torch.zeros((b, tile, 64), dtype=torch.float64)
            rows = _tap_view(x, j, k, s, t_out)[:, t0:t0 + tile, 64 * cb:64 * cb + 64]
            a[:, :rows.shape[1]] = rows               # zero fill past the layer's end
            acc += a @ w_packed[:, j * tk5.CH + 64 * cb:j * tk5.CH + 64 * cb + 64].double().T
        out[:, t0:t0 + tile] = acc[:, :min(tile, t_out - t0)]
    return out


@pytest.mark.parametrize("length", [16007, 32000])
def test_tap_view_tiles_reproduce_every_layer(rng, length):
    """Each of layers 1-6 summed over the kernel's tiles and k steps from
    the tap views of its input equals the plain Conv1d; the whole stack run
    that way, with each layer's LN and GELU, equals conv_extractor_math."""
    _, _, wav, weights, ln = _setup(rng, 2, length)
    packed = tk5.pack_conv_extractor(weights, ln, torch.float32)
    wav = torch.from_numpy(wav)
    lens = tk5.layer_lengths(length)
    x = tk5.conv_extractor_math(wav, weights[:1], ln, torch.float32, spec=tk5.CONV_SPEC[:1])
    for i in range(1, 7):
        _, k, s = tk5.CONV_SPEC[i]
        got = _tiled_layer(x.double(), packed.ws[i - 1], k, s, lens[i])
        want = torch.nn.functional.conv1d(x.double().transpose(1, 2), weights[i].double(),
                                          stride=s).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-9)
        y = torch.nn.functional.layer_norm(got.float(), (tk5.CH,), ln[2 * i], ln[2 * i + 1],
                                           eps=tk5.LN_EPS)
        x = torch.nn.functional.gelu(y).contiguous()
    np.testing.assert_allclose(x.numpy(), tk5.conv_extractor_math(wav, weights, ln,
                                                                  torch.float32).numpy(),
                               rtol=5e-4, atol=1e-4)
