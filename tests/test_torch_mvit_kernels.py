"""PyTorch port, the MViT kernels' plain versions vs the JAX package on the CPU.

K2 (patch embed), K3 (pooled attention) and K4 (whole MultiscaleBlock): the
port's plain versions, which a CPU tensor runs, are held against the JAX
XLA path (``ENABLED = False``) and against the Pallas kernels in the
interpreter (``INTERPRET = True``), at the JAX package's own tolerances:
f32 modules atol 1e-4 / rtol 5e-4 (``tests/test_mvit_block_fused.py:79``),
K3 atol 2e-5 / rtol 1e-5 (``tests/test_mvit_fused.py:45``), bf16 by the
distributional rule against the f32 reference (median |d| < 0.005 std,
max |d| < 0.1 std, ``tests/test_mvit_block_fused.py:86-92``). Parameters
are random everywhere: zero rel-pos tables or identity LN affines would
hide shear, tap and affine bugs. The CUDA kernels are held against these
plain versions on the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.frontends import mvit as jmvit
from audio_visual_deepfake_detection_tpu.ops.pallas import mvit_attention as jk3
from audio_visual_deepfake_detection_tpu.ops.pallas import mvit_block as jk4
from audio_visual_deepfake_detection_tpu.ops.pallas import patch_embed as jk2
from audio_visual_deepfake_detection_tpu_torch.frontends import mvit as tmvit
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_attention as tk3
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_block as tk4
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import patch_embed as tk2
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import (
    mvit_state_dict_from_flax)

F32_TOL = dict(atol=1e-4, rtol=5e-4)


def _noisy(params, rng, std=0.2):
    leaves, tree = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(
        tree, [np.asarray(rng.standard_normal(l.shape) * std, np.float32) for l in leaves])


def _distributional(got, want):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    scale = float(np.std(want))
    assert np.median(d) < 0.005 * scale, (np.median(d), scale)
    assert d.max() < 0.1 * scale, (d.max(), scale)


def _xla(monkeypatch, mod):
    monkeypatch.setattr(mod, "INTERPRET", False)
    monkeypatch.setattr(mod, "ENABLED", False)


# ------------------------------------------------------------------ K2

def _patch_case(rng):
    video = rng.random((1, 5, 96, 96, 3)).astype(np.float32)
    mod = jmvit.PatchEmbed(96, (3, 15, 15), (1, 12, 12), (1, 3, 3))
    params = _noisy(mod.init(jax.random.PRNGKey(0), jnp.asarray(video)), rng)
    w = torch.from_numpy(np.ascontiguousarray(
        np.transpose(params["params"]["kernel"], (4, 3, 0, 1, 2))))
    b = torch.from_numpy(params["params"]["bias"])
    return video, params, w, b


@pytest.mark.parametrize("path", ["xla", "interpret"])
def test_patch_embed_plain_matches_jax_f32(rng, monkeypatch, path):
    video, params, w, b = _patch_case(rng)
    _xla(monkeypatch, jk2)
    if path == "interpret":
        monkeypatch.setattr(jk2, "INTERPRET", True)
    mod = jmvit.PatchEmbed(96, (3, 15, 15), (1, 12, 12), (1, 3, 3))
    want = np.asarray(mod.apply(params, jnp.asarray(video)))
    tk2.reset_launches()
    got = tk2.fused_patch_embed(torch.from_numpy(video), w, b, torch.float32)
    assert tk2.LAUNCHES == 0 and got.shape == want.shape == (1, 5, 8, 8, 96)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_patch_embed_plain_bf16(rng, monkeypatch):
    """bf16 against the f32 XLA reference (distributional) and against the
    bf16 Pallas kernel in the interpreter, which rounds at the same points
    (f32 sum of bf16 products, one downcast, the bias added in bf16)."""
    video, params, w, b = _patch_case(rng)
    _xla(monkeypatch, jk2)
    mod = jmvit.PatchEmbed(96, (3, 15, 15), (1, 12, 12), (1, 3, 3))
    want32 = np.asarray(mod.apply(params, jnp.asarray(video)))
    monkeypatch.setattr(jk2, "INTERPRET", True)
    mod16 = jmvit.PatchEmbed(96, (3, 15, 15), (1, 12, 12), (1, 3, 3), dtype=jnp.bfloat16)
    want16 = np.asarray(mod16.apply(params, jnp.asarray(video))).astype(np.float32)
    got = tk2.fused_patch_embed(torch.from_numpy(video), w, b, torch.bfloat16).float().numpy()
    _distributional(got, want32)
    np.testing.assert_allclose(got, want16, atol=2e-2, rtol=2e-2)


# ------------------------------------------------------------------ K3

@pytest.mark.parametrize("ng,nk,nh,d", [(256, 17, 2, 24), (1024, 9, 1, 16)])
def test_pooled_attention_math_matches_interpreter(rng, ng, nk, nh, d):
    q, k, v = (rng.standard_normal((nh, n, d)).astype(np.float32) for n in (ng, nk, nk))
    band = (rng.standard_normal((nh, ng, nk - 1)) * 0.3).astype(np.float32)
    want = jk3.fused_pooled_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(band), scale=d ** -0.5, interpret=True)
    tk3.reset_launches()
    got = tk3.fused_pooled_attention(*map(torch.from_numpy, (q, k, v, band)),
                                     scale=d ** -0.5)
    assert tk3.LAUNCHES == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


# ------------------------------------------------------------------ K4

def _block_case(rng, *, t, hs, ws, c, nh, cfg_t=None, stride_kv=None, stride_q=(1, 1, 1),
                c_out=None, batch=2):
    cfg = jmvit.MSBlockConfig(num_heads=nh, input_channels=c, output_channels=c_out or c,
                              kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=stride_q,
                              stride_kv=stride_kv or (1, hs, ws))
    thw, cfg_thw = (t, hs, ws), (cfg_t or t, hs, ws)
    x = rng.standard_normal((batch, 1 + t * hs * ws, c)).astype(np.float32)
    jblock = jmvit.MultiscaleBlock(cfg, cfg_thw)
    params = _noisy(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), thw), rng)
    tcfg = tmvit.MSBlockConfig(**{f: getattr(cfg, f) for f in (
        "num_heads", "input_channels", "output_channels", "kernel_q", "kernel_kv",
        "stride_q", "stride_kv")})
    tblock = tmvit.MultiscaleBlock(tcfg, cfg_thw)
    sd = {k[len("blocks.0."):]: v
          for k, v in mvit_state_dict_from_flax({"block_0": params["params"]}).items()}
    tblock.load_state_dict(sd, strict=True)
    return jblock, params, tblock, x, thw


def _apply(jblock, params, x, thw):
    """The JAX block, jitted (one compile beats op-by-op dispatch here)."""
    out, out_thw = jax.jit(jblock.apply, static_argnums=2)(params, jnp.asarray(x), thw)
    return out, out_thw


BLOCK_CASES = [
    dict(t=8, hs=2, ws=2, c=128, nh=2),            # stage-3-like, d=64
    dict(t=8, hs=2, ws=2, c=384, nh=4),            # production d=96
    dict(t=8, hs=1, ws=1, c=128, nh=1),            # stage-4-like, d=128
    dict(t=8, hs=1, ws=1, c=256, nh=2, stride_kv=(1, 1, 1)),
    dict(t=5, hs=2, ws=2, c=128, nh=2),            # non-power-of-2 T
    dict(t=8, hs=2, ws=2, c=128, nh=2, cfg_t=16),  # table longer than T
    dict(t=4, hs=4, ws=4, c=192, nh=2),            # stage 2: S = 16, C = 192
]


@pytest.mark.parametrize("path", ["xla", "interpret"])
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_msblock_math_matches_jax(rng, monkeypatch, case, path):
    jblock, params, tblock, x, thw = _block_case(rng, **case)
    _xla(monkeypatch, jk4)
    if path == "interpret":
        monkeypatch.setattr(jk4, "INTERPRET", True)
        # the JAX gate's MAX_SPATIAL = 4 would send S = 16 to XLA
        monkeypatch.setattr(jk4, "MAX_SPATIAL", 16)
        assert jblock._fused_geometry_ok(thw, x.shape[1])
    want, _ = _apply(jblock, params, x, thw)
    assert tblock.fused_geometry_ok(thw, x.shape[1])
    tk4.reset_launches()
    with torch.no_grad():
        got, got_thw = tblock(torch.from_numpy(x), thw)
    assert tk4.LAUNCHES == 0 and got_thw == thw
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_msblock_math_bf16(rng, monkeypatch):
    jblock, params, tblock, x, thw = _block_case(rng, t=8, hs=2, ws=2, c=128, nh=2)
    _xla(monkeypatch, jk4)
    want, _ = _apply(jblock, params, x, thw)
    with torch.no_grad():
        got, _ = tblock(torch.from_numpy(x).bfloat16(), thw)
    _distributional(got.float().numpy(), np.asarray(want))


@pytest.mark.parametrize("path", ["xla", "interpret"])
def test_transition_block_matches_jax(rng, monkeypatch, path):
    """stride_q (1,2,2), 64 -> 128 channels, k/v pooled to a 2x2 grid
    (khw = 4): the general decomposed rel-pos branch, the channel project
    and the max-pooled skip, in eager torch on both sides of the gate."""
    jblock, params, tblock, x, thw = _block_case(
        rng, t=4, hs=4, ws=4, c=64, c_out=128, nh=2, stride_q=(1, 2, 2), stride_kv=(1, 2, 2))
    _xla(monkeypatch, jk4)
    if path == "interpret":
        monkeypatch.setattr(jk4, "INTERPRET", True)
        monkeypatch.setattr(jk4, "MAX_SPATIAL", 16)
    want, want_thw = _apply(jblock, params, x, thw)
    assert not tblock.fused_geometry_ok(thw, x.shape[1])
    with torch.no_grad():
        got, got_thw = tblock(torch.from_numpy(x), thw)
    assert got_thw == tuple(want_thw) == (4, 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_k4_gate_takes_stage_two_and_no_transitions():
    setting = tmvit.generate_config([2, 3, 16, 3], [1, 2, 4, 8], [96, 192, 384, 768], 256)
    model = tmvit.MViTVideoEncoder(setting)
    thw = model.patch_grid((1, 512, 96, 96, 3))
    k4 = []
    for i, blk in enumerate(model.blocks):
        if blk.fused_geometry_ok(thw, 1 + thw[0] * thw[1] * thw[2]):
            k4.append(i)
        thw = tuple((s + st - 1) // st for s, st in zip(thw, blk.cfg.stride_q))
    assert k4 == [3, 4] + list(range(6, 21)) + [22]
