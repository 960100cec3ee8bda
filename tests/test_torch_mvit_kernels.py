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
from audio_visual_deepfake_detection_tpu_torch.ops.mvit_math import fmatmul, toeplitz_band
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


@pytest.mark.parametrize("cdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_patch_embed_u8_plain_is_the_f32_route_on_normalized_frames(rng, cdtype):
    """The uint8 entry normalizes with the pipelines' f32 multiply: bit for
    bit the f32 entry on ``u8 * np.float32(1 / 255)``."""
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 4, 96, 96, 3), dtype=np.uint8))
    w = torch.from_numpy(rng.standard_normal((96, 3, 3, 15, 15)).astype(np.float32)) / 45
    b = torch.from_numpy(rng.standard_normal(96).astype(np.float32)) * 0.1
    got = tk2.fused_patch_embed_u8(u8, w, b, cdtype)
    want = tk2.fused_patch_embed(u8.float() * np.float32(1 / 255), w, b, cdtype)
    assert got.dtype == cdtype and torch.equal(got, want)


@pytest.mark.parametrize("f,width", [(32, 96), (101, 128)])
def test_patch_embed_bf16_layout_reproduces_the_convolution(rng, f, width):
    """The bf16 kernel's operands in numpy: frames staged with pixel 0 at
    element 16 of a 320-wide row under 3 zero rows, token (oh, ow)'s run
    (kt, kh) read from staged row 12 oh + kh at element 36 ow + 6, against
    ``pack_weight``'s (kt*kh, N, 48) layout, N = 96 up to 96 features and
    128 past them. The implicit GEMM over them is the plain convolution (as
    csrc/patch_embed.cu indexes it)."""
    t = 3
    u8 = rng.integers(0, 256, (1, t, 96, 96, 3), dtype=np.uint8)
    w = torch.from_numpy(rng.standard_normal((f, 3, 3, 15, 15)).astype(np.float32)) / 45
    b = torch.zeros(f)
    frames = (torch.from_numpy(u8[0]).float() * np.float32(1 / 255)).to(torch.bfloat16).float()
    staged = np.zeros((t + 2, 99, 320), np.float32)        # frames -1 .. t, zero at both ends
    staged[1:t + 1, 3:, 16:304] = frames.reshape(t, 96, 288).numpy()
    packed = tk2.pack_weight(w, torch.bfloat16).float().numpy()     # (45, N, 48)
    assert packed.shape == (45, width, 48) and not packed[:, f:].any()
    out = np.zeros((t, 8, 8, width), np.float32)
    for kt in range(3):
        for kh in range(15):
            for oh in range(8):
                rows = staged[kt:kt + t, 12 * oh + kh]              # (t, 320)
                a = np.stack([rows[:, 36 * ow + 6:36 * ow + 54] for ow in range(8)], 1)
                out[:, oh] += a @ packed[15 * kt + kh].T            # (t, 8, 48) @ (48, N)
    # the same bf16 operands, summed in f32 by the plain convolution
    want = tk2.patch_embed_math(frames[None], w.to(torch.bfloat16).float(), b, torch.float32)
    np.testing.assert_allclose(out[..., :f], want[0].numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("f,taken", [(96, True), (101, True), (128, True), (129, False)])
def test_patch_embed_gate_takes_the_kernel_up_to_128_features(monkeypatch, f, taken):
    """As the JAX gate (``features <= 128``): every width up to 128, odd
    ones included, reaches K2's entries, uint8 frames the uint8 one; a wider
    layer runs the plain convolution."""
    pe = tmvit.PatchEmbed(f, tk2.KERNEL, tk2.STRIDE, tk2.PADDING)
    calls = []
    for name in ("fused_patch_embed", "fused_patch_embed_u8"):
        real = getattr(tk2, name)
        monkeypatch.setattr(tk2, name,
                            lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    u8 = torch.zeros((1, 2, 96, 96, 3), dtype=torch.uint8)
    for frames in (u8, tk2.normalize_u8(u8)):
        assert pe(frames).shape == (1, 2, 8, 8, f)
    assert calls == (["fused_patch_embed_u8", "fused_patch_embed"] if taken else [])


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


def _caller_band(q_grid_rows, rel_t, t, hw):
    """The band as ``MultiscaleAttention`` built it before the table entry
    existed: the XLA Toeplitz branch (rounded) at S <= 4, else the gathered
    table rows and one product per query time step."""
    b, nh, _, d = q_grid_rows.shape
    qh, qw = hw
    q_grid = q_grid_rows.reshape(b, nh, t, qh, qw, d)
    if qh * qw <= 4:
        band = toeplitz_band(q_grid.reshape(b, nh, t, qh * qw, d), rel_t, t,
                             round_to=q_grid_rows.dtype).reshape(b, nh, t, qh, qw, t)
    else:
        rt = rel_t[torch.from_numpy(tmvit._rel_pos_index(t, t))]
        qg = q_grid.permute(2, 0, 1, 3, 4, 5).reshape(t, -1, d)
        band = fmatmul(qg, rt.transpose(1, 2)).reshape(t, b, nh, qh, qw, t).permute(
            1, 2, 0, 3, 4, 5)
    return band.reshape(b * nh, t * qh * qw, t)


@pytest.mark.parametrize("cdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hw,nh,d", [((8, 8), 1, 96), ((1, 1), 8, 32)],
                         ids=["blocks0-1", "block23"])
def test_table_entry_plain_is_the_caller_built_band(rng, cdtype, hw, nh, d):
    """K3's table entry (plain) equals the band the caller used to build
    plus ``pooled_attention_math``, bit for bit: S = 64 unrounded, S = 1
    rounded; the grid rows read in place from the pooled q, the result
    written through ``out`` into the token layout."""
    t, s = 6, hw[0] * hw[1]
    qf, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cdtype)
                for shape in ((2, nh, 1 + t * s, d), (2 * nh, t + 1, d), (2 * nh, t + 1, d)))
    rel_t = torch.from_numpy(0.3 * rng.standard_normal((2 * t + 5, d)).astype(np.float32)).to(cdtype)
    want = tk3.pooled_attention_math(qf[:, :, 1:].reshape(2 * nh, t * s, d), k, v,
                                     _caller_band(qf[:, :, 1:], rel_t, t, hw), d ** -0.5)
    tk3.reset_launches()
    got = tk3.pooled_attention_table(qf[:, :, 1:], k, v, rel_t, t, s, d ** -0.5,
                                     band_round=s <= 4)
    assert torch.equal(got.reshape(2 * nh, t * s, d), want)
    o = torch.zeros((2, 1 + t * s, nh, d), dtype=cdtype)
    tk3.pooled_attention_table(qf[:, :, 1:], k, v, rel_t, t, s, d ** -0.5, band_round=s <= 4,
                               out=o[:, 1:].transpose(1, 2))
    assert torch.equal(o[:, 1:].transpose(1, 2), got) and not o[:, 0].any()
    assert tk3.LAUNCHES == 0 and not tk3.ROUTES


K3_BLOCK_CASES = [
    dict(t=4, hs=8, ws=8, c=96, nh=1),                                    # blocks 0, 1: S = 64
    dict(t=4, hs=1, ws=1, c=768, c_out=256, nh=8, stride_kv=(1, 1, 1)),   # block 23: 768 -> 256
]


@pytest.mark.parametrize("path", ["xla", "interpret"])
@pytest.mark.parametrize("case", K3_BLOCK_CASES, ids=["stage0", "block23"])
def test_k3_blocks_match_jax(rng, monkeypatch, case, path):
    """mvit_v2_b's K3 blocks at small T against the JAX MultiscaleBlock (its
    Pallas K3 in the interpreter, or its XLA path), f32 atol 1e-4 / rtol
    5e-4: the attention core through the table entry, no band array."""
    jblock, params, tblock, x, thw = _block_case(rng, **case)
    _xla(monkeypatch, jk4)
    _xla(monkeypatch, jk3)
    if path == "interpret":
        monkeypatch.setattr(jk3, "INTERPRET", True)
    want, _ = _apply(jblock, params, x, thw)
    assert not tblock.fused_geometry_ok(thw, x.shape[1])

    def refuse(*args, **kwargs):
        raise AssertionError("band-array entry called")

    monkeypatch.setattr(tk3, "fused_pooled_attention", refuse)
    tk3.reset_launches()
    with torch.no_grad():
        got, got_thw = tblock(torch.from_numpy(x), thw)
    assert tk3.LAUNCHES == 0 and got_thw == thw
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("path", ["xla", "interpret"])
def test_k3_block_pooled_in_time_takes_the_band_array_entry(rng, monkeypatch, path):
    """k/v pooled to one cell and in time (stride_kv (2, 2, 2)), q not: T
    differs between q and k/v, so the caller gathers the band with the
    ratio-corrected index and K3 takes it as an array (the JAX gate,
    ``khw == 1``, needs no equal T either); f32 against the JAX block."""
    jblock, params, tblock, x, thw = _block_case(rng, t=4, hs=2, ws=2, c=64, nh=2,
                                                 stride_kv=(2, 2, 2))
    _xla(monkeypatch, jk4)
    _xla(monkeypatch, jk3)
    if path == "interpret":
        monkeypatch.setattr(jk3, "INTERPRET", True)
    want, _ = _apply(jblock, params, x, thw)
    assert not tblock.fused_geometry_ok(thw, x.shape[1])
    calls = []
    real = tk3.fused_pooled_attention
    monkeypatch.setattr(tk3, "fused_pooled_attention",
                        lambda q, k, v, band, scale: calls.append(band.shape) or real(
                            q, k, v, band, scale))
    with torch.no_grad():
        got, got_thw = tblock(torch.from_numpy(x), thw)
    assert calls == [(2 * 2, 4 * 2 * 2, 2)] and got_thw == thw
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


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
    dict(t=4, hs=1, ws=1, c=768, nh=8),            # stage 4: S = 1, C = 768, d = 96
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
