"""PyTorch port, fused transformer block vs the JAX package on the CPU.

The port's plain version ``block_math`` and ``pack_block_params`` are held
against the JAX ``fused_block.block_math`` / ``pack_block_params`` in every
mode x {banded, dense} with a partial mask, in f32 (2e-5, the JAX package's
kernel-vs-XLA tolerance, tests/test_fused_block.py:84-85) and bf16 (2e-2, its
bf16 kernel tolerance, :425-427). The port's TransformerBlock is held
against the JAX XLA TransformerBlock, and one tiny case against the Pallas
kernel itself in interpret mode. Layer scales and LN affines are set to O(1)
random values: at their 1e-4 init a wrong attention would pass.
The CUDA kernel itself is compared with ``block_math`` on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.models.blocks import TransformerBlock as JBlock
from audio_visual_deepfake_detection_tpu.ops.pallas import fused_block as jfb
from audio_visual_deepfake_detection_tpu_torch.models.blocks import TransformerBlock
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as tfb
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import (
    block_state_dict_from_flax)

B, T, C, H = 2, 32, 64, 2
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
CROSS = {"self": False, "ds_self": False, "qv_k": True, "kv": True}


def _mask():
    m = np.ones((B, T), bool)
    m[0, 27:] = False
    m[1, 9:] = False
    return m


def _perturb(p, rng):
    """O(1) layer scales and LN affines, so every branch of the block counts."""
    for name in ("drop_path_attn", "drop_path_mlp"):
        p[name]["scale"] = rng.standard_normal(C).astype(np.float32)
    norms = [p[k] for k in ("ln1", "ln2", "lnq", "lnk", "lnv") if k in p]
    norms += [p["attn"][k] for k in ("query_norm", "key_norm", "value_norm")]
    for n in norms:
        n["weight"] = (1 + 0.5 * rng.standard_normal(C)).astype(np.float32)
        n["bias"] = (0.3 * rng.standard_normal(C)).astype(np.float32)
    return p


def _setup(rng, mode, window):
    """JAX block params (perturbed) + inputs for one mode."""
    mask = _mask()
    mf = mask[..., None].astype(np.float32)
    x = rng.standard_normal((B, T, C)).astype(np.float32) * mf
    xo = rng.standard_normal((B, T, C)).astype(np.float32) * mf
    cross = CROSS[mode]
    block = JBlock(n_embd=C, n_head=H, window_size=window,
                   ds_stride=2 if mode == "ds_self" else 1, cross=cross,
                   deterministic=True)
    kw = {} if not cross else dict(x_k=jnp.asarray(xo), mask_k=jnp.asarray(mask),
                                   x_v=jnp.asarray(xo if mode == "kv" else x),
                                   mask_v=jnp.asarray(mask))
    params = block.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), **kw)
    p = _perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"])), rng)
    return block, p, x, xo, mask, kw


def _torch_layout(jpacked):
    """JAX packed inputs as numpy, dense weights (in, out) -> the port's
    (out, in)."""
    return [np.array(a, np.float32).T if i in range(1, 7) else np.array(a, np.float32)
            for i, a in enumerate(jpacked)]


def _kernel_args(mode, x, xo, mask):
    if mode == "ds_self":
        return x[:, 0::2], x[:, 1::2], mask[:, 0::2]
    return x, (xo if CROSS[mode] else x), mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [7, -1])
@pytest.mark.parametrize("mode", ["self", "qv_k", "kv", "ds_self"])
def test_block_math_and_packing_match_jax(rng, mode, window, dtype):
    _, p, x, xo, mask, _ = _setup(rng, mode, window)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jpacked = jfb.pack_block_params(p, C, CROSS[mode], jdt)
    tpacked = tfb.pack_block_params(block_state_dict_from_flax(p), C, CROSS[mode], tdt)
    # packing: identical folds up to f32 rounding of the bias matvecs; the
    # port keeps the dense weights (out, in)
    jnp_packed = _torch_layout(jpacked)
    for a, b in zip(jnp_packed, tpacked):
        np.testing.assert_allclose(b.float().numpy(), a, rtol=1e-6, atol=1e-6)

    xa, xb, m = _kernel_args(mode, x, xo, mask)
    mrow = m.astype(np.float32)[..., None]
    coefs = np.ones((B, 2), np.float32)
    ref = jfb.block_math(jnp.asarray(xa, jdt), jnp.asarray(xb, jdt), jnp.asarray(mrow),
                         jnp.asarray(coefs), *jpacked, n_head=H,
                         w_overlap=window // 2, mode=mode)
    # same packed inputs on both sides: the comparison is the block math alone
    tin = [torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.float32 if i in (0, 7) else tdt) for i, a in enumerate(jnp_packed)]
    got = tfb.block_math(torch.from_numpy(xa).to(tdt), torch.from_numpy(xb).to(tdt),
                         torch.from_numpy(mrow), torch.from_numpy(coefs), *tin,
                         n_head=H, w_overlap=window // 2, mode=mode)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("window", [7, -1])
@pytest.mark.parametrize("mode", ["self", "qv_k", "kv", "ds_self"])
def test_transformer_block_matches_jax_xla_path(rng, mode, window):
    block, p, x, xo, mask, kw = _setup(rng, mode, window)
    ref, ref_mask = block.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask), **kw)

    ours = TransformerBlock(C, H, ds_stride=2 if mode == "ds_self" else 1,
                            window_size=window, cross=CROSS[mode])
    ours.load_state_dict(block_state_dict_from_flax(p), strict=True)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        if CROSS[mode]:
            got, got_mask = ours(tx, tm, xo=torch.from_numpy(xo), mode=mode)
        else:
            got, got_mask = ours(tx, tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    assert np.array_equal(got_mask.numpy(), np.asarray(ref_mask))


def test_block_math_matches_pallas_kernel_interpret(rng):
    mode, window, t = "self", 7, 16
    _, p, x, _, mask, _ = _setup(rng, mode, window)
    x, mask = np.ascontiguousarray(x[:, :t]), np.ascontiguousarray(mask[:, :t])
    jpacked = jfb.pack_block_params(p, C, False, jnp.float32)
    ref = jfb.fused_transformer_block(
        jnp.asarray(x), None, jnp.asarray(mask), *jpacked, n_head=H,
        w_overlap=window // 2, mode=mode, interpret=True)
    tpacked = tfb.pack_block_params(block_state_dict_from_flax(p), C, False,
                                    torch.float32)
    got = tfb.fused_transformer_block(torch.from_numpy(x), None,
                                      torch.from_numpy(mask), *tpacked,
                                      n_head=H, w_overlap=window // 2, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_cpu_tensor_takes_plain_version_without_launch(rng):
    _, p, x, _, mask, _ = _setup(rng, "self", 7)
    tfb.reset_launches()
    packed = tfb.pack_block_params(block_state_dict_from_flax(p), C, False,
                                   torch.float32)
    y = tfb.fused_transformer_block(torch.from_numpy(x), None, torch.from_numpy(mask),
                                    *packed, n_head=H, w_overlap=3, mode="self")
    ref = tfb.block_math(torch.from_numpy(x), torch.from_numpy(x),
                         torch.from_numpy(mask).float()[..., None],
                         torch.ones(B, 2), *packed, n_head=H, w_overlap=3,
                         mode="self")
    assert tfb.LAUNCHES == 0
    assert torch.equal(y, ref)


def test_block_packs_once_and_repacks_after_parameter_update(rng):
    _, p, x, _, mask, _ = _setup(rng, "self", 7)
    ours = TransformerBlock(C, H, window_size=7)
    ours.load_state_dict(block_state_dict_from_flax(p), strict=True)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    first = ours.packed(torch.float32)
    assert ours.packed(torch.float32) is first
    with torch.no_grad():
        before, _ = ours(tx, tm)
        ours.drop_path_mlp.scale.mul_(2.0)          # in place: repacks
        after, _ = ours(tx, tm)
    assert ours.packed(torch.float32) is not first
    sd = block_state_dict_from_flax(p)
    sd["drop_path_mlp.scale"] = sd["drop_path_mlp.scale"] * 2.0
    fresh = TransformerBlock(C, H, window_size=7)
    fresh.load_state_dict(sd, strict=True)
    with torch.no_grad():
        assert torch.equal(after, fresh(tx, tm)[0])
        assert not torch.equal(before, after)
        ours.load_state_dict(block_state_dict_from_flax(p), strict=True)
        assert torch.equal(ours(tx, tm)[0], before)
