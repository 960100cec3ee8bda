"""PyTorch port, the training dispatch of the fused block (K6) on the CPU.

``fused_transformer_block_train`` is a ``torch.autograd.Function``: forward
= the kernel (here its plain version ``block_math``), backward = autograd
through ``block_math`` recomputed from the saved inputs. Held against the JAX
package: the forward with random droppath coefficients against the Pallas
kernel in interpret mode (2e-5, the JAX package's kernel tolerance), the
gradients of the inputs and of every unpacked parameter against ``jax.grad``
through the standard flax path and through the JAX train dispatch (inputs
2e-4; parameters 5e-4 after scaling by the leaf's largest value, the
tolerances of tests/test_fused_block.py:213-221), bf16 at 2e-2."""

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
    for name in ("drop_path_attn", "drop_path_mlp"):
        p[name]["scale"] = rng.standard_normal(C).astype(np.float32)
    norms = [p[k] for k in ("ln1", "ln2", "lnq", "lnk", "lnv") if k in p]
    norms += [p["attn"][k] for k in ("query_norm", "key_norm", "value_norm")]
    for n in norms:
        n["weight"] = (1 + 0.5 * rng.standard_normal(C)).astype(np.float32)
        n["bias"] = (0.3 * rng.standard_normal(C)).astype(np.float32)
    return p


def _setup(rng, mode, window, path_pdrop=0.0):
    mask = _mask()
    mf = mask[..., None].astype(np.float32)
    x = rng.standard_normal((B, T, C)).astype(np.float32) * mf
    xo = rng.standard_normal((B, T, C)).astype(np.float32) * mf
    cross = CROSS[mode]

    def make(det):
        return JBlock(n_embd=C, n_head=H, window_size=window,
                      ds_stride=2 if mode == "ds_self" else 1, cross=cross,
                      path_pdrop=path_pdrop, deterministic=det)

    def kw(xv, xov):
        if not cross:
            return {}
        m = jnp.asarray(mask)
        return dict(x_k=xov, mask_k=m, x_v=xov if mode == "kv" else xv, mask_v=m)

    params = make(True).init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                             **kw(jnp.asarray(x), jnp.asarray(xo)))
    p = _perturb(jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"])), rng)
    return make, kw, p, x, xo, mask


def _ours(p, mode, window, **kw):
    blk = TransformerBlock(C, H, ds_stride=2 if mode == "ds_self" else 1,
                           window_size=window, cross=CROSS[mode], **kw)
    blk.load_state_dict(block_state_dict_from_flax(p), strict=True)
    return blk


def _kernel_args(mode, x, xo, mask):
    if mode == "ds_self":
        return x[:, 0::2], x[:, 1::2], mask[:, 0::2]
    return x, (xo if CROSS[mode] else None), mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [7, -1])
@pytest.mark.parametrize("mode", ["self", "qv_k", "kv", "ds_self"])
def test_train_forward_with_coefs_matches_pallas_interpret(rng, mode, window, dtype):
    _, _, p, x, xo, mask = _setup(rng, mode, window)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    coefs = rng.choice([0.0, 1.0, 2.0], (B, 2)).astype(np.float32)
    xa, xb, m = _kernel_args(mode, x, xo, mask)
    jpacked = jfb.pack_block_params(p, C, CROSS[mode], jdt)
    ref = jfb.fused_transformer_block_train(
        jnp.asarray(xa, jdt), None if xb is None else jnp.asarray(xb, jdt), jnp.asarray(m),
        jnp.asarray(coefs), *jpacked, n_head=H, w_overlap=window // 2, mode=mode,
        interpret=True)
    tpacked = tfb.pack_block_params(block_state_dict_from_flax(p), C, CROSS[mode], tdt)
    tt = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    tfb.reset_launches()
    got = tfb.fused_transformer_block_train(
        tt(xa).to(tdt), None if xb is None else tt(xb).to(tdt), tt(m), tt(coefs), *tpacked,
        n_head=H, w_overlap=window // 2, mode=mode)
    assert tfb.LAUNCHES == 0 and tfb.TRAIN_LAUNCHES == 0      # a CPU tensor launches nothing
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def _torch_grads(blk, mode, x, xo, mask, g):
    """d sum(y g) / d (x, xo, every parameter) through the port's block with
    gradients enabled and train off: the K6 Function with coefficients 1."""
    tx = torch.from_numpy(x).requires_grad_(True)
    txo = torch.from_numpy(xo).requires_grad_(True)
    y, _ = blk(tx, torch.from_numpy(mask), xo=txo if CROSS[mode] else None,
               mode=mode if CROSS[mode] else None)
    (y * torch.from_numpy(g)).sum().backward()
    return tx.grad, txo.grad, {n: p.grad for n, p in blk.named_parameters()}


def _check_param_grads(got, ref_tree):
    ref = block_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref_tree))
    assert set(got) == set(ref)
    for name, r in ref.items():
        scale = max(1.0, float(r.abs().max()))
        np.testing.assert_allclose(got[name].numpy() / scale, r.numpy() / scale,
                                   rtol=5e-4, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("mode,window", [("self", 7), ("kv", 7), ("qv_k", 7), ("ds_self", 7),
                                         ("ds_self", -1), ("kv", -1)])
def test_train_grads_match_jax_standard_path(rng, mode, window):
    make, kw, p, x, xo, mask = _setup(rng, mode, window)
    t_out = T // 2 if mode == "ds_self" else T
    g = rng.standard_normal((B, t_out, C)).astype(np.float32)

    def loss(params, xv, xov):
        y, _ = make(False).apply({"params": params}, xv, jnp.asarray(mask), **kw(xv, xov),
                                 rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(y * g)

    ref_gp, ref_gx, ref_gxo = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        p, jnp.asarray(x), jnp.asarray(xo))
    gx, gxo, gp = _torch_grads(_ours(p, mode, window), mode, x, xo, mask, g)
    np.testing.assert_allclose(gx.numpy(), np.asarray(ref_gx), rtol=2e-4, atol=2e-4)
    if CROSS[mode]:
        np.testing.assert_allclose(gxo.numpy(), np.asarray(ref_gxo), rtol=2e-4, atol=2e-4)
    _check_param_grads(gp, ref_gp)


def test_train_grads_match_jax_train_dispatch(rng, monkeypatch):
    """Against the JAX custom_vjp itself (Pallas forward in interpret mode,
    backward through its mirror), cross mode."""
    mode, window = "kv", 7
    make, kw, p, x, xo, mask = _setup(rng, mode, window)
    g = rng.standard_normal((B, T, C)).astype(np.float32)
    orig = jfb.fused_transformer_block_train

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfb, "ENABLED", True)
    monkeypatch.setattr(jfb, "TRAIN_ENABLED", True)
    monkeypatch.setattr(jfb, "fused_transformer_block_train", interp)

    def loss(params, xv, xov):
        y, _ = make(False).apply({"params": params}, xv, jnp.asarray(mask), **kw(xv, xov),
                                 rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(y * g)

    ref_gp, ref_gx, ref_gxo = jax.grad(loss, argnums=(0, 1, 2))(
        p, jnp.asarray(x), jnp.asarray(xo))
    gx, gxo, gp = _torch_grads(_ours(p, mode, window), mode, x, xo, mask, g)
    np.testing.assert_allclose(gx.numpy(), np.asarray(ref_gx), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(gxo.numpy(), np.asarray(ref_gxo), rtol=2e-4, atol=2e-4)
    _check_param_grads(gp, ref_gp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,window", [("qv_k", 7), ("ds_self", -1)])
def test_function_grads_equal_autograd_through_block_math(rng, mode, window, dtype):
    _, _, p, x, xo, mask = _setup(rng, mode, window)
    tdt = getattr(torch, dtype)
    xa, xb, m = _kernel_args(mode, x, xo, mask)
    coefs = torch.from_numpy(rng.choice([0.0, 2.0], (B, 2)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(xa.shape).astype(np.float32)).to(tdt)
    tm = torch.from_numpy(np.ascontiguousarray(m))
    sd = block_state_dict_from_flax(p)

    def run(through_function):
        leaves = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
        tx = torch.from_numpy(np.ascontiguousarray(xa)).to(tdt).requires_grad_(True)
        txo = torch.from_numpy(np.ascontiguousarray(xb)).to(tdt).requires_grad_(True)
        packed = tfb.pack_block_params(leaves, C, CROSS[mode], tdt)
        kw = dict(n_head=H, w_overlap=window // 2, mode=mode)
        if through_function:
            y = tfb.fused_transformer_block_train(tx, txo, tm, coefs, *packed, **kw)
        else:
            y = tfb.block_math(tx, txo, tm.float()[..., None], coefs, *packed, **kw)
        (y * g).sum().backward()
        return y.detach(), tx.grad, txo.grad, {k: v.grad for k, v in leaves.items()}

    y1, gx1, gxo1, gp1 = run(True)
    y2, gx2, gxo2, gp2 = run(False)
    assert torch.equal(y1, y2)
    # the same operations in the same order: equal bit for bit
    assert torch.equal(gx1, gx2) and torch.equal(gxo1, gxo2)
    for k in gp1:
        if gp2[k] is None:
            assert gp1[k] is None, k
        else:
            assert torch.equal(gp1[k], gp2[k]), k


def test_train_droppath_draws_per_sample_coefficients(rng):
    """With path_pdrop > 0 every sample's output equals block_math at one of
    the four coefficient pairs {0, 1/keep}^2, and the draws come from the
    generator: the same seed gives the same output."""
    keep = 0.5
    _, _, p, x, _, mask = _setup(rng, "self", 7)
    mask[:] = True
    blk = _ours(p, "self", 7, path_pdrop=1 - keep)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    outs = []
    for seed in (7, 7, 8, 9, 10):
        y, _ = blk(tx, tm, train=True, generator=torch.Generator().manual_seed(seed))
        outs.append(y.detach())
    assert torch.equal(outs[0], outs[1])
    assert any(not torch.equal(outs[0], o) for o in outs[2:])
    packed = tfb.pack_block_params(block_state_dict_from_flax(p), C, False, torch.float32)
    cands = []
    for ca in (0.0, 1.0 / keep):
        for cm in (0.0, 1.0 / keep):
            coefs = torch.tensor([[ca, cm]]).repeat(B, 1)
            cands.append(tfb.block_math(tx, tx, tm.float()[..., None], coefs, *packed,
                                        n_head=H, w_overlap=3, mode="self"))
    for y in outs:
        for b in range(B):
            dists = [float((c[b] - y[b]).abs().max()) for c in cands]
            assert min(dists) < 2e-5, dists


def test_eval_without_grad_takes_k1_and_packs_once(rng):
    """No gradient wanted: the eval wrapper with the cached packing; with
    gradients enabled the packing is fresh every call and carries the graph."""
    _, _, p, x, _, mask = _setup(rng, "self", 7)
    blk = _ours(p, "self", 7)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        y0, _ = blk(tx, tm)
    assert not y0.requires_grad
    y1, _ = blk(tx, tm)
    assert y1.requires_grad and torch.equal(y0, y1.detach())
    assert all(not a.requires_grad for a in blk.packed(torch.float32))


def test_training_without_a_graph_still_drops_paths(rng):
    """``train=True`` under ``torch.no_grad()`` (the first pass of an
    activation-checkpointed region, a validation pass left in train mode)
    draws the same coefficients as with a graph, and is not the eval block."""
    _, _, p, x, _, mask = _setup(rng, "self", 7)
    blk = _ours(p, "self", 7, path_pdrop=0.5)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        quiet, _ = blk(tx, tm, train=True, generator=torch.Generator().manual_seed(7))
        plain, _ = blk(tx, tm)
    graph, _ = blk(tx, tm, train=True, generator=torch.Generator().manual_seed(7))
    assert not quiet.requires_grad and torch.equal(quiet, graph.detach())
    assert not torch.equal(quiet, plain)
