"""PyTorch port, the unfused localizer block and the training-mode pieces of
``models/blocks.py`` and ``models/backbones.py`` on the CPU.

The unfused block (``ConvAttention`` with banded or dense attention, MLP,
layer-scaled residuals; what training with ``dropout > 0`` runs) is held
against the JAX package's standard flax path with the same parameters and
inputs at 2e-5 (its kernel-vs-XLA tolerance), and against the port's own fused
path at 2e-5. Stochastic depth and dropout are checked for their statistics
and for being functions of the generator's seed alone."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.models.blocks import TransformerBlock as JBlock
from audio_visual_deepfake_detection_tpu_torch.core.config import ArchConfig
from audio_visual_deepfake_detection_tpu_torch.models import blocks as tblocks
from audio_visual_deepfake_detection_tpu_torch.models.meta_arch import (
    AVLocalizer, init_localizer)
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import band_attention as k7
from audio_visual_deepfake_detection_tpu_torch.tools.convert_jax import (
    block_state_dict_from_flax)

B, T, C, H = 2, 32, 64, 2
TOL = dict(rtol=2e-5, atol=2e-5)
CROSS = {"self": False, "ds_self": False, "qv_k": True, "kv": True}
ARCH = dict(input_dim=24, max_seq_len=96, embd_dim=32, fpn_dim=32, head_dim=32, n_head=2,
            arch=(1, 1, 2), mha_win_size=(5, 5, -1),
            regression_range=((0, 4), (4, 8), (8, 10000)), droppath=0.1)


def _setup(rng, mode, window):
    mask = np.ones((B, T), bool)
    mask[0, 27:] = False
    mask[1, 9:] = False
    mf = mask[..., None].astype(np.float32)
    x = rng.standard_normal((B, T, C)).astype(np.float32) * mf
    xo = rng.standard_normal((B, T, C)).astype(np.float32) * mf
    cross = CROSS[mode]
    block = JBlock(n_embd=C, n_head=H, window_size=window,
                   ds_stride=2 if mode == "ds_self" else 1, cross=cross, deterministic=True)
    m = jnp.asarray(mask)
    kw = {} if not cross else dict(x_k=jnp.asarray(xo), mask_k=m, mask_v=m,
                                   x_v=jnp.asarray(xo if mode == "kv" else x))
    params = block.init(jax.random.PRNGKey(0), jnp.asarray(x), m, **kw)
    p = jax.tree_util.tree_map(np.asarray, jax.device_get(params["params"]))
    for name in ("drop_path_attn", "drop_path_mlp"):
        p[name]["scale"] = rng.standard_normal(C).astype(np.float32)
    for n in [p[k] for k in ("ln1", "ln2", "lnq", "lnk", "lnv") if k in p] + \
            [p["attn"][k] for k in ("query_norm", "key_norm", "value_norm")]:
        n["weight"] = (1 + 0.5 * rng.standard_normal(C)).astype(np.float32)
        n["bias"] = (0.3 * rng.standard_normal(C)).astype(np.float32)
    ref, ref_mask = block.apply({"params": p}, jnp.asarray(x), m, **kw)
    return p, x, xo, mask, np.asarray(ref), np.asarray(ref_mask)


def _ours(p, mode, window, **kw):
    blk = tblocks.TransformerBlock(C, H, ds_stride=2 if mode == "ds_self" else 1,
                                   window_size=window, cross=CROSS[mode], **kw)
    blk.load_state_dict(block_state_dict_from_flax(p), strict=True)
    return blk


@pytest.mark.parametrize("mode,window", [("self", 7), ("kv", 7), ("qv_k", 7), ("ds_self", 7),
                                         ("self", -1), ("kv", -1), ("ds_self", -1)])
def test_unfused_block_matches_jax_standard_and_own_fused_path(rng, mode, window):
    p, x, xo, mask, ref, ref_mask = _setup(rng, mode, window)
    blk = _ours(p, mode, window)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    txo = torch.from_numpy(xo) if CROSS[mode] else None
    with torch.no_grad():
        got, got_mask = blk._forward_unfused(tx, tm, txo, mode, False, None)
        fused, fused_mask = blk(tx, tm, xo=txo, mode=mode if CROSS[mode] else None)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert np.array_equal(got_mask.numpy(), ref_mask)
    np.testing.assert_allclose(got.numpy(), fused.numpy(), **TOL)
    assert torch.equal(got_mask, fused_mask)


def test_training_with_dropout_takes_the_unfused_block(rng, monkeypatch):
    """dropout > 0 in training: the unfused path with banded attention
    through the K7 wrapper, gradients down to every parameter; the same seed
    gives the same output; eval stays on the fused path."""
    p, x, _, mask, ref, _ = _setup(rng, "self", 7)
    blk = _ours(p, "self", 7, proj_pdrop=0.3, path_pdrop=0.2)
    assert blk.uses_unfused(True) and not blk.uses_unfused(False)
    calls = []
    orig = k7.band_attention_kernel
    monkeypatch.setattr(k7, "band_attention_kernel",
                        lambda *a: calls.append(1) or orig(*a))
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    outs = [blk(tx, tm, train=True, generator=torch.Generator().manual_seed(s))[0]
            for s in (3, 3, 4)]
    assert len(calls) == 3
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert not np.allclose(outs[0].detach().numpy(), ref, **TOL)     # something was dropped
    outs[0].square().sum().backward()
    assert all(q.grad is not None and torch.isfinite(q.grad).all() for q in blk.parameters())
    with torch.no_grad():
        y, _ = blk(tx, tm)
    np.testing.assert_allclose(y.numpy(), ref, **TOL)
    assert len(calls) == 3


def test_dropout_and_drop_path_statistics():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500)
    y = tblocks.dropout(x, 0.3, True, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    assert torch.allclose(y[kept], torch.tensor(1 / 0.7))
    assert tblocks.dropout(x, 0.3, False, g) is x and tblocks.dropout(x, 0.0, True, g) is x
    for dtype in (torch.float32, torch.bfloat16):
        c = tblocks.drop_path_coefs((20000, 2), 0.1, dtype, "cpu", g)
        assert c.dtype == dtype
        vals = set(c.float().unique().tolist())
        assert vals == {0.0, float(torch.tensor(1 / 0.9).to(dtype))}
        assert abs((c != 0).float().mean().item() - 0.9) < 0.01
    # the draws depend on the seed alone
    a = tblocks.drop_path_coefs((8, 2), 0.5, torch.float32, "cpu", torch.Generator().manual_seed(1))
    b = tblocks.drop_path_coefs((8, 2), 0.5, torch.float32, "cpu", torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_affine_drop_path_drops_whole_samples():
    m = tblocks.AffineDropPath(4, drop_prob=0.5, init_scale=2.0)
    x = torch.ones(64, 3, 4)
    y = m(x, train=True, generator=torch.Generator().manual_seed(0))
    per_sample = y.reshape(64, -1)
    assert all(len(row.unique()) == 1 for row in per_sample)
    assert set(per_sample[:, 0].tolist()) == {0.0, 4.0}
    assert torch.equal(m(x), 2.0 * x) and torch.equal(m(x, train=False), 2.0 * x)


def _model(dropout, remat=False, seed=0):
    cfg = ArchConfig(**ARCH, dropout=dropout, remat=remat)
    return init_localizer(AVLocalizer(cfg), torch.Generator().manual_seed(seed)), cfg


def _inputs(rng):
    x = rng.standard_normal((3, 96, 24)).astype(np.float32)
    mask = np.ones((3, 96), bool)
    mask[1, 70:] = False
    mask[2] = False                      # a padding row of the batch
    return torch.from_numpy(x * mask[..., None]), torch.from_numpy(mask)


def test_interpolator_dropout_only_in_training(rng):
    model, _ = _model(0.0)
    x, mask = _inputs(rng)
    with torch.no_grad():
        a = model(x, mask)["cls_scores"]
        b = model(x, mask, train=False)["cls_scores"]
        c = model(x, mask, train=True, generator=torch.Generator().manual_seed(0))["cls_scores"]
        d = model(x, mask, train=True, generator=torch.Generator().manual_seed(0))["cls_scores"]
    assert torch.equal(a, b) and torch.equal(c, d) and not torch.equal(a, c)
    assert c.dtype == torch.float32


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_padding_row_gives_finite_gradients_and_last_hh_block_none(rng, dropout):
    """-inf sits in the stride-2 max-pool skip and outside the sequence in the
    banded scores; a fully masked row must not poison the gradients. The last
    hh_branch block's output is discarded, so it gets no gradient at all."""
    model, _ = _model(dropout)
    x, mask = _inputs(rng)
    out = model(x, mask, train=True, generator=torch.Generator().manual_seed(0))
    loss = sum(o.square().sum() for o in out["out_cls"] + out["out_offsets"]) \
        + out["cls_scores"].sum()
    loss.backward()
    last = f"backbone.hh_branch.{ARCH['arch'][2] - 1}."
    for name, q in model.named_parameters():
        if name.startswith(last):
            assert q.grad is None, name
        else:
            assert q.grad is not None and torch.isfinite(q.grad).all(), name


def test_remat_recomputes_the_same_draws(rng):
    """Activation checkpointing of the unfused blocks: the recompute winds
    the generator back, so loss and gradients equal the run without it, and
    the generator ends where that run leaves it."""
    x, mask = _inputs(rng)
    results = []
    for remat in (False, True):
        model, _ = _model(0.2, remat=remat)
        g = torch.Generator().manual_seed(5)
        out = model(x, mask, train=True, generator=g)
        loss = sum(o.square().sum() for o in out["out_cls"]) + out["cls_scores"].sum()
        loss.backward()
        results.append((loss.detach(), {n: q.grad for n, q in model.named_parameters()},
                        g.get_state()))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    for n in g0:
        if g0[n] is None:
            assert g1[n] is None
        else:
            np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=n)


def test_train_mode_rejects_sequences_longer_than_max_len(rng):
    model, cfg = _model(0.0)
    x = torch.zeros(1, 192, 24)
    mask = torch.ones(1, 192, dtype=torch.bool)
    with torch.no_grad():
        model(x, mask)                   # eval interpolates the position table
        with pytest.raises(AssertionError):
            model(x, mask, train=True)
    assert dataclasses.replace(cfg, dropout=0.1).dropout == 0.1
