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


# ------------------------------------------- the bf16 kernel's decomposition
# csrc/fused_block.cu runs bf16 as two launches over tiles of 64 rows:
# launch 1 writes qkv_rows to a (B, T, 3C) scratch, reading input rows
# r0 - 1 .. r0 + 64 of its tile; launch 2 runs block_tail, reading the
# scratch rows r0 - w .. r0 + 63 + w (all rows when dense) and x / xo rows
# r0 - 1 .. r0 + 63. Its products take the weights from a ring of 32 KB
# stages that TMA fills with 128-byte-swizzled boxes.
K_C, K_H, TILE = tfb.KERNEL_CHANNELS, tfb.KERNEL_HEADS, 64


def _kernel_block(rng, mode, window):
    """A production-width block with random weights and O(1) layer scales."""
    blk = TransformerBlock(K_C, K_H, ds_stride=2 if mode == "ds_self" else 1,
                           window_size=window, cross=CROSS[mode])
    sd = {}
    for name, a in blk.state_dict().items():
        v = rng.standard_normal(tuple(a.shape)).astype(np.float32)
        if name.endswith("weight") and a.dim() >= 2:
            v /= np.sqrt(np.prod(a.shape[1:]))
        elif "norm" in name or name.startswith("ln"):
            v = (1 + 0.5 * v) if name.endswith("weight") else 0.3 * v
        sd[name] = torch.from_numpy(v)
    blk.load_state_dict(sd)
    return blk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [7, -1])
@pytest.mark.parametrize("mode", ["self", "qv_k", "kv", "ds_self"])
def test_two_launch_tiles_stitch_to_block_math(rng, mode, window, dtype):
    """Each tile of each launch computed from its own rows alone (T = 150:
    two full tiles and a ragged one; valid lengths 150, 97, 1 and 0), stitched
    together, is block_math on the whole sequence."""
    t, w = 150, max(window // 2, 0)
    packed = list(_kernel_block(rng, mode, window).packed(dtype))
    vecs, wq, wk, wv, wp, wf1, wf2, fc1b = packed
    lens = torch.tensor([t, 97, 1, 0])
    mrow = (torch.arange(t)[None, :] < lens[:, None]).float()[..., None]
    x = (torch.from_numpy(rng.standard_normal((4, t, K_C)).astype(np.float32)) * mrow).to(dtype)
    xo = (torch.from_numpy(rng.standard_normal((4, t, K_C)).astype(np.float32)) * mrow).to(dtype)
    if mode == "self":
        xo = x
    coefs = torch.tensor([[1.0, 1.0], [0.0, 1 / 0.9], [1 / 0.9, 0.0], [1.0, 1.0]])
    kw = dict(n_head=K_H, mode=mode)
    q, k, v = (torch.zeros_like(x) for _ in range(3))
    for r0 in range(0, t, TILE):
        lo, hi = max(r0 - 1, 0), min(r0 + TILE + 1, t)
        part = tfb.qkv_rows(x[:, lo:hi], xo[:, lo:hi], mrow[:, lo:hi], vecs, wq, wk, wv, **kw)
        for whole, p in zip((q, k, v), part):
            whole[:, r0:r0 + TILE] = p[:, r0 - lo:r0 - lo + TILE]
    for got, want in zip((q, k, v), tfb.qkv_rows(x, xo, mrow, vecs, wq, wk, wv, **kw)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    y = torch.empty_like(x)
    for r0 in range(0, t, TILE):
        lo, hi = (max(r0 - max(w, 1), 0), min(r0 + TILE + w, t)) if w else (0, t)
        part = tfb.block_tail(q[:, lo:hi], k[:, lo:hi], v[:, lo:hi], x[:, lo:hi], xo[:, lo:hi],
                              mrow[:, lo:hi], coefs, vecs, wp, wf1, wf2, fc1b,
                              w_overlap=window // 2, **kw)
        y[:, r0:r0 + TILE] = part[:, r0 - lo:r0 - lo + TILE]
    want = tfb.block_math(x, xo, mrow, coefs, *packed, w_overlap=window // 2, **kw)
    # the same operations on fewer rows: equal up to the f32 sums' blocking
    torch.testing.assert_close(y.float(), want.float(), rtol=1e-5, atol=1e-5)


def _tma_box(mat, k0, n0, rows):
    """A TMA box of 64 inputs x ``rows`` outputs of an (out, in) matrix as
    it lands in shared memory: row n holds 128 bytes, its 16-byte chunk c at
    chunk c ^ (n % 8) (CU_TENSOR_MAP_SWIZZLE_128B on a 1024-byte boundary)."""
    img = np.zeros((rows, 64), np.float32)
    for n in range(rows):
        for c in range(8):
            img[n, 8 * (c ^ (n % 8)):8 * (c ^ (n % 8)) + 8] = mat[n0 + n, k0 + 8 * c:k0 + 8 * c + 8]
    return img


def _desc_read(img, row0, kk, rows):
    """The K-major operand a wgmma descriptor at stage row ``row0``, byte
    offset 32 kk names: ``rows`` x 16 inputs, unswizzled."""
    out = np.zeros((rows, 16), np.float32)
    for n in range(rows):
        r = row0 + n
        for k in range(16):
            c = (2 * kk + k // 8) ^ (r % 8)
            out[n, k] = img[r, 8 * c + k % 8]
    return out


def _stages(weights, phase):
    """The producer's schedule (csrc/fused_block.cu::produce) as stage
    images of 256 rows: QKV wq, wk, wv in four 64-deep slices; TAIL wp, then
    per hidden chunk j the fc1 rows (four 64 x 64 boxes, one per slice) and
    the fc2 columns."""
    wq, wk, wv, wp, wf1, wf2 = weights
    if phase == "qkv":
        return [_tma_box(m, 64 * kb, 0, 256) for m in (wq, wk, wv) for kb in range(4)]
    out = [_tma_box(wp, 64 * kb, 0, 256) for kb in range(4)]
    for j in range(16):
        out.append(np.concatenate([_tma_box(wf1, 64 * kb, 64 * j, 64) for kb in range(4)]))
        out.append(_tma_box(wf2, 64 * j, 0, 256))
    return out


def test_weight_stages_reproduce_each_product(rng):
    """The six products summed the way the consumers read the ring (per
    stage and 16-deep step: A's slice against the descriptor's operand) are
    the plain a @ W.T, fc2 accumulated over the 16 hidden chunks."""
    ws = [rng.standard_normal(s).astype(np.float32) for s in
          [(256, 256)] * 4 + [(1024, 256), (256, 1024)]]
    a = rng.standard_normal((64, 256)).astype(np.float32)
    h = rng.standard_normal((64, 1024)).astype(np.float32)
    qkv, tail = _stages(ws, "qkv"), _stages(ws, "tail")
    assert len(qkv) == 12 and len(tail) == 36 and all(s.shape == (256, 64) for s in qkv + tail)

    def product(stages):      # four stages of 256 outputs, 64 inputs each
        acc = np.zeros((64, 256))
        for kb, img in enumerate(stages):
            for kk in range(4):
                acc += a[:, 64 * kb + 16 * kk:64 * kb + 16 * kk + 16] @ _desc_read(img, 0, kk, 256).T
        return acc

    for i, wmat in enumerate(ws[:3]):
        np.testing.assert_allclose(product(qkv[4 * i:4 * i + 4]), a @ wmat.T, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(product(tail[:4]), a @ ws[3].T, rtol=1e-5, atol=1e-4)
    fc2 = np.zeros((64, 256))
    for j in range(16):
        fc1 = np.zeros((64, 64))
        for kb in range(4):
            for kk in range(4):
                fc1 += a[:, 64 * kb + 16 * kk:64 * kb + 16 * kk + 16] @ \
                    _desc_read(tail[4 + 2 * j], 64 * kb, kk, 64).T
        np.testing.assert_allclose(fc1, a @ ws[4][64 * j:64 * j + 64].T, rtol=1e-5, atol=1e-4)
        for kk in range(4):
            fc2 += h[:, 64 * j + 16 * kk:64 * j + 16 * kk + 16] @ \
                _desc_read(tail[5 + 2 * j], 0, kk, 256).T
    np.testing.assert_allclose(fc2, h @ ws[5].T, rtol=1e-5, atol=1e-4)
