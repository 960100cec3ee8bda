"""PyTorch port, the float32 MViT kernels (K3 pooled attention, K4 whole
MultiscaleBlock in f32): what the CPU can hold of their design.

f32 is the dtype ``cli/extract_features.py`` computes in unless told
otherwise. On the card both kernels' products are 3xTF32 on the tensor
cores (each operand split into a TF32 high part and a residual, hi.hi +
hi.lo + lo.hi, each 32-deep stage's tensor-core sum folded into an f32 sum):
``csrc/mvit_attention_f32.cu``, ``csrc/mvit_block_f32.cu``. Here:

- the attention launch's tiling rendered in torch (``attend_model``: 64-row
  blocks, 32-key tiles, the band's G product over 32 new table rows a tile
  into a ring of 128 columns and gathered from it, the online softmax, P.V
  from split P and the transposed, permuted v, the class key by an f32 dot),
  its sums in the tensor-core model of ``tests/tf32_model.py``, held to the
  f32 plain versions (atol 1e-5) and, from an f64 reference, to no more than
  2x the f32 plain version's distance: K3's blocks 0-1 (S = 64, d = 96) and
  block 23 (S = 1, d = 32), K4's attention step at each stage (class row
  first), and the band given;
- P's register fragment against the value rows' key order;
- the packing's weight split: hi has at most 10 mantissa bits, hi + lo is
  the f32 weight to the split's own rounding, the layout the kernel carves.
The port's f32 ``msblock_math`` is held to the JAX block at the three
production geometries by ``tests/test_torch_mvit_kernels.py``."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tf32_model import tc_matmul
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_attention as tk3
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_block as tk4
from audio_visual_deepfake_detection_tpu_torch.ops.kernels.fused_block import tf32_split

ROWS, KEYS, RING = 64, 32, 128       # csrc/mvit_attention_f32.cu


def key_pos(k):
    """csrc/mvit_f32.cuh::f32_key_pos: within each eight keys of a
    transposed value row, the even keys first, then the odd ones."""
    return (k & ~7) | ((k & 1) << 2) | ((k >> 1) & 3)


def attend_model(q, k, v, rel, t, s, scale, cls=0, band=None):
    """csrc/mvit_attention_f32.cu's arithmetic for one (sample, head) in
    torch: q (nq, d) f32 (row 0 the class query when ``cls``), k / v (t + 1,
    d) f32 with the class token last, the table rel (>= 2t - 1, d) or the
    band (nq - cls, t). Products by ``tc_matmul`` (per 32-deep stage);
    returns (nq, d) f32."""
    nq, d = q.shape
    wd = -(-d // 32) * 32
    nt = -(-t // KEYS)
    tp = nt * KEYS
    qp = F.pad(q, (0, wd - d))
    kp = F.pad(k[:t], (0, wd - d, 0, tp - t))
    vt = torch.zeros(wd, tp)                            # v^T, keys at key_pos
    vt[:d, key_pos(torch.arange(t))] = v[:t].t()
    relp = None if rel is None else F.pad(rel[:2 * t - 1], (0, wd - d))
    kc, vc = k[t], v[t]
    out = torch.empty(nq, d)
    f32 = lambda a: a.float()                           # noqa: E731
    for n0 in range(0, nq, ROWS):
        rows = torch.arange(n0, min(n0 + ROWS, nq))
        qb = qp[rows]
        banded = rows >= cls
        tr = (rows - cls).clamp(min=0) // s + t - 1     # table row of key 0
        m = torch.full((len(rows),), -math.inf)
        z = torch.zeros(len(rows))
        o = torch.zeros(len(rows), wd)
        M = 0
        if relp is not None:
            t_first = max(n0 - cls, 0) // s
            t_last = max(min(n0 + ROWS, nq) - 1 - cls, 0) // s
            M = (t_last - t_first + 31) // 32
            jb0 = t_first + t - KEYS
            ring = torch.full((len(rows), RING), float("nan"))
        for i in range(-M, nt):
            if relp is not None:                       # 32 new table rows of G
                j = jb0 - KEYS * i + torch.arange(KEYS)
                ok = (j >= 0) & (j <= 2 * t - 2)
                tab = torch.where(ok[:, None], relp[j.clamp(0, 2 * t - 2)], torch.zeros(()))
                ring[:, j & (RING - 1)] = f32(tc_matmul(qb, tab, 32))
            if i < 0:
                continue
            keys = KEYS * i + torch.arange(KEYS)
            sc = f32(tc_matmul(qb, kp[keys], 32)) * scale
            valid = keys < t
            if relp is not None:
                gb = ring.gather(1, (tr[:, None] - keys[None, :]) & (RING - 1))
            else:
                gb = band[(rows - cls).clamp(min=0)][:, keys.clamp(max=t - 1)]
            sc = torch.where(banded[:, None] & valid[None, :], sc + gb, sc)
            sc = torch.where(valid[None, :], sc, torch.full((), -math.inf))
            mn = torch.maximum(m, sc.amax(1))
            rescale = torch.exp(m - mn)
            p = torch.exp(sc - mn[:, None])
            z = z * rescale + p.sum(1)
            m = mn
            # P.V: P's columns in the value rows' order, both split
            pp = torch.empty_like(p)
            pp[:, key_pos(torch.arange(KEYS))] = p
            pv = f32(tc_matmul(pp, vt[:, KEYS * i:KEYS * (i + 1)], 32))
            o = o * rescale[:, None] + pv
        c = (q[rows] * kc).sum(1) * scale               # the class key, an f32 dot
        mc = torch.maximum(m, c)
        a, e = torch.exp(m - mc), torch.exp(c - mc)
        z = z * a + e
        y = (o[:, :d] * a[:, None] + e[:, None] * vc) / z[:, None]
        out[rows] = torch.where(banded[:, None], y + q[rows], y)
    return out


def plain_f32(q, k, v, rel, t, s, scale, cls=0, band=None, dtype=torch.float32):
    """The plain versions' function on the same inputs in ``dtype``: the
    grid rows by ``pooled_attention_math`` on the band ``table_band`` builds
    (or the band given); the class row (``cls``) softmax(scale q0 k^T) v, no
    residual. float64 with every step in f64: the exact attention of the
    f32 inputs."""
    q, k, v = (a.to(dtype) for a in (q, k, v))
    g = q[cls:]
    if band is None and dtype == torch.float64:   # band[n, k] = g[n] . rel[t_n - k + t - 1]
        tn = torch.arange(len(g)) // s
        idx = tn[:, None] - torch.arange(t)[None, :] + t - 1
        band = (g[:, None, :] * rel.to(dtype)[idx]).sum(-1)
    elif band is None:
        band = tk3.table_band(g[None, None], rel, t, s, False)[0, 0]
    if dtype == torch.float64:
        sc = g @ k.t() * scale
        sc[:, :-1] += band.to(dtype)
        out = torch.softmax(sc, -1) @ v + g
    else:
        out = tk3.pooled_attention_math(g[None], k[None], v[None], band[None], scale)[0]
    if cls:
        c = torch.softmax((q[:1] @ k.t()) * scale, -1) @ v
        out = torch.cat([c, out])
    return out


# name, S (spatial cells), d, t, class row first, band from the table
CASES = [("K3 blocks 0-1", 64, 96, 8, 0, True),
         ("K3 block 23", 1, 32, 8, 0, True),
         ("K4 stage 2", 16, 96, 8, 1, True),
         ("K4 stage 3", 4, 96, 8, 1, True),
         ("K4 stage 4", 1, 96, 8, 1, True),
         ("K3 band given", 4, 64, 8, 0, False),
         ("two key tiles, ragged", 2, 64, 45, 1, True),
         ("head dim 36", 4, 36, 8, 0, True)]


@pytest.mark.parametrize("name,s,d,t,cls,table", CASES, ids=[c[0] for c in CASES])
def test_attention_tiling_matches_plain_and_f64(rng, name, s, d, t, cls, table):
    nq = cls + t * s
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((t + 1, d)).astype(np.float32))
            for _ in range(2))
    rel = torch.from_numpy((0.3 * rng.standard_normal((2 * t - 1, d))).astype(np.float32))
    band = None if table else torch.from_numpy(
        rng.standard_normal((nq - cls, t)).astype(np.float32))
    scale = d ** -0.5
    got = attend_model(q, k, v, rel if table else None, t, s, scale, cls, band)
    want = plain_f32(q, k, v, rel, t, s, scale, cls, band)
    exact = plain_f32(q, k, v, rel, t, s, scale, cls, band, torch.float64)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-5
    model_err = (got.double() - exact).abs().max().item()
    plain_err = (want.double() - exact).abs().max().item()
    assert model_err <= 2 * plain_err, (model_err, plain_err)


def test_p_fragment_follows_the_value_rows_key_order():
    """P.V's register operand: thread (g, t) of a warp hands key tile step
    s8 the scores it holds at accumulator elements 4 s8 + (0, 2, 1, 3)
    (keys 8 s8 + 2t, 2t, 2t + 1, 2t + 1 of rows g, g + 8, g, g + 8) as its
    fragment a0..a3 (rows g, g + 8, g, g + 8; logical columns t, t, t + 4,
    t + 4). The value row stores at position 8 s8 + l the key of logical
    column l: each slot multiplies its own key's value."""
    for s8 in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            # accumulator element e of column block s8: row g + 8 (e >> 1), key 8 s8 + 2t + (e & 1)
            acc_key = {e: (g + 8 * (e >> 1), 8 * s8 + 2 * t + (e & 1)) for e in range(4)}
            frag = [acc_key[0], acc_key[2], acc_key[1], acc_key[3]]
            want_rows = [g, g + 8, g, g + 8]
            logical = [t, t, t + 4, t + 4]
            for (row, key), wrow, col in zip(frag, want_rows, logical):
                assert row == wrow
                assert key_pos(key) == 8 * s8 + col


def test_split_weights_parts_and_layout(rng):
    c, nh, rows = 192, 2, 15
    d = c // nh
    params = {
        "norm1.weight": torch.ones(c), "norm1.bias": torch.zeros(c),
        "norm2.weight": torch.ones(c), "norm2.bias": torch.zeros(c),
        "attn.qkv.weight": torch.from_numpy(rng.standard_normal((3 * c, c)).astype(np.float32)),
        "attn.qkv.bias": torch.zeros(3 * c),
        "attn.project.weight": torch.from_numpy(rng.standard_normal((c, c)).astype(np.float32)),
        "attn.project.bias": torch.zeros(c),
        "mlp.0.weight": torch.from_numpy(
            (1e-3 * rng.standard_normal((4 * c, c))).astype(np.float32)),
        "mlp.0.bias": torch.zeros(4 * c),
        "mlp.3.weight": torch.from_numpy(
            (3e4 * rng.standard_normal((c, 4 * c))).astype(np.float32)),
        "mlp.3.bias": torch.zeros(c),
        "attn.rel_pos_t": torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)),
    }
    for w in "qkv":
        params[f"attn.pool_{w}.pool.weight"] = torch.ones(d, 1, 3, 3, 3)
        params[f"attn.pool_{w}.norm_act.0.weight"] = torch.ones(d)
        params[f"attn.pool_{w}.norm_act.0.bias"] = torch.zeros(d)
    assert tk4.pack_msblock_params(params, nh, torch.bfloat16).split is None
    p = tk4.pack_msblock_params(params, nh, torch.float32)
    wd = tk4.head_width(d)
    assert wd == 96 and p.split.dtype == torch.float32
    assert p.split.shape == (24 * c * c + 2 * rows * wd,)
    # the kernel's carve: wqkv, wp, w1, w2 (hi, lo each), then the table hi, lo
    at, parts = 0, {}
    for name, w in (("wqkv", p.wqkv), ("wp", p.wp), ("w1", p.w1), ("w2", p.w2),
                    ("rel", F.pad(p.rel_t, (0, wd - d)))):
        n = w.numel()
        parts[name] = (w, p.split[at:at + n].view(w.shape), p.split[at + n:at + 2 * n].view(w.shape))
        at += 2 * n
    assert at == p.split.numel()
    assert torch.equal(parts["rel"][1][:, d:], torch.zeros(rows, wd - d))
    for name, (w, hi, lo) in parts.items():
        bits = hi.contiguous().view(torch.int32) & 0x1FFF
        assert int(bits.abs().max()) == 0, name                      # at most 10 mantissa bits
        assert int((lo.contiguous().view(torch.int32) & 0x1FFF).abs().max()) == 0, name
        assert torch.equal(hi, tf32_split(w)[0]) and torch.equal(lo, tf32_split(w)[1])
        assert torch.all((hi.double() + lo.double() - w.double()).abs()
                         <= w.double().abs() * 2.0 ** -22), name


@pytest.mark.parametrize("view,aligned", [
    ("fresh", True),                 # an allocation starts on 16 bytes
    ("grid rows", True),             # q[:, :, 1:] of the pooled (B, nh, 1 + N, 96) q
    ("offset 1", False),             # data one float past 16 bytes
    ("stride 97", False),            # rows 97 floats apart
    ("transposed", False),           # no unit last stride
])
def test_f32_attention_operands_the_tensor_cores_take(view, aligned):
    """The f32 K3 wrapper hands the tensor-core route only 16-byte aligned
    operands with outer strides that are multiples of 4 (it copies any
    other; the C entry refuses them)."""
    base = torch.zeros(2, 3, 9, 97)
    a = {"fresh": torch.zeros(2, 3, 8, 96), "grid rows": torch.zeros(2, 3, 9, 96)[:, :, 1:],
         "offset 1": base.view(-1)[1:1 + 2 * 3 * 8 * 96].view(2, 3, 8, 96),
         "stride 97": base[..., :96], "transposed": torch.zeros(2, 3, 96, 8).transpose(2, 3)}[view]
    assert tk3._aligned(a) is aligned
    if not aligned:
        assert tk3._aligned(a.clone(memory_format=torch.contiguous_format))
