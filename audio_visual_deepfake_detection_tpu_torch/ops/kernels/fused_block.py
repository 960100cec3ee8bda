"""Fused localizer transformer block: the CUDA kernel, its plain version and
the parameter packing (JAX ``ops/pallas/fused_block.py``).

``fused_transformer_block`` (K1, eval) and ``fused_transformer_block_train``
(K6, training) are the two wrappers the model calls. For a CUDA tensor on an
sm_90 card they launch ``csrc/fused_block.cu`` (bf16) or
``csrc/fused_block_f32.cu`` (f32; both replace the Pallas
kernel ``fused_transformer_block``, ``pallas_call`` at ``fused_block.py:535``,
and through it ``fused_transformer_block_train``, ``:753``) at every block
shape of ``kernel_shape_ok``, the Pallas kernel's per-shape domain cut at C
<= 2048 and head widths that are multiples of 8 up to 512, any window, all
on the tensor cores: bf16 at C up to 1024 and head widths 32 / 64 / 96 /
128 (``wgmma_shape_ok``) on its two-launch design, past that on the eight
launches of ``csrc/fused_block_bf16.cu``; f32 on its eight launches
everywhere, the attention at other head widths padded to an instance's or
in 128-column blocks. For a CPU tensor they run ``block_math``. Nothing
else routes between the two (``core/runtime.py::use_kernel``); ``ROUTES``
counts the launches by the route the C entry reports it took
(``ROUTE_NAMES``, ``route_of``).

K6 is K1's forward with per-sample droppath coefficients ``coefs`` (B, 2) in
{0, 1/keep} (or 1) multiplied into the two layer scales, inside a
``torch.autograd.Function`` that saves only its inputs. Its backward is no
kernel in either package: it recomputes ``block_math`` from the saved inputs
under ``torch.enable_grad()`` and differentiates that (remat semantics: one
block's intermediates live only during its own backward), as the JAX
``_trainable_block`` differentiates its mirror. ``pack_block_params`` is
differentiable, so the gradients of the 8 packed tensors flow on to the
block's parameters through the folds.

For float32 the kernel sums its products in 3xTF32 on the tensor cores;
``split_matmul`` is the split of that product in plain PyTorch, its sums
rounded to nearest (the tensor cores cut theirs toward zero, which the
tests model apart), held to f32 and f64 products by the tests.
``block_math`` keeps the f32 matmul.

``block_math`` is a torch transliteration of the JAX ``block_math``
(``fused_block.py:562-723``) and keeps the numerics that matter:
- ``cdot``: f32 accumulation, then rounding to the compute dtype,
- LN moments one-pass in bf16, two-pass in f32,
- the division-free GELU polynomial in bf16, the exact rational GELU in f32,
- banded scores and the -1e4 penalty in the compute dtype, f32 softmax, the
  context accumulated offset by offset in the compute dtype.
The JAX kernel's lane-layout variants (``PACKED_SOFTMAX``, ``BAND_VIA_DENSE``)
are not ported: both were measured neutral or slower on the TPU.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from ...core.runtime import use_kernel

NEG_PENALTY = -1e4   # finite masked-key penalty of the banded path
NEG_INF = -1e30      # band / sequence edge: effectively -inf, NaN-safe
LN_EPS = 1e-5

ROW_LNQ_W, ROW_LNQ_B = 0, 1
ROW_LNK_W, ROW_LNK_B = 2, 3
ROW_LNV_W, ROW_LNV_B = 4, 5
ROW_QCONV, ROW_KCONV, ROW_VCONV = 6, 9, 12   # 3 rows each
ROW_Q_BIAS, ROW_K_BIAS, ROW_V_BIAS, ROW_P_BIAS = 15, 16, 17, 18
ROW_SCALE_ATTN = 19
ROW_FC2_BIAS = 20
ROW_SCALE_MLP = 21
NUM_VEC_ROWS = 22

MODES = {"self": 0, "qv_k": 1, "kv": 2, "ds_self": 3}
# the kernel's shape domain (csrc/fused_block.cuh::shape_ok): C a multiple of
# 64 up to MAX_CHANNELS, a head width C / n_head that is a multiple of
# HEAD_WIDTH_STEP up to MAX_HEAD_WIDTH, any half window or dense (w <= 0), at
# any T; WGMMA_HEAD_WIDTHS up to WGMMA_CHANNELS take the bf16 two-launch
# design (wgmma_shape_ok), every other shape the bf16 scratch route
MAX_CHANNELS = 2048
HEAD_WIDTH_STEP = 8
MAX_HEAD_WIDTH = 512
WGMMA_CHANNELS = 1024
WGMMA_HEAD_WIDTHS = (32, 64, 96, 128)

# the routes of the C entry (csrc/fused_block.cuh::ROUTE_*): f32's eight
# launches and bf16's two-launch design inside wgmma_shape_ok, f32's and
# bf16's scratch routes past it
ROUTE_NAMES = ("wgmma 3xTF32", "wgmma bf16", "wgmma 3xTF32 past wgmma_shape_ok",
               "wgmma bf16 past wgmma_shape_ok")

# kernel launches since the last reset (CPU calls and plain runs never
# count): eval launches (K1) and training-forward launches (K6) apart, and
# both together by the route the C entry reports it took (ROUTE_NAMES)
LAUNCHES = 0
TRAIN_LAUNCHES = 0
ROUTES = collections.Counter()


def reset_launches() -> None:
    global LAUNCHES, TRAIN_LAUNCHES
    LAUNCHES = 0
    TRAIN_LAUNCHES = 0
    ROUTES.clear()


# --------------------------------------------------------------- plain math

def _shift_rows(x: torch.Tensor, d: int) -> torch.Tensor:
    """y[:, i] = x[:, i + d] along dim 1, zero fill."""
    if d == 0:
        return x
    y = torch.zeros_like(x)
    if d > 0:
        y[:, :-d] = x[:, d:]
    else:
        y[:, -d:] = x[:, :d]
    return y


def _erf(x: torch.Tensor) -> torch.Tensor:
    """f32 Eigen rational erf, x clamped to [-4, 4] (JAX ``_erf``)."""
    x = torch.clamp(x, -4.0, 4.0)
    x2 = x * x
    a = torch.full_like(x, -2.72614225801306e-10)
    for cc in (2.77068142495902e-08, -2.10102402082508e-06,
               -5.69250639462346e-05, -7.34990630326855e-04,
               -2.95459980854025e-03, -1.60960333262415e-02):
        a = a * x2 + cc
    b = torch.full_like(x, -1.45660718464996e-05)
    for cc in (-2.13374055278905e-04, -1.68282697438203e-03,
               -7.37332916720468e-03, -1.42647390514189e-02):
        b = b * x2 + cc
    return x * a / b


_GELU_T_COEFFS = (
    0.49765539169311523, -0.23859895765781403, 0.1585356444120407,
    -0.10322453081607819, 0.06115540862083435, -0.03750486299395561,
    0.023225031793117523, -0.007718835957348347,
)


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + _erf(x * (1.0 / math.sqrt(2.0))))


def _gelu_cheap(x: torch.Tensor) -> torch.Tensor:
    xc = torch.clamp(x, -4.0, 4.0)
    t = xc * xc * (1.0 / 8.0) + (-1.0)
    p = torch.full_like(x, _GELU_T_COEFFS[-1])
    for cc in _GELU_T_COEFFS[-2::-1]:
        p = p * t + cc
    return 0.5 * x + (math.sqrt(2.0) / 4.0) * x * (xc * p)


def _gelu(x: torch.Tensor, cdtype) -> torch.Tensor:
    return _gelu_cheap(x) if cdtype == torch.bfloat16 else _gelu_exact(x)


def _ln_plain(x: torch.Tensor, cdtype) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    if cdtype == torch.bfloat16:
        m2 = (xf * xf).mean(-1, keepdim=True)
        rs = torch.rsqrt(torch.clamp(m2 - mu * mu, min=0.0) + LN_EPS)
        return xf * rs - mu * rs
    r = xf - mu
    return r * torch.rsqrt((r * r).mean(-1, keepdim=True) + LN_EPS)


def tf32_split(x: torch.Tensor):
    """The f32 kernel's operand split of an f32 tensor: (hi, lo), hi = x
    rounded to TF32 (10 mantissa bits; to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32``), lo = x - hi rounded the same way; hi + lo is x to
    2^-22 of it."""

    def rna(v):
        bits = v.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x)
    return hi, rna(x.float() - hi)


def split_matmul(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a @ m.T as the f32 kernel's products form it (3xTF32): the TF32 parts
    of both operands, hi.hi + hi.lo + lo.hi (lo.lo left out), each product of
    TF32 values exact in f32, summed in f32 rounding to nearest (on the card
    the tensor cores cut each 32-deep stage's sum toward zero)."""
    ah, al = tf32_split(a)
    mh, ml = tf32_split(m)
    return ah @ mh.t() + (ah @ ml.t() + al @ mh.t())


def _cdot(a, m):
    """a @ m.T, m (out, in): f32 sums of the compute-dtype values, rounded
    once to a's dtype."""
    return torch.matmul(a.float(), m.float().t()).to(a.dtype)


def qkv_rows(x, xo, mrow, vecs, wq, wk, wv, *, n_head: int, mode: str):
    """The first half of ``block_math``, what the bf16 kernel's first launch
    writes to its (B, T, 3C) scratch: the q (scaled), k and v rows. Row i
    reads input rows i - 1 .. i + 1 only."""
    cdtype = x.dtype
    d_head = x.shape[-1] // n_head
    mvalid = mrow

    def rows(i):
        return vecs[i][None, None, :]

    def ln(xx, row_w, row_b):
        return _ln_plain(xx, cdtype) * rows(row_w) + rows(row_b)

    def dwconv(xx, row0):
        xf = xx.float()
        y = (_shift_rows(xf, -1) * rows(row0) + xf * rows(row0 + 1)
             + _shift_rows(xf, 1) * rows(row0 + 2))
        return y * mvalid

    def dwconv2(even, odd, row0):
        ef, of = even.float(), odd.float()
        y = (_shift_rows(of, -1) * rows(row0) + ef * rows(row0 + 1)
             + of * rows(row0 + 2))
        return y * mvalid

    def post_ln(y):
        return _ln_plain(y.to(cdtype), cdtype).to(cdtype)

    if mode == "ds_self":
        le = ln(x, ROW_LNQ_W, ROW_LNQ_B).to(cdtype)
        lo = ln(xo, ROW_LNQ_W, ROW_LNQ_B).to(cdtype)
        q, k, v = (post_ln(dwconv2(le, lo, r)) for r in (ROW_QCONV, ROW_KCONV, ROW_VCONV))
    else:
        if mode == "self":
            lq = lk = lv = ln(x, ROW_LNQ_W, ROW_LNQ_B).to(cdtype)
        else:
            lq = ln(x, ROW_LNQ_W, ROW_LNQ_B).to(cdtype)
            lk = ln(xo, ROW_LNK_W, ROW_LNK_B).to(cdtype)
            lv = ln(x if mode == "qv_k" else xo, ROW_LNV_W, ROW_LNV_B).to(cdtype)
        q = post_ln(dwconv(lq, ROW_QCONV))
        k = post_ln(dwconv(lk, ROW_KCONV))
        v = post_ln(dwconv(lv, ROW_VCONV))

    q = _cdot(q, wq) + vecs[ROW_Q_BIAS].to(cdtype)
    k = _cdot(k, wk) + vecs[ROW_K_BIAS].to(cdtype)
    v = _cdot(v, wv) + vecs[ROW_V_BIAS].to(cdtype)
    q = q * torch.tensor(1.0 / math.sqrt(d_head), dtype=cdtype, device=x.device)
    return q, k, v


def attention_ctx(q, k, v, mrow, *, n_head: int, w_overlap: int) -> torch.Tensor:
    """The attention of ``block_tail`` on the (B, T, C) q (scaled), k and v
    rows of ``qkv_rows`` and the (B, T, 1) f32 mask: per head, dense
    (``w_overlap`` <= 0) or over the 2w + 1 offsets of the band. Returns the
    (B, T, C) context, invalid rows zero. On the card the bf16 kernel runs it
    inside its second launch (bands up to 16) or as a launch of its own on
    the tensor cores (dense and wider bands, csrc/fused_block_attend.cu)."""
    w = w_overlap
    cdtype = q.dtype
    b, t, c = q.shape
    d_head = c // n_head
    mvalid_c = mrow.to(cdtype)
    pen = (mrow - 1.0) * (-NEG_PENALTY)
    row = torch.arange(t, device=q.device)[:, None]
    if w <= 0:
        # dense attention: -1e30 fill on invalid keys, values masked
        colok = (mrow[..., 0] > 0.5)[:, None, :]
        fill = torch.tensor(NEG_INF, dtype=cdtype, device=q.device)
        vm = v * mvalid_c
        ctx = torch.zeros_like(q)
        for h in range(n_head):
            sl = slice(h * d_head, (h + 1) * d_head)
            s = torch.matmul(q[..., sl].float(), k[..., sl].float().transpose(1, 2)
                             ).to(cdtype)
            sf = torch.where(colok, s, fill).float()
            e = torch.exp(sf - sf.amax(-1, keepdim=True))
            p = (e / e.sum(-1, keepdim=True)).to(cdtype)
            ctx[..., sl] = torch.matmul(p.float(), vm[..., sl].float()).to(cdtype)
        ctx = ctx * mvalid_c
    else:
        # banded: per-offset head-reduced scores in the compute dtype
        pen_c = pen.to(cdtype)
        scores = []
        for d in range(-w, w + 1):
            e = q * _shift_rows(k, d)
            s = (e.float().reshape(b, t, n_head, d_head).sum(-1).to(cdtype)
                 + _shift_rows(pen_c, d))
            ok = (row + d >= 0) & (row + d < t)
            scores.append(torch.where(ok[None], s.float(), NEG_INF))
        m = scores[0]
        for s in scores[1:]:
            m = torch.maximum(m, s)
        exps = [torch.exp(s - m) for s in scores]
        den = exps[0]
        for e in exps[1:]:
            den = den + e
        inv = 1.0 / den
        ctx = torch.zeros_like(q)
        for i, d in enumerate(range(-w, w + 1)):
            p = (exps[i] * inv).to(cdtype)
            pb = torch.repeat_interleave(p, d_head, dim=-1)
            ctx = ctx + pb * _shift_rows(v, d)
        ctx = ctx * mvalid_c
    return ctx


def block_tail(q, k, v, x, xo, mrow, coefs, vecs, wp, wf1, wf2, fc1b, *, n_head: int,
               w_overlap: int, mode: str):
    """The second half of ``block_math``, the bf16 kernel's second launch
    (with the attention launch before it where that takes the attention):
    attention over the q, k, v rows of ``qkv_rows``, proj, the layer-scaled
    residual, LN and the MLP. Row i reads q row i, k and v rows i - w ..
    i + w (all rows when dense) and x (ds_self: xo too) rows i - 1 .. i."""
    w = w_overlap
    cdtype = x.dtype
    t = x.shape[1]
    mvalid = mrow
    mvalid_c = mvalid.to(cdtype)
    coef_attn = coefs[:, 0][:, None, None]
    coef_mlp = coefs[:, 1][:, None, None]

    def rows(i):
        return vecs[i][None, None, :]

    row = torch.arange(t, device=x.device)[:, None]
    ctx = attention_ctx(q, k, v, mvalid, n_head=n_head, w_overlap=w)
    att = _cdot(ctx, wp) + vecs[ROW_P_BIAS].to(cdtype)
    att = att * mvalid_c
    if mode == "ds_self":
        om1 = _shift_rows(xo, -1)
        om1 = torch.where(row[None] == 0, torch.tensor(-math.inf, dtype=cdtype,
                                                       device=x.device), om1)
        # MaxPool(3, 2, 1) over (x[2t-1], x[2t], x[2t+1]); at a tie the
        # gradient goes to the first of the equal rows, as MaxPool1d's and
        # the JAX block's reduce_window send it (torch.maximum would split it)
        skip = torch.where(om1 >= torch.maximum(x, xo), om1, torch.where(x >= xo, x, xo))
    else:
        skip = x
    scale_a = (rows(ROW_SCALE_ATTN) * coef_attn).to(cdtype)
    y1 = skip * mvalid_c + att * scale_a

    h = _ln_plain(y1, cdtype).to(cdtype)
    h = _cdot(h, wf1) + fc1b[0].to(cdtype)
    h = _gelu(h.float(), cdtype).to(cdtype)
    h = _cdot(h, wf2) + vecs[ROW_FC2_BIAS].to(cdtype)
    h = h * mvalid_c
    y = y1 + h * (rows(ROW_SCALE_MLP) * coef_mlp).to(cdtype)
    return y.to(cdtype)


def block_math(x, xo, mrow, coefs, vecs, wq, wk, wv, wp, wf1, wf2, fc1b,
               *, n_head: int, w_overlap: int, mode: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel on (B, T, C) inputs; ``mrow`` is
    the (B, T, 1) f32 mask, ``coefs`` the (B, 2) droppath coefficients, the
    dense weights ``(out, in)`` as ``pack_block_params`` makes them. It is
    ``block_tail`` of ``qkv_rows``, the split the bf16 kernel's two launches
    take."""
    q, k, v = qkv_rows(x, xo, mrow, vecs, wq, wk, wv, n_head=n_head, mode=mode)
    return block_tail(q, k, v, x, xo, mrow, coefs, vecs, wp, wf1, wf2, fc1b,
                      n_head=n_head, w_overlap=w_overlap, mode=mode)


# ---------------------------------------------------------------- packing

def pack_block_params(sd, n_embd: int, cross: bool, dtype):
    """Pack one TransformerBlock's torch-layout parameters (reference names
    relative to the block: ``lnq.weight``, ``attn.query_conv.conv.weight``,
    ``mlp.0.weight``, ...) into the kernel inputs
    ``(vecs, wq, wk, wv, wp, wf1, wf2, fc1b)``.

    The post-conv LN affines and the ln2 affine are folded into the adjacent
    dense weights: ``LN_aff(y) @ W.T + b == LN_plain(y) @ (W * g).T + (W @ b_ln + b)``.
    Dense weights keep torch's ``(out, in)`` layout, the one the kernel reads
    for both dtypes, and come out in ``dtype``; vectors in f32. Every step is
    differentiable: called with gradients enabled, the result carries the
    graph back to the parameters (the training path); the eval path calls it
    under ``torch.no_grad()`` and caches the result."""
    c = n_embd

    def vec(name):
        return sd[name].float().reshape(c)

    def dense_w(name):          # torch (out, in[, 1]) -> (out, in) f32
        w = sd[name].float()
        return w[..., 0] if w.ndim == 3 else w

    if cross:
        lnq = (vec("lnq.weight"), vec("lnq.bias"))
        lnk = (vec("lnk.weight"), vec("lnk.bias"))
        lnv = (vec("lnv.weight"), vec("lnv.bias"))
    else:
        lnq = lnk = lnv = (vec("ln1.weight"), vec("ln1.bias"))

    def conv_taps(name):        # (C, 1, 3) depthwise -> (3, C)
        return sd[f"attn.{name}.conv.weight"].float().reshape(c, 3).t()

    def fold(norm, lin_w, lin_b):
        wf = dense_w(lin_w)
        g, bl = vec(f"{norm}.weight"), vec(f"{norm}.bias")
        return ((wf * g[None, :]).to(dtype).contiguous(),
                wf @ bl + sd[lin_b].float().reshape(-1))

    wq, q_bias = fold("attn.query_norm", "attn.query.weight", "attn.query.bias")
    wk, k_bias = fold("attn.key_norm", "attn.key.weight", "attn.key.bias")
    wv, v_bias = fold("attn.value_norm", "attn.value.weight", "attn.value.bias")
    wf1, fc1b = fold("ln2", "mlp.0.weight", "mlp.0.bias")

    rows = [*lnq, *lnk, *lnv]
    rows += list(conv_taps("query_conv"))
    rows += list(conv_taps("key_conv"))
    rows += list(conv_taps("value_conv"))
    rows += [q_bias, k_bias, v_bias, vec("attn.proj.bias"),
             vec("drop_path_attn.scale"), vec("mlp.3.bias"),
             vec("drop_path_mlp.scale")]
    vecs = torch.stack(rows).contiguous()
    wp = dense_w("attn.proj.weight").to(dtype).contiguous()
    wf2 = dense_w("mlp.3.weight").to(dtype).contiguous()
    return vecs, wq, wk, wv, wp, wf1, wf2, fc1b.reshape(1, 4 * c).contiguous()


# ---------------------------------------------------------------- wrapper

def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype} on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _validate(x, xo, mask, vecs, wq, wk, wv, wp, wf1, wf2, fc1b, mode):
    b, t, c = x.shape
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused block takes float32 or bfloat16, got {dt}")
    _check("x", x, (b, t, c), dt, dev)
    if mode != "self":
        if xo is None:
            raise ValueError(f"mode {mode} needs the other stream xo")
        _check("xo", xo, (b, t, c), dt, dev)
    _check("mask", mask, (b, t), torch.bool, dev)
    _check("vecs", vecs, (NUM_VEC_ROWS, c), torch.float32, dev)
    for name, wt in (("wq", wq), ("wk", wk), ("wv", wv), ("wp", wp)):
        _check(name, wt, (c, c), dt, dev)
    _check("wf1", wf1, (4 * c, c), dt, dev)
    _check("wf2", wf2, (c, 4 * c), dt, dev)
    _check("fc1b", fc1b, (1, 4 * c), torch.float32, dev)


def fused_transformer_block(x, xo, mask, vecs, wq, wk, wv, wp, wf1, wf2, fc1b,
                            *, n_head: int, w_overlap: int, mode: str) -> torch.Tensor:
    """One eval-time block (not differentiable). ``x``/``xo``: (B, T, C) compute dtype (``xo`` is
    None in self mode; in ds_self they are the even/odd rows of the stream);
    ``mask``: (B, T) bool of the output rows. Returns (B, T, C)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _validate(x, xo, mask, vecs, wq, wk, wv, wp, wf1, wf2, fc1b, mode)
    if not use_kernel(x):
        mrow = mask.float()[..., None]
        coefs = torch.ones((x.shape[0], 2), dtype=torch.float32, device=x.device)
        return block_math(x, x if xo is None else xo, mrow, coefs, vecs, wq, wk,
                          wv, wp, wf1, wf2, fc1b, n_head=n_head,
                          w_overlap=w_overlap, mode=mode)
    return _launch(x, xo, mask, vecs, wq, wk, wv, wp, wf1, wf2, fc1b,
                   n_head=n_head, w_overlap=w_overlap, mode=mode)


def kernel_shape_ok(c: int, n_head: int, w_overlap: int) -> bool:
    """Whether the kernel takes a block of ``c`` channels, ``n_head`` heads
    and half window ``w_overlap`` (<= 0: dense attention): C a multiple of 64
    from 64 to 2048 and C / n_head a multiple of 8 from 8 to 512, at any half
    window and any length. The same rule as
    ``csrc/fused_block.cuh::shape_ok``; ``w_overlap`` names the block and
    limits nothing."""
    if not (64 <= c <= MAX_CHANNELS and c % 64 == 0 and n_head > 0 and c % n_head == 0):
        return False
    d = c // n_head
    return d % HEAD_WIDTH_STEP == 0 and HEAD_WIDTH_STEP <= d <= MAX_HEAD_WIDTH


def wgmma_shape_ok(c: int, n_head: int) -> bool:
    """Whether a shape of ``kernel_shape_ok`` takes the bf16 two-launch design
    and the f32 attention at its own head width (C up to 1024, head width 32
    / 64 / 96 / 128; ``csrc/fused_block.cuh::wgmma_shape_ok``); every other
    one runs the scratch routes, on the tensor cores too."""
    return (kernel_shape_ok(c, n_head, 0) and c <= WGMMA_CHANNELS
            and c // n_head in WGMMA_HEAD_WIDTHS)


def route_of(c: int, n_head: int, dtype) -> str:
    """The ``ROUTE_NAMES`` entry a launch at a shape of ``kernel_shape_ok``
    takes in ``dtype``."""
    return ROUTE_NAMES[(0 if dtype == torch.float32 else 1)
                       + (0 if wgmma_shape_ok(c, n_head) else 2)]


def _launch(x, xo, mask, vecs, wq, wk, wv, wp, wf1, wf2, fc1b, *, n_head,
            w_overlap, mode, coefs=None):
    """Launch the kernel: K1 with ``coefs`` None (the kernel reads 1), K6 with
    the (B, 2) f32 droppath coefficients. bf16 runs two ``wgmma`` launches
    through a (B, T, 3C) q|k|v scratch, and between them a third, the
    attention on the tensor cores, for dense attention and for half windows
    above 16 (bands up to 16 attend inside the second launch). f32 runs
    eight launches with 3xTF32 products on ``wgmma`` (``split_matmul`` is
    their plain version) through a scratch of the split weights and
    operands: the streams' rows, the q|k|v GEMM, the attention (every
    window; head widths other than 32 / 64 / 96 / 128 padded with zeros to
    the next or, past 128, in 128-column blocks, or, dense, as two GEMMs
    through the scores), proj, LN, fc1, fc2. A
    bf16 shape of ``kernel_shape_ok`` outside ``wgmma_shape_ok`` runs the
    same eight launches in bf16 (``csrc/fused_block_bf16.cu``: bf16
    products on ``wgmma`` with block_math's rounding points, the tensor-core
    attention launch) through a scratch of 7 B T C values. A shape outside
    ``kernel_shape_ok`` raises ValueError: there is no plain fallback."""
    global LAUNCHES, TRAIN_LAUNCHES
    from .build import load

    b, t, c = x.shape
    if not kernel_shape_ok(c, n_head, w_overlap):
        raise ValueError(
            f"fused block kernel takes C a multiple of 64 up to {MAX_CHANNELS} and a head "
            f"width that is a multiple of {HEAD_WIDTH_STEP} up to {MAX_HEAD_WIDTH}; got "
            f"C={c}, {n_head} heads")
    w = max(w_overlap, 0)
    out = torch.empty_like(x)
    if b == 0 or t == 0:
        return out
    lib = load()
    dcode = 0 if x.dtype == torch.float32 else 1
    # bf16: the (B, T, 3C) q|k|v rows between the kernel's launches, 7 B T C
    # past wgmma_shape_ok; f32: the split weights and the operands its
    # launches pass on (f32_scratch_elems: ~0.97 GB at C = 2048, B T = 4608),
    # dense past head width 128 also the scores, 2 B H T Tp floats
    n = lib.avdd_fused_block_scratch(b, t, c, n_head, w, dcode)
    if n < 0:
        raise ValueError(f"fused block kernel refused C={c}, {n_head} heads, w={w}, T={t}")
    kv = torch.empty(n, dtype=x.dtype, device=x.device)
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())  # noqa: E731
    route = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.avdd_fused_block(
            ptr(x), ptr(x if xo is None else xo), ptr(mask), ptr(vecs), ptr(wq),
            ptr(wk), ptr(wv), ptr(wp), ptr(wf1), ptr(wf2), ptr(fc1b), ptr(out),
            ptr(kv),
            ctypes.c_void_p(0 if coefs is None else coefs.data_ptr()),
            b, t, c, n_head, w, MODES[mode], dcode,
            ctypes.c_void_p(stream), ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"fused block kernel launch failed: CUDA error {err}")
    if coefs is None:
        LAUNCHES += 1
    else:
        TRAIN_LAUNCHES += 1
    ROUTES[ROUTE_NAMES[route.value]] += 1
    return out


# ------------------------------------------------------------ training (K6)

class _FusedBlockTrain(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU). Backward: autograd
    through ``block_math`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, xo, mask, coefs, n_head, w_overlap, mode, *packed):
        ctx.save_for_backward(x, xo, mask, coefs, *packed)
        ctx.static = (n_head, w_overlap, mode)
        if use_kernel(x):
            return _launch(x, xo, mask, *packed, n_head=n_head, w_overlap=w_overlap,
                           mode=mode, coefs=coefs)
        return block_math(x, x if xo is None else xo, mask.float()[..., None], coefs,
                          *packed, n_head=n_head, w_overlap=w_overlap, mode=mode)

    @staticmethod
    def backward(ctx, g):
        x, xo, mask, coefs, *packed = ctx.saved_tensors
        n_head, w_overlap, mode = ctx.static
        # differentiable inputs in the order of forward's arguments: x, xo
        # (positions 0, 1) and the packed tensors (positions 7..)
        slots = [0, 1] + list(range(7, 7 + len(packed)))
        ins = [x, xo, *packed]
        want = [i for i, (slot, a) in enumerate(zip(slots, ins))
                if a is not None and ctx.needs_input_grad[slot]]
        with torch.enable_grad():
            live = [a if a is None else a.detach().requires_grad_(i in want)
                    for i, a in enumerate(ins)]
            lx, lxo, *lpacked = live
            y = block_math(lx, lx if lxo is None else lxo, mask.float()[..., None],
                           coefs, *lpacked, n_head=n_head, w_overlap=w_overlap, mode=mode)
        grads = torch.autograd.grad(y, [live[i] for i in want], g, allow_unused=True)
        out = [None] * (7 + len(packed))
        for i, gr in zip(want, grads):
            out[slots[i]] = gr
        return tuple(out)


def fused_transformer_block_train(x, xo, mask, coefs, vecs, wq, wk, wv, wp, wf1, wf2,
                                  fc1b, *, n_head: int, w_overlap: int,
                                  mode: str) -> torch.Tensor:
    """One training-time block, differentiable in ``x``, ``xo`` and the 8
    packed tensors. ``coefs`` (B, 2) f32: the droppath coefficients of the
    attention and the MLP branch, 1 when nothing is dropped, else 0 or
    1 / keep per sample. Arguments otherwise as ``fused_transformer_block``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _validate(x, xo, mask, vecs, wq, wk, wv, wp, wf1, wf2, fc1b, mode)
    _check("coefs", coefs, (x.shape[0], 2), torch.float32, x.device)
    return _FusedBlockTrain.apply(x, xo, mask, coefs, n_head, w_overlap, mode,
                                  vecs, wq, wk, wv, wp, wf1, wf2, fc1b)
