"""Localizer building blocks, (B, T, C) layout (JAX ``models/blocks.py``).

Parameters carry the original torch repo's names so a reference state dict
loads as it is. ``TransformerBlock`` dispatches as the JAX block does
(``blocks.py:227-278``):

- no gradient wanted and nothing to drop (eval under ``torch.no_grad()``):
  the fused eval kernel K1,
  ``ops/kernels/fused_block.py::fused_transformer_block``;
- gradient wanted, or training with stochastic depth, and no attention /
  projection dropout (every production config): the fused training kernel
  K6, ``fused_transformer_block_train``, with stochastic depth folded into
  per-sample coefficients;
- training with ``dropout > 0``: the unfused block (``ConvAttention`` with
  banded attention K7 or dense attention, the MLP, ``AffineDropPath``);
- a block with a relative position bias or time weighting
  (``use_rel_pe`` / ``use_time_weight``), in eval and in training, banded or
  dense: the unfused block, its banded attention the plain
  ``band_attention_xla`` (the JAX ``fused_mode`` and ``fused_train_eligible``
  both exclude these blocks, and the JAX package has no kernel for them);
- a block of stride other than 1 or 2: the unfused block, as the JAX
  dispatch sends it (``ds_stride in (1, 2)``). Its depthwise convs have
  kernel ``stride + 1``, and ``MaskedConv1D`` refuses an even kernel, as the
  JAX package's does: a stride of 3 raises where the JAX block raises.

On the CPU each kernel runs its plain version. Randomness (stochastic depth,
dropout) comes from an explicit ``torch.Generator``: the numbers are drawn on
the generator's own device and moved to the tensors'. A generator on the
tensors' device (what ``train/state.py::init_model`` returns) costs no copy;
a CPU generator driving a model on the card gives the card the draws a CPU
run gets from the same seed, so the two can be compared step for step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import band_attention, full_attention
from ..ops.conv import Dense, MaskedConv1D, MaskedConvTranspose1D, dense, max_pool_skip
from ..ops.kernels import fused_block as _fused
from ..ops.norm import ChannelLayerNorm, instance_norm_time


class GlobalDraws:
    """A generator's draws for one process's rows of a data-parallel batch.
    Every process holds the same generator, draws each number for the global
    batch (``world`` times its own rows, which the strided loader deals out
    in turn: row ``j`` of rank ``r`` is row ``j * world + r`` of the global
    batch) and keeps its own rows. The draws then depend on the global batch
    alone, as the JAX package's one key over the mesh does: one process at
    the global batch draws the same numbers, and the generator stays equal on
    every process. Stands in for the generator wherever the model takes
    one."""

    def __init__(self, generator: torch.Generator, rank: int, world: int):
        self.generator, self.rank, self.world = generator, rank, world

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)

    def rand(self, shape) -> torch.Tensor:
        full = torch.rand((shape[0] * self.world,) + tuple(shape[1:]),
                          generator=self.generator, device=self.generator.device)
        return full[self.rank::self.world]


def _uniform(shape, device, generator) -> torch.Tensor:
    """U[0, 1) f32 numbers on ``device``, drawn where the generator lives;
    ``generator`` a ``torch.Generator`` or ``GlobalDraws``."""
    if isinstance(generator, GlobalDraws):
        return generator.rand(shape).to(device)
    src = device if generator is None else generator.device
    return torch.rand(shape, generator=generator, device=src).to(device)


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout from an explicit generator (flax ``nn.Dropout``)."""
    if not train or p == 0.0:
        return x
    keep = _uniform(x.shape, x.device, generator) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def drop_path_coefs(shape, drop_prob: float, dtype, device,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic-depth coefficients ``floor(keep + u) / keep`` in ``dtype``:
    0 or 1 / keep per entry (JAX ``drop_path`` and the fused train draw)."""
    keep = 1.0 - drop_prob
    u = _uniform(shape, device, generator).to(dtype)
    return torch.floor(keep + u) / keep


class AffineDropPath(nn.Module):
    """LayerScale (init 1e-4) + per-sample stochastic depth in training."""

    def __init__(self, num_channels: int, drop_prob: float = 0.0,
                 init_scale: float = 1e-4):
        super().__init__()
        self.drop_prob = drop_prob
        self.scale = nn.Parameter(torch.full((num_channels,), init_scale))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = x * self.scale.to(x.dtype)
        if train and self.drop_prob > 0.0:
            shape = (x.shape[0],) + (1,) * (x.ndim - 1)
            y = y * drop_path_coefs(shape, self.drop_prob, x.dtype, x.device, generator)
        return y


class Scale(nn.Module):
    """Learnable scalar (the regression head's per-level scale)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


REL_PE_STD = 0.87962566103423978    # std of N(0, 1) truncated to +-2 (flax's truncated_normal)


def init_rel_pe(p: torch.Tensor, n_embd: int, generator=None) -> torch.Tensor:
    """flax ``truncated_normal(stddev=sqrt(2 / C))``: N(0, 1) truncated to
    +-2, scaled to that std."""
    s = (2.0 / n_embd) ** 0.5 / REL_PE_STD
    return nn.init.trunc_normal_(p, std=s, a=-2.0 * s, b=2.0 * s, generator=generator)


class ConvAttention(nn.Module):
    """The reference attention: depthwise k3 q/k/v convs (the query conv
    uses the kv stride, a reference quirk), their channel LNs, 1x1-conv q/k/v
    projections, banded (``window_size > 1``) or dense attention, the output
    projection and its dropout. The fused kernels read these parameters
    through ``pack_block_params``; ``forward`` is the unfused path.

    A banded block can hold ``rel_pe``, a bias added to the scores of each
    head and offset (truncated normal, std sqrt(2 / C)), and
    ``time_weighting``, a factor on each head's and offset's attention
    weight (ones), in the reference's shapes (1, 1, H, W) and (1, H, W);
    the JAX package holds both as (H, W)."""

    def __init__(self, n_embd: int, n_head: int, window_size: int = -1,
                 stride: int = 1, proj_pdrop: float = 0.0, use_rel_pe: bool = False,
                 use_time_weight: bool = False):
        super().__init__()
        self.n_head, self.window_size, self.proj_pdrop = n_head, window_size, proj_pdrop
        k = stride + 1 if stride > 1 else 3
        for name in ("query", "key", "value"):
            setattr(self, f"{name}_conv",
                    MaskedConv1D(n_embd, n_embd, k, stride=stride, groups=n_embd,
                                 bias=False))
            setattr(self, f"{name}_norm", ChannelLayerNorm(n_embd))
        for name in ("query", "key", "value", "proj"):
            setattr(self, name, nn.Conv1d(n_embd, n_embd, 1))
        self.rel_pe = self.time_weighting = None
        if window_size > 1 and use_rel_pe:
            self.rel_pe = nn.Parameter(init_rel_pe(
                torch.empty(1, 1, n_head, window_size), n_embd))
        if window_size > 1 and use_time_weight:
            self.time_weighting = nn.Parameter(torch.ones(1, n_head, window_size))

    def forward(self, x_q, mask_q, x_k, mask_k, x_v, mask_v, train: bool = False,
                generator: Optional[torch.Generator] = None):
        q, qx_mask = self.query_conv(x_q, mask_q)
        k, kv_mask = self.key_conv(x_k, mask_k)
        v, _ = self.value_conv(x_v, mask_v)
        q = dense(self.query_norm(q), self.query.weight, self.query.bias)
        k = dense(self.key_norm(k), self.key.weight, self.key.bias)
        v = dense(self.value_norm(v), self.value.weight, self.value.bias)
        b, _, c = q.shape
        d_head = c // self.n_head

        def to_heads(t):        # (B, T, C) -> (B, H, T, D), a view
            return t.reshape(b, t.shape[1], self.n_head, d_head).transpose(1, 2)

        q, k, v = to_heads(q), to_heads(k), to_heads(v)
        q = q * (1.0 / math.sqrt(d_head))
        if self.window_size > 1:
            hw = (self.n_head, self.window_size)
            rel_pe = None if self.rel_pe is None else self.rel_pe.reshape(hw)
            tw = None if self.time_weighting is None else self.time_weighting.reshape(hw)
            out = band_attention(q, k, v, kv_mask, self.window_size // 2, rel_pe, tw)
        else:
            out = full_attention(q, k, v, kv_mask)
        out = out.transpose(1, 2).reshape(b, out.shape[2], c)
        out = dense(out, self.proj.weight, self.proj.bias)
        out = dropout(out, self.proj_pdrop, train, generator)
        return out * qx_mask.to(out.dtype)[..., None], qx_mask


class TransformerBlock(nn.Module):
    """Pre-LN block with optional 2x downsampling (self) or separate q/k/v
    LNs (cross). Modes of the fused op: ``self``, ``ds_self`` (stride 2),
    ``qv_k`` (k from the other stream) and ``kv`` (k and v from it)."""

    def __init__(self, n_embd: int, n_head: int, ds_stride: int = 1,
                 window_size: int = -1, cross: bool = False,
                 proj_pdrop: float = 0.0, path_pdrop: float = 0.0,
                 use_rel_pe: bool = False, use_time_weight: bool = False):
        super().__init__()
        if ds_stride < 1 or (cross and ds_stride != 1):
            raise NotImplementedError(f"ds_stride {ds_stride} (cross={cross})")
        self.n_embd, self.n_head = n_embd, n_head
        self.ds_stride, self.window_size, self.cross = ds_stride, window_size, cross
        self.proj_pdrop, self.path_pdrop = proj_pdrop, path_pdrop
        self.rel_or_time = use_rel_pe or use_time_weight
        if cross:
            self.lnq = ChannelLayerNorm(n_embd)
            self.lnk = ChannelLayerNorm(n_embd)
            self.lnv = ChannelLayerNorm(n_embd)
        else:
            self.ln1 = ChannelLayerNorm(n_embd)
        self.attn = ConvAttention(n_embd, n_head, window_size, ds_stride, proj_pdrop,
                                  use_rel_pe, use_time_weight)
        self.drop_path_attn = AffineDropPath(n_embd, path_pdrop)
        self.ln2 = ChannelLayerNorm(n_embd)
        # the reference's MLP: its two 1x1 convs are mlp.0 and mlp.3
        self.mlp = nn.Sequential(nn.Conv1d(n_embd, 4 * n_embd, 1), nn.GELU(),
                                 nn.Identity(), nn.Conv1d(4 * n_embd, n_embd, 1))
        self.drop_path_mlp = AffineDropPath(n_embd, path_pdrop)
        self._packed = {}   # dtype -> (parameter signature, kernel inputs)

    def packed(self, dtype):
        """The fused eval op's inputs in ``dtype``, packed once without a
        graph and reused while the parameters stay as they are. The signature
        holds each parameter's storage and version counter, so an in-place
        update (``load_state_dict``, an optimizer step) or a move to another
        device or dtype repacks. The training path does not come here: its
        packed tensors carry the graph and are never cached."""
        params = dict(self.named_parameters())
        sig = tuple((p.device, p.data_ptr(), p._version) for p in params.values())
        hit = self._packed.get(dtype)
        if hit is None or hit[0] != sig:
            with torch.no_grad():
                packed = _fused.pack_block_params(params, self.n_embd, self.cross, dtype)
            hit = (sig, tuple(a.detach() for a in packed))
            self._packed[dtype] = hit
        return hit[1]

    def _wants_grad(self, x, xo) -> bool:
        """Autograd would record this block: grad mode is on and an input or
        a parameter requires a gradient. Otherwise the eval kernel K1 (no
        droppath) computes the same as the differentiable K6 path, as the
        JAX block's ``train=False`` dispatch does."""
        if not torch.is_grad_enabled():
            return False
        return x.requires_grad or (xo is not None and xo.requires_grad) or any(
            p.requires_grad for p in self.parameters())

    def uses_unfused(self, train: bool) -> bool:
        """The fused kernels cover neither dropout inside the block in
        training nor a relative position bias or time weighting at all, nor
        a stride other than 1 or 2, nor a window other than a band (> 1) or
        -1 (JAX ``fused_train_eligible`` and ``fused_mode``); set either flag
        and every block of the model is unfused, dense ones too, as in JAX.
        A window of 0, 1 or below -1 runs unfused with dense attention
        (``ConvAttention``'s ``full_attention``), as the JAX block does."""
        return (self.rel_or_time or self.ds_stride not in (1, 2)
                or not (self.window_size > 1 or self.window_size == -1)
                or (train and self.proj_pdrop > 0.0))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                xo: Optional[torch.Tensor] = None, mode: Optional[str] = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """``mode`` is ``qv_k`` or ``kv`` for a cross block (``xo`` = the
        other stream, sharing ``mask``), implied otherwise. ``train`` turns
        stochastic depth and dropout on."""
        if self.cross:
            if mode not in ("qv_k", "kv") or xo is None:
                raise ValueError("cross block needs mode qv_k|kv and xo")
        else:
            mode = "ds_self" if self.ds_stride == 2 else "self"
        if self.uses_unfused(train):
            return self._forward_unfused(x, mask, xo, mode, train, generator)
        if mode == "ds_self":
            if x.shape[1] % 2:
                raise NotImplementedError("stride-2 block needs an even length")
            x, xo, mask = x[:, 0::2], x[:, 1::2], mask[:, 0::2]
        # the kernel reads dense (B, T, C) rows
        x, mask = x.contiguous(), mask.contiguous()
        xo = None if xo is None else xo.contiguous()
        kw = dict(n_head=self.n_head, w_overlap=self.window_size // 2, mode=mode)
        drops = train and self.path_pdrop > 0.0
        if not drops and not self._wants_grad(x, xo):
            y = _fused.fused_transformer_block(x, xo, mask, *self.packed(x.dtype), **kw)
            return y, mask
        b = x.shape[0]
        if drops:
            coefs = drop_path_coefs((b, 2), self.path_pdrop, x.dtype, x.device,
                                    generator).float()
        else:
            coefs = torch.ones((b, 2), dtype=torch.float32, device=x.device)
        packed = _fused.pack_block_params(dict(self.named_parameters()), self.n_embd,
                                          self.cross, x.dtype)
        y = _fused.fused_transformer_block_train(x, xo, mask, coefs, *packed, **kw)
        return y, mask

    def _forward_unfused(self, x, mask, xo, mode, train, generator):
        if self.cross:
            q_in = self.lnq(x)
            k_in = self.lnk(xo)
            v_in = self.lnv(x if mode == "qv_k" else xo)
        else:
            q_in = k_in = v_in = self.ln1(x)
        out, out_mask = self.attn(q_in, mask, k_in, mask, v_in, mask, train, generator)
        mf = out_mask.to(out.dtype)[..., None]
        skip = max_pool_skip(x, self.ds_stride) if self.ds_stride > 1 else x
        out = skip * mf + self.drop_path_attn(out, train, generator)
        h = dense(self.ln2(out), self.mlp[0].weight, self.mlp[0].bias)
        h = dropout(F.gelu(h), self.proj_pdrop, train, generator)
        h = dense(h, self.mlp[3].weight, self.mlp[3].bias)
        h = dropout(h, self.proj_pdrop, train, generator)
        out = out + self.drop_path_mlp(h * mf, train, generator)
        return out, out_mask


class ConvBlock(nn.Module):
    """ResNet-style masked block of the pure-conv backbone (JAX
    ``models/backbones.py::ConvBlock``): ``conv1`` (k, stride ``ds_stride``,
    to 2C), ReLU, ``conv2`` (k, back to C), plus the input, or with a stride
    its 1x1 stride-s ``downsample``, then ReLU."""

    def __init__(self, n_embd: int, kernel_size: int = 3, ds_stride: int = 1,
                 expansion_factor: int = 2):
        super().__init__()
        width = n_embd * expansion_factor
        self.conv1 = MaskedConv1D(n_embd, width, kernel_size, stride=ds_stride)
        self.conv2 = MaskedConv1D(width, n_embd, kernel_size)
        self.downsample = MaskedConv1D(n_embd, n_embd, 1, stride=ds_stride) \
            if ds_stride > 1 else None

    def forward(self, x, mask):
        out, out_mask = self.conv1(x, mask)
        out, out_mask = self.conv2(torch.relu(out), out_mask)
        identity = x if self.downsample is None else self.downsample(x, mask)[0]
        return torch.relu(out + identity), out_mask


class DownBlock(nn.Module):
    """MaskedConv(k3, stride 2 or 1) + InstanceNorm + LeakyReLU(0.2)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 2):
        super().__init__()
        self.conv_block = MaskedConv1D(in_ch, out_ch, 3, stride=stride)

    def forward(self, x, mask):
        x, mask = self.conv_block(x, mask)
        return F.leaky_relu(instance_norm_time(x), 0.2), mask


class UpBlock(nn.Module):
    """MaskedConvTranspose(k3, stride 2, output_padding 1) + InstanceNorm +
    LeakyReLU(0.2). The JAX package builds every stage of the expansion,
    the last one too, with LeakyReLU (``last=False``), not the Tanh its
    docstring names; so does this port."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv_transpose = MaskedConvTranspose1D(in_ch, out_ch, 3, stride=2,
                                                    output_padding=1)

    def forward(self, x, mask):
        x, mask = self.conv_transpose(x, mask)
        return F.leaky_relu(instance_norm_time(x), 0.2), mask


class DeepInterpolator(nn.Module):
    """Feature-recovery module: the contraction (768 -> 24 rows, in -> 256 ->
    512 -> 1024 -> 2048 -> hidden channels) and the video-level classifier,
    with Dropout(0.5) before its last layer in training; with
    ``with_reconstruction`` (the ``av_recovery`` variant) also the expansion
    (24 -> 768 rows, hidden -> 2048 -> 1024 -> 512 -> 256 -> in channels),
    whose output is the reconstruction. Returns (inputs without gradient,
    reconstruction or None, video logits). Without it the module holds no
    expansion, so the production model keeps its parameter set."""

    def __init__(self, in_ch: int, hidden: int = 256, num_classes: int = 1,
                 with_reconstruction: bool = False):
        super().__init__()
        chans = [in_ch, 256, 512, 1024, 2048, hidden]
        self.contraction = nn.Module()
        for i in range(5):
            setattr(self.contraction, f"down_{i + 1}", DownBlock(chans[i], chans[i + 1]))
        self.conv0 = nn.Sequential(nn.Conv1d(hidden, hidden, 1, bias=False))
        self.conv1 = Dense(2 * hidden, hidden, bias=False)
        self.bn1 = ChannelLayerNorm(hidden)
        self.conv2 = Dense(hidden, num_classes)
        self.with_reconstruction = with_reconstruction
        if with_reconstruction:
            up = [hidden, 2048, 1024, 512, 256, in_ch]
            self.expansion = nn.Module()
            for i in range(5):
                setattr(self.expansion, f"up_{i + 1}", UpBlock(up[i], up[i + 1]))

    def forward(self, x, mask, train: bool = False,
                generator: Optional[torch.Generator] = None):
        feat, m = x, mask
        for i in range(5):
            feat, m = getattr(self.contraction, f"down_{i + 1}")(feat, m)
        h = dense(feat, self.conv0[0].weight)
        h = F.leaky_relu(instance_norm_time(h), 0.2)
        h = torch.cat([h.amax(1), h.mean(1)], -1)
        h = torch.relu(self.bn1(self.conv1(h)))
        h = dropout(h, 0.5, train, generator)
        cls_scores = self.conv2(h)
        reco = None
        if self.with_reconstruction:
            for i in range(5):
                feat, m = getattr(self.expansion, f"up_{i + 1}")(feat, m)
            reco = feat
        return x.detach(), reco, cls_scores


class SegmentAndCls(nn.Module):
    """Frame-level segmentation and video head of the THE variant (JAX
    ``models/blocks.py:406-435``): five stride-1 DownBlocks in -> 1024 ->
    512 -> 256 -> 128 -> 64 at full length, a 1x1 conv + InstanceNorm +
    LeakyReLU, per-frame logits (``seg_linear``) and a video logit from the
    max and mean of the seg map over time (``cls_linear1``). Returns
    (inputs without gradient, frame logits (B, T), video logits)."""

    def __init__(self, in_ch: int, hidden: int = 1024, num_classes: int = 1):
        super().__init__()
        chans = [in_ch] + [hidden // 2 ** i for i in range(5)]
        self.contraction = nn.Module()
        for i in range(5):
            setattr(self.contraction, f"down_{i + 1}",
                    DownBlock(chans[i], chans[i + 1], stride=1))
        last = chans[-1]
        self.conv0 = nn.Sequential(nn.Conv1d(last, last, 1, bias=False))
        self.seg_linear = Dense(last, num_classes)
        self.cls_linear1 = Dense(2 * num_classes, num_classes)

    def forward(self, x, mask, train: bool = False,
                generator: Optional[torch.Generator] = None):
        feat, m = x, mask
        for i in range(5):
            feat, m = getattr(self.contraction, f"down_{i + 1}")(feat, m)
        h = dense(feat, self.conv0[0].weight)
        h = F.leaky_relu(instance_norm_time(h), 0.2)
        seg_map = self.seg_linear(h)                              # (B, T, classes)
        cls_scores = self.cls_linear1(torch.cat([seg_map.amax(1), seg_map.mean(1)], -1))
        return x.detach(), seg_map[..., 0], cls_scores
