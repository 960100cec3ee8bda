"""Localizer building blocks, (B, T, C) layout (JAX ``models/blocks.py``).

Parameters carry the original torch repo's names so a reference state dict
loads as it is. ``TransformerBlock`` is eval-only and has one path: every
block goes through ``ops/kernels/fused_block.py::fused_transformer_block``
(the CUDA kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Dense, MaskedConv1D, dense
from ..ops.kernels import fused_block as _fused
from ..ops.norm import ChannelLayerNorm, instance_norm_time


class AffineDropPath(nn.Module):
    """LayerScale (init 1e-4). Eval only: stochastic depth is the identity."""

    def __init__(self, num_channels: int, init_scale: float = 1e-4):
        super().__init__()
        self.scale = nn.Parameter(torch.full((num_channels,), init_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class Scale(nn.Module):
    """Learnable scalar (the regression head's per-level scale)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class ConvAttention(nn.Module):
    """Parameter holder of the reference attention: depthwise k3 q/k/v convs,
    their channel LNs, and the 1x1-conv q/k/v/proj layers."""

    def __init__(self, n_embd: int, stride: int = 1):
        super().__init__()
        k = stride + 1 if stride > 1 else 3
        for name in ("query", "key", "value"):
            setattr(self, f"{name}_conv",
                    MaskedConv1D(n_embd, n_embd, k, stride=stride, groups=n_embd,
                                 bias=False))
            setattr(self, f"{name}_norm", ChannelLayerNorm(n_embd))
        for name in ("query", "key", "value", "proj"):
            setattr(self, name, nn.Conv1d(n_embd, n_embd, 1))


class TransformerBlock(nn.Module):
    """Pre-LN block with optional 2x downsampling (self) or separate q/k/v
    LNs (cross). Modes of the fused op: ``self``, ``ds_self`` (stride 2),
    ``qv_k`` (k from the other stream) and ``kv`` (k and v from it)."""

    def __init__(self, n_embd: int, n_head: int, ds_stride: int = 1,
                 window_size: int = -1, cross: bool = False):
        super().__init__()
        if not (window_size > 1 or window_size == -1):
            raise NotImplementedError(
                f"window_size {window_size}: only banded (>1) and dense (-1) "
                f"attention are ported")
        if ds_stride not in (1, 2) or (cross and ds_stride != 1):
            raise NotImplementedError(f"ds_stride {ds_stride} (cross={cross})")
        self.n_embd, self.n_head = n_embd, n_head
        self.ds_stride, self.window_size, self.cross = ds_stride, window_size, cross
        if cross:
            self.lnq = ChannelLayerNorm(n_embd)
            self.lnk = ChannelLayerNorm(n_embd)
            self.lnv = ChannelLayerNorm(n_embd)
        else:
            self.ln1 = ChannelLayerNorm(n_embd)
        self.attn = ConvAttention(n_embd, ds_stride)
        self.drop_path_attn = AffineDropPath(n_embd)
        self.ln2 = ChannelLayerNorm(n_embd)
        # the reference's MLP: its two 1x1 convs are mlp.0 and mlp.3
        self.mlp = nn.Sequential(nn.Conv1d(n_embd, 4 * n_embd, 1), nn.GELU(),
                                 nn.Identity(), nn.Conv1d(4 * n_embd, n_embd, 1))
        self.drop_path_mlp = AffineDropPath(n_embd)
        self._packed = {}   # dtype -> (parameter signature, kernel inputs)

    def packed(self, dtype):
        """The fused op's inputs in ``dtype``, packed once and reused while
        the parameters stay as they are. The signature holds each parameter's
        storage and version counter, so an in-place update (``load_state_dict``,
        an optimizer step) or a move to another device or dtype repacks."""
        params = dict(self.named_parameters())
        sig = tuple((p.device, p.data_ptr(), p._version) for p in params.values())
        hit = self._packed.get(dtype)
        if hit is None or hit[0] != sig:
            hit = (sig, _fused.pack_block_params(params, self.n_embd, self.cross, dtype))
            self._packed[dtype] = hit
        return hit[1]

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                xo: Optional[torch.Tensor] = None, mode: Optional[str] = None):
        """``mode`` is ``qv_k`` or ``kv`` for a cross block (``xo`` = the
        other stream, sharing ``mask``), implied otherwise."""
        if self.cross:
            if mode not in ("qv_k", "kv") or xo is None:
                raise ValueError("cross block needs mode qv_k|kv and xo")
        else:
            mode = "ds_self" if self.ds_stride == 2 else "self"
        if mode == "ds_self":
            if x.shape[1] % 2:
                raise NotImplementedError("stride-2 block needs an even length")
            x, xo, mask = x[:, 0::2], x[:, 1::2], mask[:, 0::2]
        # the kernel reads dense (B, T, C) rows
        x, mask = x.contiguous(), mask.contiguous()
        xo = None if xo is None else xo.contiguous()
        y = _fused.fused_transformer_block(
            x, xo, mask, *self.packed(x.dtype), n_head=self.n_head,
            w_overlap=self.window_size // 2, mode=mode)
        return y, mask


class DownBlock(nn.Module):
    """MaskedConv(k3, stride 2) + InstanceNorm + LeakyReLU(0.2)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 2):
        super().__init__()
        self.conv_block = MaskedConv1D(in_ch, out_ch, 3, stride=stride)

    def forward(self, x, mask):
        x, mask = self.conv_block(x, mask)
        return F.leaky_relu(instance_norm_time(x), 0.2), mask


class DeepInterpolator(nn.Module):
    """Feature-recovery module without reconstruction: the contraction
    (768 -> 24 rows, in -> 256 -> 512 -> 1024 -> 2048 -> hidden channels) and
    the video-level classifier. Returns (inputs, None, video logits)."""

    def __init__(self, in_ch: int, hidden: int = 256, num_classes: int = 1):
        super().__init__()
        chans = [in_ch, 256, 512, 1024, 2048, hidden]
        self.contraction = nn.Module()
        for i in range(5):
            setattr(self.contraction, f"down_{i + 1}", DownBlock(chans[i], chans[i + 1]))
        self.conv0 = nn.Sequential(nn.Conv1d(hidden, hidden, 1, bias=False))
        self.conv1 = Dense(2 * hidden, hidden, bias=False)
        self.bn1 = ChannelLayerNorm(hidden)
        self.conv2 = Dense(hidden, num_classes)

    def forward(self, x, mask):
        feat, m = x, mask
        for i in range(5):
            feat, m = getattr(self.contraction, f"down_{i + 1}")(feat, m)
        h = dense(feat, self.conv0[0].weight)
        h = F.leaky_relu(instance_norm_time(h), 0.2)
        h = torch.cat([h.amax(1), h.mean(1)], -1)
        h = torch.relu(self.bn1(self.conv1(h)))
        return x, None, self.conv2(h)
