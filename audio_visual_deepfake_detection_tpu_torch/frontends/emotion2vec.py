"""Emotion2Vec (data2vec-multi) audio emotion encoder, inference path (JAX
``frontends/emotion2vec.py``), the ``extract_features`` path of the fairseq
model (mask=False, features_only=True):

1. conv feature extractor, seven bias-free Conv1d + LN + GELU layers, 320x
   downsample to 50 Hz (kernel K5, ``ops/kernels/conv_extractor.py``),
2. feature projection LN(512) -> Linear(512, 768),
3. grouped-conv relative positional encoder, 5 x [Conv1d(k=19, groups=16) +
   LN without affine + GELU], added residually,
4. optional learned extra tokens prepended,
5. a pre-LN, then the prenet AltBlocks and the main AltBlocks, all post-norm:
   x = x + attn(x); r = norm1(x); x = norm2(r + mlp(r)); the attention is
   kernel K8 (``ops/kernels/full_attention.py``) unless ALiBi is on,
6. optional ALiBi attention bias (off by default),
7. strip the extra tokens -> (B, T', 768) frame features, f32.

Defaults follow Data2VecMultiConfig: depth 8, prenet_depth 4 (12 AltBlocks),
12 heads, embed 768, norm_eps 1e-6. Parameters carry fairseq's state-dict
names (``modality_encoders.AUDIO.local_encoder.conv_layers.0.0.weight``,
``blocks.3.attn.qkv.weight``, ...), the names the JAX package's
``convert_emotion2vec_torch`` reads. The modules only hold parameters under
those names; the math is written out here with the JAX module's rounding
points (f32 parameters, products in the compute dtype with f32 sums, f32 LN
and softmax statistics, f32 output).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import conv_extractor as _fce
from ..ops.kernels import full_attention as _fmha
from ..ops.kernels.conv_extractor import CONV_SPEC, conv_output_length  # noqa: F401
from ..ops.mvit_math import dense, fmatmul, gelu, layer_norm


@dataclasses.dataclass(frozen=True)
class Emotion2VecConfig:
    embed_dim: int = 768
    depth: int = 8
    prenet_depth: int = 4
    num_heads: int = 12
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-6
    conv_pos_depth: int = 5
    conv_pos_width: int = 95
    conv_pos_groups: int = 16
    num_extra_tokens: int = 0
    use_alibi: bool = False


# Below, nn.Sequential and nn.Identity only give the parameters fairseq's
# indexed names (conv_layers.3.2.1.weight, ...); nothing calls them.

class ConvFeatureExtractor(nn.Module):
    """fairseq ConvFeatureExtractionModel, mode='layer_norm', no conv bias:
    (B, L) wav -> (B, T', 512) in the compute dtype. ``CONV_SPEC`` runs
    through K5 (its plain version on the CPU); any other spec runs the same
    layers one by one in eager PyTorch."""

    def __init__(self, spec=CONV_SPEC, dtype=torch.float32):
        super().__init__()
        self.spec, self.dtype = tuple(spec), dtype
        layers, c_in = [], 1
        for dim, k, s in self.spec:
            layers.append(nn.Sequential(
                nn.Conv1d(c_in, dim, k, stride=s, bias=False), nn.Identity(),
                nn.Sequential(nn.Identity(), nn.LayerNorm(dim, eps=_fce.LN_EPS), nn.Identity()),
                nn.Identity()))
            c_in = dim
        self.conv_layers = nn.ModuleList(layers)
        self._packed = None

    def _weights(self):
        return [layer[0].weight for layer in self.conv_layers]

    def _ln_rows(self):
        return torch.stack([v for layer in self.conv_layers
                            for v in (layer[2][1].weight, layer[2][1].bias)])

    def packed(self) -> _fce.ConvExtractorPacked:
        """Kernel inputs in the compute dtype, cached against the parameters'
        versions (an optimizer step or a load rebuilds them)."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, _fce.pack_conv_extractor(self._weights(), self._ln_rows(),
                                                          self.dtype))
        return self._packed[1]

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if self.spec == CONV_SPEC:
            return _fce.fused_conv_extractor(wav.float(), self.packed())
        return _fce.conv_extractor_math(wav, self._weights(), self._ln_rows(), self.dtype,
                                        spec=self.spec)


class AltAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, padding_mask=None, alibi_bias=None):
        b, n, c = x.shape
        d = c // self.num_heads
        qkv = dense(x, self.qkv.weight, self.qkv.bias)
        qkv = qkv.reshape(b, n, 3, self.num_heads, d).permute(2, 0, 3, 1, 4)
        q = qkv[0] * torch.tensor(d ** -0.5, dtype=x.dtype, device=x.device)
        k, v = qkv[1], qkv[2]
        if alibi_bias is None:
            out = _fmha.full_mha(q, k, v, padding_mask)
        else:
            att = fmatmul(q, k.transpose(-1, -2)) + alibi_bias
            if padding_mask is not None:
                att = att.masked_fill(padding_mask[:, None, None, :], float("-inf"))
            out = fmatmul(torch.softmax(att, dim=-1).to(v.dtype), v).to(v.dtype)
        out = out.transpose(1, 2).reshape(b, n, c)
        return dense(out, self.proj.weight, self.proj.bias)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class AltBlock(nn.Module):
    """Post-norm variant (layer_norm_first=False)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.dtype, self.norm_eps = dtype, norm_eps
        self.attn = AltAttention(dim, num_heads, dtype)
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)

    def forward(self, x, padding_mask=None, alibi_bias=None):
        cd = self.dtype
        x = x + self.attn(x, padding_mask, alibi_bias)
        r = layer_norm(x, self.norm1.weight, self.norm1.bias, cd, eps=self.norm_eps)
        h = gelu(dense(r, self.mlp.fc1.weight, self.mlp.fc1.bias))
        h = dense(h, self.mlp.fc2.weight, self.mlp.fc2.bias)
        return layer_norm(r + h, self.norm2.weight, self.norm2.bias, cd, eps=self.norm_eps)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Standard ALiBi head slopes."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if np.log2(n_heads).is_integer():
        return np.asarray(pow2_slopes(n_heads))
    closest = 2 ** int(np.floor(np.log2(n_heads)))
    return np.asarray(
        pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][: n_heads - closest])


def alibi_bias(n_heads: int, t: int) -> np.ndarray:
    """(H, T, T) symmetric ALiBi bias: -slope * |i - j|."""
    pos = np.arange(t)
    rel = -np.abs(pos[None, :] - pos[:, None]).astype(np.float32)
    return alibi_slopes(n_heads)[:, None, None].astype(np.float32) * rel[None]


class _ContextEncoder(nn.Module):
    def __init__(self, cfg: Emotion2VecConfig, dtype):
        super().__init__()
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.norm_eps)
        self.blocks = nn.ModuleList(
            AltBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.norm_eps, dtype)
            for _ in range(cfg.prenet_depth))


class _AudioEncoder(nn.Module):
    """Parameters of fairseq's ``modality_encoders.AUDIO``."""

    def __init__(self, cfg: Emotion2VecConfig, dtype):
        super().__init__()
        c = cfg.embed_dim
        self.local_encoder = ConvFeatureExtractor(dtype=dtype)
        self.project_features = nn.Sequential(nn.Identity(), nn.LayerNorm(512, eps=1e-5),
                                        nn.Linear(512, c))
        kk = max(3, cfg.conv_pos_width // cfg.conv_pos_depth)
        self.relative_positional_encoder = nn.Sequential(nn.Identity(), *[
            nn.Sequential(nn.Conv1d(c, c, kk, padding=kk // 2, groups=cfg.conv_pos_groups))
            for _ in range(cfg.conv_pos_depth)])
        self.context_encoder = _ContextEncoder(cfg, dtype)
        if cfg.num_extra_tokens > 0:
            self.extra_tokens = nn.Parameter(torch.zeros(1, cfg.num_extra_tokens, c))
        if cfg.use_alibi:
            self.alibi_scale = nn.Parameter(torch.ones(1, 1, 1, 1))


def _pos_conv(x, conv: nn.Conv1d, cdtype):
    """One layer of the positional encoder on (B, T, C): grouped 'same' conv
    with bias in the compute dtype, LN without affine (eps 1e-5), GELU."""
    xt = x.transpose(1, 2)
    w = conv.weight.to(cdtype)
    if cdtype == torch.bfloat16 and not x.is_cuda:
        y = F.conv1d(xt.float(), w.float(), None, padding=conv.padding[0],
                     groups=conv.groups).to(cdtype)
    else:
        y = F.conv1d(xt, w, None, padding=conv.padding[0], groups=conv.groups)
    y = (y + conv.bias.to(cdtype)[None, :, None]).transpose(1, 2)
    one = torch.ones((), device=x.device)
    return gelu(layer_norm(y, one, torch.zeros((), device=x.device), cdtype, eps=1e-5))


class Emotion2Vec(nn.Module):
    """(B, L) 16 kHz waveform [+ (B, L) bool padding mask, True = padding] ->
    (B, T', embed_dim) at 50 Hz, f32."""

    def __init__(self, cfg: Emotion2VecConfig = Emotion2VecConfig(), dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.modality_encoders = nn.ModuleDict({"AUDIO": _AudioEncoder(cfg, dtype)})
        self.blocks = nn.ModuleList(
            AltBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.norm_eps, dtype)
            for _ in range(cfg.depth))

    @property
    def audio(self) -> _AudioEncoder:
        return self.modality_encoders["AUDIO"]

    def frame_padding_mask(self, padding_mask: torch.Tensor, n_frames: int) -> torch.Tensor:
        """Sample-level (B, L) padding mask -> frame-level (B, T')."""
        out_lens = (~padding_mask).sum(-1)
        for _, k, s in CONV_SPEC:
            out_lens = torch.div(out_lens - k, s, rounding_mode="floor") + 1
        return torch.arange(n_frames, device=padding_mask.device)[None, :] >= out_lens[:, None]

    def project(self, feats: torch.Tensor) -> torch.Tensor:
        """Extractor output -> LN -> Linear -> + positional encoder."""
        a, cd = self.audio, self.dtype
        ln, lin = a.project_features[1], a.project_features[2]
        x = dense(layer_norm(feats, ln.weight, ln.bias, cd, eps=1e-5), lin.weight, lin.bias)
        pos = x
        for layer in list(a.relative_positional_encoder)[1:]:
            pos = _pos_conv(pos, layer[0], cd)
        return x + pos

    def trunk(self, x: torch.Tensor, padding_mask=None) -> torch.Tensor:
        """Extra tokens, prenet LN, the AltBlocks; strips the extra tokens."""
        c, a, cd = self.cfg, self.audio, self.dtype
        ab = None
        if c.use_alibi:
            ab = torch.from_numpy(alibi_bias(c.num_heads, x.shape[1])).to(x.device)[None] \
                * a.alibi_scale.float().clamp(min=0.0)
        if c.num_extra_tokens > 0:
            num = c.num_extra_tokens
            x = torch.cat([a.extra_tokens.to(cd).expand(x.shape[0], -1, -1), x], dim=1)
            if padding_mask is not None:
                padding_mask = F.pad(padding_mask, (num, 0), value=False)
            if ab is not None:
                ab = F.pad(ab, (num, 0, num, 0))
        norm = a.context_encoder.norm
        x = layer_norm(x, norm.weight, norm.bias, cd, eps=c.norm_eps)
        for blk in list(a.context_encoder.blocks) + list(self.blocks):
            x = blk(x, padding_mask, ab)
        return x[:, c.num_extra_tokens:].float()

    def forward(self, wav: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.project(self.audio.local_encoder(wav))
        if padding_mask is not None:
            padding_mask = self.frame_padding_mask(padding_mask, x.shape[1])
        return self.trunk(x, padding_mask)


def init_emotion2vec(model: Emotion2Vec, seed: int = 0, perturb: bool = True):
    """Seeded random weights: Linear weights normal (std 0.02), conv weights
    normal with std 1/sqrt(fan_in), biases zero, LN identity, extra tokens
    zero, ALiBi scale one. ``perturb`` randomizes the LN affines, biases and
    extra tokens too, so that a wrong affine or bias shows in the output."""
    g = torch.Generator().manual_seed(seed)

    def randn(t, std):
        return torch.randn(t.shape, generator=g) * std

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("alibi_scale"):
                val = torch.ones_like(p)
            elif name.endswith("bias") or name.endswith("extra_tokens"):
                val = randn(p, 0.1) if perturb else torch.zeros_like(p)
            elif p.dim() == 1:                        # LN weights
                val = 1 + randn(p, 0.2) if perturb else torch.ones_like(p)
            elif p.dim() == 3:                        # Conv1d
                val = randn(p, p[0].numel() ** -0.5)
            else:
                val = randn(p, 0.02)
            p.copy_(val.to(p.device))
    return model.eval()
