"""BYOL-A content-audio encoder, AudioNTT2020Task6 (JAX ``frontends/byola.py``).

Three Conv2d(3x3) + BatchNorm + ReLU + MaxPool(2) stages over (mel = 64,
time), then a per-timeframe 2-layer MLP to d = 2048: 16000 / 160 / 8 = 12.5
feature rows per second.

Public layout is the JAX package's: ``lms`` is (B, T, n_mels), time-major.
Inside, the convs run as the original torch model does, on (B, C, mel, time)
with the original parameter names (``features.{0,4,8}`` convs,
``features.{1,5,9}`` batch norms, ``fc.{0,3}``), and the flatten before the
MLP is mel-major (index = mel_bin * 64 + channel), so ``fc.0`` maps 1:1.

Numerics follow the JAX module: convs and products in the compute dtype
(f32 accumulation, rounded once, bias added in the compute dtype), the
eval-mode batch norm as an explicit f32 affine cast back to the compute
dtype, f32 output. It has no hand-written kernel (the JAX package has no
Pallas kernel here): the convs go to cuDNN, with TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.mvit_math import dense
from .mel import byola_log_mel

BN_EPS = 1e-5


def conv_bn_block(x, conv: nn.Conv2d, bn: nn.BatchNorm2d, cdtype):
    """One stage (JAX ``ConvBNBlock``) on (B, C, mel, time): conv in the
    compute dtype, eval-mode batch norm from the stored statistics in f32,
    cast back, ReLU, 2x2 max pool."""
    x = F.conv2d(x.to(cdtype), conv.weight.to(cdtype), None, padding=1)
    x = x + conv.bias.to(cdtype)[None, :, None, None]

    def per_ch(v):
        return v.float()[None, :, None, None]

    x = ((x.float() - per_ch(bn.running_mean))
         * torch.rsqrt(per_ch(bn.running_var) + BN_EPS) * per_ch(bn.weight)
         + per_ch(bn.bias)).to(cdtype)
    return F.max_pool2d(F.relu(x), 2)


class AudioNTT2020(nn.Module):
    """(B, T, n_mels) log-mel -> (B, T // 8, d) features, f32 out."""

    def __init__(self, n_mels: int = 64, d: int = 2048, dtype=torch.float32):
        super().__init__()
        self.n_mels, self.d, self.dtype = n_mels, d, dtype
        layers = []
        for c_in in (1, 64, 64):
            layers += [nn.Conv2d(c_in, 64, 3, padding=1), nn.BatchNorm2d(64, eps=BN_EPS),
                       nn.ReLU(), nn.MaxPool2d(2)]
        self.features = nn.Sequential(*layers)
        self.fc = nn.Sequential(nn.Linear(64 * (n_mels // 8), d), nn.ReLU(),
                                nn.Dropout(0.3), nn.Linear(d, d), nn.ReLU())

    def forward(self, lms: torch.Tensor) -> torch.Tensor:
        cd = self.dtype
        x = lms.transpose(1, 2)[:, None]                  # (B, 1, mel, time)
        for i in (0, 4, 8):
            x = conv_bn_block(x, self.features[i], self.features[i + 1], cd)
        b, c, m, t = x.shape
        x = x.permute(0, 3, 2, 1).reshape(b, t, m * c)    # mel-major flatten
        x = F.relu(dense(x, self.fc[0].weight, self.fc[0].bias))
        x = F.relu(dense(x, self.fc[3].weight, self.fc[3].bias))
        return x.float()


@torch.no_grad()
def byola_features(model: AudioNTT2020, wav: torch.Tensor) -> torch.Tensor:
    """Waveform (B, L) -> (B, T / 8, d) content features (frozen encoder)."""
    return model(byola_log_mel(wav).transpose(-1, -2))


def init_byola(model: AudioNTT2020, seed: int = 0, perturb: bool = True):
    """Seeded random weights: conv and linear weights normal with std
    1/sqrt(fan_in), biases zero, batch norm identity. ``perturb`` randomizes
    the biases and the batch-norm statistics and affines too (variance > 0),
    so that a wrong affine shows in the output."""
    g = torch.Generator().manual_seed(seed)

    def randn(t, std):
        return torch.randn(t.shape, generator=g) * std

    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                p.copy_(randn(p, p[0].numel() ** -0.5))
            elif name.endswith("bias"):
                p.copy_(randn(p, 0.1) if perturb else torch.zeros_like(p))
            else:                                           # BN weight
                p.copy_(1 + randn(p, 0.2) if perturb else torch.ones_like(p))
        if perturb:
            for m in model.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.running_mean.copy_(randn(m.running_mean, 0.1))
                    m.running_var.copy_(1 + 0.5 * torch.rand(m.running_var.shape, generator=g))
    return model.eval()
