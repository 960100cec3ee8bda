"""MViT-v2 video encoder family (JAX ``frontends/mvit.py``), (B, T, H, W, 3).

The modules keep torchvision's video-MViT parameter names (``conv_proj``,
``pos_encoding.class_token``, ``blocks.{i}.{norm1,norm2,project,mlp.0,mlp.3}``,
``blocks.{i}.attn.{qkv,project,pool_q/k/v.pool,pool_q/k/v.norm_act.0,
rel_pos_h/w/t}``, ``norm``), so a torchvision state dict (the AlignVideo
checkpoint under ``video_encoder.mvit.``) loads by name and the JAX
package's ``convert_mvit_torch`` maps between the two. Parameters stay f32;
``dtype`` is the compute dtype, as in the JAX modules.

Dispatch, the port's counterpart of the JAX gates:
- ``PatchEmbed`` at the production geometry -> kernel K2;
- ``MultiscaleBlock`` in the steady state (stride-1 q, k/v pooled to a
  (T, 1, 1) grid, in == out channels, at most 16 spatial cells) -> the
  whole-block kernel K4 (stage 2's S = 16 included, unlike the TPU's
  ``MAX_SPATIAL = 4``);
- any other block whose k/v pool to (T, 1, 1) -> the pooled-attention kernel
  K3 for the attention core, its band built inside from the temporal
  rel-pos table (or, where k/v are pooled in time and q is not, gathered by
  the caller with the ratio-corrected index), the rest in eager torch;
- the stride-q transition blocks -> eager torch (no kernel in the JAX
  package either).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import mvit_attention as _k3
from ..ops.kernels import mvit_block as _k4
from ..ops.kernels import patch_embed as _k2
from ..ops.mvit_math import (dense, fmatmul, gelu, layer_norm, softmax_pv, token_pool,
                             toeplitz_band)


@dataclasses.dataclass(frozen=True)
class MSBlockConfig:
    num_heads: int
    input_channels: int
    output_channels: int
    kernel_q: Tuple[int, int, int]
    kernel_kv: Tuple[int, int, int]
    stride_q: Tuple[int, int, int]
    stride_kv: Tuple[int, int, int]


def generate_config(blocks: Sequence[int], heads: Sequence[int],
                    channels: Sequence[int], out_dim: int) -> List[MSBlockConfig]:
    """Per-block settings of a stage layout (JAX ``generate_config``)."""
    num_heads, in_ch = [], []
    stride_q = [[1, 1, 1] for _ in range(sum(blocks))]
    cum = np.cumsum(blocks)
    stride_kv = []
    for i, nb in enumerate(blocks):
        num_heads.extend([heads[i]] * nb)
        in_ch.extend([channels[i]] * nb)
        if i != len(blocks) - 1:
            stride_q[cum[i]] = [1, 2, 2]
        skv = 2 ** (len(blocks) - 1 - i)
        stride_kv.extend([[1, skv, skv]] * nb)
    input_channels = [in_ch[0]] + in_ch[:-1]
    output_channels = in_ch[:-1] + [out_dim]
    return [MSBlockConfig(num_heads=num_heads[i], input_channels=input_channels[i],
                          output_channels=output_channels[i], kernel_q=(3, 3, 3),
                          kernel_kv=(3, 3, 3), stride_q=tuple(stride_q[i]),
                          stride_kv=tuple(stride_kv[i]))
            for i in range(len(num_heads))]


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def _rel_pos_index(q_size: int, k_size: int) -> np.ndarray:
    """Ratio-corrected relative position lookup (torchvision _add_rel_pos)."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    qi = np.arange(q_size)[:, None] * q_ratio
    ki = np.arange(k_size)[None, :] * k_ratio
    return (qi - ki + (k_size - 1) * k_ratio).astype(np.int64)


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


class PatchEmbed(nn.Module):
    """``conv_proj``: Conv3d(3 -> C) over (B, T, H, W, 3) frames."""

    def __init__(self, features: int, kernel, stride, padding, dtype=torch.float32):
        super().__init__()
        self.kernel, self.stride, self.padding = tuple(kernel), tuple(stride), tuple(padding)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros((features, 3) + self.kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        """Frames in [0, 1], or uint8 frames normalized here (x 1/255 in f32,
        inside the kernel at the production geometry)."""
        u8 = v.dtype == torch.uint8
        if (self.kernel == _k2.KERNEL and self.stride == _k2.STRIDE
                and self.padding == _k2.PADDING and tuple(v.shape[2:]) == _k2.FRAME
                and self.weight.shape[0] <= _k2.MAX_FEATURES):
            if u8:
                return _k2.fused_patch_embed_u8(v, self.weight, self.bias, self.dtype)
            return _k2.fused_patch_embed(v.float(), self.weight, self.bias, self.dtype)
        return _k2.patch_embed_math(_k2.normalize_u8(v) if u8 else v, self.weight, self.bias,
                                    self.dtype, self.stride, self.padding)


class TokenPool(nn.Module):
    """Depthwise Conv3d pooling of the head tokens + the per-head LN
    (torchvision ``Pool``: ``pool`` and ``norm_act.0``)."""

    def __init__(self, d: int, kernel, stride):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.pool = nn.Conv3d(d, d, self.kernel, stride=self.stride,
                              padding=tuple(k // 2 for k in self.kernel), groups=d,
                              bias=False)
        self.norm_act = nn.Sequential(nn.LayerNorm(d, eps=1e-6))

    def taps(self, cd) -> torch.Tensor:
        d = self.pool.weight.shape[0]
        return self.pool.weight.to(cd).float().reshape(d, 27).t()

    def forward(self, x, thw):
        if _prod(self.stride) == 1 and _prod(self.kernel) == 1:
            return x, thw
        ln = self.norm_act[0]
        return token_pool(x, self.taps(x.dtype), thw, self.stride, ln.weight, ln.bias)


class MultiscaleAttention(nn.Module):
    """Pooled attention of one block; computes in the input's dtype."""

    def __init__(self, cfg: MSBlockConfig, input_thw):
        super().__init__()
        self.cfg = cfg
        out = cfg.output_channels
        d = out // cfg.num_heads
        self.qkv = nn.Linear(cfg.input_channels, 3 * out)
        self.project = nn.Linear(out, out)
        self.pool_q = TokenPool(d, cfg.kernel_q, cfg.stride_q)
        self.pool_k = TokenPool(d, cfg.kernel_kv, cfg.stride_kv)
        self.pool_v = TokenPool(d, cfg.kernel_kv, cfg.stride_kv)
        # table sizes from the configured grid, as torchvision allocates them
        cq = [s // st for s, st in zip(input_thw, cfg.stride_q)]
        ck = [s // st for s, st in zip(input_thw, cfg.stride_kv)]
        rel_sp = 2 * max(cq[1], ck[1], cq[2], ck[2]) - 1
        self.rel_pos_h = nn.Parameter(torch.zeros(rel_sp, d))
        self.rel_pos_w = nn.Parameter(torch.zeros(rel_sp, d))
        self.rel_pos_t = nn.Parameter(torch.zeros(2 * max(cq[0], ck[0]) - 1, d))

    def forward(self, x, thw):
        c, cd = self.cfg, x.dtype
        out_dim, nh = c.output_channels, c.num_heads
        d = out_dim // nh
        b, n, _ = x.shape
        qkv = dense(x, self.qkv.weight, self.qkv.bias)
        qkv = qkv.reshape(b, n, 3, nh, d).permute(2, 0, 3, 1, 4)
        q, q_thw = self.pool_q(qkv[0], thw)
        k, k_thw = self.pool_k(qkv[1], thw)
        v, _ = self.pool_v(qkv[2], thw)
        qt, qh, qw = q_thw
        kt, kh, kw = k_thw
        scale_c = torch.tensor(d ** -0.5, dtype=cd, device=x.device)
        rel_t = self.rel_pos_t.to(cd)
        if kh * kw == 1 and qt == kt:
            return self._pooled_core(q, k, v, rel_t, q_thw, scale_c)
        q_grid = q[:, :, 1:].reshape(b, nh, qt, qh, qw, d)
        if qt == kt and qh * qw <= 4:     # the XLA Toeplitz branch: G rounded
            bias_t = toeplitz_band(q_grid.reshape(b, nh, qt, qh * qw, d), rel_t, kt,
                                   round_to=cd).reshape(b, nh, qt, qh, qw, kt)
        else:                             # q . rel_t[t_q - t_k + kt - 1], one product per t_q
            rt = rel_t[torch.from_numpy(_rel_pos_index(qt, kt)).to(x.device)]
            qg = q_grid.permute(2, 0, 1, 3, 4, 5).reshape(qt, -1, d)
            bias_t = fmatmul(qg, rt.transpose(1, 2)).reshape(
                qt, b, nh, qh, qw, kt).permute(1, 2, 0, 3, 4, 5)
        if kh * kw == 1:                  # k/v pooled in time too: K3 with the band given
            return self._pooled_core(q, k, v, rel_t, q_thw, scale_c, band=bias_t)
        idx = lambda a, bb: torch.from_numpy(_rel_pos_index(a, bb)).to(x.device)  # noqa: E731
        rh = self.rel_pos_h.to(cd).float()[idx(qh, kh)]
        rw = self.rel_pos_w.to(cd).float()[idx(qw, kw)]
        bias_h = torch.einsum("bnthwd,hkd->bnthwk", q_grid.float(), rh)
        bias_w = torch.einsum("bnthwd,wkd->bnthwk", q_grid.float(), rw)
        bhw = (bias_h[..., :, None] + bias_w[..., None, :]).to(cd).float()
        # scores + [0 | bias] in place: bias_t over the key's t, bhw over its (h, w)
        att = fmatmul(q * scale_c, k.transpose(2, 3))
        grid = att[:, :, 1:, 1:].unflatten(3, (kt, kh * kw)).unflatten(2, (qt, qh, qw))
        grid += bias_t.to(cd).float()[..., None]
        grid += bhw.reshape(b, nh, qt, qh, qw, 1, kh * kw)
        o = softmax_pv(att, v)
        o = o + F.pad(q[:, :, 1:], (0, 0, 1, 0))        # residual pool, no cls
        o = o.transpose(1, 2).reshape(b, -1, out_dim)
        return dense(o, self.project.weight, self.project.bias), q_thw

    def _pooled_core(self, q, k, v, rel_t, q_thw, scale_c, band=None):
        """k/v pooled to (T, 1, 1): grid queries through K3, written straight
        into the token layout, with the band built inside from the table, or,
        where q keeps another T than k/v, the (B, nh, qt, qh, qw, kt) ``band``
        built by the caller; the class-token query row in eager torch (no
        bias, no residual), as on the TPU."""
        b, nh, n_q, d = q.shape
        qt, qh, qw = q_thw
        nk = k.shape[2]
        kp = torch.cat([k[:, :, 1:], k[:, :, :1]], dim=2).reshape(b * nh, nk, d)
        vp = torch.cat([v[:, :, 1:], v[:, :, :1]], dim=2).reshape(b * nh, nk, d)
        o = q.new_empty((b, n_q, nh, d))
        if band is None:
            _k3.pooled_attention_table(q[:, :, 1:], kp, vp, rel_t, qt, qh * qw, d ** -0.5,
                                       band_round=qh * qw <= 4, out=o[:, 1:].transpose(1, 2))
        else:
            ng = n_q - 1
            o[:, 1:] = _k3.fused_pooled_attention(
                q[:, :, 1:].reshape(b * nh, ng, d), kp, vp, band.reshape(b * nh, ng, nk - 1),
                scale=d ** -0.5).reshape(b, nh, ng, d).transpose(1, 2)
        o[:, 0] = softmax_pv(fmatmul(q[:, :, :1] * scale_c, k.transpose(2, 3)), v)[:, :, 0]
        return dense(o.reshape(b, n_q, nh * d), self.project.weight, self.project.bias), q_thw


class MultiscaleBlock(nn.Module):
    """One block; computes in the input's dtype."""

    def __init__(self, cfg: MSBlockConfig, input_thw):
        super().__init__()
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(cfg.input_channels, eps=1e-6)
        self.attn = MultiscaleAttention(cfg, input_thw)
        self.norm2 = nn.LayerNorm(cfg.output_channels, eps=1e-6)
        if cfg.input_channels != cfg.output_channels:
            self.project = nn.Linear(cfg.input_channels, cfg.output_channels)
        hidden = 4 * cfg.output_channels
        # torchvision's MLP: Linear, GELU, Dropout, Linear at mlp.{0,3}
        self.mlp = nn.Sequential(nn.Linear(cfg.output_channels, hidden), nn.GELU(),
                                 nn.Identity(), nn.Linear(hidden, cfg.output_channels))
        self._packed = {}   # dtype -> (parameter signature, K4 inputs)

    def fused_geometry_ok(self, thw, n_tokens: int) -> bool:
        """The K4 gate (JAX ``_fused_geometry_ok`` with MAX_SPATIAL = 16)."""
        c = self.cfg
        k_thw = tuple(-(-g // st) for g, st in zip(thw, c.stride_kv))
        return (thw[1] * thw[2] <= _k4.MAX_SPATIAL
                and c.input_channels == c.output_channels
                and tuple(c.stride_q) == (1, 1, 1)
                and tuple(c.kernel_q) == (3, 3, 3)
                and tuple(c.kernel_kv) == (3, 3, 3)
                and c.stride_kv[0] == 1
                and k_thw[1] == 1 and k_thw[2] == 1
                and c.output_channels % c.num_heads == 0
                and (c.output_channels // c.num_heads) <= _k4.MAX_HEAD_DIM
                and n_tokens == 1 + thw[0] * thw[1] * thw[2])

    def packed(self, dtype) -> _k4.MSBlockPacked:
        """K4's inputs in ``dtype``, repacked only when a parameter changed
        (storage or version counter), as the localizer blocks do."""
        params = dict(self.named_parameters())
        sig = tuple((p.device, p.data_ptr(), p._version) for p in params.values())
        hit = self._packed.get(dtype)
        if hit is None or hit[0] != sig:
            hit = (sig, _k4.pack_msblock_params(params, self.cfg.num_heads, dtype))
            self._packed[dtype] = hit
        return hit[1]

    def forward(self, x, thw):
        c = self.cfg
        if self.fused_geometry_ok(thw, x.shape[1]):
            y = _k4.fused_multiscale_block(x, self.packed(x.dtype), t=thw[0],
                                           grid_hw=(thw[1], thw[2]), n_head=c.num_heads)
            return y, thw
        cd = x.dtype
        x_norm1 = layer_norm(x, self.norm1.weight, self.norm1.bias, cd)
        x_attn, thw_new = self.attn(x_norm1, thw)
        if c.input_channels != c.output_channels:   # proj_after_attn: on norm1(x)
            x = dense(x_norm1, self.project.weight, self.project.bias)
        if _prod(c.stride_q) > 1:
            b, _, ch = x.shape
            t, hs, ws = thw
            grid = x[:, 1:].reshape(b, t, hs, ws, ch).permute(0, 4, 1, 2, 3)
            kernel = tuple(s + 1 if s > 1 else s for s in c.stride_q)
            grid = F.max_pool3d(grid, kernel, stride=c.stride_q,
                                padding=tuple(k // 2 for k in kernel))
            x = torch.cat([x[:, :1], grid.permute(0, 2, 3, 4, 1).reshape(b, -1, ch)], dim=1)
        x = x + x_attn
        h = layer_norm(x, self.norm2.weight, self.norm2.bias, cd)
        h = gelu(dense(h, self.mlp[0].weight, self.mlp[0].bias))
        return x + dense(h, self.mlp[3].weight, self.mlp[3].bias), thw_new


class MViTVideoEncoder(nn.Module):
    """(B, T, 96, 96, 3) -> (B, T', out_dim) per-frame features: conv_proj,
    class token, blocks, final LN, class token dropped, f32 spatial mean."""

    def __init__(self, block_setting, patch_kernel=(3, 15, 15), patch_stride=(1, 12, 12),
                 patch_padding=(1, 3, 3), temporal_size: int = 512,
                 spatial_size=(96, 96), dtype=torch.float32, batch_front_split: int = 2):
        super().__init__()
        self.block_setting = tuple(block_setting)
        self.patch_kernel, self.patch_stride = tuple(patch_kernel), tuple(patch_stride)
        self.patch_padding = tuple(patch_padding)
        self.temporal_size, self.spatial_size = temporal_size, tuple(spatial_size)
        self.dtype = dtype
        self.batch_front_split = batch_front_split
        c0 = self.block_setting[0].input_channels
        self.conv_proj = PatchEmbed(c0, patch_kernel, patch_stride, patch_padding, dtype)
        self.pos_encoding = nn.Module()
        self.pos_encoding.class_token = nn.Parameter(torch.zeros(c0))
        cfg_thw = self.patch_grid((1, temporal_size) + self.spatial_size)
        blocks = []
        for cfg in self.block_setting:
            blocks.append(MultiscaleBlock(cfg, cfg_thw))
            cfg_thw = tuple(s // st for s, st in zip(cfg_thw, cfg.stride_q))
        self.blocks = nn.ModuleList(blocks)
        self.norm = nn.LayerNorm(self.block_setting[-1].output_channels, eps=1e-6)

    def patch_grid(self, video_shape) -> Tuple[int, int, int]:
        """(T', H', W') token grid of a (B, T, H, W, 3) input."""
        return tuple(_conv_out(s, k, st, p) for s, k, st, p in zip(
            tuple(video_shape[1:4]), self.patch_kernel, self.patch_stride,
            self.patch_padding))

    def thw_after(self, thw, split: int) -> Tuple[int, int, int]:
        """Grid after blocks[:split] ('same'-padded strided q pooling)."""
        for cfg in self.block_setting[:split]:
            thw = tuple((s + st - 1) // st for s, st in zip(thw, cfg.stride_q))
        return thw

    def embed(self, video: torch.Tensor) -> torch.Tensor:
        """Patch embed + class token -> (B, 1 + T'H'W', C) in the compute dtype."""
        x = self.conv_proj(video)
        b, t, hs, ws, ch = x.shape
        x = x.reshape(b, t * hs * ws, ch)
        cls = self.pos_encoding.class_token.to(x.dtype).expand(b, 1, ch)
        return torch.cat([cls, x], dim=1)

    def front_blocks(self, x, thw, split: int) -> torch.Tensor:
        for blk in self.blocks[:split]:
            x, thw = blk(x, thw)
        return x

    def encode_front(self, video, split: int) -> torch.Tensor:
        return self.front_blocks(self.embed(video), self.patch_grid(video.shape), split)

    def encode_back(self, x, thw, split: int) -> torch.Tensor:
        """blocks[split:] + final LN + per-frame f32 spatial mean."""
        for blk in self.blocks[split:]:
            x, thw = blk(x, thw)
        x = layer_norm(x, self.norm.weight, self.norm.bias, x.dtype)[:, 1:]
        b = x.shape[0]
        return x.reshape(b, thw[0], thw[1] * thw[2], x.shape[-1]).float().mean(2)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        n = len(self.block_setting)
        x = self.encode_front(video, n)
        return self.encode_back(x, self.thw_after(self.patch_grid(video.shape), n), n)


def hybrid_apply(model: MViTVideoEncoder, chunks: torch.Tensor, *,
                 sequential_patch: bool = False, batched_back: bool = False,
                 front_group: int = 0) -> torch.Tensor:
    """The production chunk strategy (JAX ``hybrid_apply``): patch embed and
    blocks[:split] batched across chunks, in groups of ``front_group`` chunks
    (the tail group zero-padded, as the JAX version does) when there are
    more; then blocks[split:] per chunk, or with ``batched_back`` batched
    over the chunks of each group (the JAX version batches all chunks: here
    the group also bounds the back stages' memory). ``sequential_patch``
    embeds one chunk at a time. Chunks are independent, so every setting
    gives the same features."""
    split = model.batch_front_split
    thw0 = model.patch_grid(chunks.shape)
    thw = model.thw_after(thw0, split)

    def run_group(x, n_real):
        if sequential_patch and x.shape[0] > 1:
            emb = torch.cat([model.embed(v[None]) for v in x])
        else:
            emb = model.embed(x)
        front = model.front_blocks(emb, thw0, split)[:n_real]
        if batched_back:
            return model.encode_back(front, thw, split)
        return torch.cat([model.encode_back(front[i:i + 1], thw, split)
                          for i in range(n_real)])

    n = chunks.shape[0]
    if not (front_group and n > front_group):
        return run_group(chunks, n)
    g = front_group
    pad = (-n) % g
    if pad:
        chunks = torch.cat([chunks, chunks.new_zeros((pad,) + chunks.shape[1:])])
    return torch.cat([run_group(chunks[i:i + g], min(g, n - i))
                      for i in range(0, n, g)])


def _stage_model(blocks, out_dim, temporal_size, dtype, split):
    return MViTVideoEncoder(generate_config(blocks, [1, 2, 4, 8], [96, 192, 384, 768],
                                            out_dim),
                            temporal_size=temporal_size, dtype=dtype,
                            batch_front_split=split)


def mvit_v2_t(out_dim: int = 256, temporal_size: int = 512, dtype=torch.float32):
    return _stage_model([1, 2, 5, 2], out_dim, temporal_size, dtype, 1)


def mvit_v2_s(out_dim: int = 256, temporal_size: int = 512, dtype=torch.float32):
    return _stage_model([1, 2, 11, 2], out_dim, temporal_size, dtype, 1)


def mvit_v2_b(out_dim: int = 256, temporal_size: int = 512, dtype=torch.float32):
    return _stage_model([2, 3, 16, 3], out_dim, temporal_size, dtype, 2)


def init_mvit(model: MViTVideoEncoder, seed: int = 0, perturb: bool = True):
    """Seeded random weights: Linear and conv weights normal (std 0.02, or
    1/sqrt(fan_in) for the convs), biases zero, LN identity, rel-pos tables
    and class token zero (torchvision's init). ``perturb`` randomizes the LN
    affines, biases, rel-pos tables and class token too, so that a wrong
    affine, tap or band shows in the output."""
    g = torch.Generator().manual_seed(seed)

    def randn(t, std):
        return torch.randn(t.shape, generator=g) * std

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "rel_pos" in name or "class_token" in name:
                val = randn(p, 0.1) if perturb else torch.zeros_like(p)
            elif p.dim() == 1:                        # LN weights
                val = 1 + randn(p, 0.2) if perturb else torch.ones_like(p)
            elif p.dim() == 5:                        # conv_proj and pool convs
                val = randn(p, p[0].numel() ** -0.5)
            else:
                val = randn(p, 0.02)
            p.copy_(val.to(p.device))
    return model
