"""HR/LR dual-branch pyramid backbone (JAX ``models/backbones.py:64-233``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.conv import MaskedConv1D
from ..ops.norm import ChannelLayerNorm
from ..ops.pe import sinusoid_encoding
from ..ops.resample import linear_resample_time, nearest_resample_time
from .blocks import TransformerBlock


def _abs_pe(max_len: int, n_embd: int, t: int, device, train: bool = False) -> torch.Tensor:
    """(1, T, C) absolute PE: the fixed table in training, linearly
    re-interpolated when an eval sequence is at least ``max_len`` long."""
    table = sinusoid_encoding(max_len, n_embd, device) / (n_embd ** 0.5)
    if train:
        assert t <= max_len, "sequence longer than max_len at train time"
        return table[None, :t]
    if t >= max_len:
        return linear_resample_time(table[None], t, axis=1)
    return table[None, :t]


def _remat(block, generator, x, mask, xo, mode):
    """Run a training-mode block under activation checkpointing: its
    intermediates are recomputed in the backward pass. The recompute must see
    the random draws of the first run, so the generator is wound back to where
    the block started for it and put forward again afterwards."""
    start = None if generator is None else generator.get_state()
    first = [True]

    def run(x, xo):
        if first[0] or generator is None:
            first[0] = False
            return block(x, mask, xo=xo, mode=mode, train=True, generator=generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return block(x, mask, xo=xo, mode=mode, train=True, generator=generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, xo, use_reentrant=False)


def _embed_stack(n_in: int, n_embd: int, ks: int, n_convs: int, with_ln: bool):
    """Embedding convs and their LNs (JAX ``_EmbedStack``), as the reference
    names them on the backbone: ``embd.{i}`` / ``embd_norm.{i}``."""
    embd = nn.ModuleList(
        MaskedConv1D(n_in if i == 0 else n_embd, n_embd, ks, bias=not with_ln)
        for i in range(n_convs))
    norms = nn.ModuleList(
        ChannelLayerNorm(n_embd) if with_ln else nn.Identity()
        for _ in range(n_convs))
    return embd, norms


class HRLRBackbone(nn.Module):
    """Initial cross block (q = x, k = the reconstruction stream, v = x),
    ``arch[1]`` stem blocks, then per level: a stride-2 branch block, an lh
    cross block (full-res stream vs nearest-upsampled level) and an hh cross
    block (level vs nearest-downsampled full-res). Level 0 of the output is
    the refined full-res stream."""

    def __init__(self, n_in: int, n_embd: int = 256, n_head: int = 4,
                 n_embd_ks: int = 3, max_len: int = 768, arch=(2, 2, 5),
                 mha_win_size=(-1,) * 6, scale_factor: int = 2,
                 with_ln: bool = True, use_abs_pe: bool = False,
                 proj_pdrop: float = 0.0, path_pdrop: float = 0.0,
                 remat: bool = False):
        super().__init__()
        if isinstance(n_in, (tuple, list)) or isinstance(n_embd, (tuple, list)):
            raise NotImplementedError("per-stream input projections are not ported")
        assert len(mha_win_size) == 1 + arch[2]
        assert scale_factor == 2, "the stride-2 fused block mode needs scale 2"
        self.n_embd, self.max_len, self.arch = n_embd, max_len, tuple(arch)
        self.use_abs_pe = use_abs_pe
        self.remat = remat
        self.embd, self.embd_norm = _embed_stack(n_in, n_embd, n_embd_ks,
                                                 arch[0], with_ln)
        w0 = mha_win_size[0]
        drop = dict(proj_pdrop=proj_pdrop, path_pdrop=path_pdrop)
        self.resselfattention = TransformerBlock(n_embd, n_head, window_size=w0,
                                                 cross=True, **drop)
        self.stem = nn.ModuleList(TransformerBlock(n_embd, n_head, window_size=w0, **drop)
                                  for _ in range(arch[1]))
        self.branch = nn.ModuleList(
            TransformerBlock(n_embd, n_head, ds_stride=2,
                             window_size=mha_win_size[1 + i], **drop)
            for i in range(arch[2]))
        self.lh_branch = nn.ModuleList(
            TransformerBlock(n_embd, n_head, window_size=w0, cross=True, **drop)
            for _ in range(arch[2]))
        self.hh_branch = nn.ModuleList(
            TransformerBlock(n_embd, n_head, window_size=w0, cross=True, **drop)
            for _ in range(arch[2]))

    def _run(self, blk, x, mask, xo, mode, train, generator):
        """One block. Activation checkpointing (``remat``) wraps unfused
        training blocks only: a fused training block already keeps nothing
        but its inputs (JAX ``pick_block``)."""
        if self.remat and blk.uses_unfused(train) and torch.is_grad_enabled():
            return _remat(blk, generator, x, mask, xo, mode)
        return blk(x, mask, xo=xo, mode=mode, train=train, generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``x`` (B, T, Cin) in the compute dtype, ``mask`` (B, T) bool. The
        reconstruction stream of the no-recon variant is ``x`` itself, so the
        shared embedding runs once (the JAX package's ``reco_is_x``).
        ``train`` turns stochastic depth and dropout on, drawn from
        ``generator``. The last ``hh_branch`` block's output is discarded
        (as in the reference), so its parameters get no gradient."""
        for conv, norm in zip(self.embd, self.embd_norm):
            x, mask = conv(x, mask)
            x = torch.relu(norm(x))
        t = x.shape[1]
        if self.use_abs_pe:
            pe = _abs_pe(self.max_len, self.n_embd, t, x.device, train).to(x.dtype)
            x = x + pe * mask.to(x.dtype)[..., None]
        reco_x = x

        run = lambda blk, x, mask, xo=None, mode=None: self._run(  # noqa: E731
            blk, x, mask, xo, mode, train, generator)
        x, _ = run(self.resselfattention, x, mask, reco_x, "qv_k")
        for blk in self.stem:
            x, mask = run(blk, x, mask)

        lh_feat, lh_mask = x, mask
        out_feats, out_masks = [lh_feat], [lh_mask]
        for i in range(self.arch[2]):
            x, mask = run(self.branch[i], x, mask)
            up = nearest_resample_time(x, t, axis=1).contiguous()
            lh_feat, lh_mask = run(self.lh_branch[i], lh_feat, lh_mask, up, "kv")
            out_feats.append(x)
            out_masks.append(mask)
            down = nearest_resample_time(lh_feat, x.shape[1], axis=1).contiguous()
            x, mask = run(self.hh_branch[i], x, mask, down, "kv")
        out_feats[0], out_masks[0] = lh_feat, lh_mask
        return out_feats, out_masks
