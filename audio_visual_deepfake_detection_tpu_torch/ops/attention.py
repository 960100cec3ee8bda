"""Attention primitives of the unfused localizer block (JAX
``ops/attention.py``): banded sliding-window and dense masked attention on
(B, H, T, D) heads, q already scaled by ``D ** -0.5``.

``band_attention`` is what the block calls. It goes through
``ops/kernels/band_attention.py::band_attention_fused``: the CUDA kernel K7
on the card, its plain version on the CPU, and in both cases a backward that
differentiates ``band_attention_xla`` below (the JAX package routes its TPU
path the same way). ``band_attention_xla`` softmaxes in f32 whatever the
input dtype, the kernel in the input dtype; the two are equal to rounding in
f32 and differ by bf16 rounding in bf16.

``full_attention`` (window -1, the coarsest pyramid level) is a plain
product outside any kernel in the JAX package too, so ``torch.matmul`` and a
softmax are its port. Relative position bias and time weighting are not
ported (``ArchConfig`` refuses the configs that would need them).
"""

from __future__ import annotations

import torch

NEG_PENALTY = -1e4     # added to the score of a masked key (finite: edge rows renormalise)


def shift_time(x: torch.Tensor, d: int, axis: int = -2) -> torch.Tensor:
    """y with y[..., i, :] = x[..., i + d, :] along ``axis``, zero fill."""
    if d == 0:
        return x
    ax = axis % x.ndim
    t = x.shape[ax]
    n = min(abs(d), t)
    shape = list(x.shape)
    shape[ax] = n
    pad = x.new_zeros(shape)
    if d > 0:
        return torch.cat([x.narrow(ax, n, t - n), pad], dim=ax)
    return torch.cat([pad, x.narrow(ax, 0, t - n)], dim=ax)


def band_attention(q, k, v, kv_valid, w_overlap: int, rel_pe=None,
                   time_weight=None) -> torch.Tensor:
    """Banded attention with the reference's masking. q, k, v (B, H, T, D),
    ``kv_valid`` (B, T) bool, ``w_overlap`` the half window. Returns
    (B, H, T, D)."""
    if rel_pe is not None or time_weight is not None:
        raise NotImplementedError(
            "rel_pe / time_weight are not ported; see queue 1 item 10 of ROADMAP.md")
    from .kernels.band_attention import band_attention_fused     # it imports this module

    return band_attention_fused(q, k, v, kv_valid, w_overlap)


def band_attention_xla(q, k, v, kv_valid, w_overlap: int) -> torch.Tensor:
    """The banded formulation the kernel's backward differentiates: scores
    in the input dtype, softmax over the 2w+1 offsets in f32."""
    t = q.shape[-2]
    kv_pen = torch.where(kv_valid, 0.0, NEG_PENALTY).to(q.dtype)          # (B, T)
    ar = torch.arange(t, device=q.device)
    neg_inf = torch.tensor(float("-inf"), dtype=q.dtype, device=q.device)
    offsets = range(-w_overlap, w_overlap + 1)
    scores = []
    for d in offsets:
        s = (q * shift_time(k, d)).sum(-1)                                # (B, H, T)
        pen = shift_time(kv_pen[..., None], d)[..., 0]
        in_range = (ar >= max(0, -d)) & (ar < t - max(0, d))
        scores.append(torch.where(in_range, s + pen[:, None, :], neg_inf))
    att = torch.stack(scores, dim=-1)                                     # (B, H, T, 2w+1)
    att = torch.softmax(att.float(), dim=-1).to(q.dtype)
    # rows whose own key slot is masked are zeroed (the reference's NaN guard)
    att = att.masked_fill(~kv_valid[:, None, :, None], 0.0)
    out = torch.zeros_like(q)
    for idx, d in enumerate(offsets):
        out = out + att[..., idx:idx + 1] * shift_time(v, d)
    return out


def full_attention(q, k, v, kv_valid) -> torch.Tensor:
    """Dense masked attention: q (B, H, Tq, D), k, v (B, H, Tk, D),
    ``kv_valid`` (B, Tk). Masked keys get -1e30, not -inf: a row with a valid
    key softmaxes to the same values, and a fully masked row (a padding row
    of the batch) softmaxes to uniform instead of NaN, so neither it nor its
    backward poisons the parameters' gradients; the value mask zeroes it."""
    att = torch.matmul(q, k.transpose(-1, -2))
    fill = torch.tensor(-1e30, dtype=q.dtype, device=q.device)
    att = torch.where(kv_valid[:, None, None, :], att, fill)
    att = torch.softmax(att.float(), dim=-1).to(q.dtype)
    v = v * kv_valid[:, None, :, None].to(v.dtype)
    return torch.matmul(att, v)
