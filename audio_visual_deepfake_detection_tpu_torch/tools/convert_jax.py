"""Carry the JAX package's flax parameters into the port (jax-free).

``state_dict_from_flax(params)`` takes the flax tree as nested dicts of
numpy arrays (with or without the leading ``params`` collection) and returns
a state dict under the original torch repo's names, in torch layouts:

- Conv1d ``(out, in/g, k)``        <- flax ``(k, in/g, out)``
- ConvTranspose1d ``(in, out, k)`` <- flax ``(k, in, out)`` (the
  reconstruction's ``expansion.up_*``; no flip, JAX ``_convT_w`` inverted)
- 1x1 Conv1d ``(out, in, 1)``      <- flax dense ``(in, out)`` (attention
  q/k/v/proj, the MLP, the recovery module's ``conv0``)
- Linear ``(out, in)``             <- flax dense ``(in, out)``
- LayerNorm / layer scale ``(C,)``, head scales ``()``
- relative position bias ``(1, 1, H, W)`` and time weighting ``(1, H, W)``
  <- flax ``(H, W)`` (the reference's shapes; JAX ``convert_torch.py``
  squeezes them back)

The legacy backbones' trees map too: the per-stream projections
``embed/proj_{i}`` to ``backbone.proj.{i}``, the conv backbone's
``ConvBlock``s ``stem_{i}`` / ``branch_{i}`` with ``conv1`` / ``conv2`` /
``downsample``, and the identity neck's ``fpn_norm_{i}``.

The names are the ones the JAX package's ``tools/convert_torch.py::_ref_name``
maps to (the THE variant's recovery module, ``interpolator`` in flax, under
the reference's ``segmentandCls.``), so ``convert_state_dict(state_dict_from_flax(p), p)`` returns ``p``
bit for bit, and a reference checkpoint loads into the port by name.

``train_state_from_flax`` carries a whole JAX ``TrainState`` (parameters, EMA
parameters, Adam moments and count, loss normalizer, step) into the port's
``TrainState``, so that both take the same next step.

``mvit_state_dict_from_flax`` does the same for the MViT-v2 video encoder,
under torchvision's names (Conv3d ``(out, in/g, kt, kh, kw)`` <- flax
``(kt, kh, kw, in/g, out)``), the inverse of the JAX ``convert_mvit_torch``.

``byola_state_dict_from_flax`` (original ``AudioNTT2020Task6`` names;
Conv2d ``(out, in, mel, time)`` <- flax ``(time, mel, in, out)``) and
``emotion2vec_state_dict_from_flax`` (fairseq data2vec-multi names) invert
``convert_byola_torch`` and ``convert_emotion2vec_torch`` the same way.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _wb(leaf: str) -> str:
    return "weight" if leaf == "kernel" else "bias"


def _block(prefix: str, rest: Tuple[str, ...]) -> Tuple[str, str]:
    name, leaf = rest[0], rest[-1]
    if name in ("ln1", "ln2", "lnq", "lnk", "lnv"):
        return f"{prefix}.{name}.{leaf}", "vec"
    if name in ("drop_path_attn", "drop_path_mlp"):
        return f"{prefix}.{name}.scale", "vec"
    if name in ("mlp_fc1", "mlp_fc2"):
        idx = 0 if name == "mlp_fc1" else 3
        return f"{prefix}.mlp.{idx}.{_wb(leaf)}", "conv1x1" if leaf == "kernel" else "vec"
    if name == "attn":
        sub = rest[1]
        if sub in ("query_conv", "key_conv", "value_conv"):
            return f"{prefix}.attn.{sub}.conv.weight", "conv"
        if sub in ("query_norm", "key_norm", "value_norm"):
            return f"{prefix}.attn.{sub}.{leaf}", "vec"
        if sub in ("query", "key", "value", "proj"):
            return f"{prefix}.attn.{sub}.{_wb(leaf)}", \
                "conv1x1" if leaf == "kernel" else "vec"
        if sub in ("rel_pe", "time_weighting"):
            return f"{prefix}.attn.{sub}", sub
    raise KeyError(f"unmapped block param {prefix} {rest}")


def torch_name(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax path (no ``params`` head) -> (reference name, layout kind)."""
    p, leaf = path, path[-1]
    conv = "conv" if leaf == "kernel" else "vec"
    if p[0] == "interpolator":
        name = p[1]
        if re.fullmatch(r"down_\d", name):
            return f"interpolator.contraction.{name}.conv_block.conv.{_wb(leaf)}", conv
        if re.fullmatch(r"up_\d", name):
            return (f"interpolator.expansion.{name}.conv_transpose.conv.{_wb(leaf)}",
                    "convT" if leaf == "kernel" else "vec")
        if name in ("cls_conv0", "seg_conv0"):
            return "interpolator.conv0.0.weight", "conv1x1"
        if name in ("seg_linear", "cls_linear1"):
            return f"interpolator.{name}.{_wb(leaf)}", "linear" if leaf == "kernel" else "vec"
        if name == "cls_fc1":
            return "interpolator.conv1.weight", "linear"
        if name == "cls_ln":
            return f"interpolator.bn1.{leaf}", "vec"
        if name == "cls_fc2":
            return f"interpolator.conv2.{_wb(leaf)}", "linear" if leaf == "kernel" else "vec"
    elif p[0] == "backbone":
        name = p[1]
        if name == "embed":
            m = re.fullmatch(r"embd_(\d+)", p[2])
            if m:
                return f"backbone.embd.{m.group(1)}.conv.{_wb(leaf)}", conv
            m = re.fullmatch(r"embd_norm_(\d+)", p[2])
            if m:
                return f"backbone.embd_norm.{m.group(1)}.{leaf}", "vec"
            m = re.fullmatch(r"proj_(\d+)", p[2])
            if m:
                return f"backbone.proj.{m.group(1)}.conv.{_wb(leaf)}", conv
        if name == "res_self_attn":
            return _block("backbone.resselfattention", p[2:])
        m = re.fullmatch(r"(stem|branch|lh_branch|hh_branch)_(\d+)", name)
        if m:
            pre = f"backbone.{m.group(1)}.{m.group(2)}"
            if p[2] in ("conv1", "conv2", "downsample"):        # the conv backbone's ConvBlock
                return f"{pre}.{p[2]}.conv.{_wb(leaf)}", conv
            return _block(pre, p[2:])
    elif p[0] == "neck":
        for pat, ref in ((r"lateral_(\d+)", "lateral_convs"),
                         (r"fpn_conv_(\d+)", "fpn_convs")):
            m = re.fullmatch(pat, p[1])
            if m:
                return f"neck.{ref}.{m.group(1)}.conv.{_wb(leaf)}", conv
        m = re.fullmatch(r"fpn_norm_(\d+)", p[1])
        if m:
            return f"neck.fpn_norms.{m.group(1)}.{leaf}", "vec"
    elif p[0] in ("cls_head", "reg_head"):
        m = re.fullmatch(r"head_(\d+)", p[1])
        if m:
            return f"{p[0]}.head.{m.group(1)}.conv.{_wb(leaf)}", conv
        m = re.fullmatch(r"norm_(\d+)", p[1])
        if m:
            return f"{p[0]}.norm.{m.group(1)}.{leaf}", "vec"
        if p[1] in ("cls_head", "offset_head"):
            return f"{p[0]}.{p[1]}.conv.{_wb(leaf)}", conv
        m = re.fullmatch(r"scale_(\d+)", p[1])
        if m:
            return f"reg_head.scale.{m.group(1)}.scale", "vec"
    raise KeyError(f"unmapped param {path}")


_LAYOUT = {
    "conv": lambda w: np.transpose(w, (2, 1, 0)),          # (k, in/g, out) -> (out, in/g, k)
    "convT": lambda w: np.transpose(w, (1, 2, 0)),         # (k, in, out) -> (in, out, k)
    "conv1x1": lambda w: np.transpose(w)[:, :, None],      # (in, out) -> (out, in, 1)
    "linear": np.transpose,                                # (in, out) -> (out, in)
    "conv3d": lambda w: np.transpose(w, (4, 3, 0, 1, 2)),  # (kt, kh, kw, in/g, out) -> (out, in/g, kt, kh, kw)
    "flat": lambda w: np.reshape(w, (-1,)),                # class token (1, 1, C) -> (C,)
    # BYOL-A: flax NHWC conv over (time, mel) -> torch's (out, in, mel, time)
    "conv2d_tm": lambda w: np.transpose(w, (3, 2, 1, 0)),
    "vec": lambda w: w,
    "rel_pe": lambda w: np.reshape(w, (1, 1) + w.shape),    # (H, W) -> (1, 1, H, W)
    "time_weighting": lambda w: np.reshape(w, (1,) + w.shape),   # (H, W) -> (1, H, W)
}


def state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """Flax tree of the whole localizer -> torch state dict. A tree whose
    recovery module holds ``seg_linear`` is the THE variant's: its names go
    under ``segmentandCls.``, the reference's attribute."""
    if set(params) == {"params"}:
        params = params["params"]
    sd = _state_dict(params, torch_name)
    if "seg_linear" not in params.get("interpolator", {}):
        return sd
    head = "interpolator."
    return {"segmentandCls." + n[len(head):] if n.startswith(head) else n: v
            for n, v in sd.items()}


def train_state_from_flax(state, flax_state: Dict):
    """Load a JAX ``TrainState`` into the port's ``state`` (AdamW), in place.

    ``flax_state`` holds numpy values: ``params`` and ``ema_params`` (flax
    trees), ``mu`` and ``nu`` (the Adam moment trees of optax's
    ``ScaleByAdamState``, shaped like ``params``), ``count`` (its step
    count), ``loss_normalizer`` and ``step``. Returns ``state``."""
    model, inner = state.model, state.tx.inner
    if not isinstance(inner, torch.optim.AdamW):
        raise NotImplementedError("train_state_from_flax carries AdamW moments only")
    model.load_state_dict(state_dict_from_flax(flax_state["params"]), strict=True)
    device = next(model.parameters()).device
    ema = state_dict_from_flax(flax_state["ema_params"])
    mu = state_dict_from_flax(flax_state["mu"])
    nu = state_dict_from_flax(flax_state["nu"])
    with torch.no_grad():
        for name, p in model.named_parameters():
            state.ema_params[name].copy_(ema[name])
            inner.state[p] = {
                "step": torch.tensor(float(flax_state["count"])),
                "exp_avg": mu[name].to(device),
                "exp_avg_sq": nu[name].to(device),
            }
    state.step = int(flax_state["step"])
    state.loss_normalizer = torch.tensor(float(flax_state["loss_normalizer"]), device=device)
    return state


def block_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """Flax subtree of one TransformerBlock -> its state dict, names relative
    to the block (``lnq.weight``, ``attn.query_conv.conv.weight``, ...)."""
    out = {}
    for path, value in _flatten(params):
        name, kind = _block("", path)
        out[name[1:]] = _tensor(kind, value)
    return out


def _tensor(kind: str, value) -> torch.Tensor:
    return torch.from_numpy(np.array(_LAYOUT[kind](np.asarray(value, np.float32))))


def _mvit_name(path: Tuple[str, ...]) -> Tuple[str, str]:
    """MViT flax path -> (torchvision name, layout kind)."""
    name, leaf = path[0], path[-1]
    ln_leaf = "weight" if leaf == "scale" else "bias"
    if name == "conv_proj":
        return f"conv_proj.{_wb(leaf)}", "conv3d" if leaf == "kernel" else "vec"
    if name == "class_token":
        return "pos_encoding.class_token", "flat"
    if name == "norm":
        return f"norm.{ln_leaf}", "vec"
    m = re.fullmatch(r"block_(\d+)", name)
    if m:
        pre = f"blocks.{m.group(1)}"
        sub = path[1]
        if sub in ("norm1", "norm2"):
            return f"{pre}.{sub}.{ln_leaf}", "vec"
        if sub in ("project", "mlp_fc1", "mlp_fc2"):
            ref = {"project": "project", "mlp_fc1": "mlp.0", "mlp_fc2": "mlp.3"}[sub]
            return f"{pre}.{ref}.{_wb(leaf)}", "linear" if leaf == "kernel" else "vec"
        if sub == "attn":
            mod = path[2]
            if mod in ("qkv", "proj"):
                ref = "qkv" if mod == "qkv" else "project"
                return f"{pre}.attn.{ref}.{_wb(leaf)}", \
                    "linear" if leaf == "kernel" else "vec"
            if mod in ("pool_q", "pool_k", "pool_v"):
                if path[3] == "pool":
                    return f"{pre}.attn.{mod}.pool.weight", "conv3d"
                return f"{pre}.attn.{mod}.norm_act.0.{ln_leaf}", "vec"
            if mod in ("rel_pos_h", "rel_pos_w", "rel_pos_t"):
                return f"{pre}.attn.{mod}", "vec"
    raise KeyError(f"unmapped MViT param {path}")


def mvit_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """Flax tree of a JAX ``MViTVideoEncoder`` -> state dict under
    torchvision's names, the ones ``convert_mvit_torch`` reads, so
    ``convert_mvit_torch(mvit_state_dict_from_flax(p), p)`` returns ``p``."""
    return _state_dict(params, _mvit_name)


def _byola_name(path: Tuple[str, ...]) -> Tuple[str, str]:
    """BYOL-A flax path -> (AudioNTT2020Task6 name, layout kind)."""
    blk, leaf = path[0], path[-1]
    if blk in ("block0", "block1", "block2"):
        i = 4 * int(blk[-1])
        if path[1] == "conv":
            return f"features.{i}.{_wb(leaf)}", "conv2d_tm" if leaf == "kernel" else "vec"
        key = {"bn_mean": "running_mean", "bn_var": "running_var",
               "bn_scale": "weight", "bn_bias": "bias"}[path[1]]
        return f"features.{i + 1}.{key}", "vec"
    if blk in ("fc1", "fc2"):
        return f"fc.{0 if blk == 'fc1' else 3}.{_wb(leaf)}", \
            "linear" if leaf == "kernel" else "vec"
    raise KeyError(f"unmapped BYOL-A param {path}")


_AUD = "modality_encoders.AUDIO"


def _emotion_name(path: Tuple[str, ...]) -> Tuple[str, str]:
    """Emotion2Vec flax path -> (fairseq name, layout kind)."""
    name, leaf = path[0], path[-1]
    ln_leaf = "weight" if leaf == "scale" else "bias"
    lin = "linear" if leaf == "kernel" else "vec"
    if name == "local_encoder":
        i = int(path[1].split("_")[1])
        if path[1].startswith("conv_"):
            return f"{_AUD}.local_encoder.conv_layers.{i}.0.weight", "conv"
        return f"{_AUD}.local_encoder.conv_layers.{i}.2.1.{ln_leaf}", "vec"
    if name == "proj_ln":
        return f"{_AUD}.project_features.1.{ln_leaf}", "vec"
    if name == "proj":
        return f"{_AUD}.project_features.2.{_wb(leaf)}", lin
    if name.startswith("pos_conv_"):
        i = int(name.split("_")[2])
        return f"{_AUD}.relative_positional_encoder.{i + 1}.0.{_wb(leaf)}", \
            "conv" if leaf == "kernel" else "vec"
    if name == "prenet_norm":
        return f"{_AUD}.context_encoder.norm.{ln_leaf}", "vec"
    if name in ("extra_tokens", "alibi_scale"):
        return f"{_AUD}.{name}", "vec"
    if name.startswith("prenet_") or name.startswith("block_"):
        i = int(name.split("_")[1])
        ref = f"{_AUD}.context_encoder.blocks.{i}" if name.startswith("prenet_") \
            else f"blocks.{i}"
        sub = path[1]
        if sub == "attn":
            return f"{ref}.attn.{path[2]}.{_wb(leaf)}", lin
        if sub in ("norm1", "norm2"):
            return f"{ref}.{sub}.{ln_leaf}", "vec"
        if sub in ("mlp_fc1", "mlp_fc2"):
            return f"{ref}.mlp.{sub[4:]}.{_wb(leaf)}", lin
    raise KeyError(f"unmapped Emotion2Vec param {path}")


def _state_dict(params: Dict, name_of) -> Dict[str, torch.Tensor]:
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, value in _flatten(params):
        name, kind = name_of(path)
        out[name] = _tensor(kind, value)
    return out


def byola_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """Flax tree of a JAX ``AudioNTT2020`` -> state dict under the original
    model's names, so ``convert_byola_torch`` of the result returns the tree.
    (A torch BatchNorm's ``num_batches_tracked`` has no counterpart: load
    with ``strict=False``.)"""
    return _state_dict(params, _byola_name)


def emotion2vec_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """Flax tree of a JAX ``Emotion2Vec`` -> state dict under fairseq's
    names, the ones ``convert_emotion2vec_torch`` reads."""
    return _state_dict(params, _emotion_name)
