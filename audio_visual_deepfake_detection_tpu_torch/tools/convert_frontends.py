"""Loaders for the released frontend checkpoints, by their on-disk layouts
(JAX ``tools/convert_frontends.py``), into the port's encoders:

- ``alignvideo_model.ckpt``: a pytorch-lightning checkpoint of the
  AlignVideo module, ``{"state_dict": {...}, "hyper_parameters": {...}}``,
  its video encoder's weights under ``video_encoder.mvit.`` (MViT-v2,
  torchvision's names) or ``video_encoder.`` (C3D), possibly behind
  ``module.`` (DataParallel) / ``model.`` (an outer Lightning attribute)
  prefixes, possibly with a ``state_dict_ema`` twin;
- ``emotion2vec_base.pt``: a fairseq checkpoint, ``{"model": state_dict,
  "cfg": {"model": ...}}``, the architecture (depth, width, prenet depth,
  extra tokens, ALiBi, positional convs) in ``cfg.model`` and
  ``cfg.model.modalities.audio``;
- ``AudioNTT2020-BYOLA-64x96d2048.pth``: a torch state dict, possibly
  nested under ``state_dict``, whose keys the reference filters and
  re-roots with the ``(^fc\\.|\\.fc\\.|^features\\.|\\.features\\.)`` regex.

The port's modules hold the reference's state-dict names, so each loader
loads by name: it keeps the keys the module holds, ignores the rest (the
classifier head, the EMA teacher, decoders, other submodules), and loads
with ``strict=True`` on what the module holds, so that a missing or
misshapen tensor raises with its name. Each returns the module in eval mode
on ``device`` (the card unless ``device="cpu"`` is asked for), its
parameters f32 and ``dtype`` its compute dtype, as the port's constructors
take it: hand the three to ``FeatureExtractor(video_model=...,
byola_model=..., emotion_model=...)``.

The loaders take an already-loaded mapping: the caller reads the file.
``torch.load(path, weights_only=True)`` reads a file whose nodes are plain
containers; a real Lightning ``AttributeDict`` or fairseq ``DictConfig``
needs the file's own classes to unpickle. ``cfg`` nodes are read as a dict,
a Namespace or an omegaconf node alike, without importing omegaconf.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.runtime import entry_device
from ..frontends import mvit
from ..frontends.byola import AudioNTT2020
from ..frontends.emotion2vec import Emotion2Vec, Emotion2VecConfig
from ..frontends.video import C3DVideoEncoder

__all__ = [
    "strip_wrapper_prefixes",
    "unwrap_lightning",
    "load_alignvideo_checkpoint",
    "emotion2vec_config_from_fairseq",
    "load_emotion2vec_checkpoint",
    "load_byola_checkpoint",
]

MVIT_DEPTHS = {10: "mvit_v2_t", 16: "mvit_v2_s", 24: "mvit_v2_b"}
_C3D_BARE = re.compile(r"^(block\d\.\d)\.(weight|bias)$")
_BYOLA_KEY_RE = re.compile(r"(^fc\.|\.fc\.|^features\.|\.features\.)")


def _cfg_get(cfg: Any, key: str, default=None):
    """Read a field from a dict / Namespace / omegaconf node uniformly."""
    if cfg is None:
        return default
    if isinstance(cfg, Mapping):
        return cfg.get(key, default)
    return getattr(cfg, key, default)


def strip_wrapper_prefixes(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove training-wrapper prefixes (``module.`` from DataParallel,
    ``model.`` from an outer Lightning attribute, ``_orig_mod.`` from
    torch.compile) that the released checkpoints may carry. A prefix is only
    stripped when EVERY key carries it — mixed trees are left alone."""
    sd = dict(state_dict)
    for prefix in ("module.", "model.", "_orig_mod."):
        while sd and all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def unwrap_lightning(ckpt: Mapping[str, Any], use_ema: bool = False
                     ) -> Tuple[Dict[str, Any], Optional[dict]]:
    """Lightning ckpt dict -> (clean state dict, hyper_parameters or None).

    Accepts a raw state dict too (returns it unchanged with hparams None).
    ``use_ema`` prefers a ``state_dict_ema`` twin when present.
    """
    if "state_dict" in ckpt:
        sd = ckpt["state_dict_ema"] if use_ema and "state_dict_ema" in ckpt \
            else ckpt["state_dict"]
        hparams = ckpt.get("hyper_parameters") or ckpt.get("hparams") or None
        return strip_wrapper_prefixes(sd), \
            dict(hparams) if isinstance(hparams, Mapping) else hparams
    return strip_wrapper_prefixes(ckpt), None


def _as_tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def _load_by_name(model: nn.Module, sd: Mapping[str, Any], device: torch.device) -> nn.Module:
    """The entries of ``sd`` that ``model`` holds, loaded strictly; a
    BatchNorm's ``num_batches_tracked`` the file lacks keeps the module's
    own (eval never reads it). Returns the model in eval mode on
    ``device``."""
    held = model.state_dict()
    picked = {k: _as_tensor(v) for k, v in sd.items() if k in held}
    for k, v in held.items():
        if k.endswith("num_batches_tracked") and k not in picked:
            picked[k] = v
    model.load_state_dict(picked, strict=True)
    return model.to(device).eval()


def load_alignvideo_checkpoint(ckpt: Mapping[str, Any], out_dim: Optional[int] = None,
                               use_ema: bool = False, dtype=torch.float32,
                               device="cuda") -> nn.Module:
    """AlignVideo Lightning checkpoint -> the port's video encoder with its
    weights. Builds the encoder the checkpoint's ``hyper_parameters``
    describe (``v_encoder`` in {c3d, mvit_v2_t/s/b}, ``temporal_dim``,
    ``v_cla_feature_in``, ``ve_features``); without ``v_encoder`` the
    ``mvit.blocks.<i>.`` indices pick the MViT size (10 / 16 / 24 blocks),
    and a checkpoint without ``mvit.`` keys is C3D. Only the video encoder is
    read: ``forward_features`` uses nothing else."""
    device = entry_device(device)
    sd, hparams = unwrap_lightning(ckpt, use_ema=use_ema)
    enc_sd = {k[len("video_encoder."):]: v for k, v in sd.items()
              if k.startswith("video_encoder.")}
    if not enc_sd:
        raise KeyError(
            "no video_encoder.* keys found — not an AlignVideo checkpoint "
            f"(saw e.g. {sorted(sd)[:3]})")

    v_encoder = _cfg_get(hparams, "v_encoder", None)
    if v_encoder is None:  # infer from the key layout
        v_encoder = "mvit_v2_t" if any(k.startswith("mvit.") for k in enc_sd) \
            else "c3d"
    out_dim = out_dim or int(_cfg_get(hparams, "v_cla_feature_in", 256))
    temporal = int(_cfg_get(hparams, "temporal_dim", 512))

    if v_encoder.startswith("mvit"):
        # depth disambiguation when hparams are absent: count block indices
        if hparams is None or _cfg_get(hparams, "v_encoder", None) is None:
            n_blocks = 1 + max(int(m.group(1)) for k in enc_sd
                               if (m := re.match(r"mvit\.blocks\.(\d+)\.", k)))
            v_encoder = MVIT_DEPTHS.get(n_blocks, v_encoder)
        if v_encoder not in MVIT_DEPTHS.values():
            raise ValueError(f"unsupported v_encoder {v_encoder!r}")
        model = getattr(mvit, v_encoder)(out_dim=out_dim, temporal_size=temporal, dtype=dtype)
        weights = {k[len("mvit."):]: v for k, v in enc_sd.items() if k.startswith("mvit.")}
    elif v_encoder == "c3d":
        ve_features = tuple(_cfg_get(hparams, "ve_features", (64, 96, 128, 128)))
        model = C3DVideoEncoder(n_features=ve_features, out_dim=out_dim, dtype=dtype)
        # the tensorneko wrappers hold their raw conv as ``conv``; a bare
        # ``block{i}.{j}.weight`` is that conv's
        weights = {_C3D_BARE.sub(r"\1.conv.\2", k): v for k, v in enc_sd.items()}
    else:
        raise ValueError(f"unsupported v_encoder {v_encoder!r}")
    return _load_by_name(model, weights, device)


def emotion2vec_config_from_fairseq(cfg: Any) -> Emotion2VecConfig:
    """fairseq ``cfg`` node (the checkpoint's ``cfg`` entry, or ``cfg.model``
    directly) -> :class:`Emotion2VecConfig`; a missing field takes the
    config's default."""
    model_cfg = _cfg_get(cfg, "model", cfg)
    modalities = _cfg_get(model_cfg, "modalities", None)
    audio = _cfg_get(modalities, "audio", None)
    default = Emotion2VecConfig()

    def f(node, key, dflt):
        v = _cfg_get(node, key, dflt)
        return dflt if v is None else v

    return Emotion2VecConfig(
        embed_dim=int(f(model_cfg, "embed_dim", default.embed_dim)),
        depth=int(f(model_cfg, "depth", default.depth)),
        num_heads=int(f(model_cfg, "num_heads", default.num_heads)),
        mlp_ratio=float(f(model_cfg, "mlp_ratio", default.mlp_ratio)),
        norm_eps=float(f(model_cfg, "norm_eps", default.norm_eps)),
        prenet_depth=int(f(audio, "prenet_depth", default.prenet_depth)),
        num_extra_tokens=int(f(audio, "num_extra_tokens",
                               default.num_extra_tokens)),
        use_alibi=bool(f(audio, "use_alibi_encoder", default.use_alibi)),
        conv_pos_depth=int(f(audio, "conv_pos_depth", default.conv_pos_depth)),
        conv_pos_width=int(f(audio, "conv_pos_width", default.conv_pos_width)),
        conv_pos_groups=int(f(audio, "conv_pos_groups",
                              default.conv_pos_groups)),
    )


def load_emotion2vec_checkpoint(ckpt: Mapping[str, Any], dtype=torch.float32,
                                device="cuda") -> Emotion2Vec:
    """fairseq checkpoint dict (``{"model": sd, "cfg": ...}``; a bare state
    dict also works, with the default config) -> ``Emotion2Vec(cfg)`` with
    its weights. The self-distillation teacher (``_ema``) and the decoders
    the released base checkpoint carries are not held by the module, so
    they are left out."""
    device = entry_device(device)
    if "model" in ckpt and isinstance(ckpt["model"], Mapping):
        sd = strip_wrapper_prefixes(ckpt["model"])
        cfg = emotion2vec_config_from_fairseq(ckpt.get("cfg"))
    else:
        sd = strip_wrapper_prefixes(ckpt)
        cfg = emotion2vec_config_from_fairseq(None)
    return _load_by_name(Emotion2Vec(cfg, dtype=dtype), sd, device)


def load_byola_checkpoint(ckpt: Mapping[str, Any], n_mels: int = 64, d: int = 2048,
                          dtype=torch.float32, device="cuda") -> AudioNTT2020:
    """BYOL-A ``.pth`` state dict -> ``AudioNTT2020(n_mels, d)`` with its
    weights, keys normalized as the reference does: optional
    ``state_dict`` nesting, then only ``fc.*`` / ``features.*`` keys (the
    regex is searched anywhere in the key, which is re-rooted there)."""
    device = entry_device(device)
    sd = ckpt.get("state_dict", ckpt)
    weights = {}
    for k, v in sd.items():
        m = _BYOLA_KEY_RE.search(k)
        if m is None:
            continue
        new_k = k[m.start():]
        if new_k.startswith("."):
            new_k = new_k[1:]
        weights[new_k] = v
    return _load_by_name(AudioNTT2020(n_mels=n_mels, d=d, dtype=dtype), weights, device)
