"""A checkpoint of the reference PyTorch repo (``epoch_NNN.pth.tar``) as a
checkpoint of this port (the counterpart of the root
``convert_checkpoint.py``):

    python -m audio_visual_deepfake_detection_tpu_torch.cli.convert_checkpoint \\
        CONFIG epoch_010.pth.tar [--output converted_ckpt] [--epoch 0]

The port's modules keep the reference's state-dict names, so the weights
load as they are: ``state_dict`` (raw) and ``state_dict_ema`` (EMA; the raw
weights stand in where the file has none), without DataParallel's
``module.`` prefix, each into the localizer the config describes: every
parameter the model holds must be there with its shape, and what the model
does not hold is left out, as the JAX package's converter leaves it (the
reference's no-recon model carries its unused expansion, the THE head an
unused ``bn1``). Each variant keeps the reference's own prefixes:
``interpolator.`` with ``expansion.up_*.conv_transpose.conv`` for
``av_recovery``, ``segmentandCls.`` for ``av_recovery_the``.
The result, ``<output>/epoch_<epoch>.pt``, is a training start
(``train.checkpoint.save_weights``: a fresh optimizer, step 0, the
normalizer at ``init_loss_norm``) that ``cli/inference.py --ckpt`` and
``cli/validate.py`` read. The file is read with ``weights_only=True``: a
checkpoint cannot run code. Host work only; nothing runs on a device.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from ..core.config import arch_config_from, load_config
from ..models.meta_arch import AVLocalizer
from ..train.checkpoint import save_weights


def reference_state_dicts(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"params": raw, "ema_params": EMA}`` state dicts of a reference
    checkpoint, ``module.`` prefixes stripped."""
    blob = torch.load(path, map_location="cpu", weights_only=True)

    def strip(sd):
        return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}

    raw = strip(blob["state_dict"])
    return {"params": raw, "ema_params": strip(blob.get("state_dict_ema", raw))}


def convert(config_path: str, torch_ckpt: str, output: str, epoch: int = 0) -> str:
    """Returns the file written."""
    config = load_config(config_path)
    cfg = arch_config_from(config)
    model = AVLocalizer(cfg)
    held = set(model.state_dict())
    sds = {key: {n: v for n, v in sd.items() if n in held}
           for key, sd in reference_state_dicts(torch_ckpt).items()}
    model.load_state_dict(sds["ema_params"], strict=True)     # names and shapes checked
    model.load_state_dict(sds["params"], strict=True)
    return save_weights(output, model, config, ema_state=sds["ema_params"], epoch=epoch)


def main(argv: Optional[List[str]] = None) -> str:
    parser = argparse.ArgumentParser(description="Convert a reference checkpoint")
    parser.add_argument("config", help="config yaml describing the model")
    parser.add_argument("torch_ckpt", help="reference .pth.tar checkpoint")
    parser.add_argument("--output", default="converted_ckpt")
    parser.add_argument("--epoch", type=int, default=0)
    args = parser.parse_args(argv)
    path = convert(args.config, args.torch_ckpt, args.output, args.epoch)
    n = sum(v.numel() for v in torch.load(path, weights_only=True)["params"].values())
    print(f"converted {n / 1e6:.2f}M parameters -> {path}")
    return path


if __name__ == "__main__":
    main()
