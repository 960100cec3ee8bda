"""Hand-written CUDA kernels, each beside its plain PyTorch version.

Each wrapper module counts the launches of its kernel (``LAUNCHES``; K1 and
K6 share ``fused_block`` and count apart, K6 in ``TRAIN_LAUNCHES``), and only
where it launches it: ``launch_counts`` reads them all by kernel name,
``reset_launches`` sets them to 0."""

from __future__ import annotations

from typing import Dict

KERNELS = ("fused_transformer_block", "patch_embed", "pooled_attention", "multiscale_block",
           "conv_extractor", "full_mha", "fused_transformer_block_train", "band_attention")


def _counters():
    """Kernel name -> (wrapper module, its counter's name), imported at the
    call: the wrappers import nothing heavy, but this package imports none
    of them by itself."""
    from . import (band_attention, conv_extractor, full_attention, fused_block,
                   mvit_attention, mvit_block, patch_embed)

    mods = (fused_block, patch_embed, mvit_attention, mvit_block, conv_extractor,
            full_attention, fused_block, band_attention)
    return {name: (m, "TRAIN_LAUNCHES" if name == "fused_transformer_block_train"
                   else "LAUNCHES") for name, m in zip(KERNELS, mods)}


def reset_launches() -> None:
    for m, _ in _counters().values():
        m.reset_launches()


def launch_counts() -> Dict[str, int]:
    return {name: getattr(m, attr) for name, (m, attr) in _counters().items()}
