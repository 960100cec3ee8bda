"""Jax-free static configs over the JAX package's YAML dicts.

``ArchConfig`` / ``TestConfig`` mirror ``models/meta_arch.py::ArchConfig``
and ``infer/decode.py::TestConfig`` of the JAX package field for field, so
one loaded YAML dict configures both packages. The YAML loader itself
(``core/config.py::load_config``) is jax-free host code of the JAX package
and is imported only when a dict has to be read.

The port covers the production localizer, ``av_recovery_norecon`` with the
HRLR backbone and the FPN neck. Anything else raises NotImplementedError
naming the ROADMAP item that will port it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

_LATER = "queue 1 item 10 of ROADMAP.md ('The rest')"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    variant: str = "av_recovery_norecon"
    backbone_type: str = "hrlr"
    fpn_type: str = "fpn"
    input_dim: int = 3072
    num_classes: int = 1
    max_seq_len: int = 768
    arch: Tuple[int, int, int] = (2, 2, 5)
    scale_factor: int = 2
    regression_range: Tuple[Tuple[float, float], ...] = (
        (0, 4), (4, 8), (8, 16), (16, 32), (32, 64), (64, 10000))
    n_head: int = 4
    mha_win_size: Tuple[int, ...] = (7, 7, 7, 7, 7, -1)
    embd_kernel_size: int = 3
    embd_dim: int = 256
    embd_with_ln: bool = True
    fpn_dim: int = 256
    fpn_with_ln: bool = True
    fpn_start_level: int = 0
    head_dim: int = 256
    head_kernel_size: int = 3
    head_num_layers: int = 3
    head_with_ln: bool = True
    max_buffer_len_factor: float = 1.0
    use_abs_pe: bool = True
    use_rel_pe: bool = False
    use_time_weight: bool = False
    dropout: float = 0.0
    droppath: float = 0.1
    cls_prior_prob: float = 0.01
    head_empty_cls: Tuple[int, ...] = ()
    compute_dtype: str = "float32"          # float32 | bfloat16
    remat: bool = False
    remat_policy: str = ""

    def __post_init__(self):
        if self.variant != "av_recovery_norecon":
            raise NotImplementedError(
                f"variant {self.variant!r}: only av_recovery_norecon is "
                f"ported; see {_LATER}")
        if self.backbone_type != "hrlr" or self.fpn_type != "fpn":
            raise NotImplementedError(
                f"backbone {self.backbone_type!r} / neck {self.fpn_type!r}: "
                f"only hrlr + fpn are ported; see {_LATER}")
        if self.use_rel_pe or self.use_time_weight:
            raise NotImplementedError(
                f"use_rel_pe / use_time_weight are not ported; see {_LATER}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")

    @property
    def fpn_strides(self) -> Tuple[int, ...]:
        return tuple(self.scale_factor ** i
                     for i in range(self.fpn_start_level, self.arch[-1] + 1))

    @property
    def fpn_lens(self) -> Tuple[int, ...]:
        return tuple(self.max_seq_len // s for s in self.fpn_strides)

    @property
    def max_div_factor(self) -> int:
        """Padding granularity of eval inputs, lifted to a multiple of the
        interpolator's 32x downsampling (JAX ``ArchConfig.max_div_factor``)."""
        m = 1
        for s, w in zip(self.fpn_strides, self.mha_win_size):
            stride = s * (w // 2) * 2 if w > 1 else s
            assert self.max_seq_len % stride == 0, \
                "max_seq_len must be divisible by fpn stride * window size"
            m = max(m, stride)
        return m * 32 // math.gcd(m, 32)


@dataclasses.dataclass(frozen=True)
class TestConfig:
    __test__ = False  # not a pytest class

    pre_nms_thresh: float = 0.001
    pre_nms_topk: int = 5000
    nms_pre_topk: int = 0
    iou_threshold: float = 0.1
    min_score: float = 0.01
    max_seg_num: int = 1000
    nms_method: str = "soft"      # soft | hard | none
    nms_sigma: float = 0.5
    duration_thresh: float = 0.05
    multiclass_nms: bool = True
    voting_thresh: float = 0.75
    ext_score_file: str | None = None


def load_config(path: str) -> Dict[str, Any]:
    """The JAX package's YAML loader (defaults tree + propagation)."""
    from audio_visual_deepfake_detection_tpu.core.config import load_config as _load

    return _load(path)


def arch_config_from(config: Dict) -> ArchConfig:
    from audio_visual_deepfake_detection_tpu.core.config import (
        BACKBONE_NAME_MAP, MODEL_NAME_TO_VARIANT)

    m = config["model"]
    tc = config["train_cfg"]
    win = m["n_mha_win_size"]
    arch = tuple(m["backbone_arch"])
    if isinstance(win, int):
        win = [win] * (1 + arch[-1])
    tpu = config.get("tpu", {})
    return ArchConfig(
        variant=MODEL_NAME_TO_VARIANT[config["model_name"]],
        backbone_type=BACKBONE_NAME_MAP.get(m["backbone_type"], m["backbone_type"]),
        fpn_type=m["fpn_type"],
        input_dim=m["video_input_dim"] + m["audio_input_dim"],
        num_classes=m["num_classes"],
        max_seq_len=m["max_seq_len"],
        arch=arch,
        scale_factor=m["scale_factor"],
        regression_range=tuple(tuple(r) for r in m["regression_range"]),
        n_head=m["n_head"],
        mha_win_size=tuple(win),
        embd_kernel_size=m["embd_kernel_size"],
        embd_dim=m["embd_dim"],
        embd_with_ln=m["embd_with_ln"],
        fpn_dim=m["fpn_dim"],
        fpn_with_ln=m["fpn_with_ln"],
        fpn_start_level=m["fpn_start_level"],
        head_dim=m["head_dim"],
        head_kernel_size=m["head_kernel_size"],
        head_num_layers=m["head_num_layers"],
        head_with_ln=m["head_with_ln"],
        max_buffer_len_factor=m["max_buffer_len_factor"],
        use_abs_pe=m["use_abs_pe"],
        use_rel_pe=m["use_rel_pe"],
        dropout=tc["dropout"],
        droppath=tc["droppath"],
        cls_prior_prob=tc["cls_prior_prob"],
        head_empty_cls=tuple(tc["head_empty_cls"]),
        compute_dtype=tpu.get("compute_dtype", "float32"),
        remat=tpu.get("remat", False),
        remat_policy=tpu.get("remat_policy", ""),
    )


def test_config_from(config: Dict) -> TestConfig:
    t = config["test_cfg"]
    return TestConfig(
        pre_nms_thresh=t["pre_nms_thresh"],
        pre_nms_topk=t["pre_nms_topk"],
        iou_threshold=t["iou_threshold"],
        min_score=t["min_score"],
        max_seg_num=t["max_seg_num"],
        nms_method=t["nms_method"],
        nms_sigma=t["nms_sigma"],
        duration_thresh=t["duration_thresh"],
        multiclass_nms=t["multiclass_nms"],
        voting_thresh=t["voting_thresh"],
        ext_score_file=t.get("ext_score_file"),
        nms_pre_topk=t.get("nms_pre_topk", 0),
    )
