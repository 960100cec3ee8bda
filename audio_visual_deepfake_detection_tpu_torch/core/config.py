"""Static configs and the YAML loader (JAX ``core/config.py``).

``ArchConfig`` / ``TestConfig`` mirror ``models/meta_arch.py::ArchConfig``
and ``infer/decode.py::TestConfig`` of the JAX package field for field, and
``load_config`` is this package's own copy of the JAX package's loader (YAML
values win, a defaults tree fills the gaps, dataset dims and train/test
configs are propagated into ``config['model']``), so one YAML file
configures both packages and gives the same dict. Nothing here imports the
JAX package.

The port covers every variant of the JAX package: the three recovery
localizers with the HRLR backbone (``av_recovery_norecon``, production;
``av_recovery``, whose reconstruction feeds the backbone and an L1 loss;
``av_recovery_the``, with a frame-level segmentation head) and the legacy
``plain`` ActionFormer family (``AVLocPointTransformer`` /
``LocPointTransformer``) with the ``convTransformer`` or ``conv`` backbone,
either neck (``fpn`` or ``identity``), relative position bias and time
weighting. The recovery variants build the HRLR backbone whatever
``backbone_type`` says, as the JAX package does. ``scale_factor`` other than 2 raises NotImplementedError: the
stride-2 block is the only downsampling block the port has.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Tuple

import yaml

VARIANTS = ("av_recovery_norecon", "av_recovery", "av_recovery_the", "plain")
BACKBONES = ("hrlr", "convTransformer", "conv")
NECKS = ("fpn", "identity")


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
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.backbone_type not in BACKBONES or self.fpn_type not in NECKS:
            raise ValueError(f"backbone {self.backbone_type!r} / neck {self.fpn_type!r}: "
                             f"one of {BACKBONES} / {NECKS}")
        if self.scale_factor != 2:
            raise NotImplementedError(
                f"scale_factor {self.scale_factor}: the port downsamples by 2 only")
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
        """Padding granularity of eval inputs (JAX
        ``ArchConfig.max_div_factor``): the largest fpn stride x window
        span, lifted to a multiple of the DeepInterpolator's 32x
        downsampling for the two variants that hold one. The THE variant's
        segmentation head keeps every length (stride-1 convs)."""
        m = 1
        for s, w in zip(self.fpn_strides, self.mha_win_size):
            stride = s * (w // 2) * 2 if w > 1 else s
            assert self.max_seq_len % stride == 0, \
                "max_seq_len must be divisible by fpn stride * window size"
            m = max(m, stride)
        if self.variant in ("av_recovery", "av_recovery_norecon"):
            m = m * 32 // math.gcd(m, 32)
        return m


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


def default_config() -> Dict[str, Any]:
    return {
        "init_rand_seed": 1234567891,
        "dataset_name": "deepfake_video_audioEmoBYOLA",
        "train_split": ("train",),
        "val_split": ("dev",),
        "test_split": ("test",),
        "model_name": "AVLocPointTransformerRecoveryNoNormNorecon",
        "dataset": {
            "feat_stride": 1,
            "num_frames": 1,
            "default_fps": None,
            "video_feat_folder": None,
            "audio_feat_folder": None,
            "audio_byola_feat_folder": None,
            "audio_emo_feat_folder": None,
            "train_txt": None,
            "json_folder": None,
            "test_folder": None,
            "file_prefix": None,
            "file_ext": ".npy",
            "audio_file_ext": ".npy",
            "video_input_dim": 256,
            "audio_input_dim": 2816,
            "input_dim": 0,
            "num_classes": 1,
            "downsample_rate": 0,
            "max_seq_len": 768,
            "trunc_thresh": 0.5,
            "crop_ratio": None,
            "force_upsampling": True,
            # maximum number of GT segments per sample (static padding)
            "max_gt_segments": 32,
        },
        "loader": {
            "batch_size": 8,
            "num_workers": 4,
        },
        "model": {
            "backbone_type": "convHRLRFullResSelfAttTransformerRevised",
            "fpn_type": "fpn",
            "backbone_arch": (2, 2, 5),
            "scale_factor": 2,
            "regression_range": [(0, 4), (4, 8), (8, 16), (16, 32), (32, 64), (64, 10000)],
            "n_head": 4,
            "n_mha_win_size": [7, 7, 7, 7, 7, -1],
            "embd_kernel_size": 3,
            "embd_dim": 256,
            "embd_with_ln": True,
            "fpn_dim": 256,
            "fpn_with_ln": True,
            "fpn_start_level": 0,
            "head_dim": 256,
            "head_kernel_size": 3,
            "head_num_layers": 3,
            "head_with_ln": True,
            "max_buffer_len_factor": 1.0,
            "use_abs_pe": True,
            "use_rel_pe": False,
        },
        "train_cfg": {
            "center_sample": "radius",
            "center_sample_radius": 1.5,
            "loss_weight": 1.0,
            "cls_prior_prob": 0.01,
            "init_loss_norm": 2000,
            "clip_grad_l2norm": -1,
            "head_empty_cls": [],
            "dropout": 0.0,
            "droppath": 0.1,
            "label_smoothing": 0.0,
        },
        "test_cfg": {
            "pre_nms_thresh": 0.001,
            "pre_nms_topk": 5000,
            "iou_threshold": 0.1,
            "min_score": 0.01,
            "max_seg_num": 1000,
            "nms_method": "soft",
            "nms_sigma": 0.5,
            "duration_thresh": 0.05,
            "multiclass_nms": True,
            "ext_score_file": None,
            "voting_thresh": 0.75,
            # TPU extension (not in the reference DEFAULTS): pre-NMS top-K
            # preselect for serving latency; 0 = reference behavior
            "nms_pre_topk": 0,
        },
        "opt": {
            "type": "AdamW",
            "momentum": 0.9,
            "weight_decay": 0.0,
            "learning_rate": 1e-3,
            "epochs": 30,
            "warmup": True,
            "warmup_epochs": 5,
            "schedule_type": "cosine",
            "schedule_steps": [],
            "schedule_gamma": 0.1,
            "eta_min": 1e-8,
        },
        "output_folder": "./runs",
        "tpu": {
            # data-parallel mesh axis size; -1 = all local devices
            "dp_size": -1,
            "compute_dtype": "float32",   # float32 | bfloat16
            "remat": False,               # backbone activation checkpointing
            "remat_policy": "",           # "" | dots | dots_no_batch
            "prefetch": 2,
        },
    }


def _merge_defaults(defaults: Dict, target: Dict) -> None:
    """Fill missing keys from defaults (YAML wins, like config.py:137-143)."""
    for key, val in defaults.items():
        if key in target:
            if isinstance(val, dict) and isinstance(target[key], dict):
                _merge_defaults(val, target[key])
        else:
            target[key] = copy.deepcopy(val)


def _propagate(config: Dict) -> Dict:
    """Copy dataset dims + train/test cfg into model (config.py:149-157)."""
    model = config["model"]
    ds = config["dataset"]
    model["video_input_dim"] = ds["video_input_dim"]
    model["audio_input_dim"] = ds["audio_input_dim"]
    model["num_classes"] = ds["num_classes"]
    model["max_seq_len"] = ds["max_seq_len"]
    model["train_cfg"] = config["train_cfg"]
    model["test_cfg"] = config["test_cfg"]
    return config


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        config = yaml.safe_load(f)
    if config is None:  # empty / comments-only file -> pure defaults
        config = {}
    if not isinstance(config, dict):
        raise ValueError(
            f"config file {path!r} must be a YAML mapping, got "
            f"{type(config).__name__}")
    _merge_defaults(default_config(), config)
    return _propagate(config)


# reference model_name -> our variant tag
MODEL_NAME_TO_VARIANT = {
    "AVLocPointTransformerRecoveryNoNormNorecon": "av_recovery_norecon",
    "AVLocPointTransformerRecoveryNoNorm": "av_recovery",
    "AVLocPointTransformerRecoveryNoNormNoreconTHE": "av_recovery_the",
    "AVLocPointTransformer": "plain",
    "LocPointTransformer": "plain",
}

BACKBONE_NAME_MAP = {
    "convHRLRFullResSelfAttTransformerRevised": "hrlr",
    "convTransformer": "convTransformer",
    "conv": "conv",
}


def arch_config_from(config: Dict) -> ArchConfig:
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
