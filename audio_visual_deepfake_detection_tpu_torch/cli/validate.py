"""Validation: inference over a labelled split and the challenge mAP at tIoU
{0.5, 0.75, 0.9, 0.95} (the port's counterpart of the root ``validate.py``).

    python -m audio_visual_deepfake_detection_tpu_torch.cli.validate \\
        CONFIG --ckpt RUN_FOLDER_OR_FILE [--device cuda|cpu]

The split is the config's ``dataset.train_txt`` list of metadata JSONs under
``dataset.json_folder``, with the feature caches beside the test set's.
``--saveonly`` pickles the flat prediction table and evaluates nothing;
``--no-ema`` takes the raw weights; ``--fusion topk`` with the test config's
``ext_score_file`` fuses external class scores (sqrt(cls x seg), top-k)
before an EPIC-style mAP. The run is on the card unless ``--device cpu``
asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import pickle
from typing import Dict, List, Optional

import numpy as np

from ..core.config import arch_config_from, load_config, test_config_from
from ..core.runtime import entry_device
from ..data import DataLoader, DeepfakeDataset
from ..eval import run_evaluation
from ..eval.detection import ANETdetection, postprocess_results_with_cls, results_to_array
from ..infer.runner import build_inference_fn, collate_infer_varlen, inference_one_epoch
from ..models.meta_arch import DTYPES
from ..train.loop import pad_batch_to
from .inference import load_localizer, resolve_checkpoint


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Validation mAP")
    parser.add_argument("config", type=str)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; never falls back to the CPU")
    parser.add_argument("--no-ema", action="store_true")
    parser.add_argument("--saveonly", action="store_true",
                        help="pickle the raw prediction table and skip the evaluation")
    parser.add_argument("--fusion", choices=["challenge", "topk"], default="challenge",
                        help="how test_cfg.ext_score_file is used: 'challenge' "
                             "multiplies by the best class score, 'topk' duplicates "
                             "segments over the top-k classes at sqrt(cls x seg)")
    parser.add_argument("--ext-topk", type=int, default=2)
    parser.add_argument("--ext-num-pred", type=int, default=200)
    parser.add_argument("--output", type=str, default="")
    parser.add_argument("-p", "--print-freq", type=int, default=20)
    return parser


def run(args: argparse.Namespace) -> Dict:
    """Returns {"mAP": average mAP x 100 (None with --saveonly), "summary":
    the evaluator's line, "results": the flat prediction table,
    "gt_records": the split's ground truth, "output": the file written}."""
    device = entry_device(args.device)
    config = load_config(args.config)
    cfg = arch_config_from(config)
    test_cfg = test_config_from(config)
    ckpt = resolve_checkpoint(args.ckpt)

    dataset = DeepfakeDataset(config["dataset_name"], False, config["val_split"],
                              config["dataset"])
    dtype, pin = DTYPES[cfg.compute_dtype], device.type == "cuda"

    def collate(samples):
        batch = collate_infer_varlen(samples, cfg.max_div_factor, cfg.max_seq_len, dtype, pin)
        batch["_gt"] = [{"video_id": s["video_id"], "n_fakes": s["n_fakes"],
                         "segments_time": s["segments_time"]} for s in samples]
        return batch

    loader = DataLoader(dataset, args.batch_size, collate, shuffle=False, drop_last=False,
                        num_workers=config["loader"]["num_workers"])
    model = load_localizer(cfg, ckpt, device, use_ema=not args.no_ema)
    infer_fn = build_inference_fn(cfg, test_cfg)
    gt_records: List[dict] = []

    def batches():
        for batch in loader:
            gt_records.extend(batch.pop("_gt"))
            yield pad_batch_to(batch, args.batch_size)

    results, _ = inference_one_epoch(batches(), infer_fn, model, output_folder=None,
                                     print_freq=args.print_freq)
    out = {"mAP": None, "summary": None, "results": results, "gt_records": gt_records}

    if args.saveonly:
        out["output"] = args.output or "eval_results.pkl"
        with open(out["output"], "wb") as f:
            pickle.dump(results, f)
        print(f"saved raw results to {out['output']} (saveonly: no evaluation)")
        return out

    if test_cfg.ext_score_file and args.fusion == "topk":
        with open(test_cfg.ext_score_file) as f:
            cls_scores = json.load(f)
        if "results" in cls_scores:
            cls_scores = cls_scores["results"]
        fused = postprocess_results_with_cls(
            results_to_array(results, num_pred=args.ext_num_pred),
            cls_scores, num_pred=args.ext_num_pred, topk=args.ext_topk)
        _, mAP_arr, _ = ANETdetection(gt_records).evaluate(fused, verbose=True)
        out["mAP"] = float(np.mean(mAP_arr)) * 100
        print(f"challenge mAP (topk-fused): {out['mAP']:.3f}")
        return out

    out["output"] = args.output or "eval_proposals.json"
    out["mAP"], _ = run_evaluation(results, gt_records, out["output"],
                                   cls_score_file=test_cfg.ext_score_file)
    with open(out["output"].replace(".json", ".txt")) as f:
        out["summary"] = f.read().splitlines()[-1]
    print(f"challenge mAP: {out['mAP']:.3f}")
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
