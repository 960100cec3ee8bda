from .challenge import build_proposal_json, run_evaluation  # noqa: F401
from .detection import (  # noqa: F401
    ANETdetection,
    CHALLENGE_TIOUS,
    average_precision,
    average_recall_vs_nr_proposals,
    interpolated_prec_rec,
    postprocess_results_with_cls,
    remove_duplicate_annotations,
    results_to_array,
    segment_iou,
    topkx_recall,
)
from .io import load_gt_seg_from_json, load_pred_seg_from_json  # noqa: F401
