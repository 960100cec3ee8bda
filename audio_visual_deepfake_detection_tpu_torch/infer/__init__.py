from .decode import decode_and_postprocess  # noqa: F401
from .results import generate_results  # noqa: F401
from .resume import atomic_write_json, collect_done, flush_files, plan_host_share  # noqa: F401
from .runner import (  # noqa: F401
    build_inference_fn,
    build_online_inference_fn,
    collate_infer_varlen,
    collate_streams,
    host_feats,
    inference_one_epoch,
    items_to_table,
    results_to_items,
)
from .service import Detections, LocalizerService  # noqa: F401
