from .decode import decode_and_postprocess  # noqa: F401
from .runner import (  # noqa: F401
    build_inference_fn,
    build_online_inference_fn,
    collate_streams,
    results_to_items,
)
from .service import Detections, LocalizerService  # noqa: F401
