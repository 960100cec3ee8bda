from .decode import decode_and_postprocess  # noqa: F401
from .runner import build_inference_fn, results_to_items  # noqa: F401
from .service import Detections, LocalizerService  # noqa: F401
