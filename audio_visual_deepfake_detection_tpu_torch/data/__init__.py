from . import metadata  # noqa: F401
from .dataset import (  # noqa: F401
    DATASET_STREAMS,
    CorruptFeatureError,
    DeepfakeDataset,
    DeepfakeInferenceDataset,
    StreamSpec,
    collate_batch,
    collate_train_streams,
    frame_labels_from_segments,
    linear_resample_np,
    resample_concat_np,
)
from .loader import DataLoader  # noqa: F401
from .truncate import draw_truncate_window, truncate_feats  # noqa: F401
