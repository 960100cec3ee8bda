"""Entry points, run as ``python -m audio_visual_deepfake_detection_tpu_torch.cli.<name>``:
``inference`` (a shard -> JSON flushes), ``validate`` (a labelled split ->
mAP) and ``generate_results`` (the shards -> submission files)."""
