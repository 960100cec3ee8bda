"""Feature frontends: the MViT-v2 video encoder and its input pipeline."""
