"""Row counts the dataset keeps from the audio feature streams (JAX
``data/metadata.py``; numpy-free host arithmetic).

The reference dataset truncates each audio feature file to the rows its
video's duration accounts for: ``int(rate * duration - offset)``.
"""

from __future__ import annotations

BYOLA_FPS = 12.497
EMOTION_FPS = 50.0
BYOLA_TRUNC_OFFSET = 0.3657
EMOTION_TRUNC_OFFSET = 0.817


def byola_trunc_rows(duration: float) -> int:
    """Rows kept from a BYOL-A feature file."""
    return int(BYOLA_FPS * duration - BYOLA_TRUNC_OFFSET)


def emotion_trunc_rows(duration: float) -> int:
    """Rows kept from an Emotion2Vec feature file."""
    return int(EMOTION_FPS * duration - EMOTION_TRUNC_OFFSET)
