"""Merge shard outputs into the submission files (the port's counterpart of
the root ``generate_results.py``): prediction.txt (video level) and
prediction.json (segments of score > 0.2, else the [[0, 0, 0]] sentinel).

    python -m audio_visual_deepfake_detection_tpu_torch.cli.generate_results \\
        OUTPUT_FOLDER [--num-shards N]
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

from ..infer.results import generate_results


def main(argv: Optional[List[str]] = None) -> Tuple[int, int]:
    parser = argparse.ArgumentParser(description="Submission files")
    parser.add_argument("base_folder", help="folder holding the shard folders 1..N")
    parser.add_argument("--num-shards", type=int, default=7)
    args = parser.parse_args(argv)
    n_txt, n_json = generate_results(args.base_folder, args.num_shards)
    print(f"prediction.txt: {n_txt} videos, prediction.json: {n_json} videos")
    return n_txt, n_json


if __name__ == "__main__":
    main()
