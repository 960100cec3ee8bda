"""Build what the port compiles and run its programs once, ahead of the first
real call (the port's counterpart of the root ``warmup_cache.py``, with its
arguments):

    python -m audio_visual_deepfake_detection_tpu_torch.cli.warmup CONFIG \\
        [--infer-batch 64 512] [--train-batch B ...] [--device cuda|cpu]

On the card it first builds the CUDA kernel library (``ops/kernels/build.py``:
one nvcc per ``csrc/*.cu``) or finds it built, and prints which with the
build's seconds. Then it builds or finds every host library the port
compiles with g++ (``runtime/host_{resample,match,nms}.py``, and
``runtime/host_media.py`` where the libav* headers are; where they are not,
it prints the reason ``host_media`` gives, and the media decode takes its
cv2 / ffmpeg route as it always does there). Then, like the JAX script, it
runs one inference forward of the config's seeded localizer at each
``--infer-batch`` (``infer/runner.py::build_inference_fn`` on zero
features) and one training step at each ``--train-batch`` (zero features, a
fixed segment), and prints the seconds each took and the kernel launches it
made.

What persists across processes is the built libraries, under ``build/`` at
the repository root, keyed by a hash of their sources and flags. Nothing
else does: PyTorch compiles no program ahead here, so the forwards and steps
only show that the config runs and what its first call costs (the CUDA
context, cuBLAS / cuDNN handles, the allocator's pools), all of which a new
process pays again.

The run is on the card unless ``--device cpu`` asks for the CPU; without a
card or without nvcc, ``--device cuda`` raises. On the CPU there is no
kernel library to build: every kernel runs its plain version there.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from ..core.config import arch_config_from, load_config, test_config_from
from ..core.runtime import entry_device
from ..infer.runner import build_inference_fn
from ..ops import kernels
from ..runtime import host_match, host_media, host_nms, host_resample, native
from ..train import TrainState, build_train_step, init_model, make_optimizer

HOST_LIBRARIES = {"resample": host_resample, "match": host_match, "nms": host_nms,
                  "media": host_media}


def launches() -> Dict[str, int]:
    """The kernels launched since the last ``kernels.reset_launches``, by name."""
    return {name: n for name, n in kernels.launch_counts().items() if n}


def build_kernels() -> Dict:
    """The CUDA kernel library, built or found. Raises where nvcc fails or
    is missing."""
    from ..ops.kernels import build

    found = build.library_path().exists()
    t0 = time.perf_counter()
    build.load()
    out = {"state": "found" if found else "built", "path": str(build.library_path()),
           "seconds": time.perf_counter() - t0, "build_seconds": build.BUILD_SECONDS}
    print(f"kernel library {out['state']}: {out['path']} (BUILD_SECONDS "
          f"{build.BUILD_SECONDS})", flush=True)
    return out


def build_host_libraries() -> Dict[str, Dict]:
    """Every host library, built or found; ``media`` is ``unavailable`` with
    its reason where the libav* headers are not found."""
    out = {}
    for name, mod in HOST_LIBRARIES.items():
        if mod is host_media and not host_media.available():
            out[name] = {"state": "unavailable", "reason": host_media.unavailable_reason()}
            print(f"host library {name} unavailable: {out[name]['reason']}", flush=True)
            continue
        path = native.library_path(native.CSRC / f"{name}.cpp", mod.FLAGS,
                                   getattr(mod, "LINK_FLAGS", ()))
        found = path.exists()
        t0 = time.perf_counter()
        mod.load()
        out[name] = {"state": "found" if found else "built", "path": str(path),
                     "seconds": time.perf_counter() - t0}
        print(f"host library {name} {out[name]['state']}: {path} "
              f"({out[name]['seconds']:.2f} s)", flush=True)
    return out


def run(args: argparse.Namespace) -> Dict:
    """Returns what was built and, per batch, the seconds and launches."""
    device = entry_device(args.device)
    summary: Dict = {"device": device.type, "infer": {}, "train": {}}
    if device.type == "cuda":
        summary["kernels"] = build_kernels()
    summary["host"] = build_host_libraries()
    config = load_config(args.config)
    cfg = arch_config_from(config)
    test_cfg = test_config_from(config)
    seed = config["init_rand_seed"]
    t_len, c_in = cfg.max_seq_len, cfg.input_dim

    for batch in args.infer_batch:
        t0 = time.perf_counter()
        kernels.reset_launches()
        model, _ = init_model(cfg, seed, device)
        fn = build_inference_fn(cfg, test_cfg)
        feats = torch.zeros((batch, t_len, c_in), device=device)
        mask = torch.ones((batch, t_len), dtype=torch.bool, device=device)
        ones = torch.ones((batch,), device=device)
        out = fn(model.eval(), feats, mask, ones * 25.0, ones * 9.6, ones * 0.3, ones * 0.3)
        out[1].cpu()
        took = time.perf_counter() - t0
        summary["infer"][batch] = {"seconds": took, "launches": launches()}
        print(f"inference B={batch} ready in {took:.1f}s, launches "
              f"{summary['infer'][batch]['launches']}", flush=True)
        del model, out

    for batch in args.train_batch:
        t0 = time.perf_counter()
        kernels.reset_launches()
        model, generator = init_model(cfg, seed, device)
        tc = config["train_cfg"]
        tx, _ = make_optimizer(model, config["opt"], 1000, tc["clip_grad_l2norm"])
        state = TrainState.create(model, tx, tc["init_loss_norm"], generator)
        step = build_train_step(cfg, tc)
        b = {
            "feats": torch.zeros((batch, t_len, c_in), device=device),
            "mask": torch.ones((batch, t_len), dtype=torch.bool, device=device),
            "gt_segments": torch.tensor([[[10.0, 30.0]]], device=device).repeat(batch, 1, 1),
            "gt_labels": torch.zeros((batch, 1), dtype=torch.int32, device=device),
            "gt_valid": torch.ones((batch, 1), dtype=torch.bool, device=device),
            "has_gt": torch.ones((batch,), dtype=torch.bool, device=device),
        }
        state, losses = step(state, b)
        loss = float(losses["final_loss"])          # waits for the step
        took = time.perf_counter() - t0
        summary["train"][batch] = {"seconds": took, "launches": launches(),
                                   "final_loss": loss}
        print(f"train B={batch} ready in {took:.1f}s, final_loss {loss:.4f}, launches "
              f"{summary['train'][batch]['launches']}", flush=True)
        del state, model
    return summary


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Build the port's libraries and run its "
                                                 "programs once")
    parser.add_argument("config", type=str)
    parser.add_argument("--infer-batch", type=int, nargs="*", default=[64, 512])
    parser.add_argument("--train-batch", type=int, nargs="*", default=[])
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; never falls back to the CPU")
    return parser


def main(argv: Optional[List[str]] = None) -> Dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
