#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one Hopper card.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
1. build   - nvcc-builds the port's CUDA sources (one nvcc per source, in
             parallel) into build/kernels/, prints ptxas's registers, shared
             memory and spills per kernel, the toolchain and the card's name
             and power limit; then reads the production YAML through the
             port's own loader;
2. kernels - the fused transformer-block kernel K1 against its plain PyTorch
             version (block_math), both on the card, for every production
             (mode, T, attention) combination of the HRLR backbone at the
             service batch B=16 and the main path's B=64, and a T=768 self
             block at B=512, f32 (atol 1e-4) and bf16 (atol = rtol = 2e-2),
             with partial masks and O(1) layer scales / LN affines;
3. dense   - K1 in dense mode at T = 24, 31 (whole-sequence path) and 32,
             48, 100 (tiled path), f32 and bf16; a production-width f32
             localizer forward at T = 1536 on the card against the CPU;
4. serve   - a production-width LocalizerService (3072-d input, T=768,
             C=256, 4 heads, windows (7,7,7,7,7,-1), bf16, seeded weights)
             answers requests of varied valid length; every forward must
             launch the block kernel 18 times; then f32 on 2 videos, the
             card's kernel path against the same model's plain path on the
             CPU (scores 1e-4, segments 1e-3, video_cls 2e-4);
5. mvit    - K2 (patch embed: the uint8 entry and the f32 one), K3 (pooled
             attention: the table entry at blocks 0-1 and 23, and the
             band-given entry), K4 (whole MultiscaleBlock) against their
             plain versions at every production shape of mvit_v2_b at 512
             frames, B = 2 chunks (one with a zero tail), f32 (atol 1e-4,
             rtol 5e-4) and bf16 (K3 against the f32 function of its bf16
             inputs within its rounding bound); K2 also at 128, 101 and 33
             features, K3 also with a dominant class key; K2's uint8 entry
             and K3's table entry also
             at the 32 chunks the main path hands them (f32 and bf16), K4's
             three geometries there in bf16; then the launches inside one K4
             call at 32 chunks one by one (kernel events of a trace) and the
             whole call's time;
6. audio kernels - K5 (Emotion2Vec conv extractor) against its plain version
             at B = 2, 16 and 64 on a 9.6 s wav and one with an odd tail,
             f32 and bf16, K8 (full
             attention) at (2, 12, 479 | 130 | 50, 64) and (1, 12, 2000, 64)
             with and without a padding mask and with one sample fully
             masked, f32 and bf16;
7. video   - MViT-v2-b at full width and depth, bf16, through
             FeatureExtractor.video_chunks_features on 16 uint8 chunks of
             512 frames: shape, finiteness, each kernel's launch count, every
             K3 launch the wgmma kernel with the band from the table (K3's
             band-array entry and K2's f32-frame entry raise meanwhile, so
             K2 ran its uint8 entry); f32 on a 32-frame chunk, card against
             the CPU plain path;
8. audio   - BYOL-A and Emotion2Vec at full width and depth (12 AltBlocks),
             bf16, 16 wavs of 9.6 s through FeatureExtractor: shapes,
             finiteness, K5 once and K8 twelve times; f32 on a padded pair of
             short wavs, card against the CPU plain path;
9. media -> detections - the program of bench.py::measure_e2e: 16 videos of
             240 uint8 frames and their 153,600-sample wavs through the three
             encoders, rows 240 / 119 / 479, build_online_inference_fn
             (device resample to 768, concat, the production localizer,
             decode, soft-NMS); every kernel's launch count and K2's and
             K3's routes as in phase 7, and every video gets a detection;
10. k6     - the training forward K6 (K1's kernel with per-sample droppath
             coefficients) at every production block shape at the training
             batch B=50, f32 and bf16, coefficients from {0, 1/0.9} and a
             sample of ones, against block_math at K1's tolerances; its
             gradients (B=5: autograd through block_math keeps every
             intermediate) through the autograd Function on the card against
             autograd straight through block_math on the card, and in f32
             against the CPU;
11. k7     - banded attention K7 at (50, 4, T, 64), T = 768 .. 24, w = 3,
             ragged masks, f32 (atol 1e-5) and bf16, against its plain
             version; also w = 0, 1 and 8, head dims 32 and 128, 65,600
             (sample, head) pairs and a layout the wrapper copies; the
             differentiable wrapper's gradients in f32 against the CPU;
12. train  - configs_train/deepfake_exp10.yaml through the port's loader,
             full width and depth, seeded batches in collate_batch's format.
             f32 with a deterministic forward, 2 steps at B=16, card against
             CPU (losses rtol 1e-4, grad_norm rtol 1e-3). bf16 and f32,
             stochastic, 10 steps at B=50 through train_one_epoch: finite
             losses, K6 18 launches a step and K1 none, a mid-epoch
             checkpoint written and restored, the focal sum on the fixed
             batch falls. The same with dropout 0.1 (the unfused block; 4
             steps in f32): K7 17 launches a forward, K6 and K1 none, and
             one f32 step at B=16 card against CPU with the same draws. ms
             per step, samples/s and peak GiB at B=50, a step's stages (CUDA
             events at train_step's stage hook; in the unfused step also
             around K7's forward and its backward through
             band_attention_xla) and its device time by kernel;
13. timing - K1 per production shape at B = 16, 64 and 512 (bf16), packing
             cost, service latency at batch 16, localizer-only videos/s at
             B=512 bf16 (the program of bench.py::measure_ours); K2-K4 and
             K1's dense paths against their plain versions, K2 and K3 also at
             32 chunks, with F.conv3d beside K2 and scaled_dot_product_attention
             under a [band | 0] mask, + q, beside K3; MViT-v2-b chunks/s at 16
             and 64 chunks; K5 and K8 at
             B = 2, 16, 64 (checked there too, K8 with and without a mask)
             with the eager conv stack and scaled_dot_product_attention beside
             them; BYOL-A and Emotion2Vec wavs/s; media -> detections
             videos/s at 16 and 64 videos and its per-stage breakdown; K6 per
             production shape and K7 per banded length at B=50 (also its
             device time) with scaled_dot_product_attention under a band
             mask beside K7. Each
             kernel's time stands beside its bound: the larger of its
             operations over the card's peak rate and its bytes over the
             memory rate; and what each main-path kernel costs a 64-video
             media -> detections run above that bound; K7's block size
             and blocks an SM against four alternatives built beside it;
14. offline - the offline sweep from feature caches to submission files
             and mAP through the port's CLIs (cli/inference.py,
             generate_results.py, validate.py) in this process:
             configs_test/deepfake_exp12_test.yaml in bf16, a seeded cache
             of 256 videos of 4-16 s and one of 30 s at the streams' native
             rates and widths, a checkpoint with EMA (classifier bias 0).
             Both routes cover the shard (host resample at B = 16 and 64,
             device resample at 16), K1 18 launches a forward and no plain
             block on the card, a preempted run resumed covers every video
             once with the same detections, f32 card vs CPU over 32 videos
             and host vs device resample (scores 1e-4, segments 1e-3, logit
             2e-4), the submission files, validate's mAP at four tIoUs and
             1.0 on the ground truth fed back; videos/s per route and batch,
             loader wait vs infer_fn, peak memory, a batch's stages.

The card's name and power limit, then a JSON object with the kernels'
launches, errors and times, are the two lines before the last; the last
line is {"ok": true, "device": {...}}. A full report goes to
build/chip_smoke_report.json.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
F32_ATOL = 1e-4
BF16_TOL = 2e-2       # atol and rtol, the JAX package's bf16 kernel tolerance
PROD = dict(variant="av_recovery_norecon", input_dim=3072, num_classes=1,
            max_seq_len=768, embd_dim=256, fpn_dim=256, head_dim=256, n_head=4,
            mha_win_size=(7, 7, 7, 7, 7, -1), use_abs_pe=True, droppath=0.1)
# bench.py::measure_ours test config; serving lowers min_score so the
# random-weight model keeps several detections per video
BENCH_TEST = dict(pre_nms_thresh=0.001, pre_nms_topk=2000, iou_threshold=0.1,
                  min_score=0.2, max_seg_num=100, nms_method="soft",
                  nms_sigma=0.75, duration_thresh=0.001, multiclass_nms=False,
                  voting_thresh=0.9)
# (block names, mode, T of the block's output, window): all 18 blocks
PROD_BLOCKS = [
    (["res_self_attn"], "qv_k", 768, 7),
    (["stem_0", "stem_1"], "self", 768, 7),
    (["branch_0"], "ds_self", 384, 7),
    (["branch_1"], "ds_self", 192, 7),
    (["branch_2"], "ds_self", 96, 7),
    (["branch_3"], "ds_self", 48, 7),
    (["branch_4"], "ds_self", 24, -1),
    ([f"lh_branch_{i}" for i in range(5)], "kv", 768, 7),
    (["hh_branch_0"], "kv", 384, 7),
    (["hh_branch_1"], "kv", 192, 7),
    (["hh_branch_2"], "kv", 96, 7),
    (["hh_branch_3"], "kv", 48, 7),
    (["hh_branch_4"], "kv", 24, 7),
]
REPORT = {}


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def timed(phase, *args, **kwargs):
    """Run a phase and log the seconds it took."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    took = time.perf_counter() - t0
    REPORT.setdefault("phase_seconds", {})[phase.__name__] = took
    log(f"[{phase.__name__}: {took:.1f} s]")
    return out


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unavailable"


def perturb(model, seed):
    """O(1) layer scales and LN affines: at their 1e-4 / identity init a
    wrong attention or MLP path would not show in the output."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.models.blocks import AffineDropPath
    from audio_visual_deepfake_detection_tpu_torch.ops.norm import ChannelLayerNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, AffineDropPath):
                m.scale.copy_(torch.randn(m.scale.shape, generator=g))
            elif isinstance(m, ChannelLayerNorm):
                m.weight.copy_(1 + 0.5 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.3 * torch.randn(m.bias.shape, generator=g))
    return model


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20):
    """Device time of one call of ``fn``, ms: the call is captured into a CUDA
    graph (allocations, kernels and all) and the graph replayed ``iters``
    times between two events, so the host issues nothing per call. A
    CUDA-event reading of a call that the card finishes sooner than the host
    issues it (~0.1 ms through a Python wrapper, more on a busy host)
    measures the host; this does not."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the default stream, as capture needs
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------- phases

def phase_config():
    """The port's own YAML loader on the production test config: it must give
    the localizer chip_smoke.py serves (and import nothing of JAX: main()
    looks at sys.modules at the end)."""
    from audio_visual_deepfake_detection_tpu_torch.core.config import (
        ArchConfig, arch_config_from, load_config, test_config_from)

    config = load_config(os.path.join(REPO, "configs_test", "deepfake_exp12_test.yaml"))
    arch = arch_config_from(config)
    test_config_from(config)
    want = ArchConfig(**PROD)
    for field in ("variant", "input_dim", "max_seq_len", "embd_dim", "n_head",
                  "mha_win_size", "arch"):
        if getattr(arch, field) != getattr(want, field):
            fail(f"load_config: {field} = {getattr(arch, field)!r}, expected "
                 f"{getattr(want, field)!r}")
    log(f"config: deepfake_exp12_test.yaml -> {arch.variant}, input {arch.input_dim}, "
        f"T {arch.max_seq_len}, windows {arch.mha_win_size}")


def phase_build():
    import torch
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load()
    took = time.perf_counter() - t0
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    smi = nvidia_smi_line()
    log(f"build: {took:.2f} s (nvcc ran: {build.BUILD_SECONDS is not None}) "
        f"-> {build.library_path().name}")
    for line in build.BUILD_LOG.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill", "warning", "wgmma")):
            log(f"  ptxas: {line.strip()}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc [{nvcc}] triton {triton_v}")
    log(f"card: {smi}")
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}")
    REPORT["build"] = dict(seconds=took, torch=torch.__version__,
                           cuda=torch.version.cuda, nvcc=nvcc, triton=triton_v,
                           nvidia_smi=smi, ptxas=build.BUILD_LOG[-4000:])
    return smi


def block_case(mode, t, window, b, dtype, device, seed):
    """Random packed params + inputs of one production block shape."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.models.blocks import TransformerBlock

    g = torch.Generator().manual_seed(seed)
    cross = mode in ("qv_k", "kv")
    blk = TransformerBlock(256, 4, ds_stride=2 if mode == "ds_self" else 1,
                           window_size=window, cross=cross)
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, torch.nn.Conv1d):
                bound = 1.0 / float(m.weight[0].numel()) ** 0.5
                m.weight.uniform_(-bound, bound, generator=g)
                if m.bias is not None:
                    m.bias.uniform_(-0.1, 0.1, generator=g)
    perturb(blk, seed + 1)
    packed = [a.to(device) for a in blk.packed(dtype)]
    # valid lengths: full, 3/4, 1/3, a single row, and an all-padding row
    lens = [t, (3 * t) // 4, t // 3, 1, 0][:b] + [t] * max(0, b - 5)
    mask = torch.arange(t)[None, :] < torch.tensor(lens)[:, None]
    mf = mask[..., None].float()
    x = (torch.randn((b, t, 256), generator=g) * mf).to(device, dtype)
    xo = (torch.randn((b, t, 256), generator=g) * mf).to(device, dtype)
    if mode == "self":
        xo = None
    return x, xo, mask.to(device).contiguous(), packed


def run_block(which, x, xo, mask, packed, mode, window):
    import torch
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as fb

    if which == "kernel":
        return fb.fused_transformer_block(x, xo, mask, *packed, n_head=4,
                                          w_overlap=window // 2, mode=mode)
    coefs = torch.ones((x.shape[0], 2), device=x.device)
    return fb.block_math(x, x if xo is None else xo, mask.float()[..., None],
                         coefs, *packed, n_head=4, w_overlap=window // 2, mode=mode)


def compare(got, ref):
    """(max |got - ref|, within tolerance, elements beyond atol + rtol |ref|).

    f32: atol F32_ATOL. bf16: atol = rtol = BF16_TOL per element, and an
    element beyond that passes only if it is off by at most one bf16 ulp of
    the output's largest magnitude: the kernel sums its products in another
    order than cuBLAS, so the residual stream (the block's largest values)
    may round to the neighbouring bf16 value, and the output keeps that step
    where the MLP branch cancels it to a small value. Non-finite output
    fails."""
    import torch

    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        return float("inf"), False, -1
    d = (g - r).abs()
    if got.dtype == torch.float32:
        return d.max().item(), d.max().item() <= F32_ATOL, int((d > F32_ATOL).sum())
    over = d > BF16_TOL + BF16_TOL * r.abs()
    top = r.abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return d.max().item(), bool((d[over] <= ulp).all()), int(over.sum())


# K1 beyond the batches of phase_kernels' loop: (B, mode, T, window) of the
# offline sweep's batch, one full-length block
K1_BIG = ((512, "self", 768, 7),)


def phase_kernels(dev="cuda", blocks=PROD_BLOCKS, batches=(16, 64), big=K1_BIG):
    """Kernel vs block_math, f32 and bf16, at every block shape for each
    batch of ``batches`` (the service's 16, the main path's 64) and at the
    (B, mode, T, window) cases of ``big``: five varied valid lengths (full,
    3/4, 1/3, one row, none), the rest full. The 64-row tiles of the bf16
    kernel meet their ragged edges and the two-tiles-a-block pairing there."""
    import torch

    worst = {"float32": 0.0, "bfloat16": 0.0}
    rows = []
    cases = [(b, mode, t, window) for b in batches for _, mode, t, window in blocks]
    for b, mode, t, window in cases + list(big):
        for dtype in (torch.float32, torch.bfloat16):
            x, xo, mask, packed = block_case(mode, t, window, b, dtype, dev, seed=t)
            got = run_block("kernel", x, xo, mask, packed, mode, window)
            ref = run_block("plain", x, xo, mask, packed, mode, window)
            sync(dev)
            err, ok, n_over = compare(got, ref)
            name = str(dtype).split(".")[-1]
            worst[name] = max(worst[name], err)
            rows.append(dict(B=b, mode=mode, T=t, window=window, dtype=name,
                             max_abs_err=err, ok=ok, beyond_atol_rtol=n_over))
            log(f"kernel vs plain B={b} {mode:7s} T={t:3d} w={window:2d} {name:8s} "
                f"max|d|={err:.3e} beyond atol+rtol: {n_over} of {got.numel()} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                REPORT["kernels"] = rows
                fail(f"kernel disagrees with block_math: B={b} {mode} T={t} {name}")
            del x, xo, mask, packed, got, ref
    REPORT["kernels"] = rows
    return worst


def phase_serve(dev="cuda", arch=PROD, n_req=32, batch=16):
    import torch
    from audio_visual_deepfake_detection_tpu_torch.core.config import ArchConfig, TestConfig
    from audio_visual_deepfake_detection_tpu_torch.infer import (
        LocalizerService, build_inference_fn)
    from audio_visual_deepfake_detection_tpu_torch.models import build_localizer
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as fb

    cfg = ArchConfig(**arch, compute_dtype="bfloat16")
    tcfg = TestConfig(**dict(BENCH_TEST, min_score=0.001))
    model = perturb(build_localizer(cfg, seed=0, device=dev), 1)
    n_blocks = 1 + cfg.arch[1] + 3 * cfg.arch[2]
    service = LocalizerService(cfg, tcfg, model, batch_size=batch, max_wait_ms=50,
                               warmup=True)
    rng = np.random.default_rng(0)
    t = cfg.max_seq_len
    lens = rng.integers(t // 8, t + 1, n_req)
    feats = [rng.standard_normal((n, cfg.input_dim), dtype=np.float32) for n in lens]
    try:
        sync(dev)
        fb.reset_launches()
        service.forwards = 0
        futures = [service.submit(f, 25.0, n / 25.0, 0.3125) for f, n in zip(feats, lens)]
        results = [f.result(timeout=600) for f in futures]
        sync(dev)
        launches, forwards = fb.LAUNCHES, service.forwards
    finally:
        service.stop(timeout=600)
    log(f"serve: {n_req} requests, {forwards} forwards, {launches} block-kernel "
        f"launches, detections per video min {min(len(r.scores) for r in results)} "
        f"max {max(len(r.scores) for r in results)}")
    expect = n_blocks * forwards if torch.device(dev).type == "cuda" else 0
    if launches != expect or forwards == 0:
        fail(f"expected {n_blocks} launches per forward, got {launches} in {forwards}")
    for r, n in zip(results, lens):
        if len(r.scores) == 0:
            fail("a request resolved with no detection")
        if not (np.isfinite(r.segments).all() and np.isfinite(r.scores).all()
                and np.isfinite(r.video_cls)):
            fail("non-finite detections")
        if r.segments.shape != (len(r.scores), 2) or r.segments.min() < 0 \
                or r.segments.max() > n / 25.0 + 1e-4:
            fail("segments outside [0, duration]")
    REPORT["serve"] = dict(requests=n_req, forwards=forwards, launches=launches,
                           detections=[len(r.scores) for r in results])

    # f32, 2 videos: the card's kernel path vs the same model's plain CPU path
    cfg32 = ArchConfig(**arch, compute_dtype="float32")
    m32 = perturb(build_localizer(cfg32, seed=0, device="cpu"), 1)
    fn = build_inference_fn(cfg32, tcfg)
    x = rng.standard_normal((2, t, cfg.input_dim), dtype=np.float32)
    mask = np.ones((2, t), bool)
    mask[1, (2 * t) // 3:] = False
    x *= mask[..., None]
    meta = [np.full(2, v, np.float32) for v in (25.0, 30.72, 1.0, 1.0)]
    cpu = [a.numpy() for a in fn(m32, x, mask, *meta)]
    fb.reset_launches()
    gpu = [a.cpu().numpy() for a in fn(m32.to(dev), x, mask, *meta)]
    if fb.LAUNCHES != (n_blocks if torch.device(dev).type == "cuda" else 0):
        fail(f"f32 forward launched the block kernel {fb.LAUNCHES} times")
    errs = {}
    for i in range(2):
        kc, kg = int(cpu[3][i].sum()), int(gpu[3][i].sum())
        if kc != kg or kc == 0:
            fail(f"f32 video {i}: {kg} detections on the card vs {kc} on the CPU")
        errs[f"scores_{i}"] = float(np.abs(gpu[1][i][:kc] - cpu[1][i][:kc]).max())
        errs[f"segments_{i}"] = float(np.abs(gpu[0][i][:kc] - cpu[0][i][:kc]).max())
        if errs[f"scores_{i}"] > 1e-4 or errs[f"segments_{i}"] > 1e-3:
            fail(f"f32 video {i}: card vs CPU differ {errs}")
    errs["video_cls"] = float(np.abs(gpu[4] - cpu[4]).max())
    if errs["video_cls"] > 2e-4:
        fail(f"f32 video_cls differ {errs}")
    log(f"f32 card vs CPU plain path: {errs}")
    REPORT["f32_parity"] = errs
    return model, cfg


def phase_timing(model, cfg, smi):
    import torch
    from audio_visual_deepfake_detection_tpu_torch.core.config import TestConfig
    from audio_visual_deepfake_detection_tpu_torch.infer import (
        LocalizerService, build_inference_fn)

    dev = torch.device("cuda")
    per_shape = []
    totals, bounds, dev_totals = {}, {}, {}
    worst = 0.0
    for b in (16, 64, 512):     # the service batch, a 64-video media run, the offline sweep
        k_tot = p_tot = d_tot = 0.0
        bounds[b] = bound_sum([(*k1_work(mode, t, window, b), len(names))
                               for names, mode, t, window in PROD_BLOCKS])
        for names, mode, t, window in PROD_BLOCKS:
            x, xo, mask, packed = block_case(mode, t, window, b, torch.bfloat16, dev, seed=t)
            err, ok, n_over = compare(
                run_block("kernel", x, xo, mask, packed, mode, window),
                run_block("plain", x, xo, mask, packed, mode, window))
            worst = max(worst, err)
            log(f"kernel vs plain B={b} {mode:7s} T={t:3d} w={window:2d} bfloat16 "
                f"max|d|={err:.3e} beyond atol+rtol: {n_over} of {x.numel()} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"kernel disagrees with block_math: B={b} {mode} T={t} bfloat16")
            iters = {16: 20, 64: 8}.get(b, 3)
            ms = {}
            for which in ("plain", "kernel", "kernel", "plain"):   # interleaved
                ms.setdefault(which, []).append(cuda_ms(
                    lambda: run_block(which, x, xo, mask, packed, mode, window), iters))
            k_ms, p_ms = min(ms["kernel"]), min(ms["plain"])
            d_ms = device_ms(lambda: run_block("kernel", x, xo, mask, packed, mode, window),
                             iters)
            k_tot += k_ms * len(names)
            p_tot += p_ms * len(names)
            d_tot += d_ms * len(names)
            per_shape.append(dict(B=b, mode=mode, T=t, window=window, max_abs_err=err,
                                  beyond_atol_rtol=n_over, kernel_ms=k_ms, plain_ms=p_ms,
                                  device_ms=d_ms, blocks=len(names)))
            log(f"time B={b:3d} {mode:7s} T={t:3d} w={window:2d}: kernel "
                f"{k_ms:.4f} ms (device {d_ms:.4f})  plain {p_ms:.4f} ms  ({smi})")
            del x, xo, mask, packed
        totals[b] = (k_tot, p_tot)
        dev_totals[b] = d_tot
        log(f"time B={b}: 18 blocks of one forward, kernel {k_tot:.3f} ms (their kernels alone "
            f"{d_tot:.3f} ms, {k1_work_total(b) / d_tot / 1e9:.1f} TFLOP/s), plain {p_tot:.3f} ms, "
            f"bound {bounds[b][0]:.3f} ms ({bounds[b][1]}) ({smi})")
        torch.cuda.empty_cache()
    REPORT["block_times"] = per_shape
    REPORT["pack_ms"] = pack_cost(model, smi)

    # service latency at batch 16 (bench test config, seeded weights)
    tcfg = TestConfig(**BENCH_TEST)
    service = LocalizerService(cfg, tcfg, model, batch_size=16, max_wait_ms=50,
                               warmup=True)
    rng = np.random.default_rng(1)
    feats = [rng.standard_normal((768, cfg.input_dim), dtype=np.float32) for _ in range(16)]
    lat = []
    try:
        for _ in range(6):
            t0 = time.perf_counter()
            futs = [service.submit(f, 25.0, 30.72, 1.0) for f in feats]
            for f in futs:
                f.result(timeout=600)
            lat.append((time.perf_counter() - t0) * 1e3)
    finally:
        service.stop(timeout=600)
    lat_ms = statistics.median(lat[1:])
    log(f"service latency, 16 requests -> 16 answers: median {lat_ms:.2f} ms "
        f"(runs {[round(v, 2) for v in lat]}) ({smi})")

    # localizer-only videos/s at B=512 bf16 (bench.py::measure_ours program)
    fn = build_inference_fn(cfg, tcfg)
    B = 512
    feats = torch.randn((B, 768, cfg.input_dim), generator=torch.Generator().manual_seed(0)
                        ).to(dev, torch.bfloat16)
    mask = torch.ones((B, 768), dtype=torch.bool, device=dev)
    meta = [torch.full((B,), v, device=dev) for v in (25.0, 9.6, 0.3125, 0.3125)]

    def run():
        out = fn(model, feats, mask, *meta)
        out[1].cpu()
    for _ in range(2):
        run()
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        rates.append(B * 3 / (time.perf_counter() - t0))
    vps = statistics.median(rates)
    log(f"localizer-only B=512 bf16: {vps:.1f} videos/s (blocks {[round(r, 1) for r in rates]}) "
        f"({smi})")
    profile = profile_forward(run, B / vps * 1e3, smi)
    REPORT["timing"] = dict(service_latency_ms=lat_ms, service_runs_ms=lat,
                            localizer_videos_per_s=vps, rates=rates,
                            block_totals_ms={str(k): v for k, v in totals.items()},
                            block_device_ms={str(k): v for k, v in dev_totals.items()},
                            block_bounds_ms={str(k): v for k, v in bounds.items()},
                            profile=profile, card=smi)
    return totals, worst, bounds


def pack_cost(model, smi):
    """Host ms to pack the 18 blocks' bf16 kernel inputs: from scratch plus
    six weight transposes per block (what every forward paid when nothing was
    cached), and through the blocks' cache."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.models.blocks import TransformerBlock
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as fb

    blocks = [m for m in model.modules() if isinstance(m, TransformerBlock)]

    def uncached():
        for blk in blocks:
            packed = fb.pack_block_params(dict(blk.named_parameters()), blk.n_embd,
                                          blk.cross, torch.bfloat16)
            for w in packed[1:7]:
                w.t().contiguous()

    def cached():
        for blk in blocks:
            blk.packed(torch.bfloat16)

    out = {}
    for name, fn in (("uncached", uncached), ("cached", cached)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / 10
    log(f"packing the {len(blocks)} blocks' bf16 inputs, host ms per forward: "
        f"uncached {out['uncached']:.3f}, cached {out['cached']:.3f} ({smi})")
    return out


def profile_forward(run, forward_ms, smi, label="one B=512 forward", top_n=12):
    """Device time by kernel over one forward (torch.profiler, CUPTI).
    Informational: a profiler that sees no device time is reported, not
    failed on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except Exception as e:  # noqa: BLE001 - the profiler is optional here
        log(f"profile unavailable: {e}")
        return None
    from torch.autograd import DeviceType

    # device-side kernel events only (operator rows would count them twice)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    total_us = sum(dev(e) for e in kernels)
    top = sorted(kernels, key=dev, reverse=True)[:top_n]
    log(f"profile, {label}: kernels busy {total_us / 1e3:.2f} ms of "
        f"{forward_ms:.2f} ms wall, {len(kernels)} kernel names ({smi})")
    rows = []
    for e in top:
        rows.append(dict(name=e.key[:90], device_ms=dev(e) / 1e3, calls=e.count))
        log(f"  {dev(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    return dict(device_ms=total_us / 1e3, forward_ms=forward_ms, top=rows)


# ------------------------------------------------------ K1 dense repair

DENSE_TS = (24, 31, 32, 48, 100)   # T >= 32 raised before the tiled path


def phase_k1_dense(dev="cuda", b=5):
    """K1 in dense mode (ds_self, window -1) against block_math at T = 24,
    31 (whole-sequence path) and 32, 48, 100 (tiled two-phase path), f32 and
    bf16, lengths full, 3/4, 1/3, one row and none."""
    import torch

    worst = {"float32": 0.0, "bfloat16": 0.0}
    for t in DENSE_TS:
        for dtype in (torch.float32, torch.bfloat16):
            x, xo, mask, packed = block_case("ds_self", t, -1, b, dtype, dev, seed=t)
            got = run_block("kernel", x, xo, mask, packed, "ds_self", -1)
            ref = run_block("plain", x, xo, mask, packed, "ds_self", -1)
            sync(dev)
            err, ok, n_over = compare(got, ref)
            name = str(dtype).split(".")[-1]
            worst[name] = max(worst[name], err)
            log(f"K1 dense B={b} ds_self T={t:3d} {name:8s} max|d|={err:.3e} "
                f"beyond atol+rtol: {n_over} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"K1 dense disagrees with block_math: T={t} {name}")
    REPORT["k1_dense"] = worst
    return worst


def phase_long_forward(dev="cuda", arch=PROD, t=1536):
    """A production-width f32 localizer forward at T = 1536 (coarsest level
    48 rows, the tiled dense path) through build_inference_fn on the card,
    held against the same model's plain path on the CPU."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.core.config import ArchConfig, TestConfig
    from audio_visual_deepfake_detection_tpu_torch.infer import build_inference_fn
    from audio_visual_deepfake_detection_tpu_torch.models import build_localizer
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as fb

    cfg = ArchConfig(**arch, compute_dtype="float32")
    tcfg = TestConfig(**dict(BENCH_TEST, min_score=0.001))
    model = perturb(build_localizer(cfg, seed=0, device="cpu"), 1)
    fn = build_inference_fn(cfg, tcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, t, cfg.input_dim), dtype=np.float32)
    mask = np.ones((2, t), bool)
    mask[1, (3 * t) // 5:] = False
    x *= mask[..., None]
    meta = [np.full(2, v, np.float32) for v in (25.0, t / 25.0, 1.0, 1.0)]
    cpu = [a.numpy() for a in fn(model, x, mask, *meta)]
    fb.reset_launches()
    gpu = [a.cpu().numpy() for a in fn(model.to(dev), x, mask, *meta)]
    n_blocks = 1 + cfg.arch[1] + 3 * cfg.arch[2]
    if fb.LAUNCHES != n_blocks:
        fail(f"T={t} forward launched the block kernel {fb.LAUNCHES} times")
    errs = {}
    for i in range(2):
        kc, kg = int(cpu[3][i].sum()), int(gpu[3][i].sum())
        if kc != kg or kc == 0:
            fail(f"T={t} video {i}: {kg} detections on the card vs {kc} on the CPU")
        errs[f"scores_{i}"] = float(np.abs(gpu[1][i][:kc] - cpu[1][i][:kc]).max())
        errs[f"segments_{i}"] = float(np.abs(gpu[0][i][:kc] - cpu[0][i][:kc]).max())
        if errs[f"scores_{i}"] > 1e-4 or errs[f"segments_{i}"] > 1e-3:
            fail(f"T={t} video {i}: card vs CPU differ {errs}")
    errs["video_cls"] = float(np.abs(gpu[4] - cpu[4]).max())
    if errs["video_cls"] > 2e-4:
        fail(f"T={t} video_cls differ {errs}")
    log(f"localizer f32 T={t} (coarsest level {t // 32} rows): card vs CPU plain {errs}")
    REPORT["long_forward"] = errs


# ------------------------------------------------------------ MViT kernels

# K4 geometries of mvit_v2_b at 512 frames: (S grid, C, heads, blocks)
MSBLOCK_SHAPES = [((4, 4), 192, 2, 2), ((2, 2), 384, 4, 15), ((1, 1), 768, 8, 1)]
# K3 on the main path (the table entry): (name, heads, S spatial cells, head
# dim, band rounded to the compute dtype, blocks per forward); blocks 0-1 are
# C = 96 on the 8x8 grid, block 23 is 768 -> 256 channels on one cell
K3_SHAPES = [("blocks 0-1", 1, 64, 96, False, 2), ("block 23", 8, 1, 32, True, 1)]
VIDEO_T = 512


def check_bf16(got, ref):
    """compare()'s bf16 rule, else the JAX package's distributional rule
    (median |d| < 0.005 std(ref), max |d| < 0.1 std(ref),
    tests/test_mvit_block_fused.py:86-92). Returns (max |d|, ok, rule)."""
    import torch

    err, ok, _ = compare(got, ref)
    if ok:
        return err, True, "atol=rtol=2e-2"
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        return float("inf"), False, "non-finite"
    d = (g - r).abs()
    std = r.std().item()
    ok = d.median().item() < 0.005 * std and d.max().item() < 0.1 * std
    return err, ok, f"distributional (median {d.median().item():.2e}, std {std:.2e})"


def check_f32(got, ref, atol=1e-4, rtol=5e-4):
    import torch

    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        return float("inf"), False
    d = (g - r).abs()
    return d.max().item(), bool((d <= atol + rtol * r.abs()).all())


# bf16 K3 per element, against its function in f32 on the same bf16 inputs
# (K8_RULES' argument, with K3's residual): with p the exact softmax weights,
# A = sum_j p_j |v_j|, attn = the attention part of the output and out =
# attn + q, the kernel rounds the exps before P.V and sums z from them
# (2^-8 (A + |attn|)), rounds attn (2^-8 |attn|) and the sum with q (2^-8
# |out|). A band the function rounds to bf16 (block 23) may round one ulp
# the other way from the kernel's f32 G: 2^-7 max_j |band_j| (A + |attn|).
K3_BF16_RULE = ("|kernel - f32| <= 1e-5 + 2^-8 (sum_j p_j |v_j| + 2 |attn| + |out|) "
                "[+ 2^-7 max_j |band_j| (sum_j p_j |v_j| + |attn|), band rounded], and within "
                "1.5x of plain vs f32 (max, median)")


def check_k3(got, ref, args):
    """bf16 K3 (either entry) against its function in f32 on the same bf16
    inputs: K3_BF16_RULE per element, and the kernel no further than the
    plain version from it. ``args``: run_k3's (the table entry) or
    run_k3_array's (the band given). Returns (max |d| to plain, ok, rule)."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_attention as k3

    if not torch.isfinite(got.float()).all():
        return float("inf"), False, "non-finite"
    err = (got.float() - ref.float()).abs().max().item()
    with torch.no_grad():
        if len(args) == 4:                       # the band given
            q, k, v, band = (a.float() for a in args)
            band_max = None
        else:
            qf, k, v, rel, s_cells, band_round = args
            q, k, v = qf[:, :, 1:].float(), k.float(), v.float()
            b, nh, ng, d = q.shape
            band = k3.table_band(q, rel.float(), VIDEO_T, s_cells, False)
            if band_round:
                band = band.to(qf.dtype).float()
            band_max = band.abs().amax(-1, keepdim=True).reshape(b * nh, ng, 1) \
                if band_round else None
            q, band = q.reshape(b * nh, ng, d), band.reshape(b * nh, ng, VIDEO_T)
        scale = q.shape[-1] ** -0.5
        exact = k3.pooled_attention_math(q, k, v, band, scale)
        spread = k3.pooled_attention_math(q, k, v.abs(), band, scale) - q
        del band
        attn = exact - q
        limit = K8_BF16_ATOL + K8_BF16_U * (spread + 2 * attn.abs() + exact.abs())
        if band_max is not None:
            limit += 2 * K8_BF16_U * band_max * (spread + attn.abs())
        g, r = (a.float().reshape(exact.shape) for a in (got, ref))
        over = int(((g - exact).abs() > limit).sum())
        near, text = against_exact(g, r, exact)
    return err, near and over == 0, \
        f"{over} beyond the rounding bound against f32; {text}"


def randomize_block(blk, seed):
    """Seeded weights at O(1) activations: Linear weights ~ N(0, 1/fan_in),
    pool taps ~ N(0, 1/27), LN affines 1 + 0.2 N, biases and rel-pos tables
    0.1 N, so every branch of the block shows in its output."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, prm in blk.named_parameters():
            if name.endswith("bias") or "rel_pos" in name:
                val = 0.1 * torch.randn(prm.shape, generator=g)
            elif prm.dim() == 1:
                val = 1 + 0.2 * torch.randn(prm.shape, generator=g)
            else:
                val = torch.randn(prm.shape, generator=g) * prm[0].numel() ** -0.5
            prm.copy_(val)
    return blk


def msblock_case(grid_hw, c, nh, dtype, dev, b=2, seed=0):
    """A K4 block at production width; chunk 1's last quarter of time steps
    are zero tokens (a zero-padded tail chunk)."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.frontends.mvit import (
        MSBlockConfig, MultiscaleBlock)

    hs, ws = grid_hw
    t = VIDEO_T
    cfg = MSBlockConfig(nh, c, c, (3, 3, 3), (3, 3, 3), (1, 1, 1), (1, hs, ws))
    blk = randomize_block(MultiscaleBlock(cfg, (t, hs, ws)), seed).to(dev)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((b, 1 + t * hs * ws, c), generator=g)
    if b > 1:
        x[1, 1 + (3 * t // 4) * hs * ws:] = 0
    return blk, x.to(dev, dtype)


def run_msblock(which, blk, x, t, grid_hw, nh):
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_block as k4

    p = blk.packed(x.dtype)
    if which == "kernel":
        return k4.fused_multiscale_block(x, p, t=t, grid_hw=grid_hw, n_head=nh)
    return k4.msblock_math(x, p, t=t, grid_hw=grid_hw, n_head=nh)


def k3_case(chunks, heads, s_cells, d, band_round, dtype, dev, seed=0, cls_scale=1.0):
    """K3's inputs as MultiscaleAttention hands them over: the pooled q
    (chunks, heads, 1 + T S, d) whose grid rows the kernel reads in place, k
    and v (chunks * heads, T + 1, d) with the class token last, the (2T - 1,
    d) temporal table; O(1) scores and band. Then S and the band rounding.
    ``cls_scale`` scales the class key: at 8 its score is 8 N(0, 1) against
    512 grid keys of O(1) scores, so it takes half the weight or more on
    about a fifth of the rows and little on the rest."""
    import torch

    g = torch.Generator().manual_seed(seed)
    t = VIDEO_T
    qf = torch.randn((chunks, heads, 1 + t * s_cells, d), generator=g)
    k, v = (torch.randn((chunks * heads, t + 1, d), generator=g) for _ in range(2))
    k[:, -1] *= cls_scale
    rel = 0.1 * torch.randn((2 * t - 1, d), generator=g)
    return tuple(a.to(dev, dtype) for a in (qf, k, v, rel)) + (s_cells, band_round)


def run_k3(which, qf, k, v, rel, s_cells, band_round):
    """The table entry as the MViT forward calls it (q strided, the output
    written into the token layout), or its plain version."""
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_attention as k3

    d = qf.shape[-1]
    if which == "kernel":
        b, nh, n, _ = qf.shape
        o = qf.new_empty((b, n, nh, d))
        return k3.pooled_attention_table(qf[:, :, 1:], k, v, rel, VIDEO_T, s_cells, d ** -0.5,
                                         band_round, out=o[:, 1:].transpose(1, 2))
    return k3.pooled_attention_table_math(qf[:, :, 1:], k, v, rel, VIDEO_T, s_cells, d ** -0.5,
                                          band_round)


def k3_library(qf, k, v, rel, s_cells, band_round):
    """The nearest PyTorch calls to K3 (not one call: SDPA has no rel-pos
    band and no + q): scaled_dot_product_attention with [band | 0] as a bf16
    additive mask, then + q. The band and the mask are built here, outside
    what the returned function times."""
    import torch
    import torch.nn.functional as F
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_attention as k3

    q = qf[:, :, 1:].contiguous()
    b, nh, ng, d = q.shape
    band = k3.table_band(q, rel, VIDEO_T, s_cells, band_round)
    mask = torch.cat([band, band.new_zeros((b, nh, ng, 1))], -1).to(q.dtype)
    del band
    kk, vv = (a.reshape(b, nh, VIDEO_T + 1, d) for a in (k, v))
    return lambda: F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask, scale=d ** -0.5) + q


def k3_array_case(chunks, heads, s_cells, d, band_cd, dtype, dev, seed=0):
    """K3's JAX contract: grid queries, k/v and a caller-built band array."""
    import torch

    g = torch.Generator().manual_seed(seed)
    bh, ng = chunks * heads, VIDEO_T * s_cells
    q, k, v = (torch.randn((bh, n, d), generator=g).to(dev, dtype)
               for n in (ng, VIDEO_T + 1, VIDEO_T + 1))
    band = torch.randn((bh, ng, VIDEO_T), generator=g).to(dev)
    return q, k, v, band.to(dtype) if band_cd else band


def run_k3_array(which, q, k, v, band):
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_attention as k3

    fn = k3.fused_pooled_attention if which == "kernel" else k3.pooled_attention_math
    return fn(q, k, v, band, scale=q.shape[-1] ** -0.5)


def patch_case(dtype, dev, b=2, seed=0, u8=True, f=96):
    """b chunks of 512 frames, the last chunk's final quarter zero (a
    zero-padded tail chunk): uint8 as the main path hands them over, or f32
    frames in [0, 1]; f features (mvit_v2_b's 96)."""
    import torch

    t = VIDEO_T
    g = torch.Generator().manual_seed(seed)
    if u8:
        video = torch.randint(0, 256, (b, t, 96, 96, 3), generator=g, dtype=torch.uint8)
    else:
        video = torch.rand((b, t, 96, 96, 3), generator=g)
    video[-1, (3 * t) // 4:] = 0
    w = torch.randn((f, 3, 3, 15, 15), generator=g) * 2025 ** -0.5
    bias = 0.1 * torch.randn(f, generator=g)
    return video.to(dev), w.to(dev), bias.to(dev), dtype


def run_patch(which, video, w, bias, dtype):
    import torch
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import patch_embed as k2

    u8 = video.dtype == torch.uint8
    if which == "kernel":
        return (k2.fused_patch_embed_u8 if u8 else k2.fused_patch_embed)(video, w, bias, dtype)
    return (k2.patch_embed_u8_math if u8 else k2.patch_embed_math)(video, w, bias, dtype)


def conv3d_library(video, w, bias):
    """K2's function as one PyTorch call: cuDNN's bf16 conv3d on the
    channels-first bf16 copy of the same (normalized) frames, made here."""
    import torch
    import torch.nn.functional as F
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import patch_embed as k2

    x = k2.normalize_u8(video) if video.dtype == torch.uint8 else video
    xc = x.permute(0, 4, 1, 2, 3).to(torch.bfloat16).contiguous()
    del x
    wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
    return lambda: F.conv3d(xc, wb, bb, stride=(1, 12, 12), padding=(1, 3, 3))


def mvit_cases(dev="cuda", chunks=2):
    """(kernel, label, blocks per chunk-forward, case maker, runner, bf16
    (operations, bytes) of one call) for every main-path call of K2-K4 at
    B = ``chunks`` chunks: K2's uint8 entry, K3's table entry, K4."""
    cases = [("patch_embed", f"uint8 B={chunks} T={VIDEO_T} 96x96x3 -> 8x8x96", 1,
              lambda dt: patch_case(dt, dev, b=chunks), run_patch,
              k2_work(chunks, VIDEO_T, in_bytes=1))]
    for name, heads, s_cells, d, rnd, n in K3_SHAPES:
        cases.append(("pooled_attention",
                      f"{name}: B={chunks} heads={heads} S={s_cells} Ng={VIDEO_T * s_cells} "
                      f"Nk={VIDEO_T + 1} d={d}, band from the table", n,
                      lambda dt, a=(heads, s_cells, d, rnd): k3_case(chunks, *a, dt, dev),
                      run_k3,
                      k3_table_work(chunks * heads, VIDEO_T * s_cells, d)))
    for hw, c, nh, n in MSBLOCK_SHAPES:
        s_cells = hw[0] * hw[1]
        cases.append(("multiscale_block", f"S={s_cells} C={c} heads={nh}", n,
                      lambda dt, a=(hw, c, nh): msblock_case(*a, dt, dev, b=chunks),
                      lambda which, blk, x, a=(hw, nh): run_msblock(
                          which, blk, x, VIDEO_T, a[0], a[1]),
                      k4_work(chunks, s_cells, c, VIDEO_T)))
    return cases


# K2 at widths mvit_v2_b does not have, as the gate takes them (F <= 128):
# (features, uint8 frames): the 128-wide product (bf16 frames there stage in
# two slots), an odd F past 96 and one below it (single stores at the end)
K2_WIDTHS = ((128, True), (128, False), (101, True), (101, False), (33, True))


def contract_cases(dev="cuda", chunks=2):
    """The entries the main path no longer calls, held all the same: K2 on
    f32 frames (resized or float inputs) and K3 with the band given (the JAX
    signature), at K3's main-path shapes; K2 at K2_WIDTHS; K3's table entry
    with a dominant class key."""
    cases = [("patch_embed", f"f32 frames B={chunks} T={VIDEO_T} 96x96x3 -> 8x8x96", 0,
              lambda dt: patch_case(dt, dev, b=chunks, u8=False), run_patch, None)]
    for f, u8 in K2_WIDTHS:
        cases.append(("patch_embed", f"{'uint8' if u8 else 'f32'} frames B={chunks} "
                      f"T={VIDEO_T} 96x96x3 -> 8x8x{f}", 0,
                      lambda dt, a=(u8, f): patch_case(dt, dev, b=chunks, u8=a[0], f=a[1]),
                      run_patch, None))
    for name, heads, s_cells, d, rnd, _ in K3_SHAPES:
        cases.append(("pooled_attention",
                      f"{name}: BH={chunks * heads} Ng={VIDEO_T * s_cells} d={d}, band given", 0,
                      lambda dt, a=(heads, s_cells, d, rnd): k3_array_case(chunks, *a, dt, dev),
                      run_k3_array, None))
        cases.append(("pooled_attention",
                      f"{name}: B={chunks} heads={heads} S={s_cells} d={d}, band from the table, "
                      f"class key x8", 0,
                      lambda dt, a=(heads, s_cells, d, rnd): k3_case(chunks, *a, dt, dev,
                                                                     cls_scale=8.0),
                      run_k3, None))
    return cases


def phase_mvit_kernels(dev="cuda", group=32):
    """K2, K3, K4 against their plain versions on the card at every
    main-path shape, B = 2 chunks (one with a zero tail), f32 (atol 1e-4,
    rtol 5e-4) and bf16 (check_bf16; K3 by check_k3), with the entries the
    main path no longer calls (K2 on f32 frames, K3 with the band given),
    K2 at K2_WIDTHS and K3 with a dominant class key; K2's uint8
    entry and K3's table entry also at the ``group`` chunks the main path
    hands them, f32 and bf16, and K4's three geometries there in bf16."""
    import torch

    worst, rows = {}, []
    both = (torch.float32, torch.bfloat16)
    cases = [(c, both) for c in mvit_cases(dev) + contract_cases(dev)]
    cases += [((k, f"{label} [{group}-chunk group]", *rest), both)
              for k, label, *rest in mvit_cases(dev, group) if k != "multiscale_block"]
    for hw, c, nh, n in MSBLOCK_SHAPES:
        cases.append((("multiscale_block", f"S={hw[0] * hw[1]} C={c} heads={nh} B={group}", n,
                       lambda dt, a=(hw, c, nh): msblock_case(*a, dt, dev, b=group),
                       lambda which, blk, x, a=(hw, nh): run_msblock(
                           which, blk, x, VIDEO_T, a[0], a[1]), None),
                      (torch.bfloat16,)))
    # no production width: C = 128 (64-column product tiles beside the 192
    # ones) with head dim 64 (the attention step's head-dim-64 instantiation)
    cases.append((("multiscale_block", "S=4 C=128 heads=2 (64-column tiles, head dim 64)", 0,
                   lambda dt: msblock_case((2, 2), 128, 2, dt, dev),
                   lambda which, blk, x: run_msblock(which, blk, x, VIDEO_T, (2, 2), 2), None),
                  both))
    for (kname, label, _, make, run, _), dtypes in cases:
        for dtype in dtypes:
            args = make(dtype)
            got, ref = run("kernel", *args), run("plain", *args)
            sync(dev)
            dname = str(dtype).split(".")[-1]
            if dtype == torch.float32:
                err, ok = check_f32(got, ref)
                rule = "atol 1e-4 rtol 5e-4"
            elif kname == "pooled_attention":
                err, ok, rule = check_k3(got, ref, args)
            else:
                err, ok, rule = check_bf16(got, ref)
            w = worst.setdefault(kname, {"float32": 0.0, "bfloat16": 0.0})
            w[dname] = max(w[dname], err)
            rows.append(dict(kernel=kname, shape=label, dtype=dname, max_abs_err=err,
                             ok=ok, rule=rule))
            log(f"{kname} vs plain {label} {dname:8s} max|d|={err:.3e} [{rule}] "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                REPORT["mvit_kernels"] = rows
                fail(f"{kname} disagrees with its plain version: {label} {dname}")
            del args, got, ref
        torch.cuda.empty_cache()
    REPORT["mvit_kernels"] = rows
    return worst


K4_LAUNCHES = ("LN1 row statistics", "LN1 + qkv product", "q pool + head LN",
               "k / v pools + head LN", "pooled attention + q", "proj product + x",
               "LN2 row statistics", "LN2 + fc1 product + GELU", "fc2 product + y1")


def kernel_events(fn, calls):
    """The device-side kernel events of ``calls`` calls of ``fn``, in launch
    order, as (kernel name, device microseconds) (torch.profiler, CUPTI)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith(("Memcpy", "Memset"))]
    events.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in events]


def k4_launch_table(smi, dev="cuda", group=32, calls=3):
    """Device time of each launch inside one fused_multiscale_block call, per
    production geometry at the ``group`` chunks the main path runs, bf16:
    ``calls`` calls are traced and each launch's kernel events averaged by
    their place in the call; the whole call is timed apart, replayed as a
    CUDA graph (device_ms), with its TFLOP/s over k4_work. Says where a
    block's time is. A trace that does not hold every launch of every call
    leaves the per-launch times unmeasured and says so; the whole call's time
    does not depend on it."""
    import torch

    out = {}
    for hw, c, nh, n_blocks in MSBLOCK_SHAPES:
        s_cells = hw[0] * hw[1]
        blk, x = msblock_case(hw, c, nh, torch.bfloat16, dev, b=group)
        with torch.no_grad():
            call = lambda: run_msblock("kernel", blk, x, VIDEO_T, hw, nh)  # noqa: E731
            events = kernel_events(call, calls)
            whole = device_ms(call, iters=5)
        n = len(K4_LAUNCHES)
        per_call = [events[i * n:(i + 1) * n] for i in range(calls)]
        traced = len(events) == calls * n and all(
            [name for name, _ in one] == [name for name, _ in per_call[0]] for one in per_call)
        rows = [dict(launch=i + 1, name=name,
                     kernel=per_call[0][i][0][:80] if traced else None,
                     ms=sum(one[i][1] for one in per_call) / calls / 1e3 if traced else None)
                for i, name in enumerate(K4_LAUNCHES)]
        flops, _ = k4_work(group, s_cells, c, VIDEO_T)
        label = f"S={s_cells} C={c} heads={nh}"
        log(f"K4 launches, {label}, {group} chunks bf16 (x{n_blocks} per forward): whole call "
            f"{whole:.4f} ms, {flops / whole / 1e9:.1f} TFLOP/s over k4_work ({smi})")
        if traced:
            busy = sum(r["ms"] for r in rows)
            for r in rows:
                log(f"  {r['launch']:2d} {r['ms']:9.4f} ms {100 * r['ms'] / busy:5.1f}%  "
                    f"{r['name']}  [{r['kernel'][:40]}]")
        else:
            log(f"  per-launch times not measured: the trace holds {len(events)} kernel events "
                f"for {calls} calls of {n} launches")
        out[label] = dict(rows=rows, total_ms=whole, tflops=flops / whole / 1e9,
                          blocks=n_blocks, traced=traced)
        del blk, x, call
        torch.cuda.empty_cache()
    per_forward = sum(v["total_ms"] * v["blocks"] for v in out.values())
    total_flops = sum(k4_work(group, hw[0] * hw[1], c, VIDEO_T)[0] * n
                      for hw, c, _, n in MSBLOCK_SHAPES)
    log(f"K4, the 18 blocks of one {group}-chunk forward: {per_forward:.3f} ms, "
        f"{total_flops / per_forward / 1e9:.1f} TFLOP/s over k4_work ({smi})")
    REPORT["k4_launch_table"] = dict(card=smi, chunks=group, shapes=out,
                                     forward_ms=per_forward,
                                     forward_tflops=total_flops / per_forward / 1e9)
    return REPORT["k4_launch_table"]


# ------------------------------------------------------------ video slice

def video_launches(n_chunks, group, batched_back, n_k4=18, n_k3_front=2, n_k3_back=1):
    """Launches of one hybrid_apply call of mvit_v2_b: the patch embed and
    the two K3 front blocks once per chunk group, then the 18 K4 blocks and
    the K3 block 23 once per group (batched back) or per chunk."""
    groups = -(-n_chunks // group) if n_chunks > group else 1
    backs = groups if batched_back else n_chunks
    return {"patch_embed": groups, "pooled_attention": n_k3_front * groups + n_k3_back * backs,
            "multiscale_block": n_k4 * backs}


@contextlib.contextmanager
def main_path_entries():
    """While the main path runs, K3's band-array entry and K2's f32-frame
    entry raise: the forward must take K3's table entry (no band array is
    built) and K2's uint8 entry (no f32 frames are made)."""
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_attention as k3
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import patch_embed as k2

    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"{name} was called on the main path")
        return call

    saved = k3.fused_pooled_attention, k2.fused_patch_embed
    k3.fused_pooled_attention = refuse("K3's band-array entry")
    k2.fused_patch_embed = refuse("K2's f32-frame entry")
    try:
        yield
    finally:
        k3.fused_pooled_attention, k2.fused_patch_embed = saved


def video_routes(counts, on_card):
    """K3's launches by the kernel the C entry reports it took, since the
    last reset, against the main path's: every one the wgmma kernel with the
    band from the table. Fails otherwise."""
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_attention as k3

    got = dict(k3.ROUTES)
    want = {k3.ROUTE_NAMES[2]: counts["pooled_attention"]} if on_card else {}
    if got != want:
        fail(f"K3 routes {got}, expected {want}")
    return got


def video_model(dtype, temporal_size=VIDEO_T, seed=0):
    from audio_visual_deepfake_detection_tpu_torch.frontends.mvit import init_mvit, mvit_v2_b

    return init_mvit(mvit_v2_b(temporal_size=temporal_size, dtype=dtype), seed, perturb=True)


def phase_video(dev="cuda", n_chunks=16, smi=""):
    """The video slice's main path: MViT-v2-b at full width and depth, bf16,
    through FeatureExtractor.video_chunks_features on uint8 chunks; then f32
    on one 32-frame chunk, card against the CPU plain path."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.frontends import pipeline

    ex = pipeline.FeatureExtractor(video_model=video_model(torch.bfloat16), device=dev)
    rng = np.random.default_rng(5)
    chunks = rng.integers(0, 256, (n_chunks, VIDEO_T, 96, 96, 3), dtype=np.uint8)
    chunks[-1, VIDEO_T // 2:] = 0                    # a zero-padded tail chunk
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    with main_path_entries():
        feats = ex.video_chunks_features(chunks)
    sync(dev)
    wall = time.perf_counter() - t0
    on_card = torch.device(dev).type == "cuda"
    expect = video_launches(n_chunks, pipeline.FRONT_CHUNK_GROUP, True)
    counts = {k: launch_counts()[k] for k in expect}
    routes = video_routes(expect, on_card)
    if not on_card:
        expect = {k: 0 for k in expect}
    log(f"video: {n_chunks} uint8 chunks x {VIDEO_T} frames -> {feats.shape} bf16 in "
        f"{wall:.2f} s (first call), launches {counts} (expected {expect}), K3 routes "
        f"{routes} ({smi})")
    if feats.shape != (n_chunks, VIDEO_T, 256) or not np.isfinite(feats).all():
        fail(f"video features {feats.shape}, finite={np.isfinite(feats).all()}")
    if counts != expect:
        fail(f"video kernel launches {counts}, expected {expect}")

    # f32, one short chunk: the card's kernels vs the CPU plain path
    m32 = video_model(torch.float32, temporal_size=32, seed=1)
    clip = rng.integers(0, 256, (1, 32, 96, 96, 3), dtype=np.uint8)
    cpu = pipeline.FeatureExtractor(video_model=m32, device="cpu").video_chunks_features(clip)
    reset_counts()
    gpu = pipeline.FeatureExtractor(video_model=m32, device=dev).video_chunks_features(clip)
    e32 = video_launches(1, pipeline.FRONT_CHUNK_GROUP, True)
    c32 = {k: launch_counts()[k] for k in e32}
    if torch.device(dev).type != "cuda":
        e32 = {k: 0 for k in e32}
    d = np.abs(gpu - cpu)
    ok = bool((d <= 1e-4 + 5e-4 * np.abs(cpu)).all())
    log(f"video f32, 1 chunk x 32 frames: card vs CPU plain max|d|={d.max():.3e} "
        f"(atol 1e-4 rtol 5e-4) {'ok' if ok else 'MISMATCH'}, launches {c32} "
        f"(expected {e32})")
    # without the kernels this would hold the plain path against itself
    if c32 != e32:
        fail(f"video f32 kernel launches {c32}, expected {e32}")
    if not ok:
        fail("video f32 card vs CPU plain path differ")
    REPORT["video"] = dict(chunks=n_chunks, first_call_s=wall, launches=counts,
                           f32_max_abs_err=float(d.max()), f32_launches=c32)
    return ex, counts


def mvit_breakdown(model, x_u8, smi):
    """CUDA-event time of each stage of one batched MViT-v2-b forward (the
    patch embed, each block with its route, the final LN and mean) after a
    warm-up forward: where the encoder's time goes, layer by layer."""
    import torch

    def routes():
        thw = model.patch_grid(x_u8.shape)
        out = []
        for blk in model.blocks:
            k4 = blk.fused_geometry_ok(thw, 1 + thw[0] * thw[1] * thw[2])
            out.append("K4" if k4 else "eager" if max(blk.cfg.stride_q) > 1 else "K3")
            thw = tuple((a + st - 1) // st for a, st in zip(thw, blk.cfg.stride_q))
        return out

    def forward(record):
        thw = model.patch_grid(x_u8.shape)
        stages = [("patch embed", lambda t: (model.embed(x_u8), thw))]
        for i, blk in enumerate(model.blocks):
            stages.append((f"block {i}", blk.__call__))
        names, marks = [], []
        tok = None
        for name, fn in stages:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tok, thw = fn(tok) if name == "patch embed" else fn(tok, thw)
            end.record()
            names.append(name)
            marks.append((start, end))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model.encode_back(tok, thw, len(model.blocks))
        end.record()
        names.append("final LN + mean")
        marks.append((start, end))
        torch.cuda.synchronize()
        return names, [s.elapsed_time(e) for s, e in marks] if record else None

    with torch.no_grad():
        forward(False)
        names, ms = forward(True)
    route = ["K2"] + routes() + ["eager"]
    total = sum(ms)
    log(f"MViT-v2-b bf16 breakdown, {x_u8.shape[0]} chunks batched: {total:.2f} ms ({smi})")
    rows = []
    for name, r, t in zip(names, route, ms):
        rows.append(dict(stage=name, route=r, ms=t))
        log(f"  {name:16s} {r:5s} {t:9.3f} ms  {100 * t / total:5.1f}%")
    by_route = {}
    for row in rows:
        by_route[row["route"]] = by_route.get(row["route"], 0.0) + row["ms"]
    log(f"  by route: " + ", ".join(f"{k} {v:.2f} ms" for k, v in by_route.items()))
    return dict(total_ms=total, stages=rows, by_route=by_route)


LIBRARY_NAMES = {"patch_embed": "F.conv3d bf16",
                 "pooled_attention": "scaled_dot_product_attention + q (nearest, not one call)"}


def library_call(kname, args):
    """The PyTorch yardstick of a main-path K2 / K3 case, made outside the
    timing (None for K4: no PyTorch call computes a whole block)."""
    if kname == "patch_embed":
        return conv3d_library(*args[:3])
    if kname == "pooled_attention":
        return k3_library(*args)
    return None


def phase_mvit_timing(smi, dev="cuda"):
    """Each new kernel against its plain version per production shape (CUDA
    events, plain / kernel / kernel / plain), K1's tiled dense path at T=48
    and both dense paths at T=24, then MViT-v2-b chunks/s (bf16) at 16 and
    64 chunks with the back stages per chunk and batched."""
    import torch
    import torch.nn.functional as F
    from audio_visual_deepfake_detection_tpu_torch.frontends import mvit, pipeline
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as fb

    per_shape, totals, works = [], {}, {}
    library, device_totals = {}, {}
    for kname, label, n_blocks, make, run, work in mvit_cases(dev):
        args = make(torch.bfloat16)
        # the plain K4 time swings from run to run (46.7-90.4 ms per forward
        # across otherwise equal runs): take the median of 6 interleaved
        # readings each, and keep the spread
        ms = {}
        for which in ("plain", "kernel", "kernel", "plain") * 3:
            # ten kernel calls a reading: with three, the first call's host
            # time is a tenth of a short kernel's reading
            ms.setdefault(which, []).append(cuda_ms(
                lambda: run(which, *args), 10 if which == "kernel" else 3, warmup=1))
        k_ms, p_ms = float(np.median(ms["kernel"])), float(np.median(ms["plain"]))
        with torch.no_grad():
            d_ms = device_ms(lambda: run("kernel", *args))
        device_totals[kname] = device_totals.get(kname, 0.0) + d_ms * n_blocks
        tot = totals.setdefault(kname, [0.0, 0.0])
        tot[0] += k_ms * n_blocks
        tot[1] += p_ms * n_blocks
        works.setdefault(kname, []).append((*work, n_blocks))
        b_ms, b_by = bound(*work)
        row = dict(kernel=kname, shape=label, blocks=n_blocks, kernel_ms=k_ms, device_ms=d_ms,
                   plain_ms=p_ms, kernel_range=[min(ms["kernel"]), max(ms["kernel"])],
                   plain_range=[min(ms["plain"]), max(ms["plain"])], bound_ms=b_ms,
                   bound_by=b_by)
        extra = ""
        lib_fn = library_call(kname, args)
        if lib_fn is not None:
            row["library_ms"] = cuda_ms(lib_fn, 3, warmup=1)
            library[kname] = library.get(kname, 0.0) + row["library_ms"] * n_blocks
            extra = f"  {LIBRARY_NAMES[kname]} {row['library_ms']:.4f} ms"
        del lib_fn
        per_shape.append(row)
        log(f"time {kname} {label} bf16, median of 6: kernel {k_ms:.4f} ms "
            f"[{min(ms['kernel']):.4f}, {max(ms['kernel']):.4f}] (its kernels alone "
            f"{d_ms:.4f} ms)  plain {p_ms:.4f} ms "
            f"[{min(ms['plain']):.4f}, {max(ms['plain']):.4f}]  bound {b_ms:.4f} ms ({b_by})"
            f"{extra} (x{n_blocks} per forward) ({smi})")
        del args
        torch.cuda.empty_cache()
    bounds = {k: bound_sum(v) for k, v in works.items()}

    # K2 and K3 at the 32 chunks a group of the main path hands them (K4's
    # time there comes from k4_launch_table): kernel, its kernels alone and
    # the library yardstick, per forward
    group_ms, group_dev, group_lib, group_works = {}, {}, {}, {}
    with torch.no_grad():
        for kname, label, n_blocks, make, run, work in mvit_cases(dev, pipeline.FRONT_CHUNK_GROUP):
            if kname == "multiscale_block":
                continue
            args = make(torch.bfloat16)
            k_ms = cuda_ms(lambda: run("kernel", *args), 3, warmup=1)
            d_ms = device_ms(lambda: run("kernel", *args), iters=5)
            lib_fn = library_call(kname, args)
            l_ms = cuda_ms(lib_fn, 3, warmup=1)
            del lib_fn
            group_ms[kname] = group_ms.get(kname, 0.0) + k_ms * n_blocks
            group_dev[kname] = group_dev.get(kname, 0.0) + d_ms * n_blocks
            group_lib[kname] = group_lib.get(kname, 0.0) + l_ms * n_blocks
            group_works.setdefault(kname, []).append((*work, n_blocks))
            log(f"time {kname} {label} bf16: kernel {k_ms:.4f} ms (its kernels alone {d_ms:.4f} "
                f"ms), bound {bound(*work)[0]:.4f} ms ({bound(*work)[1]}), "
                f"{LIBRARY_NAMES[kname]} {l_ms:.4f} ms (x{n_blocks} per forward) ({smi})")
            del args
            torch.cuda.empty_cache()
    group = {k: dict(ms=v, device_ms=group_dev[k], library_ms=group_lib[k],
                     bound_ms=bound_sum(group_works[k])[0], bound_by=bound_sum(group_works[k])[1])
             for k, v in group_ms.items()}
    for k, v in group.items():
        log(f"{k}, one {pipeline.FRONT_CHUNK_GROUP}-chunk forward: {v['ms']:.3f} ms (kernels "
            f"alone {v['device_ms']:.3f}), bound {v['bound_ms']:.3f} ms ({v['bound_by']}), "
            f"{LIBRARY_NAMES[k]} {v['library_ms']:.3f} ms ({smi})")

    dense = {}
    for t in (48, 24):
        x, xo, mask, packed = block_case("ds_self", t, -1, 512, torch.bfloat16, dev, seed=t)
        k_ms = cuda_ms(lambda: run_block("kernel", x, xo, mask, packed, "ds_self", -1), 10)
        p_ms = cuda_ms(lambda: run_block("plain", x, xo, mask, packed, "ds_self", -1), 10)
        dense[f"T={t}"] = dict(kernel_ms=k_ms, plain_ms=p_ms)
        log(f"time K1 dense ds_self B=512 T={t} bf16: kernel {k_ms:.4f} ms "
            f"plain {p_ms:.4f} ms ({smi})")

    rates = {}
    rng = np.random.default_rng(9)
    ex = pipeline.FeatureExtractor(video_model=video_model(torch.bfloat16), device=dev)

    def features(x, batched):
        """The extractor's path (back stages batched), or the same chunks
        with the back stages run one chunk at a time."""
        if batched:
            return ex.video_chunks_features_device(x)
        return mvit.hybrid_apply(ex.video_model, x, front_group=pipeline.FRONT_CHUNK_GROUP,
                                 batched_back=False)

    for n in (16, 64):
        x = torch.from_numpy(rng.integers(0, 256, (n, VIDEO_T, 96, 96, 3),
                                          dtype=np.uint8)).to(dev)
        for batched in (False, True) if n == 16 else (True,):   # per chunk: 16 only
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                features(x, batched)                    # warm-up
            runs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    features(x, batched)
                torch.cuda.synchronize()
                runs.append(n / (time.perf_counter() - t0))
            key = f"{n} chunks, batched_back={batched}"
            rates[key] = max(runs)
            log(f"MViT-v2-b bf16 {key}: {max(runs):.2f} chunks/s (runs "
                f"{[round(r, 2) for r in runs]}, peak mem "
                f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB) ({smi})")
            torch.cuda.empty_cache()
        del x
    x = torch.from_numpy(rng.integers(0, 256, (16, VIDEO_T, 96, 96, 3), dtype=np.uint8)).to(dev)
    breakdown = mvit_breakdown(ex.video_model, x, smi)
    profile = profile_forward(lambda: ex.video_chunks_features_device(x),
                              16e3 / rates["16 chunks, batched_back=True"], smi,
                              label="one 16-chunk MViT-v2-b forward, bf16", top_n=25)
    REPORT["mvit_timing"] = dict(per_shape=per_shape, totals=totals, k1_dense=dense,
                                 chunks_per_s=rates, profile=profile, breakdown=breakdown,
                                 bounds=bounds, library_ms=library, card=smi,
                                 group_of_32=group, device_totals=device_totals)
    return totals, bounds, library, group


# ------------------------------------------------------------ audio kernels

WAV_LEN = 153600                      # 9.6 s at 16 kHz
WAV_ODD = 16000 + 7                   # an odd tail: no layer's length divides evenly
E2V_T, E2V_H, E2V_D = 479, 12, 64     # Emotion2Vec frames of 9.6 s, heads, head dim
BYOLA_ROWS, EMO_ROWS = 119, 479       # dataset row truncation of a 9.6 s video
K8_F32_ATOL = 2e-5                    # rtol 0 (tests/test_full_attention.py)
# bf16 K8 per element, against the f32 function of the same bf16 inputs
# alone: what the kernel's own roundings can do at most. Rounding to bf16 (8
# significant bits) moves a value by at most 2^-8 of it. With p the exact
# softmax weights and A = sum_j p_j |v_j|, the kernel rounds the exps before
# P.V (2^-8 A), sums z from them (2^-8 |out|) and rounds its output (2^-8
# |out|): |kernel - f32| <= 1e-5 + 2^-8 (A + 2 |out|), the 1e-5 for the f32
# sums. The inputs here give outputs of std ~0.075 and A ~0.8, so an absolute
# 5e-2 would pass almost anything. Beside it the distributional rule: the
# kernel no further than the plain version from the f32 function (NO_WORSE).
K8_BF16_ATOL, K8_BF16_U = 1e-5, 2.0 ** -8
K8_RULES = {"float32": f"atol {K8_F32_ATOL:g}",
            "bfloat16": "|kernel - f32| <= 1e-5 + 2^-8 (sum_j p_j |v_j| + 2 |f32|), and within "
                        "1.5x of plain vs f32 (max, median)"}
# a bf16 kernel may be this much further than its plain version from the
# same function in f32 (max and median |d|), where the two are compared
# through that reference
NO_WORSE = 1.5
# peaks of one H100 SXM for the bounds: dense bf16 tensor cores, f32 outside
# them, HBM3
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def bound(flops, nbytes, peak=PEAK_BF16):
    """(least ms the card could take, 'operations' or 'bytes'): the larger of
    operations over the peak rate and bytes moved (each input read once, each
    output written once) over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bound_sum(works):
    """The bound of a series of launches, [(operations, bytes, count), ...]:
    the sum of each launch's bound; named after the side that makes up more
    of it."""
    parts = [(bound(f, n), c) for f, n, c in works]
    total = sum(ms * c for (ms, _), c in parts)
    by_ops = sum(ms * c for (ms, by), c in parts if by == "operations")
    return total, "operations" if 2 * by_ops >= total else "bytes"


def k1_work(mode, t, window, b, c=256, nbytes=2):
    """One localizer block on (b, t, c) outputs: 24 c^2 multiply-adds a row
    for q, k, v, proj and the 4x MLP, 4 c a key for scores and P.V over
    2 w + 1 keys (all t when dense), the three depthwise k3 convs; reads x
    (twice the rows when downsampling), the cross input when there is one,
    the mask and 12 c^2 weights, writes the output."""
    keys = t if window < 0 else window + 1
    flops = b * t * (2 * 12 * c * c + 4 * c * keys + 2 * 3 * 3 * c)
    rows_in = b * t * (2 if mode == "ds_self" else 1)
    cross = b * t if mode in ("qv_k", "kv") else 0
    return flops, (rows_in + cross + b * t) * c * nbytes + 12 * c * c * nbytes + rows_in


def k1_work_total(b):
    """Operations of one forward's 18 blocks at batch b."""
    return sum(k1_work(mode, t, window, b)[0] * len(names)
               for names, mode, t, window in PROD_BLOCKS)


def k2_work(n, t=512, nbytes=2, in_bytes=4):
    """Patch embed: uint8 (in_bytes 1) or f32 video in, (n, t, 8, 8, 96) out,
    3 x 15 x 15 x 3 taps."""
    out = n * t * 64 * 96
    return 2 * out * 2025, n * t * 96 * 96 * 3 * in_bytes + out * nbytes + 96 * 2025 * nbytes


def k3_work(bh, ng, d, band_bytes, nk=513, nbytes=2):
    """K3 with the band given: scores and P.V over nk keys; q, k, v, the
    band array and the output."""
    return 4 * bh * ng * nk * d, \
        bh * (2 * ng * d + 2 * nk * d) * nbytes + bh * ng * (nk - 1) * band_bytes


def k3_table_work(bh, ng, d, nk=513, nbytes=2):
    """K3 with the band from the table: scores, band and P.V, 6 ng nk d
    operations a (sample, head); q, k, v, the 2 (nk - 1) - 1 table rows and
    the output."""
    return 6 * bh * ng * nk * d, \
        bh * (2 * ng * d + 2 * nk * d) * nbytes + (2 * (nk - 1) - 1) * d * nbytes


def k4_work(n, s, c, t=512, nbytes=2):
    """One whole MultiscaleBlock: 24 c^2 a row for qkv, proj and the MLP,
    6 c a key for scores, band and P.V over 513 keys, 3 x 27 pool taps."""
    rows = n * (1 + t * s)
    flops = rows * (2 * 12 * c * c + 6 * c * (t + 1) + 2 * 81 * c)
    return flops, 2 * rows * c * nbytes + 12 * c * c * nbytes


def k5_work(b, length, nbytes=2):
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import conv_extractor as k5

    lens = k5.layer_lengths(length)
    flops = sum(2 * b * t * 512 * k * (512 if i else 1)
                for i, (t, (_, k, _)) in enumerate(zip(lens, k5.CONV_SPEC)))
    weights = sum(512 * k * (512 if i else 1) for i, (_, k, _) in enumerate(k5.CONV_SPEC))
    return flops, b * length * 4 + b * lens[-1] * 512 * nbytes + weights * nbytes


def k8_work(b, h, t, d, masked, nbytes=2):
    return 4 * b * h * t * t * d, 4 * b * h * t * d * nbytes + (b * t if masked else 0)


def k5_case(b, length, dtype, dev, seed=0):
    """The production extractor with seeded weights (LN affines 1 + 0.2 N,
    0.1 N) and b wavs; the last wav's final third is silence, as a shorter
    file zero-padded into a batch."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.frontends.emotion2vec import (
        ConvFeatureExtractor)

    g = torch.Generator().manual_seed(seed)
    m = ConvFeatureExtractor(dtype=dtype)
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() == 3:
                p.copy_(torch.randn(p.shape, generator=g) * p[0].numel() ** -0.5)
        for i, layer in enumerate(m.conv_layers):
            ln = layer[2][1]
            ln.weight.copy_(1 + 0.2 * torch.randn(ln.weight.shape, generator=g))
            ln.bias.copy_(0.1 * torch.randn(ln.bias.shape, generator=g))
    wav = 0.1 * torch.randn((b, length), generator=g)
    wav[-1, (2 * length) // 3:] = 0
    return m.to(dev), wav.to(dev)


def run_k5(which, m, wav):
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import conv_extractor as k5

    if which == "kernel":
        return k5.fused_conv_extractor(wav, m.packed())
    return k5.conv_extractor_math(wav, m._weights(), m._ln_rows(), m.dtype)


def k5_exact(m, wav, group=8):
    """K5's function in f32 on the bf16 kernel's inputs (wav and weights
    rounded to bf16, no rounding after that), a few wavs at a time."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import conv_extractor as k5

    bf16 = torch.bfloat16
    with torch.no_grad():
        ws = [w.to(bf16).float() for w in m._weights()]
        return torch.cat([k5.conv_extractor_math(wav[i:i + group].to(bf16).float(), ws,
                                                 m._ln_rows(), torch.float32)
                          for i in range(0, wav.shape[0], group)])


def against_exact(got, ref, exact):
    """The kernel's and the plain version's distance from the same function
    in f32. Returns (ok, text): ok when the kernel's max and median |d| are
    at most NO_WORSE times the plain version's."""
    import torch

    g, r = (got.float() - exact).abs(), (ref.float() - exact).abs()
    if not torch.isfinite(g).all():
        return False, "non-finite"
    gm, gmed, rm, rmed = g.max().item(), g.median().item(), r.max().item(), r.median().item()
    ok = gm <= NO_WORSE * rm and gmed <= NO_WORSE * rmed
    return ok, (f"vs f32: kernel max {gm:.3e} median {gmed:.3e}, plain max {rm:.3e} "
                f"median {rmed:.3e}")


def check_k5_bf16(m, wav, got, ref):
    """check_bf16; where that fails, the kernel must be no further than the
    plain version from the f32 function. Returns (max |d|, ok, the rule that
    decided, the readings)."""
    err, ok, rule = check_bf16(got, ref)
    near, text = against_exact(got.detach(), ref.detach(), k5_exact(m, wav))
    if ok:
        return err, True, rule.split(" (")[0], f"{rule}; {text}"
    rule = f"kernel within {NO_WORSE:g}x of plain vs f32"
    return err, near, rule, f"{rule[:-7]} {text}"


def check_k8(got, ref, q, k, v, mask):
    """f32: atol K8_F32_ATOL. bf16: the rounding bound of K8_RULES per
    element, and the kernel no further than the plain version from the f32
    function."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import full_attention as k8

    name = str(got.dtype).split(".")[-1]
    if not torch.isfinite(got.float()).all():
        return float("inf"), False, "non-finite"
    err = (got.float() - ref.float()).abs().max().item()
    if got.dtype == torch.float32:
        return err, err <= K8_F32_ATOL, K8_RULES[name]
    with torch.no_grad():
        exact = k8.full_mha_math(q.float(), k.float(), v.float(), mask)
        spread = k8.full_mha_math(q.float(), k.float(), v.float().abs(), mask)
    near, text = against_exact(got, ref, exact)
    bound = K8_BF16_ATOL + K8_BF16_U * (spread + 2 * exact.abs())
    over = int(((got.float() - exact).abs() > bound).sum())
    return err, near and over == 0, \
        f"{over} beyond the rounding bound against f32; std(ref) {ref.float().std():.3f}; {text}"


def k8_case(b, t, dtype, dev, masked, seed=0, h=E2V_H, d=E2V_D):
    """q (pre-scaled), k, v as AltAttention hands them over: strided views of
    one (b, t, 3, h, d) projection output. The mask pads the last sample's
    final third."""
    import torch

    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, t, 3, h, d), generator=g)
    qkv[:, :, 0] *= d ** -0.5
    q, k, v = qkv.to(dev, dtype).permute(2, 0, 3, 1, 4)
    mask = None
    if masked:
        lens = torch.tensor([t] * (b - 1) + [(2 * t) // 3])
        mask = (torch.arange(t)[None, :] >= lens[:, None]).to(dev)
    return q, k, v, mask


def run_k8(which, q, k, v, mask):
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import full_attention as k8

    return (k8.full_mha if which == "kernel" else k8.full_mha_math)(q, k, v, mask)


K8_CASES = ((2, E2V_T), (2, 130), (2, 50), (1, 2000))   # (B, T): two production lengths,
# one shorter than a key tile, one past the 1600 rows the first design could hold


K8_MANY_B = 5462        # x 12 heads = 65,544 (sample, head) pairs


def check_k8_all_masked(dtype, dev, t=130):
    """A sample whose keys are all masked: the plain version's softmax of
    -inf is NaN there, the kernel gives uniform weights (the mean of v), as
    the TPU kernel does. The other samples go through check_k8."""
    import torch

    q, k, v, mask = k8_case(3, t, dtype, dev, True, seed=3 * t)
    mask[1] = True
    got = run_k8("kernel", q, k, v, mask)
    sync(dev)
    keep = torch.tensor([0, 2], device=q.device)
    err, ok, rule = check_k8(got[keep], run_k8("plain", q[keep], k[keep], v[keep], mask[keep]),
                             q[keep], k[keep], v[keep], mask[keep])
    mean = v[1].float().mean(1, keepdim=True).expand_as(got[1])
    d = (got[1].float() - mean).abs()
    tol = K8_F32_ATOL if dtype == torch.float32 else K8_BF16_ATOL + K8_BF16_U * mean.abs()
    uniform = bool(torch.isfinite(got).all()) and bool((d <= tol).all())
    return max(err, d.max().item()), ok and uniform, \
        f"{rule}; all-masked sample vs mean(v) {d.max().item():.2e}"


K5_BATCHES = (2, 16, 64)   # a pair, the audio phase's 16 wavs, the main path's 64


def phase_audio_kernels(dev="cuda", lengths=(WAV_LEN, WAV_ODD), cases=K8_CASES,
                        k5_batches=K5_BATCHES):
    """K5 against conv_extractor_math at B = 2, 16 and 64 (the persistent
    tiles' ragged last wave), a 9.6 s wav and one with an odd tail, f32 (atol
    1e-4, rtol 5e-4) and bf16 (check_k5_bf16); K8 against
    full_mha_math at (2, 12, 479 | 130 | 50, 64) and (1, 12, 2000, 64), with
    and without a padding mask, with one sample fully masked, and in bf16 at
    more than 65,535 (sample, head) pairs; f32 atol 2e-5 and bf16 the rounding
    bound and the f32 reference (check_k8)."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import conv_extractor as k5

    worst = {k: {"float32": 0.0, "bfloat16": 0.0} for k in ("conv_extractor", "full_mha")}
    rows = []

    def record(kname, label, dtype, err, ok, rule):
        dname = str(dtype).split(".")[-1]
        worst[kname][dname] = max(worst[kname][dname], err)
        rows.append(dict(kernel=kname, shape=label, dtype=dname, max_abs_err=err, ok=ok,
                         rule=rule))
        log(f"{kname} vs plain {label} {dname:8s} max|d|={err:.3e} [{rule}] "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            REPORT["audio_kernels"] = rows
            fail(f"{kname} disagrees with its plain version: {label} {dname}")

    for b in k5_batches:
        for length in lengths:
            for dtype in (torch.float32, torch.bfloat16):
                with torch.no_grad():
                    m, wav = k5_case(b, length, dtype, dev, seed=length + b)
                    got, ref = run_k5("kernel", m, wav), run_k5("plain", m, wav)
                    sync(dev)
                    t_out = k5.conv_output_length(length)
                    if tuple(got.shape) != (b, t_out, 512) or got.dtype != dtype:
                        fail(f"conv extractor output {tuple(got.shape)} {got.dtype}")
                    if dtype == torch.float32:
                        err, ok = check_f32(got, ref)
                        rule = "atol 1e-4 rtol 5e-4"
                    else:
                        err, ok, _, rule = check_k5_bf16(m, wav, got, ref)
                record("conv_extractor", f"B={b} L={length} -> {t_out} x 512", dtype, err, ok,
                       rule)
                del m, wav, got, ref
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    for b, t in cases:
        for masked in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                args = k8_case(b, t, dtype, dev, masked, seed=t)
                got, ref = run_k8("kernel", *args), run_k8("plain", *args)
                sync(dev)
                err, ok, rule = check_k8(got, ref, *args)
                record("full_mha", f"({b}, {E2V_H}, {t}, {E2V_D}) {'mask' if masked else 'no mask'}",
                       dtype, err, ok, rule)
                del args, got, ref
    # on the card only: the plain version, which a CPU tensor takes, gives NaN there
    for dtype in (torch.float32, torch.bfloat16) if torch.device(dev).type == "cuda" else ():
        err, ok, rule = check_k8_all_masked(dtype, dev)
        record("full_mha", f"(3, {E2V_H}, 130, {E2V_D}) one sample all masked", dtype, err, ok,
               rule)
    if torch.device(dev).type == "cuda":
        # more (sample, head) pairs than a grid's second axis takes (65,535)
        args = k8_case(K8_MANY_B, 50, torch.bfloat16, dev, True, seed=8, d=32)
        got, ref = run_k8("kernel", *args), run_k8("plain", *args)
        sync(dev)
        record("full_mha", f"({K8_MANY_B}, {E2V_H}, 50, 32) mask", torch.bfloat16,
               *check_k8(got, ref, *args))
        del args, got, ref
        torch.cuda.empty_cache()
    REPORT["audio_kernels"] = rows
    return worst


# ------------------------------------------------------------- audio slice

AUDIO_KERNELS = ("conv_extractor", "full_mha")
TRAIN_KERNELS = ("fused_transformer_block_train", "band_attention")
ALL_KERNELS = ("fused_transformer_block", "patch_embed", "pooled_attention",
               "multiscale_block") + AUDIO_KERNELS + TRAIN_KERNELS


def kernel_modules():
    """Kernel name -> (wrapper module, its launch counter). K1 and K6 share a
    source and a module, and count apart."""
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import (
        band_attention, conv_extractor, full_attention, fused_block, mvit_attention,
        mvit_block, patch_embed)

    mods = (fused_block, patch_embed, mvit_attention, mvit_block, conv_extractor,
            full_attention, fused_block, band_attention)
    return {name: (m, "TRAIN_LAUNCHES" if name == "fused_transformer_block_train"
                   else "LAUNCHES") for name, m in zip(ALL_KERNELS, mods)}


def reset_counts():
    for m, _ in kernel_modules().values():
        m.reset_launches()


def launch_counts():
    return {name: getattr(m, attr) for name, (m, attr) in kernel_modules().items()}


def audio_models(dtype, seed=0, d=2048, cfg=None):
    from audio_visual_deepfake_detection_tpu_torch.frontends.byola import (
        AudioNTT2020, init_byola)
    from audio_visual_deepfake_detection_tpu_torch.frontends.emotion2vec import (
        Emotion2Vec, Emotion2VecConfig, init_emotion2vec)

    cfg = cfg or Emotion2VecConfig()
    return (init_byola(AudioNTT2020(d=d, dtype=dtype), seed, perturb=True),
            init_emotion2vec(Emotion2Vec(cfg, dtype=dtype), seed + 1, perturb=True))


def phase_audio(video, dev="cuda", n_wavs=16, wav_len=WAV_LEN, smi="", models=None,
                models32=None):
    """The audio slice's main path: production-width BYOL-A and Emotion2Vec
    (12 AltBlocks), bf16, ``n_wavs`` wavs of 9.6 s through a FeatureExtractor
    that also holds the video model ``video``: shapes, finiteness, K5 once
    and K8 twelve times per forward; then f32 on a padded pair of 2 s and
    1.5 s wavs, the card's kernels against the CPU plain path."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.frontends import pipeline
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import conv_extractor as k5

    on_card = torch.device(dev).type == "cuda"
    by_m, emo_m = models or audio_models(torch.bfloat16)
    n_blocks = len(emo_m.blocks) + len(emo_m.audio.context_encoder.blocks)
    ex = pipeline.FeatureExtractor(video_model=video, byola_model=by_m, emotion_model=emo_m,
                                   device=dev)
    rng = np.random.default_rng(11)
    wavs = (rng.standard_normal((n_wavs, wav_len)) * 0.1).astype(np.float32)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    by = ex.byola_features_device(wavs)
    emo = ex.emotion_features_device(wavs)
    sync(dev)
    wall = time.perf_counter() - t0
    got = launch_counts()
    expect = dict.fromkeys(ALL_KERNELS, 0)
    if on_card:
        expect.update(conv_extractor=1, full_mha=n_blocks)
    rows_by, rows_emo = (1 + wav_len // 160) // 8, k5.conv_output_length(wav_len)
    log(f"audio: {n_wavs} wavs of {wav_len} samples -> BYOL-A {tuple(by.shape)}, Emotion2Vec "
        f"{tuple(emo.shape)} in {wall:.2f} s (first call), launches {got} ({smi})")
    if tuple(by.shape) != (n_wavs, rows_by, by_m.d) or \
            tuple(emo.shape) != (n_wavs, rows_emo, emo_m.cfg.embed_dim):
        fail(f"audio feature shapes {tuple(by.shape)} {tuple(emo.shape)}")
    if by.dtype != torch.float32 or emo.dtype != torch.float32 or \
            not (torch.isfinite(by).all() and torch.isfinite(emo).all()):
        fail("audio features are not finite f32")
    if got != expect:
        fail(f"audio kernel launches {got}, expected {expect}")

    # f32, a zero-padded pair of wavs: the card's kernels vs the CPU plain path
    by32, emo32 = models32 or audio_models(torch.float32, seed=2)
    pair = [wavs[0, :32000], wavs[1, :24000]]
    cpu = pipeline.FeatureExtractor(byola_model=by32, emotion_model=emo32, device="cpu")
    cpu_out = cpu.byola_features_batch(pair), cpu.emotion_features_batch(pair)
    card = pipeline.FeatureExtractor(byola_model=by32, emotion_model=emo32, device=dev)
    reset_counts()
    card_out = card.byola_features_batch(pair), card.emotion_features_batch(pair)
    c32 = launch_counts()
    errs = {}
    for name, a, b, atol, rtol in (("byola", card_out[0], cpu_out[0], 1e-4, 5e-4),
                                   ("emotion", card_out[1], cpu_out[1], 2e-4, 1e-3)):
        d = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
        ok = all(x.shape == y.shape and bool((np.abs(x - y) <= atol + rtol * np.abs(y)).all())
                 for x, y in zip(a, b))
        errs[name] = d
        log(f"audio f32, wavs of 2 s and 1.5 s, {name}: card vs CPU plain max|d|={d:.3e} "
            f"(atol {atol:g} rtol {rtol:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"audio f32 {name}: card vs CPU plain path differ")
    if c32 != expect:     # else the plain path would be held against itself
        fail(f"audio f32 kernel launches {c32}, expected {expect}")
    REPORT["audio"] = dict(wavs=n_wavs, first_call_s=wall, launches=got, f32_max_abs_err=errs)
    return ex, got


def media_batch(n_videos, n_frames=240, wav_len=WAV_LEN, chunk=None, seed=7):
    """uint8 videos of ``n_frames`` frames, one zero-padded chunk each, and
    their wavs."""
    from audio_visual_deepfake_detection_tpu_torch.frontends.video import chunk_video

    rng = np.random.default_rng(seed)
    chunks = np.concatenate([chunk_video(rng.integers(0, 256, (n_frames, 96, 96, 3),
                                                      dtype=np.uint8), chunk or VIDEO_T)[0]
                             for _ in range(n_videos)])
    wavs = (rng.standard_normal((n_videos, wav_len)) * 0.1).astype(np.float32)
    return chunks, wavs


def media_to_detections(ex, model, fn, chunks, wavs, n_frames=240, duration=9.6):
    """The program of bench.py::measure_e2e on the port: the three encoders,
    the dataset's row truncation, then build_online_inference_fn (device
    resample of each stream to max_seq_len, concat, localizer, decode,
    soft-NMS, voting). Everything stays on the device."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.data.metadata import (
        byola_trunc_rows, emotion_trunc_rows)

    n = chunks.shape[0]
    v = ex.video_chunks_features_device(chunks)[:, :n_frames]
    by = ex.byola_features_device(wavs)[:, :byola_trunc_rows(duration)]
    emo = ex.emotion_features_device(wavs)[:, :emotion_trunc_rows(duration)]
    streams = (v, by, emo)
    rows = [torch.full((n,), s.shape[1], dtype=torch.int32, device=s.device) for s in streams]
    return fn(model, streams, rows, torch.full((n,), duration, device=v.device))


def phase_media_detections(ex, model, cfg, dev="cuda", n_videos=16, n_frames=240,
                           wav_len=WAV_LEN, smi=""):
    """Raw media -> detections with no stand-in: 16 videos of 240 uint8
    frames and their 9.6 s wavs through MViT-v2-b, BYOL-A and Emotion2Vec,
    rows 240 / 119 / 479, build_online_inference_fn. Every kernel of the
    path must launch as often as one forward of each model needs, and every
    video gets a detection at the serving min_score."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.core.config import TestConfig
    from audio_visual_deepfake_detection_tpu_torch.frontends import pipeline
    from audio_visual_deepfake_detection_tpu_torch.infer import build_online_inference_fn

    fn = build_online_inference_fn(cfg, TestConfig(**dict(BENCH_TEST, min_score=0.001)),
                                   1.0, 1.0)
    chunks, wavs = media_batch(n_videos, n_frames, wav_len)
    duration = wav_len / 16000.0
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    with main_path_entries():
        segs, scores, _, valid, vcls = media_to_detections(ex, model, fn, chunks, wavs,
                                                           n_frames, duration)
    n_det = valid.sum(1).cpu().numpy()
    sync(dev)
    wall = time.perf_counter() - t0
    got = launch_counts()
    emo_m = ex.emotion_model
    on_card = torch.device(dev).type == "cuda"
    video_expect = video_launches(n_videos, pipeline.FRONT_CHUNK_GROUP, True)
    routes = video_routes(video_expect, on_card)
    expect = dict(dict.fromkeys(ALL_KERNELS, 0), **video_expect,
                  fused_transformer_block=1 + cfg.arch[1] + 3 * cfg.arch[2], conv_extractor=1,
                  full_mha=len(emo_m.blocks) + len(emo_m.audio.context_encoder.blocks))
    if not on_card:
        expect = dict.fromkeys(expect, 0)
    log(f"media -> detections: {n_videos} videos of {n_frames} frames + {wav_len}-sample wavs, "
        f"detections per video min {n_det.min()} max {n_det.max()}, launches {got}, K3 "
        f"routes {routes}, wall {wall:.3f} s ({smi})")
    if n_det.min() < 1 or not torch.isfinite(vcls).all() or \
            not torch.isfinite(segs[valid]).all() or not torch.isfinite(scores[valid]).all():
        fail("a video got no detection or a non-finite result")
    if segs[valid].min() < 0 or segs[valid].max() > duration + 1e-3:
        fail("segments outside [0, duration]")
    if got != expect:
        fail(f"media -> detections launches {got}, expected {expect}")
    REPORT["media_detections"] = dict(videos=n_videos, wall_s=wall, detections=n_det.tolist(),
                                      launches=got, routes=routes)
    return got


def time_pair(run, rounds=5, iters=3):
    """Kernel and plain interleaved (plain, kernel, kernel, plain, ...):
    per-call ms as {which: (median, min, max)} over ``rounds`` readings each."""
    ms = {"plain": [], "kernel": []}
    order = ("plain", "kernel", "kernel", "plain")
    for i in range(2 * rounds):
        which = order[i % 4]
        ms[which].append(cuda_ms(lambda: run(which), iters, warmup=1))
    return {k: (float(np.median(v)), min(v), max(v)) for k, v in ms.items()}


def eager_conv_stack(m, wav):
    """K5's function as a straightforward eager PyTorch stack in bf16
    (F.conv1d, F.layer_norm, F.gelu): a yardstick, not one library call."""
    import torch
    import torch.nn.functional as F

    x = wav.to(torch.bfloat16)[:, None, :]
    for layer, (_, _, s) in zip(m.conv_layers, m.spec):
        ln = layer[2][1]
        x = F.conv1d(x, layer[0].weight.to(torch.bfloat16), stride=s).transpose(1, 2)
        x = F.gelu(F.layer_norm(x, (512,), ln.weight.to(x.dtype), ln.bias.to(x.dtype), 1e-5))
        x = x.transpose(1, 2)
    return x.transpose(1, 2)


def phase_audio_timing(ex, model, cfg, smi, dev="cuda", batches=(2, 16, 64)):
    """K5 and K8 per call against their plain versions at B = 2, 16 and 64
    (bf16, CUDA events, interleaved, median of 5 with min and max), the
    eager conv stack and the scaled_dot_product_attention call beside them;
    BYOL-A and Emotion2Vec wavs/s at B = 64; media -> detections videos/s at
    16 and 64 videos with peak memory, each broken down by stage."""
    import torch
    import torch.nn.functional as F
    from audio_visual_deepfake_detection_tpu_torch.core.config import TestConfig
    from audio_visual_deepfake_detection_tpu_torch.infer import build_online_inference_fn

    bf16 = torch.bfloat16
    out = {"conv_extractor": {}, "full_mha": {}}
    k5_rules = set()
    with torch.no_grad():     # as the extractor runs them: no autograd graph kept
        for b in batches:
            m, wav = k5_case(b, WAV_LEN, bf16, dev, seed=b)
            got, ref = run_k5("kernel", m, wav), run_k5("plain", m, wav)
            err, ok, decided, rule = check_k5_bf16(m, wav, got, ref)
            k5_rules.add(decided)
            del got, ref
            log(f"conv_extractor vs plain B={b} L={WAV_LEN} bfloat16 max|d|={err:.3e} [{rule}] "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"conv_extractor disagrees with its plain version at B={b}")
            t = time_pair(lambda which: run_k5(which, m, wav))
            eager = cuda_ms(lambda: eager_conv_stack(m, wav), 3, warmup=1)
            k_dev = device_ms(lambda: run_k5("kernel", m, wav), 5)
            bms, by = bound(*k5_work(b, WAV_LEN))
            out["conv_extractor"][b] = dict(ms=t["kernel"][0], ms_range=t["kernel"][1:],
                                            plain_ms=t["plain"][0], plain_range=t["plain"][1:],
                                            eager_stack_ms=eager, bound_ms=bms, bound_by=by,
                                            device_ms=k_dev)
            log(f"time conv_extractor B={b} L={WAV_LEN} bf16, median of 5: kernel "
                f"{t['kernel'][0]:.3f} ms [{t['kernel'][1]:.3f}, {t['kernel'][2]:.3f}] (device "
                f"{k_dev:.3f}, {k5_work(b, WAV_LEN)[0] / k_dev / 1e9:.1f} TFLOP/s)  plain "
                f"{t['plain'][0]:.3f} ms [{t['plain'][1]:.3f}, {t['plain'][2]:.3f}]  eager stack "
                f"{eager:.3f} ms  bound {bms:.3f} ms ({by}) ({smi})")
            del m, wav
            torch.cuda.empty_cache()
            q, k, v, mask = k8_case(b, E2V_T, bf16, dev, True, seed=b)
            for m_, text in ((None, "no mask"), (mask, "mask")):   # the main path sends both
                err, ok, rule = check_k8(run_k8("kernel", q, k, v, m_),
                                         run_k8("plain", q, k, v, m_), q, k, v, m_)
                log(f"full_mha vs plain ({b}, {E2V_H}, {E2V_T}, {E2V_D}) {text} bfloat16 "
                    f"max|d|={err:.3e} [{rule}] {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"full_mha disagrees with its plain version at B={b}, {text}")
            t = time_pair(lambda which: run_k8(which, q, k, v, mask), iters=5)
            add = torch.zeros(mask.shape, dtype=bf16, device=dev).masked_fill_(
                mask, float("-inf"))[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=add, scale=1.0)
            lib = cuda_ms(sdpa, 5, warmup=1)
            k_dev = device_ms(lambda: run_k8("kernel", q, k, v, mask))
            lib_dev = device_ms(sdpa)
            bms, by = bound(*k8_work(b, E2V_H, E2V_T, E2V_D, True))
            out["full_mha"][b] = dict(ms=t["kernel"][0], ms_range=t["kernel"][1:],
                                      plain_ms=t["plain"][0], plain_range=t["plain"][1:],
                                      library_ms=lib, bound_ms=bms, bound_by=by,
                                      device_ms=k_dev, library_device_ms=lib_dev)
            log(f"time full_mha ({b}, {E2V_H}, {E2V_T}, {E2V_D}) mask bf16, median of 5: kernel "
                f"{t['kernel'][0]:.4f} ms [{t['kernel'][1]:.4f}, {t['kernel'][2]:.4f}]  plain "
                f"{t['plain'][0]:.4f} ms [{t['plain'][1]:.4f}, {t['plain'][2]:.4f}]  "
                f"scaled_dot_product_attention {lib:.4f} ms  bound {bms:.4f} ms ({by}); their "
                f"kernels alone (graph replay): full_mha {k_dev:.4f} ms, "
                f"scaled_dot_product_attention {lib_dev:.4f} ms ({smi})")
            del q, k, v, mask, add
            torch.cuda.empty_cache()

    def rate(fn, n):
        """Best of two timed runs after a warm-up, and the peak memory."""
        torch.cuda.reset_peak_memory_stats()
        fn()
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(n / (time.perf_counter() - t0))
        return max(runs), runs, torch.cuda.max_memory_allocated() / 2**30

    rates, stages = {}, {}
    wavs64 = 0.1 * torch.randn((64, WAV_LEN), device=dev,
                               generator=torch.Generator(dev).manual_seed(0))
    for name, feats in (("byola", ex.byola_features_device),
                        ("emotion2vec", ex.emotion_features_device)):
        best, runs, peak = rate(lambda: feats(wavs64), 64)
        rates[f"{name} wavs/s B=64"] = best
        log(f"{name} bf16 B=64 wavs of 9.6 s: {best:.1f} wavs/s (runs "
            f"{[round(r, 1) for r in runs]}, peak mem {peak:.1f} GiB) ({smi})")
    fn = build_online_inference_fn(cfg, TestConfig(**BENCH_TEST), 1.0, 1.0)
    for n in (16, 64):
        chunks, wavs = media_batch(n)
        chunks, wavs = torch.from_numpy(chunks).to(dev), torch.from_numpy(wavs).to(dev)

        def run():
            media_to_detections(ex, model, fn, chunks, wavs)[1].cpu()
        best, runs, peak = rate(run, n)
        reset_counts()
        run()
        rates[f"media -> detections videos/s B={n}"] = best
        rates[f"media -> detections peak GiB B={n}"] = peak
        rates[f"media -> detections launches B={n}"] = launch_counts()
        log(f"media -> detections bf16 B={n}: {best:.2f} videos/s (runs "
            f"{[round(r, 2) for r in runs]}, peak mem {peak:.1f} GiB), launches per run "
            f"{launch_counts()} ({smi})")
        stages[str(n)] = media_breakdown(ex, model, cfg, chunks, wavs, smi)
    REPORT["audio_timing"] = dict(kernels=out, rates=rates, stages=stages, card=smi,
                                  k5_rules=sorted(k5_rules))
    return out, rates, sorted(k5_rules)


def media_breakdown(ex, model, cfg, chunks, wavs, smi, n_frames=240, duration=9.6):
    """CUDA-event time of each stage of one media -> detections run (after
    the warm-up runs of the rate measurement): video encoder, log-mel,
    BYOL-A, K5, projection + positional convs, the AltBlock trunk, resample +
    concat, localizer, decode + soft-NMS."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.core.config import TestConfig
    from audio_visual_deepfake_detection_tpu_torch.frontends.mel import byola_log_mel
    from audio_visual_deepfake_detection_tpu_torch.infer.decode import decode_and_postprocess
    from audio_visual_deepfake_detection_tpu_torch.models.points import generate_points
    from audio_visual_deepfake_detection_tpu_torch.ops.resample import linear_resample_dynamic

    tcfg = TestConfig(**BENCH_TEST)
    n = chunks.shape[0]
    emo_m, by_m = ex.emotion_model, ex.byola_model
    marks = []

    def stage(name, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        marks.append((name, start, end))
        return res

    with torch.inference_mode():
        v = stage("video (MViT-v2-b)", lambda: ex.video_chunks_features_device(chunks))
        lms = stage("log-mel", lambda: byola_log_mel(wavs).transpose(-1, -2))
        by = stage("BYOL-A", lambda: by_m(lms))
        feats = stage("conv extractor (K5)", lambda: emo_m.audio.local_encoder(wavs))
        x = stage("proj + pos-conv", lambda: emo_m.project(feats))
        emo = stage("AltBlock trunk (K8)", lambda: emo_m.trunk(x))
        streams = (v[:, :n_frames], by[:, :BYOLA_ROWS], emo[:, :EMO_ROWS])
        rows = [torch.full((n,), s.shape[1], dtype=torch.int32, device=v.device)
                for s in streams]
        seq = cfg.max_seq_len
        cat = stage("resample + concat", lambda: torch.cat(
            [linear_resample_dynamic(s.float(), r, seq) for s, r in zip(streams, rows)], -1))
        mask = torch.ones((n, seq), dtype=torch.bool, device=v.device)
        outp = stage("localizer (K1)", lambda: model(cat, mask))
        meta = [torch.full((n,), val, device=v.device)
                for val in (n_frames / duration, duration, n_frames / seq, n_frames / seq)]
        points = generate_points(cfg.fpn_lens, cfg.fpn_strides, cfg.regression_range,
                                 device=v.device)
        stage("decode + soft-NMS", lambda: decode_and_postprocess(
            outp, points, *meta, tcfg, cfg.num_classes))
    torch.cuda.synchronize()
    ms = [(name, s.elapsed_time(e)) for name, s, e in marks]
    total = sum(t for _, t in ms)
    log(f"media -> detections breakdown, {n} videos, bf16: {total:.2f} ms of stages ({smi})")
    for name, t in ms:
        log(f"  {name:22s} {t:9.3f} ms  {100 * t / total:5.1f}%")
    return dict(total_ms=total, stages=[dict(stage=k, ms=t) for k, t in ms])


# ---------------------------------------------------------- training slice

TRAIN_B = 50                          # configs_train/deepfake_exp10.yaml, per device
K7_TS = (768, 384, 192, 96, 48, 24)   # the banded blocks' lengths (w = 3, 4 heads of 64)
K7_F32_ATOL = 1e-5
GRAD_TOL = 5e-4                       # |d| / max(1, max |ref|), f32 card vs CPU


def k6_work(mode, t, window, b, nbytes=2):
    """K1's work plus the (b, 2) f32 coefficients."""
    flops, moved = k1_work(mode, t, window, b, nbytes=nbytes)
    return flops, moved + 8 * b


def k7_work(b, h, t, d, w, nbytes=2):
    """2 d multiply-adds a key for the scores and for P.V over 2 w + 1 keys;
    q, k, v read and the output written once, and the mask."""
    return 4 * b * h * t * d * (2 * w + 1), 4 * b * h * t * d * nbytes + b * t


def draw_coefs(b, dev, seed, keep=0.9):
    """(b, 2) droppath coefficients from {0, 1 / keep}, sample 0 all ones."""
    import torch

    g = torch.Generator().manual_seed(seed)
    coefs = torch.floor(keep + torch.rand((b, 2), generator=g)) / keep
    coefs[0] = 1.0
    return coefs.to(dev)


def run_k6(which, x, xo, mask, coefs, packed, mode, window):
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as fb

    kw = dict(n_head=4, w_overlap=window // 2, mode=mode)
    if which == "kernel":
        return fb.fused_transformer_block_train(x, xo, mask, coefs, *packed, **kw)
    return fb.block_math(x, x if xo is None else xo, mask.float()[..., None], coefs,
                         *packed, **kw)


def k6_grads(which, x, xo, mask, coefs, packed, mode, window, g):
    """d sum(y g) / d (x, xo, the 8 packed tensors): through the K6 Function
    ('kernel') or straight through block_math ('plain')."""
    leaves = [None if a is None else a.detach().clone().requires_grad_(True)
              for a in (x, xo, *packed)]
    y = run_k6(which, leaves[0], leaves[1], mask, coefs, leaves[2:], mode, window)
    (y.float() * g).sum().backward()
    return [None if a is None else a.grad for a in leaves]


def grad_gap(got, ref):
    """Largest |d| / max(1, max |ref|) over the gradient list."""
    worst = 0.0
    for a, r in zip(got, ref):
        if r is None:
            continue
        if a is None or not bool(a.isfinite().all()):
            return float("inf")
        scale = max(1.0, r.float().abs().max().item())
        worst = max(worst, (a.float().cpu() - r.float().cpu()).abs().max().item() / scale)
    return worst


def phase_k6(dev="cuda", blocks=PROD_BLOCKS, b=TRAIN_B, grad_b=5):
    """K6 at every production block shape, f32 and bf16. Forward at batch
    ``b`` (the batch the training path hands it) with coefficients from
    {0, 1/0.9} and a sample of ones: the kernel against block_math at K1's
    tolerances. Gradients at the smaller batch ``grad_b`` (lengths full, 3/4,
    1/3, one row, none; the backward is autograd through block_math, which
    is per sample, and keeps every intermediate): through the Function on the card
    against autograd straight through block_math on the card (the same
    operations: 1e-6 relative), and in f32 against the CPU (GRAD_TOL)."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as fb

    on_card = torch.device(dev).type == "cuda"
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_grad = {"card": 0.0, "cpu": 0.0}
    rows = []
    for names, mode, t, window in blocks:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x, xo, mask, packed = block_case(mode, t, window, b, dtype, dev, seed=t)
            coefs = draw_coefs(b, dev, seed=t)
            fb.reset_launches()
            with torch.no_grad():
                got = run_k6("kernel", x, xo, mask, coefs, packed, mode, window)
                ref = run_k6("plain", x, xo, mask, coefs, packed, mode, window)
            sync(dev)
            if (fb.TRAIN_LAUNCHES, fb.LAUNCHES) != ((1, 0) if on_card else (0, 0)):
                fail(f"K6 forward counted {fb.TRAIN_LAUNCHES} training and {fb.LAUNCHES} "
                     f"eval launches")
            err, ok, n_over = compare(got, ref)
            worst[name] = max(worst[name], err)
            # a dropped branch leaves the residual alone: sample 1's MLP
            # coefficient decides whether its output moves with the MLP scale
            x, xo, mask, packed = block_case(mode, t, window, grad_b, dtype, dev, seed=t + 1)
            coefs = draw_coefs(grad_b, dev, seed=t + 1)
            g = torch.randn(x.shape, generator=torch.Generator().manual_seed(t)).to(dev)
            gk = k6_grads("kernel", x, xo, mask, coefs, packed, mode, window, g)
            gp = k6_grads("plain", x, xo, mask, coefs, packed, mode, window, g)
            gap_card = grad_gap(gk, gp)
            worst_grad["card"] = max(worst_grad["card"], gap_card)
            gap_cpu = None
            if dtype == torch.float32 and on_card:
                cpu = lambda a: None if a is None else a.cpu()  # noqa: E731
                gc = k6_grads("kernel", cpu(x), cpu(xo), mask.cpu(), coefs.cpu(),
                              [a.cpu() for a in packed], mode, window, g.cpu())
                gap_cpu = grad_gap(gk, gc)
                worst_grad["cpu"] = max(worst_grad["cpu"], gap_cpu)
            rows.append(dict(B=b, mode=mode, T=t, window=window, dtype=name, max_abs_err=err,
                             ok=ok, grad_gap_card=gap_card, grad_gap_cpu=gap_cpu))
            log(f"K6 vs plain B={b} {mode:7s} T={t:3d} w={window:2d} {name:8s} max|d|={err:.3e} "
                f"beyond atol+rtol: {n_over}; grads B={grad_b}: Function vs block_math "
                f"{gap_card:.2e}" + ("" if gap_cpu is None else f", vs CPU {gap_cpu:.2e}")
                + f" {'ok' if ok else 'MISMATCH'}")
            REPORT["k6"] = rows
            if not ok:
                fail(f"K6 disagrees with block_math: {mode} T={t} {name}")
            if gap_card > 1e-6 or (gap_cpu is not None and gap_cpu > GRAD_TOL):
                fail(f"K6 gradients disagree: {mode} T={t} {name}")
    if on_card:
        torch.cuda.empty_cache()
    return worst, worst_grad


def k7_case(b, t, dtype, dev, seed=0, h=4, d=64):
    """q (pre-scaled), k, v as ConvAttention hands them over: head views of
    (b, t, h d) projections; ragged key masks (full, 3/4, 1/3, one row, none,
    the rest full)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, t, h * d), generator=g).to(dev, dtype) for _ in range(3))
    q = q * d ** -0.5
    lens = [t, (3 * t) // 4, t // 3, 1, 0][:b] + [t] * max(0, b - 5)
    valid = (torch.arange(t)[None, :] < torch.tensor(lens)[:, None]).to(dev)
    heads = lambda a: a.reshape(b, t, h, d).transpose(1, 2)  # noqa: E731
    return heads(q), heads(k), heads(v), valid


def run_k7(which, q, k, v, valid, w=3):
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import band_attention as k7

    fn = k7.band_attention_kernel if which == "kernel" else k7.band_attention_plain
    return fn(q, k, v, valid, w)


def check_k7(got, ref, q, k, v, valid, w=3):
    """f32: atol K7_F32_ATOL. bf16: atol = rtol = BF16_TOL per element, and
    the kernel no further than NO_WORSE x the plain version from the same
    function in f32 (max and median)."""
    import torch

    if not torch.isfinite(got.float()).all():
        return float("inf"), False, "non-finite"
    d = (got.float() - ref.float()).abs()
    err = d.max().item()
    if got.dtype == torch.float32:
        return err, err <= K7_F32_ATOL, f"atol {K7_F32_ATOL:g}"
    with torch.no_grad():
        exact = run_k7("plain", q.float(), k.float(), v.float(), valid, w)
    near, text = against_exact(got, ref, exact)
    over = int((d > BF16_TOL + BF16_TOL * ref.float().abs()).sum())
    return err, near and over == 0, f"{over} beyond atol=rtol=2e-2; {text}"


# K7 beyond the main path's shapes: (b, t, d, w, layout); "copied" hands the
# wrapper q with a transposed row, k 2 bytes off alignment and v with a row
# stride of 66 values, which it copies before the launch
K7_EXTRA = ((TRAIN_B, 768, 64, 0, "heads"), (TRAIN_B, 768, 64, 1, "heads"),
            (TRAIN_B, 768, 64, 8, "heads"), (TRAIN_B, 97, 64, 8, "heads"),
            (5, 150, 32, 3, "heads"), (5, 150, 128, 3, "heads"), (5, 150, 128, 8, "heads"),
            (16400, 24, 64, 3, "heads"), (5, 150, 64, 3, "copied"))


def k7_relayout(q, k, v):
    """The same values in layouts the kernel cannot read as they are."""
    import torch

    b, h, t, d = q.shape
    q = q.transpose(2, 3).contiguous().transpose(2, 3)
    flat = torch.empty(k.numel() + 1, dtype=k.dtype, device=k.device)
    k = flat[1:].view(b, h, t, d).copy_(k)
    v = torch.empty((b, h, t, d + 2), dtype=v.dtype, device=v.device)[..., :d].copy_(v)
    return q, k, v


def phase_k7(dev="cuda", ts=K7_TS, b=TRAIN_B, grad_b=5, w=3, extra=K7_EXTRA):
    """K7 at (b, 4, T, 64) for every banded length, ragged masks, f32 and
    bf16, against band_attention_plain (check_k7), and at the ``extra``
    shapes, windows and layouts; the differentiable wrapper's gradients in
    f32 at batch ``grad_b`` on the card against the CPU (1e-5 relative to
    the largest value)."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import band_attention as k7

    on_card = torch.device(dev).type == "cuda"
    worst = {"float32": 0.0, "bfloat16": 0.0}
    rows = []
    cases = [(b, t, 64, w, "heads") for t in ts] + list(extra)
    for bb, t, d, ww, layout in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            args = k7_case(bb, t, dtype, dev, seed=t, d=d)
            if layout == "copied":
                args = (*k7_relayout(*args[:3]), args[3])
            k7.reset_launches()
            with torch.no_grad():
                got, ref = run_k7("kernel", *args, ww), run_k7("plain", *args, ww)
            sync(dev)
            if k7.LAUNCHES != int(on_card):
                fail(f"K7 counted {k7.LAUNCHES} launches for one call")
            err, ok, rule = check_k7(got, ref, *args, ww)
            worst[name] = max(worst[name], err)
            rows.append(dict(shape=(bb, 4, t, d), w=ww, layout=layout, dtype=name,
                             max_abs_err=err, ok=ok, rule=rule))
            log(f"K7 vs plain ({bb}, 4, {t}, {d}) w={ww} {layout:6s} {name:8s} max|d|={err:.3e} "
                f"[{rule}] {'ok' if ok else 'MISMATCH'}")
            REPORT["k7"] = rows
            if not ok:
                fail(f"K7 disagrees with its plain version: ({bb}, 4, {t}, {d}) w={ww} {layout} "
                     f"{name}")
            del args, got, ref
    for t in ts:
        q, k, v, valid = k7_case(grad_b, t, torch.float32, dev, seed=t + 1)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(t))

        def grads(device):
            leaves = [a.detach().to(device).requires_grad_(True) for a in (q, k, v)]
            k7.band_attention_fused(*leaves, valid.to(device), w).backward(g.to(device))
            return [a.grad for a in leaves]
        gap = grad_gap(grads(dev), grads("cpu"))
        log(f"K7 grads ({grad_b}, 4, {t}, 64) f32 card vs CPU: {gap:.2e}")
        if gap > 1e-5:
            fail(f"K7 gradients disagree with the CPU at T={t}")
    if on_card:
        torch.cuda.empty_cache()
    return worst


# K7's launch shape and its alternatives: (warps a block = query rows a tile,
# blocks an SM that the register cap allows)
K7_VARIANTS = ((8, 6), (16, 2), (16, 3), (8, 4), (4, 12))


def k7_variants(smi, b=TRAIN_B, variants=K7_VARIANTS, rounds=3):
    """K7's launch shape against its alternatives (the reason for the
    source's): csrc/band_attention.cu with its block size and launch bound
    replaced by each variant's, built beside the source under
    build/k7_variants/, checked against the plain version at T = 768 and
    timed (device time, CUDA-graph replay, the variants in turns) at the
    unfused forward's lengths, bf16. The first variant is the source's own."""
    import ctypes
    import torch
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import band_attention as k7
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import build

    out_dir = os.path.join(REPO, "build", "k7_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = (build.CSRC / "band_attention.cu").read_text()
    own = ("constexpr int NW = 8;", "__launch_bounds__(NT, 6)")
    if not all(a in src for a in own):
        fail("k7_variants: csrc/band_attention.cu no longer has the block size it replaces")
    procs = {}
    for nw, per_sm in variants:
        name = f"nw{nw}_x{per_sm}"
        text = src.replace(own[0], f"constexpr int NW = {nw};").replace(
            own[1], f"__launch_bounds__(NT, {per_sm})").replace(
            "avdd_band_attention", "avdd_band_attention_" + name)
        path = os.path.join(out_dir, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-I", str(build.CSRC), "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log_text = proc.communicate()[0]
        if proc.returncode:
            fail(f"k7_variants: {name} does not build:\n{log_text[-2000:]}")
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, name + ".so")), "avdd_band_attention_" + name)
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_char_p]
        fns[name] = fn

    def run(fn, q, k, v, valid):
        bb, h, t, d = q.shape
        out = torch.empty_strided((bb, h, t, d), (t * h * d, d, h * d, 1), dtype=q.dtype,
                                  device=q.device)
        err = fn(k7._ARGS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                               out.data_ptr(), torch.cuda.current_stream().cuda_stream,
                               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], t * h * d, d,
                               h * d, bb, h, t, d, 3, 1))
        if err:
            fail(f"k7_variants: launch failed, CUDA error {err}")
        return out

    calls = {768: 8, 384: 2, 192: 2, 96: 2, 48: 2, 24: 1}
    totals = dict.fromkeys(fns, 0.0)
    rows = []
    for t in K7_TS:
        args = k7_case(b, t, torch.bfloat16, "cuda", seed=t)
        if t == 768:
            ref = run_k7("plain", *args)
            for name, fn in fns.items():
                if not check_k7(run(fn, *args), ref, *args)[1]:
                    fail(f"k7_variants: {name} disagrees with the plain version")
        ms = {name: [] for name in fns}
        order = list(fns)
        for r in range(rounds):
            for name in order if r % 2 == 0 else order[::-1]:
                ms[name].append(device_ms(lambda: run(fns[name], *args)))
        best = {name: min(v) for name, v in ms.items()}
        for name in fns:
            totals[name] += best[name] * calls[t]
        rows.append(dict(T=t, device_ms=best))
        log(f"K7 variants ({b}, 4, {t}, 64) bf16 device us: " +
            ", ".join(f"{n} {v * 1e3:.1f}" for n, v in best.items()) + f" ({smi})")
    log("K7 variants, the 17 launches of one unfused forward, device ms: " +
        ", ".join(f"{n} {v:.4f}" for n, v in totals.items()) + f" ({smi})")
    REPORT["k7_variants"] = dict(card=smi, per_length=rows, totals=totals)
    return totals


def train_setup(dropout, dtype, dev, seed=0, arch=None, opt_iters=10):
    """Config, model, state and step from configs_train/deepfake_exp10.yaml
    through the port's loader (``arch`` overrides the model for a CPU
    rehearsal)."""
    import dataclasses
    import torch
    from audio_visual_deepfake_detection_tpu_torch.core.config import (
        ArchConfig, arch_config_from, load_config)
    from audio_visual_deepfake_detection_tpu_torch import train

    config = load_config(os.path.join(REPO, "configs_train", "deepfake_exp10.yaml"))
    cfg = arch_config_from(config)
    want = ArchConfig(**PROD)
    for field in ("variant", "input_dim", "max_seq_len", "embd_dim", "n_head", "mha_win_size",
                  "arch", "droppath"):
        if getattr(cfg, field) != getattr(want, field):
            fail(f"deepfake_exp10.yaml: {field} = {getattr(cfg, field)!r}")
    if config["loader"]["batch_size"] != TRAIN_B:
        fail(f"deepfake_exp10.yaml: batch_size {config['loader']['batch_size']}")
    if arch is not None:
        cfg = ArchConfig(**arch)
    cfg = dataclasses.replace(cfg, dropout=dropout, compute_dtype=dtype)
    tc = config["train_cfg"]
    # on the card through the entry point's own default, as a user calls it
    on_card = torch.device(dev).type == "cuda"
    model, _ = train.init_model(cfg, seed) if on_card else train.init_model(cfg, seed, dev)
    if next(model.parameters()).device.type != torch.device(dev).type:
        fail(f"init_model put the model on {next(model.parameters()).device}")
    tx, sched = train.make_optimizer(model, config["opt"], opt_iters, tc["clip_grad_l2norm"])
    return cfg, config, model, tx, sched


def train_batch(cfg, b, seed=0, max_gt=32):
    """A seeded batch: varied valid lengths, one to three fake segments per
    video, every fifth video real (no segment). Built as arrays and held to
    what the port's ``collate_batch`` makes of the same samples: the same
    keys, dtypes and values."""
    from audio_visual_deepfake_detection_tpu_torch.data import collate_batch

    rng = np.random.default_rng(seed)
    t = cfg.max_seq_len
    lens = rng.integers(t // 2, t + 1, b)
    lens[0] = t
    mask = np.arange(t)[None, :] < lens[:, None]
    feats = rng.standard_normal((b, t, cfg.input_dim), dtype=np.float32) * mask[..., None]
    seg = np.zeros((b, max_gt, 2), np.float32)
    valid = np.zeros((b, max_gt), bool)
    for i in range(b):
        if i % 5 == 4:
            continue
        n = int(rng.integers(1, 4))
        start = rng.uniform(0, lens[i] - 40, n)
        seg[i, :n, 0] = start
        seg[i, :n, 1] = start + rng.uniform(4, 36, n)
        valid[i, :n] = True
    ones = np.ones((b,), np.float32)
    batch = {"feats": feats, "mask": mask, "gt_segments": seg,
             "gt_labels": np.zeros((b, max_gt), np.int64), "gt_valid": valid,
             "has_gt": valid.any(1), "fps": 25 * ones,
             "duration": (lens / 25.0).astype(np.float32),
             "feat_stride": ones, "feat_num_frames": ones,
             "video_ids": [f"v{i}" for i in range(b)]}
    samples = [{"video_id": f"v{i}", "feats": feats[i, :lens[i]],
                "segments": seg[i, valid[i]] if valid[i].any() else None,
                "labels": np.zeros(int(valid[i].sum()), np.int64),
                "fps": 25.0, "duration": lens[i] / 25.0, "feat_stride": 1.0,
                "feat_num_frames": 1.0} for i in range(b)]
    real = collate_batch(samples, t, max_gt)
    for key, value in real.items():
        mine = batch.get(key)
        if key == "video_ids":
            same = mine == value
        else:
            same = (isinstance(mine, np.ndarray) and mine.dtype == value.dtype
                    and np.array_equal(mine, value))
        if not same or set(real) != set(batch):
            fail(f"train_batch: {key!r} differs from collate_batch's")
    return real


def batch_on(batch, dev):
    """The batch's arrays as tensors on ``dev`` (the ids stay a list)."""
    import torch

    return {k: v if k == "video_ids" else torch.as_tensor(v).to(dev) for k, v in batch.items()}


def batch_losses(cfg, tc, out, dbatch, normalizer):
    """Label assignment and ``compute_losses`` of model outputs ``out`` on a
    device batch, as the train step runs them."""
    from audio_visual_deepfake_detection_tpu_torch.models import meta_arch

    gt_cls, gt_off = meta_arch.label_points(
        meta_arch.model_points(cfg, normalizer.device), dbatch["gt_segments"],
        dbatch["gt_labels"], dbatch["gt_valid"], cfg.num_classes, tc["center_sample"],
        tc["center_sample_radius"])
    return meta_arch.compute_losses(
        out, gt_cls, gt_off, dbatch["has_gt"], normalizer, num_classes=cfg.num_classes,
        loss_weight=tc["loss_weight"], label_smoothing=tc["label_smoothing"])


def focal_sum(cfg, config, model, batch):
    """The unnormalized classification focal sum of the eval-mode model on
    a batch (cls_loss times the normalizer it was divided by)."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch import train
    from audio_visual_deepfake_detection_tpu_torch.models import meta_arch

    dev = next(model.parameters()).device
    tc = config["train_cfg"]
    out = train.build_eval_forward(cfg)(model, batch["feats"], batch["mask"])
    norm = torch.tensor(float(tc["init_loss_norm"]), device=dev)
    losses, num_pos = batch_losses(cfg, tc, out, batch_on(batch, dev), norm)
    return float(losses["cls_loss"] * meta_arch.update_loss_normalizer(norm, num_pos))


def steps_card_vs_cpu(dropout, deterministic, dev, b, n_steps, arch=None):
    """``n_steps`` f32 train steps on the card and on the CPU from the same
    seed and batch; stochastic steps draw from a CPU generator on both, so
    the draws are the same. Returns the largest relative gaps and the card's
    launch counts."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch import train

    runs = {}
    for device in (dev, "cpu"):
        cfg, config, model, tx, _ = train_setup(dropout, "float32", device, arch=arch)
        state = train.TrainState.create(model, tx, config["train_cfg"]["init_loss_norm"],
                                        torch.Generator().manual_seed(11))
        step = train.build_train_step(cfg, config["train_cfg"],
                                      deterministic_forward=deterministic)
        batch = train_batch(cfg, b, seed=3)
        batch.pop("video_ids")
        reset_counts()
        out = []
        for _ in range(n_steps):
            state, losses = step(state, batch)
            out.append({k: float(v) for k, v in losses.items()})
        sync(device)
        runs[str(device)] = (out, launch_counts())
        del state, model, tx
    gaps = {"losses": 0.0, "grad_norm": 0.0}
    for card, cpu in zip(runs[str(dev)][0], runs["cpu"][0]):
        for key, val in cpu.items():
            if not math.isfinite(card[key]):
                fail(f"train step: non-finite {key} on the card")
            gap = abs(card[key] - val) / max(abs(val), 1e-12)
            which = "grad_norm" if key == "grad_norm" else "losses"
            gaps[which] = max(gaps[which], gap)
    return gaps, runs[str(dev)][1], runs[str(dev)][0]


def run_epoch(dropout, dtype, dev, b, n_steps, ckpt_dir, arch=None, stage_hook=None):
    """``n_steps`` stochastic steps on one fixed batch through
    train_one_epoch with a checkpoint every ``n_steps // 2`` iterations:
    finite losses, the launch counts, the checkpoint restored into a fresh
    state equals what was saved, the eval-mode focal sum on the batch falls."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch import train

    cfg, config, model, tx, sched = train_setup(dropout, dtype, dev, arch=arch,
                                                opt_iters=n_steps)
    tc = config["train_cfg"]
    state = train.TrainState.create(model, tx, tc["init_loss_norm"],
                                    torch.Generator(device=dev).manual_seed(5))
    step = train.build_train_step(cfg, tc, stage_hook=stage_hook)
    batch = train_batch(cfg, b, seed=4)
    seen = []

    def recording_step(st, bt):
        st, losses = step(st, bt)
        seen.append(losses)
        return st, losses

    before = focal_sum(cfg, config, model, batch)
    sync(dev)
    reset_counts()
    state = train.train_one_epoch([batch] * n_steps, state, recording_step, 0,
                                  schedule=sched, print_freq=max(n_steps // 2, 1),
                                  ckpt_every_iters=n_steps // 2, ckpt_folder=ckpt_dir,
                                  batch_size=b)
    sync(dev)
    counts = launch_counts()
    after = focal_sum(cfg, config, model, batch)
    vals = [{k: float(v) for k, v in ls.items()} for ls in seen]
    if len(vals) != n_steps or not all(math.isfinite(v) for ls in vals for v in ls.values()):
        fail(f"train {dtype} dropout={dropout}: {len(vals)} steps, non-finite losses")
    if not after < before:
        fail(f"train {dtype} dropout={dropout}: focal sum on the fixed batch went "
             f"{before:.4f} -> {after:.4f}")
    tag = f"epoch_000_iter{n_steps // 2 + 1}"
    path = os.path.join(ckpt_dir, tag + ".pt")
    if not os.path.exists(path):
        fail(f"no mid-epoch checkpoint {path}")
    _, _, model2, tx2, _ = train_setup(dropout, dtype, dev, seed=1, arch=arch, opt_iters=n_steps)
    fresh = train.TrainState.create(model2, tx2, 0.0, torch.Generator(device=dev))
    fresh, epoch, next_iter = train.restore_checkpoint(path, fresh)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    same = all(torch.equal(v.cpu(), saved["params"][k]) for k, v in model2.state_dict().items())
    same = same and all(torch.equal(v.cpu(), saved["ema_params"][k])
                        for k, v in fresh.ema_params.items())
    if not same or (epoch, next_iter, fresh.step) != (0, n_steps // 2 + 1, n_steps // 2 + 1):
        fail(f"checkpoint {tag}: restored epoch {epoch}, next_iter {next_iter}, "
             f"step {fresh.step}, parameters equal: {same}")
    log(f"train {dtype} dropout={dropout} B={b}: {n_steps} steps through train_one_epoch, "
        f"final_loss {vals[0]['final_loss']:.4f} -> {vals[-1]['final_loss']:.4f}, eval focal "
        f"sum {before:.3f} -> {after:.3f}, launches {counts}, checkpoint {tag} restored")
    del fresh, model2, tx2
    return dict(steps=n_steps, losses=vals, focal_before=before, focal_after=after,
                launches=counts), state, step, batch


def time_steps(state, step, batch, b, smi, label, warm=2, timed=5):
    """ms per step, samples/s and peak GiB of ``timed`` steps after
    ``warm``, on batches already on the device."""
    import torch

    dev = next(state.model.parameters()).device
    batch = batch_on(batch, dev)
    for _ in range(warm):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train step {label} B={b}: {ms:.1f} ms/step, {b / ms * 1e3:.1f} samples/s, peak "
        f"{peak:.2f} GiB ({smi})")
    return dict(ms_per_step=ms, samples_per_s=b / ms * 1e3, peak_gib=peak)


class StageEvents:
    """A ``stage_hook`` for build_train_step: while ``on``, records a CUDA
    event at each stage boundary of the step."""

    def __init__(self):
        self.on, self.events = False, {}

    def __call__(self, name):
        import torch

        if self.on:
            self.events[name] = torch.cuda.Event(enable_timing=True)
            self.events[name].record()

    def ms(self):
        order = ("begin", "forward", "backward", "update")
        return [self.events[a].elapsed_time(self.events[b]) for a, b in zip(order, order[1:])]


@contextlib.contextmanager
def k7_spans():
    """While inside: a pair of CUDA events around every K7 forward call (the
    kernel's launch through its wrapper) and every backward of its autograd
    Function (band_attention_xla recomputed and differentiated). Yields
    {"forward": [...], "backward": [...]} of (start, end) event pairs; their
    spans are stream time, any host gap inside a call included."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import band_attention as k7

    spans = {"forward": [], "backward": []}
    fwd, bwd = k7.band_attention_kernel, k7._BandAttention.backward

    def timed(kind, fn):
        def run(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            spans[kind].append((start, end))
            return out
        return run
    k7.band_attention_kernel = timed("forward", fwd)
    k7._BandAttention.backward = staticmethod(timed("backward", bwd))
    try:
        yield spans
    finally:
        k7.band_attention_kernel = fwd
        k7._BandAttention.backward = staticmethod(bwd)


def step_breakdown(state, step, hook, batch, smi, label, profile=True, band=False):
    """CUDA-event time of the stages of one training step, recorded by the
    step itself through its stage hook (label assignment, forward with the 18
    K6 launches and the losses; backward with the 17 recomputes; clip + AdamW
    + EMA + normalizer), and the device time by kernel of one whole step.
    ``band``: the unfused step, whose forward and backward are split further
    at K7 (k7_spans): its 17 forward calls, and its 17 backwards through
    band_attention_xla against the rest of the backward."""
    import torch

    dbatch = batch_on(batch, next(state.model.parameters()).device)
    torch.cuda.synchronize()
    hook.on = True
    with k7_spans() if band else contextlib.nullcontext() as spans:
        step(state, dbatch)
    torch.cuda.synchronize()
    hook.on = False
    ms = hook.ms()
    total = sum(ms)
    log(f"train step stages {label}: forward + losses {ms[0]:.1f} ms ({100 * ms[0] / total:.0f}%), "
        f"backward (recompute + gradients) {ms[1]:.1f} ms ({100 * ms[1] / total:.0f}%), clip + "
        f"AdamW + EMA {ms[2]:.1f} ms ({100 * ms[2] / total:.0f}%) ({smi})")
    out = dict(forward_ms=ms[0], backward_ms=ms[1], update_ms=ms[2])
    if band:
        k7_ms = {kind: sum(a.elapsed_time(b) for a, b in pairs) for kind, pairs in spans.items()}
        n = {kind: len(pairs) for kind, pairs in spans.items()}
        out.update(k7_forward_ms=k7_ms["forward"], k7_backward_ms=k7_ms["backward"],
                   k7_calls=n, backward_rest_ms=ms[1] - k7_ms["backward"])
        log(f"  unfused step {label}: forward {ms[0]:.1f} ms, K7 inside it {k7_ms['forward']:.2f} "
            f"ms ({n['forward']} calls); backward {ms[1]:.1f} ms, through band_attention_xla "
            f"{k7_ms['backward']:.1f} ms ({n['backward']} calls, "
            f"{100 * k7_ms['backward'] / total:.1f}% of the step), the rest "
            f"{ms[1] - k7_ms['backward']:.1f} ms; optimizer {ms[2]:.1f} ms ({smi})")
    prof = profile and profile_forward(lambda: step(state, dbatch), total, smi,
                                       label=f"one train step {label}", top_n=8)
    k6_ms = None
    if prof and not band:
        k6_ms = sum(r["device_ms"] for r in prof["top"] if "fused_block_kernel" in r["name"])
        log(f"  K6 forward kernels: {k6_ms:.2f} ms of {prof['device_ms']:.2f} ms device time")
    out.update(k6_device_ms=k6_ms, profile=prof)
    return out


def phase_train(dev="cuda", b=TRAIN_B, cpu_b=16, n_steps=10, arch=None, smi="",
                timing=True):
    """The training slice's main path at full width and depth. (a) f32,
    deterministic forward, 2 steps at batch ``cpu_b``, card against CPU
    (a CPU step at the training batch of 50 takes two minutes; K6 itself is
    held to block_math at that batch by phase_k6): losses rtol 1e-4,
    grad_norm rtol 1e-3, K6 18 launches a step. (b)
    bf16 and f32, stochastic, ``n_steps`` through train_one_epoch at batch
    ``b`` (run_epoch). (c) the same with dropout 0.1 (the unfused block; at
    most 4 steps in f32): K7 17 launches a forward, K6 none, and one
    stochastic f32 step at batch ``cpu_b`` card against CPU with the same
    draws. No training step may launch the eval kernel K1. Then the step
    times."""
    import tempfile
    import torch

    on_card = torch.device(dev).type == "cuda"
    n_blocks = 18 if arch is None else 1 + arch["arch"][1] + 3 * arch["arch"][2]
    n_band = n_blocks - (1 if (arch or PROD)["mha_win_size"][-1] == -1 else 0)
    report = {}

    def expect(counts, k6, k7, what):
        want = dict.fromkeys(counts, 0)
        if on_card:
            want.update(fused_transformer_block_train=k6, band_attention=k7)
        if counts != want:      # the eval kernel K1 included: none in a training step
            fail(f"{what}: launches {counts}, expected {want}")

    gaps, counts, traj = steps_card_vs_cpu(0.0, True, dev, cpu_b, 2, arch)
    log(f"train f32 deterministic, 2 steps B={cpu_b}, card vs CPU: losses rel {gaps['losses']:.2e} "
        f"grad_norm rel {gaps['grad_norm']:.2e}, launches {counts}, final_loss "
        f"{[round(s['final_loss'], 5) for s in traj]}")
    expect(counts, 2 * n_blocks, 0, "deterministic steps")
    if gaps["losses"] > 1e-4 or gaps["grad_norm"] > 1e-3:
        fail(f"train f32 card vs CPU differ: {gaps}")
    report["deterministic_card_vs_cpu"] = dict(gaps, B=cpu_b, launches=counts)

    launched = {}
    states = {}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        for dropout, dtype in ((0.0, "bfloat16"), (0.0, "float32"), (0.1, "bfloat16"),
                               (0.1, "float32")):
            label = f"{'K6' if dropout == 0 else 'unfused-K7'}-{dtype}"
            steps = min(n_steps, 4) if (dropout, dtype) == (0.1, "float32") else n_steps
            hook = StageEvents()
            rep, state, step, batch = run_epoch(
                dropout, dtype, dev, b, steps, os.path.join(tmp, label), arch, hook)
            if dropout == 0.0:
                expect(rep["launches"], n_blocks * steps, 0, label)
            else:
                expect(rep["launches"], 0, n_band * steps, label)
            launched.setdefault("k6" if dropout == 0 else "k7", rep["launches"])
            report[label] = rep
            if timing and on_card and (dropout == 0.0 or dtype == "bfloat16"):
                rep["timing"] = time_steps(state, step, batch, b, smi, label)
                rep["stages"] = step_breakdown(state, step, hook, batch, smi, label,
                                               band=dropout > 0)
            del state, step, batch
            if on_card:
                torch.cuda.empty_cache()

    gaps, counts, _ = steps_card_vs_cpu(0.1, False, dev, cpu_b, 1, arch)
    log(f"train f32 dropout=0.1 stochastic (same draws), 1 step B={cpu_b}, card vs CPU: losses "
        f"rel {gaps['losses']:.2e} grad_norm rel {gaps['grad_norm']:.2e}, launches {counts}")
    expect(counts, 0, n_band, "unfused step")
    if gaps["losses"] > 1e-4 or gaps["grad_norm"] > 1e-3:
        fail(f"unfused train step f32 card vs CPU differ: {gaps}")
    report["unfused_card_vs_cpu"] = dict(gaps, B=cpu_b, launches=counts)
    REPORT["train"] = report
    return launched, report


# a small localizer for rehearsing the training phases on the CPU
TINY_ARCH = dict(input_dim=24, max_seq_len=96, embd_dim=32, fpn_dim=32, head_dim=32, n_head=2,
                 arch=(1, 1, 2), mha_win_size=(5, 5, -1),
                 regression_range=((0, 4), (4, 8), (8, 10000)), droppath=0.1)


def phase_train_kernel_timing(smi, dev="cuda", b=TRAIN_B):
    """K6 per production shape and K7 per banded length at the training
    batch, bf16, against their plain versions (interleaved, CUDA events),
    each beside its bound; for K7 also scaled_dot_product_attention with an
    additive band mask, the nearest library call (it computes a dense T x T
    softmax with -inf outside the band, without the -1e4 penalty's rounding:
    not the same function)."""
    import torch
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    out = {"k6": [], "k7": []}
    k_tot = p_tot = d_tot = 0.0
    with torch.no_grad():
        for names, mode, t, window in PROD_BLOCKS:
            x, xo, mask, packed = block_case(mode, t, window, b, bf16, dev, seed=t)
            coefs = draw_coefs(b, dev, seed=t)
            ms = {}
            for which in ("plain", "kernel", "kernel", "plain"):
                ms.setdefault(which, []).append(cuda_ms(
                    lambda: run_k6(which, x, xo, mask, coefs, packed, mode, window), 5))
            k_ms, p_ms = min(ms["kernel"]), min(ms["plain"])
            d_ms = device_ms(lambda: run_k6("kernel", x, xo, mask, coefs, packed, mode, window), 5)
            bms, by = bound(*k6_work(mode, t, window, b))
            k_tot += k_ms * len(names)
            p_tot += p_ms * len(names)
            d_tot += d_ms * len(names)
            out["k6"].append(dict(mode=mode, T=t, window=window, blocks=len(names), ms=k_ms,
                                  plain_ms=p_ms, device_ms=d_ms, bound_ms=bms, bound_by=by))
            log(f"time K6 B={b} {mode:7s} T={t:3d} w={window:2d} bf16: kernel {k_ms:.4f} ms "
                f"(device {d_ms:.4f})  plain {p_ms:.4f} ms  bound {bms:.4f} ms ({by}) ({smi})")
            del x, xo, mask, packed
        k6_bound = bound_sum([(*k6_work(mode, t, window, b), len(names))
                              for names, mode, t, window in PROD_BLOCKS])
        log(f"time K6 B={b}: the 18 launches of one training forward, kernel {k_tot:.3f} ms "
            f"(their kernels alone {d_tot:.3f} ms), plain {p_tot:.3f} ms, bound "
            f"{k6_bound[0]:.3f} ms ({k6_bound[1]}) ({smi})")
        # K7 calls of one unfused forward: 8 at T=768, 2 each at 384..48, 1 at 24
        calls = {768: 8, 384: 2, 192: 2, 96: 2, 48: 2, 24: 1}
        k7_tot = k7_plain = k7_lib = k7_dev = k7_lib_dev = 0.0
        for t in K7_TS:
            q, k, v, valid = k7_case(b, t, bf16, dev, seed=t)
            tp = time_pair(lambda which: run_k7(which, q, k, v, valid), rounds=3, iters=5)
            d_ms = device_ms(lambda: run_k7("kernel", q, k, v, valid))
            idx = torch.arange(t, device=dev)
            band = torch.zeros((t, t), dtype=bf16, device=dev).masked_fill_(
                (idx[:, None] - idx[None, :]).abs() > 3, float("-inf"))
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=band, scale=1.0)
            lib = cuda_ms(sdpa, 5, warmup=1)
            lib_dev = device_ms(sdpa)
            bms, by = bound(*k7_work(b, 4, t, 64, 3))
            k7_tot += tp["kernel"][0] * calls[t]
            k7_plain += tp["plain"][0] * calls[t]
            k7_lib += lib * calls[t]
            k7_dev += d_ms * calls[t]
            k7_lib_dev += lib_dev * calls[t]
            out["k7"].append(dict(T=t, calls=calls[t], ms=tp["kernel"][0], device_ms=d_ms,
                                  plain_ms=tp["plain"][0], library_ms=lib,
                                  library_device_ms=lib_dev, bound_ms=bms, bound_by=by))
            log(f"time K7 ({b}, 4, {t}, 64) w=3 bf16: kernel {tp['kernel'][0]:.4f} ms (device "
                f"{d_ms:.4f}, {100 * bms / d_ms:.0f}% of the bound)  plain {tp['plain'][0]:.4f} ms  "
                f"scaled_dot_product_attention + band mask (nearest library call, not the same "
                f"function) {lib:.4f} ms (device {lib_dev:.4f})  bound {bms:.4f} ms ({by}) ({smi})")
            del q, k, v, valid, band
        k7_bound = bound_sum([(*k7_work(b, 4, t, 64, 3), calls[t]) for t in K7_TS])
        share = calls[768] * out["k7"][0]["device_ms"] / k7_dev
        log(f"time K7 B={b}: the 17 launches of one unfused forward, kernel {k7_tot:.3f} ms "
            f"(device {k7_dev:.3f}, the 8 at T=768 {100 * share:.1f}% of it), plain "
            f"{k7_plain:.3f} ms, library {k7_lib:.3f} ms (device {k7_lib_dev:.3f}), bound "
            f"{k7_bound[0]:.3f} ms ({k7_bound[1]}) ({smi})")
    torch.cuda.empty_cache()
    totals = dict(k6=(k_tot, p_tot, k6_bound, d_tot),
                  k7=(k7_tot, k7_plain, k7_bound, k7_lib, k7_dev, k7_lib_dev, share))
    REPORT["train_kernel_timing"] = dict(per_shape=out, card=smi,
                                         totals={k: list(v) for k, v in totals.items()})
    return totals


# ------------------------------------------------------ offline shard sweep

OFFLINE_VIDEOS = 256                  # durations uniform in 4-16 s, plus one of 30 s
OFFLINE_LABELLED = 64                 # of them with metadata JSONs (0-3 fake segments)
OFFLINE_CPU_VIDEOS = 32               # the f32 card vs CPU shard
OFFLINE_LONG_PASSES = 4               # the timing shard: the cache's videos this many times
OFFLINE_TOL = dict(scores=1e-4, segments=1e-3, video_cls=2e-4)


@contextlib.contextmanager
def plain_block_calls():
    """Counts ``block_math`` calls on CUDA tensors while the context is open
    (a block on the card must take K1, never its plain version)."""
    from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as fb

    plain, counts = fb.block_math, {"cuda": 0}

    def counted(x, *args, **kwargs):
        if x.is_cuda:
            counts["cuda"] += 1
        return plain(x, *args, **kwargs)

    fb.block_math = counted
    try:
        yield counts
    finally:
        fb.block_math = plain


def flush_items(folder):
    """A shard folder's result items, in flush order."""
    from audio_visual_deepfake_detection_tpu_torch.infer.resume import flush_files

    items = []
    for path in flush_files(folder):
        with open(path) as f:
            items.extend(json.load(f))
    return items


def match_detections(got, want, tol=OFFLINE_TOL):
    """Two runs' items of the same videos, held to ``tol``: the video logit
    directly, the detections as a set (each of one run matched to an
    unclaimed one of the other within the score and segment tolerances, so a
    pair of near-equal scores may come out in either order); a detection
    may go unmatched only at the cut, its score within the tolerance of its
    list's lowest. Returns the largest differences and the unmatched count;
    fails on anything else."""
    want = {it["video_id"]: it for it in want}
    worst = dict(scores=0.0, segments=0.0, video_cls=0.0, unmatched=0)
    if sorted(want) != sorted(it["video_id"] for it in got):
        fail("the two runs hold different videos")
    for g in got:
        w = want[g["video_id"]]
        worst["video_cls"] = max(worst["video_cls"],
                                 float(np.abs(np.subtract(g["video_cls"], w["video_cls"])).max()))
        gs, ws = np.asarray(g["scores"]), np.asarray(w["scores"])
        gseg, wseg = np.asarray(g["segments"]).reshape(-1, 2), np.asarray(w["segments"]).reshape(-1, 2)
        free = np.ones(len(ws), bool)
        lost = []
        for i in np.argsort(-gs, kind="stable"):
            ok = free & (np.abs(ws - gs[i]) <= tol["scores"]) \
                & (np.abs(wseg - gseg[i]).max(axis=1, initial=0.0) <= tol["segments"])
            if not ok.any():
                lost.append(gs[i])
                continue
            j = int(np.flatnonzero(ok)[np.argmin(np.abs(ws[ok] - gs[i]))])
            free[j] = False
            worst["scores"] = max(worst["scores"], float(abs(ws[j] - gs[i])))
            worst["segments"] = max(worst["segments"], float(np.abs(wseg[j] - gseg[i]).max()))
        lost += list(ws[free])
        cut = min(gs.min(initial=np.inf), ws.min(initial=np.inf)) + tol["scores"]
        if any(s > cut for s in lost):
            fail(f"{g['video_id']}: {len(lost)} detections unmatched within {tol} "
                 f"({len(gs)} vs {len(ws)} detections)")
        worst["unmatched"] += len(lost)
        worst["matched"] = worst.get("matched", 0) + len(gs) - len(lost)
    if worst["video_cls"] > tol["video_cls"] or not worst.get("matched"):
        fail(f"video logits differ by {worst['video_cls']:.3e}, or no detection at all")
    return worst


def offline_breakdown(config_path, ckpt, dev, smi, b=16, n=32):
    """Where a B=16 bf16 batch of the sweep spends its time, stage by stage
    on the card: np.load + native resample of one video on one thread (the
    loader runs ``num_workers`` of them), the copy of a pinned batch to the
    card, the localizer forward, decode + soft-NMS (the rest of
    ``infer_fn``), the detections back to the host. CUDA events; host clock
    for the host stages."""
    import torch
    from audio_visual_deepfake_detection_tpu_torch.cli.inference import load_localizer
    from audio_visual_deepfake_detection_tpu_torch.core.config import (
        arch_config_from, load_config, test_config_from)
    from audio_visual_deepfake_detection_tpu_torch.data import DeepfakeInferenceDataset
    from audio_visual_deepfake_detection_tpu_torch.infer.runner import (
        build_inference_fn, collate_infer_varlen, results_to_items)
    from audio_visual_deepfake_detection_tpu_torch.models.meta_arch import DTYPES

    config = load_config(config_path)
    cfg, tcfg = arch_config_from(config), test_config_from(config)
    ds = DeepfakeInferenceDataset(config["dataset_name"], ["test"], 1, config["dataset"])
    t0 = time.perf_counter()
    samples = [ds[i] for i in range(n)]
    load_ms = 1e3 * (time.perf_counter() - t0) / n
    batch = collate_infer_varlen(samples[:b], cfg.max_div_factor, cfg.max_seq_len,
                                 DTYPES[cfg.compute_dtype], pin=True)
    model = load_localizer(cfg, ckpt, torch.device(dev))
    fn = build_inference_fn(cfg, tcfg)
    meta = [torch.as_tensor(batch[k]).to(dev) for k in ("fps", "duration", "feat_stride",
                                                       "feat_num_frames")]
    mask = torch.as_tensor(batch["mask"]).to(dev)
    x = batch["feats"].to(dev)
    copy_ms = cuda_ms(lambda: batch["feats"].to(dev, non_blocking=True), 10)
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: model(x, mask), 10)
    infer_ms = cuda_ms(lambda: fn(model, x, mask, *meta), 5)
    out = fn(model, x, mask, *meta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results_to_items(batch["video_ids"], out[0], out[1], out[3], out[4])
    fetch_ms = 1e3 * (time.perf_counter() - t0)
    workers = config["loader"]["num_workers"]
    rows = [("np.load + native resample, one video, one thread", load_ms),
            (f"  the batch's {b} over {workers} loader threads", load_ms * b / workers),
            (f"host -> card copy, ({b}, {cfg.max_seq_len}, {cfg.input_dim}) "
             f"{cfg.compute_dtype} pinned", copy_ms),
            ("localizer forward (K1 18 launches + eager)", forward_ms),
            ("decode + soft-NMS (infer_fn - forward)", infer_ms - forward_ms),
            ("detections to the host (results_to_items, after a sync)", fetch_ms)]
    log(f"offline breakdown, one B={b} batch ({smi}):")
    for name, ms in rows:
        log(f"  {name:62s} {ms:9.3f} ms")
    return {name: ms for name, ms in rows}


def phase_offline_inference(dev="cuda", n_videos=OFFLINE_VIDEOS, n_labelled=OFFLINE_LABELLED,
                            n_cpu=OFFLINE_CPU_VIDEOS, dims=(256, 2048, 768), overrides=None,
                            batches=(16, 64), smi=""):
    """The offline sweep from feature caches to submission files and mAP,
    through the port's CLIs in this process, as a user runs them:
    ``configs_test/deepfake_exp12_test.yaml`` (full width and depth, its
    test config with the 0.2 score cut) in bf16, over a seeded cache of
    ``n_videos`` videos (durations 4-16 s and one of 30 s, each stream at its
    native rate and width) and a checkpoint of seeded weights whose EMA copy
    differs from the raw one (and whose classifier bias is 0, so scores
    reach the cut). Checks, each a failure:
    (1) the host-resample route at each of ``batches`` and the
    device-resample route at 16 yield one item per video (the host route
    is timed again over the shard read ``OFFLINE_LONG_PASSES`` times, so
    that its rate is not the pipeline's fill); (2) K1 launches
    18 times a forward, no other kernel launches and no block runs its
    plain version on the card; (3) a run stopped by a preemption request
    after 5 batches and resumed covers every video once with the
    uninterrupted run's detections; (4) f32 on the card matches the CPU over
    ``n_cpu`` videos (scores 1e-4, segments 1e-3, logit 2e-4); (5) the two
    routes agree in f32 at those tolerances; (6) ``generate_results`` writes
    one line and one key per video; (7) ``validate`` gives a finite mAP at
    the four tIoUs and the evaluator 1.0 on the ground truth fed back.
    ``overrides`` (a config fragment) shrink the model for a CPU rehearsal."""
    import shutil
    import tempfile
    import torch
    from audio_visual_deepfake_detection_tpu_torch.cli import (
        generate_results, inference, validate)
    from audio_visual_deepfake_detection_tpu_torch.core.config import (
        arch_config_from, load_config)
    from audio_visual_deepfake_detection_tpu_torch.eval import ANETdetection, run_evaluation
    from audio_visual_deepfake_detection_tpu_torch.models import build_localizer
    from audio_visual_deepfake_detection_tpu_torch.tools import synth_cache
    from audio_visual_deepfake_detection_tpu_torch.train.preempt import PreemptionGuard

    on_card = torch.device(dev).type == "cuda"
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    report = {}
    need = 2 * 2.8e6 * n_videos * sum(dims) / 3072    # ~2.8 MB a 10 s video, twice over
    free = shutil.disk_usage(build).free
    if free < need:                       # halve the sweep, and say so
        n_videos, n_labelled = n_videos // 2, n_labelled // 2
        log(f"offline: {free / 1e9:.1f} GB free for ~{need / 1e9:.1f} GB of caches: "
            f"{n_videos} videos")
        report["halved_for_disk"] = True
    root = tempfile.mkdtemp(dir=build)
    try:
        t0 = time.perf_counter()
        cache = synth_cache.write_feature_cache(root, n_videos - 1, seed=9, dims=dims,
                                                extra_durations=(30.0,), n_labelled=n_labelled)
        synth_cache.write_shard_list(cache["test_folder"], 2, cache["records"][:n_cpu])
        synth_cache.write_shard_list(cache["test_folder"], 3,
                                     cache["records"] * OFFLINE_LONG_PASSES)
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        log(f"offline: cache of {n_videos} videos ({size / 1e9:.2f} GB, "
            f"{1e3 * (time.perf_counter() - t0):.0f} ms to write), {n_labelled} labelled")
        base = os.path.join(REPO, "configs_test", "deepfake_exp12_test.yaml")
        configs = {}
        for dtype in ("bfloat16", "float32"):
            configs[dtype] = synth_cache.write_config(
                base, os.path.join(root, f"{dtype}.yaml"), cache, os.path.join(root, "runs"),
                synth_cache.merge({"tpu": {"compute_dtype": dtype}}, overrides or {}))
        config = load_config(configs["float32"])
        cfg = arch_config_from(config)
        n_blocks = 1 + cfg.arch[1] + 3 * cfg.arch[2]
        raw = build_localizer(cfg, seed=11, device="cpu")
        ema = perturb(build_localizer(cfg, seed=0, device="cpu"), 1).state_dict()
        # a trained model's scale of scores: under the focal prior's bias
        # (p = 0.01) no seeded score would pass the test config's 0.2 cut
        ema["cls_head.cls_head.conv.bias"].zero_()
        ckpt = synth_cache.write_checkpoint(os.path.join(root, "ckpt"), raw, config, ema)
        ids = sorted(r["id"] for r in cache["records"])

        def sweep(label, dtype, *flags, out=None, device=None, sub=1, preempt=None):
            """One CLI run over shard ``sub``; its items, summary, launches."""
            folder = os.path.join(root, out or label)
            cfg_path = synth_cache.write_config(
                configs[dtype], os.path.join(root, f"{label}.yaml"), cache, folder)
            args = [cfg_path, str(sub), "--ckpt", os.path.dirname(ckpt), *flags]
            if device is not None or not on_card:
                args += ["--device", device or dev]
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            with plain_block_calls() as plain:
                summary = inference.run(inference.build_parser().parse_args(args), preempt)
            counts = launch_counts()
            st = summary["stats"]
            if on_card and (device or dev) == "cuda":
                want = dict.fromkeys(counts, 0)
                want["fused_transformer_block"] = n_blocks * st["batches"]
                if counts != want or plain["cuda"]:
                    fail(f"offline {label}: launches {counts}, {plain['cuda']} plain block "
                         f"calls on the card; expected {want}")
            rate = st["videos"] / summary["seconds"] if summary["seconds"] else 0.0
            # without the first batch, whose wait is the pipeline's fill
            rest_s = st["seconds"] - st["first_s"]
            rest_wait = st["wait_s"] - st["first_wait_s"]
            rest_rate = (st["videos"] - st["first_videos"]) / rest_s if rest_s > 0 else 0.0
            peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
            rec = dict(videos=st["videos"], batches=st["batches"], seconds=summary["seconds"],
                       videos_per_s=rate, wait_s=st["wait_s"], infer_ms=st["infer_ms"],
                       fetch_s=st["fetch_s"], flush_s=st["flush_s"], peak_gib=peak,
                       first_s=st["first_s"], first_wait_s=st["first_wait_s"],
                       after_first_videos_per_s=rest_rate, after_first_wait_s=rest_wait,
                       after_first_s=rest_s, k1_launches=counts["fused_transformer_block"])
            log(f"offline {label}: {st['videos']} videos in {summary['seconds']:.3f} s = "
                f"{rate:.1f} videos/s; waits on the loader {st['wait_s']:.3f} s, infer_fn "
                f"{st['infer_ms']:.1f} ms on the device, fetch {st['fetch_s']:.3f} s, flushes "
                f"{st['flush_s']:.3f} s; K1 {counts['fused_transformer_block']} launches in "
                f"{st['batches']} forwards"
                + (f", peak {peak:.2f} GiB" if peak is not None else "")
                + (f"; without the first batch (fill {st['first_s']:.3f} s, of it "
                   f"{st['first_wait_s']:.3f} s waiting): {rest_rate:.1f} videos/s, waits "
                   f"{rest_wait:.3f} of {rest_s:.3f} s" if st["batches"] > 1 else ""))
            return flush_items(summary["out_folder"]), summary, rec

        def covers(label, items, want_ids):
            got = [it["video_id"] for it in items]
            if sorted(got) != sorted(want_ids):
                fail(f"offline {label}: {len(got)} items for {len(want_ids)} videos "
                     f"({len(set(got))} distinct)")

        # (1), (2): both routes cover the shard; cold then warm for the rates
        runs = {}
        b0 = batches[0]
        for label, flags in ([(f"host_b{b}", ("--batch-size", str(b))) for b in batches]
                             + [(f"device_resample_b{b0}",
                                 ("--batch-size", str(b0), "--device-resample"))]):
            for rep in ("cold", "warm"):
                items, summary, rec = sweep(f"{label}_{rep}", "bfloat16", *flags)
                covers(label, items, ids)
                report[f"{label}_{rep}"] = rec
            runs[label] = items
        # the host route's rates at length: the shard read OFFLINE_LONG_PASSES
        # times over (from the page cache, as the warm runs read it), so that
        # the first batch's wait, the pipeline's fill, is a small share
        for b in batches:
            _, _, rec = sweep(f"long_b{b}", "bfloat16", "--batch-size", str(b), sub=3)
            report[f"host_b{b}_long"] = rec

        # (3) preemption after 5 batches, then --resume
        class StopAfter(PreemptionGuard):
            def __init__(self, n):
                super().__init__(signals=())
                self.n, self.polls = n, 0

            def requested(self):
                self.polls += 1
                return self.polls >= self.n

        flags = ("--batch-size", str(b0), "--flush-every", str(3 * b0))
        first, s1, _ = sweep("preempt", "bfloat16", *flags, preempt=StopAfter(5))
        if not s1["preempted"] or len(first) != 5 * b0:
            fail(f"offline preempt: stopped {s1['preempted']} after {len(first)} videos")
        items, s2, _ = sweep("resume", "bfloat16", *flags, "--resume", out="preempt")
        covers("preempt + resume", items, ids)
        full = {it["video_id"]: it for it in runs[f"host_b{b0}"]}
        differ = [it["video_id"] for it in items if it != full[it["video_id"]]]
        if differ or s2["done_before"] != 5 * b0:
            fail(f"offline resume: {s2['done_before']} found done, {len(differ)} videos differ "
                 f"from the uninterrupted run, e.g. {differ[:3]}")
        report["preempt_resume"] = dict(first=len(first), resumed=s2["stats"]["videos"],
                                        identical=True)
        log(f"offline preempt + resume: {len(first)} + {s2['stats']['videos']} videos, every "
            f"video once, detections equal to the uninterrupted run's")

        # (4), (5) f32: card vs CPU, host vs device resample
        ids_cpu = sorted(r["id"] for r in cache["records"][:n_cpu])
        f32 = {}
        for label, device, flags in (("f32_cpu", "cpu", ()), ("f32_card", dev, ()),
                                     ("f32_card_device_resample", dev, ("--device-resample",))):
            f32[label], _, rec = sweep(label, "float32", *flags, device=device, sub=2)
            covers(label, f32[label], ids_cpu)
            report[label] = rec
        report["f32_card_vs_cpu"] = match_detections(f32["f32_card"], f32["f32_cpu"])
        report["f32_routes"] = match_detections(f32["f32_card_device_resample"],
                                                f32["f32_card"])
        log(f"offline f32 card vs CPU over {n_cpu} videos: {report['f32_card_vs_cpu']}; "
            f"device vs host resample: {report['f32_routes']}")

        # (6) the submission files of the first batch size's run
        base_out = os.path.join(root, f"host_b{b0}_warm")
        n_txt, n_json = generate_results.main([base_out, "--num-shards", "1"])
        with open(os.path.join(base_out, "prediction.txt")) as f:
            lines = f.read().splitlines()
        with open(os.path.join(base_out, "prediction.json")) as f:
            pred = json.load(f)
        if not (n_txt == n_json == len(lines) == len(pred) == n_videos):
            fail(f"offline submission: {len(lines)} lines, {len(pred)} keys for {n_videos}")
        kept = sum(v != [[0, 0, 0]] for v in pred.values())
        report["submission"] = dict(lines=len(lines), keys=len(pred), videos_over_0_2=kept)
        log(f"offline submission: prediction.txt {len(lines)} lines, prediction.json "
            f"{len(pred)} keys ({kept} with a segment of score > 0.2)")

        # (7) validation mAP, and 1.0 on the ground truth fed back
        vargs = [configs["bfloat16"], "--ckpt", ckpt, "--output",
                 os.path.join(root, "eval", "proposals.json")]
        if not on_card:
            vargs += ["--device", dev]
        reset_counts()
        with plain_block_calls() as plain:
            out = validate.main(vargs)
        if on_card and (launch_counts()["fused_transformer_block"] == 0 or plain["cuda"]):
            fail("offline validate: K1 did not run, or a block ran its plain version")
        at = [float(w) for w in out["summary"].split()[4::2]]
        if len(at) != 4 or not all(math.isfinite(v) for v in at + [out["mAP"]]):
            fail(f"offline validate: {out['summary']!r}")
        gt = out["gt_records"]
        perfect = {"video-id": [], "t-start": [], "t-end": [], "label": [], "score": []}
        for rec in gt:
            for s, e in (rec["segments_time"] if rec["n_fakes"] else []):
                for key, v in zip(perfect, (rec["video_id"], float(s), float(e), 0, 1.0)):
                    perfect[key].append(v)
        perfect = {k: np.asarray(v) for k, v in perfect.items()}
        _, m_ap, avg = ANETdetection(gt).evaluate(perfect)
        again, _ = run_evaluation(perfect, gt, os.path.join(root, "eval", "gt.json"),
                                  verbose=False)
        if not (avg == 1.0 and list(m_ap) == [1.0] * 4 and again == 100.0):
            fail(f"offline evaluator on the ground truth: {list(m_ap)}, {again}")
        report["validate"] = dict(videos=len(gt), segments=len(perfect["score"]),
                                  mAP=out["mAP"], mAP_at=at, gt_fed_back=avg)
        log(f"offline validate: {len(gt)} videos, {len(perfect['score'])} fake segments, "
            f"{out['summary']}; ground truth fed back: {avg}")

        if on_card:
            report["breakdown"] = offline_breakdown(configs["bfloat16"], ckpt, dev, smi, b=b0)
        log(f"card: {smi}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    REPORT["offline_inference"] = report
    return report


def main_path_loss(kernels, k1_totals, k1_bounds, mvit_group, k4_table, audio_times, smi,
                   n_videos=64, group=32):
    """What each kernel of the main path costs one ``n_videos``-video media ->
    detections run above its bound: launches x (time - bound) at the batch
    that run hands it (K1 and the audio kernels at 64, the video kernels in
    groups of 32 chunks), bf16. The next kernel to redesign is read off this
    column. Adds the three numbers to the kernels' entries."""
    groups = n_videos // group
    k4_bound = bound_sum([(*k4_work(group, hw[0] * hw[1], c, VIDEO_T), n)
                          for hw, c, _, n in MSBLOCK_SHAPES])[0]
    per_run = {
        "fused_transformer_block": (k1_totals[n_videos][0], k1_bounds[n_videos][0]),
        "patch_embed": tuple(groups * mvit_group["patch_embed"][k] for k in ("ms", "bound_ms")),
        "pooled_attention": tuple(groups * mvit_group["pooled_attention"][k]
                                  for k in ("ms", "bound_ms")),
        "multiscale_block": (groups * k4_table["forward_ms"], groups * k4_bound),
        "conv_extractor": tuple(audio_times["conv_extractor"][n_videos][k]
                                for k in ("ms", "bound_ms")),
        "full_mha": tuple(12 * audio_times["full_mha"][n_videos][k] for k in ("ms", "bound_ms")),
    }
    launches = REPORT["audio_timing"]["rates"][f"media -> detections launches B={n_videos}"]
    log(f"kernel time above its bound on one {n_videos}-video media -> detections run, bf16 "
        f"({smi}):")
    rows = {}
    for k in kernels:
        if k["name"] not in per_run:
            continue
        ms, b_ms = per_run[k["name"]]
        k["main_path_ms_64"], k["main_path_bound_ms_64"] = ms, b_ms
        k["main_path_lost_ms_64"] = ms - b_ms
        rows[k["name"]] = dict(launches=launches[k["name"]], ms=ms, bound_ms=b_ms, lost_ms=ms - b_ms)
        log(f"  {k['name']:24s} {launches[k['name']]:3d} launches {ms:9.3f} ms, bound "
            f"{b_ms:8.3f} ms, lost {ms - b_ms:9.3f} ms")
    REPORT["main_path_loss"] = dict(card=smi, videos=n_videos, kernels=rows)


def main():
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        return 2
    try:
        from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as fb
    except ImportError as e:
        print(f"the port package is not importable here: {e}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = timed(phase_build)
    timed(phase_config)
    worst = timed(phase_kernels)
    dense_worst = timed(phase_k1_dense)
    timed(phase_long_forward)
    model, cfg = timed(phase_serve)
    serve_launches = REPORT["serve"]["launches"]
    mvit_worst = timed(phase_mvit_kernels)
    k4_table = timed(k4_launch_table, smi)
    audio_worst = timed(phase_audio_kernels)
    ex, video_launched = timed(phase_video, smi=smi)
    ex, audio_launched = timed(phase_audio, ex.video_model, smi=smi)
    media_launched = timed(phase_media_detections, ex, model, cfg, smi=smi)
    k6_worst, k6_grad = timed(phase_k6)
    k7_worst = timed(phase_k7)
    train_launched, train_report = timed(phase_train, smi=smi)
    totals, worst_timed, k1_bounds = timed(phase_timing, model, cfg, smi)
    mvit_totals, mvit_bounds, mvit_library, mvit_group = timed(phase_mvit_timing, smi)
    audio_times, _, k5_rules = timed(phase_audio_timing, ex, model, cfg, smi)
    train_times = timed(phase_train_kernel_timing, smi)
    timed(k7_variants, smi)
    offline = timed(phase_offline_inference, smi=smi)
    for mod in ("jax", "audio_visual_deepfake_detection_tpu"):
        if mod in sys.modules:
            fail(f"{mod} was imported")
    REPORT["seconds"] = time.perf_counter() - t_start
    src = "audio_visual_deepfake_detection_tpu_torch/csrc/"
    pallas = "audio_visual_deepfake_detection_tpu/ops/pallas/"
    kernels = [{
        "name": "fused_transformer_block",
        "route": "cuda",
        "source": src + "fused_block.cu",
        "replaces": pallas + "fused_block.py:473",
        "launches": serve_launches,
        "max_abs_err": max(worst["float32"], dense_worst["float32"]),
        "max_abs_err_bf16": max(worst["bfloat16"], worst_timed, dense_worst["bfloat16"]),
        "tolerance": {"float32": F32_ATOL, "bfloat16": BF16_TOL},
        "ms": totals[16][0],
        "plain_ms": totals[16][1],
        "bound_ms": k1_bounds[16][0],
        "bound_by": k1_bounds[16][1],
        "library_ms": None,
        "device_ms": REPORT["timing"]["block_device_ms"]["16"],
        "ms_b64": totals[64][0],
        "device_ms_b64": REPORT["timing"]["block_device_ms"]["64"],
        "plain_ms_b64": totals[64][1],
        "bound_ms_b64": k1_bounds[64][0],
        "ms_b512": totals[512][0],
        "device_ms_b512": REPORT["timing"]["block_device_ms"]["512"],
        "plain_ms_b512": totals[512][1],
        "bound_ms_b512": k1_bounds[512][0],
        "note": "ms = sum over the 18 blocks of one forward at B=16 bf16 (two CUDA launches "
                "a block, counted once); launches_offline_inference = the offline sweep's "
                "256 videos at B=16 through cli/inference.py",
        "launches_offline_inference": offline["host_b16_warm"]["k1_launches"],
    }]
    for name, file, line in (("patch_embed", "patch_embed", 140),
                             ("pooled_attention", "mvit_attention", 72),
                             ("multiscale_block", "mvit_block", 313)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + file + ".cu",
            "replaces": f"{pallas}{file}.py:{line}",
            "launches": video_launched[name],
            "max_abs_err": mvit_worst[name]["float32"],
            "max_abs_err_bf16": mvit_worst[name]["bfloat16"],
            "tolerance": {"float32": "atol 1e-4 rtol 5e-4",
                          "bfloat16": "atol=rtol=2e-2 or distributional"},
            "ms": mvit_totals[name][0],
            "plain_ms": mvit_totals[name][1],
            "bound_ms": mvit_bounds[name][0],
            "bound_by": mvit_bounds[name][1],
            "library_ms": mvit_library.get(name),
            "device_ms": REPORT["mvit_timing"]["device_totals"].get(name),
            "note": "ms = sum over one 2-chunk mvit_v2_b forward's launches, bf16, through "
                    "the wrappers (CUDA events); device_ms = their kernels alone (CUDA "
                    "graph replay)",
        })
    kernels[-1].update(ms_32_chunks=k4_table["forward_ms"],
                       tflops_32_chunks=k4_table["forward_tflops"])
    for k in kernels[1:3]:      # K2, K3: one forward of a 32-chunk group of the main path
        g = mvit_group[k["name"]]
        k.update(ms_32_chunks=g["ms"], device_ms_32_chunks=g["device_ms"],
                 bound_ms_32_chunks=g["bound_ms"], library_ms_32_chunks=g["library_ms"])
    kernels[2].update(routes_media_to_detections=REPORT["media_detections"]["routes"],
                      tolerance={"float32": "atol 1e-4 rtol 5e-4", "bfloat16": K3_BF16_RULE})
    kernels[1]["note"] += "; the uint8 entry (the main path's); library_ms = F.conv3d in bf16"
    kernels[2]["note"] += ("; the table entry (the main path's: band built in the kernel); "
                           "library_ms = scaled_dot_product_attention with [band | 0] as an "
                           "additive mask, then + q: the nearest PyTorch calls, not one call")
    for name, file, line, per_forward, tol in (
            ("conv_extractor", "conv_extractor", 177, 1,
             {"float32": "atol 1e-4 rtol 5e-4", "bfloat16": " | ".join(k5_rules)}),
            ("full_mha", "full_attention", 114, audio_launched["full_mha"],
             K8_RULES)):
        t16 = audio_times[name][16]
        lib = t16.get("library_ms")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + file + ".cu",
            "replaces": f"{pallas}{file}.py:{line}",
            "launches": audio_launched[name],
            "max_abs_err": audio_worst[name]["float32"],
            "max_abs_err_bf16": audio_worst[name]["bfloat16"],
            "tolerance": tol,
            "ms": t16["ms"] * per_forward,
            "plain_ms": t16["plain_ms"] * per_forward,
            "bound_ms": t16["bound_ms"] * per_forward,
            "bound_by": t16["bound_by"],
            "library_ms": None if lib is None else lib * per_forward,
            "per_call_ms": {str(b): t["ms"] for b, t in audio_times[name].items()},
            "per_call_device_ms": {str(b): t.get("device_ms")
                                   for b, t in audio_times[name].items()},
            "per_call_library_device_ms": {str(b): t.get("library_device_ms")
                                           for b, t in audio_times[name].items()},
            "note": f"ms = the {per_forward} launch(es) of one Emotion2Vec forward on 16 wavs "
                    f"of 9.6 s, bf16",
        })
    for k in kernels:
        k["launches_media_to_detections"] = media_launched[k["name"]]
    k6_ms, k6_plain, k6_bound, k6_dev = train_times["k6"]
    kernels.append({
        "name": "fused_transformer_block_train",
        "route": "cuda",
        "source": src + "fused_block.cu",
        "replaces": pallas + "fused_block.py:753",
        "launches": train_launched["k6"]["fused_transformer_block_train"],
        "max_abs_err": k6_worst["float32"],
        "max_abs_err_bf16": k6_worst["bfloat16"],
        "grad_gap": k6_grad,
        "tolerance": {"float32": F32_ATOL, "bfloat16": BF16_TOL,
                      "grads": "Function vs block_math 1e-6, f32 card vs CPU "
                               f"{GRAD_TOL:g}, relative to max(1, max |ref|)"},
        "ms": k6_ms,
        "device_ms": k6_dev,
        "plain_ms": k6_plain,
        "bound_ms": k6_bound[0],
        "bound_by": k6_bound[1],
        "library_ms": None,
        "note": f"launches = {train_report['K6-bfloat16']['steps']} bf16 training steps at "
                f"B={TRAIN_B}; ms = the 18 forward launches of one step at B={TRAIN_B} bf16; "
                "the backward differentiates the plain version, as the TPU kernel's does",
    })
    k7_ms, k7_plain, k7_bound, k7_lib, k7_dev, k7_lib_dev, k7_share = train_times["k7"]
    kernels.append({
        "name": "band_attention",
        "route": "cuda",
        "source": src + "band_attention.cu",
        "replaces": pallas + "band_attention.py:77",
        "launches": train_launched["k7"]["band_attention"],
        "max_abs_err": k7_worst["float32"],
        "max_abs_err_bf16": k7_worst["bfloat16"],
        "tolerance": {"float32": f"atol {K7_F32_ATOL:g}",
                      "bfloat16": f"atol=rtol=2e-2, and within {NO_WORSE:g}x of plain vs f32"},
        "ms": k7_ms,
        "device_ms": k7_dev,
        "plain_ms": k7_plain,
        "bound_ms": k7_bound[0],
        "bound_by": k7_bound[1],
        "library_ms": k7_lib,
        "library_device_ms": k7_lib_dev,
        "device_share_t768": k7_share,
        "redesigned": "8-row tiles across a 512-byte run of heads, k / v and their halo "
                      "staged by cp.async, a warp a row, w a template parameter, one grid axis",
        "note": f"launches = {train_report['unfused-K7-bfloat16']['steps']} bf16 training steps "
                f"with dropout 0.1 at B={TRAIN_B}; ms = the 17 launches of one unfused forward "
                f"at B={TRAIN_B} bf16 through the wrapper (device_ms: the kernels alone); "
                "library_ms = scaled_dot_product_attention with an additive band mask, the "
                "nearest library call, not the same function",
    })
    main_path_loss(kernels, totals, k1_bounds, mvit_group, k4_table, audio_times, smi)
    REPORT["kernels"] = kernels
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke_report.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
