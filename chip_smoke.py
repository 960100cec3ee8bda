#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one Hopper card.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
1. build   - nvcc-builds the port's CUDA sources into build/kernels/ and
             prints the toolchain and the card's name and power limit;
2. kernels - the fused transformer-block kernel against its plain PyTorch
             version (block_math), both on the card, for every production
             (mode, T, attention) combination of the HRLR backbone at the
             service batch B=16, f32 (atol 1e-4) and bf16 (atol = rtol =
             2e-2), with partial masks and O(1) layer scales / LN affines;
3. serve   - a production-width LocalizerService (3072-d input, T=768,
             C=256, 4 heads, windows (7,7,7,7,7,-1), bf16, seeded weights)
             answers requests of varied valid length; every forward must
             launch the block kernel 18 times; then f32 on 2 videos, the
             card's kernel path against the same model's plain path on the
             CPU (scores 1e-4, segments 1e-3, video_cls 2e-4);
4. timing  - the kernel and its plain version per production shape at B=16
             and B=512 (bf16), their outputs held to each other (atol = rtol
             = 2e-2), the host cost of packing the block weights, service
             latency at batch 16, localizer-only videos/s at B=512 bf16 (the
             program of bench.py::measure_ours).

The card's name and power limit, then a JSON object with the kernels'
launches, errors and times, are the two lines before the last; the last
line is {"ok": true, "device": {...}}. A full report goes to
build/chip_smoke_report.json.
"""

from __future__ import annotations

import json
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


# ----------------------------------------------------------------- phases

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
        if "registers" in line or "spill" in line or "smem" in line:
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
    import math

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


def phase_kernels(dev="cuda", blocks=PROD_BLOCKS, b=16):
    """Kernel vs block_math at batch ``b``: five varied valid lengths
    (full, 3/4, 1/3, one row, none), the rest full."""
    import torch

    worst = {"float32": 0.0, "bfloat16": 0.0}
    rows = []
    for names, mode, t, window in blocks:
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
                fail(f"kernel disagrees with block_math: {mode} T={t} {name}")
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
    model = perturb(build_localizer(cfg, seed=0), 1).to(dev)
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
    m32 = perturb(build_localizer(cfg32, seed=0), 1)
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
    totals = {}
    worst = 0.0
    for b in (16, 512):
        k_tot = p_tot = 0.0
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
            iters = 20 if b == 16 else 3
            ms = {}
            for which in ("plain", "kernel", "kernel", "plain"):   # interleaved
                ms.setdefault(which, []).append(cuda_ms(
                    lambda: run_block(which, x, xo, mask, packed, mode, window), iters))
            k_ms, p_ms = min(ms["kernel"]), min(ms["plain"])
            k_tot += k_ms * len(names)
            p_tot += p_ms * len(names)
            per_shape.append(dict(B=b, mode=mode, T=t, window=window, max_abs_err=err,
                                  beyond_atol_rtol=n_over, kernel_ms=k_ms, plain_ms=p_ms,
                                  blocks=len(names)))
            log(f"time B={b:3d} {mode:7s} T={t:3d} w={window:2d}: kernel "
                f"{k_ms:.4f} ms  plain {p_ms:.4f} ms  ({smi})")
            del x, xo, mask, packed
        totals[b] = (k_tot, p_tot)
        log(f"time B={b}: 18 blocks of one forward, kernel {k_tot:.3f} ms, "
            f"plain {p_tot:.3f} ms ({smi})")
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
                            profile=profile, card=smi)
    return totals, worst


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


def profile_forward(run, forward_ms, smi):
    """Device time by kernel over one B=512 forward (torch.profiler, CUPTI).
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
    top = sorted(kernels, key=dev, reverse=True)[:12]
    log(f"profile, one B=512 forward: kernels busy {total_us / 1e3:.2f} ms of "
        f"{forward_ms:.2f} ms wall, {len(kernels)} kernel names ({smi})")
    rows = []
    for e in top:
        rows.append(dict(name=e.key[:90], device_ms=dev(e) / 1e3, calls=e.count))
        log(f"  {dev(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    return dict(device_ms=total_us / 1e3, forward_ms=forward_ms, top=rows)


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
    smi = phase_build()
    worst = phase_kernels()
    model, cfg = phase_serve()
    serve_launches = REPORT["serve"]["launches"]
    totals, worst_timed = phase_timing(model, cfg, smi)
    for mod in ("jax", "audio_visual_deepfake_detection_tpu"):
        if mod in sys.modules:
            fail(f"{mod} was imported")
    REPORT["seconds"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke_report.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "fused_transformer_block",
        "route": "cuda",
        "source": "audio_visual_deepfake_detection_tpu_torch/csrc/fused_block.cu",
        "replaces": "audio_visual_deepfake_detection_tpu/ops/pallas/fused_block.py:473",
        "launches": serve_launches,
        "max_abs_err": worst["float32"],
        "max_abs_err_bf16": max(worst["bfloat16"], worst_timed),
        "tolerance": {"float32": F32_ATOL, "bfloat16": BF16_TOL},
        "ms": totals[16][0],
        "plain_ms": totals[16][1],
        "ms_b512": totals[512][0],
        "plain_ms_b512": totals[512][1],
        "note": "ms = sum over the 18 blocks of one forward at B=16 bf16",
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
