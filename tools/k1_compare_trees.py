"""The production K1, the MViT kernels K3 and K4, or the frontends' K2, K5
and K8, in two source trees on one card. The trees run in turns a, b, b, a,
each in a process of its own that builds its own kernel library under its
``build/kernels/``.

K1 (the default): the 18 blocks of one localizer forward
(``chip_smoke.PROD_BLOCKS``), in bf16 or float32, device ms (each block
replayed as a CUDA graph, ``chip_smoke.device_ms``), summed, at B = 16, 64
and 512; with ``--wide``, also one self-mode block at each (C, heads, half
window; 0 dense) of the list at B = 2, T = 2304. Each run also hashes every
block's output, and the tool says at which shapes the two trees' outputs
are bit for bit the same.

``--kernels frontends``: in bf16 and float32, K2 (its uint8 entry and its
f32-frame entry, mvit_v2_b's 96 features) at 2 and 32 chunks, device ms of
one call replayed as a CUDA graph, K5 (one call: the seven layers) on B =
16 and 64 wavs of 9.6 s, and K8's 12 launches of one Emotion2Vec forward at
(B, 12, 479, 64) with the key mask, B = 16 and 64.

``--kernels k7``: in bf16 and float32, K7 at the unfused block's w = 3 on
(50, 4, T, 64) head views at each ``chip_smoke.K7_TS`` length, device ms
of one call replayed as a CUDA graph, and their sum; and at every
``chip_smoke.DOMAIN_K7`` shape and ``DOMAIN_K7_W`` window (the route past
the tiled kernel), each beside the nearest library call's device ms
(``chip_smoke.sdpa_nearest``: SDPA with the key mask and band).

``--kernels mvit``: in bf16 and float32, K4's 18 blocks of one mvit_v2_b
forward at 32 chunks (each ``chip_smoke.MSBLOCK_SHAPES`` geometry, device ms
of one call replayed as a CUDA graph, times its blocks), K3's three
launches (``chip_smoke.K3_SHAPES``, the table entry) at 2 and 32 chunks,
and MViT-v2-b chunks/s at 32 chunks in f32 through
``FeatureExtractor.video_chunks_features_device`` (the extractor's path,
best of two after a warm-up).

Every timed run also hashes each timed output (``--kernels mvit`` and
``frontends`` too), and the tool says where the two trees' outputs are bit
for bit the same.

With ``--precision`` it times nothing and runs each tree once, in float32,
against two plain versions on the same inputs: the one the checks hold the
kernel to, in f32, and the same with every f32 step in f64
(``Tensor.float`` swapped for ``Tensor.double``; for K3 / K4 the softmax's
denominator summed in f64 too: the exact function of the f32 inputs, to
f64 rounding). K2 and K8 (``--kernels frontends``) at the shapes that mode
times them, K8 at the ``chip_smoke.K8_CASES`` lengths up to 2000, masked
and not, and K5 on B = 2 wavs of ``chip_smoke.WAV_LEN`` and ``WAV_ODD``
samples, against ``patch_embed_math`` / ``full_mha_math`` /
``conv_extractor_math``. K1 / K6 at every
shape ``chip_smoke.py`` checks them at (K1:
the 18 production blocks' 13 shapes at B = 16 and 64 and the B = 512
full-length block; K6: the 13 at B = 50 with droppath coefficients; both at
every (C, heads, w) x T x mode of ``chip_smoke.WIDE_SHAPES`` / ``WIDE_TS``
at B = 2, and with ``--wide`` each listed shape at every
``chip_smoke.DOMAIN_TS`` length, K1 in the four modes and K6 in self mode)
against ``block_math``; K4 at each geometry and K3 at each shape,
at 2 and 32 chunks, against ``msblock_math`` /
``pooled_attention_table_math``; each on the cases and seeds of those
checks. Per shape it prints both trees' worst |d| from each and the ratio
b / a.

    python3 tools/k1_compare_trees.py PARENT_TREE CHANGED_TREE [--kernels k1|mvit|frontends|k7]
        [--dtype float32] [--wide 512,4,0 1024,8,0 ...] [--precision] [--out FILE]

A tree is a checkout of the repository (``git archive`` of a commit unpacked
into a folder). Prints each run and the mean of each tree with the change in
percent; ``--out`` writes them as JSON. Needs one card."""

import argparse
import json
import os
import subprocess
import sys

BATCHES = (16, 64, 512)

RUN = r"""
import hashlib, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c
dtype = getattr(torch, %r)
smi = c.phase_build()
out = {"card": smi}
digests = {}


def ms(run):
    # a call past 10 ms is timed over fewer replays
    return c.device_ms(run, iters=20 if c.cuda_ms(run, iters=1, warmup=1) < 10 else 5)


def timed(key, run):
    digests[key] = hashlib.sha256(run().float().cpu().numpy().tobytes()).hexdigest()
    return ms(run)


for b in %r:
    total = 0.0
    for names, mode, t, window in c.PROD_BLOCKS:
        x, xo, mask, packed = c.block_case(mode, t, window, b, dtype, "cuda", seed=t)
        with torch.no_grad():
            total += len(names) * timed(f"B={b} {mode} T={t} window={window}",
                lambda: c.run_block("kernel", x, xo, mask, packed, mode, window))
        del x, xo, mask, packed
        torch.cuda.empty_cache()
    out[f"B={b}"] = total
for cc, nh, w in %r:
    window = 2 * w + 1 if w else -1
    x, xo, mask, packed = c.block_case("self", 2304, window, 2, dtype, "cuda", cc, c=cc,
                                       n_head=nh)
    with torch.no_grad():
        out[f"({cc},{nh},{w})"] = timed(f"({cc},{nh},{w})",
            lambda: c.run_block("kernel", x, xo, mask, packed, "self", window, nh))
    del x, xo, mask, packed
out["digests"] = digests
print("RESULT " + json.dumps(out))
"""

DIGEST = r"""
import hashlib


def digest(t):
    return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()
"""

MVIT_RUN = DIGEST + r"""
import json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as c
from audio_visual_deepfake_detection_tpu_torch.frontends import pipeline

smi = c.phase_build()
out = {"card": smi}
digests = {}
with torch.no_grad():
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        total = 0.0
        for hw, cc, nh, n in c.MSBLOCK_SHAPES:
            blk, x = c.msblock_case(hw, cc, nh, dt, "cuda", b=32)
            run = lambda: c.run_msblock("kernel", blk, x, c.VIDEO_T, hw, nh)
            digests[f"K4 {dname} S={hw[0] * hw[1]} C={cc}"] = digest(run())
            ms = c.device_ms(run, iters=5)
            out[f"K4 {dname} S={hw[0] * hw[1]} C={cc}"] = ms * n
            total += ms * n
            del blk, x
            torch.cuda.empty_cache()
        out[f"K4 {dname} 18 blocks"] = total
        for chunks in (2, 32):
            total = 0.0
            for name, heads, s_cells, d, rnd, n in c.K3_SHAPES:
                args = c.k3_case(chunks, heads, s_cells, d, rnd, dt, "cuda")
                digests[f"K3 {dname} {name} B={chunks}"] = digest(c.run_k3("kernel", *args))
                ms = c.device_ms(lambda: c.run_k3("kernel", *args), iters=5)
                out[f"K3 {dname} {name} B={chunks}"] = ms * n
                total += ms * n
                del args
                torch.cuda.empty_cache()
            out[f"K3 {dname} 3 launches B={chunks}"] = total
    ex = pipeline.FeatureExtractor(video_model=c.video_model(torch.float32),
                                   compute_dtype="float32", device="cuda")
    x = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (32, c.VIDEO_T, 96, 96, 3), dtype=np.uint8)).cuda()
    ex.video_chunks_features_device(x)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.video_chunks_features_device(x)
        torch.cuda.synchronize()
        runs.append(32 / (time.perf_counter() - t0))
    out["MViT-v2-b f32 chunks/s B=32"] = max(runs)
out["digests"] = digests
print("RESULT " + json.dumps(out))
"""


FRONT_RUN = DIGEST + r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c

smi = c.phase_build()
out = {"card": smi}
digests = {}
with torch.no_grad():
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for u8 in (True, False):
            for chunks in (2, 32):
                video, w, bias, _ = c.patch_case(dt, "cuda", b=chunks, u8=u8)
                key = f"K2 {dname} {'uint8' if u8 else 'f32'} frames B={chunks}"
                run = lambda: c.run_patch("kernel", video, w, bias, dt)
                digests[key] = digest(run())
                out[key] = c.device_ms(run, iters=5)
                del video
                torch.cuda.empty_cache()
        for b in (16, 64):
            m, wav = c.k5_case(b, c.WAV_LEN, dt, "cuda", seed=b)
            run = lambda: c.run_k5("kernel", m, wav)
            digests[f"K5 {dname} B={b}"] = digest(run())
            out[f"K5 {dname} B={b}"] = c.device_ms(run, iters=5)
            del m, wav
            torch.cuda.empty_cache()
            q, k, v, mask = c.k8_case(b, c.E2V_T, dt, "cuda", True, seed=b)
            run = lambda: c.run_k8("kernel", q, k, v, mask)
            digests[f"K8 {dname} B={b}"] = digest(run())
            out[f"K8 {dname} 12 launches B={b}"] = 12 * c.device_ms(run)
            del q, k, v, mask
out["digests"] = digests
print("RESULT " + json.dumps(out))
"""


FRONT_PREC = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import conv_extractor as k5
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import full_attention as k8
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import patch_embed as k2

smi = c.phase_build()
rows = []


def f64(run):
    # the plain version with every .float() a .double()
    f = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        return run()
    finally:
        torch.Tensor.float = f


def record(kernel, shape, got, ref, exact):
    torch.cuda.synchronize()
    got, ref = got.double(), ref.double()
    rows.append(dict(kernel=kernel, shape=shape, plain=(got - ref).abs().max().item(),
                     f64=(got - exact).abs().max().item(),
                     plain_vs_f64=(ref - exact).abs().max().item()))


f32 = torch.float32
with torch.no_grad():
    for u8 in (True, False):
        for chunks in (2, 32):
            video, w, bias, _ = c.patch_case(f32, "cuda", b=chunks, u8=u8)
            frames = k2.normalize_u8(video) if u8 else video
            got = c.run_patch("kernel", video, w, bias, f32)
            ref = c.run_patch("plain", video, w, bias, f32)
            exact = f64(lambda: k2.patch_embed_math(frames, w, bias, torch.float64))
            record("K2", f"{'uint8' if u8 else 'f32'} frames B={chunks}", got, ref, exact)
            del video, frames, got, ref, exact
            torch.cuda.empty_cache()
    cases = [(b, c.E2V_T, True) for b in (16, 64)]
    cases += [(b, t, m) for b, t in c.K8_CASES if t <= 2000 for m in (False, True)]
    for b, t, masked in cases:
        q, k, v, mask = c.k8_case(b, t, f32, "cuda", masked, seed=b if t == c.E2V_T else t)
        got = c.run_k8("kernel", q, k, v, mask)
        ref = c.run_k8("plain", q, k, v, mask)
        exact = f64(lambda: k8.full_mha_math(q.double(), k.double(), v.double(), mask))
        record("K8", f"({b}, {c.E2V_H}, {t}, {c.E2V_D}) {'mask' if masked else 'no mask'}",
               got, ref, exact)
        del q, k, v, mask, got, ref, exact
        torch.cuda.empty_cache()
    for length in (c.WAV_LEN, c.WAV_ODD):
        m, wav = c.k5_case(2, length, f32, "cuda", seed=length + 2)
        got = c.run_k5("kernel", m, wav)
        ref = c.run_k5("plain", m, wav)
        exact = f64(lambda: k5.conv_extractor_math(
            wav.double(), [w.double() for w in m._weights()], m._ln_rows().double(),
            torch.float64))
        record("K5", f"B=2 L={length}", got, ref, exact)
        del m, wav, got, ref, exact
        torch.cuda.empty_cache()
print("RESULT " + json.dumps({"card": smi, "rows": rows}))
"""


MVIT_PREC = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_attention as k3
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import mvit_block as k4

smi = c.phase_build()
rows = []


def softmax_pv64(att, v):
    e = (att - att.amax(-1, keepdim=True)).exp()
    return (e @ v) / e.sum(-1, keepdim=True)


def f64(run):
    # the plain version with every .float() a .double() and its softmax in f64
    f, s3, s4 = torch.Tensor.float, k3.softmax_pv, k4.softmax_pv
    torch.Tensor.float = torch.Tensor.double
    k3.softmax_pv = k4.softmax_pv = softmax_pv64
    try:
        return run()
    finally:
        torch.Tensor.float, k3.softmax_pv, k4.softmax_pv = f, s3, s4


def record(kernel, shape, got, ref, exact):
    torch.cuda.synchronize()
    rows.append(dict(kernel=kernel, shape=shape, plain=(got - ref).abs().max().item(),
                     f64=(got - exact).abs().max().item(),
                     plain_vs_f64=(ref - exact).abs().max().item()))


with torch.no_grad():
    for chunks in (2, 32):
        for hw, cc, nh, n in c.MSBLOCK_SHAPES:
            blk, x = c.msblock_case(hw, cc, nh, torch.float32, "cuda", b=chunks)
            p = blk.packed(torch.float32)
            t, kw = c.VIDEO_T, dict(grid_hw=hw, n_head=nh)
            got = k4.fused_multiscale_block(x, p, t=t, **kw).double()
            ref = k4.msblock_math(x, p, t=t, **kw).double()
            p64 = k4.MSBlockPacked(*[None if a is None else a.double() for a in p])
            exact = f64(lambda: k4.msblock_math(x.double(), p64, t=t, **kw))
            record("K4", f"S={hw[0] * hw[1]} C={cc} heads={nh} B={chunks}", got, ref, exact)
            del blk, x, p, p64, got, ref, exact
            torch.cuda.empty_cache()
        for name, heads, s_cells, d, rnd, n in c.K3_SHAPES:
            qf, k, v, rel, s, br = c.k3_case(chunks, heads, s_cells, d, rnd, torch.float32, "cuda")
            got = c.run_k3("kernel", qf, k, v, rel, s, br).double()
            ref = c.run_k3("plain", qf, k, v, rel, s, br).double()
            exact = f64(lambda: c.run_k3("plain", qf.double(), k.double(), v.double(),
                                         rel.double(), s, br))
            record("K3", f"{name} B={chunks}", got, ref, exact)
            del qf, k, v, rel, got, ref, exact
            torch.cuda.empty_cache()
print("RESULT " + json.dumps({"card": smi, "rows": rows}))
"""


PREC = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c

smi = c.phase_build()
rows = []


def f64(run):
    # block_math with every .float() a .double(): its f32 steps in f64
    f = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        return run()
    finally:
        torch.Tensor.float = f


def one(kernel, b, mode, t, window, seed, cc=256, nh=4, **key):
    x, xo, mask, packed = c.block_case(mode, t, window, b, torch.float32, "cuda", seed, c=cc,
                                       n_head=nh)
    coefs = c.draw_coefs(b, "cuda", seed)
    def run(which, x, xo, packed):
        if kernel == "K1":
            return c.run_block(which, x, xo, mask, packed, mode, window, nh)
        return c.run_k6(which, x, xo, mask, coefs.to(x.dtype), packed, mode, window, nh)
    with torch.no_grad():
        got = run("kernel", x, xo, packed).double()
        ref = run("plain", x, xo, packed).double()
        d = lambda a: None if a is None else a.double()
        exact = f64(lambda: run("plain", x.double(), d(xo), [a.double() for a in packed]))
    torch.cuda.synchronize()
    rows.append(dict(kernel=kernel, B=b, mode=mode, T=t, window=window, C=cc, heads=nh,
                     plain=(got - ref).abs().max().item(),
                     f64=(got - exact).abs().max().item(),
                     plain_vs_f64=(ref - exact).abs().max().item(), **key))
    del x, xo, mask, packed, got, ref, exact
    torch.cuda.empty_cache()


for b in (16, 64):
    for _, mode, t, window in c.PROD_BLOCKS:
        one("K1", b, mode, t, window, t, group="production")
one("K1", 512, "self", 768, 7, 768, group="production")
for _, mode, t, window in c.PROD_BLOCKS:
    one("K6", c.TRAIN_B, mode, t, window, t, group="production")
for cc, nh, w in c.WIDE_SHAPES:
    for t in c.WIDE_TS:
        for mode in ("self", "qv_k", "kv", "ds_self"):
            for kernel in ("K1", "K6"):
                one(kernel, c.WIDE_B, mode, t, 2 * w + 1 if w else -1, cc + t + w, cc, nh,
                    group="wide")
# --wide: each shape at every length of chip_smoke.DOMAIN_TS, K1 in the four
# modes, K6 in self mode
for cc, nh, w in %r:
    for t in c.DOMAIN_TS:
        for mode in ("self", "qv_k", "kv", "ds_self"):
            for kernel in ("K1", "K6") if mode == "self" else ("K1",):
                one(kernel, c.DOMAIN_B, mode, t, 2 * w + 1 if w else -1, cc + t + w, cc, nh,
                    group="domain")
print("RESULT " + json.dumps({"card": smi, "rows": rows}))
"""

K7_RUN = DIGEST + r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c

smi = c.phase_build()
out = {"card": smi}
digests = {}
with torch.no_grad():
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        total = 0.0
        for t in c.K7_TS:
            args = c.k7_case(c.TRAIN_B, t, dt, "cuda", seed=t)
            run = lambda: c.run_k7("kernel", *args, 3)
            digests[f"K7 {dname} T={t}"] = digest(run())
            ms = c.device_ms(run, iters=20)
            out[f"K7 {dname} T={t}"] = ms
            total += ms
            del args
        out[f"K7 {dname} the {len(c.K7_TS)} lengths"] = total
        for bb, h, t, d in c.DOMAIN_K7:
            for ww in c.DOMAIN_K7_W:
                args = c.k7_case(bb, t, dt, "cuda", seed=ww, h=h, d=d)
                run = lambda: c.run_k7("kernel", *args, ww)
                key = f"K7 {dname} {bb}x{h}x{t}x{d} w={ww}"
                digests[key] = digest(run())
                out[key] = c.device_ms(run, iters=10)
                out[key + " SDPA"] = c.device_ms(c.sdpa_nearest(*args, ww), iters=10)
                del args
out["digests"] = digests
print("RESULT " + json.dumps(out))
"""


def run_tree(tree, code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                          text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                         f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def precision(args):
    wide = [tuple(int(v) for v in w.split(",")) for w in args.wide]
    code = {"k1": PREC % (wide,), "mvit": MVIT_PREC, "frontends": FRONT_PREC}[args.kernels]
    res = {name: run_tree(os.path.abspath(getattr(args, name)), code) for name in ("a", "b")}
    print(f"f32 worst |d| per shape, a -> b (b / a), from plain f32 and from plain f64 "
          f"({res['b']['card']})")
    summary = {}
    for ra, rb in zip(res["a"]["rows"], res["b"]["rows"]):
        shape = ra.get("shape") or (f"{ra['group']} C={ra['C']} heads={ra['heads']} "
                                    f"window={ra['window']} B={ra['B']} T={ra['T']} {ra['mode']}")
        ratio = {k: rb[k] / max(ra[k], 1e-30) for k in ("plain", "f64")}
        rb["ratio"] = ratio
        print(f"{ra['kernel']} {shape}: plain {ra['plain']:.3e} -> {rb['plain']:.3e} "
              f"({ratio['plain']:.2f}x); f64 {ra['f64']:.3e} -> {rb['f64']:.3e} "
              f"({ratio['f64']:.2f}x); plain vs f64 {rb['plain_vs_f64']:.3e}")
        grp = summary.setdefault(f"{ra['kernel']} {ra.get('group', '')}".strip(), {
            "shapes": 0, **{f"{k}_{s}": 0.0 for k in ("plain", "f64") for s in ("a", "b")},
            **{f"{k}_max_ratio": 0.0 for k in ("plain", "f64")},
            **{f"{k}_over_2x": 0 for k in ("plain", "f64")}, "plain_vs_f64": 0.0})
        grp["shapes"] += 1
        grp["plain_vs_f64"] = max(grp["plain_vs_f64"], rb["plain_vs_f64"])
        for k in ("plain", "f64"):
            grp[f"{k}_a"] = max(grp[f"{k}_a"], ra[k])
            grp[f"{k}_b"] = max(grp[f"{k}_b"], rb[k])
            grp[f"{k}_max_ratio"] = max(grp[f"{k}_max_ratio"], ratio[k])
            grp[f"{k}_over_2x"] += ratio[k] > 2.0
    for name, g in summary.items():
        print(f"{name}, {g['shapes']} shapes: from plain f32 worst {g['plain_a']:.3e} -> "
              f"{g['plain_b']:.3e}, max ratio {g['plain_max_ratio']:.2f}, over 2x at "
              f"{g['plain_over_2x']}; from f64 worst {g['f64_a']:.3e} -> {g['f64_b']:.3e}, max "
              f"ratio {g['f64_max_ratio']:.2f}, over 2x at {g['f64_over_2x']}; plain f32 from "
              f"f64 worst {g['plain_vs_f64']:.3e}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(precision=res, summary=summary), f, indent=1)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="the first tree (the parent)")
    ap.add_argument("b", help="the second tree (the change)")
    ap.add_argument("--kernels", choices=("k1", "mvit", "frontends", "k7"), default="k1",
                    help="K1 (one dtype), K3 and K4, K2, K5 and K8, or K7 (both dtypes)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="K1's dtype")
    ap.add_argument("--wide", nargs="*", default=[], metavar="C,HEADS,W",
                    help="K1: wide-grid blocks to time at B=2, T=2304 (W 0: dense)")
    ap.add_argument("--precision", action="store_true",
                    help="f32 worst |d| per shape from plain f32 and f64, no timing")
    ap.add_argument("--out", help="JSON file for the runs and means")
    args = ap.parse_args(argv)
    if args.precision and args.kernels == "k7":
        ap.error("--precision takes k1, mvit or frontends")
    if args.precision:
        return precision(args)
    wide = [tuple(int(v) for v in s.split(",")) for s in args.wide]
    code = {"k1": RUN % (args.dtype, BATCHES, wide), "mvit": MVIT_RUN,
            "frontends": FRONT_RUN, "k7": K7_RUN}[args.kernels]
    label = {"k1": f"K1 {args.dtype}", "mvit": "K3 / K4",
             "frontends": "K2 / K5 / K8", "k7": "K7"}[args.kernels]
    runs = []
    for name in ("a", "b", "b", "a"):
        tree = os.path.abspath(getattr(args, name))
        res = run_tree(tree, code)
        runs.append(dict(tree=name, path=tree, **res))
        print(f"{name} {label} " + "; ".join(f"{k} {v:.3f}" for k, v in res.items()
                                            if k not in ("card", "digests")) +
              f" ({res['card']})", flush=True)
    keys = [k for k in runs[0] if k not in ("tree", "path", "card", "digests")]
    means = {name: {k: sum(r[k] for r in runs if r["tree"] == name) / 2 for k in keys}
             for name in ("a", "b")}
    change = {k: 100.0 * (means["b"][k] / means["a"][k] - 1.0) for k in keys}
    for k in keys:
        print(f"{label} {k}: a {means['a'][k]:.3f} b {means['b'][k]:.3f} ({change[k]:+.2f}%)")
    same = None
    if "digests" in runs[0]:
        # every run of a tree gives the same bits, and the two trees' agree
        same = {k: len({r["digests"][k] for r in runs}) == 1 for k in runs[0]["digests"]}
        print(f"{label} outputs bit for bit the same in all four runs at {sum(same.values())} "
              f"of {len(same)} shapes" + "".join(f"; differ at {k}" for k, v in same.items()
                                                  if not v))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(kernels=args.kernels, dtype=args.dtype, runs=runs, means=means,
                           change_percent=change, bit_equal=same), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
