"""The production K1 in two source trees on one card: the 18 blocks of one
localizer forward (``chip_smoke.PROD_BLOCKS``), in bf16 or float32, device
ms (each block replayed as a CUDA graph, ``chip_smoke.device_ms``), summed,
at B = 16, 64 and 512; with ``--wide``, also one self-mode block at each
(C, heads, half window; 0 dense) of the list at B = 2, T = 2304. The trees
run in turns a, b, b, a, each in a process of its own that builds its own
kernel library under its ``build/kernels/``.

With ``--precision`` it times nothing and runs each tree once: the float32
K1 / K6 at every shape ``chip_smoke.py`` checks them at (K1: the 18
production blocks' 13 shapes at B = 16 and 64 and the B = 512 full-length
block; K6: the 13 at B = 50 with droppath coefficients; both at every
(C, heads, w) x T x mode of ``chip_smoke.WIDE_SHAPES`` / ``WIDE_TS`` at
B = 2), each on the cases and seeds of those checks, against two plain
versions on the same inputs: ``block_math`` in float32 (what the checks
hold the kernel to) and ``block_math`` with every float32 step in float64
(the exact sum of the f32 inputs, to f64 rounding). Per shape it prints
both trees' worst |d| from each and the ratio b / a.

    python3 tools/k1_compare_trees.py PARENT_TREE CHANGED_TREE [--dtype float32]
        [--wide 512,4,0 1024,8,0 ...] [--precision] [--out FILE]

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
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c
dtype = getattr(torch, %r)
smi = c.phase_build()
out = {"card": smi}


def ms(run):
    # a call past 10 ms is timed over fewer replays
    return c.device_ms(run, iters=20 if c.cuda_ms(run, iters=1, warmup=1) < 10 else 5)


for b in %r:
    total = 0.0
    for names, mode, t, window in c.PROD_BLOCKS:
        x, xo, mask, packed = c.block_case(mode, t, window, b, dtype, "cuda", seed=t)
        with torch.no_grad():
            total += len(names) * ms(
                lambda: c.run_block("kernel", x, xo, mask, packed, mode, window))
        del x, xo, mask, packed
        torch.cuda.empty_cache()
    out[str(b)] = total
for cc, nh, w in %r:
    window = 2 * w + 1 if w else -1
    x, xo, mask, packed = c.block_case("self", 2304, window, 2, dtype, "cuda", cc, c=cc,
                                       n_head=nh)
    with torch.no_grad():
        out[f"{cc},{nh},{w}"] = ms(
            lambda: c.run_block("kernel", x, xo, mask, packed, "self", window, nh))
    del x, xo, mask, packed
print("RESULT " + json.dumps(out))
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
print("RESULT " + json.dumps({"card": smi, "rows": rows}))
"""


def run_tree(tree, dtype, wide, precision=False):
    code = PREC if precision else RUN % (dtype, BATCHES, wide)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                          text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                         f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def precision(args):
    res = {name: run_tree(os.path.abspath(getattr(args, name)), "float32", [], True)
           for name in ("a", "b")}
    print(f"f32 worst |d| per shape, a -> b (b / a), from plain f32 and from plain f64 "
          f"({res['b']['card']})")
    summary = {}
    for ra, rb in zip(res["a"]["rows"], res["b"]["rows"]):
        shape = (f"{ra['kernel']} {ra['group']} C={ra['C']} heads={ra['heads']} "
                 f"window={ra['window']} B={ra['B']} T={ra['T']} {ra['mode']}")
        ratio = {k: rb[k] / max(ra[k], 1e-30) for k in ("plain", "f64")}
        rb["ratio"] = ratio
        print(f"{shape}: plain {ra['plain']:.3e} -> {rb['plain']:.3e} ({ratio['plain']:.2f}x); "
              f"f64 {ra['f64']:.3e} -> {rb['f64']:.3e} ({ratio['f64']:.2f}x); "
              f"plain vs f64 {rb['plain_vs_f64']:.3e}")
        grp = summary.setdefault(f"{ra['kernel']} {ra['group']}", {
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
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--wide", nargs="*", default=[], metavar="C,HEADS,W",
                    help="wide-grid blocks to time at B=2, T=2304 (W 0: dense)")
    ap.add_argument("--precision", action="store_true",
                    help="f32 worst |d| per shape from plain f32 and f64, no timing")
    ap.add_argument("--out", help="JSON file for the runs and means")
    args = ap.parse_args(argv)
    if args.precision:
        return precision(args)
    wide = [tuple(int(v) for v in s.split(",")) for s in args.wide]
    keys = [str(b) for b in BATCHES] + [f"{c},{h},{w}" for c, h, w in wide]
    names = [f"B={b}" for b in BATCHES] + [f"({k})" for k in keys[len(BATCHES):]]
    runs = []
    for name in ("a", "b", "b", "a"):
        tree = os.path.abspath(getattr(args, name))
        res = run_tree(tree, args.dtype, wide)
        runs.append(dict(tree=name, path=tree, **res))
        print(f"{name} {args.dtype} " + " ".join(f"{n} {res[k]:.3f} ms" for n, k in
                                                 zip(names, keys)) + f" ({res['card']})",
              flush=True)
    means = {name: {k: sum(r[k] for r in runs if r["tree"] == name) / 2 for k in keys}
             for name in ("a", "b")}
    change = {k: 100.0 * (means["b"][k] / means["a"][k] - 1.0) for k in keys}
    print("mean a " + " ".join(f"{n} {means['a'][k]:.3f}" for n, k in zip(names, keys)))
    print("mean b " + " ".join(f"{n} {means['b'][k]:.3f}" for n, k in zip(names, keys)))
    print("b vs a " + " ".join(f"{n} {change[k]:+.2f}%" for n, k in zip(names, keys)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(dtype=args.dtype, runs=runs, means=means, change_percent=change), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
